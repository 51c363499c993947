"""The port's copy of ``examples/quickstart.py``
(``examples/quickstart_torch.py``) against the reference example.

The reference script runs once as a CPU process; the port's ``run`` takes
the same data (``repro.data.generate(PRNGKey(0), ...)`` carried over by
``convert.dataset_from_numpy``) and must print every number equal to the
reference's printed digits within one unit in the last, the communication
numbers (MiB, rounds, the traffic ratio) and the survivors exactly. The
exact-recovery line is a caveat (ROADMAP.md §3): its relative error is
float32 rounding, whose digits differ between the packages; both are held
below 1e-5 and printed. The port's example also runs as a CPU process at
its own defaults, printing the reference's lines and importing neither
jax nor repro.
"""
import re

import numpy as np
import pytest
import torch

from _example_parity import (assert_line_matches, load_example, reference_dataset,
                             run_printed, run_script, template)
from repro import core as jcore

EXACT = (r"comm (\S+) MiB", r"(\d+) rounds", r"\((\S+)x less traffic\)",
         r"for the (\d+) surviving")
REL_ERR_LINE = 0


@pytest.fixture(scope="module")
def reference_lines():
    return run_script("quickstart.py")


@pytest.fixture(scope="module")
def port_run():
    jds, ds = reference_dataset()
    res, lines = run_printed(load_example("quickstart_torch.py").run, ds)
    return jds, ds, res, lines


@pytest.mark.parametrize("line", [1, 2, 3, 4])
def test_printed_numbers_match_the_reference(reference_lines, port_run, line):
    lines = port_run[3]
    assert len(lines) == len(reference_lines) == 5
    assert_line_matches(lines[line], reference_lines[line], EXACT)


def test_exact_recovery_line_caveat(reference_lines, port_run):
    got, want = port_run[3][REL_ERR_LINE], reference_lines[REL_ERR_LINE]
    print(f"reference: {want}\nport:      {got}")
    assert template(got) == template(want)
    assert port_run[2]["rel_err"] < 1e-5
    assert float(want.rsplit("= ", 1)[1]) < 1e-5


def test_weights_match_the_reference_functions(port_run):
    jds, ds, res, _ = port_run
    stats = [jcore.compute_stats(A, b) for A, b in jds.clients]
    for key, want in (("w_fed", jcore.one_shot_fusion(stats, 0.01)),
                      ("w_central", jcore.solve_ridge(jcore.compute_stats(*jds.stacked()), 0.01))):
        np.testing.assert_allclose(res[key].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_dropout_is_the_float64_optimum_of_the_survivors(port_run):
    _, ds, res, _ = port_run
    rows = [c for c, alive in zip(ds.clients, res["alive"]) if alive]
    A = torch.cat([a for a, _ in rows]).double()
    b = torch.cat([b for _, b in rows]).double()
    w64 = torch.linalg.solve(A.T @ A + 0.01 * torch.eye(A.shape[1], dtype=torch.float64),
                             A.T @ b)
    assert res["survivors"] == 10
    assert float(torch.linalg.norm(res["w_dropout"].double() - w64) / torch.linalg.norm(w64)) < 1e-5


def test_example_runs_as_a_cpu_process(reference_lines):
    lines = run_script("quickstart_torch.py", "--device", "cpu")
    assert [template(x) for x in lines] == [template(x) for x in reference_lines]
    assert float(lines[REL_ERR_LINE].rsplit("= ", 1)[1]) < 1e-5
    # the communication ledger and the survivors do not depend on the data
    for pattern in EXACT:
        assert re.findall(pattern, "\n".join(lines)) == re.findall(
            pattern, "\n".join(reference_lines)), pattern
