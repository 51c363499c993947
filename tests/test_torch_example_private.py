"""The port's copy of ``examples/private_federation.py``
(``examples/private_federation_torch.py``) against the reference example.

The reference script runs once as a CPU process; the port's ``run`` takes
the same data (``repro.data.generate(PRNGKey(0), ...)`` carried over by
``convert.dataset_from_numpy``) and the same keys (``threefry.key(int(eps *
100))`` and its ``fold_in(key, 1)``, whose noise is ``jax.random``'s bit for
bit), and must print every line as the reference does: each MSE equal to
its printed digits within one unit in the last, each "failed" cell in the
same place, the eps column, Theorem 7's eps_total, LOCO-CV's sigma* and its
overhead exactly. The port's example also runs as a CPU process at its own
defaults, printing the reference's lines and importing neither jax nor
repro.
"""
import re

import pytest

from _example_parity import (assert_line_matches, load_example, reference_dataset,
                             run_printed, run_script, template)

EXACT = (r"^\s*(\d+\.\d) ", r"eps0=(\S+)", r"eps_total = (\S+)", r"sigma=(\S+)",
         r"overhead (\d+)")


@pytest.fixture(scope="module")
def reference_lines():
    return run_script("private_federation.py")


@pytest.fixture(scope="module")
def port_run():
    _, ds = reference_dataset()
    return run_printed(load_example("private_federation_torch.py").run, ds)


@pytest.mark.parametrize("line", range(10))
def test_printed_line_matches_the_reference(reference_lines, port_run, line):
    lines = port_run[1]
    assert len(lines) == len(reference_lines) == 10
    assert_line_matches(lines[line], reference_lines[line], EXACT)


def test_returned_numbers_are_the_printed_ones(port_run):
    res, lines = port_run
    assert lines[0] == f"non-private MSE: {res['mse_non_private']:.4f}"
    for row, line in zip(res["rows"], lines[2:7]):
        cells = line.split()
        assert float(cells[0]) == row["eps"]
        for cell, key in zip(cells[1:], ("alg2", "alg2_psd", "secagg")):
            assert cell == ("failed" if row[key] is None else f"{row[key]:.4f}")
    assert res["loco_overhead_scalars"] == 100 and res["loco_sigma"] == 1.0


def test_example_runs_as_a_cpu_process(reference_lines):
    lines = run_script("private_federation_torch.py", "--device", "cpu")
    assert [template(x) for x in lines] == [template(x) for x in reference_lines]
    # the eps grid, Theorem 7 and the overhead do not depend on the data
    for pattern in EXACT[:3] + EXACT[4:]:
        assert [re.findall(pattern, x) for x in lines] == [
            re.findall(pattern, x) for x in reference_lines], pattern
