"""Helpers of the example parity tests (``tests/test_torch_example_*.py``):
run an example as a process, load a port example in process, and compare
printed lines number by number."""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np

from repro import data as jdata
from repro_torch import convert

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
FAILED = re.compile(r"\bfailed\b")

# The import check appended to a port example run as a process: its last
# line lists every module of jax, jaxlib or repro that the run imported.
_RUN_AND_LIST = ("import runpy, sys; path = sys.argv[1]; sys.argv = sys.argv[1:]; "
                 "runpy.run_path(path, run_name='__main__'); "
                 "print('imported', [m for m in sys.modules "
                 "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')])")


def run_script(name: str, *args: str, timeout: int = 300) -> list[str]:
    """``examples/<name>`` as a process on the CPU; its stdout's lines. A
    port example (``*_torch.py``) is run through a wrapper whose last line
    lists the jax or repro modules it imported; that line must be empty and
    is dropped."""
    path = str(ROOT / "examples" / name)
    port = name.endswith("_torch.py")
    cmd = [sys.executable, "-c", _RUN_AND_LIST, path] if port else [sys.executable, path]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([*cmd, *args], capture_output=True, text=True, timeout=timeout,
                         cwd=ROOT, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.rstrip("\n").split("\n")
    if port:
        assert lines[-1] == "imported []", lines[-1]
        lines = lines[:-1]
    return lines


def load_example(name: str):
    """``examples/<name>`` imported as a module (its ``main`` not run)."""
    path = ROOT / "examples" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_dataset():
    """The reference examples' data, ``repro.data.generate(PRNGKey(0), ...)``
    at 20 clients x 500 rows, d 100, gamma 0.5: (the JAX dataset, the same
    arrays as the port's CPU ``FederatedDataset``)."""
    jds = jdata.generate(jax.random.PRNGKey(0), num_clients=20, samples_per_client=500,
                         dim=100, gamma=0.5)
    ds = convert.dataset_from_numpy(
        [(np.asarray(A), np.asarray(b)) for A, b in jds.clients], np.asarray(jds.test_A),
        np.asarray(jds.test_b), np.asarray(jds.w_star), jds.gamma, device="cpu")
    return jds, ds


def run_printed(fn, *args):
    """``fn(*args)``'s result and the lines it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue().rstrip("\n").split("\n")


def template(line: str) -> str:
    """The line with every number and every "failed" cell masked."""
    return NUMBER.sub("#", FAILED.sub("#", line))


def last_digit(token: str) -> float:
    """One unit in the last printed digit of ``token``."""
    mantissa, _, exponent = token.lower().partition("e")
    decimals = len(mantissa.partition(".")[2])
    return 10.0 ** (int(exponent or 0) - decimals)


def assert_line_matches(got: str, want: str, exact: tuple[str, ...] = ()) -> None:
    """``got`` prints ``want``'s text, its "failed" cells in the same
    places, and each number equal to ``want``'s printed digits within one
    unit in the last; the numbers that each regex of ``exact`` finds are
    equal as printed."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want), (got, want)
    for g, w in zip(NUMBER.findall(got), NUMBER.findall(want)):
        assert abs(float(g) - float(w)) <= last_digit(w) * (1 + 1e-9), (g, w, got, want)
    for pattern in exact:
        assert re.findall(pattern, got) == re.findall(pattern, want), (pattern, got, want)
