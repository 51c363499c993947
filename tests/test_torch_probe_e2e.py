"""The port's copy of ``examples/train_probe_e2e.py``
(``examples/train_probe_e2e_torch.py``): as a CPU process at a small size
it trains, fits the one-shot head and prints its error against the
centralized head; its feature function on weights carried over from the
reference (``convert.model_params_from``) equals the reference example's
``feature_fn`` at float32 1e-5 (the reference's lines, which its script
runs at import, are repeated here); it imports neither jax nor repro.
"""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs, convert

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "train_probe_e2e_torch.py"


def _example():
    spec = importlib.util.spec_from_file_location("train_probe_e2e_torch", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_runs_as_a_cpu_process():
    # one thread: the tiny model's steps gain nothing from more, and the
    # suite's workers share the host's cores
    run = subprocess.run([sys.executable, str(EXAMPLE), "--device", "cpu", "--steps", "3",
                          "--batch", "2", "--seq", "16"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr[-2000:]
    m = re.search(r"one-shot probe head == centralized head: rel err (\S+)", run.stdout)
    assert m and float(m.group(1)) < 1e-3, run.stdout
    assert "[e2e] pretrained" in run.stdout and "probe train MSE" in run.stdout


def test_example_imports_no_jax_or_repro():
    text = EXAMPLE.read_text()
    assert not re.search(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", text, re.M)
    code = ("import sys, importlib.util; "
            f"spec = importlib.util.spec_from_file_location('e2e', {str(EXAMPLE)!r}); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert run.returncode == 0, run.stdout + run.stderr


def test_features_match_the_reference_feature_fn():
    jcfg, cfg = jconfigs.get_reduced("yi-9b"), configs.get_reduced("yi-9b")
    params = jmodel.init_params(jax.random.PRNGKey(3), jcfg)
    lm = convert.model_params_from(params, cfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (16, 64)).astype(np.int32)

    # the reference example's feature_fn, line for line
    logits, _ = jmodel.forward(params, {"tokens": jnp.asarray(tokens)}, jcfg, chunk_size=32)
    del logits
    want = jmodel._input_embeddings(params, {"tokens": jnp.asarray(tokens)}, jcfg).mean(axis=1)

    got = _example().features(lm, torch.from_numpy(tokens))
    assert got.shape == (16, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
