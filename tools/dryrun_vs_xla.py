#!/usr/bin/env python3
"""The dry-run's collective bytes against XLA's, config by config, on the CPU.

    PYTHONPATH=src python3 tools/dryrun_vs_xla.py [--archs a,b,...] [--kinds train,prefill]

For each reduced config (``configs.get_reduced``, 2 stages, B 2, S 256) and
step kind, on a (4, 2) ``data, model`` mesh: the reference's program
lowered and compiled by ``jax.jit`` on 8 host devices (one child process
for all of them; ``launch/dryrun.py``'s ``build_lowered`` in cost mode and
``parse_collectives``), and the port's ``count_collective_bytes`` (DTensor
on a fake process group). Prints one JSON line per pair: both byte counts
by kind, the ratio of the totals, and the ops the port ran replicated.
``tests/test_torch_dryrun_collectives.py`` holds yi-9b's ratios within a
factor of 2 through :func:`xla_collectives` and :func:`port_collectives`;
this tool shows every config's. The port's counts follow DTensor's rules,
so each line names its torch version. Imports JAX (the reference), so it
runs beside the port, never on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax
import numpy as np
jax.devices()
from repro import configs
from repro.launch import dryrun
from repro.models.config import InputShape

mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
out = {}
for pair in sys.argv[1:]:
    arch, kind = pair.split(":")
    cfg = dataclasses.replace(configs.get_reduced(arch), num_stages=2)
    shape = InputShape("t", 256, 2, kind)
    with mesh:
        lowered = dryrun.build_lowered(cfg, shape, mesh, mode="cost")
    out[pair] = dryrun.parse_collectives(lowered.compile().as_text())
print("XLA " + json.dumps(out))
"""


def xla_collectives(pairs: list[str]) -> dict:
    """``{"arch:kind": parse_collectives(...)}`` of the reference's cost
    programs on the (4, 2) mesh of 8 host devices, from one child process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", _CHILD, *pairs], env=env,
                         capture_output=True, text=True, timeout=1800)
    lines = [line for line in run.stdout.splitlines() if line.startswith("XLA ")]
    if run.returncode or not lines:
        raise RuntimeError(f"the reference's child failed:\n{run.stderr[-4000:]}")
    return json.loads(lines[0][4:])


def port_collectives(pair: str) -> tuple[dict, dict]:
    """The port's ``count_collective_bytes`` of ``"arch:kind"`` on the
    same mesh and shape."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.config import InputShape
    arch, kind = pair.split(":")
    cfg = dataclasses.replace(configs.get_reduced(arch), num_stages=2)
    mesh = mesh_lib.make_mesh((4, 2), ("data", "model"), device="meta")
    return dryrun.count_collective_bytes(cfg, InputShape("t", 256, 2, kind), mesh)


def main(argv=None) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=",".join(configs.ARCH_IDS))
    ap.add_argument("--kinds", default="train,prefill")
    args = ap.parse_args(argv)
    pairs = [f"{arch}:{kind}" for arch in args.archs.split(",")
             for kind in args.kinds.split(",")
             if not (kind == "decode" and configs.get_reduced(arch).encoder_only)]
    xla = xla_collectives(pairs)
    warnings.filterwarnings("ignore")
    for pair in pairs:
        arch, kind = pair.split(":")
        port, replicated = port_collectives(pair)
        print(json.dumps({"arch": arch, "kind": kind, "torch": torch.__version__,
                          "port": port, "xla": xla[pair],
                          "ratio": port["total"] / xla[pair]["total"],
                          "replicated_ops": replicated}), flush=True)


if __name__ == "__main__":
    main()
