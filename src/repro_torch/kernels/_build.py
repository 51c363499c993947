"""Build the CUDA sources in ``csrc/`` into shared libraries, on first use.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``lib<name>.so``, compiled by ``nvcc`` for ``sm_90a`` (Hopper) and loaded
with ``ctypes``. No PyTorch header is included, so a build takes seconds.
All sources are compiled at once, one ``nvcc`` process each, started
together. The output goes to ``build/repro_torch_kernels/<hash>/`` at the
root of the checkout, keyed by a hash of the sources and flags, so an edit
to any source rebuilds and an unchanged tree reuses what it built before.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card need not have ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gram_moment", "gemm_nt", "panel_transform", "feature_gram",
           "swa_flash")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if v in os.environ]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "repro_torch are compiled on first use")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every source that is not built yet; returns seconds spent.

    Raises RuntimeError with nvcc's output if any compilation fails. The
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
    kept beside each library as ``lib<name>.log``.
    """
    with _lock:
        return _build_locked()


def _build_locked() -> float:
    out = _build_dir()
    todo = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"lib{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return time.perf_counter() - t0


def build_logs() -> dict[str, str]:
    """nvcc's ``-Xptxas -v`` report for each built source."""
    out = _build_dir()
    return {n: (out / f"lib{n}.log").read_text() for n in SOURCES
            if (out / f"lib{n}.log").exists()}


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building all sources first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if name not in SOURCES:
                raise KeyError(f"no CUDA source {name!r} (have {SOURCES})")
            _build_locked()
            lib = ctypes.CDLL(str(_build_dir() / f"lib{name}.so"))
            _libs[name] = lib
        return lib
