"""Port parity for the kernel layer: helpers, Thm-4 codec, K1, K2, P.

(K3 and K4, the feature kernels, are held in tests/test_torch_features.py.)

The same numpy inputs go through the JAX reference (its Pallas kernels in
interpret mode, as tests/test_kernels.py runs them) and through the port's
CPU path (the kernels' plain versions). The CUDA kernels themselves run only
on the card; ``chip_smoke.py`` holds them against these plain versions
there. Also here: the port imports neither jax nor repro, its CUDA entry
points refuse CPU tensors, and ``chip_smoke.py`` fails without a card.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.server import cholesky as jchol
from repro_torch.kernels import _build, gram, ops, ref
from repro_torch.server import cholesky as tchol

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


class _Elsewhere:
    """A stand-in for a tensor on a device the port has no route for."""
    device = torch.device("xpu")


def _rng(*seed):
    return np.random.default_rng(list(seed))


def _f32(x):
    return torch.from_numpy(np.asarray(x, np.float32))


class TestHelpers:
    @pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 9, 63, 64, 65, 1000])
    @pytest.mark.parametrize("floor", [1, 4])
    def test_pow2_bucket(self, n, floor):
        assert ops.pow2_bucket(n, floor=floor) == jops.pow2_bucket(n, floor=floor)

    @pytest.mark.parametrize("d", [0, 1, 2, 3, 10, 100, 4096])
    def test_tri_len_dim(self, d):
        assert ops.tri_len(d) == jops.tri_len(d)
        assert ops.tri_dim(ops.tri_len(d)) == jops.tri_dim(jops.tri_len(d)) == d

    @pytest.mark.parametrize("length", [2, 4, 7, 11])
    def test_tri_dim_rejects(self, length):
        for fn in (ops.tri_dim, jops.tri_dim):
            with pytest.raises(ValueError):
                fn(length)


class TestPackedCodec:
    @pytest.mark.parametrize("d", [1, 2, 3, 7, 16, 33, 64])
    def test_pack_unpack_bitwise_vs_jax(self, d):
        a = _rng(d).standard_normal((2 * d, d)).astype(np.float32)
        G = a.T @ a
        tri_t = ops.pack_lower(torch.from_numpy(G))
        tri_j = np.asarray(jops.pack_lower(jnp.asarray(G)))
        np.testing.assert_array_equal(tri_t.numpy(), tri_j)
        full_t = ops.unpack_lower(tri_t, d)
        full_j = np.asarray(jops.unpack_lower(jnp.asarray(tri_j), d))
        np.testing.assert_array_equal(full_t.numpy(), full_j)
        np.testing.assert_array_equal(full_t.numpy(), G)

    def test_batched_and_f64(self):
        a = _rng(5).standard_normal((3, 9, 5))
        G = np.einsum("bni,bnj->bij", a, a)
        tri = ops.pack_lower(torch.from_numpy(G))
        assert tri.shape == (3, 15) and tri.dtype == torch.float64
        np.testing.assert_array_equal(ops.unpack_lower(tri, 5).numpy(), G)

    def test_unpack_rejects_bad_length(self):
        with pytest.raises(ValueError):
            ops.unpack_lower(torch.zeros(7), 3)


class TestGramMoment:
    @pytest.mark.parametrize("n,d,dtype", [
        (64, 16, "float32"), (100, 37, "float32"), (1, 24, "float32"),
        (256, 64, "float32"), (256, 64, "bfloat16"), (33, 5, "bfloat16")])
    def test_matches_jax_kernel(self, n, d, dtype):
        rng = _rng(n, d)
        A = rng.standard_normal((n, d)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        At, bt = torch.from_numpy(A), torch.from_numpy(b)
        Aj, bj = jnp.asarray(A), jnp.asarray(b)
        if dtype == "bfloat16":
            At, bt = At.bfloat16(), bt.bfloat16()
            Aj, bj = Aj.astype(jnp.bfloat16), bj.astype(jnp.bfloat16)
        G, h = ops.gram_moment(At, bt)
        Gj, hj = jops.gram_moment(Aj, bj, interpret=True)
        assert G.dtype == h.dtype == torch.float32
        np.testing.assert_allclose(G.numpy(), np.asarray(Gj), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-3, atol=1e-3)

    def test_float64_accumulates_in_float64(self):
        rng = _rng(7)
        A, b = rng.standard_normal((50, 9)), rng.standard_normal(50)
        G, h = ops.gram_moment(torch.from_numpy(A), torch.from_numpy(b))
        assert G.dtype == torch.float64
        np.testing.assert_allclose(G.numpy(), A.T @ A, rtol=1e-12)
        np.testing.assert_allclose(h.numpy(), A.T @ b, rtol=1e-12, atol=1e-12)


class TestGemmNt:
    @pytest.mark.parametrize("m,n,k,alpha", [(40, 40, 9, 1.0), (100, 37, 13, -1.0),
                                             (64, 96, 96, 1.0), (8, 3, 1, 0.5)])
    def test_matches_jax_kernel(self, m, n, k, alpha):
        rng = _rng(m, n, k)
        C, A, B = (rng.standard_normal(s).astype(np.float32)
                   for s in ((m, n), (m, k), (n, k)))
        out = ops.gemm_nt(_f32(C), _f32(A), _f32(B), alpha=alpha)
        outj = jops.gemm_nt(jnp.asarray(C), jnp.asarray(A), jnp.asarray(B),
                            alpha=alpha, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(outj), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(
            ref.gemm_nt_ref(_f32(C), _f32(A), _f32(B), alpha=alpha).numpy(),
            C + alpha * A @ B.T, rtol=1e-5, atol=1e-5)


def _panel(bw, r, seed):
    rng = _rng(bw, r, seed)
    M = rng.standard_normal((4 * bw, bw))
    L11 = np.linalg.cholesky(M.T @ M + 0.1 * np.eye(bw))
    return L11, 0.5 * rng.standard_normal((r, bw))


def _two_phase(L11, X1, s):
    """numpy model of the CUDA kernel P's schedule: per-row scalar chains
    (a valid order of its wavefront), then each row of T in j-major order."""
    bw, r = L11.shape[0], X1.shape[0]
    C, S = np.zeros((bw, r)), np.zeros((bw, r))
    out = np.array(L11)
    tiny = np.finfo(L11.dtype).tiny
    for i in range(bw):
        l = out[i].copy()
        for j in range(r):
            x = X1[j, i]
            for k in range(i):
                a = l[k]
                l[k] = (a + s * S[k, j] * x) / C[k, j]
                x = (-S[k, j] * a + x) / C[k, j]
            rho = np.sqrt(max(l[i] * l[i] + s * x * x, tiny))
            C[i, j], S[i, j] = rho / l[i], x / l[i]
            l[i] = rho
        out[i, :i + 1] = l[:i + 1]
    w = bw + r
    T = np.zeros((w, w))
    for q in range(w):
        tk = (np.arange(bw) == q).astype(float)
        for j in range(r):
            tj = float(q == bw + j)
            for k in range(bw):
                a = tk[k]
                tk[k] = (a + s * S[k, j] * tj) / C[k, j]
                tj = (-S[k, j] * a + tj) / C[k, j]
            T[q, bw + j] = tj
        T[q, :bw] = tk
    return out, T


class TestPanelTransform:
    @pytest.mark.parametrize("bw,r", [(8, 3), (16, 9), (12, 17)])
    @pytest.mark.parametrize("sign", [1.0, -1.0])
    def test_matches_jax(self, bw, r, sign):
        L11, X1 = _panel(bw, r, 0)
        if sign < 0:   # downdate what an update added: stays positive definite
            L11 = np.asarray(jchol.panel_transform(jnp.asarray(L11, jnp.float32),
                                                   jnp.asarray(X1, jnp.float32))[0])
        L11, X1 = L11.astype(np.float32), X1.astype(np.float32)
        Lt, Tt = tchol.panel_transform(_f32(L11), _f32(X1), sign=sign)
        Lj, Tj = jchol.panel_transform(jnp.asarray(L11), jnp.asarray(X1), sign=sign)
        np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("bw,r,sign", [(5, 4, 1.0), (8, 11, 1.0), (6, 3, -1.0)])
    def test_kernel_schedule_equals_sequential_order(self, bw, r, sign):
        """Kernel P reorders the rotations (wavefront rows, j-major T rows);
        in float64 that order reproduces the sequential loop."""
        L11, X1 = _panel(bw, r, 1)
        if sign < 0:
            L11 = tchol.panel_transform_ref(torch.from_numpy(L11),
                                            torch.from_numpy(X1))[0].numpy()
        Lm, Tm = _two_phase(L11, X1, sign)
        Lr, Tr = tchol.panel_transform_ref(torch.from_numpy(L11),
                                           torch.from_numpy(X1), sign=sign)
        np.testing.assert_allclose(Lm, Lr.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(Tm, Tr.numpy(), rtol=1e-12, atol=1e-12)


class TestCudaEntryPoints:
    """The wrappers take CUDA tensors only, and dispatch raises elsewhere."""

    def test_kernels_refuse_cpu_tensors(self):
        A = torch.zeros(4, 3)
        with pytest.raises(ValueError, match="CUDA"):
            gram.gram_moment_cuda(A, torch.zeros(4))
        with pytest.raises(ValueError, match="CUDA"):
            gram.gemm_nt_cuda(torch.zeros(4, 4), A, torch.zeros(4, 3))
        with pytest.raises(ValueError, match="CUDA"):
            gram.panel_transform_cuda(torch.eye(3), A)
        with pytest.raises(ValueError, match="CUDA"):
            gram.sketch_gram_cuda(A, torch.zeros(4), torch.zeros(3, 2))
        with pytest.raises(ValueError, match="CUDA"):
            gram.rff_gram_cuda(A, torch.zeros(4), torch.zeros(3, 2), torch.zeros(2))
        with pytest.raises(ValueError, match="CUDA"):
            gram.swa_flash_cuda(*(torch.zeros(1, 4, 2, 64) for _ in range(3)), window=None)
        assert gram.launch_counts() == {"gram_moment": 0, "gemm_nt": 0,
                                        "panel_transform": 0, "sketch_gram": 0,
                                        "rff_gram": 0, "swa_flash": 0}

    def test_unknown_device_raises(self):
        """A device other than CUDA, CPU and meta raises; a meta tensor
        takes the plain version, which there computes shapes alone."""
        G, h = ops.gram_moment(torch.zeros(4, 3, device="meta"),
                               torch.zeros(4, device="meta"))
        assert (G.device.type, G.shape, h.shape) == ("meta", (3, 3), (3,))
        elsewhere = _Elsewhere()
        with pytest.raises(ValueError, match="device"):
            ops.gram_moment(elsewhere, elsewhere)
        with pytest.raises(ValueError, match="device"):
            tchol.panel_transform(elsewhere, elsewhere)

    def test_build_goes_to_ignored_build_dir(self):
        assert _build.BUILD_ROOT.parent == ROOT / "build"
        assert "build/" in (ROOT / ".gitignore").read_text().split()
        assert {p.stem for p in (PORT / "csrc").glob("*.cu")} == set(_build.SOURCES)
        # every wrapped kernel names a built source
        assert {gram._SOURCE.get(k, k) for k in gram._SIGNATURES} == set(_build.SOURCES)
        # and every entry raises the launch count of one kernel
        assert {gram._COUNTED_AS.get(k, k) for k in gram._SIGNATURES} == set(gram.KERNELS)


_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


class TestIsolation:
    def test_no_jax_or_repro_imports_in_source(self):
        files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        hits = [(f.name, m.group(0).strip()) for f in files
                for m in _IMPORT_RE.finditer(f.read_text())]
        assert len(files) > 10 and hits == []

    def test_import_loads_no_jax_or_repro(self):
        code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels.ops, "
                "repro_torch.kernels.gram, repro_torch.server, repro_torch.fed, "
                "repro_torch.data, repro_torch.convert, repro_torch.core.features, "
                "repro_torch.core.threefry, repro_torch.core.projection, "
                "repro_torch.core.rff, repro_torch.configs, repro_torch.models, "
                "repro_torch.models.model, repro_torch.launch.serve; "
                "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
                "print(bad); sys.exit(1 if bad else 0)")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr

    def test_chip_smoke_fails_without_a_card(self):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                             env=env, cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
