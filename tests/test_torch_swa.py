"""Kernel K5 (sliding-window flash attention) of the PyTorch port against the
reference's ``swa_flash_pallas`` (interpret mode) and ``swa_attention_ref``.

The same numpy inputs go to both packages. On the CPU the port's
``ops.swa_attention`` runs the plain version of K5; numpy models of the
CUDA kernel's two routines (which KV blocks a query block visits, the
per-element mask, the blockwise online softmax, the ragged edge; for the
bfloat16 tensor-core routine also the edge-only mask, the exp2 softmax and
the hi/lo split of P rounded as bf16) are held against that plain version,
so the arithmetic the kernel performs is checked here even though the
kernel itself runs only on the card.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import gram, ops, ref

# tests/test_kernels.py's tolerances: float32, and one bf16 rounding
TOL = {"float32": 3e-5, "bfloat16": 4e-2}
BLOCK = 64                   # kBQ = kBK in csrc/swa_flash.cu


def _inputs(B, S, H, Hkv, hd, dtype="float32", seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def _port(arrs):
    return [convert.tensor_from_numpy(a, device="cpu") for a in arrs]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


class TestAgainstReferenceKernel:
    @pytest.mark.parametrize("S,hd,window,causal", [
        (256, 64, 64, True), (256, 128, None, True), (128, 64, 32, True),
        (256, 64, None, False), (192, 64, 48, True),
        # hubert-xlarge's head_dim, non-causal (S a multiple of the block:
        # the reference wrapper's padding caveat below) and causal
        (192, 80, None, False), (256, 80, 48, False), (200, 80, None, True)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_kernel(self, S, hd, window, causal, dtype):
        arrs = _inputs(2, S, 2, 2, hd, dtype, seed=S + hd)
        o_jax = jops.swa_attention(*(jnp.asarray(a) for a in arrs), window=window,
                                   causal=causal, block_q=64, block_k=64)
        o = ops.swa_attention(*_port(arrs), window=window, causal=causal)
        assert o.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        np.testing.assert_allclose(_f32(o), _f32(o_jax), atol=TOL[dtype])

    @pytest.mark.parametrize("S", [192, 200])
    @pytest.mark.parametrize("window", [None, 48])
    def test_ragged_non_causal_matches_oracle(self, S, window):
        arrs = _inputs(1, S, 2, 2, 64, seed=S)
        o_ref = jref.swa_attention_ref(*(jnp.asarray(a) for a in arrs),
                                       window=window, causal=False)
        o = ops.swa_attention(*_port(arrs), window=window, causal=False)
        np.testing.assert_allclose(_f32(o), _f32(o_ref), atol=TOL["float32"])

    @pytest.mark.parametrize("S", [192, 200])
    def test_reference_wrapper_attends_to_its_padding(self, S):
        """The reference caveat the port avoids: ``ops.swa_attention`` pads S
        to its default block of 128 and, non-causal, gives the padded keys
        softmax weight; its own oracle does not."""
        arrs = _inputs(1, S, 2, 2, 64, seed=S)
        j = [jnp.asarray(a) for a in arrs]
        padded = jops.swa_attention(*j, window=None, causal=False)
        oracle = jref.swa_attention_ref(*j, window=None, causal=False)
        assert np.abs(_f32(padded) - _f32(oracle)).max() > 1e-2
        port = ops.swa_attention(*_port(arrs), window=None, causal=False)
        np.testing.assert_allclose(_f32(port), _f32(oracle), atol=TOL["float32"])

    def test_window_blocks_are_skipped(self):
        """tests/test_kernels.py's poison test: keys and values far outside
        every query's window have no influence."""
        q, k, v = _inputs(1, 256, 1, 1, 64, seed=0)
        o1 = ops.swa_attention(*_port([q, k, v]), window=64)
        k[:, :64] = 1e4
        v[:, :64] = 1e4
        o2 = ops.swa_attention(*_port([q, k, v]), window=64)
        np.testing.assert_allclose(o1[:, 192:].numpy(), o2[:, 192:].numpy(), atol=1e-5)

    @pytest.mark.parametrize("H,Hkv,hd,window", [(4, 2, 64, 32), (8, 2, 128, None),
                                                 (4, 1, 64, 48)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_grouped_kv_matches_repeated_kv(self, H, Hkv, hd, window, dtype):
        """GQA by index (query head h reads KV head h // (H / H_kv)) equals
        the reference kernel on KV repeated per group, as the model path of
        tests/test_kernels.py::test_matches_model_attention builds it."""
        q, k, v = _inputs(2, 128, H, Hkv, hd, dtype, seed=H + Hkv)
        rep = [jnp.repeat(jnp.asarray(t), H // Hkv, axis=2) for t in (k, v)]
        o_jax = jops.swa_attention(jnp.asarray(q), *rep, window=window,
                                   block_q=64, block_k=64)
        o = ops.swa_attention(*_port([q, k, v]), window=window)
        np.testing.assert_allclose(_f32(o), _f32(o_jax), atol=TOL[dtype])

    def test_bad_window_raises(self):
        q, k, v = _port(_inputs(1, 8, 1, 1, 64))
        with pytest.raises(ValueError, match="window"):
            ops.swa_attention(q, k, v, window=0)

    def test_kernel_refuses_cpu_and_unknown_devices(self):
        """The kernel refuses CPU tensors; a device other than CUDA, CPU
        and meta raises; meta takes the plain version, shapes alone."""
        q, k, v = _port(_inputs(1, 8, 1, 1, 64))
        with pytest.raises(ValueError, match="CUDA"):
            gram.swa_flash_cuda(q, k, v, window=None)
        o = ops.swa_attention(*(t.to("meta") for t in (q, k, v)), window=None)
        assert (o.device.type, o.shape, o.dtype) == ("meta", q.shape, q.dtype)
        with pytest.raises(ValueError, match="device"):
            ops.on_card(torch.device("xpu"), "swa_attention")


# --- a numpy model of csrc/swa_flash.cu's schedule ----------------------------

def _kv_block_range(q0: int, S: int, window, causal: bool) -> range:
    """The KV blocks the kernel walks for the query block starting at q0."""
    q_last = min(q0 + BLOCK - 1, S - 1)
    k_lo = max(0, q0 - window + 1) if window is not None else 0
    k_hi = q_last if causal else S - 1
    return range(k_lo // BLOCK, k_hi // BLOCK + 1)


def _keep(q_pos, k_pos, S, window, causal):
    """The kernel's per-element rule: key inside S, causal, in the window."""
    rel = q_pos[:, None] - k_pos[None, :]
    ok = np.broadcast_to(k_pos[None, :] < S, rel.shape).copy()
    if causal:
        ok &= rel >= 0
    if window is not None:
        ok &= rel < window
    return ok


def _kernel_model(q, k, v, window, causal):
    """float32 online softmax over 64-key blocks, 64-row query blocks,
    zero-filled ragged tiles, rows past S never stored."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    scale = np.float32(hd ** -0.5)
    out = np.zeros_like(q)
    n_blocks = -(-S // BLOCK)
    for b in range(B):
        for h in range(H):
            for qb in range(n_blocks):
                q0 = qb * BLOCK
                Q = np.zeros((BLOCK, hd), np.float32)
                Q[:min(BLOCK, S - q0)] = q[b, q0:q0 + BLOCK, h]
                q_pos = q0 + np.arange(BLOCK)
                m = np.full(BLOCK, -1e30, np.float32)
                l = np.zeros(BLOCK, np.float32)
                acc = np.zeros((BLOCK, hd), np.float32)
                for kb in _kv_block_range(q0, S, window, causal):
                    k0 = kb * BLOCK
                    Kt = np.zeros((BLOCK, hd), np.float32)
                    Vt = np.zeros((BLOCK, hd), np.float32)
                    Kt[:min(BLOCK, S - k0)] = k[b, k0:k0 + BLOCK, h // group]
                    Vt[:min(BLOCK, S - k0)] = v[b, k0:k0 + BLOCK, h // group]
                    s = (Q @ Kt.T) * scale
                    s = np.where(_keep(q_pos, k0 + np.arange(BLOCK), S, window, causal),
                                 s, np.float32(-1e30))
                    m_new = np.maximum(m, s.max(1))
                    alpha = np.exp(m - m_new)
                    p = np.exp(s - m_new[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ Vt
                    m = m_new
                rows = min(BLOCK, S - q0)
                out[b, q0:q0 + rows, h] = (acc / np.maximum(l, 1e-30)[:, None])[:rows]
    return out


def _edge_block(q0: int, k0: int, S: int, window, causal: bool) -> bool:
    """The bf16 routine's test for a KV block that needs the mask: it holds
    keys >= S, crosses the diagonal, or reaches the window's far edge."""
    return (k0 + BLOCK > S or (causal and k0 + BLOCK - 1 > q0)
            or (window is not None and q0 + BLOCK - 1 - k0 >= window))


def _bf16(x) -> np.ndarray:
    """Round float32 values to bf16 (nearest even) and back, as the card's
    ``__floats2bfloat162_rn``."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _kernel_model_bf16(q, k, v, window, causal, *, split_p=True, mask_every_block=False):
    """The bf16 tensor-core routine: scores in float32 from bf16 q, k (whose
    products are exact in float32), scaled into the log2 domain, masked only
    on edge blocks, exp2 online softmax; P @ V as P_hi V + P_lo V with
    P_hi = bf16(p) and P_lo = bf16(p - P_hi) (``split_p=False``: P_hi V
    alone), float32 sums; the output rounded to bf16."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    scale_log2 = np.float32(np.float32(hd ** -0.5) * np.float32(np.log2(np.e)))
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for h in range(H):
            for q0 in range(0, S, BLOCK):
                Q = np.zeros((BLOCK, hd), np.float32)
                Q[:min(BLOCK, S - q0)] = q[b, q0:q0 + BLOCK, h]
                q_pos = q0 + np.arange(BLOCK)
                m = np.full(BLOCK, -1e30, np.float32)
                l = np.zeros(BLOCK, np.float32)
                acc = np.zeros((BLOCK, hd), np.float32)
                for kb in _kv_block_range(q0, S, window, causal):
                    k0 = kb * BLOCK
                    Kt = np.zeros((BLOCK, hd), np.float32)
                    Vt = np.zeros((BLOCK, hd), np.float32)
                    Kt[:min(BLOCK, S - k0)] = k[b, k0:k0 + BLOCK, h // group]
                    Vt[:min(BLOCK, S - k0)] = v[b, k0:k0 + BLOCK, h // group]
                    s = (Q @ Kt.T) * scale_log2
                    if mask_every_block or _edge_block(q0, k0, S, window, causal):
                        s = np.where(_keep(q_pos, k0 + np.arange(BLOCK), S, window, causal),
                                     s, np.float32(-1e30))
                    m_new = np.maximum(m, s.max(1))
                    alpha = np.exp2(m - m_new)
                    p = np.exp2(s - m_new[:, None])
                    l = l * alpha + p.sum(1)
                    p_hi = _bf16(p)
                    acc = acc * alpha[:, None] + p_hi @ Vt
                    if split_p:
                        acc = acc + _bf16(p - p_hi) @ Vt
                    m = m_new
                rows = min(BLOCK, S - q0)
                out[b, q0:q0 + rows, h] = (acc / np.maximum(l, 1e-30)[:, None])[:rows]
    return _bf16(out)


def _bf16_ulps(o, p) -> float:
    """chip_smoke.py's check: worst |o - p| / (2^-7 |p| + 1e-4); one bf16 ulp
    of the plain value passes (<= 1)."""
    o, p = np.asarray(o, np.float64), np.asarray(p, np.float64)
    return float((np.abs(o - p) / (np.abs(p) * 2.0 ** -7 + 1e-4)).max())


class TestKernelSchedule:
    @pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 1100])
    @pytest.mark.parametrize("window", [None, 1, 48, 1024])
    @pytest.mark.parametrize("causal", [True, False])
    def test_block_range_is_exactly_the_blocks_with_a_kept_pair(self, S, window, causal):
        k_pos = np.arange(S)
        for q0 in range(0, S, BLOCK):
            q_pos = np.arange(q0, min(q0 + BLOCK, S))
            ok = _keep(q_pos, k_pos, S, window, causal)
            needed = {int(kk) // BLOCK for kk in np.nonzero(ok.any(0))[0]}
            assert set(_kv_block_range(q0, S, window, causal)) == needed
            assert ok.any(1).all()        # no row of the sequence is fully masked

    @pytest.mark.parametrize("S,window", [(200, None), (200, 1), (200, 48),
                                          (1100, 1024), (1000, 48)])
    @pytest.mark.parametrize("causal", [True, False])
    def test_kernel_model_equals_plain_version(self, S, window, causal):
        q, k, v = _inputs(1, S, 2, 1, 128, seed=S)
        model = _kernel_model(q, k, v, window, causal)
        plain = ref.swa_attention_ref(*_port([q, k, v]), window=window, causal=causal)
        np.testing.assert_allclose(model, plain.numpy(), atol=TOL["float32"])

    @pytest.mark.parametrize("S,window", [(1500, None), (200, 48), (65, 1)])
    @pytest.mark.parametrize("causal", [True, False])
    def test_kernel_model_equals_plain_version_at_hd80(self, S, window, causal):
        """The float32 schedule at hubert-xlarge's head_dim 80, its S 1500."""
        q, k, v = _inputs(1, S, 2, 2, 80, seed=S + 80)
        model = _kernel_model(q, k, v, window, causal)
        plain = ref.swa_attention_ref(*_port([q, k, v]), window=window, causal=causal)
        np.testing.assert_allclose(model, plain.numpy(), atol=TOL["float32"])

    @pytest.mark.parametrize("S,window", [(4096, 1024), (4096, None)])
    def test_kept_pairs_of_the_serving_shape(self, S, window):
        """The kept pairs per (batch, head) that K5's bound in chip_smoke.py
        counts: 3,670,528 for the SWA layers, S(S+1)/2 for the full ones."""
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        pairs = chip_smoke.swa_pairs(S, window, True)
        want = {1024: 3_670_528, None: S * (S + 1) // 2}[window]
        assert pairs == want
        q_pos = np.arange(0, S, 7)           # spot rows against the mask rule
        ok = _keep(q_pos, np.arange(S), S, window, True)
        per_row = np.minimum(q_pos + 1, window or S)
        assert (ok.sum(1) == per_row).all()


class TestTensorCoreSchedule:
    """The bf16 routine of csrc/swa_flash.cu (mma.sync): 64-row query blocks,
    64-key blocks, the mask only on edge blocks, P split into bf16 hi and
    lo parts."""

    @pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 1100])
    @pytest.mark.parametrize("window", [None, 1, 48, 1024])
    @pytest.mark.parametrize("causal", [True, False])
    def test_edge_blocks_are_exactly_the_blocks_with_a_dropped_pair(self, S, window, causal):
        for q0 in range(0, S, BLOCK):
            q_pos = q0 + np.arange(BLOCK)            # all 64 rows, also those >= S
            for kb in _kv_block_range(q0, S, window, causal):
                k0 = kb * BLOCK
                ok = _keep(q_pos, k0 + np.arange(BLOCK), S, window, causal)
                assert _edge_block(q0, k0, S, window, causal) == (not ok.all())

    @pytest.mark.parametrize("S,window,causal,hd,group", [
        (200, None, True, 64, 2), (200, 48, True, 128, 1), (130, 3, True, 64, 2),
        (1, None, True, 128, 1), (65, 1, True, 64, 1), (256, 1024, False, 128, 2),
        (200, 48, False, 64, 1), (1100, 1024, True, 64, 2),
        # head_dim 80 (hubert-xlarge: 5 k-steps of 16), its ragged S 1500
        # non-causal, and causal, windowed and grouped cases
        (1500, None, False, 80, 1), (65, 1, False, 80, 1), (200, 48, True, 80, 2),
        (130, None, True, 80, 1)])
    def test_model_within_one_bf16_ulp_of_plain(self, S, window, causal, hd, group):
        """The hi/lo split keeps P @ V at float32 accuracy: every element
        within one bf16 ulp of the plain version, chip_smoke.py's limit; and
        skipping the mask on interior blocks changes no bit."""
        q, k, v = (_bf16(a) for a in _inputs(1, S, 2, 2 // group, hd, seed=S + hd))
        plain = ref.swa_attention_ref(*(t.bfloat16() for t in _port([q, k, v])),
                                      window=window, causal=causal)
        model = _kernel_model_bf16(q, k, v, window, causal)
        assert _bf16_ulps(model, _f32(plain)) <= 1
        assert np.array_equal(
            model, _kernel_model_bf16(q, k, v, window, causal, mask_every_block=True))

    @pytest.mark.parametrize("hd", [64, 80, 128])
    def test_ldmatrix_rows_land_on_distinct_banks(self, hd):
        """The padded shared-memory row (hd + 8 bf16, csrc/swa_flash.cu's
        kLd): the 8 rows that one ``ldmatrix`` phase reads, 16 bytes each at
        one column offset, fall on 8 distinct groups of 4 of the 32 banks,
        at every column offset the kernel reads from, so no phase conflicts."""
        row_words = (hd + 8) * 2 // 4
        for col in range(0, hd, 8):                    # 16-byte chunks
            for row0 in range(0, BLOCK, 8):
                groups = {((row0 + r) * row_words + col // 2) % 32 // 4 for r in range(8)}
                assert len(groups) == 8, (hd, col, row0)
        # unpadded rows (hd elements) would put all 8 rows on one group
        assert len({(r * hd // 2) % 32 // 4 for r in range(8)}) < 8

    @pytest.mark.parametrize("S,window", [(200, None), (130, 3), (1100, 1024)])
    def test_bf16_only_p_breaks_the_check(self, S, window):
        """Why P is split: P rounded once to bf16 before P @ V (2^-9 relative
        per weight) lands many bf16 ulps from the plain value."""
        q, k, v = (_bf16(a) for a in _inputs(1, S, 2, 1, 64, seed=S))
        plain = _f32(ref.swa_attention_ref(*(t.bfloat16() for t in _port([q, k, v])),
                                           window=window))
        assert _bf16_ulps(_kernel_model_bf16(q, k, v, window, True, split_p=False),
                          plain) > 2

    @pytest.mark.parametrize("S,window", [(200, 48), (1000, 48), (4096, 1024), (4096, None)])
    def test_bf16_matches_pallas_kernel(self, S, window):
        """The model against the reference's Pallas kernel in interpret mode
        at tests/test_kernels.py's bf16 tolerance, the serving shape's S
        included (one head: interpret mode is slow)."""
        B, H, hd = 1, 1, 128 if S < 4096 else 64
        q, k, v = _inputs(B, S, H, H, hd, "bfloat16", seed=S)
        o_jax = jops.swa_attention(*(jnp.asarray(a) for a in (q, k, v)), window=window,
                                   block_q=128 if S % 128 == 0 else 64,
                                   block_k=128 if S % 128 == 0 else 64)
        model = _kernel_model_bf16(*(_f32(a) for a in (q, k, v)), window, True)
        np.testing.assert_allclose(model, _f32(o_jax), atol=TOL["bfloat16"])
