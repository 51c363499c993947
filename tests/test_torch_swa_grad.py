"""The gradient of the port's attention (``ops.swa_attention``) against the
reference's.

The reference's attention has no kernel of its own to differentiate: JAX
takes the vjp of its masked-softmax ``swa_attention_ref``. The port keeps K5
as the forward and computes the backward with ``ref.swa_attention_bwd``;
here, on the CPU, the forward is K5's plain version. The same numpy inputs
and output gradient go to ``jax.vjp(repro.kernels.ref.swa_attention_ref)``,
whose q, k, v have equal head counts, so a grouped (GQA) case repeats each
KV head over its query group on the JAX side and sums the repeated heads'
gradients back. Float32 at 1e-5 of each gradient's largest magnitude; the
same against ``torch.autograd`` through the port's own plain forward.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = 1e-5


def _inputs(B, S, H, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd), (B, S, H, hd))]


def _jax_grads(q, k, v, do, window, causal):
    """jax.vjp of the reference's attention, KV heads repeated over their
    query group and their gradients summed back."""
    group = q.shape[2] // k.shape[2]
    kr, vr = (jnp.repeat(jnp.asarray(t), group, axis=2) for t in (k, v))
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.swa_attention_ref(
        q_, k_, v_, window=window, causal=causal), jnp.asarray(q), kr, vr)
    dq, dk, dv = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    B, S, _, hd = k.shape
    fold = lambda g: g.reshape(B, S, k.shape[2], group, hd).sum(3)   # noqa: E731
    return dq, fold(dk), fold(dv)


def _close(x, ref_, tol=TOL):
    x = x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    np.testing.assert_allclose(x, ref_, rtol=0, atol=tol * float(np.abs(ref_).max()))


# (B, S, H, Hkv, hd, window, causal): causal, windowed, non-causal, ragged S
# past one 256-query block, GQA groups 1, 2, 4, head_dim 64, 80 and 128
CASES = [
    (2, 64, 2, 2, 64, None, True),
    (1, 300, 4, 2, 64, None, True),
    (1, 300, 4, 1, 64, 48, True),
    (2, 130, 2, 2, 80, None, False),
    (1, 300, 2, 1, 80, 64, False),
    (1, 520, 4, 1, 128, 200, True),
    (1, 257, 2, 2, 128, None, False),
    (2, 96, 4, 2, 128, 32, True),
]


@pytest.mark.parametrize("B,S,H,Hkv,hd,window,causal", CASES)
def test_bwd_matches_jax_vjp(B, S, H, Hkv, hd, window, causal):
    q, k, v, do = _inputs(B, S, H, Hkv, hd, seed=S + hd)
    want = _jax_grads(q, k, v, do, window, causal)
    got = ref.swa_attention_bwd(*(torch.from_numpy(t) for t in (q, k, v, do)),
                                window=window, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("B,S,H,Hkv,hd,window,causal", CASES)
def test_op_gradient_matches_autograd_through_plain(B, S, H, Hkv, hd, window, causal):
    """``ops.swa_attention`` under autograd (the Function: forward, then
    ``swa_attention_bwd``) against autograd through the plain forward."""
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(B, S, H, Hkv, hd, seed=S))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.swa_attention(*leaves, window=window, causal=causal)
    assert out.grad_fn is not None
    out.backward(do)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.swa_attention_ref(*plain, window=window, causal=causal).backward(do)
    torch.testing.assert_close(out.detach(), ref.swa_attention_ref(q, k, v, window=window,
                                                                   causal=causal),
                               rtol=0, atol=0)
    for a, b in zip(leaves, plain):
        _close(a.grad, b.grad.numpy())


def test_bwd_bf16_grads_in_input_dtype():
    q, k, v, do = (torch.from_numpy(t.astype(ml_dtypes.bfloat16).astype(np.float32))
                   .bfloat16() for t in _inputs(1, 200, 4, 2, 64, seed=3))
    got = ref.swa_attention_bwd(q, k, v, do, window=64, causal=True)
    f32 = ref.swa_attention_bwd(q.float(), k.float(), v.float(), do.float(),
                                window=64, causal=True)
    for g, w in zip(got, f32):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.bfloat16())      # float32 inside, rounded once


def test_serving_call_records_nothing():
    """No input requiring grad, or grad mode off: the bare forward (no
    ``grad_fn``, nothing saved), bitwise the recorded call's output."""
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(1, 64, 2, 1, 64))
    bare = ops.swa_attention(q, k, v, window=16)
    assert bare.grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.swa_attention(qg, k, v, window=16).grad_fn is None
    recorded = ops.swa_attention(qg, k, v, window=16)
    assert recorded.grad_fn is not None and torch.equal(recorded.detach(), bare)


def test_only_q_requires_grad():
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(1, 80, 2, 2, 64, seed=9))
    qg = q.clone().requires_grad_(True)
    ops.swa_attention(qg, k, v, window=None, causal=True).backward(do)
    dq, _, _ = ref.swa_attention_bwd(q, k, v, do, window=None, causal=True)
    assert torch.equal(qg.grad, dq)


def test_backward_range_is_labelled():
    """The backward runs inside one ``attn.bwd`` profiler range, which the
    card smoke's step split reads."""
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(1, 64, 2, 2, 64))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ops.swa_attention(*leaves, window=None).backward(do)
    assert any(e.key == "attn.bwd" for e in prof.key_averages())
