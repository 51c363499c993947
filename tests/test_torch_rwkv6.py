"""The port's RWKV6 layer and rwkv6-1.6b against the reference.

The time mix and channel mix (``models/rwkv6.py``) are held to the
reference's on the reduced rwkv6 config, with parameters from the
reference's ``init_rwkv`` / ``init_channel_mix`` and inputs made with numpy
from a seed: outputs, the final state S and the decode cache within 1e-5 of
the reference's largest magnitude in float32, at the same chunk on both
sides (64: one chunk at S 64, two at S 128, two of 48 at a ragged S 96), and
in bf16 within 1e-2 (about 2.5 bf16 ulps at the largest magnitude, as the
Mamba layer is held). The reduced rwkv6 (two RWKV layers) runs with the
reference's ``init_params`` carried over by ``convert.model_params_from``:
forward logits, prefill caches and teacher-forced decode within 1e-4 of the
largest magnitude, and the greedy tokens of the reference's ``serve``.

The reference's ``rwkv_time_mix`` with ``chunk_size=None`` (the default of
its ``forward`` and ``prefill_step``) runs the whole sequence as one chunk,
where ``exp(-cumsum(log w))`` overflows float32 past ~88 of summed
log-decay: ``TestOneChunkCaveat`` pins that, and that the port's fixed
chunk of 64 stays finite and equal to the reference's chunked forward.
``TestBf16Noise`` pins a second: deeper random-weight stacks in bf16 miss
the reference's own decode-consistency tolerance in both packages.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import rwkv6 as jrwkv
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import blocks, config, layers, model, rwkv6
from test_torch_models import BATCH, GEN, PROMPT, _close, _jax_layer_caches, _tokens, \
    _tree_size

ARCH = "rwkv6-1.6b"
TOL, BF16_TOL = 1e-5, 1e-2
FULL_PARAMS = 1_580_795_904


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype),
            dataclasses.replace(configs.get_reduced(ARCH), dtype=dtype))


def _fill(module, params) -> None:
    for name, p in module.named_parameters():
        p.copy_(convert.tensor_from_numpy(np.asarray(params[name]), device="cpu"))


@functools.cache
def _layer(dtype="float32"):
    """(reference time mix, channel mix, port time mix, channel mix, jax
    cfg, port cfg) for one layer."""
    jcfg, tcfg = _cfgs(dtype)
    ptm = jrwkv.init_rwkv(jax.random.PRNGKey(0), jcfg)
    pcm = jrwkv.init_channel_mix(jax.random.PRNGKey(1), jcfg)
    tdt = getattr(torch, dtype)
    tm = rwkv6.RWKVTimeMix(tcfg, dtype=tdt, device="cpu")
    cm = rwkv6.RWKVChannelMix(tcfg, dtype=tdt, device="cpu")
    _fill(tm, ptm)
    _fill(cm, pcm)
    return ptm, pcm, tm, cm, jcfg, tcfg


@functools.cache
def _jax_time_mix(jcfg, chunk):
    return jax.jit(functools.partial(jrwkv.rwkv_time_mix, cfg=jcfg, chunk_size=chunk,
                                     return_state=True))


def _x(S, B=2, seed=0, d=256):
    return np.random.default_rng(seed).standard_normal((B, S, d), dtype=np.float32)


def _norms(tcfg, seed):
    """Two RMSNorms with random scales, and the reference's param dicts."""
    rng = np.random.default_rng(seed)
    mods, trees = [], []
    for _ in range(2):
        scale = (1 + 0.3 * rng.standard_normal(tcfg.d_model)).astype(np.float32)
        n = layers.RMSNorm(tcfg.d_model, tcfg.norm_eps, dtype=torch.float32, device="cpu")
        n.scale.copy_(torch.from_numpy(scale))
        mods.append(n)
        trees.append({"scale": jnp.asarray(scale)})
    return mods, trees


class TestTimeMix:
    @pytest.mark.parametrize("S", [64, 128, 96])
    @pytest.mark.parametrize("chunk", [64, 16, 1])
    def test_time_mix_matches_reference(self, S, chunk):
        """Output and final state at the same chunk on both sides; at S 96
        ``pick_chunk`` gives 48 for 64 on both. At chunk 1 the port's groups
        of ``GROUP_CHUNKS`` = 64 chunks split S 128 in two and S 96 into 64
        and 32, carrying the state between groups."""
        ptm, _, tm, _, jcfg, tcfg = _layer()
        x = _x(S, seed=S)
        ry, rS = _jax_time_mix(jcfg, chunk)(ptm, jnp.asarray(x))
        ty, tS = rwkv6.rwkv_time_mix(tm, torch.from_numpy(x), tcfg, chunk_size=chunk,
                                     return_state=True)
        _close(ty, ry, TOL)
        assert tS.dtype == torch.float32
        assert tuple(tS.shape) == (2, tcfg.rwkv_heads, tcfg.rwkv_head_dim,
                                   tcfg.rwkv_head_dim)
        _close(tS, rS, TOL)
        assert layers.pick_chunk(96, 64) == jlayers.pick_chunk(96, 64) == 48

    def test_head_norm_uses_the_population_variance(self):
        """Mean and population variance over hd (``jnp.var``), then rsqrt(var
        + eps) x ln_scale; torch's default unbiased variance would differ."""
        ptm, _, tm, _, jcfg, tcfg = _layer()
        rng = np.random.default_rng(3)
        scale = (1 + 0.5 * rng.standard_normal(tm.ln_scale.shape)).astype(np.float32)
        y = (2 + 3 * rng.standard_normal((2, 5, tcfg.rwkv_heads, tcfg.rwkv_head_dim))
             ).astype(np.float32)
        params = {**ptm, "ln_scale": jnp.asarray(scale)}
        ref = np.asarray(jrwkv._head_norm(params, jnp.asarray(y), jcfg.norm_eps))
        tm2 = rwkv6.RWKVTimeMix(tcfg, dtype=torch.float32, device="cpu")
        tm2.ln_scale.copy_(torch.from_numpy(scale))
        got = rwkv6._head_norm(tm2, torch.from_numpy(y), tcfg.norm_eps)
        _close(got, ref, 1e-6)
        yt = torch.from_numpy(y)
        mu = yt.mean(-1, keepdim=True)
        unbiased = (yt - mu) * torch.rsqrt(yt.var(-1, keepdim=True) + tcfg.norm_eps)
        assert float((unbiased * tm2.ln_scale - got).abs().max()) > 1e-3

    @pytest.mark.parametrize("with_prev", [False, True])
    def test_channel_mix_matches_reference(self, with_prev):
        _, pcm, _, cm, _, _ = _layer()
        x = _x(40, seed=5)
        prev = np.random.default_rng(6).standard_normal((2, 256), dtype=np.float32)
        jp, tp = (jnp.asarray(prev), torch.from_numpy(prev)) if with_prev else (None, None)
        ref = jrwkv.rwkv_channel_mix(pcm, jnp.asarray(x), jp)
        got = rwkv6.rwkv_channel_mix(cm, torch.from_numpy(x), tp)
        _close(got, ref, TOL)
        if with_prev:   # the shift reads prev at position 0 only
            plain = rwkv6.rwkv_channel_mix(cm, torch.from_numpy(x))
            assert torch.equal(plain[:, 1:], got[:, 1:])
            assert not torch.equal(plain[:, 0], got[:, 0])

    @pytest.mark.parametrize("S", [64, 96])
    def test_bf16_casts(self, S):
        """bf16 parameters and input (float32 w0, u, ln_scale): the output
        stays bf16 and S float32, both within BF16_TOL of the reference's
        bf16; the channel mix too. The port's bf16 output is nearer the
        reference's than a float32 model's is."""
        ptm, pcm, tm, cm, jcfg, tcfg = _layer("bfloat16")
        assert tm.w0.dtype == tm.u.dtype == tm.ln_scale.dtype == torch.float32
        assert tm.wr.dtype == tm.mix.dtype == tm.wB.dtype == torch.bfloat16
        x = _x(S)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        ry, rS = _jax_time_mix(jcfg, 64)(ptm, xb)
        xt = torch.from_numpy(x).bfloat16()
        ty, tS = rwkv6.rwkv_time_mix(tm, xt, tcfg, chunk_size=64, return_state=True)
        assert (ty.dtype, tS.dtype) == (torch.bfloat16, torch.float32)
        ry32 = np.asarray(ry, np.float32)
        _close(ty, ry32, BF16_TOL)
        _close(tS, rS, BF16_TOL)
        rc = jrwkv.rwkv_channel_mix(pcm, xb)
        tc = rwkv6.rwkv_channel_mix(cm, xt)
        assert tc.dtype == torch.bfloat16
        _close(tc, np.asarray(rc, np.float32), BF16_TOL)
        tm32 = rwkv6.RWKVTimeMix(tcfg, dtype=torch.float32, device="cpu")
        tm32.load_state_dict({k: v.float() for k, v in tm.state_dict().items()})
        y32 = rwkv6.rwkv_time_mix(tm32, xt.float(), dataclasses.replace(tcfg, dtype="float32"),
                                  chunk_size=64)
        assert np.abs(y32.numpy() - ry32).max() > np.abs(ty.float().numpy() - ry32).max()

    def test_decode_from_a_given_cache(self):
        """Three single steps of the whole layer (norms with random scales)
        from a random cache: outputs, S and both shifts."""
        ptm, pcm, tm, cm, jcfg, tcfg = _layer()
        (n1, n2), (j1, j2) = _norms(tcfg, 9)
        rng = np.random.default_rng(7)
        H, hd = tcfg.rwkv_heads, tcfg.rwkv_head_dim
        c = {"S": rng.standard_normal((2, H, hd, hd), dtype=np.float32),
             "x_tm": rng.standard_normal((2, 256), dtype=np.float32),
             "x_cm": rng.standard_normal((2, 256), dtype=np.float32)}
        jc = {k: jnp.asarray(v) for k, v in c.items()}
        tc = {k: torch.from_numpy(v) for k, v in c.items()}
        x = _x(3, seed=8)
        for t in range(3):
            jo, jc = jrwkv.rwkv_decode(ptm, pcm, j1, j2, jnp.asarray(x[:, t:t + 1]), jc,
                                       jcfg, jcfg.norm_eps)
            to, tc = rwkv6.rwkv_decode(tm, cm, n1, n2, torch.from_numpy(x[:, t:t + 1]), tc,
                                       tcfg)
            _close(to, jo, TOL)
            assert set(tc) == set(jc)
            for key in jc:
                _close(tc[key], jc[key], TOL)

    @pytest.mark.parametrize("S", [64, 96, 2])
    def test_prefill_then_decode_equals_prefill(self, S):
        """Within the port, one whole layer: a prefill of S - 1 positions and
        one decode step give the S-position prefill's last output and its
        cache (S, and the shifts, which are the normed inputs)."""
        _, _, tm, cm, _, tcfg = _layer()
        layer = blocks.Layer(tcfg, config.LayerSpec("rwkv"), dtype=torch.float32,
                             device="cpu")
        layer.rwkv_tm.load_state_dict(tm.state_dict())
        layer.rwkv_cm.load_state_dict(cm.state_dict())
        (n1, n2), _ = _norms(tcfg, 11)
        layer.norm1.load_state_dict(n1.state_dict())
        layer.norm2.load_state_dict(n2.state_dict())
        x = torch.from_numpy(_x(S, seed=S))
        y, cache = blocks.prefill_layer(layer, x, tcfg)
        assert cache["x_tm"].data_ptr() != layer.norm1(x).data_ptr()
        _close(cache["x_tm"], layer.norm1(x)[:, -1], 0)
        _, c = blocks.prefill_layer(layer, x[:, :-1], tcfg)
        o, c = blocks.decode_layer(layer, x[:, -1:], c, S - 1, tcfg)
        _close(o, y[:, -1:], TOL)
        for key in ("S", "x_tm", "x_cm"):
            _close(c[key], cache[key], TOL)
        _close(blocks.apply_layer(layer, x, tcfg), y, 0)

    def test_init_rwkv_cache_layout(self):
        _, _, _, _, jcfg, tcfg = _layer()
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            jc = jrwkv.init_rwkv_cache(jcfg, 3, jdt)
            tc = rwkv6.init_rwkv_cache(tcfg, 3, dt, "cpu")
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in tc.items()} == {k: (v.shape, v.dtype.name)
                                                for k, v in jc.items()}
            assert tc["S"].dtype == torch.float32
            assert not any(v.any() for v in tc.values())

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_init_draws_the_reference_distributions(self, dtype):
        """The reference's leaves, shapes and dtypes (w0, u and ln_scale
        float32 in a bf16 model too); mix on [0, 1), w0 = -0.5, ln_scale
        ones, u's 0.1, wB's 0.01, the projections' in_dim^-0.5; the same
        generator seed draws the same weights."""
        ptm, pcm, _, _, _, tcfg = _layer(dtype)
        tdt = getattr(torch, dtype)
        gen = torch.Generator().manual_seed(0)
        tm = rwkv6.RWKVTimeMix(tcfg, dtype=tdt, device="cpu")
        cm = rwkv6.RWKVChannelMix(tcfg, dtype=tdt, device="cpu")
        tm.reset_parameters(gen)
        cm.reset_parameters(gen)
        for mod, ref in ((tm, ptm), (cm, pcm)):
            assert {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
                    for n, p in mod.named_parameters()} == \
                {n: (a.shape, a.dtype.name) for n, a in ref.items()}
            mix = mod.mix.float()
            assert float(mix.min()) >= 0 and float(mix.max()) < 1
            assert abs(float(mix.mean()) - 0.5) < 0.02
        assert bool((tm.w0 == -0.5).all()) and bool((tm.ln_scale == 1).all())
        assert abs(float(tm.u.std()) / 0.1 - 1) < 0.1
        assert abs(float(tm.wB.float().std()) / 0.01 - 1) < 0.05
        for w in (tm.wr, tm.wk, tm.wv, tm.wg, tm.wo, tm.wA, cm.wk, cm.wv, cm.wr):
            w = w.float()
            assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.05
        again = rwkv6.RWKVTimeMix(tcfg, dtype=tdt, device="cpu")
        again.reset_parameters(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in zip(tm.parameters(), again.parameters()))


@functools.cache
def _models(dtype="float32"):
    """(jax params, port model, jax cfg, port cfg), built once per dtype."""
    jcfg, tcfg = _cfgs(dtype)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    lm = convert.model_params_from(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return params, lm, jcfg, tcfg


class TestRWKV6:
    def test_config_and_counts(self):
        """The registry's configs are the reference's, field for field; the
        count is the reference tree's, full (1,580,795,904: the whole model,
        3.16 GB in bf16) and reduced, and a meta-device build's."""
        for get_j, get_t in ((jconfigs.get, configs.get),
                             (jconfigs.get_reduced, configs.get_reduced)):
            j, t = get_j(ARCH), get_t(ARCH)
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert t.param_count() == j.param_count() == _tree_size(j)
            assert sum(p.numel() for p in model.BackboneLM(t, device="meta").parameters()) \
                == t.param_count()
        full = configs.get(ARCH)
        assert full.param_count() == full.active_param_count() == FULL_PARAMS
        assert (full.num_layers, full.rwkv_heads) == (24, 32)
        assert ARCH in configs.PORTED

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_convert_carries_every_leaf(self, dtype):
        """Every port parameter is its reference leaf, bit for bit; a bf16
        tree keeps float32 w0, u and ln_scale, and a float32 leaf anywhere
        else raises, as does a bf16 w0."""
        params, lm, _, tcfg = _models(dtype)
        assert sum(p.numel() for p in lm.parameters()) == tcfg.param_count()
        for s, stage in enumerate(lm.stages):
            for i, layer in enumerate(stage):
                for name, p in layer.named_parameters():
                    leaf = params["stages"][i]
                    for key in name.split("."):
                        leaf = leaf[key]
                    np.testing.assert_array_equal(p.float().numpy(),
                                                  np.asarray(leaf[s], np.float32))
                    assert str(p.dtype).removeprefix("torch.") == np.asarray(leaf).dtype.name
        tm = lm.stages[0][0].rwkv_tm
        assert tm.w0.dtype == tm.u.dtype == tm.ln_scale.dtype == torch.float32
        if dtype == "float32":
            return
        p = jax.tree.map(np.asarray, params)
        for path in (("rwkv_tm", "wB"), ("rwkv_cm", "mix"), ("norm2", "scale")):
            bad = jax.tree.map(lambda a: a, p)
            bad["stages"][0][path[0]][path[1]] = \
                bad["stages"][0][path[0]][path[1]].astype(np.float32)
            with pytest.raises(ValueError, match="model wants bfloat16"):
                convert.model_params_from(bad, tcfg, device="cpu")
        bad = jax.tree.map(lambda a: a, p)
        bad["stages"][0]["rwkv_tm"]["w0"] = bad["stages"][0]["rwkv_tm"]["w0"].astype(
            p["embed"]["table"].dtype)
        with pytest.raises(ValueError, match="model wants float32"):
            convert.model_params_from(bad, tcfg, device="cpu")

    def test_forward_logits(self):
        params, lm, jcfg, _ = _models()
        toks = _tokens()
        ref, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, jcfg, chunk_size=64)
        _close(model.forward(lm, {"tokens": torch.from_numpy(toks)}), ref)

    @pytest.mark.parametrize("batch", [BATCH, 4])
    def test_prefill_and_teacher_forced_decode(self, batch):
        """Prefill caches (S, x_tm, x_cm of both layers) and each decode
        step's logits against the reference's ``prefill_step`` at its
        serve's chunk 64 and its jitted ``decode_step``."""
        params, lm, jcfg, _ = _models()
        toks = _tokens(PROMPT + GEN, batch)
        jl, jc = jmodel.prefill_step(params, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                                     jcfg, chunk_size=64, max_len=PROMPT + GEN)
        tl, tc = model.prefill_step(lm, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                                    max_len=PROMPT + GEN)
        _close(tl, jl)
        assert tc["pos"] == int(jc["pos"]) == PROMPT
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            assert set(t) == set(j) == {"S", "x_tm", "x_cm"}
            for key in t:
                _close(t[key], j[key])
        decode = jax.jit(lambda p, c, b: jmodel.decode_step(p, c, b, jcfg))
        for pos in range(PROMPT, PROMPT + GEN):
            tok = toks[:, pos:pos + 1]
            jl, jc = decode(params, jc, {"tokens": jnp.asarray(tok)})
            tl, tc = model.decode_step(lm, tc, {"tokens": torch.from_numpy(tok)})
            _close(tl, jl)
        assert tc["pos"] == PROMPT + GEN
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            for key in t:
                _close(t[key], j[key])

    def test_init_decode_cache_matches_reference_layout(self):
        """The reference's layout, and the same bytes at any length: the
        state does not grow with the context."""
        _, _, jcfg, tcfg = _models()
        jc = jmodel.init_decode_cache(jcfg, 2, 100)
        tc = model.init_decode_cache(tcfg, 2, 100, device="cpu")
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in t.items()} == {k: (v.shape, v.dtype.name) for k, v in j.items()}
            assert not any(v.any() for v in t.values())
        long = model.init_decode_cache(tcfg, 2, 32768, device="cpu")

        def nbytes(c):
            return sum(v.numel() * v.element_size() for lc in c["layers"] for v in lc.values())

        assert nbytes(long) == nbytes(tc)

    @pytest.mark.parametrize("S", [PROMPT, 50])
    def test_decode_consistency(self, S):
        """A prefill of S - 1 tokens and one decode step hand the state and
        both shifts over: the S-token forward's last logits at 1e-4 (and so
        at the reference's 3e-2). No position bound: decoding past
        ``max_len`` is fine for an RWKV layer."""
        _, lm, _, _ = _models()
        toks = torch.from_numpy(_tokens(S))
        full = model.forward(lm, {"tokens": toks})
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :-1]}, max_len=S - 1)
        lg, cache = model.decode_step(lm, cache, {"tokens": toks[:, -1:]})
        scale = float(full[:, -1].abs().max())
        err = float((lg[:, 0] - full[:, -1]).abs().max())
        assert err < 3e-2 * max(scale, 1.0) and err < 1e-4 * max(scale, 1.0), err
        assert cache["pos"] == S

    def test_greedy_tokens_equal_the_reference_serve(self):
        res = jserve.serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, seed=0)
        _, lm, jcfg, _ = _models()
        prompts = torch.from_numpy(_tokens(PROMPT, BATCH, seed=0, vocab=jcfg.vocab_size))
        tokens, _ = serve.generate(lm, prompts, GEN)
        np.testing.assert_array_equal(tokens.numpy(), res["generated"])

    def test_serve_report(self):
        res = serve.serve(ARCH, batch=BATCH, prompt_len=40, gen_tokens=5, device="cpu")
        assert set(res) == {"arch", "prefill_s", "decode_s", "decode_tok_per_s", "generated"}
        assert res["arch"] == "rwkv6-reduced"
        assert res["generated"].shape == (BATCH, 5)
        assert ((0 <= res["generated"]) & (res["generated"] < 512)).all()
        again = serve.serve(ARCH, batch=BATCH, prompt_len=40, gen_tokens=5, device="cpu")
        np.testing.assert_array_equal(res["generated"], again["generated"])


class TestOneChunkCaveat:
    def test_reference_one_chunk_overflows_at_256(self):
        """The reference's time mix with ``chunk_size=None`` runs S 256 as
        one chunk: past ~88 of summed log-decay ``exp(-lw_cum)`` is inf and
        ``0 * inf`` NaN, so later rows are not finite; the first 64 are."""
        ptm, _, _, _, jcfg, _ = _layer()
        y, _ = _jax_time_mix(jcfg, None)(ptm, jnp.asarray(_x(256)))
        finite = np.isfinite(np.asarray(y)).all(axis=(0, 2))
        assert finite[:64].all() and not finite.all()
        y64, _ = _jax_time_mix(jcfg, 64)(ptm, jnp.asarray(_x(256)))
        assert np.isfinite(np.asarray(y64)).all()

    def test_port_forward_is_finite_at_256(self):
        """The port's forward (its layers' fixed chunk of 64) at S 256 is
        finite and equals the reference's ``forward(chunk_size=64)``; the
        reference's default one chunk is not finite there."""
        params, lm, jcfg, _ = _models()
        toks = _tokens(256)
        got = model.forward(lm, {"tokens": torch.from_numpy(toks)})
        assert bool(torch.isfinite(got).all())
        ref, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, jcfg, chunk_size=64)
        _close(got, ref)
        one, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, jcfg)
        assert not np.isfinite(np.asarray(one)).all()


class TestBf16Noise:
    def test_bf16_rounding_alone_exceeds_the_consistency_tolerance(self):
        """The reduced rwkv6 at 8 layers in bf16, the reference's weights in
        both packages, S 128: the reference's own decode consistency (a
        prefill of S - 1 and one decode step against the S-token prefill)
        misses its 3e-2 x max(scale, 1) tolerance, and both packages' bf16
        prefills lie as far from the float32 model's; the port's float32
        consistency is within 1e-4. Random-weight RWKV stacks amplify bf16
        rounding with depth, which is why the card check holds rwkv6-1.6b's
        consistency in float32."""
        S, B = 128, 2
        jcfg, tcfg = (dataclasses.replace(c, num_stages=8) for c in _cfgs("bfloat16"))
        params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
        lm = convert.model_params_from(jax.tree.map(np.asarray, params), tcfg, device="cpu")
        toks = _tokens(S, B)
        jt = jnp.asarray(toks)
        _, c = jmodel.prefill_step(params, {"tokens": jt[:, :-1]}, jcfg, chunk_size=64,
                                   max_len=S)
        jd, _ = jmodel.decode_step(params, c, {"tokens": jt[:, -1:]}, jcfg)
        jf, _ = jmodel.prefill_step(params, {"tokens": jt}, jcfg, chunk_size=64, max_len=S)
        jd, jf = np.asarray(jd[:, 0], np.float32), np.asarray(jf[:, -1], np.float32)
        tf, _ = model.prefill_step(lm, {"tokens": torch.from_numpy(toks)})
        tf = tf[:, -1].float().numpy()
        tol = 3e-2 * max(float(np.abs(jf).max()), 1.0)
        assert float(np.abs(jd - jf).max()) > tol
        lm.float()
        lm.cfg = dataclasses.replace(tcfg, dtype="float32")
        tt = torch.from_numpy(toks)
        f32, _ = model.prefill_step(lm, {"tokens": tt})
        _, c = model.prefill_step(lm, {"tokens": tt[:, :-1]})
        d32, _ = model.decode_step(lm, c, {"tokens": tt[:, -1:]})
        f32, d32 = f32[:, -1].numpy(), d32[:, 0].numpy()
        scale = max(float(np.abs(f32).max()), 1.0)
        assert float(np.abs(d32 - f32).max()) < 1e-4 * scale
        ref_noise, port_noise = (float(np.abs(a - f32).max()) for a in (jf, tf))
        assert ref_noise > tol and port_noise > tol
        assert port_noise < 2 * ref_noise
