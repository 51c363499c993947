"""The port's Mamba layer and jamba-1.5-large against the reference.

The Mamba (S6) layer (``models/mamba.py``) is held to the reference's on
the reduced jamba config, with parameters from the reference's
``init_mamba`` and inputs made with numpy from a seed: the output and the
decode cache (conv window, state h) within 1e-5 of the reference's largest
magnitude in float32, for the reference's chunk None and 8 against the
port's 64 and 8, at S 64 and at a ragged S 50 (where ``pick_chunk`` snaps),
and in bf16 within 1e-2 (about 2.5 bf16 ulps at the largest magnitude; the
two scans sum in other orders, and XLA may keep bf16 intermediates wider).
Reduced jamba (a Mamba + MoE layer and an attention + dense layer) runs with
the reference's ``init_params`` carried over by ``convert.model_params_from``:
forward logits, prefill caches and teacher-forced decode within 1e-4 of the
largest magnitude, as ``tests/test_torch_moe.py`` holds the zoo, and the
greedy tokens of the reference's ``serve``.
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
from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import blocks, config, layers, mamba, model
from test_torch_models import BATCH, GEN, PROMPT, _close, _jax_layer_caches, _tokens, \
    _tree_size

ARCH = "jamba-1.5-large-398b"
TOL, BF16_TOL = 1e-5, 1e-2


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_reduced(ARCH), dtype=dtype),
            dataclasses.replace(configs.get_reduced(ARCH), dtype=dtype))


@functools.cache
def _layer(dtype="float32"):
    """(reference params, port Mamba, jax cfg, port cfg) for one layer."""
    jcfg, tcfg = _cfgs(dtype)
    params = jmamba.init_mamba(jax.random.PRNGKey(0), jcfg)
    m = mamba.Mamba(tcfg, dtype=getattr(torch, dtype), device="cpu")
    for name, p in m.named_parameters():
        p.copy_(convert.tensor_from_numpy(np.asarray(params[name]), device="cpu"))
    return params, m, jcfg, tcfg


@functools.cache
def _jax_fwd(jcfg, chunk):
    return jax.jit(functools.partial(jmamba.mamba_fwd, cfg=jcfg, chunk_size=chunk,
                                     return_cache=True))


def _x(S, B=2, seed=0, d=256):
    return np.random.default_rng(seed).standard_normal((B, S, d), dtype=np.float32)


class TestMambaLayer:
    @pytest.mark.parametrize("S", [64, 50])
    @pytest.mark.parametrize("ref_chunk", [None, 8])
    @pytest.mark.parametrize("chunk", [64, 8])
    def test_mamba_fwd_matches_reference(self, S, ref_chunk, chunk):
        """Output and cache. The port's chunk 64 is one chunk at S 64 and
        50; its chunk 8 is 8 chunks at S 64 and 10 of 5 at S 50, carrying h
        across them."""
        params, m, jcfg, tcfg = _layer()
        x = _x(S)
        ry, rc = _jax_fwd(jcfg, ref_chunk)(params, jnp.asarray(x))
        ty, tc = mamba.mamba_fwd(m, torch.from_numpy(x), tcfg, chunk_size=chunk,
                                 return_cache=True)
        _close(ty, ry, TOL)
        assert tuple(tc["conv"].shape) == (2, tcfg.mamba_conv - 1, tcfg.d_inner)
        _close(tc["conv"], rc["conv"], TOL)
        _close(tc["h"], rc["h"], TOL)
        assert tc["h"].dtype == torch.float32

    @pytest.mark.parametrize("S", [64, 50])
    def test_bf16_casts(self, S):
        """bf16 parameters and input (float32 A_log and D): the output and
        conv window stay bf16 and h float32, all within BF16_TOL; the port
        is a bf16 model, farther from the float32 one than from the
        reference's bf16."""
        params, m, jcfg, tcfg = _layer("bfloat16")
        x = _x(S)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        ry, rc = _jax_fwd(jcfg, 8)(params, xb)
        ty, tc = mamba.mamba_fwd(m, torch.from_numpy(x).bfloat16(), tcfg, chunk_size=64,
                                 return_cache=True)
        assert (ty.dtype, tc["conv"].dtype, tc["h"].dtype) == \
            (torch.bfloat16, torch.bfloat16, torch.float32)
        _close(ty, np.asarray(ry, np.float32), BF16_TOL)
        _close(tc["conv"], np.asarray(rc["conv"], np.float32), BF16_TOL)
        _close(tc["h"], rc["h"], BF16_TOL)
        m32 = mamba.Mamba(tcfg, dtype=torch.float32, device="cpu")
        m32.load_state_dict({k: v.float() for k, v in m.state_dict().items()})
        y32 = mamba.mamba_fwd(m32, torch.from_numpy(np.asarray(xb, np.float32)),
                              dataclasses.replace(tcfg, dtype="float32"), chunk_size=64)
        ry = np.asarray(ry, np.float32)
        assert np.abs(y32.numpy() - ry).max() > np.abs(ty.float().numpy() - ry).max()

    def test_mamba_decode_from_a_given_cache(self):
        params, m, jcfg, tcfg = _layer()
        rng = np.random.default_rng(7)
        conv = rng.standard_normal((2, tcfg.mamba_conv - 1, tcfg.d_inner), dtype=np.float32)
        h = rng.standard_normal((2, tcfg.d_inner, tcfg.mamba_d_state), dtype=np.float32)
        x = _x(3, seed=8)
        jc = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
        tc = {"conv": torch.from_numpy(conv), "h": torch.from_numpy(h)}
        for t in range(3):
            jo, jc = jmamba.mamba_decode(params, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
            to, tc = mamba.mamba_decode(m, torch.from_numpy(x[:, t:t + 1]), tc, tcfg)
            _close(to, jo, TOL)
            _close(tc["conv"], jc["conv"], TOL)
            _close(tc["h"], jc["h"], TOL)

    @pytest.mark.parametrize("S", [64, 50, 4])
    def test_prefill_then_decode_equals_prefill(self, S):
        """Within the port: a prefill of S - 1 positions and one decode step
        give the S-position prefill's last output and its cache."""
        _, m, _, tcfg = _layer()
        x = torch.from_numpy(_x(S, seed=S))
        y, cache = mamba.mamba_fwd(m, x, tcfg, chunk_size=8, return_cache=True)
        _, c = mamba.mamba_fwd(m, x[:, :-1], tcfg, chunk_size=8, return_cache=True)
        o, c = mamba.mamba_decode(m, x[:, -1:], c, tcfg)
        _close(o, y[:, -1:], TOL)
        _close(c["conv"], cache["conv"], TOL)
        _close(c["h"], cache["h"], TOL)

    @pytest.mark.parametrize("chunk", [None, 1, 7, 8, 64, 100])
    @pytest.mark.parametrize("S", [1, 50, 64, 4095])
    def test_pick_chunk_is_the_reference_rule(self, S, chunk):
        from repro.models import layers as jlayers
        assert layers.pick_chunk(S, chunk) == jlayers.pick_chunk(S, chunk)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_init_draws_the_reference_distributions(self, dtype):
        """The reference's leaves, shapes and dtypes (A_log and D float32 in
        a bf16 model too), A_log = log(1..d_state) on every channel, D ones,
        a zero dt bias, the conv's 0.2 and the projections' in_dim^-0.5."""
        ref, _, _, tcfg = _layer(dtype)
        m = mamba.Mamba(tcfg, dtype=getattr(torch, dtype), device="cpu")
        m.reset_parameters(torch.Generator().manual_seed(0))
        assert {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
                for n, p in m.named_parameters()} == \
            {n: (a.shape, a.dtype.name) for n, a in ref.items()}
        assert m.A_log.dtype == m.D.dtype == torch.float32
        np.testing.assert_allclose(m.A_log.numpy(), np.asarray(ref["A_log"]), rtol=1e-7)
        assert bool((m.D == 1).all()) and not m.dt_bias.float().any()
        assert abs(float(m.conv_w.float().std()) / 0.2 - 1) < 0.05
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            w = getattr(m, name).float()
            assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.05
        again = mamba.Mamba(tcfg, dtype=getattr(torch, dtype), device="cpu")
        again.reset_parameters(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))


@functools.cache
def _models(dtype="float32", **changes):
    """(jax params, port model, jax cfg, port cfg), built once per variant."""
    jcfg, tcfg = _cfgs(dtype)
    jcfg, tcfg = dataclasses.replace(jcfg, **changes), dataclasses.replace(tcfg, **changes)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    lm = convert.model_params_from(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return params, lm, jcfg, tcfg


def _close_cache(t, j, tol=1e-4):
    assert set(t) == set(j)
    for key in t:
        _close(t[key], j[key], tol)


class TestJamba:
    def test_config_and_counts(self):
        """The registry's configs are the reference's, field for field; the
        port's count is the tree's, full (398.6 G, 94.1 G active) and
        reduced; the 5-layer depth cut served on the card is 24.05 G."""
        for get_j, get_t in ((jconfigs.get, configs.get),
                             (jconfigs.get_reduced, configs.get_reduced)):
            j, t = get_j(ARCH), get_t(ARCH)
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
            assert t.param_count() == j.param_count() == _tree_size(j)
            assert sum(p.numel() for p in model.BackboneLM(t, device="meta").parameters()) \
                == t.param_count()
        full = configs.get(ARCH)
        assert full.param_count() == 398_554_079_232
        assert round(full.active_param_count() / 1e9, 1) == 94.1
        cut = dataclasses.replace(full, stage_pattern=full.stage_pattern[:5], num_stages=1)
        assert cut.param_count() == 24_045_641_728
        kinds = [(s.attn, s.mlp) for s in cut.stage_pattern]
        assert kinds == [("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
                         ("mamba", "moe"), ("full", "dense")]

    def test_convert_carries_every_leaf(self):
        params, lm, jcfg, tcfg = _models()
        assert sum(p.numel() for p in lm.parameters()) == tcfg.param_count()
        for i, layer in enumerate(lm.stages[0]):
            assert hasattr(layer, "mamba") != hasattr(layer, "attn")
            for name, p in layer.named_parameters():
                leaf = params["stages"][i]
                for key in name.split("."):
                    leaf = leaf[key]
                np.testing.assert_array_equal(p.numpy(), np.asarray(leaf)[0])

    def test_convert_bf16_keeps_float32_a_log_and_d(self):
        """A bf16 jamba tree converts with its float32 A_log and D (bits
        kept); a float32 leaf anywhere else still raises."""
        params, lm, _, tcfg = _models("bfloat16")
        layer = lm.stages[0][0]
        assert layer.mamba.A_log.dtype == layer.mamba.D.dtype == torch.float32
        assert layer.mamba.in_proj.dtype == layer.moe.gate.dtype == torch.bfloat16
        np.testing.assert_array_equal(layer.mamba.A_log.numpy(),
                                      np.asarray(params["stages"][0]["mamba"]["A_log"])[0])
        p = jax.tree.map(np.asarray, params)
        for path in (("mamba", "dt_bias"), ("norm1", "scale"), ("moe", "router")):
            bad = jax.tree.map(lambda a: a, p)
            leaf = bad["stages"][0]
            for key in path[:-1]:
                leaf = leaf[key]
            leaf[path[-1]] = leaf[path[-1]].astype(np.float32)
            with pytest.raises(ValueError, match="model wants bfloat16"):
                convert.model_params_from(bad, tcfg, device="cpu")
        bad = jax.tree.map(lambda a: a, p)
        bad["stages"][0]["mamba"]["D"] = bad["stages"][0]["mamba"]["D"].astype(
            p["embed"]["table"].dtype)
        with pytest.raises(ValueError, match="model wants float32"):
            convert.model_params_from(bad, tcfg, device="cpu")

    def test_forward_logits(self):
        params, lm, jcfg, _ = _models()
        toks = _tokens()
        ref, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, jcfg, chunk_size=16)
        _close(model.forward(lm, {"tokens": torch.from_numpy(toks)}), ref)

    @pytest.mark.parametrize("batch,cf", [(BATCH, None), (4, 1.25)])
    def test_prefill_and_teacher_forced_decode(self, batch, cf):
        """Prefill caches (the attention layer's k, v; the Mamba layer's conv
        window and h) and each decode step's logits; at B 4 with capacity
        factor 1.25 decode drops pairs in both packages alike."""
        changes = {} if cf is None else {"capacity_factor": cf}
        params, lm, jcfg, tcfg = _models(**changes)
        toks = _tokens(PROMPT + GEN, batch)
        jl, jc = jmodel.prefill_step(params, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                                     jcfg, chunk_size=16, max_len=PROMPT + GEN)
        tl, tc = model.prefill_step(lm, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                                    max_len=PROMPT + GEN)
        _close(tl, jl)
        assert tc["pos"] == int(jc["pos"]) == PROMPT
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            _close_cache(t, j)
        assert set(tc["layers"][0]) == {"conv", "h"} and set(tc["layers"][1]) == {"k", "v"}
        decode = jax.jit(lambda p, c, b: jmodel.decode_step(p, c, b, jcfg))
        dropped = 0
        for pos in range(PROMPT, PROMPT + GEN):
            tok = toks[:, pos:pos + 1]
            jl, jc = decode(params, jc, {"tokens": jnp.asarray(tok)})
            tl, tc = model.decode_step(lm, tc, {"tokens": torch.from_numpy(tok)})
            _close(tl, jl)
            dropped += int((~lm.stages[0][0].moe.routing["keep"]).sum())
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            _close_cache(t, j)
        assert (dropped > 0) == (cf is not None)

    def test_init_decode_cache_matches_reference_layout(self):
        _, _, jcfg, tcfg = _models()
        jc = jmodel.init_decode_cache(jcfg, 2, 100)
        tc = model.init_decode_cache(tcfg, 2, 100, device="cpu")
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                    for k, v in t.items()} == {k: (v.shape, v.dtype.name) for k, v in j.items()}
            assert not any(v.any() for v in t.values())

    @pytest.mark.parametrize("S", [PROMPT, 50])
    def test_decode_consistency(self, S):
        """A prefill of S - 1 tokens and one decode step hand the Mamba state
        and conv window over: the S-token forward's last logits, at the
        reference's tolerance (and at 1e-4 here, float32)."""
        _, lm, _, _ = _models()
        toks = torch.from_numpy(_tokens(S))
        full = model.forward(lm, {"tokens": toks})
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :-1]}, max_len=S)
        lg, _ = model.decode_step(lm, cache, {"tokens": toks[:, -1:]})
        scale = float(full[:, -1].abs().max())
        err = float((lg[:, 0] - full[:, -1]).abs().max())
        assert err < 3e-2 * max(scale, 1.0) and err < 1e-4 * max(scale, 1.0), err

    def test_greedy_tokens_equal_the_reference_serve(self):
        res = jserve.serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, seed=0)
        _, lm, jcfg, _ = _models()
        prompts = torch.from_numpy(_tokens(PROMPT, BATCH, seed=0, vocab=jcfg.vocab_size))
        tokens, _ = serve.generate(lm, prompts, GEN)
        np.testing.assert_array_equal(tokens.numpy(), res["generated"])

    def test_serve_report(self):
        res = serve.serve(ARCH, batch=BATCH, prompt_len=40, gen_tokens=5, device="cpu")
        assert res["arch"] == "jamba-reduced"
        assert res["generated"].shape == (BATCH, 5)
        assert ((0 <= res["generated"]) & (res["generated"] < 512)).all()


class TestShortPrefill:
    @pytest.mark.parametrize("S", [1, 2])
    def test_reference_decode_fails_after_a_short_prefill(self, S):
        """The reference's caveat: a prefill of S < K - 1 = 3 tokens leaves a
        conv cache shorter than K - 1 (``x_in[:, S - (K - 1):]`` with a
        negative start), and its next decode fails in the einsum."""
        params, _, jcfg, _ = _layer()
        x = _x(S + 1)
        _, rc = _jax_fwd(jcfg, None)(params, jnp.asarray(x[:, :S]))
        assert rc["conv"].shape[1] < jcfg.mamba_conv - 1
        with pytest.raises(ValueError, match="Size of label 'k'"):
            jmamba.mamba_decode(params, jnp.asarray(x[:, S:]), rc, jcfg)

    @pytest.mark.parametrize("S", [1, 2])
    def test_port_decode_raises_before_any_write(self, S):
        """The port's decode raises ValueError naming the short prefill,
        in the layer and in ``decode_step``, before any layer's cache is
        written; at S = K - 1 it decodes."""
        _, lm, _, tcfg = _models()
        toks = torch.from_numpy(_tokens(S + 1))
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :S]}, max_len=S + 1)
        before = [{k: v.clone() for k, v in c.items()} for c in cache["layers"]]
        with pytest.raises(ValueError, match="prefill shorter than mamba_conv - 1"):
            model.decode_step(lm, cache, {"tokens": toks[:, S:]})
        assert cache["pos"] == S
        for c, b in zip(cache["layers"], before, strict=True):
            assert all(torch.equal(c[k], b[k]) for k in b)
        x = torch.zeros(BATCH, 1, tcfg.d_model)
        with pytest.raises(ValueError, match="holds 1 positions, decode needs 3"):
            mamba.mamba_decode(lm.stages[0][0].mamba, x, cache["layers"][0], tcfg)
        K = tcfg.mamba_conv
        toks = torch.from_numpy(_tokens(K))
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :K - 1]}, max_len=K)
        lg, cache = model.decode_step(lm, cache, {"tokens": toks[:, K - 1:]})
        assert cache["pos"] == K and bool(torch.isfinite(lg).all())


class TestBlocks:
    def test_mamba_layers_build_and_count(self):
        """Both Mamba layer kinds build with a ``mamba`` module and no
        ``attn``; their parameters are the analytic count's."""
        _, tcfg = _cfgs()
        for spec in tcfg.stage_pattern + (config.LayerSpec("mamba", "dense"),):
            layer = blocks.Layer(tcfg, spec, dtype=torch.float32, device="cpu")
            assert hasattr(layer, "mamba") == (spec.attn == "mamba") != hasattr(layer, "attn")
            assert sum(p.numel() for p in layer.parameters()) == config._layer_params(
                tcfg, spec, active_only=False)
        assert blocks.SEQ_CHUNK == 64
