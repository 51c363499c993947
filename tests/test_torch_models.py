"""The port's model path (gemma3 serving) against the reference's models.

Parameters come from the reference's ``init_params`` and are carried over
with ``convert.model_params_from``; token inputs are made with numpy from a
seed. The reference runs in float32 (``configs.get_reduced``), its
attention through its own chunked ``attention_fwd`` (chunk 16); the port's
attention through ``ops.swa_attention`` (the plain version of K5 here). The
prompt of 96 tokens is three reduced windows (32), so the SWA ring buffer
wraps during decode.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import config as jconfig
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import attention, blocks, config, layers, model

ARCH = "gemma3-27b"
PROMPT, GEN, BATCH = 96, 8, 2


def _close(x, ref, tol=1e-4):
    """|x - ref| <= tol * max(|ref|, 1), elementwise scale of the whole array."""
    x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)
    ref = np.asarray(ref, np.float32)
    assert x.shape == ref.shape
    np.testing.assert_allclose(x, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1.0))


def _port_cfg(jcfg):
    """The port's ArchConfig with every field of a reference config."""
    fields = dataclasses.asdict(jcfg)
    for key in ("stage_pattern", "tail_pattern"):
        fields[key] = tuple(config.LayerSpec(**s) for s in fields[key])
    return config.ArchConfig(**fields)


def _cfgs(hd128: bool = False):
    jcfg = jconfigs.get_reduced(ARCH)
    if hd128:      # full gemma's head_dim and GQA ratio 2
        jcfg = dataclasses.replace(jcfg, head_dim=128)
    return jcfg, _port_cfg(jcfg)


@functools.cache
def _models(hd128: bool = False):
    """(jax params, port model, jax cfg, port cfg), built once per variant."""
    jcfg, tcfg = _cfgs(hd128)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    lm = convert.model_params_from(jax.tree.map(np.asarray, params), tcfg,
                                   device="cpu")
    return params, lm, jcfg, tcfg


# The reference's analytic count for hubert-xlarge against its own tree:
# every dense MLP counted as gated (48 x 1280 x 5120) and a vocab x d token
# embedding where the tree has mask_embed (504 x 1280 - 1280).
HUBERT_EXCESS = 48 * 1280 * 5120 + 504 * 1280 - 1280


def _tree_size(jcfg) -> int:
    """Parameters the reference's ``init_params`` builds, from shapes only."""
    tree = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(tree))


def _tokens(S=PROMPT, B=BATCH, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


class TestConfigs:
    @pytest.mark.parametrize("arch", configs.PORTED)
    @pytest.mark.parametrize("get", ["get", "get_reduced"])
    def test_gemma_configs_equal_field_by_field(self, get, arch):
        """Every ported config, full and reduced (gemma3 first). The counts
        agree but for hubert's, where the port's is the reference tree's
        size and the reference's analytic count is higher."""
        j, t = getattr(jconfigs, get)(arch), getattr(configs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        if j.input_mode == "embeddings":
            assert t.param_count() == t.active_param_count() == _tree_size(j)
            assert j.param_count() > t.param_count()
        else:
            assert j.param_count() == t.param_count()
            assert j.active_param_count() == t.active_param_count()
        assert (j.num_layers, j.q_dim, j.kv_dim) == (t.num_layers, t.q_dim, t.kv_dim)

    @pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
    def test_param_count_and_shapes_of_every_family(self, arch):
        """The copied analytic count covers every family (attention, MoE,
        Mamba, RWKV), and the skip matrix is the same. For hubert-xlarge the
        port counts what the reference's ``init_params`` builds, and the
        reference's own count exceeds that by HUBERT_EXCESS at full size."""
        for full, jcfg in ((True, jconfigs.get(arch)), (False, jconfigs.get_reduced(arch))):
            tcfg = _port_cfg(jcfg)
            if jcfg.input_mode == "embeddings":
                assert tcfg.param_count() == _tree_size(jcfg)
                if full:
                    assert jcfg.param_count() - tcfg.param_count() == HUBERT_EXCESS \
                        == 315_216_640
            else:
                assert tcfg.param_count() == jcfg.param_count()
                assert tcfg.active_param_count() == jcfg.active_param_count()
            for name, shape in jconfig.INPUT_SHAPES.items():
                assert dataclasses.asdict(config.INPUT_SHAPES[name]) == dataclasses.asdict(shape)
                assert config.shape_applicable(tcfg, config.INPUT_SHAPES[name]) == \
                    jconfig.shape_applicable(jcfg, shape)

    def test_registry_knows_the_reference_ids(self):
        """Every reference id is ported (slice 16e brought the last,
        rwkv6-1.6b); any other id raises KeyError."""
        assert configs.ARCH_IDS == jconfigs.ARCH_IDS
        assert sorted(configs.PORTED) == sorted(configs.ARCH_IDS)
        with pytest.raises(KeyError):
            configs.get("gpt-5")
        with pytest.raises(KeyError):
            configs.get_reduced("gpt-5")

    def test_unported_layers_raise(self):
        _, tcfg = _cfgs()
        # an RWKV layer builds (slice 16e): time mix and channel mix, no
        # attn, mlp or moe, float32 w0, u and ln_scale
        for spec in (config.LayerSpec("rwkv"), config.LayerSpec("rwkv", "moe")):
            layer = blocks.Layer(tcfg, spec, dtype=torch.bfloat16, device="cpu")
            assert hasattr(layer, "rwkv_tm") and hasattr(layer, "rwkv_cm")
            assert not any(hasattr(layer, n) for n in ("attn", "mlp", "moe", "mamba"))
            tm = layer.rwkv_tm
            assert tm.w0.dtype == tm.u.dtype == tm.ln_scale.dtype == torch.float32
            assert tm.wr.dtype == layer.rwkv_cm.wk.dtype == torch.bfloat16
            assert sum(p.numel() for p in layer.parameters()) == config._layer_params(
                tcfg, spec, active_only=False)
        with pytest.raises(NotImplementedError, match="has no port"):
            blocks.Layer(tcfg, config.LayerSpec("none"), dtype=torch.float32, device="cpu")
        # both Mamba layer kinds build (slice 16d): a mamba mixer, no attn
        mamba_cfg = dataclasses.replace(tcfg, num_experts=4, top_k=2)
        for spec in (config.LayerSpec("mamba"), config.LayerSpec("mamba", "moe")):
            layer = blocks.Layer(mamba_cfg, spec, dtype=torch.float32, device="cpu")
            assert hasattr(layer, "mamba") and not hasattr(layer, "attn")
            assert hasattr(layer, "moe" if spec.mlp == "moe" else "mlp")
            assert layer.mamba.A_log.dtype == torch.float32
            assert sum(p.numel() for p in layer.parameters()) == config._layer_params(
                mamba_cfg, spec, active_only=False)
        # an MoE layer builds (slice 16b): its experts in place of the MLP
        moe_cfg = dataclasses.replace(tcfg, num_experts=4, top_k=2)
        layer = blocks.Layer(moe_cfg, config.LayerSpec("swa", "moe"),
                             dtype=torch.float32, device="cpu")
        assert hasattr(layer, "moe") and not hasattr(layer, "mlp")
        assert tuple(layer.moe.gate.shape) == (4, tcfg.d_model, tcfg.d_ff)
        assert sum(p.numel() for p in layer.parameters()) == config._layer_params(
            moe_cfg, config.LayerSpec("swa", "moe"), active_only=False)
        # an encoder layer builds (slice 16c): the ungated MLP, no gate
        enc_cfg = dataclasses.replace(tcfg, encoder_only=True, causal=False)
        layer = blocks.Layer(enc_cfg, config.LayerSpec("full_bidir"),
                             dtype=torch.float32, device="cpu")
        assert layer.mlp.gate is None and "mlp.gate" not in dict(layer.named_parameters())
        assert sum(p.numel() for p in layer.parameters()) == config._layer_params(
            enc_cfg, config.LayerSpec("full_bidir"), active_only=False)
        # and an embeddings-mode model: mask_embed in place of the embedding
        lm = model.BackboneLM(dataclasses.replace(enc_cfg, input_mode="embeddings"),
                              device="cpu")
        assert not hasattr(lm, "embed") and tuple(lm.mask_embed.shape) == (tcfg.d_model,)

    def test_validate_raises_on_bad_configs(self):
        _, tcfg = _cfgs()
        with pytest.raises(ValueError):
            dataclasses.replace(tcfg, num_stages=0).validate()
        with pytest.raises(ValueError):
            dataclasses.replace(tcfg, encoder_only=True).validate()


class TestLayers:
    def test_rmsnorm(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 5, 256), dtype=np.float32) * 3
        scale = rng.standard_normal(256, dtype=np.float32)
        norm = layers.RMSNorm(256, 1e-6, dtype=torch.float32, device="cpu")
        norm.scale.copy_(torch.from_numpy(scale))
        _close(norm(torch.from_numpy(x)),
               jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))

    @pytest.mark.parametrize("hd,theta", [(64, 10_000.0), (128, 1_000_000.0)])
    def test_rope(self, hd, theta):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 300, 3, hd), dtype=np.float32)
        pos = np.tile(np.arange(300, dtype=np.int32), (2, 1))
        _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))

    def test_mlp(self):
        params = jlayers.init_mlp(jax.random.PRNGKey(2), 64, 96, jnp.float32)
        mlp = layers.MLP(64, 96, dtype=torch.float32, device="cpu")
        for name, p in mlp.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
        x = np.random.default_rng(3).standard_normal((2, 7, 64), dtype=np.float32)
        _close(mlp(torch.from_numpy(x)), jlayers.mlp(params, jnp.asarray(x)))

    def test_init_draws_the_reference_distributions(self):
        _, tcfg = _cfgs()
        lm = model.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                               device="cpu")
        assert sum(p.numel() for p in lm.parameters()) == tcfg.param_count()
        assert not any(p.requires_grad for p in lm.parameters())
        layer = lm.stages[0][0]
        assert torch.equal(layer.norm1.scale, torch.ones(tcfg.d_model))
        for w in (layer.attn.wq, layer.mlp.down, lm.head.kernel):
            assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.05
        assert abs(float(lm.embed.table.std()) - 0.02) < 0.001
        again = model.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                                  device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(lm.parameters(), again.parameters()))


class TestAttention:
    @pytest.mark.parametrize("kind", ["swa", "full", "full_bidir"])
    @pytest.mark.parametrize("hd128", [False, True])
    def test_attention_fwd(self, kind, hd128):
        params, lm, jcfg, tcfg = _models(hd128)
        jp = jax.tree.map(lambda a: a[0], params["stages"][0]["attn"])
        x = np.random.default_rng(4).standard_normal((2, PROMPT, jcfg.d_model),
                                                     dtype=np.float32)
        ref = jattn.attention_fwd(jp, jnp.asarray(x), jcfg, kind=kind, chunk_size=16)
        out = attention.attention_fwd(lm.stages[0][0].attn, torch.from_numpy(x), tcfg,
                                      kind=kind)
        _close(out, ref)

    def test_qkv_bias(self):
        _, tcfg = _cfgs()
        jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH), qkv_bias=True)
        tcfg = dataclasses.replace(tcfg, qkv_bias=True)
        rng = np.random.default_rng(6)
        jp = jattn.init_attention(jax.random.PRNGKey(3), jcfg)
        jp = {k: jnp.asarray(rng.standard_normal(v.shape, dtype=np.float32))
              if k.startswith("b") else v for k, v in jp.items()}
        attn = attention.Attention(tcfg, dtype=torch.float32, device="cpu")
        for name, p in attn.named_parameters():
            p.copy_(torch.from_numpy(np.array(jp[name])))
        x = rng.standard_normal((2, 40, jcfg.d_model), dtype=np.float32)
        _close(attention.attention_fwd(attn, torch.from_numpy(x), tcfg, kind="swa"),
               jattn.attention_fwd(jp, jnp.asarray(x), jcfg, kind="swa", chunk_size=8))

    @pytest.mark.parametrize("kind", ["swa", "full"])
    def test_prefill_cache_and_decode(self, kind):
        params, lm, jcfg, tcfg = _models()
        jp = jax.tree.map(lambda a: a[0], params["stages"][0]["attn"])
        attn = lm.stages[0][0].attn
        x = np.random.default_rng(5).standard_normal((2, PROMPT + 3, jcfg.d_model),
                                                     dtype=np.float32)
        jo, jc = jattn.prefill_cache(jp, jnp.asarray(x[:, :PROMPT]), jcfg, kind=kind,
                                     chunk_size=16, max_len=PROMPT + 3)
        to, tc = attention.prefill_cache(attn, torch.from_numpy(x[:, :PROMPT]), tcfg,
                                         kind=kind, max_len=PROMPT + 3)
        _close(to, jo)
        for key in ("k", "v"):
            _close(tc[key], jc[key])
        for pos in range(PROMPT, PROMPT + 3):
            jo, jc = jattn.attention_decode(jp, jnp.asarray(x[:, pos:pos + 1]), jc,
                                            jnp.asarray(pos, jnp.int32), jcfg, kind=kind)
            to, tc = attention.attention_decode(attn, torch.from_numpy(x[:, pos:pos + 1]),
                                                tc, pos, tcfg, kind=kind)
            _close(to, jo)
            for key in ("k", "v"):
                _close(tc[key], jc[key])


def _jax_layer_caches(jcache, jcfg):
    """The reference's stacked cache as one cache per layer, in order."""
    out = []
    for s in range(jcfg.num_stages):
        out += [jax.tree.map(lambda a: a[s], c) for c in jcache["stages"]]
    return out + list(jcache.get("tail", ()))


class TestModel:
    @pytest.mark.parametrize("hd128", [False, True])
    def test_forward_logits(self, hd128):
        params, lm, jcfg, _ = _models(hd128)
        toks = _tokens()
        ref, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, jcfg, chunk_size=16)
        _close(model.forward(lm, {"tokens": torch.from_numpy(toks)}), ref)

    @pytest.mark.parametrize("hd128", [False, True])
    def test_prefill_and_teacher_forced_decode(self, hd128):
        params, lm, jcfg, _ = _models(hd128)
        toks = _tokens(PROMPT + GEN)
        jl, jc = jmodel.prefill_step(params, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                                     jcfg, chunk_size=16, max_len=PROMPT + GEN)
        tl, tc = model.prefill_step(lm, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                                    max_len=PROMPT + GEN)
        _close(tl, jl)
        assert tc["pos"] == int(jc["pos"]) == PROMPT
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            _close(t["k"], j["k"])
            _close(t["v"], j["v"])
        decode = jax.jit(lambda p, c, b: jmodel.decode_step(p, c, b, jcfg))
        for pos in range(PROMPT, PROMPT + GEN):
            tok = toks[:, pos:pos + 1]
            jl, jc = decode(params, jc, {"tokens": jnp.asarray(tok)})
            tl, tc = model.decode_step(lm, tc, {"tokens": torch.from_numpy(tok)})
            _close(tl, jl)
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            _close(t["k"], j["k"])

    def test_init_decode_cache_matches_reference_layout(self):
        _, _, jcfg, tcfg = _models()
        jc = jmodel.init_decode_cache(jcfg, 2, 100)
        tc = model.init_decode_cache(tcfg, 2, 100, device="cpu")
        assert tc["pos"] == 0
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            assert tuple(t["k"].shape) == j["k"].shape and not t["k"].any()

    def test_decode_consistency(self):
        """tests/test_models.py::test_decode_consistency on the port: prefill
        of S - 1 tokens + one decode step equals the full forward's last
        position."""
        _, lm, _, _ = _models()
        toks = torch.from_numpy(_tokens(PROMPT))
        full = model.forward(lm, {"tokens": toks})
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :-1]}, max_len=PROMPT)
        lg, _ = model.decode_step(lm, cache, {"tokens": toks[:, -1:]})
        scale = float(full[:, -1].abs().max())
        err = float((lg[:, 0] - full[:, -1]).abs().max())
        assert err < 3e-2 * max(scale, 1.0), err

    def test_decode_past_the_cache_raises(self):
        """A decode step one position past a ``prefill_step(max_len=S)``
        cache: the full layers' caches end at S - 1, so the port raises
        ValueError naming the cache length, and writes no layer's cache."""
        _, lm, _, tcfg = _models()
        toks = torch.from_numpy(_tokens(PROMPT + 1))
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :PROMPT]}, max_len=PROMPT)
        before = [{k: c[k].clone() for k in ("k", "v")} for c in cache["layers"]]
        with pytest.raises(ValueError, match=f"cache length {PROMPT}"):
            model.decode_step(lm, cache, {"tokens": toks[:, PROMPT:]})
        assert cache["pos"] == PROMPT
        for c, b in zip(cache["layers"], before, strict=True):
            assert torch.equal(c["k"], b["k"]) and torch.equal(c["v"], b["v"])
        i, layer = next((i, l) for i, l in enumerate(lm.all_layers())
                        if l.spec.attn == "full")
        x = torch.zeros(BATCH, 1, tcfg.d_model)
        with pytest.raises(ValueError, match=f"position {PROMPT} .* cache length {PROMPT}"):
            attention.attention_decode(layer.attn, x, cache["layers"][i], PROMPT, tcfg,
                                       kind="full")
        assert torch.equal(cache["layers"][i]["k"], before[i]["k"])
        # the SWA ring buffer wraps as before; the last in-cache position works
        assert attention.decode_slot("swa", PROMPT, tcfg.window) == PROMPT % tcfg.window
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :PROMPT - 1]}, max_len=PROMPT)
        lg, cache = model.decode_step(lm, cache, {"tokens": toks[:, PROMPT - 1:PROMPT]})
        assert cache["pos"] == PROMPT and bool(torch.isfinite(lg).all())

    def test_reference_clamps_decode_past_its_cache(self):
        """The reference's caveat beside the port's error: its full layers
        write ``pos`` with ``dynamic_update_slice``, which clamps a position
        past the cache onto the last slot. Row S - 1 of every full layer's
        cache is overwritten, and the logits miss the one-pass logits by
        far more than the reference's own decode-consistency tolerance."""
        params, lm, jcfg, tcfg = _models()
        S = 8
        toks = _tokens(S + 1)
        _, jc = jmodel.prefill_step(params, {"tokens": jnp.asarray(toks[:, :S])}, jcfg,
                                    chunk_size=16, max_len=S)
        kinds = [s.attn for s in tcfg.stage_pattern * tcfg.num_stages + tcfg.tail_pattern]
        assert "full" in kinds
        before = [np.asarray(c["k"]) for c in _jax_layer_caches(jc, jcfg)]
        decode = jax.jit(lambda p, c, b: jmodel.decode_step(p, c, b, jcfg))
        jl, jc = decode(params, jc, {"tokens": jnp.asarray(toks[:, S:])})
        after = [np.asarray(c["k"]) for c in _jax_layer_caches(jc, jcfg)]
        for kind, b, a in zip(kinds, before, after, strict=True):
            assert a.shape[1] == S
            if kind == "full":
                assert not np.array_equal(a[:, S - 1], b[:, S - 1])
                np.testing.assert_array_equal(a[:, :S - 1], b[:, :S - 1])
        one_pass, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, jcfg,
                                     chunk_size=16)
        one_pass = np.asarray(one_pass[:, -1], np.float64)
        err = float(np.abs(np.asarray(jl[:, 0], np.float64) - one_pass).max())
        assert err > 3e-2 * max(float(np.abs(one_pass).max()), 1.0), err
        _, tc = model.prefill_step(lm, {"tokens": torch.from_numpy(toks[:, :S])}, max_len=S)
        with pytest.raises(ValueError, match=f"cache length {S}"):
            model.decode_step(lm, tc, {"tokens": torch.from_numpy(toks[:, S:])})

    def test_convert_rejects_mismatched_arrays(self):
        params, _, jcfg, tcfg = _models()
        p = jax.tree.map(np.asarray, params)
        with pytest.raises(ValueError, match="model wants"):
            convert.model_params_from(p, dataclasses.replace(tcfg, d_ff=256), device="cpu")
        p["head"]["kernel"] = p["head"]["kernel"].astype(np.float64)
        with pytest.raises(ValueError, match="model wants"):
            convert.model_params_from(p, tcfg, device="cpu")


class TestServe:
    def test_greedy_tokens_equal_the_reference_serve(self):
        """The reference's ``serve`` (its own prefill, jitted decode loop and
        prompts) and the port's ``generate`` on the same parameters and
        prompts pick the same greedy tokens."""
        res = jserve.serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, seed=0)
        jcfg = jconfigs.get_reduced(ARCH)
        params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
        lm = convert.model_params_from(jax.tree.map(np.asarray, params),
                                       configs.get_reduced(ARCH), device="cpu")
        prompts = torch.from_numpy(_tokens(PROMPT, BATCH, seed=0, vocab=jcfg.vocab_size))
        tokens, times = serve.generate(lm, prompts, GEN)
        np.testing.assert_array_equal(tokens.numpy(), res["generated"])
        assert set(times) == {"prefill_s", "decode_s"}

    def test_serve_report(self):
        res = serve.serve(ARCH, batch=BATCH, prompt_len=40, gen_tokens=5, device="cpu")
        jres_keys = {"arch", "prefill_s", "decode_s", "decode_tok_per_s", "generated"}
        assert set(res) == jres_keys
        assert res["generated"].shape == (BATCH, 5)
        assert ((0 <= res["generated"]) & (res["generated"] < 512)).all()
        again = serve.serve(ARCH, batch=BATCH, prompt_len=40, gen_tokens=5, device="cpu")
        np.testing.assert_array_equal(res["generated"], again["generated"])

    def test_sampling_draws_from_the_generator(self):
        _, lm, _, _ = _models()
        prompts = torch.from_numpy(_tokens(20))
        runs = [serve.generate(lm, prompts, 6, greedy=False,
                               generator=torch.Generator().manual_seed(s))[0]
                for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])

    @pytest.mark.parametrize("argv,reduced", [([], True), (["--reduced"], True),
                                              (["--no-reduced"], False)])
    def test_cli_reduced_is_a_real_switch(self, argv, reduced, monkeypatch, capsys):
        seen = {}

        def fake_serve(arch, **kw):
            seen.update(kw, arch=arch)
            return {"arch": arch, "prefill_s": 0.0, "decode_s": 0.0,
                    "decode_tok_per_s": 0.0, "generated": np.zeros((1, 2), int)}

        monkeypatch.setattr(serve, "serve", fake_serve)
        monkeypatch.setattr(sys, "argv", ["serve", "--mode", "model", "--arch", ARCH,
                                          "--device", "cpu", *argv])
        serve.main()
        assert seen["reduced"] is reduced and seen["device"] == "cpu"
        assert "[serve]" in capsys.readouterr().out

    @pytest.mark.parametrize("arch", configs.PORTED)
    def test_cli_runs_on_the_cpu(self, arch, monkeypatch, capsys):
        """Every ported arch; an encoder-only one raises the reference's
        ValueError (no decode step)."""
        monkeypatch.setattr(sys, "argv", ["serve", "--mode", "model", "--arch", arch,
                                          "--device", "cpu", "--batch", "1",
                                          "--prompt-len", "8", "--gen-tokens", "3"])
        if configs.get_reduced(arch).encoder_only:
            with pytest.raises(ValueError, match="encoder-only architecture has no decode"):
                serve.main()
            with pytest.raises(ValueError, match="encoder-only architecture has no decode"):
                jserve.serve(arch, batch=1, prompt_len=8, gen_tokens=3)
            return
        serve.main()
        out = capsys.readouterr().out
        assert configs.get_reduced(arch).name in out and "sample continuation" in out
