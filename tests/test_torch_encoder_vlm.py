"""The port's encoder and VLM inputs against the reference: hubert-xlarge's
``embeddings`` mode and ``encode_step``, pixtral-12b's patch prefix.

Parameters come from the reference's ``init_params``, carried over by
``convert.model_params_from``; frames, masks, patches and tokens are made
with numpy from a seed. Both packages run the reduced configs in float32;
the reference's attention is its chunked ``attention_fwd`` (chunk 16, which
snaps to a divisor of a ragged S), the port's the plain version of K5
(``ops.swa_attention``), non-causal for hubert's ``full_bidir`` layers.
Logits and caches are held within 1e-4 of the largest magnitude, as
``tests/test_torch_models.py`` holds gemma3. hubert also runs at head_dim
80, its full config's, through ``dataclasses.replace`` of the reduced one.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import attention, blocks, layers, model
from test_torch_models import _close, _jax_layer_caches, _port_cfg, _tree_size

HUBERT, PIXTRAL = "hubert-xlarge", "pixtral-12b"
PROMPT, GEN, BATCH = 40, 6, 2


@functools.cache
def _models(arch: str, head_dim: int | None = None):
    """(jax params, port model, jax cfg, port cfg), built once per variant;
    ``head_dim`` replaces the reduced config's."""
    jcfg = jconfigs.get_reduced(arch)
    if head_dim is not None:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
    tcfg = _port_cfg(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    lm = convert.model_params_from(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return params, lm, jcfg, tcfg


def _frames(S, B=BATCH, d=256, seed=0, mask_share=0.0):
    """(B, S, d) frame embeddings, and a boolean mask with about
    ``mask_share`` of the frames set (None at 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d), dtype=np.float32)
    mask = rng.random((B, S)) < mask_share if mask_share else None
    return x, mask


def _batches(x, mask):
    jb, tb = {"embeddings": jnp.asarray(x)}, {"embeddings": torch.from_numpy(x)}
    if mask is not None:
        jb["mask"], tb["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    return jb, tb


def _pixtral_inputs(S=PROMPT, B=BATCH, seed=0):
    """The reference ``serve``'s draws: prompts, then patches, from one rng."""
    jcfg = jconfigs.get_reduced(PIXTRAL)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, jcfg.num_prefix, jcfg.d_model), dtype=np.float32)
    return toks, patches


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_count_is_the_reference_tree_size(arch):
    """The port's analytic count is what the reference's ``init_params``
    builds, for all ten configs, full and reduced (hubert's included, where
    the reference's own count is higher)."""
    for jcfg in (jconfigs.get(arch), jconfigs.get_reduced(arch)):
        assert _port_cfg(jcfg).param_count() == _tree_size(jcfg)


class TestUngatedMLP:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
    def test_matches_reference_gelu_mlp(self, dtype):
        """``layers.mlp`` without ``gate``: gelu(x @ up) @ down, tanh form."""
        params = jlayers.init_mlp(jax.random.PRNGKey(2), 64, 96, dtype, gated=False)
        assert set(params) == {"up", "down"}
        mlp = layers.MLP(64, 96, dtype=layers.dtype_of(jnp.dtype(dtype).name),
                         device="cpu", gated=False)
        assert {name for name, _ in mlp.named_parameters()} == {"up", "down"}
        for name, p in mlp.named_parameters():
            p.copy_(convert.tensor_from_numpy(np.asarray(params[name]), device="cpu"))
        x = np.random.default_rng(3).standard_normal((2, 7, 64), dtype=np.float32)
        ref = jlayers.mlp(params, jnp.asarray(x, dtype))
        out = mlp(convert.tensor_from_numpy(np.asarray(jnp.asarray(x, dtype)), device="cpu"))
        _close(out, ref.astype(jnp.float32), tol=1e-4 if dtype == jnp.float32 else 1e-2)

    def test_exact_gelu_would_differ(self):
        """Why the port asks for ``approximate="tanh"``: torch's default erf
        GELU misses ``jax.nn.gelu`` by more than the parity tolerance."""
        x = np.linspace(-4, 4, 4001, dtype=np.float32)
        ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
        t = torch.from_numpy(x)
        np.testing.assert_allclose(F.gelu(t, approximate="tanh").numpy(), ref, atol=1e-6)
        assert np.abs(F.gelu(t).numpy() - ref).max() > 1e-4

    def test_init_draws_every_weight(self):
        mlp = layers.MLP(64, 96, dtype=torch.float32, device="cpu", gated=False)
        mlp.reset_parameters(torch.Generator().manual_seed(0))
        for w in (mlp.up, mlp.down):
            assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.05


class TestHubert:
    def test_convert_carries_the_embeddings_tree(self):
        """No ``embed``, a top-level ``mask_embed``, MLPs without ``gate``;
        every port parameter is its reference leaf, bit for bit."""
        params, lm, jcfg, tcfg = _models(HUBERT)
        assert "embed" not in params and not hasattr(lm, "embed")
        np.testing.assert_array_equal(lm.mask_embed.numpy(), np.asarray(params["mask_embed"]))
        assert sum(p.numel() for p in lm.parameters()) == tcfg.param_count() \
            == _tree_size(jcfg)
        for s, stage in enumerate(lm.stages):
            for i, layer in enumerate(stage):
                assert "gate" not in params["stages"][i]["mlp"] and layer.mlp.gate is None
                for name, p in layer.named_parameters():
                    leaf = params["stages"][i]
                    for key in name.split("."):
                        leaf = leaf[key]
                    np.testing.assert_array_equal(p.numpy(), np.asarray(leaf)[s])

    def test_convert_rejects_mismatched_arrays(self):
        params, _, _, tcfg = _models(HUBERT)
        p = jax.tree.map(np.asarray, params)
        p["mask_embed"] = p["mask_embed"].astype(np.float64)
        with pytest.raises(ValueError, match="mask_embed: reference array float64"):
            convert.model_params_from(p, tcfg, device="cpu")
        p["mask_embed"] = p["mask_embed"][:-1].astype(np.float32)
        with pytest.raises(ValueError, match="model wants"):
            convert.model_params_from(p, tcfg, device="cpu")
        with pytest.raises(ValueError, match="model wants"):       # d_ff 256
            convert.model_params_from(jax.tree.map(np.asarray, params),
                                      dataclasses.replace(tcfg, d_ff=256), device="cpu")

    @pytest.mark.parametrize("head_dim", [None, 80])
    @pytest.mark.parametrize("S", [24, 50])
    @pytest.mark.parametrize("masked", [False, True])
    def test_encode_step_matches_reference(self, head_dim, S, masked):
        """Unit logits of the reference's ``encode_step``, with and without a
        mask, at S 24 and a ragged S 50 (not a multiple of K5's 64-row
        block), at the reduced head_dim 64 and the full config's 80."""
        params, lm, jcfg, tcfg = _models(HUBERT, head_dim)
        x, mask = _frames(S, seed=S, mask_share=0.3 if masked else 0.0)
        jb, tb = _batches(x, mask)
        ref = jmodel.encode_step(params, jb, jcfg, chunk_size=16)
        out = model.encode_step(lm, tb)
        assert tuple(out.shape) == (BATCH, S, tcfg.vocab_size)
        _close(out, ref)
        if masked:      # the mask moved the logits: mask_embed took those frames
            flipped = model.encode_step(lm, tb | {"mask": ~tb["mask"]})
            assert not np.allclose(out.numpy(), flipped.numpy())

    def test_mask_replaces_frames_with_mask_embed(self):
        params, lm, _, tcfg = _models(HUBERT)
        x, mask = _frames(12, seed=1, mask_share=0.5)
        tb = _batches(x, mask)[1]
        got = model._input_embeddings(lm, tb)
        want = np.where(mask[..., None], np.asarray(params["mask_embed"]), x)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == layers.dtype_of(tcfg.dtype)

    @pytest.mark.parametrize("head_dim", [None, 80])
    def test_attention_is_bidirectional(self, head_dim):
        """Changing only the last frame moves frame 0's logits (a causal
        mask would leave them), in both packages alike."""
        params, lm, jcfg, _ = _models(HUBERT, head_dim)
        x, _ = _frames(24, seed=5)
        y = x.copy()
        y[:, -1] = np.random.default_rng(6).standard_normal(y[:, -1].shape, dtype=np.float32)
        outs = [model.encode_step(lm, {"embeddings": torch.from_numpy(a)}).numpy()
                for a in (x, y)]
        assert np.abs(outs[0][:, 0] - outs[1][:, 0]).max() > 1e-3
        ref = jmodel.encode_step(params, {"embeddings": jnp.asarray(y)}, jcfg, chunk_size=8)
        _close(torch.from_numpy(outs[1]), ref)

    def test_decode_paths_raise(self):
        """``full_bidir`` layers have no cache, as in the reference."""
        _, lm, _, tcfg = _models(HUBERT)
        layer = lm.all_layers()[0]
        x = torch.zeros(1, 4, tcfg.d_model)
        with pytest.raises(ValueError, match="prefill unsupported"):
            blocks.prefill_layer(layer, x, tcfg)
        with pytest.raises(ValueError, match="decode unsupported"):
            blocks.decode_layer(layer, x[:, :1], {}, 0, tcfg)
        with pytest.raises(ValueError, match="no decode cache"):
            model.init_decode_cache(tcfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="prefill unsupported"):
            model.prefill_step(lm, {"embeddings": x})

    def test_init_draws_the_reference_distributions(self):
        cfg = configs.get_reduced(HUBERT)
        lm = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        assert sum(p.numel() for p in lm.parameters()) == cfg.param_count()
        assert abs(float(lm.mask_embed.std()) - 0.02) < 0.004
        assert lm.stages[0][0].mlp.gate is None
        again = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(lm.parameters(), again.parameters()))


class TestPixtral:
    def test_convert_carries_every_leaf(self):
        params, lm, jcfg, tcfg = _models(PIXTRAL)
        assert sum(p.numel() for p in lm.parameters()) == tcfg.param_count() \
            == _tree_size(jcfg)
        np.testing.assert_array_equal(lm.embed.table.numpy(),
                                      np.asarray(params["embed"]["table"]))

    def test_forward_logits(self):
        params, lm, jcfg, _ = _models(PIXTRAL)
        toks, patches = _pixtral_inputs()
        ref, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks),
                                         "patches": jnp.asarray(patches)}, jcfg, chunk_size=16)
        out = model.forward(lm, {"tokens": torch.from_numpy(toks),
                                 "patches": torch.from_numpy(patches)})
        assert out.shape[1] == jcfg.num_prefix + PROMPT
        _close(out, ref)

    def test_prefill_and_teacher_forced_decode(self):
        """Prefill of patches + prompt: logits, every layer's cache and
        ``pos`` (prefix + prompt); then decode steps on tokens."""
        params, lm, jcfg, _ = _models(PIXTRAL)
        toks, patches = _pixtral_inputs(PROMPT + GEN)
        P = jcfg.num_prefix
        total = P + PROMPT + GEN
        jl, jc = jmodel.prefill_step(params, {"tokens": jnp.asarray(toks[:, :PROMPT]),
                                              "patches": jnp.asarray(patches)},
                                     jcfg, chunk_size=16, max_len=total)
        tl, tc = model.prefill_step(lm, {"tokens": torch.from_numpy(toks[:, :PROMPT]),
                                         "patches": torch.from_numpy(patches)}, max_len=total)
        _close(tl, jl)
        assert tc["pos"] == int(jc["pos"]) == P + PROMPT
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            assert t["k"].shape[1] == total
            _close(t["k"], j["k"])
            _close(t["v"], j["v"])
        decode = jax.jit(lambda p, c, b: jmodel.decode_step(p, c, b, jcfg))
        for pos in range(PROMPT, PROMPT + GEN):
            tok = toks[:, pos:pos + 1]
            jl, jc = decode(params, jc, {"tokens": jnp.asarray(tok)})
            tl, tc = model.decode_step(lm, tc, {"tokens": torch.from_numpy(tok)})
            _close(tl, jl)
        assert tc["pos"] == P + PROMPT + GEN
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            _close(t["k"], j["k"])

    def test_decode_consistency(self):
        """Patches + S - 1 tokens prefilled, one decode step, against the
        patches + S prefill's last logits, at the reference's tolerance."""
        _, lm, jcfg, _ = _models(PIXTRAL)
        toks, patches = (torch.from_numpy(a) for a in _pixtral_inputs())
        full, _ = model.prefill_step(lm, {"tokens": toks, "patches": patches})
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :-1], "patches": patches},
                                      max_len=jcfg.num_prefix + PROMPT)
        lg, _ = model.decode_step(lm, cache, {"tokens": toks[:, -1:]})
        scale = float(full[:, -1].abs().max())
        assert float((lg[:, 0] - full[:, -1]).abs().max()) < 3e-2 * max(scale, 1.0)

    def test_greedy_tokens_equal_the_reference_serve(self):
        """The reference's ``serve`` (its prompts, then its patches, from one
        rng; its prefill and jitted decode) against the port's ``generate``
        on the same parameters and draws."""
        res = jserve.serve(PIXTRAL, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, seed=0)
        _, lm, _, _ = _models(PIXTRAL)
        toks, patches = (torch.from_numpy(a) for a in _pixtral_inputs())
        tokens, _ = serve.generate(lm, toks, GEN, patches=patches)
        np.testing.assert_array_equal(tokens.numpy(), res["generated"])

    def test_serve_draws_the_reference_prompts_and_patches(self, monkeypatch):
        seen = {}
        real = serve.generate

        def spy(lm, prompts, gen_tokens, **kw):
            seen.update(prompts=prompts, patches=kw["patches"])
            return real(lm, prompts, gen_tokens, **kw)

        monkeypatch.setattr(serve, "generate", spy)
        res = serve.serve(PIXTRAL, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN,
                          seed=3, device="cpu")
        toks, patches = _pixtral_inputs(seed=3)
        np.testing.assert_array_equal(seen["prompts"].numpy(), toks)
        np.testing.assert_array_equal(seen["patches"].numpy(), patches)
        assert res["generated"].shape == (BATCH, GEN)
        again = serve.serve(PIXTRAL, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN,
                            seed=3, device="cpu")
        np.testing.assert_array_equal(res["generated"], again["generated"])

    def test_prefill_cache_length_counts_the_prefix(self):
        """``generate``'s cache holds prefix + prompt + generated tokens:
        the last decode step writes the last slot, and one more raises."""
        _, lm, jcfg, tcfg = _models(PIXTRAL)
        toks, patches = (torch.from_numpy(a) for a in _pixtral_inputs())
        P = jcfg.num_prefix
        _, cache = model.prefill_step(lm, {"tokens": toks, "patches": patches},
                                      max_len=P + PROMPT + 1)
        lg, cache = model.decode_step(lm, cache, {"tokens": toks[:, -1:]})
        assert cache["pos"] == P + PROMPT + 1 and bool(torch.isfinite(lg).all())
        with pytest.raises(ValueError, match=f"cache length {P + PROMPT + 1}"):
            model.decode_step(lm, cache, {"tokens": toks[:, -1:]})
        assert attention.decode_slot("full", P + PROMPT, P + PROMPT + 1) == P + PROMPT
