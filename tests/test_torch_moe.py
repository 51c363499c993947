"""The port's MoE block and the attention-only model zoo against the reference.

The MoE block (``models/moe.py``) is held to the reference's on the reduced
phi3.5-moe and mixtral configs, with parameters from the reference's
``init_moe`` and inputs made with numpy from a seed: the expert indices and
the kept-pair mask equal, the outputs and the aux loss within 1e-5 of the
reference's largest magnitude (float32, two summation orders). The five
configs of this slice (qwen2-72b, yi-9b, minitron-8b, phi3.5-moe,
mixtral-8x22b), reduced and in float32, run with the reference's
``init_params`` carried over by ``convert.model_params_from``: forward
logits, prefill caches and teacher-forced decode within 1e-4 of the
largest magnitude (as ``tests/test_torch_models.py`` holds gemma3), and the
greedy tokens of the reference's ``serve``. The prompt of 96 tokens is
three of mixtral-reduced's 32-token windows, so its window masks and its
ring buffer wraps.
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
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs, convert
from repro_torch.launch import serve
from repro_torch.models import model, moe
from test_torch_models import BATCH, GEN, PROMPT, _close, _jax_layer_caches, _tokens

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "mixtral-8x22b")
ZOO = ("qwen2-72b", "yi-9b", "minitron-8b") + MOE_ARCHS
MOE_TOL = 1e-5


def _cfgs(arch, **changes):
    return (dataclasses.replace(jconfigs.get_reduced(arch), **changes),
            dataclasses.replace(configs.get_reduced(arch), **changes))


def _port_moe(params, tcfg) -> moe.MoE:
    m = moe.MoE(tcfg, dtype=torch.float32, device="cpu")
    for name, p in m.named_parameters():
        p.copy_(torch.from_numpy(np.array(params[name])))
    return m


def _jax_assignment(params, x, cfg):
    """The reference's routing and capacity lines (``moe.py:62-74``):
    float32 probabilities, ``jax.lax.top_k`` indices, the kept mask."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.top_k
    probs = jax.nn.softmax((x.reshape(T, d) @ params["router"]).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, k)
    flat = idx.reshape(T * k)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    ranks = jnp.cumsum(onehot, axis=0) - onehot
    rank = jnp.take_along_axis(ranks, flat[:, None], axis=1)[:, 0]
    keep = rank < jmoe.capacity(cfg, T)
    return np.asarray(probs), np.asarray(idx), np.asarray(keep).reshape(T, k)


def _moe_inputs(arch, S=32, seed=0, **changes):
    jcfg, tcfg = _cfgs(arch, **changes)
    params = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    return jcfg, tcfg, params, _port_moe(params, tcfg), x


class TestMoEBlock:
    @pytest.mark.parametrize("arch", MOE_ARCHS)
    @pytest.mark.parametrize("cf", [8.0, 0.25])
    def test_moe_block_matches_reference(self, arch, cf):
        """Dropless (the reduced configs' 8.0) and dropping (0.25, as
        ``test_capacity_dropping``): the same experts, the same kept pairs,
        the same outputs and aux."""
        jcfg, tcfg, params, m, x = _moe_inputs(arch, capacity_factor=cf)
        y, aux = jmoe.moe_block(params, jnp.asarray(x), jcfg, return_aux=True)
        ty, taux = moe.moe_block(m, torch.from_numpy(x), tcfg, return_aux=True)
        probs, idx, keep = _jax_assignment(params, jnp.asarray(x), jcfg)
        np.testing.assert_array_equal(m.routing["expert_idx"].numpy(), idx)
        np.testing.assert_array_equal(m.routing["keep"].numpy(), keep)
        assert bool(keep.all()) == (cf == 8.0)
        _close(m.routing["probs"], probs, MOE_TOL)
        _close(ty, y, MOE_TOL)
        assert abs(float(taux) - float(aux)) <= MOE_TOL * float(aux)

    @pytest.mark.parametrize("T,cf", [(1, 1.25), (4, 1.25), (64, 0.25), (64, 8.0), (4096, 1.25)])
    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_capacity(self, arch, T, cf):
        for get_j, get_t in ((jconfigs.get, configs.get), (jconfigs.get_reduced, configs.get_reduced)):
            jcfg = dataclasses.replace(get_j(arch), capacity_factor=cf)
            tcfg = dataclasses.replace(get_t(arch), capacity_factor=cf)
            assert moe.capacity(tcfg, T) == jmoe.capacity(jcfg, T)

    @pytest.mark.parametrize("k", [1, 2, 3, 8])
    @pytest.mark.parametrize("levels", [2, 5])
    def test_top_k_tie_rule(self, k, levels):
        """Values from a few levels tie in most rows: the port's top-k
        gives ``jax.lax.top_k``'s values and indices, the lower index first
        among equals."""
        probs = (np.random.default_rng(levels).integers(0, levels, (257, 8))
                 .astype(np.float32) / levels)
        vals, idx = moe.top_k(torch.from_numpy(probs), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))

    @pytest.mark.parametrize("arch", MOE_ARCHS)
    @pytest.mark.parametrize("cf", [8.0, 0.25])
    def test_router_ties_route_as_the_reference(self, arch, cf):
        """Integer inputs and a router whose experts 0 and 1 (and 2 and 3)
        are the same column: exact, tied logits in both packages. The
        expert indices and kept pairs are equal, the outputs close."""
        jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
        rng = np.random.default_rng(3)
        params = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
        router = rng.integers(-1, 2, (jcfg.d_model, jcfg.num_experts)).astype(np.float32)
        router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
        params = dict(params, router=jnp.asarray(router))
        x = rng.integers(-2, 3, (2, 32, jcfg.d_model)).astype(np.float32)
        m = _port_moe(params, tcfg)
        ty = moe.moe_block(m, torch.from_numpy(x), tcfg)
        probs, idx, keep = _jax_assignment(params, jnp.asarray(x), jcfg)
        assert (probs[:, 0] == probs[:, 1]).all()
        np.testing.assert_array_equal(m.routing["expert_idx"].numpy(), idx)
        np.testing.assert_array_equal(m.routing["keep"].numpy(), keep)
        _close(ty, jmoe.moe_block(params, jnp.asarray(x), jcfg), MOE_TOL)

    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_gather_matches_reference(self, arch):
        jcfg, tcfg, params, m, x = _moe_inputs(arch, S=16)
        _close(moe.moe_block_gather(m, torch.from_numpy(x), tcfg),
               jmoe.moe_block_gather(params, jnp.asarray(x), jcfg), MOE_TOL)

    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_dispatch_vs_gather_dropless(self, arch):
        """``tests/test_models.py::TestMoE::test_dispatch_vs_gather_dropless``
        on the port, with its tolerance."""
        _, tcfg, _, m, x = _moe_inputs(arch, S=16)
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(moe.moe_block(m, xt, tcfg).numpy(),
                                   moe.moe_block_gather(m, xt, tcfg).numpy(),
                                   rtol=1e-3, atol=1e-4)

    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_aux_loss_uniform_router(self, arch):
        """A zero router ties every expert: experts 0 and 1 take every
        token and the aux is 1, in both packages."""
        jcfg, tcfg, params, m, x = _moe_inputs(arch, S=64)
        params = dict(params, router=jnp.zeros_like(params["router"]))
        m.router.zero_()
        _, aux = moe.moe_block(m, torch.from_numpy(x), tcfg, return_aux=True)
        _, jaux = jmoe.moe_block(params, jnp.asarray(x), jcfg, return_aux=True)
        assert float(aux) == pytest.approx(1.0, abs=1e-6)
        assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
        assert (m.routing["expert_idx"].numpy() == [0, 1]).all()

    @pytest.mark.parametrize("arch", MOE_ARCHS)
    def test_init_draws_the_reference_distributions(self, arch):
        jcfg, tcfg = _cfgs(arch)
        ref = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
        m = moe.MoE(tcfg, dtype=torch.float32, device="cpu")
        assert {n: tuple(p.shape) for n, p in m.named_parameters()} == \
            {n: a.shape for n, a in ref.items()}
        m.reset_parameters(torch.Generator().manual_seed(0))
        for name, fan_in in (("router", tcfg.d_model), ("gate", tcfg.d_model),
                             ("up", tcfg.d_model), ("down", tcfg.d_ff)):
            w = getattr(m, name)
            assert abs(float(w.mean())) < 0.05 * fan_in ** -0.5
            assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.05
            assert abs(float(np.asarray(ref[name]).std()) * fan_in ** 0.5 - 1) < 0.05
        again = moe.MoE(tcfg, dtype=torch.float32, device="cpu")
        again.reset_parameters(torch.Generator().manual_seed(0))
        assert all(torch.equal(a, b) for a, b in zip(m.parameters(), again.parameters()))


@functools.cache
def _models(arch, **changes):
    """(jax params, port model, jax cfg, port cfg), built once per config."""
    jcfg, tcfg = _cfgs(arch, **changes)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    lm = convert.model_params_from(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return params, lm, jcfg, tcfg


class TestZoo:
    @pytest.mark.parametrize("arch", ZOO)
    def test_convert_carries_every_leaf(self, arch):
        """Every port parameter is its reference leaf, bit for bit (MoE
        leaves take index s of the stacked stage axis, like the rest)."""
        params, lm, jcfg, tcfg = _models(arch)
        assert sum(p.numel() for p in lm.parameters()) == tcfg.param_count()
        for s, stage in enumerate(lm.stages):
            for i, layer in enumerate(stage):
                for name, p in layer.named_parameters():
                    leaf = params["stages"][i]
                    for key in name.split("."):
                        leaf = leaf[key]
                    np.testing.assert_array_equal(p.numpy(), np.asarray(leaf)[s])
        if tcfg.num_experts:
            assert all(hasattr(layer, "moe") and not hasattr(layer, "mlp")
                       for layer in lm.all_layers())

    @pytest.mark.parametrize("arch", ZOO)
    def test_forward_logits(self, arch):
        params, lm, jcfg, _ = _models(arch)
        toks = _tokens()
        ref, _ = jmodel.forward(params, {"tokens": jnp.asarray(toks)}, jcfg, chunk_size=16)
        _close(model.forward(lm, {"tokens": torch.from_numpy(toks)}), ref)

    @pytest.mark.parametrize("arch,batch,cf", [(a, BATCH, None) for a in ZOO]
                             + [(a, 4, 1.25) for a in MOE_ARCHS])
    def test_prefill_and_teacher_forced_decode(self, arch, batch, cf):
        """Prefill caches and each decode step's logits. At B 4 with the
        full configs' capacity factor 1.25, decode's T = B capacity (2
        slots an expert) drops pairs; the logits still agree, so both
        packages drop the same ones."""
        changes = {} if cf is None else {"capacity_factor": cf}
        params, lm, jcfg, tcfg = _models(arch, **changes)
        toks = _tokens(PROMPT + GEN, batch)
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
        dropped = 0
        for pos in range(PROMPT, PROMPT + GEN):
            tok = toks[:, pos:pos + 1]
            jl, jc = decode(params, jc, {"tokens": jnp.asarray(tok)})
            tl, tc = model.decode_step(lm, tc, {"tokens": torch.from_numpy(tok)})
            _close(tl, jl)
            if tcfg.num_experts:
                dropped += sum(int((~l.moe.routing["keep"]).sum()) for l in lm.all_layers())
        for t, j in zip(tc["layers"], _jax_layer_caches(jc, jcfg), strict=True):
            _close(t["k"], j["k"])
        assert (dropped > 0) == (cf is not None)

    @pytest.mark.parametrize("arch", ZOO)
    def test_decode_consistency(self, arch):
        """Prefill of S - 1 tokens + one decode step against the S-token
        forward's last position, at the reference's tolerance."""
        _, lm, _, _ = _models(arch)
        toks = torch.from_numpy(_tokens())
        full = model.forward(lm, {"tokens": toks})
        _, cache = model.prefill_step(lm, {"tokens": toks[:, :-1]}, max_len=PROMPT)
        lg, _ = model.decode_step(lm, cache, {"tokens": toks[:, -1:]})
        scale = float(full[:, -1].abs().max())
        assert float((lg[:, 0] - full[:, -1]).abs().max()) < 3e-2 * max(scale, 1.0)

    @pytest.mark.parametrize("arch", ZOO)
    def test_greedy_tokens_equal_the_reference_serve(self, arch):
        res = jserve.serve(arch, batch=BATCH, prompt_len=PROMPT, gen_tokens=GEN, seed=0)
        params, lm, jcfg, _ = _models(arch)
        prompts = torch.from_numpy(_tokens(PROMPT, BATCH, seed=0, vocab=jcfg.vocab_size))
        tokens, _ = serve.generate(lm, prompts, GEN)
        np.testing.assert_array_equal(tokens.numpy(), res["generated"])

    @pytest.mark.parametrize("arch", ZOO)
    def test_serve_report(self, arch):
        res = serve.serve(arch, batch=BATCH, prompt_len=40, gen_tokens=5, device="cpu")
        assert res["arch"] == configs.get_reduced(arch).name
        assert res["generated"].shape == (BATCH, 5)
        assert ((0 <= res["generated"]) & (res["generated"] < 512)).all()
