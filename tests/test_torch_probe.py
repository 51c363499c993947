"""The one-shot linear probe in the port (``repro_torch.core.probe``, its
single-device half) against the reference.

``tests/test_system.py::test_probe_multi_target`` runs on the port; then
both packages probe the same numpy-made inputs through the same feature map
(1-D and (n, t) targets, float32 and bf16 features); then a probe on frozen
reduced-gemma3 features, the reference's ``init_params`` carried over with
``convert.model_params_from``: features (final-norm hidden states per
token) at ``tests/test_torch_models.py``'s tolerance, and the head against
the reference's head fitted on the reference's own features.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import probe as jprobe
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import convert, core
from repro_torch.core import probe
from repro_torch.models import blocks, config

ARCH = "gemma3-27b"


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(x, ref) -> float:
    x = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def test_probe_multi_target():
    X = torch.from_numpy(_np((100, 8), 0))
    Y = torch.from_numpy(_np((100, 3), 1))
    res = probe.one_shot_probe(torch.tanh, X, Y, sigma=0.01)
    assert res.weights.shape == (8, 3)
    head = probe.head_as_params(res)
    assert head["kernel"].shape == (8, 3)


class TestAgainstReference:
    @pytest.mark.parametrize("targets", [(), (1,), (3,)])
    @pytest.mark.parametrize("sigma", [1e-3, 1e-2, 1.0])
    def test_one_shot_probe(self, targets, sigma):
        X, Y = _np((120, 10), 2), _np((120, *targets), 3)
        rt = probe.one_shot_probe(torch.tanh, torch.from_numpy(X), torch.from_numpy(Y),
                                  sigma=sigma)
        rj = jprobe.one_shot_probe(jnp.tanh, jnp.asarray(X), jnp.asarray(Y), sigma=sigma)
        assert rt.weights.shape == rj.weights.shape
        assert rt.sigma == rj.sigma == sigma
        assert _rel(rt.weights, rj.weights) <= 1e-5
        assert _rel(rt.stats.gram, rj.stats.gram) <= 1e-6
        assert _rel(rt.stats.moment, rj.stats.moment) <= 1e-6
        assert int(rt.stats.count) == int(rj.stats.count) == 120
        assert rt.stats.count.dtype == torch.int32
        mt = probe.probe_mse(torch.tanh, torch.from_numpy(X), torch.from_numpy(Y), rt)
        mj = jprobe.probe_mse(jnp.tanh, jnp.asarray(X), jnp.asarray(Y), rj)
        assert abs(float(mt) - float(mj)) <= 1e-5 * float(mj)

    @pytest.mark.parametrize("targets", [(), (4,)])
    def test_feature_stats_of_bf16_features(self, targets):
        """bf16 features accumulate in float32, as the reference's einsum
        with ``preferred_element_type`` does."""
        F = jnp.asarray(_np((64, 16), 4)).astype(jnp.bfloat16)
        Y = _np((64, *targets), 5)
        sj = jprobe._feature_stats(F, jnp.asarray(Y))
        st = probe._feature_stats(convert.tensor_from_numpy(F, device="cpu"),
                                  torch.from_numpy(Y))
        assert st.gram.dtype == torch.float32 == st.moment.dtype
        assert sj.gram.dtype == jnp.float32 == sj.moment.dtype
        assert _rel(st.gram, sj.gram) <= 1e-6
        assert _rel(st.moment, sj.moment) <= 1e-6

    @pytest.mark.parametrize("targets", [(), (2,)])
    def test_solve_head(self, targets):
        sj = jprobe._feature_stats(jnp.asarray(_np((50, 6), 6)),
                                   jnp.asarray(_np((50, *targets), 7)))
        st = core.SuffStats(*(convert.tensor_from_numpy(x, device="cpu")
                              for x in (sj.gram, sj.moment, sj.count)))
        assert _rel(probe.solve_head(st, 0.1), jprobe.solve_head(sj, 0.1)) <= 1e-5

    def test_head_as_params(self):
        for targets in ((), (3,)):
            X, Y = _np((40, 5), 8), _np((40, *targets), 9)
            rt = probe.one_shot_probe(torch.tanh, torch.from_numpy(X),
                                      torch.from_numpy(Y))
            rj = jprobe.one_shot_probe(jnp.tanh, jnp.asarray(X), jnp.asarray(Y))
            ht, hj = probe.head_as_params(rt), jprobe.head_as_params(rj)
            assert set(ht) == set(hj) == {"kernel", "bias"}
            for k in ht:
                assert tuple(ht[k].shape) == hj[k].shape
                assert ht[k].dtype == torch.float32
            assert not ht["bias"].any()
            assert _rel(ht["kernel"], hj["kernel"]) <= 1e-5

    def test_mesh_raises_naming_item_15(self):
        """The mesh half (item 15) runs: rows split over the client axes,
        one reduction, the same head as one device; the reference's mesh in
        this process is 1 x 1."""
        from repro.launch import mesh as jmesh_lib
        from repro_torch.launch.mesh import make_cpu_mesh

        X, y = _np((64, 6), 5), _np((64, 2), 6)
        W = _np((6, 5), 7)
        got = probe.one_shot_probe(lambda x: torch.tanh(x @ torch.from_numpy(W)),
                                   torch.from_numpy(X), torch.from_numpy(y),
                                   mesh=make_cpu_mesh(8))
        one = probe.one_shot_probe(lambda x: torch.tanh(x @ torch.from_numpy(W)),
                                   torch.from_numpy(X), torch.from_numpy(y))
        ref = jprobe.one_shot_probe(lambda x: jnp.tanh(x @ W), jnp.asarray(X),
                                    jnp.asarray(y),
                                    mesh=jmesh_lib.make_host_mesh((1, 1)))
        assert _rel(got.weights, one.weights.numpy()) <= 1e-4
        assert _rel(got.weights, ref.weights) <= 1e-4
        assert int(got.stats.count) == 64


# -- frozen reduced-gemma3 features ----------------------------------------------

def _port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    for key in ("stage_pattern", "tail_pattern"):
        fields[key] = tuple(config.LayerSpec(**s) for s in fields[key])
    return config.ArchConfig(**fields)


@functools.cache
def _gemma():
    jcfg = jconfigs.get_reduced(ARCH)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    lm = convert.model_params_from(jax.tree.map(np.asarray, params), _port_cfg(jcfg),
                                   device="cpu")
    return params, lm, jcfg


def _jax_features(params, jcfg, tokens):
    """Final-norm hidden states per token, through the reference's layers."""
    x = jmodel._input_embeddings(params, {"tokens": tokens}, jcfg)
    for s in range(jcfg.num_stages):
        for pos, spec in enumerate(jcfg.stage_pattern):
            layer = jax.tree.map(lambda a, s=s: a[s], params["stages"][pos])
            x = jblocks.apply_layer(layer, x, jcfg, spec, chunk_size=16,
                                    collect_aux=None)
    for pos, spec in enumerate(jcfg.tail_pattern):
        x = jblocks.apply_layer(params["tail"][pos], x, jcfg, spec, chunk_size=16,
                                collect_aux=None)
    x = jlayers.rmsnorm(params["final_norm"], x, jcfg.norm_eps)
    return x.reshape(-1, jcfg.d_model)


def _port_features(lm, tokens):
    x = lm.embed(tokens)
    for layer in lm.all_layers():
        x = blocks.apply_layer(layer, x, lm.cfg)
    return lm.final_norm(x).reshape(-1, lm.cfg.d_model)


class TestGemmaProbe:
    @pytest.mark.parametrize("targets", [(), (4,)])
    def test_probe_on_frozen_features(self, targets):
        params, lm, jcfg = _gemma()
        rng = np.random.default_rng(0)
        toks = rng.integers(0, 512, (2, 48)).astype(np.int32)
        with torch.no_grad():
            ft = _port_features(lm, torch.from_numpy(toks))
        fj = _jax_features(params, jcfg, jnp.asarray(toks))
        ref = np.asarray(fj, np.float32)
        assert ft.shape == ref.shape == (96, jcfg.d_model)
        np.testing.assert_allclose(ft.float().numpy(), ref, rtol=0,
                                   atol=1e-4 * max(float(np.abs(ref).max()), 1.0))
        w_true = rng.standard_normal((jcfg.d_model, *targets)).astype(np.float32)
        y = ref @ w_true + 0.01 * rng.standard_normal((96, *targets)).astype(np.float32)
        sigma = 1.0
        rt = probe.one_shot_probe(lambda t: _port_features(lm, t).detach(),
                                  torch.from_numpy(toks), torch.from_numpy(y), sigma=sigma)
        rj = jprobe.one_shot_probe(lambda t: _jax_features(params, jcfg, t),
                                   jnp.asarray(toks), jnp.asarray(y), sigma=sigma)
        assert rt.weights.shape == rj.weights.shape
        # the heads answer alike on the features (predictions), and the
        # one-shot head is the centralized float64 solve on its own features
        pt = ft.float().numpy() @ rt.weights.numpy()
        pj = ref @ np.asarray(rj.weights)
        assert _rel(pt, pj) <= 1e-4
        F = ft.double()
        w64 = torch.linalg.solve(F.T @ F + sigma * torch.eye(F.shape[1], dtype=torch.float64),
                                 F.T @ torch.from_numpy(y).double())
        assert _rel(rt.weights, w64) <= 1e-3
