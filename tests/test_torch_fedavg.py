"""The paper's iterative baselines in the port (``repro_torch.fed.fedavg``)
against the reference, and the DP one-shot protocol's sanity check.

Datasets are the reference's (``repro.data.generate`` from a JAX key),
carried over with ``convert.dataset_from_numpy``. The reference's
``TestIterative`` and ``test_dp_protocol_noisy_but_sane`` run on the port;
then both packages run the same configurations: the client-sampling masks
and the DP-FedAvg noise are ``jax.random``'s bits, and the weights and
iterates agree at rtol 1e-4 (XLA fuses the reference's scan body, torch
runs the products one by one).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import data as jdata
from repro import fed as jfed
from repro_torch import configs, core, fed
from repro_torch.configs import ridge
from repro_torch.convert import dataset_from_numpy
from repro_torch.core import privacy, threefry
from repro_torch.fed import fedavg


def _datasets(seed=0, **kw):
    defaults = dict(num_clients=8, samples_per_client=100, dim=20, gamma=0.5)
    defaults.update(kw)
    dj = jdata.generate(jax.random.PRNGKey(seed), **defaults)
    dt = dataset_from_numpy([(np.asarray(A), np.asarray(b)) for A, b in dj.clients],
                            dj.test_A, dj.test_b, dj.w_star, dj.gamma, device="cpu")
    return dj, dt


def _ds(seed=0, **kw):
    return _datasets(seed, **kw)[1]


def _mse(ds, w) -> float:
    return float(core.mse(ds.test_A, ds.test_b, w))


class TestIterative:
    """tests/test_fed.py::TestIterative, on the port."""

    def test_fedavg_converges_iid(self):
        ds = _ds(gamma=0.0)
        res = fed.run_iterative(ds, fed.IterativeConfig(rounds=300, sigma=0.01))
        oracle = fed.run_centralized(ds, 0.01)
        assert _mse(ds, res.weights) < 1.05 * _mse(ds, oracle.weights)

    def test_fedprox_runs(self):
        ds = _ds()
        res = fed.run_iterative(ds, fed.IterativeConfig(rounds=50, sigma=0.01,
                                                        prox_mu=0.01))
        assert np.isfinite(_mse(ds, res.weights))

    def test_history_tracking(self):
        ds = _ds()
        res = fed.run_iterative(ds, fed.IterativeConfig(rounds=30, sigma=0.01),
                                track_history=True)
        assert res.extras["history"].shape == (30, ds.dim)

    def test_prop4_single_gradient_step_insufficient(self):
        ds = _ds(num_clients=20, samples_per_client=500, dim=50)
        one = fed.run_one_shot(ds, 0.01)
        m_one = _mse(ds, one.weights)
        best = min(_mse(ds, fed.one_gradient_step(ds, float(eta)))
                   for eta in np.logspace(-7, -1, 25))
        assert best > 1.5 * m_one

    def test_client_sampling(self):
        ds = _ds()
        res = fed.run_iterative(ds, fed.IterativeConfig(
            rounds=60, sigma=0.01, sample_fraction=0.5))
        assert np.isfinite(_mse(ds, res.weights))


def test_dp_protocol_noisy_but_sane():
    """tests/test_fed.py's Algorithm-2 check, on the port."""
    ds = _ds(num_clients=20, samples_per_client=500, dim=30)
    res = fed.run_one_shot(ds, 0.01, dp=(5.0, 1e-5), dp_key=threefry.key(3))
    clean = fed.run_one_shot(ds, 0.01)
    m_dp, m_cl = _mse(ds, res.weights), _mse(ds, clean.weights)
    assert m_dp != m_cl and m_dp < 20 * m_cl + 0.1


def _jax_schedule(cfg, K, d):
    """The reference's per-round masks and DP noise, drawn as its scan body
    draws them."""
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.rounds)
    tau = 0.0
    if cfg.dp_eps is not None:
        tau = privacy.gaussian_tau(privacy.per_round_budget(cfg.dp_eps, cfg.rounds),
                                   cfg.dp_delta, cfg.dp_clip)
    masks, noise = [], []
    for rk in keys:
        k_sample, k_noise = jax.random.split(rk)
        if cfg.sample_fraction < 1.0:
            m = max(1, int(cfg.sample_fraction * K))
            perm = jax.random.permutation(k_sample, K)
            masks.append(np.asarray(jnp.zeros((K,)).at[perm[:m]].set(1.0)))
        else:
            masks.append(np.ones(K, np.float32))
        noise.append(np.asarray(jax.random.normal(k_noise, (K, d)) * tau))
    return np.stack(masks), np.stack(noise)


CASES = {
    "fedavg": {},
    "fedprox": {"prox_mu": 0.01},
    "sampling_0.5": {"sample_fraction": 0.5},
    "sampling_0.3_seed_5": {"sample_fraction": 0.3, "seed": 5},
    "dp_fedavg": {"dp_eps": 5.0, "dp_clip": 0.5},
    "dp_sampled_fedprox": {"dp_eps": 1.0, "sample_fraction": 0.5, "prox_mu": 0.01,
                           "seed": 3},
}


class TestAgainstReference:
    @pytest.mark.parametrize("case", list(CASES))
    def test_schedule_bits(self, case):
        cfg = fed.IterativeConfig(rounds=25, **CASES[case])
        K, d = 8, 20
        tau = 0.0
        if cfg.dp_eps is not None:
            tau = privacy.gaussian_tau(privacy.per_round_budget(cfg.dp_eps, cfg.rounds),
                                       cfg.dp_delta, cfg.dp_clip)
        masks, m, noise = fedavg._schedule(cfg, K, d, tau)
        jmasks, jnoise = _jax_schedule(cfg, K, d)
        np.testing.assert_array_equal(masks, jmasks)
        assert m == (max(1, int(cfg.sample_fraction * K))
                     if cfg.sample_fraction < 1.0 else K)
        if cfg.dp_eps is None:
            assert noise is None
        else:
            np.testing.assert_array_equal(noise, jnoise)

    @pytest.mark.parametrize("case", list(CASES))
    def test_run_iterative_matches(self, case):
        dj, dt = _datasets(seed=1)
        kw = dict(rounds=40, **CASES[case])
        rj = jfed.run_iterative(dj, jfed.IterativeConfig(**kw), track_history=True)
        rt = fed.run_iterative(dt, fed.IterativeConfig(**kw), track_history=True)
        hj, ht = np.asarray(rj.extras["history"]), rt.extras["history"].numpy()
        assert ht.shape == hj.shape == (40, dt.dim)
        np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights),
                                   rtol=1e-4, atol=1e-4 * np.abs(hj).max())
        np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-4 * np.abs(hj).max())
        assert dataclasses.asdict(rt.comm) == dataclasses.asdict(rj.comm)
        assert rt.rounds == rj.rounds == 40
        assert rt.weights.dtype == torch.float32

    def test_sample_fraction_rounding(self):
        """``int(f K)`` and ``max(1, ...)`` as the reference takes them."""
        for f, K in ((0.5, 8), (0.3, 8), (0.01, 8), (0.99, 7)):
            cfg = fed.IterativeConfig(rounds=3, sample_fraction=f)
            masks, m, _ = fedavg._schedule(cfg, K, 4, 0.0)
            assert m == max(1, int(f * K))
            assert (masks.sum(1) == m).all()
            np.testing.assert_array_equal(masks, _jax_schedule(cfg, K, 4)[0])

    def test_dp_float64_raises(self):
        _, dt = _datasets(num_clients=2, samples_per_client=10, dim=4)
        d64 = dataclasses.replace(dt, clients=tuple((A.double(), b.double())
                                                    for A, b in dt.clients))
        with pytest.raises(ValueError, match="float32"):
            fed.run_iterative(d64, fed.IterativeConfig(rounds=2, dp_eps=1.0))
        res = fed.run_iterative(d64, fed.IterativeConfig(rounds=2))
        assert res.weights.dtype == torch.float64

    @pytest.mark.parametrize("eta", [1e-4, 1e-2])
    def test_one_gradient_step_matches(self, eta):
        dj, dt = _datasets(seed=2)
        np.testing.assert_allclose(fed.one_gradient_step(dt, eta).numpy(),
                                   np.asarray(jfed.one_gradient_step(dj, eta)),
                                   rtol=1e-5, atol=1e-6)

    def test_configs_have_the_reference_fields(self):
        assert [(f.name, f.default) for f in dataclasses.fields(fed.IterativeConfig)] == \
            [(f.name, f.default) for f in dataclasses.fields(jfed.IterativeConfig)]
        assert [(f.name, f.default) for f in dataclasses.fields(ridge.RidgeConfig)] == \
            [(f.name, f.default) for f in dataclasses.fields(type(jconfigs.RIDGE))]
        assert dataclasses.asdict(configs.RIDGE) == dataclasses.asdict(jconfigs.RIDGE)

    def test_fed_exports_the_reference_names(self):
        assert set(jfed.__all__) - set(fed.__all__) == set()
