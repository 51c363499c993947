"""Port parity for server/cholesky.py: rank-1 scan, blocked update, PSD vectors.

Mirrors tests/test_mutation_path.py inside the port (blocked == scan at its
2e-4 tolerance) and holds each function against ``repro.server.cholesky`` on
the same numpy inputs. ``psd_update_vectors`` is compared through U^T U, not
through its numerical rank, whose float32 cutoff sits at the eigh noise
(ROADMAP queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.server import cholesky as jchol
from repro_torch.server import cholesky as tchol


def _factor(d, seed=0, sigma=0.1, scale=1.0):
    rng = np.random.default_rng([d, seed])
    A = (rng.standard_normal((2 * d, d)) * scale).astype(np.float32)
    G = A.T @ A + sigma * np.eye(d, dtype=np.float32)
    return np.linalg.cholesky(G.astype(np.float64)).astype(np.float32), A


def _vectors(r, d, seed=1, scale=1.0):
    rng = np.random.default_rng([r, d, seed])
    return (scale * rng.standard_normal((r, d))).astype(np.float32)


class TestRank1:
    @pytest.mark.parametrize("d,r", [(8, 1), (24, 3), (40, 5)])
    @pytest.mark.parametrize("sign", [1.0, -1.0])
    def test_chol_update_matches_jax(self, d, r, sign):
        L, _ = _factor(d)
        U = _vectors(r, d, scale=0.3)
        got = tchol.chol_update(torch.from_numpy(L), torch.from_numpy(U), sign=sign)
        ref = jchol.chol_update(jnp.asarray(L), jnp.asarray(U), sign=sign)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)

    def test_inputs_untouched(self):
        L, _ = _factor(12)
        Lt, xt = torch.from_numpy(L.copy()), torch.from_numpy(_vectors(1, 12)[0])
        before = (Lt.clone(), xt.clone())
        tchol.chol_rank1(Lt, xt)
        assert torch.equal(Lt, before[0]) and torch.equal(xt, before[1])


class TestBlocked:
    @pytest.mark.parametrize("d,r,bs", [(16, 3, 8), (48, 8, 16), (100, 17, 32),
                                        (64, 64, 32)])
    def test_matches_scan_reference(self, d, r, bs):
        L, _ = _factor(d, seed=d + r)
        U = torch.from_numpy(_vectors(r, d))
        Lt = torch.from_numpy(L)
        ref = tchol.chol_update(Lt, U)
        got = tchol.chol_update_blocked(Lt, U, block_size=bs)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("d,r,bs", [(40, 9, 16), (33, 12, 32)])
    def test_matches_jax_blocked(self, d, r, bs):
        L, _ = _factor(d, seed=5)
        U = _vectors(r, d, seed=5)
        got = tchol.chol_update_blocked(torch.from_numpy(L), torch.from_numpy(U),
                                        block_size=bs)
        ref = jchol.chol_update_blocked(jnp.asarray(L), jnp.asarray(U),
                                        block_size=bs, use_pallas=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)

    def test_downdate_matches_scan(self):
        d, r = 48, 10
        L, _ = _factor(d)
        Lt, U = torch.from_numpy(L), torch.from_numpy(_vectors(r, d, seed=3, scale=0.3))
        ref = tchol.chol_update(tchol.chol_update(Lt, U), U, sign=-1.0)
        got = tchol.chol_update_blocked(tchol.chol_update_blocked(Lt, U), U, sign=-1.0)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)

    def test_downdate_near_sigma_floor(self):
        d, r, sigma = 40, 12, 1e-3
        L, A = _factor(d, sigma=sigma, scale=1e-3)
        target = A.astype(np.float64).T @ A + sigma * np.eye(d)
        Lt, U = torch.from_numpy(L), torch.from_numpy(_vectors(r, d, seed=7))
        for fn in (tchol.chol_update_blocked, tchol.chol_update):
            down = fn(fn(Lt, U, sign=1.0), U, sign=-1.0).double()
            recon_err = np.abs((down @ down.T).numpy() - target).max()
            assert recon_err < 0.05 * sigma, (fn.__name__, recon_err)

    @pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
    def test_dtypes(self, dtype):
        d, r = 32, 9
        L, _ = _factor(d)
        Lt = torch.from_numpy(L).to(dtype)
        U = torch.from_numpy(_vectors(r, d)).to(dtype)
        ref = tchol.chol_update(Lt, U)
        got = tchol.chol_update_blocked(Lt, U, block_size=16)
        assert got.dtype == ref.dtype == dtype
        tol = 1e-10 if dtype == torch.float64 else 1e-1
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                   rtol=tol, atol=tol)

    def test_rank_zero_is_identity(self):
        L, _ = _factor(8)
        Lt = torch.from_numpy(L)
        assert torch.equal(tchol.chol_update_blocked(Lt, torch.zeros(0, 8)), Lt)

    def test_snapshot_not_written_through(self):
        """Tensors are mutable: an (L, h) snapshot held elsewhere must survive
        an update of the same factor (the reference gets this from JAX's
        immutable arrays)."""
        L, _ = _factor(40)
        Lt = torch.from_numpy(L.copy())
        snap = Lt.clone()
        U = torch.from_numpy(_vectors(9, 40))
        tchol.chol_update_blocked(Lt, U, block_size=16)
        tchol.chol_update(Lt, U[:2])
        assert torch.equal(Lt, snap)


class TestPsdUpdateVectors:
    @pytest.mark.parametrize("n,d", [(7, 24), (30, 16), (3, 10)])
    def test_reconstructs_gram(self, n, d):
        rng = np.random.default_rng([n, d])
        A = rng.standard_normal((n, d)).astype(np.float32)
        G = A.T @ A
        Ut = tchol.psd_update_vectors(torch.from_numpy(G))
        Uj = np.asarray(jchol.psd_update_vectors(jnp.asarray(G)))
        np.testing.assert_allclose((Ut.T @ Ut).numpy(), G, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose((Ut.T @ Ut).numpy(), Uj.T @ Uj, rtol=1e-4, atol=1e-4)
        assert Ut.shape[0] >= min(n, d)

    def test_zero_gram(self):
        U = tchol.psd_update_vectors(torch.zeros(5, 5))
        assert U.shape == (0, 5)
