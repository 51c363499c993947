"""The port's pytree checkpointing (``repro_torch.checkpoint``) against the
JAX package's (``repro.checkpoint``).

The durable pool trusts its snapshots to this module, so it is held to the
reference's own tests (``tests/test_checkpoint.py``): bitwise roundtrips at
f64 / f32 / bf16, step discovery with gaps, restore onto a template's dtype,
onto a device and onto a sharded template (a ``ShardedTensor`` on a mesh of
8 CPU shards: the pool's restore of a sharded tenant). Beyond those, the npz keys are the reference's key
strings (``jax.tree_util.keystr``), and a step written by either package
restores in the other bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro_torch import checkpoint


def _tree(rng):
    """A nested tree shaped like engine state: dict / list / tuple, mixed
    dtypes, scalar leaves."""
    return {
        "G": rng.standard_normal((5, 5)).astype(np.float32),
        "h": rng.standard_normal(5).astype(np.float32),
        "count": np.int32(17),
        "nested": {
            "factors": [rng.standard_normal((3, 3)).astype(np.float32),
                        rng.standard_normal(3).astype(np.float32)],
            "meta": (np.float32(0.25), np.arange(4, dtype=np.int32)),
        },
    }


def _leaves(tree):
    return [leaf for _, leaf in checkpoint.checkpoint._paths(tree)]


class TestRoundtrip:
    def test_exact_roundtrip_bits(self, tmp_path):
        tree = _tree(np.random.default_rng(0))
        checkpoint.save_pytree(tree, tmp_path, step=3)
        out = checkpoint.load_pytree(tree, tmp_path, step=3, device="cpu")
        assert out["nested"]["meta"].__class__ is tuple
        assert isinstance(out["nested"]["factors"], list)
        for r, o in zip(_leaves(tree), _leaves(out)):
            assert isinstance(o, torch.Tensor) and o.device.type == "cpu"
            assert o.numpy().dtype == np.asarray(r).dtype
            assert o.numpy().tobytes() == np.asarray(r).tobytes()

    def test_tensor_leaves_roundtrip(self, tmp_path):
        g = torch.Generator().manual_seed(0)
        tree = {"G": torch.randn(6, 6, generator=g, dtype=torch.float64),
                "n": torch.tensor(9, dtype=torch.int64)}
        checkpoint.save_pytree(tree, tmp_path, step=0)
        out = checkpoint.load_pytree(tree, tmp_path, step=0, device="cpu")
        for k in tree:
            assert out[k].dtype == tree[k].dtype
            assert torch.equal(out[k], tree[k])

    def test_bf16_leaves_roundtrip(self, tmp_path):
        """bf16 is a wire dtype and a storage dtype: its leaves survive npz
        (which has no bf16) bit for bit, widened to float32 on disk."""
        g = torch.Generator().manual_seed(1)
        tree = {"w": torch.randn(64, generator=g).to(torch.bfloat16),
                "G": torch.randn(8, 8, generator=g).to(torch.bfloat16)}
        checkpoint.save_pytree(tree, tmp_path, step=0)
        with np.load(tmp_path / "step_00000000.npz") as data:
            assert data["['w']"].dtype == np.float32
        out = checkpoint.load_pytree(tree, tmp_path, step=0, device="cpu")
        for k in tree:
            assert out[k].dtype == torch.bfloat16
            assert torch.equal(out[k].view(torch.int16),
                               tree[k].view(torch.int16))

    def test_restore_casts_to_template_dtype(self, tmp_path):
        """The template owns the dtype: an f32 save restored onto a bf16
        template is bf16 with round-to-nearest-even values, as in JAX."""
        x = np.linspace(0, 1, 16, dtype=np.float32)
        checkpoint.save_pytree({"x": x}, tmp_path, step=1)
        down = checkpoint.load_pytree(
            {"x": torch.zeros(16, dtype=torch.bfloat16)}, tmp_path, step=1,
            device="cpu")
        assert down["x"].dtype == torch.bfloat16
        want = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        assert down["x"].float().numpy().tobytes() == want.tobytes()

    def test_wide_leaves_keep_their_width(self, tmp_path):
        """The npz keeps 64-bit leaves at full width, and the port restores
        them so (torch has no x64 switch; the reference narrows them when
        ``jax_enable_x64`` is off)."""
        tree = {"h": np.linspace(0, 1, 8), "n": np.int64(9)}   # f64 / i64
        checkpoint.save_pytree(tree, tmp_path, step=2)
        with np.load(tmp_path / "step_00000002.npz") as data:
            assert data["['h']"].dtype == np.float64
        out = checkpoint.load_pytree(tree, tmp_path, step=2, device="cpu")
        assert out["h"].dtype == torch.float64
        assert out["n"].dtype == torch.int64 and int(out["n"]) == 9

    def test_meta_template_allocates_nothing_and_restores(self, tmp_path):
        G = np.arange(12, dtype=np.float32).reshape(3, 4)
        checkpoint.save_pytree({"G": G}, tmp_path, step=4)
        template = {"G": torch.empty((3, 4), dtype=torch.float64,
                                     device="meta")}
        out = checkpoint.load_pytree(template, tmp_path, step=4, device="cpu")
        assert out["G"].dtype == torch.float64
        assert np.array_equal(out["G"].numpy(), G.astype(np.float64))

    def test_missing_leaf_key_raises(self, tmp_path):
        checkpoint.save_pytree({"a": np.ones(2)}, tmp_path, step=0)
        with pytest.raises(KeyError):
            checkpoint.load_pytree({"a": np.ones(2), "b": np.ones(2)},
                                   tmp_path, step=0, device="cpu")

    def test_manifest_written(self, tmp_path):
        tree = _tree(np.random.default_rng(2))
        path = checkpoint.save_pytree(tree, tmp_path, step=42)
        assert path.name == "step_00000042.npz"
        manifest = (tmp_path / "step_00000042.json").read_text()
        assert '"step": 42' in manifest
        assert f'"num_leaves": {len(_leaves(tree))}' in manifest

    def test_restore_onto_sharded_template(self, tmp_path):
        """Save a replicated tree, restore onto a mesh-sharded template: the
        restored leaves carry the template's mesh and spec, bitwise (what
        the pool's snapshot restore does for sharded-placement tenants)."""
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.launch.sharding import P, ShardedTensor

        mesh = mesh_lib.make_cpu_mesh(8)
        rng = np.random.default_rng(3)
        G = rng.standard_normal((8, 8)).astype(np.float32)
        h = rng.standard_normal(8).astype(np.float32)
        jcheckpoint.save_pytree({"G": G, "h": h}, tmp_path, step=7)
        template = {"G": ShardedTensor.distribute(torch.zeros(8, 8), mesh,
                                                  P("data", "model")),
                    "h": ShardedTensor.distribute(torch.zeros(8, dtype=torch.float64),
                                                  mesh, P("data"))}
        out = checkpoint.load_pytree(template, tmp_path, step=7, device="cpu")
        assert out["G"].spec == P("data", "model") and out["G"].mesh is mesh
        assert out["h"].spec == P("data") and out["h"].dtype == torch.float64
        assert len(out["G"].blocks) == 8 and len(out["h"].blocks) == 4
        assert out["G"].full().numpy().tobytes() == G.tobytes()
        assert np.array_equal(out["h"].full().numpy(), h.astype(np.float64))
        # a sharded leaf saves whole, as the reference's arrays do
        checkpoint.save_pytree({"G": out["G"]}, tmp_path / "again", step=1)
        back = jcheckpoint.load_pytree({"G": jnp.zeros((8, 8), jnp.float32)},
                                       tmp_path / "again", step=1)
        assert np.asarray(back["G"]).tobytes() == G.tobytes()
        with pytest.raises(ValueError, match="template"):
            checkpoint.load_pytree({"G": template["h"], "h": template["h"]},
                                   tmp_path, step=7)


class TestLatestStep:
    def test_gaps_and_zero(self, tmp_path):
        for step in (0, 3, 17):
            checkpoint.save_pytree({"x": np.ones(1)}, tmp_path, step=step)
        assert checkpoint.latest_step(tmp_path) == 17

    def test_empty_dir(self, tmp_path):
        assert checkpoint.latest_step(tmp_path) is None

    def test_missing_dir(self, tmp_path):
        assert checkpoint.latest_step(tmp_path / "never_made") is None

    def test_ignores_foreign_files(self, tmp_path):
        checkpoint.save_pytree({"x": np.ones(1)}, tmp_path, step=5)
        (tmp_path / "step_junk.npz").write_bytes(b"")
        (tmp_path / "wal_00000009.log").write_bytes(b"")
        assert checkpoint.latest_step(tmp_path) == 5


class TestAgainstTheReference:
    def _snapshot_like(self, rng):
        """The durable pool's tree: tenants and clients keyed by index."""
        def entry():
            return {"gram": rng.standard_normal((4, 4)).astype(np.float32),
                    "moment": rng.standard_normal(4).astype(np.float32),
                    "count": np.asarray(7, np.int64),
                    "yty": np.float32(3.5)}
        return {"t0": {"fused": entry(), "clients": {"c0": entry(),
                                                     "c1": entry()},
                       "dropped": {}},
                "t1": {"fused": entry(), "clients": {}, "dropped": {"d0": entry()}},
                "lst": [np.ones(2, np.float32), (np.zeros(1, np.int32), None)]}

    def test_key_strings_are_the_references(self, tmp_path):
        tree = self._snapshot_like(np.random.default_rng(3))
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        want = [jax.tree_util.keystr(p) for p, _ in flat]
        got = [k for k, _ in checkpoint.checkpoint._paths(tree)]
        assert got == want
        assert "['t0']['fused']['gram']" in got
        checkpoint.save_pytree(tree, tmp_path / "port", step=1)
        jcheckpoint.save_pytree(tree, tmp_path / "jax", step=1)
        for name in ("step_00000001.json",):
            assert ((tmp_path / "port" / name).read_text()
                    == (tmp_path / "jax" / name).read_text())
        with np.load(tmp_path / "port" / "step_00000001.npz") as a, \
                np.load(tmp_path / "jax" / "step_00000001.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()

    def test_jax_written_step_restores_into_the_port_and_back(self, tmp_path):
        tree = self._snapshot_like(np.random.default_rng(4))
        jcheckpoint.save_pytree(tree, tmp_path / "a", step=2)
        out = checkpoint.load_pytree(tree, tmp_path / "a", step=2,
                                     device="cpu")
        for r, o in zip(_leaves(tree), _leaves(out)):
            assert o.numpy().tobytes() == np.asarray(r).tobytes()
        # and the port's write of what it restored loads in the reference
        checkpoint.save_pytree(out, tmp_path / "b", step=2)
        # (the reference narrows the int64 count without jax_enable_x64)
        back = jcheckpoint.load_pytree(tree, tmp_path / "b", step=2)
        for r, o in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back)):
            assert np.array_equal(np.asarray(o), np.asarray(r))

    def test_bf16_steps_cross_both_ways(self, tmp_path):
        rng = np.random.default_rng(5)
        x = rng.standard_normal(32).astype(np.float32)
        jcheckpoint.save_pytree({"x": jnp.asarray(x, jnp.bfloat16)},
                                tmp_path / "a", step=0)
        out = checkpoint.load_pytree(
            {"x": torch.zeros(32, dtype=torch.bfloat16)}, tmp_path / "a",
            step=0, device="cpu")
        want = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        assert out["x"].float().numpy().tobytes() == want.tobytes()
        checkpoint.save_pytree(out, tmp_path / "b", step=0)
        back = jcheckpoint.load_pytree({"x": jnp.zeros(32, jnp.bfloat16)},
                                       tmp_path / "b", step=0)
        assert np.asarray(back["x"], np.float32).tobytes() == want.tobytes()
