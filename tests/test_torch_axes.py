"""Port parity for the logical-axis trees and the model-parameter shardings.

``models.model.param_axes`` / ``cache_axes`` (and the ``axes_*`` functions
of the layers they read) are held to the reference's leaf for leaf, for all
ten configs, exactly; the by-name view covers every parameter of a port
model. Then the shardings: ``ShardingRules.tree_shardings`` of the port's
axes over the port's meta specs (``launch/specs.py``) against the
reference's ``tree_shardings`` over its ``eval_shape`` trees, on the
abstract meshes of tests/test_torch_sharding.py (16 x 16, 2 x 16 x 16,
4 x 2) and the four model-parameter rule tables: every resolved spec and
every ``shard_shape`` equal; ``opt_state_shardings`` likewise, its count
replicated; ``ShardedTensor.distribute`` takes a ``NamedSharding``.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, specs
from repro_torch.models import model as M

ARCHS = list(configs.ARCH_IDS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
RULES = ("DEFAULT_RULES", "ZERO1_PARAM_RULES", "STACK_FSDP_RULES", "DECODE_RULES")


def _jmesh(shape, axes):
    try:
        return JAbstractMesh(shape, axes)
    except TypeError:  # jax<=0.4 signature: tuple of (name, size) pairs
        return JAbstractMesh(tuple(zip(axes, shape)))


def flat(tree, leaf_type, path=()):
    """{path: leaf} of a tree of dicts and tuples (both packages' layouts)."""
    if isinstance(tree, leaf_type) or not isinstance(tree, (dict, tuple, list)):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat(v, leaf_type, path + (k,)))
    return out


def _jflat(tree):
    return flat(tree, (JP, jax.ShapeDtypeStruct, JNamedSharding))


def _tflat(tree):
    return flat(tree, (sharding.PartitionSpec, torch.Tensor, sharding.NamedSharding))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's axes and eval_shape trees of a config (cached: pure)."""
    cfg = jconfigs.get(arch)
    return jmodel.param_axes(cfg), jspecs.params_specs(cfg), jspecs.opt_specs(cfg)


@functools.lru_cache(maxsize=None)
def _port(arch):
    cfg = configs.get(arch)
    return M.param_axes(cfg), specs.params_specs(cfg), specs.opt_specs(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch):
    want = _jflat(jmodel.param_axes(jconfigs.get(arch)))
    got = _tflat(M.param_axes(configs.get(arch)))
    assert got.keys() == want.keys()
    for path, spec in want.items():
        assert isinstance(got[path], sharding.PartitionSpec), path
        assert tuple(got[path]) == tuple(spec), path


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_match_reference(arch):
    """An encoder has no cache: both packages raise for its layers."""
    if configs.get(arch).encoder_only:
        with pytest.raises(ValueError, match="full_bidir"):
            jmodel.cache_axes(jconfigs.get(arch))
        with pytest.raises(ValueError, match="full_bidir"):
            M.cache_axes(configs.get(arch))
        return
    want = _jflat(jmodel.cache_axes(jconfigs.get(arch)))
    got = _tflat(M.cache_axes(configs.get(arch)))
    assert got.keys() == want.keys()
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), path


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_by_name_cover_every_parameter(arch):
    """Every named parameter of a (meta) port model has a spec of its rank:
    its stage-pattern position's spec without the leading "stack"."""
    cfg = configs.get(arch)
    lm = M.BackboneLM(cfg, device="meta")
    by_name = M.param_axes_by_name(cfg)
    named = dict(lm.named_parameters())
    assert list(by_name) == list(named)
    stacked = _tflat(M.param_axes(cfg))
    for name, p in named.items():
        assert len(by_name[name]) == p.ndim, name
        parts = name.split(".")
        if parts[0] == "stages":
            key = ("stages", int(parts[2]), *parts[3:])
            assert tuple(stacked[key]) == ("stack", *by_name[name])
        elif parts[0] == "tail":
            assert tuple(stacked[("tail", int(parts[1]), *parts[2:])]) == tuple(by_name[name])
        else:
            assert tuple(stacked[tuple(parts)]) == tuple(by_name[name])


def _assert_same_shardings(got, want):
    assert got.keys() == want.keys()
    for path, jsh in want.items():
        tsh = got[path]
        assert isinstance(tsh, sharding.NamedSharding), path
        assert tuple(tsh.spec) == tuple(jsh.spec), path


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("table", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_shardings_match_reference(arch, table, mesh_name):
    """Every parameter leaf's resolved spec and shard shape, and AdamW's
    state's, equal the reference's; the count is replicated."""
    shape, axes = MESHES[mesh_name]
    jm, tm = _jmesh(shape, axes), mesh_lib.make_mesh(shape, axes, device="meta")
    jrules, trules = getattr(jsharding, table), getattr(sharding, table)
    j_axes, j_params, j_opt = _reference(arch)
    t_axes, t_params, t_opt = _port(arch)

    want = _jflat(jsharding.params_shardings(jrules, j_axes, j_params, jm))
    got = _tflat(sharding.params_shardings(trules, t_axes, t_params, tm))
    _assert_same_shardings(got, want)
    leaves = _tflat(t_params)
    for path, jsh in want.items():
        dims = tuple(leaves[path].shape)
        assert got[path].shard_shape(dims) == tuple(jsh.shard_shape(dims)), path

    want = _jflat(jsharding.opt_state_shardings(jrules, j_axes, j_opt, jm))
    got = _tflat(sharding.opt_state_shardings(trules, t_axes, t_opt, tm))
    _assert_same_shardings(got, want)
    assert tuple(got[("count",)].spec) == ()


def test_tree_shardings_take_shapes_and_check_structure():
    """Leaves may be shapes as well as tensors; trees of another structure
    raise."""
    tm = mesh_lib.make_mesh((4, 2), ("data", "model"), device="meta")
    axes = {"w": sharding.P("embed", "ff"), "b": (sharding.P("ff"),)}
    got = sharding.DEFAULT_RULES.tree_shardings(axes, {"w": (8, 6), "b": ((6,),)}, tm)
    assert tuple(got["w"].spec) == ("data", "model")
    assert got["w"].shard_shape((8, 6)) == (2, 3)
    assert tuple(got["b"][0].spec) == ("model",)
    with pytest.raises(ValueError):
        sharding.DEFAULT_RULES.tree_shardings(axes, {"w": (8, 6)}, tm)
    with pytest.raises(ValueError):
        sharding.DEFAULT_RULES.tree_shardings(axes, {"w": (8, 6), "b": ()}, tm)


def test_production_mesh_and_card_constants():
    """The reference's production meshes, on meta; the H100's peaks."""
    pod1 = mesh_lib.make_production_mesh()
    pod2 = mesh_lib.make_production_mesh(multi_pod=True)
    assert pod1.shape == {"data": 16, "model": 16}
    assert pod2.shape == {"pod": 2, "data": 16, "model": 16}
    assert pod1.distinct_devices == [torch.device("meta")]
    bw, fp32, bf16, tf32 = mesh_lib.card_peaks("NVIDIA H100 80GB HBM3")
    assert (bw, bf16) == (mesh_lib.HBM_BANDWIDTH, mesh_lib.PEAK_FLOPS_BF16)
    assert mesh_lib.card_peaks("NVIDIA H100 PCIe")[0] == 2.0e12
    with pytest.raises(RuntimeError):
        mesh_lib.card_peaks("NVIDIA A100-SXM4-80GB")


def test_distribute_takes_a_named_sharding():
    """A parameter laid out by its by-name spec on the (4, 2) CPU mesh: the
    blocks are the NamedSharding's shard shape and reassemble bitwise."""
    cfg = configs.get_reduced("yi-9b")
    lm = M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    mesh = mesh_lib.make_cpu_mesh(8)
    by_name = M.param_axes_by_name(cfg)
    for name, p in lm.named_parameters():
        sh = sharding.DEFAULT_RULES.named(by_name[name], p.shape, mesh)
        st = sharding.ShardedTensor.distribute(p, sh)
        assert {tuple(b.shape) for b in st.blocks.values()} == {sh.shard_shape(p.shape)}
        assert torch.equal(st.full(), p)
    with pytest.raises(ValueError, match="carries its spec"):
        sharding.ShardedTensor.distribute(p, sh, sh.spec)
    np.testing.assert_equal(
        sharding.DEFAULT_RULES.named(by_name["head.kernel"], (256, 512), mesh).shard_shape(
            (256, 512)), (64, 256))
