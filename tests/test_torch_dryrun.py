"""Port parity for ``launch/dryrun.py`` and ``launch/roofline.py``.

- Memory mode: the dry-run's per-device argument bytes of every runnable
  (config x input shape) on the 16 x 16, 2 x 16 x 16 and 4 x 2 meshes
  equal, as integers, the sum over the reference's ``eval_shape`` leaves of
  its ``NamedSharding.shard_shape`` times the leaf's item size, with the
  reference's dry-run shardings (``DEFAULT_RULES`` for parameters, AdamW's
  state and the batch; the cache for decode); the card's fitting depth is
  the largest that fits.
- Cost mode: at reduced yi-9b (2 stages, B 2, S 256) the FLOPs counted on
  meta equal an analytic count, term by term (matmul parameters x tokens,
  the plain attention's all-keys pairs; a training step's backward reads
  only the keys its causal mask keeps); a mesh's figure is the count over
  its devices; its collectives DTensor's bytes (tests/
  test_torch_dryrun_collectives.py holds them to XLA's).
- Roofline: tests/test_launch.py's ``TestRooflineMath`` on the port, and
  ``analytic_hbm_bytes`` / ``_model_flops`` against the reference's at
  1e-12 (hubert-xlarge's expected value from the port's parameter count).
- The CLI: ``--all --card --memory-only`` gives 33 OK and 7 SKIP.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding as JNamedSharding

from repro import configs as jconfigs
from repro.launch import roofline as jroofline
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import config as jconfig
from repro.models import model as jmodel
from repro_torch import configs
from repro_torch.kernels import gram
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.models import model as M
from repro_torch.models.config import INPUT_SHAPES, InputShape, shape_applicable

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(configs.ARCH_IDS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}


def _jmesh(shape, axes):
    try:
        return JAbstractMesh(shape, axes)
    except TypeError:  # jax<=0.4 signature: tuple of (name, size) pairs
        return JAbstractMesh(tuple(zip(axes, shape)))


def _jbytes(rules, axes, shapes, mesh) -> int:
    """Per-device bytes of a reference tree under its shardings."""
    shardings = rules.tree_shardings(axes, shapes, mesh)
    leaves = jax.tree.leaves(shapes)
    sh = jax.tree.leaves(shardings, is_leaf=lambda v: isinstance(v, JNamedSharding))
    assert len(leaves) == len(sh)
    return sum(math.prod(s.shard_shape(l.shape)) * np.dtype(l.dtype).itemsize
               for l, s in zip(leaves, sh))


@functools.lru_cache(maxsize=None)
def _jtrees(arch):
    cfg = jconfigs.get(arch)
    return jmodel.param_axes(cfg), jspecs.params_specs(cfg), jspecs.opt_specs(cfg)


def reference_argument_bytes(arch, shape_name, jm) -> dict:
    """The reference dry-run's arguments, per device, by group."""
    cfg, shape = jconfigs.get(arch), jconfig.INPUT_SHAPES[shape_name]
    rules = jsharding.DEFAULT_RULES
    p_axes, p_specs, o_specs = _jtrees(arch)
    b_specs = jspecs.batch_specs(cfg, shape)
    b_axes = {k: jsharding.BATCH_AXES[cfg.input_mode][k] for k in b_specs}
    out = {"params": _jbytes(rules, p_axes, p_specs, jm),
           "batch": _jbytes(rules, b_axes, b_specs, jm)}
    if shape.kind == "train":
        out["opt"] = sum(_jbytes(rules, p_axes, o_specs[k], jm)
                         for k in ("master", "m", "v")) + np.dtype(o_specs["count"].dtype).itemsize
    if shape.kind == "decode":
        out["cache"] = _jbytes(rules, jmodel.cache_axes(cfg), jspecs.cache_specs(cfg, shape), jm)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_leaves(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jm, tm = _jmesh(shape, axes), mesh_lib.make_mesh(shape, axes, device="meta")
    cfg = configs.get(arch)
    for name, s in INPUT_SHAPES.items():
        if not shape_applicable(cfg, s)[0]:
            continue
        got = dryrun.memory(cfg, s, tm)
        want = reference_argument_bytes(arch, name, jm)
        assert got["arguments"] == want, (name, got["arguments"], want)
        assert got["argument_bytes"] == sum(want.values())
        assert all(isinstance(v, int) for v in got["arguments"].values())
        assert got["temp_bytes"] is None


def test_card_memory_and_fitting_depth():
    """On the one-card mesh the parameters' bytes are the model's, and the
    fitting depth is the largest whole-stage depth whose arguments fit."""
    card = dryrun.make_named_mesh("card")
    for arch, shape_name in (("yi-9b", "train_4k"), ("gemma3-27b", "decode_32k"),
                             ("jamba-1.5-large-398b", "prefill_32k"),
                             ("rwkv6-1.6b", "long_500k")):
        cfg, shape = configs.get(arch), INPUT_SHAPES[shape_name]
        lm = M.BackboneLM(cfg, device="meta")
        mem = dryrun.memory(cfg, shape, card)
        assert mem["arguments"]["params"] == sum(p.numel() * p.element_size()
                                                 for p in lm.parameters())
        n = dryrun.fit_stages(cfg, shape, card, mesh_lib.HBM_BYTES)

        def args(stages):
            return dryrun.memory(dataclasses.replace(cfg, num_stages=stages), shape,
                                 card)["argument_bytes"]
        if n:
            assert args(n) <= mesh_lib.HBM_BYTES
        if n < cfg.num_stages:
            assert args(n + 1) > mesh_lib.HBM_BYTES
    rec = dryrun.run_combo("rwkv6-1.6b", "long_500k", mesh_name="card", memory_only=True)
    assert rec["memory"]["fits"] and rec["memory"]["fit_layers"] == 24
    # gemma3's cut keeps its 2-layer tail: whole 6-layer stages plus 2
    mem = dryrun.run_combo("gemma3-27b", "long_500k", mesh_name="card",
                           memory_only=True)["memory"]
    assert not mem["fits"] and 0 < mem["fit_stages"] < 10
    assert mem["fit_layers"] == 6 * mem["fit_stages"] + 2
    rec = dryrun.run_combo("qwen2-72b", "long_500k", mesh_name="card")
    assert "skipped" in rec and "memory" not in rec


# -- cost mode ----------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (True, 16), (False, None)])
def test_meta_route_takes_the_plain_versions(causal, window):
    """Meta tensors go through the plain versions, which give meta tensors
    of the right shapes and count no launch; another device raises."""
    from repro_torch.kernels import ops
    gram.reset_launch_counts()
    q = torch.empty(2, 40, 8, 64, dtype=torch.bfloat16, device="meta")
    k = v = torch.empty(2, 40, 2, 64, dtype=torch.bfloat16, device="meta")
    o = ops.swa_attention(q, k, v, window=window, causal=causal)
    assert (o.device.type, o.shape, o.dtype) == ("meta", q.shape, q.dtype)
    G, h = ops.gram_moment(torch.empty(9, 5, device="meta"), torch.empty(9, device="meta"))
    assert (G.device.type, G.shape, h.shape) == ("meta", (5, 5), (5,))
    assert all(n == 0 for n in gram.launch_counts().values())
    assert ops.on_card(torch.device("meta"), "x") is False
    with pytest.raises(ValueError, match="device"):
        ops.on_card(torch.device("xpu"), "x")


def _yi(stages=2):
    return dataclasses.replace(configs.get_reduced("yi-9b"), num_stages=stages)


def _matmul_params(cfg) -> int:
    """Parameters that enter a matmul: the layers' projections and the head
    (the embedding is a gather)."""
    per_layer = 2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim \
        + 3 * cfg.d_model * cfg.d_ff
    return per_layer * cfg.num_layers + cfg.d_model * cfg.vocab_size


def test_forward_flops_are_the_analytic_count():
    """2 x matmul parameters x tokens, plus the plain attention's
    4 x hd FLOPs for each of the S x S (query, key) pairs of every head
    (QK^T and PV; every block reads all S keys, masked ones included).
    RoPE, norms, softmax and the CE are elementwise and not counted."""
    cfg, B, S = _yi(), 2, 256
    shape = InputShape("f", S, B, "train")
    lm = M.BackboneLM(cfg, device="meta")
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        M.forward(lm, specs.batch_specs(cfg, shape))
    matmul = 2 * _matmul_params(cfg) * B * S
    attention = cfg.num_layers * 4 * cfg.head_dim * B * cfg.num_heads * S * S
    assert counter.get_total_flops() == matmul + attention


@pytest.mark.parametrize("S", [256, 512])
def test_train_step_flops_term_by_term(S):
    """The step without remat: the forward, then the backward's two
    matmuls a forward one (dX and dW: 2 x), and the attention backward's
    five products a kept block pair (P recomputed, dV, dP, dQ, dK), over
    the keys [0, q1) a causal query block reads, not all S: at S 512 the
    second 256-query block reads 512 keys, the first 256. AdamW is
    elementwise."""
    cfg, B = _yi(), 2
    flops = dryrun.count_flops(cfg, InputShape("t", S, B, "train"))
    matmul = 3 * 2 * _matmul_params(cfg) * B * S
    fwd_attn = cfg.num_layers * 4 * cfg.head_dim * B * cfg.num_heads * S * S
    pairs = sum(min(q0 + 256, S) * min(256, S - q0) for q0 in range(0, S, 256))
    bwd_attn = cfg.num_layers * 5 * 2 * cfg.head_dim * B * cfg.num_heads * pairs
    assert flops == matmul + fwd_attn + bwd_attn


def test_cost_records_per_chip_and_no_kernel_launched():
    """A mesh's FLOPs are the whole count over its devices, its collectives
    DTensor's bytes by the reference's kind names (more at 4 stages than
    at 2); the card's collectives are 0. Meta runs launch no kernel (the
    plain versions take them) and leave no process group."""
    gram.reset_launch_counts()
    card = dryrun.run_combo("yi-9b", "decode_32k", mesh_name="card")
    pod = dryrun.run_combo("yi-9b", "decode_32k", mesh_name="pod1")
    assert all(n == 0 for n in gram.launch_counts().values())
    assert not torch.distributed.is_initialized()
    kinds = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute", "total"}
    for n in dryrun.COST_STAGES:
        c, p = card[f"cost_{n}stage"], pod[f"cost_{n}stage"]
        assert p["flops"] * 256 == c["flops"] > 0
        assert c["collectives"] == {"total": 0} and "replicated_ops" not in c
        coll = p["collectives"]
        assert coll["total"] > 0 and set(coll) <= kinds
        assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
        assert isinstance(p["replicated_ops"], dict)
        assert c["bytes"] is None and p["bytes"] is None
    assert pod["cost_4stage"]["collectives"]["total"] > pod["cost_2stage"]["collectives"]["total"]
    r = roofline.analyze(card)
    assert r.chips == 1 and r.collective_s == 0.0 and r.memory_s is None
    rp = roofline.analyze(pod)
    assert rp.chips == 256 and rp.collective_s is None and rp.coll_bytes > 0
    assert rp.coll_bytes == pytest.approx(sum(rp.coll_by_kind.values()), rel=1e-12)
    assert rp.dominant in ("compute", "memory")
    assert rp.flops * 256 == pytest.approx(r.flops, rel=1e-12)
    assert f"{rp.coll_bytes:.3g}" in roofline.markdown_table([rp])


# -- roofline -------------------------------------------------------------------

class TestRooflineMath:
    """tests/test_launch.py's TestRooflineMath, on the port."""

    def _record(self):
        return {
            "arch": "yi-9b", "shape": "train_4k", "kind": "train",
            "cost_2stage": {"flops": 100.0, "bytes": 10.0,
                            "collectives": {"all-reduce": 8, "total": 8}},
            "cost_4stage": {"flops": 180.0, "bytes": 18.0,
                            "collectives": {"all-reduce": 14, "total": 14}},
        }

    def test_linear_extrapolation(self):
        r = roofline.analyze(self._record())
        n = configs.get("yi-9b").num_stages  # 48
        assert r.flops == pytest.approx(100 + (n - 2) * 40)
        assert r.coll_bytes == pytest.approx(8 + (n - 2) * 3)
        assert r.bytes_ == pytest.approx(10 + (n - 2) * 4)
        assert r.coll_by_kind == {"all-reduce": pytest.approx(8 + (n - 2) * 3)}

    def test_negative_delta_clamped(self):
        rec = self._record()
        rec["cost_4stage"]["flops"] = 50.0  # partitioner noise
        r = roofline.analyze(rec)
        assert r.flops == pytest.approx(100.0)

    def test_skip_records_return_none(self):
        assert roofline.analyze({"skipped": "reason"}) is None
        assert roofline.analyze({"error": "boom"}) is None

    def test_analytic_memory_positive_and_sane(self):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            b = roofline.analytic_hbm_bytes("yi-9b", shape)
            assert 0 < b < 1e13
        assert roofline.analytic_hbm_bytes("yi-9b", "decode_32k") < \
            roofline.analytic_hbm_bytes("yi-9b", "train_4k")

    def test_model_flops_match_param_count(self):
        r = roofline._model_flops("yi-9b", "train_4k", 256)
        cfg = configs.get("yi-9b")
        assert r == pytest.approx(6 * cfg.active_param_count() * 256 * 4096 / 256)

    def test_dominant_over_the_terms_that_exist(self):
        rec = {**self._record(), "devices": 256, "mesh_shape": {"data": 16, "model": 16}}
        r = roofline.analyze(rec)
        n = configs.get("yi-9b").num_stages
        # a pod record's collective bytes, but no interconnect figure for them
        assert r.chips == 256 and r.coll_bytes == pytest.approx(8 + (n - 2) * 3)
        assert r.coll_by_kind == {"all-reduce": pytest.approx(8 + (n - 2) * 3)}
        assert r.collective_s is None
        assert r.dominant in ("compute", "memory")
        assert r.step_time_bound_s() == max(r.compute_s, r.est_memory_s)


def test_roofline_refuses_records_of_two_torch_versions(tmp_path):
    """Each record names the torch that made it; a table of records from
    two versions is refused, one version's is read."""
    rec = dryrun.run_combo("yi-9b", "decode_32k", mesh_name="card")
    assert rec["torch"] == torch.__version__
    for arch, version in (("yi-9b", "2.11.0"), ("qwen2-72b", "2.11.0")):
        (tmp_path / f"{arch}_decode_32k_card.json").write_text(
            json.dumps({**rec, "arch": arch, "torch": version}))
    assert len(roofline.load_all("card", tmp_path)) == 2
    (tmp_path / "qwen2-72b_decode_32k_card.json").write_text(
        json.dumps({**rec, "arch": "qwen2-72b", "torch": "2.13.0"}))
    with pytest.raises(ValueError, match="torch"):
        roofline.load_all("card", tmp_path)


@pytest.fixture
def port_counts(monkeypatch):
    """The reference's ``ArchConfig`` counting parameters as the port does
    (hubert-xlarge's reference count is 315,216,640 high, ROADMAP)."""
    def by_port(method):
        def count(cfg):
            return getattr(configs.get(cfg.name), method)()
        return count
    monkeypatch.setattr(jconfig.ArchConfig, "param_count", by_port("param_count"))
    monkeypatch.setattr(jconfig.ArchConfig, "active_param_count",
                        by_port("active_param_count"))


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_arithmetic_matches_reference(arch, request):
    if arch == "hubert-xlarge":
        request.getfixturevalue("port_counts")
        assert jconfigs.get(arch).param_count() == configs.get(arch).param_count()
    cfg = configs.get(arch)
    for name, s in INPUT_SHAPES.items():
        if not shape_applicable(cfg, s)[0]:
            continue
        for model_shards, data_shards in ((16, 16), (16, 32), (2, 4), (1, 1)):
            got = roofline.analytic_hbm_bytes(arch, name, model_shards=model_shards,
                                              data_shards=data_shards)
            want = jroofline.analytic_hbm_bytes(arch, name, model_shards=model_shards,
                                                data_shards=data_shards)
            assert got == pytest.approx(want, rel=1e-12), (name, model_shards)
        assert roofline._model_flops(arch, name, 256) == \
            pytest.approx(jroofline._model_flops(arch, name), rel=1e-12)
        assert roofline._cache_bytes(cfg, s) == \
            pytest.approx(jroofline._cache_bytes(jconfigs.get(arch), s), rel=1e-12)


def test_cli_memory_sweep_and_roofline(tmp_path):
    """``--all --card --memory-only``: 33 OK, 7 SKIP, exit 0; one costed
    record gives the roofline one row."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                          "--card", "--memory-only", "--out", str(tmp_path)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert run.returncode == 0, run.stderr[-2000:]
    status = [line.split("]")[0].strip("[ ") for line in run.stdout.splitlines()]
    assert status.count("OK") == 33 and status.count("SKIP") == 7 and len(status) == 40
    rec = json.loads((tmp_path / "yi-9b_train_4k_card.json").read_text())
    assert rec["memory"]["fits"] is False and 0 < rec["memory"]["fit_layers"] < 48
    run = subprocess.run([sys.executable, "-c",
                          "from repro_torch.launch import dryrun, roofline; "
                          f"dryrun.main(['--arch', 'yi-9b', '--shape', 'decode_32k', "
                          f"'--card', '--out', {str(tmp_path)!r}]); "
                          f"roofline.main(['--dir', {str(tmp_path)!r}])"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "| yi-9b | decode_32k | 1 |" in run.stdout and "(1 rows)" in run.stdout
    assert (tmp_path / "roofline_card.csv").exists()
