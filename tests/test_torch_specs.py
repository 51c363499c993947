"""Port parity for ``launch/specs.py``: the meta-tensor trees against the
reference's ``jax.eval_shape`` trees, leaf for leaf, in shape and dtype,
for every config and every runnable input shape.

The port's batches carry the port's dtypes, which are the reference's:
int32 tokens and labels (``data.pipeline`` makes int32), a bool mask,
embeddings and patches in the activation dtype; no leaf differs. A cache's
``pos`` is the reference's int32 scalar in the spec tree (the port's own
cache keeps a Python int). Also here: tests/test_launch.py's
``TestInputSpecs`` on the port, and a prefill's cache (what the dry-run
counts as a prefill's output) against the spec tree and the reference's
prefill on the reduced configs.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro.models.config import INPUT_SHAPES as JINPUT_SHAPES
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import model as M
from repro_torch.models.config import INPUT_SHAPES, InputShape, shape_applicable

ARCHS = list(configs.ARCH_IDS)


def flat(tree, path=()):
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return {path: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flat(v, path + (k,)))
    return out


def _dtype(leaf) -> str:
    return str(leaf.dtype).removeprefix("torch.") if isinstance(leaf, torch.Tensor) \
        else np.dtype(leaf.dtype).name


def assert_same_specs(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.device.type == "meta", path
        assert (tuple(g.shape), _dtype(g)) == (tuple(w.shape), _dtype(w)), path


def _runnable(arch):
    cfg = configs.get(arch)
    return [s for s in INPUT_SHAPES.values() if shape_applicable(cfg, s)[0]]


@functools.lru_cache(maxsize=None)
def _jopt(arch):
    return jspecs.opt_specs(jconfigs.get(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_opt_specs_match_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert_same_specs(specs.params_specs(cfg), jspecs.params_specs(jcfg))
    assert_same_specs(specs.opt_specs(cfg), _jopt(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for shape in _runnable(arch):
        jshape = JINPUT_SHAPES[shape.name]
        assert_same_specs(specs.batch_specs(cfg, shape), jspecs.batch_specs(jcfg, jshape))
        if not cfg.encoder_only:
            assert_same_specs(specs.cache_specs(cfg, shape),
                              jspecs.cache_specs(jcfg, jshape))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_is_the_cache_spec(arch):
    """On the reduced config, a prefill on meta leaves a cache of the
    spec tree's shapes and dtypes (laid out by layer), and the reference's
    prefill one of its cache spec's; an encoder's prefill (its encode)
    gives all logits and no cache."""
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    shape = InputShape("p", cfg.num_prefix + 32, 2, "prefill")
    if cfg.encoder_only:
        logits = M.encode_step(M.BackboneLM(cfg, device="meta"),
                               specs.batch_specs(cfg, shape))
        assert (logits.device.type, logits.shape) == ("meta", (2, 32, cfg.vocab_size))
        return
    lm = M.BackboneLM(cfg, device="meta")
    _, cache = M.prefill_step(lm, specs.batch_specs(cfg, shape))
    spec = specs.cache_specs(cfg, shape)
    per_stage, n = len(cfg.stage_pattern), len(cfg.stage_pattern) * cfg.num_stages
    for j, layer_cache in enumerate(cache["layers"]):
        want = spec["stages"][j % per_stage] if j < n else spec["tail"][j - n]
        for key, t in layer_cache.items():
            w = want[key]
            w_shape = tuple(w.shape[1:]) if j < n else tuple(w.shape)
            assert (tuple(t.shape), t.dtype) == (w_shape, w.dtype), (j, key)
    assert cache["pos"] == shape.seq_len
    jbatch = jspecs.batch_specs(jcfg, shape)
    jparams = jspecs.params_specs(jcfg)
    jcache = jax.eval_shape(lambda p, b: jmodel.prefill_step(p, b, jcfg, chunk_size=64),
                            jparams, jbatch)[1]
    assert_same_specs(spec, jcache)


class TestInputSpecs:
    """tests/test_launch.py's TestInputSpecs, on the port."""

    @pytest.mark.parametrize("arch", ARCHS)
    def test_batch_specs_cover_every_runnable_shape(self, arch):
        cfg = configs.get(arch)
        for shape in _runnable(arch):
            b = specs.batch_specs(cfg, shape)
            if shape.kind == "decode":
                assert b["tokens"].shape == (shape.global_batch, 1)
            elif cfg.input_mode == "prefix_embeddings":
                assert b["tokens"].shape[1] + cfg.num_prefix == shape.seq_len

    def test_skip_matrix_is_exactly_seven(self):
        skips = sum(0 if shape_applicable(configs.get(a), s)[0] else 1
                    for a in configs.ARCH_IDS for s in INPUT_SHAPES.values())
        assert skips == 7

    def test_param_specs_match_analytic_count(self):
        """Exactly: the port's count is its own model's size (the
        reference's is within 2% of its tree; hubert's is not)."""
        for arch in ARCHS:
            cfg = configs.get(arch)
            total = sum(math.prod(t.shape) for t in flat(specs.params_specs(cfg)).values())
            assert total == cfg.param_count(), arch

    def test_cache_specs_shapes(self):
        cfg = configs.get("gemma3-27b")
        c = specs.cache_specs(cfg, INPUT_SHAPES["long_500k"])
        swa_cache = c["stages"][0]["k"]
        assert swa_cache.shape == (cfg.num_stages, 1, cfg.window, cfg.num_kv_heads,
                                   cfg.head_dim)
        full_cache = c["stages"][5]["k"]
        assert full_cache.shape[2] == INPUT_SHAPES["long_500k"].seq_len

    def test_decode_batch_of_an_encoder_raises(self):
        with pytest.raises(ValueError, match="encoder-only"):
            specs.batch_specs(configs.get("hubert-xlarge"), INPUT_SHAPES["decode_32k"])
