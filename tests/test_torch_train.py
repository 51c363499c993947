"""The port's training pieces against the reference's: the data pipeline,
AdamW, the loss, microbatching, the train loop, and serving left as it was.

Batches must be bitwise the reference's (numpy draws in the same order).
AdamW is held on the same gradients and state (carried over with
``convert.opt_state_from``): master, m and v within 1e-6 of each leaf's
largest magnitude, the bf16 parameters within one bf16 ulp. The trainer
(``launch.train.train`` on the CPU) trains from the reference's
``init_params`` weights, carried over, and its loss history must follow
the reference trainer's at 1e-4. The loss and gradients of all ten reduced
configs are in ``tests/test_torch_train_grads.py``, the attention's
gradient in ``tests/test_torch_swa_grad.py``.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jcheckpoint
from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro_torch import checkpoint, configs, convert
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import config, layers, model
from repro_torch.optim import adamw


def _port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    for key in ("stage_pattern", "tail_pattern"):
        fields[key] = tuple(config.LayerSpec(**s) for s in fields[key])
    return config.ArchConfig(**fields)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- the data pipeline ---------------------------------------------------------

@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (3, 17, 1)])
def test_token_pipeline_bitwise(seed, step, shard):
    spec = dict(global_batch=4, seq_len=33, vocab_size=1000)
    want = jpipeline.TokenPipeline(jpipeline.BatchSpec(**spec), seed=seed,
                                   shard_index=shard, num_shards=2).batch(step)
    got = pipeline.TokenPipeline(pipeline.BatchSpec(**spec), seed=seed, shard_index=shard,
                                 num_shards=2, device="cpu").batch(step)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32 and got[key].device.type == "cpu"
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (5, 9, 1)])
def test_embedding_pipeline_bitwise(seed, step, shard):
    kw = dict(global_batch=4, seq_len=7, d_model=12, seed=seed, shard_index=shard,
              num_shards=2)
    want = jpipeline.EmbeddingPipeline(**kw).batch(step)
    got = pipeline.EmbeddingPipeline(**kw, device="cpu").batch(step)
    for key in ("embeddings", "targets"):
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))


def test_pipeline_iterates_by_step_and_checks_shards():
    spec = pipeline.BatchSpec(2, 5, 50)
    it = iter(pipeline.TokenPipeline(spec, device="cpu"))
    first, second = next(it), next(it)
    assert torch.equal(second["tokens"],
                       pipeline.TokenPipeline(spec, device="cpu").batch(1)["tokens"])
    assert not torch.equal(first["tokens"], second["tokens"])
    with pytest.raises(ValueError):
        pipeline.TokenPipeline(pipeline.BatchSpec(3, 5, 50), num_shards=2, device="cpu")
    with pytest.raises(ValueError):
        pipeline.EmbeddingPipeline(global_batch=3, seq_len=5, d_model=4, num_shards=2,
                                   device="cpu")


@pytest.mark.parametrize("arch", ["yi-9b", "hubert-xlarge", "pixtral-12b"])
def test_prepare_batch_bitwise(arch):
    """The three input modes: tokens as they are, an encoder's labels and
    mask, a VLM's patches, each drawn as the reference's trainer draws them."""
    tcfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    raw = train.make_pipeline(tcfg, 2, 24, 4, device="cpu").batch(3)
    jraw = jtrain.make_pipeline(jcfg, 2, 24, 4).batch(3)
    got, want = train.prepare_batch(tcfg, raw), jtrain.prepare_batch(jcfg, jraw)
    assert sorted(got) == sorted(want)
    for key in got:
        assert _np(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(_np(got[key]), np.asarray(want[key]))


# --- AdamW ---------------------------------------------------------------------

def test_schedule_matches_reference():
    """Warmup, the cosine and past its end; float32 either way. The warmup
    and the plateau are bitwise; the cosine's float32 ``cos`` is XLA's own
    on the reference's side, so within one float32 ulp there."""
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 140):
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        want = np.asarray(jadamw.schedule(jcfg, jnp.int32(step)))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        if step < 10 or step >= 100:
            assert got.item() == want.item(), step
        else:
            assert abs(got.item() - want.item()) <= float(np.spacing(want)), step
    assert adamw.schedule(cfg, 100).item() == pytest.approx(3e-5, rel=1e-6)


def _bf16_model():
    jcfg = dataclasses.replace(jconfigs.get_reduced("yi-9b"), dtype="bfloat16")
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    return params, convert.model_params_from(jax.tree.map(np.asarray, params),
                                             _port_cfg(jcfg), device="cpu")


def _like(tree, rng, scale, positive=False, dtype=np.float32):
    def draw(leaf):
        x = rng.standard_normal(np.shape(leaf)).astype(np.float32) * scale
        return (np.abs(x) if positive else x).astype(dtype)
    return jax.tree.map(draw, tree)


@pytest.mark.parametrize("count", [0, 6])
def test_adamw_apply_matches_reference(count):
    """One step on bf16 gradients from a state carried over with
    ``opt_state_from``, against the reference's ``apply`` jitted (as its
    trainer runs it) and op by op. Against the op-by-op one, m and v are
    bitwise, and so is the master from a fresh state (count 0); from count
    6 the bias corrections' float32 ``pow`` is XLA's own. The jitted one
    fuses the moments' products and sums (other roundings), so there m, v
    and the master are held within 1e-6 of each leaf's largest magnitude.
    The bf16 parameters are within one bf16 ulp of either."""
    params, lm = _bf16_model()
    rng = np.random.default_rng(count)
    master = jax.tree.map(lambda p, n: np.asarray(p, np.float32) + n, params,
                          _like(params, rng, 1e-3))
    jstate = {"master": master, "m": _like(params, rng, 1e-3),
              "v": _like(params, rng, 1e-5, positive=True),
              "count": jnp.int32(count)}
    if count == 0:
        jstate = jadamw.init(params)
    jgrads = _like(params, rng, 1e-2, dtype=ml_dtypes.bfloat16)
    cfg = adamw.AdamWConfig(warmup_steps=3, total_steps=20)
    jcfg = jadamw.AdamWConfig(warmup_steps=3, total_steps=20)
    jargs = (jax.tree.map(jnp.asarray, jgrads), jax.tree.map(jnp.asarray, jstate), jcfg)
    jitted = jax.jit(jadamw.apply, static_argnums=2)(*jargs)
    eager = jadamw.apply(*jargs)

    state = convert.opt_state_from(jstate, lm)
    grads = convert.named_tensors_from(jgrads, lm)
    assert all(g.dtype == torch.bfloat16 for g in grads.values())
    out = adamw.apply(lm, grads, state, cfg)
    assert out is state and int(state["count"]) == count + 1
    assert state["count"].dtype == torch.int32
    for key in ("m", "v", "master"):
        got = jax.tree.leaves(convert.model_tree_of(lm, state[key]))
        for g, w, e in zip(got, jax.tree.leaves(jitted[1][key]),
                           jax.tree.leaves(eager[1][key])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())
            if key != "master" or count == 0:
                np.testing.assert_array_equal(g, np.asarray(e))
    for name, p in lm.named_parameters():
        assert p.dtype == torch.bfloat16
        # the parameters are the new master, rounded to nearest even
        assert torch.equal(p, state["master"][name].bfloat16())
    mine = jax.tree.leaves(convert.model_tree_of(lm))
    for ref_params in (jitted[0], eager[0]):
        for g, w in zip(mine, jax.tree.leaves(ref_params)):
            w = np.asarray(w, np.float32)
            assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w)), "more than one bf16 ulp"


def test_init_copies_the_parameters():
    _, lm = _bf16_model()
    state = adamw.init(lm)
    for name, p in lm.named_parameters():
        assert state["master"][name].dtype == torch.float32
        assert torch.equal(state["master"][name], p.float())
        assert not state["m"][name].any() and not state["v"][name].any()
    assert int(state["count"]) == 0
    f32 = model.init_params(configs.get_reduced("yi-9b"),
                            generator=torch.Generator().manual_seed(0), device="cpu")
    st = adamw.init(f32)
    p = next(f32.parameters())
    assert st["master"]["embed.table"].data_ptr() != p.data_ptr()     # a copy


# --- the loss ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32) * 4
    if dtype == "bfloat16":
        logits = logits.astype(ml_dtypes.bfloat16)
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    want = float(jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = layers.cross_entropy(convert.tensor_from_numpy(logits, device="cpu"),
                               torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("kept", [0, 5, 18])
def test_masked_cross_entropy_matches_reference(kept):
    """The masked-unit CE (hubert's loss): the reference's masked mean of
    ``logz - gold`` in float32, with no position kept giving 0."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32) * 4
    labels = rng.integers(0, 40, (2, 9)).astype(np.int32)
    mask = np.zeros(18, bool)
    mask[rng.permutation(18)[:kept]] = True
    mask = mask.reshape(2, 9)
    lg = jnp.asarray(logits)
    ce = (jax.nn.logsumexp(lg, axis=-1)
          - jnp.take_along_axis(lg, jnp.asarray(labels)[..., None], axis=-1)[..., 0])
    m = jnp.asarray(mask, jnp.float32)
    want = float((ce * m).sum() / jnp.maximum(m.sum(), 1.0))
    got = layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               torch.from_numpy(mask))
    assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1.0)
    assert (float(got) == 0.0) == (kept == 0)


def test_model_tree_round_trip():
    """``model_tree_of`` gives the reference's tree structure and shapes;
    ``named_tensors_from`` of it gives the parameters back bitwise."""
    for arch in ("jamba-1.5-large-398b", "gemma3-27b", "hubert-xlarge"):
        cfg = configs.get_reduced(arch)
        lm = model.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
        tree = convert.model_tree_of(lm)
        ref_tree = jax.eval_shape(lambda: jmodel.init_params(
            jax.random.PRNGKey(0), jconfigs.get_reduced(arch)))
        assert jax.tree.structure(tree) == jax.tree.structure(ref_tree)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref_tree)):
            assert a.shape == b.shape
        back = convert.named_tensors_from(tree, lm)
        for name, p in lm.named_parameters():
            assert back[name].dtype == p.dtype and torch.equal(back[name], p)


# --- the step ------------------------------------------------------------------

def _yi(seed=0):
    cfg = configs.get_reduced("yi-9b")
    return cfg, model.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                                  device="cpu")


def test_microbatches_match_one_batch():
    """Two microbatches against one: the loss and the gradients (AdamW's
    first moment after one step is (1 - b1) g) within 1e-5."""
    cfg, lm1 = _yi()
    _, lm2 = _yi()
    batch = train.make_pipeline(cfg, 4, 32, 0, device="cpu").batch(0)
    opt = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    s1, s2 = adamw.init(lm1), adamw.init(lm2)
    l1 = model.make_train_step(cfg, opt, microbatches=1)(lm1, s1, batch)
    l2 = model.make_train_step(cfg, opt, microbatches=2)(lm2, s2, batch)
    assert abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l1))
    for name, m in s1["m"].items():
        torch.testing.assert_close(s2["m"][name], m, rtol=0,
                                   atol=1e-5 * float(m.abs().max()))
    with pytest.raises(ValueError):
        model.make_train_step(cfg, opt, microbatches=0)


def test_train_step_leaves_no_graph():
    """The step turns requires_grad on for its own use only: afterwards no
    parameter requires a gradient or holds one, and a forward builds no
    graph."""
    cfg, lm = _yi()
    batch = train.make_pipeline(cfg, 2, 16, 0, device="cpu").batch(0)
    before = {n: p.clone() for n, p in lm.named_parameters()}
    state = adamw.init(lm)
    loss = model.make_train_step(cfg, adamw.AdamWConfig())(lm, state, batch)
    assert loss.grad_fn is None and loss.dtype == torch.float32
    for name, p in lm.named_parameters():
        assert not p.requires_grad and p.grad is None
        assert not torch.equal(p, before[name]), f"{name} did not move"
    assert model.forward(lm, batch).grad_fn is None


def test_masked_embed_without_mask_gets_zero_gradient():
    """An encoder batch without a mask never reaches ``mask_embed``: its
    gradient is zero, as JAX's, and AdamW still decays it."""
    cfg = configs.get_reduced("hubert-xlarge")
    lm = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    raw = train.make_pipeline(cfg, 2, 16, 0, device="cpu").batch(0)
    batch = train.prepare_batch(cfg, raw)
    batch = {"embeddings": batch["embeddings"], "labels": batch["labels"],
             "mask": torch.zeros_like(batch["mask"])}
    # no masked frame: the loss is 0 over max(0, 1) frames
    state = adamw.init(lm)
    before = state["master"]["mask_embed"].clone()
    opt = adamw.AdamWConfig(warmup_steps=1)
    loss = model.make_train_step(cfg, opt)(lm, state, batch)
    assert float(loss) == 0.0
    assert not state["m"]["mask_embed"].any() and not state["v"]["mask_embed"].any()
    # a zero step: only the weight decay moves it
    lr = adamw.schedule(opt, 1)
    assert torch.equal(state["master"]["mask_embed"],
                       before - lr * (0.0 + opt.weight_decay * before))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b", "mixtral-8x22b"])
def test_forward_under_autograd_equals_serving_forward(arch):
    """The out-of-place forms that autograd needs (the WKV carry, the Mamba
    scan step, the MoE SiLU) compute the serving forms' bits."""
    cfg = configs.get_reduced(arch)
    lm = model.init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    tokens = train.make_pipeline(cfg, 2, 160, 0, device="cpu").batch(0)["tokens"]
    with torch.no_grad():
        served = model.forward(lm, {"tokens": tokens})
    for p in lm.parameters():
        p.requires_grad_(True)
    recorded = model.forward(lm, {"tokens": tokens})
    assert recorded.grad_fn is not None
    assert torch.equal(recorded.detach(), served)
    logits, aux = model.forward(lm, {"tokens": tokens}, remat=True, with_aux=True)
    assert torch.equal(logits.detach(), served)
    assert aux.dtype == torch.float32
    assert (float(aux.detach()) > 0) == any(s.mlp == "moe" for s in cfg.stage_pattern)


# --- the trainer ---------------------------------------------------------------

@functools.cache
def _reference_run(arch, steps, batch, seq):
    res = jtrain.train(arch, reduced=True, steps=steps, batch=batch, seq=seq, log_every=1)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                         jconfigs.get_reduced(arch)))
    return res["history"], params


@pytest.mark.parametrize("arch", ["yi-9b", "phi3.5-moe-42b-a6.6b"])
def test_train_matches_reference_trainer(arch, monkeypatch, tmp_path):
    """Three steps of the trainer on the CPU from the reference's initial
    weights: the loss history agrees at 1e-4, and the checkpoint it writes
    restores into the reference's tree."""
    history, params = _reference_run(arch, 3, 4, 64)
    monkeypatch.setattr(model, "init_params", lambda cfg, generator, device:
                        convert.model_params_from(params, cfg, device=device))
    res = train.train(arch, reduced=True, steps=3, batch=4, seq=64, log_every=1,
                      ckpt_dir=str(tmp_path), device="cpu")
    assert [h["step"] for h in res["history"]] == [h["step"] for h in history]
    for got, want in zip(res["history"], history):
        assert abs(got["loss"] - want["loss"]) <= 1e-4, (got, want)
    assert res["first_loss"] == res["history"][0]["loss"]
    assert res["final_loss"] < res["first_loss"]
    assert res["params_m"] == pytest.approx(
        sum(p.numel() for p in res["params"].parameters()) / 1e6)
    assert checkpoint.latest_step(tmp_path) == 3
    restored = jcheckpoint.load_pytree(jax.tree.map(jnp.asarray, params), str(tmp_path),
                                       step=3)
    for a, b in zip(jax.tree.leaves(restored),
                    jax.tree.leaves(convert.model_tree_of(res["params"]))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_cli_on_cpu(tmp_path, capsys, monkeypatch):
    out = tmp_path / "report.json"
    monkeypatch.setattr("sys.argv", ["train", "--arch", "yi-9b", "--reduced", "--steps", "3",
                                     "--batch", "2", "--seq", "32", "--device", "cpu",
                                     "--out", str(out)])
    train.main()
    text = capsys.readouterr().out
    assert "[train] yi-9b-reduced:" in text and "[train] done: loss" in text
    report = json.loads(out.read_text())
    assert set(report) == {"arch", "params_m", "final_loss", "first_loss", "wall_s",
                           "history"}
    assert [h["step"] for h in report["history"]] == [0, 2]
