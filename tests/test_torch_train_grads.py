"""The port's training loss and its gradients against the reference's, for
each of the ten reduced configs.

The reference's ``init_params`` tree is carried over with
``convert.model_params_from``; the batch is the port's pipeline output
(bitwise the reference's, ``tests/test_torch_train.py``) through
``launch.train.prepare_batch``. The reference runs
``jax.value_and_grad(loss_fn)`` once per config (jitted, stages under
``jax.checkpoint``, Mamba and RWKV in chunks of 64); the port runs
``loss_fn`` with ``remat=True`` and ``backward``, and its gradients are
brought into the reference's layout by ``convert.model_tree_of``. Float32
at 1e-4: the loss absolutely, each gradient leaf against its largest
magnitude. This covers the MoE aux loss, hubert's masked-unit loss,
pixtral's prefix, Mamba and RWKV across two chunks (S 128), and the
attention's gradient through ``ops.swa_attention``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs, convert
from repro_torch.launch import train
from repro_torch.models import config, model

TOL = 1e-4
REMAT_TOL = 1e-6
B, S = 2, 128


def _port_cfg(jcfg):
    fields = dataclasses.asdict(jcfg)
    for key in ("stage_pattern", "tail_pattern"):
        fields[key] = tuple(config.LayerSpec(**s) for s in fields[key])
    return config.ArchConfig(**fields)


@functools.cache
def _setup(arch):
    """(reference params, port config, batch, reference loss, reference
    grads), the reference compiled and run once per config."""
    jcfg = jconfigs.get_reduced(arch)
    tcfg = _port_cfg(jcfg)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    batch = train.prepare_batch(tcfg, train.make_pipeline(tcfg, B, S, 0, device="cpu")
                                .batch(0))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jmodel.loss_fn, cfg=jcfg, chunk_size=64, remat=True)))(params, jbatch)
    return (jax.tree.map(np.asarray, params), tcfg, batch, float(loss),
            jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(arch, remat=True):
    params, tcfg, batch, _, _ = _setup(arch)
    lm = convert.model_params_from(params, tcfg, device="cpu")
    for p in lm.parameters():
        p.requires_grad_(True)
    loss = model.loss_fn(lm, batch, remat=remat)
    loss.backward()
    return lm, loss.detach(), {n: p.grad for n, p in lm.named_parameters()}


@pytest.mark.parametrize("arch", configs.PORTED)
def test_loss_and_grads_match_reference(arch):
    _, _, _, jloss, jgrads = _setup(arch)
    lm, loss, grads = _port_loss_and_grads(arch)
    assert loss.dtype == torch.float32
    assert abs(float(loss) - jloss) <= TOL
    tree = convert.model_tree_of(lm, grads)
    flat_t, def_t = jax.tree.flatten(tree)
    flat_j, def_j = jax.tree.flatten(jgrads)
    assert def_t == def_j
    for t, j in zip(flat_t, flat_j):
        assert t.shape == j.shape and np.isfinite(t).all()
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL * max(float(np.abs(j).max()), 1e-30))


@pytest.mark.parametrize("arch", ["yi-9b", "jamba-1.5-large-398b", "rwkv6-1.6b",
                                  "mixtral-8x22b", "hubert-xlarge"])
def test_remat_gives_the_same_loss_and_grads(arch):
    """Bitwise, but for the token embedding's gradient: its scatter-add of
    repeated tokens sums in another order under remat (1e-6 of its largest
    magnitude)."""
    _, loss, grads = _port_loss_and_grads(arch, remat=True)
    _, loss0, grads0 = _port_loss_and_grads(arch, remat=False)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        if name == "embed.table":
            torch.testing.assert_close(g, grads0[name], rtol=0,
                                       atol=REMAT_TOL * float(g.abs().max()))
        else:
            assert torch.equal(g, grads0[name]), name
