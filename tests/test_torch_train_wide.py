"""Training a wider model: the port follows the reference's trainer step for
step where its default learning rate makes the loss spike.

yi-9b's reduced pattern at d_model 2048 (16 heads over 1 KV head of hd 128,
d_ff 5504, vocab 16000, 2 layers), float32, B 2 x S 256, the reference's
``init_params`` weights carried over, three steps of each package's train
step under the trainer's schedule (warmup 5). At the trainer's 3e-4 the
loss rises above its first value by the third step in both packages (Adam's
first steps move a d-wide product by ~lr * d); at 3e-4 scaled by 256 /
d_model it falls. (At B 1 or S 128, or at vocab 4000, the third step no
longer rises: the size is what the spike needs.)

At the width the card trains (yi-9b's own d_model 4096, 32 heads over 4,
d_ff 11008, bf16 weights and grads), one layer, vocab 2000 and B 1 x S 64,
the trainer's 3e-4 also lifts the loss above its first value by the third
step in both packages, which agree within 2e-3 relative. The card smoke
trains yi-9b at d_model 4096 with the scaled rate for this reason.

Each package trains in turn, the port's model freed before the reference
starts, so only one holds its optimizer state at a time.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.launch import train
from repro_torch.models import config, model
from repro_torch.optim import adamw

D_MODEL, STEPS = 2048, 3
CARD_WIDTH = dict(d_model=4096, num_heads=32, num_kv_heads=4, head_dim=128, d_ff=11008,
                  vocab_size=2000, num_stages=1, dtype="bfloat16")
CARD_WIDTH_RTOL = 2e-3        # bf16 weights: the two packages round their GEMMs apart


def _cfgs(**widths):
    jcfg = dataclasses.replace(jconfigs.get_reduced("yi-9b"), **widths)
    fields = dataclasses.asdict(jcfg)
    for key in ("stage_pattern", "tail_pattern"):
        fields[key] = tuple(config.LayerSpec(**s) for s in fields[key])
    return jcfg, config.ArchConfig(**fields)


def _histories(lr, batch, seq, **widths):
    """(port, reference) losses of STEPS train steps from the reference's
    seed-0 weights on the port's batches, at peak rate ``lr``."""
    jcfg, tcfg = _cfgs(**widths)
    opt = dict(lr=lr, warmup_steps=5, total_steps=8)
    params = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    pipe = train.make_pipeline(tcfg, batch, seq, 0, device="cpu")
    batches = [pipe.batch(i) for i in range(STEPS)]
    lm = convert.model_params_from(params, tcfg, device="cpu")
    step, state = model.make_train_step(tcfg, adamw.AdamWConfig(**opt)), adamw.init(lm)
    got = [float(step(lm, state, b)) for b in batches]
    del lm, state
    gc.collect()
    jstep = jax.jit(jmodel.make_train_step(jcfg, jadamw.AdamWConfig(**opt), chunk_size=64))
    jstate, want = jadamw.init(params), []
    for b in batches:
        loss, params, jstate = jstep(params, jstate, {k: jnp.asarray(v.numpy())
                                                       for k, v in b.items()})
        want.append(float(loss))
    return got, want


@pytest.mark.parametrize("lr", [3e-4, 3e-4 * 256 / D_MODEL])
def test_wide_model_follows_reference(lr):
    got, want = _histories(lr, 2, 256, d_model=D_MODEL, num_heads=16, num_kv_heads=1,
                           head_dim=128, d_ff=5504, vocab_size=16000)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if lr == 3e-4:
        assert got[-1] > got[0], got
    else:
        assert got[-1] < got[0] and all(np.diff(got) < 0), got


def test_card_width_rises_in_both_packages():
    """The rise at 3e-4 belongs to the reference's trainer at the card's
    width and dtype too, not to the port."""
    got, want = _histories(3e-4, 1, 64, **CARD_WIDTH)
    np.testing.assert_allclose(got, want, rtol=CARD_WIDTH_RTOL)
    assert got[-1] > got[0], got
    assert want[-1] > want[0], want
