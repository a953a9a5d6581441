"""The port's fused n-step call (``device_data.make_fused_train_step``) fed
the JAX synthesizer's draws, against JAX's ``make_fused_train_step`` from
the same trained weights and key, float32, at B = 2 with n_inner = 2.
Dropout is the identity on both sides (see tests/torch_train_ref.py)."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.models import SpecUNet2D as FlaxUNet
from softspoken_tpu.train import device_data as jdd
from softspoken_tpu.train import loop as jloop
from softspoken_tpu.train import synth as jsynth
from softspoken_tpu_torch.ckpt import from_flax_variables
from softspoken_tpu_torch.train import device_data as tdd
from softspoken_tpu_torch.train import loop as tloop

from torch_train_ref import NoDropout, jax_draws, port_model, rel_err

torch.set_num_threads(2)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "root", "models", "spec_unet_2d", "model_checkpoint")
AUGS = ("add_reverb", "reduce_volume")


def test_fused_two_steps_match_jax():
    """Adam's first update is ≈ lr·sign(g) for every element, so an element
    whose gradient lies within float32 noise of 0 moves ±lr either way, and
    the second update divides by a root mean square of two gradients that
    may nearly cancel.  (Both packages' float32 gradients are ~1.5e-3 off
    the float64 gradient, relative L2: tests/test_torch_train_step.py.)  So
    no element is held to a plain atol: each must move within 4·lr of JAX's
    movement over the two steps (the most two Adam steps can differ), and
    of all 1.71 M parameters at most 0.5% may differ by more than 0.5·lr
    (measured 0.1%) and at most 5% by more than 0.1·lr (measured 1%).  The
    BN running statistics to 1e-3 of each tensor's max (measured 1.8e-4:
    the second step's forward runs on weights that the first step's
    sign-ambiguous elements moved); the averaged loss to 1e-4 relative.
    Key 3's two batches have equal masks on both sides."""
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    trained = jax.device_get(jckpt.load(CKPT)[0])
    sp, nz = jsynth.make_pools(np.random.default_rng(0), 3, 3)
    lr, key = 1e-3, jax.random.PRNGKey(3)
    tx = optax.adamw(lr, weight_decay=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", NoDropout)
        step = jdd.make_fused_train_step(FlaxUNet(), tx, jdd.make_synth_batch_fn(2, AUGS),
                                         n_inner=2)
        state = jloop.TrainState(trained["params"], trained["batch_stats"],
                                 tx.init(trained["params"]), jnp.asarray(0, jnp.int32))
        state, m_j = step(state, jnp.asarray(sp), jnp.asarray(nz), key)
        after = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    want = from_flax_variables(after)

    # the fused JAX step splits its key per inner step, then k_batch, k_drop
    draws = [jax_draws(jax.random.split(k)[0], 2, 3, 3, AUGS) for k in jax.random.split(key, 2)]
    it = iter(draws)
    model = port_model(trained)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tstate = tloop.TrainState(model, tloop.make_optimizer(model, lr))
    fused = tdd.make_fused_train_step(tdd.make_synth_batch_fn(2, AUGS), n_inner=2,
                                      draw_fn=lambda g, n_speech, n_noise: next(it))
    m_t = fused(tstate, torch.from_numpy(sp), torch.from_numpy(nz), torch.Generator())
    assert tstate.step == 2 and int(state.step) == 2
    assert set(m_t) == {"loss", "mask_loss", "spec_loss"}
    assert abs(float(m_t["loss"]) - float(m_j["loss"])) <= 1e-4 * abs(float(m_j["loss"]))

    got = model.state_dict()
    n = off_half = off_tenth = 0
    for k, w in want.items():
        g = got[k].numpy()
        if "running" in k:
            assert rel_err(g, w) <= 1e-3, k
            continue
        b = before[k].numpy()
        d = np.abs((g - b) - (w - b))
        assert d.max() <= 4 * lr, k
        n += d.size
        off_half += int((d > 0.5 * lr).sum())
        off_tenth += int((d > 0.1 * lr).sum())
    assert n == 1_713_555
    assert off_half <= 0.005 * n and off_tenth <= 0.05 * n, (off_half, off_tenth)
