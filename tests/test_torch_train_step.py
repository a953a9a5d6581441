"""The port's float32 and bfloat16 train steps against the JAX trainer on
the committed trained weights (carried over with ``from_flax_variables``)
and a synthesized batch, at B = 2.

float32 gradients are not exact: both packages sum convolutions and the
BatchNorm reductions in their own orders, and the network amplifies that.
So besides holding the port to JAX directly, the tests measure both against
the float64 gradient (the port's float64 step, which
tests/test_torch_train.py holds to JAX's float64 step to 1e-5) and require
the port to be as close to it as JAX is.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.train import device_data as jdd
from softspoken_tpu.train import synth as jsynth

from torch_train_ref import jax_loss_and_grads, port_loss_and_grads, port_model, rel_err

torch.set_num_threads(2)

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "root", "models", "spec_unet_2d", "model_checkpoint")
AUGS = ("add_reverb", "reduce_volume")


@pytest.fixture(scope="module")
def trained():
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    return jax.device_get(jckpt.load(CKPT)[0])


@pytest.fixture(scope="module")
def pools():
    return jsynth.make_pools(np.random.default_rng(0), 3, 3)


@pytest.fixture(scope="module")
def batch(pools):
    """One batch of JAX's synthesizer, in the port's layout."""
    sp, nz = pools
    b = jax.jit(jdd.make_synth_batch_fn(2, AUGS))(jnp.asarray(sp), jnp.asarray(nz),
                                                   jax.random.PRNGKey(0))
    return {"mel": np.asarray(b["mel"])[..., 0], "mask": np.asarray(b["mask"]),
            "spec": np.asarray(b["spec"]).transpose(0, 3, 1, 2)}


@pytest.fixture(scope="module")
def truth(trained, batch):
    """The float64 gradient."""
    return port_loss_and_grads(port_model(trained), batch, 0.0, torch.float64)[2]


def _errors(grads, truth):
    """Per tensor max |g − truth| / max |truth|, and the relative L2 error of
    the whole gradient."""
    per = {k: rel_err(grads[k], truth[k]) for k in truth}
    l2 = np.sqrt(sum(((grads[k] - truth[k]) ** 2).sum() for k in truth)
                 / sum((truth[k] ** 2).sum() for k in truth))
    return per, float(l2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_matches_jax_as_closely_as_jax_matches_float64(trained, batch, truth, dtype):
    """The loss to JAX's within 1e-5 relative in float32 and 1e-2 in
    bfloat16 (8 bits, rounded at other points: Flax casts per call, the
    port autocasts).  Each gradient tensor within max(2× JAX's own error,
    1e-3 in float32 / 5e-2 in bfloat16) of the float64 gradient, relative
    to its max |g| (the floor admits torch's float32 accumulation over the
    65,536 positions of the spec head's 1×1 conv, ~4e-4, where XLA's tree
    sum reaches 1e-6); the whole gradient within 1.5× JAX's relative L2
    error.  The BN running statistics, computed in float32 from each
    layer's input, to 2e-5 (float32) or 2e-2 (bfloat16 activations) of
    each tensor's max."""
    jdt, tdt, floor, stat_tol = {"float32": (jnp.float32, torch.float32, 1e-3, 2e-5),
                                 "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2, 2e-2)}[dtype]
    loss_j, _, grads_j = jax_loss_and_grads(trained, batch, 0.0, jdt)
    model = port_model(trained)
    loss_t, _, grads_t = port_loss_and_grads(model, batch, 0.0, tdt)
    assert abs(loss_t - loss_j) <= (1e-5 if dtype == "float32" else 1e-2) * abs(loss_j)
    per_t, l2_t = _errors(grads_t, truth)
    per_j, l2_j = _errors(grads_j, truth)
    bad = [(k, per_t[k], per_j[k]) for k in truth if per_t[k] > max(2 * per_j[k], floor)]
    assert not bad, bad
    assert l2_t <= 1.5 * l2_j + 1e-6, (l2_t, l2_j)
    sd = model.state_dict()
    worst = max((rel_err(sd[k].numpy(), grads_j[k]), k) for k in grads_j if "running" in k)
    assert worst[0] <= stat_tol, worst
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
