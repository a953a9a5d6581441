"""The port's U-Net training mode, loss, gradients and AdamW against the JAX
package's trainer (``softspoken_tpu/train/loop.py``), on the full model at
B = 2 from the same weights (``fixture_variables(seed=0)`` carried over
with ``from_flax_variables``) and the same batch.

The gradient parity here runs in float64 on both sides: the random fixture
weights make float32 gradients ill-conditioned (the JAX package's own
float32 gradient is up to 10% of a tensor's max off its float64 gradient),
so float32 could not tell a wrong formula from rounding.  The float32 and
bfloat16 steps are held to JAX on trained weights in
tests/test_torch_train_step.py.  Dropout is tested alone.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from softspoken_tpu import ckpt as jckpt
from softspoken_tpu_torch.models.unet import BN_EPS, BatchNorm1d, BatchNorm2d, channel_dropout
from softspoken_tpu_torch.train import loop as tloop

from torch_train_ref import jax_loss_and_grads, port_loss_and_grads, port_model, rel_err

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_vars():
    return jax.device_get(jckpt.fixture_variables(seed=0))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(4)
    toggles = rng.uniform(size=(2, 256)) > 0.95
    return {
        "mel": rng.uniform(0.0, 1.5, (2, 128, 256)).astype(np.float32),
        "mask": (np.cumsum(toggles, axis=1) % 2).astype(np.float32),
        "spec": rng.uniform(0.0, 1.0, (2, 2, 128, 256)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# BatchNorm and dropout

@pytest.mark.parametrize("oned", [False, True], ids=["2d", "1d"])
def test_batchnorm_training_follows_flax(oned):
    """Batch statistics with the biased variance, for the normalization and
    for the running update (ra = 0.9·ra + 0.1·stat): the same as a Flax
    BatchNorm on the same values (1e-5), and not what torch's own
    BatchNorm writes into running_var (×n/(n−1))."""
    rng = np.random.default_rng(0)
    shape = (3, 5, 16) if oned else (3, 5, 4, 6)
    x = rng.normal(0.7, 2.0, shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 5).astype(np.float32), rng.normal(0, 0.1, 5).astype(np.float32)
    rm, rv = rng.normal(0, 0.2, 5).astype(np.float32), rng.uniform(0.5, 1.5, 5).astype(np.float32)

    bn = (BatchNorm1d if oned else BatchNorm2d)(5, eps=BN_EPS)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(rm))
        bn.running_var.copy_(torch.from_numpy(rv))
    y = bn.train()(torch.from_numpy(x)).detach().numpy()

    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    x_last = np.moveaxis(x, 1, -1)
    yj, upd = flax_bn.apply({"params": {"scale": scale, "bias": bias},
                             "batch_stats": {"mean": rm, "var": rv}},
                            jnp.asarray(x_last), mutable=["batch_stats"])
    np.testing.assert_allclose(y, np.moveaxis(np.asarray(yj), -1, 1), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), upd["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), upd["batch_stats"]["var"], atol=1e-5)

    axes = (0, 2) if oned else (0, 2, 3)
    n = x.size // 5
    var_b = x.astype(np.float64).var(axis=axes)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * rv + 0.1 * var_b, rtol=1e-5)
    torch_bn = (torch.nn.BatchNorm1d if oned else torch.nn.BatchNorm2d)(5, eps=BN_EPS)
    torch_bn.running_var.copy_(torch.from_numpy(rv))
    torch_bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(torch_bn.running_var.numpy(), 0.9 * rv + 0.1 * var_b * n / (n - 1),
                               rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    # eval mode: torch's running-statistics path, unchanged
    ye = bn.eval()(torch.from_numpy(x)).detach().numpy()
    exp = (x - bn.running_mean.numpy()[:, None] if oned else x - bn.running_mean.numpy()[:, None, None])
    sd = np.sqrt(bn.running_var.numpy() + BN_EPS)
    want = exp / (sd[:, None] if oned else sd[:, None, None]) * (
        scale[:, None] if oned else scale[:, None, None]) + (bias[:, None] if oned else bias[:, None, None])
    np.testing.assert_allclose(ye, want, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 256, 3, 5), (4, 256, 7)], ids=["2d", "1d"])
def test_channel_dropout_drops_whole_channels_and_scales(shape):
    x = torch.rand(shape) + 0.5
    g = torch.Generator().manual_seed(1)
    y = channel_dropout(x, 0.1, g)
    kept = (y.reshape(shape[0], shape[1], -1) != 0).any(dim=-1)       # (B, C)
    # every element of a channel map shares its fate; kept ones scale by 1/(1−p)
    full = kept.reshape(kept.shape + (1,) * (len(shape) - 2)).expand(shape)
    assert torch.equal(y, torch.where(full, x / 0.9, torch.zeros(())))
    assert 0.05 < 1.0 - float(kept.float().mean()) < 0.15
    assert torch.equal(channel_dropout(x, 0.1, torch.Generator().manual_seed(1)), y)


def test_model_dropout_only_in_training_mode(jax_vars):
    model = port_model(jax_vars, dropout_p=0.1)
    mel = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 128, 256)).astype(np.float32))
    with torch.no_grad():
        ev = model.eval()(mel, torch.Generator().manual_seed(0))
        assert torch.equal(model(mel, torch.Generator().manual_seed(5))[1], ev[1])
        model.train()
        a = model(mel, torch.Generator().manual_seed(0))
        b = model(mel, torch.Generator().manual_seed(0))
        c = model(mel, torch.Generator().manual_seed(1))
    assert torch.equal(a[1], b[1]) and not torch.equal(a[1], c[1])
    assert not torch.equal(a[1], ev[1])


# ---------------------------------------------------------------------------
# one step against the JAX trainer

@pytest.mark.parametrize("bw", [0.0, 2.0], ids=["bw0", "bw2"])
def test_loss_grads_and_bn_stats_match_jax_in_float64(jax_vars, batch, bw):
    """Float64 inside both models (each rounds its two outputs to float32,
    as it always does, so 1e-7 is the loss's floor): loss and metrics to
    1e-6 relative, every gradient tensor to 1e-5 of its own max |g|
    (measured 5e-7), and the new BN running statistics (biased batch
    variance, momentum 0.9) to 1e-6 relative."""
    loss_j, met_j, grads_j = jax_loss_and_grads(jax_vars, batch, bw, jnp.float64)
    model = port_model(jax_vars)
    loss_t, met_t, grads_t = port_loss_and_grads(model, batch, bw, torch.float64)
    assert abs(loss_t - loss_j) <= 1e-6 * abs(loss_j)
    for k in ("loss", "mask_loss", "spec_loss"):
        assert abs(met_t[k] - met_j[k]) <= 1e-6 * abs(met_j[k]), k
    assert set(grads_t) == {k for k in grads_j if "running" not in k}
    worst = max((rel_err(grads_t[k], grads_j[k]), k) for k in grads_t)
    assert worst[0] <= 1e-5, worst
    sd = model.state_dict()
    n_stats = 0
    for k in grads_j:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), grads_j[k], rtol=1e-6, atol=1e-9, err_msg=k)
            n_stats += 1
    assert n_stats == 2 * 36


def test_adamw_matches_optax_over_three_steps():
    """torch.optim.AdamW (make_optimizer) and optax.adamw on the same
    parameters and gradients: decoupled decay on every tensor, bias
    correction; the same float32 arithmetic in another order, so each
    parameter agrees to 1e-6 relative or 1e-4 of the step size lr = 1e-3
    (measured: one element of 288 off by 1.5e-8)."""
    rng = np.random.default_rng(0)
    shapes = [(32, 1, 3, 3), (32,), (4, 32, 128, 1), (1,)]
    params = [rng.normal(0, 0.5, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 10.0 ** -i, s).astype(np.float32) for i, s in enumerate(shapes)]
             for _ in range(3)]

    tx = optax.adamw(1e-3, weight_decay=1e-4)
    pj = [jnp.asarray(p) for p in params]
    opt = tx.init(pj)
    module = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    optim = tloop.make_optimizer(module, 1e-3, 1e-4)
    for g in grads:
        upd, opt = tx.update([jnp.asarray(x) for x in g], opt, pj)
        pj = optax.apply_updates(pj, upd)
        for p, x in zip(module, g):
            p.grad = torch.from_numpy(x.copy())
        optim.step()
        for p, want in zip(module, pj):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_dropout_generator_is_a_function_of_seed_and_step():
    a = tloop.dropout_generator(3, 7, torch.device("cpu"))
    b = tloop.dropout_generator(3, 7, torch.device("cpu"))
    c = tloop.dropout_generator(3, 8, torch.device("cpu"))
    x, y, z = (torch.rand(8, generator=g) for g in (a, b, c))
    assert torch.equal(x, y) and not torch.equal(x, z)
