"""Training-mode BatchNorm (``ops/batchnorm.py``): the plain twin of the
CUDA kernel pair against the module's code before the kernel and against
float64, and which path ``models/unet.py``'s BatchNorm takes off the card.

The kernel itself runs only on a card (tests/test_torch_batchnorm_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from softspoken_tpu_torch.models.unet import BN_EPS, BN_MOMENTUM, BatchNorm1d, BatchNorm2d
from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, batchnorm
from softspoken_tpu_torch.train.loop import create_train_state, train_step

SHAPES = [(6, 5, 7, 9), (8, 4, 33)]
BN_LAUNCHES = ("bn_train_fwd", "bn_train_bwd")


def _inputs(shape, seed=0):
    """x with a channel offset larger than its spread (the case where a
    one-pass E[x²] − mean² variance would lose digits), the affine
    parameters, the running statistics and an upstream gradient."""
    rng = np.random.default_rng(seed)
    C = shape[1]
    offset = rng.normal(0.0, 3.0, C).reshape((1, C) + (1,) * (len(shape) - 2))
    t = {"x": rng.normal(0.0, 0.5, shape) + offset,
         "w": rng.uniform(0.5, 1.5, C), "b": rng.normal(0.0, 0.1, C),
         "rm": rng.normal(0.0, 0.2, C), "rv": rng.uniform(0.5, 1.5, C),
         "dy": rng.normal(0.0, 1.0, shape)}
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in t.items()}


def _run(fn, t):
    """(y, running mean, running var, num_batches_tracked, dx, dw, db) of
    one training-mode call of ``fn`` with the BatchNorm signature."""
    x = t["x"].clone().requires_grad_()
    w, b = t["w"].clone().requires_grad_(), t["b"].clone().requires_grad_()
    rm, rv = t["rm"].clone(), t["rv"].clone()
    nbt = torch.zeros((), dtype=torch.int64)
    y = fn(x, w, b, rm, rv, nbt, BN_EPS, BN_MOMENTUM)
    y.backward(t["dy"])
    return y.detach(), rm, rv, nbt, x.grad, w.grad, b.grad


def _before_the_kernel(x, weight, bias, running_mean, running_var, num_batches_tracked,
                       eps, momentum):
    """``_TrainStatsBN.forward``'s training branch as it was before the
    kernel pair, line for line."""
    dims = [0] + list(range(2, x.dim()))
    with torch.no_grad():
        stat_t = torch.promote_types(x.dtype, torch.float32)
        var, mean = torch.var_mean(x.to(stat_t), dim=dims, correction=0)
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
        num_batches_tracked.add_(1)
    return F.batch_norm(x, None, None, weight, bias, True, 0.0, eps)


def _float64(x, weight, bias, running_mean, running_var, num_batches_tracked, eps,
             momentum):
    """The definition, in float64 autograd: biased variance, Flax's update."""
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(dims)
    var = ((x - mean.view(shape)) ** 2).mean(dims)
    with torch.no_grad():
        running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
        running_var.copy_((1 - momentum) * running_var + momentum * var)
        num_batches_tracked.add_(1)
    xhat = (x - mean.view(shape)) / torch.sqrt(var.view(shape) + eps)
    return xhat * weight.view(shape) + bias.view(shape)


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "1d"])
def test_plain_twin_is_the_code_before_the_kernel_and_near_float64(shape):
    """Output, running statistics, num_batches_tracked and the gradients for
    x, w and b: bit for bit the module's code before the kernel pair, and the
    module's own training mode on the CPU; within float32 rounding of the
    float64 function (5e-6 of each tensor's largest value: sums over a few
    hundred float32 elements)."""
    t = _inputs(shape)
    got = _run(batchnorm.batch_norm_train_plain, t)
    for a, b in zip(got, _run(_before_the_kernel, t)):
        assert torch.equal(a, b)
    assert int(got[3]) == 1

    bn = (BatchNorm1d if len(shape) == 3 else BatchNorm2d)(shape[1], eps=BN_EPS).train()
    with torch.no_grad():
        for p, k in ((bn.weight, "w"), (bn.bias, "b"), (bn.running_mean, "rm"),
                     (bn.running_var, "rv")):
            p.copy_(t[k])
    x = t["x"].clone().requires_grad_()
    y = bn(x)
    y.backward(t["dy"])
    mod = (y.detach(), bn.running_mean, bn.running_var, bn.num_batches_tracked, x.grad,
           bn.weight.grad, bn.bias.grad)
    for a, b in zip(got, mod):
        assert torch.equal(a, b)

    want = _run(_float64, {k: v.double() for k, v in t.items()})
    for name, a, b in zip(("y", "running_mean", "running_var", "nbt", "dx", "dw", "db"),
                          got, want):
        if name == "nbt":
            assert int(a) == int(b) == 1
            continue
        err = float((a.double() - b).abs().max() / b.abs().max())
        assert err < 5e-6, (name, err)


@pytest.mark.parametrize("shape", [(6, 5, 7, 9), (4, 32, 16, 24)], ids=["c5", "c32"])
def test_plain_twin_on_a_channels_last_input(shape):
    """The plain twin on a channels-last input (the layout of the float32
    step's activations on the card) keeps it: y and dx come back
    channels-last; the running statistics are the contiguous input's bit
    for bit, and y, dx, dw and db are within the same float32 rounding of
    the float64 function as test_plain_twin_is_the_code_before_the_kernel_and_near_float64
    holds the contiguous input to."""
    cl = torch.channels_last
    t = _inputs(shape)
    flat = _run(batchnorm.batch_norm_train_plain, t)
    got = _run(batchnorm.batch_norm_train_plain,
               dict(t, x=t["x"].contiguous(memory_format=cl),
                    dy=t["dy"].contiguous(memory_format=cl)))
    assert got[0].is_contiguous(memory_format=cl) and got[4].is_contiguous(memory_format=cl)
    for i in (1, 2, 3):
        assert torch.equal(got[i], flat[i])
    want = _run(_float64, {k: v.double() for k, v in t.items()})
    for name, i in (("y", 0), ("dx", 4), ("dw", 5), ("db", 6)):
        err = float((got[i].double() - want[i]).abs().max() / want[i].abs().max())
        assert err < 5e-6, (name, err)


class _OneRank:
    """A ``shard`` of one rank: the all-gather of a tensor is that tensor."""

    def all_gather(self, t):
        return t[None]


@pytest.mark.parametrize("mode", ["train", "eval", "autocast_bf16", "shard"])
@pytest.mark.parametrize("oned", [False, True], ids=["2d", "1d"])
def test_module_takes_the_plain_path_off_the_card(monkeypatch, mode, oned):
    """On the CPU, in eval mode, under bfloat16 autocast (a convolution feeds
    the BatchNorm bfloat16, as in the bfloat16 step) and with ``shard`` set,
    the module never calls the kernel's wrapper and counts no launch."""
    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(batchnorm, "batch_norm_train", refuse)
    shape = (4, 3, 8) if oned else (4, 3, 6, 8)
    conv = (torch.nn.Conv1d if oned else torch.nn.Conv2d)(3, 3, 1)
    bn = (BatchNorm1d if oned else BatchNorm2d)(3, eps=BN_EPS)
    bn.train(mode != "eval")
    if mode == "shard":
        bn.shard = _OneRank()
    x = _inputs(shape)["x"].requires_grad_()
    assert not batchnorm.runs_kernel(x)
    before = {k: KERNEL_LAUNCHES[k] for k in BN_LAUNCHES}
    if mode == "autocast_bf16":
        with torch.autocast("cpu", dtype=torch.bfloat16):
            h = conv(x)
            assert h.dtype == torch.bfloat16
            y = bn(h)
    else:
        y = bn(x)
    y.float().sum().backward()
    assert torch.isfinite(x.grad).all()
    assert int(bn.num_batches_tracked) == (0 if mode == "eval" else 1)
    assert {k: KERNEL_LAUNCHES[k] for k in BN_LAUNCHES} == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_train_step_launches_no_batchnorm_kernel(dtype):
    """A whole training step on the CPU (float32 and the bfloat16 autocast
    step) runs every BatchNorm in plain torch: no ``bn_train_*`` launch."""
    rng = np.random.default_rng(2)
    batch = {"mel": torch.from_numpy(rng.uniform(0, 1.5, (2, 128, 256)).astype(np.float32)),
             "mask": torch.from_numpy((rng.uniform(size=(2, 256)) > 0.5).astype(np.float32)),
             "spec": torch.from_numpy(rng.uniform(0, 1, (2, 2, 128, 256)).astype(np.float32))}
    state = create_train_state(seed=0, compute_dtype=dtype)
    before = {k: KERNEL_LAUNCHES[k] for k in BN_LAUNCHES}
    m = train_step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert {k: KERNEL_LAUNCHES[k] for k in BN_LAUNCHES} == before
    assert all(int(mod.num_batches_tracked) == 1 for mod in state.model.modules()
               if isinstance(mod, (BatchNorm1d, BatchNorm2d)))


def test_kernel_wrapper_refuses_a_cpu_tensor():
    """The wrapper launches the kernel or raises: a CPU input is refused
    before any library is loaded."""
    t = _inputs((4, 3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        batchnorm.batch_norm_train(t["x"], t["w"], t["b"], t["rm"], t["rv"],
                                   torch.zeros((), dtype=torch.int64), BN_EPS, BN_MOMENTUM)
