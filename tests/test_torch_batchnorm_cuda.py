"""Training-mode BatchNorm's CUDA kernel pair (``csrc/bn_train.cu`` behind
``ops/batchnorm.py``) on the card, in both layouts (contiguous NCHW and
channels-last NHWC): against its plain twin and float64 at the training
step's shapes and at ragged ones, bit-equal over two runs, the wrapper's
refusals, and the launches of one training step.

No JAX here; on a machine with only PyTorch:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_batchnorm_cuda.py

Each test decides inside itself whether a card is present and skips
without one.
"""

import numpy as np
import pytest
import torch

from softspoken_tpu_torch.models.unet import BN_EPS, BN_MOMENTUM
from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, batchnorm

pytestmark = pytest.mark.cuda

BN_LAUNCHES = ("bn_train_fwd", "bn_train_bwd")
NHWC_LAUNCHES = ("bn_train_fwd_nhwc", "bn_train_bwd_nhwc")
TRAINING_BATCHNORMS = 36  # 11 two-D ResBlocks and the 1-D mask block, 3 each
TRAINING_BATCHNORMS_2D = 33  # the 2-D ones: channels-last in the float32 step
CL = torch.channels_last

# the step's (N, C, S...) at B = 128: level 1, the bottleneck, the mask block;
# then ragged ones: S = 63 and 10 (the scalar path), a 2-D input (S = 1), a
# partial last slab (M = 8,200 of 8,192 a slab)
STEP_SHAPES = [(128, 32, 128, 256), (128, 128, 8, 16), (128, 4, 256)]
RAGGED_SHAPES = [(3, 5, 7, 9), (5, 3, 10), (7, 6), (2, 3, 4100)]
# channels-last: odd C and C % 4 != 0 (the scalar loads), C = 4 (one channel
# group, 256 rows a pass), C = 1,024 (one row a pass), C = 96 (16 idle
# threads), a partial last tile (R = 8,200 rows of 256 a tile)
RAGGED_NHWC_SHAPES = [(3, 5, 7, 9), (2, 6, 5, 3), (4, 4, 33, 17), (2, 1024, 3, 5),
                      (3, 96, 11, 13), (2, 32, 41, 100)]


def _step_nhwc_shapes(batch: int = 128) -> list:
    """The input shape of each distinct 2-D BatchNorm of a float32 training
    step at ``batch`` rows, read by forward pre-hooks from one forward of a
    single row on the CPU with the channels-last training plan forced (the
    spatial sizes do not depend on the batch; with gradients on, as in a
    step: without, the CPU's 1x1 convolutions take oneDNN's contiguous
    path); each input is channels-last."""
    from softspoken_tpu_torch.models.unet import N_MELS, BatchNorm2d, SpecUNet2D

    model = SpecUNet2D().train()
    model._train_plan = lambda mel: True
    seen = []

    def hook(_m, args):
        assert args[0].is_contiguous(memory_format=CL)
        seen.append((batch,) + tuple(args[0].shape[1:]))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, BatchNorm2d)]
    model(torch.zeros(1, N_MELS, 256))
    for h in hooks:
        h.remove()
    assert len(seen) == TRAINING_BATCHNORMS_2D
    return sorted(set(seen), key=seen.index)


STEP_NHWC_SHAPES = [(128, 32, 256, 128), (128, 64, 128, 64), (128, 96, 64, 32),
                    (128, 128, 32, 16), (128, 128, 16, 8), (128, 96, 32, 16),
                    (128, 64, 64, 32), (128, 32, 128, 64)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _inputs(shape, seed=0, device="cuda", memory_format=torch.contiguous_format):
    """As tests/test_torch_batchnorm.py: a channel offset larger than the
    spread, affine parameters, running statistics, an upstream gradient;
    x and dy in ``memory_format``."""
    g = torch.Generator(device=device).manual_seed(seed)
    C = shape[1]
    bshape = (1, C) + (1,) * (len(shape) - 2)

    def rn(*s):
        return torch.randn(s, generator=g, device=device)

    return {"x": (0.5 * rn(*shape) + 3.0 * rn(C).view(bshape)).contiguous(
                memory_format=memory_format),
            "w": 0.5 + torch.rand(C, generator=g, device=device),
            "b": 0.1 * rn(C), "rm": 0.2 * rn(C),
            "rv": 0.5 + torch.rand(C, generator=g, device=device),
            "dy": rn(*shape).contiguous(memory_format=memory_format)}


def _run(fn, t):
    x = t["x"].clone().requires_grad_()
    w, b = t["w"].clone().requires_grad_(), t["b"].clone().requires_grad_()
    rm, rv = t["rm"].clone(), t["rv"].clone()
    nbt = torch.zeros((), dtype=torch.int64, device=x.device)
    y = fn(x, w, b, rm, rv, nbt, BN_EPS, BN_MOMENTUM)
    y.backward(t["dy"])
    return {"y": y.detach(), "running_mean": rm, "running_var": rv, "nbt": nbt,
            "dx": x.grad, "dw": w.grad, "db": b.grad}


def _float64(x, weight, bias, running_mean, running_var, num_batches_tracked, eps,
             momentum):
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


def _rel(a, want):
    return float((a.double() - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", STEP_SHAPES + RAGGED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_pair_matches_plain_version(shape):
    """The kernel pair launches once each way and lands as close to the
    float64 function as the plain version (cuDNN and torch.var_mean) does.
    Tolerance, on each tensor's error relative to its largest value: within
    2x the plain version's own error, or within a floor where that error
    is smaller still: 2e-6 for the output and the running statistics (a few
    float32 roundings of values up to ~10) and 1e-5 for the gradients (dw
    and db are sums over up to 4.2 M float32 products, whose summation
    order the two versions choose differently)."""
    _need_card()
    t = _inputs(shape)
    before = {k: KERNEL_LAUNCHES[k] for k in BN_LAUNCHES}
    got = _run(batchnorm.batch_norm_train, t)
    torch.cuda.synchronize()
    assert {k: KERNEL_LAUNCHES[k] - before[k] for k in BN_LAUNCHES} == dict.fromkeys(
        BN_LAUNCHES, 1)
    plain = _run(batchnorm.batch_norm_train_plain, t)
    want = _run(_float64, {k: v.double() for k, v in t.items()})
    _holds_to_float64(got, plain, want)


def _holds_to_float64(got, plain, want):
    """test_kernel_pair_matches_plain_version's tolerance: each tensor's
    error relative to float64 within 2x the plain version's or its floor."""
    assert int(got["nbt"]) == int(plain["nbt"]) == 1
    for name in ("y", "running_mean", "running_var", "dx", "dw", "db"):
        floor = 2e-6 if name in ("y", "running_mean", "running_var") else 1e-5
        e_kernel, e_plain = _rel(got[name], want[name]), _rel(plain[name], want[name])
        assert e_kernel <= max(2 * e_plain, floor), (name, e_kernel, e_plain)


def test_the_step_gives_these_channels_last_shapes():
    """STEP_NHWC_SHAPES are the distinct inputs of the float32 step's 33
    two-D BatchNorms at B = 128, each channels-last."""
    assert _step_nhwc_shapes() == STEP_NHWC_SHAPES


@pytest.mark.parametrize("shape", STEP_NHWC_SHAPES + RAGGED_NHWC_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_channels_last_pair_matches_plain_version(shape):
    """A channels-last input takes the row-tile kernels (one launch each
    way, counted as channels-last too), returns y and dx channels-last, and
    lands as close to float64 as the contiguous pair must (the tolerance of
    test_kernel_pair_matches_plain_version)."""
    _need_card()
    t = _inputs(shape, memory_format=CL)
    assert batchnorm.runs_kernel(t["x"]) and batchnorm.channels_last(t["x"])
    names = BN_LAUNCHES + NHWC_LAUNCHES
    before = {k: KERNEL_LAUNCHES[k] for k in names}
    got = _run(batchnorm.batch_norm_train, t)
    torch.cuda.synchronize()
    assert {k: KERNEL_LAUNCHES[k] - before[k] for k in names} == dict.fromkeys(names, 1)
    assert got["y"].is_contiguous(memory_format=CL)
    assert got["dx"].is_contiguous(memory_format=CL)
    plain = _run(batchnorm.batch_norm_train_plain, t)
    want = _run(_float64, {k: v.double() for k, v in t.items()})
    _holds_to_float64(got, plain, want)


def test_channels_last_dy_of_another_layout():
    """A contiguous upstream gradient for a channels-last input is taken in
    the input's layout: the same result as a channels-last one."""
    _need_card()
    t = _inputs((4, 8, 6, 10), memory_format=CL)
    a = _run(batchnorm.batch_norm_train, t)
    b = _run(batchnorm.batch_norm_train, dict(t, dy=t["dy"].contiguous()))
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_channels_last_kernel_on_an_unaligned_view():
    """A channels-last view that starts 4 bytes into its storage takes the
    scalar loads and gives the same result as an aligned copy."""
    _need_card()
    t = _inputs((4, 8, 5, 6), memory_format=CL)
    buf = torch.empty(t["x"].numel() + 1, device="cuda")
    x = buf[1:].view(4, 5, 6, 8).permute(0, 3, 1, 2)
    x.copy_(t["x"])
    assert batchnorm.channels_last(x) and x.data_ptr() % 16 != 0
    a = _run(batchnorm.batch_norm_train, dict(t, x=x))
    b = _run(batchnorm.batch_norm_train, t)
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=1e-6, atol=1e-6)


def test_kernel_on_an_unaligned_view():
    """A contiguous view that starts 4 bytes into its storage (not 16-byte
    aligned) takes the kernel's scalar loads and gives the same result as
    an aligned copy of the same values."""
    _need_card()
    t = _inputs((4, 3, 64))
    buf = torch.empty(t["x"].numel() + 1, device="cuda")
    x = buf[1:].view(t["x"].shape)
    x.copy_(t["x"])
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    a = _run(batchnorm.batch_norm_train, dict(t, x=x))
    b = _run(batchnorm.batch_norm_train, t)
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,memory_format", [
    (STEP_SHAPES[0], torch.contiguous_format), (RAGGED_SHAPES[0], torch.contiguous_format),
    (STEP_NHWC_SHAPES[0], CL), (RAGGED_NHWC_SHAPES[0], CL), (STEP_NHWC_SHAPES[2], CL)],
    ids=["step", "ragged", "step-nhwc", "ragged-nhwc", "c96-nhwc"])
def test_two_runs_are_bit_equal(shape, memory_format):
    """No float atomics and a fixed merge order: the same inputs give the
    same bits, in either layout."""
    _need_card()
    t = _inputs(shape, seed=3, memory_format=memory_format)
    a = _run(batchnorm.batch_norm_train, t)
    b = _run(batchnorm.batch_norm_train, t)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """A non-contiguous (and not channels-last), a non-float32, a CPU or a
    channels-last input of more than 1,024 channels raises before any
    launch; the module takes the plain path for each.  A contiguous float32
    CUDA input with a single value a channel raises too (as F.batch_norm
    does in training): the module hands it to the kernel's wrapper."""
    _need_card()
    t = _inputs((4, 3, 6, 8))
    nbt = torch.zeros((), dtype=torch.int64, device="cuda")
    before = {k: KERNEL_LAUNCHES[k] for k in BN_LAUNCHES}
    for x in (t["x"].transpose(2, 3), t["x"].double(), t["x"].bfloat16(), t["x"].cpu()):
        assert not batchnorm.runs_kernel(x)
        with pytest.raises(ValueError):
            batchnorm.batch_norm_train(x, t["w"], t["b"], t["rm"], t["rv"], nbt, BN_EPS,
                                       BN_MOMENTUM)
    wide = torch.randn(2, 1028, 3, 3, device="cuda").contiguous(memory_format=CL)
    assert batchnorm.channels_last(wide) and not batchnorm.runs_kernel(wide)
    with pytest.raises(ValueError, match="channels"):
        batchnorm.batch_norm_train(wide, *(torch.ones(1028, device="cuda"),) * 4, nbt,
                                   BN_EPS, BN_MOMENTUM)
    one = torch.randn(1, 3, device="cuda")
    assert batchnorm.runs_kernel(one)
    with pytest.raises(ValueError, match="elements a channel"):
        batchnorm.batch_norm_train(one, t["w"], t["b"], t["rm"], t["rv"], nbt, BN_EPS,
                                   BN_MOMENTUM)
    with pytest.raises(ValueError):  # a parameter of another type
        batchnorm.batch_norm_train(t["x"], t["w"].double(), t["b"], t["rm"], t["rv"], nbt,
                                   BN_EPS, BN_MOMENTUM)
    assert {k: KERNEL_LAUNCHES[k] for k in BN_LAUNCHES} == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_launches_the_pair_once_per_batchnorm(dtype):
    """One float32 training step on the card launches the forward and the
    backward once for each of the 36 training-mode BatchNorms, the 33 two-D
    ones channels-last (the 1-D mask block stays contiguous); the bfloat16
    autocast step and an eval forward launch neither."""
    _need_card()
    from softspoken_tpu_torch.train.loop import create_train_state, train_step

    rng = np.random.default_rng(2)
    batch = {"mel": rng.uniform(0, 1.5, (2, 128, 256)), "mask": rng.uniform(size=(2, 256)) > 0.5,
             "spec": rng.uniform(0, 1, (2, 2, 128, 256))}
    batch = {k: torch.from_numpy(np.asarray(v, np.float32)).cuda() for k, v in batch.items()}
    state = create_train_state(seed=0, compute_dtype=dtype, device="cuda")
    names = BN_LAUNCHES + NHWC_LAUNCHES
    before = {k: KERNEL_LAUNCHES[k] for k in names}
    m = train_step(state, batch)
    assert np.isfinite(float(m["loss"]))
    f32 = dtype == torch.float32
    want = {**dict.fromkeys(BN_LAUNCHES, TRAINING_BATCHNORMS if f32 else 0),
            **dict.fromkeys(NHWC_LAUNCHES, TRAINING_BATCHNORMS_2D if f32 else 0)}
    assert {k: KERNEL_LAUNCHES[k] - before[k] for k in names} == want
    state.model.eval()
    with torch.no_grad():
        state.model(batch["mel"])
    assert {k: KERNEL_LAUNCHES[k] - before[k] for k in names} == want
