"""Training-mode BatchNorm with batch statistics as a hand-written CUDA
kernel pair on the card (``csrc/bn_train.cu``).

``batch_norm_train(x, weight, bias, running_mean, running_var,
num_batches_tracked, eps, momentum)`` normalizes a float32 (N, C, ...) CUDA
tensor, contiguous or channels-last 4-D, with its batch mean and biased
variance over every axis but the channel, updates the running statistics in
place as Flax does (``ra = (1 - momentum)·ra + momentum·stat``, biased
variance, ``num_batches_tracked += 1``) and returns
``(x - mean)·rsqrt(var + eps)·w + b`` in x's layout.  The memory format
picks the kernels: a contiguous tensor the per-channel slabs, a
channels-last one the row tiles across every channel (``csrc/bn_train.cu``).
It is a ``torch.autograd.Function``: the forward saves x, the channel means
and 1/σ, and the backward is a kernel too.  Each forward launch is counted
as ``bn_train_fwd`` and each backward as ``bn_train_bwd``
(``ops.count_launch``); a channels-last launch also as ``bn_train_fwd_nhwc``
/ ``bn_train_bwd_nhwc``.  For any other tensor it raises: it never falls
back.

``batch_norm_train_plain`` is the same function in plain torch
(``torch.var_mean`` and ``F.batch_norm``) on any device and type; the CPU
and the bfloat16 step run it, and the tests hold the kernel to it.
``runs_kernel`` says which of the two ``models/unet.py``'s BatchNorm takes.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build, count_launch

NAME = "bn_train"
MAX_CHANNEL_ELEMENTS = 2 ** 31 - 1  # the kernel's flat (n, s) index is 32-bit
MAX_NHWC_CHANNELS = 1024  # the channels-last kernels: 4 channels a thread, 256 threads


def batch_norm_train_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           running_mean: torch.Tensor, running_var: torch.Tensor,
                           num_batches_tracked: torch.Tensor, eps: float,
                           momentum: float) -> torch.Tensor:
    """The function in plain torch: statistics in float32 at least, whatever
    the input type; F.batch_norm's own batch statistics for the output."""
    dims = [0] + list(range(2, x.dim()))
    with torch.no_grad():
        stat_t = torch.promote_types(x.dtype, torch.float32)
        var, mean = torch.var_mean(x.to(stat_t), dim=dims, correction=0)
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
        num_batches_tracked.add_(1)
    return F.batch_norm(x, None, None, weight, bias, True, 0.0, eps)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bn_train_workspace_floats.argtypes = [I, I, I]
    lib.bn_train_workspace_floats.restype = ctypes.c_longlong
    lib.bn_train_forward.argtypes = [P] * 10 + [I, I, I, Fl, Fl, P]
    lib.bn_train_forward.restype = I
    lib.bn_train_backward.argtypes = [P] * 9 + [I, I, I, P]
    lib.bn_train_backward.restype = I
    lib.bn_train_workspace_floats_nhwc.argtypes = [I, I]
    lib.bn_train_workspace_floats_nhwc.restype = ctypes.c_longlong
    lib.bn_train_forward_nhwc.argtypes = [P] * 10 + [I, I, Fl, Fl, P]
    lib.bn_train_forward_nhwc.restype = I
    lib.bn_train_backward_nhwc.argtypes = [P] * 9 + [I, I, P]
    lib.bn_train_backward_nhwc.restype = I
    return lib


def channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the channels-last kernels: a 4-D channels-last
    tensor that is not also contiguous (one that is both, as at C = 1 or
    H = W = 1, takes the contiguous ones)."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def runs_kernel(x: torch.Tensor) -> bool:
    """Whether ``x`` is what the kernel takes: a float32 CUDA tensor,
    contiguous or channels-last 4-D with at most ``MAX_NHWC_CHANNELS``
    channels.  ``batch_norm_train`` refuses one of fewer than two axes or
    outside 2 to 2³¹ − 1 elements a channel."""
    return x.is_cuda and x.dtype == torch.float32 and (
        x.is_contiguous() or (channels_last(x) and x.shape[1] <= MAX_NHWC_CHANNELS))


def _shape(x: torch.Tensor):
    """The kernels' shape arguments: (N, C, S) of a contiguous (N, C, ...)
    tensor, (N·H·W, C) of a channels-last one."""
    if channels_last(x):
        return x.shape[0] * x.shape[2] * x.shape[3], x.shape[1]
    return x.shape[0], x.shape[1], math.prod(x.shape[2:])


def _check_vectors(x: torch.Tensor, **vectors) -> None:
    C = x.shape[1]
    for name, v in vectors.items():
        if not (v.device == x.device and v.dtype == torch.float32 and v.shape == (C,)
                and v.is_contiguous()):
            raise ValueError(f"batch_norm_train: {name} must be a contiguous float32 ({C},) "
                             f"tensor on {x.device}, got {tuple(v.shape)} {v.dtype} on {v.device}")


def _workspace(x: torch.Tensor, nhwc: bool) -> torch.Tensor:
    lib = _lib()
    floats = (lib.bn_train_workspace_floats_nhwc if nhwc else lib.bn_train_workspace_floats)
    return torch.empty(int(floats(*_shape(x))), dtype=torch.float32, device=x.device)


def forward_kernel(x, weight, bias, running_mean, running_var, num_batches_tracked,
                   eps: float, momentum: float):
    """The forward's three kernels: (y, mean, 1/σ), the running statistics
    and ``num_batches_tracked`` updated in place.  No autograd."""
    C = x.shape[1]
    nhwc = channels_last(x)
    y = torch.empty_like(x)  # in x's layout
    mean = torch.empty(C, dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    work = _workspace(x, nhwc)
    launch = _lib().bn_train_forward_nhwc if nhwc else _lib().bn_train_forward
    with torch.cuda.device(x.device):  # the kernels run on the current device
        rc = launch(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), num_batches_tracked.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), work.data_ptr(), *_shape(x), eps, momentum,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_train forward launch failed: cudaError {rc}")
    count_launch("bn_train_fwd")
    if nhwc:
        count_launch("bn_train_fwd_nhwc")
    return y, mean, rstd


def backward_kernel(x, dy, weight, mean, rstd):
    """The backward's three kernels: (dx, dw, db), dx in x's layout; dy is
    taken in x's layout (copied if it is not)."""
    nhwc = channels_last(x)
    dy = dy.contiguous(memory_format=torch.channels_last if nhwc else torch.contiguous_format)
    dx = torch.empty_like(x)
    dw = torch.empty_like(mean)
    db = torch.empty_like(mean)
    work = _workspace(x, nhwc)
    launch = _lib().bn_train_backward_nhwc if nhwc else _lib().bn_train_backward
    with torch.cuda.device(x.device):
        rc = launch(
            x.data_ptr(), dy.data_ptr(), weight.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), work.data_ptr(), *_shape(x),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_train backward launch failed: cudaError {rc}")
    count_launch("bn_train_bwd")
    if nhwc:
        count_launch("bn_train_bwd_nhwc")
    return dx, dw, db


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                eps, momentum):
        y, mean, rstd = forward_kernel(x, weight, bias, running_mean, running_var,
                                       num_batches_tracked, eps, momentum)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx, dw, db = backward_kernel(x, dy, weight, mean, rstd)
        return dx, dw, db, None, None, None, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     num_batches_tracked: torch.Tensor, eps: float,
                     momentum: float) -> torch.Tensor:
    """Training-mode BatchNorm on the card (see the module docstring); raises
    for a tensor the kernel does not take."""
    per_channel = x.shape[0] * math.prod(x.shape[2:]) if x.dim() >= 2 else 0
    if not (runs_kernel(x) and 2 <= per_channel <= MAX_CHANNEL_ELEMENTS):
        raise ValueError(f"batch_norm_train takes a float32 CUDA tensor (N, C, ...), contiguous "
                         f"or channels-last 4-D with at most {MAX_NHWC_CHANNELS} channels, "
                         f"with 2 to {MAX_CHANNEL_ELEMENTS} elements a channel, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}"
                         f"{'' if x.is_contiguous() else ', not contiguous'}")
    _check_vectors(x, weight=weight, bias=bias, running_mean=running_mean,
                   running_var=running_var)
    if not (num_batches_tracked.device == x.device and num_batches_tracked.dtype == torch.int64
            and num_batches_tracked.numel() == 1):
        raise ValueError("batch_norm_train: num_batches_tracked must be an int64 scalar on "
                         f"{x.device}")
    return _BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                 num_batches_tracked, eps, momentum)
