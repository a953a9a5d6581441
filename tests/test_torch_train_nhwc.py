"""The float32 training step's channels-last plan (``models/unet.py``,
``SpecUNet2D._train_plan``) off the card: which inputs take it, and the plan
forced on the CPU against the NCHW forward and backward.

The CPU never takes the plan by itself; these tests hold its code, not its
speed.  On the card: tests/test_torch_train_cuda.py.
"""

import copy
import types

import numpy as np
import pytest
import torch

from softspoken_tpu_torch.models.unet import SpecUNet2D
from softspoken_tpu_torch.train.loop import create_train_state, dropout_generator, loss_fn

CL = torch.channels_last
FRAMES = 32  # the plan needs T divisible by 16; 32 keeps the CPU step short


def _card_input():
    """What the chooser reads of a CUDA input (its ``is_cuda`` and its
    device's type, whose autocast state it asks for), on a machine
    without a card."""
    return types.SimpleNamespace(is_cuda=True, device=torch.device("cpu"))


@pytest.mark.parametrize("case,takes", [
    ("cpu", False), ("card_float32", True), ("card_bfloat16_autocast", False),
    ("card_shard", False), ("card_eval", False), ("card_float64", False)])
def test_plan_chooser(case, takes):
    """The plan engages for a CUDA input in training mode with float32
    weights, no autocast and no shard; the CPU, the bfloat16 step, a shard,
    eval mode and float64 weights keep the NCHW code."""
    model = SpecUNet2D().train(case != "card_eval")
    mel = torch.zeros(1, 128, FRAMES) if case == "cpu" else _card_input()
    if case == "card_shard":
        model.conv1_1.conv1[0].shard = object()
    if case == "card_float64":
        model.double()
    if case == "card_bfloat16_autocast":
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert model._train_plan(mel) is takes
    else:
        assert model._train_plan(mel) is takes


def _batch(dtype, seed=0, B=2):
    rng = np.random.default_rng(seed)
    b = {"mel": rng.uniform(0, 1.5, (B, 128, FRAMES)),
         "mask": rng.uniform(size=(B, FRAMES)) > 0.5,
         "spec": rng.uniform(0, 1, (B, 2, 128, FRAMES))}
    return {k: torch.from_numpy(np.asarray(v, np.float64)).to(dtype) for k, v in b.items()}


def _step(model, batch, forced: bool):
    """Loss, outputs, gradients and BatchNorm statistics of one training
    forward and backward, the plan forced or not; with the plan, the layout
    of every 4-D module output."""
    model = copy.deepcopy(model)
    if forced:
        model._train_plan = lambda mel: True
    layouts = []

    def hook(mod, args, out):
        if isinstance(out, torch.Tensor) and out.dim() == 4:
            layouts.append((type(mod).__name__, out.is_contiguous(memory_format=CL)))

    hooks = [m.register_forward_hook(hook) for m in model.modules()]
    gen = dropout_generator(0, 0, torch.device("cpu"))
    spec, mask = model(batch["mel"], gen)
    for h in hooks:
        h.remove()
    gen = dropout_generator(0, 0, torch.device("cpu"))
    loss, _ = loss_fn(model, batch, 0.0, gen)
    loss.backward()
    return {"loss": loss.detach(), "spec": spec.detach(), "mask": mask.detach(),
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "stats": {k: b for k, b in model.named_buffers() if "running" in k},
            "layouts": layouts}


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


def test_forced_plan_is_the_nchw_step_in_float64():
    """In float64 the plan (transposed image, transposed kernels,
    channels-last activations, the mask head's GEMM, the spec head's view)
    computes the NCHW step: loss, both heads, every gradient and every
    running statistic within 1e-10; every 4-D module output is
    channels-last, and the spec head comes back as (B, 2, 128, T)."""
    model = create_train_state(0).model.double()
    batch = _batch(torch.float64)
    want = _step(model, batch, forced=False)
    got = _step(model, batch, forced=True)
    assert got["spec"].shape == (2, 2, 128, FRAMES) and got["mask"].shape == (2, FRAMES)
    assert got["layouts"] and all(cl for _, cl in got["layouts"]), got["layouts"]
    assert not all(cl for _, cl in want["layouts"])
    for name in ("loss", "spec", "mask"):
        assert _rel(got[name], want[name]) <= 1e-10, name
    for kind in ("grads", "stats"):
        for k in want[kind]:
            assert _rel(got[kind][k], want[kind][k]) <= 1e-10, (kind, k)


def test_forced_plan_in_float32_is_within_float32_rounding():
    """The plan in float32 against the float64 step.  The CPU runs its
    convolutions through oneDNN's channels-last kernels, whose float32 sums
    round more coarsely than its NCHW ones, and more so on fewer threads.
    Forward (measured, error relative to the largest value: the spec head
    1.5e-5 on 1 thread, 6.9e-6 on 3, the NCHW step 2.8e-6): the loss and
    both heads within 5e-5.  Gradients (measured, error relative to each
    tensor's max |g|, worst tensor / whole-gradient relative L2: 1 thread
    1.07e-2 / 1.7e-3, 2 and 4 threads 1.5e-3 / 9.4e-5, 8 threads 2.0e-5 /
    5.0e-6; the NCHW step 5.5e-6 / 3.0e-6 at any count): each tensor
    within 3e-2 and the whole gradient within 5e-3.  The plan's own
    arithmetic is held exactly in float64
    (test_forced_plan_is_the_nchw_step_in_float64); the card's is held to
    the NCHW step in tests/test_torch_train_cuda.py.  Running statistics
    within 1e-5."""
    state = create_train_state(0)
    batch = _batch(torch.float32)
    plan = _step(state.model, batch, forced=True)
    truth = _step(copy.deepcopy(state.model).double(), _batch(torch.float64), forced=False)
    for name in ("loss", "spec", "mask"):
        assert _rel(plan[name], truth[name]) <= 5e-5, name
    worst = max((_rel(plan["grads"][k], g), k) for k, g in truth["grads"].items())
    assert worst[0] <= 3e-2, worst
    num = sum(((plan["grads"][k].double() - g) ** 2).sum() for k, g in truth["grads"].items())
    den = sum((g ** 2).sum() for g in truth["grads"].values())
    assert float(torch.sqrt(num / den)) <= 5e-3
    for k, s in truth["stats"].items():
        assert _rel(plan["stats"][k], s) <= 1e-5, k
