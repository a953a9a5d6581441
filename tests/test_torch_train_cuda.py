"""The float32 training step's channels-last plan on the card
(``models/unet.py``, ``SpecUNet2D._train_plan``): the step against the
same step forced to NCHW, no cuDNN layout copy in a profiled step, and a
``.pth`` written after channels-last steps in ``Detector``.

No JAX here; on a machine with only PyTorch:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_cuda.py

Each test decides inside itself whether a card is present and skips
without one.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from softspoken_tpu_torch.models.unet import SpecUNet2D
from torch_cuda_helpers import field_wav, need_card

pytestmark = pytest.mark.cuda

LAYOUT_COPIES = ("nchwToNhwc", "nhwcToNchw")


def _batches(n, B=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"mel": rng.uniform(0, 1.5, (B, 128, 256)), "mask": rng.uniform(size=(B, 256)) > 0.5,
             "spec": rng.uniform(0, 1, (B, 2, 128, 256))}
        out.append({k: torch.from_numpy(np.asarray(v, np.float32)).cuda() for k, v in b.items()})
    return out


def _three_steps(monkeypatch, nchw: bool, batches):
    """Three float32 AdamW steps from seed 0's weights on the card (TF32
    convolutions, as the step runs by default): each step's loss, the
    first step's gradients, the weights after the third.  ``nchw`` forces
    the NCHW code."""
    from softspoken_tpu_torch.train.loop import create_train_state, train_step

    with monkeypatch.context() as m:
        if nchw:
            m.setattr(SpecUNet2D, "_train_plan", lambda self, mel: False)
        state = create_train_state(seed=0, device="cuda")
        losses, grads = [], None
        for batch in batches:
            losses.append(float(train_step(state, batch)["loss"]))
            if grads is None:
                grads = {k: p.grad.double().clone() for k, p in state.model.named_parameters()}
        weights = {k: p.detach().double().clone() for k, p in state.model.named_parameters()}
    return losses, grads, weights


def _leaf_gaps(got, want, leaves):
    """Each leaf's | ||got|| - ||want|| | over max(||want||, the median
    leaf's norm), as the train cell's check in the benchmark."""
    norms = {k: float(want[k].norm()) for k in leaves}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].norm()) - norms[k]) / max(norms[k], med) for k in leaves}


def test_channels_last_step_matches_the_nchw_step(monkeypatch):
    """A float32 B = 16 step in channels-last against the same step forced
    to NCHW, from the same weights, batches and dropout generator, within
    the train cell's limits on TF32 steps (its check of the program
    against its float32 reference, ``fit_synthetic.py``'s ``check``,
    with the same leaves and measures): the first step's loss within
    1.3e-4 relative; the first step's gradient norms, leaf by leaf, at most
    0.01 apart at the median leaf; the norms of the weights' change after
    three AdamW steps at most 0.2 apart at the worst leaf.  (Later losses
    are not held: AdamW's first steps move each weight by about the
    learning rate whatever its gradient's size, so rounding that flips a
    small gradient's sign moves the two runs apart.)"""
    need_card()
    from softspoken_tpu_torch.train.loop import create_train_state

    batches = _batches(3)
    cl = _three_steps(monkeypatch, False, batches)
    nchw = _three_steps(monkeypatch, True, batches)
    init = {k: p.detach().double() for k, p in create_train_state(seed=0).model.named_parameters()}
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(cl[0], nchw[0])]
    med = float(np.median([float(g.norm()) for g in nchw[1].values()]))
    # a leaf whose gradient is nought to rounding moves under AdamW by
    # round-off alone: left out, as the check leaves it out
    leaves = [k for k, g in nchw[1].items() if float(g.norm()) >= 1e-3 * med]
    grad = _leaf_gaps(cl[1], nchw[1], leaves)
    moved = {k: v - init[k].cuda() for k, v in nchw[2].items()}
    change = _leaf_gaps({k: v - init[k].cuda() for k, v in cl[2].items()}, moved, leaves)
    print(f"loss rel {loss_rel}; {len(leaves)} leaves; grad1 median leaf "
          f"{np.median(list(grad.values())):.3g} worst {max(grad.values()):.3g}; change3 "
          f"median leaf {np.median(list(change.values())):.3g} worst {max(change.values()):.3g}")
    assert loss_rel[0] <= 1.3e-4, loss_rel
    assert float(np.median(list(grad.values()))) <= 0.01
    assert max(change.values()) <= 0.2


def _profiled_kernels(run):
    """The names of the CUDA kernels one call of ``run`` launches, after one
    call outside the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _step_kernels(monkeypatch, nchw: bool):
    from softspoken_tpu_torch.train.loop import create_train_state, train_step

    batch = _batches(1)[0]
    with monkeypatch.context() as m:
        if nchw:
            m.setattr(SpecUNet2D, "_train_plan", lambda self, mel: False)
        state = create_train_state(seed=0, device="cuda")
        return _profiled_kernels(lambda: train_step(state, batch)), state


def _copies(names):
    return Counter(n for n in names if any(c in n for c in LAYOUT_COPIES))


def test_profiled_step_has_no_layout_copy(monkeypatch):
    """A profiled float32 step runs no cuDNN layout copy
    (``nchwToNhwcKernel`` / ``nhwcToNchwKernel``) on its 2-D path and runs
    the channels-last BatchNorm kernels: every copy it launches is one that
    the 1-D mask block (which stays NCL, as cuDNN takes a 1-D convolution
    as a 2-D one of height 1) launches alone on the step's (B, 4, 256)
    input, forward and backward.  The same step forced to NCHW shows the
    copies (the profile can see them)."""
    need_card()
    names, state = _step_kernels(monkeypatch, nchw=False)
    assert names, "the profiler recorded no CUDA kernel"
    assert any("bn_train" in n and "nhwc" in n for n in names)
    block = state.model.mask_output_conv
    flat = torch.randn(16, 4, 256, device="cuda", requires_grad=True)
    alone = _profiled_kernels(lambda: block(flat).sum().backward())
    assert not _copies(names) - _copies(alone), (_copies(names), _copies(alone))
    forced, _ = _step_kernels(monkeypatch, nchw=True)
    assert _copies(forced) - _copies(alone)
    assert not any("bn_train" in n and "nhwc" in n for n in forced)


def test_pth_after_channels_last_steps_detects_as_written_from_nchw(tmp_path):
    """Two channels-last float32 steps on the card leave every tensor of the
    state (parameters, statistics) contiguous, as AdamW's moments; the
    ``.pth`` written from it holds the values of the same weights copied to
    NCHW on the host and saved, and ``Detector`` detects exactly the same
    on both files."""
    need_card()
    from softspoken_tpu_torch.ckpt import load_pth
    from softspoken_tpu_torch.ckpt.convert import save_pth
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
    from softspoken_tpu_torch.train.loop import create_train_state, train_step

    state = create_train_state(seed=0, device="cuda")
    before = KERNEL_LAUNCHES["bn_train_fwd_nhwc"]
    for batch in _batches(2, B=4):
        train_step(state, batch)
    assert KERNEL_LAUNCHES["bn_train_fwd_nhwc"] - before == 2 * 33
    sd = state.model.state_dict()
    assert all(v.is_contiguous() for v in sd.values())
    assert all(t.is_contiguous() for st in state.optimizer.state.values() for t in st.values()
               if torch.is_tensor(t))
    cl_pth, nchw_pth = str(tmp_path / "cl.pth"), str(tmp_path / "nchw.pth")
    save_pth(cl_pth, sd, epoch=state.step)
    save_pth(nchw_pth, {k: v.detach().cpu().contiguous() for k, v in sd.items()},
             epoch=state.step)
    a, b = load_pth(cl_pth)[0], load_pth(nchw_pth)[0]
    assert a.keys() == b.keys()
    for k in a:
        ta, tb = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert ta.is_contiguous() and torch.equal(ta, tb), k
    wav = field_wav(str(tmp_path / "x.wav"), 30.0, 32000, seed=4)
    res = [Detector(checkpoint_path=p).detect_file_streaming(wav) for p in (cl_pth, nchw_pth)]
    assert res[0].num_windows == res[1].num_windows > 0
    np.testing.assert_array_equal(res[0].avg_values, res[1].avg_values)
    assert res[0].intervals == res[1].intervals
