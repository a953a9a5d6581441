"""Tests of the port that need the CUDA card (the kernels have no CPU mode).

They import neither JAX nor the JAX package, so they also run on a machine
with only PyTorch; there, skip the repo's conftest (which sets up JAX):

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each test decides inside itself whether a card is present and skips
without one.
"""

import numpy as np
import pytest
import torch

from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
from softspoken_tpu_torch.ops import frame_mel as fm

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _buf_and_starts():
    # the fixture of tests/test_pallas_frame_mel.py, plus a window flush
    # with the buffer's end
    rng = np.random.default_rng(7)
    buf = rng.standard_normal(66150 + 4 * 13230 + 300).astype(np.float32)
    starts = np.array([0, 174, 13230, 2 * 13230, 3 * 13230, buf.size - 66150], np.int32)
    return torch.from_numpy(buf).cuda(), torch.from_numpy(starts).cuda()


@pytest.mark.parametrize("mode", ["highest", "high", "default"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_frame_mel_kernel_matches_plain_version(mode, out_dtype):
    """Same operands, same rounding: only the summation order differs
    (1e-4 at float32 out; one bf16 ulp below 4, 2**-6, at bf16 out)."""
    _need_card()
    buf, starts = _buf_and_starts()
    before = KERNEL_LAUNCHES[fm.NAME]
    got = fm.log_mel_windows_fused(buf, starts, mode, out_dtype)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES[fm.NAME] == before + 1
    assert got.dtype == out_dtype and got.shape == (6, 128, 256)
    ref = fm.log_mel_windows_fused_ref(buf, starts, mode, out_dtype)
    tol = 1e-4 if out_dtype == torch.float32 else 2.0 ** -6
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(), atol=tol)


def test_frame_mel_kernel_marks_out_of_range_windows():
    _need_card()
    buf, _ = _buf_and_starts()
    bad = torch.tensor([buf.shape[0] - 66149, -1], dtype=torch.int32, device="cuda")
    assert torch.isnan(fm.log_mel_windows_fused(buf, bad)).all()


def test_frame_mel_wrapper_rejects_wrong_layouts():
    _need_card()
    buf, starts = _buf_and_starts()
    with pytest.raises(ValueError):
        fm.log_mel_windows_fused(buf.double(), starts)
    with pytest.raises(ValueError):
        fm.log_mel_windows_fused(buf, starts.long())
    with pytest.raises(ValueError):
        fm.log_mel_windows_fused(buf, starts.cpu())
