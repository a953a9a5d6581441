"""The port's mel frontend and its frame_mel kernel wrapper against the JAX
package (softspoken_tpu.ops.mel and ops.pallas_frame_mel in interpret mode).

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from softspoken_tpu.ops import mel as jmel
from softspoken_tpu.ops import pallas_frame_mel as jpfm
from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
from softspoken_tpu_torch.ops import frame_mel as fm
from softspoken_tpu_torch.ops import mel as tmel

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def buf_and_starts():
    # the fixture of tests/test_pallas_frame_mel.py: offsets exercise
    # start % 128 ∈ {0, mid, odd}
    rng = np.random.default_rng(7)
    buf = rng.standard_normal(66150 + 4 * 13230 + 300).astype(np.float32)
    starts = np.array([0, 174, 13230, 2 * 13230, 3 * 13230], np.int32)
    return buf, starts


def test_tables_equal_jax():
    """Same float64 construction, same float32 rounding: exactly equal."""
    np.testing.assert_array_equal(tmel.hann_periodic(512), jmel.hann_periodic(512))
    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    np.testing.assert_array_equal(tmel.dft_matrices(), jmel.dft_matrices())
    w, fb = fm.tables()
    jw, jfb = jpfm._tables()
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(fb, jfb)


def test_log_mel_windows_matches_jax_highest(buf_and_starts):
    """float32 chain on both sides; 1e-5 covers summation order."""
    buf, starts = buf_and_starts
    ref = jmel.log_mel_windows(jnp.asarray(buf), jnp.asarray(starts),
                               precision=jax.lax.Precision.HIGHEST)
    got = tmel.log_mel_windows(torch.from_numpy(buf), torch.from_numpy(starts))
    assert got.shape == (5, 128, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_frames_from_window_matches_jax(buf_and_starts):
    buf, _ = buf_and_starts
    w = buf[:66150]
    np.testing.assert_array_equal(
        tmel.frames_from_window(torch.from_numpy(w)).numpy(),
        np.asarray(jmel.frames_from_window(jnp.asarray(w))))


# (mode, tolerance for frames 1..255, tolerance for frame 0).  "highest":
# float32 both sides.  "high": both use the bf16x3 split; the JAX kernel
# also splits its input to 16 bits (_permute_split parts=2) and, on the CPU,
# runs frame 0 (_frame0) in float32, so frame 0 differs by the dropped
# bf16 terms (~1e-5).  "default": the JAX kernel rounds operands to bf16
# as the port does, but its frame 0 runs in float32 on the CPU while the
# port's runs in bf16, a one-pass bf16 error (~1e-2 after compression).
MODE_TOL = [("highest", 1e-5, 1e-5), ("high", 1e-5, 1e-4), ("default", 5e-3, 2e-2)]


@pytest.mark.parametrize("mode,tol_mid,tol_f0", MODE_TOL)
def test_fused_ref_matches_jax_kernel(buf_and_starts, mode, tol_mid, tol_f0):
    buf, starts = buf_and_starts
    ref = np.asarray(jpfm.log_mel_windows_fused(
        jnp.asarray(buf), jnp.asarray(starts), mode=mode, interpret=True))
    got = fm.log_mel_windows_fused_ref(torch.from_numpy(buf), torch.from_numpy(starts),
                                       mode).numpy()
    assert got.shape == ref.shape == (5, 128, 256)
    np.testing.assert_allclose(got[..., 1:], ref[..., 1:], atol=tol_mid, rtol=tol_mid)
    np.testing.assert_allclose(got[..., :1], ref[..., :1], atol=tol_f0, rtol=tol_f0)


def test_fused_ref_equals_full_chain_highest(buf_and_starts):
    """Truncating to 768 bins changes nothing but summation order."""
    buf, starts = (torch.from_numpy(a) for a in buf_and_starts)
    np.testing.assert_allclose(fm.log_mel_windows_fused_ref(buf, starts).numpy(),
                               tmel.log_mel_windows(buf, starts).numpy(), atol=2e-6)


def test_bf16_out_is_one_rounding(buf_and_starts):
    buf, starts = (torch.from_numpy(a) for a in buf_and_starts)
    f32 = fm.log_mel_windows_fused_ref(buf, starts, "default")
    b16 = fm.log_mel_windows_fused_ref(buf, starts, "default", torch.bfloat16)
    assert b16.dtype == torch.bfloat16
    assert torch.equal(b16, f32.to(torch.bfloat16))


def test_wrapper_on_cpu_runs_plain_version_and_counts_nothing(buf_and_starts):
    buf, starts = (torch.from_numpy(a) for a in buf_and_starts)
    before = KERNEL_LAUNCHES[fm.NAME]
    got = fm.log_mel_windows_fused(buf, starts, "high")
    assert KERNEL_LAUNCHES[fm.NAME] == before
    assert torch.equal(got, fm.log_mel_windows_fused_ref(buf, starts, "high"))


def test_wrapper_rejects_bad_arguments(buf_and_starts):
    buf, starts = (torch.from_numpy(a) for a in buf_and_starts)
    with pytest.raises(ValueError):
        fm.log_mel_windows_fused(buf, starts, "fastest")
    with pytest.raises(ValueError):
        fm.log_mel_windows_fused(buf, starts, out_dtype=torch.float16)
    with pytest.raises(ValueError):  # a window past the buffer's end
        fm.log_mel_windows_fused(buf, torch.tensor([buf.shape[0] - 66149], dtype=torch.int32))


@pytest.mark.parametrize("frames", [256, 259, 8])
def test_frame_index_table_equals_jax(frames):
    got = tmel.frame_index_table(frames)
    want = jmel.frame_index_table(frames)
    assert got.dtype == np.int32 and got.shape == (frames, 512)
    np.testing.assert_array_equal(got, want)


def test_frame_index_table_is_the_layout_frames_from_window_slices(buf_and_starts):
    buf, _ = buf_and_starts
    w = buf[:66150]
    frames = tmel.frames_from_window(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(frames, w[tmel.frame_index_table()])


def test_log_mel_single_matches_jax_highest(buf_and_starts):
    buf, _ = buf_and_starts
    w = buf[174: 174 + 66150]
    got = tmel.log_mel_single(w, device="cpu")
    want = jmel.log_mel_single(w, precision=jax.lax.Precision.HIGHEST)
    assert isinstance(got, np.ndarray) and got.shape == (128, 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ops_exports_the_jax_frontend_functions():
    import softspoken_tpu.ops as jops
    import softspoken_tpu_torch.ops as tops

    assert set(jops.__all__) <= set(tops.__all__)
    assert tops.frame_index_table is tmel.frame_index_table
    assert tops.log_mel_single is tmel.log_mel_single
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.log_mel_single(np.zeros(66150, np.float32))
