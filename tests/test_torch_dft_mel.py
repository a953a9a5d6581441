"""K2, the DFT→mel frontend over gathered frames (``mel_kernel="pallas"``):
the port's plain version on the CPU against the JAX package's Pallas kernel
in interpret mode, at the tolerances of tests/test_pallas_mel.py (rtol 2e-4,
atol 1e-5: float32 on both sides, other summation orders).  The CUDA kernel
itself is held to this plain version on the card (test_torch_cuda.py;
chip_smoke.py's kernel table)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softspoken_tpu.ops import mel as jmel
from softspoken_tpu.ops import pallas_mel as jpm
from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
from softspoken_tpu_torch.ops import dft_mel as dm
from softspoken_tpu_torch.ops import mel as melops

RTOL, ATOL = 2e-4, 1e-5


def _jax_windows(wave, starts):
    return np.asarray(jpm.log_mel_windows_pallas(
        jnp.asarray(wave), jnp.asarray(starts, jnp.int32), interpret=True))


@pytest.mark.parametrize("n_windows,starts", [
    (2, [0, 13230]),                             # tests/test_pallas_mel.py's fixture
    (3, [0, 174, 2 * 13230 + 31, 66150 * 2]),    # a 4-window batch, odd offsets, flush end
], ids=["pallas-fixture", "batch-of-4"])
def test_plain_matches_jax_pallas(n_windows, starts):
    rng = np.random.default_rng(0)
    wave = rng.uniform(-0.5, 0.5, jmel.WINDOW_SAMPLES * n_windows).astype(np.float32)
    before = sum(KERNEL_LAUNCHES.values())
    got = dm.log_mel_windows_dft(torch.from_numpy(wave),
                                 torch.tensor(starts, dtype=torch.int32)).numpy()
    assert sum(KERNEL_LAUNCHES.values()) == before  # the CPU runs no kernel
    want = _jax_windows(wave, starts)
    assert got.shape == want.shape == (len(starts), 128, 256)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_frames_entry_point_matches_jax_at_other_frame_counts():
    """(B, F) = (4, 64): 256 rows, F not the window's 256 frames."""
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((4, 64, 512)).astype(np.float32)
    got = dm.log_mel_from_frames_dft(torch.from_numpy(frames)).numpy()
    want = np.asarray(jpm.log_mel_from_frames_pallas(jnp.asarray(frames), interpret=True))
    assert got.shape == want.shape == (4, 128, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_matches_the_port_mel_chain():
    """Bins 768-1024 weigh exactly 0, so K2's plain version and the 1025-bin
    chain sum the same nonzero terms; only the order differs."""
    rng = np.random.default_rng(2)
    wave = torch.from_numpy(rng.uniform(-0.5, 0.5, 3 * 66150).astype(np.float32))
    starts = torch.tensor([0, 66150, 2 * 66150], dtype=torch.int32)
    got = dm.log_mel_windows_dft(wave, starts)
    want = melops.log_mel_windows(wave, starts, "highest")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 100, 512), (3, 256, 511)], ids=["rows-not-256", "width"])
def test_wrong_shapes_raise_like_the_jax_kernel(shape):
    frames = torch.zeros(shape)
    with pytest.raises(ValueError):
        dm.log_mel_from_frames_dft(frames)
    if shape[-1] == 512:  # the JAX wrapper's own check, same rule
        with pytest.raises(ValueError):
            jpm.log_mel_from_frames_pallas(jnp.zeros(shape, jnp.float32), interpret=True)


def test_a_device_without_a_kernel_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        dm.log_mel_from_frames_dft(torch.zeros((1, 256, 512), device="meta"))


def test_truncation_is_exact():
    """The 768-bin tables drop only bins whose mel weight is exactly 0 and
    agree with the JAX kernel's 1024-bin tables on the bins they keep;
    cutting into the filterbank's support raises."""
    w, fb = dm.tables()
    assert w.shape == (512, 1536) and fb.shape == (768, 128)
    jw, jfb = jpm._tables()
    np.testing.assert_array_equal(w[:, :768], jw[:, :768])
    np.testing.assert_array_equal(w[:, 768:], jw[:, 1024:1024 + 768])
    np.testing.assert_array_equal(fb, jfb[:768])
    assert np.all(jfb[768:] == 0.0)
    with pytest.raises(ValueError, match="support exceeds"):
        melops.truncated_tables(743)  # bin 743 still carries weight
    assert melops.truncated_tables(744)[1].shape == (744, 128)


def test_kernel_layout_of_w_is_a_permutation():
    """The kernel reads W as 16 KiB bf16 tiles, per 64-bin slice [re 64 | im
    64] columns by 64 samples, three parts; untiled, the parts sum back to
    exactly W's columns in that order."""
    from softspoken_tpu_torch.ops import mel_core

    w, _ = dm.tables()
    stream = dm._device_tables(torch.device("cpu"))
    assert stream.dtype == torch.bfloat16 and stream.shape == (12, 27, 128, 64)
    w_parts, _fb = mel_core.untile(stream, 3)
    np.testing.assert_array_equal(w_parts[0] + w_parts[1] + w_parts[2], w)
    # slice 5, k-chunk 2, part 0 is tile 2*3 + 0; un-swizzled row n holds bin 64*5 + n
    tile = mel_core._swizzle(stream[5, 6]).float().numpy()
    np.testing.assert_array_equal(tile[:64], w_parts[0][128:192, 320:384].T)
    np.testing.assert_array_equal(tile[64:], w_parts[0][128:192, 768 + 320:768 + 384].T)
