"""What the tensor-core kernels of the port read and compute, on the CPU.

The CUDA kernels (csrc/mel_core.cuh with the loaders frame_mel.cu and
dft_mel.cu) cannot run here, but everything around their arithmetic can:
the bf16 split of the operands, the multi-pass product built from it, the
hop-block identity by which K1 frames a window, the tiled and swizzled
table stream, and the name under which a library is built.  Inputs are made
with numpy from a seed; the whole chain is held against the JAX package's
kernel in interpret mode.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from softspoken_tpu.ops import pallas_frame_mel as jpfm
from softspoken_tpu_torch.ops import _build, mel_core
from softspoken_tpu_torch.ops import dft_mel as dm
from softspoken_tpu_torch.ops import frame_mel as fm
from softspoken_tpu_torch.ops import mel as melops

torch.set_num_threads(2)


def _frames(n=512, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n, 512)).astype(np.float32))


def _split_product(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """a @ b as the kernels' multi-pass bf16 product: part i of a meets part
    j of b when i + j < n (1, 3 or 6 passes for n = 1, 2, 3), every product
    exact, float32 sums.  n = 3 is the float32-class product."""
    pa, pb = melops.bf16_parts(a, n), melops.bf16_parts(b, n)
    return sum(pa[i] @ pb[j] for j in range(n) for i in range(n - j))


# ------------------------------------------------------------- the split ----
def test_three_parts_of_w_sum_back_exactly():
    w = torch.from_numpy(fm.tables()[0])
    parts = melops.bf16_parts(w, 3)
    np.testing.assert_array_equal((parts[0] + parts[1] + parts[2]).numpy(), w.numpy())
    for p in parts:  # each part is a bf16 value
        assert torch.equal(p, p.to(torch.bfloat16).to(torch.float32))


def test_three_parts_of_fb_and_of_a_frame_sum_back_exactly():
    for x in (torch.from_numpy(fm.tables()[1]), _frames(64)):
        parts = melops.bf16_parts(x, 3)
        np.testing.assert_array_equal((parts[0] + parts[1] + parts[2]).numpy(), x.numpy())


@pytest.mark.parametrize("n,rel", [(1, 2.0 ** -8), (2, 2.0 ** -16)])
def test_fewer_parts_reach_as_far_as_their_bits(n, rel):
    """n parts hold 8·n mantissa bits: what is left over is below half a
    unit in the last of them."""
    x = _frames(64)
    rest = x - sum(melops.bf16_parts(x, n))
    assert float((rest.abs() / x.abs().clamp_min(1e-30)).max()) <= rel


def test_high_mode_is_the_two_part_split():
    """``dft_product("high")`` = hi·hi + hi·lo + lo·hi of the two-part split,
    which is also the two-part ``_split_product`` up to the order of its sums."""
    x, w = _frames(32), torch.from_numpy(fm.tables()[0])
    got = melops.dft_product(x, w, "high")
    (x_hi, x_lo), (w_hi, w_lo) = melops.bf16_parts(x, 2), melops.bf16_parts(w, 2)
    assert torch.equal(x_hi, x.to(torch.bfloat16).float())
    assert torch.equal(x_lo, (x - x_hi).to(torch.bfloat16).float())
    assert torch.equal(got, x_hi @ w_hi + x_hi @ w_lo + x_lo @ w_hi)
    np.testing.assert_allclose(_split_product(x, w, 2).numpy(), got.numpy(), atol=1e-5)


def test_six_pass_product_is_float32_class():
    """The six products of weight >= 2^-16 of the three-part split against
    the float32 product: <= 2e-6 of the product's largest |value| (the
    dropped terms weigh 2^-24; measured 9.7e-7 on these 512 frames)."""
    x, w = _frames(512), torch.from_numpy(fm.tables()[0])
    ref = x @ w
    got = _split_product(x, w, 3)
    assert float((got - ref).abs().max()) <= 2e-6 * float(ref.abs().max())
    # one pass is far from it, three passes in between
    e1 = float((_split_product(x, w, 1) - ref).abs().max())
    e2 = float((_split_product(x, w, 2) - ref).abs().max())
    assert e1 > 100 * e2 > 100 * float((got - ref).abs().max())


def _kernel_chain(buf, starts, n_parts):
    """The kernels' arithmetic with plain tensors: split DFT product, power,
    six-pass mel product, compression."""
    w, fb = (torch.from_numpy(t) for t in fm.tables())
    frames = melops.gather_frames(buf, starts)
    proj = _split_product(frames, w, n_parts)
    power = proj[..., :768] ** 2 + proj[..., 768:] ** 2
    mel = _split_product(power, fb, 3)
    return torch.sqrt(torch.log10(mel + 1.0)).transpose(-1, -2)


def test_six_pass_chain_matches_jax_kernel_highest():
    """The whole chain as the kernels compute it ("highest" and K2) against
    the JAX kernel in interpret mode, at the tolerance the plain version is
    held to (test_torch_mel.py: 1e-5)."""
    rng = np.random.default_rng(7)
    buf = rng.standard_normal(66150 + 2 * 13230 + 300).astype(np.float32)
    starts = np.array([0, 174, 2 * 13230], np.int32)
    ref = np.asarray(jpfm.log_mel_windows_fused(
        jnp.asarray(buf), jnp.asarray(starts), mode="highest", interpret=True))
    got = _kernel_chain(torch.from_numpy(buf), torch.from_numpy(starts), 3).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode,parts,tol", [("default", 1, 2e-6), ("high", 2, 2e-6)])
def test_split_chain_matches_plain_version(mode, parts, tol):
    """In the bf16 modes the kernel's chain and the plain version multiply
    the same rounded operands; the six-pass mel product is float32 class."""
    rng = np.random.default_rng(5)
    buf = torch.from_numpy(rng.standard_normal(66150 + 300).astype(np.float32))
    starts = torch.tensor([0, 299], dtype=torch.int32)
    np.testing.assert_allclose(_kernel_chain(buf, starts, parts).numpy(),
                               fm.log_mel_windows_fused_ref(buf, starts, mode).numpy(), atol=tol)


# -------------------------------------------------- the hop-block identity ----
def _hop_blocks(w: torch.Tensor) -> torch.Tensor:
    """(66150,) window → (257, 256): Blk[0] = reverse(w[1:257]),
    Blk[1 + i] = w[256·i : 256·(i + 1)], as K1's loader stages them."""
    return torch.cat([w[1:257].flip(0)[None], w[: 256 * 256].reshape(256, 256)])


@pytest.mark.parametrize("where", ["start0", "odd", "flush_with_the_end"])
def test_hop_block_identity(where):
    """frame f = Blk[f] ‖ Blk[f + 1] for every f, the reflected frame 0
    included, so proj[f] = Blk[f] @ W[:256] + Blk[f + 1] @ W[256:]."""
    rng = np.random.default_rng(11)
    buf = torch.from_numpy(rng.standard_normal(66150 + 1001).astype(np.float32))
    s = {"start0": 0, "odd": 333, "flush_with_the_end": buf.shape[0] - 66150}[where]
    win = buf[s: s + 66150]
    blk = _hop_blocks(win)
    frames = melops.frames_from_window(win)
    np.testing.assert_array_equal(torch.cat([blk[:-1], blk[1:]], dim=1).numpy(), frames.numpy())
    assert torch.equal(frames, melops.gather_frames(buf, torch.tensor([s]))[0])
    w = torch.from_numpy(fm.tables()[0]).double()
    proj = blk[:-1].double() @ w[:256] + blk[1:].double() @ w[256:]
    np.testing.assert_allclose(proj.numpy(), (frames.double() @ w).numpy(), atol=1e-12)


# ------------------------------------------------------- the table stream ----
@pytest.mark.parametrize("mode", ["highest", "high", "default"])
def test_frame_mel_tables_untile_back(mode):
    w, fb = fm.tables()
    n = fm._MODE_PARTS[mode]
    stream = fm._device_tables(torch.device("cpu"), mode)
    assert stream.dtype == torch.bfloat16 and stream.is_contiguous()
    assert stream.shape == (12, 8 * n + 3, 128, 64)
    w_parts, fb_parts = mel_core.untile(stream, n)
    for got, want in zip(w_parts, melops.bf16_parts(torch.from_numpy(w), n)):
        np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(fb_parts[0] + fb_parts[1] + fb_parts[2], fb)
    if n == 3:
        np.testing.assert_array_equal(w_parts[0] + w_parts[1] + w_parts[2], w)


def test_dft_mel_tables_are_the_three_part_stream():
    stream = dm._device_tables(torch.device("cpu"))
    assert torch.equal(stream, fm._device_tables(torch.device("cpu"), "highest"))
    w_parts, fb_parts = mel_core.untile(stream, 3)
    w, fb = dm.tables()
    np.testing.assert_array_equal(w_parts[0] + w_parts[1] + w_parts[2], w)
    np.testing.assert_array_equal(fb_parts[0] + fb_parts[1] + fb_parts[2], fb)


def test_tile_layout_is_the_128_byte_swizzle():
    """Row n of a tile is 128 bytes; its 16-byte group c lies at group
    c ^ (n % 8): the layout the wgmma descriptor in mel_core.cuh names."""
    stream = mel_core.stream_tables(1)
    w = torch.from_numpy(fm.tables()[0]).to(torch.bfloat16)
    s, kc = 7, 3
    tile = stream[s, kc].reshape(-1)  # part 0 of k-chunk kc: 8192 bf16 values
    for n, c in [(0, 0), (1, 0), (5, 2), (77, 7), (127, 3)]:
        col = (0 if n < 64 else 768) + 64 * s + n % 64
        want = w[64 * kc + 8 * c: 64 * kc + 8 * c + 8, col]
        at = n * 64 + 8 * (c ^ (n % 8))
        assert torch.equal(tile[at: at + 8], want)
    fb = melops.bf16_parts(torch.from_numpy(fm.tables()[1]), 3)[1].to(torch.bfloat16)
    tile = stream[s, 8 * 1 + 1].reshape(-1)  # fb part 1 of the slice
    assert torch.equal(tile[9 * 64 + 8 * (4 ^ 1): 9 * 64 + 8 * (4 ^ 1) + 8],
                       fb[64 * s + 32: 64 * s + 40, 9])
    assert torch.equal(mel_core._swizzle(mel_core._swizzle(stream)), stream)


def test_stream_tables_rejects_other_part_counts():
    with pytest.raises(ValueError):
        mel_core.stream_tables(4)


# ---------------------------------------------------------------- the build ----
def test_library_name_changes_with_a_header(tmp_path, monkeypatch):
    """A library is named after its source, every header beside it and the
    flags, so that an edited shared header never loads a stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    names = {k: _build.lib_path(k) for k in ("frame_mel", "dft_mel")}
    assert names["frame_mel"] != names["dft_mel"]
    assert all(os.path.dirname(v) == str(tmp_path / "build") for v in names.values())
    assert names == {k: _build.lib_path(k) for k in names}  # stable
    with open(csrc / "mel_core.cuh", "ab") as f:
        f.write(b"\n// edited\n")
    after_header = {k: _build.lib_path(k) for k in names}
    assert all(after_header[k] != names[k] for k in names)
    with open(csrc / "frame_mel.cu", "ab") as f:
        f.write(b"\n// edited\n")
    after_source = {k: _build.lib_path(k) for k in names}
    assert after_source["frame_mel"] != after_header["frame_mel"]
    assert after_source["dft_mel"] == after_header["dft_mel"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.lib_path("dft_mel") != after_source["dft_mel"]
