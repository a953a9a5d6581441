"""4-bit IMA-ADPCM codec of the fused engine's adpcm4 upload wire.

Counterpart of the JAX package's ``ops/adpcm.py``.  Wire format (transport
only, not the RIFF block layout): blocks of ``SPB`` samples, each a
``HDR_BYTES`` header

    [0:2] int16 LE  first sample (the predictor's seed)
    [2]   uint8    initial step index 0..88, chosen per block from the
                   block's own mean |delta|, so blocks encode and decode
                   independently
    [3]   uint8    reserved (0)

then ``SPB // 2`` data bytes: ``SPB - 1`` nibbles, low nibble first (the
last nibble is padding), each decoded as the WAV IMA tables decode it.
About 0.52 bytes per sample against mu-law's 1.0.

The host encodes (``encode_i16``: the native ``ss_ima_encode_i16`` loop of
``io/native.py`` when it is built, else numpy; the same bytes).  The
device decodes: ``decode_device`` launches the hand-written CUDA kernel
``csrc/adpcm_decode.cu`` (K3) for a CUDA tensor and runs its plain version
``decode_device_ref`` for a CPU tensor; there is no fallback between the
two.  ``decode_np`` is the numpy reference.

K3 replaces the JAX package's ``ops/adpcm.py:175`` ``decode_device``, a
``lax.scan`` of 255 dependent steps.  On an H100 its bound is the bytes
(the wire read once, 4 bytes a sample written once: 3.4 us for a default
chunk of the 16 kHz wire), not its integer work, so the kernel must not
walk the 255-step chain one thread per block.  Both updates of a step are
clamped adds, x -> min(max(x + a, lo), hi), and those compose exactly into
one clamped add; the kernel runs each chain (step index, then predictor)
as a 32-lane warp scan of such maps, one warp per wire block, with
coalesced 32-bit loads and aligned float4 stores, bit-equal to the loop.
``tests/test_torch_adpcm_scan.py`` holds a numpy model of that
decomposition to the JAX scan on the CPU.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _build, count_launch

SPB = 256                 # samples per block (16 ms at the 16 kHz wire)
HDR_BYTES = 4
BLOCK_BYTES = HDR_BYTES + SPB // 2
BYTES_PER_SAMPLE = BLOCK_BYTES / SPB
NAME = "adpcm_decode"

# the WAV IMA tables (io/wavio.py's _IMA_INDEX/_IMA_STEPS)
INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8,
                        -1, -1, -1, -1, 2, 4, 6, 8], np.int64)
STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int64)


def n_blocks(n_samples: int) -> int:
    return -(-int(n_samples) // SPB)


def wire_bytes(n_samples: int) -> int:
    """Encoded size for ``n_samples`` int16 samples (zero-padded tail)."""
    return n_blocks(n_samples) * BLOCK_BYTES


def encode_i16(x: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """int16 PCM → ADPCM wire bytes (uint8, length ``wire_bytes(len(x))``).

    Vectorized across blocks: the SPB-1 per-sample loop runs numpy ops on
    (nb,) state vectors, unless the native loop is built.
    """
    if x.dtype != np.int16:
        raise TypeError(f"encode_i16 requires int16 PCM, got {x.dtype}")
    n = len(x)
    nb = n_blocks(n)
    want = nb * BLOCK_BYTES
    if out is None:
        out = np.zeros(want, np.uint8)
    elif out.dtype != np.uint8 or len(out) != want or not out.flags.c_contiguous:
        raise ValueError(f"out must be contiguous uint8[{want}]")

    from ..io.native import ima_encode_i16 as _native

    q = _native(x, out, SPB)
    if q is not None:
        return q

    if nb == 0:
        return out
    xb = np.zeros((nb, SPB), np.int64)
    xb.reshape(-1)[:n] = x
    hdr_pred = xb[:, 0]
    # per-block initial index: first step >= the block's mean |delta|
    mean_d = np.abs(np.diff(xb, axis=1)).mean(axis=1)
    idx = np.clip(np.searchsorted(STEP_TABLE, mean_d), 0, 88).astype(np.int64)
    hdr_idx = idx.copy()

    pred = hdr_pred.copy()
    nibbles = np.zeros((nb, SPB - 1), np.uint8)
    for k in range(SPB - 1):
        step = STEP_TABLE[idx]
        delta = xb[:, k + 1] - pred
        sign = delta < 0
        mag = np.abs(delta)
        nib = np.where(sign, 8, 0).astype(np.int64)
        temp = step.copy()
        ge = mag >= temp
        nib |= np.where(ge, 4, 0)
        mag = mag - np.where(ge, temp, 0)
        temp >>= 1
        ge = mag >= temp
        nib |= np.where(ge, 2, 0)
        mag = mag - np.where(ge, temp, 0)
        temp >>= 1
        nib |= np.where(mag >= temp, 1, 0)
        # reconstruct exactly as the decoder does, so the states agree
        diff = (step >> 3) + np.where(nib & 1, step >> 2, 0) \
            + np.where(nib & 2, step >> 1, 0) + np.where(nib & 4, step, 0)
        pred = np.clip(np.where(nib & 8, pred - diff, pred + diff),
                       -32768, 32767)
        idx = np.clip(idx + INDEX_TABLE[nib], 0, 88)
        nibbles[:, k] = nib

    blocks = out.reshape(nb, BLOCK_BYTES)
    blocks[:, 0:2] = hdr_pred.astype(np.int16)[:, None].view(np.uint8)
    blocks[:, 2] = hdr_idx.astype(np.uint8)
    blocks[:, 3] = 0
    padded = np.zeros((nb, SPB), np.uint8)  # SPB-1 nibbles + 1 pad
    padded[:, : SPB - 1] = nibbles
    data = (padded[:, 0::2] | (padded[:, 1::2] << 4)).astype(np.uint8)
    blocks[:, HDR_BYTES:] = data
    return out


def decode_np(wire: np.ndarray, n_samples: int) -> np.ndarray:
    """Reference numpy decode → int16[n_samples].  As the JAX one, it does
    not clip the header's step index (an index above 88 raises)."""
    nb = len(wire) // BLOCK_BYTES
    blocks = np.asarray(wire, np.uint8).reshape(nb, BLOCK_BYTES)
    pred = blocks[:, 0:2].copy().view("<i2").reshape(nb).astype(np.int64)
    idx = blocks[:, 2].astype(np.int64)
    data = blocks[:, HDR_BYTES:]
    nib = np.empty((nb, SPB), np.uint8)
    nib[:, 0::2] = data & 0x0F
    nib[:, 1::2] = data >> 4
    out = np.empty((nb, SPB), np.int16)
    out[:, 0] = pred
    for k in range(SPB - 1):
        n = nib[:, k].astype(np.int64)
        step = STEP_TABLE[idx]
        diff = (step >> 3) + np.where(n & 1, step >> 2, 0) \
            + np.where(n & 2, step >> 1, 0) + np.where(n & 4, step, 0)
        pred = np.clip(np.where(n & 8, pred - diff, pred + diff),
                       -32768, 32767)
        idx = np.clip(idx + INDEX_TABLE[n], 0, 88)
        out[:, k + 1] = pred
    return out.reshape(-1)[:n_samples]


def _check_wire(wire: torch.Tensor, n_samples: int) -> int:
    if wire.dtype != torch.uint8 or wire.dim() != 1:
        raise ValueError("wire must be a 1-D uint8 tensor")
    if wire.shape[0] % BLOCK_BYTES:
        raise ValueError(f"wire length {wire.shape[0]} is no multiple of {BLOCK_BYTES}")
    nb = wire.shape[0] // BLOCK_BYTES
    if not 0 <= n_samples <= nb * SPB:
        raise ValueError(f"n_samples={n_samples} outside [0, {nb * SPB}]")
    return nb


def decode_device_ref(wire: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the JAX ``decode_device`` scan
    as a loop of SPB-1 steps over (nb,) int32 state, the header's step index
    clipped to 0..88 → float32[n_samples] in [-1, 1]."""
    nb = _check_wire(wire, n_samples)
    blocks = wire.reshape(nb, BLOCK_BYTES).to(torch.int32)
    pred = ((blocks[:, 0] | (blocks[:, 1] << 8)) + 32768) % 65536 - 32768  # int16 LE
    idx = torch.clamp(blocks[:, 2], 0, 88)
    data = blocks[:, HDR_BYTES:]
    nib = torch.stack([data & 0x0F, data >> 4], dim=-1).reshape(nb, SPB)  # low first
    steps = torch.from_numpy(STEP_TABLE.astype(np.int32)).to(wire.device)
    index_tab = torch.from_numpy(INDEX_TABLE.astype(np.int32)).to(wire.device)
    out = torch.empty((SPB, nb), dtype=torch.int32, device=wire.device)
    out[0] = pred
    for k in range(SPB - 1):
        n = nib[:, k]
        step = steps[idx.long()]
        diff = (step >> 3) + torch.where((n & 1) != 0, step >> 2, 0) \
            + torch.where((n & 2) != 0, step >> 1, 0) + torch.where((n & 4) != 0, step, 0)
        pred = torch.clamp(torch.where((n & 8) != 0, pred - diff, pred + diff), -32768, 32767)
        idx = torch.clamp(idx + index_tab[n.long()], 0, 88)
        out[k + 1] = pred
    flat = out.T.reshape(nb * SPB)[:n_samples]
    return flat.to(torch.float32) * (1.0 / 32768.0)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    fn = lib.adpcm_decode_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, ctypes.c_longlong, P, ctypes.c_longlong, P]
    fn.restype = ctypes.c_int
    return lib


def decode_device(wire: torch.Tensor, n_samples: int) -> torch.Tensor:
    """ADPCM wire bytes → float32[n_samples] in [-1, 1] on ``wire``'s device:
    the kernel K3 on the card, ``decode_device_ref`` on the CPU."""
    if wire.device.type == "cpu":
        return decode_device_ref(wire, n_samples)
    if wire.device.type != "cuda":
        raise ValueError(f"unsupported device {wire.device}")
    nb = _check_wire(wire, n_samples)
    if not wire.is_contiguous() or wire.data_ptr() % 4:
        raise ValueError("wire must be contiguous and 4-byte aligned")
    out = torch.empty(n_samples, dtype=torch.float32, device=wire.device)
    if n_samples == 0:
        return out
    with torch.cuda.device(wire.device):  # the kernel runs on the current device
        rc = _lib().adpcm_decode_launch(wire.data_ptr(), nb, out.data_ptr(), n_samples,
                                        torch.cuda.current_stream(wire.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adpcm_decode kernel launch failed: cudaError {rc}")
    count_launch(NAME)
    return out
