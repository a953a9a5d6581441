"""The decomposition of the CUDA kernel K3 (``softspoken_tpu_torch/csrc/
adpcm_decode.cu``) as a numpy model, held bit-equal to the JAX package's
``ops/adpcm.py::decode_device`` (its ``lax.scan``, on the CPU) and to the
port's plain ``decode_device_ref``.

The model does what each warp of the kernel does, in int32: lane w holds
nibble word w (steps 8w..8w+7); it composes its 8 clamp-add maps
x -> min(max(x + a, lo), hi) of the step index, the warp scans the 32 maps
in 5 rounds of ``__shfl_up_sync`` (emulated over the lane axis), each lane
walks its 8 steps from the previous lane's prefix, and the same is done for
the predictor maps; nibble 255 is the identity map (0, -2^30, 2^30); lane w
stores samples 8w..8w+7 from the previous lane's last predictor, whole
vectors where they fit below n and single samples at the ragged edge.  The
composition law itself is checked with hypothesis.  The kernel is held to
``decode_device_ref`` on the card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from softspoken_tpu.ops import adpcm as J
from softspoken_tpu_torch.ops import adpcm as P

I32 = np.int32
OPEN = 1 << 30  # the identity map's bounds in the kernel
LANES = 32
PRED_LO, PRED_HI, IDX_HI = -32768, 32767, 88


def clip(x, lo, hi):
    return np.minimum(np.maximum(x, lo), hi)


def then(f, g):
    """The map f, then g, as the kernel composes (a, lo, hi) triples."""
    a1, l1, h1 = f
    a2, l2, h2 = g
    return a1 + a2, clip(l1 + a2, l2, h2), clip(h1 + a2, l2, h2)


def apply(f, x):
    a, lo, hi = f
    return clip(x + a, lo, hi)


def _triple(a, lo, hi):
    return tuple(np.asarray(v, I32) for v in (a, lo, hi))


def shfl_up(v, off):
    """``__shfl_up_sync`` over the last (lane) axis: lanes below ``off``
    keep their own value."""
    out = v.copy()
    out[..., off:] = v[..., :-off]
    return out


def warp_inclusive_scan(f):
    lane = np.arange(LANES)
    for off in (1, 2, 4, 8, 16):
        e = tuple(shfl_up(c, off) for c in f)
        f = tuple(np.where(lane >= off, c, o) for c, o in zip(then(e, f), f))
    return f


def index_add(nib):
    m = nib & 7
    return np.where(m < 4, -1, 2 * (m - 3)).astype(I32)


def pred_add(step, nib):
    diff = (step >> 3) + np.where(nib & 1, step >> 2, 0) + np.where(nib & 2, step >> 1, 0) \
        + np.where(nib & 4, step, 0)
    return np.where(nib & 8, -diff, diff).astype(I32)


def scan_decode(wire: np.ndarray, n: int) -> np.ndarray:
    """The kernel's decode of ``wire`` → float32[n], warp by warp."""
    nb = len(wire) // P.BLOCK_BYTES
    words = np.ascontiguousarray(wire.reshape(nb, P.BLOCK_BYTES)).view("<u4")  # (nb, 33)
    hdr, data = words[:, :1], words[:, 1:]                                   # lane w: word w
    pred0 = (hdr & 0xFFFF).astype(np.uint16).view(np.int16).astype(I32)
    idx0 = np.minimum((hdr >> 16) & 0xFF, IDX_HI).astype(I32)
    nib = [((data >> (4 * j)) & 0xF).astype(I32) for j in range(8)]
    pad = np.arange(LANES) == LANES - 1  # nibble 255, lane 31's last: padding
    identity = _triple(0, -OPEN, OPEN)
    steps = P.STEP_TABLE.astype(I32)

    def lane_maps(adds, lo, hi):
        f = _triple(adds[0], lo, hi)
        for j in range(1, 8):
            g = _triple(adds[j], np.full_like(adds[j], lo), np.full_like(adds[j], hi))
            if j == 7:
                g = tuple(np.where(pad, i, c) for i, c in zip(identity, g))
            f = then(f, g)
        return warp_inclusive_scan(f)

    f = lane_maps([index_add(x) for x in nib], 0, IDX_HI)
    idx = shfl_up(apply(f, idx0), 1)
    idx[:, 0] = idx0[:, 0]
    add = []
    for j in range(8):
        add.append(pred_add(steps[idx], nib[j]))
        idx = clip(idx + index_add(nib[j]), 0, IDX_HI)

    g = lane_maps(add, PRED_LO, PRED_HI)
    pred = shfl_up(apply(g, pred0), 1)  # lane w: sample 8w
    pred[:, 0] = pred0[:, 0]
    samples = np.empty((nb, LANES, 8), I32)
    samples[..., 0] = pred
    for j in range(7):
        pred = clip(pred + add[j], PRED_LO, PRED_HI)
        samples[..., j + 1] = pred
    vals = samples.astype(np.float32) * np.float32(1.0 / 32768.0)

    out = np.full(nb * P.SPB, np.nan, np.float32)  # what the kernel leaves unwritten
    for b in range(nb):
        if b * P.SPB >= n:  # the warp leaves
            continue
        for w in range(LANES):
            s0 = b * P.SPB + 8 * w
            if s0 + 8 <= n:
                out[s0: s0 + 8] = vals[b, w]
            else:
                live = max(0, n - s0)
                out[s0: s0 + live] = vals[b, w, :live]
    assert np.isnan(out[n:]).all(), "the model stored past n"
    return out[:n]


def adversarial_wire(nb: int, seed: int) -> np.ndarray:
    """Random bytes; header step indices 0..255 in turn (clipped to 88);
    seeds at -32768 and 32767; blocks of nibble runs 0xF, 0x7 and 0x8 (the
    largest negative step, the largest positive, the smallest negative)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, nb * P.BLOCK_BYTES).astype(np.uint8).reshape(nb, P.BLOCK_BYTES)
    w[:, 2] = np.arange(nb) % 256
    w[0::5, 0:2] = [0x00, 0x80]   # -32768
    w[1::5, 0:2] = [0xFF, 0x7F]   # 32767
    w[0::5, P.HDR_BYTES:] = 0xFF  # drives the predictor into -32768 and stays
    w[1::5, P.HDR_BYTES:] = 0x77  # into 32767
    w[2::5, P.HDR_BYTES:] = 0x88
    w[3::5, P.HDR_BYTES:] = 0x77  # from a random seed: climbs, then saturates
    return w.reshape(-1)


def _both_references(w, n):
    want = np.asarray(J.decode_device(jnp.asarray(w), n))
    ref = P.decode_device_ref(torch.from_numpy(w), n).numpy()
    np.testing.assert_array_equal(ref, want)
    return want


@pytest.mark.parametrize("nb,n", [(260, 259 * 256 + 1), (260, 259 * 256 + 8),
                                  (260, 259 * 256 + 9), (260, 259 * 256 + 255),
                                  (258, 256 * 256), (260, 257 * 256 + 9)],
                         ids=["tail1", "tail8", "tail9", "tail255", "whole", "blocks-past-n"])
def test_scan_model_is_bit_equal_to_jax_on_adversarial_wires(nb, n):
    """Header indices 0..255, seeds at both clips, saturating nibble runs;
    n ending one sample into a lane, on a lane's end, one past it and one
    short of the block; and a wire with whole blocks past n."""
    w = adversarial_wire(nb, seed=n)
    got = scan_decode(w, n)
    np.testing.assert_array_equal(got, _both_references(w, n))
    pcm = (got * 32768).astype(np.int64)  # the clips were reached
    assert pcm.min() == PRED_LO and pcm.max() == PRED_HI


@pytest.mark.parametrize("n", [1, 255, 256, 257, 40 * 256 + 77])
def test_scan_model_is_bit_equal_on_encoded_speech(n):
    """Wires the host encoder makes (its per-block header index)."""
    rng = np.random.default_rng(n)
    t = np.arange(n) / 16000
    x = np.clip((0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.normal(size=n)) * 20000,
                -32768, 32767).astype(np.int16)
    w = P.encode_i16(x)
    got = scan_decode(w, n)
    np.testing.assert_array_equal(got, _both_references(w, n))
    np.testing.assert_array_equal(got, P.decode_np(w, n).astype(np.float32) / 32768.0)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(block=st.binary(min_size=P.BLOCK_BYTES, max_size=P.BLOCK_BYTES),
       n=st.integers(1, P.SPB))
def test_scan_model_matches_the_plain_version_on_any_block(block, n):
    w = np.frombuffer(block, np.uint8).copy()
    np.testing.assert_array_equal(scan_decode(w, n),
                                  P.decode_device_ref(torch.from_numpy(w), n).numpy())


# maps as the kernel sees them: adds of a block stay below 2^24 in sum
_ADD = st.integers(-(1 << 24) + 1, (1 << 24) - 1)


@st.composite
def _maps(draw, lo_min=PRED_LO, hi_max=PRED_HI):
    lo = draw(st.integers(lo_min, hi_max))
    return _triple(draw(_ADD), lo, draw(st.integers(lo, hi_max)))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(f=_maps(), g=_maps(), h=_maps(), x=st.integers(-(1 << 20), 1 << 20))
def test_clamp_add_composition_is_associative_and_is_composition(f, g, h, x):
    left, right = then(then(f, g), h), then(f, then(g, h))
    assert all(int(u) == int(v) for u, v in zip(left, right))
    x = np.asarray(x, I32)
    assert int(apply(left, x)) == int(apply(h, apply(g, apply(f, x))))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(f=st.one_of(_maps(), _maps(0, IDX_HI)), x=st.integers(PRED_LO, PRED_HI))
def test_the_padding_map_is_an_identity_without_overflow(f, x):
    """(0, -2^30, 2^30) on either side of a map gives the map back in int32
    arithmetic, for every add a block can sum to."""
    identity = _triple(0, -OPEN, OPEN)
    for comp in (then(identity, f), then(f, identity)):
        assert all(int(u) == int(v) for u, v in zip(comp, f))
    assert int(apply(identity, np.asarray(x, I32))) == x


def test_int32_extremes_would_not_be_an_identity():
    """Why the padding map's bounds are not INT_MIN/INT_MAX: a negative add
    wraps INT_MIN + a around to a large positive bound."""
    wrong = _triple(0, np.iinfo(I32).min, np.iinfo(I32).max)
    f = _triple(-1, PRED_LO, PRED_HI)
    with np.errstate(over="ignore"):
        comp = then(wrong, f)
    assert int(comp[1]) == PRED_HI != int(f[1])
