"""The port's IMA-ADPCM wire codec (``softspoken_tpu_torch/ops/adpcm.py``)
against the JAX package's ``ops/adpcm.py`` on the CPU: the encoder byte for
byte on both routes (native and numpy), ``decode_np`` and the plain device
decode ``decode_device_ref`` bit-equal to the JAX ``decode_device`` scan,
header step indices 0..255 included.  The CUDA kernel K3 is held to
``decode_device_ref`` on the card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softspoken_tpu.io import native as jnative
from softspoken_tpu.ops import adpcm as J
from softspoken_tpu_torch.io import native
from softspoken_tpu_torch.ops import adpcm as P


def _speechlike(n, seed=0, amp=20000):
    # tests/test_adpcm_wire.py's signal, at a sample count
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    x = (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.2 * np.sin(2 * np.pi * 900 * t) + 0.05 * rng.normal(size=n))
    return np.clip(x * amp, -32768, 32767).astype(np.int16)


def _extreme(n, seed=0):
    """Full-scale steps, runs at ±32768/32767 and white noise: drives the
    quantizer's largest steps and both clips."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, n).astype(np.int16)
    x[n // 4: n // 2] = np.where(np.arange(n // 2 - n // 4) % 64 < 32, 32767, -32768)
    return x


SIGNALS = {"speech": _speechlike, "extreme": _extreme,
           "silence": lambda n, seed=0: np.zeros(n, np.int16)}
# 0 and partial-block lengths, and ≥ 16 full blocks plus a tail (the C
# encoder's 8-block group path and its scalar tail)
LENGTHS = [0, 1, 255, 256, 257, 3 * 256 + 13, 16 * 256 + 77, 40 * 256 + 255]


def test_constants_equal():
    assert (P.SPB, P.HDR_BYTES, P.BLOCK_BYTES, P.BYTES_PER_SAMPLE) == \
        (J.SPB, J.HDR_BYTES, J.BLOCK_BYTES, J.BYTES_PER_SAMPLE)
    np.testing.assert_array_equal(P.INDEX_TABLE, J.INDEX_TABLE)
    np.testing.assert_array_equal(P.STEP_TABLE, J.STEP_TABLE)
    for n in LENGTHS + [10 ** 6 + 1]:
        assert P.n_blocks(n) == J.n_blocks(n) and P.wire_bytes(n) == J.wire_bytes(n)


@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("n", LENGTHS)
def test_native_encode_is_byte_equal_to_jax(signal, n):
    if not (native.native_available() and jnative.native_available()):
        pytest.skip("no g++: neither package can build its native library")
    x = SIGNALS[signal](n, seed=n)
    got = P.encode_i16(x)
    np.testing.assert_array_equal(got, J.encode_i16(x))
    out = np.full(P.wire_bytes(n), 0xAB, np.uint8)  # every byte is written
    assert P.encode_i16(x, out=out) is out
    np.testing.assert_array_equal(out, got)


@pytest.mark.parametrize("signal", sorted(SIGNALS))
@pytest.mark.parametrize("n", [1, 257, 16 * 256 + 77])
def test_numpy_encode_is_byte_equal_to_jax_and_native(monkeypatch, signal, n):
    x = SIGNALS[signal](n, seed=n + 1)
    native_bytes = P.encode_i16(x)
    monkeypatch.setattr(native, "ima_encode_i16", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "ima_encode_i16", lambda *a, **k: None)
    got = P.encode_i16(x)
    np.testing.assert_array_equal(got, J.encode_i16(x))
    np.testing.assert_array_equal(got, native_bytes)


def test_encode_checks_its_arguments():
    with pytest.raises(TypeError):
        P.encode_i16(np.zeros(16, np.float32))
    with pytest.raises(ValueError):
        P.encode_i16(np.zeros(300, np.int16), out=np.zeros(P.BLOCK_BYTES, np.uint8))
    with pytest.raises(ValueError):
        native.ima_encode_i16(np.zeros(300, np.int16), np.zeros(10, np.uint8), P.SPB)


def _random_wire(nb, seed, max_index=255):
    """Random bytes, header indices 0..max_index, and int16 seeds at the
    extremes with runs of nibble 7 / 15 that saturate the clip."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, nb * P.BLOCK_BYTES).astype(np.uint8).reshape(nb, P.BLOCK_BYTES)
    w[:, 2] = rng.integers(0, max_index + 1, nb)
    w[0, 0:2] = [0x00, 0x80]        # -32768
    w[1, 0:2] = [0xFF, 0x7F]        # 32767
    w[0, P.HDR_BYTES:] = 0xFF       # nibble 15: the largest negative step
    w[1, P.HDR_BYTES:] = 0x77       # nibble 7: the largest positive step
    w[0, 2] = w[1, 2] = min(88, max_index)
    return w.reshape(-1)


@pytest.mark.parametrize("nb,tail", [(2, 0), (37, 1), (37, 200), (64, 255)])
def test_decode_device_ref_is_bit_equal_to_jax(nb, tail):
    """Header indices 0..255 (the device decode clips them to 0..88)."""
    w = _random_wire(nb, seed=nb + tail)
    n = nb * P.SPB - tail
    want = np.asarray(J.decode_device(jnp.asarray(w), n))
    got = P.decode_device_ref(torch.from_numpy(w), n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the wrapper runs the plain version
    np.testing.assert_array_equal(P.decode_device(torch.from_numpy(w), n).numpy(), want)


@pytest.mark.parametrize("nb,tail", [(3, 0), (37, 100)])
def test_decode_np_is_bit_equal_to_jax(nb, tail):
    """Valid wires (indices 0..88): decode_np, JAX's decode_np and its
    device scan all agree."""
    w = _random_wire(nb, seed=7 * nb + tail, max_index=88)
    n = nb * P.SPB - tail
    got = P.decode_np(w, n)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, J.decode_np(w, n))
    np.testing.assert_array_equal(got.astype(np.float32) / 32768.0,
                                  np.asarray(J.decode_device(jnp.asarray(w), n)))


def test_decode_np_rejects_an_unclipped_index_as_jax_does():
    w = _random_wire(2, seed=3, max_index=88)
    w[2] = 200
    with pytest.raises(IndexError):
        J.decode_np(w, P.SPB)
    with pytest.raises(IndexError):
        P.decode_np(w, P.SPB)


@pytest.mark.parametrize("signal", ["speech", "extreme"])
def test_roundtrip_through_both_packages(signal):
    x = SIGNALS[signal](16 * 256 + 77, seed=9)
    w = P.encode_i16(x)
    y = P.decode_np(w, len(x))
    np.testing.assert_array_equal(y, J.decode_np(J.encode_i16(x), len(x)))
    np.testing.assert_array_equal(
        P.decode_device(torch.from_numpy(w), len(x)).numpy(), y.astype(np.float32) / 32768.0)


def test_roundtrip_snr():
    """tests/test_adpcm_wire.py's quality bound on the port's codec."""
    x = _speechlike(32000)
    y = P.decode_np(P.encode_i16(x), len(x)).astype(np.float64)
    err = y - x.astype(np.float64)
    snr = 10 * np.log10(np.sum(x.astype(np.float64) ** 2) / np.sum(err ** 2))
    assert snr > 22.0, snr


def test_decode_device_checks_its_arguments():
    w = torch.zeros(2 * P.BLOCK_BYTES, dtype=torch.uint8)
    with pytest.raises(ValueError):
        P.decode_device(w[:-1], 10)
    with pytest.raises(ValueError):
        P.decode_device(w, 2 * P.SPB + 1)
    with pytest.raises(ValueError):
        P.decode_device(w.to(torch.int8), 10)
    assert P.decode_device(w, 0).shape == (0,)
