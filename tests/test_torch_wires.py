"""The lossy upload wires on the port against the JAX package on the CPU.

The codecs: the mu-law device decode within 2 float32 ulp of the JAX one
on all 256 codes and its encoder equal on all 65,536 int16 values, on
both routes; the bfp4 device decode; ``wavio.top16_from_raw``; the wire
policy ``_i16_kind``.  Then the whole fused pipeline, port on the CPU
against JAX on the CPU, for each wire and branch of ``detect_file_fused``
that takes one (full model width, short audio, ``device_batch=4``, 6 s
chunks, parity mode as in ``tests/test_torch_fused.py``): equal windows and
intervals, and 1e-4 on the averaged grid.  The wire samples are bit-equal
(the mu-law decode to 2 ulp), so only the summation order differs
(measured ~6e-8).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flac_ref
from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine.fused import _i16_kind as j_i16_kind
from softspoken_tpu.engine.fused import detect_file_fused as jax_detect_file_fused
from softspoken_tpu.io import native as jnative
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.ops import bfp4 as jbfp4
from softspoken_tpu.ops import mulaw as jmulaw
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine.fused import _i16_kind, detect_file_fused
from softspoken_tpu_torch.io import native, wavio
from softspoken_tpu_torch.ops import bfp4, mulaw

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _one_thread_reference(monkeypatch):
    """The JAX package's threaded ss_fir_decim_i16 (>= 65,536 outputs with
    more than one thread) reads a thread_local scratch from its worker
    threads and crashes the process; one thread gives the same samples."""
    monkeypatch.setattr(jnative, "_threads", lambda: 1)


# ---------------------------------------------------------------- codecs
def test_mulaw_decode_device_within_two_ulp_of_jax():
    q = np.arange(-128, 128, dtype=np.int8)
    got = mulaw.decode_device(torch.from_numpy(q))
    assert got.dtype == torch.float32
    want = np.asarray(jmulaw.decode_device(jnp.asarray(q)))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    host = mulaw.decode_host(q)
    np.testing.assert_allclose(got.numpy(), host, atol=1e-6)
    # both float32 formulas sit up to 6 ulp from the float64 decode (expm1
    # magnifies its argument's rounding by up to 5.5): the port's no farther
    np.testing.assert_array_max_ulp(want, host, maxulp=6)
    np.testing.assert_array_max_ulp(got.numpy(), host, maxulp=6)
    assert got[128] == 0.0  # code 0 is silence


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_mulaw_encode_equal_on_every_int16(monkeypatch, route):
    x = np.arange(-32768, 32768, dtype=np.int16)
    if route == "numpy":
        monkeypatch.setattr(native, "mulaw_encode_i16", lambda *a, **k: None)
    elif not native.native_available():
        pytest.skip("no g++: the native library cannot be built")
    want = jmulaw.encode_i16(x)
    np.testing.assert_array_equal(mulaw.encode_i16(x), want)
    out = np.full(len(x), 99, np.int8)
    assert mulaw.encode_i16(x, out=out) is out
    np.testing.assert_array_equal(out, want)
    # into a slice of a staging buffer, as the fused engine does
    stage = np.zeros(len(x) + 10, np.int8)
    mulaw.encode_i16(x, out=stage[5:5 + len(x)])
    np.testing.assert_array_equal(stage[5:5 + len(x)], want)
    assert not stage[:5].any() and not stage[-5:].any()


def test_mulaw_encode_checks_its_arguments():
    with pytest.raises(TypeError):
        mulaw.encode_i16(np.zeros(4, np.uint16))
    if native.native_available():
        with pytest.raises(ValueError):
            native.mulaw_encode_i16(np.zeros(4, np.int16), mulaw.encode_lut(),
                                    out=np.zeros(3, np.int8))


@pytest.mark.parametrize("n", [1, 255, 256, 3 * 256 + 17])
def test_bfp4_decode_device_equals_jax(n):
    """Negative wire bytes included: the high nibble is masked after the
    shift."""
    rng = np.random.default_rng(n)
    nb = -(-n // bfp4.BLOCK)
    packed = rng.integers(-128, 128, nb * bfp4.BLOCK // 2).astype(np.int8)
    scales = rng.integers(1, 32768, nb).astype(np.int16)
    got = bfp4.decode_device(torch.from_numpy(packed), torch.from_numpy(scales), n)
    want = np.asarray(jbfp4.decode_device(jnp.asarray(packed), jnp.asarray(scales), n))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), bfp4.decode_host(packed.view(np.uint8), scales, n),
                               rtol=1e-6, atol=1e-9)


def test_bfp4_roundtrip_through_the_device_decode():
    x = np.random.default_rng(2).integers(-30000, 30000, 1000).astype(np.int16)
    packed, scales = bfp4.encode_i16(x)
    got = bfp4.decode_device(torch.from_numpy(packed.view(np.int8)), torch.from_numpy(scales),
                             len(x))
    np.testing.assert_allclose(got.numpy(), bfp4.roundtrip_i16(x), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("subtype,width", [("PCM_24", 3), ("PCM_32", 4), ("PCM_U8", 1)])
def test_top16_from_raw_equals_jax(subtype, width):
    raw = np.random.default_rng(width).integers(0, 256, 1000 * width).astype(np.uint8)
    raw[:width] = 0xFF
    raw[width: 2 * width] = 0
    got = wavio.top16_from_raw(raw, subtype)
    assert got.dtype == np.int16 and got.shape == (1000,)
    np.testing.assert_array_equal(got, jwavio.top16_from_raw(raw, subtype))


def test_top16_from_raw_rejects_other_subtypes():
    with pytest.raises(wavio.WavFormatError):
        wavio.top16_from_raw(np.zeros(8, np.uint8), "FLOAT")


@pytest.mark.parametrize("codec", ["auto", "pcm16", "mulaw8", "adpcm4", "bfp4", "bogus"])
@pytest.mark.parametrize("precision", ["fast", "parity"])
def test_wire_policy_matches_jax_off_tpu(codec, precision):
    """"auto" is the exact wire off a TPU; any codec but the two lossy
    ones rides the exact wire silently, as in the JAX package."""
    got = _i16_kind(types.SimpleNamespace(
        cfg=Config().with_engine(upload_codec=codec, precision=precision)))
    want = j_i16_kind(types.SimpleNamespace(
        cfg=JConfig().with_engine(upload_codec=codec, precision=precision)))
    assert got == want == (codec if codec in ("mulaw8", "adpcm4") else "i16")


# ---------------------------------------------------------------- fused
PARITY = dict(precision="parity", device_batch=4, pipeline="fused", chunk_seconds=6.0)


def _signal(sr, seconds, seed, channels=1):
    rng = np.random.default_rng(seed)
    shape = (int(sr * seconds),) if channels == 1 else (int(sr * seconds), channels)
    return rng.uniform(-0.5, 0.5, shape).astype(np.float32)


def _wav(tmp_path, sr, seconds, subtype="PCM_16", channels=1, seed=0):
    p = str(tmp_path / f"w_{sr}_{subtype}_{channels}_{seed}.wav")
    jwavio.write(p, _signal(sr, seconds, seed, channels), sr, subtype=subtype)
    return p


def _flac24(tmp_path, sr, seconds, seed):
    x = np.clip(np.rint(_signal(sr, seconds, seed) * 2 ** 23), -2 ** 23, 2 ** 23 - 1)
    p = str(tmp_path / f"f24_{sr}_{seed}.flac")
    flac_ref.write_flac(p, x.astype(np.int64), sr, bits=24)
    return p


def _jax(path, **eng):
    det = JDetector(JConfig().with_engine(**eng), variables=jckpt.fixture_variables(seed=0))
    return jax_detect_file_fused(det, path)


def _port_det(**eng):
    return Detector(Config().with_engine(**eng), state_dict=fixture_state_dict(0), device="cpu")


def _held(got, ref):
    assert got.num_windows == ref.num_windows > 0
    assert got.avg_values.shape == ref.avg_values.shape
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-4)
    assert got.intervals == ref.intervals
    assert got.audio_seconds == pytest.approx(ref.audio_seconds)


def _kinds(det):
    """(native_sr, wire kind) of every engine the detector built."""
    return sorted((k[0], k[1]) for k in det._engines)


FUSED_CASES = [
    # (file maker, codec, wire_decimate, engine that must run)
    pytest.param(lambda t: _wav(t, 32000, 20.0, seed=1), "mulaw8", "auto", (16000, "mulaw8"),
                 id="32k-pcm16-mulaw8-decimated"),
    pytest.param(lambda t: _wav(t, 32000, 20.0, seed=2), "mulaw8", "off", (32000, "mulaw8"),
                 id="32k-pcm16-mulaw8-full-rate"),
    pytest.param(lambda t: _wav(t, 32000, 20.0, seed=3), "adpcm4", "auto", (16000, "adpcm4"),
                 id="32k-pcm16-adpcm4-decimated"),
    pytest.param(lambda t: _wav(t, 32000, 20.0, seed=4), "adpcm4", "off", (32000, "adpcm4"),
                 id="32k-pcm16-adpcm4-full-rate"),
    pytest.param(lambda t: _wav(t, 22050, 14.0, seed=5), "adpcm4", "auto", (22050, "adpcm4"),
                 id="22050-adpcm4-no-decimation"),
    pytest.param(lambda t: _wav(t, 32000, 9.0, "PCM_24", seed=6), "adpcm4", "auto",
                 (16000, "mulaw8"), id="32k-pcm24-wav-adpcm4-runs-mulaw8"),
    pytest.param(lambda t: _flac24(t, 32000, 9.0, seed=7), "adpcm4", "auto", (16000, "adpcm4"),
                 id="32k-24bit-flac-adpcm4-truncated"),
    pytest.param(lambda t: _wav(t, 22050, 9.0, "PCM_U8", seed=8), "mulaw8", "auto",
                 (22050, "mulaw8"), id="22050-pcm-u8-mulaw8"),
    pytest.param(lambda t: _wav(t, 48000, 9.0, "FLOAT", 2, seed=9), "mulaw8", "auto",
                 (16000, "mulaw8"), id="48k-float-stereo-mulaw8-decimated"),
]


@pytest.mark.parametrize("make,codec,decim,engine", FUSED_CASES)
def test_fused_wire_matches_jax(tmp_path, make, codec, decim, engine):
    p = make(tmp_path)
    eng = dict(PARITY, upload_codec=codec, wire_decimate=decim)
    ref = _jax(p, **eng)
    det = _port_det(**eng)
    got = detect_file_fused(det, p)
    _held(got, ref)
    assert _kinds(det) == [engine]


def test_pcm24_wav_under_adpcm4_is_the_mulaw8_wire(tmp_path):
    """The reference's behaviour, copied: a 24-bit mono WAV runs mulaw8
    under upload_codec="adpcm4", so the two grids are the same bits."""
    p = _wav(tmp_path, 32000, 9.0, "PCM_24", seed=6)
    a = detect_file_fused(_port_det(**PARITY, upload_codec="adpcm4"), p)
    b = detect_file_fused(_port_det(**PARITY, upload_codec="mulaw8"), p)
    np.testing.assert_array_equal(a.avg_values, b.avg_values)


@pytest.mark.parametrize("codec", ["auto", "bfp4"])
def test_exact_wire_codecs_run_the_int16_engine(tmp_path, codec):
    """"auto" (no TPU here) and an unknown codec run the exact int16 wire:
    the grid is pcm16's, bit for bit."""
    p = _wav(tmp_path, 32000, 8.0, seed=10)
    det = _port_det(**PARITY, upload_codec=codec)
    got = det.detect_file_streaming(p)
    assert _kinds(det) == [(32000, "i16")]
    exact = detect_file_fused(_port_det(**PARITY, upload_codec="pcm16"), p)
    np.testing.assert_array_equal(got.avg_values, exact.avg_values)


def test_lossy_wire_runs_through_detect_file_streaming(tmp_path):
    """The public entry point: no NotImplementedError, close to pcm16."""
    p = _wav(tmp_path, 32000, 8.0, seed=11)
    lossy = _port_det(**PARITY, upload_codec="adpcm4").detect_file_streaming(p)
    exact = _port_det(**PARITY, upload_codec="pcm16").detect_file_streaming(p)
    assert lossy.num_windows == exact.num_windows
    np.testing.assert_allclose(lossy.avg_values, exact.avg_values, atol=0.05)


def test_unknown_engine_kind_raises():
    from softspoken_tpu_torch.engine.fused import FusedStreamingEngine

    with pytest.raises(ValueError):
        FusedStreamingEngine(_port_det(**PARITY), 32000, "bfp4")
