"""The port's WAV writers against the JAX package's: ``write`` in every
subtype and the streaming ``WavWriter`` (with its RF64 promotion) give the
same bytes for the same samples."""

import numpy as np
import pytest

from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch.io import wavio

SUBTYPES = ["PCM_U8", "PCM_16", "PCM_24", "PCM_32", "FLOAT", "DOUBLE"]


def _samples(frames, channels, seed=0):
    rng = np.random.default_rng(seed)
    # past full scale on purpose: the integer encoders clip
    x = rng.uniform(-1.2, 1.2, (frames, channels)).astype(np.float32)
    x[:4, 0] = [1.0, -1.0, 0.5 / 32768, -0.5 / 32768]  # the rounding edges
    return x[:, 0] if channels == 1 else x


@pytest.mark.parametrize("subtype", SUBTYPES)
@pytest.mark.parametrize("channels,frames", [(1, 1001), (2, 777), (3, 64)])
def test_write_bytes_equal_the_jax_writer(tmp_path, subtype, channels, frames):
    x = _samples(frames, channels)
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    wavio.write(str(a), x, 44100, subtype=subtype)
    jwavio.write(str(b), x, 44100, subtype=subtype)
    assert a.read_bytes() == b.read_bytes()
    got, sr = wavio.read(str(a))
    want, _ = jwavio.read(str(b))
    assert sr == 44100
    np.testing.assert_array_equal(got, want)


def test_write_rejects_unknown_subtype(tmp_path):
    with pytest.raises(KeyError):
        wavio.write(str(tmp_path / "x.wav"), np.zeros(4, np.float32), 8000, subtype="PCM_12")


def _stream(mod, path, x, sr, subtype, sizes):
    with mod.WavWriter(str(path), sr, x.shape[1], subtype) as w:
        pos = 0
        for n in sizes:
            w.write(x[pos:pos + n])
            pos += n
        w.write(x[pos:])


@pytest.mark.parametrize("subtype", SUBTYPES)
def test_wav_writer_uneven_chunks_bytes_equal(tmp_path, subtype):
    x = _samples(5003, 2, seed=1)
    sizes = [1, 0, 999, 17, 2048]
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    _stream(wavio, a, x, 32000, subtype, sizes)
    _stream(jwavio, b, x, 32000, subtype, sizes)
    assert a.read_bytes() == b.read_bytes()
    whole = tmp_path / "whole.wav"
    _stream(wavio, whole, x, 32000, subtype, [])
    got, _ = wavio.read(str(a), always_2d=True)
    np.testing.assert_array_equal(got, wavio.read(str(whole), always_2d=True)[0])


def test_wav_writer_rejects_channel_mismatch(tmp_path):
    with wavio.WavWriter(str(tmp_path / "x.wav"), 8000, 2) as w:
        with pytest.raises(ValueError, match="channel"):
            w.write(np.zeros((4, 3), np.float32))


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "FLOAT"])
def test_rf64_promotion_bytes_equal_and_read_back(tmp_path, monkeypatch, subtype):
    monkeypatch.setattr(wavio.WavWriter, "_RF64_THRESHOLD", 1000)
    monkeypatch.setattr(jwavio.WavWriter, "_RF64_THRESHOLD", 1000)
    x = _samples(3001, 2, seed=2)
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    _stream(wavio, a, x, 48000, subtype, [1000, 1])
    _stream(jwavio, b, x, 48000, subtype, [1000, 1])
    data = a.read_bytes()
    assert data == b.read_bytes()
    assert data[:4] == b"RF64" and data[12:16] == b"ds64"
    inf = wavio.info(str(a))
    assert (inf.frames, inf.channels, inf.samplerate) == (3001, 2, 48000)
    got, _ = wavio.read(str(a), always_2d=True)
    plain = tmp_path / "plain.wav"
    wavio.write(str(plain), x, 48000, subtype=subtype)
    np.testing.assert_array_equal(got, wavio.read(str(plain), always_2d=True)[0])
