"""The host trainer's data path (``train/data.py``) against the JAX
package's: the three loaders on the same WAVs, and ``build_batch`` for the
same seed.

The loaders read through each package's ``load_audio``, whose readers and
resampler are held bit for bit elsewhere (test_torch_containers.py,
test_torch_host.py), so their clips are equal.  ``build_batch`` mixes in
the JAX package's numpy code and consumes the same numpy draws, so the mix
is equal; the mels go through two float32 frontends: measured 2.8e-6 on
the mix and 6.1e-5 on the noise target, whose quiet bins sit where
sqrt(log10(x+1)) is steep; bound 2e-4 (test_torch_train_synth.py holds the
device synthesizer's mels to 1e-3).  The frame
mask thresholds the clean mel at 1e-4: a bin within the mel tolerance of
the threshold could flip a frame, so the masks are held equal on clips
whose quiet frames are exact zeros.
"""

import numpy as np
import pytest
import torch

from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.train import data as JD
from softspoken_tpu_torch.train import data as D

SR = 22050


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    out = {}
    for name, sr, sec in (("long", 22050, 7.0), ("hi", 44100, 5.0), ("short", 22050, 1.3),
                          ("stereo", 32000, 4.0)):
        n = int(sr * sec)
        x = rng.uniform(-0.4, 0.4, (n, 2) if name == "stereo" else n).astype(np.float32)
        p = str(d / f"{name}.wav")
        jwavio.write(p, x, sr, subtype="PCM_16")
        out[name] = p
    return out


def test_constants_are_the_jax_ones():
    assert (D.SR, D.CLIP) == (JD.SR, JD.CLIP) == (22050, 66150)


@pytest.mark.parametrize("name,start", [("long", 0), ("long", 50000), ("hi", 12345),
                                        ("short", 0), ("short", 7000), ("stereo", 3000)])
def test_load_environmental_noise_matches_jax(wavs, name, start):
    got = D.load_environmental_noise(wavs[name], start)
    want = JD.load_environmental_noise(wavs[name], start)
    assert got.dtype == np.float32 and got.shape == (D.CLIP,)
    np.testing.assert_array_equal(got, want)


def test_load_environmental_noise_of_an_unreadable_file(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not audio")
    assert D.load_environmental_noise(str(bad), 0) is None
    assert JD.load_environmental_noise(str(bad), 0) is None


def test_load_peoples_speech_matches_jax(wavs, tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not audio")
    items = [(wavs["long"], 1000), (wavs["hi"], 30000), (wavs["short"], 0), (str(bad), 0),
             (wavs["stereo"], 9000)]
    np.testing.assert_array_equal(D.load_peoples_speech(items), JD.load_peoples_speech(items))


def test_load_spoken_word_matches_jax(wavs):
    items = [(wavs["short"], 0), (wavs["short"], 40000), (wavs["hi"], 60000)]
    np.testing.assert_array_equal(D.load_spoken_word(items), JD.load_spoken_word(items))


def test_load_spoken_word_out_of_clip_offset(tmp_path):
    """A placement at or past the clip is skipped (tests/test_fit.py:128)."""
    w = tmp_path / "w.wav"
    jwavio.write(str(w), np.ones(10000, np.float32), SR, subtype="FLOAT")
    clip = D.load_spoken_word([(str(w), D.CLIP + 4000)])
    assert clip.shape == (D.CLIP,) and float(np.abs(clip).max()) == 0.0
    clip2 = D.load_spoken_word([(str(w), D.CLIP - 100)])
    assert float(np.abs(clip2[: D.CLIP - 100]).max()) == 0.0
    assert float(np.abs(clip2[D.CLIP - 100:]).max()) > 0.0
    np.testing.assert_array_equal(clip2, JD.load_spoken_word([(str(w), D.CLIP - 100)]))


def _clips(B, seed):
    """Speech with exact-zero gaps (so the frame mask is decided by the
    silence, not by a bin near the threshold) and noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(D.CLIP) / SR
    speech = np.stack([(0.3 * np.sin(2 * np.pi * (300 + 90 * b) * t)
                        * (np.sin(2 * np.pi * 0.7 * t + b) > 0)).astype(np.float32)
                       for b in range(B)])
    noise = rng.uniform(-0.05, 0.05, (B, D.CLIP)).astype(np.float32)
    return speech, noise


@pytest.mark.parametrize("snr", [(-5.0, 20.0), (10.0, 10.0)])
def test_build_batch_without_augmentations_matches_jax(snr):
    speech, noise = _clips(3, seed=1)
    rng_p, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    got = D.build_batch(speech, noise, rng_p, snr_db_range=snr, device="cpu")
    want = JD.build_batch(speech, noise, rng_j, snr_db_range=snr)
    assert tuple(got["mel"].shape) == (3, 128, 256)
    assert tuple(got["mask"].shape) == (3, 256)
    assert tuple(got["spec"].shape) == (3, 2, 128, 256)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in got.values())
    np.testing.assert_allclose(got["mel"].numpy(), want["mel"][..., 0], atol=2e-4)
    np.testing.assert_allclose(got["spec"].numpy(), np.moveaxis(want["spec"], -1, 1),
                               atol=2e-4)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert 0 < got["mask"].numpy().mean() < 1
    assert rng_p.random() == rng_j.random()


def test_build_batch_with_augmentations_consumes_the_jax_draws():
    """One SNR draw for the batch and one integer per row, as in JAX: the
    numpy generator leaves build_batch in the same state.  The parameters
    come from a torch.Generator seeded with the row's integer, so the rows
    differ from JAX's; they differ from each other (per-row draws), and the
    same seed gives the same batch."""
    speech, noise = _clips(2, seed=2)
    speech[1] = speech[0]
    noise[1] = noise[0]
    augs = ("reduce_volume", "add_echo")
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    got = D.build_batch(speech, noise, rng_p, augmentations=augs,
                        snr_db_range=(10.0, 10.0), device="cpu")
    JD.build_batch(speech, noise, rng_j, augmentations=augs, snr_db_range=(10.0, 10.0))
    assert rng_p.bit_generator.state == rng_j.bit_generator.state
    mel = got["mel"].numpy()
    assert np.abs(mel[0] - mel[1]).max() > 1e-3
    again = D.build_batch(speech, noise, np.random.default_rng(3), augmentations=augs,
                          snr_db_range=(10.0, 10.0), device="cpu")
    for k in got:
        assert torch.equal(got[k], again[k])


def test_build_batch_rows_are_augmented_with_their_drawn_parameters():
    """Row b of the batch is the mix augmented with get_parameters of a
    Generator seeded by the b-th integer the numpy generator gives after
    the SNR draw."""
    from softspoken_tpu_torch.ops import mel as melops
    from softspoken_tpu_torch.train import augment as aug

    speech, noise = _clips(2, seed=4)
    augs = ("add_reverb", "bandpass_filter", "compress_dynamics")
    got = D.build_batch(speech, noise, np.random.default_rng(5), augmentations=augs,
                        device="cpu")
    rng = np.random.default_rng(5)
    snr = rng.uniform(-5.0, 20.0, size=(2, 1)).astype(np.float32)
    sp = np.sqrt(np.mean(speech ** 2, axis=1, keepdims=True) + 1e-12)
    nz = np.sqrt(np.mean(noise ** 2, axis=1, keepdims=True) + 1e-12)
    mix = speech + noise * (sp / (nz * 10.0 ** (snr / 20.0)))
    for b in range(2):
        g = torch.Generator()
        g.manual_seed(int(rng.integers(0, 2**31 - 1)))
        row = aug.apply_augmentations(torch.from_numpy(mix[b: b + 1]), D.SR, augs,
                                      aug.get_parameters(g, augs))
        # one row's mel against the batch's: the BLAS may block the two
        # products differently, so float32 rounding apart
        np.testing.assert_allclose(got["mel"][b: b + 1].numpy(),
                                   melops.log_mel_clips(row, "highest").numpy(), atol=1e-5)


def test_build_batch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    speech, noise = _clips(1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.build_batch(speech, noise, np.random.default_rng(0))


def test_build_batch_timings():
    speech, noise = _clips(2, seed=0)
    t = {}
    D.build_batch(speech, noise, np.random.default_rng(0), augmentations=("reduce_volume",),
                  device="cpu", timings=t)
    assert set(t) == {"augment", "mel"} and all(v > 0 for v in t.values())
