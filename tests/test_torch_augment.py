"""The port's augmentation suite (``train/augment.py``) against the JAX
package's on the same (B, 66150) clips and the same parameters, and the
properties ``tests/test_train.py`` holds the JAX suite to.

Tolerances: the elementwise augmentations agree to float32 rounding (1e-6
of the peak); the band-pass goes through two FFTs of different libraries
(measured 3e-7, bound 1e-5); ``change_speed`` adds the phase vocoder, whose
phase is a running sum over up to 331 frames: the JAX package adds it one
float32 term at a time, the port with ``torch.cumsum`` (double accumulation
on the CPU), so the phases differ by a few float32 ulps of values up to
~10^3 rad (measured 2.6e-4 of the peak, bound 1e-3).  The running sum
also carries every frame's phase into the later frames of its bin, so the
phase of a near-silent bin, which the two FFT libraries round differently,
is carried into loud frames: end to end, ``change_speed`` is held on clips
without a near-silent passage, and ``_phase_vocoder`` alone on the same
STFT with one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softspoken_tpu.train import augment as jaug
from softspoken_tpu_torch.train import augment as aug

SR = 22050
CLIP = 66150


def _clips(seed=0, quiet=True):
    """Two rows: noise and a 500 Hz tone, with a near-silent passage (the
    compressor's lower branch) unless ``quiet`` is False."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.2, (2, CLIP)).astype(np.float32)
    x[1] = 0.4 * np.sin(2 * np.pi * 500 * np.arange(CLIP) / SR)
    if quiet:
        x[:, 20000:26000] *= 0.01
    return x


def _tone(freq=500.0, n=CLIP, amp=0.5):
    return (amp * np.sin(2 * np.pi * freq * np.arange(n) / SR)).astype(np.float32)


def _pair(name, x, **params):
    got = aug.FUNC_MAP[name](torch.from_numpy(x), SR, **params)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    want = np.asarray(jaug.FUNC_MAP[name](jnp.asarray(x), SR, **params))
    return got.numpy(), want


CASES = [
    ("change_pitch", dict(pitch_factor=2.3), 1e-6),
    ("change_pitch", dict(pitch_factor=-2.9), 1e-6),
    ("add_reverb", dict(reverb_level=0.6, decay_time=0.7, num_delays=3.7), 1e-6),
    ("add_reverb", dict(reverb_level=0.25, decay_time=0.2, num_delays=1.2), 1e-6),
    ("reduce_volume", dict(reduction_level=0.3), 1e-6),
    ("gain_ramp", dict(start_db=-12.0, end_db=-3.0), 1e-6),
    ("add_echo", dict(echo_delay=0.33, decay_factor=0.5), 1e-6),
    ("bandpass_filter", dict(low_freq=250.0, high_freq=1800.0), 1e-5),
    ("add_harmonic_distortion", dict(distortion_level=33.0), 1e-6),
    ("compress_dynamics", dict(compression_ratio=3.0, threshold_level=-25.0), 1e-6),
    ("change_speed", dict(speed_factor=0.8), 1e-3),
    ("change_speed", dict(speed_factor=0.93), 1e-3),
    ("change_speed", dict(speed_factor=1.2), 1e-3),
]


@pytest.mark.parametrize("name,params,tol", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_augmentation_matches_jax(name, params, tol):
    x = _clips(quiet=name != "change_speed")
    got, want = _pair(name, x, **params)
    np.testing.assert_allclose(got, want, atol=tol * float(np.abs(want).max()))


def test_change_speed_at_one_is_the_input():
    """The reference's short cut at exactly 1.0: no STFT round trip."""
    x = _clips()
    got, want = _pair("change_speed", x, speed_factor=1.0)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(want, x)


def test_change_speed_properties():
    """Pitch kept at 500 Hz, the sped-up tail silent, and the round trip's
    ~1.5× level (tests/test_train.py's properties)."""
    x = _tone()[None]
    fast = aug.change_speed(torch.from_numpy(x), speed_factor=1.25).numpy()
    assert np.all(np.isfinite(fast))
    seg = fast[0, 10000:30000]
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert np.argmax(spec) * SR / len(seg) == pytest.approx(500.0, abs=10.0)
    assert np.abs(fast[0, int(CLIP / 1.25) + 2048:]).max() < 0.05
    level = np.sqrt(np.mean(seg ** 2)) / np.sqrt(np.mean(x[0, 10000:30000] ** 2))
    assert 1.3 < level < 1.7


def test_change_speed_slowdown_keeps_tail():
    """A slowdown emits more frames than the input; the output is sized so
    the last ~40 ms of the clip are not silent."""
    x = _tone()[None]
    slow = aug.change_speed(torch.from_numpy(x), speed_factor=0.8).numpy()
    mid_rms = np.sqrt(np.mean(slow[0, CLIP // 2: CLIP // 2 + 2048] ** 2))
    tail_rms = np.sqrt(np.mean(slow[0, -2048:] ** 2))
    assert tail_rms > 0.5 * mid_rms


@pytest.mark.parametrize("speed", [0.8, 1.2])
def test_phase_vocoder_matches_jax_on_the_same_stft(speed):
    """The cumulative-sum vocoder against the JAX scan on the JAX package's
    STFT of clips with a near-silent passage: 1e-3 of the peak magnitude
    (measured ~1e-4), except where a phase advance sits on the ±π cut of
    the wrap, which an ulp of the two atan2s puts on either side (2 of
    327,294 values at speed 0.8, none at 1.2; at most 1e-5 allowed)."""
    spec = np.asarray(jaug._stft(jnp.asarray(_clips())))
    n_frames = spec.shape[-2]
    out_frames = n_frames if speed >= 1.0 else int(np.ceil((n_frames - 1) / speed)) + 1
    got = aug._phase_vocoder(torch.from_numpy(spec), speed, out_frames=out_frames).numpy()
    want = np.asarray(jaug._phase_vocoder(jnp.asarray(spec), jnp.asarray(speed, jnp.float32),
                                          out_frames=out_frames))
    assert got.shape == want.shape == (2, out_frames, 513)
    off = np.abs(got - want) > 1e-3 * np.abs(want).max()
    assert off.sum() <= 1e-5 * off.size


def test_istft_is_the_scatter_overlap_add():
    """The four shifted views add what the JAX package's scatter adds."""
    rng = np.random.default_rng(3)
    spec = (rng.normal(size=(2, 7, 513)) + 1j * rng.normal(size=(2, 7, 513))).astype(np.complex64)
    for n in (1000, 2560):  # shorter than hop·6 + n_fft: cut; longer: zero-padded
        got = aug._istft(torch.from_numpy(spec), n).numpy()
        want = np.asarray(jaug._istft(jnp.asarray(spec), n))
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_butterworth_coefficients_are_scipys():
    b, a = aug._butter1_band_coeffs(300.0, 2000.0, SR)
    jb, ja = jaug._butter1_band_coeffs(300.0, 2000.0, SR)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)


def test_bandpass_filter_response():
    """Steady-state output matches scipy's lfilter away from the edges."""
    import scipy.signal

    x = np.random.default_rng(1).normal(0, 0.3, (1, 4 * SR)).astype(np.float32)
    y = aug.bandpass_filter(torch.from_numpy(x), low_freq=300.0, high_freq=2000.0).numpy()
    b, a = scipy.signal.butter(1, [300 / (SR / 2), 2000 / (SR / 2)], btype="band")
    want = scipy.signal.lfilter(b, a, x[0]).astype(np.float32)
    mid = slice(SR, 3 * SR)
    assert np.abs(y[0, mid] - want[mid]).max() < 5e-3


def test_apply_augmentations_dispatch_and_order():
    """The chain applies in the given order (pitch then distortion is not
    distortion then pitch) and equals the JAX chain on the same params;
    an unknown name raises KeyError."""
    x = _clips()
    augs = ["change_pitch", "add_harmonic_distortion", "add_echo", "reduce_volume"]
    params = [{"pitch_factor": 1.7}, {"distortion_level": 20.0},
              {"echo_delay": 0.2, "decay_factor": 0.4}, {"reduction_level": 0.5}]
    got = aug.apply_augmentations(torch.from_numpy(x), SR, augs, params).numpy()
    want = np.asarray(jaug.apply_augmentations(jnp.asarray(x), SR, augs, params))
    np.testing.assert_allclose(got, want, atol=1e-6)
    swapped = aug.apply_augmentations(torch.from_numpy(x), SR, augs[1::-1] + augs[2:],
                                      params[1::-1] + params[2:]).numpy()
    assert np.abs(swapped - got).max() > 1e-3
    with pytest.raises(KeyError):
        aug.apply_augmentations(torch.from_numpy(x), SR, ["nope"], [{}])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_parameters_stays_inside_the_ranges(seed):
    """Every key of every range, drawn from a torch.Generator, inside
    PARAM_RANGES (the JAX package's ranges); a name without a range is
    skipped, as in JAX; the same seed gives the same draws."""
    assert aug.PARAM_RANGES == jaug.PARAM_RANGES
    names = list(aug.PARAM_RANGES) + ["not_an_augmentation"]
    g = torch.Generator()
    g.manual_seed(seed)
    params = aug.get_parameters(g, names)
    jparams = jaug.get_parameters(jax.random.PRNGKey(seed), names)
    assert len(params) == len(jparams) == len(aug.PARAM_RANGES)
    for name, p in zip(aug.PARAM_RANGES, params):
        assert list(p) == list(aug.PARAM_RANGES[name])
        for key, (lo, hi) in aug.PARAM_RANGES[name].items():
            assert lo <= p[key] <= hi and isinstance(p[key], float)
    g2 = torch.Generator()
    g2.manual_seed(seed)
    assert aug.get_parameters(g2, names) == params


def test_a_drawn_chain_matches_jax_on_its_parameters():
    """Parameters drawn by the port, fed to both packages: every
    augmentation the host trainer may run, in one chain."""
    x = _clips(seed=5)
    names = ["add_reverb", "reduce_volume", "bandpass_filter", "compress_dynamics",
             "add_echo", "gain_ramp"]
    g = torch.Generator()
    g.manual_seed(11)
    params = aug.get_parameters(g, names)
    got = aug.apply_augmentations(torch.from_numpy(x), SR, names, params).numpy()
    want = np.asarray(jaug.apply_augmentations(jnp.asarray(x), SR, names, params))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
