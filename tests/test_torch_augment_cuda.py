"""The host trainer's augmentations and batch on the card against the CPU,
each augmentation three times over, with the digests of its inputs and
parameters in the failure message: two runs that print the same digest had
the same input (ROADMAP §1's ``add_harmonic_distortion`` fault).

Card only; the command is in tests/test_torch_cuda.py's docstring.  One
comparison of each augmentation on noise and a tone is
tests/test_torch_cuda.py::test_host_augmentations_on_the_card_match_the_cpu.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from torch_cuda_helpers import need_card

pytestmark = pytest.mark.cuda

# card against CPU on the same clips and parameters, relative to the peak:
# the pointwise augmentations round the same operations (an ulp of
# exp/pow), the filters go through cuFFT against pocketfft
AUG_TOL = {"bandpass_filter": 1e-4, "add_reverb": 1e-5, "add_echo": 1e-5, "gain_ramp": 1e-5}
AUG_TOL_POINTWISE = 1e-5
# change_speed's phase vocoder carries each bin's phase into its later
# frames, so the phase of a near-silent bin, which two FFT libraries round
# differently, moves the loud frames after it: speech with pauses differs
# by up to ~1e-2 of the peak between the card and the CPU, a different but
# equally valid stretch.  It is held on noise and a tone (every bin loud),
# where only the running sum's order differs, and its vocoder on the CPU's
# STFT, where a phase advance on the ±π cut may flip (a share of at most
# 1e-5 of the values, as tests/test_torch_augment.py holds it)
SPEED_TOL = 2e-3
# build_batch's mels, card against CPU, mel pinned to "highest", with every
# augmentation of FIT_AUGS but change_speed (above)
BATCH_MEL_TOL = 5e-3
FIT_AUGS = ("add_reverb", "reduce_volume", "bandpass_filter", "change_speed", "change_pitch")
REPEATS = 3


def _digest(data) -> str:
    """The first 16 hex digits of the SHA-256 of an array's or bytes'
    contents."""
    raw = data if isinstance(data, bytes) else np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


@pytest.fixture(scope="module")
def clips():
    """Four 3 s speech and four environment clips at 22,050 Hz from
    ``train/synth.py`` (the trainer's sources)."""
    need_card()  # before any work: the test skips without a card
    from softspoken_tpu_torch.train import synth

    rng = np.random.default_rng(12)
    speech = np.stack([synth.synth_speech(rng, 66150)[0] for _ in range(4)]).astype(np.float32)
    noise = np.stack([synth.synth_environment(rng, 66150) for _ in range(4)]).astype(np.float32)
    return speech, noise


def test_each_augmentation_repeats_and_matches_the_cpu(clips):
    """Each augmentation on a speech-and-noise mix (change_speed on noise
    and a tone), three comparisons, each side from a fresh copy of the
    input: each side repeats bit for bit and each comparison holds its
    tolerance; then the phase vocoder at 0.8 and 1.2 on the CPU's STFT."""
    need_card()
    from softspoken_tpu_torch.train import augment as aug

    speech, noise = clips
    x = speech + 0.3 * noise
    rng = np.random.default_rng(9)
    loud = rng.normal(0, 0.2, x.shape).astype(np.float32)
    loud[1] = 0.4 * np.sin(2 * np.pi * 500 * np.arange(x.shape[1]) / 22050)
    g = torch.Generator()
    g.manual_seed(5)
    names = list(aug.PARAM_RANGES)
    digests = {"inputs": f"speech {_digest(speech)} noise {_digest(noise)} mix {_digest(x)} "
                         f"noise-and-tone {_digest(loud)}"}
    bad = []
    for name, params in zip(names, aug.get_parameters(g, names)):
        clip = loud if name == "change_speed" else x
        tol = SPEED_TOL if name == "change_speed" else AUG_TOL.get(name, AUG_TOL_POINTWISE)
        digests[name] = (f"clips {_digest(clip)} "
                         f"params {_digest(json.dumps(params, sort_keys=True).encode())}")
        cpus, cards = [], []
        for _ in range(REPEATS):
            cpus.append(aug.FUNC_MAP[name](torch.from_numpy(clip.copy()), **params))
            cards.append(aug.FUNC_MAP[name](torch.from_numpy(clip.copy()).cuda(), **params).cpu())
            err = float((cards[-1] - cpus[-1]).abs().max() / cpus[-1].abs().max())
            if not err <= tol:
                bad.append(f"{name}: {err:.3g} of the peak (tol {tol})")
        if not all(torch.equal(c, cpus[0]) for c in cpus[1:]):
            bad.append(f"{name}: the CPU does not repeat on the same input")
        if not all(torch.equal(c, cards[0]) for c in cards[1:]):
            bad.append(f"{name}: the card does not repeat on the same input")
    assert not bad, f"{bad}; digests {digests}"
    spec = aug._stft(torch.from_numpy(x))
    n_frames = spec.shape[-2]
    for sf in (0.8, 1.2):
        out_frames = n_frames if sf >= 1.0 else int(np.ceil((n_frames - 1) / sf)) + 1
        cpu = aug._phase_vocoder(spec, sf, out_frames=out_frames)
        card = aug._phase_vocoder(spec.cuda(), sf, out_frames=out_frames).cpu()
        assert float(((card - cpu).abs() > 1e-3 * cpu.abs().max()).float().mean()) <= 1e-5, sf


def test_build_batch_on_the_card_matches_the_cpu(clips):
    """``build_batch`` on both devices from one numpy seed (the same SNRs
    and per-row parameters), mel pinned to "highest": mel and spec within
    5e-3, at most 1% of the mask frames apart."""
    need_card()
    from softspoken_tpu_torch.train.data import build_batch

    speech, noise = clips
    augs = tuple(a for a in FIT_AUGS if a != "change_speed")
    got = build_batch(speech, noise, np.random.default_rng(7), augs, device="cuda",
                      mel_mode="highest")
    want = build_batch(speech, noise, np.random.default_rng(7), augs, device="cpu",
                       mel_mode="highest")
    for k in ("mel", "spec"):
        assert float((got[k].cpu() - want[k]).abs().max()) <= BATCH_MEL_TOL, k
    assert float((got["mask"].cpu() != want["mask"]).float().mean()) <= 0.01
