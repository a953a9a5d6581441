"""The port's training batch synthesizer against the JAX package's.

JAX's ``jax.random`` streams cannot be reproduced in torch, so the port
splits its synthesizer into draws and a deterministic transform
(``synth_from_draws``).  ``torch_train_ref.jax_draws`` re-derives the JAX
synthesizer's draws from its key by the JAX package's own splits
(``sample_mix_rows``; ``randint(k_roll)``; ``fold_in(k_aug, index)`` and the
``u()`` calls of ``make_device_augment_fn``) and feeds them to the port.

Tolerances.  The mel is ``sqrt(log10(1 + P))`` in float32: below P ≈ 2^-23
the sum 1 + P rounds, so near zero the mel moves in steps of about 2.3e-4,
and float32 differences of the FFT and matmul libraries at the level of one
rounding can move a near-silent bin by a step or two; 1e-3 covers that.  The
mask thresholds the speech mel at 1e-4, so it may differ only on columns
whose speech mel peaks within that tolerance of the threshold.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softspoken_tpu.ops import mel as jmel
from softspoken_tpu.train import device_data as jdd
from softspoken_tpu.train import loop as jloop
from softspoken_tpu.train import synth as jsynth
from softspoken_tpu.train import targets as jtargets
from softspoken_tpu.train.augment import PARAM_RANGES as J_PARAM_RANGES
from softspoken_tpu_torch.ops import mel as tmel
from softspoken_tpu_torch.train import augment as taugment
from softspoken_tpu_torch.train import device_data as tdd
from softspoken_tpu_torch.train import loop as tloop
from softspoken_tpu_torch.train import synth as tsynth
from softspoken_tpu_torch.train import targets as ttargets

from torch_train_ref import CLIP, jax_aug_params, jax_draws

torch.set_num_threads(2)

MEL_TOL = 1e-3
ALL_EIGHT = ("gain_ramp", "compress_dynamics", "add_echo", "bandpass_filter",
             "add_reverb", "change_pitch", "add_harmonic_distortion", "reduce_volume")


# ---------------------------------------------------------------------------
# host generators, targets, mel

@pytest.mark.parametrize("n_speech,n_noise,kinds,frac", [
    (2, 2, (), 0.2),
    (1, 6, ("music", "granular", "drone", "impact_chain", "crackle"), 0.7),
], ids=["default", "extra_kinds"])
def test_make_pools_bit_identical_to_jax(n_speech, n_noise, kinds, frac):
    """The same numpy stream through copied generators: exactly equal."""
    want = jsynth.make_pools(np.random.default_rng(21), n_speech, n_noise,
                             extra_kinds=kinds, extra_frac=frac)
    got = tsynth.make_pools(np.random.default_rng(21), n_speech, n_noise,
                            extra_kinds=kinds, extra_frac=frac)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_param_ranges_equal_jax():
    assert taugment.PARAM_RANGES == J_PARAM_RANGES


def test_log_mel_clips_matches_jax():
    """Float32 on both sides (JAX's precision=None is float32 on the CPU):
    only the summation order differs (measured ~2e-6 on values up to ~1)."""
    clips = np.random.default_rng(6).uniform(-0.5, 0.5, (3, CLIP)).astype(np.float32)
    want = np.asarray(jax.jit(jmel.log_mel_clips)(jnp.asarray(clips)))
    got = tmel.log_mel_clips(torch.from_numpy(clips))
    assert got.shape == (3, 128, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert tmel.train_mel_mode(torch.device("cpu")) == "highest"
    assert tmel.train_mel_mode(torch.device("cuda")) == "default"


def test_targets_match_jax():
    rng = np.random.default_rng(2)
    spec = rng.uniform(0.0, 1.0, (3, 128, 256)).astype(np.float32)
    spec[:, :, rng.integers(0, 256, 40)] = 0.0
    want = np.asarray(jtargets.frame_mask(jnp.asarray(spec)))
    np.testing.assert_array_equal(ttargets.frame_mask(torch.from_numpy(spec)).numpy(), want)
    np.testing.assert_array_equal(ttargets.frame_mask_np(spec), jtargets.frame_mask_np(spec))
    db = rng.uniform(-80.0, 0.0, (260, 260)).astype(np.float32)
    np.testing.assert_array_equal(ttargets.process_spec(db), jtargets.process_spec(db))
    np.testing.assert_array_equal(ttargets.process_spec(np.zeros((260, 260))),
                                  jtargets.process_spec(np.zeros((260, 260))))


@pytest.mark.parametrize("bw", [0.5, 2.0])
def test_boundary_weights_match_jax(bw):
    """Same float32 arithmetic in another order: 1e-6."""
    rng = np.random.default_rng(3)
    runs = rng.uniform(size=(4, 256)) > 0.97            # sparse toggles → runs
    mask = (np.cumsum(runs, axis=1) % 2).astype(np.float32)
    mask[0] = 0.0                                        # a row with no transition
    mask[1, -3:] = 1.0 - mask[1, -4]                     # a transition at the edge
    want = np.asarray(jloop.boundary_weights(jnp.asarray(mask), bw))
    got = tloop.boundary_weights(torch.from_numpy(mask), bw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# augmentations and the transform

@pytest.mark.parametrize("aug", jdd._DEVICE_AUGS)
def test_each_augmentation_matches_jax(aug):
    """Signal level, JAX's own parameters: within 1e-6·max|mix| (float32
    FFT round-off for the filters).  change_pitch reads the source at
    j/factor; past the clip's end (j/factor > n−1, rows that lower the
    pitch) the reference extrapolates, (1−w)·x[n−1] + w·x[n−1] with w up to
    ~n/5, which loses log2(w) bits to rounding that each library contracts
    differently: there the bound is 2^-21·(1+w)·|x[n−1]|."""
    rng = np.random.default_rng(9)
    B, n = 6, CLIP
    mix = (0.3 * rng.standard_normal((B, n))).astype(np.float32)
    k_aug = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(jdd.make_device_augment_fn((aug,)))(jnp.asarray(mix), k_aug))
    params = jax_aug_params(k_aug, (aug,), B)
    got = tdd.make_device_augment_fn((aug,))(torch.from_numpy(mix), params).numpy()
    tol = np.full((B, n), 1e-6 * np.abs(mix).max(), np.float32)
    if aug == "change_pitch":
        factor = 2.0 ** (params[aug]["semitones"].numpy().astype(np.float64) / 12.0)
        w = np.arange(n)[None, :] / factor[:, None] - (n - 1)
        tail = w > 0
        assert tail.any() and (~tail).any()
        tol = np.where(tail, 2.0 ** -21 * (1.0 + w) * np.abs(mix[:, -1:]), tol)
    assert np.all(np.abs(got - want) <= tol)


def _pools(n_speech=3, n_noise=3, **kw):
    return jsynth.make_pools(np.random.default_rng(3), n_speech, n_noise, **kw)


@pytest.mark.parametrize("augs", [(), ("add_reverb", "reduce_volume"), ALL_EIGHT],
                         ids=["none", "cli_default", "all_eight_reordered"])
def test_synth_from_draws_matches_jax(augs):
    """Key 2 draws three speech rows and one silent row, and for the
    all-eight case only pitch-raising factors (rows that lower the pitch
    read past the clip's end, see test_each_augmentation_matches_jax)."""
    sp, nz = _pools()
    B, key = 4, jax.random.PRNGKey(2)
    want = jax.jit(jdd.make_synth_batch_fn(B, augs))(jnp.asarray(sp), jnp.asarray(nz), key)
    draws = jax_draws(key, B, 3, 3, augs)
    if "change_pitch" in augs:
        assert (draws["aug"]["change_pitch"]["semitones"] >= 0).all()
    assert 0 < int(draws["keep"].sum()) < B
    got = tdd.synth_from_draws(torch.from_numpy(sp), torch.from_numpy(nz), draws, augs)
    _assert_batch_matches(got, want)


def test_synth_from_draws_protected_policy_matches_jax():
    sp, nz = _pools(3, 6, extra_kinds=("granular", "drone"), extra_frac=0.5)
    B, key, start = 6, jax.random.PRNGKey(1), 3
    kw = {"extras_start": start, "extras_snr_range": (10.0, 20.0), "extras_silent_prob": 0.5}
    want = jax.jit(jdd.make_synth_batch_fn(B, (), **kw))(jnp.asarray(sp), jnp.asarray(nz), key)
    draws = jax_draws(key, B, 3, 6, **kw)
    assert bool((draws["ni"] >= start).any()) and int(draws["keep"].sum()) < B
    got = tdd.synth_from_draws(torch.from_numpy(sp), torch.from_numpy(nz), draws)
    _assert_batch_matches(got, want)


def _assert_batch_matches(got, want):
    mel_j = np.asarray(want["mel"])[..., 0]
    spec_j = np.asarray(want["spec"]).transpose(0, 3, 1, 2)
    assert got["mel"].shape == mel_j.shape and got["spec"].shape == spec_j.shape
    np.testing.assert_allclose(got["mel"].numpy(), mel_j, atol=MEL_TOL)
    np.testing.assert_allclose(got["spec"].numpy(), spec_j, atol=MEL_TOL)
    mask_j = np.asarray(want["mask"])
    differ = got["mask"].numpy() != mask_j
    peak = spec_j[:, 0].max(axis=1)                      # speech mel, per column
    assert np.all(np.abs(peak[differ] - 1e-4) <= MEL_TOL)


# ---------------------------------------------------------------------------
# the port's own draws

def test_sampler_draws_are_seeded_and_in_range():
    fn = tdd.make_synth_batch_fn(64, ALL_EIGHT)
    a = fn.draw(torch.Generator().manual_seed(3), 5, 7)
    b = fn.draw(torch.Generator().manual_seed(3), 5, 7)
    assert list(a["aug"]) == list(ALL_EIGHT)
    for k in ("si", "ni", "keep", "snr_db", "shift"):
        assert torch.equal(a[k], b[k])
    assert a["si"].shape == (64,) and int(a["si"].max()) < 5 and int(a["ni"].max()) < 7
    assert a["keep"].shape == (64, 1) and set(a["keep"].unique().tolist()) <= {0.0, 1.0}
    assert float(a["snr_db"].min()) >= -5.0 and float(a["snr_db"].max()) < 20.0
    assert int(a["shift"].min()) >= 0 and int(a["shift"].max()) < CLIP
    nd = a["aug"]["add_reverb"]["n_delays"]
    assert set(nd.unique().tolist()) <= {1.0, 2.0, 3.0, 4.0}
    lo, hi = taugment.PARAM_RANGES["gain_ramp"]["start_db"]
    assert lo <= float(a["aug"]["gain_ramp"]["start_db"].min()) <= float(
        a["aug"]["gain_ramp"]["start_db"].max()) < hi


def test_sampler_protected_policy_semantics():
    """Extras under speech only in the protected SNR range; silent rows
    steered into the extras region at about p + (1−p)·frac."""
    g = torch.Generator().manual_seed(7)
    d = tdd.sample_mix_rows(g, 4096, 100, 100, (-5.0, 20.0), 0.5, extras_start=80,
                            extras_snr_range=(10.0, 20.0), extras_silent_prob=0.5)
    is_extra, speechy = d["ni"] >= 80, d["keep"][:, 0] > 0.5
    assert bool((d["snr_db"][:, 0][is_extra & speechy] >= 10.0).all())
    assert int((is_extra & speechy).sum()) > 10
    assert 0.5 < float(is_extra[~speechy].float().mean()) < 0.7


def test_unknown_augmentation_raises_and_change_speed_warns(caplog):
    with pytest.raises(KeyError, match="no device augmentation"):
        tdd.make_synth_batch_fn(2, ("reduce_volume", "time_warp"))
    with caplog.at_level(logging.WARNING):
        fn = tdd.make_synth_batch_fn(2, ("change_speed", "reduce_volume"))
    assert fn.augmentations == ("reduce_volume",)
    assert any("change_speed" in r.message for r in caplog.records)


def test_synth_batch_fn_runs_with_its_own_draws():
    sp, nz = (torch.from_numpy(x) for x in _pools(2, 2))
    batch = tdd.make_synth_batch_fn(3, ("add_reverb", "reduce_volume"))(
        sp, nz, torch.Generator().manual_seed(0))
    assert batch["mel"].shape == (3, 128, 256) and batch["mask"].shape == (3, 256)
    assert batch["spec"].shape == (3, 2, 128, 256)
    for v in batch.values():
        assert bool(torch.isfinite(v).all())
    assert set(batch["mask"].unique().tolist()) <= {0.0, 1.0}
