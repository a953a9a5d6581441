"""On-device training-batch synthesis (the JAX package's
``train/device_data.py``).

The host uploads two clip pools once, ``speech (Ns, 66150)`` and ``noise
(Nn, 66150)`` float32, and every batch is synthesized on the device: index
sampling, circular time shifts, SNR mixing, the per-row augmentations, the
mel frontend (``ops.mel.log_mel_clips``) and the mask/spec targets.  A
training step moves nothing to the device but the draws it samples there.

The synthesizer is split in two:

  * the **draws** (``SynthBatchFn.draw``): every random quantity of a batch,
    sampled with an explicit ``torch.Generator`` on the device: the pool
    rows, the silence flags, the SNRs with the protected policy's redraws
    (``sample_mix_rows``), the roll shifts, and each augmentation's per-row
    parameters (``sample_augment_params``);
  * the **transform** (``synth_from_draws``): everything else, a
    deterministic function of the pools and the draws.

JAX's ``jax.random`` streams cannot be reproduced in torch; the split lets
the tests feed the JAX synthesizer's own draws to the port's transform.

Target semantics: clean-speech mel → mask and spec channel 0, scaled noise
mel → spec channel 1; a ``silence_prob`` fraction of rows zero out the
speech so the detector sees true negatives.  The batch is in the port's
layout: ``mel`` (B, 128, 256), ``mask`` (B, 256), ``spec`` (B, 2, 128, 256).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import mel as melops
from .targets import frame_mask

log = logging.getLogger(__name__)

SR = 22050
CLIP = SR * 3

Draws = Dict[str, object]

DEVICE_AUGS = (
    "change_pitch",
    "add_reverb",
    "reduce_volume",
    "add_echo",
    "bandpass_filter",
    "add_harmonic_distortion",
    "compress_dynamics",
    "gain_ramp",
)
_FILTERS = ("add_reverb", "add_echo", "bandpass_filter")


# --------------------------------------------------------------------------
# per-row augmentations
#
# Every parameter is a per-row tensor.  The filtering augmentations (reverb
# taps, echo, first-order Butterworth band-pass) compose into one per-row
# frequency response applied in one rfft/irfft round trip.
# --------------------------------------------------------------------------

def _butter1_band_response(theta: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                           sr: float) -> torch.Tensor:
    """H(e^{jθ}) of scipy.signal.butter(1, [lo, hi], 'band').

    The analog first-order band-pass H(s) = BW·s / (s² + BW·s + w0²) at
    s = 4(z−1)/(z+1), with the prewarped edges w = 4·tan(π f / sr).
    """
    w1 = 4.0 * torch.tan(math.pi * lo / sr)
    w2 = 4.0 * torch.tan(math.pi * hi / sr)
    bw = w2 - w1
    w0sq = w1 * w2
    z = torch.exp(1j * theta)
    s = 4.0 * (z - 1.0) / (z + 1.0 + 1e-12)
    return (bw * s) / (s * s + bw * s + w0sq + 1e-12)


def _uniform(gen: torch.Generator, lohi: Tuple[float, float], shape) -> torch.Tensor:
    lo, hi = lohi
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def sample_augment_params(generator: torch.Generator, augmentations: Sequence[str],
                          batch_size: int) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-row parameters of each augmentation, in the ranges of
    ``augment.PARAM_RANGES`` (voice_activity.py:314-343)."""
    from .augment import PARAM_RANGES

    B, g = batch_size, generator
    col = (B, 1)
    draws = {
        "change_pitch": lambda: {"semitones": _uniform(g, (-3.0, 3.0), (B,))},
        "reduce_volume": lambda: {"level": _uniform(g, (0.1, 0.99), col)},
        "gain_ramp": lambda: {
            "start_db": _uniform(g, PARAM_RANGES["gain_ramp"]["start_db"], col),
            "end_db": _uniform(g, PARAM_RANGES["gain_ramp"]["end_db"], col)},
        "add_harmonic_distortion": lambda: {"k": _uniform(g, (10.0, 50.0), col)},
        "compress_dynamics": lambda: {
            "ratio": _uniform(g, (1.5, 6.0), col),
            "threshold_db": _uniform(g, (-40.0, -10.0), col)},
        "add_reverb": lambda: {
            "level": _uniform(g, (0.2, 0.8), col),
            "decay_time": _uniform(g, (0.2, 1.0), col),
            # the host path int-truncates uniform(1.0, 5.0) → {1..4}
            "n_delays": torch.randint(1, 5, col, generator=g, device=g.device).float()},
        "add_echo": lambda: {
            "delay_s": _uniform(g, (0.1, 0.7), col),
            "decay": _uniform(g, (0.3, 0.7), col)},
        "bandpass_filter": lambda: {
            "low_hz": _uniform(g, (100.0, 500.0), col),
            "high_hz": _uniform(g, (600.0, 2500.0), col)},
    }
    return {a: draws[a]() for a in augmentations}


def _change_pitch(mix, p):
    n = mix.shape[1]
    factor = 2.0 ** (p["semitones"] / 12.0)
    src = torch.arange(n, dtype=torch.float32, device=mix.device)[None, :] / factor[:, None]
    lo = torch.floor(src).long().clamp(0, n - 1)
    w = src - lo.float()
    hi = (lo + 1).clamp(max=n - 1)
    return (1.0 - w) * mix.gather(1, lo) + w * mix.gather(1, hi)


def _reduce_volume(mix, p):
    return mix * p["level"]


def _gain_ramp(mix, p):
    # linear-in-dB ramp; endpoints independent per row
    a, b = p["start_db"], p["end_db"]
    t = torch.linspace(0.0, 1.0, mix.shape[1], device=mix.device)[None, :]
    return mix * 10.0 ** ((a + (b - a) * t) / 20.0)


def _harmonic_distortion(mix, p):
    return torch.sign(mix) * (1.0 - torch.exp(-p["k"] * mix.abs()))


def _compress_dynamics(mix, p):
    thr = 10.0 ** (p["threshold_db"] / 20.0)
    mag = mix.abs()
    # below threshold the branch keeps the RAW value, so sign(x)·x
    # rectifies quiet negative samples: the reference's quirk, kept
    return torch.sign(mix) * torch.where(mag > thr, thr + (mag - thr) / p["ratio"], mix)


_POINTWISE = {"change_pitch": _change_pitch,
              "reduce_volume": _reduce_volume,
              "gain_ramp": _gain_ramp,
              "add_harmonic_distortion": _harmonic_distortion,
              "compress_dynamics": _compress_dynamics}


def _apply_filters(mix, group, params, sr):
    """One combined frequency response for adjacent filtering augmentations.
    The zero pad to a power of two turns circular filtering into linear
    convolution for every delay shorter than the pad (the longest reverb
    delay, 1 s, is far below the 2.9 s pad)."""
    B, n = mix.shape
    nfft = 1 << (n - 1).bit_length()
    theta = 2.0 * math.pi * torch.fft.rfftfreq(nfft, device=mix.device)
    H = torch.ones((B, theta.shape[0]), dtype=torch.complex64, device=mix.device)
    if "add_reverb" in group:
        p = params["add_reverb"]
        level, decay_time, n_del = p["level"], p["decay_time"], p["n_delays"]
        taps = torch.arange(5, dtype=torch.float32, device=mix.device)[None, :]  # (1, 5)
        live = (taps < n_del).float()                                           # (B, 5)
        # delays: linspace(0, sr·decay, k+1)[1:] ≈ (i+1)/k · sr·decay
        d = (taps + 1.0) / torch.clamp(n_del, min=1.0) * sr * decay_time
        g = torch.exp(-3.0 * taps / torch.clamp(n_del - 1.0, min=1.0)) * live
        g = g / g.sum(dim=1, keepdim=True)
        tap_resp = (g[..., None] * torch.exp(-1j * d[..., None] * theta)).sum(dim=1)
        H = H * ((1.0 - level) + level * tap_resp)
    if "add_echo" in group:
        p = params["add_echo"]
        d = p["delay_s"] * sr
        H = H * (1.0 + p["decay"] * torch.exp(-1j * d * theta))
    if "bandpass_filter" in group:
        p = params["bandpass_filter"]
        H = H * _butter1_band_response(theta[None, :], p["low_hz"], p["high_hz"], sr)
    padded = F.pad(mix, (0, nfft - n))
    return torch.fft.irfft(torch.fft.rfft(padded) * H, n=nfft)[:, :n].to(torch.float32)


def make_device_augment_fn(augmentations: Sequence[str], sr: int = SR):
    """Returns ``augment(mix (B, n), params) -> (B, n)`` applying the named
    augmentations with the per-row ``params`` of ``sample_augment_params``,
    in the caller's order.  Raises ``KeyError`` for an augmentation with no
    device implementation; ``change_speed`` is skipped with a warning."""
    augs = device_augmentations(augmentations)

    def augment(mix: torch.Tensor, params) -> torch.Tensor:
        # nonlinear augmentations do not commute with filtering, so the
        # caller's order holds; adjacent filters fuse into one FFT round
        # trip (they multiply in the frequency domain, so they commute)
        i = 0
        while i < len(augs):
            if augs[i] in _FILTERS:
                group = []
                while i < len(augs) and augs[i] in _FILTERS:
                    group.append(augs[i])
                    i += 1
                mix = _apply_filters(mix, group, params, sr)
            else:
                mix = _POINTWISE[augs[i]](mix, params[augs[i]])
                i += 1
        return mix.to(torch.float32)

    return augment


def device_augmentations(augmentations: Sequence[str]) -> Tuple[str, ...]:
    """The augmentations the device path applies, in the caller's order."""
    augs = tuple(a for a in augmentations if a in DEVICE_AUGS)
    unknown = set(augmentations) - set(augs)
    if unknown - {"change_speed"}:
        raise KeyError(f"no device augmentation for {sorted(unknown)}")
    if "change_speed" in unknown:
        log.warning(
            "change_speed has no traced device implementation (variable-"
            "length output breaks the fixed batch shape); it is SKIPPED on "
            "the --synthetic path. The host `fit` path does apply it."
        )
    return augs


# --------------------------------------------------------------------------
# draws and the transform
# --------------------------------------------------------------------------

def sample_mix_rows(
    generator: torch.Generator,
    batch_size: int,
    n_speech: int,
    n_noise: int,
    snr_db_range: Tuple[float, float],
    silence_prob: float,
    extras_start: Optional[int] = None,
    extras_snr_range: Tuple[float, float] = (10.0, 20.0),
    extras_silent_prob: float = 0.5,
) -> Dict[str, torch.Tensor]:
    """Per-row ``si, ni`` (B,) int64 and ``keep, snr_db`` (B, 1) float32.

    ``extras_start`` marks where the opt-in confuser textures begin in the
    noise pool (``synth.make_pools`` appends them at the tail) and switches
    on the **protected placement policy**: silent rows draw from the extras
    region with probability ``extras_silent_prob`` (pure negatives at
    natural level), and speech rows that drew an extras clip get their SNR
    redrawn from ``extras_snr_range``, so the hard low-SNR mixes stay
    in-distribution environment noise.
    """
    B, g = batch_size, generator
    si = torch.randint(0, n_speech, (B,), generator=g, device=g.device)
    ni = torch.randint(0, n_noise, (B,), generator=g, device=g.device)
    keep = (torch.rand((B, 1), generator=g, device=g.device) >= silence_prob).float()
    snr_db = _uniform(g, snr_db_range, (B, 1))
    if extras_start is not None and 0 < extras_start < n_noise:
        ni_extra = torch.randint(extras_start, n_noise, (B,), generator=g, device=g.device)
        silent = keep[:, 0] < 0.5
        force = (torch.rand((B,), generator=g, device=g.device) < extras_silent_prob) & silent
        ni = torch.where(force, ni_extra, ni)
        is_extra = (ni >= extras_start)[:, None]
        snr_hi = _uniform(g, extras_snr_range, (B, 1))
        snr_db = torch.where(is_extra & (keep > 0.5), snr_hi, snr_db)
    return {"si": si, "ni": ni, "keep": keep, "snr_db": snr_db}


def synth_from_draws(speech_pool: torch.Tensor, noise_pool: torch.Tensor, draws: Draws,
                     augmentations: Sequence[str] = (),
                     mel_mode: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The batch ``{"mel", "mask", "spec"}`` the draws describe.

    ``draws``: ``si, ni, keep, snr_db`` (``sample_mix_rows``), ``shift``
    (B,) int64 and ``aug`` (``sample_augment_params``), on the pools'
    device.  ``mel_mode`` defaults to ``ops.mel.train_mel_mode`` of that
    device.
    """
    mode = mel_mode or melops.train_mel_mode(speech_pool.device)
    speech = speech_pool[draws["si"]]
    noise = noise_pool[draws["ni"]]
    keep, snr_db = draws["keep"], draws["snr_db"]

    # circular time shift decorrelates repeated pool draws (jnp.roll per row)
    n = speech.shape[1]
    idx = (torch.arange(n, device=speech.device)[None, :] - draws["shift"][:, None]) % n
    speech = speech.gather(1, idx)

    # true negatives: drop speech entirely on some rows
    speech = speech * keep
    sp_rms = torch.sqrt(torch.mean(speech ** 2, dim=1, keepdim=True) + 1e-12)
    nz_rms = torch.sqrt(torch.mean(noise ** 2, dim=1, keepdim=True) + 1e-12)
    gain = sp_rms / (nz_rms * 10.0 ** (snr_db / 20.0))
    # silent rows: keep the noise at its natural level instead of ×~0
    gain = torch.where(keep > 0, gain, torch.ones_like(gain))
    noise_scaled = noise * gain

    mix = speech + noise_scaled
    if augmentations:
        mix = make_device_augment_fn(augmentations)(mix, draws["aug"])

    mel_mix = melops.log_mel_clips(mix, mode)
    mel_speech = melops.log_mel_clips(speech, mode)
    mel_noise = melops.log_mel_clips(noise_scaled, mode)
    mask = frame_mask(torch.where(mel_speech > 1e-4, mel_speech, torch.zeros_like(mel_speech)))
    return {"mel": mel_mix, "mask": mask, "spec": torch.stack([mel_speech, mel_noise], dim=1)}


class SynthBatchFn:
    """``synth(speech_pool, noise_pool, generator) -> batch``: ``draw`` then
    ``transform``.  Built by ``make_synth_batch_fn``."""

    def __init__(self, batch_size: int, augmentations: Sequence[str] = (),
                 snr_db_range: Tuple[float, float] = (-5.0, 20.0),
                 silence_prob: float = 0.2, extras_start: Optional[int] = None,
                 extras_snr_range: Tuple[float, float] = (10.0, 20.0),
                 extras_silent_prob: float = 0.5, mel_mode: Optional[str] = None):
        self.batch_size = batch_size
        self.augmentations = device_augmentations(augmentations)
        self.snr_db_range = tuple(snr_db_range)
        self.silence_prob = silence_prob
        self.extras_start = extras_start
        self.extras_snr_range = tuple(extras_snr_range)
        self.extras_silent_prob = extras_silent_prob
        self.mel_mode = mel_mode

    def draw(self, generator: torch.Generator, n_speech: int, n_noise: int) -> Draws:
        B = self.batch_size
        d = sample_mix_rows(generator, B, n_speech, n_noise, self.snr_db_range,
                            self.silence_prob, self.extras_start, self.extras_snr_range,
                            self.extras_silent_prob)
        d["shift"] = torch.randint(0, CLIP, (B,), generator=generator, device=generator.device)
        d["aug"] = sample_augment_params(generator, self.augmentations, B)
        return d

    def transform(self, speech_pool: torch.Tensor, noise_pool: torch.Tensor,
                  draws: Draws) -> Dict[str, torch.Tensor]:
        return synth_from_draws(speech_pool, noise_pool, draws, self.augmentations,
                                self.mel_mode)

    def __call__(self, speech_pool: torch.Tensor, noise_pool: torch.Tensor,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        draws = self.draw(generator, speech_pool.shape[0], noise_pool.shape[0])
        return self.transform(speech_pool, noise_pool, draws)


def make_synth_batch_fn(
    batch_size: int,
    augmentations: Sequence[str] = (),
    snr_db_range: Tuple[float, float] = (-5.0, 20.0),
    silence_prob: float = 0.2,
    extras_start: Optional[int] = None,
    extras_snr_range: Tuple[float, float] = (10.0, 20.0),
    extras_silent_prob: float = 0.5,
    mel_mode: Optional[str] = None,
) -> SynthBatchFn:
    """``extras_start`` (optional) enables the protected confuser-placement
    policy, see :func:`sample_mix_rows`."""
    return SynthBatchFn(batch_size, augmentations, snr_db_range, silence_prob,
                        extras_start, extras_snr_range, extras_silent_prob, mel_mode)


DrawFn = Callable[[torch.Generator, int, int], Draws]


def make_fused_train_step(synth_fn: SynthBatchFn, n_inner: int = 8,
                          boundary_weight: float = 0.0, draw_fn: Optional[DrawFn] = None):
    """Returns ``step(state, speech_pool, noise_pool, generator) -> metrics``:
    ``n_inner`` full {draw → synthesize → forward → backward → update}
    steps on one stream, with the metrics averaged over them and left on
    the device (the caller reads them once per call).

    ``draw_fn(generator, n_speech, n_noise) -> draws`` defaults to
    ``synth_fn.draw``; the tests pass the JAX synthesizer's draws in here.
    """
    from .loop import train_step

    draw = draw_fn or synth_fn.draw

    def fused(state, speech_pool: torch.Tensor, noise_pool: torch.Tensor,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
        ms = []
        for _ in range(n_inner):
            with torch.no_grad():
                draws = draw(generator, speech_pool.shape[0], noise_pool.shape[0])
                batch = synth_fn.transform(speech_pool, noise_pool, draws)
            ms.append(train_step(state, batch, boundary_weight))
        return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    return fused


def slice_draws(draws: Draws, rows: slice) -> Draws:
    """The draws of rows ``rows`` of the batch (every per-row tensor cut
    along its first axis)."""
    out: Draws = {}
    for k, v in draws.items():
        out[k] = slice_draws(v, rows) if isinstance(v, dict) else v[rows]
    return out


def make_sharded_fused_train_step(state, synth_fn: SynthBatchFn, mesh, n_inner: int = 8,
                                  boundary_weight: float = 0.0,
                                  draw_fn: Optional[DrawFn] = None):
    """``make_fused_train_step`` over ``mesh`` in a process group of one
    process per mesh entry (every rank calls this once): each inner step
    draws the whole batch on every rank (the one-card run's draws, from
    the same generator), synthesizes only this rank's rows, keeps this
    rank's time block, and takes the sharded step
    (``loop.make_sharded_train_step``'s).  Returns ``step(state,
    speech_pool, noise_pool, generator) -> metrics``, the global metrics
    averaged over the inner steps."""
    from ..parallel.grid import ProcessGrid, shard_batch, shard_model
    from .loop import batch_partition_specs, global_metrics, sharded_step

    grid = ProcessGrid(mesh)
    B = synth_fn.batch_size
    if B % grid.data:
        raise ValueError(f"batch_size ({B}) must be a multiple of the mesh 'data' "
                         f"axis size ({grid.data})")
    shard_time = mesh.shape.get("seq", 1) > 1  # a 1-wide axis splits nothing
    shard_model(state.model, grid, shard_time)
    specs = batch_partition_specs(mesh, shard_time)
    per = B // grid.data
    rows = slice(grid.d * per, (grid.d + 1) * per)
    draw = draw_fn or synth_fn.draw

    def fused(state, speech_pool: torch.Tensor, noise_pool: torch.Tensor,
              generator: torch.Generator) -> Dict[str, torch.Tensor]:
        ms = []
        for _ in range(n_inner):
            with torch.no_grad():
                draws = draw(generator, speech_pool.shape[0], noise_pool.shape[0])
                batch = synth_fn.transform(speech_pool, noise_pool, slice_draws(draws, rows))
                batch = shard_batch(batch, specs, grid, axes=("seq",))
            ms.append(sharded_step(state, batch, grid, shard_time, boundary_weight))
        return global_metrics({k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]},
                              grid)

    return fused
