"""The trainers (the JAX package's ``train/fit.py``):

  * ``fit`` trains from directories of speech and noise recordings: random
    3 s clips read on the host (``ClipSampler``), mixed at a random SNR and
    augmented, their mels and targets computed on the device
    (``train/data.py::build_batch``), then one optimizer step;
  * ``fit_synthetic`` trains from the synthetic corpus, every step on the
    device.

Both take ``mesh`` (``parallel.make_mesh(("data", "seq"), ...)``) inside a
process group of one process per mesh entry (``train --mesh`` starts
them): each rank trains on its own mesh entry's device with the sharded
step (``loop.make_sharded_train_step``), makes every draw of the global
batch as the one-card run does, builds only its own rows, and rank 0 alone
writes the checkpoint and logs.

For ``fit_synthetic`` the host makes two clip pools from a seed
(``train/synth.py``) and uploads them once; every step then runs on the
device (``train/device_data.py``):
draws, synthesis, mel, targets, forward, backward and the AdamW update.
Fresh pools are generated on a background thread and swapped in through a
pinned host copy, so host work never blocks the device.  Checkpoints are
reference ``.pth`` files (``ckpt.save_pth``) that the port's ``Detector``
and the JAX package's ``ckpt.load_pth`` both read.
"""

from __future__ import annotations

import glob
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import ckpt as ckpt_mod
from ..engine.detector import resolve_device
from ..io import internal_length, load_audio
from . import data as D
from .loop import DTYPES, TrainState, create_train_state, train_step

log = logging.getLogger(__name__)


def _save_checkpoint(ckpt_out: str, state: TrainState, epoch: int, fatal: bool) -> None:
    """Persist the weights and BN statistics; a mid-run save failure must not
    kill a long training run (the final save still raises)."""
    try:
        ckpt_mod.save_pth(ckpt_out, state.model.state_dict(), epoch=epoch)
    except Exception:  # noqa: BLE001 — keep training, surface the failure
        if fatal:
            raise
        log.exception("checkpoint save failed at step %d (continuing)", epoch)


def list_wavs(directory: str) -> List[str]:
    return sorted(glob.glob(os.path.join(directory, "**", "*.wav"), recursive=True))


class ClipSampler:
    """Random 3 s internal-rate clips from a file pool (bounded reads)."""

    def __init__(self, files: Sequence[str], rng: np.random.Generator, tile_short: bool):
        if not files:
            raise ValueError("empty file pool")
        self.files = list(files)
        self.rng = rng
        self.tile_short = tile_short
        self._lengths = {f: internal_length(f) for f in self.files}

    def sample(self, read: bool = True) -> np.ndarray:
        """One clip; ``read=False`` makes the clip's draws and returns zeros
        without reading (another rank's row of a sharded batch)."""
        f = self.files[int(self.rng.integers(len(self.files)))]
        n = self._lengths[f]
        start = int(self.rng.integers(max(1, n - D.CLIP + 1)))
        if self.tile_short and n < D.CLIP:
            # a random tiling phase: start 0 would make every draw of a
            # sub-3 s file the same clip (the reference rotates start_idx
            # into the tiled read the same way)
            phase = int(self.rng.integers(max(1, n)))
            clip = D.load_environmental_noise(f, phase) if read else None
            if clip is not None:
                return clip
        if not read:
            return np.zeros(D.CLIP, np.float32)
        wav, _ = load_audio(f, start=start)
        clip = np.zeros(D.CLIP, np.float32)
        if wav is not None:
            m = min(len(wav), D.CLIP)
            clip[:m] = wav[:m]
        return clip

    def batch(self, b: int, rows: slice = slice(None)) -> np.ndarray:
        """``b`` clips, of which only ``rows`` are read (the rest zeros)."""
        keep = range(b)[rows]
        return np.stack([self.sample(read=i in keep) for i in range(b)])


def fit(
    speech_dir: str,
    noise_dir: str,
    steps: int = 1000,
    batch_size: int = 16,
    learning_rate: float = 1e-3,
    ckpt_out: Optional[str] = None,
    augmentations: Sequence[str] = ("add_reverb", "reduce_volume", "bandpass_filter"),
    seed: int = 0,
    mesh=None,
    log_every: int = 20,
    save_every: int = 200,
    on_metrics=None,
    resume: Optional[str] = None,
    train_dtype: str = "float32",
    boundary_weight: float = 0.0,
    device=None,
) -> Dict[str, float]:
    """Train from the WAVs under ``speech_dir`` and ``noise_dir``; returns
    the last logged metrics.

    Each step draws ``batch_size`` speech and noise clips on the host,
    builds the batch on ``device`` (the CUDA card unless the caller passes
    ``"cpu"``; raises without a card) and takes one optimizer step.  Every
    ``log_every`` steps and at the last, the losses are read once, logged
    and passed to ``on_metrics(step, metrics)``.  With ``mesh`` (see the
    module docstring) each rank reads and builds only its rows.
    """
    if train_dtype not in DTYPES:
        raise ValueError(f"train_dtype must be one of {sorted(DTYPES)}, got {train_dtype!r}")
    dev, rank = _mesh_device(mesh, device)
    rng = np.random.default_rng(seed)
    speech = ClipSampler(list_wavs(speech_dir), rng, tile_short=False)
    noise = ClipSampler(list_wavs(noise_dir), rng, tile_short=True)
    state = create_train_state(seed, learning_rate, resume=resume,
                               compute_dtype=DTYPES[train_dtype], device=dev)
    step0 = state.step
    rows = slice(None)
    if mesh is not None:
        from .loop import make_sharded_train_step

        sharded, shard = make_sharded_train_step(state, mesh,
                                                 boundary_weight=boundary_weight)
        data = mesh.shape["data"]
        if batch_size % data:
            raise ValueError(f"batch_size ({batch_size}) must be a multiple of the mesh "
                             f"'data' axis size ({data})")
        per = batch_size // data
        d = rank // mesh.shape.get("seq", 1)
        rows = slice(d * per, (d + 1) * per)

    metrics: Dict[str, float] = {}
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        batch = D.build_batch(speech.batch(batch_size, rows), noise.batch(batch_size, rows),
                              rng, augmentations=augmentations, device=dev, rows=rows)
        if mesh is None:
            m = train_step(state, batch, boundary_weight)
        else:
            m = sharded(state, shard(batch, axes=("seq",)))  # the rows are its own
        if step % log_every == 0 or step == steps:
            names = sorted(m)
            values = torch.stack([m[k] for k in names]).tolist()  # the one read
            metrics = dict(zip(names, values))
            if rank == 0:
                log.info("step %d  loss=%.4f  mask=%.4f  spec=%.4f  (%.1f clips/s)",
                         step, metrics["loss"], metrics["mask_loss"], metrics["spec_loss"],
                         step * batch_size / (time.perf_counter() - t0))
            if on_metrics:
                on_metrics(step, metrics)
        if ckpt_out and rank == 0 and (step % save_every == 0 or step == steps):
            _save_checkpoint(ckpt_out, state, step0 + step, fatal=step == steps)
    return metrics


def _mesh_device(mesh, device) -> "tuple[torch.device, int]":
    """(this process's device, its rank): ``device`` (the card unless the
    caller passes "cpu") and 0 without a mesh; else its mesh entry, which
    needs the process group that ``train --mesh`` starts."""
    if mesh is None:
        return resolve_device(device), 0
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("mesh training needs torch.distributed initialized with one "
                           "process per mesh entry (train --mesh starts them, or torchrun)")
    rank = dist.get_rank()
    return list(mesh.devices.flat)[rank], rank


def _host_pools(pools, pin: bool):
    """Host pools as tensors, pinned for an asynchronous copy to the card."""
    ts = tuple(torch.from_numpy(np.ascontiguousarray(p)) for p in pools)
    return tuple(t.pin_memory() for t in ts) if pin else ts


def fit_synthetic(
    steps: int = 2000,
    batch_size: int = 32,
    learning_rate: float = 1e-3,
    ckpt_out: Optional[str] = None,
    augmentations: Sequence[str] = ("add_reverb", "reduce_volume", "bandpass_filter"),
    seed: int = 0,
    mesh=None,
    n_inner: int = 10,
    pool_speech: int = 768,
    pool_noise: int = 768,
    pool_refresh_outer: int = 50,
    log_every_outer: int = 5,
    save_every_outer: int = 25,
    on_metrics=None,
    resume: Optional[str] = None,
    train_dtype: str = "float32",
    noise_extra_kinds: tuple = (),
    noise_extra_frac: float = 0.2,
    noise_extra_policy: str = "mixed",
    noise_extra_snr_range: tuple = (10.0, 20.0),
    noise_extra_silent_prob: float = 0.5,
    boundary_weight: float = 0.0,
    snr_db_range: tuple = (-5.0, 20.0),
    stall_abort_s: float = 900.0,
    device=None,
) -> Dict[str, float]:
    """Train from the synthetic corpus with fully on-device batch synthesis.

    Each outer iteration runs ``n_inner`` complete steps and then reads its
    averaged metrics once.  Every ``log_every_outer`` outer iterations the
    metrics are logged and passed to ``on_metrics(step, metrics)``; the
    metrics carry ``wall_seconds`` besides the losses: the host time since
    the loop began, the first outer iteration's set-up included.  Returns
    the last logged metrics.

    ``device``: the CUDA card unless the caller passes ``"cpu"``; raises
    without a card.  With ``mesh`` (see the module docstring) each rank
    synthesizes only its rows.
    """
    from . import synth
    from .device_data import (make_fused_train_step, make_sharded_fused_train_step,
                              make_synth_batch_fn)

    if noise_extra_policy not in ("mixed", "protected"):
        raise ValueError(f"unknown noise_extra_policy {noise_extra_policy!r}")
    if (noise_extra_policy == "protected" and noise_extra_kinds
            and int(pool_noise * noise_extra_frac) >= pool_noise):
        # extras_start would be 0 and the policy would silently fall back
        # to the mixed path, the opposite of what was requested
        raise ValueError(
            "noise_extra_policy='protected' requires noise_extra_frac < 1.0 "
            "(some non-extra noise must remain to mix under speech); got "
            f"noise_extra_frac={noise_extra_frac}")
    if train_dtype not in DTYPES:
        raise ValueError(f"train_dtype must be one of {sorted(DTYPES)}, got {train_dtype!r}")
    dev, rank = _mesh_device(mesh, device)
    pin = dev.type == "cuda"

    def upload(pools):
        return tuple(t.to(dev, non_blocking=True) for t in pools)

    rng = np.random.default_rng(seed)
    log.info("generating initial clip pools (%d speech + %d noise)…",
             pool_speech, pool_noise)
    speech_pool, noise_pool = upload(_host_pools(synth.make_pools(
        rng, pool_speech, pool_noise, extra_kinds=tuple(noise_extra_kinds),
        extra_frac=noise_extra_frac), pin))

    state = create_train_state(seed, learning_rate, resume=resume,
                               compute_dtype=DTYPES[train_dtype], device=dev)
    step0 = state.step
    # protected placement: make_pools appends the extra kinds as the LAST
    # extra_frac of the noise pool, so the region boundary is static
    n_extra = int(pool_noise * noise_extra_frac) if noise_extra_kinds else 0
    extras_start = (pool_noise - n_extra
                    if noise_extra_policy == "protected" and n_extra > 0 else None)
    synth_fn = make_synth_batch_fn(batch_size, augmentations,
                                   snr_db_range=tuple(snr_db_range),
                                   extras_start=extras_start,
                                   extras_snr_range=tuple(noise_extra_snr_range),
                                   extras_silent_prob=noise_extra_silent_prob)
    if mesh is None:
        step_fn = make_fused_train_step(synth_fn, n_inner=n_inner,
                                        boundary_weight=boundary_weight)
    else:
        step_fn = make_sharded_fused_train_step(state, synth_fn, mesh, n_inner=n_inner,
                                                boundary_weight=boundary_weight)

    outer_total = -(-steps // n_inner)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    pool_rng = np.random.default_rng(seed + 2)
    pool_pending = None
    metrics: Dict[str, float] = {}
    t0 = time.perf_counter()

    watchdog = (_StallWatchdog(stall_abort_s)
                if stall_abort_s and stall_abort_s > 0 else None)

    # the watchdog daemon must not outlive the loop: on an exception it
    # would os._exit(86) the whole process up to stall_abort_s later
    try:
        for outer in range(1, outer_total + 1):
            pinned = None
            if pool_refresh_outer:
                # swap in a fresh pool the moment its background generation
                # finishes; meanwhile keep training on the current pool.
                # Generations run on a daemon thread and are not started
                # near the end of the run.  Under a mesh every rank swaps at
                # the same step: when the last rank's generation finishes.
                failed, done = (pool_pending is not None and pool_pending.failed(),
                                pool_pending is not None and pool_pending.done())
                if mesh is not None and pool_pending is not None:
                    failed, done = _on_every_rank(failed, done, dev)
                    if failed:
                        raise RuntimeError("background pool refresh failed on a rank "
                                           f"of the mesh ({pool_pending.error})")
                if failed:
                    log.warning("background pool refresh failed (%s); will retry",
                                pool_pending.error)
                    pool_pending = None
                elif done:
                    # the pinned copy stays referenced until this outer
                    # iteration's metrics read has waited for the copy
                    pinned = pool_pending.result
                    speech_pool, noise_pool = upload(pinned)
                    log.info("swapped in a fresh clip pool at step %d", outer * n_inner)
                    pool_pending = None
                if (pool_pending is None
                        and outer % pool_refresh_outer == 0
                        and outer_total - outer >= pool_refresh_outer):
                    pool_pending = _DaemonJob(
                        lambda: _host_pools(synth.make_pools(
                            pool_rng, pool_speech, pool_noise,
                            extra_kinds=tuple(noise_extra_kinds),
                            extra_frac=noise_extra_frac), pin))
            m = step_fn(state, speech_pool, noise_pool, gen)
            names = sorted(m)
            values = torch.stack([m[k] for k in names]).tolist()  # the one read
            del pinned
            if watchdog is not None:
                watchdog.beat(outer)
            step = outer * n_inner
            if outer % log_every_outer == 0 or outer == outer_total:
                elapsed = time.perf_counter() - t0
                metrics = dict(zip(names, values), wall_seconds=elapsed)
                if rank == 0:
                    log.info(
                        "step %d/%d  loss=%.4f  mask=%.4f  spec=%.4f  (%.1f clips/s, "
                        "%.3f s/step)", step, outer_total * n_inner, metrics["loss"],
                        metrics["mask_loss"], metrics["spec_loss"], step * batch_size / elapsed,
                        elapsed / step)
                if on_metrics:
                    on_metrics(step, metrics)
            if ckpt_out and rank == 0 and (outer % save_every_outer == 0
                                           or outer == outer_total):
                _save_checkpoint(ckpt_out, state, step0 + step, fatal=outer == outer_total)
    finally:
        if watchdog is not None:
            watchdog.stop()
    return metrics


def _on_every_rank(failed: bool, done: bool, device: torch.device) -> "tuple[bool, bool]":
    """(failed on some rank, done on every rank), agreed in one all-reduce."""
    import torch.distributed as dist

    t = torch.tensor([0 if failed else 2 if done else 1], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t) == 0, int(t) == 2


class _StallWatchdog:
    """Abort the process when training stops making progress.

    A hang is worse than a crash here: checkpoints make restarts cheap, so
    when no heartbeat arrives within ``timeout_s`` the process exits with
    code 86, which supervisors treat as retryable.  A thread blocked inside
    a device call cannot be unwound from Python, hence ``os._exit``.
    """

    EXIT_CODE = 86

    def __init__(self, timeout_s: float, abort=None):
        self.timeout_s = timeout_s
        self._abort = abort if abort is not None else os._exit
        self._beat = {"t": time.monotonic(), "step": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._watch, daemon=True, name="train-stall-watchdog")
        self._thread.start()

    def beat(self, step: int) -> None:
        self._beat = {"t": time.monotonic(), "step": step}

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        poll = max(0.05, min(30.0, self.timeout_s / 4))
        while not self._stop.wait(poll):
            beat = self._beat
            quiet = time.monotonic() - beat["t"]
            if quiet > self.timeout_s:
                log.error(
                    "no training progress for %.0f s (device stall?) — aborting "
                    "with exit code %d so a supervisor can retry; last completed "
                    "outer step %d, latest checkpoint is resumable",
                    quiet, self.EXIT_CODE, beat["step"])
                self._abort(self.EXIT_CODE)
                return


class _DaemonJob:
    """One background computation on a daemon thread (never blocks exit)."""

    def __init__(self, fn, *args, **kwargs):
        self.result = None
        self.error: Exception | None = None
        self._done = threading.Event()

        def run():
            try:
                self.result = fn(*args, **kwargs)
            except Exception as e:  # surfaced by the training loop
                self.error = e
            finally:
                self._done.set()

        threading.Thread(target=run, daemon=True).start()

    def done(self) -> bool:
        # completion is the event alone, so a job whose fn returned None
        # is still done
        return self._done.is_set() and self.error is None

    def failed(self) -> bool:
        return self._done.is_set() and self.error is not None
