"""The detector: weights, numerics, the batched mel + U-Net forward, and the
host pipeline.

Reference behaviour (not its structure):
  * NNDetector.__init__/load_checkpoint  — NNDetector.py:21-53
  * process_batch (3 s slices → model)   — NNDetector.py:84-101
  * the worker's per-file loop           — worker.py:49-128
  * average_overlapping_detections       — NNDetector.py:153-190
  * find_speech_regions                  — NNDetector.py:103-143

Two pipelines, chosen by ``engine.pipeline``; "auto" is "fused" on the
CUDA card and "host" elsewhere (the JAX package's rule, with the card in
place of its TPU):
  * fused (``engine/fused.py``): raw PCM to the device; resample, mel,
    U-Net and the overlap grid run there chunk by chunk.
  * host (below): decode and resample on the host (or the resample on the
    device, ``resample_backend``), one upload per chunk, the U-Net batch by
    batch, one fetch per chunk, and the grid averaged on the host in
    float64.  It pads in the internal domain as the reference does, so it
    is held against the JAX host pipeline, not against fused.

Numerics.  "parity": float32 everywhere with TF32 off and the mel DFT in
float32 ("highest") through the plain torch chain.  "fast": bfloat16 convs
with float32 accumulation, and the mel frontend through the hand-written
CUDA kernel K1 (``ops/frame_mel.py``) with a one-pass bf16 DFT ("default")
and bf16 output.  ``mel_kernel`` / ``mel_precision`` pin either explicitly;
``mel_kernel="pallas"`` selects the float32 DFT→mel kernel K2
(``ops/dft_mel.py``), where the mel precision does not apply.

The detection path computes the mask head only (``SpecUNet2D.mask_logits``);
``process_batch`` returns both heads.  Not ported yet, and raising
``NotImplementedError`` at use: the music post-filter
(``engine.music_filter``), chunk journaling (``chunk_checkpoint_every``,
``journal_dir``), the lossy upload wires, ``decoder_upsample="phase"``,
``conv_impl="packed"`` and orbax checkpoint directories.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import ckpt as ckpt_mod
from ..config import Config, DEFAULT_CONFIG
from ..io import internal_length, load_audio, stream_chunks
from ..models import build_model
from ..ops import mel as melops
from . import regions as R
from .planner import num_windows_for_padded_length, window_starts

log = logging.getLogger(__name__)


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card; raises when there is none.  Pass
    ``device="cpu"`` explicitly to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: softspoken_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def resolve_pipeline(pipeline: str, device: torch.device) -> str:
    """``engine.pipeline``: "auto" is "fused" on the card, "host" elsewhere."""
    if pipeline == "auto":
        return "fused" if device.type == "cuda" else "host"
    if pipeline not in ("fused", "host"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    return pipeline


def resolve_resample_backend(backend: str, device: torch.device) -> str:
    """``engine.resample_backend``: "auto" is "device" on the card, "host"
    elsewhere."""
    if backend == "auto":
        return "device" if device.type == "cuda" else "host"
    if backend not in ("host", "device"):
        raise ValueError(f"unknown resample_backend {backend!r}")
    return backend


@dataclasses.dataclass
class DetectionResult:
    """Per-file detection output (times already −pad-shifted, seconds)."""

    intervals: List[Tuple[float, float]]
    avg_values: np.ndarray          # averaged raw logits per covered grid bin
    num_windows: int
    audio_seconds: float            # unpadded duration of the input

    def averaged_detections(self) -> List[Tuple[float, str]]:
        """Reference-shaped [(avg, "%.4f" time)] list (NNDetector.py:179-187)."""
        return [(float(v), f"{i * R.TIME_RESOLUTION:.4f}")
                for i, v in enumerate(self.avg_values)]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to softspoken_tpu_torch yet "
                               "(see ROADMAP.md)")


class Detector:
    """Sliding-window speech detector over the mel + U-Net forward."""

    def __init__(
        self,
        config: Config = DEFAULT_CONFIG,
        state_dict: Optional[Mapping[str, object]] = None,
        checkpoint_path: Optional[str] = None,
        fold: bool = True,
        device=None,
    ):
        self.cfg = config
        self.device = resolve_device(device)
        self.epoch = -1
        eng = config.engine
        if eng.music_filter is not None:
            raise _not_ported("the music post-filter (engine.music_filter)")
        if eng.decoder_upsample not in ("auto", "concat"):
            raise _not_ported(f"decoder_upsample={eng.decoder_upsample!r}")
        if eng.conv_impl not in ("auto", "direct"):
            raise _not_ported(f"conv_impl={eng.conv_impl!r}")
        self.pipeline = resolve_pipeline(eng.pipeline, self.device)
        self.resample_backend = resolve_resample_backend(eng.resample_backend, self.device)

        if state_dict is None:
            path = checkpoint_path or os.path.join(
                config.paths.model_dir, config.paths.model_name)
            if os.path.isfile(path):
                state_dict, self.epoch = ckpt_mod.load_pth(path)
            elif os.path.isdir(path):
                raise _not_ported(
                    f"reading orbax checkpoint directories ({path}); export it "
                    "to .pth with the JAX package's convert-ckpt command")
            else:
                # the reference degrades to an untrained model (NNDetector.py:51-53)
                log.warning("no checkpoint found at %s; using random init", path)
                state_dict = ckpt_mod.fixture_state_dict(seed=0)

        self.fast = eng.precision != "parity"
        self.dtype = torch.bfloat16 if self.fast else torch.float32
        self.model = build_model(state_dict, folded=fold).to(
            device=self.device, dtype=self.dtype)

        mp = eng.mel_precision
        if mp == "auto":
            mp = "default" if self.fast else "highest"
        if mp not in melops.MODES:
            raise ValueError(f"unknown mel_precision {mp!r}")
        self.mel_mode = mp
        mk = eng.mel_kernel
        if mk == "auto":
            # parity mode keeps the plain chain: the kernel's summation order
            # differs from it by ~1e-6 (the JAX package's same carve-out)
            mk = "fused" if (self.fast and self.device.type == "cuda") else "xla"
        if mk not in ("fused", "pallas", "xla"):
            raise ValueError(f"unknown mel_kernel {mk!r}")
        self.mel_kernel = mk
        self._engines: Dict[tuple, object] = {}

    # ------------------------------------------------------------------
    def _forward(self, wave: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """(chunk_buf,) f32, (B,) int32 on the device → mask logits (B, 256) f32."""
        with torch.inference_mode(), melops.fp32_matmul():
            if self.mel_kernel == "fused":
                from ..ops.frame_mel import log_mel_windows_fused

                mel = log_mel_windows_fused(wave, starts, self.mel_mode,
                                            out_dtype=self.dtype)
            elif self.mel_kernel == "pallas":
                from ..ops.dft_mel import log_mel_windows_dft

                mel = log_mel_windows_dft(wave, starts)  # float32; the model casts
            else:
                mel = melops.log_mel_windows(wave, starts, self.mel_mode)
            return self.model.mask_logits(mel)

    def _forward_full(self, wave: torch.Tensor, starts: torch.Tensor):
        """Like ``_forward`` through the plain mel chain, with the spec head:
        (spec (B, 2, 128, 256), mask logits (B, 256)), float32."""
        with torch.inference_mode(), melops.fp32_matmul():
            return self.model(melops.log_mel_windows(wave, starts, self.mel_mode))

    def chunk_windows(self) -> int:
        """Windows per chunk: the multiple of device_batch nearest to
        chunk_seconds' window count."""
        cfg = self.cfg
        w = int(cfg.engine.chunk_seconds * cfg.dsp.sample_rate // cfg.samples_per_step)
        B = cfg.engine.device_batch
        return max(B, int(round(w / B)) * B)

    def chunk_buffer_len(self) -> int:
        """Chunk buffer: a chunk's windows + the full last window."""
        cfg = self.cfg
        return (self.chunk_windows() - 1) * cfg.samples_per_step + cfg.samples_per_window

    # ------------------------------------------------------------------
    # the reference's API
    # ------------------------------------------------------------------
    def plan_detection_job(self, files: Sequence[str]) -> Dict[str, np.ndarray]:
        from .planner import plan_detection_job

        return plan_detection_job(files, self.cfg)

    def process_batch(self, audio_data: np.ndarray, batch_indexes):
        """Reference-shaped single-batch API (NNDetector.py:84-101): padded
        audio + start indexes → (speech_pred (B, 2, 128, 256), mask_pred
        (B, 1, 256)) numpy arrays in the reference's NCHW layout."""
        idxs = np.asarray(batch_indexes, np.int64)
        if idxs.size == 0:
            return (np.zeros((0, 2, 128, 256), np.float32),
                    np.zeros((0, 1, 256), np.float32))
        spw = self.cfg.samples_per_window
        if int(idxs.max()) + spw > np.iinfo(np.int32).max:
            # device indexes are int32; wrapping would score the wrong audio
            # (the chunked detect_file/detect_waveform take any length)
            raise ValueError(
                f"start index {int(idxs.max())} exceeds the int32 device index "
                "range; use the chunked detect_file/detect_waveform APIs for "
                "very long recordings")
        wave = np.zeros(max(int(idxs.max()) + spw, len(audio_data)), np.float32)
        wave[: len(audio_data)] = np.asarray(audio_data, np.float32)
        spec, logits = self._forward_full(
            torch.from_numpy(wave).to(self.device),
            torch.from_numpy(idxs.astype(np.int32)).to(self.device))
        return spec.cpu().numpy(), logits.cpu().numpy()[:, None, :]

    # ------------------------------------------------------------------
    # the host pipeline
    # ------------------------------------------------------------------
    def _logits_from_segments(
        self,
        padded_len: int,
        fill_segment: Callable[[int, int, np.ndarray], None],
        progress: Optional[Callable[[float], None]] = None,
        timers=None,
    ) -> np.ndarray:
        """All window logits (W, 256) for a padded stream of ``padded_len``
        samples.

        ``fill_segment(s0, s1, out)`` writes padded-stream samples [s0, s1)
        into ``out`` (zero-filled, length s1 - s0).  A fill thread prepares
        chunk i+1 while the device runs chunk i.  Per chunk: one upload of
        the chunk buffer, the U-Net batch by batch (a ragged tail padded to
        a whole batch), one fetch.  ``timers`` (runtime.metrics.StageTimers)
        collects host_fill on the fill thread and wait_fill / device_put /
        dispatch / fetch here; ``fetch`` includes waiting for the chunk's
        device work.
        """
        tt = timers.time if timers is not None else (lambda _n: nullcontext())
        cfg = self.cfg
        B = cfg.engine.device_batch
        n_windows = num_windows_for_padded_length(padded_len, cfg)
        if n_windows <= 0:
            return np.zeros((0, 256), np.float32)
        starts = window_starts(n_windows, cfg)
        chunk_w = self.chunk_windows()
        buf_len = self.chunk_buffer_len()
        cuda = self.device.type == "cuda"
        ranges = [(w0, min(w0 + chunk_w, n_windows)) for w0 in range(0, n_windows, chunk_w)]

        def fill_chunk(ci: int) -> torch.Tensor:
            # a fresh (pinned) buffer per chunk: none is rewritten while an
            # upload from it may be in flight
            t0 = time.perf_counter()
            w0, w1 = ranges[ci]
            s0 = int(starts[w0])
            s1 = min(int(starts[w1 - 1]) + cfg.samples_per_window, padded_len)
            buf = torch.zeros(buf_len, dtype=torch.float32, pin_memory=cuda)
            fill_segment(s0, s1, buf.numpy()[: s1 - s0])
            if timers is not None:
                timers.add("host_fill", time.perf_counter() - t0)
            return buf

        out: List[np.ndarray] = []
        with ThreadPoolExecutor(max_workers=1) as ex:  # one thread: fill_segment may be sequential
            fut = ex.submit(fill_chunk, 0)
            for ci, (w0, w1) in enumerate(ranges):
                with tt("wait_fill"):
                    host = fut.result()
                if ci + 1 < len(ranges):
                    fut = ex.submit(fill_chunk, ci + 1)
                local = (starts[w0:w1] - starts[w0]).astype(np.int32)
                n = len(local)
                local = np.concatenate([local, np.zeros((-n) % B, np.int32)])
                if int(local.max()) + cfg.samples_per_window > buf_len:
                    raise RuntimeError("window start past the chunk buffer")
                with tt("device_put"):
                    wave = host.to(self.device, non_blocking=True)
                    st = torch.from_numpy(local).to(self.device, non_blocking=True)
                with tt("dispatch"):
                    logits = torch.cat([self._forward(wave, st[b0: b0 + B])
                                        for b0 in range(0, len(local), B)])
                with tt("fetch"):
                    out.append(logits[:n].cpu().numpy())
                if progress is not None:
                    progress(w1 / n_windows)
        return np.concatenate(out)

    def mask_logits_for_padded(self, padded: np.ndarray) -> np.ndarray:
        """All window logits for an already ±3 s-padded waveform: (W, 256)."""
        padded = np.asarray(padded, np.float32)

        def fill(s0: int, s1: int, out: np.ndarray) -> None:
            out[:] = padded[s0:s1]

        return self._logits_from_segments(len(padded), fill)

    def _finalize(self, logits: np.ndarray, audio_seconds: float,
                  timers=None) -> DetectionResult:
        cfg = self.cfg
        with timers.time("grid") if timers is not None else nullcontext():
            sum_g, cnt_g = R.average_grid_host(logits, cfg.engine.step_seconds)
            avg = np.divide(sum_g, cnt_g, out=np.zeros_like(sum_g), where=cnt_g > 0)
            if cfg.engine.min_count > 1:
                # the reference drops bins covered by fewer windows
                # (NNDetector.py:153,181-183); below threshold excludes them
                avg = np.where(cnt_g >= cfg.engine.min_count, avg, -np.inf)
            regions = R.find_speech_regions(
                avg, cfg.engine.threshold, cfg.engine.break_duration,
                exit_threshold=cfg.engine.exit_threshold,
                smooth_bins=cfg.engine.grid_smooth,
            )
        regions = R.shift_regions(regions, -cfg.engine.pad_seconds)
        return DetectionResult(regions, avg, logits.shape[0], audio_seconds)

    def detect_waveform(
        self, audio: np.ndarray, progress: Optional[Callable[[float], None]] = None,
        timers=None,
    ) -> DetectionResult:
        """Unpadded internal-rate mono waveform → intervals.

        The ±3 s zero padding (worker.py:59-62) is virtual: each chunk is
        assembled as [zeros | audio | zeros] without a padded copy.
        """
        cfg = self.cfg
        audio = np.asarray(audio, np.float32)
        pad = cfg.pad_samples

        def fill(s0: int, s1: int, out: np.ndarray) -> None:
            a0, a1 = max(s0, pad), min(s1, pad + len(audio))
            if a1 > a0:
                out[a0 - s0: a1 - s0] = audio[a0 - pad: a1 - pad]

        logits = self._logits_from_segments(len(audio) + 2 * pad, fill, progress, timers)
        return self._finalize(logits, len(audio) / cfg.dsp.sample_rate, timers)

    def detect_file(
        self, path: str, progress: Optional[Callable[[float], None]] = None
    ) -> DetectionResult:
        """Decode + resample + detect one file (in-memory decode)."""
        audio, _sr = load_audio(path, target_sr=self.cfg.dsp.sample_rate)
        if audio is None:
            raise IOError(f"failed to decode {path}")
        return self.detect_waveform(audio, progress)

    # ------------------------------------------------------------------
    def detect_file_streaming(
        self, path: str, progress: Optional[Callable[[float], None]] = None,
        journal_dir: Optional[str] = None, timers=None,
    ) -> DetectionResult:
        """Bounded-memory detection of one file through ``self.pipeline``.

        The host branch keeps a rolling decode buffer that follows the
        (monotonically advancing) chunk requests, so peak host memory is
        about one chunk whatever the file's length.
        """
        if self.pipeline == "fused":
            return self.detect_file_fused(path, progress, journal_dir, timers=timers)
        cfg = self.cfg
        if journal_dir or cfg.engine.chunk_checkpoint_every > 0:
            raise _not_ported("chunk journaling (engine.chunk_checkpoint_every)")
        sr = cfg.dsp.sample_rate
        pad = cfg.pad_samples
        total = internal_length(path, sr)
        decode_iter = stream_chunks(path, chunk_samples=int(sr * cfg.engine.chunk_seconds),
                                    target_sr=sr, backend=self.resample_backend,
                                    device=self.device)
        state = {"buf": np.zeros(0, np.float32), "at": 0, "done": False}

        def fill(s0: int, s1: int, out: np.ndarray) -> None:
            a0, a1 = max(s0, pad) - pad, min(s1, pad + total) - pad  # audio coords
            if a1 <= a0:
                return
            drop = a0 - state["at"]  # advance the rolling buffer
            if drop > 0:
                state["buf"] = state["buf"][drop:]
                state["at"] = a0
            while state["at"] + len(state["buf"]) < a1 and not state["done"]:
                c = next(decode_iter, None)
                if c is None:
                    state["done"] = True
                else:
                    state["buf"] = np.concatenate([state["buf"], c.data])
                    state["done"] = c.is_last
            seg = state["buf"][a0 - state["at"]: a1 - state["at"]]
            out[a0 + pad - s0: a0 + pad - s0 + len(seg)] = seg

        try:
            logits = self._logits_from_segments(total + 2 * pad, fill, progress, timers)
        finally:
            decode_iter.close()  # release the file handle now, not at collection
        return self._finalize(logits, total / sr, timers)

    def detect_file_fused(
        self, path: str, progress: Optional[Callable[[float], None]] = None,
        journal_dir: Optional[str] = None, timers=None,
    ) -> DetectionResult:
        """Raw PCM to the device; decode, resample, mel, U-Net and the
        overlap grid run there chunk by chunk (engine/fused.py)."""
        from .fused import detect_file_fused

        return detect_file_fused(self, path, progress, journal_dir, timers=timers)
