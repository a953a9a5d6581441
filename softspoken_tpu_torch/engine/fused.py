"""Fused streaming detection: raw PCM up, score grids down.

Per chunk the device runs

    wire ─▶ decode ─▶ polyphase-matmul resample (io.resample) ─▶
    framing + DFT + mel (ops.frame_mel, the CUDA kernel in fast mode) ─▶
    U-Net mask head per batch ─▶ overlap grid ─▶ averaged scores

and the inter-chunk grid overlap (windows straddling a chunk boundary) stays
on the device as a carry, so chunking never changes results.  The wire is
exact int16 PCM (÷32768 on the device) or float32 by default; the lossy
wires of ``engine.upload_codec`` are 8-bit mu-law (``ops/mulaw.py``, an
elementwise decode) and 4-bit IMA-ADPCM (``ops/adpcm.py``, the CUDA kernel
K3), and on them the host may first decimate the stream by an integer
factor (``io/decimate.py``, ``engine.wire_decimate``).  The host reads
chunk k+depth and uploads it on a side stream while the card computes chunk
k, and fetches every chunk's grid in one transfer at the end.

With a journal (``engine.chunk_checkpoint_every`` > 0 and a journal
directory), every N chunks the grids completed since the last save and the
carry come down in one transfer into an ``.npz`` sidecar
(``engine/journal.py``); a killed run resumes at the first unsaved chunk
with the saved carry, and its grid is bit-equal to an uninterrupted run's.

The engine keeps no per-run state, so threads detecting files side by side
share it.

The grid sums each bin's windows in a fixed order, so a run gives the same
bits every time: at the default step (0.6 s, p = 5, ``grid_tile_period``)
as p disjoint contiguous blocks added in group order, as the JAX package
does; at a step that does not tile, as a per-bin gather of its covering
windows summed in window order.

Numerics: this path resamples the zero-padded native stream, where a host
pipeline would resample first and pad in the internal domain; the two differ
only within a filter length (~1.5 ms) of the ±3 s pad joins.  Hold it
against the JAX package's fused pipeline, not its host pipeline.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, nullcontext
from functools import lru_cache
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..io import flac, mp3, opus, wavio
from ..io.audio import probe, read_mono
from ..io.decimate import WireDecimator, decim_factor
from ..io.resample import _ratio, polyphase_apply, polyphase_block_geometry
from ..ops import adpcm, mulaw
from ..runtime.metrics import Span, count, current_key, recording, span
from . import regions as R
from .detector import DetectionResult, Detector
from .planner import num_windows_for_padded_length, window_starts

CARRY = 512  # bins of inter-chunk grid overlap (needs ≥ 256 − min bin stride)
LOSSY = ("mulaw8", "adpcm4")


@lru_cache(maxsize=16)
def grid_tile_period(step_seconds: float, max_p: int = 8,
                     n_check: int = 1 << 22) -> Optional[int]:
    """Smallest p such that windows i and i+p tile the score grid exactly:
    ``window_bin_offset(i+p) == window_bin_offset(i) + 256`` for every i
    (the JAX package's ``engine/fused.py::grid_tile_period``).

    When it exists (default step 0.6 s: p = 5, since step/Δt = 256/5), the
    overlap sum decomposes into p disjoint contiguous blocks: group g =
    windows {g, g+p, g+2p, …} covers [bins[g], bins[g]+256·n_g) gap-free.
    Verified over ``n_check`` windows (4M ≈ 29 days of audio at 0.6 s;
    ~0.2 s of host time, so cached: every new detector builds its engines);
    ``run`` re-verifies against the bins it uses.
    """
    i = np.arange(n_check, dtype=np.int64)
    bins = R.window_bin_offset(i, step_seconds)
    for p in range(1, max_p + 1):
        G = int(np.rint(p * step_seconds / R.TIME_RESOLUTION))
        if G == 256 and bool(np.all(bins[p:] == bins[:-p] + G)):
            return p
    return None


class FusedStreamingEngine:
    """Chunk program for one (native_sr, wire kind) on the detector's device.

    ``kind`` is "i16" (PCM16 mono, ÷32768 on the device), "f32" (host
    decoded and downmixed), "mulaw8" (int8 mu-law codes) or "adpcm4" (uint8
    IMA-ADPCM blocks).  Built once, then only read: ``_program``,
    ``_accumulate`` and ``_placement`` write no attribute, and ``run`` keeps
    its state local, so threads may share one engine.
    """

    def __init__(self, detector: Detector, native_sr: int, kind: str = "i16"):
        if kind not in ("i16", "f32") + LOSSY:
            raise ValueError(f"unknown wire kind {kind!r}")
        self.det = detector
        self.device = detector.device
        # under a parallel.MeshDetector, each batch's windows shard over the
        # mesh's data axis; the grid stays on the detector's card
        self.mesh = getattr(detector, "_fused_mesh", None)
        self._forward_chunk = detector._forward_chunk
        self.cfg = cfg = detector.cfg
        self.kind = kind
        self.native_sr = native_sr
        self.up, self.down = _ratio(native_sr, cfg.dsp.sample_rate)

        self.chunk_w = detector.chunk_windows()
        self.B = cfg.engine.device_batch
        self.nb = self.chunk_w // self.B
        self.buf_len = detector.chunk_buffer_len()

        # The grid must reach fin+CARRY so the carry slice is in bounds for
        # every chunk, the final one (finalized through `covered`) included.
        step, dt = cfg.engine.step_seconds, R.TIME_RESOLUTION
        scatter_extent = int(round((self.chunk_w - 1) * step / dt)) + 256 + 2
        fin_upper = max(
            int(round(self.chunk_w * step / dt)),
            int(round((self.chunk_w - 1) * step / dt)) + 256,
        ) + 2
        self.glen = max(scatter_extent, fin_upper + CARRY)
        self._tile_p = grid_tile_period(step)
        if self._tile_p is not None:
            # a full group's block must fit even from a tail chunk's padding
            # offset 0 (its values are zero there)
            self.glen = max(self.glen, -(-self.chunk_w // self._tile_p) * 256)

        if self.up == 1 and self.down == 1:
            self.W = None
            self.pad_l = 0
            self.in_len = self.buf_len
        else:
            (W, self.wmin, self.n_blocks, self.n_copies,
             self.pad_l, self.in_len) = polyphase_block_geometry(
                self.up, self.down, self.buf_len)
            self.width = W.shape[0]
            self.W = torch.from_numpy(W).to(self.device)
        # what the wire carries: mulaw8 codes are encoded straight into the
        # staging buffer (code 0 is silence, so the zero fill still pads);
        # adpcm4 stages int16 and block-encodes it into a shorter wire
        self._wire_dtype = {"f32": torch.float32, "i16": torch.int16,
                            "mulaw8": torch.int8, "adpcm4": torch.uint8}[kind]
        self._wire_len = adpcm.wire_bytes(self.in_len) if kind == "adpcm4" else self.in_len

    # ------------------------------------------------------------------
    def _program(self, native: torch.Tensor, lo: int, fin: int,
                 starts: torch.Tensor, place, valid: torch.Tensor,
                 carry_sum: torch.Tensor, carry_cnt: torch.Tensor):
        """One chunk: native (in_len,) → (avg, cnt, carry_sum', carry_cnt'),
        avg/cnt of length glen.  ``place`` is the grid placement that
        ``_placement`` made and checked on the host.  Its enqueue is three
        spans of the thread's recorder: chunk.decode (wire decode and
        resample), chunk.batch per batch (``_forward_chunk``) and chunk.grid
        (grid update, carry and average)."""
        with span("chunk.decode"):
            if self.kind == "mulaw8":
                x = mulaw.decode_device(native)
            elif self.kind == "adpcm4":
                x = adpcm.decode_device(native, self.in_len)  # K3 on the card
            else:
                x = native.to(torch.float32)
                if self.kind == "i16":
                    x = x * (1.0 / 32768.0)
            if self.W is not None:
                x = polyphase_apply(x, self.W, wmin=self.wmin, pad_l=self.pad_l,
                                    n_blocks=self.n_blocks, n_copies=self.n_copies,
                                    down=self.down, width=self.width)
            if not 0 <= lo <= x.shape[0] - self.buf_len:
                raise RuntimeError(f"chunk window out of range: lo={lo} len={x.shape[0]}")
            internal = x[lo: lo + self.buf_len]

        logits = self._forward_chunk(internal, starts)            # (chunk_w, 256)
        with span("chunk.grid"):
            sum_g, cnt_g = self._accumulate(
                torch.stack([logits * valid[:, None],
                             valid[:, None].expand(self.chunk_w, 256)]),
                place)
            sum_g[:CARRY] += carry_sum
            cnt_g[:CARRY] += carry_cnt
            if not 0 <= fin <= self.glen - CARRY:
                raise RuntimeError(f"carry slice out of range: fin={fin} glen={self.glen}")
            avg = sum_g / torch.clamp(cnt_g, min=1.0)
            return avg, cnt_g, sum_g[fin: fin + CARRY].clone(), cnt_g[fin: fin + CARRY].clone()

    def _accumulate(self, vals: torch.Tensor, place) -> torch.Tensor:
        """(k, chunk_w, 256) per-window values → (k, glen) grid sums, each
        bin's terms added in a fixed order (no atomics, so no run-to-run
        drift)."""
        k = vals.shape[0]
        if self._tile_p is not None:
            # group g = windows g, g+p, …: one contiguous block at place[g],
            # copied into row g; the rows are added in order g = 0..p-1, the
            # JAX package's sum of p block updates
            p = self._tile_p
            rows = vals.new_zeros((p, k, self.glen))
            for g, off in enumerate(place):
                grp = vals[:, g::p]
                if grp.shape[1] == 0:  # a chunk of fewer than p windows
                    continue
                rows[g, :, off: off + grp.shape[1] * 256].view(k, -1, 256).copy_(grp)
            out = rows[0]
            for g in range(1, p):
                out = out + rows[g]
            return out
        # place (glen, K): flat indices of each bin's covering windows in
        # window order, padded with the index of an appended zero
        flat = torch.cat([vals.reshape(k, -1), vals.new_zeros((k, 1))], dim=1)
        cols = flat[:, place]                              # (k, glen, K)
        out = cols[..., 0]
        for j in range(1, cols.shape[2]):
            out = out + cols[..., j]
        return out

    def _placement(self, bins: np.ndarray, n: int):
        """Host side of the grid update for a chunk whose first ``n`` of
        ``chunk_w`` windows are real, at local bin offsets ``bins``: the p
        block offsets (a tiling step) or the (glen, K) gather table, every
        index checked to lie in [0, glen)."""
        if n <= 0:
            raise RuntimeError("a chunk without windows")
        if self._tile_p is not None:
            p = self._tile_p
            # a group g >= chunk_w has no windows and places nothing, as the
            # JAX package's dynamic_update_slice of an empty group
            place = [int(bins[g]) if g < self.chunk_w else 0 for g in range(p)]
            for g, off in enumerate(place):
                n_g = len(range(g, self.chunk_w, p))
                if off < 0 or off + 256 * n_g > self.glen:
                    raise RuntimeError(f"grid block out of range: group {g} at {off} "
                                       f"+ {256 * n_g} > glen={self.glen}")
            return place
        b = bins[:n].astype(np.int64)
        if int(b.min()) < 0 or int(b.max()) + 256 > self.glen:
            raise RuntimeError(f"grid scatter out of range: bins [{b.min()}, "
                               f"{b.max()}] + 256 > glen={self.glen}")
        target = (b[:, None] + np.arange(256)).ravel()    # bin of flat index i*256+l
        order = np.argsort(target, kind="stable")         # window order within a bin
        counts = np.bincount(target, minlength=self.glen)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(order.size) - first[target[order]]
        table = np.full((self.glen, max(1, int(counts.max()))),
                        self.chunk_w * 256, np.int64)     # sentinel: the appended zero
        table[target[order], rank] = order
        return torch.from_numpy(table)

    # ------------------------------------------------------------------
    def synthetic_chunk_args(self) -> tuple:
        """``_program``'s arguments up to the carry for one full synthetic
        chunk (zero audio, every window valid), resident on the device: the
        one layout ``device_only_rate`` and ``tools.profile_chunk`` run."""
        cfg = self.cfg
        starts = np.minimum(np.arange(self.chunk_w, dtype=np.int64) * cfg.samples_per_step,
                            self.buf_len - cfg.samples_per_window).astype(np.int32)
        place = self._placement(
            R.window_bin_offset(np.arange(self.chunk_w), cfg.engine.step_seconds),
            self.chunk_w)
        if isinstance(place, torch.Tensor):
            place = place.to(self.device)
        native = torch.zeros(self._wire_len, dtype=self._wire_dtype, device=self.device)
        st = torch.from_numpy(starts.reshape(self.nb, self.B)).to(self.device)
        valid = torch.ones(self.chunk_w, dtype=torch.float32, device=self.device)
        return native, 0, 0, st, place, valid

    def device_only_rate(self, repeats: int = 8) -> float:
        """Audio-seconds per wall-second of the chunk program alone on
        ``synthetic_chunk_args``, the carry threaded through so the chunks
        serialize."""
        args = self.synthetic_chunk_args()
        cs = torch.zeros(CARRY, device=self.device)
        cc = torch.zeros(CARRY, device=self.device)
        self._program(*args, cs, cc)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            _, _, cs, cc = self._program(*args, cs, cc)
        self._sync()
        wall = time.perf_counter() - t0
        return repeats * self.chunk_w * self.cfg.engine.step_seconds / wall

    def _sync(self) -> None:
        devices = {self.device}
        if self.mesh is not None:
            devices.update(self.mesh.devices.flat)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ------------------------------------------------------------------
    def run(
        self,
        read_native: Callable[[int, int], np.ndarray],
        native_frames: int,
        progress: Optional[Callable[[float], None]] = None,
        journal=None,
        timers=None,
    ) -> DetectionResult:
        """Detect over a native-rate stream of ``native_frames`` samples.

        ``read_native(start, frames)`` returns mono samples, clamped at EOF:
        float32 for the "f32" wire, int16 for every other.  ``journal``
        (engine.journal.ChunkJournal) resumes from and saves chunk progress.
        ``timers`` (runtime.metrics.StageTimers) records spans under the
        calling thread's key (the runner's file index): host_fill and
        device_put on the read-ahead threads; readahead_start (their start),
        wait_prepare, dispatch (the chunk program's spans inside),
        checkpoint, readahead_join, final_fetch (device_wait, then fetch) and
        regions here; and counts chunks, batches, windows_live (real windows)
        and windows_launched (``chunk_w`` a chunk); the model counts
        batches_nhwc (the batches of its channels-last path).
        """
        key = current_key()
        with recording(timers, key):
            return self._run(read_native, native_frames, progress, journal, timers, key)

    def _run(self, read_native, native_frames, progress, journal, timers, key):
        cfg = self.cfg
        up, down = self.up, self.down
        cuda = self.device.type == "cuda"
        pad_native = int(round(cfg.engine.pad_seconds * self.native_sr))
        n_nat_padded = native_frames + 2 * pad_native
        padded_len = -(-n_nat_padded * up // down) if self.W is not None else n_nat_padded

        n_windows = num_windows_for_padded_length(padded_len, cfg)
        if n_windows <= 0:
            return DetectionResult([], np.zeros(0), 0, 0.0)
        starts_g = window_starts(n_windows, cfg)
        bins_g = R.window_bin_offset(np.arange(n_windows), cfg.engine.step_seconds)
        covered = int(bins_g[-1]) + 256
        p = self._tile_p
        if p is not None and n_windows > p and not np.all(bins_g[p:] == bins_g[:-p] + 256):
            raise RuntimeError(f"grid tile period {p} violated by the window offsets "
                               f"of {n_windows} windows")

        if self.kind == "mulaw8":
            def put(got: np.ndarray, dst: np.ndarray) -> None:
                mulaw.encode_i16(got, out=dst)
        else:
            def put(got: np.ndarray, dst: np.ndarray) -> None:
                dst[:] = got

        def read_padded(start: int, frames: int, out: np.ndarray) -> None:
            """Native padded-stream samples [start, start+frames) into out
            (as mu-law codes on the mulaw8 wire)."""
            a0 = max(start, pad_native)
            a1 = min(start + frames, pad_native + native_frames)
            if a1 > a0:
                got = read_native(a0 - pad_native, a1 - a0)
                put(got, out[a0 - start: a0 - start + len(got)])

        n_chunks = -(-n_windows // self.chunk_w)

        done_parts: List[np.ndarray] = []
        k0 = 0
        carry_sum = torch.zeros(CARRY, dtype=torch.float32, device=self.device)
        carry_cnt = torch.zeros_like(carry_sum)
        if journal is not None:
            # bind the journal to this exact computation before trusting it
            journal.header.update(
                n_windows=int(n_windows), n_chunks=int(n_chunks),
                chunk_w=int(self.chunk_w), glen=int(self.glen),
                kind=self.kind, native_sr=int(self.native_sr))
            resume = journal.load()
            if resume is not None and resume.chunks_done < n_chunks:
                done_parts = list(resume.avg_parts)
                k0 = resume.chunks_done
                carry_sum = torch.from_numpy(resume.carry_sum).to(self.device)
                carry_cnt = torch.from_numpy(resume.carry_cnt).to(self.device)
        every = max(1, cfg.engine.chunk_checkpoint_every or 1)

        def prepare(ci: int):
            """Host side of chunk ci (fill thread): pinned staging + metadata."""
            with recording(timers, key), span("host_fill"):
                return fill(ci)

        def fill(ci: int):
            w0 = ci * self.chunk_w
            w1 = min(w0 + self.chunk_w, n_windows)
            s0 = int(starts_g[w0])
            base = int(bins_g[w0])
            # the last chunk finalizes through `covered`, even when full
            next_base = (int(R.window_bin_offset(np.array([w0 + self.chunk_w]),
                                                 cfg.engine.step_seconds)[0])
                         if ci + 1 < n_chunks else covered)
            fin = min(next_base, covered) - base

            if self.kind == "adpcm4":
                staging = np.zeros(self.in_len, np.int16)
            else:
                staging_t = torch.zeros(self.in_len, dtype=self._wire_dtype, pin_memory=cuda)
                staging = staging_t.numpy()
            if self.W is None:
                lo = 0
                read_padded(s0, min(self.in_len, n_nat_padded - s0), staging)
            else:  # align reads to whole `down` blocks
                rs = max(0, (s0 * down) // up - 2 * down)
                rs -= rs % down
                lo = s0 - (rs * up) // down
                if not 0 <= lo <= 4 * up:
                    raise RuntimeError(f"polyphase alignment drift: lo={lo} up={up}")
                if lo + self.buf_len > self.n_blocks * up:
                    raise RuntimeError(
                        f"polyphase window overruns resample blocks: lo={lo}")
                left = min(rs, self.pad_l)
                re = min(n_nat_padded, rs + self.in_len - self.pad_l)
                off = self.pad_l - left
                read_padded(rs - left, re - (rs - left), staging[off:])
            if self.kind == "adpcm4":
                # one encode pass of the whole staging buffer into the wire
                staging_t = torch.zeros(self._wire_len, dtype=torch.uint8, pin_memory=cuda)
                adpcm.encode_i16(staging, out=staging_t.numpy())

            n = w1 - w0
            starts_l = np.zeros(self.chunk_w, np.int32)
            bins_l = np.zeros(self.chunk_w, np.int64)
            valid = np.zeros(self.chunk_w, np.float32)
            starts_l[:n] = starts_g[w0:w1] - s0
            bins_l[:n] = bins_g[w0:w1] - base
            valid[:n] = 1.0
            if int(starts_l.max()) + cfg.samples_per_window > self.buf_len:
                raise RuntimeError("window start past the chunk buffer")
            place = self._placement(bins_l, n)
            host = [staging_t, torch.from_numpy(starts_l), torch.from_numpy(valid)]
            if isinstance(place, torch.Tensor):
                host.append(place)
            if cuda:
                host = [host[0]] + [t.pin_memory() for t in host[1:]]
            return host, place, lo, fin, w1

        up_stream = torch.cuda.Stream(self.device) if cuda else None

        def upload(fill_fut):
            """Wire side of one chunk (upload thread): async copies of the
            pinned payload on a side stream, with an event to wait on."""
            host, place, lo, fin, w1 = fill_fut.result()
            ev = None
            with recording(timers, key), span("device_put"), \
                    torch.cuda.stream(up_stream) if cuda else nullcontext():
                dev = [t.to(self.device, non_blocking=True) for t in host]
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(up_stream)
            if isinstance(place, torch.Tensor):
                place = dev[3]
            return dev, place, ev, lo, fin, w1

        depth = max(1, cfg.engine.readahead_chunks)
        pending: List[Tuple[int, torch.Tensor]] = []
        with ThreadPoolExecutor(max_workers=1) as fill_ex, \
                ThreadPoolExecutor(max_workers=1) as up_ex:
            with span("readahead_start"):  # the first submits start both threads
                futs = deque(up_ex.submit(upload, fill_ex.submit(prepare, ci))
                             for ci in range(k0, min(k0 + depth, n_chunks)))
            for ci in range(k0, n_chunks):
                with span("wait_prepare"):
                    dev, place, ev, lo, fin, w1 = futs.popleft().result()
                if ci + depth < n_chunks:
                    futs.append(up_ex.submit(upload, fill_ex.submit(prepare, ci + depth)))
                with span("dispatch"):
                    if cuda:
                        cur = torch.cuda.current_stream(self.device)
                        cur.wait_event(ev)
                        for t in dev:  # allocated on the side stream, used here
                            t.record_stream(cur)
                    native, starts_d, valid_d = dev[:3]
                    avg, _cnt, carry_sum, carry_cnt = self._program(
                        native, lo, fin, starts_d.view(self.nb, self.B), place,
                        valid_d, carry_sum, carry_cnt)
                count("chunks")
                count("batches", self.nb)
                count("windows_live", w1 - ci * self.chunk_w)
                count("windows_launched", self.chunk_w)
                pending.append((fin, avg))
                if progress is not None:
                    progress(w1 / n_windows)
                if (journal is not None and ci + 1 < n_chunks
                        and (ci + 1 - k0) % every == 0):
                    # checkpoint: the grids completed since the last save and
                    # the carry, in one device→host transfer
                    with span("checkpoint"):
                        got = torch.cat([a[:f] for f, a in pending]
                                        + [carry_sum, carry_cnt]).cpu().numpy()
                        at = 0
                        for f, _a in pending:
                            done_parts.append(got[at: at + f])
                            at += f
                        pending = []
                        journal.save(done_parts, got[at: at + CARRY], got[at + CARRY:])
            with span("readahead_join"):
                fill_ex.shutdown()
                up_ex.shutdown()

        # one device→host transfer for every grid not yet fetched: the host
        # first waits for the chunks' device work (device_wait), then copies
        tail = np.zeros(0, np.float32)
        with span("final_fetch"):
            if pending:
                with span("device_wait"):
                    grids = torch.cat([a[:fin] for fin, a in pending])
                    if cuda:
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(self.device))
                        done.synchronize()
                with span("fetch"):
                    tail = grids.cpu().numpy()
        if journal is not None:
            journal.clear()
        with span("regions"):
            avg_values = np.concatenate(done_parts + [tail])[:covered]
            if cfg.engine.min_count > 1:
                # coverage counts are a pure function of the window offsets
                # (NNDetector.py:153,181-183): recompute them on the host
                cnt = np.zeros(covered, np.int64)
                idx = (bins_g[:, None] + np.arange(256)[None, :]).ravel()
                np.add.at(cnt, idx[idx < covered], 1)
                avg_values = np.where(cnt >= cfg.engine.min_count, avg_values, -np.inf)
            regions = R.find_speech_regions(
                avg_values, cfg.engine.threshold, cfg.engine.break_duration,
                exit_threshold=cfg.engine.exit_threshold,
                smooth_bins=cfg.engine.grid_smooth,
            )
            regions = R.shift_regions(regions, -cfg.engine.pad_seconds)
        return DetectionResult(regions, avg_values, n_windows,
                               native_frames / self.native_sr)


_ENGINES_LOCK = threading.Lock()


def get_fused_engine(detector: Detector, native_sr: int, kind: str) -> FusedStreamingEngine:
    """The detector's engine for (native_sr, kind) and its mesh, built once
    under a lock (worker threads of the runner ask for it concurrently)."""
    mesh = getattr(detector, "_fused_mesh", None)
    key = (native_sr, kind, detector.cfg.engine.device_batch,
           detector.cfg.engine.chunk_seconds, id(mesh) if mesh is not None else None)
    with _ENGINES_LOCK:
        eng = detector._engines.get(key)
        if eng is None:
            eng = detector._engines[key] = FusedStreamingEngine(detector, native_sr, kind)
        return eng


def backend_tag(device: torch.device) -> str:
    """The journal header's ``backend``: the port and its device, never a
    JAX backend, so a journal of the JAX package or of another device kind
    is never resumed here."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"torch-cuda:{torch.cuda.get_device_name(device)}"
    return f"torch-{device.type}"


def _make_journal(detector: Detector, path: str, journal_dir: Optional[str]):
    """Chunk-resume sidecar bound to (file identity, weights, numerics), with
    the JAX package's header keys and the port's own ``backend`` tag."""
    if not journal_dir:
        return None
    from .journal import journal_for

    st = os.stat(path)
    cfg = detector.cfg
    header = {
        "size": int(st.st_size), "mtime_ns": int(st.st_mtime_ns),
        "weights": detector.weights_digest(), "step_seconds": cfg.engine.step_seconds,
        "precision": cfg.engine.precision, "sample_rate": cfg.dsp.sample_rate,
        # every knob that changes the numerics: a resume must never stitch
        # grids computed under different kernels, precisions or wires
        "mel_precision": cfg.engine.mel_precision,
        "mel_kernel": cfg.engine.mel_kernel,
        "pad_seconds": cfg.engine.pad_seconds,
        "decoder_upsample": cfg.engine.decoder_upsample,
        "upload_codec": cfg.engine.upload_codec,
        "wire_decimate": _wire_decimate_tag(cfg),
        "device_batch": cfg.engine.device_batch,
        "chunk_seconds": cfg.engine.chunk_seconds,
        "backend": backend_tag(detector.device),
    }
    return journal_for(journal_dir, path, header)


def _wire_decimate_tag(cfg) -> str:
    """Journal-header tag for the wire decimation: the knob, the filter
    design's ``DECIM_VERSION`` and which decimator runs (the native loop or
    numpy, which agree only to ~1 LSB of the int16 wire)."""
    wd = cfg.engine.wire_decimate
    if wd == "off":
        return "off"
    from ..io import native
    from ..io.decimate import DECIM_VERSION

    return f"{wd}:v{DECIM_VERSION}:{'c' if native.native_available() else 'np'}"


def _i16_kind(detector: Detector) -> str:
    """Wire kind for a 16-bit PCM source: exact int16, or a lossy wire.

    As the JAX package's: "auto" picks mulaw8 only on a TPU in fast mode,
    so here it is the exact int16 wire; any codec other than "mulaw8" and
    "adpcm4" ("bfp4" included) also rides the exact int16 wire, silently.
    """
    codec = detector.cfg.engine.upload_codec
    return codec if codec in LOSSY else "i16"


def _maybe_wire_decimate(detector: Detector, read_fn, frames: int, sr: int, kind: str):
    """Wrap an int16 reader in the wire decimator where it cannot matter:
    only on a lossy wire with ``engine.wire_decimate="auto"``, and only when
    the native rate has an integer factor M with sr/M >= 2*dsp.f_max (the
    mel filterbank sees nothing above f_max).  Returns the ``(read_fn,
    frames, sr)`` the engine runs at."""
    cfg = detector.cfg
    if kind not in LOSSY or cfg.engine.wire_decimate != "auto":
        return read_fn, frames, sr
    M = decim_factor(sr, cfg.dsp.f_max)
    if M == 1:
        return read_fn, frames, sr
    d = WireDecimator(read_fn, frames, sr, M, f_max=cfg.dsp.f_max)
    return d.read, d.frames, d.sr


def _f32_source(detector: Detector, read_f32, frames: int, sr: int):
    """``(engine, read, frames)`` for a mono float32 range reader (the
    host-decoded formats): on a lossy wire the samples are rounded to int16
    first (≤3e-5 full scale, inside the codec's own quantization); exact
    wires keep float32."""
    kind = _i16_kind(detector)
    if kind in LOSSY:
        def read_i16(start: int, n: int) -> np.ndarray:
            data = read_f32(start, n)
            return np.clip(np.rint(data * np.float32(32768.0)), -32768, 32767
                           ).astype(np.int16)

        rd, nfr, wire_sr = _maybe_wire_decimate(detector, read_i16, frames, sr, kind)
        return get_fused_engine(detector, wire_sr, kind), rd, nfr
    return get_fused_engine(detector, sr, "f32"), read_f32, frames


def _open_source(detector: Detector, path: str, inf, stack: ExitStack):
    """``(engine, read, frames)`` for a probed file, its reader opened on
    ``stack``: the dispatch of ``detect_file_fused``."""
    kind = _i16_kind(detector)
    if inf.subtype.startswith("FLAC"):
        if inf.channels == 1 and (inf.bits_per_sample <= 16 or kind in LOSSY):
            smr = stack.enter_context(flac.SequentialMonoReader(
                path, dtype="i16", truncate_to_i16=inf.bits_per_sample > 16))
            rd, nfr, sr = _maybe_wire_decimate(
                detector, smr.read, inf.frames, inf.samplerate, kind)
            return get_fused_engine(detector, sr, kind), rd, nfr
        smr = stack.enter_context(flac.SequentialMonoReader(path))
        return get_fused_engine(detector, inf.samplerate, "f32"), smr.read, inf.frames

    if isinstance(inf, wavio.WavInfo) and inf.subtype == "PCM_16" and inf.channels == 1:
        reader = stack.enter_context(wavio.RawReader(path))

        def read_native(start: int, frames: int) -> np.ndarray:
            reader.will_need(start + frames, frames)  # prefetch the next chunk
            return reader.read_raw(start, frames).view("<i2")

        rd, nfr, sr = _maybe_wire_decimate(
            detector, read_native, inf.frames, inf.samplerate, kind)
        return get_fused_engine(detector, sr, kind), rd, nfr

    if (isinstance(inf, wavio.WavInfo) and inf.channels == 1
            and inf.subtype in ("PCM_24", "PCM_32", "PCM_U8") and kind in LOSSY):
        # the reference's wire for these: mulaw8 under either lossy codec
        reader = stack.enter_context(wavio.RawReader(path))

        def read_top16(start: int, frames: int) -> np.ndarray:
            reader.will_need(start + frames, frames)
            return wavio.top16_from_raw(reader.read_raw(start, frames), inf.subtype)

        rd, nfr, sr = _maybe_wire_decimate(
            detector, read_top16, inf.frames, inf.samplerate, "mulaw8")
        return get_fused_engine(detector, sr, "mulaw8"), rd, nfr

    if inf.subtype == "OPUS" or inf.subtype.startswith("MPEG"):
        # one persistent handle: a per-chunk read would re-open the file and
        # re-scan an MP3 or re-enter an Opus stream with its pre-roll (no
        # longer bit-exact at the seams); Opus serves the backward chunk
        # overlap from the reader's history
        seq = opus if inf.subtype == "OPUS" else mp3
        smr = stack.enter_context(seq.SequentialMonoReader(path))
        return _f32_source(detector, smr.read, inf.frames, inf.samplerate)

    def read_f32(start: int, frames: int) -> np.ndarray:
        return read_mono(path, start=start, frames=frames)[0]

    return _f32_source(detector, read_f32, inf.frames, inf.samplerate)


def detect_file_fused(
    detector: Detector, path: str,
    progress: Optional[Callable[[float], None]] = None,
    journal_dir: Optional[str] = None, timers=None,
) -> DetectionResult:
    """Whole-file detection through the fused device pipeline, with the JAX
    package's dispatch on ``io.audio.probe``:

      * mono FLAC of ≤16 bits streams int16 (a b-bit sample shifted to 16
        bits, ÷32768 on the device, equals the float path's v/2^(b−1)); on a
        lossy wire a deeper mono FLAC streams its top 16 bits too;
      * any other FLAC decodes and downmixes on its sequential reader;
      * mono PCM16 WAV streams its raw int16 from one persistent handle;
      * on a lossy wire, mono PCM_24/PCM_32/PCM_U8 WAV streams its top 16
        bits on the mulaw8 wire, whatever the codec (as the JAX package
        does, ``adpcm4`` included);
      * MP3 and Ogg Opus decode on one persistent sequential reader;
      * every other readable format (Ogg Vorbis among them) is decoded and
        downmixed on the host (``read_mono``) and rides the float32 wire,
        or a lossy wire as int16.

    Each int16 stream on a lossy wire goes through ``_maybe_wire_decimate``.
    With ``journal_dir`` set, chunk progress persists there and a killed run
    resumes mid-file, on every branch.  The probe, the journal's binding,
    the reader's open and the engine's lookup are the span ``probe`` of
    ``timers``.
    """
    with ExitStack() as stack:
        with Span(timers, "probe", current_key()):
            inf = probe(path)
            journal = _make_journal(detector, path, journal_dir)
            engine, read, frames = _open_source(detector, path, inf, stack)
        return engine.run(read, frames, progress, journal, timers=timers)
