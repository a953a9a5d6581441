"""Silence-voices stage: zero (or crossfade) flagged intervals, write back.

A copy of the JAX package's ``silence/silencer.py``; the review table is a
``Table`` (``project/table.py``), read as the JAX CLI reads it with pandas'
default NA handling.

Behavior parity with ``SilenceWorker`` (``silencer_ui.py:918-1015``):
  * rows with erase == 1, grouped by (file_path, file_name)
  * audio loaded at **native** rate, all channels
  * per-interval hard zero over [round(st·sr), round(et·sr)) with bounds
    clamps, all channels
  * output ``<stem>_silenced.wav`` in the chosen directory (PCM_16, which is
    what the reference's soundfile default produced)
  * decode errors skip the file and still advance progress
  * cooperative stop between files
  * completion marker ``silence_complete.txt`` written by the caller flow
    (silencer_ui.py:1174-1183) — see ``write_status_file``

Beyond the reference:
  * optional crossfade ramps (``fade_ms``) — ops.mute
  * bounded-memory streaming write-back for files larger than
    ``stream_threshold_bytes`` (the reference loads entire multi-GB files)
  * per-file error manifest returned to the caller
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..io import wavio
from ..ops.mute import apply_mute
from ..project.table import Table, is_na, to_number

log = logging.getLogger(__name__)

STATUS_FILENAME = "silence_complete.txt"


@dataclass
class SilenceReport:
    files_done: int = 0
    files_failed: int = 0
    outputs: List[str] = field(default_factory=list)
    errors: Dict[str, str] = field(default_factory=dict)
    stopped: bool = False


class SilenceRunner:
    def __init__(
        self,
        output_dir: str,
        fade_ms: float = 0.0,
        subtype: str = "PCM_16",
        stream_threshold_bytes: int = 1 << 30,
        chunk_frames: int = 1 << 22,
    ):
        self.output_dir = output_dir
        self.fade_ms = fade_ms
        self.subtype = subtype
        self.stream_threshold_bytes = stream_threshold_bytes
        self.chunk_frames = chunk_frames
        self._stop = False

    def stop(self) -> None:
        """Cooperative stop (between files), like silencer_ui.py:1011-1015."""
        self._stop = True

    # ------------------------------------------------------------------
    def run(
        self,
        review: Table,
        on_file_start: Optional[Callable[[str], None]] = None,
        on_file_done: Optional[Callable[[str], None]] = None,
        on_progress: Optional[Callable[[int], None]] = None,
    ) -> SilenceReport:
        report = SilenceReport()
        erase_rows = [r for r in review.rows if to_number(r["erase"]) == 1]
        if not erase_rows:
            return report

        # groupby(["file_path", "file_name"]): sorted keys, rows in table
        # order, a row with a missing key dropped
        by_key: Dict[Tuple, List[Dict]] = {}
        for r in erase_rows:
            if not (is_na(r["file_path"]) or is_na(r["file_name"])):
                by_key.setdefault((r["file_path"], r["file_name"]), []).append(r)
        groups = sorted(by_key.items())
        total = len(groups)
        os.makedirs(self.output_dir, exist_ok=True)

        used_names = set()
        for gi, ((fpath, fname), rows) in enumerate(groups):
            if self._stop:
                report.stopped = True
                break
            full = os.path.join(fpath, fname)
            if on_file_start:
                on_file_start(full)
            stem, _ext = os.path.splitext(fname)
            # reference naming (silencer_ui.py:987-990) is basename-only;
            # keep it, but same-named recordings from different folders must
            # not silently overwrite each other's output
            out_name = f"{stem}_silenced.wav"
            k = 2
            while out_name in used_names:
                out_name = f"{stem}_silenced_{k}.wav"
                k += 1
            if k > 2:
                log.warning("output name collision for %s; writing %s",
                            full, out_name)
            used_names.add(out_name)
            out_path = os.path.join(self.output_dir, out_name)
            try:
                # float() inside the try: one malformed hand-edited review
                # row must skip-and-continue, not abort the whole run
                intervals = [(float(r["start_time"]), float(r["end_time"])) for r in rows]
                self._silence_one(full, out_path, intervals)
                report.outputs.append(out_path)
                if on_file_done:
                    on_file_done(out_path)
                report.files_done += 1
            except Exception as e:  # noqa: BLE001 — skip-and-continue parity
                log.error("silencing failed for %s: %s", full, e)
                report.errors[full] = str(e)
                report.files_failed += 1
            if on_progress:
                advanced = report.files_done + report.files_failed
                on_progress(int(advanced / total * 100))
        return report

    # ------------------------------------------------------------------
    def _silence_one(self, src: str, dst: str, intervals: List[Tuple[float, float]]):
        from ..io.audio import probe, read_any

        inf = probe(src)   # WAV/RF64 or FLAC input; output is always WAV
        fade = int(round(self.fade_ms / 1000.0 * inf.samplerate))
        bpf = inf.channels * max(2, inf.bits_per_sample // 8)
        approx_bytes = inf.data_bytes or inf.frames * bpf
        if approx_bytes <= self.stream_threshold_bytes:
            data, sr = read_any(src, always_2d=True)        # (frames, ch)
            out = apply_mute(data.T, intervals, sr, fade_samples=fade).T
            wavio.write(dst, out, sr, subtype=self.subtype)
            return
        # streaming write-back for huge files. FLAC keeps one decoder handle
        # (range-reopening would re-decode from the stream start per chunk);
        # the silencer's reads are strictly sequential so this is exact.
        flac_reader = None
        raw_reader = None
        if inf.subtype.startswith("FLAC"):
            from ..io.flac import FlacReader

            flac_reader = FlacReader(src)
            scale = np.float32(1.0 / (1 << (inf.bits_per_sample - 1)))
        elif (isinstance(inf, wavio.WavInfo)
              and inf.subtype not in wavio.BLOCK_SUBTYPES):
            # persistent handle + sequential fadvise: reopening/reparsing
            # the header per chunk resets kernel readahead — the measured
            # streaming throughput ceiling RawReader exists to fix; the
            # multi-GB silencer path uses it too
            # (block-coded ADPCM can't frame-address: falls to read_any)
            raw_reader = wavio.RawReader(src)

        def read_seq(pos: int, nread: int):
            if flac_reader is not None:
                return flac_reader.read_i32(nread).astype(np.float32) * scale, inf.samplerate
            if raw_reader is not None:
                raw_reader.will_need(pos + nread, nread)
                raw = raw_reader.read_raw(pos, nread)
                return (wavio._decode(raw, inf.subtype)
                        .reshape(-1, inf.channels), inf.samplerate)
            return read_any(src, start=pos, frames=nread, always_2d=True)

        try:
            with wavio.WavWriter(dst, inf.samplerate, inf.channels, self.subtype) as w:
                pos = 0
                while pos < inf.frames:
                    nread = min(self.chunk_frames, inf.frames - pos)
                    data, sr = read_seq(pos, nread)
                    out = apply_mute(
                        data.T,
                        intervals,
                        sr,
                        fade_samples=fade,
                        offset=pos,
                        total_samples=inf.frames,
                    ).T
                    w.write(out)
                    pos += nread
        finally:
            if flac_reader is not None:
                flac_reader.close()
            if raw_reader is not None:
                raw_reader.close()


def write_status_file(project: Dict, project_output_dir: str) -> str:
    """Write the completion marker and persist its path to the project
    (silencer_ui.py:1174-1183)."""
    path = os.path.join(project_output_dir, STATUS_FILENAME)
    with open(path, "w") as f:
        f.write("complete\n")
    project["silence_status_file"] = path
    return path
