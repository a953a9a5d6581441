"""Raven Lite/Pro selection-table export.

A copy of the JAX package's ``export/raven.py`` over a ``Table``.  Output
contract (review_exporter.py:341-481 and the reference README), two files
under ``<base_dir>/Raven Outputs/<project>/``:

  * ``<project>_listfile.txt`` — unique absolute WAV paths, first-appearance
    order, one per line with trailing newline
  * ``<project>.txt`` — tab-delimited selection table with **cumulative**
    Begin/End times across the listfile (offsets from per-file durations,
    probed from the file headers; fallback = that file's max detection end
    time), columns Selection, View='Spectrogram 1', Channel=1, Begin/End
    Time (s), Low/High Freq (Hz), Annotation, Begin Path + erase/
    user_comment/review_datetime (+confidence if present)
"""

from __future__ import annotations

import logging
import math
import os
from pathlib import Path
from typing import Dict, Union

from ..project.table import NAN, Table, is_na, round_column, to_numeric, write_csv
from .base import Transform

log = logging.getLogger(__name__)


_DURATION_CACHE: Dict[tuple, float] = {}


def _wav_duration(path: Union[str, Path]) -> float:
    # format-dispatching probe, cached on (path, mtime, size): the review
    # screen re-runs every exporter on each grade/edit, and re-probing
    # hundreds of file headers per keystroke is O(files) blocking IO
    from ..io.audio import get_audio_data

    path = str(path)
    try:
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None and key in _DURATION_CACHE:
        return _DURATION_CACHE[key]
    dur, _sr = get_audio_data(path)
    if key is not None:
        _DURATION_CACHE[key] = dur
    return dur


class RavenTxtTransform(Transform):
    name = "raven"
    extension = ".txt"

    def __call__(
        self,
        table: Table,
        *,
        base_dir: Union[str, Path],
        project_name: str,
        precision: int = 6,
        annotation_label: str = "Human",
        low_freq: int = 0,
        high_freq: int = 8000,
        **kwargs,
    ) -> None:
        missing = {"file_path", "file_name", "start_time", "end_time"} - set(table.columns)
        if missing:
            raise ValueError(f"raven export: missing column(s): {missing}")

        out_root = Path(base_dir) / "Raven Outputs" / project_name
        out_root.mkdir(parents=True, exist_ok=True)

        abs_path = [str(Path(p) / n)
                    for p, n in zip(table.column("file_path"), table.column("file_name"))]
        unique_paths = list(dict.fromkeys(abs_path))
        (out_root / f"{project_name}_listfile.txt").write_text(
            "\n".join(unique_paths) + "\n"
        )

        ends = to_numeric(table.column("end_time"))
        offsets: Dict[str, float] = {}
        running = 0.0
        for p in unique_paths:
            try:
                dur = _wav_duration(p)
            except Exception:  # header unreadable → largest detection end
                own = [e for a, e in zip(abs_path, ends) if a == p and not is_na(e)]
                dur = max(own) if own else NAN
            offsets[p] = running
            dur = float(dur)
            if not math.isfinite(dur):
                # all end_times non-numeric too: contribute nothing rather
                # than poisoning every later file's cumulative offset with
                # NaN
                log.warning("raven export: no duration derivable for %s", p)
                dur = 0.0
            running += dur

        off = [offsets[a] for a in abs_path]
        starts = to_numeric(table.column("start_time"))
        begin = round_column([o + s for o, s in zip(off, starts)], precision)
        end = round_column([o + e for o, e in zip(off, ends)], precision)

        n = len(table)
        blank = [""] * n
        cols = {
            "Selection": list(range(1, n + 1)),
            "View": ["Spectrogram 1"] * n,
            "Channel": [1] * n,
            "Begin Time (s)": begin,
            "End Time (s)": end,
            "Low Freq (Hz)": [low_freq] * n,
            "High Freq (Hz)": [high_freq] * n,
            "Annotation": [annotation_label] * n,
            "Begin Path": abs_path,
        }
        for c in ("erase", "user_comment", "review_datetime"):
            cols[c] = table.column(c) if c in table.columns else blank
        if "confidence" in table.columns:
            cols["confidence"] = table.column("confidence")

        write_csv(str(out_root / f"{project_name}.txt"), Table.from_columns(cols), sep="\t")
        return None
