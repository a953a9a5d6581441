"""Wildlife Acoustics Kaleidoscope CSV export.

A copy of the JAX package's ``export/kaleidoscope.py`` over a ``Table``.
Output contract (review_exporter.py:218-338 and the reference README): one
CSV ``<base_dir>/Kaleidoscope Outputs/<project>/<project>.csv`` with columns
INDIR, FOLDER, IN FILE*, OFFSET, DURATION, TOP1MATCH*, MANUAL ID plus
traceability columns end_time/erase/review_datetime.

INDIR is the longest common path prefix of all file_path values; FOLDER is
each path relative to it ("" when equal).  Deliberate divergence from the
reference: the reference only strips a trailing '\\' from INDIR
(Windows-only behavior); we strip the platform separator so POSIX output is
sane.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union

from ..project.table import NAN, Table, is_na, round_column, to_numeric, write_csv
from .base import Transform


class KaleidoscopeCsvTransform(Transform):
    name = "kaleidoscope"
    extension = ".csv"

    def __call__(
        self,
        table: Table,
        *,
        base_dir: Union[str, Path],
        project_name: str,
        precision: int = 6,
        human_label: str = "Human",
        **kwargs,
    ) -> None:
        missing = {"file_path", "file_name", "start_time", "end_time"} - set(table.columns)
        if missing:
            raise ValueError(f"kaleidoscope export: missing column(s): {missing}")

        out_root = Path(base_dir) / "Kaleidoscope Outputs" / project_name
        out_root.mkdir(parents=True, exist_ok=True)

        start = to_numeric(table.column("start_time"))
        end = to_numeric(table.column("end_time"))

        paths = [str(p) for p in table.column("file_path")]
        # commonpath raises on a relative/absolute mix (e.g. a hand-added
        # row with an empty file_path) — that must degrade the INDIR split,
        # not wedge every subsequent review save
        try:
            indir = os.path.commonpath([p for p in paths if p]) if any(paths) else ""
        except ValueError:
            indir = ""
        if indir:
            folders = [
                os.path.relpath(p, indir) if os.path.isabs(p) == os.path.isabs(indir) and p else p
                for p in paths
            ]
        else:
            folders = list(paths)
        folders = ["" if f == "." else f for f in folders]
        # trim only a REAL trailing separator: the degraded-empty INDIR
        # ('' from the ValueError fallback above) must stay empty, not
        # become the filesystem root
        if indir:
            indir = indir.rstrip(os.sep) or os.sep

        n = len(table)
        blank = [""] * n
        duration = [_diff(e, s) for e, s in zip(end, start)]
        out = Table.from_columns(
            {
                "INDIR": [indir] * n,
                "FOLDER": folders,
                "IN FILE*": table.column("file_name"),
                "OFFSET": round_column(start, precision),
                "DURATION": round_column(duration, precision),
                "TOP1MATCH*": [human_label] * n,
                "MANUAL ID": _get(table, "user_comment", blank),
                "end_time": round_column(end, precision),
                "erase": _get(table, "erase", blank),
                "review_datetime": _get(table, "review_datetime", blank),
            }
        )
        write_csv(str(out_root / f"{project_name}.csv"), out)
        return None


def _diff(e, s):
    """``e - s`` with a missing operand giving a missing cell."""
    return NAN if is_na(e) or is_na(s) else e - s


def _get(table: Table, name: str, default):
    """``df.get(name, default)``."""
    return table.column(name) if name in table.columns else default
