"""Audacity label-track export.

A copy of the JAX package's ``export/audacity.py`` over a ``Table``.  Output
contract (review_exporter.py:129-215 and the reference README): one
``<base_dir>/Audacity Outputs/<project>/<wav stem>.txt`` per WAV, rows
``start<TAB>end<TAB>Human`` at 6 decimals, no header, trailing newline,
rows sorted by (file_name, start_time).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

from ..project.table import Table, is_na, sort_rows, to_numeric
from .base import Transform


class AudacityTxtTransform(Transform):
    name = "audacity"
    extension = ".txt"

    def __call__(
        self,
        table: Table,
        *,
        base_dir: Union[str, Path],
        project_name: str,
        comment: str = "Human",
        precision: int = 6,
        **kwargs,
    ) -> None:
        missing = {"file_name", "start_time", "end_time"} - set(table.columns)
        if missing:
            raise ValueError(f"audacity export: missing column(s): {missing}")

        out_root = Path(base_dir) / "Audacity Outputs" / project_name
        out_root.mkdir(parents=True, exist_ok=True)

        table = table.copy()
        table.set_column("start_time", to_numeric(table.column("start_time")))
        table.set_column("end_time", to_numeric(table.column("end_time")))
        bad = [r["file_name"] for r in table.rows
               if is_na(r["start_time"]) or is_na(r["end_time"])]
        if bad:
            # surface the corrupt source row: a silent coercion wrote
            # literal 'nan\tnan' label rows Audacity rejects
            raise ValueError(
                "audacity export: non-numeric start/end time(s) in rows for "
                f"{sorted(set(bad))[:3]}")
        rows = sort_rows(table.rows, ["file_name", "start_time"])

        # label files are keyed by recording stem; recordings that differ
        # only in extension (x.wav + x.flac) must not collide on x.txt
        groups: dict = {}
        for r in rows:
            groups.setdefault(r["file_name"], []).append(r)
        stems: dict = {}
        for n in groups:
            stems.setdefault(Path(n).stem, []).append(n)
        label_name = {
            n: (f"{Path(n).stem}.txt" if len(group) == 1
                else f"{n.replace('/', '_')}.txt")
            for group in stems.values() for n in group
        }

        written = set()
        for wav_name, group in groups.items():
            lines = [
                f"{r['start_time']:.{precision}f}\t{r['end_time']:.{precision}f}\t{comment}"
                for r in group
            ]
            out = out_root / label_name[wav_name]
            out.write_text("\n".join(lines) + "\n")
            written.add(out.name)
        # the output dir is exporter-owned: a recording whose detections
        # were all deleted in review must not leave a stale label file
        # claiming regions the user removed
        for old in out_root.glob("*.txt"):
            if old.name not in written:
                old.unlink()
        return None
