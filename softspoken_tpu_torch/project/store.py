"""Detections CSV store, written with the ``csv`` module.

Same columns and row format as the JAX package's pandas-backed
``DetectionStore`` (schema of ``silencer_ui.py:775-817``):

    ID, file_path, file_name, start_time, end_time, erase, user_comment,
    review_datetime

rewritten after every completed file (worker.py:127-128), so a stopped run
resumes at file granularity.  A ``.processed`` sidecar records finished files
whether or not they had detections.  ``backfill_ids`` and
``empty_detections_table`` are the JAX package's ``backfill_ids`` and
``empty_detections_frame`` over a ``Table`` (``project/table.py``).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, List, Set, Tuple

from .table import Table, is_na, to_numeric

COLUMNS = [
    "ID", "file_path", "file_name", "start_time", "end_time",
    "erase", "user_comment", "review_datetime",
]


def empty_detections_table() -> Table:
    return Table(COLUMNS)


def backfill_ids(table: Table) -> Table:
    """Insert/repair the ID column (silencer_ui.py:797-807): a missing column
    becomes 1..n in front; IDs that are not numbers get max present ID + 1,
    + 2, ... in row order; every ID becomes an int (truncated)."""
    if "ID" not in table.columns:
        table.set_column("ID", list(range(1, len(table) + 1)), pos=0)
        return table
    ids = to_numeric(table.column("ID"))
    present = [v for v in ids if not is_na(v)]
    nxt = (int(max(present)) if present else 0) + 1
    out = []
    for v in ids:
        if is_na(v):
            out.append(nxt)
            nxt += 1
        else:
            out.append(int(v))
    table.set_column("ID", out)
    return table


class DetectionStore:
    """Detections table bound to one CSV file."""

    def __init__(self, csv_path: str):
        self.path = csv_path
        self.rows: List[Dict[str, str]] = []
        if os.path.exists(csv_path):
            with open(csv_path, newline="", encoding="utf-8") as f:
                for r in csv.DictReader(f):
                    self.rows.append({c: (r.get(c) or "") for c in COLUMNS})
            self._backfill_ids()

    # reference constructor took the whole project settings dict
    # (silencer_ui.py:776-793); this classmethod keeps that call shape.
    @classmethod
    def for_project(cls, project: Dict) -> "DetectionStore":
        return cls(project["detections_file"])

    def _backfill_ids(self) -> None:
        """Give rows without a numeric ID the next free ones (silencer_ui.py:797-807)."""
        ids = backfill_ids(Table(COLUMNS, self.rows)).column("ID")
        for r, i in zip(self.rows, ids):
            r["ID"] = str(i)
            if r["erase"] == "":
                r["erase"] = "0"

    def next_id(self) -> int:
        """Autoincrement from the current max (worker.py:107-111)."""
        return max((int(r["ID"]) for r in self.rows), default=0) + 1

    @property
    def _processed_sidecar(self) -> str:
        return self.path + ".processed"

    def processed_files(self) -> Set[str]:
        """Full paths with rows in the table or listed in the sidecar."""
        out = {os.path.join(r["file_path"], r["file_name"]) for r in self.rows}
        try:
            with open(self._processed_sidecar, encoding="utf-8") as f:
                out.update(line.rstrip("\n") for line in f if line.strip())
        except OSError:
            pass
        return out

    def mark_processed(self, file_full_path: str) -> None:
        with open(self._processed_sidecar, "a", encoding="utf-8") as f:
            f.write(file_full_path + "\n")

    def append_intervals(self, file_full_path: str,
                         intervals: Iterable[Tuple[float, float]]) -> int:
        """Append one file's detections (worker.py:113-125); returns the count."""
        d, b = os.path.dirname(file_full_path), os.path.basename(file_full_path)
        nid = self.next_id()
        added = [
            {"ID": str(nid + i), "file_path": d, "file_name": b,
             "start_time": repr(float(s)), "end_time": repr(float(e)),
             "erase": "0", "user_comment": "", "review_datetime": ""}
            for i, (s, e) in enumerate(intervals)
        ]
        self.rows.extend(added)
        return len(added)

    def save(self) -> None:
        """Rewrite the CSV (atomically: a crash leaves the previous one)."""
        tmp = f"{self.path}.tmp{os.getpid()}"
        with open(tmp, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=COLUMNS, lineterminator="\n")
            w.writeheader()
            w.writerows(self.rows)
        os.replace(tmp, self.path)



# Backwards-shaped alias matching the reference class name
DetectionProject = DetectionStore
