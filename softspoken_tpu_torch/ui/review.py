"""Headless review session — the review screen's data semantics without Qt.

A copy of the JAX package's ``ui/review.py`` over a ``Table``
(``project/table.py``) in place of a DataFrame; it writes the same
``review.csv``.  Reproduces the behavior of ``ReviewDetectionsScreen``
(review_detections.py) as a plain controller any frontend (CLI, TUI, web,
Qt) can drive:

  * load: review CSV if present, else the detections CSV filtered to
    length > minimum_detection_len (:220-235, 764-770); both read without
    NA strings (``keep_default_na=False``)
  * ordering: sorted by (file_name, start_time) like the table (:976)
  * keep/erase: set ``erase`` 0/1 + stamp ``review_datetime`` "now", then
    auto-advance (:677-717)
  * add: insert keeping the (file_name, start_time) sort order; ID assigned
    on save from the autoincrement backfill (:538-675)
  * delete: drop rows (:175-211)
  * save: normalize types, backfill IDs, write review CSV, and re-run all
    three exporters on every persist (:93-169)
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config, DEFAULT_CONFIG
from ..export import run_standard_exports
from ..project.store import COLUMNS, backfill_ids
from ..project.table import NAN, Table, is_na, read_csv, sort_rows, to_number, to_numeric, write_csv

_TIME_FMT = "%Y-%m-%d %H:%M:%S"


class ReviewSession:
    def __init__(
        self,
        project: dict,
        projects_folder: str,
        config: Config = DEFAULT_CONFIG,
        now_fn=None,
    ):
        self.project = project
        self.projects_folder = projects_folder
        self.cfg = config
        self._now = now_fn or (lambda: datetime.datetime.now().strftime(_TIME_FMT))
        self.current_index = 0
        self.table = self._load()

    @property
    def rows(self) -> List[Dict]:
        return self.table.rows

    # ------------------------------------------------------------------
    def _load(self) -> Table:
        review_path = self.project.get("review_file")
        det_path = self.project.get("detections_file")
        if review_path and os.path.exists(review_path):
            t = read_csv(review_path, keep_default_na=False)
        elif det_path and os.path.exists(det_path):
            t = read_csv(det_path, keep_default_na=False)
            start = to_numeric(t.column("start_time"))
            end = to_numeric(t.column("end_time"))
            min_len = self.cfg.engine.minimum_detection_len
            # a missing time makes the difference NaN, which compares False
            t.rows = [r for r, s, e in zip(t.rows, start, end) if (e - s) > min_len]
        else:
            t = Table(COLUMNS)
        t = backfill_ids(t)
        # table order: (file_name, start_time) — review_detections.py:976
        if len(t):
            t.set_column("start_time", to_numeric(t.column("start_time")))
            t.set_column("end_time", to_numeric(t.column("end_time")))
            t.rows = sort_rows(t.rows, ["file_name", "start_time"])
        return t

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.table)

    def current(self) -> Optional[Dict]:
        if 0 <= self.current_index < len(self.table):
            return self.table.rows[self.current_index]
        return None

    def seek(self, index: int) -> None:
        self.current_index = int(np.clip(index, 0, max(0, len(self.table) - 1)))

    def next(self) -> None:
        self.seek(self.current_index + 1)

    def prev(self) -> None:
        self.seek(self.current_index - 1)

    # ------------------------------------------------------------------
    def keep(self, index: Optional[int] = None, persist: bool = True) -> None:
        """Keep → erase=0 + review timestamp (review_detections.py:677-681;
        note the reference README says the opposite — the code is right)."""
        self._label(0, index, persist)

    def erase(self, index: Optional[int] = None, persist: bool = True) -> None:
        self._label(1, index, persist)

    def _checked_index(self, index: Optional[int]) -> Optional[int]:
        """Bounds-checked row index, or None when there is nothing to edit."""
        if len(self.table) == 0:
            return None
        i = self.current_index if index is None else index
        if not 0 <= i < len(self.table):
            return None
        return i

    def _label(self, flag: int, index: Optional[int], persist: bool) -> None:
        i = self._checked_index(index)
        if i is None:
            return
        self.table.rows[i]["erase"] = flag
        self.table.rows[i]["review_datetime"] = self._now()
        if persist:
            self.save()
        if index is None:
            self.next()  # auto-advance (:715-717)

    def set_comment(self, text: str, index: Optional[int] = None, persist: bool = False):
        i = self._checked_index(index)
        if i is None:
            return
        self.table.rows[i]["user_comment"] = text
        if persist:
            self.save()

    def set_times(
        self, start: float, end: float, index: Optional[int] = None, persist: bool = False
    ):
        i = self._checked_index(index)
        if i is None:
            return
        self.table.rows[i]["start_time"] = float(start)
        self.table.rows[i]["end_time"] = float(end)
        if persist:
            self.save()

    # ------------------------------------------------------------------
    def add(
        self,
        file_path: str,
        file_name: str,
        start_time: float,
        end_time: float,
        persist: bool = True,
    ) -> Optional[int]:
        """Insert a detection keeping (file_name, start_time) order; the ID
        is assigned by the save-time backfill (review_detections.py:538-675).
        Returns the inserted row position, or None if end ≤ start."""
        if end_time <= start_time:
            return None
        insert_at = len(self.table)
        for j, (name, start) in enumerate(zip(self.table.column("file_name"),
                                              to_numeric(self.table.column("start_time")))):
            # a missing start compares False, as NaN does in the vectorized form
            if name > file_name or (name == file_name and start > start_time):
                insert_at = j
                break
        row = {
            "ID": NAN,
            "file_path": file_path,
            "file_name": file_name,
            "start_time": float(f"{start_time:.3f}"),
            "end_time": float(f"{end_time:.3f}"),
            "erase": 0,
            "user_comment": "",
            "review_datetime": "",
        }
        # a column the table lacks is appended, missing in the other rows
        cols = self.table.columns + [c for c in row if c not in self.table.columns]
        rows = self.table.rows
        self.table = Table(cols, rows[:insert_at] + [row] + rows[insert_at:])
        self.current_index = insert_at
        if persist:
            self.save()
        return insert_at

    def delete(self, indexes: Sequence[int], persist: bool = True) -> None:
        n = len(self.table)
        drop = {range(n)[i] for i in indexes}
        self.table.rows = [r for j, r in enumerate(self.table.rows) if j not in drop]
        self.current_index = min(self.current_index, max(0, len(self.table) - 1))
        if persist:
            self.save()

    # ------------------------------------------------------------------
    def reviewed_mask(self) -> np.ndarray:
        """Rows already graded (used for highlighting — :1002-1011)."""
        if "review_datetime" not in self.table.columns:
            return np.zeros(len(self.table), bool)
        return np.asarray([bool(str(v).strip()) for v in self.table.column("review_datetime")],
                          dtype=bool)

    def stats(self) -> dict:
        n = len(self.table)
        rmask = self.reviewed_mask()
        if "erase" in self.table.columns:
            emask = np.asarray([to_number(v) == 1 for v in self.table.column("erase")],
                               dtype=bool)
        else:
            emask = np.zeros(n, bool)
        # kept counts rows BOTH reviewed and not erased — `reviewed-erased`
        # went wrong (even negative) when erase=1 rows lacked a review
        # timestamp, e.g. hand-edited CSVs
        return {"total": n, "reviewed": int(rmask.sum()),
                "erased": int(emask.sum()),
                "kept": int((rmask & ~emask).sum())}

    # ------------------------------------------------------------------
    def save(self, persist: bool = True) -> Table:
        """Normalize + write review CSV + re-run the three exporters
        (the reference does this on every grade/edit/close — :93-169)."""
        t = backfill_ids(self.table.copy())
        t.set_column("start_time", to_numeric(t.column("start_time")))
        t.set_column("end_time", to_numeric(t.column("end_time")))
        # to_numeric(coerce).fillna(0).astype(int): a fraction truncates
        t.set_column("erase", [0 if is_na(v) else int(v) for v in to_numeric(t.column("erase"))])
        self.table = t
        if persist:
            write_csv(self.project["review_file"], t)
            run_standard_exports(t, self.projects_folder, self.project["name"])
        return t
