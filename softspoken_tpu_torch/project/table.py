"""A small column table with pandas' CSV semantics, written without pandas.

The JAX package keeps its detection and review tables in pandas DataFrames;
the card's machine has no pandas.  ``Table`` holds the same data as rows of
dicts, one key per column, with cells of the Python types a DataFrame column
would hold: ``int``, ``float`` (``NAN`` for a missing value), ``bool`` or
``str``.  The functions here reproduce the pieces of pandas that decide the
bytes of the CSV files the workflow writes:

  * ``read_csv`` infers each column's type as ``pandas.read_csv``'s C
    parser does: all integers → ``int`` (``float`` when a cell is missing),
    all decimals → ``float``, all booleans → ``bool``, else ``str``; with
    ``keep_default_na`` pandas' NA strings (and the empty field) are missing;
  * ``to_numeric`` is ``pd.to_numeric(..., errors="coerce")`` over a column;
  * ``write_csv`` is ``DataFrame.to_csv(index=False)``: an integer column
    prints as integers, a numeric column with a float or a missing cell
    prints every cell as a float (Python's shortest repr), a missing cell is
    an empty field, and the ``csv`` module quotes as pandas does.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

NAN = float("nan")

# pandas._libs.parsers.STR_NA_VALUES: what read_csv and to_numeric read as NaN
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)",
                    re.IGNORECASE)
_WS = " \t"


def is_na(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _parse(s: str):
    """A string as the C parser's numeric conversion reads it: int, float,
    or None when it is not a number."""
    t = s.strip(_WS)
    if _INT.fullmatch(t):
        return int(t)
    if _FLOAT.fullmatch(t):
        return float(t)
    return None


def to_number(v):
    """One cell through ``pd.to_numeric(errors="coerce")``."""
    if _is_number(v) or isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v in NA_STRINGS:
            return NAN
        x = _parse(v)
        return NAN if x is None else x
    return NAN


def _promote(values: List) -> List:
    """A numeric column's common type: ints stay ints unless a float or a
    missing cell is present, which makes every cell a float."""
    if any(isinstance(v, float) for v in values):
        return [float(v) for v in values]
    return values


def to_numeric(values: Iterable) -> List:
    """``pd.to_numeric(column, errors="coerce")``."""
    return _promote([to_number(v) for v in values])


def infer_column(cells: Sequence[str], keep_default_na: bool = True) -> List:
    """One column of strings as ``pd.read_csv`` types it."""
    missing = [keep_default_na and c in NA_STRINGS for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return [NAN] * len(cells)
    parsed = [_parse(c) for c in present]
    if all(p is not None for p in parsed):
        it = iter(parsed)
        return _promote([NAN if m else next(it) for m in missing])
    if all(c in _BOOLS for c in present):
        return [NAN if m else _BOOLS[c] for c, m in zip(cells, missing)]
    return [NAN if m else c for c, m in zip(cells, missing)]


class Table:
    """Columns in order and rows of dicts holding every column."""

    def __init__(self, columns: Sequence[str], rows: Optional[List[Dict]] = None):
        self.columns = list(columns)
        self.rows = [{c: r.get(c, NAN) for c in self.columns} for r in (rows or [])]

    @classmethod
    def from_columns(cls, data: Dict[str, Sequence]) -> "Table":
        """Like ``pd.DataFrame(dict_of_lists)``."""
        cols = list(data)
        n = len(data[cols[0]]) if cols else 0
        return cls(cols, [{c: data[c][i] for c in cols} for i in range(n)])

    def __len__(self) -> int:
        return len(self.rows)

    def copy(self) -> "Table":
        return Table(self.columns, [dict(r) for r in self.rows])

    def column(self, name: str) -> List:
        return [r[name] for r in self.rows]

    def set_column(self, name: str, values: Sequence, pos: Optional[int] = None) -> None:
        if name not in self.columns:
            self.columns.insert(len(self.columns) if pos is None else pos, name)
        for r, v in zip(self.rows, values):
            r[name] = v
        # keep each row's key order the column order
        self.rows = [{c: r[c] for c in self.columns} for r in self.rows]


def read_csv(path: str, sep: str = ",", keep_default_na: bool = True) -> Table:
    """``pd.read_csv(path, sep=sep, keep_default_na=...)``."""
    with open(path, newline="", encoding="utf-8") as f:
        lines = list(csv.reader(f, delimiter=sep))
    if not lines:
        raise ValueError(f"{path}: no columns to parse")
    header, body = lines[0], [ln for ln in lines[1:] if ln]
    width = len(header)
    cols = [infer_column([ln[i] if i < len(ln) else "" for ln in body], keep_default_na)
            for i in range(width)]
    return Table(header, [{h: cols[i][j] for i, h in enumerate(header)}
                          for j in range(len(body))])


def _column_text(values: Sequence) -> List[str]:
    """``DataFrame.to_csv``'s text for one column's cells."""
    if values and all(_is_number(v) or is_na(v) for v in values):
        if any(isinstance(v, float) or v is None for v in values):
            return ["" if is_na(v) else repr(float(v)) for v in values]
        return [str(v) for v in values]
    return ["" if is_na(v) else (repr(v) if isinstance(v, float) else str(v))
            for v in values]


def write_csv(path: str, table: Table, sep: str = ",") -> None:
    """``table.to_csv(path, sep=sep, index=False)`` with ``"\\n"`` line ends."""
    text = [_column_text(table.column(c)) for c in table.columns]
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        w.writerow(table.columns)
        for j in range(len(table)):
            w.writerow([t[j] for t in text])


def sort_rows(rows: List[Dict], by: Sequence[str]) -> List[Dict]:
    """``sort_values(by)`` for two or more keys: stable (pandas' lexsort),
    each key ascending with missing cells last."""
    return sorted(rows, key=lambda r: tuple((is_na(r[c]), 0 if is_na(r[c]) else r[c])
                                            for c in by))


def round_column(values: Sequence, decimals: int) -> List:
    """``Series.round(decimals)``: numpy's rounding on a float column; an
    integer column is left as it is."""
    values = _promote(list(values))
    if not any(isinstance(v, float) for v in values):
        return values
    return np.round(np.asarray(values, np.float64), decimals).tolist()
