"""Export framework: a named-transform registry over the review table.

A copy of the JAX package's ``export/base.py`` over a ``Table``
(``project/table.py``) in place of a DataFrame.  Behavior parity with
``review_exporter.py:31-126``: transforms receive a *copy* of the canonical
table and either return content (``Table`` → CSV, str/bytes → written
verbatim) or handle their own IO and return None.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

from ..project.table import Table, write_csv

ExportResult = Union[Table, str, bytes, None]


class Transform:
    """One application-specific export. Subclass and implement __call__."""

    name: str = "unnamed"
    extension: str = ".csv"

    def __call__(self, table: Table, **kwargs) -> ExportResult:
        raise NotImplementedError


class ReviewExportManager:
    def __init__(self, table: Table):
        self.table = table
        self._registry: Dict[str, Transform] = {}

    def register_transform(self, transform: Transform) -> None:
        if transform.name in self._registry:
            raise KeyError(f"transform '{transform.name}' already registered")
        self._registry[transform.name] = transform

    def transform(self, cls: type) -> type:
        """Decorator registration."""
        self.register_transform(cls())
        return cls

    def names(self):
        return list(self._registry)

    def export(self, name: str, dst: Union[str, Path], make_dirs: bool = True,
               **kw) -> Optional[Path]:
        """Run one transform.  Returns the path the manager wrote, or None
        when the transform handled its own IO (returned None)."""
        if name not in self._registry:
            raise KeyError(f"no transform named '{name}'")
        tf = self._registry[name]
        dst = Path(dst)
        if dst.is_dir():
            dst = dst / f"review{tf.extension}"
        if make_dirs:
            dst.parent.mkdir(parents=True, exist_ok=True)

        result = tf(self.table.copy(), **kw)
        if result is None:
            return None
        if isinstance(result, Table):
            write_csv(str(dst), result)
        elif isinstance(result, str):
            dst.write_text(result)
        elif isinstance(result, bytes):
            dst.write_bytes(result)
        else:
            raise TypeError(f"unsupported transform return type {type(result).__name__}")
        return dst

    def export_all(self, dst_dir: Union[str, Path], **kw) -> Dict[str, Optional[Path]]:
        return {name: self.export(name, dst_dir, **kw) for name in self._registry}


def standard_manager(table: Table) -> ReviewExportManager:
    """Manager pre-loaded with the three stock exporters, as wired by the
    review screen on every persist (review_detections.py:142-169)."""
    from .audacity import AudacityTxtTransform
    from .kaleidoscope import KaleidoscopeCsvTransform
    from .raven import RavenTxtTransform

    mgr = ReviewExportManager(table)
    mgr.register_transform(AudacityTxtTransform())
    mgr.register_transform(KaleidoscopeCsvTransform())
    mgr.register_transform(RavenTxtTransform())
    return mgr


def run_standard_exports(table: Table, base_dir: Union[str, Path], project_name: str) -> None:
    """The export fan-out performed on every review save."""
    mgr = standard_manager(table)
    for name in mgr.names():
        mgr.export(name, dst=".", base_dir=base_dir, project_name=project_name)
