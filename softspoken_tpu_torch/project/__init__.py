"""Projects: the registry and file layout, the detections store, and the
pandas-free table the workflow's CSV files go through."""

from .manager import OUTPUTS_DIRNAME, ProjectManager
from .store import (
    COLUMNS,
    DetectionProject,
    DetectionStore,
    backfill_ids,
    empty_detections_table,
)
from .table import Table, read_csv, to_numeric, write_csv

__all__ = [
    "ProjectManager", "OUTPUTS_DIRNAME", "DetectionStore", "DetectionProject",
    "COLUMNS", "backfill_ids", "empty_detections_table", "Table", "read_csv",
    "to_numeric", "write_csv",
]
