"""Share of the untraced window's wall time that the fused engine's host
waited on the card for a file's chunk programs before fetching their grids
(``StageTimers["device_wait"]``), in %.  Moves ``detect_files_per_s``."""

from benchmarks.harness.readers import stage_pct


def read(records):
    return stage_pct(records, "device_wait")
