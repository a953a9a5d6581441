"""Share of the untraced window's wall time that the fused engine's run
loop spent enqueueing chunk programs (``StageTimers["dispatch"]``), in
%; a full launch queue blocks it too.  Moves ``detect_files_per_s``."""

from benchmarks.harness.readers import stage_pct


def read(records):
    return stage_pct(records, "dispatch")
