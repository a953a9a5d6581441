"""Share of the untraced window's wall time that the fused engine's run
loop waited for a chunk's host fill and upload (``StageTimers
["wait_prepare"]``), in %.  Moves ``detect_audio_s_per_s``."""

from benchmarks.harness.readers import stage_pct


def read(records):
    return stage_pct(records, "wait_prepare")
