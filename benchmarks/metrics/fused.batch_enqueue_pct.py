"""Share of the untraced window's wall time that the chunk program spent
enqueueing K1 and the U-Net, batch by batch (``StageTimers["chunk.batch"]``,
inside ``dispatch``; a full launch queue blocks it too), in %.  Moves
``detect_audio_s_per_s``."""

from benchmarks.harness.readers import stage_pct


def read(records):
    return stage_pct(records, "chunk.batch")
