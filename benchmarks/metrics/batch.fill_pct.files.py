"""Share of the window slots the fused engine launched that held a real
window, over the untraced window, in %: 100 × ``count.windows_live`` ÷
``count.windows_launched`` of the runner's ``StageTimers`` (a chunk
launches ``chunk_w`` slots, whole batches of ``device_batch``).  Moves
``detect_files_per_s``."""


def read(records):
    w = records.get("window") or {}
    timers = w.get("timers", {})
    live, launched = timers.get("count.windows_live"), timers.get("count.windows_launched")
    if live is None or not launched:
        return None
    return 100.0 * live / launched
