"""95th percentile over every file of the untraced window of the time from
the runner starting a file (``file_started``) to its rows being saved
(``file_done``), in ms.  Moves ``detect_files_per_s``."""

from benchmarks.harness.readers import file_p95_ms


def read(records):
    return file_p95_ms(records)
