"""The runner's persist time per completed file in the untraced window, in
ms: ``StageTimers["persist"]`` (append the rows, rewrite the CSV, mark
the file processed) over the files done.  Moves ``detect_files_per_s``."""

from benchmarks.harness.readers import persist_ms_per_file


def read(records):
    return persist_ms_per_file(records)
