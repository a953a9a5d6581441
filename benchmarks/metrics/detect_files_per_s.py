"""Files completed in the window over the window's whole wall time; the
file in flight when ``seconds`` ran out completes and counts."""

from benchmarks.harness.readers import file_rate


def read(records):
    return file_rate(records)
