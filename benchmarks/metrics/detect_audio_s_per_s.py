"""Audio seconds of every file completed in the window over the window's
whole wall time; the file in flight when ``seconds`` ran out completes
and counts, and its completion closes the window."""

from benchmarks.harness.readers import audio_rate


def read(records):
    return audio_rate(records)
