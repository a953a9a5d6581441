"""Share of the traced slice in which no kernel, copy or memset ran on the
card (the union of the device intervals of the Chrome trace), in %.
Moves ``train_steps_per_s``."""

from benchmarks.harness.readers import idle_pct


def read(records):
    return idle_pct(records)
