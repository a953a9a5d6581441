"""K1's share of its roofline in the traced slice, in %: the least time of
every K1 launch (``counts/k1.py``, at the configuration's device batch)
over K1's device time, over the launches the trace names.  No K1 launch:
nothing is read.  Moves ``detect_files_per_s``."""

from benchmarks.harness.readers import k1_roofline_pct


def read(records):
    return k1_roofline_pct(records)
