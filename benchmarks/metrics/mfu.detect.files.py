"""Model FLOP utilization of detection in the untraced window, in %: the
windows the reference algorithm evaluates for the files done times the
frozen forward work of one (``counts/specunet2d.py``), over the wall
time and the configuration's ``peak_flops``.  Moves ``detect_files_per_s``."""

from benchmarks.harness.readers import mfu_detect


def read(records):
    return mfu_detect(records)
