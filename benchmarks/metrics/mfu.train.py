"""Model FLOP utilization of training, in %: clips trained in the untraced
window times the frozen work of one clip (``counts/specunet2d.py``:
3 x the forward with both heads, plus the speech and noise targets'
frontends), over the window's wall time and the configuration's stated
peak (``peak_flops``, dense TF32)."""

from benchmarks.harness import registry


def read(records):
    w = records.get("window")
    if not w or not w.get("clips"):
        return None
    counts = registry.load_module("counts", "specunet2d")
    work = w["clips"] * counts.train_flops_per_clip()
    return 100.0 * work / (w["wall_s"] * float(records["config"]["peak_flops"]))
