"""Training steps completed in the window over its wall time; the loop's
metrics read after each call of ``n_inner`` steps is the sync point at both
ends."""


def read(records):
    w = records.get("window")
    if not w or not w.get("steps"):
        return None
    return w["steps"] / w["wall_s"]
