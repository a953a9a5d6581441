"""The JAX package's quality on the card's four eval conditions.

Computes, with the JAX package on the CPU, what
tests/test_torch_quality_cuda.py::test_eval_condition_holds_the_jax_cpu_quality
measures on the card with the port: for each condition of
``scripts/quality_grid.py`` listed in ``CONDITIONS`` (its seed is ``7000 +``
the condition's index there), 8 files x 120 s at 32 kHz from
``make_eval_set``, detected with the trained checkpoint in fast mode with
``mel_precision="highest"`` through ``detect_file_streaming``, and scored
at the parity operating point as ``scripts/quality_grid.py::metrics_from``
scores it, without and with the music post-filter at its default
threshold (as ``postfilter_parity_metrics`` applies it).

    JAX_PLATFORMS=cpu python tests/jax_eval_reference.py [v1_clean ...]

prints one JSON line per condition; that test carries the F1 values as its
reference (``EVAL_REFERENCE``).  Any other tag of the grid (``v2_snr5``,
``v1_fading``, ...) is computed the same way, with its own seed.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (tag, generator, seed, degradations): quality_grid.py's conditions
# clean (index 0), mulaw (7) and reverb08 (14)
CONDITIONS = [
    ("v1_clean", "v1", 7000, None),
    ("v2_clean", "v2", 7000, None),
    ("v1_mulaw", "v1", 7007, ["mulaw"]),
    ("v2_reverb08", "v2", 7014, ["reverb08"]),
]
N_FILES, SECONDS = 8, 120.0
THRESHOLD, BREAK, MIN_LEN, IOU = 0.1, 0.5, 0.1, 0.5


def grid_condition(tag):
    """(tag, generator, seed, degradations, snr_db) of any grid tag, from
    ``scripts/quality_grid.py``'s list (its seed is 7000 + the index)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from quality_grid import CONDITIONS as GRID

    gen, name = tag.split("_", 1)
    ci = [c for c, _kw in GRID].index(name)
    kw = GRID[ci][1]
    return tag, gen, 7000 + ci, kw.get("degradations"), kw.get("snr_db")


def score(per_file, pad, sr, music_threshold=None):
    """Parity-point metrics of ``(avg, dur, truth, path)`` per file; with
    ``music_threshold`` the predictions go through the post-filter."""
    from softspoken_tpu.engine import postfilter as PF
    from softspoken_tpu.engine import regions as R
    from softspoken_tpu.io.audio import load_audio_startstop
    from softspoken_tpu.train import evaluate as E

    ft, et, tax = {}, {}, {}
    dropped = total = 0
    for avg, dur, truth, path in per_file:
        regs = R.shift_regions(R.find_speech_regions(avg, THRESHOLD, BREAK), -pad)
        regs = [(max(0.0, s), min(dur, e)) for s, e in regs if e > 0 and s < dur]
        pred = R.filter_min_length(regs, MIN_LEN)
        if music_threshold is not None:
            def read_ctx(s, e, _p=path):
                return load_audio_startstop(_p, (s, e), target_sr=sr)[0]

            kept, _ = PF.filter_intervals(pred, read_ctx, sr, dur, music_threshold)
            dropped += len(pred) - len(kept)
            total += len(pred)
            pred = kept
        E._accumulate(ft, E.frame_metrics(pred, truth, dur))
        E._accumulate(et, E.event_metrics(pred, truth, IOU))
        E.merge_taxonomy(tax, E.event_error_taxonomy(pred, truth, IOU))
    out = {"frame_f1": E._finalize(ft)["f1"], "event_f1": E._finalize(et)["f1"],
           "taxonomy": E.finalize_taxonomy(tax)}
    if music_threshold is not None:
        out.update(regions_dropped=dropped, regions_total=total)
    return out


def main(tags) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from softspoken_tpu import Config
    from softspoken_tpu.engine import Detector
    from softspoken_tpu.engine import postfilter as PF
    from softspoken_tpu.train import evaluate as E

    cfg = Config().with_engine(mel_precision="highest")
    det = Detector(cfg, checkpoint_path=os.path.join(
        REPO, "root/models/spec_unet_2d/model_checkpoint"))
    assert det.epoch >= 0, "the trained checkpoint did not load"
    sr, pad = cfg.dsp.sample_rate, cfg.engine.pad_seconds
    base = tempfile.mkdtemp(prefix="jax_eval_ref_")
    runs = [(*c, None) for c in CONDITIONS if not tags or c[0] in tags]
    runs += [grid_condition(t) for t in tags if t not in {c[0] for c in CONDITIONS}]
    for tag, gen, seed, deg, snr_db in runs:
        t0 = time.time()
        labels = E.make_eval_set(os.path.join(base, tag), n_files=N_FILES,
                                 seconds=SECONDS, seed=seed, generator=gen,
                                 degradations=deg, snr_db=snr_db)
        synth_s = time.time() - t0
        t0 = time.time()
        per_file = []
        for path, truth in E.load_labels(labels):
            res = det.detect_file_streaming(path)
            per_file.append((np.asarray(res.avg_values, np.float32),
                             float(res.audio_seconds), truth, path))
        detect_s = time.time() - t0
        print(json.dumps({
            "condition": tag, "seed": seed,
            "plain": score(per_file, pad, sr),
            "filtered": score(per_file, pad, sr, PF.DEFAULT_THRESHOLD),
            "synth_s": round(synth_s, 1), "detect_s": round(detect_s, 1),
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
