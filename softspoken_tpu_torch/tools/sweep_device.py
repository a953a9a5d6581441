"""Sweep device-only throughput across engine operating points: the port of
``scripts/sweep_device.py``.

Measures ``FusedStreamingEngine.device_only_rate`` (all inputs resident on
the device) for a list of config variants, printing audio-sec/s and MFU
against the card's dense bf16 peak (``runtime.metrics.device_peak_flops``;
null on the CPU) — the companion of ``profile_chunk``.  The "phase" and
"unroll" variants are accepted as in the JAX package and run as the port's
Config computes them (concat/direct: ``scan_unroll`` and
``decoder_upsample="phase"`` change no kernel here).

    python -m softspoken_tpu_torch.tools.sweep_device [--repeats 8]
        [--variants a,b,...] [--wire-sr 16000] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from ..ckpt import fixture_state_dict
from ..config import Config
from ..engine import Detector
from ..engine.fused import get_fused_engine
from ..runtime.metrics import device_peak_flops, mfu
from . import add_device_arg

VARIANTS = {
    # name: engine-config overrides
    "base":        dict(device_batch=128, chunk_seconds=600.0),
    "phase":       dict(device_batch=128, chunk_seconds=600.0,
                        decoder_upsample="phase"),
    "b96":         dict(device_batch=96, chunk_seconds=600.0),
    "b160":        dict(device_batch=160, chunk_seconds=600.0),
    "b192":        dict(device_batch=192, chunk_seconds=600.0),
    "b256":        dict(device_batch=256, chunk_seconds=600.0),
    "c900":        dict(device_batch=128, chunk_seconds=900.0),
    "c1200":       dict(device_batch=128, chunk_seconds=1200.0),
    "b192c900":    dict(device_batch=192, chunk_seconds=900.0),
    "phase_b192":  dict(device_batch=192, chunk_seconds=600.0,
                        decoder_upsample="phase"),
    "unroll2":     dict(device_batch=128, chunk_seconds=600.0, scan_unroll=2),
    "unroll4":     dict(device_batch=128, chunk_seconds=600.0, scan_unroll=4),
    "unroll8":     dict(device_batch=128, chunk_seconds=600.0, scan_unroll=8),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    # the decimated lossy wire (32k -> 16k, io/decimate.py) makes the device
    # program resample from 16 kHz: sweep that by default, as the JAX script
    ap.add_argument("--wire-sr", type=int, default=16000)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    state = fixture_state_dict(seed=0)
    peak = None
    rows = []
    for name in args.variants.split(","):
        ov = VARIANTS[name]
        cfg = Config().with_engine(**ov)
        t0 = time.perf_counter()
        det = Detector(cfg, state_dict=state, device=args.device)
        if peak is None and det.device.type == "cuda":
            peak = device_peak_flops()
        eng = get_fused_engine(det, args.wire_sr, "mulaw8")
        r = max(eng.device_only_rate(args.repeats), eng.device_only_rate(args.repeats))
        build = time.perf_counter() - t0
        m = None if peak is None else mfu(r, peak_flops=peak)
        mfu_text = "null" if m is None else f"{m:.4f}"
        print(f"{name:12s} {r:8.0f} audio-s/s  mfu={mfu_text}  "
              f"(total incl. first call {build:.0f}s)  {ov}", flush=True)
        rows.append({"variant": name, "audio_s_per_s": r, "mfu": m, "overrides": ov})
    return rows


if __name__ == "__main__":
    main()
