"""Where does the end-to-end wall time go?  Per-stage breakdown of the fused
pipeline: the port of ``scripts/profile_e2e.py``.

Runs the WAV → intervals pass that ``bench`` times, with ``StageTimers``
threaded into ``FusedStreamingEngine.run``:

- host_fill    — disk read + staging copy (and a lossy wire's encode), on
                 the read-ahead thread
- device_put   — host→device upload of the chunk PCM (upload thread)
- wait_prepare — main thread blocked on the read-ahead future
- dispatch     — main thread issuing the chunk program (async)
- final_fetch  — download of all score grids + compute drain

host_fill + device_put overlap the device compute of the previous chunk;
wait_prepare + dispatch + final_fetch are the serial path.  If wait_prepare
≈ device_put the pipeline is upload-bound; if final_fetch dominates, the
device is.  Fixture weights, as the bench.

    python -m softspoken_tpu_torch.tools.profile_e2e [--seconds 1800]
        [--repeats 3] [--codec auto|pcm16|mulaw8|adpcm4] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from ..bench import make_recording
from ..ckpt import fixture_state_dict
from ..config import Config
from ..engine import Detector
from ..engine.fused import _i16_kind, get_fused_engine
from ..io import wavio
from ..runtime.metrics import StageTimers
from . import add_device_arg

STAGES = ("host_fill", "device_put", "wait_prepare", "dispatch", "final_fetch")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1800.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--chunk-seconds", type=float, default=150.0)
    ap.add_argument("--codec", default="auto",
                    choices=["auto", "pcm16", "mulaw8", "adpcm4"])
    add_device_arg(ap)
    args = ap.parse_args(argv)

    cfg = Config().with_engine(device_batch=args.batch,
                               chunk_seconds=args.chunk_seconds,
                               upload_codec=args.codec)
    det = Detector(cfg, state_dict=fixture_state_dict(seed=0), device=args.device)

    tmp = os.path.join(tempfile.gettempdir(), "softspoken_bench")
    os.makedirs(tmp, exist_ok=True)
    path = os.path.join(tmp, f"bench_{int(args.seconds)}s.wav")
    if not os.path.exists(path):
        make_recording(path, args.seconds)

    inf = wavio.info(path)
    kind = _i16_kind(det)
    print(f"wire kind: {kind}, device {det.device}", flush=True)
    engine = get_fused_engine(det, inf.samplerate, kind)

    reader = wavio.RawReader(path)

    def read_native(start, frames):
        reader.will_need(start + frames, frames)
        return reader.read_raw(start, frames).view("<i2")

    runs = []
    try:
        engine.run(read_native, inf.frames)  # warm: first-call costs
        for r in range(args.repeats):
            timers = StageTimers()
            t0 = time.perf_counter()
            res = engine.run(read_native, inf.frames, timers=timers)
            wall = time.perf_counter() - t0
            rate = res.audio_seconds / wall
            tot = timers.totals
            acct = sum(tot.get(k, 0.0) for k in ("wait_prepare", "dispatch", "final_fetch"))
            print(f"run {r}: wall={wall:.3f}s rate={rate:.0f}x  "
                  f"main-thread accounted={acct:.3f}s "
                  f"unaccounted={wall - acct:.3f}s", flush=True)
            for k in STAGES:
                n = timers.calls.get(k, 0)
                v = tot.get(k, 0.0)
                print(f"    {k:13s} {v * 1e3:9.1f} ms  n={n:3d}  "
                      f"{v / max(n, 1) * 1e3:7.1f} ms/call", flush=True)
            runs.append({"wall": wall, "rate": rate,
                         "stages": {k: tot.get(k, 0.0) for k in STAGES}})
    finally:
        reader.close()
    return runs


if __name__ == "__main__":
    main()
