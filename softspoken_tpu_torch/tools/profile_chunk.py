"""Profile the fused chunk program: a markdown table of device time per
kernel name.  The port of ``scripts/profile_chunk.py``.

Traces ``--repeats`` chunk programs of ``FusedStreamingEngine`` on one
synthetic chunk (``synthetic_chunk_args``; the defaults follow the bench's
device-only operating point through the same BENCH_DEV_BATCH /
BENCH_DEV_CHUNK_SECONDS variables) with ``runtime.profiling.device_trace``
(``torch.profiler``), reads the Chrome trace it writes, sums the duration
of the card's events (kernels, copies, memsets) per name, and writes the
table.  Only device time goes in it; on the CPU (``--device cpu``) there
is no device event, and the table lists the profiler's CPU ops instead,
whose times nest.

    python -m softspoken_tpu_torch.tools.profile_chunk [--out PATH]
        [--repeats 4] [--batch N] [--chunk-seconds S] [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time

import torch

from ..ckpt import fixture_state_dict
from ..config import Config
from ..engine import Detector
from ..engine.fused import CARRY, get_fused_engine
from ..runtime.metrics import analytic_flops_per_window, device_peak_flops, mfu
from ..runtime.profiling import device_trace
from . import OUT_DIR, add_device_arg, resolve_out

DEFAULT_OUT = os.path.join(OUT_DIR, "PROFILE_torch.md")
# the Chrome trace categories of the card's own work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# a substring of each hand kernel's name → the kernel and its source
KERNEL_SOURCES = (
    ("WindowLoader", "K1 frame_mel: csrc/frame_mel.cu"),
    ("RowLoader", "K2 dft_mel: csrc/dft_mel.cu"),
    ("adpcm_decode_kernel", "K3 adpcm_decode: csrc/adpcm_decode.cu"),
)


def source_of(name: str) -> str:
    """The port's source of a device event: a hand kernel's file, else the
    library the name shows (cuDNN, cuBLAS/CUTLASS), else torch."""
    for sym, src in KERNEL_SOURCES:
        if sym in name:
            return src
    k = name.lower()
    if "memcpy" in k or "memset" in k:
        return "copy"
    if any(s in k for s in ("cudnn", "xmma", "implicit", "conv")):
        return "cuDNN conv"
    if any(s in k for s in ("gemm", "cutlass", "cublas")):
        return "GEMM"
    if "nchwtonhwc" in k or "nhwctonchw" in k:
        return "layout"
    return "torch"


def aggregate(trace_path: str, cats=DEVICE_CATS):
    """Per-name total duration (µs) and count of the trace's complete
    events whose category is in ``cats``."""
    with open(trace_path) as f:
        tr = json.load(f)
    agg = collections.Counter()
    cnt = collections.Counter()
    for e in tr.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") not in cats or not e.get("name"):
            continue
        agg[e["name"]] += float(e.get("dur", 0.0))
        cnt[e["name"]] += 1
    return agg, cnt


def table(agg, cnt, header_lines, limit: int = 30, source=source_of) -> str:
    """The markdown report: the header lines, then one row per name, the
    largest first, with ``source(name)`` in the last column."""
    total_us = sum(agg.values())
    lines = list(header_lines) + [
        "| device op | ms (all reps) | % | count | source |",
        "|---|---|---|---|---|",
    ]
    for n, v in agg.most_common(limit):
        lines.append(f"| `{n[:70]}` | {v / 1e3:.3f} | {100 * v / max(total_us, 1e-9):.1f}% "
                     f"| {cnt[n]} | {source(n)} |")
    return "\n".join(lines) + "\n"


def capture(batch: int, chunk_seconds: float, repeats: int, trace_dir: str, device=None):
    """Untraced wall of ``repeats`` chunk programs, then the same loop
    traced; returns (wall s, audio s, trace file, detector)."""
    cfg = Config().with_engine(device_batch=batch, chunk_seconds=chunk_seconds)
    det = Detector(cfg, state_dict=fixture_state_dict(seed=0), device=device)
    eng = get_fused_engine(det, 32000, "i16")
    args = eng.synthetic_chunk_args()
    cs = torch.zeros(CARRY, device=det.device)
    cc = torch.zeros(CARRY, device=det.device)
    eng._program(*args, cs, cc)
    eng._sync()  # warm: first-call costs
    print("warm done", flush=True)

    t0 = time.perf_counter()
    for _ in range(repeats):
        _, _, cs, cc = eng._program(*args, cs, cc)
    eng._sync()
    wall = time.perf_counter() - t0

    with device_trace(trace_dir, device=det.device) as d:
        for _ in range(repeats):
            _, _, cs, cc = eng._program(*args, cs, cc)
        eng._sync()
    audio_sec = repeats * eng.chunk_w * cfg.engine.step_seconds
    return wall, audio_sec, os.path.join(d, f"trace_{os.getpid()}.json"), det


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--batch", type=int,
                    default=int(os.environ.get("BENCH_DEV_BATCH", "128")))
    ap.add_argument("--chunk-seconds", type=float,
                    default=float(os.environ.get("BENCH_DEV_CHUNK_SECONDS", "600")))
    ap.add_argument("--trace-dir", default=os.path.join(tempfile.gettempdir(), "chunk_trace"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    args.out = resolve_out(args.out)

    wall, audio_sec, trace, det = capture(args.batch, args.chunk_seconds, args.repeats,
                                          args.trace_dir, args.device)
    on_card = det.device.type == "cuda"
    agg, cnt = aggregate(trace, DEVICE_CATS if on_card else ("cpu_op",))
    total_us = sum(agg.values())
    rate = audio_sec / wall
    mfu_text = (f"MFU {mfu(rate, peak_flops=device_peak_flops()):.1%}" if on_card
                else "MFU null (CPU)")
    what = "device op time" if on_card else "CPU op time (nested ops overlap)"
    header = [
        "# Fused chunk program — device op profile",
        "",
        f"Captured with `torch.profiler` over {args.repeats} chunk programs "
        f"(device_batch={args.batch}, chunk_seconds={args.chunk_seconds}, "
        f"32 kHz int16 input, fixture weights) on {det.device}"
        + (f" ({torch.cuda.get_device_name(det.device)})" if on_card else "") + ".",
        "",
        f"- un-traced wall for the same loop: **{wall:.3f} s** "
        f"→ {rate:,.0f} audio-sec/s, {mfu_text} "
        f"(analytic {analytic_flops_per_window() / 1e9:.2f} GFLOP/window)",
        f"- summed {what} in trace: {total_us / 1e3:.1f} ms "
        f"({total_us / 1e3 / args.repeats:.1f} ms/chunk)",
        "",
    ]
    out = table(agg, cnt, header, source=source_of if on_card else (lambda _n: "CPU op"))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out)
    print(out[:4000])
    print(f"wrote {args.out}")
    return {"wall": wall, "audio_sec": audio_sec, "rate": rate,
            "device_ms": total_us / 1e3 if on_card else None,
            "rows": {n: (agg[n] / 1e3, cnt[n]) for n in agg}}


if __name__ == "__main__":
    main()
