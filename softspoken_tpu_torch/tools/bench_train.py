"""Train-step throughput on the card: the port of ``scripts/bench_train.py``.

Measures the fused on-device training program
(``train/device_data.py::make_fused_train_step`` — synthesize → forward →
backward → update, ``n_inner`` steps per call) the way the bench measures
inference: clips/s, s/step, and an MFU using the usual 3× forward-FLOPs
approximation for forward + backward against the card's dense bf16 peak
(``runtime.metrics.device_peak_flops``; null on the CPU).  The batch
synthesis and the optimizer update are extra, unmodeled work, so the MFU
is conservative.

    python -m softspoken_tpu_torch.tools.bench_train [--outer 8] [--batch 32]
        [--n-inner 10] [--dtype float32|bfloat16] [--pool 96] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..engine.detector import resolve_device
from ..runtime.metrics import analytic_flops_per_window, device_peak_flops
from ..train import synth
from ..train.device_data import make_fused_train_step, make_synth_batch_fn
from ..train.loop import DTYPES, create_train_state
from . import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--outer", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-inner", type=int, default=10)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--pool", type=int, default=96,
                    help="clips per pool (small: upload, not realism)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    sp, nz = synth.make_pools(rng, args.pool, args.pool)
    t_pool = time.perf_counter() - t0
    speech_pool = torch.from_numpy(np.ascontiguousarray(sp)).to(dev)
    noise_pool = torch.from_numpy(np.ascontiguousarray(nz)).to(dev)

    state = create_train_state(0, 1e-3, compute_dtype=DTYPES[args.dtype], device=dev)
    synth_fn = make_synth_batch_fn(
        args.batch, ("add_reverb", "reduce_volume", "bandpass_filter"))
    step_fn = make_fused_train_step(synth_fn, n_inner=args.n_inner)

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    m = step_fn(state, speech_pool, noise_pool, gen)  # warm: first-call costs
    float(m["loss"])

    t0 = time.perf_counter()
    for _ in range(args.outer):
        m = step_fn(state, speech_pool, noise_pool, gen)
    loss = float(m["loss"])  # waits for the whole chain on the stream
    wall = time.perf_counter() - t0

    steps = args.outer * args.n_inner
    clips = steps * args.batch
    fwd = analytic_flops_per_window()      # per window == per training clip
    train_flops = 3.0 * fwd * clips        # forward + ~2x for the backward
    peak = device_peak_flops() if dev.type == "cuda" else None
    out = {
        "steps": steps, "batch": args.batch,
        "s_per_step": round(wall / steps, 4),
        "clips_per_s": round(clips / wall, 1),
        "train_mfu": None if peak is None else round(train_flops / wall / peak, 4),
        "audio_s_per_s": round(clips * 3.0 / wall, 1),
        "loss": round(loss, 4),
        "dtype": args.dtype,
        "pool_gen_s": round(t_pool, 1),
        "device": str(dev),
    }
    print(out, flush=True)
    return out


if __name__ == "__main__":
    main()
