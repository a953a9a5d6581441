"""The kernel table of the PyTorch/CUDA port, on one CUDA card.

    python3 chip_smoke.py

Phases:
  1. device and toolchain: the card's name and power limit, nvcc/triton,
     and the kernels built from ``softspoken_tpu_torch/csrc``, one nvcc per
     source, all started together (build seconds); then the tensor-core
     instructions (HGMMA = wgmma, HMMA = mma.sync) and warp shuffles (SHFL)
     that ``cuobjdump -sass`` finds in each kernel instance of each library:
     an instance of K1 or K2 without tensor-core instructions, or of K3
     (a warp scan) without SHFL, fails the run
  2. every kernel against its plain PyTorch version at its path's shapes,
     with its stated tolerance, and its timing beside its bound: K1
     frame_mel (the fused path; all three modes, the bound from the
     benchmark's count, ``benchmarks/counts/k1.py``), K2 dft_mel (the host
     path, mel_kernel="pallas"; the same count's parts over its frames),
     K3 adpcm_decode (the adpcm4 wire) bit-equal on adversarial wires and
     tails ending inside a lane, with one block's device latency, dw_silu
     (the Conformer's depthwise convolution, bias and SiLU) within twice
     its bfloat16 rounding of the float64 function, and bn_train
     (training-mode BatchNorm's forward and backward, contiguous and
     channels-last) against its plain twin at the input of each of a
     B = 128 step's 36 BatchNorms, timed at the full-resolution shape each
     way in each layout beside the plain twin and cuDNN's ``F.batch_norm``,
     then all 36 of a step.  Each kernel's device time is
     read on the card (torch.profiler's CUDA events, and a CUDA graph of 10
     launches timed with events: ``device_time``) beside the time per call
     through its Python wrapper; ``ms`` in the JSON line is the device time.

Prints a JSON line of the five kernel records, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failure exits nonzero
before that line.  Imports nothing of JAX.

The port's other checks on the card are the ``cuda``-marked tests
(``pytest -m cuda``, the command in tests/test_torch_cuda.py); its speed
end to end is the benchmark's (``benchmarks/``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# published dense peaks (NVIDIA data sheets): bytes/s, fp32 non-tensor FLOP/s
# (the bounds of K3, dw_silu and bn_train; K1's and K2's are the benchmark's)
PEAKS = {
    "sxm": {"bytes": 3.35e12, "fp32": 67e12},
    "pcie": {"bytes": 2.0e12, "fp32": 51.2e12},
}
# frame_mel tolerances, kernel vs its plain version on the same card and
# inputs.  "default" and "high": both round the same operands the same way,
# so only the summation order differs (~1e-6 relative on values below ~4).
# "highest": the plain version is a float32 product, the kernel the six-pass
# bf16 split, which drops terms of weight 2^-24 (~5e-6 measured).  A bf16
# output may then round one way or the other: one bf16 ulp below 4 is 2**-6.
TOL_F32 = 1e-4
TOL_BF16 = 2.0 ** -6
# dft_mel (K2) against its plain version: float32 (TF32 off) against the
# six-pass split, as "highest" above
TOL_DFT_MEL = 1e-4
KERNELS = ("frame_mel", "dft_mel", "adpcm_decode", "dw_silu", "bn_train")
TENSOR_CORE_KERNELS = ("frame_mel", "dft_mel")  # K3 is integer work: none claimed
WARP_SCAN_KERNELS = ("adpcm_decode",)  # K3's design is a warp scan: SHFL in its SASS
# a substring of each kernel's name in the profiler's CUDA events
KERNEL_SYMBOLS = {"frame_mel": "WindowLoader", "dft_mel": "RowLoader",
                  "adpcm_decode": "adpcm_decode_kernel", "dw_silu": "dw_silu_kernel",
                  "bn_train": "bn_train_"}


def _k1_count():
    """``benchmarks/counts/k1.py``, the benchmark's count of K1's work (the
    function's: the 744 DFT bins the filterbank weighs), loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "_bench_counts_k1", os.path.join(HERE, "benchmarks", "counts", "k1.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def count_bound(K, flops: float, n_bytes: float) -> dict:
    """The least time of ``flops`` and ``n_bytes`` at the count's peaks
    (``K.PEAK_FLOPS``, ``K.PEAK_BYTES_PER_S``): the larger of the two."""
    t_ops, t_bytes = flops / K.PEAK_FLOPS, n_bytes / K.PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "flops": flops}


def bound_note(b: dict, ms: float) -> str:
    return (f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']}) = {100 * b['bound_ms'] / ms:.1f}% "
            f"of it; {b['flops'] / ms / 1e9:.2f} TFLOP/s of the function")


SASS_OPCODES = ("HGMMA", "HMMA", "SHFL")  # wgmma, mma.sync, warp shuffles


def sass_counts(lib: str) -> dict:
    """{kernel instance: {opcode: count}} of ``SASS_OPCODES`` in the SASS of
    a built library."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, timeout=300,
                       check=True)
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPCODES, 0)
        elif fn:
            op = next((o for o in SASS_OPCODES if o in line), None)
            if op:
                counts[fn][op] += 1
    return counts


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup=3, iters=10, reps=5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls
    (CUDA events): the time per call, which for a kernel of a few
    microseconds is the host's time to make the call (see device_time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return float(np.median(out))


def device_time(fn, symbol: str, launches: int = 20, per_graph: int = 10,
                reps: int = 20) -> dict:
    """The device time of one launch of the kernel whose name contains
    ``symbol``, read on the card two ways, neither of which waits on the
    host: ``profiler_ms``, the mean duration of its CUDA events over
    ``launches`` calls of ``fn`` under ``torch.profiler``; and ``graph_ms``,
    ``per_graph`` calls captured in one CUDA graph and replayed ``reps``
    times between CUDA events (the gaps between the graph's kernels
    included).  ``ms`` is the profiler's reading, else the graph's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and symbol in e.name]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    graph_ms = a.elapsed_time(b) / (reps * per_graph)
    del graph
    profiler_ms = 1e-3 * float(np.mean(us)) if us else None
    return {"ms": profiler_ms if profiler_ms else graph_ms, "profiler_ms": profiler_ms,
            "profiler_events": len(us), "graph_ms": graph_ms}


def kernel_device_ms(run, calls: int = 1) -> float:
    """The device time of every kernel one call of ``run`` launches: the
    sum of torch.profiler's CUDA events over ``calls`` calls, after two
    warm-up calls, divided by ``calls``.  For a call that launches several
    kernels, or whose host enqueue is as long as its kernels (CUDA events
    around it would time the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not us:
        raise RuntimeError("torch.profiler recorded no CUDA event")
    return 1e-3 * sum(us) / calls


def device_text(d: dict) -> str:
    p = "none" if d["profiler_ms"] is None else f"{d['profiler_ms']:.5f}"
    return (f"device_ms={d['ms']:.5f} (profiler {p} over {d['profiler_events']} kernel "
            f"events; CUDA graph {d['graph_ms']:.5f})")


# ---------------------------------------------------------------------------
def phase_toolchain() -> dict:
    """Builds the kernels; returns {kernel: {"tensor_core_instructions": n,
    "shfl_instructions": n}} from its library's SASS, having checked that
    every instance of K1 and K2 has tensor-core instructions and every
    instance of K3 warp shuffles."""
    from softspoken_tpu_torch.ops import _build

    log("nvcc:", shutil.which("nvcc") or
        ("/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "absent"))
    try:
        import triton  # noqa: F401
        log("triton:", triton.__version__)
    except ImportError:
        log("triton: absent")
    log("torch", torch.__version__, "cuda", torch.version.cuda)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as ex:  # one nvcc per source
        for f in [ex.submit(_build.build, name) for name in KERNELS]:
            f.result()
    log(f"kernels {', '.join(KERNELS)} built in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        lines = text.splitlines()
        # C7519 (a warpgroup.arrive the compiler adds before a wgmma whose A
        # operand comes from registers) is routine: counted, not printed
        log(f"  [{name}] ptxas C7519 notes: {sum('C7519' in ln for ln in lines)}")
        for line in lines:
            if "C7519" not in line and any(
                    k in line.lower() for k in ("used", "spill", "error", "warning", "c75")):
                log(f"  [{name}] {line.strip()[:200]}")
    totals = {}
    for name in KERNELS:
        per_fn = sass_counts(_build.lib_path(name))
        for fn, c in per_fn.items():
            log(f"  [{name}] sass {fn[:120]}: "
                + " ".join(f"{op}={c[op]}" for op in SASS_OPCODES))
        if not per_fn:
            raise AssertionError(f"{name}: no kernel in its library")
        if name in TENSOR_CORE_KERNELS and any(c["HGMMA"] + c["HMMA"] == 0
                                               for c in per_fn.values()):
            raise AssertionError(f"{name}: a kernel instance has no tensor-core instruction")
        if name in WARP_SCAN_KERNELS and any(c["SHFL"] == 0 for c in per_fn.values()):
            raise AssertionError(f"{name}: a kernel instance has no warp shuffle (SHFL): "
                                 "the warp scan is not in its SASS")
        totals[name] = {"tensor_core_instructions": sum(c["HGMMA"] + c["HMMA"]
                                                        for c in per_fn.values()),
                        "shfl_instructions": sum(c["SHFL"] for c in per_fn.values())}
    return totals


def phase_frame_mel() -> dict:
    """K1 against its plain version at the fused engine's shapes; its bound
    is the benchmark's count (``benchmarks/counts/k1.py``)."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.ops import frame_mel as fm

    dev = torch.device("cuda")
    det = Detector(Config(), state_dict=fixture_state_dict(0), device=dev)
    buf_len, B = det.chunk_buffer_len(), det.cfg.engine.device_batch
    assert buf_len == 3_439_800, buf_len
    rng = np.random.default_rng(7)
    buf = torch.from_numpy(rng.standard_normal(buf_len).astype(np.float32)).to(dev)
    # 128 starts spaced by the window step, with odd offsets mixed in, and
    # the last window flush with the buffer's end
    starts_np = (np.arange(B) * det.cfg.samples_per_step
                 + rng.integers(0, 2, B) * rng.integers(1, 129, B))
    starts_np = np.minimum(starts_np, buf_len - fm.WINDOW_SAMPLES)
    starts_np[-1] = buf_len - fm.WINDOW_SAMPLES
    starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)

    main = None
    for mode in ("highest", "high", "default"):
        for out_dtype in (torch.float32, torch.bfloat16):
            got = fm.log_mel_windows_fused(buf, starts, mode, out_dtype)
            torch.cuda.synchronize()
            ref = fm.log_mel_windows_fused_ref(buf, starts, mode, out_dtype)
            err = float((got.float() - ref.float()).abs().max())
            tol = TOL_BF16 if out_dtype == torch.bfloat16 else TOL_F32
            finite = bool(torch.isfinite(got.float()).all())
            log(f"frame_mel mode={mode} out={str(out_dtype)[6:]} shape={tuple(got.shape)} "
                f"max_abs_err={err:.3e} tol={tol:.3e} finite={finite}")
            if not finite or err > tol or got.shape != (B, 128, 256):
                raise AssertionError(f"frame_mel {mode}/{out_dtype} disagrees with its plain version")
            if mode == det.mel_mode and out_dtype == det.dtype:
                main = (mode, out_dtype, err)

    mode, out_dtype, err = main  # the fast main path's mode
    call_ms = cuda_time_ms(lambda: fm.log_mel_windows_fused(buf, starts, mode, out_dtype))
    dev_t = device_time(lambda: fm.log_mel_windows_fused(buf, starts, mode, out_dtype),
                        KERNEL_SYMBOLS["frame_mel"])
    ms = dev_t["ms"]
    plain_ms = cuda_time_ms(lambda: fm.log_mel_windows_fused_ref(buf, starts, mode, out_dtype),
                            iters=3)
    # yardstick: two cuBLAS products on pre-framed input, in the mode's type
    from softspoken_tpu_torch.ops import mel as melops

    w, fbank = (torch.from_numpy(t).to(dev) for t in fm.tables())
    lib_t = torch.float32 if mode == "highest" else torch.bfloat16
    frames = melops.gather_frames(buf, starts).reshape(-1, 512).to(lib_t)
    w_l, fb_l = w.to(lib_t), fbank.to(lib_t)

    def library():
        proj = frames @ w_l
        re, im = proj[:, :768], proj[:, 768:]
        return (re * re + im * im) @ fb_l

    library_ms = cuda_time_ms(library)
    K = _k1_count()

    def bound(dt: torch.dtype) -> dict:
        out_bytes = 2 if dt == torch.bfloat16 else 4
        return count_bound(K, K.flops(B), K.bytes_moved(B, out_bytes))

    b = bound(out_dtype)
    rec = {
        "name": "frame_mel", "route": "cuda",
        "source": "softspoken_tpu_torch/csrc/frame_mel.cu",
        "replaces": "softspoken_tpu/ops/pallas_frame_mel.py:204",
        "max_abs_err": err, "ms": ms, "call_ms": call_ms,
        "graph_ms": dev_t["graph_ms"], "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": library_ms, "tensor_cores": True,
    }
    log(f"frame_mel timing (mode={mode}, out={str(out_dtype)[6:]}, B={B}): "
        f"{device_text(dev_t)} call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} " + bound_note(b, ms))
    for m in ("highest", "high"):
        t = cuda_time_ms(lambda: fm.log_mel_windows_fused(buf, starts, m))
        d = device_time(lambda: fm.log_mel_windows_fused(buf, starts, m),
                        KERNEL_SYMBOLS["frame_mel"])
        log(f"frame_mel timing mode={m} out=float32: {device_text(d)} call_ms={t:.4f} "
            + bound_note(bound(torch.float32), d["ms"]))
    del frames, buf
    torch.cuda.empty_cache()
    return rec


def phase_dft_mel() -> dict:
    """K2 against its plain version on B=128 windows of frames gathered
    from a random chunk: the host path's shapes with mel_kernel="pallas".
    Its bound counts the function as ``benchmarks/counts/k1.py`` counts K1's:
    ``mel_flops_per_frame`` for each of its B x F frames, each float32 frame
    sample read once and each float32 output written once, at that count's
    peaks."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ops import dft_mel as dm
    from softspoken_tpu_torch.ops import mel as melops

    dev = torch.device("cuda")
    cfg = Config()
    B, F = cfg.engine.device_batch, 256
    buf_len = 3_439_800  # the default chunk buffer
    rng = np.random.default_rng(13)
    buf = torch.from_numpy(rng.standard_normal(buf_len).astype(np.float32)).to(dev)
    starts = torch.from_numpy((np.arange(B) * cfg.samples_per_step).astype(np.int32)).to(dev)
    frames = melops.gather_frames(buf, starts)
    got = dm.log_mel_from_frames_dft(frames)
    torch.cuda.synchronize()
    ref = dm.log_mel_from_frames_dft_ref(frames)
    err = float((got - ref).abs().max())
    finite = bool(torch.isfinite(got).all())
    log(f"dft_mel shape={tuple(got.shape)} max_abs_err={err:.3e} tol={TOL_DFT_MEL:.1e} "
        f"finite={finite}")
    if not finite or err > TOL_DFT_MEL or got.shape != (B, 128, F):
        raise AssertionError("dft_mel disagrees with its plain version")

    call_ms = cuda_time_ms(lambda: dm.log_mel_from_frames_dft(frames))
    dev_t = device_time(lambda: dm.log_mel_from_frames_dft(frames), KERNEL_SYMBOLS["dft_mel"])
    ms = dev_t["ms"]
    plain_ms = cuda_time_ms(lambda: dm.log_mel_from_frames_dft_ref(frames), iters=3)
    gather_ms = cuda_time_ms(lambda: melops.gather_frames(buf, starts))
    # yardstick: two cuBLAS float32 products (TF32 off) and the power step
    w, fbank = (torch.from_numpy(t).to(dev) for t in dm.tables())
    flat = frames.reshape(-1, 512)

    def library():
        with melops.fp32_matmul():
            proj = flat @ w
            re, im = proj[:, :dm.N_BINS], proj[:, dm.N_BINS:]
            return (re * re + im * im) @ fbank

    library_ms = cuda_time_ms(library)
    K = _k1_count()
    rows = B * F
    b = count_bound(K, rows * K.S.mel_flops_per_frame(),
                    4.0 * (frames.numel() + rows * K.S.N_MELS))
    rec = {
        "name": "dft_mel", "route": "cuda",
        "source": "softspoken_tpu_torch/csrc/dft_mel.cu",
        "replaces": "softspoken_tpu/ops/pallas_mel.py:59",
        "max_abs_err": err, "ms": ms, "call_ms": call_ms,
        "graph_ms": dev_t["graph_ms"], "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": library_ms, "tensor_cores": True,
    }
    log(f"dft_mel timing (float32 class, B={B}, F={F}): {device_text(dev_t)} "
        f"call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} " + bound_note(b, ms)
        + f"; gather_ms={gather_ms:.4f} (the frames, on the path before the kernel)")
    del frames, flat, buf, got, ref
    torch.cuda.empty_cache()
    return rec


def adversarial_adpcm_wire(nb: int, seed: int) -> np.ndarray:
    """Random ADPCM wire bytes with header step indices 0..255 (the decode
    clips them to 88), seeds at -32768 and 32767, and blocks of nibble 15 /
    nibble 7 runs that drive the predictor into both clips."""
    from softspoken_tpu_torch.ops import adpcm

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 256, nb * adpcm.BLOCK_BYTES).astype(np.uint8).reshape(nb, -1)
    w[0::4, 0:2] = [0x00, 0x80]
    w[1::4, 0:2] = [0xFF, 0x7F]
    w[0::4, adpcm.HDR_BYTES:] = 0xFF
    w[1::4, adpcm.HDR_BYTES:] = 0x77
    return w.reshape(-1)


def adpcm_bound(peaks, n: int) -> dict:
    """K3's least time: the bytes (each wire byte read once, each float
    written once) over the memory rate, or its integer work (~20 operations
    a step: lookup, three masked adds, two clips) at one operation per lane
    a cycle (half the float32 FMA peak); the bytes bound it."""
    from softspoken_tpu_torch.ops import adpcm

    n_bytes = adpcm.wire_bytes(n) + 4 * n
    t_bytes, t_ops = n_bytes / peaks["bytes"], 20 * n / (peaks["fp32"] / 2)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops_ms": 1e3 * t_ops}


def check_adpcm(label: str, wire: torch.Tensor, n: int, peaks, smi: str,
                time_it: bool = True) -> dict:
    """K3 on ``wire`` against its plain version (bit-equal, the only
    tolerance), then its time beside the bound and the plain version's."""
    from softspoken_tpu_torch.ops import adpcm

    got = adpcm.decode_device(wire, n)
    torch.cuda.synchronize()
    ref = adpcm.decode_device_ref(wire, n)
    err = float((got - ref).abs().max())
    equal = bool(torch.equal(got, ref))
    log(f"adpcm_decode {label}: n={n} blocks={wire.numel() // adpcm.BLOCK_BYTES} "
        f"bit-equal={equal} max_abs_err={err:.3e} tol=0 (bit-equal)")
    if not equal or got.shape != (n,):
        raise AssertionError(f"adpcm_decode {label} disagrees with its plain version")
    out = {"max_abs_err": err}
    if time_it:
        b = adpcm_bound(peaks, n)
        sym = KERNEL_SYMBOLS["adpcm_decode"]
        call_ms = cuda_time_ms(lambda: adpcm.decode_device(wire, n))
        dev_t = device_time(lambda: adpcm.decode_device(wire, n), sym)
        ms = dev_t["ms"]
        plain_ms = cuda_time_ms(lambda: adpcm.decode_device_ref(wire, n), warmup=1, iters=2,
                                reps=3)
        one = wire[: adpcm.BLOCK_BYTES]  # one block: one warp's two scans, the latency
        one_t = device_time(lambda: adpcm.decode_device(one, adpcm.SPB), sym)
        clk = sm_clock_mhz()
        log(f"adpcm_decode {label} timing: {device_text(dev_t)} = "
            f"{100 * b['bound_ms'] / ms:.1f}% of bound; call_ms={call_ms:.4f} (per call "
            f"through decode_device, host included) plain_ms={plain_ms:.4f} library_ms=none "
            f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']}: {b['bytes']} bytes; integer work "
            f"{b['ops_ms']:.4f}); one block (one warp) {device_text(one_t)} = "
            f"{one_t['ms'] * 1e-3 * clk * 1e6:.0f} cycles at {clk:.0f} MHz (max SM clock) "
            f"| {smi}")
        out.update(ms=ms, call_ms=call_ms, graph_ms=dev_t["graph_ms"], plain_ms=plain_ms,
                   bound_ms=b["bound_ms"], bound_by=b["bound_by"], one_block_ms=one_t["ms"])
    return out


def sm_clock_mhz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60, check=True)
    return float(r.stdout.strip().splitlines()[0])


def phase_adpcm(peaks, smi: str) -> dict:
    """K3 against its plain version on adversarial wires: one of a default
    chunk at the 16 kHz decimated wire (timed) and one with a short tail."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import FusedStreamingEngine
    from softspoken_tpu_torch.ops import adpcm

    det = Detector(Config(), state_dict=fixture_state_dict(0))
    n = FusedStreamingEngine(det, 16000, "adpcm4").in_len
    wire = torch.from_numpy(adversarial_adpcm_wire(adpcm.n_blocks(n), seed=3)).cuda()
    rec = check_adpcm("adversarial chunk", wire, n, peaks, smi)
    short = torch.from_numpy(adversarial_adpcm_wire(37, seed=4)).cuda()
    check_adpcm("adversarial short tail", short, 36 * adpcm.SPB + 5, peaks, smi, time_it=False)
    for tail in (1, 8, 9, 255):  # n ending one into a lane, on its end, one past, one short
        check_adpcm(f"adversarial tail 256k+{tail}", short, 36 * adpcm.SPB + tail, peaks, smi,
                    time_it=False)
    return {"name": "adpcm_decode", "route": "cuda",
            "source": "softspoken_tpu_torch/csrc/adpcm_decode.cu",
            "replaces": "softspoken_tpu/ops/adpcm.py:175 (lax.scan, never Pallas)",
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "call_ms": rec["call_ms"], "graph_ms": rec["graph_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None, "tensor_cores": False,
            "one_block_ms": rec["one_block_ms"]}


def phase_dw_silu(peaks, smi: str) -> dict:
    """The Conformer's depthwise kernel (``ops/dwconv.py``, ``csrc/dw_silu.cu``)
    against the float64 function of the same bfloat16 inputs, each output
    within twice its bfloat16 rounding (a tap read one step off misses by
    O(1)): at Conformer (L)'s shape in a B = 128 batch (64 steps, 512
    channels, 32 taps; timed, with its bound) and at two ragged ones (a
    partial block of channels, a shorter window, an odd kernel)."""
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
    from softspoken_tpu_torch.ops import dwconv

    def case(windows, T, C, K, seed):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn(windows * T, C, generator=g).to("cuda", torch.bfloat16)
        w = (torch.randn(K, C, generator=g) / K ** 0.5).to("cuda", torch.bfloat16)
        b = (0.5 * torch.randn(C, generator=g)).to("cuda", torch.bfloat16)
        before = KERNEL_LAUNCHES["dw_silu"]
        got = dwconv.depthwise_silu(x, w, b, T)
        torch.cuda.synchronize()
        if KERNEL_LAUNCHES["dw_silu"] != before + 1:
            raise AssertionError(f"dw_silu ({windows}x{T}, {C}, K={K}) did not launch its kernel")
        want = dwconv.depthwise_silu_plain(x.double().cpu(), w.double().cpu(),
                                           b.double().cpu(), T)
        err = (got.double().cpu() - want).abs()
        worst = float((err / (2.0 ** -7 * want.abs() + 1e-4)).max())
        rel = float((got.double().cpu() - want).norm() / want.norm())
        log(f"dw_silu ({windows}x{T}, {C}, K={K}): max_abs_err={float(err.max()):.3e} "
            f"rel_l2={rel:.3e} worst/tolerance={worst:.3f}")
        if not worst <= 1.0:
            raise AssertionError(f"dw_silu ({windows}x{T}, {C}, K={K}) disagrees with the "
                                 "function beyond twice its bfloat16 rounding")
        return x, w, b, float(err.max())

    case(5, 50, 80, 7, seed=2)
    case(3, 64, 500, 16, seed=3)
    windows, T, C, K = 128, 64, 512, 32
    x, w, b, max_err = case(windows, T, C, K, seed=1)
    rows = windows * T
    flop = rows * C * (2.0 * K + 1.0)
    n_bytes = 2 * (2 * rows * C + K * C + C)
    t_ops, t_bytes = flop / peaks["fp32"], n_bytes / peaks["bytes"]
    bound_ms = 1e3 * max(t_ops, t_bytes)
    call_ms = cuda_time_ms(lambda: dwconv.depthwise_silu(x, w, b, T))
    dev_t = device_time(lambda: dwconv.depthwise_silu(x, w, b, T), KERNEL_SYMBOLS["dw_silu"])
    plain_ms = cuda_time_ms(lambda: dwconv.depthwise_silu_plain(x, w, b, T), warmup=2,
                            iters=5, reps=3)
    ms = dev_t["ms"]
    log(f"dw_silu timing ({windows}x{T}, {C}, K={K}, bf16): {device_text(dev_t)} = "
        f"{100 * bound_ms / ms:.1f}% of bound; call_ms={call_ms:.4f}; "
        f"bound_ms={bound_ms:.4f} ({'operations' if t_ops >= t_bytes else 'bytes'}: "
        f"{flop / 1e6:.1f} MFLOP as float32 FMA, {n_bytes} bytes); plain (cuDNN grouped "
        f"conv + SiLU) {plain_ms:.4f} ms | {smi}")
    return {"name": "dw_silu", "route": "cuda", "source": "softspoken_tpu_torch/csrc/dw_silu.cu",
            "replaces": "none (the Conformer's, no JAX counterpart)",
            "max_abs_err": max_err, "ms": ms, "call_ms": call_ms, "graph_ms": dev_t["graph_ms"],
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": plain_ms, "tensor_cores": False}


def bn_train_shapes(batch: int = 128) -> list:
    """The input shape of each training-mode BatchNorm of the U-Net at
    ``batch`` rows, in the order a step runs them, read by forward
    pre-hooks from one forward of a single row on the CPU (the spatial
    sizes do not depend on the batch)."""
    from softspoken_tpu_torch.models.unet import N_MELS, BatchNorm1d, BatchNorm2d, SpecUNet2D

    model = SpecUNet2D().eval()
    shapes = []
    hooks = [m.register_forward_pre_hook(
                 lambda _m, args: shapes.append((batch,) + tuple(args[0].shape[1:])))
             for m in model.modules() if isinstance(m, (BatchNorm1d, BatchNorm2d))]
    with torch.no_grad():
        model(torch.zeros(1, N_MELS, 256))
    for h in hooks:
        h.remove()
    return shapes


def _bn_inputs(shape, seed: int) -> dict:
    """As the BatchNorm tests: a channel offset larger than the spread."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    C = shape[1]
    bshape = (1, C) + (1,) * (len(shape) - 2)
    return {"x": 0.5 * torch.randn(shape, generator=g, device="cuda")
            + 3.0 * torch.randn(C, generator=g, device="cuda").view(bshape),
            "w": 0.5 + torch.rand(C, generator=g, device="cuda"),
            "b": 0.1 * torch.randn(C, generator=g, device="cuda"),
            "rm": torch.zeros(C, device="cuda"), "rv": torch.ones(C, device="cuda"),
            "nbt": torch.zeros((), dtype=torch.int64, device="cuda"),
            "dy": torch.randn(shape, generator=g, device="cuda")}


def phase_bn_train(peaks, smi: str) -> dict:
    """Training-mode BatchNorm's kernel pair (``ops/batchnorm.py``,
    ``csrc/bn_train.cu``) at every shape a B = 128 training step gives it:
    the input of each of the step's 36 BatchNorms (``bn_train_shapes``),
    contiguous and, for the 33 two-D ones, channels-last as well (the
    float32 step's layout on the card); the output and the three gradients
    against the plain twin on the same inputs (within 1e-5 of each tensor's
    largest value; the precise check is tests/test_torch_batchnorm_cuda.py).
    Then at the full-resolution shape (128, 32, 128, 256), in each layout,
    each direction's device time (its three kernels summed, 20 calls)
    beside its bound (the forward reads x twice and writes y, the backward
    reads x and dy twice and writes dx: bytes / 3.35 TB/s), the plain
    twin's time and cuDNN's ``F.batch_norm`` alone (``library_ms``, a
    yardstick the port never calls; its backward is the plain twin's).
    Then the 36 BatchNorms, both directions: contiguous, as the float32
    step's layout (33 channels-last), and the plain twin.  Every device
    time is ``kernel_device_ms``: the 36's host enqueue is as long as their
    kernels' device time, so events around it would time the host."""
    import torch.nn.functional as F

    from softspoken_tpu_torch.models.unet import BN_EPS, BN_MOMENTUM
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
    from softspoken_tpu_torch.ops import batchnorm as bnops

    cl = torch.channels_last
    counters = ("bn_train_fwd", "bn_train_bwd", "bn_train_fwd_nhwc", "bn_train_bwd_nhwc")

    def both(fn, t):
        xr, wr, br = (t[k].detach().clone().requires_grad_() for k in ("x", "w", "b"))
        y = fn(xr, wr, br, t["rm"].clone(), t["rv"].clone(), t["nbt"].clone(), BN_EPS,
               BN_MOMENTUM)
        y.backward(t["dy"])
        return y.detach(), xr.grad, wr.grad, br.grad

    def channels_last(t):
        return dict(t, x=t["x"].contiguous(memory_format=cl),
                    dy=t["dy"].contiguous(memory_format=cl))

    shapes = bn_train_shapes()
    if len(shapes) != 36:
        raise AssertionError(f"the U-Net has {len(shapes)} BatchNorms, not 36")
    cases = [_bn_inputs(s, seed=i) for i, s in enumerate(shapes)]
    worst = {}
    for i, t in enumerate(cases):
        layouts = [("nchw", t)] + ([("nhwc", channels_last(t))] if len(shapes[i]) == 4 else [])
        for layout, tl in layouts:
            before = {k: KERNEL_LAUNCHES[k] for k in counters}
            got = both(bnops.batch_norm_train, tl)
            torch.cuda.synchronize()
            nhwc = layout == "nhwc"
            launched = {k: KERNEL_LAUNCHES[k] - before[k] for k in counters}
            if launched != {"bn_train_fwd": 1, "bn_train_bwd": 1, "bn_train_fwd_nhwc": int(nhwc),
                            "bn_train_bwd_nhwc": int(nhwc)}:
                raise AssertionError(f"bn_train ({layout}) did not launch its kernels once each "
                                     f"way at {shapes[i]}: {launched}")
            want = both(bnops.batch_norm_train_plain, tl)
            errs = {name: float((a - e).abs().max() / e.abs().max())
                    for name, a, e in zip(("y", "dx", "dw", "db"), got, want)}
            if not max(errs.values()) <= 1e-5:
                raise AssertionError(f"bn_train ({layout}) disagrees with its plain twin at "
                                     f"{shapes[i]}: {errs}")
            key = (layout, shapes[i])
            prev = worst.get(key, {})
            worst[key] = {k: max(v, prev.get(k, 0.0)) for k, v in errs.items()}
            del got, want
    for (layout, s), errs in worst.items():
        log(f"bn_train {layout} {s} vs plain twin, max error / max value: "
            + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    max_err = max(max(e.values()) for e in worst.values())

    shape = (128, 32, 128, 256)
    recs = {}
    for layout in ("nchw", "nhwc"):
        t = cases[shapes.index(shape)]
        if layout == "nhwc":
            t = channels_last(t)
        x, w, b, dy = t["x"].detach(), t["w"].detach(), t["b"].detach(), t["dy"]
        args = (t["rm"], t["rv"], t["nbt"], BN_EPS, BN_MOMENTUM)
        elem_bytes = 4 * x.numel()
        y, mean, rstd = bnops.forward_kernel(x, w, b, *args)
        fwd = lambda: bnops.forward_kernel(x, w, b, *args)  # noqa: E731
        bwd = lambda: bnops.backward_kernel(x, dy, w, mean, rstd)  # noqa: E731
        xr, wr, br = (v.clone().requires_grad_() for v in (x, w, b))
        yp = bnops.batch_norm_train_plain(xr, wr, br, *args)
        plain_f = lambda: bnops.batch_norm_train_plain(x, w, b, *args)  # noqa: E731
        plain_b = lambda: torch.autograd.grad(yp, (xr, wr, br), dy, retain_graph=True)  # noqa: E731
        lib_f = lambda: F.batch_norm(x, None, None, w, b, True, 0.0, BN_EPS)  # noqa: E731
        for name, fn, passes, plain, lib in (("forward", fwd, 3, plain_f, lib_f),
                                             ("backward", bwd, 5, plain_b, plain_b)):
            ms = kernel_device_ms(fn, calls=20)
            bound_ms = 1e3 * passes * elem_bytes / peaks["bytes"]
            call_ms = cuda_time_ms(fn)
            plain_ms = cuda_time_ms(plain, warmup=2, iters=10, reps=3)
            lib_ms = plain_ms if lib is plain else cuda_time_ms(lib, warmup=2, iters=10, reps=3)
            log(f"bn_train {layout} {name} {shape} fp32: device_ms={ms:.5f} (profiler, 20 calls) "
                f"= {100 * bound_ms / ms:.1f}% of bound ({passes} passes of "
                f"{elem_bytes / 1e6:.1f} MB: bound_ms={bound_ms:.4f}, "
                f"{passes * elem_bytes / ms / 1e9:.3f} TB/s); call_ms={call_ms:.4f}; "
                f"plain {plain_ms:.4f} ms; library (cuDNN F.batch_norm) {lib_ms:.4f} ms | {smi}")
            recs[name if layout == "nchw" else f"{name}_nhwc"] = {
                "ms": ms, "call_ms": call_ms, "bound_ms": bound_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms}
        del y, yp, xr, wr, br, t, x, dy

    def step_all(fn, layouts):
        def run():
            for c in layouts:
                xr, wr, br = (c[k].requires_grad_() for k in ("x", "w", "b"))
                y = fn(xr, wr, br, c["rm"], c["rv"], c["nbt"], BN_EPS, BN_MOMENTUM)
                torch.autograd.grad(y, (xr, wr, br), c["dy"])
        return run

    step_cases = [channels_last(c) if len(s) == 4 else c for c, s in zip(cases, shapes)]
    step_kernel = kernel_device_ms(step_all(bnops.batch_norm_train, cases))
    step_nhwc = kernel_device_ms(step_all(bnops.batch_norm_train, step_cases))
    step_plain = kernel_device_ms(step_all(bnops.batch_norm_train_plain, cases))
    n_elem = sum(c["x"].numel() for c in cases)
    step_bound = 1e3 * 8 * 4 * n_elem / peaks["bytes"]
    log(f"bn_train all 36 BatchNorms of a B=128 step, forward + backward: kernel "
        f"{step_kernel:.3f} ms contiguous, {step_nhwc:.3f} ms as the float32 step lays them "
        f"out (33 channels-last), plain twin {step_plain:.3f} ms, bound {step_bound:.3f} ms "
        f"(8 passes of {4 * n_elem / 1e9:.3f} GB; kernel at "
        f"{100 * step_bound / step_kernel:.1f}% / {100 * step_bound / step_nhwc:.1f}%) | {smi}")
    return {"name": "bn_train", "route": "cuda", "source": "softspoken_tpu_torch/csrc/bn_train.cu",
            "replaces": "none (Flax BatchNorm was left to XLA)",
            "max_abs_err": max_err, "ms": recs["forward"]["ms"] + recs["backward"]["ms"],
            **recs,
            "bound_ms": recs["forward"]["bound_ms"] + recs["backward"]["bound_ms"],
            "bound_by": "bytes", "plain_ms": recs["forward"]["plain_ms"] + recs["backward"]["plain_ms"],
            "library_ms": recs["forward"]["library_ms"] + recs["backward"]["library_ms"],
            "step_ms": step_kernel, "step_nhwc_ms": step_nhwc, "step_plain_ms": step_plain,
            "step_bound_ms": step_bound, "tensor_cores": False}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    import softspoken_tpu_torch  # noqa: F401 — fails outside a checkout

    smi = nvidia_smi_line()
    log("card:", smi, "| torch:", torch.cuda.get_device_name(0))
    peaks = PEAKS["pcie" if "PCIe" in smi else "sxm"]
    t0 = time.perf_counter()
    tc = phase_toolchain()
    recs = [phase_frame_mel(), phase_dft_mel(), phase_adpcm(peaks, smi),
            phase_dw_silu(peaks, smi), phase_bn_train(peaks, smi)]
    for rec in recs:
        rec.update(tc[rec["name"]])
        if rec["tensor_cores"] and not rec["tensor_core_instructions"]:
            raise AssertionError(f"{rec['name']} claims the tensor cores but its SASS shows none")
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": recs}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
