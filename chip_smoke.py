"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, then end to end.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # build + check the kernels only

Phases:
  1. device and toolchain: the card's name and power limit, nvcc/triton,
     and the kernels built from ``softspoken_tpu_torch/csrc``, one nvcc per
     source, all started together (build seconds); then the tensor-core
     instructions (HGMMA = wgmma, HMMA = mma.sync) that ``cuobjdump -sass``
     finds in each kernel instance of each library: an instance without any
     fails the run
  2. every kernel against its plain PyTorch version at its path's shapes,
     with its stated tolerance, and its timing beside the bound (K1 in all
     three modes) with the achieved TFLOP/s: K1 frame_mel (fused path), K2
     dft_mel (host path, mel_kernel="pallas")
  3. the fused path: ``detect`` on a 30-minute 32 kHz PCM16 WAV in fast
     mode (launch counts reset just before, read just after), then
     parity-mode checks: chunked == unchunked on the card, and card == CPU
  4. the host path: ``detect`` on the same WAV with ``{"engine":
     {"pipeline": "host", "mel_kernel": "pallas"}}`` (counts reset just
     before each run, read just after), twice in memory, then --streaming
     with the device resampler; then parity-mode checks: card == CPU and
     streaming == in-memory
Prints a JSON line of kernel records, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure exits nonzero before
that line.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
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

# published dense peaks (NVIDIA data sheets): bytes/s, fp32 non-tensor FLOP/s,
# bf16 tensor-core FLOP/s
PEAKS = {
    "sxm": {"bytes": 3.35e12, "fp32": 67e12, "bf16": 989e12},
    "pcie": {"bytes": 2.0e12, "fp32": 51.2e12, "bf16": 756e12},
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
KERNELS = ("frame_mel", "dft_mel")
MEL_PASSES = 6  # the mel product is the six-pass bf16 split in every mode


def mel_chain_bound(peaks, rows: int, dft_passes: int, n_bytes: int) -> dict:
    """The least time the card could take for ``rows`` frames of the chain
    DFT (2·rows·512·1536 FLOP a pass) → power → mel (2·rows·768·128 a pass),
    by either of two routes, and the bytes' time:
      cuda_cores_mel: the DFT's ``dft_passes`` bf16 passes on the tensor cores
        (0 passes: the DFT as float32 FMA on the CUDA cores too) and the mel
        product as exact float32 FMA; the two units overlap
      tensor_cores: every product on the tensor cores, the float32 class as
        six bf16 passes
    ``bound_ms`` is the smaller route (no kernel may beat it), or the bytes."""
    dft, mel = 2 * rows * 512 * 1536, 2 * rows * 768 * 128
    if dft_passes:
        t_cc = max(dft * dft_passes / peaks["bf16"], mel / peaks["fp32"])
    else:
        t_cc = (dft + mel) / peaks["fp32"]
    t_tc = (dft * (dft_passes or 6) + mel * MEL_PASSES) / peaks["bf16"]
    t_ops, t_bytes = min(t_cc, t_tc), n_bytes / peaks["bytes"]
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "cuda_cores_mel_ms": 1e3 * t_cc, "tensor_cores_ms": 1e3 * t_tc,
            "bytes_ms": 1e3 * t_bytes, "flop": dft + mel,
            "issued_flop": dft * (dft_passes or 6) + mel * MEL_PASSES}


def bound_text(b: dict, ms: float) -> str:
    return (f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']}; all on the tensor cores "
            f"{b['tensor_cores_ms']:.4f}, mel as float32 FMA {b['cuda_cores_mel_ms']:.4f}, "
            f"bytes {b['bytes_ms']:.4f}) achieved {b['flop'] / ms / 1e9:.2f} TFLOP/s of the "
            f"function, {b['issued_flop'] / ms / 1e9:.2f} TFLOP/s of bf16 passes issued")


def tensor_core_counts(lib: str) -> dict:
    """{kernel instance: (HGMMA, HMMA) instruction counts} from the SASS of
    a built library."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, timeout=300,
                       check=True)
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = [0, 0]
        elif fn and "HGMMA" in line:
            counts[fn][0] += 1
        elif fn and "HMMA" in line:
            counts[fn][1] += 1
    return {k: tuple(v) for k, v in counts.items()}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup=3, iters=10, reps=5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` launches (CUDA events)."""
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


# ---------------------------------------------------------------------------
def phase_toolchain() -> dict:
    """Builds the kernels; returns {kernel: tensor-core instructions in its
    library}, having checked that every kernel instance has some."""
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
        per_fn = tensor_core_counts(_build.lib_path(name))
        for fn, (hgmma, hmma) in per_fn.items():
            log(f"  [{name}] sass {fn[:120]}: HGMMA={hgmma} HMMA={hmma}")
        if not per_fn or any(h + m == 0 for h, m in per_fn.values()):
            raise AssertionError(f"{name}: a kernel instance has no tensor-core instruction")
        totals[name] = sum(h + m for h, m in per_fn.values())
    return totals


def phase_frame_mel(peaks) -> dict:
    """K1 against its plain version at the fused engine's shapes."""
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
    ms = cuda_time_ms(lambda: fm.log_mel_windows_fused(buf, starts, mode, out_dtype))
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
    table_bytes = {m: fm._device_tables(dev, m).numel() * 2 for m in fm._MODE_PARTS}

    def bound(m: str, dt: torch.dtype) -> dict:
        n_bytes = (buf_len * 4 + B * 4 + table_bytes[m]
                   + B * 128 * 256 * (2 if dt == torch.bfloat16 else 4))
        return mel_chain_bound(peaks, B * 256, {"default": 1, "high": 3, "highest": 0}[m], n_bytes)

    b = bound(mode, out_dtype)
    # launches stays null unless the main path runs (phase 3)
    rec = {
        "name": "frame_mel", "route": "cuda",
        "source": "softspoken_tpu_torch/csrc/frame_mel.cu",
        "replaces": "softspoken_tpu/ops/pallas_frame_mel.py:204",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": library_ms, "tensor_cores": True,
    }
    log(f"frame_mel timing (mode={mode}, out={str(out_dtype)[6:]}, B={B}): "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        + bound_text(b, ms))
    for m in ("highest", "high"):
        t = cuda_time_ms(lambda: fm.log_mel_windows_fused(buf, starts, m))
        log(f"frame_mel timing mode={m} out=float32: kernel_ms={t:.4f} "
            + bound_text(bound(m, torch.float32), t))
    del frames, buf
    torch.cuda.empty_cache()
    return rec


def phase_dft_mel(peaks) -> dict:
    """K2 against its plain version on B=128 windows of frames gathered
    from a random chunk: the host path's shapes with mel_kernel="pallas"."""
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

    ms = cuda_time_ms(lambda: dm.log_mel_from_frames_dft(frames))
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
    rows = B * F
    flops_1024 = 2 * rows * 512 * 2048 + 2 * rows * 1024 * 128  # the TPU kernel's bins
    n_bytes = 4 * (frames.numel() + rows * 128) + 2 * dm._device_tables(dev).numel()
    b = mel_chain_bound(peaks, rows, 0, n_bytes)  # float32 class: FMA, or six bf16 passes
    rec = {
        "name": "dft_mel", "route": "cuda",
        "source": "softspoken_tpu_torch/csrc/dft_mel.cu",
        "replaces": "softspoken_tpu/ops/pallas_mel.py:59",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": library_ms, "tensor_cores": True,
    }
    log(f"dft_mel timing (float32 class, B={B}, F={F}): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} " + bound_text(b, ms)
        + f"; {flops_1024 / 1e9:.2f} GFLOP over the TPU kernel's 1024 bins would be "
        f"{1e3 * flops_1024 / peaks['fp32']:.4f} ms as float32 FMA; "
        f"gather_ms={gather_ms:.4f} (the frames, on the path before the kernel)")
    del frames, flat, buf, got, ref
    torch.cuda.empty_cache()
    return rec


def _field_wav(path: str, seconds: float, sr: int, seed: int) -> None:
    """Seeded noise floor with speech-band bursts (modulated 300-3000 Hz
    tones, 2.5 s every 20 s), written as PCM16 mono."""
    from softspoken_tpu_torch.io import wavio

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = (0.01 * rng.standard_normal(n)).astype(np.float32)
    t = np.arange(int(2.5 * sr)) / sr
    env = (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t)).astype(np.float32)
    for k, s0 in enumerate(range(5 * sr, n - len(t), 20 * sr)):
        f = 300 + (k * 371) % 2700
        x[s0: s0 + len(t)] += (0.3 * env * np.sin(2 * np.pi * f * t)).astype(np.float32)
    wavio.write(path, x, sr, subtype="PCM_16")


def _host_batches(det, wav: str) -> "tuple[int, int]":
    """(windows, batches) the host pipeline dispatches for ``wav``: whole
    chunks, and the ragged tail padded to whole batches (the planner's
    formulas)."""
    from softspoken_tpu_torch.engine.planner import num_windows_for_padded_length
    from softspoken_tpu_torch.io import internal_length

    cfg = det.cfg
    n_windows = num_windows_for_padded_length(
        internal_length(wav, cfg.dsp.sample_rate) + 2 * cfg.pad_samples, cfg)
    B, chunk_w = cfg.engine.device_batch, det.chunk_windows()
    full, tail = divmod(n_windows, chunk_w)
    return n_windows, full * (chunk_w // B) + -(-tail // B)


def phase_end_to_end(work: str, wav: str, sr: int, seconds: float) -> dict:
    """The fused path (slice 1): ``detect`` with the default config."""
    from softspoken_tpu_torch import Config, cli
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine
    from softspoken_tpu_torch.engine.planner import num_windows_for_padded_length
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts

    csv_path = os.path.join(work, "detections.csv")
    args = cli.build_parser().parse_args(
        ["detect", "--files", wav, "--out", csv_path, "--random-init", "--strict-reference"])
    reset_launch_counts()
    torch.cuda.synchronize()
    report = cli.cmd_detect(args)
    torch.cuda.synchronize()
    launches = dict(KERNEL_LAUNCHES)
    log("kernel launches on the main path:", json.dumps(launches))
    if report["files_done"] != 1 or report["errors"]:
        raise AssertionError(f"detect failed: {report['errors']}")
    cfg = Config()
    det = Detector(cfg, state_dict=fixture_state_dict(0))
    n_nat = int(seconds * sr) + 2 * int(cfg.engine.pad_seconds * sr)
    padded = -(-n_nat * 441 // 640)  # 32000 → 22050 Hz is up/down = 441/640
    n_windows = num_windows_for_padded_length(padded, cfg)
    chunk_w = det.chunk_windows()
    n_batches = -(-n_windows // chunk_w) * (chunk_w // cfg.engine.device_batch)
    log(f"windows={n_windows} batches={n_batches} frame_mel launches={launches.get('frame_mel', 0)}")
    if launches.get("frame_mel", 0) < n_batches:
        raise AssertionError("the main path did not run the frame_mel kernel on every batch")
    log(f"e2e audio_sec_per_wall_sec={report['audio_sec_per_wall_sec']:.2f} "
        f"wall_seconds={report['wall_seconds']:.3f}")
    log("stage_seconds:", json.dumps(report["stage_seconds"]))
    with open(csv_path) as f:
        rows = f.read().splitlines()
    log(f"detections rows={len(rows) - 1}; first: {rows[1] if len(rows) > 1 else None}")
    # the same run again, now that cuDNN and the kernels are warm
    warm = cli.cmd_detect(args)
    log(f"e2e warm audio_sec_per_wall_sec={warm['audio_sec_per_wall_sec']:.2f} "
        f"wall_seconds={warm['wall_seconds']:.3f}")
    log("warm stage_seconds:", json.dumps(warm["stage_seconds"]))
    engine = get_fused_engine(det, sr, "i16")
    rate = engine.device_only_rate(repeats=4)
    log(f"device_only_rate={rate:.2f} audio-s/wall-s")
    profile_chunks(engine)
    return launches


def profile_chunks(engine, repeats: int = 2) -> None:
    """Device time by kernel over ``repeats`` synthetic chunk programs."""
    from torch.profiler import ProfilerActivity, profile

    engine.device_only_rate(repeats=1)  # warm
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.device_only_rate(repeats=repeats)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops repeat their kernels' device time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    groups = {}
    for ms, _n, key in rows:
        k = key.lower()
        g = ("frame_mel" if ("mel_core_kernel" in k and "windowloader" in k) else
             "dft_mel" if ("mel_core_kernel" in k and "rowloader" in k) else
             "grid" if "indexfunc" in k else
             "layout" if ("nchwtonhwc" in k or "nhwctonchw" in k) else
             "conv" if ("conv" in k or "xmma" in k or "cudnn" in k or "implicit" in k) else
             "gemm" if ("gemm" in k or "cutlass" in k) else "other")
        groups[g] = groups.get(g, 0.0) + ms
    log(f"profile: {repeats + 1} chunk programs (one is the device_only warm-up), "
        f"kernel device_ms={total:.3f} (wall_ms={wall_ms:.3f} includes the profiler's cost) "
        f"by_group={json.dumps({k: round(v, 3) for k, v in groups.items()})}")
    for ms, n, key in rows[:15]:
        log(f"  {ms:10.3f} ms  x{n:<5d} {key[:110]}")


def phase_parity(wav: str) -> None:
    """Parity mode on the card through the fused path: chunked ==
    unchunked, card == CPU, and the fast path's distance from parity on the
    same file."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector

    sd = fixture_state_dict(0)
    par = Config().with_engine(precision="parity", pipeline="fused")

    def run(cfg, device=None):
        return Detector(cfg, state_dict=sd, device=device).detect_file_streaming(wav)

    whole = run(par)
    chunked = run(par.with_engine(chunk_seconds=12.0))
    d = float(np.abs(whole.avg_values - chunked.avg_values).max())
    log(f"parity chunked vs unchunked: windows {chunked.num_windows}/{whole.num_windows} "
        f"max_abs_diff={d:.3e} tol=1e-5 intervals_equal={chunked.intervals == whole.intervals}")
    # 1e-5: the same float32 program over other chunk boundaries; only the
    # carry's summation order differs
    if d > 1e-5 or chunked.intervals != whole.intervals or not np.isfinite(whole.avg_values).all():
        raise AssertionError("chunked parity run disagrees with the unchunked one")

    small = par.with_engine(device_batch=8, chunk_seconds=12.0)
    gpu, cpu = run(small), run(small, device="cpu")
    d = float(np.abs(gpu.avg_values - cpu.avg_values).max())
    log(f"parity card vs CPU: max_abs_diff={d:.3e} tol=1e-4 intervals_equal={gpu.intervals == cpu.intervals}")
    # 1e-4: float32 with TF32 off on both; cuDNN and the CPU sum convolutions
    # in other orders, which the U-Net amplifies to ~1e-5
    if d > 1e-4 or gpu.intervals != cpu.intervals:
        raise AssertionError("parity run on the card disagrees with the CPU")

    fast = run(Config())
    d = float(np.abs(fast.avg_values - whole.avg_values).max())
    log(f"fast vs parity on the card: max_abs_diff={d:.3e} "
        f"intervals fast={fast.intervals} parity={whole.intervals}")
    if not np.isfinite(fast.avg_values).all() or len(fast.avg_values) != len(whole.avg_values):
        raise AssertionError("fast-mode grid is not finite or has the wrong length")


def phase_host_path(work: str, wav: str) -> int:
    """The host path (slice 2) at full width: ``detect`` with the pipeline
    and kernel chosen in the --config JSON, in-memory decode (first and
    second run), then --streaming with the device resampler."""
    from softspoken_tpu_torch import Config, cli
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts

    engine = {"pipeline": "host", "mel_kernel": "pallas"}
    det = Detector(Config().with_engine(**engine), state_dict=fixture_state_dict(0))
    n_windows, n_batches = _host_batches(det, wav)
    del det

    def detect(name: str, eng: dict, *flags: str):
        conf = os.path.join(work, f"{name}.json")
        with open(conf, "w") as f:
            json.dump({"engine": eng}, f)
        args = cli.build_parser().parse_args(
            ["detect", "--files", wav, "--out", os.path.join(work, f"{name}.csv"),
             "--random-init", "--strict-reference", "--config", conf, *flags])
        reset_launch_counts()
        torch.cuda.synchronize()
        report = cli.cmd_detect(args)
        torch.cuda.synchronize()
        launches = dict(KERNEL_LAUNCHES)
        if report["files_done"] != 1 or report["errors"]:
            raise AssertionError(f"host detect {name} failed: {report['errors']}")
        log(f"host {name}: audio_sec_per_wall_sec={report['audio_sec_per_wall_sec']:.2f} "
            f"wall_seconds={report['wall_seconds']:.3f} launches={json.dumps(launches)} "
            f"windows={n_windows} batches={n_batches}")
        log(f"host {name} stage_seconds:", json.dumps(report["stage_seconds"]))
        if launches.get("dft_mel", 0) < n_batches:
            raise AssertionError(f"host {name} did not run the dft_mel kernel on every batch")
        return launches

    launches = detect("in_memory_first", engine)  # the path's counts for the record
    detect("in_memory_second", engine)
    detect("streaming_device_resampler", dict(engine, resample_backend="auto"), "--streaming")
    return launches.get("dft_mel", 0)


def phase_host_parity(wav: str) -> None:
    """Parity mode through the host path with K2 on the 60 s file: card ==
    CPU, and streaming (either resampler) == in-memory on the card."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector

    sd = fixture_state_dict(0)
    par = Config().with_engine(precision="parity", pipeline="host", mel_kernel="pallas",
                               device_batch=8, chunk_seconds=12.0)
    card = Detector(par, state_dict=sd).detect_file(wav)
    cpu = Detector(par, state_dict=sd, device="cpu").detect_file(wav)
    d = float(np.abs(card.avg_values - cpu.avg_values).max())
    log(f"host parity card vs CPU: windows {card.num_windows}/{cpu.num_windows} "
        f"max_abs_diff={d:.3e} tol=1e-4 intervals_equal={card.intervals == cpu.intervals}")
    # 1e-4: float32 with TF32 off on both; K2 and cuDNN sum in other orders
    # than the CPU, which the U-Net amplifies to ~1e-5
    if (d > 1e-4 or card.intervals != cpu.intervals or card.num_windows != cpu.num_windows
            or not np.isfinite(card.avg_values).all()):
        raise AssertionError("host parity run on the card disagrees with the CPU")
    for backend in ("host", "auto"):
        det = Detector(par.with_engine(resample_backend=backend), state_dict=sd)
        stream = det.detect_file_streaming(wav)
        d = float(np.abs(stream.avg_values - card.avg_values).max())
        log(f"host parity streaming ({det.resample_backend} resampler) vs in-memory: "
            f"max_abs_diff={d:.3e} tol=1e-5 intervals_equal={stream.intervals == card.intervals}")
        # 1e-5: the same program over audio resampled chunk by chunk (and on
        # the card by a float32 GEMM): float round-off in the samples
        if d > 1e-5 or stream.intervals != card.intervals:
            raise AssertionError("host streaming run disagrees with the in-memory one")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true", help="phases 1-2 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    import softspoken_tpu_torch  # noqa: F401 — fails outside a checkout

    smi = nvidia_smi_line()
    log("card:", smi, "| torch:", torch.cuda.get_device_name(0))
    peaks = PEAKS["pcie" if "PCIe" in smi else "sxm"]
    work = os.path.join(HERE, "build", "softspoken_tpu_torch", "smoke")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    tc = phase_toolchain()
    k1 = phase_frame_mel(peaks)
    k2 = phase_dft_mel(peaks)
    for rec in (k1, k2):
        rec["tensor_core_instructions"] = tc[rec["name"]]
        if rec["tensor_cores"] and not rec["tensor_core_instructions"]:
            raise AssertionError(f"{rec['name']} claims the tensor cores but its SASS shows none")
    if not args.kernels:
        sr, seconds = 32000, 1800.0
        wav = os.path.join(work, "field_30min_32k.wav")
        wav60 = os.path.join(work, "field_60s_32k.wav")
        t1 = time.perf_counter()
        _field_wav(wav, seconds, sr, seed=11)
        _field_wav(wav60, 60.0, sr, seed=5)
        log(f"wrote {seconds:.0f} s and 60 s {sr} Hz PCM16 WAVs in "
            f"{time.perf_counter() - t1:.1f} s")
        k1["launches"] = phase_end_to_end(work, wav, sr, seconds).get("frame_mel", 0)
        phase_parity(wav60)
        k2["launches"] = phase_host_path(work, wav)
        phase_host_parity(wav60)
        os.remove(wav)
        os.remove(wav60)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [k1, k2]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
