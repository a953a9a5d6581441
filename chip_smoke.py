"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, then end to end.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # build + check the kernels only

Phases:
  1. device and toolchain: the card's name and power limit, nvcc/triton,
     and the kernels built from ``softspoken_tpu_torch/csrc`` (build seconds)
  2. every kernel against its plain PyTorch version at the main path's
     shapes, with its stated tolerance, and its timing beside the bound
  3. end to end: ``detect`` on a 30-minute 32 kHz PCM16 WAV in fast mode
     (launch counts reset just before, read just after), then parity-mode
     checks: chunked == unchunked on the card, and card == CPU
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
# inputs: both round the same operands the same way, so only the summation
# order differs (~1e-6 relative on values below ~4); a bf16 output may then
# round one way or the other: one bf16 ulp below 4 is 2**-6.
TOL_F32 = 1e-4
TOL_BF16 = 2.0 ** -6


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
def phase_toolchain():
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
    _build.build("frame_mel")
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  [{name}] {line.strip()}")


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
    out_bytes = B * 128 * 256 * (2 if out_dtype == torch.bfloat16 else 4)
    n_bytes = buf_len * 4 + B * 4 + w.numel() * 4 * (2 if mode == "high" else 1) \
        + fbank.numel() * 4 + out_bytes
    dft = 2 * B * 256 * 512 * 1536 * (3 if mode == "high" else 1)
    mel = 2 * B * 256 * 768 * 128
    # the mel product is exact float32 in every mode, so its peak is the
    # non-tensor fp32 rate; in bf16 modes the DFT runs on the tensor cores,
    # a separate unit, so the two overlap and the larger time bounds
    if mode == "highest":
        t_ops = (dft + mel) / peaks["fp32"]
    else:
        t_ops = max(dft / peaks["bf16"], mel / peaks["fp32"])
    t_bytes = n_bytes / peaks["bytes"]
    # launches stays null unless the main path runs (phase 3)
    rec = {
        "name": "frame_mel", "route": "cuda",
        "source": "softspoken_tpu_torch/csrc/frame_mel.cu",
        "replaces": "softspoken_tpu/ops/pallas_frame_mel.py:204",
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }
    log(f"frame_mel timing (mode={mode}, out={str(out_dtype)[6:]}, B={B}): "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}; dft {1e3 * dft / peaks['bf16']:.4f} "
        f"at the bf16 tensor peak, mel {1e3 * mel / peaks['fp32']:.4f} at the fp32 peak, "
        f"all at the bf16 tensor peak {1e3 * (dft + mel) / peaks['bf16']:.4f})")
    for m in ("highest", "high"):
        log(f"frame_mel timing mode={m} out=float32: kernel_ms="
            f"{cuda_time_ms(lambda: fm.log_mel_windows_fused(buf, starts, m)):.4f}")
    del frames, buf
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


def phase_end_to_end(work: str) -> dict:
    from softspoken_tpu_torch import Config, cli
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine
    from softspoken_tpu_torch.engine.planner import num_windows_for_padded_length
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts

    sr, seconds = 32000, 1800.0
    wav = os.path.join(work, "field_30min_32k.wav")
    csv_path = os.path.join(work, "detections.csv")
    t0 = time.perf_counter()
    _field_wav(wav, seconds, sr, seed=11)
    log(f"wrote {seconds:.0f} s {sr} Hz PCM16 WAV in {time.perf_counter() - t0:.1f} s")

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
    os.remove(wav)
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
        g = ("frame_mel" if "frame_mel" in k else
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


def phase_parity(work: str) -> None:
    """Parity mode on the card: chunked == unchunked, card == CPU, and the
    fast path's distance from parity on the same file."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector

    wav = os.path.join(work, "field_60s_32k.wav")
    _field_wav(wav, 60.0, 32000, seed=5)
    sd = fixture_state_dict(0)
    par = Config().with_engine(precision="parity")

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
    os.remove(wav)


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
    phase_toolchain()
    rec = phase_frame_mel(peaks)
    if not args.kernels:
        launches = phase_end_to_end(work)
        rec["launches"] = launches.get("frame_mel", 0)
        phase_parity(work)
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [rec]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
