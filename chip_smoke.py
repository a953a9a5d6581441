"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, then end to end.

    python3 chip_smoke.py              # every phase; needs one CUDA card
    python3 chip_smoke.py --kernels    # build + check the kernels only
    python3 chip_smoke.py --mesh-only  # what needs several cards, over all of them
    python3 chip_smoke.py --tools-only # phases 1-2, then the maintainers' tools (14-16)

Phases:
  1. device and toolchain: the card's name and power limit, nvcc/triton,
     and the kernels built from ``softspoken_tpu_torch/csrc``, one nvcc per
     source, all started together (build seconds); then the tensor-core
     instructions (HGMMA = wgmma, HMMA = mma.sync) and warp shuffles (SHFL)
     that ``cuobjdump -sass`` finds in each kernel instance of each library:
     an instance of K1 or K2 without tensor-core instructions, or of K3
     (a warp scan) without SHFL, fails the run
  2. every kernel against its plain PyTorch version at its path's shapes,
     with its stated tolerance, and its timing beside the bound (K1 in all
     three modes) with the achieved TFLOP/s: K1 frame_mel (fused path), K2
     dft_mel (host path, mel_kernel="pallas"), K3 adpcm_decode (the adpcm4
     wire) bit-equal on adversarial wires and tails ending inside a lane,
     with one block's device latency, dw_silu (the Conformer's
     depthwise convolution, bias and SiLU) within twice its bfloat16
     rounding of the float64 function, and bn_train (training-mode
     BatchNorm's forward and backward) against its plain twin at the
     step's full-resolution shape, timed each way beside the plain twin
     and cuDNN's ``F.batch_norm``, then all 36 training-mode BatchNorms of
     a B = 128 step against the plain twin.  Each kernel's device time is
     read on the card (torch.profiler's CUDA events, and a CUDA graph of 10
     launches timed with events: ``device_time``) beside the time per call
     through its Python wrapper; ``ms`` in the JSON line is the device time
  3. the fused path: ``detect`` on a 30-minute 32 kHz PCM16 WAV in fast
     mode (launch counts reset just before, read just after), then
     parity-mode checks: chunked == unchunked on the card, and card == CPU
  4. the host path: ``detect`` on the same WAV with ``{"engine":
     {"pipeline": "host", "mel_kernel": "pallas"}}`` (counts reset just
     before each run, read just after), twice in memory, then --streaming
     with the device resampler; then parity-mode checks: card == CPU and
     streaming == in-memory
  5. training (slice 5): ``fit_synthetic`` on the card, pools of 128 + 128
     clips, B = 32, n_inner = 10, ["add_reverb", "reduce_volume"], one
     warm-up outer call and 5 timed (3 in bfloat16), with steps/s, clips/s,
     the first call's seconds, peak memory and the losses; one step card ==
     CPU (float32 pinned, dropout off); K1 and K2 launch counts 0 over all
     of that, bn_train's 36 forward and 36 backward launches a float32
     step and none a bfloat16 one; the checkpoint in ``Detector`` on the
     card on the 60 s WAV; a torch.profiler breakdown of one outer call
  6. slice 6, after the WAVs are written (native, before phase 3) and
     after training (the rest):
     native — both g++ libraries (csrc/ssdsp.cpp, csrc/ssflac.cpp, one g++
       each, started together; build seconds), then the 30-minute WAV's
       samples resampled natively and with scipy (times, largest
       difference); phase 4's in-memory runs must then decode through the
       native library (call counts), their rate and ``decode`` printed
       beside the scipy-bound numbers of PERF.md
     flac — one 120 s PCM16 signal as a WAV and as a mono 16-bit FLAC
       (tests/flac_ref.py): fused fast mode timed (audio-s/wall-s,
       host_fill, K1 launches, native FLAC reads) and parity mode, grids
       bit-equal; the host path with K2, grids within 1e-6; a 10 s stereo
       24-bit FLAC on the f32 wire bit-equal to the same samples as a float
       WAV
     containers — a 60 s AIFF and W64 (the writers of tests/test_aiff.py and
       tests/test_pcm_containers.py): fused grids bit-equal to the WAV's
     determinism — two fused fast runs on the 30-minute WAV, bit-equal;
       the grid update timed against the index_add_ pair it replaced
     trained — ``Detector()`` loads epoch 48750; 8 labeled 120 s fields
       (``synth_field_recording``, seeds 0-7) in fast and parity mode:
       frame and event F1; fails if fast's mean frame F1 is more than 0.01
       below parity's or either is under 0.80
  7. workflow (slice 7): the CLI in-process on a project of the 30-minute
     WAV, two labeled 120 s fields and a 10 s stereo 24-bit 48 kHz FLAC:
     ``project new``, ``detect`` (trained, fused, K1; a second run adds 0
     rows), ``review list/add/erase/export``, ``silence`` (also as
     ``python -m softspoken_tpu_torch``) and ``silence --fade-ms 20``; each
     output held sample for sample to its input and erase rows, streaming to
     in-memory, the labeled speech share silenced (floor 0.80), and the
     mute's device twin on (2, 57,600,000) float32 bit-equal (zero) and
     within 1e-6 (fade) to the numpy mute, timed; wall seconds per step
  8. eval (slice 8): (a) four conditions of scripts/quality_grid.py (v1
     clean, v2 clean, v1 mulaw, v2 reverb08; seeds 7000, 7000, 7007, 7014),
     8 x 120 s at 32 kHz each from ``make_eval_set`` (synthesized in four
     worker processes while the card detects), detected by the trained
     weights in fast mode with mel_precision "highest" through
     ``detect_file_streaming`` (fused, K1) and scored at the parity point,
     without and with the music filter at 0.85: frame and event F1 within
     0.01 and 0.03 of the JAX package's CPU result (``EVAL_REFERENCE``),
     with the taxonomy, regions dropped, synth and detect seconds and K1
     launches; docs/QUALITY_r05.json's TPU values printed beside them;
     (b) the CLI in process: ``eval --make-synthetic`` 8 x 120 s (frame F1
     >= 0.80, K1 launched), a v2 ``fading`` eval with ``--music-filter
     --exit-threshold 0.05 --grid-smooth 3``, and ``detect`` with the same
     flags writing its CSV; wall seconds of each.  Phase 1 also reports
     which codec libraries of the JAX package's MP3/Ogg/Opus readers load.
  9. wires (slice 9, after ``trained``): K3 bit-equal on the 30-minute WAV's
     first chunk at the 16 kHz wire (timed); the mu-law device decode within
     2 ulp of the same float32 formula on the CPU on all 256 codes, and no
     farther from the float64 ``decode_host`` than that formula is; detect on the 30-minute WAV (fixture weights)
     under pcm16, mulaw8 and adpcm4 with wire_decimate "auto" and "off",
     warm, each with audio-s/wall-s, host_fill, wire bytes and device ms
     per chunk with the decode's share, and K3's launches (one per adpcm4
     chunk; adpcm4 grids bit-equal run to run); the trained weights' frame
     and event F1 under each wire on the 8 labeled fields of ``trained``
     (mel "highest"): within 0.01 frame F1 of pcm16, and within 0.01 / 0.03
     of the JAX package's CPU result (``WIRE_REFERENCE``); the branches: a
     24-bit mono WAV under adpcm4 bit-equal to mulaw8 (the reference's
     wire), a 24-bit mono FLAC under adpcm4 bit-equal to its top 16 bits as
     a PCM16 WAV, a stereo FLOAT WAV under mulaw8 bit-equal to its int16
     downmix, and "auto" on the int16 engine.
 10. slice 10, after ``eval``: journal — the 30-minute WAV (12 chunks),
     trained, fused fast: warm audio-s/wall-s with no journal and a save
     every 1 and 4 chunks (grids bit-equal), killed after 5 chunks and
     resumed (7 programs, grid and intervals bit-equal, sidecar cleared,
     the resume's wall time), and a journal the CPU wrote discarded on the
     card; concurrency — eight 5-minute WAVs and eight copies of a 120 s
     FLAC through ``DetectRunner`` at file_concurrency 1, 2, 4, three
     turns (CSV byte-identical to K = 1's, aggregate rates); doctor — the
     port's report, ``device`` and ``kernels`` ok.
 11. slice 11, after ``doctor``: first detect — the 30-minute WAV, trained,
     fused, as the first detect of a fresh process (this script with
     ``--first-detect MODE WAV``), inline and through ``DetectRunner`` at
     K = 1, twice each, rate and ``dispatch``; bench — ``python -m
     softspoken_tpu_torch bench --seconds 1800`` with BENCH_REPEATS=3 and
     BENCH_TRACE: every key of the root bench.py's line plus ``device``,
     mfu = value x flops_per_audio_second() / the card's bf16 peak (1e-6),
     the i16 wire, device_only > 0, the trace naming K1's kernel and the
     ``annotate`` span, value >= 0.75 x phase 3's warm rate; then K1's
     launches over one timed repeat's detect and one ``device_only_rate``;
     gui — the Qt app under the port's shim on the card: a project of two
     5-minute WAVs, the detector screen (K1 counted; its CSV byte-identical
     to ``detect``'s), the review spectrogram saved, one row erased, the
     silence screen (erased samples 0, the rest the input's), and ``gui
     --smoke --screenshot`` as a subprocess.
 12. slice 12, after ``gui``: fit — ``python -m softspoken_tpu_torch train
     --speech-dir --noise-dir`` in process, with its default flags, on
     16 + 16 WAVs from ``train/synth.py`` (10 s at 22,050 Hz, a quarter at
     44.1 kHz, four 2 s noise files), 23 steps of the full SpecUNet_2D at
     B = 16 with five augmentations (change_speed and change_pitch among
     them): steps/s and clips/s after 3 warm steps (the card synchronized
     after steps 1, 3 and 23 only), first and last loss, peak memory,
     K1-K3 launches (0); the host split (reads + resample, augmentation,
     mel) and the train step's ms over 5 synchronized steps; every
     augmentation card == CPU three times over, with a hash of its clips
     and parameters, and ``build_batch`` card == CPU; the checkpoint in
     ``Detector`` on the 60 s WAV.  codecs — which MP3/Ogg/Opus libraries
     load; per loaded format a 120 s file from its encoder and a float WAV
     of its decoded samples, fused grids bit-equal, both rates; per absent
     one, probe/detect raising the reader's error, load_audio (None, None)
     and ``DetectRunner`` recording the file and finishing the next, as
     the JAX package does on such a host.
 13. slice 14 (several cards), after the host path's parity checks: mesh —
     a ``MeshDetector`` over [cuda:0, cuda:0] on the 30-minute WAV in parity
     precision, fused with K1 ("highest"), host with K2, and fused on the
     adpcm4 wire: grids within 1e-5 of one card's, intervals equal, K1 and
     K2 launched once per batch per data entry, K3 once per chunk on the
     detector's card (``launches_mesh``); ``detect --distributed
     --num-processes 1`` on a project and ``project merge-detections``;
     ``train --synthetic --mesh`` as a 1 x 1 NCCL group for two float32
     steps against ``train``, TF32 off in both (loss within 1e-3, the
     parameters' movement within 0.2 relative L2: Adam's first update is
     ±lr wherever a gradient is within rounding of 0), and two float64
     sharded steps in a 1 x 1
     NCCL group against two unsharded ones (every state tensor within 1e-6
     of its max).
     ``--mesh-only`` runs instead, over every visible card: phases 1-2 on
     cuda:0, then K1 (every mode), K2 and K3 on each card from a thread
     whose current device is cuda:0, against their plain versions; the mesh
     parity above over every card; ``detect`` and ``detect --mesh`` (fast,
     fixture weights): warm audio-s/wall-s and ``device_only_rate`` each,
     intervals equal; a journal kill after 5 of 12 chunks and resume under
     the mesh, bit-equal; two ``detect --distributed`` processes (cards 0
     and 1) and ``project merge-detections`` against one process, CSV
     byte-identical; (n/2, 2) training in n processes (``spawn``): two
     float64 sharded steps within 1e-6 of the unsharded ones, two float32
     ``fit_synthetic`` steps at B = 32 with TF32 off (the parameters'
     movement within 0.2 relative L2 of one card's), then ``fit_synthetic``
     at phase 5's point (B = 32, pools 128 + 128, n_inner = 10, 40 steps)
     beside one card's: steps/s, losses per outer call within 2%, the
     parameters' movement within 1.0 relative L2.
 14. slice 15, after ``eval``: tools — ``softspoken_tpu_torch.tools`` in
     process on the card: ``quality_grid --quick`` (8 cells, 2 files x 60 s,
     fused, K1 "highest") at the parity point and with the music filter,
     each F1 within 0.01 frame / 0.03 event of the JAX package's CPU grid
     (``QUICK_REFERENCE``); ``codec_gate --codec adpcm4`` at 2 files x 30 s
     (K3 and K1 launched); one run each of ``sweep_device`` (base, phase),
     ``profile_chunk`` (its table names K1), ``profile_e2e`` and
     ``bench_train`` (2 outer calls); K1-K3 launches and seconds per tool,
     the phase's seconds.  ``--tools-only`` runs phases 1-2, this, 15 and 16.
 15. slice 16, after ``tools``: finetune — ``tools.ft_boundary --quick`` on
     the card, its stages as subprocesses (train 4 steps at B = 2 from the
     committed .pth, the quick grid, the verdict JSON): stage seconds and
     the grid stage's K1 launches (> 0), read from the line the grid prints
     at exit; with pygame's clips on the machine, ``tools.real_audio_check
     --quick`` in process (K1 counted) held to the same run on the CPU (a
     subprocess running meanwhile): beds and mixes byte-equal,
     false_fraction per class within 0.01, F1 within 0.01 / 0.03; then
     ``tools.ft_music --quick`` (K1 in its grid and real-audio stages).
     Without the clips, one line names the runs not made.
 16. slice 17, after ``finetune``: round5 — ``tools.train_r05 --quick`` on
     the card (80 steps at B = 2 from scratch, seed 31337): its final line's
     steps and the .pth's epoch 80, recipe.json the JAX script's --quick
     recipe; run again it launches no trainer; in a third workdir holding
     the recipe and a ``save_pth`` checkpoint at epoch 50 it runs the
     trainer with ``--steps 30 --resume`` and ends at epoch 80;
     ``tools.probe_scratch_channels --quick`` (two arms of 8 steps, six
     conditions of 1 x 30 s scored, K1 from its exit line);
     ``tools.probe_agc_r05 --files 1 --seconds 30`` in process (8
     conditions x 2 arms, K1 counted), at its defaults and in parity (float32
     convolutions, fused with K1 "highest"), the parity run held to the same
     run on the CPU (a subprocess started first): ``_agc.wav`` bytes equal,
     F1 within 0.01 / 0.03 per condition and arm; the defaults' F1 printed
     beside the parity run's (bf16 moves it); the AGC's cumulative-sum
     form against the JAX script's ``np.convolve`` on one file (seconds,
     outputs equal); ``tools.retrain_gate_r05 --quick`` of the
     committed .pth: stage 1's K1 launches > 0; with the clips stage 2 and
     the verdict, without them an exit naming the clips and one line
     saying stage 2 and the verdict were not run.  Seconds of each part.
Prints a JSON line of kernel records (``launches_tools``: per tool of
phase 14; ``launches_finetune``: per tool and stage of phase 15;
``launches_round5``: per tool and stage of phase 16; K1's ``launches_eval``: its launches
over phase 8; ``launches_journal``: in phase 10's journaled run;
``launches_bench_repeat``, ``launches_bench_device_only`` and
``launches_gui``: phase 11's; ``launches_fit`` and ``launches_codecs``:
phase 12's, the latter per format, null for a format whose library does
not load), the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Any failure exits nonzero before
that line.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
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
KERNELS = ("frame_mel", "dft_mel", "adpcm_decode", "dw_silu", "bn_train")
MEL_KERNELS = ("frame_mel", "dft_mel")
TENSOR_CORE_KERNELS = ("frame_mel", "dft_mel")  # K3 is integer work: none claimed
WARP_SCAN_KERNELS = ("adpcm_decode",)  # K3's design is a warp scan: SHFL in its SASS
# a substring of each kernel's name in the profiler's CUDA events
KERNEL_SYMBOLS = {"frame_mel": "WindowLoader", "dft_mel": "RowLoader",
                  "adpcm_decode": "adpcm_decode_kernel", "dw_silu": "dw_silu_kernel",
                  "bn_train": "bn_train_"}
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


# the system libraries the JAX package's MP3, Ogg Vorbis and Opus readers bind
CODEC_LIBRARIES = ("libmpg123.so.0", "libmp3lame.so.0", "libogg.so.0", "libvorbis.so.0",
                   "libvorbisfile.so.3", "libvorbisenc.so.2", "libopus.so.0")


def codec_libraries() -> str:
    """Which of ``CODEC_LIBRARIES`` load with ctypes (a report, not a check)."""
    import ctypes

    out = []
    for name in CODEC_LIBRARIES:
        try:
            ctypes.CDLL(name)
            out.append(f"{name}=loads")
        except OSError:
            out.append(f"{name}=absent")
    return " ".join(out)


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
    log("codec libraries:", codec_libraries())
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
        "launches": None, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
        "graph_ms": dev_t["graph_ms"], "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": library_ms, "tensor_cores": True,
    }
    log(f"frame_mel timing (mode={mode}, out={str(out_dtype)[6:]}, B={B}): "
        f"{device_text(dev_t)} call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} " + bound_text(b, ms))
    for m in ("highest", "high"):
        t = cuda_time_ms(lambda: fm.log_mel_windows_fused(buf, starts, m))
        d = device_time(lambda: fm.log_mel_windows_fused(buf, starts, m),
                        KERNEL_SYMBOLS["frame_mel"])
        log(f"frame_mel timing mode={m} out=float32: {device_text(d)} call_ms={t:.4f} "
            + bound_text(bound(m, torch.float32), d["ms"]))
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
    rows = B * F
    flops_1024 = 2 * rows * 512 * 2048 + 2 * rows * 1024 * 128  # the TPU kernel's bins
    n_bytes = 4 * (frames.numel() + rows * 128) + 2 * dm._device_tables(dev).numel()
    b = mel_chain_bound(peaks, rows, 0, n_bytes)  # float32 class: FMA, or six bf16 passes
    rec = {
        "name": "dft_mel", "route": "cuda",
        "source": "softspoken_tpu_torch/csrc/dft_mel.cu",
        "replaces": "softspoken_tpu/ops/pallas_mel.py:59",
        "launches": None, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
        "graph_ms": dev_t["graph_ms"], "plain_ms": plain_ms,
        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
        "library_ms": library_ms, "tensor_cores": True,
    }
    log(f"dft_mel timing (float32 class, B={B}, F={F}): {device_text(dev_t)} "
        f"call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} " + bound_text(b, ms)
        + f"; {flops_1024 / 1e9:.2f} GFLOP over the TPU kernel's 1024 bins would be "
        f"{1e3 * flops_1024 / peaks['fp32']:.4f} ms as float32 FMA; "
        f"gather_ms={gather_ms:.4f} (the frames, on the path before the kernel)")
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
            "launches": None, "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
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
            "replaces": "none (the Conformer's, no JAX counterpart)", "launches": None,
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
    the output and the three gradients against the plain twin on the same
    inputs (within 1e-5 of each tensor's largest value; the precise check
    is tests/test_torch_batchnorm_cuda.py).  Then at the full-resolution
    shape (128, 32, 128, 256) each direction's device time (its three
    kernels summed, 20 calls) beside its bound (the forward reads x twice
    and writes y, the backward reads x and dy twice and writes dx: bytes /
    3.35 TB/s), the plain twin's time and cuDNN's ``F.batch_norm`` alone
    (``library_ms``, a yardstick the port never calls; its backward is the
    plain twin's).  Then the 36 BatchNorms, both directions, kernel against
    plain twin.  Every device time is ``kernel_device_ms``: the 36's host
    enqueue is as long as their kernels' device time, so events around it
    would time the host."""
    import torch.nn.functional as F

    from softspoken_tpu_torch.models.unet import BN_EPS, BN_MOMENTUM
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
    from softspoken_tpu_torch.ops import batchnorm as bnops

    def both(fn, t):
        xr, wr, br = (t[k].detach().clone().requires_grad_() for k in ("x", "w", "b"))
        y = fn(xr, wr, br, t["rm"].clone(), t["rv"].clone(), t["nbt"].clone(), BN_EPS,
               BN_MOMENTUM)
        y.backward(t["dy"])
        return y.detach(), xr.grad, wr.grad, br.grad

    shapes = bn_train_shapes()
    if len(shapes) != 36:
        raise AssertionError(f"the U-Net has {len(shapes)} BatchNorms, not 36")
    cases = [_bn_inputs(s, seed=i) for i, s in enumerate(shapes)]
    worst = {}
    for i, t in enumerate(cases):
        before = KERNEL_LAUNCHES["bn_train_fwd"], KERNEL_LAUNCHES["bn_train_bwd"]
        got = both(bnops.batch_norm_train, t)
        torch.cuda.synchronize()
        if (KERNEL_LAUNCHES["bn_train_fwd"], KERNEL_LAUNCHES["bn_train_bwd"]) != (
                before[0] + 1, before[1] + 1):
            raise AssertionError(f"bn_train did not launch its kernels once each way at "
                                 f"{shapes[i]}")
        want = both(bnops.batch_norm_train_plain, t)
        errs = {name: float((a - e).abs().max() / e.abs().max())
                for name, a, e in zip(("y", "dx", "dw", "db"), got, want)}
        if not max(errs.values()) <= 1e-5:
            raise AssertionError(f"bn_train disagrees with its plain twin at {shapes[i]}: "
                                 f"{errs}")
        prev = worst.get(shapes[i], {})
        worst[shapes[i]] = {k: max(v, prev.get(k, 0.0)) for k, v in errs.items()}
        del got, want
    for s, errs in worst.items():
        log(f"bn_train {s} vs plain twin, max error / max value: "
            + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    max_err = max(max(e.values()) for e in worst.values())

    shape = (128, 32, 128, 256)
    t = cases[shapes.index(shape)]
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
    recs = {}
    for name, fn, passes, plain, lib in (("forward", fwd, 3, plain_f, lib_f),
                                         ("backward", bwd, 5, plain_b, plain_b)):
        ms = kernel_device_ms(fn, calls=20)
        bound_ms = 1e3 * passes * elem_bytes / peaks["bytes"]
        call_ms = cuda_time_ms(fn)
        plain_ms = cuda_time_ms(plain, warmup=2, iters=10, reps=3)
        lib_ms = plain_ms if lib is plain else cuda_time_ms(lib, warmup=2, iters=10, reps=3)
        log(f"bn_train {name} {shape} fp32: device_ms={ms:.5f} (profiler, 20 calls) = "
            f"{100 * bound_ms / ms:.1f}% of bound ({passes} passes of "
            f"{elem_bytes / 1e6:.1f} MB: bound_ms={bound_ms:.4f}, "
            f"{passes * elem_bytes / ms / 1e9:.3f} TB/s); call_ms={call_ms:.4f}; "
            f"plain {plain_ms:.4f} ms; library (cuDNN F.batch_norm) {lib_ms:.4f} ms | {smi}")
        recs[name] = {"ms": ms, "call_ms": call_ms, "bound_ms": bound_ms,
                      "plain_ms": plain_ms, "library_ms": lib_ms}
    del y, yp, xr, wr, br, t, x, dy

    def step_all(fn):
        def run():
            for c in cases:
                xr, wr, br = (c[k].requires_grad_() for k in ("x", "w", "b"))
                y = fn(xr, wr, br, c["rm"], c["rv"], c["nbt"], BN_EPS, BN_MOMENTUM)
                torch.autograd.grad(y, (xr, wr, br), c["dy"])
        return run

    step_kernel = kernel_device_ms(step_all(bnops.batch_norm_train))
    step_plain = kernel_device_ms(step_all(bnops.batch_norm_train_plain))
    n_elem = sum(c["x"].numel() for c in cases)
    step_bound = 1e3 * 8 * 4 * n_elem / peaks["bytes"]
    log(f"bn_train all 36 BatchNorms of a B=128 step, forward + backward: kernel "
        f"{step_kernel:.3f} ms, plain twin {step_plain:.3f} ms, bound {step_bound:.3f} ms "
        f"(8 passes of {4 * n_elem / 1e9:.3f} GB; kernel at "
        f"{100 * step_bound / step_kernel:.1f}%) | {smi}")
    return {"name": "bn_train", "route": "cuda", "source": "softspoken_tpu_torch/csrc/bn_train.cu",
            "replaces": "none (Flax BatchNorm was left to XLA)", "launches": None,
            "max_abs_err": max_err, "ms": recs["forward"]["ms"] + recs["backward"]["ms"],
            "forward": recs["forward"], "backward": recs["backward"],
            "bound_ms": recs["forward"]["bound_ms"] + recs["backward"]["bound_ms"],
            "bound_by": "bytes", "plain_ms": recs["forward"]["plain_ms"] + recs["backward"]["plain_ms"],
            "library_ms": recs["forward"]["library_ms"] + recs["backward"]["library_ms"],
            "step_ms": step_kernel, "step_plain_ms": step_plain, "step_bound_ms": step_bound,
            "tensor_cores": False}


def _field_signal(seconds: float, sr: int, seed: int) -> np.ndarray:
    """Seeded noise floor with speech-band bursts (modulated 300-3000 Hz
    tones, 2.5 s every 20 s), float32 mono."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = (0.01 * rng.standard_normal(n)).astype(np.float32)
    t = np.arange(int(2.5 * sr)) / sr
    env = (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t)).astype(np.float32)
    for k, s0 in enumerate(range(5 * sr, n - len(t), 20 * sr)):
        f = 300 + (k * 371) % 2700
        x[s0: s0 + len(t)] += (0.3 * env * np.sin(2 * np.pi * f * t)).astype(np.float32)
    return x


def _field_wav(path: str, seconds: float, sr: int, seed: int) -> None:
    """``_field_signal`` written as PCM16 mono."""
    from softspoken_tpu_torch.io import wavio

    wavio.write(path, _field_signal(seconds, sr, seed), sr, subtype="PCM_16")


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
    return launches, profile_chunks(engine), warm["audio_sec_per_wall_sec"]


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
    return total


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
    from softspoken_tpu_torch.io import native
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
        native.reset_call_counts()
        torch.cuda.synchronize()
        report = cli.cmd_detect(args)
        torch.cuda.synchronize()
        launches, calls = dict(KERNEL_LAUNCHES), dict(native.NATIVE_CALLS)
        if report["files_done"] != 1 or report["errors"]:
            raise AssertionError(f"host detect {name} failed: {report['errors']}")
        log(f"host {name}: audio_sec_per_wall_sec={report['audio_sec_per_wall_sec']:.2f} "
            f"wall_seconds={report['wall_seconds']:.3f} launches={json.dumps(launches)} "
            f"native_calls={json.dumps(calls)} windows={n_windows} batches={n_batches}")
        log(f"host {name} stage_seconds:", json.dumps(report["stage_seconds"]))
        if launches.get("dft_mel", 0) < n_batches:
            raise AssertionError(f"host {name} did not run the dft_mel kernel on every batch")
        if "decode" in report["stage_seconds"]:
            log(f"host {name} with the native resampler: audio_sec_per_wall_sec="
                f"{report['audio_sec_per_wall_sec']:.2f} decode={report['stage_seconds']['decode']:.3f} s; "
                "with scipy's (PERF.md section 5, the second in-memory run on NVIDIA H100 "
                "80GB HBM3, 700.00 W): 451.99 and 3.506 s")
            if not calls.get("resample_f32") or not calls.get("pcm16_to_mono_f32"):
                raise AssertionError(f"host {name} did not decode through the native library")
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


TRAIN_AUGS = ("add_reverb", "reduce_volume")


def timed_fit(work: str, smi: str, dtype: str, timed_outer: int, seed: int = 0) -> dict:
    """``fit_synthetic`` on the card: pools of 128 + 128 clips, B = 32,
    n_inner = 10, one untimed outer call and ``timed_outer`` timed ones
    (each ends in its one metrics read, a synchronization)."""
    from softspoken_tpu_torch.ckpt import load_pth
    from softspoken_tpu_torch.train import fit_synthetic
    from softspoken_tpu_torch.train.loop import create_train_state

    path = os.path.join(work, f"train_{dtype}.pth")
    seen = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit_synthetic(steps=10 * (1 + timed_outer), batch_size=32, n_inner=10, pool_speech=128,
                  pool_noise=128, augmentations=TRAIN_AUGS, seed=seed, ckpt_out=path,
                  log_every_outer=1, save_every_outer=10 ** 6, train_dtype=dtype,
                  on_metrics=lambda step, m: seen.append(m), device="cuda")
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    first_s = seen[0]["wall_seconds"]
    timed_s = seen[-1]["wall_seconds"] - first_s
    steps_per_s = 10 * timed_outer / timed_s
    losses = [m["loss"] for m in seen]
    log(f"train {dtype}: first outer call {first_s:.3f} s; {timed_outer} timed outer calls "
        f"{timed_s:.3f} s → steps/s={steps_per_s:.3f} clips/s={32 * steps_per_s:.1f} "
        f"(B=32, n_inner=10); peak max_memory_allocated={peak / 2**30:.3f} GiB; "
        f"fit_synthetic wall {total_s:.3f} s with pool generation | {smi}")
    log(f"train {dtype} losses per outer call: " + ", ".join(f"{v:.5f}" for v in losses)
        + f" | {smi}")
    if not all(np.isfinite(v) for m in seen for v in m.values()):
        raise AssertionError(f"train {dtype}: a loss is not finite")
    sd, epoch = load_pth(path)
    init = create_train_state(seed=seed).model.state_dict()
    still = [k for k, v in sd.items() if "running" not in k and torch.equal(torch.as_tensor(v), init[k])]
    if epoch != 10 * (1 + timed_outer) or still:
        raise AssertionError(f"train {dtype}: epoch {epoch}, unchanged parameters {still[:5]}")
    return {"path": path, "steps_per_s": steps_per_s, "first_outer_s": first_s,
            "peak_bytes": peak, "losses": losses}


def train_step_card_vs_cpu(batch_size: int = 4, seed: int = 0, smi: str = "") -> dict:
    """One train step on the card and on the CPU from the same weights and
    the same batch (synthesized on the CPU from draws made there; the
    card's own synthesis of those draws is compared with it), float32
    pinned (TF32 off), dropout off, the mel in "highest" mode on both.

    The reference for the gradients is the CPU's float64 gradient: cuDNN's
    backward is not bit-deterministic (its weight gradients may sum with
    atomics) and sums in other orders than the CPU, and the U-Net amplifies
    float32 rounding in its gradients, so the card is held to be about as
    close to float64 as the CPU's float32 is: each gradient tensor's error
    (relative to its max |g|) within 4× the CPU's error on that tensor or
    within the CPU's worst error over all tensors (one tensor's error is
    itself noisy: at B = 2 the card was 7.4× the CPU on one tensor and
    still 2.5× inside the CPU's worst), and the whole gradient within 3×
    the CPU's relative L2 error.  Loss to 1e-5 relative; new BN running
    statistics to 1e-4 of each tensor's max; the synthesized mel to 1e-3
    (the float32 FFT and matmul libraries; see tests/test_torch_train_synth.py)."""
    from softspoken_tpu_torch.ops.mel import fp32_matmul
    from softspoken_tpu_torch.train import device_data as dd
    from softspoken_tpu_torch.train import synth
    from softspoken_tpu_torch.train.loop import create_train_state, loss_fn, train_step

    sp, nz = (torch.from_numpy(x) for x in synth.make_pools(np.random.default_rng(seed), 8, 8))
    fn = dd.make_synth_batch_fn(batch_size, TRAIN_AUGS, mel_mode="highest")
    draws = fn.draw(torch.Generator().manual_seed(seed), 8, 8)

    def to(d, dev):
        return {k: (to(v, dev) if isinstance(v, dict) else v.to(dev)) for k, v in d.items()}

    with fp32_matmul(), torch.no_grad():
        batch = fn.transform(sp, nz, draws)
        card_batch = fn.transform(sp.cuda(), nz.cuda(), to(draws, "cuda"))
    mel_err = float((card_batch["mel"].cpu() - batch["mel"]).abs().max())
    mask_flips = int((card_batch["mask"].cpu() != batch["mask"]).sum())

    def step(dev):
        state = create_train_state(seed, device=dev, dropout_p=0.0)
        with fp32_matmul():
            m = train_step(state, to(batch, dev))
        grads = {k: p.grad.cpu().double() for k, p in state.model.named_parameters()}
        sd = {k: v.cpu().double() for k, v in state.model.state_dict().items()}
        return float(m["loss"]), grads, sd

    loss_g, grads_g, sd_g = step("cuda")
    loss_c, grads_c, sd_c = step("cpu")
    model = create_train_state(seed, dropout_p=0.0).model.double().train()
    loss64, _ = loss_fn(model, {k: v.double() for k, v in batch.items()})
    loss64.backward()
    truth = {k: p.grad for k, p in model.named_parameters()}

    def err(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    per = [(err(grads_g[k], truth[k]), err(grads_c[k], truth[k]), k) for k in truth]
    cpu_worst = max(r[1] for r in per)
    bad = [r for r in per if r[0] > max(4 * r[1], cpu_worst)]
    l2 = {name: float(torch.sqrt(sum(((g[k] - truth[k]) ** 2).sum() for k in truth)
                                 / sum((truth[k] ** 2).sum() for k in truth)))
          for name, g in (("card", grads_g), ("cpu", grads_c))}
    stat_err = max(err(sd_g[k], sd_c[k]) for k in sd_g if "running" in k)
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    worst = max(per)
    log(f"train parity card vs CPU (B={batch_size}, float32 pinned, dropout off): loss "
        f"{loss_g:.7f} / {loss_c:.7f} (float64 {float(loss64.detach()):.7f}) rel_diff={loss_rel:.2e} tol=1e-5; "
        f"gradient vs float64, relative L2: card {l2['card']:.3e} CPU {l2['cpu']:.3e} (tol 3× CPU); "
        f"worst tensor {worst[2]} card {worst[0]:.2e} CPU {worst[1]:.2e}, CPU's worst "
        f"{cpu_worst:.2e}; tensors outside max(4× CPU, CPU's worst): {len(bad)}; "
        f"BN stats max rel diff {stat_err:.2e} tol=1e-4; "
        f"synthesized mel card vs CPU {mel_err:.2e} tol=1e-3, mask flips {mask_flips} | {smi}")
    if (loss_rel > 1e-5 or bad or l2["card"] > 3 * l2["cpu"] + 1e-7 or stat_err > 1e-4
            or mel_err > 1e-3):
        raise AssertionError(f"train step on the card disagrees with the CPU: {bad[:5]}")
    return {"loss_rel": loss_rel, "l2": l2, "stat_err": stat_err, "mel_err": mel_err}


def profile_train_outer(smi: str, seed: int = 0) -> None:
    """Device time by kernel over one outer call (10 steps, B = 32, float32)
    of the fused train step, after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    from softspoken_tpu_torch.train import device_data as dd
    from softspoken_tpu_torch.train import synth
    from softspoken_tpu_torch.train.loop import create_train_state

    sp, nz = (torch.from_numpy(x).cuda() for x in synth.make_pools(np.random.default_rng(seed), 32, 32))
    state = create_train_state(seed, device="cuda")
    step = dd.make_fused_train_step(dd.make_synth_batch_fn(32, TRAIN_AUGS), n_inner=10)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    float(step(state, sp, nz, gen)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step(state, sp, nz, gen)["loss"])
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
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
        g = ("batch_norm" if ("bn_fw" in k or "bn_bw" in k or "batch_norm" in k
                              or "welford" in k) else
             "layout" if ("nchwtonhwc" in k or "nhwctonchw" in k) else
             "fft" if "fft" in k else
             "conv" if ("fprop" in k or "dgrad" in k or "wgrad" in k or "conv" in k) else
             "gemm" if ("gemm" in k or "cutlass" in k or "nvjet" in k) else
             "optimizer" if ("foreach" in k or "adam" in k) else
             "memcpy" if "memcpy" in k else
             "elementwise" if "elementwise" in k else "other")
        groups[g] = groups.get(g, 0.0) + ms
    log(f"train profile: one outer call (10 steps, B=32, float32), kernel device_ms={total:.3f} "
        f"wall_ms={wall_ms:.3f} (profiler on) device busy {100 * total / wall_ms:.1f}% of wall; "
        f"by_group={json.dumps({k: round(v, 3) for k, v in groups.items()})} | {smi}")
    for ms, n, key in rows[:25]:
        log(f"  {ms:10.3f} ms  x{n:<5d} {key[:110]}")


def phase_train(work: str, wav: str, smi: str) -> None:
    """Slice 5: ``fit_synthetic`` on the card (float32 and bfloat16), one
    step card == CPU, and the launch counters of K1 and K2 over all three
    (the training path runs neither); then its checkpoint in ``Detector``
    on the card, and a profile of one outer call."""
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts

    reset_launch_counts()
    torch.cuda.synchronize()
    f32 = timed_fit(work, smi, "float32", timed_outer=5)
    timed_fit(work, smi, "bfloat16", timed_outer=3)
    train_step_card_vs_cpu(smi=smi)
    torch.cuda.synchronize()
    launches = dict(KERNEL_LAUNCHES)
    log("kernel launches over the training phase:", json.dumps(launches))
    if any(launches.get(k, 0) for k in MEL_KERNELS):
        raise AssertionError("the training path launched a mel kernel")
    # 60 float32 steps of fit_synthetic and the card's step of the parity
    # check, 36 training-mode BatchNorms each; the 40 bfloat16 steps none
    bn = launches.get("bn_train_fwd", 0), launches.get("bn_train_bwd", 0)
    if bn != (36 * 61, 36 * 61):
        raise AssertionError(f"bn_train launches over the training phase {bn}, "
                             f"not {36 * 61} each way")

    det = Detector(checkpoint_path=f32["path"])
    res = det.detect_file_streaming(wav)
    log(f"trained checkpoint (epoch {det.epoch}) in Detector on the card ({det.pipeline}): "
        f"windows={res.num_windows} intervals={len(res.intervals)} "
        f"finite={bool(np.isfinite(res.avg_values).all())}")
    if det.epoch != 60 or not np.isfinite(res.avg_values).all() or res.num_windows < 1:
        raise AssertionError("the trained checkpoint does not run in Detector")
    profile_train_outer(smi)


# ---------------------------------------------------------------------------
# slice 6: the native host DSP, the readers, a deterministic grid, and the
# trained weights on the card
def _tests_defs(fname: str, names) -> dict:
    """The top-level functions and constants ``names`` of ``tests/<fname>``,
    compiled on their own: the test modules import the JAX package, which
    this script must not."""
    import ast

    path = os.path.join(HERE, "tests", fname)
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    body = []
    for node in tree.body:
        targets = ([node.name] if isinstance(node, (ast.FunctionDef, ast.ClassDef)) else
                   [t.id for t in node.targets if isinstance(t, ast.Name)]
                   if isinstance(node, ast.Assign) else [])
        if any(t in names for t in targets):
            body.append(node)
    import struct
    import warnings

    ns = {"np": np, "struct": struct, "warnings": warnings}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    missing = [n for n in names if n not in ns]
    if missing:
        raise AssertionError(f"tests/{fname} has no {missing}")
    return ns


def _flac_ref():
    """tests/flac_ref.py, the numpy FLAC encoder (it imports only numpy)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    try:
        import flac_ref
    finally:
        sys.path.pop(0)
    return flac_ref


def phase_native(wav: str, smi: str) -> None:
    """Builds both g++ libraries (one g++ each, started together), then
    resamples the 30-minute WAV's samples natively and with scipy."""
    import scipy.signal

    from softspoken_tpu_torch.io import flac, native, read_mono
    from softspoken_tpu_torch.io.resample import design_taps
    from softspoken_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        libs = [f.result() for f in [ex.submit(_build.build_host, n) for n in ("ssdsp", "ssflac")]]
    log(f"native libraries built in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(os.path.basename(p) for p in libs))
    if not (native.native_available() and flac.flac_available()):
        raise AssertionError("the native libraries did not load")
    native.reset_call_counts()
    x, sr = read_mono(wav)
    up, down = 441, 640  # 32000 → 22050 Hz
    taps = design_taps(up, down)
    times = {}
    for name, fn in (("native", lambda: native.resample_f32(x, up, down, taps)),
                     ("scipy", lambda: scipy.signal.resample_poly(
                         x.astype(np.float64), up, down, window=taps).astype(np.float32))):
        best = []
        for _ in range(2):
            t = time.perf_counter()
            y = fn()
            best.append(time.perf_counter() - t)
        times[name] = (min(best), y)
    d = float(np.abs(times["native"][1] - times["scipy"][1]).max())
    calls = dict(native.NATIVE_CALLS)
    log(f"resample {len(x) / sr:.0f} s at {sr} Hz to 22050 Hz on the host ({native._threads()} "
        f"threads, {os.cpu_count()} cores): native {times['native'][0]:.3f} s, scipy "
        f"{times['scipy'][0]:.3f} s, max_abs_diff={d:.3e} tol=2e-6; native_calls="
        f"{json.dumps(calls)} | {smi}")
    if d > 2e-6 or calls.get("resample_f32", 0) < 2 or not calls.get("pcm16_to_mono_f32"):
        raise AssertionError("the native resampler was not used or disagrees with scipy")


def _timed_detect(det, path: str, journal_dir=None) -> tuple:
    """(result, wall seconds, stage timers, K1/K2 launches, native calls) of
    one ``detect_file_streaming``, the counts set to 0 just before."""
    from softspoken_tpu_torch.io import native
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
    from softspoken_tpu_torch.runtime.metrics import StageTimers

    timers = StageTimers()
    reset_launch_counts()
    native.reset_call_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = det.detect_file_streaming(path, journal_dir=journal_dir, timers=timers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, timers.summary(), dict(KERNEL_LAUNCHES), dict(native.NATIVE_CALLS)


def phase_flac(work: str, smi: str) -> None:
    """One PCM16 signal as a WAV and as a mono 16-bit FLAC (tests/flac_ref.py):
    fused detect in fast mode (timed) and in parity mode, bit-equal grids;
    the host path with K2, grids within 1e-6; then a stereo 24-bit FLAC on
    the f32 wire against the same samples as a float WAV."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.io import wavio

    flac_ref = _flac_ref()
    sr, seconds = 32000, 120.0
    x16 = np.clip(np.rint(_field_signal(seconds, sr, seed=17) * 32768), -32768, 32767
                  ).astype(np.int16)
    wp, fp = os.path.join(work, "flac_pair.wav"), os.path.join(work, "flac_pair.flac")
    wavio.write(wp, x16.astype(np.float32) / 32768.0, sr, subtype="PCM_16")
    t0 = time.perf_counter()
    flac_ref.write_flac(fp, x16, sr, bits=16)
    log(f"flac: encoded {seconds:.0f} s at {sr} Hz in {time.perf_counter() - t0:.1f} s "
        f"({os.path.getsize(fp) / os.path.getsize(wp):.3f} of the WAV's bytes)")

    det = Detector()  # the trained weights, fast mode, fused on the card
    _timed_detect(det, wp)  # warm
    runs = {}
    for path in (wp, fp, fp, wp):
        kind = "flac" if path == fp else "wav"
        res, wall, st, launches, calls = _timed_detect(det, path)
        runs.setdefault(kind, []).append(res)
        log(f"flac fused fast {kind}: audio_sec_per_wall_sec={seconds / wall:.2f} "
            f"wall_seconds={wall:.4f} host_fill={st.get('host_fill', 0.0):.4f} "
            f"launches={json.dumps(launches)} native_calls={json.dumps(calls)} | {smi}")
        if not launches.get("frame_mel"):
            raise AssertionError(f"fused detect on the {kind} did not launch frame_mel")
        if kind == "flac" and not calls.get("flac_read_i32"):
            raise AssertionError("the FLAC was not read by the native decoder")
    ref = runs["wav"][0].avg_values
    same = all(np.array_equal(r.avg_values, ref) for rs in runs.values() for r in rs)
    log(f"flac fused fast: four grids bit-equal={same} intervals={len(runs['wav'][0].intervals)}")
    if not same or runs["flac"][0].intervals != runs["wav"][0].intervals:
        raise AssertionError("fused fast-mode grid of the FLAC differs from the WAV's")

    par = Detector(Config().with_engine(precision="parity"))
    a, b = par.detect_file_streaming(fp), par.detect_file_streaming(wp)
    eq = np.array_equal(a.avg_values, b.avg_values)
    log(f"flac fused parity: grids bit-equal={eq} intervals_equal={a.intervals == b.intervals}")
    if not eq or a.intervals != b.intervals:
        raise AssertionError("fused parity grid of the FLAC differs from the WAV's")

    host = Detector(Config().with_engine(pipeline="host", mel_kernel="pallas"))
    res = {}
    for kind, path in (("wav", wp), ("flac", fp)):
        from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts

        reset_launch_counts()
        t0 = time.perf_counter()
        res[kind] = host.detect_file(path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"flac host K2 {kind}: audio_sec_per_wall_sec={seconds / wall:.2f} "
            f"launches={json.dumps(dict(KERNEL_LAUNCHES))} | {smi}")
        if not KERNEL_LAUNCHES.get("dft_mel"):
            raise AssertionError(f"host detect on the {kind} did not launch dft_mel")
    d = float(np.abs(res["flac"].avg_values - res["wav"].avg_values).max())
    log(f"flac host K2: max_abs_diff={d:.3e} tol=1e-6 "
        f"intervals_equal={res['flac'].intervals == res['wav'].intervals}")
    if d > 1e-6 or res["flac"].intervals != res["wav"].intervals:
        raise AssertionError("host grid of the FLAC differs from the WAV's")

    rng = np.random.default_rng(23)
    x24 = np.clip(np.rint(rng.normal(0, 0.2, (10 * 48000, 2)) * 2 ** 23),
                  -2 ** 23, 2 ** 23 - 1).astype(np.int64)
    fp24, wp24 = os.path.join(work, "s24.flac"), os.path.join(work, "s24.wav")
    flac_ref.write_flac(fp24, x24, 48000, bits=24)
    wavio.write(wp24, (x24 / 2.0 ** 23).astype(np.float32), 48000, subtype="FLOAT")
    a, b = det.detect_file_streaming(fp24), det.detect_file_streaming(wp24)
    eq = np.array_equal(a.avg_values, b.avg_values)
    log(f"flac stereo 24-bit 48 kHz (f32 wire) vs float WAV: grids bit-equal={eq}")
    if not eq:
        raise AssertionError("the stereo 24-bit FLAC differs from its float WAV")
    for p in (wp, fp, fp24, wp24):
        os.remove(p)


def phase_containers(work: str) -> None:
    """A 60 s mono PCM16 signal as AIFF and W64 (the writers of
    tests/test_aiff.py and tests/test_pcm_containers.py) and as a WAV:
    fused detect gives bit-equal grids."""
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.io import wavio

    aiff = _tests_defs("test_aiff.py", ["_ext80", "_chunk", "write_aiff"])
    w64 = _tests_defs("test_pcm_containers.py",
                      ["_W64_RIFF", "_W64_SUF", "_KS_PCM_SUF", "_w64_chunk", "write_w64"])
    sr = 32000
    x16 = np.clip(np.rint(_field_signal(60.0, sr, seed=29) * 32768), -32768, 32767
                  ).astype(np.int16)
    x = x16.astype(np.float32) / 32768.0
    paths = {k: os.path.join(work, f"c.{k}") for k in ("wav", "aiff", "w64")}
    wavio.write(paths["wav"], x, sr, subtype="PCM_16")
    aiff["write_aiff"](paths["aiff"], x16[:, None], sr)
    w64["write_w64"](paths["w64"], x[:, None], sr)
    det = Detector()
    ref = det.detect_file_streaming(paths["wav"])
    for k in ("aiff", "w64"):
        res, wall, _st, launches, _c = _timed_detect(det, paths[k])
        eq = np.array_equal(res.avg_values, ref.avg_values)
        log(f"containers {k}: grid bit-equal to the WAV's={eq} "
            f"audio_sec_per_wall_sec={60.0 / wall:.2f} launches={json.dumps(launches)}")
        if not eq or res.intervals != ref.intervals:
            raise AssertionError(f"fused detect on the {k} differs from the WAV")
    for p in paths.values():
        os.remove(p)


def phase_determinism(wav: str, chunk_device_ms: float, smi: str) -> None:
    """Fused detect twice in fast mode on the 30-minute WAV: bit-equal grids.
    The grid update alone, timed against the index_add_ pair it replaced."""
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine import regions as R
    from softspoken_tpu_torch.engine.fused import get_fused_engine

    det = Detector()
    a, b = det.detect_file_streaming(wav), det.detect_file_streaming(wav)
    eq = np.array_equal(a.avg_values, b.avg_values)
    log(f"determinism: two fused fast runs on the 30-min WAV, grids bit-equal={eq} "
        f"windows={a.num_windows} intervals={len(a.intervals)}")
    if not eq or a.intervals != b.intervals:
        raise AssertionError("two fused runs of one file gave different grids")
    eng = get_fused_engine(det, 32000, "i16")
    cw = eng.chunk_w
    bins = R.window_bin_offset(np.arange(cw), det.cfg.engine.step_seconds).astype(np.int64)
    dev = det.device
    place = eng._placement(bins, cw)
    if isinstance(place, torch.Tensor):
        place = place.to(dev)
    vals = torch.randn(cw, 256, device=dev)
    valid = torch.ones(cw, device=dev)
    idx = (torch.from_numpy(bins).to(dev)[:, None] + torch.arange(256, device=dev)).reshape(-1)

    def ordered():
        eng._accumulate(torch.stack([vals * valid[:, None],
                                     valid[:, None].expand(cw, 256)]), place)

    def index_add():
        s = torch.zeros(eng.glen, device=dev)
        s.index_add_(0, idx, (vals * valid[:, None]).reshape(-1))
        c = torch.zeros(eng.glen, device=dev)
        c.index_add_(0, idx, valid[:, None].expand(cw, 256).reshape(-1))

    t_new, t_old = cuda_time_ms(ordered), cuda_time_ms(index_add)
    log(f"grid update per chunk ({cw} windows): ordered blocks {t_new:.4f} ms, the "
        f"index_add_ pair it replaced {t_old:.4f} ms; chunk programs' device time in this "
        f"run's profile: {chunk_device_ms:.3f} ms for 3 (before this change, PERF.md "
        f"section 5: 105.980 ms) | {smi}")


def phase_trained(work: str, smi: str) -> None:
    """``Detector()`` runs the trained checkpoint (epoch 48750); 8 labeled
    120 s fields at 32 kHz, detected in fast and parity mode, scored with
    frame and event F1 against their labels."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.io import wavio
    from softspoken_tpu_torch.train.evaluate import event_metrics, frame_metrics
    from softspoken_tpu_torch.train.synth import synth_field_recording

    fast = Detector()
    if fast.epoch != 48750:
        raise AssertionError(f"Detector() loaded epoch {fast.epoch}, not the trained 48750")
    par = Detector(Config().with_engine(precision="parity"))
    sr, seconds = 32000, 120.0
    scores = {"fast": [], "parity": []}
    same, worst_diff = 0, 0.0
    t0 = time.perf_counter()
    for seed in range(8):
        audio, truth = synth_field_recording(np.random.default_rng(seed), seconds, sr=sr)
        path = os.path.join(work, f"field_{seed}.wav")
        wavio.write(path, audio, sr, subtype="PCM_16")
        res = {m: d.detect_file_streaming(path) for m, d in (("fast", fast), ("parity", par))}
        for m, r in res.items():
            scores[m].append((frame_metrics(r.intervals, truth, seconds)["f1"],
                              event_metrics(r.intervals, truth)["f1"]))
        same += res["fast"].intervals == res["parity"].intervals
        worst_diff = max(worst_diff, float(np.abs(res["fast"].avg_values
                                                  - res["parity"].avg_values).max()))
        os.remove(path)
    summary = {}
    for m, sc in scores.items():
        f = np.array(sc)
        summary[m] = (float(f[:, 0].mean()), float(f[:, 0].min()),
                      float(f[:, 1].mean()), float(f[:, 1].min()))
        log(f"trained {m}: frame F1 mean={summary[m][0]:.4f} worst={summary[m][1]:.4f}; "
            f"event F1 mean={summary[m][2]:.4f} worst={summary[m][3]:.4f}; per field "
            + " ".join(f"{a:.3f}/{b:.3f}" for a, b in sc) + f" | {smi}")
    gap = summary["parity"][0] - summary["fast"][0]
    log(f"trained fast vs parity: mean frame F1 gap={gap:.4f} (tol 0.01), fields with "
        f"identical intervals {same}/8, largest grid diff={worst_diff:.3e}; "
        f"{time.perf_counter() - t0:.1f} s for 8 fields")
    if gap > 0.01 or min(summary["fast"][0], summary["parity"][0]) < 0.80:
        raise AssertionError("the trained weights score below the gate on the card")


# ---------------------------------------------------------------------------
# slice 9: the lossy upload wires (mulaw8, adpcm4, wire decimation) and K3
# (tag, upload_codec, wire_decimate)
WIRES = (("pcm16", "pcm16", "auto"), ("mulaw8_auto", "mulaw8", "auto"),
         ("mulaw8_off", "mulaw8", "off"), ("adpcm4_auto", "adpcm4", "auto"),
         ("adpcm4_off", "adpcm4", "off"))
# The JAX package's own result on the trained phase's 8 labeled 120 s fields
# (seeds 0-7, 32 kHz PCM16): tests/jax_wire_reference.py on the CPU at commit
# d38cc7b, trained checkpoint, fast mode with mel_precision="highest", the
# fused pipeline under each wire.  (mean frame F1, mean event F1).
WIRE_REFERENCE = {
    "pcm16": (0.9665015136106887, 0.8320634920634921),
    "mulaw8_auto": (0.9644566508796881, 0.8358134920634921),
    "mulaw8_off": (0.9664369080430482, 0.8286019536019535),
    "adpcm4_auto": (0.9647802068251726, 0.822063492063492),
    "adpcm4_off": (0.9666731237269015, 0.8320634920634921),
}
WIRE_TOL_FRAME, WIRE_TOL_EVENT = 0.01, 0.03  # card vs the JAX CPU result, per wire
WIRE_TOL_PCM16 = 0.01  # a lossy wire's mean frame F1 vs pcm16's, on the card


def _engine_kinds(det) -> list:
    """(native_sr, wire kind) of every fused engine the detector built."""
    return sorted((k[0], k[1]) for k in det._engines)


def _decode_ms(eng) -> float:
    """Device time of the engine's wire decode alone on a chunk-sized wire."""
    from softspoken_tpu_torch.ops import adpcm, mulaw

    w = torch.zeros(eng._wire_len, dtype=eng._wire_dtype, device="cuda")
    if eng.kind == "adpcm4":
        return cuda_time_ms(lambda: adpcm.decode_device(w, eng.in_len))
    if eng.kind == "mulaw8":
        return cuda_time_ms(lambda: mulaw.decode_device(w))
    return cuda_time_ms(lambda: w.to(torch.float32) * (1.0 / 32768.0))


def phase_wires(work: str, wav: str, peaks, smi: str, k3: dict) -> None:
    """(1) K3 on the 30-minute WAV's first chunk at the 16 kHz wire; (2) the
    mu-law device decode on all 256 codes; (3) detect on the 30-minute WAV
    under each of ``WIRES`` (fixture weights), warm, adpcm4 twice; (4) the
    trained weights' F1 under each wire on 8 labeled fields; (5) the
    branches: a 24-bit WAV and FLAC under adpcm4, a stereo FLOAT WAV under
    mulaw8, and "auto"."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine
    from softspoken_tpu_torch.io import read_mono, wavio
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, adpcm, mulaw, reset_launch_counts
    from softspoken_tpu_torch.train.evaluate import event_metrics, frame_metrics
    from softspoken_tpu_torch.train.synth import synth_field_recording

    t_phase = time.perf_counter()
    # (2) the mu-law decode, all 256 codes: the card's against the same
    # float32 formula on the CPU (which tests/test_torch_wires.py holds to
    # 2 ulp of the JAX one), and against the float64 decode_host, from which
    # the float32 formula itself sits up to 6 ulp away (expm1 magnifies the
    # rounding of its argument by up to |x| = 5.5)
    q = np.arange(-128, 128, dtype=np.int8)
    got = mulaw.decode_device(torch.from_numpy(q).cuda()).cpu().numpy()
    cpu = mulaw.decode_device(torch.from_numpy(q)).numpy()
    want = mulaw.decode_host(q)

    def ulps(a, b):
        return int(np.max(np.abs(a.view(np.int32).astype(np.int64)
                                 - b.view(np.int32).astype(np.int64))))

    log(f"wires mulaw decode_device on the card, 256 codes: {ulps(got, cpu)} float32 ulp "
        f"from the formula on the CPU (tol 2); {ulps(got, want)} ulp from decode_host "
        f"(tol: the CPU formula's own {ulps(cpu, want)}), "
        f"max_abs_err={float(np.abs(got - want).max()):.3e}")
    if ulps(got, cpu) > 2 or ulps(got, want) > ulps(cpu, want):
        raise AssertionError("the mu-law device decode is off its reference")

    # (3) the 30-minute WAV under each wire, fixture weights, fast mode
    sd = fixture_state_dict(0)
    seconds = 1800.0
    grids, captured = {}, []
    orig_decode = adpcm.decode_device

    def spy(w, n):  # keeps the main path's first adpcm4 wire for (1)
        if not captured:
            captured.append((w.clone(), n))
        return orig_decode(w, n)

    for tag, codec, decim in WIRES:
        det = Detector(Config().with_engine(upload_codec=codec, wire_decimate=decim),
                       state_dict=sd)
        if tag == "adpcm4_auto":
            adpcm.decode_device = spy
        try:
            warm = det.detect_file_streaming(wav)  # warm-up (cuDNN, kernels, engine)
        finally:
            adpcm.decode_device = orig_decode
        res, wall, st, launches, calls = _timed_detect(det, wav)
        (sr_w, kind), = _engine_kinds(det)
        eng = get_fused_engine(det, sr_w, kind)
        n_chunks = -(-res.num_windows // eng.chunk_w)
        chunk_ms = 1e3 * eng.chunk_w * det.cfg.engine.step_seconds / eng.device_only_rate(4)
        dec_ms = _decode_ms(eng)
        wire_b = eng._wire_len * torch.empty(0, dtype=eng._wire_dtype).element_size()
        same = np.array_equal(warm.avg_values, res.avg_values)
        grids[tag] = res
        log(f"wires detect {tag} (30-min 32 kHz WAV, fixture weights): engine {kind} at "
            f"{sr_w} Hz, audio_sec_per_wall_sec={seconds / wall:.2f} wall_seconds={wall:.4f} "
            f"host_fill={st.get('host_fill', 0.0):.4f} wait_prepare="
            f"{st.get('wait_prepare', 0.0):.4f} wire_bytes_per_chunk={wire_b} "
            f"device_ms_per_chunk={chunk_ms:.3f} decode_ms={dec_ms:.4f} "
            f"({100 * dec_ms / chunk_ms:.2f}%) chunks={n_chunks} "
            f"launches={json.dumps(launches)} native_calls={json.dumps(calls)} "
            f"grid equal to the warm-up run={same} | {smi}")
        k3_launches = launches.get("adpcm_decode", 0)
        if not launches.get("frame_mel") or not np.isfinite(res.avg_values).all():
            raise AssertionError(f"wires {tag}: frame_mel not launched or a grid not finite")
        if k3_launches != (n_chunks if kind == "adpcm4" else 0):
            raise AssertionError(f"wires {tag}: adpcm_decode launched {k3_launches} times "
                                 f"for {n_chunks} chunks")
        if kind in ("mulaw8", "adpcm4") and decim == "auto" and not calls.get("fir_decim_i16"):
            raise AssertionError(f"wires {tag}: the native decimator did not run")
        if kind == "adpcm4":
            if not same:
                raise AssertionError(f"wires {tag}: two runs gave different grids")
            k3["launches"] = k3_launches
    ref = grids["pcm16"].avg_values
    log("wires detect: grid max_abs_diff from pcm16 " + ", ".join(
        f"{t} {float(np.abs(r.avg_values - ref).max()):.3e}" for t, r in grids.items()
        if t != "pcm16") + "; intervals equal to pcm16's " + ", ".join(
        f"{t} {r.intervals == grids['pcm16'].intervals}" for t, r in grids.items() if t != "pcm16"))

    # (1) K3 on the main path's first chunk (the adversarial wires ran in phase 2)
    wire, n = captured[0]
    rec = check_adpcm("30-min WAV's first chunk, 16 kHz wire", wire, n, peaks, smi)
    k3["ms_first_chunk"] = rec["ms"]
    k3["call_ms_first_chunk"] = rec["call_ms"]
    k3["max_abs_err"] = max(k3["max_abs_err"], rec["max_abs_err"])

    # (4) quality of the trained weights under each wire
    sr, fseconds = 32000, 120.0
    fields = []
    t0 = time.perf_counter()
    for seed in range(8):
        audio, truth = synth_field_recording(np.random.default_rng(seed), fseconds, sr=sr)
        path = os.path.join(work, f"wires_field_{seed}.wav")
        wavio.write(path, audio, sr, subtype="PCM_16")
        fields.append((path, truth))
    log(f"wires: 8 labeled 120 s fields synthesized in {time.perf_counter() - t0:.1f} s")
    means, misses = {}, []
    for tag, codec, decim in WIRES:
        det = Detector(Config().with_engine(mel_precision="highest", upload_codec=codec,
                                            wire_decimate=decim))
        if det.epoch != 48750:
            raise AssertionError(f"Detector() loaded epoch {det.epoch}, not the trained 48750")
        t0 = time.perf_counter()
        sc = []
        for path, truth in fields:
            r = det.detect_file_streaming(path)
            sc.append((frame_metrics(r.intervals, truth, fseconds)["f1"],
                       event_metrics(r.intervals, truth)["f1"]))
        f = np.array(sc)
        means[tag] = (float(f[:, 0].mean()), float(f[:, 1].mean()))
        rf, re_ = WIRE_REFERENCE[tag]
        df, de = means[tag][0] - rf, means[tag][1] - re_
        log(f"wires quality {tag}: frame F1 mean={means[tag][0]:.4f} (JAX CPU {rf:.4f}, diff "
            f"{df:+.4f}, tol {WIRE_TOL_FRAME}) event F1 mean={means[tag][1]:.4f} (JAX CPU "
            f"{re_:.4f}, diff {de:+.4f}, tol {WIRE_TOL_EVENT}); per field "
            + " ".join(f"{a:.3f}/{b:.3f}" for a, b in sc)
            + f"; {time.perf_counter() - t0:.2f} s | {smi}")
        if abs(df) > WIRE_TOL_FRAME or abs(de) > WIRE_TOL_EVENT:
            misses.append(f"{tag}: frame {df:+.4f}, event {de:+.4f} from the JAX CPU result")
    for tag in means:
        gap = means[tag][0] - means["pcm16"][0]
        log(f"wires quality {tag}: mean frame F1 {gap:+.4f} from pcm16 on the card "
            f"(tol {WIRE_TOL_PCM16})")
        if abs(gap) > WIRE_TOL_PCM16:
            misses.append(f"{tag}: frame {gap:+.4f} from pcm16")
    for path, _ in fields:
        os.remove(path)

    # (5) the branches, trained weights, fast mode
    det_a = Detector(Config().with_engine(upload_codec="adpcm4"))
    det_m = Detector(Config().with_engine(upload_codec="mulaw8"))
    x = _field_signal(60.0, sr, seed=31)
    p24 = os.path.join(work, "wires_24bit.wav")
    wavio.write(p24, x, sr, subtype="PCM_24")
    a, _w, _st, la, _c = _timed_detect(det_a, p24)
    b = det_m.detect_file_streaming(p24)
    eq = np.array_equal(a.avg_values, b.avg_values)
    log(f"wires branch 60 s 24-bit mono WAV under adpcm4: engines {_engine_kinds(det_a)}, "
        f"grid bit-equal to mulaw8's={eq} (the reference runs mulaw8 here), "
        f"launches={json.dumps(la)}")
    if not eq or la.get("adpcm_decode", 0) or _engine_kinds(det_a) != [(16000, "mulaw8")]:
        raise AssertionError("the 24-bit WAV under adpcm4 did not run the mulaw8 wire")

    flac_ref = _flac_ref()
    v24 = np.clip(np.rint(_field_signal(30.0, sr, seed=37) * 2 ** 23), -2 ** 23, 2 ** 23 - 1
                  ).astype(np.int64)
    f24, w16 = os.path.join(work, "wires_24bit.flac"), os.path.join(work, "wires_top16.wav")
    flac_ref.write_flac(f24, v24, sr, bits=24)
    wavio.write(w16, (v24 >> 8).astype(np.float32) / 32768.0, sr, subtype="PCM_16")
    det_a = Detector(Config().with_engine(upload_codec="adpcm4"))
    a, _w, _st, la, _c = _timed_detect(det_a, f24)
    b = det_a.detect_file_streaming(w16)
    eq = np.array_equal(a.avg_values, b.avg_values)
    log(f"wires branch 30 s 24-bit mono FLAC under adpcm4 (top 16 bits): engines "
        f"{_engine_kinds(det_a)}, grid bit-equal to the top-16-bit PCM16 WAV's={eq}, "
        f"launches={json.dumps(la)}")
    if not eq or not la.get("adpcm_decode") or _engine_kinds(det_a) != [(16000, "adpcm4")]:
        raise AssertionError("the 24-bit FLAC under adpcm4 did not ride the adpcm4 wire")

    xs = np.stack([_field_signal(30.0, 48000, seed=41), _field_signal(30.0, 48000, seed=43)], 1)
    pf, pm = os.path.join(work, "wires_stereo.wav"), os.path.join(work, "wires_mono16.wav")
    wavio.write(pf, xs, 48000, subtype="FLOAT")
    mono = read_mono(pf)[0]
    i16 = np.clip(np.rint(mono * np.float32(32768.0)), -32768, 32767).astype(np.int16)
    wavio.write(pm, i16.astype(np.float32) / 32768.0, 48000, subtype="PCM_16")
    det_m = Detector(Config().with_engine(upload_codec="mulaw8"))
    a, _w, _st, la, _c = _timed_detect(det_m, pf)
    b = det_m.detect_file_streaming(pm)
    eq = np.array_equal(a.avg_values, b.avg_values)
    log(f"wires branch 30 s stereo FLOAT 48 kHz WAV under mulaw8: engines "
        f"{_engine_kinds(det_m)}, grid bit-equal to its int16 downmix as a PCM16 WAV={eq}, "
        f"launches={json.dumps(la)}")
    if not eq or _engine_kinds(det_m) != [(16000, "mulaw8")]:
        raise AssertionError("the stereo FLOAT WAV under mulaw8 did not ride the mulaw8 wire")

    det = Detector()
    det.detect_file_streaming(pm)
    log(f"wires branch upload_codec=\"auto\": engines {_engine_kinds(det)}")
    if _engine_kinds(det) != [(48000, "i16")]:
        raise AssertionError("upload_codec=\"auto\" did not run the exact int16 wire")
    for p in (p24, f24, w16, pf, pm):
        os.remove(p)
    log(f"wires phase: {time.perf_counter() - t_phase:.1f} s | {smi}")
    if misses:
        raise AssertionError("wires quality off its gates: " + "; ".join(misses))


# ---------------------------------------------------------------------------
# slice 7: the review-and-silence workflow through the CLI, ending in silenced WAVs
def _cli(argv, label: str, times: dict) -> tuple:
    """``softspoken_tpu_torch.cli.main(argv)`` in-process: (exit code, stdout),
    the wall seconds into ``times[label]``."""
    import contextlib
    import io

    from softspoken_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    times[label] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}:\n{buf.getvalue()[-2000:]}")
    return rc, buf.getvalue()


def _json_tail(out: str) -> dict:
    return json.loads(out[out.index("{"):])


def _wav_chunks(path: str) -> dict:
    """A RIFF/WAVE file's chunks by id."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AssertionError(f"{path} is not a RIFF/WAVE file")
    out, pos = {}, 12
    while pos + 8 <= len(data):
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        out[data[pos:pos + 4]] = data[pos + 8:pos + 8 + size]
        pos += 8 + size + (size & 1)
    return out


def _erase_mask(n: int, sr: int, intervals) -> np.ndarray:
    """Samples inside ``[rint(st*sr), rint(et*sr))`` of any interval, clamped
    (the reference's loop, silencer_ui.py:974-985)."""
    mask = np.zeros(n, bool)
    for st, et in intervals:
        a = min(max(int(np.rint(st * sr)), 0), n)
        b = min(max(int(np.rint(et * sr)), 0), n)
        mask[a:b] = True
    return mask


def _silence_rates(runner, table, durations: dict) -> dict:
    """Runs ``runner`` on ``table``; audio-s/wall-s per input file."""
    marks = {}
    runner.run(table, on_file_start=lambda f: marks.setdefault(f, time.perf_counter()),
               on_file_done=lambda o: marks.setdefault(o, time.perf_counter()))
    rates, outs = {}, iter(sorted((t, k) for k, t in marks.items()))
    for (t0, src), (t1, _out) in zip(outs, outs):
        rates[os.path.basename(src)] = durations[src] / (t1 - t0)
    return rates


def phase_workflow(work: str, wav: str, smi: str) -> None:
    """The review-and-silence workflow through the port's CLI, in-process, on a
    project of the 30-minute WAV, two labeled 120 s fields and a 10 s stereo
    24-bit 48 kHz FLAC: ``project new`` → ``detect`` (on the card, the
    trained weights, fused, K1) twice → ``review list/add/erase/export`` →
    ``silence`` (hard zero; also as a ``python -m softspoken_tpu_torch``
    subprocess) and ``silence --fade-ms 20``.  Every silenced file is held
    sample for sample to its input and its erase rows; the streaming path to
    the in-memory one; the device twin of the mute to the numpy mute."""
    from softspoken_tpu_torch.io import probe, read_any, wavio
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
    from softspoken_tpu_torch.ops.mute import apply_mute, apply_mute_device
    from softspoken_tpu_torch.project import read_csv
    from softspoken_tpu_torch.project.table import to_number
    from softspoken_tpu_torch.silence import SilenceRunner
    from softspoken_tpu_torch.train.synth import synth_field_recording

    wf = os.path.join(work, "workflow")
    shutil.rmtree(wf, ignore_errors=True)
    os.makedirs(wf)
    t_files = time.perf_counter()
    labeled = {}
    for seed in (100, 101):
        audio, truth = synth_field_recording(np.random.default_rng(seed), 120.0, sr=32000)
        path = os.path.join(wf, f"labeled_{seed}.wav")
        wavio.write(path, audio, 32000, subtype="PCM_16")
        labeled[path] = truth
    mono, _truth = synth_field_recording(np.random.default_rng(102), 10.0, sr=48000)
    x24 = np.clip(np.rint(np.stack([mono, -0.5 * mono], 1) * 2 ** 23),
                  -2 ** 23, 2 ** 23 - 1).astype(np.int64)
    fp = os.path.join(wf, "stereo24.flac")
    _flac_ref().write_flac(fp, x24, 48000, bits=24)
    files = [wav, *labeled, fp]
    durations = {f: probe(f).duration for f in files}
    log(f"workflow: wrote 2 labeled 120 s WAVs and a 10 s stereo 24-bit 48 kHz FLAC in "
        f"{time.perf_counter() - t_files:.1f} s")

    times: dict = {}
    base = ["--project-dir", os.path.join(wf, "projects")]
    _cli(base + ["project", "new", "field7", *files], "project new", times)
    reset_launch_counts()
    torch.cuda.synchronize()
    report = _json_tail(_cli(base + ["detect", "--project", "field7"], "detect", times)[1])
    launches = dict(KERNEL_LAUNCHES)
    if report["files_done"] != 4 or report["errors"] or not report["device"].startswith("cuda"):
        raise AssertionError(f"workflow detect: {report}")
    if not launches.get("frame_mel"):
        raise AssertionError("workflow detect did not launch frame_mel")
    again = _json_tail(_cli(base + ["detect", "--project", "field7"], "detect again", times)[1])
    if again["rows_added"] != 0 or again["files_skipped"] != 4:
        raise AssertionError(f"a second detect added rows: {again}")
    out = _cli(base + ["review", "list"], "review list", times)[1]
    n = json.loads(out.strip().splitlines()[-1])["total"]
    _cli(base + ["review", "add", "--file", fp, "--start", "2.0", "--end", "3.5"],
         "review add", times)
    _cli(base + ["review", "erase", "--rows", *map(str, range(n + 1))], "review erase", times)
    _cli(base + ["review", "export"], "review export", times)
    proj_dir = os.path.join(wf, "projects")
    exports = [os.path.join(proj_dir, "Audacity Outputs", "field7"),
               os.path.join(proj_dir, "Kaleidoscope Outputs", "field7", "field7.csv"),
               os.path.join(proj_dir, "Raven Outputs", "field7", "field7.txt")]
    if not all(os.path.exists(p) for p in exports) or not os.listdir(exports[0]):
        raise AssertionError("review export did not write the three exports")
    dir_a, dir_b = os.path.join(wf, "silenced"), os.path.join(wf, "silenced_fade")
    sil = _json_tail(_cli(base + ["silence", "--output-dir", dir_a], "silence", times)[1])
    _cli(base + ["silence", "--fade-ms", "20", "--output-dir", dir_b], "silence fade", times)
    dir_sub = os.path.join(wf, "silenced_subprocess")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "softspoken_tpu_torch", *base, "silence",
                        "--output-dir", dir_sub], cwd=HERE, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, PYTHONPATH=HERE))
    times["silence (python -m)"] = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"python -m softspoken_tpu_torch silence: {r.stderr[-2000:]}")
    log(f"workflow detect: {n} reviewable rows of {report['rows_added']}, "
        f"{report['audio_sec_per_wall_sec']:.2f} audio-s/wall-s, launches={json.dumps(launches)}")
    log("workflow CLI wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f" | {smi}")

    # every file with an erase row has an output, every other file none
    table = read_csv(os.path.join(proj_dir, "Softspoken Outputs", "field7", "field7_review.csv"))
    erase = {}
    for row in table.rows:
        if to_number(row["erase"]) == 1:
            full = os.path.join(row["file_path"], row["file_name"])
            erase.setdefault(full, []).append((float(row["start_time"]),
                                               float(row["end_time"])))
    outputs = {f: os.path.join(dir_a, os.path.splitext(os.path.basename(f))[0]
                               + "_silenced.wav") for f in files}
    if sorted(sil["outputs"]) != sorted(outputs[f] for f in erase) or sil["errors"]:
        raise AssertionError(f"silence outputs {sil['outputs']} for erased {sorted(erase)}")
    for f in files:
        if (f in erase) != os.path.exists(outputs[f]):
            raise AssertionError(f"{f}: output present={os.path.exists(outputs[f])}, "
                                 f"erase rows={len(erase.get(f, []))}")
    if fp not in erase:
        raise AssertionError("the FLAC has no erase row")

    for f in erase:
        x, sr = read_any(f, always_2d=True)
        n_fr, ch = x.shape
        name = os.path.basename(outputs[f])
        inf = wavio.info(outputs[f])
        if (inf.frames, inf.channels, inf.samplerate, inf.subtype) != (n_fr, ch, sr, "PCM_16"):
            raise AssertionError(f"{name}: {inf} against ({n_fr}, {ch}, {sr})")
        mask = _erase_mask(n_fr, sr, erase[f])
        want = np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)
        want[mask] = 0
        got = wavio.read_raw(outputs[f])[0].view("<i2").reshape(n_fr, ch)
        zeros_ok = bool(np.all(got[mask] == 0))
        rest_ok = bool(np.array_equal(got[~mask], want[~mask]))
        for d in (dir_sub,):
            with open(os.path.join(d, name), "rb") as a, open(outputs[f], "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"{name}: the subprocess wrote other bytes")
        fade = int(round(0.02 * sr))
        ref = os.path.join(wf, "fade_ref.wav")
        wavio.write(ref, apply_mute(x.T, erase[f], sr, fade_samples=fade).T, sr,
                    subtype="PCM_16")
        with open(ref, "rb") as a, open(os.path.join(dir_b, name), "rb") as b:
            fade_ok = a.read() == b.read()
        log(f"workflow silence: {name} detections={len(erase[f])} frames={n_fr} channels={ch} "
            f"sr={sr} muted={mask.mean():.4f} zeros_exact={zeros_ok} rest_bit_equal={rest_ok} "
            f"fade_{fade}_equal={fade_ok}")
        if not (zeros_ok and rest_ok and fade_ok):
            raise AssertionError(f"{name}: the silenced samples are wrong")

    # the streaming path writes the in-memory path's fmt chunk and samples
    # (behind the JUNK chunk WavWriter reserves for RF64)
    dir_m, dir_s = os.path.join(wf, "direct_memory"), os.path.join(wf, "direct_streaming")
    mem = _silence_rates(SilenceRunner(dir_m), table, durations)
    stream = _silence_rates(SilenceRunner(dir_s, stream_threshold_bytes=0), table, durations)
    for f in erase:
        name = os.path.basename(outputs[f])
        with open(os.path.join(dir_m, name), "rb") as a, open(outputs[f], "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{name}: the direct in-memory run differs from the CLI's")
        a, b = _wav_chunks(os.path.join(dir_s, name)), _wav_chunks(outputs[f])
        if list(a) != [b"JUNK", b"fmt ", b"data"] or a[b"fmt "] != b[b"fmt "] \
                or a[b"data"] != b[b"data"]:
            raise AssertionError(f"{name}: streaming differs from in-memory")
    log("workflow silence audio-s/wall-s per file, in memory: "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(mem.items()))
        + "; streaming: " + ", ".join(f"{k} {v:.2f}" for k, v in sorted(stream.items()))
        + f"; streaming fmt+samples equal to in-memory | {smi}")

    # how much of the labeled speech the workflow silenced
    for path, truth in labeled.items():
        x, sr = read_any(path)
        speech = _erase_mask(len(x), sr, truth)
        muted = _erase_mask(len(x), sr, erase.get(path, []))
        s_share = float((muted & speech).sum() / max(1, speech.sum()))
        n_share = float((muted & ~speech).sum() / max(1, (~speech).sum()))
        log(f"workflow labeled {os.path.basename(path)}: {len(truth)} utterances, silenced "
            f"speech share={s_share:.4f} (floor 0.80), non-speech share={n_share:.4f}")
        if s_share < 0.80:
            raise AssertionError(f"{path}: only {s_share:.3f} of the labeled speech silenced")

    # the device twin on the card, on two channels of 30 minutes
    x, sr = read_any(wav)
    rng = np.random.default_rng(7)
    audio = np.stack([x, rng.standard_normal(len(x), dtype=np.float32) * 0.1])
    st = rng.uniform(-60.0, 1860.0, 50)
    iv = list(erase.get(wav, [])) + list(zip(st, st + rng.uniform(-5.0, 30.0, 50)))
    # unclipped round-half-even sample indices: the twin clips them itself
    samples = np.rint(np.asarray(iv, np.float64) * sr).astype(np.int64)
    dev = torch.from_numpy(audio).cuda()
    s_dev, e_dev = torch.from_numpy(samples[:, 0]).cuda(), torch.from_numpy(samples[:, 1]).cuda()
    for fade in (0, 640):
        t0 = time.perf_counter()
        want = apply_mute(audio, iv, sr, fade_samples=fade)
        np_s = time.perf_counter() - t0
        got = apply_mute_device(dev, s_dev, e_dev, fade).cpu().numpy()
        err = float(np.abs(got - want).max())
        ms = cuda_time_ms(lambda: apply_mute_device(dev, s_dev, e_dev, fade),
                          warmup=1, iters=3, reps=3)
        ok = np.array_equal(got, want) if fade == 0 else err <= 1e-6
        log(f"workflow mute twin {tuple(audio.shape)} float32, {len(iv)} intervals "
            f"({len(erase.get(wav, []))} detected), fade={fade}: max_abs_err={err:.3e} "
            f"({'bit-equal required' if fade == 0 else 'tol 1e-6'}) ok={ok}; card {ms:.3f} ms, "
            f"numpy apply_mute {np_s * 1e3:.1f} ms | {smi}")
        if not ok:
            raise AssertionError(f"the device mute disagrees with apply_mute (fade={fade})")
    del dev, s_dev, e_dev
    shutil.rmtree(wf)
    log(f"workflow phase: {time.perf_counter() - t_files:.1f} s")


# ---------------------------------------------------------------------------
# slice 8: the eval harness, the two generators, the degradations and the
# music post-filter
# scripts/quality_grid.py's conditions (its seed is 7000 + the condition's index there)
EVAL_CONDITIONS = (("v1_clean", "v1", 7000, None), ("v2_clean", "v2", 7000, None),
                   ("v1_mulaw", "v1", 7007, ["mulaw"]),
                   ("v2_reverb08", "v2", 7014, ["reverb08"]))
# The JAX package's own result on those conditions, the gate's reference:
# tests/jax_eval_reference.py on the CPU at commit b959b9b, 8 x 120 s at
# 32 kHz, trained checkpoint, fast mode with mel_precision="highest",
# detect_file_streaming (its host pipeline on the CPU), parity operating
# point.  (frame F1, event F1) without and with the music filter at 0.85.
EVAL_REFERENCE = {
    "v1_clean": ((0.9553723169887329, 0.8322981366459626),
                 (0.9553723169887329, 0.8322981366459626)),
    "v2_clean": ((0.8969774372073223, 0.7852760736196318),
                 (0.8969774372073223, 0.7852760736196318)),
    "v1_mulaw": ((0.9590730518673231, 0.8315789473684211),
                 (0.9521377791128467, 0.8253968253968255)),
    "v2_reverb08": ((0.8021829942056327, 0.5929203539823009),
                    (0.8010796221322537, 0.5955555555555556)),
}
EVAL_TOL_FRAME, EVAL_TOL_EVENT = 0.01, 0.03
EVAL_FILES, EVAL_SECONDS = 8, 120.0


def _make_eval_condition(outdir: str, generator: str, seed: int, degradations,
                         n_files: int, seconds: float) -> tuple:
    """``make_eval_set`` of one condition at 32 kHz, in a worker process:
    (labels path, seconds taken)."""
    from softspoken_tpu_torch.train.evaluate import make_eval_set

    t0 = time.perf_counter()
    labels = make_eval_set(outdir, n_files=n_files, seconds=seconds, seed=seed,
                           generator=generator, degradations=degradations)
    return labels, time.perf_counter() - t0


def _score_parity(per_file, pad: float, sr: int, music_threshold=None) -> dict:
    """scripts/quality_grid.py's ``metrics_from`` at the parity point
    (threshold 0.1, merge 0.5 s, shift by -pad, clamp, min length 0.1 s,
    IoU 0.5) with the error taxonomy; with ``music_threshold`` the
    predictions go through the post-filter as ``postfilter_parity_metrics``
    applies it, reading contexts from the WAVs."""
    from softspoken_tpu_torch.engine import postfilter as PF
    from softspoken_tpu_torch.engine import regions as R
    from softspoken_tpu_torch.io import load_audio_startstop
    from softspoken_tpu_torch.train import evaluate as E

    ft, et, tax = {}, {}, {}
    dropped = total = 0
    for avg, dur, truth, path in per_file:
        regs = R.shift_regions(R.find_speech_regions(avg, 0.1, 0.5), -pad)
        regs = [(max(0.0, s), min(dur, e)) for s, e in regs if e > 0 and s < dur]
        pred = R.filter_min_length(regs, 0.1)
        if music_threshold is not None:
            def read_ctx(s, e, _p=path):
                return load_audio_startstop(_p, (s, e), target_sr=sr)[0]

            kept, _scores = PF.filter_intervals(pred, read_ctx, sr, dur, music_threshold)
            dropped += len(pred) - len(kept)
            total += len(pred)
            pred = kept
        E._accumulate(ft, E.frame_metrics(pred, truth, dur))
        E._accumulate(et, E.event_metrics(pred, truth, 0.5))
        E.merge_taxonomy(tax, E.event_error_taxonomy(pred, truth, 0.5))
    return {"frame_f1": E._finalize(ft)["f1"], "event_f1": E._finalize(et)["f1"],
            "taxonomy": E.finalize_taxonomy(tax), "dropped": dropped, "total": total}


def phase_eval(work: str, smi: str) -> int:
    """(a) The committed checkpoint's quality on four conditions of
    scripts/quality_grid.py, held to the JAX package's CPU result; (b) the
    ``eval`` and ``detect`` commands with the operating-point flags, in
    process.  Returns K1's launches over the phase."""
    import concurrent.futures
    import multiprocessing

    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine import postfilter as PF
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
    from softspoken_tpu_torch.train import evaluate as E

    ev = os.path.join(work, "eval")
    shutil.rmtree(ev, ignore_errors=True)
    os.makedirs(ev)
    t_phase = time.perf_counter()
    with open(os.path.join(HERE, "docs", "QUALITY_r05.json")) as f:
        tpu_record = json.load(f)["conditions"]
    cfg = Config().with_engine(mel_precision="highest")
    det = Detector(cfg)
    log(f"eval detector: pipeline {det.pipeline}, mel kernel {det.mel_kernel}, "
        f"epoch {det.epoch}")
    if det.epoch != 48750:
        raise AssertionError(f"Detector() loaded epoch {det.epoch}, not the trained 48750")
    sr, pad = cfg.dsp.sample_rate, cfg.engine.pad_seconds
    reset_launch_counts()
    misses = []
    # the four sets synthesize in worker processes while the card detects
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(EVAL_CONDITIONS),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(_make_eval_condition, os.path.join(ev, tag), gen, seed, deg,
                            EVAL_FILES, EVAL_SECONDS)
                for tag, gen, seed, deg in EVAL_CONDITIONS]
        for (tag, _gen, seed, _deg), fut in zip(EVAL_CONDITIONS, futs):
            labels, synth_s = fut.result()
            before = KERNEL_LAUNCHES["frame_mel"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            per_file = []
            for path, truth in E.load_labels(labels):
                res = det.detect_file_streaming(path)
                per_file.append((np.asarray(res.avg_values, np.float32),
                                 float(res.audio_seconds), truth, path))
            detect_s = time.perf_counter() - t0
            k1 = KERNEL_LAUNCHES["frame_mel"] - before
            t0 = time.perf_counter()
            plain = _score_parity(per_file, pad, sr)
            filt = _score_parity(per_file, pad, sr, PF.DEFAULT_THRESHOLD)
            score_s = time.perf_counter() - t0
            ref, tpu = EVAL_REFERENCE[tag], tpu_record[tag]
            tpu_pf = tpu.get("parity_postfilter", {})
            for label, got, (rf, re_) in (("plain", plain, ref[0]), ("filtered", filt, ref[1])):
                df, de = got["frame_f1"] - rf, got["event_f1"] - re_
                log(f"eval {tag} (seed {seed}) {label}: frame F1 {got['frame_f1']:.4f} "
                    f"(JAX CPU {rf:.4f}, diff {df:+.4f}, tol {EVAL_TOL_FRAME}), event F1 "
                    f"{got['event_f1']:.4f} (JAX CPU {re_:.4f}, diff {de:+.4f}, tol "
                    f"{EVAL_TOL_EVENT}); taxonomy {json.dumps(got['taxonomy'])}")
                if abs(df) > EVAL_TOL_FRAME or abs(de) > EVAL_TOL_EVENT:
                    misses.append(f"{tag} {label}: frame {df:+.4f}, event {de:+.4f}")
            log(f"eval {tag}: music filter dropped {filt['dropped']}/{filt['total']} regions; "
                f"TPU record (docs/QUALITY_r05.json, information only): parity "
                f"{tpu['parity']['frame_f1']}/{tpu['parity']['event_f1']}, postfilter "
                f"{tpu_pf.get('frame_f1')}/{tpu_pf.get('event_f1')} dropped "
                f"{tpu_pf.get('regions_dropped')}/{tpu_pf.get('regions_total')}; "
                f"synth {synth_s:.2f} s, detect {detect_s:.3f} s "
                f"({EVAL_FILES * EVAL_SECONDS / detect_s:.1f} audio-s/wall-s), "
                f"scoring {score_s:.2f} s, "
                f"K1 launches {k1} | {smi}")
            if not k1:
                raise AssertionError(f"eval {tag} did not launch frame_mel")
    launches_a = KERNEL_LAUNCHES["frame_mel"]

    # (b) the CLI, in process, on the card
    times: dict = {}
    d1, d2 = os.path.join(ev, "cli_v1"), os.path.join(ev, "cli_v2")
    before = KERNEL_LAUNCHES["frame_mel"]
    out = _cli(["eval", "--make-synthetic", d1, "--eval-files", "8", "--eval-seconds", "120"],
               "eval v1 8x120 s", times)[1]
    res = json.loads(out.strip().splitlines()[-1])
    grew = KERNEL_LAUNCHES["frame_mel"] - before
    log(f"cli eval v1: frame {json.dumps(res['frame'])} event {json.dumps(res['event'])}, "
        f"{len(res['files'])} files, K1 launches {grew}")
    if set(res) != {"frame", "event", "files"} or res["frame"]["f1"] < 0.80 or not grew:
        raise AssertionError(f"cli eval v1: frame F1 {res['frame']['f1']}, K1 launches {grew}")
    out = _cli(["eval", "--make-synthetic", d2, "--generator", "v2", "--degrade", "fading",
                "--eval-files", "2", "--eval-seconds", "60", "--music-filter",
                "--exit-threshold", "0.05", "--grid-smooth", "3"], "eval v2 fading flags",
               times)[1]
    res2 = json.loads(out.strip().splitlines()[-1])
    log(f"cli eval v2 fading --music-filter --exit-threshold 0.05 --grid-smooth 3: frame F1 "
        f"{res2['frame']['f1']:.4f}, event F1 {res2['event']['f1']:.4f}")
    if set(res2) != {"frame", "event", "files"} or len(res2["files"]) != 2:
        raise AssertionError(f"cli eval v2: {res2}")
    csv_path = os.path.join(ev, "detect_flags.csv")
    rep = _json_tail(_cli(["detect", "--files", os.path.join(d1, "eval_000.wav"), "--out",
                           csv_path, "--music-filter", "--exit-threshold", "0.05",
                           "--grid-smooth", "3"], "detect flags", times)[1])
    with open(csv_path) as f:
        rows = f.read().splitlines()
    log(f"cli detect --music-filter --exit-threshold 0.05 --grid-smooth 3: "
        f"{rep['rows_added']} rows, {len(rows) - 1} in the CSV")
    if rep["files_done"] != 1 or len(rows) - 1 != rep["rows_added"] or not rep["rows_added"]:
        raise AssertionError(f"cli detect with the operating-point flags: {rep}")
    log("eval CLI wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f" | {smi}")
    shutil.rmtree(ev)
    log(f"eval phase: {time.perf_counter() - t_phase:.1f} s, K1 launches "
        f"{KERNEL_LAUNCHES['frame_mel']} ({launches_a} in the four conditions)")
    if misses:
        raise AssertionError("eval quality off the JAX reference: " + "; ".join(misses))
    return KERNEL_LAUNCHES["frame_mel"]


# ---------------------------------------------------------------------------
# slice 15: the maintainers' tools (softspoken_tpu_torch/tools/) on the card
# The JAX package's own quick grid, the tools phase's reference:
# ``JAX_PLATFORMS=cpu python scripts/quality_grid.py --quick`` on the CPU at
# commit 25c161a (2 files x 60 s per cell; seeds 7000-7003 in the quick
# list's order; trained checkpoint; mel_precision "highest"; its host
# pipeline on the CPU).  (frame F1, event F1) at the parity point, then with
# the music filter at 0.85 (``parity_postfilter``).
QUICK_REFERENCE = {
    "v1_clean": ((0.9775, 1.0), (0.9775, 1.0)),
    "v1_snr0": ((0.964, 0.75), (0.964, 0.75)),
    "v1_mulaw": ((0.9668, 0.9268), (0.9668, 0.9268)),
    "v1_reverb08": ((0.6083, 0.4211), (0.6083, 0.4211)),
    "v2_clean": ((0.9187, 0.8511), (0.9187, 0.8511)),
    "v2_snr0": ((0.8914, 0.7541), (0.8914, 0.7541)),
    "v2_mulaw": ((0.8941, 0.6857), (0.8941, 0.6857)),
    "v2_reverb08": ((0.9077, 0.7119), (0.8847, 0.6897)),
}
TOOLS_TOL_FRAME, TOOLS_TOL_EVENT = 0.01, 0.03


def phase_tools(work: str, smi: str) -> dict:
    """The tools on the card, in process, each with its kernel launches
    (K1-K3) and seconds: ``quality_grid --quick`` held to the JAX package's
    CPU grid (``QUICK_REFERENCE``) at the parity point and with the music
    filter; ``codec_gate --codec adpcm4`` at 2 files x 30 s; one run each
    of ``sweep_device`` (base, phase), ``profile_chunk`` (its table must
    name K1), ``profile_e2e`` and ``bench_train`` (2 outer calls).  Returns
    the launches per tool."""
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
    from softspoken_tpu_torch.tools import (bench_train, codec_gate, compare_grids,
                                            profile_chunk, profile_e2e, quality_grid,
                                            sweep_device)

    tw = os.path.join(work, "tools")
    shutil.rmtree(tw, ignore_errors=True)
    os.makedirs(tw)
    t_phase = time.perf_counter()
    launches: dict = {}

    def run(name, argv, mod):
        before = {k: KERNEL_LAUNCHES[k] for k in KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        launches[name] = {k: KERNEL_LAUNCHES[k] - before[k] for k in KERNELS}
        log(f"tools {name}: {time.perf_counter() - t0:.1f} s, kernel launches "
            f"{json.dumps(launches[name])} | {smi}")
        return out

    grid = run("quality_grid", ["--quick", "--out", os.path.join(tw, "quick.json"),
                                "--workdir", os.path.join(tw, "grid")], quality_grid)
    ref = {tag: {"parity": {"frame_f1": p[0], "event_f1": p[1]},
                 "parity_postfilter": {"frame_f1": f[0], "event_f1": f[1]}}
           for tag, (p, f) in QUICK_REFERENCE.items()}
    rows = compare_grids.hold(ref, grid["conditions"], TOOLS_TOL_FRAME, TOOLS_TOL_EVENT)
    for r in rows:
        got = grid["conditions"][r["condition"]][r["key"]]
        log(f"tools quick grid {r['condition']} {r['key']}: frame F1 {got['frame_f1']} "
            f"(JAX CPU diff {r.get('d_frame', float('nan')):+.4f}), event F1 "
            f"{got['event_f1']} (diff {r.get('d_event', float('nan')):+.4f}); tol "
            f"{TOOLS_TOL_FRAME}/{TOOLS_TOL_EVENT}")
    misses = [f"{r['condition']} {r['key']}" for r in rows if not r["ok"]]
    if set(grid["conditions"]) != set(QUICK_REFERENCE) or len(rows) != 2 * len(ref):
        misses.append(f"quick grid cells {sorted(grid['conditions'])}")

    gate = run("codec_gate", ["--codec", "adpcm4", "--files", "2", "--seconds", "30",
                              "--out", os.path.join(tw, "codec_gate.json"),
                              "--workdir", os.path.join(tw, "codec")], codec_gate)
    log(f"tools codec_gate adpcm4: intervals identical {gate['interval_identical_files']}/"
        f"{gate['total_files']}; frame F1 pcm16/adpcm4/adpcm4_dec " + ", ".join(
            f"{tag} {row['pcm16']['frame_f1']}/{row['adpcm4']['frame_f1']}/"
            f"{row['adpcm4_dec']['frame_f1']}" for tag, row in gate["conditions"].items()))
    sweep = run("sweep_device", ["--variants", "base,phase", "--repeats", "3"], sweep_device)
    prof = run("profile_chunk", ["--out", os.path.join(tw, "profile_chunk.md"),
                                 "--trace-dir", os.path.join(tw, "trace")], profile_chunk)
    k1_ms = sum(ms for n, (ms, _c) in prof["rows"].items() if KERNEL_SYMBOLS["frame_mel"] in n)
    log(f"tools profile_chunk: {prof['rate']:.2f} audio-s/wall-s, device ms "
        f"{prof['device_ms']:.3f} over 4 chunk programs, K1 {k1_ms:.3f} ms")
    e2e = run("profile_e2e", ["--repeats", "1"], profile_e2e)
    trained = run("bench_train", ["--outer", "2"], bench_train)
    seconds = time.perf_counter() - t_phase
    log(f"tools phase: {seconds:.1f} s (sweep {json.dumps([round(r['audio_s_per_s'], 2) for r in sweep])}"
        f" audio-s/wall-s, profile_e2e {e2e[0]['rate']:.2f}, bench_train "
        f"{trained['clips_per_s']} clips/s) | {smi}")
    if not launches["quality_grid"]["frame_mel"]:
        misses.append("quality_grid launched no frame_mel")
    if not launches["codec_gate"]["adpcm_decode"] or not launches["codec_gate"]["frame_mel"]:
        misses.append("codec_gate adpcm4 launched no adpcm_decode or no frame_mel")
    if not k1_ms or not all(r["audio_s_per_s"] > 0 for r in sweep) \
            or not np.isfinite(trained["loss"]):
        misses.append("a profiling tool measured nothing")
    shutil.rmtree(tw)
    if misses:
        raise AssertionError("tools phase: " + "; ".join(misses))
    return launches


# ---------------------------------------------------------------------------
# slice 16: the real-audio probe and the fine-tune drivers
RA_TOL_FRACTION = 0.01  # real_audio_check card vs CPU: false_fraction per class


def _tool_proc(name: str, argv: list) -> "tuple[float, subprocess.CompletedProcess]":
    """``python -m softspoken_tpu_torch.tools.<name> ARGV`` on the card, a
    subprocess: (seconds, the finished process, its output captured)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", f"softspoken_tpu_torch.tools.{name}", *argv],
                       cwd=HERE, capture_output=True, text=True, timeout=900)
    return time.perf_counter() - t0, r


def _check_tool(name: str, wd: str, r: subprocess.CompletedProcess) -> None:
    """Fails on a tool's nonzero exit, with its output and the tails of the
    stage logs in its workdir."""
    if r.returncode != 0:
        tails = []
        for f in sorted(os.listdir(wd)):
            if f.endswith(".log"):
                with open(os.path.join(wd, f)) as fh:
                    tails.append(f"--- {f}\n" + "".join(fh.readlines()[-20:]))
        raise AssertionError(f"{name} exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}\n" + "\n".join(tails))


def _ft_driver(name: str, wd: str) -> "tuple[float, str]":
    """``python -m softspoken_tpu_torch.tools.<name> --quick`` on the card, a
    subprocess whose stages are subprocesses too: (seconds, its stdout);
    fails on a nonzero exit."""
    seconds, r = _tool_proc(name, ["--quick", "--workdir", wd])
    _check_tool(name, wd, r)
    return seconds, r.stdout


def _stage_seconds(out: str) -> list:
    """Each stage's wall seconds, from the "done in" lines ``ftlib.run``
    prints (a skipped stage prints none)."""
    return [float(ln.split("done in ")[1].split(" s")[0]) for ln in out.splitlines()
            if ln.startswith("  done in ")]


def _stage_launches(wd: str, log_name: str) -> dict:
    """The kernel launches that a stage subprocess printed at its exit."""
    from softspoken_tpu_torch.tools import read_launches

    with open(os.path.join(wd, log_name)) as f:
        got = read_launches(f.read())
    return {k: got.get(k, 0) for k in KERNELS}


def _wav_files(root: str) -> dict:
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _dirs, files in os.walk(root) for f in files if f.endswith(".wav")}


def phase_finetune(work: str, smi: str) -> dict:
    """The fine-tune drivers and the real-audio probe on the card.
    ``tools.ft_boundary --quick`` end to end (train 4 steps from the
    committed .pth, the quick grid, the verdict), each stage a subprocess:
    the grid stage's K1 launches, read from the line it prints at exit, must
    be > 0.  With pygame's clips present: ``tools.real_audio_check --quick``
    in process (K1 counted), held to the same run on the CPU (a subprocess
    started first, running meanwhile): the beds' and mixes' WAV bytes equal,
    false_fraction per class within 0.01, F1 within 0.01 frame / 0.03 event;
    then ``tools.ft_music --quick`` (its grid and real-audio stages launch
    K1).  Without the clips, one line says what was not run.  Returns the
    launches per tool and stage."""
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
    from softspoken_tpu_torch.tools import real_audio_check as RA

    fw = os.path.join(work, "finetune")
    shutil.rmtree(fw, ignore_errors=True)
    os.makedirs(fw)
    t_phase = time.perf_counter()
    launches: dict = {}
    misses: list = []
    missing = RA.missing_clips(RA.pygame_data_dir())
    cpu_json, cpu_wd = os.path.join(fw, "real_cpu.json"), os.path.join(fw, "real_cpu")
    cpu_proc = None
    if not missing:
        cpu_proc = subprocess.Popen(
            [sys.executable, "-m", "softspoken_tpu_torch.tools.real_audio_check", "--quick",
             "--device", "cpu", "--out", cpu_json, "--workdir", cpu_wd],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wd = os.path.join(fw, "ft_boundary")
        seconds, out = _ft_driver("ft_boundary", wd)
        launches["ft_boundary grid"] = _stage_launches(wd, "grid.log")
        with open(os.path.join(wd, "VERDICT_ft_boundary.json")) as f:
            verdict = json.load(f)
        stages = _stage_seconds(out)
        log(f"finetune ft_boundary --quick: {seconds:.1f} s (stages train, grid: "
            f"{stages} s), grid K1 launches {launches['ft_boundary grid']['frame_mel']}, "
            f"verdict adopt={verdict['adopt']} (4 steps), v2 worst event F1 "
            f"{verdict['v2_worst_event_f1']} | {smi}")
        if not launches["ft_boundary grid"]["frame_mel"]:
            misses.append("ft_boundary's grid stage launched no frame_mel")
        if len(stages) != 2 or not os.path.exists(os.path.join(wd, "candidate.pth")):
            misses.append(f"ft_boundary stages {stages}")

        if missing:
            log(f"finetune: pygame's clips are absent ({', '.join(missing)}): "
                "real_audio_check --quick (card and CPU) and ft_music --quick not run")
        else:
            card_json, card_wd = os.path.join(fw, "real_card.json"), os.path.join(fw, "real_card")
            before = {k: KERNEL_LAUNCHES[k] for k in KERNELS}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = RA.main(["--quick", "--out", card_json, "--workdir", card_wd])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches["real_audio_check"] = {k: KERNEL_LAUNCHES[k] - before[k] for k in KERNELS}
            t0 = time.perf_counter()
            cpu_out, _ = cpu_proc.communicate(timeout=900)
            wait_s = time.perf_counter() - t0
            if cpu_proc.returncode != 0:
                raise AssertionError(f"real_audio_check --device cpu exited "
                                     f"{cpu_proc.returncode}:\n{cpu_out[-3000:]}")
            with open(cpu_json) as f:
                cpu = json.load(f)
            wav_card, wav_cpu = _wav_files(card_wd), _wav_files(cpu_wd)
            same = sorted(k for k in wav_card if k in wav_cpu and open(wav_card[k], "rb").read()
                          == open(wav_cpu[k], "rb").read())
            if not wav_card or same != sorted(wav_card) or set(wav_card) != set(wav_cpu):
                misses.append(f"real_audio_check WAVs card != CPU: {sorted(set(wav_card) ^ set(same))}")
            for cls, got in card["false_positives_on_real_audio"].items():
                want = cpu["false_positives_on_real_audio"][cls]
                d = got["false_fraction"] - want["false_fraction"]
                log(f"finetune real_audio_check {cls}: false_fraction card {got['false_fraction']} "
                    f"CPU {want['false_fraction']} ({d:+.4f}, tol {RA_TOL_FRACTION}), events "
                    f"{got['false_events']}/{want['false_events']}, grid max {got['grid_max']}/"
                    f"{want['grid_max']}")
                if abs(d) > RA_TOL_FRACTION:
                    misses.append(f"real_audio_check {cls} false_fraction {d:+.4f}")
            for snr, row in card["recall_over_real_noise_beds"].items():
                got, want = row["parity"], cpu["recall_over_real_noise_beds"][snr]["parity"]
                df, de = got["frame_f1"] - want["frame_f1"], got["event_f1"] - want["event_f1"]
                log(f"finetune real_audio_check {snr}: frame F1 card {got['frame_f1']} CPU "
                    f"{want['frame_f1']} ({df:+.4f}), event F1 {got['event_f1']}/"
                    f"{want['event_f1']} ({de:+.4f}); tol {TOOLS_TOL_FRAME}/{TOOLS_TOL_EVENT}")
                if abs(df) > TOOLS_TOL_FRAME or abs(de) > TOOLS_TOL_EVENT:
                    misses.append(f"real_audio_check {snr} F1 {df:+.4f}/{de:+.4f}")
            log(f"finetune real_audio_check --quick: card {seconds:.1f} s ({card['backend']}), "
                f"CPU {cpu['wall_seconds']} s of probes (waited {wait_s:.1f} s more), "
                f"{len(same)} WAVs byte-equal, K1 launches "
                f"{launches['real_audio_check']['frame_mel']} | {smi}")
            if not launches["real_audio_check"]["frame_mel"]:
                misses.append("real_audio_check launched no frame_mel")

            wd = os.path.join(fw, "ft_music")
            seconds, out = _ft_driver("ft_music", wd)
            stages = _stage_seconds(out)
            launches["ft_music grid"] = _stage_launches(wd, "grid.log")
            launches["ft_music real"] = _stage_launches(wd, "real.log")
            with open(os.path.join(wd, "VERDICT_ft_music.json")) as f:
                verdict = json.load(f)
            log(f"finetune ft_music --quick: {seconds:.1f} s (stages train, grid, real: "
                f"{stages} s), K1 launches grid {launches['ft_music grid']['frame_mel']}, real "
                f"{launches['ft_music real']['frame_mel']}, verdict adopt={verdict['adopt']} "
                f"(4 steps), music false_fraction {verdict['music_false_fraction']} | {smi}")
            if not (launches["ft_music grid"]["frame_mel"]
                    and launches["ft_music real"]["frame_mel"]) or len(stages) != 3:
                misses.append(f"ft_music stages {stages}, launches "
                              f"{launches['ft_music grid']} {launches['ft_music real']}")
    finally:
        if cpu_proc is not None and cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.communicate()
    log(f"finetune phase: {time.perf_counter() - t_phase:.1f} s | {smi}")
    if misses:
        for d, _dirs, files in os.walk(fw):
            for f in sorted(files):
                if f.endswith(".log"):
                    with open(os.path.join(d, f)) as fh:
                        log(f"--- {os.path.relpath(os.path.join(d, f), fw)} (tail)\n"
                            + "".join(fh.readlines()[-15:]))
        raise AssertionError("finetune phase: " + "; ".join(misses))
    shutil.rmtree(fw)
    return launches


# ---------------------------------------------------------------------------
# slice 17: the round-5 retrain supervisor, its gate and the two probes
# the recipe.json that scripts/train_r05.py --quick writes
R5_QUICK_RECIPE = {
    "steps": 80, "batch_size": 128, "lr": "1e-3", "seed": 31337,
    "augment": ["add_reverb", "reduce_volume", "gain_ramp"],
    "noise_extra": ["granular", "drone", "impact_chain", "crackle"],
    "noise_extra_frac": 0.2, "noise_extra_policy": "protected", "snr": [-5.0, 20.0],
    "from_scratch": True, "plan": "docs/ROUND5_PLAN.md", "quick": True}
R5_BUDGET_S = 250.0  # the phase's share of the script's 1,200 s limit


def agc_direct(x: np.ndarray, sr: int, win_s: float = 3.0, floor_db: float = -45.0):
    """The AGC as scripts/probe_agc_r05.py computes it: the envelope by a
    direct ``np.convolve`` with the box (O(N * win)), the form that
    ``tools.probe_agc_r05.agc`` replaces by cumulative sums."""
    win = max(1, int(sr * win_s))
    env2 = np.convolve(x.astype(np.float64) ** 2, np.ones(win, np.float64) / win, mode="same")
    env = np.sqrt(np.maximum(env2, 0.0))
    floor = 10.0 ** (floor_db / 20.0)
    ref = max(float(np.median(env)), floor)
    y = x.astype(np.float64) * (ref / np.maximum(env, floor))
    peak = np.abs(y).max()
    if peak > 0.99:
        y *= 0.99 / peak
    return y.astype(np.float32)


# probe_agc_r05 card vs CPU in parity: float32 convolutions, the fused
# pipeline on both devices with K1 in "highest", where both compute the same
# function to ~1e-5.  At the tool's defaults (fast: bf16 convolutions, K1
# "default") one event of a 30 s file splits on the card and merges on the
# CPU, whose bf16 rounds otherwise; the card's parity run splits it too.
# One batch of 64 windows a chunk holds a 30 s file's 56 windows (a 600 s
# chunk would make the CPU compute 1,024 for each file)
AGC_PARITY = {"engine": {"precision": "parity", "pipeline": "fused", "mel_kernel": "fused",
                         "device_batch": 64, "chunk_seconds": 36.0}}


def _agc_compare(got_run: dict, want_run: dict, got_name: str, want_name: str) -> list:
    """Logs each condition and arm's F1 of one AGC probe run beside
    another's; returns the cells outside 0.01 frame / 0.03 event."""
    outside = []
    for tag, row in got_run["conditions"].items():
        for arm in ("baseline", "agc"):
            got, want = row[arm], want_run["conditions"][tag][arm]
            df, de = got["frame_f1"] - want["frame_f1"], got["event_f1"] - want["event_f1"]
            log(f"round5 probe_agc_r05 {tag} {arm}: frame F1 {got_name} {got['frame_f1']} "
                f"{want_name} {want['frame_f1']} ({df:+.4f}), event F1 {got['event_f1']}/"
                f"{want['event_f1']} ({de:+.4f}), taxonomy {got['taxonomy']}/"
                f"{want['taxonomy']}")
            if abs(df) > TOOLS_TOL_FRAME or abs(de) > TOOLS_TOL_EVENT:
                outside.append(f"{tag} {arm} {df:+.4f}/{de:+.4f}")
    return outside


def _r5_supervised(wd: str, seconds: float, out: str, smi: str, label: str) -> dict:
    """Checks a ``tools.train_r05 --quick`` run into ``wd``: its final JSON
    line's steps and the .pth's epoch are 80; returns that line."""
    from softspoken_tpu_torch.ckpt import load_pth

    final = json.loads(next(ln for ln in reversed(out.splitlines()) if ln.startswith("{")))
    epoch = load_pth(os.path.join(wd, "ckpt_r05.pth"))[1]
    log(f"round5 train_r05 --quick ({label}): {seconds:.1f} s, steps {final['steps']}, "
        f"the .pth's epoch {epoch}, wall_s {final['wall_s']} | {smi}")
    if final["steps"] != 80 or epoch != 80:
        raise AssertionError(f"round5 train_r05 ({label}) ended at steps {final['steps']}, "
                             f"epoch {epoch}, not 80:\n{out[-3000:]}")
    return final


def phase_round5(work: str, smi: str) -> dict:
    """The round-5 tools on the card; the four subprocess tools run side by
    side (each part's seconds are its own wall beside the others), the AGC
    probe in process meanwhile.  ``tools.train_r05 --quick`` (80 steps at
    B = 2 from scratch): its final line's steps and the .pth's epoch 80,
    recipe.json the JAX script's; then run again, it launches no trainer;
    in a workdir holding the recipe and a ``save_pth`` checkpoint at epoch
    50 it runs the trainer with ``--steps 30 --resume`` and ends at epoch
    80.  ``tools.probe_scratch_channels --quick`` (two arms of 8 steps, six
    conditions scored; K1 from its ``kernel launches:`` line).
    ``tools.probe_agc_r05 --files 1 --seconds 30`` in process (K1 counted)
    at its defaults and in parity (``AGC_PARITY``); the parity run held to
    the same run on the CPU (a subprocess): the ``_agc.wav`` bytes equal,
    frame and event F1 within 0.01 / 0.03 per condition and arm; the
    defaults' F1 printed beside the parity run's.  The AGC's two forms timed
    on one file, outputs equal.  ``tools.retrain_gate_r05 --quick`` of the
    committed .pth: stage 1's K1 launches (its grid's exit line); with
    pygame's clips stage 2 and the verdict, without them an exit naming the
    clips, and one line saying what was not run.  Returns the launches per
    tool."""
    from softspoken_tpu_torch.ckpt import save_pth
    from softspoken_tpu_torch.io import wavio
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
    from softspoken_tpu_torch.tools import DEFAULT_CKPT, read_launches
    from softspoken_tpu_torch.tools import probe_agc_r05 as PA
    from softspoken_tpu_torch.tools import real_audio_check as RA
    from softspoken_tpu_torch.train.loop import create_train_state

    fw = os.path.join(work, "round5")
    shutil.rmtree(fw, ignore_errors=True)
    os.makedirs(fw)
    t_phase = time.perf_counter()
    launches: dict = {}
    parts: dict = {}
    misses: list = []
    wds = {k: os.path.join(fw, k) for k in ("r05", "r05_resume", "probe_scratch", "gate")}
    os.makedirs(wds["r05_resume"])
    with open(os.path.join(wds["r05_resume"], "recipe.json"), "w") as f:
        json.dump(R5_QUICK_RECIPE, f, indent=1)
    resume_ckpt = os.path.join(wds["r05_resume"], "ckpt_r05.pth")
    save_pth(resume_ckpt, create_train_state(seed=31337).model.state_dict(), epoch=50)
    parity_json = os.path.join(fw, "parity.json")
    with open(parity_json, "w") as f:
        json.dump(AGC_PARITY, f)
    agc_modes = {"default": [], "parity": ["--config", parity_json]}
    cpu_json, cpu_wd = os.path.join(fw, "agc_cpu.json"), os.path.join(fw, "agc_cpu")
    tools = {"train_r05": ("train_r05", ["--quick", "--workdir", wds["r05"]]),
             "train_r05 resume": ("train_r05", ["--quick", "--workdir", wds["r05_resume"]]),
             "probe_scratch_channels": ("probe_scratch_channels",
                                        ["--quick", "--workdir", wds["probe_scratch"]]),
             "retrain_gate_r05": ("retrain_gate_r05", ["--quick", "--workdir", wds["gate"],
                                                       "--ckpt", DEFAULT_CKPT]),
             "probe_agc_r05 CPU": ("probe_agc_r05", [
                 "--files", "1", "--seconds", "30", *agc_modes["parity"], "--device", "cpu",
                 "--workdir", cpu_wd, "--out", cpu_json])}
    with ThreadPoolExecutor(len(tools)) as pool:
        futs = {k: pool.submit(_tool_proc, name, argv) for k, (name, argv) in tools.items()}
        card_wd = os.path.join(fw, "agc_card")
        card = {}
        for mode, extra in agc_modes.items():
            before = {k: KERNEL_LAUNCHES[k] for k in KERNELS}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card[mode] = PA.main(["--files", "1", "--seconds", "30", *extra,
                                  "--workdir", card_wd,
                                  "--out", os.path.join(fw, f"agc_card_{mode}.json")])
            torch.cuda.synchronize()
            parts[f"probe_agc_r05 {mode}"] = time.perf_counter() - t0
            launches[f"probe_agc_r05 {mode}"] = {
                k: KERNEL_LAUNCHES[k] - before[k] for k in KERNELS}
            if len(card[mode]["conditions"]) != 8 \
                    or not launches[f"probe_agc_r05 {mode}"]["frame_mel"]:
                misses.append(f"probe_agc_r05 {mode}: {sorted(card[mode]['conditions'])}, "
                              f"{launches[f'probe_agc_r05 {mode}']}")
        done = {k: f.result() for k, f in futs.items()}
    parts.update({k: seconds for k, (seconds, _r) in done.items()})
    # timed alone: np.convolve runs on every BLAS thread
    wav_card = _wav_files(card_wd)
    x, sr = wavio.read(wav_card[min(k for k in wav_card if not k.endswith("_agc.wav"))])
    t0 = time.perf_counter()
    y = PA.agc(x, sr)
    t_cum = time.perf_counter() - t0
    t0 = time.perf_counter()
    y_direct = agc_direct(x, sr)
    t_direct = time.perf_counter() - t0
    log(f"round5 agc on the host, one {len(x) / sr:.0f} s file: cumulative sums "
        f"{t_cum:.4f} s, the JAX script's np.convolve {t_direct:.4f} s, float32 outputs "
        f"equal: {np.array_equal(y, y_direct)} | {smi}")
    if not np.array_equal(y, y_direct):
        misses.append("agc's cumulative-sum form differs from np.convolve's")

    for key, wd in (("train_r05", wds["r05"]), ("train_r05 resume", wds["r05_resume"]),
                    ("probe_scratch_channels", wds["probe_scratch"])):
        _check_tool(tools[key][0], wd, done[key][1])
    _r5_supervised(wds["r05"], parts["train_r05"], done["train_r05"][1].stdout, smi, "fresh")
    with open(os.path.join(wds["r05"], "recipe.json")) as f:
        if json.load(f) != R5_QUICK_RECIPE:
            misses.append("train_r05 recipe.json is not the JAX script's --quick recipe")
    parts["train_r05 again"], out = _ft_driver("train_r05", wds["r05"])
    with open(os.path.join(wds["r05"], "train_r05.log")) as f:
        attempts = f.read().count("=== attempt")
    log(f"round5 train_r05 --quick again: {parts['train_r05 again']:.1f} s, trainer "
        f"attempts in its log {attempts}")
    if attempts != 1 or "\n+ " in "\n" + out:
        misses.append(f"a finished train_r05 launched a trainer again ({attempts} attempts)")
    out = done["train_r05 resume"][1].stdout
    _r5_supervised(wds["r05_resume"], parts["train_r05 resume"], out, smi, "resumed at 50")
    cmd = next(ln for ln in out.splitlines() if ln.startswith("+ "))
    if ("resuming from step 50 (30 to go)" not in out or " --steps 30 " not in cmd
            or f" --resume {resume_ckpt} " not in cmd + " "):
        misses.append(f"train_r05 did not resume from epoch 50: {cmd}")

    out = done["probe_scratch_channels"][1].stdout
    got = read_launches(out)
    launches["probe_scratch_channels"] = {k: got.get(k, 0) for k in KERNELS}
    with open(os.path.join(wds["probe_scratch"], "probe_quick.json")) as f:
        probe = json.load(f)
    log(f"round5 probe_scratch_channels --quick: {parts['probe_scratch_channels']:.1f} s "
        f"(stages {_stage_seconds(out)} s), K1 launches "
        f"{launches['probe_scratch_channels']['frame_mel']}, frame F1 A/B "
        + ", ".join(f"{t} {r['frame_f1_A']}/{r['frame_f1_B']}"
                    for t, r in probe["per_condition"].items()) + f" | {smi}")
    if (len(probe["per_condition"]) != 6 or len(_stage_seconds(out)) != 2
            or not launches["probe_scratch_channels"]["frame_mel"]):
        misses.append(f"probe_scratch_channels: {sorted(probe['per_condition'])}, stages "
                      f"{_stage_seconds(out)}, {launches['probe_scratch_channels']}")

    r = done["probe_agc_r05 CPU"][1]
    if r.returncode != 0:
        raise AssertionError(f"probe_agc_r05 --device cpu exited {r.returncode}:\n"
                             f"{(r.stdout + r.stderr)[-3000:]}")
    with open(cpu_json) as f:
        cpu = json.load(f)
    wav_cpu = _wav_files(cpu_wd)
    agc_card = sorted(k for k in wav_card if k.endswith("_agc.wav"))
    same = [k for k in agc_card if k in wav_cpu and open(wav_card[k], "rb").read()
            == open(wav_cpu[k], "rb").read()]
    if len(agc_card) != 8 or same != agc_card or set(wav_card) != set(wav_cpu):
        misses.append(f"probe_agc_r05 _agc.wav card != CPU: {sorted(set(agc_card) - set(same))}")
    outside = _agc_compare(card["parity"], cpu, "parity card", "CPU")
    misses += [f"probe_agc_r05 parity card vs CPU {cell}" for cell in outside]
    moved = _agc_compare(card["default"], card["parity"], "card default", "parity")
    log(f"round5 probe_agc_r05 1 x 30 s: card {parts['probe_agc_r05 default']:.1f} s "
        f"(default), {parts['probe_agc_r05 parity']:.1f} s (parity), CPU "
        f"{parts['probe_agc_r05 CPU']:.1f} s (parity); {len(same)} _agc.wav byte-equal; "
        f"cells outside {TOOLS_TOL_FRAME}/{TOOLS_TOL_EVENT}: parity card vs CPU {outside} "
        f"(held), the card's default vs its parity {moved} (not held: bf16); K1 launches "
        f"{launches['probe_agc_r05 default']['frame_mel']} (default), "
        f"{launches['probe_agc_r05 parity']['frame_mel']} (parity) | {smi}")

    wd = wds["gate"]
    r = done["retrain_gate_r05"][1]
    gate_out = r.stdout + r.stderr
    launches["retrain_gate_r05 grid"] = _stage_launches(wd, "grid.log")
    log(f"round5 retrain_gate_r05 --quick: {parts['retrain_gate_r05']:.1f} s, exit "
        f"{r.returncode}, stages {_stage_seconds(r.stdout)} s, grid K1 launches "
        f"{launches['retrain_gate_r05 grid']['frame_mel']} | {smi}")
    if not launches["retrain_gate_r05 grid"]["frame_mel"]:
        misses.append("retrain_gate_r05's grid stage launched no frame_mel")
    missing = RA.missing_clips(RA.pygame_data_dir())
    if missing:
        log(f"round5: pygame's clips are absent ({', '.join(missing)}): the gate's stage 2 "
            "(real_audio_check) and its verdict were not run on the card")
        if r.returncode == 0 or not all(n in gate_out for n in missing):
            misses.append(f"retrain_gate_r05 without clips exited {r.returncode}:\n"
                          f"{gate_out[-2000:]}")
    elif r.returncode != 0 or not os.path.exists(os.path.join(wd, "RETRAIN_GATE_r05.json")):
        misses.append(f"retrain_gate_r05 exited {r.returncode}:\n{gate_out[-2000:]}")
    else:
        launches["retrain_gate_r05 real"] = _stage_launches(wd, "real.log")
        if not launches["retrain_gate_r05 real"]["frame_mel"]:
            misses.append("retrain_gate_r05's real-audio stage launched no frame_mel")

    seconds = time.perf_counter() - t_phase
    log(f"round5 phase: {seconds:.1f} s (budget {R5_BUDGET_S:.0f} s; parts, side by side "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + f") | {smi}")
    if misses:
        for d, _dirs, files in os.walk(fw):
            for f in sorted(files):
                if f.endswith(".log"):
                    with open(os.path.join(d, f)) as fh:
                        log(f"--- {os.path.relpath(os.path.join(d, f), fw)} (tail)\n"
                            + "".join(fh.readlines()[-15:]))
        raise AssertionError("round5 phase: " + "; ".join(misses))
    shutil.rmtree(fw)
    return launches


# ---------------------------------------------------------------------------
# slice 10: the chunk journal, file concurrency, doctor
def _count_programs(engine, kill_after=None):
    """Wraps ``engine._program``: returns the call list; raises after
    ``kill_after`` calls.  ``del engine._program`` unwraps it."""
    program, calls = type(engine)._program.__get__(engine), []

    def wrapped(*a, **k):
        if kill_after is not None and len(calls) >= kill_after:
            raise RuntimeError("simulated preemption")
        calls.append(1)
        return program(*a, **k)

    engine._program = wrapped
    return calls


def phase_journal(work: str, wav: str, smi: str) -> int:
    """The 30-minute WAV (12 chunks) with the trained weights, fused fast
    mode: warm rates without a journal and with a save every 1 and 4
    chunks; killed after 5 chunks and resumed: 7 programs, the grid and
    intervals bit-equal, the sidecar cleared.  A journal that the CPU wrote
    is discarded on the card.  Returns K1's launches in the journaled run."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine

    t_phase = time.perf_counter()
    jd = os.path.join(work, "journal")
    shutil.rmtree(jd, ignore_errors=True)
    rates, results, k1 = {}, {}, 0
    for every in (0, 1, 4) * 3:  # three turns
        det = Detector(Config().with_engine(chunk_checkpoint_every=every))
        det.detect_file_streaming(wav, journal_dir=jd if every else None)  # warm
        res, wall, stages, launches, _c = _timed_detect(det, wav, jd if every else None)
        rates.setdefault(every, []).append(1800.0 / wall)
        results[every] = res
        if every == 1:
            k1 = launches.get("frame_mel", 0)
        log(f"journal every={every}: audio_sec_per_wall_sec={rates[every][-1]:.2f} "
            f"wall_s={wall:.4f} checkpoint_s={stages.get('checkpoint', 0.0):.4f} "
            f"final_fetch_s={stages.get('final_fetch', 0.0):.4f} "
            f"launches={json.dumps(launches)} | {smi}")
        if os.path.isdir(jd) and os.listdir(jd):
            raise AssertionError("a finished run left its journal behind")
    log("journal medians (range): " + "; ".join(
        f"every={e} {np.median(r):.2f} ({min(r):.2f}-{max(r):.2f}), "
        f"{np.median(r) / np.median(rates[0]):.2f}x none" for e, r in rates.items())
        + f" | {smi}")
    base = results[0]
    for every in (1, 4):
        if not (np.array_equal(results[every].avg_values, base.avg_values)
                and results[every].intervals == base.intervals):
            raise AssertionError(f"the journaled run (every={every}) changed the grid")
    det = Detector(Config().with_engine(chunk_checkpoint_every=1))
    engine = get_fused_engine(det, 32000, "i16")
    n_chunks = -(-base.num_windows // engine.chunk_w)
    if n_chunks != 12:
        raise AssertionError(f"the 30-minute WAV has {n_chunks} chunks, not 12")
    _count_programs(engine, kill_after=5)
    try:
        det.detect_file_streaming(wav, journal_dir=jd)
        raise AssertionError("the killed run did not stop")
    except RuntimeError as e:
        if "simulated preemption" not in str(e):
            raise
    finally:
        del engine._program
    sidecars = os.listdir(jd)
    calls = _count_programs(engine)
    try:
        res, wall, stages, _l, _c = _timed_detect(det, wav, jd)
    finally:
        del engine._program
    eq = np.array_equal(res.avg_values, base.avg_values) and res.intervals == base.intervals
    log(f"journal resume: sidecar after the kill {sidecars}; programs on resume "
        f"{len(calls)} of {n_chunks} (expect 7); grid and intervals bit-equal={eq}; "
        f"resumed wall_s={wall:.4f} (uninterrupted, median: "
        f"{1800.0 / np.median(rates[1]):.4f} with the journal, "
        f"{1800.0 / np.median(rates[0]):.4f} without); "
        f"left after success {os.listdir(jd)} | {smi}")
    if len(sidecars) != 1 or len(calls) != 7 or not eq or os.listdir(jd):
        raise AssertionError("the journaled resume on the card is not the uninterrupted run")
    # a journal the CPU wrote: same weights and knobs, device "cpu"
    eng = dict(precision="parity", device_batch=8, chunk_seconds=6.0, pipeline="fused",
               chunk_checkpoint_every=1)
    short = os.path.join(work, "journal_cpu.wav")
    _field_wav(short, 20.0, 32000, seed=41)
    cpu = Detector(Config().with_engine(**eng), device="cpu")
    cpu_engine = get_fused_engine(cpu, 32000, "i16")
    _count_programs(cpu_engine, kill_after=1)
    try:
        cpu.detect_file_streaming(short, journal_dir=jd)
        raise AssertionError("the killed CPU run did not stop")
    except RuntimeError as e:
        if "simulated preemption" not in str(e):
            raise
    finally:
        del cpu_engine._program
    written = os.listdir(jd)
    card = Detector(Config().with_engine(**eng))
    card_engine = get_fused_engine(card, 32000, "i16")
    calls = _count_programs(card_engine)
    try:
        res = card.detect_file_streaming(short, journal_dir=jd)
    finally:
        del card_engine._program
    n_short = -(-res.num_windows // card_engine.chunk_w)
    log(f"journal across devices: the CPU left {written}; the card ran {len(calls)} of "
        f"{n_short} programs (all: not resumed), left {os.listdir(jd)}")
    if len(written) != 1 or len(calls) != n_short or os.listdir(jd):
        raise AssertionError("the card resumed a journal that the CPU wrote")
    os.remove(short)
    log(f"journal phase: {time.perf_counter() - t_phase:.1f} s")
    return k1


def phase_concurrency(work: str, smi: str) -> None:
    """``DetectRunner`` with the trained weights at file_concurrency K = 1,
    2, 4 on two traffics: eight 5-minute 32 kHz WAVs (seeds 51-58; the
    card-bound warm fused path) and eight copies of one 120 s 32 kHz FLAC
    (the host-bound path: one decoder thread a file).  Three turns of K = 1,
    2, 4 each: every CSV byte-identical to K = 1's (file names aside), and
    the aggregate audio-s/wall-s of each run with each K's median and
    range."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.io import wavio
    from softspoken_tpu_torch.project import DetectionStore
    from softspoken_tpu_torch.runtime import DetectRunner

    t_phase = time.perf_counter()
    work = os.path.join(work, "concurrency")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    wavs = [os.path.join(work, f"conc_{s}.wav") for s in range(51, 59)]
    for s, p in enumerate(wavs, start=51):
        _field_wav(p, 300.0, 32000, seed=s)
    x16 = np.clip(np.rint(_field_signal(120.0, 32000, seed=59) * 32768), -32768, 32767
                  ).astype(np.int16)
    flacs = [os.path.join(work, f"conc_{i}.flac") for i in range(8)]
    _flac_ref().write_flac(flacs[0], x16, 32000, bits=16)
    for p in flacs[1:]:
        shutil.copyfile(flacs[0], p)
    del x16
    wavio.write(os.path.join(work, "warm.wav"), np.zeros(32000 * 20, np.float32), 32000,
                subtype="PCM_16")
    for traffic, paths, seconds in (("wav", wavs, 8 * 300.0), ("flac", flacs, 8 * 120.0)):
        ref, rates = None, {}
        for rep_i in range(3):
            for k in (1, 2, 4):
                cfg = Config().with_engine(file_concurrency=k)
                det = Detector(cfg)
                det.detect_file_streaming(os.path.join(work, "warm.wav"))  # warm
                csv_path = os.path.join(work, f"{traffic}_k{k}_{rep_i}.csv")
                rep = DetectRunner(det, DetectionStore(csv_path), cfg).run(paths)
                if rep.errors or rep.files_done != len(paths):
                    raise AssertionError(f"concurrency {traffic} K={k}: files done "
                                         f"{rep.files_done}, errors {rep.errors}")
                with open(csv_path, "rb") as f:
                    got = f.read()
                ref = got if ref is None else ref
                wall = rep.throughput["wall_seconds"]
                rates.setdefault(k, []).append(seconds / wall)
                log(f"concurrency {traffic} K={k} run {rep_i}: aggregate "
                    f"audio_sec_per_wall_sec={rates[k][-1]:.2f} wall_s={wall:.4f} "
                    f"csv bytes={len(got)} equal to K=1's={got == ref} | {smi}")
                if got != ref:
                    raise AssertionError(f"{traffic} file_concurrency={k} wrote another "
                                         "CSV than K=1")
        log(f"concurrency {traffic} medians (range): " + "; ".join(
            f"K={k} {np.median(r):.2f} ({min(r):.2f}-{max(r):.2f}), "
            f"{np.median(r) / np.median(rates[1]):.2f}x K=1" for k, r in rates.items())
            + f" | {smi}")
    shutil.rmtree(work)
    log(f"concurrency phase: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# slice 11: the first detect of a process, `bench`, and the Qt app on the card
def first_detect(mode: str, wav: str) -> int:
    """One case of the first-detect measurement, run as this script's
    subprocess: the trained weights, fused, and the first detect of the
    process on ``wav``, either ``Detector.detect_file_streaming`` on the
    main thread ("inline") or ``DetectRunner`` at K = 1, whose detection
    runs on a worker thread ("runner").  Prints one JSON line."""
    import tempfile

    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.project import DetectionStore
    from softspoken_tpu_torch.runtime import DetectRunner, StageTimers

    cfg = Config()
    det = Detector(cfg)
    torch.cuda.synchronize()
    if mode == "inline":
        timers = StageTimers()
        t0 = time.perf_counter()
        res = det.detect_file_streaming(wav, timers=timers)
        wall = time.perf_counter() - t0
        stages, audio = timers.summary(), res.audio_seconds
    elif mode == "runner":
        with tempfile.TemporaryDirectory() as d:
            rep = DetectRunner(det, DetectionStore(os.path.join(d, "d.csv")), cfg).run([wav])
        if rep.errors or rep.files_done != 1:
            raise AssertionError(f"first detect through DetectRunner: {rep.errors}")
        stages, audio = rep.timers, rep.throughput["audio_seconds"]
        wall = rep.throughput["wall_seconds"]
    else:
        raise ValueError(f"unknown first-detect mode {mode!r}")
    print(json.dumps({"mode": mode, "audio_sec_per_wall_sec": audio / wall,
                      "wall_seconds": wall, "stage_seconds": stages}), flush=True)
    return 0


def phase_first_detect(wav: str, smi: str) -> None:
    """The first fused detect of a process, inline against DetectRunner at
    K = 1 on a worker thread: one subprocess per case, each its first
    detect, on the 30-minute WAV with the trained weights."""
    for mode in ("inline", "runner", "inline", "runner"):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--first-detect",
                            mode, wav], cwd=HERE, capture_output=True, text=True,
                           timeout=600, env=dict(os.environ, PYTHONPATH=HERE))
        if r.returncode != 0:
            raise AssertionError(f"first detect ({mode}): {r.stderr[-2000:]}")
        got = json.loads(r.stdout.strip().splitlines()[-1])
        st = got["stage_seconds"]
        log(f"first detect {mode}: audio_sec_per_wall_sec={got['audio_sec_per_wall_sec']:.2f} "
            f"wall_s={got['wall_seconds']:.3f} dispatch={st.get('dispatch', 0.0):.3f} "
            f"stage_seconds={json.dumps({k: round(v, 3) for k, v in st.items()})} | {smi}")


def bench_payload_keys(path: str) -> "tuple[set, set]":
    """A bench script's JSON keys, read from its source (not imported):
    those of the dicts given to ``payload.update`` (every run prints them)
    and those assigned as ``payload[...]`` (printed when their phase runs)."""
    import ast

    always, assigned = set(), set()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update" and getattr(node.func.value, "id", "") == "payload"):
            always |= {k.value for k in node.args[0].keys}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and getattr(t.value, "id", "") == "payload":
                    assigned.add(t.slice.value)
    return always, assigned


def phase_bench(work: str, warm_rate: float, smi: str) -> dict:
    """``python -m softspoken_tpu_torch bench --seconds 1800`` in a subprocess
    (BENCH_REPEATS=3, the last repeat traced): its line holds every JAX key
    plus ``device``, its mfu is value x flops_per_audio_second() / the
    card's peak, the wire is i16, the device-only rate is positive, the
    trace names K1's kernel and the annotated span, and the best of three
    repeats reaches 0.75 of phase 3's warm fused rate.  Then, in this
    process, K1's launches over one timed repeat's detect (the bench's
    config and WAV) and over one ``device_only_rate`` call."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
    from softspoken_tpu_torch.runtime.metrics import device_peak_flops, flops_per_audio_second

    t_phase = time.perf_counter()
    bdir = os.path.join(work, "bench")
    shutil.rmtree(bdir, ignore_errors=True)
    trace_dir = os.path.join(bdir, "trace")
    os.makedirs(trace_dir)
    env = dict(os.environ, PYTHONPATH=HERE, TMPDIR=bdir, BENCH_REPEATS="3",
               BENCH_TRACE=trace_dir)
    r = subprocess.run([sys.executable, "-m", "softspoken_tpu_torch", "bench", "--seconds",
                        "1800"], cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise AssertionError(f"bench exited {r.returncode}: {r.stderr[-3000:]}")
    lines = r.stdout.strip().splitlines()
    log("bench line:", lines[-1])
    line = json.loads(lines[-1])
    always, assigned = bench_payload_keys(os.path.join(HERE, "bench.py"))
    missing = sorted((always | {"multifile_rate", "multifile_k", "multifile_stats"})
                     - set(line))
    extra = sorted(set(line) - always - assigned - {"device"})
    peak = device_peak_flops()
    want_mfu = line["value"] * flops_per_audio_second() / peak
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    text = ""
    for t in traces:
        with open(t, encoding="utf-8") as f:
            text += f.read()
    k1_named = "mel_core_kernel" in text and "WindowLoader" in text
    span_named = '"bench.detect_file_streaming"' in text
    checks = {
        "every JAX key and device": not missing and line.get("device") == smi,
        "no other key": not extra,
        "mfu = value x flops / peak": abs(line["mfu"] - want_mfu) <= 1e-6,
        "wire_codec i16": line["wire_codec"] == "i16",
        "device_only > 0": line["device_only"] > 0,
        "trace names K1 and an annotate span": bool(traces) and k1_named and span_named,
        "value >= 0.75 x phase 3's warm rate": line["value"] >= 0.75 * warm_rate,
    }
    log(f"bench: value={line['value']} mfu={line['mfu']:.6f} (want {want_mfu:.6f}, peak "
        f"{peak:.4g}) device_only={line['device_only']} device_only_mfu="
        f"{line['device_only_mfu']:.6f} warm rate of phase 3={warm_rate:.2f} "
        f"(x{line['value'] / warm_rate:.3f}) multifile_rate={line.get('multifile_rate')} "
        f"trace files={len(traces)} bytes={len(text)} missing={missing} extra={extra} "
        f"checks={json.dumps(checks)} | {smi}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("bench phase: " + "; ".join(failed))

    det = Detector(Config().with_engine(device_batch=128, chunk_seconds=150),
                   state_dict=fixture_state_dict(seed=0))
    det.detect_file_streaming(os.path.join(bdir, "softspoken_bench", "warm.wav"))
    reset_launch_counts()
    torch.cuda.synchronize()
    det.detect_file_streaming(os.path.join(bdir, "softspoken_bench", "bench_1800s.wav"))
    torch.cuda.synchronize()
    per_repeat = dict(KERNEL_LAUNCHES)
    dev_det = Detector(Config().with_engine(device_batch=128, chunk_seconds=600),
                       state_dict=fixture_state_dict(seed=0))
    eng = get_fused_engine(dev_det, 32000, "i16")
    eng.device_only_rate(repeats=1)
    reset_launch_counts()
    torch.cuda.synchronize()
    eng.device_only_rate()
    torch.cuda.synchronize()
    device_only = dict(KERNEL_LAUNCHES)
    log(f"bench launches: one timed repeat's detect {json.dumps(per_repeat)}, one "
        f"device_only_rate() call {json.dumps(device_only)} | "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if not per_repeat.get("frame_mel") or not device_only.get("frame_mel"):
        raise AssertionError("the bench's paths did not launch frame_mel")
    shutil.rmtree(bdir)
    return {"launches_bench_repeat": per_repeat["frame_mel"],
            "launches_bench_device_only": device_only["frame_mel"]}


def phase_gui(work: str, smi: str) -> int:
    """The Qt app under the port's headless shim on the card: a project of
    two 5-minute WAVs, the detector screen's start (K1 counted), the review
    spectrogram saved as a screenshot, one row graded "erase", the silence
    screen; and ``python -m softspoken_tpu_torch gui --smoke --screenshot``
    on that project.  The GUI's detections CSV must be byte-identical to
    ``detect``'s on the same files and config, the PNGs non-empty, each
    erased sample 0 and every other sample the input's."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.io import wavio
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
    from softspoken_tpu_torch.project import read_csv
    from softspoken_tpu_torch.project.table import to_number
    from softspoken_tpu_torch.ui.qt_shim import install

    t_phase = time.perf_counter()
    gdir = os.path.join(work, "gui")
    shutil.rmtree(gdir, ignore_errors=True)
    os.makedirs(gdir)
    wavs = [os.path.join(gdir, f"gui_{s}.wav") for s in (61, 62)]
    for s, p in zip((61, 62), wavs):
        _field_wav(p, 300.0, 32000, seed=s)
    install(force=True)
    from PySide6.QtWidgets import QApplication, QFileDialog, QInputDialog

    from softspoken_tpu_torch.ui import qt_app

    pdir = os.path.join(gdir, "projects")
    QApplication.instance() or QApplication([])
    win = qt_app.SoftspokenApp(Config().with_paths(project_dir=pdir))
    win.show()
    QInputDialog.getText = staticmethod(lambda *a, **k: ("gui", True))
    QFileDialog.getOpenFileNames = staticmethod(lambda *a, **k: (wavs, ""))
    win.new_project()
    win.workspace.add_files()
    files = win.pm.get_unprocessed_list()
    win.show_detector()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    win.detector.start_btn.click()
    torch.cuda.synchronize()
    t_detect = time.perf_counter() - t0
    launches = dict(KERNEL_LAUNCHES)
    if not win.detector.log.text().startswith(f"done: {len(wavs)} file(s)"):
        raise AssertionError(f"gui detect: {win.detector.log.text()}")
    if not launches.get("frame_mel"):
        raise AssertionError("the detector screen did not launch frame_mel")
    gui_csv = win.pm.current_project["detections_file"]
    cli_csv = os.path.join(gdir, "cli_detections.csv")
    _cli(["detect", "--files", *files, "--out", cli_csv], "detect", {})
    with open(gui_csv, "rb") as a, open(cli_csv, "rb") as b:
        gui_bytes, cli_bytes = a.read(), b.read()

    win.show_review()
    shot = os.path.join(gdir, "review.png")
    pix = win.review.image.pixmap()
    if pix is None or not pix.save(shot):
        raise AssertionError(f"the review spectrogram did not render: {win.review.image.text()}")
    win.review.table.selectRow(0)
    win.review.erase()
    outdir = os.path.join(gdir, "silenced")
    QFileDialog.getExistingDirectory = staticmethod(lambda *a, **k: outdir)
    win.show_silence()
    win.silence.start()
    info = win.silence.info.text()
    win.close()

    shot2 = os.path.join(gdir, "smoke.png")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "softspoken_tpu_torch", "--project-dir", pdir,
                        "gui", "--smoke", "--screenshot", shot2], cwd=HERE, capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=HERE))
    t_smoke = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"gui --smoke exited {r.returncode}: {r.stderr[-2000:]}")

    review = read_csv(win.pm.current_project["review_file"])
    erase = {}
    for row in review.rows:
        if to_number(row["erase"]) == 1:
            erase.setdefault(os.path.join(row["file_path"], row["file_name"]), []).append(
                (float(row["start_time"]), float(row["end_time"])))
    samples_ok = len(erase) == 1 and info == "done: 1 silenced file(s)"
    for f, ivs in erase.items():
        raw, inf = wavio.read_raw(f)
        x = raw.view("<i2")
        out = os.path.join(outdir, os.path.splitext(os.path.basename(f))[0] + "_silenced.wav")
        raw, inf2 = wavio.read_raw(out)
        got = raw.view("<i2")
        mask = _erase_mask(len(x), inf.samplerate, ivs)
        samples_ok &= (inf2.samplerate == inf.samplerate and len(got) == len(x)
                       and bool(np.all(got[mask] == 0))
                       and bool(np.array_equal(got[~mask], x[~mask])) and bool(mask.any()))
    pngs = {p: os.path.getsize(p) if os.path.exists(p) else 0 for p in (shot, shot2)}
    pngs_ok = all(n > 0 and open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
                  for p, n in pngs.items())
    n_rows = gui_bytes.count(b"\n") - 1
    log(f"gui: detector screen {t_detect:.3f} s for {len(files)} x 300 s "
        f"({len(files) * 300.0 / t_detect:.2f} audio-s/wall-s), launches={json.dumps(launches)}, "
        f"csv bytes={len(gui_bytes)} rows={n_rows} equal to detect's="
        f"{gui_bytes == cli_bytes}; screenshot bytes={pngs[shot]}, gui --smoke "
        f"{t_smoke:.1f} s screenshot bytes={pngs[shot2]}; silence: {info!r}, erased rows="
        f"{sum(len(v) for v in erase.values())}, samples held={samples_ok} | "
        f"phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    if gui_bytes != cli_bytes:
        raise AssertionError("the GUI's detections CSV differs from detect's")
    if not pngs_ok:
        raise AssertionError(f"a screenshot is missing or empty: {pngs}")
    if not samples_ok:
        raise AssertionError("the GUI's silenced WAV does not hold the erased samples")
    shutil.rmtree(gdir)
    return launches["frame_mel"]


def phase_doctor() -> None:
    """The port's ``doctor``: ``device`` and ``kernels`` must be ok."""
    import contextlib
    import io

    from softspoken_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["doctor", "--device-timeout", "300"])
    report = json.loads(buf.getvalue())
    log("doctor:", json.dumps({k: report[k] for k in ("device", "kernels", "summary")}),
        "exit", rc)
    if rc != 0 or report["device"]["status"] != "ok" or report["kernels"]["status"] != "ok":
        raise AssertionError("doctor reports the card or the kernels as failed")


# ---------------------------------------------------------------------------
# slice 12: the host trainer from recordings, and the MP3/Ogg/Opus readers
FIT_AUGS = ("add_reverb", "reduce_volume", "bandpass_filter", "change_speed", "change_pitch")
# card against CPU on the same clips and parameters, relative to the peak:
# the pointwise augmentations round the same operations (an ulp of
# exp/pow), the filters go through cuFFT against pocketfft
AUG_TOL = {"bandpass_filter": 1e-4, "add_reverb": 1e-5, "add_echo": 1e-5, "gain_ramp": 1e-5}
AUG_TOL_POINTWISE = 1e-5
# change_speed's phase vocoder carries each bin's phase into its later
# frames, so the phase of a near-silent bin, which two FFT libraries round
# differently, moves the loud frames after it: speech with pauses differs
# by up to ~1e-2 of the peak between the card and the CPU, a different
# but equally valid stretch.  It is held on noise and a tone (every bin
# loud), where only the running sum's order differs, and its vocoder on
# the CPU's STFT, where a phase advance on the ±π cut may flip (a share of
# at most 1e-5 of the values, as tests/test_torch_augment.py holds it)
SPEED_TOL = 2e-3
# build_batch's mels, card against CPU, mel pinned to "highest", with every
# augmentation of FIT_AUGS but change_speed (above)
BATCH_MEL_TOL = 5e-3
# card-vs-CPU comparisons of each augmentation within one run
AUG_REPEATS = 3


def _digest(data) -> str:
    """The first 16 hex digits of the SHA-256 of an array's or bytes'
    contents: two runs that print the same digest had the same input."""
    raw = data if isinstance(data, bytes) else np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def _fit_corpora(root: str) -> "tuple[str, str]":
    """16 speech and 16 noise WAVs from ``train/synth.py``: 10 s at 22,050
    Hz, a quarter of each at 44.1 kHz (the resampler), and 4 noise files of
    2 s (the tiling of short noise)."""
    from softspoken_tpu_torch.io import wavio
    from softspoken_tpu_torch.train import synth

    rng = np.random.default_rng(12)
    dirs = (os.path.join(root, "speech"), os.path.join(root, "noise"))
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    for i in range(16):
        sr = 44100 if i < 4 else 22050
        x, _active = synth.synth_speech(rng, 10 * sr)
        wavio.write(os.path.join(dirs[0], f"s{i:02d}.wav"), x, sr, subtype="PCM_16")
        seconds = 2 if 4 <= i < 8 else 10
        y = synth.synth_environment(rng, seconds * sr)
        wavio.write(os.path.join(dirs[1], f"n{i:02d}.wav"), y, sr, subtype="PCM_16")
    return dirs


def fit_card_vs_cpu(speech: np.ndarray, noise: np.ndarray, smi: str) -> None:
    """Each augmentation on the card against the CPU on the same clips and
    parameters (change_speed as SPEED_TOL says), then ``build_batch`` on
    both devices from one numpy seed (the same SNRs and per-row
    parameters), mel pinned to "highest"."""
    from softspoken_tpu_torch.train import augment as aug
    from softspoken_tpu_torch.train.data import build_batch

    x = speech[:4] + 0.3 * noise[:4]
    rng = np.random.default_rng(9)
    loud = rng.normal(0, 0.2, x.shape).astype(np.float32)
    loud[1] = 0.4 * np.sin(2 * np.pi * 500 * np.arange(x.shape[1]) / 22050)
    g = torch.Generator()
    g.manual_seed(5)
    names = list(aug.PARAM_RANGES)
    log(f"augmentation inputs: speech {_digest(speech)} noise {_digest(noise)} "
        f"mix {_digest(x)} noise-and-tone {_digest(loud)}")
    worst = {}
    bad = []
    for name, params in zip(names, aug.get_parameters(g, names)):
        clip = loud if name == "change_speed" else x
        tol = SPEED_TOL if name == "change_speed" else AUG_TOL.get(name, AUG_TOL_POINTWISE)
        # three comparisons, each side from a fresh copy of the input: each
        # side must repeat bit for bit, and each comparison hold
        cpus, cards, errs = [], [], []
        for _ in range(AUG_REPEATS):
            cpu = aug.FUNC_MAP[name](torch.from_numpy(clip.copy()), **params)
            card = aug.FUNC_MAP[name](torch.from_numpy(clip.copy()).cuda(), **params).cpu()
            diff = (card - cpu).abs()
            errs.append(float(diff.max() / cpu.abs().max()))
            if not errs[-1] <= tol:
                i = int(diff.argmax())
                bad.append(f"{name}: {errs[-1]:.3g} of the peak {float(cpu.abs().max()):.4g} "
                           f"({params}); worst at input {float(clip.reshape(-1)[i])!r}: card "
                           f"{float(card.reshape(-1)[i])!r} cpu {float(cpu.reshape(-1)[i])!r}")
            cpus.append(cpu)
            cards.append(card)
        if not all(torch.equal(c, cpus[0]) for c in cpus[1:]):
            bad.append(f"{name}: the CPU does not repeat on the same input")
        if not all(torch.equal(c, cards[0]) for c in cards[1:]):
            bad.append(f"{name}: the card does not repeat on the same input")
        worst[name] = max(errs)
        log(f"augmentation {name}: clips {_digest(clip)} params "
            f"{_digest(json.dumps(params, sort_keys=True).encode())} "
            f"max |card - cpu| / peak per repeat {errs}")
    if bad:
        raise AssertionError("augmentations on the card differ from the CPU: " + "; ".join(bad))
    spec = aug._stft(torch.from_numpy(x))
    n_frames = spec.shape[-2]
    for sf in (0.8, 1.2):
        out_frames = n_frames if sf >= 1.0 else int(np.ceil((n_frames - 1) / sf)) + 1
        cpu = aug._phase_vocoder(spec, sf, out_frames=out_frames)
        card = aug._phase_vocoder(spec.cuda(), sf, out_frames=out_frames).cpu()
        off = float(((card - cpu).abs() > 1e-3 * cpu.abs().max()).float().mean())
        worst[f"phase_vocoder_{sf}_share_off"] = off
        if off > 1e-5:
            raise AssertionError(f"the phase vocoder at {sf} on the card: {off:.3g} of "
                                 f"the values off by more than 1e-3 of the peak")
    log("augmentations card vs CPU, max |diff| / peak: "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    augs = tuple(a for a in FIT_AUGS if a != "change_speed")
    got = build_batch(speech[:4], noise[:4], np.random.default_rng(7), augs,
                      device="cuda", mel_mode="highest")
    want = build_batch(speech[:4], noise[:4], np.random.default_rng(7), augs,
                       device="cpu", mel_mode="highest")
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in ("mel", "spec")}
    mask_diff = float((got["mask"].cpu() != want["mask"]).float().mean())
    log(f"build_batch card vs CPU (B=4, {', '.join(augs)}, mel highest): "
        f"max |diff| mel {errs['mel']:.3g} spec {errs['spec']:.3g}, mask frames differing "
        f"{mask_diff:.4f} | {smi}")
    if max(errs.values()) > BATCH_MEL_TOL or mask_diff > 0.01:
        raise AssertionError(f"build_batch on the card differs from the CPU: {errs}, "
                             f"mask {mask_diff}")


def phase_fit(work: str, wav60: str, smi: str) -> dict:
    """Slice 12: ``python -m softspoken_tpu_torch train --speech-dir
    --noise-dir`` (the CLI in process, its default flags) on the card: 23
    steps of the full SpecUNet_2D at B = 16 with FIT_AUGS; steps/s and
    clips/s after 3 warm steps, first and last loss, peak memory; the
    kernel counters (fit runs none of K1-K3).  The steps are timed by a
    wrapper of ``fit``'s ``train_step`` that synchronizes the card after
    steps 1, 3 and 23 only; the metrics are read where the CLI reads them.  Then the per-step host split
    (reads + resample, augmentation, mel) and the train step's ms over 5
    synchronized steps after 3 warm ones; the card against the CPU; the
    checkpoint in ``Detector`` on the 60 s WAV."""
    import contextlib
    import io

    from softspoken_tpu_torch import cli
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
    from softspoken_tpu_torch.train.data import build_batch
    from softspoken_tpu_torch.train import fit as fit_mod
    from softspoken_tpu_torch.train.fit import ClipSampler, list_wavs
    from softspoken_tpu_torch.train.loop import create_train_state, train_step

    t_phase = time.perf_counter()
    speech_dir, noise_dir = _fit_corpora(os.path.join(work, "fit"))
    pth = os.path.join(work, "fit", "fit.pth")
    argv = ["train", "--speech-dir", speech_dir, "--noise-dir", noise_dir, "--steps", "23",
            "--batch-size", "16", "--augment", *FIT_AUGS, "--out", pth]
    log("fit: python -m softspoken_tpu_torch " + " ".join(argv))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    stamps, first_loss, count = {}, [], [0]
    real_step = fit_mod.train_step

    def timed_step(state, batch, *args):
        m = real_step(state, batch, *args)
        count[0] += 1
        if count[0] in (1, 3, 23):
            torch.cuda.synchronize()
            stamps[count[0]] = time.perf_counter()
        if count[0] == 1:
            first_loss.append(float(m["loss"]))
        return m

    buf = io.StringIO()
    fit_mod.train_step = timed_step
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
    finally:
        fit_mod.train_step = real_step
    torch.cuda.synchronize()
    launches = dict(KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    if rc != 0 or len(lines) != 1 or count[0] != 23:
        raise AssertionError(f"train --speech-dir failed: rc {rc}, {count[0]} steps, "
                             f"{len(lines)} output lines")
    final = lines[0]
    steps_per_s = 20 / (stamps[23] - stamps[3])
    log(f"fit (B=16, 23 steps, full SpecUNet_2D): steps/s={steps_per_s:.3f} "
        f"clips/s={16 * steps_per_s:.1f} after 3 warm steps; first 3 steps "
        f"{stamps[3] - t0:.3f} s; command wall {wall:.3f} s; peak "
        f"max_memory_allocated={peak / 2**30:.3f} GiB; loss first {first_loss[0]:.5f} "
        f"last {final['loss']:.5f} | {smi}")
    log("fit kernel launches:", json.dumps(launches))
    if not all(np.isfinite(v) for v in [first_loss[0], *final.values()]):
        raise AssertionError("fit: a loss is not finite")
    if any(launches.get(k, 0) for k in KERNELS):
        raise AssertionError("the host trainer launched a mel or wire kernel")

    # the host batch's split, synchronized at each boundary
    rng = np.random.default_rng(1)
    speech = ClipSampler(list_wavs(speech_dir), rng, tile_short=False)
    noise = ClipSampler(list_wavs(noise_dir), rng, tile_short=True)
    state = create_train_state(0, device="cuda")
    split = {"read": [], "augment": [], "mel": [], "step": []}
    for i in range(8):
        t = time.perf_counter()
        sb, nb = speech.batch(16), noise.batch(16)
        t_read = time.perf_counter() - t
        tm = {}
        batch = build_batch(sb, nb, rng, FIT_AUGS, device="cuda", timings=tm)
        t = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        if i >= 3:
            for k, v in (("read", t_read), ("augment", tm["augment"]), ("mel", tm["mel"]),
                         ("step", time.perf_counter() - t)):
                split[k].append(1e3 * v)
    med = {k: float(np.median(v)) for k, v in split.items()}
    log("fit per step, median of 5 after 3 warm (ms): "
        f"reads+resample {med['read']:.2f}, augmentation {med['augment']:.2f}, "
        f"mel {med['mel']:.2f}, train step {med['step']:.2f}; host share "
        f"{(med['read'] + med['augment'] + med['mel']) / sum(med.values()):.3f} | {smi}")
    fit_card_vs_cpu(sb, nb, smi)

    det = Detector(checkpoint_path=pth)
    res = det.detect_file_streaming(wav60)
    log(f"fit checkpoint (epoch {det.epoch}) in Detector on the card ({det.pipeline}): "
        f"windows={res.num_windows} intervals={len(res.intervals)}")
    if det.epoch != 23 or not np.isfinite(res.avg_values).all() or res.num_windows < 1:
        raise AssertionError("the fit checkpoint does not run in Detector")
    log(f"fit phase {time.perf_counter() - t_phase:.1f} s")
    return {k: launches.get(k, 0) for k in KERNELS}


def _ogg_page(body: bytes, flags: int) -> bytes:
    """One Ogg page around ``body`` (CRC left 0: the sniffers parse the
    header only)."""
    lacing = [255] * (len(body) // 255) + [len(body) % 255]
    return (b"OggS\x00" + bytes([flags]) + bytes(8) + (0x5353).to_bytes(4, "little")
            + bytes(8) + bytes([len(lacing)]) + bytes(lacing) + body)


def _codec_stub(path: str, fmt: str) -> str:
    """A file each sniffer routes to its codec reader, for a host where the
    codec's library does not load: an MPEG frame header, an Ogg page with a
    Vorbis identification header, an Ogg BOS page with an OpusHead."""
    head = {
        "mp3": b"\xff\xfb\x90\x64" + bytes(412),
        "vorbis": _ogg_page(b"\x01vorbis" + bytes(23), 0x02),
        "opus": _ogg_page(b"OpusHead\x01\x01" + (312).to_bytes(2, "little")
                          + (48000).to_bytes(4, "little") + bytes(3), 0x02),
    }[fmt]
    with open(path, "wb") as f:
        f.write(head)
    return path


def phase_codecs(work: str, smi: str, seconds: float = 120.0, device: str = "cuda") -> dict:
    """Slice 12: the MP3, Ogg Vorbis and Opus readers.  For each format
    whose libraries load: a ``seconds`` file from its encoder (32 kHz; Opus,
    whose encoder takes no 32 kHz input, at 48 kHz) and a float32 WAV of its
    decoded samples, trained weights, fused fast mode: the grids bit-equal,
    each rate in audio-s/wall-s.  For each format whose library is absent:
    probe raises the codec's format error naming the library, load_audio
    gives (None, None), detect raises, and ``DetectRunner`` records the file
    and finishes the next one, as the JAX package does on such a host.
    Returns, per format, each kernel's launches over the timed detection
    of its compressed file, or None where its library is absent (nothing
    ran, so nothing was counted)."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.io import audio, mp3, oggvorbis, opus, wavio
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES, reset_launch_counts
    from softspoken_tpu_torch.project import DetectionStore
    from softspoken_tpu_torch.runtime import DetectRunner

    t_phase = time.perf_counter()
    log("codec libraries:", codec_libraries())
    cdir = os.path.join(work, "codecs")
    shutil.rmtree(cdir, ignore_errors=True)
    os.makedirs(cdir)
    formats = (("mp3", mp3, mp3.encoder_available, mp3.Mp3FormatError, "libmpg123"),
               ("vorbis", oggvorbis, oggvorbis.available, oggvorbis.OggFormatError,
                "libvorbis"),
               ("opus", opus, opus.available, opus.OpusFormatError, "libogg + libopus"))
    det = Detector(Config().with_engine(pipeline="fused"), device=device)
    good = os.path.join(cdir, "good.wav")
    _field_wav(good, 10.0, 32000, seed=3)
    launches = {}
    for fmt, mod, can_encode, error, lib in formats:
        launches[fmt] = None
        if mod.available() and can_encode():
            sr = 48000 if fmt == "opus" else 32000
            x = _field_signal(seconds, sr, seed=21)
            path = os.path.join(cdir, f"field.{'ogg' if fmt == 'vorbis' else fmt}")
            {"mp3": lambda: mp3.write_mp3(path, x, sr),
             "vorbis": lambda: oggvorbis.write_vorbis(path, x, sr),
             "opus": lambda: opus.write_opus(path, x, sr)}[fmt]()
            decoded, nsr = audio.read_any(path)
            ref = os.path.join(cdir, f"{fmt}_decoded.wav")
            wavio.write(ref, decoded, nsr, subtype="FLOAT")
            rates = {}
            for p in (path, ref):
                det.detect_file_streaming(p)  # warm
                reset_launch_counts()
                t0 = time.perf_counter()
                res = det.detect_file_streaming(p)
                if device == "cuda":
                    torch.cuda.synchronize()
                rates[p] = (res, res.audio_seconds / (time.perf_counter() - t0))
                if p == path:
                    launches[fmt] = {k: KERNEL_LAUNCHES.get(k, 0) for k in KERNELS}
            (rc, rate_c), (rw, rate_w) = rates[path], rates[ref]
            log(f"codecs {fmt}: {seconds:.0f} s at {sr} Hz, {os.path.getsize(path)} bytes; "
                f"compressed {rate_c:.2f} audio-s/wall-s, its float WAV {rate_w:.2f}; "
                f"grids bit-equal {np.array_equal(rc.avg_values, rw.avg_values)} | {smi}")
            if not np.array_equal(rc.avg_values, rw.avg_values) or rc.intervals != rw.intervals:
                raise AssertionError(f"{fmt}: the fused grid differs from its decoded WAV's")
            continue
        path = _codec_stub(os.path.join(cdir, f"stub.{fmt}"), fmt)
        try:
            audio.probe(path)
            raise AssertionError(f"{fmt}: probe read a file whose library is absent")
        except error as e:
            if "not found" not in str(e):
                raise AssertionError(f"{fmt}: unexpected error {e!r}")
            why = str(e)
        if audio.load_audio(path) != (None, None):
            raise AssertionError(f"{fmt}: load_audio did not fail as a decode failure")
        try:
            det.detect_file_streaming(path)
            raise AssertionError(f"{fmt}: detect ran on a file whose library is absent")
        except error:
            pass
        store = DetectionStore(os.path.join(cdir, f"{fmt}.csv"))
        report = DetectRunner(det, store).run([path, good])
        if report.files_done != 1 or set(report.errors) != {path}:
            raise AssertionError(f"{fmt}: the runner did not record the file and go on: "
                                 f"{report.errors}")
        log(f"codecs {fmt}: {lib} absent — probe and detect raise "
            f"{error.__name__}: {why!r}; "
            f"load_audio (None, None); the runner recorded "
            f"{report.errors[path]!r} and finished the next file; no number claimed")
    log(f"codecs phase {time.perf_counter() - t_phase:.1f} s; kernel launches on each "
        f"compressed file (null: not run): {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------------------
# slice 14: several cards

MESH_GRID_TOL = 1e-5  # float32, TF32 off: convolutions at another batch size round apart


def _last_json(out: str) -> dict:
    """The last indented JSON object a command printed (a detect report)."""
    start = out.rindex("\n{") + 1
    return json.loads(out[start: out.index("\n}", start) + 2])


def mesh_detect_parity(wav: str, devices, smi: str) -> dict:
    """``MeshDetector`` over ``devices`` against one card on ``wav``, in parity
    precision (float32, TF32 off) so that the grid speaks for the sharding:
    the fused path with K1 ("highest"), the host path with K2, and the fused
    path on the adpcm4 wire (K3).  The grids within MESH_GRID_TOL, the
    intervals equal, K1 and K2 launched once per batch per data entry, K3
    once per chunk on the detector's card (the mesh copies the decoded,
    resampled chunk to the other cards), each count set to 0 just before
    its run.  Returns each kernel's launches in its mesh run."""
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.ckpt import fixture_state_dict
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.parallel import MeshDetector, make_mesh

    sd = fixture_state_dict(0)
    n = len(devices)
    out = {}
    # (case, engine options, the kernel it reports, {kernel: mesh launches
    # per one-card launch})
    for name, eng, kernel, per in (
            ("fused", dict(pipeline="fused", mel_kernel="fused"), "frame_mel",
             {"frame_mel": n}),
            ("host", dict(pipeline="host", mel_kernel="pallas"), "dft_mel", {"dft_mel": n}),
            ("adpcm4 wire", dict(pipeline="fused", mel_kernel="fused", upload_codec="adpcm4"),
             "adpcm_decode", {"adpcm_decode": 1, "frame_mel": n})):
        cfg = Config().with_engine(precision="parity", **eng)
        runs = {}
        for label in ("one card", f"mesh x{n}"):
            det = Detector(cfg, state_dict=sd, device="cuda:0")
            if label != "one card":
                MeshDetector(det, make_mesh(("data",), devices=devices))
            res, wall, _st, launches, _c = _timed_detect(det, wav)
            runs[label] = (res, {k: launches.get(k, 0) for k in per}, wall)
        (one, l1, w1), (mesh, ln, wn) = runs.values()
        err = float(np.abs(mesh.avg_values - one.avg_values).max())
        same = mesh.intervals == one.intervals and mesh.num_windows == one.num_windows
        counted = all(l1[k] > 0 and ln[k] == m * l1[k] for k, m in per.items())
        log(f"mesh {name} parity over {[str(d) for d in devices]}: grid max_abs_diff="
            f"{err:.3e} tol={MESH_GRID_TOL:.0e}, intervals equal={same} "
            f"({len(one.intervals)}), launches one card {json.dumps(l1)}, mesh "
            f"{json.dumps(ln)} (expected x{json.dumps(per)}: {counted}); wall one card "
            f"{w1:.3f} s, mesh {wn:.3f} s | {smi}")
        if err > MESH_GRID_TOL or not same or not counted:
            raise AssertionError(f"mesh {name}: the sharded run disagrees with one card")
        out[kernel] = ln[kernel]
    return out


def sharded_step_f64(mesh, rank: int, steps: int = 2, seed: int = 0) -> dict:
    """``steps`` sharded steps of ``make_sharded_train_step`` over ``mesh`` on
    this rank's card in float64, from seeded weights on a seeded global
    batch (B = 2 x data, T = 256, boundary weight 2, dropout 0.1); returns
    the state dict and the metrics."""
    from softspoken_tpu_torch.train import loop

    state = _f64_state(mesh, rank, seed)
    step, shard = loop.make_sharded_train_step(state, mesh, boundary_weight=2.0)
    batch = _f64_batch(2 * mesh.shape["data"], state.device, seed)
    ms = [{k: float(v) for k, v in step(state, shard(batch)).items()} for _ in range(steps)]
    return {"sd": {k: v.cpu() for k, v in state.model.state_dict().items()}, "metrics": ms}


def _f64_state(mesh, rank: int, seed: int):
    from softspoken_tpu_torch.train import loop

    dev = list(mesh.devices.flat)[rank] if mesh is not None else torch.device("cuda", 0)
    model = loop.create_train_state(seed, dropout_p=0.1).model.double().to(dev)
    return loop.TrainState(model, loop.make_optimizer(model), seed=seed)


def _f64_batch(B: int, dev, seed: int) -> dict:
    rng = np.random.default_rng(seed + 100)
    toggles = rng.uniform(size=(B, 256)) > 0.95
    b = {"mel": rng.uniform(0.0, 1.5, (B, 128, 256)),
         "mask": (np.cumsum(toggles, axis=1) % 2).astype(np.float64),
         "spec": rng.uniform(0.0, 1.0, (B, 2, 128, 256))}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def unsharded_step_f64(B: int, steps: int = 2, seed: int = 0) -> dict:
    """The unsharded counterpart of ``sharded_step_f64`` on cuda:0."""
    from softspoken_tpu_torch.train import loop

    state = _f64_state(None, 0, seed)
    batch = _f64_batch(B, state.device, seed)
    ms = [{k: float(v) for k, v in loop.train_step(state, batch, 2.0).items()}
          for _ in range(steps)]
    return {"sd": {k: v.cpu() for k, v in state.model.state_dict().items()}, "metrics": ms}


F64_TOL = 1e-6  # float64: reduction orders only (measured ~1e-11 on the CPU)


def check_f64_steps(label: str, got: dict, want: dict, smi: str) -> float:
    """The sharded float64 steps against the unsharded: every state tensor
    within F64_TOL of its max (relative), the metrics too."""
    worst = max(float((got["sd"][k].double() - v.double()).abs().max()
                      / max(float(v.double().abs().max()), 1e-30))
                for k, v in want["sd"].items() if v.is_floating_point())
    m_err = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got["metrics"], want["metrics"])
                for k in b)
    log(f"{label}: {len(want['metrics'])} float64 steps, sharded vs unsharded: worst state "
        f"tensor rel_diff={worst:.3e}, metrics rel_diff={m_err:.3e}, tol={F64_TOL:.0e}; "
        f"losses {[round(m['loss'], 9) for m in got['metrics']]} | {smi}")
    if worst > F64_TOL or m_err > F64_TOL:
        raise AssertionError(f"{label}: the sharded float64 steps disagree with the unsharded")
    return worst


def adam_rule(before: dict, got: dict, want: dict, lr: float = 1e-3) -> dict:
    """tests/test_torch_parallel_train.py's comparison of two float32 runs:
    each element's movement against the reference's (Adam's first update
    is ±lr for every element whose gradient is not within rounding of 0)."""
    n = half = tenth = 0
    worst = 0.0
    num = den = 0.0
    for k, w in want.items():
        if "running" in k or "num_batches" in k:
            continue
        b = torch.as_tensor(before[k]).double()
        dw = torch.as_tensor(w).double() - b
        d = (torch.as_tensor(got[k]).double() - b - dw).abs()
        worst = max(worst, float(d.max()))
        n += d.numel()
        half += int((d > 0.5 * lr).sum())
        tenth += int((d > 0.1 * lr).sum())
        num += float((d ** 2).sum())
        den += float((dw ** 2).sum())
    return {"max_abs": worst, "frac_half_lr": half / n, "frac_tenth_lr": tenth / n,
            "rel_l2_of_movement": (num / max(den, 1e-30)) ** 0.5}


def phase_mesh(work: str, wav: str, wav60: str, smi: str) -> dict:
    """Slice 14 on one card: (1) a MeshDetector over [cuda:0, cuda:0] on the
    30-minute WAV, fused, host with K2 and the adpcm4 wire
    (``mesh_detect_parity``); (2)
    ``detect --distributed --num-processes 1`` on a project, then ``project
    merge-detections``; (3) ``train --synthetic --mesh`` as a 1 x 1 NCCL
    group for two steps against two unsharded steps (float32: Adam's rule),
    and two float64 sharded steps in a 1 x 1 NCCL group against two
    unsharded ones within F64_TOL."""
    import torch.distributed as dist

    from softspoken_tpu_torch.ckpt import load_pth
    from softspoken_tpu_torch.ops.mel import fp32_matmul
    from softspoken_tpu_torch.parallel import make_mesh
    from softspoken_tpu_torch.parallel.distributed import free_port, init_process_group
    from softspoken_tpu_torch.train.loop import create_train_state

    t0 = time.perf_counter()
    dev0 = torch.device("cuda", 0)
    launches = mesh_detect_parity(wav, [dev0, dev0], smi)

    pdir = os.path.join(work, "mesh_project")
    shutil.rmtree(pdir, ignore_errors=True)
    times: dict = {}
    _cli(["--project-dir", pdir, "project", "new", "M", wav60], "new", times)
    _, out = _cli(["--project-dir", pdir, "detect", "--project", "M", "--random-init",
                   "--distributed", "--num-processes", "1"], "detect --distributed", times)
    report = _last_json(out)
    _, merged = _cli(["--project-dir", pdir, "project", "merge-detections", "M"], "merge", times)
    merged = json.loads(merged.strip().splitlines()[-1])
    log(f"mesh detect --distributed --num-processes 1: files_done={report['files_done']} "
        f"rows_added={report['rows_added']} csv={os.path.basename(report['detections_csv'])}; "
        f"merge-detections {json.dumps({k: merged[k] for k in ('partitions', 'files', 'rows')})}"
        f"; wall s {json.dumps({k: round(v, 3) for k, v in times.items()})}")
    if report["files_done"] != 1 or merged["partitions"] != 0 or dist.is_initialized():
        raise AssertionError("detect --distributed with one process did not run as one process")

    common = ["train", "--synthetic", "--steps", "2", "--batch-size", "8", "--pool-size", "8",
              "--n-inner", "1", "--augment", *TRAIN_AUGS, "--seed", "3"]
    with fp32_matmul():  # TF32 convolutions would round the two runs apart at 1e-3
        _, plain = _cli([*common, "--out", os.path.join(work, "mesh_plain.pth")], "train", times)
        _, meshed = _cli([*common, "--mesh", "--out", os.path.join(work, "mesh_1x1.pth")],
                         "train --mesh", times)
    plain, meshed = (json.loads(o.strip().splitlines()[-1]) for o in (plain, meshed))
    sd, epoch = load_pth(os.path.join(work, "mesh_1x1.pth"))
    rule = adam_rule(create_train_state(3).model.state_dict(), sd,
                     load_pth(os.path.join(work, "mesh_plain.pth"))[0])
    loss_rel = abs(meshed["loss"] - plain["loss"]) / plain["loss"]
    log(f"mesh train --mesh (1 x 1 NCCL group, B=8, two steps, float32, TF32 off) vs train: loss "
        f"{meshed['loss']:.7f} / {plain['loss']:.7f} rel_diff={loss_rel:.2e} (tol 1e-3); "
        f"parameters: relative L2 of the movement {rule['rel_l2_of_movement']:.3e} (tol 0.2), "
        f"max_abs_diff={rule['max_abs']:.3e}, elements off by > 0.5 lr {rule['frac_half_lr']:.2e},"
        f" > 0.1 lr {rule['frac_tenth_lr']:.2e} (Adam's ±lr first update; the float64 check "
        f"below holds the steps exactly); wall s {times['train']:.2f} / "
        f"{times['train --mesh']:.2f} | {smi}")
    if (loss_rel > 1e-3 or rule["rel_l2_of_movement"] > 0.2 or epoch != 2
            or dist.is_initialized()):
        raise AssertionError("train --mesh on one card disagrees with train")

    mesh = make_mesh(("data", "seq"), shape=(1, 1), devices=[dev0])
    init_process_group(f"tcp://localhost:{free_port()}", 1, 0, dev0, timeout_s=300)
    try:
        got = sharded_step_f64(mesh, 0)
    finally:
        dist.destroy_process_group()
    check_f64_steps("mesh 1 x 1 NCCL group", got, unsharded_step_f64(2), smi)
    log(f"mesh phase {time.perf_counter() - t0:.1f} s")
    return launches


# two float32 steps of fit_synthetic at B = 32, compared with TF32 off
SHORT_FIT = dict(steps=2, batch_size=32, n_inner=1, pool_speech=16, pool_noise=16,
                 augmentations=TRAIN_AUGS, seed=0)


def _kernel_ms_by_card(prof) -> dict:
    """Each card's device time (kernels and copies) in a profile, and its
    NCCL kernels' share: {card: {"busy_ms", "nccl_ms", "nccl_kernels"}}."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        d = out.setdefault(int(e.device_index), {"busy_ms": 0.0, "nccl_ms": 0.0,
                                                 "nccl_kernels": 0})
        ms = e.time_range.elapsed_us() / 1e3
        d["busy_ms"] += ms
        if "nccl" in e.name.lower():
            d["nccl_ms"] += ms
            d["nccl_kernels"] += 1
    return out


def profile_mesh_chunk(engine, label: str, smi: str, repeats: int = 4) -> dict:
    """Where a chunk program's time goes, on one card or over a mesh: the
    chunk's wall time (``device_only_rate``, no profiler), the host
    thread's time inside the chunk forward (the sharded forward enqueues
    every card's forwards, the shard and wave copies and the gather to the
    detector's card; it does not wait on a card), and each card's device
    time per chunk under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fwd = engine._forward_chunk
    spent = []

    def timed(wave, starts):
        t = time.perf_counter()
        out = fwd(wave, starts)
        spent.append(time.perf_counter() - t)
        return out

    engine._forward_chunk = timed
    try:
        engine.device_only_rate(repeats=1)  # warm
        spent.clear()
        rate = engine.device_only_rate(repeats=repeats)
        enqueue_ms = 1e3 * float(np.median(spent))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            engine.device_only_rate(repeats=repeats)
    finally:
        engine._forward_chunk = fwd
    chunks = repeats + 1  # device_only_rate runs one program before its clock
    wall_ms = 1e3 * engine.chunk_w * engine.cfg.engine.step_seconds / rate
    cards = {c: round(v["busy_ms"] / chunks, 3) for c, v in
             sorted(_kernel_ms_by_card(prof).items())}
    log(f"mesh-only profile {label}: chunk wall_ms={wall_ms:.3f} (device_only_rate {rate:.2f}), "
        f"host time in the chunk forward {enqueue_ms:.3f} ms "
        f"({100 * enqueue_ms / wall_ms:.1f}% of the wall), device ms per chunk by card "
        f"{json.dumps(cards)} | {smi}")
    return {"wall_ms": wall_ms, "forward_host_ms": enqueue_ms, "device_ms_by_card": cards}


def profile_step(step_fn, dev, reps: int = 5) -> dict:
    """One train step's wall time (the median of ``reps`` synchronized
    steps, no profiler) and, under ``torch.profiler`` over ``reps`` more,
    this card's device time per step and its NCCL kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step_fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        step_fn()
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step_fn()
        torch.cuda.synchronize(dev)
    mine = _kernel_ms_by_card(prof).get(dev.index, {"busy_ms": 0.0, "nccl_ms": 0.0,
                                                    "nccl_kernels": 0})
    return {"wall_ms": 1e3 * float(np.median(walls)), "device_ms": mine["busy_ms"] / reps,
            "nccl_ms": mine["nccl_ms"] / reps, "nccl_kernels": mine["nccl_kernels"] / reps}


def _f32_step(mesh, rank: int, B: int):
    """A float32 train step at phase 5's batch (B rows, T = 256, boundary
    weight 2, dropout 0.1) on this rank's card: sharded over ``mesh``, or
    the unsharded step on cuda:0 when ``mesh`` is None."""
    from softspoken_tpu_torch.train import loop

    dev = list(mesh.devices.flat)[rank] if mesh is not None else torch.device("cuda", 0)
    model = loop.create_train_state(0, dropout_p=0.1).model.to(dev)
    state = loop.TrainState(model, loop.make_optimizer(model), seed=0)
    batch = {k: v.float() for k, v in _f64_batch(B, dev, 0).items()}
    if mesh is None:
        return lambda: loop.train_step(state, batch, 2.0), dev
    step, shard = loop.make_sharded_train_step(state, mesh, boundary_weight=2.0)
    block = shard(batch)
    return lambda: step(state, block), dev


def _mesh_train_worker(rank: int, world: int, init: str, work: str, timed_outer: int) -> None:
    """One rank of the (2, 2) mesh training (``--mesh-only``): two float64
    sharded steps (rank 0 saves them); two ``fit_synthetic`` steps with TF32
    off (``short_fit``); then ``fit_synthetic`` under the mesh at phase 5's
    point (rank 0 saves the metrics per outer call)."""
    import torch.distributed as dist

    from softspoken_tpu_torch.ops.mel import fp32_matmul
    from softspoken_tpu_torch.parallel import make_mesh
    from softspoken_tpu_torch.parallel.distributed import init_process_group
    from softspoken_tpu_torch.train import fit_synthetic

    mesh = make_mesh(("data", "seq"), shape=(world // 2, 2))
    init_process_group(init, world, rank, list(mesh.devices.flat)[rank], timeout_s=300)
    try:
        f64 = sharded_step_f64(mesh, rank)
        if rank == 0:
            torch.save(f64, os.path.join(work, "mesh_f64.pt"))
        prof = profile_step(*_f32_step(mesh, rank, 32))
        with open(os.path.join(work, f"mesh_step_rank{rank}.json"), "w") as f:
            json.dump(prof, f)
        with fp32_matmul():
            fit_synthetic(mesh=mesh, ckpt_out=os.path.join(work, "mesh_short.pth"), **SHORT_FIT)
        seen = []
        fit_synthetic(steps=10 * (1 + timed_outer), batch_size=32, n_inner=10, pool_speech=128,
                      pool_noise=128, augmentations=TRAIN_AUGS, seed=0, mesh=mesh,
                      ckpt_out=os.path.join(work, "mesh_train.pth"), log_every_outer=1,
                      save_every_outer=10 ** 6, on_metrics=lambda step, m: seen.append(m))
        if rank == 0:
            with open(os.path.join(work, "mesh_train.json"), "w") as f:
                json.dump(seen, f)
    finally:
        dist.destroy_process_group()


def mesh_only(smi: str, peaks) -> list:
    """The ``--mesh-only`` run over every visible card (four, as it is run
    on a four-card host), mirroring the JAX package's ``dryrun_multichip``:
    kernels on every card, ``detect --mesh`` against one card with both
    rates, a journal kill/resume under the mesh, a 2-process ``detect
    --distributed`` + merge against one process, and (2, 2) training.
    Returns the kernel records."""
    from softspoken_tpu_torch import Config, cli
    from softspoken_tpu_torch.ckpt import fixture_state_dict, load_pth
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine.fused import get_fused_engine
    from softspoken_tpu_torch.ops.mel import fp32_matmul
    from softspoken_tpu_torch.parallel import MeshDetector, make_mesh
    from softspoken_tpu_torch.parallel import distributed as pdist
    from softspoken_tpu_torch.train import fit_synthetic
    from softspoken_tpu_torch.train.loop import create_train_state

    n = torch.cuda.device_count()
    if n < 2:
        raise AssertionError(f"--mesh-only needs several cards, found {n}")
    devices = [torch.device("cuda", i) for i in range(n)]
    work = os.path.join(HERE, "build", "softspoken_tpu_torch", "smoke_mesh")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    tc = phase_toolchain()
    recs = [phase_frame_mel(peaks), phase_dft_mel(peaks), phase_adpcm(peaks, smi)]
    for rec in recs:
        rec.update(tc[rec["name"]])
    errs = per_card_kernels(devices, smi)
    for rec in recs:
        rec["max_abs_err_per_card"] = errs[rec["name"]]

    sr = 32000
    wav = os.path.join(work, "field_30min_32k.wav")
    _field_wav(wav, 1800.0, sr, seed=11)
    launches = mesh_detect_parity(wav, devices, smi)
    for rec in recs:
        rec["launches"] = launches[rec["name"]]

    # rates: detect (fast, fixture weights) on one card and over every card
    rates = {}
    for label, flags in (("one card", []), (f"mesh x{n}", ["--mesh"])):
        args = cli.build_parser().parse_args(
            ["detect", "--files", wav, "--out", os.path.join(work, f"rate_{len(flags)}.csv"),
             "--random-init", "--strict-reference", *flags])
        cli.cmd_detect(args)  # warm
        warm = cli.cmd_detect(args)
        det = Detector(Config(), state_dict=fixture_state_dict(0))
        if flags:
            MeshDetector(det, make_mesh(("data",)))
        res = det.detect_file_streaming(wav)
        engine = get_fused_engine(det, sr, "i16")
        rate = engine.device_only_rate(repeats=4)
        profile_mesh_chunk(engine, label, smi)
        rates[label] = (warm["audio_sec_per_wall_sec"], rate, res)
        log(f"mesh-only detect {label}: e2e warm audio_sec_per_wall_sec="
            f"{warm['audio_sec_per_wall_sec']:.2f} (per card "
            f"{warm['audio_sec_per_wall_sec_per_chip']:.2f}), device_only_rate={rate:.2f}, "
            f"stage_seconds {json.dumps({k: round(v, 3) for k, v in warm['stage_seconds'].items()})}"
            f" | {smi}")
    (_, _, one), (_, _, mesh_res) = rates.values()
    diff = float(np.abs(mesh_res.avg_values - one.avg_values).max())
    log(f"mesh-only detect fast mode, mesh vs one card: intervals equal="
        f"{mesh_res.intervals == one.intervals}, grid max_abs_diff={diff:.3e} (bf16 convolutions "
        f"at another batch size; the parity-mode check above holds {MESH_GRID_TOL:.0e})")
    if mesh_res.intervals != one.intervals:
        raise AssertionError("detect --mesh changed the intervals")

    # a journal kill and resume under the mesh
    det = Detector(Config().with_engine(chunk_checkpoint_every=1), state_dict=fixture_state_dict(0))
    MeshDetector(det, make_mesh(("data",)))
    base = det.detect_file_streaming(wav)
    engine = get_fused_engine(det, sr, "i16")
    jd = os.path.join(work, "journal")
    calls = _count_programs(engine, kill_after=5)
    try:
        det.detect_file_streaming(wav, journal_dir=jd)
        raise AssertionError("the simulated preemption did not fire")
    except RuntimeError as e:
        if "preemption" not in str(e):
            raise
    del engine._program
    calls = _count_programs(engine)
    resumed = det.detect_file_streaming(wav, journal_dir=jd)
    del engine._program
    equal = (np.array_equal(resumed.avg_values, base.avg_values)
             and resumed.intervals == base.intervals)
    log(f"mesh-only journal: killed after 5 chunks, resumed with {len(calls)} programs, grid and "
        f"intervals bit-equal={equal}, sidecar left={os.listdir(jd)}")
    if not equal or os.listdir(jd) or len(calls) != 7:
        raise AssertionError("the journal did not resume bit-equal under the mesh")

    # two processes of detect --distributed + merge against one process
    files = []
    for i in range(2):
        p = os.path.join(work, f"dist{i}.wav")
        _field_wav(p, 60.0, sr, seed=20 + i)
        files.append(p)
    times: dict = {}
    for d in ("one", "two"):
        _cli(["--project-dir", os.path.join(work, d), "project", "new", "P", *files], d, times)
    _cli(["--project-dir", os.path.join(work, "one"), "detect", "--project", "P",
          "--random-init"], "one process", times)
    port = pdist.free_port()
    env = dict(os.environ, PYTHONPATH=HERE)
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "softspoken_tpu_torch", "--project-dir",
         os.path.join(work, "two"), "detect", "--project", "P", "--random-init",
         "--distributed", "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(r)], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"detect --distributed exited {p.returncode}:\n{out[-3000:]}")
    devs = [_last_json(o)["device"] for o in outs]
    _cli(["--project-dir", os.path.join(work, "two"), "project", "merge-detections", "P"],
         "merge", times)
    csvs = [open(os.path.join(work, d, "Softspoken Outputs", "P", "P_detections.csv"),
                 "rb").read() for d in ("one", "two")]
    log(f"mesh-only detect --distributed: 2 processes on {devs} in "
        f"{time.perf_counter() - t1:.2f} s, merged CSV identical to one process's="
        f"{csvs[0] == csvs[1]} ({len(csvs[0].splitlines()) - 1} rows); one process "
        f"{times['one process']:.2f} s")
    if csvs[0] != csvs[1] or devs[0] == devs[1]:
        raise AssertionError("detect --distributed + merge differs from one process")

    # (2, 2) training: float64 exactness, then phase 5's point against one card
    timed_outer = 3
    t1 = time.perf_counter()
    pdist.spawn(_mesh_train_worker, n, args=(n, f"tcp://localhost:{pdist.free_port()}", work,
                                             timed_outer), timeout_s=600)
    log(f"mesh-only training workers: {time.perf_counter() - t1:.1f} s")
    one = profile_step(*_f32_step(None, 0, 32))
    ranks = [json.load(open(os.path.join(work, f"mesh_step_rank{r}.json"))) for r in range(n)]
    log(f"mesh-only profile of one float32 train step (B=32, T=256, no synthesis): one card "
        f"wall_ms={one['wall_ms']:.3f} device_ms={one['device_ms']:.3f}; ({n // 2}, 2) per rank "
        + "; ".join(f"rank {r} wall_ms={p['wall_ms']:.3f} device_ms={p['device_ms']:.3f} "
                    f"nccl_ms={p['nccl_ms']:.3f} nccl_kernels={p['nccl_kernels']:.0f}"
                    for r, p in enumerate(ranks)) + f" | {smi}")
    check_f64_steps(f"mesh ({n // 2}, 2) NCCL group", torch.load(
        os.path.join(work, "mesh_f64.pt")), unsharded_step_f64(2 * (n // 2)), smi)
    init_sd = create_train_state(0).model.state_dict()
    short = os.path.join(work, "one_short.pth")
    with fp32_matmul():
        fit_synthetic(ckpt_out=short, device="cuda", **SHORT_FIT)
    rule = adam_rule(init_sd, load_pth(os.path.join(work, "mesh_short.pth"))[0],
                     load_pth(short)[0])
    log(f"mesh-only train ({n // 2}, 2) vs one card, two float32 steps with TF32 off (B=32): "
        f"parameters: relative L2 of the movement {rule['rel_l2_of_movement']:.3e} (tol 0.2), "
        f"max_abs_diff {rule['max_abs']:.3e}, elements off by > 0.5 lr "
        f"{rule['frac_half_lr']:.2e} | {smi}")
    if rule["rel_l2_of_movement"] > 0.2:
        raise AssertionError("two (2, 2) training steps disagree with one card's")
    seen = json.load(open(os.path.join(work, "mesh_train.json")))
    first = seen[0]["wall_seconds"]
    mesh_sps = 10 * timed_outer / (seen[-1]["wall_seconds"] - first)
    one = timed_fit(work, smi, "float32", timed_outer)
    rule = adam_rule(init_sd, load_pth(os.path.join(work, "mesh_train.pth"))[0],
                     load_pth(one["path"])[0])
    loss_rel = max(abs(m["loss"] - l1) / l1 for m, l1 in zip(seen, one["losses"]))
    log(f"mesh-only train ({n // 2}, 2) vs one card (B=32, pools 128+128, n_inner=10, "
        f"{10 * (1 + timed_outer)} steps, phase 5's precision): steps/s {mesh_sps:.3f} vs "
        f"{one['steps_per_s']:.3f} ({mesh_sps / one['steps_per_s']:.2f}x); first outer call "
        f"{first:.3f} s vs {one['first_outer_s']:.3f} s; losses per outer call "
        f"{[round(m['loss'], 5) for m in seen]} vs {[round(v, 5) for v in one['losses']]} (max "
        f"rel diff {loss_rel:.2e}, tol 0.02); parameters: relative L2 of the movement "
        f"{rule['rel_l2_of_movement']:.3e} (tol 1.0: runs that differ in rounding drift apart "
        f"under Adam, whose updates are ±lr wherever a gradient is within rounding of 0), "
        f"max_abs_diff {rule['max_abs']:.3e} | {smi}")
    if loss_rel > 0.02 or rule["rel_l2_of_movement"] > 1.0:
        raise AssertionError("(2, 2) training disagrees with one card")
    os.remove(wav)
    return recs


def per_card_kernels(devices, smi: str) -> dict:
    """K1 (every mode and output type), K2 and K3 on each card at the main
    path's shapes, launched from a thread whose current device is cuda:0,
    each against its plain version on the same card; returns each kernel's
    largest error over the cards."""
    from softspoken_tpu_torch.ops import adpcm
    from softspoken_tpu_torch.ops import dft_mel as dm
    from softspoken_tpu_torch.ops import frame_mel as fm
    from softspoken_tpu_torch.ops import mel as melops

    worst = {"frame_mel": 0.0, "dft_mel": 0.0, "adpcm_decode": 0.0}
    rng = np.random.default_rng(17)
    buf_np = rng.standard_normal(3_439_800).astype(np.float32)
    starts_np = (np.arange(128) * 13_230).astype(np.int32)
    wire_np = adversarial_adpcm_wire(9_762, seed=5)
    n_adpcm = 9_762 * adpcm.SPB - 160

    def check(dev):
        torch.cuda.set_device(0)
        buf = torch.from_numpy(buf_np).to(dev)
        starts = torch.from_numpy(starts_np).to(dev)
        line = []
        for mode in ("highest", "high", "default"):
            for dt in (torch.float32, torch.bfloat16):
                got = fm.log_mel_windows_fused(buf, starts, mode, dt)
                torch.cuda.synchronize(dev)
                ref = fm.log_mel_windows_fused_ref(buf, starts, mode, dt)
                err = float((got.float() - ref.float()).abs().max())
                tol = TOL_BF16 if dt == torch.bfloat16 else TOL_F32
                if got.device != dev or not bool(torch.isfinite(got.float()).all()) or err > tol:
                    raise AssertionError(f"frame_mel {mode}/{dt} on {dev}: error {err}")
                worst["frame_mel"] = max(worst["frame_mel"], err)
                line.append(f"K1 {mode}/{str(dt)[6:]} {err:.2e}")
        frames = melops.gather_frames(buf, starts)
        got = dm.log_mel_from_frames_dft(frames)
        torch.cuda.synchronize(dev)
        err = float((got - dm.log_mel_from_frames_dft_ref(frames)).abs().max())
        if got.device != dev or err > TOL_DFT_MEL:
            raise AssertionError(f"dft_mel on {dev}: error {err}")
        worst["dft_mel"] = max(worst["dft_mel"], err)
        wire = torch.from_numpy(wire_np).to(dev)
        got = adpcm.decode_device(wire, n_adpcm)
        torch.cuda.synchronize(dev)
        if got.device != dev or not torch.equal(got, adpcm.decode_device_ref(wire, n_adpcm)):
            raise AssertionError(f"adpcm_decode on {dev} is not bit-equal")
        log(f"kernels on {dev} from a cuda:0 thread: {', '.join(line)}, K2 {err:.2e} "
            f"(tol {TOL_DFT_MEL:.0e}), K3 bit-equal | {smi}")

    with ThreadPoolExecutor(max_workers=1) as ex:
        for dev in devices:
            ex.submit(check, dev).result()
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true", help="phases 1-2 only")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only what needs several cards (slice 14), over every visible card")
    ap.add_argument("--tools-only", action="store_true",
                    help="phases 1-2, then the tools, finetune and round5 phases "
                         "(slices 15-17) only")
    ap.add_argument("--first-detect", nargs=2, metavar=("MODE", "WAV"),
                    help="one case of the first-detect measurement (a subprocess of "
                         "the full run): MODE inline or runner")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    import softspoken_tpu_torch  # noqa: F401 — fails outside a checkout

    if args.first_detect:
        return first_detect(*args.first_detect)

    smi = nvidia_smi_line()
    log("card:", smi, "| torch:", torch.cuda.get_device_name(0))
    peaks = PEAKS["pcie" if "PCIe" in smi else "sxm"]
    work = os.path.join(HERE, "build", "softspoken_tpu_torch", "smoke")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    if args.mesh_only:
        return finish(t0, mesh_only(smi, peaks), smi)
    tc = phase_toolchain()
    k1 = phase_frame_mel(peaks)
    k2 = phase_dft_mel(peaks)
    k3 = phase_adpcm(peaks, smi)
    dw = phase_dw_silu(peaks, smi)
    bn = phase_bn_train(peaks, smi)
    for rec in (k1, k2, k3, dw, bn):
        rec.update(tc[rec["name"]])
        if rec["tensor_cores"] and not rec["tensor_core_instructions"]:
            raise AssertionError(f"{rec['name']} claims the tensor cores but its SASS shows none")
    if args.tools_only:
        tool_launches = phase_tools(work, smi)
        ft_launches = phase_finetune(work, smi)
        r5_launches = phase_round5(work, smi)
        for rec in (k1, k2, k3):
            rec["launches_tools"] = {t: n[rec["name"]] for t, n in tool_launches.items()}
            rec["launches_finetune"] = {t: n[rec["name"]] for t, n in ft_launches.items()}
            rec["launches_round5"] = {t: n[rec["name"]] for t, n in r5_launches.items()}
    elif not args.kernels:
        sr, seconds = 32000, 1800.0
        wav = os.path.join(work, "field_30min_32k.wav")
        wav60 = os.path.join(work, "field_60s_32k.wav")
        t1 = time.perf_counter()
        _field_wav(wav, seconds, sr, seed=11)
        _field_wav(wav60, 60.0, sr, seed=5)
        log(f"wrote {seconds:.0f} s and 60 s {sr} Hz PCM16 WAVs in "
            f"{time.perf_counter() - t1:.1f} s")
        phase_native(wav, smi)
        launches, chunk_device_ms, warm_rate = phase_end_to_end(work, wav, sr, seconds)
        k1["launches"] = launches.get("frame_mel", 0)
        phase_parity(wav60)
        k2["launches"] = phase_host_path(work, wav)
        phase_host_parity(wav60)
        mesh_launches = phase_mesh(work, wav, wav60, smi)
        for rec in (k1, k2, k3):
            rec["launches_mesh"] = mesh_launches[rec["name"]]
        phase_train(work, wav60, smi)
        phase_flac(work, smi)
        phase_containers(work)
        phase_determinism(wav, chunk_device_ms, smi)
        phase_trained(work, smi)
        phase_wires(work, wav, peaks, smi, k3)
        phase_workflow(work, wav, smi)
        k1["launches_eval"] = phase_eval(work, smi)
        tool_launches = phase_tools(work, smi)
        ft_launches = phase_finetune(work, smi)
        r5_launches = phase_round5(work, smi)
        for rec in (k1, k2, k3):
            rec["launches_tools"] = {t: n[rec["name"]] for t, n in tool_launches.items()}
            rec["launches_finetune"] = {t: n[rec["name"]] for t, n in ft_launches.items()}
            rec["launches_round5"] = {t: n[rec["name"]] for t, n in r5_launches.items()}
        k1["launches_journal"] = phase_journal(work, wav, smi)
        phase_concurrency(work, smi)
        phase_doctor()
        phase_first_detect(wav, smi)
        k1.update(phase_bench(work, warm_rate, smi))
        k1["launches_gui"] = phase_gui(work, smi)
        fit_launches = phase_fit(work, wav60, smi)
        codec_launches = phase_codecs(work, smi)
        for rec in (k1, k2, k3):
            rec["launches_fit"] = fit_launches[rec["name"]]
            rec["launches_codecs"] = {fmt: None if n is None else n[rec["name"]]
                                      for fmt, n in codec_launches.items()}
        os.remove(wav)
        os.remove(wav60)
    return finish(t0, [k1, k2, k3, dw, bn], smi)


def finish(t0: float, recs: list, smi: str) -> int:
    """The closing lines: the kernel records, the card's name and power
    limit, and the contract's last line."""
    log(f"total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": recs}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
