"""Time versions of the ADPCM decode kernel K3 side by side on one CUDA card.

    python3 scripts/k3_ab.py OLD.cu NEW.cu [MORE.cu ...]

Each source is a version of ``softspoken_tpu_torch/csrc/adpcm_decode.cu``
that exports ``adpcm_decode_launch(wire, nb, out, n, stream)``.  The script
builds each with the flags of ``softspoken_tpu_torch/ops/_build.py`` (one
nvcc each, all started together) into ``build/k3_ab/``, holds each
bit-equal (``torch.equal``) to ``ops/adpcm.decode_device_ref`` on an
adversarial wire of a default chunk at the 16 kHz wire (9,762 blocks,
n = 2,498,976) and on one block, then times them in turns (the sources in
order, then reversed, twice): the device time of one launch
(``chip_smoke.device_time``: torch.profiler's CUDA events, and a CUDA graph
of 10 launches), the time per back-to-back call, and one block's device
latency.  Prints each reading, the nvidia-smi line, and one JSON line of
medians per source.  Needs the card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from softspoken_tpu_torch.ops import _build, adpcm  # noqa: E402

OUT_DIR = os.path.join(ROOT, "build", "k3_ab")
CHUNK_N = 2_498_976  # FusedStreamingEngine(Detector(), 16000, "adpcm4").in_len
ROUNDS = 2  # turns through the sources, each in order and then reversed


def build(src: str) -> tuple:
    """(library path, nvcc's output) of ``src``, built with the package's flags."""
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(OUT_DIR, exist_ok=True)
    lib = os.path.join(OUT_DIR, f"{os.path.basename(src)[:-3]}-{h}.so")
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
                        src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}")
    return lib, r.stdout


def launcher(lib_path: str):
    fn = ctypes.CDLL(lib_path).adpcm_decode_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, ctypes.c_longlong, P, ctypes.c_longlong, P]
    fn.restype = ctypes.c_int

    def decode(wire: torch.Tensor, n: int) -> torch.Tensor:
        out = torch.empty(n, dtype=torch.float32, device=wire.device)
        rc = fn(wire.data_ptr(), wire.numel() // adpcm.BLOCK_BYTES, out.data_ptr(), n,
                torch.cuda.current_stream(wire.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"adpcm_decode_launch failed: cudaError {rc}")
        return out

    return decode


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="+", help="versions of csrc/adpcm_decode.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_ab: no CUDA device", flush=True)
        return 2
    smi = cs.nvidia_smi_line()
    with ThreadPoolExecutor(max_workers=len(args.sources)) as ex:
        built = list(ex.map(build, args.sources))
    decoders = {}
    for src, (lib, text) in zip(args.sources, built):
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        print(f"k3_ab built {src}: {'; '.join(regs)}", flush=True)
        decoders[src] = launcher(lib)

    wire = torch.from_numpy(cs.adversarial_adpcm_wire(adpcm.n_blocks(CHUNK_N), seed=3)).cuda()
    one = wire[: adpcm.BLOCK_BYTES]
    ref = adpcm.decode_device_ref(wire, CHUNK_N)
    ref_one = adpcm.decode_device_ref(one, adpcm.SPB)
    for src, dec in decoders.items():
        ok = torch.equal(dec(wire, CHUNK_N), ref) and torch.equal(dec(one, adpcm.SPB), ref_one)
        print(f"k3_ab {src}: bit-equal to decode_device_ref={ok}", flush=True)
        if not ok:
            raise AssertionError(f"{src} disagrees with decode_device_ref")

    order = []
    for _ in range(ROUNDS):
        order += list(args.sources) + list(reversed(args.sources))
    runs = {src: [] for src in args.sources}
    for src in order:
        dec = decoders[src]
        d = cs.device_time(lambda: dec(wire, CHUNK_N), "adpcm_decode_kernel")
        o = cs.device_time(lambda: dec(one, adpcm.SPB), "adpcm_decode_kernel")
        call = cs.cuda_time_ms(lambda: dec(wire, CHUNK_N))
        runs[src].append({"device_ms": d["ms"], "profiler_ms": d["profiler_ms"],
                          "graph_ms": d["graph_ms"], "call_ms": call, "one_block_ms": o["ms"]})
        print(f"k3_ab {src} (nb={wire.numel() // adpcm.BLOCK_BYTES}, n={CHUNK_N}): "
              f"{cs.device_text(d)} call_ms={call:.5f} one block {cs.device_text(o)} | {smi}",
              flush=True)
    summary = {src: {k: float(np.median([r[k] for r in rs if r[k] is not None]))
                     for k in rs[0]} for src, rs in runs.items()}
    print(smi, flush=True)
    print(json.dumps({"k3_ab": summary, "turns": order, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
