"""The JAX package's quality under each wire on the card's labeled fields.

Computes, with the JAX package on the CPU, what
tests/test_torch_quality_cuda.py::test_each_wire_holds_the_jax_cpu_quality
measures on the card with the port: the 8 labeled 120 s fields at 32 kHz
of that module's ``fields`` (``synth_field_recording`` with
``np.random.default_rng(seed)``, seeds 0-7, written as PCM16 WAVs),
detected with the trained checkpoint in fast mode with
``mel_precision="highest"`` through the fused pipeline under each upload
wire of ``WIRES``, and scored with frame and event F1 (IoU 0.5) against
their labels, as that module scores them.

    JAX_PLATFORMS=cpu python tests/jax_wire_reference.py [pcm16 ...]

prints one JSON line per wire; that test carries the means as its
reference (``WIRE_REFERENCE``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (tag, upload_codec, wire_decimate)
WIRES = [
    ("pcm16", "pcm16", "auto"),
    ("mulaw8_auto", "mulaw8", "auto"),
    ("mulaw8_off", "mulaw8", "off"),
    ("adpcm4_auto", "adpcm4", "auto"),
    ("adpcm4_off", "adpcm4", "off"),
]
N_FIELDS, SECONDS, SR = 8, 120.0, 32000


def main(tags) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from softspoken_tpu import Config
    from softspoken_tpu.engine import Detector
    from softspoken_tpu.engine.fused import detect_file_fused
    from softspoken_tpu.io import wavio
    from softspoken_tpu.train.evaluate import event_metrics, frame_metrics
    from softspoken_tpu.train.synth import synth_field_recording
    from softspoken_tpu.io import native as jnative

    # the JAX package's threaded ss_fir_decim_i16 (decimated reads of
    # >= 65,536 outputs with more than one thread) reads a thread_local
    # scratch from its worker threads and crashes; one thread gives the
    # same samples
    jnative._threads = lambda: 1

    base = tempfile.mkdtemp(prefix="jax_wire_ref_")
    fields = []
    for seed in range(N_FIELDS):
        audio, truth = synth_field_recording(np.random.default_rng(seed), SECONDS, sr=SR)
        path = os.path.join(base, f"field_{seed}.wav")
        wavio.write(path, audio, SR, subtype="PCM_16")
        fields.append((path, truth))
    ckpt = os.path.join(REPO, "root/models/spec_unet_2d/model_checkpoint")
    for tag, codec, decim in WIRES:
        if tags and tag not in tags:
            continue
        cfg = Config().with_engine(mel_precision="highest", pipeline="fused",
                                   upload_codec=codec, wire_decimate=decim)
        det = Detector(cfg, checkpoint_path=ckpt)
        assert det.epoch >= 0, "the trained checkpoint did not load"
        t0 = time.time()
        per_field = []
        for path, truth in fields:
            res = detect_file_fused(det, path)
            per_field.append((frame_metrics(res.intervals, truth, SECONDS)["f1"],
                              event_metrics(res.intervals, truth)["f1"]))
        f = np.array(per_field)
        print(json.dumps({
            "wire": tag, "upload_codec": codec, "wire_decimate": decim,
            "frame_f1_mean": float(f[:, 0].mean()), "event_f1_mean": float(f[:, 1].mean()),
            "per_field": per_field, "detect_s": round(time.time() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
