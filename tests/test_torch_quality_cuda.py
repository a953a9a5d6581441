"""The committed trained weights' quality on the card: fast mode against
parity mode on 8 labeled fields, each upload wire and four eval conditions
of scripts/quality_grid.py against the JAX package's own result on the CPU
(tests/jax_wire_reference.py, tests/jax_eval_reference.py), at the inputs
those references were computed on.

Card only (the fused path runs K1); the command is in
tests/test_torch_cuda.py's docstring.
"""

import numpy as np
import pytest

from torch_cuda_helpers import need_card

pytestmark = pytest.mark.cuda

TRAINED_EPOCH = 48750
# (tag, upload_codec, wire_decimate)
WIRES = (("pcm16", "pcm16", "auto"), ("mulaw8_auto", "mulaw8", "auto"),
         ("mulaw8_off", "mulaw8", "off"), ("adpcm4_auto", "adpcm4", "auto"),
         ("adpcm4_off", "adpcm4", "off"))
# tests/jax_wire_reference.py on the CPU at commit d38cc7b: the 8 labeled
# 120 s fields (seeds 0-7, 32 kHz PCM16), trained checkpoint, fast mode with
# mel_precision="highest", the fused pipeline under each wire.  (mean frame
# F1, mean event F1)
WIRE_REFERENCE = {
    "pcm16": (0.9665015136106887, 0.8320634920634921),
    "mulaw8_auto": (0.9644566508796881, 0.8358134920634921),
    "mulaw8_off": (0.9664369080430482, 0.8286019536019535),
    "adpcm4_auto": (0.9647802068251726, 0.822063492063492),
    "adpcm4_off": (0.9666731237269015, 0.8320634920634921),
}
TOL_FRAME, TOL_EVENT = 0.01, 0.03  # the card against the JAX CPU result
WIRE_TOL_PCM16 = 0.01  # a lossy wire's mean frame F1 against pcm16's, on the card
# scripts/quality_grid.py's conditions (its seed is 7000 + the condition's
# index there): (tag, generator, seed, degradations)
EVAL_CONDITIONS = (("v1_clean", "v1", 7000, None), ("v2_clean", "v2", 7000, None),
                   ("v1_mulaw", "v1", 7007, ["mulaw"]),
                   ("v2_reverb08", "v2", 7014, ["reverb08"]))
# tests/jax_eval_reference.py on the CPU at commit b959b9b: 8 x 120 s at 32
# kHz from make_eval_set, trained checkpoint, fast mode with
# mel_precision="highest", detect_file_streaming, parity operating point.
# (frame F1, event F1) without and with the music filter at 0.85
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


@pytest.fixture(scope="module")
def fields(tmp_path_factory):
    """The 8 labeled 120 s fields at 32 kHz (``synth_field_recording``,
    seeds 0-7, PCM16): [(path, truth)]."""
    need_card()  # before any work: the test skips without a card
    from softspoken_tpu_torch.io import wavio
    from softspoken_tpu_torch.train.synth import synth_field_recording

    root = tmp_path_factory.mktemp("fields")
    out = []
    for seed in range(8):
        audio, truth = synth_field_recording(np.random.default_rng(seed), 120.0, sr=32000)
        path = str(root / f"field_{seed}.wav")
        wavio.write(path, audio, 32000, subtype="PCM_16")
        out.append((path, truth))
    return out


def _mean_f1(det, fields) -> tuple:
    """(mean frame F1, mean event F1) of ``det`` over the labeled fields."""
    from softspoken_tpu_torch.train.evaluate import event_metrics, frame_metrics

    scores = []
    for path, truth in fields:
        r = det.detect_file_streaming(path)
        scores.append((frame_metrics(r.intervals, truth, 120.0)["f1"],
                       event_metrics(r.intervals, truth)["f1"]))
    f = np.array(scores)
    return float(f[:, 0].mean()), float(f[:, 1].mean())


def test_trained_weights_score_in_fast_and_parity_mode(fields):
    """``Detector()`` loads the trained epoch; its fast mode's mean frame F1
    is at most 0.01 below parity mode's, and both at least 0.80."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector

    fast = Detector()
    assert fast.epoch == TRAINED_EPOCH
    fast_f1 = _mean_f1(fast, fields)[0]
    parity_f1 = _mean_f1(Detector(Config().with_engine(precision="parity")), fields)[0]
    assert parity_f1 - fast_f1 <= 0.01, (fast_f1, parity_f1)
    assert min(fast_f1, parity_f1) >= 0.80, (fast_f1, parity_f1)


def test_each_wire_holds_the_jax_cpu_quality(fields):
    """Under each upload wire (mel "highest"), the mean frame and event F1
    within 0.01 / 0.03 of the JAX package's CPU result, and each wire's mean
    frame F1 within 0.01 of pcm16's on the card."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector

    means, misses = {}, []
    for tag, codec, decim in WIRES:
        det = Detector(Config().with_engine(mel_precision="highest", upload_codec=codec,
                                            wire_decimate=decim))
        assert det.epoch == TRAINED_EPOCH
        means[tag] = _mean_f1(det, fields)
        (frame, event), (rf, re_) = means[tag], WIRE_REFERENCE[tag]
        if abs(frame - rf) > TOL_FRAME or abs(event - re_) > TOL_EVENT:
            misses.append(f"{tag}: frame {frame - rf:+.4f}, event {event - re_:+.4f} "
                          "from the JAX CPU result")
    for tag, (frame, _event) in means.items():
        if abs(frame - means["pcm16"][0]) > WIRE_TOL_PCM16:
            misses.append(f"{tag}: frame {frame - means['pcm16'][0]:+.4f} from pcm16")
    assert not misses, misses


def _score_parity(per_file, pad: float, sr: int, music_threshold=None) -> dict:
    """scripts/quality_grid.py's ``metrics_from`` at the parity point
    (threshold 0.1, merge 0.5 s, shift by -pad, clamp, min length 0.1 s,
    IoU 0.5); with ``music_threshold`` the predictions go through the
    post-filter as ``postfilter_parity_metrics`` applies it, reading
    contexts from the WAVs."""
    from softspoken_tpu_torch.engine import postfilter as PF
    from softspoken_tpu_torch.engine import regions as R
    from softspoken_tpu_torch.io import load_audio_startstop
    from softspoken_tpu_torch.train import evaluate as E

    ft, et = {}, {}
    for avg, dur, truth, path in per_file:
        regs = R.shift_regions(R.find_speech_regions(avg, 0.1, 0.5), -pad)
        regs = [(max(0.0, s), min(dur, e)) for s, e in regs if e > 0 and s < dur]
        pred = R.filter_min_length(regs, 0.1)
        if music_threshold is not None:
            def read_ctx(s, e, _p=path):
                return load_audio_startstop(_p, (s, e), target_sr=sr)[0]

            pred, _scores = PF.filter_intervals(pred, read_ctx, sr, dur, music_threshold)
        E._accumulate(ft, E.frame_metrics(pred, truth, dur))
        E._accumulate(et, E.event_metrics(pred, truth, 0.5))
    return {"frame_f1": E._finalize(ft)["f1"], "event_f1": E._finalize(et)["f1"]}


@pytest.mark.parametrize("tag,generator,seed,degradations", EVAL_CONDITIONS,
                         ids=[c[0] for c in EVAL_CONDITIONS])
def test_eval_condition_holds_the_jax_cpu_quality(tmp_path, tag, generator, seed,
                                                  degradations):
    """One condition, 8 x 120 s at 32 kHz from ``make_eval_set``, detected
    by the trained weights (mel "highest", ``detect_file_streaming``: the
    fused path with K1) and scored at the parity point without and with
    the music filter: frame and event F1 within 0.01 and 0.03 of the JAX
    package's CPU result."""
    need_card()
    from softspoken_tpu_torch import Config
    from softspoken_tpu_torch.engine import Detector
    from softspoken_tpu_torch.engine import postfilter as PF
    from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
    from softspoken_tpu_torch.train import evaluate as E

    cfg = Config().with_engine(mel_precision="highest")
    det = Detector(cfg)
    assert det.epoch == TRAINED_EPOCH
    labels = E.make_eval_set(str(tmp_path), n_files=8, seconds=120.0, seed=seed,
                             generator=generator, degradations=degradations)
    before = KERNEL_LAUNCHES["frame_mel"]
    per_file = []
    for path, truth in E.load_labels(labels):
        res = det.detect_file_streaming(path)
        per_file.append((np.asarray(res.avg_values, np.float32), float(res.audio_seconds),
                         truth, path))
    assert KERNEL_LAUNCHES["frame_mel"] > before
    sr, pad = cfg.dsp.sample_rate, cfg.engine.pad_seconds
    for got, (rf, re_) in ((_score_parity(per_file, pad, sr), EVAL_REFERENCE[tag][0]),
                           (_score_parity(per_file, pad, sr, PF.DEFAULT_THRESHOLD),
                            EVAL_REFERENCE[tag][1])):
        assert abs(got["frame_f1"] - rf) <= TOL_FRAME, (got, rf)
        assert abs(got["event_f1"] - re_) <= TOL_EVENT, (got, re_)
