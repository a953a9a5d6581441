"""The evaluation harness (``train/evaluate.py``) against the JAX package:
the error taxonomy, the granularity metric and the accumulators on the JAX
tests' own cases (tests/test_eval.py), label files, eval sets written
byte for byte alike, and ``evaluate_detector`` with the trained weights in
parity mode (the port on the CPU from the committed .pth, JAX from the
orbax checkpoint) giving equal result dicts."""

import os

import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine import regions as jregions
from softspoken_tpu.train import evaluate as JE
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine import regions
from softspoken_tpu_torch.train import evaluate as E

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "root", "models", "spec_unet_2d", "model_checkpoint")

# (pred, truth) of tests/test_eval.py's taxonomy cases
TAXONOMY_CASES = {
    "miss": ([], [(1.0, 2.0), (5.0, 6.0)]),
    "merged": ([(1.0, 6.0)], [(1.0, 2.0), (5.0, 6.0)]),
    "split": ([(1.0, 1.4), (1.6, 2.0)], [(1.0, 2.0)]),
    "boundary": ([(1.0, 1.3)], [(1.0, 2.0)]),
    "false_alarm": ([(1.05, 2.1), (8.0, 9.0)], [(1.0, 2.0)]),
    "reconcile": ([(0.0, 1.0), (2.0, 2.2), (2.4, 3.0), (10.0, 11.0), (20.0, 24.0)],
                  [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0), (20.0, 21.0), (23.0, 24.0)]),
}


@pytest.mark.parametrize("case", sorted(TAXONOMY_CASES))
def test_taxonomy_equals_jax(case):
    pred, truth = TAXONOMY_CASES[case]
    for iou in (0.3, 0.5, 0.7):
        tx = E.event_error_taxonomy(pred, truth, iou)
        assert tx == JE.event_error_taxonomy(pred, truth, iou)
        em = E.event_metrics(pred, truth, iou)
        assert tx["miss"] + tx["merged"] + tx["split"] + tx["boundary"] == em["fn"]
        assert tx["false_alarm"] + tx["fragment"] == em["fp"]
        assert tx["matched"] == em["tp"]
    tx = E.event_error_taxonomy(pred, truth)
    expect = {"miss": ("miss", 2), "merged": ("merged", 2), "split": ("split", 1),
              "boundary": ("boundary", 1), "false_alarm": ("false_alarm", 1)}
    if case in expect:
        key, n = expect[case]
        assert tx[key] == n


def test_taxonomy_finalize_equals_jax():
    tot, jtot = {}, {}
    for pred, truth in TAXONOMY_CASES.values():
        E.merge_taxonomy(tot, E.event_error_taxonomy(pred, truth))
        JE.merge_taxonomy(jtot, JE.event_error_taxonomy(pred, truth))
    assert tot == jtot
    assert E.finalize_taxonomy(tot) == JE.finalize_taxonomy(jtot)
    fin = E.finalize_taxonomy({})
    assert fin == JE.finalize_taxonomy({}) and fin["onset_mae_s"] == 0.0
    one = {}
    E.merge_taxonomy(one, E.event_error_taxonomy([], [(0.0, 1.0)]))
    E.merge_taxonomy(one, E.event_error_taxonomy([(1.0, 1.3)], [(1.0, 2.0)]))
    fin = E.finalize_taxonomy(one)
    assert fin["miss_frac_of_fn"] == 0.5 and fin["boundary_frac_of_fn"] == 0.5


def _intervals(rng, n, duration):
    s = np.sort(rng.uniform(0, duration, n))
    return [(float(x), float(x + rng.uniform(0.02, 3.0))) for x in s]


@pytest.mark.parametrize("seed", range(4))
def test_granularity_accumulate_and_min_length_equal_jax(seed):
    rng = np.random.default_rng(seed)
    truth = _intervals(rng, 9, 60.0)
    pred = _intervals(rng, 7, 60.0) + truth[:4]
    for brk in (0.3, 0.5, 1.0):
        assert (E.event_metrics_granularity(pred, truth, brk)
                == JE.event_metrics_granularity(pred, truth, brk))
    for m in (0.0, 0.1, 0.5):
        assert regions.filter_min_length(pred, m) == jregions.filter_min_length(pred, m)
    tot, jtot = {}, {}
    for p, t in ((pred, truth), ([], truth), (pred, []), (truth, truth)):
        E._accumulate(tot, E.frame_metrics(p, t, 64.0))
        JE._accumulate(jtot, JE.frame_metrics(p, t, 64.0))
    assert tot == jtot and E._finalize(tot) == JE._finalize(jtot)
    assert E._finalize({}) == JE._finalize({})


def test_label_files_equal_jax(tmp_path):
    labeled = [("eval_000.wav", [(0.25, 1.5), (3.0, 4.125)]),
               ("sub/b.wav", [(0.1, 0.2)]), ("c.flac", [])]
    E.save_labels(str(tmp_path / "a.csv"), labeled)
    JE.save_labels(str(tmp_path / "b.csv"), labeled)
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    assert E.load_labels(str(tmp_path / "a.csv")) == JE.load_labels(str(tmp_path / "a.csv"))

    tracks = tmp_path / "tracks"
    tracks.mkdir()
    (tracks / "x.txt").write_text("3.5\t4.0\tHuman\n\n0.5\t1.25\tHuman\n")
    (tracks / "x.wav").write_bytes(b"")
    (tracks / "y.txt").write_text("1\t2\n")
    (tracks / "y.flac").write_bytes(b"")
    for p in (str(tracks), str(tracks / "x.txt")):
        assert E.load_labels(p) == JE.load_labels(p)
    assert E.load_labels(str(tracks / "x.txt"))[0][1] == [(0.5, 1.25), (3.5, 4.0)]
    (tracks / "z.txt").write_text("7.0\n")
    (tracks / "z.wav").write_bytes(b"")
    with pytest.raises(ValueError):
        E.load_labels(str(tracks / "z.txt"))
    (tmp_path / "orphan.txt").write_text("0.5\t1.0\tHuman\n")
    with pytest.raises(FileNotFoundError):
        E.load_labels(str(tmp_path / "orphan.txt"))


def _tree(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("generator,degradations",
                         [("v1", None), ("v2", ["rolloff4k", "mulaw"])])
def test_make_eval_set_is_byte_identical(tmp_path, generator, degradations):
    kw = dict(n_files=2, seconds=8.0, seed=7007, generator=generator,
              degradations=degradations)
    a = E.make_eval_set(str(tmp_path / "port"), **kw)
    b = JE.make_eval_set(str(tmp_path / "jax"), **kw)
    assert os.path.basename(a) == os.path.basename(b) == "labels.csv"
    ta, tb = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(ta) == ["eval_000.wav", "eval_001.wav", "labels.csv"]
    assert ta == tb


def test_evaluate_detector_equals_jax_in_parity_mode(tmp_path):
    if not os.path.isdir(CKPT):
        pytest.skip("trained checkpoint not present")
    labels = E.make_eval_set(str(tmp_path), n_files=2, seconds=20.0, seed=11)
    labeled = E.load_labels(labels)
    assert labeled == JE.load_labels(labels)
    eng = dict(precision="parity", device_batch=16, chunk_seconds=15.0)
    port = Detector(Config().with_engine(**eng), checkpoint_path=CKPT + ".pth",
                    device="cpu")
    jax = JDetector(JConfig().with_engine(**eng), checkpoint_path=CKPT)
    assert port.epoch == jax.epoch > 0
    got = E.evaluate_detector(port, labeled)
    assert got == JE.evaluate_detector(jax, labeled)
    assert got["frame"]["f1"] > 0.8 and len(got["files"]) == 2
