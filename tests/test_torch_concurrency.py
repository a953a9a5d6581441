"""File concurrency on the port (``runtime/workers.py``,
``engine.file_concurrency``) against the sequential run and the JAX
package's runner, on the CPU, and the thread-safety it rests on.

K = 2 writes the byte-identical detections CSV of K = 1 and of the JAX
runner; an error stays with its file; ``stop()`` settles the files in
flight; K = 2 with the chunk journal clears every sidecar.  Beneath it:
``ops.mel.fp32_matmul`` keeps TF32 off until its last holder leaves, the
engine cache builds one engine per key under threads, and two threads
sharing one engine get each file's sequential grid bit for bit.
"""

import os
import threading

import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.project.store import DetectionStore as JStore
from softspoken_tpu.runtime import DetectRunner as JRunner
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine.fused import get_fused_engine
from softspoken_tpu_torch.ops import mel as melops
from softspoken_tpu_torch.project import DetectionStore
from softspoken_tpu_torch.runtime import DetectRunner, RunCallbacks

torch.set_num_threads(2)

ENG = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="fused")


def _wavs(tmp_path, seconds, prefix="c", sr=16000, seed=3):
    rng = np.random.default_rng(seed)
    paths = []
    for i, secs in enumerate(seconds):
        p = str(tmp_path / f"{prefix}{i}.wav")
        x = rng.uniform(-0.5, 0.5, int(sr * secs)).astype(np.float32)
        if i % 2:
            x[: sr] *= 0.01  # some variety in the detections
        jwavio.write(p, x, sr, subtype="PCM_16")
        paths.append(p)
    return paths


def _run(tmp_path, paths, name, callbacks=None, **eng):
    cfg = Config().with_engine(**{**ENG, **eng})
    det = Detector(cfg, state_dict=fixture_state_dict(0), device="cpu")
    store = DetectionStore(str(tmp_path / name))
    runner = DetectRunner(det, store, cfg, streaming=True)
    return runner, runner.run(paths, callbacks), store.path


def test_k2_csv_equals_k1_and_the_jax_runner(tmp_path):
    paths = _wavs(tmp_path, [4, 6, 5, 4])
    _, rep1, csv1 = _run(tmp_path, paths, "k1.csv")
    _, rep2, csv2 = _run(tmp_path, paths, "k2.csv", file_concurrency=2)
    assert not rep1.errors and not rep2.errors and rep2.files_done == 4
    jcfg = JConfig().with_engine(**ENG)
    jstore = JStore(str(tmp_path / "jax.csv"))
    jrep = JRunner(JDetector(jcfg, variables=jckpt.fixture_variables(seed=0)), jstore,
                   jcfg, streaming=True).run(paths)
    assert not jrep.errors
    with open(csv1, "rb") as a, open(csv2, "rb") as b, open(jstore.path, "rb") as j:
        one, two, ref = a.read(), b.read(), j.read()
    assert one == two == ref
    assert one.count(b"\n") > 1


def test_an_error_stays_with_its_file(tmp_path):
    good = _wavs(tmp_path, [4, 4], prefix="g")
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"RIFFgarbage")
    _, rep, _ = _run(tmp_path, [good[0], bad, good[1]], "d.csv", file_concurrency=2)
    assert rep.files_done == 2 and list(rep.errors) == [bad]


def test_stop_settles_the_files_in_flight(tmp_path):
    paths = _wavs(tmp_path, [4, 4, 4, 4], prefix="s")
    cfg = Config().with_engine(**ENG, file_concurrency=2)
    det = Detector(cfg, state_dict=fixture_state_dict(0), device="cpu")
    store = DetectionStore(str(tmp_path / "d.csv"))
    runner = DetectRunner(det, store, cfg, streaming=True)
    started, done = [], []

    def on_done(path):
        done.append(path)
        runner.stop()  # as soon as the first file settles

    rep = runner.run(paths, RunCallbacks(file_started=started.append, file_done=on_done))
    assert rep.stopped
    # every file that started was settled, in order, and persisted
    assert done == started and rep.files_done == len(done) >= 2
    assert store.processed_files() == set(done)
    assert len(done) < len(paths)


def test_k2_with_the_journal_clears_every_sidecar(tmp_path):
    paths = _wavs(tmp_path, [8, 7, 8], prefix="j")
    _, rep1, csv1 = _run(tmp_path, paths, "k1.csv")
    _, rep2, csv2 = _run(tmp_path, paths, "k2.csv", file_concurrency=2,
                         chunk_checkpoint_every=1)
    assert not rep2.errors and rep2.files_done == 3
    jd = os.path.join(os.path.dirname(csv2), ".chunk_progress")
    assert os.path.isdir(jd) and os.listdir(jd) == []
    with open(csv1, "rb") as a, open(csv2, "rb") as b:
        assert a.read() == b.read()


def test_file_concurrency_must_be_positive(tmp_path):
    det = Detector(Config().with_engine(**ENG), state_dict=fixture_state_dict(0),
                   device="cpu")
    with pytest.raises(ValueError):
        DetectRunner(det, DetectionStore(str(tmp_path / "d.csv")),
                     Config().with_engine(file_concurrency=0))


# ------------------------------------------------------------ thread safety
def test_fp32_guard_holds_until_the_last_holder_leaves():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    a_in, b_in, a_out, b_checked = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with melops.fp32_matmul():
            a_in.set()
            b_in.wait()
        a_out.set()  # A left first, while B still holds the guard

    def b():
        a_in.wait()
        with melops.fp32_matmul():
            b_in.set()
            a_out.wait()
            seen["inside_b_after_a"] = (torch.backends.cuda.matmul.allow_tf32,
                                        torch.backends.cudnn.allow_tf32)
        b_checked.set()

    try:
        ts = [threading.Thread(target=a), threading.Thread(target=b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert seen["inside_b_after_a"] == (False, False)
        # the last holder restored the flags it found
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
        with melops.fp32_matmul():
            with melops.fp32_matmul():
                pass
            assert not torch.backends.cudnn.allow_tf32  # nested: still held
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_engine_cache_builds_one_engine_under_threads():
    det = Detector(Config().with_engine(**ENG), state_dict=fixture_state_dict(0),
                   device="cpu")
    go = threading.Barrier(8)
    got = []

    def ask():
        go.wait()
        got.append(get_fused_engine(det, 32000, "i16"))

    ts = [threading.Thread(target=ask) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert len(got) == 8 and all(e is got[0] for e in got)
    assert len(det._engines) == 1


def test_two_threads_sharing_one_engine_get_their_sequential_grids(tmp_path):
    """``_program``, ``_accumulate`` and ``_placement`` write no attribute
    and nothing built once per engine is written during a run, so two
    threads on one engine reproduce each file's sequential grid."""
    paths = _wavs(tmp_path, [7, 8], prefix="t", seed=8)
    det = Detector(Config().with_engine(**ENG), state_dict=fixture_state_dict(0),
                   device="cpu")
    engine = get_fused_engine(det, 16000, "i16")
    before = {k: v for k, v in vars(engine).items()}
    w_before = engine.W.clone()
    seq = [det.detect_file_streaming(p).avg_values for p in paths]
    out, errors = {}, []
    go = threading.Barrier(2)

    def work(i):
        try:
            go.wait()
            out[i] = [det.detect_file_streaming(paths[i]).avg_values]
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    assert not errors
    for i in range(2):
        for got in out[i]:
            np.testing.assert_array_equal(got, seq[i])
    assert get_fused_engine(det, 16000, "i16") is engine
    assert {k: v for k, v in vars(engine).items()} == before
    assert torch.equal(engine.W, w_before)
