"""Chunk-journal resume on the port (``engine/journal.py`` and the journal
inside ``FusedStreamingEngine.run``) against the JAX package on the CPU.

A fused detection killed after k chunks leaves its sidecar; the resumed run
executes only the remaining chunk programs and its grid and intervals are
bit-equal to an uninterrupted run, on every wire (int16, mulaw8, adpcm4
with decimation, the float32 wire of an AIFF, a FLAC).  The resumed grid is
held to the JAX package's fused grid of the same file (atol 1e-5, equal
intervals).  The header cases mirror ``tests/test_journal.py``, and a
journal of either package is discarded, not resumed, by the other.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import flac_ref
from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine.fused import get_fused_engine as jax_get_fused_engine
from softspoken_tpu.engine.journal import variables_digest as jax_variables_digest
from softspoken_tpu.io import native as jnative
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine.fused import _make_journal, backend_tag, get_fused_engine
from softspoken_tpu_torch.engine.journal import ChunkJournal, variables_digest
from test_aiff import write_aiff

torch.set_num_threads(2)

ENG = dict(precision="parity", device_batch=4, chunk_seconds=6.0, pipeline="fused",
           chunk_checkpoint_every=1)


@pytest.fixture(autouse=True)
def _one_thread_reference(monkeypatch):
    """The JAX package's threaded wire-decimation FIR crashes (ROADMAP §3);
    one thread gives the same samples."""
    monkeypatch.setattr(jnative, "_threads", lambda: 1)


def _i16(sr, seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(sr * seconds)
    x = 0.02 * rng.standard_normal(n)
    t = np.arange(n) / sr
    for a in (2.0, 5.5):
        m = (t >= a) & (t < a + 1.5)
        x[m] += 0.4 * np.sin(2 * np.pi * 700 * t[m])
    return np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)


def _wav(tmp_path, sr=16000, seconds=8.0, seed=0):
    p = str(tmp_path / f"w{sr}_{seed}.wav")
    jwavio.write(p, _i16(sr, seconds, seed).astype(np.float32) / 32768.0, sr,
                 subtype="PCM_16")
    return p


def _aiff(tmp_path, sr=16000, seconds=8.0, seed=1):
    p = str(tmp_path / f"a{sr}_{seed}.aiff")
    write_aiff(p, _i16(sr, seconds, seed).astype(np.int64)[:, None], sr)
    return p


def _flac(tmp_path, sr=16000, seconds=8.0, seed=2):
    p = str(tmp_path / f"f{sr}_{seed}.flac")
    flac_ref.write_flac(p, _i16(sr, seconds, seed).astype(np.int64), sr, bits=16)
    return p


def _det(seed=0, **eng):
    return Detector(Config().with_engine(**{**ENG, **eng}),
                    state_dict=fixture_state_dict(seed), device="cpu")


class _Programs:
    """Counts an engine's chunk programs; raises after ``kill_after``."""

    def __init__(self, engine, kill_after=None):
        self.engine, self.fn, self.kill_after, self.calls = engine, engine._program, kill_after, 0

    def __enter__(self):
        def program(*a, **k):
            if self.kill_after is not None and self.calls >= self.kill_after:
                raise RuntimeError("simulated preemption")
            self.calls += 1
            return self.fn(*a, **k)

        self.engine._program = program
        return self

    def __exit__(self, *exc):
        del self.engine._program


WIRES = [
    # (file maker, engine options, (native_sr, kind) of the engine that runs)
    pytest.param(_wav, {}, (16000, "i16"), id="int16"),
    pytest.param(_wav, dict(upload_codec="mulaw8"), (16000, "mulaw8"), id="mulaw8"),
    pytest.param(lambda t: _wav(t, sr=32000, seed=3), dict(upload_codec="adpcm4"),
                 (16000, "adpcm4"), id="adpcm4-decimated"),
    pytest.param(_aiff, {}, (16000, "f32"), id="aiff-f32-wire"),
    pytest.param(_flac, {}, (16000, "i16"), id="flac"),
]


@pytest.mark.parametrize("make, eng, engine_key", WIRES)
def test_kill_and_resume_is_bit_equal(tmp_path, make, eng, engine_key):
    path = make(tmp_path)
    jd = str(tmp_path / "progress")
    det = _det(**eng)
    baseline = det.detect_file_streaming(path)
    engine = get_fused_engine(det, *engine_key)
    n_chunks = -(-baseline.num_windows // engine.chunk_w)
    assert n_chunks >= 3
    k = 1
    with _Programs(engine, kill_after=k), pytest.raises(RuntimeError, match="preemption"):
        det.detect_file_streaming(path, journal_dir=jd)
    side = os.listdir(jd)
    assert len(side) == 1 and side[0].endswith(".chunks.npz")
    with _Programs(engine) as count:
        resumed = det.detect_file_streaming(path, journal_dir=jd)
    assert count.calls == n_chunks - k
    np.testing.assert_array_equal(resumed.avg_values, baseline.avg_values)
    assert resumed.intervals == baseline.intervals
    assert resumed.num_windows == baseline.num_windows
    assert os.listdir(jd) == []  # cleared on success
    jeng = {kk: v for kk, v in {**ENG, **eng}.items() if kk != "chunk_checkpoint_every"}
    ref = JDetector(JConfig().with_engine(**jeng),
                    variables=jckpt.fixture_variables(seed=0)).detect_file_fused(path)
    np.testing.assert_allclose(resumed.avg_values, ref.avg_values, atol=1e-5)
    assert resumed.intervals == ref.intervals


def test_checkpoint_cadence_saves_every_n_chunks(tmp_path):
    """With N = 2 a kill after 3 programs resumes from chunk 2, the last save."""
    path = _wav(tmp_path, seconds=12.0)
    jd = str(tmp_path / "progress")
    det = _det(chunk_checkpoint_every=2)
    baseline = det.detect_file_streaming(path)
    engine = get_fused_engine(det, 16000, "i16")
    n_chunks = -(-baseline.num_windows // engine.chunk_w)
    assert n_chunks >= 4
    with _Programs(engine, kill_after=3), pytest.raises(RuntimeError):
        det.detect_file_streaming(path, journal_dir=jd)
    with _Programs(engine) as count:
        resumed = det.detect_file_streaming(path, journal_dir=jd)
    assert count.calls == n_chunks - 2
    np.testing.assert_array_equal(resumed.avg_values, baseline.avg_values)


def _killed(det, path, jd, engine_key=(16000, "i16"), k=1):
    engine = get_fused_engine(det, *engine_key)
    with _Programs(engine, kill_after=k), pytest.raises(RuntimeError):
        det.detect_file_streaming(path, journal_dir=jd)
    assert len(os.listdir(jd)) == 1
    return engine


def test_stale_journal_is_discarded(tmp_path):
    path = _wav(tmp_path)
    jd = str(tmp_path / "progress")
    det = _det()
    engine = _killed(det, path, jd)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 7))  # the source changed
    with _Programs(engine) as count:
        res = det.detect_file_streaming(path, journal_dir=jd)
    assert count.calls == -(-res.num_windows // engine.chunk_w)  # nothing skipped
    assert os.listdir(jd) == []


def test_different_weights_invalidate_journal(tmp_path):
    path = _wav(tmp_path)
    jd = str(tmp_path / "progress")
    _killed(_det(seed=0), path, jd)
    det1 = _det(seed=3)
    engine = get_fused_engine(det1, 16000, "i16")
    with _Programs(engine) as count:
        res = det1.detect_file_streaming(path, journal_dir=jd)
    assert count.calls == -(-res.num_windows // engine.chunk_w)


@pytest.mark.parametrize("change", [
    dict(mel_precision="default"), dict(mel_kernel="pallas"),
    dict(decoder_upsample="phase"),
    dict(upload_codec="mulaw8"), dict(wire_decimate="off"),
    dict(device_batch=8), dict(chunk_seconds=12.0), dict(pad_seconds=2.9),
    dict(precision="fast"),
], ids=lambda c: next(iter(c)))
def test_numerics_change_invalidates_journal(tmp_path, change):
    """Every knob that changes the numerics is in the header, with the
    port's own backend tag.  ``conv_impl`` is not, as in the JAX header: the
    port computes "direct" for "packed"."""
    path = _wav(tmp_path, seconds=6.0)
    jd = str(tmp_path / "progress")
    h0 = _make_journal(_det(), path, jd).header
    assert h0["backend"] == backend_tag(torch.device("cpu")) == "torch-cpu"
    assert "conv_impl" not in h0
    assert _make_journal(_det(), path, jd).header == h0
    assert _make_journal(_det(conv_impl="packed"), path, jd).header == h0
    assert _make_journal(_det(**change), path, jd).header != h0


def test_host_pipeline_logs_and_does_not_journal(tmp_path, caplog):
    path = _wav(tmp_path, seconds=6.0)
    jd = str(tmp_path / "progress")
    det = _det(pipeline="host")
    with caplog.at_level("WARNING"):
        res = det.detect_file_streaming(path, journal_dir=jd)
    assert res.num_windows > 0
    assert "requires the fused pipeline" in caplog.text
    assert not os.path.exists(jd)


def test_orphan_tmp_files_are_swept(tmp_path):
    p = str(tmp_path / "j.chunks.npz")
    (tmp_path / "j.chunks.npz.tmp99999").write_bytes(b"stranded")
    j = ChunkJournal(p, {"k": 1})
    j.save([np.ones(4, np.float32)], np.zeros(2, np.float32), np.zeros(2, np.float32))
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []
    (tmp_path / "j.chunks.npz.tmp12345").write_bytes(b"stranded")
    j.clear()
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []
    assert not os.path.exists(p)


def test_sweep_handles_glob_metachar_names_and_live_pids(tmp_path):
    p = str(tmp_path / "take [1].abcd.chunks.npz")
    (tmp_path / "take [1].abcd.chunks.npz.tmp99999").write_bytes(b"dead")
    live = f"take [1].abcd.chunks.npz.tmp{os.getppid()}"
    (tmp_path / live).write_bytes(b"live")
    j = ChunkJournal(p, {"k": 1})
    j.save([np.ones(4, np.float32)], np.zeros(2, np.float32), np.zeros(2, np.float32))
    assert sorted(f for f in os.listdir(tmp_path) if ".tmp" in f) == [live]


def test_npz_layout_and_load_equal_the_jax_journal(tmp_path):
    """The same parts saved by both packages load as the same state."""
    from softspoken_tpu.engine.journal import ChunkJournal as JChunkJournal

    parts = [np.arange(5, dtype=np.float32), np.arange(3, dtype=np.float32) + 9]
    cs, cc = np.linspace(0, 1, 4, dtype=np.float32), np.full(4, 2.0, np.float32)
    for i, cls in enumerate((ChunkJournal, JChunkJournal)):
        cls(str(tmp_path / f"{i}.npz"), {"k": 1}).save(parts, cs, cc)
    with np.load(tmp_path / "0.npz") as a, np.load(tmp_path / "1.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(
            ["header", "fins", "avg_flat", "carry_sum", "carry_cnt"])
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    for i, cls in enumerate((JChunkJournal, ChunkJournal)):
        st = cls(str(tmp_path / f"{i}.npz"), {"k": 1}).load()
        assert st.chunks_done == 2
        for got, want in zip(st.avg_parts, parts):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(st.carry_sum, cs)


def test_variables_digest_depends_on_dtype_and_matches_numpy_trees():
    f32 = torch.linspace(-1, 1, 32)
    assert variables_digest({"w": f32}) != variables_digest({"w": f32.to(torch.bfloat16)})
    assert variables_digest({"w": f32}) != variables_digest({"w": f32.double() + 1e-12})
    assert variables_digest({"w": f32}) == variables_digest({"w": f32.clone()})
    assert variables_digest({"a": f32, "b": f32 * 2}) != variables_digest({"a": f32 * 2, "b": f32})
    # numpy leaves digest as the JAX package's do
    tree = {"p": {"w": np.linspace(-1, 1, 8, dtype=np.float32), "b": np.zeros(3)}}
    assert variables_digest(tree) == jax_variables_digest(tree)
    bf = {"w": np.linspace(-1, 1, 8, dtype=np.float32).astype(ml_dtypes.bfloat16)}
    assert variables_digest(bf) == jax_variables_digest(bf)


def test_detector_digest_follows_weights_and_precision():
    a, b = _det(seed=0), _det(seed=0)
    assert a.weights_digest() == b.weights_digest()
    assert _det(seed=3).weights_digest() != a.weights_digest()
    assert _det(precision="fast").weights_digest() != a.weights_digest()


def test_a_jax_journal_is_discarded_by_the_port(tmp_path):
    path = _wav(tmp_path)
    jd = str(tmp_path / "progress")
    jeng = {k: v for k, v in ENG.items()}
    jdet = JDetector(JConfig().with_engine(**jeng), variables=jckpt.fixture_variables(seed=0))
    jengine = jax_get_fused_engine(jdet, 16000, "i16")
    fn, calls = jengine._fn, []

    def killer(*a):
        if len(calls) >= 1:
            raise RuntimeError("simulated preemption")
        calls.append(1)
        return fn(*a)

    jengine._fn = killer
    try:
        with pytest.raises(RuntimeError):
            jdet.detect_file_fused(path, journal_dir=jd)
    finally:
        jengine._fn = fn
    assert len(os.listdir(jd)) == 1  # the same sidecar name in both packages
    det = _det()
    engine = get_fused_engine(det, 16000, "i16")
    with _Programs(engine) as count:
        res = det.detect_file_streaming(path, journal_dir=jd)
    assert count.calls == -(-res.num_windows // engine.chunk_w)  # not resumed
    assert os.listdir(jd) == []
    np.testing.assert_array_equal(res.avg_values, det.detect_file_streaming(path).avg_values)


def test_a_port_journal_is_discarded_by_the_jax_package(tmp_path):
    path = _wav(tmp_path)
    jd = str(tmp_path / "progress")
    _killed(_det(), path, jd)
    jdet = JDetector(JConfig().with_engine(**ENG), variables=jckpt.fixture_variables(seed=0))
    jengine = jax_get_fused_engine(jdet, 16000, "i16")
    fn, calls = jengine._fn, []

    def counter(*a):
        calls.append(1)
        return fn(*a)

    jengine._fn = counter
    try:
        res = jdet.detect_file_fused(path, journal_dir=jd)
    finally:
        jengine._fn = fn
    assert len(calls) == -(-res.num_windows // jengine.chunk_w)  # not resumed
    assert os.listdir(jd) == []
