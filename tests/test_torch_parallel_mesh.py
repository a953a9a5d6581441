"""The port's window-sharded detection (``parallel/mesh.py``) on the CPU,
against the port's single-device run and against the JAX package's
``MeshDetector`` on the conftest's 8 virtual CPU devices
(tests/test_parallel.py's cases, which that file marks ``slow`` for JAX).

A mesh of CPU devices stands in for the cards: ``make_mesh(devices=["cpu"] * n)``
lists one device n times, and each entry still holds its own replica.
"""

import os

import numpy as np
import pytest
import torch

from softspoken_tpu import Config as JConfig
from softspoken_tpu import ckpt as jckpt
from softspoken_tpu.engine import Detector as JDetector
from softspoken_tpu.engine.fused import detect_file_fused as jax_detect_file_fused
from softspoken_tpu.io import wavio as jwavio
from softspoken_tpu.parallel import MeshDetector as JMeshDetector
from softspoken_tpu.parallel import make_mesh as jmake_mesh
from softspoken_tpu_torch import Config
from softspoken_tpu_torch.ckpt import fixture_state_dict
from softspoken_tpu_torch.engine import Detector
from softspoken_tpu_torch.engine.fused import detect_file_fused, get_fused_engine
from softspoken_tpu_torch.ops import KERNEL_LAUNCHES
from softspoken_tpu_torch.parallel import Mesh, MeshDetector, make_mesh, shard_windows_forward
from softspoken_tpu_torch.project.store import DetectionStore
from softspoken_tpu_torch.runtime import DetectRunner

torch.set_num_threads(2)

ENG = dict(precision="parity", device_batch=8, chunk_seconds=12.0)
CFG = Config().with_engine(**ENG)


def cpus(n):
    return ["cpu"] * n


def _det(cfg=CFG):
    return Detector(cfg, state_dict=fixture_state_dict(0), device="cpu")


def _jdet(**eng):
    return JDetector(JConfig().with_engine(**{**ENG, **eng}),
                     variables=jckpt.fixture_variables(seed=0))


@pytest.fixture(scope="module")
def audio():
    return np.random.default_rng(0).uniform(-0.4, 0.4, 22050 * 20).astype(np.float32)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("mesh") / "f.wav")
    rng = np.random.default_rng(4)
    jwavio.write(p, rng.uniform(-0.4, 0.4, 22050 * 15).astype(np.float32), 22050,
                 subtype="PCM_16")
    return p


# ---------------------------------------------------------------------------
# meshes and guards

def test_make_mesh_shapes():
    m = make_mesh(("data",), devices=cpus(8))
    assert isinstance(m, Mesh) and m.devices.shape == (8,) and m.size == 8
    m2 = make_mesh(("data", "seq"), shape=(4, 2), devices=cpus(8))
    assert m2.shape == {"data": 4, "seq": 2}
    assert all(d == torch.device("cpu") for d in m2.devices.flat)
    assert m2.axis_devices("data") == [torch.device("cpu")] * 4
    assert make_mesh(("data", "seq"), devices=cpus(3)).shape == {"data": 3, "seq": 1}


def test_make_mesh_without_a_card_raises(monkeypatch):
    """The default is every visible card; none visible and no devices
    named is an error, never a quiet CPU mesh."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_mesh_detector_rejects_bad_batch():
    det = _det(Config().with_engine(precision="parity", device_batch=6, chunk_seconds=12.0))
    with pytest.raises(ValueError, match="multiple of the mesh 'data' axis"):
        MeshDetector(det, make_mesh(("data",), devices=cpus(8)))


def test_mesh_detector_needs_a_data_axis():
    with pytest.raises(ValueError, match="no 'data' axis"):
        MeshDetector(_det(), make_mesh(("seq",), devices=cpus(2)))


def test_mesh_detector_data_axis_divisibility():
    """device_batch divides the data axis, not the mesh: a (4, 2) data × seq
    mesh takes device_batch 4."""
    det = _det(Config().with_engine(precision="parity", device_batch=4, chunk_seconds=12.0))
    with MeshDetector(det, make_mesh(("data", "seq"), shape=(4, 2), devices=cpus(8))) as w:
        assert len(det._forward_chunk.models) == 4
        assert w.mesh.size == 8


def test_mesh_detector_refuses_double_wrap():
    det = _det()
    mesh = make_mesh(devices=cpus(2))
    with MeshDetector(det, mesh):
        with pytest.raises(RuntimeError, match="already mesh-bound"):
            MeshDetector(det, mesh)
    with MeshDetector(det, mesh):  # after the restore, wrapping again is fine
        pass


def test_mesh_detector_restore_unwraps():
    det = _det()
    plain = det._forward_chunk
    w = MeshDetector(det, make_mesh(devices=cpus(2)))
    assert det._forward_chunk is not plain and det._fused_mesh is w.mesh
    w.restore()
    assert det._forward_chunk == plain and det._fused_mesh is None
    w.restore()  # idempotent
    with MeshDetector(det, make_mesh(devices=cpus(2))) as w2:
        assert det._fused_mesh is w2.mesh
    assert det._fused_mesh is None and det._forward_chunk == plain


def test_mesh_detector_passes_attributes_through():
    det = _det()
    with MeshDetector(det, make_mesh(devices=cpus(2))) as w:
        assert w.cfg is det.cfg and w.device == det.device
        assert w.weights_digest() == det.weights_digest()
        assert w.chunk_windows() == det.chunk_windows()


def test_every_entry_holds_its_own_replica():
    det = _det()
    fwd = shard_windows_forward(det, make_mesh(devices=cpus(4)))
    assert len({id(m) for m in fwd.models} | {id(det.model)}) == 5
    for m in fwd.models:
        for (k, a), b in zip(m.state_dict().items(), det.model.state_dict().values()):
            assert a.dtype == b.dtype and torch.equal(a, b), k


# ---------------------------------------------------------------------------
# sharded detection against one device

def test_sharded_detect_waveform_matches_single_device(audio):
    """The host pipeline, 20 s, windows over 8 entries: the same windows and
    intervals, the grid within rtol 1e-5, atol 1e-6 (the convolutions
    round per batch size)."""
    single = _det().detect_waveform(audio)
    det = _det()
    with MeshDetector(det, make_mesh(devices=cpus(8))) as w:
        got = w.detect_waveform(audio)
    assert got.num_windows == single.num_windows > 0
    np.testing.assert_allclose(got.avg_values, single.avg_values, rtol=1e-5, atol=1e-6)
    assert got.intervals == single.intervals


def test_sharded_fused_matches_single_device(wav):
    single = detect_file_fused(_det(), wav)
    det = _det()
    MeshDetector(det, make_mesh(devices=cpus(8)))
    got = detect_file_fused(det, wav)
    assert got.num_windows == single.num_windows > 0
    np.testing.assert_allclose(got.avg_values, single.avg_values, rtol=1e-5, atol=1e-6)
    assert got.intervals == single.intervals


def test_sharded_detect_waveform_matches_jax_mesh(audio):
    """Both packages sharded over 8 devices; the host pipelines' 1e-4
    (tests/test_torch_host.py)."""
    jdet = _jdet()
    ref = JMeshDetector(jdet, jmake_mesh(("data",))).detect_waveform(audio)
    with MeshDetector(_det(), make_mesh(devices=cpus(8))) as w:
        got = w.detect_waveform(audio)
    assert got.num_windows == ref.num_windows
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-4)
    assert got.intervals == ref.intervals


def test_sharded_fused_matches_jax_mesh(wav):
    """Fused against fused, both sharded over 8 devices; the fused parity
    tolerance of tests/test_torch_fused.py (1e-4)."""
    jdet = _jdet(pipeline="fused")
    JMeshDetector(jdet, jmake_mesh(("data",)))
    ref = jax_detect_file_fused(jdet, wav)
    det = _det()
    MeshDetector(det, make_mesh(devices=cpus(8)))
    got = detect_file_fused(det, wav)
    assert got.num_windows == ref.num_windows
    np.testing.assert_allclose(got.avg_values, ref.avg_values, atol=1e-4)
    assert got.intervals == ref.intervals


def test_the_fused_engine_is_cached_per_mesh(wav):
    det = _det()
    plain = get_fused_engine(det, 22050, "i16")
    with MeshDetector(det, make_mesh(devices=cpus(2))) as w:
        meshed = get_fused_engine(det, 22050, "i16")
        assert meshed is not plain and meshed.mesh is w.mesh
        assert get_fused_engine(w, 22050, "i16") is meshed
        assert meshed.device_only_rate(repeats=1) > 0
    assert get_fused_engine(det, 22050, "i16") is plain and plain.mesh is None


def test_journal_kill_and_resume_under_the_mesh(tmp_path, wav):
    """A sharded run killed after one chunk resumes from its sidecar,
    bit-equal to an uninterrupted sharded run, and clears the sidecar."""
    det = _det(Config().with_engine(precision="parity", device_batch=8, chunk_seconds=3.0))
    MeshDetector(det, make_mesh(devices=cpus(4)))
    baseline = det.detect_file_fused(wav)
    engine = get_fused_engine(det, 22050, "i16")
    n_chunks = -(-baseline.num_windows // engine.chunk_w)
    assert n_chunks >= 3
    calls = {"n": 0}
    program = engine._program

    def killed(*a, **k):
        if calls["n"] >= 1:
            raise RuntimeError("simulated preemption")
        calls["n"] += 1
        return program(*a, **k)

    jd = str(tmp_path / "progress")
    engine._program = killed
    with pytest.raises(RuntimeError, match="preemption"):
        det.detect_file_fused(wav, journal_dir=jd)
    del engine._program
    assert [f for f in os.listdir(jd) if f.endswith(".chunks.npz")]
    resumed = det.detect_file_fused(wav, journal_dir=jd)
    np.testing.assert_array_equal(resumed.avg_values, baseline.avg_values)
    assert resumed.intervals == baseline.intervals
    assert os.listdir(jd) == []


def test_runner_under_the_mesh_k2_equals_sequential(tmp_path, wav):
    """Three files through DetectRunner at file_concurrency 1 and 2 under a
    mesh: byte-identical CSVs; the meter counts the mesh's entries."""
    rng = np.random.default_rng(1)
    files = [wav]
    for j, secs in enumerate((7, 13)):
        p = str(tmp_path / f"r{j}.wav")
        jwavio.write(p, rng.uniform(-0.5, 0.5, secs * 22050).astype(np.float32), 22050,
                     subtype="PCM_16")
        files.append(p)
    det = _det(Config().with_engine(pipeline="fused", **ENG))
    MeshDetector(det, make_mesh(devices=cpus(2)))
    out = []
    for k in (1, 2):
        store = DetectionStore(str(tmp_path / f"k{k}.csv"))
        runner = DetectRunner(det, store, det.cfg.with_engine(file_concurrency=k),
                              streaming=True)
        report = runner.run(files)
        assert report.files_done == 3 and not report.errors
        assert runner.meter.n_chips == 2
        with open(store.path, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]


def test_the_sharded_host_path_launches_per_shard(audio, monkeypatch):
    """Each batch runs once per data entry: the forward is called shards ×
    batches times, on windows in shard order."""
    det = _det()
    seen = []
    forward = Detector._forward

    def spy(self, wave, starts, model=None):
        seen.append(starts.clone())
        return forward(self, wave, starts, model)

    monkeypatch.setattr(Detector, "_forward", spy)
    with MeshDetector(det, make_mesh(devices=cpus(4))):
        logits = det.mask_logits_for_padded(np.zeros(det.chunk_buffer_len(), np.float32))
    nb = -(-logits.shape[0] // 8)
    assert logits.shape[1] == 256 and len(seen) == 4 * nb
    assert all(len(s) == 2 for s in seen)
    # shard k of the first batch holds windows 2k and 2k + 1
    first = torch.cat([seen[k * nb] for k in range(4)])
    assert torch.equal(first, torch.arange(8, dtype=torch.int32) * det.cfg.samples_per_step)
    assert not KERNEL_LAUNCHES  # no kernel runs on the CPU
