"""The port's multi-process start-up and file partitions
(``parallel/distributed.py``) and ``detect --distributed`` with ``project
merge-detections``, on the CPU over gloo, against the JAX package's
``parallel/distributed.py``."""

import datetime
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from softspoken_tpu.parallel import merge_partition_stores as jmerge
from softspoken_tpu.parallel import partition_files as jpartition
from softspoken_tpu.project.store import DetectionStore as JStore
from softspoken_tpu_torch.io import wavio
from softspoken_tpu_torch.parallel import (init_distributed, merge_partition_stores,
                                           partition_files)
from softspoken_tpu_torch.parallel import distributed as pdist
from softspoken_tpu_torch.project.store import DetectionStore

from torch_parallel_worker import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


# ---------------------------------------------------------------------------
# partition_files

@pytest.mark.parametrize("n_files,n", [(11, 4), (7, 3), (10, 1), (10, 2), (10, 3), (10, 5),
                                       (3, 2), (2, 4)])
def test_partition_files_equals_jax(n_files, n):
    """The same sorted round-robin as JAX for any input order; complete,
    disjoint, balanced within one file (the uneven 7/3 included)."""
    files = [f"/x/rec{i:02d}.wav" for i in range(n_files)][::-1]
    parts = [partition_files(files, process_id=p, num_processes=n) for p in range(n)]
    assert parts == [jpartition(files, process_id=p, num_processes=n) for p in range(n)]
    assert sorted(sum(parts, [])) == sorted(files)
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 1


def test_partition_files_defaults_to_one_process():
    files = ["b.wav", "a.wav"]
    assert not dist.is_initialized()
    assert partition_files(files) == ["a.wav", "b.wav"]


# ---------------------------------------------------------------------------
# init_distributed

@pytest.fixture
def calls(monkeypatch):
    """init_process_group and set_device recorded, not run; no torchrun
    environment."""
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    got = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: got.append(dict(backend=backend, **kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: got.append({"set_device": d}))
    return got


def test_init_distributed_without_a_cluster_is_a_noop(calls, monkeypatch):
    assert init_distributed() is None
    assert init_distributed(device="cpu") is None
    # an explicit single process never joins, even inside a launcher's environment
    for k, v in dict(MASTER_ADDR="h", MASTER_PORT="1", WORLD_SIZE="4", RANK="2").items():
        monkeypatch.setenv(k, v)
    assert init_distributed(num_processes=1) is None
    assert init_distributed("10.0.0.1:1234", num_processes=1, process_id=0) is None
    assert calls == []


def test_init_distributed_reads_the_torchrun_environment(calls, monkeypatch):
    for k, v in dict(MASTER_ADDR="h", MASTER_PORT="29500", WORLD_SIZE="2", RANK="1").items():
        monkeypatch.setenv(k, v)
    assert init_distributed(device="cpu") == torch.device("cpu")
    assert calls == [dict(backend="gloo", init_method="env://", world_size=2, rank=1,
                          timeout=datetime.timedelta(seconds=pdist.COLLECTIVE_TIMEOUT_S))]


def test_init_distributed_passes_explicit_arguments(calls):
    assert init_distributed("10.0.0.1:1234", num_processes=2, process_id=1,
                            device="cpu") == torch.device("cpu")
    assert calls == [dict(backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=2,
                          rank=1, timeout=datetime.timedelta(seconds=pdist.COLLECTIVE_TIMEOUT_S))]


def test_init_distributed_takes_a_card_per_process_with_nccl(calls, monkeypatch):
    """Without --device: the card process_id % device_count, or LOCAL_RANK;
    made current before the group starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert init_distributed("h:1", num_processes=8, process_id=6) == torch.device("cuda", 2)
    assert calls[0] == {"set_device": torch.device("cuda", 2)}
    assert calls[1]["backend"] == "nccl"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert init_distributed("h:1", num_processes=8, process_id=6) == torch.device("cuda", 3)


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_init_distributed_with_a_named_card_still_takes_one_card_per_process(
        calls, monkeypatch, device):
    """`detect --distributed --device cuda` (or a numbered card): each
    process still takes its own card (rank % count, or LOCAL_RANK), made
    current by its index; NCCL refuses two ranks on one card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert init_distributed("h:1", num_processes=4, process_id=1,
                            device=device) == torch.device("cuda", 1)
    assert calls[0] == {"set_device": torch.device("cuda", 1)}
    assert calls[1]["backend"] == "nccl" and calls[1]["rank"] == 1
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert init_distributed("h:1", num_processes=4, process_id=1,
                            device=device) == torch.device("cuda", 2)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", "cpu"])
def test_rank_devices_lists_one_device_per_rank(monkeypatch, device):
    """A process mesh's device list (`train --mesh`): this rank's own
    device (LOCAL_RANK under torchrun) and every other rank's card."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    got = pdist.rank_devices(2, 4, device)
    if device == "cpu":
        assert got == [torch.device("cpu")] * 4
        return
    assert got == [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setenv("LOCAL_RANK", "0")  # a second host's first process
    assert pdist.rank_devices(6, 8, device)[6] == torch.device("cuda", 0)


def test_init_distributed_without_a_card_or_an_address_raises(calls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("h:1", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="coordinator address"):
        init_distributed(num_processes=2, process_id=0, device="cpu")
    assert calls == []


def test_two_processes_bootstrap_and_all_reduce(tmp_path):
    """A real 2-process gloo group: each rank adds rank + 1."""
    outs = run_ranks("allreduce", 2, tmp_path, timeout=120)
    assert [float(o["sum"]) for o in outs] == [3.0, 3.0]


# ---------------------------------------------------------------------------
# merge_partition_stores

def _partitions(root, store_cls):
    """p0 detected a.wav (two rows); p1 processed a quiet b.wav (no rows);
    p2 detected c.wav (one row)."""
    p0 = store_cls(os.path.join(root, "det.p0.csv"))
    p0.append_intervals("/x/a.wav", [(1.0, 2.0), (3.0, 4.5)])
    p0.mark_processed("/x/a.wav")
    p0.save()
    p1 = store_cls(os.path.join(root, "det.p1.csv"))
    p1.mark_processed("/x/b.wav")
    p1.save()
    p2 = store_cls(os.path.join(root, "det.p2.csv"))
    p2.append_intervals("/x/c.wav", [(0.5, 0.9)])
    p2.mark_processed("/x/c.wav")
    p2.save()


@pytest.mark.parametrize("writer", [JStore, DetectionStore], ids=["jax-parts", "port-parts"])
def test_merge_partition_stores_is_byte_equal_to_jax(tmp_path, writer):
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    _partitions(str(a), writer)
    shutil.copytree(a, b)
    want = jmerge(str(a / "det.csv"))
    got = merge_partition_stores(str(b / "det.csv"))
    assert got == {**want, "store": str(b / "det.csv")}
    assert got["partitions"] == 3 and got["files"] == 3 and got["rows"] == 3
    for name in ("det.csv", "det.csv.processed"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == ["det.csv", "det.csv.processed"]
    again = merge_partition_stores(str(b / "det.csv"))  # idempotent
    assert again["partitions"] == 0 and len(DetectionStore(str(b / "det.csv")).rows) == 3


def test_merge_takes_a_partitions_files_in_sorted_order(tmp_path):
    """Several files in one partition: the port merges them in sorted
    order (the JAX merge walks a set, whose order varies between
    processes); the rows and the processed files are JAX's."""
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    p0 = JStore(str(a / "d.p0.csv"))
    for f, iv in (("/x/z.wav", [(1.0, 2.0)]), ("/x/m.wav", [(0.25, 0.5)]), ("/x/a.wav", [])):
        p0.append_intervals(f, iv)
        p0.mark_processed(f)
    p0.save()
    shutil.copytree(a, b)
    jmerge(str(a / "d.csv"), remove=False)
    merge_partition_stores(str(b / "d.csv"), remove=False)
    assert os.path.exists(b / "d.p0.csv")
    rows = DetectionStore(str(b / "d.csv")).rows
    assert [r["file_name"] for r in rows] == ["m.wav", "z.wav"]
    jrows = DetectionStore(str(a / "d.csv")).rows
    key = lambda r: (r["file_name"], r["start_time"], r["end_time"])  # noqa: E731
    assert sorted(map(key, rows)) == sorted(map(key, jrows))
    assert (DetectionStore(str(b / "d.csv")).processed_files()
            == DetectionStore(str(a / "d.csv")).processed_files())


# ---------------------------------------------------------------------------
# detect --distributed + project merge-detections

def _cli(args, cwd, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-m", "softspoken_tpu_torch", *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(procs, timeout=240):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def test_two_process_distributed_detect_and_merge_equal_one_process(tmp_path):
    """Two processes detect their share of a project's files into
    per-process stores; `project merge-detections` gathers them into a
    detections CSV byte-identical to one process's.  (Two files: the merge
    appends partition by partition, so with more files than processes the
    rows' order, not their content, would differ from a sequential run.)"""
    rng = np.random.default_rng(5)
    files = []
    for i in range(2):
        p = str(tmp_path / f"rec{i}.wav")
        wavio.write(p, (0.3 * rng.standard_normal(2 * 22050)).astype(np.float32), 22050,
                    subtype="PCM_16")
        files.append(p)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"engine": {"precision": "parity", "device_batch": 4,
                              "chunk_seconds": 12.0}}, f)
    for d in ("one", "two"):
        _finish([_cli(["--project-dir", d, "project", "new", "P", *files], tmp_path)])
    common = ["--config", cfg, "detect", "--project", "P", "--random-init", "--device", "cpu"]
    port = pdist.free_port()
    procs = [_cli(["--project-dir", "one", *common], tmp_path)]
    procs += [_cli(["--project-dir", "two", *common, "--distributed", "--coordinator",
                    f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r)],
                   tmp_path) for r in range(2)]
    outs = _finish(procs)
    for r in (0, 1):
        report = json.loads(outs[1 + r][outs[1 + r].index("{"):])
        assert report["files_done"] == 1 and report["detections_csv"].endswith(f".p{r}.csv")
    merged = _finish([_cli(["--project-dir", "two", "project", "merge-detections", "P"],
                           tmp_path)])[0]
    assert json.loads(merged.strip().splitlines()[-1])["files"] == 2
    one = tmp_path / "one" / "Softspoken Outputs" / "P" / "P_detections.csv"
    two = tmp_path / "two" / "Softspoken Outputs" / "P" / "P_detections.csv"
    assert one.read_bytes() == two.read_bytes()
    assert len(one.read_text().splitlines()) >= 3
    assert sorted(os.listdir(two.parent)) == sorted(os.listdir(one.parent))
