"""Multi-process start-up and work partitioning (the JAX package's
``parallel/distributed.py``), on ``torch.distributed``.

Detection is embarrassingly parallel over files: each process takes a
deterministic round-robin share of the sorted file list and writes its own
detections store, and ``merge_partition_stores`` gathers the stores through
the filesystem afterwards.  Training (``train --mesh``) runs one process per
card in a ``data × seq`` grid (``parallel/grid.py``); ``spawn`` starts them
when no launcher (``torchrun``) did.

Every process group is made with a timeout, so a rank that dies makes the
others' collectives fail instead of hanging; ``spawn`` raises in the parent
when a worker fails.
"""

from __future__ import annotations

import datetime
import glob
import logging
import os
import re
import socket
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

COLLECTIVE_TIMEOUT_S = 600.0
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def process_device(rank: int, device=None) -> torch.device:
    """The device of process ``rank``: the CPU when the caller names it
    ("cpu"), else a card of its own — ``LOCAL_RANK`` (set by ``torchrun``)
    or ``rank % device_count`` — whether ``device`` is None, "cuda" or a
    numbered card (one card per process: NCCL refuses two ranks on one).
    Raises when no card is visible."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' (--device cpu) to run "
                           "the processes on the CPU over gloo")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", int(local) if local is not None else rank % n)


def rank_devices(rank: int, world: int, device=None) -> List[torch.device]:
    """One device per rank of a process group, as a mesh lists them: this
    rank's from ``process_device``, every other rank's as it picks its own
    on a host of the same cards (``rank % device_count``)."""
    own = process_device(rank, device)
    if own.type == "cpu":
        return [own] * world
    n = torch.cuda.device_count()
    return [own if r == rank else torch.device("cuda", r % n) for r in range(world)]


def init_process_group(init_method: str, world_size: int, rank: int,
                       device: torch.device,
                       timeout_s: float = COLLECTIVE_TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` with NCCL on a card and gloo
    on the CPU, and a timeout on every collective.  A card becomes this
    process's current device first."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> Optional[torch.device]:
    """Join the process group (a no-op when single-process); returns this
    process's device, or None when nothing was initialized.

    * ``num_processes == 1`` is an explicit single-process request: no-op.
    * With no arguments, the environment ``torchrun`` sets (``MASTER_ADDR``,
      ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) initializes the group when
      present; otherwise this is a no-op (the JAX package's cluster
      auto-detection finding no cluster).
    * Otherwise ``tcp://<coordinator_address>`` with rank ``process_id`` of
      ``num_processes``; an argument left out is read from that same
      environment, and one missing there too raises.

    ``device`` "cpu" puts the process on the CPU (gloo); otherwise (None,
    "cuda" or a numbered card) it takes the card ``LOCAL_RANK`` or
    ``process_id % device_count`` (NCCL).
    """
    if num_processes == 1:
        log.debug("explicit num_processes=1; torch.distributed not initialized")
        return None
    env = os.environ
    if coordinator_address is None and num_processes is None and process_id is None:
        if not all(k in env for k in _TORCHRUN_ENV):
            log.debug("single-process run; torch.distributed not initialized")
            return None
        init_method = "env://"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
        rank = process_id if process_id is not None else _env_int("RANK")
        if coordinator_address is None or world is None or rank is None:
            raise ValueError("init_distributed needs the coordinator address, the "
                             "number of processes and this process's id (or the "
                             "torchrun environment)")
        init_method = f"tcp://{coordinator_address}"
    dev = process_device(rank, device)
    init_process_group(init_method, world, rank, dev)
    log.info("distributed: process %d/%d on %s", rank, world, dev)
    return dev


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def partition_files(files: Sequence[str], process_id: Optional[int] = None,
                    num_processes: Optional[int] = None) -> List[str]:
    """Deterministic per-process slice of the work list (sorted round-robin,
    so adding hosts rebalances without coordination)."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return sorted(files)[pid::n]


def merge_partition_stores(store_path: str, remove: bool = True) -> dict:
    """Gather the per-process ``<base>.pN<ext>`` detection stores of
    ``detect --distributed`` into the main store at ``store_path``, in
    partition order.

    File-granular and idempotent: a partition's file is skipped when the
    main store already processed it (each file is detected by exactly one
    process).  The partition CSVs and their ``.processed`` sidecars are
    deleted after the merge unless ``remove=False``.
    """
    from ..project.store import DetectionStore

    base, ext = os.path.splitext(store_path)
    own = re.escape(base) + r"\.p(\d+)" + re.escape(ext)
    parts = sorted((p for p in glob.glob(f"{glob.escape(base)}.p*{ext}")
                    if re.fullmatch(own, p)),
                   key=lambda p: int(re.fullmatch(own, p).group(1)))
    main = DetectionStore(store_path)
    done = main.processed_files()
    merged_rows = merged_files = 0
    for part_path in parts:
        part = DetectionStore(part_path)
        by_file: dict = {}
        for r in part.rows:
            full = os.path.join(r["file_path"], r["file_name"])
            by_file.setdefault(full, []).append(
                (float(r["start_time"]), float(r["end_time"])))
        for full in sorted(part.processed_files()):
            if full in done:
                continue
            merged_rows += main.append_intervals(full, by_file.get(full, []))
            main.mark_processed(full)
            done.add(full)
            merged_files += 1
    main.save()
    if remove:
        for part_path in parts:
            for p in (part_path, part_path + ".processed"):
                try:
                    os.remove(p)
                except OSError:
                    pass
    log.info("merged %d partition store(s): %d file(s), %d row(s) into %s",
             len(parts), merged_files, merged_rows, store_path)
    return {"partitions": len(parts), "files": merged_files,
            "rows": merged_rows, "store": store_path}


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes (the ``spawn``
    start method) and wait for all of them.  A worker that raises or exits
    non-zero terminates the others and raises here; so does ``timeout_s``
    running out (None: no deadline; each worker's collectives still time
    out)."""
    ctx = torch.multiprocessing.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while True:
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        if ctx.join(timeout=left):
            return
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"spawn: {nprocs} worker(s) still running after {timeout_s} s")
