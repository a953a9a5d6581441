"""Chunk-granular resume for the fused streaming engine.

A copy of the JAX package's ``engine/journal.py`` (the same ``.npz``
layout, atomic replace and orphan sweep); ``variables_digest`` walks a torch
state dict.

The reference's resume granularity is per-file (its detections CSV saves
after every completed file, ``worker.py:127-128``); a multi-hour file killed
at 90% reprocesses from zero.  The fused engine already threads a
device-resident carry between chunks, so everything needed to resume
mid-file is: the per-chunk averaged score grids completed so far plus the
carry after the last completed chunk.  ``ChunkJournal`` persists exactly
that as an atomically-replaced ``.npz`` sidecar.

A journal is only valid for the identical computation: the header captures
the source file's identity (size + mtime), the grid geometry, and a digest
of the model weights.  Any mismatch → the journal is ignored and deleted.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

_VERSION = 1


@dataclass
class ResumeState:
    chunks_done: int
    avg_parts: List[np.ndarray]      # trimmed per-chunk averaged grids
    carry_sum: np.ndarray            # (CARRY,) f32 after the last chunk
    carry_cnt: np.ndarray


def variables_digest(variables: Mapping[str, object]) -> str:
    """Stable sha256 over a state dict (or a nested dict of arrays), keys
    in sorted order; 16 hex digits.

    Torch tensors come to the host in one transfer: their bytes are
    concatenated where they live and fetched by a single ``.cpu()``, so a
    model on the card costs one device→host copy, not one per tensor.  The
    dtype is part of the identity (as in the JAX package): equal values in
    bfloat16 and float32, or float64 values that differ below float32's
    precision, must not digest alike, because a journal vouches for the
    identical computation and the numerics differ per dtype.
    """
    leaves: List[Tuple[str, object]] = []

    def walk(node, prefix: str) -> None:
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}")
        else:
            leaves.append((prefix, node))

    walk(variables, "")
    tensors = [v for _, v in leaves if isinstance(v, torch.Tensor)]
    host = {}
    if tensors:
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                          for t in tensors]).cpu().numpy()
        at = 0
        for t in tensors:
            n = t.numel() * t.element_size()
            host[id(t)] = flat[at: at + n]
            at += n
    h = hashlib.sha256()
    for prefix, node in leaves:
        h.update(prefix.encode())
        if isinstance(node, torch.Tensor):
            h.update(str(tuple(node.shape)).encode())
            h.update(str(node.dtype).encode())
            h.update(host[id(node)].tobytes())
        else:
            arr = np.asarray(node)
            h.update(str(arr.shape).encode())
            h.update(arr.dtype.str.encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


class ChunkJournal:
    """Sidecar persistence for one in-progress file detection."""

    def __init__(self, path: str, header: Dict):
        self.path = path
        self.header = dict(header, version=_VERSION)

    # ------------------------------------------------------------------
    def load(self) -> Optional[ResumeState]:
        """Return the resume state if the sidecar matches this computation."""
        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                header = json.loads(str(z["header"]))
                if header != self.header:
                    log.info("chunk journal %s is stale (header mismatch); "
                             "discarding", self.path)
                    self.clear()
                    return None
                fins = z["fins"].astype(np.int64)
                flat = z["avg_flat"].astype(np.float32)
                carry_sum = z["carry_sum"].astype(np.float32)
                carry_cnt = z["carry_cnt"].astype(np.float32)
        except Exception as e:  # noqa: BLE001 — corrupt sidecar = no resume
            log.warning("unreadable chunk journal %s (%s); discarding",
                        self.path, e)
            self.clear()
            return None
        parts: List[np.ndarray] = []
        at = 0
        for fin in fins:
            parts.append(flat[at: at + int(fin)])
            at += int(fin)
        if at != len(flat):
            self.clear()
            return None
        log.info("resuming %s from chunk %d", self.header.get("source", "?"),
                 len(parts))
        return ResumeState(len(parts), parts, carry_sum, carry_cnt)

    # ------------------------------------------------------------------
    def save(self, avg_parts: List[np.ndarray], carry_sum: np.ndarray,
             carry_cnt: np.ndarray) -> None:
        """Atomically replace the sidecar with the progress so far."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        buf = io.BytesIO()
        np.savez(
            buf,
            header=np.asarray(json.dumps(self.header, sort_keys=True)),
            fins=np.asarray([len(p) for p in avg_parts], np.int64),
            avg_flat=(np.concatenate(avg_parts).astype(np.float32)
                      if avg_parts else np.zeros(0, np.float32)),
            carry_sum=np.asarray(carry_sum, np.float32),
            carry_cnt=np.asarray(carry_cnt, np.float32),
        )
        self._sweep_orphan_tmps()
        tmp = f"{self.path}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        # fsync the directory so the rename itself survives power loss —
        # the file-level fsync alone only protects the tmp's CONTENTS
        try:
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # e.g. platforms where directories can't be fsynced

    def _sweep_orphan_tmps(self) -> None:
        """Remove tmp files stranded by a crash between write and replace.

        Each SIGKILL mid-save leaves one '<path>.tmp<pid>' behind — the
        exact scenario the journal exists for — and nothing else ever
        deletes them.  Only tmps whose writing pid is DEAD are swept: a live
        pid means a concurrent run on the same file is mid-save, and
        unlinking its tmp between write and os.replace would crash it
        (glob.escape because source stems like 'take [1]' are glob
        metacharacters).
        """
        import glob

        for stale in glob.glob(glob.escape(self.path) + ".tmp*"):
            pid_s = stale[len(self.path) + 4:]
            if pid_s == str(os.getpid()):
                continue
            try:
                os.kill(int(pid_s), 0)
            except (ValueError, ProcessLookupError):
                pass  # malformed suffix or dead pid: stale, sweep it
            except PermissionError:
                continue  # alive under another uid — leave it
            else:
                continue  # alive: a concurrent save owns it
            try:
                os.remove(stale)
            except OSError:
                pass

    def clear(self) -> None:
        self._sweep_orphan_tmps()
        try:
            os.remove(self.path)
        except OSError:
            pass


def journal_for(journal_dir: str, source_path: str, header: Dict) -> ChunkJournal:
    """Journal sidecar under ``journal_dir`` for one source file.

    The name keys on the absolute source path so concurrent runs over
    different files never collide.
    """
    tag = hashlib.sha256(os.path.abspath(source_path).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source_path))[0][:40]
    path = os.path.join(journal_dir, f"{stem}.{tag}.chunks.npz")
    return ChunkJournal(path, dict(header, source=os.path.abspath(source_path)))
