"""Run a function of a benchmark file in worker processes.

The benchmark's files are loaded by path (``registry.load_module``), so a
worker process cannot import them by name.  ``call(path, name, *args)``
loads the file in the worker (once) and calls its function ``name``;
``map_calls`` runs a list of such calls on ``workers`` spawned processes,
results in order.
"""

from __future__ import annotations

import importlib.util
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Sequence

_LOADED: Dict[str, object] = {}


def call(path: str, name: str, *args):
    mod = _LOADED.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location("_bench_worker_" + str(len(_LOADED)), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return getattr(mod, name)(*args)


def map_calls(path: str, name: str, arg_lists: Sequence[tuple], workers: int) -> List:
    if workers <= 1:
        return [call(path, name, *a) for a in arg_lists]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        futs = [ex.submit(call, path, name, *a) for a in arg_lists]
        return [f.result() for f in futs]
