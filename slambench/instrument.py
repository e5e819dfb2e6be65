"""Wrappers the benchmark puts around the program's functions, by name:
profiler ranges, call counters and torch's sync debug mode. Nothing here
changes what a wrapped function computes."""

from __future__ import annotations

import functools
import importlib
import warnings

import torch

PROGRAM = "dpg_slam_tpu_torch"


def resolve(target: str):
    """'batch._batched_solve' -> (module dpg_slam_tpu_torch.batch, attribute)."""
    mod, _, attr = target.rpartition(".")
    module = importlib.import_module(f"{PROGRAM}.{mod}")
    if not hasattr(module, attr):
        raise AttributeError(f"{PROGRAM}.{mod} has no {attr}: a metric names a function the program lacks")
    return module, attr


class Patches:
    """Module attributes replaced by wrappers, restored on close."""

    def __init__(self):
        self._saved = []

    def wrap(self, target: str, make):
        """Replace target by make(original)."""
        module, attr = resolve(target)
        orig = getattr(module, attr)
        self._saved.append((module, attr, orig))
        setattr(module, attr, functools.wraps(orig)(make(orig)))

    def close(self):
        while self._saved:
            module, attr, orig = self._saved.pop()
            setattr(module, attr, orig)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def ranged(name: str):
    """A wrapper maker that opens a profiler range named `name` around
    every call."""
    def make(fn):
        def call(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return call
    return make


def count_syncs(run):
    """(run(), number of host syncs it made), by torch's sync debug mode
    (chip_smoke.py's count_syncs); (run(), None) without a card."""
    if not torch.cuda.is_available():
        return run(), None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)

