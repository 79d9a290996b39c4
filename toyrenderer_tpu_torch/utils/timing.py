"""Timers (reference: Utilities.h:70-110 Timer / ScopedTimer, which log
phase durations at startup), and the frame's profiler ranges."""

from __future__ import annotations

import contextlib
import logging
import time

import torch

log = logging.getLogger("toyrenderer_tpu_torch")


class Timer:
    def __init__(self):
        self.start = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self.start) * 1000.0

    def reset(self):
        self.start = time.perf_counter()


class ScopedTimer:
    """`with ScopedTimer("load scene"):` -- logs the duration on exit."""

    def __init__(self, label: str, printer=None):
        self.label = label
        self.printer = printer or (lambda msg: log.info(msg))

    def __enter__(self):
        self.t = Timer()
        return self.t

    def __exit__(self, *exc):
        self.printer(f"{self.label}: {self.t.elapsed_ms():.1f} ms")
        return False


def profiler_range(label: str):
    """A torch.profiler range named `label` while a profiler records
    (tools/passes.py), else a context that does nothing: outside a
    profile the frame's ranges cost nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(label)
    return contextlib.nullcontext()
