"""A ``torch.profiler`` trace, and wall-clock seconds per named phase.

Counterpart of the JAX package's ``utils/profiling.py``. ``trace`` records
the host and, with a card, the device (CUPTI) into a Chrome trace under
``logdir``; a profiler that cannot start raises (the JAX helper goes on
without a trace). ``PhaseTimer`` synchronizes the card at a phase's end
where the JAX helper waits for its arrays (``block_until_ready``).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into ``{logdir}/trace.json`` (Chrome trace
    format, readable by Perfetto); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseTimer:
    """Wall-clock seconds and call counts per named phase.

        t = PhaseTimer()
        with t.phase("encode", sync=enc_tensor): ...
        print(t.report())

    ``sync`` (a tensor or a device) on a card waits for the card's queued
    work before the phase's clock stops; without it a phase times only
    the host's launches."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        """One line per phase, the longest first: name, seconds, calls."""
        return "\n".join(f"{k:24s} {self.totals[k]:9.3f}s x{self.counts[k]}"
                         for k in sorted(self.totals, key=lambda k: -self.totals[k]))

