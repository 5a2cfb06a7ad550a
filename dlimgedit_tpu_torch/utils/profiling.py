"""Per-executable call-latency recorder and device traces (counterparts
of the ``Profiler`` and ``xplane_trace`` in dlimgedit_tpu/utils/profiling.py).

PyTorch returns from a CUDA call before the device has finished, so on a
CUDA device the recorder synchronises the device before it starts and
before it stops the clock: a recorded time covers completed work. It costs
nothing when disabled (``wrap`` returns the function itself).
``chrome_trace`` records the host's and the device's timeline of a block
with torch.profiler and writes it as a Chrome trace (Perfetto,
chrome://tracing), the port's form of JAX's XPlane trace.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch


@dataclass
class CallStats:
    count: int = 0
    total_ms: float = 0.0
    min_ms: float = float("inf")
    max_ms: float = 0.0

    def record(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.min_ms = min(self.min_ms, ms)
        self.max_ms = max(self.max_ms, ms)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / self.count if self.count else 0.0


class Profiler:
    """Per-key latency recorder (thread-safe)."""

    def __init__(self, enabled: bool = False,
                 device: Optional[torch.device] = None):
        self.enabled = enabled
        self._cuda = device is not None and device.type == "cuda"
        self._device = device
        self._stats: Dict[str, CallStats] = defaultdict(CallStats)
        self._lock = threading.Lock()

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize(self._device)

    @contextlib.contextmanager
    def measure(self, key: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            ms = (time.perf_counter() - t0) * 1e3
            with self._lock:
                self._stats[key].record(ms)

    def wrap(self, key: str, fn):
        if not self.enabled:
            return fn

        def wrapped(*args, **kwargs):
            with self.measure(key):
                return fn(*args, **kwargs)

        return wrapped

    def stats(self) -> Dict[str, CallStats]:
        with self._lock:
            return dict(self._stats)

    def report(self) -> str:
        lines = [f"{'key':<48} {'count':>6} {'mean ms':>9} {'min':>8} {'max':>8}"]
        for key, s in sorted(self.stats().items()):
            lines.append(f"{key:<48} {s.count:>6} {s.mean_ms:>9.2f} "
                         f"{s.min_ms:>8.2f} {s.max_ms:>8.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def chrome_trace(log_dir, name: str = "trace") -> Iterator[
        "torch.profiler.profile"]:
    """Trace the block with torch.profiler (CPU activity, and CUDA activity
    where a device is present) and write ``<log_dir>/<name>.json``, a
    Chrome trace. Yields the profiler, whose ``events()`` hold the block's
    operations; the device's work is synchronised before the trace ends."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / f"{name}.json"))
