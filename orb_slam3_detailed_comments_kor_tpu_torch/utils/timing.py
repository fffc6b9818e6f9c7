"""Per-stage timing / tracing (REGISTER_TIMES analog, structured output).

The reference gates ad-hoc ``std::chrono`` spans behind the compile-time
``REGISTER_TIMES`` flag (``include/Config.h:4``; spans in ``Tracking.cc:
1789-2172``, ``LocalMapping.cc:86-312``, ``LoopClosing.cc:75-282``) and
dumps text files at shutdown (``Tracking::PrintTimeStats``). Here tracing
is a runtime feature: nested stage spans accumulate on host and summaries
are structured JSON. Port of ``StageTimer`` from
``orb_slam3_detailed_comments_kor_tpu/utils/timing.py``; the spans time
the host (a span around device work times its dispatch unless the caller
synchronises). ``torch_profile`` takes the place of the reference's
``jax_profile``: ``torch.profiler`` around any block, device kernels
included.

Overhead when disabled: one attribute check per span.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional


class StageTimer:
    """Accumulates wall-time samples per named stage."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.samples: Dict[str, List[float]] = {}
        self._stack: List[str] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        # nested spans are recorded under "outer/inner"
        full = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = (time.perf_counter() - t0) * 1e3
            self._stack.pop()
            self.samples.setdefault(full, []).append(dt)

    def add(self, name: str, ms: float) -> None:
        if self.enabled:
            self.samples.setdefault(name, []).append(ms)

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-stage stats in ms (count/mean/p50/p95/max/total)."""
        import numpy as np

        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p95_ms": float(np.percentile(a, 95)),
                "max_ms": float(a.max()),
                "total_ms": float(a.sum()),
            }
        return out

    def dump_json(self, path: str) -> None:
        """Structured dump (PrintTimeStats / TrackStats2File analog)."""
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2, sort_keys=True)

    def report(self) -> str:
        lines = [f"{'stage':<40} {'n':>6} {'mean':>8} {'p95':>8} {'max':>8}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<40} {s['count']:>6} {s['mean_ms']:>8.2f} "
                f"{s['p95_ms']:>8.2f} {s['max_ms']:>8.2f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def torch_profile(logdir: Optional[str]):
    """Profile a block with ``torch.profiler`` (host activity, and the
    card's kernels where there is a card) and write a Chrome trace into
    ``logdir``. With no ``logdir`` it does nothing, as the reference's
    ``jax_profile``."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
