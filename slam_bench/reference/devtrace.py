"""Device activity from a ``torch.profiler`` run that records CUDA activity
only, and the arithmetic on it.

``device_events`` is a copy of the reading in the repo's chip smoke
script: kernels, copies and fills from the profiler's own records (host
activity is not recorded, since recording it costs about 0.4 ms of host
time per operation and would slow the run it measures). The rest works on
plain ``(start_us, name, duration_us)`` tuples, so it is tested on the CPU
with hand-made intervals.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

Event = Tuple[float, str, float]


def device_events(prof) -> List[Event]:
    """(start µs, name, µs) of every device activity in profile ``prof``."""
    from torch.autograd import DeviceType

    try:
        return [(e.start_ns() / 1e3, e.name(), e.duration_ns() / 1e3)
                for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    except AttributeError:  # a torch without these accessors
        return [(e.time_range.start, e.name, e.time_range.elapsed_us())
                for e in prof.events() if e.device_type == DeviceType.CUDA]


def merged_intervals(events: Iterable[Event]) -> List[Tuple[float, float]]:
    """The union of the events' [start, end) intervals, sorted, disjoint."""
    spans = sorted((s, s + d) for s, _, d in events if d > 0)
    out: List[List[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(events: Iterable[Event]) -> float:
    """Microseconds in which at least one operation ran on the device."""
    return sum(e - s for s, e in merged_intervals(events))


def idle_pct(events: Sequence[Event], window_us: float) -> float:
    """100 × (1 − busy ÷ window): the share of the window the device was
    idle."""
    return 100.0 * (1.0 - busy_us(events) / window_us)


def time_by_name(events: Iterable[Event]) -> Dict[str, float]:
    """Device µs summed per operation name."""
    out: Dict[str, float] = {}
    for _, name, d in events:
        out[name] = out.get(name, 0.0) + d
    return out


def idle_gaps(events: Sequence[Event]) -> List[Tuple[float, float]]:
    """(start µs, length µs) of each gap between merged busy intervals."""
    iv = merged_intervals(events)
    return [(a[1], b[0] - a[1]) for a, b in zip(iv, iv[1:]) if b[0] > a[1]]
