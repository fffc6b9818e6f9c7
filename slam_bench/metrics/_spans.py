"""Host milliseconds per window frame in the port's ``StageTimer`` spans."""


def top_level(spans):
    """Spans not nested in another (names of the form ``group/stage``)."""
    return {k: v for k, v in spans.items() if k.count("/") == 1}


def ms_per_frame(run, names=(), prefix=None):
    if not run.window_frames:
        return None
    spans = top_level(run.spans)
    keys = [k for k in spans if k in names or (prefix is not None and k.startswith(prefix))]
    if not keys:
        return None
    return sum(sum(spans[k]) for k in keys) / run.window_frames
