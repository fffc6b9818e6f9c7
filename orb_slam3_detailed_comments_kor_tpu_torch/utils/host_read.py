"""A device tensor on its way to the host without a wait in between.

On the card the tensor is copied with ``non_blocking=True`` into pinned
memory and a CUDA event is recorded behind the copy (the reference's
``copy_to_host_async``); ``is_ready`` asks the event, and ``numpy`` waits
on it only if the copy has not landed yet. A CPU tensor is read as is.
"""

from __future__ import annotations

import numpy as np
import torch


class HostRead:
    def __init__(self, x: torch.Tensor):
        if x.is_cuda:
            self.buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.buf.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf, self.event = x, None

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        # a pinned buffer read before its copy lands reads garbage
        if self.event is not None:
            self.event.synchronize()
        return self.buf.numpy()
