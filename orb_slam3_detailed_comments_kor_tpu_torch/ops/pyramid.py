"""Image pyramid as banded resize matmuls.

Port of ``level_shapes``, ``resize_weights`` and ``resize_matmul`` from
``orb_slam3_detailed_comments_kor_tpu/ops/pyramid.py``.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def level_shapes(h: int, w: int, n_levels: int, scale: float) -> List[Tuple[int, int]]:
    """Static per-level (H, W). Matches cv::round(h / scale^l)."""
    out = []
    for l in range(n_levels):
        inv = 1.0 / (scale ** l)
        out.append((int(round(h * inv)), int(round(w * inv))))
    return out


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 antialiased triangle-filter matrix.

    These are the weights the reference pipeline really multiplies by. Its
    ``resize_weights`` first asks jax's private ``compute_weight_mat``, but
    ``extract_orb_batch`` calls it while being traced under ``jax.jit``,
    where that returns a tracer, ``np.asarray`` raises, and the reference
    falls back to this float64 formula cast to float32. Rebuilding the
    formula in numpy gives the same bits (checked in the tests); the
    eager ``compute_weight_mat`` weights differ from it by up to 4e-5.
    """
    scale = out_size / in_size
    sample_f = (np.arange(out_size) + 0.5) / scale - 0.5
    kscale = min(scale, 1.0)  # antialias: widen the kernel when shrinking
    x = np.abs(sample_f[:, None] - np.arange(in_size)[None, :]) * kscale
    w = np.maximum(0.0, 1.0 - x)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    # one host-to-device copy per (shape, device), not one per frame
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


def resize_matmul(img: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """Separable linear+antialias resize of [..., H, W] via two matmuls."""
    A = _weights_on(img.shape[-2], h_out, img.device)
    B = _weights_on(img.shape[-1], w_out, img.device)
    return torch.matmul(torch.matmul(A, img), B.T)
