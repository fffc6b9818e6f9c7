"""Image pyramid as banded resize matmuls, and the separable Gaussian blur.

Port of ``orb_slam3_detailed_comments_kor_tpu/ops/pyramid.py``, every
function of it. The frame path builds its pyramid with ``resize_matmul``
(the weights of ``resize_weights``); ``build_pyramid``, the reference's
per-level list in which each level is resized from the one before, goes
through ``jax.image.resize`` there, whose own weights ``_eager_weights``
rebuilds.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


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


@functools.lru_cache(maxsize=None)
def _eager_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32: the weights ``jax.image.resize(...,
    "linear", antialias=True)`` builds (``compute_weight_mat``) as XLA
    compiles it on the CPU: in float32, the division by the kernel scale as
    a product with its reciprocal, the two multiply-adds fused (each
    emulated here by one float64 operation rounded once), the column sums
    taken in row order. Within 2e-6 of jax's weights at the 480x752 / 1.2
    pyramid's shapes, where ``resize_weights``'s float64 formula is up to
    4e-5 away."""
    f32 = np.float32
    inv = f32(in_size / out_size)
    r = f32(1.0) / f32(max(in_size / out_size, 1.0))
    a = np.arange(out_size, dtype=f32) + f32(0.5)
    sample = (a.astype(np.float64) * np.float64(inv) - 0.5).astype(f32)
    d = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), (1.0 - d.astype(np.float64) * np.float64(r)).astype(f32))
    total = np.zeros(out_size, f32)
    for row in w:
        total = total + row
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T, dtype=f32)


def build_pyramid(img: torch.Tensor, n_levels: int, scale: float) -> List[torch.Tensor]:
    """img [H,W] float32 -> list of n_levels images, level l scaled by
    scale^-l, each resized from the level before it (as the reference
    does), not from level 0. An axis whose size does not change is left as
    it is, as ``jax.image.resize`` leaves it."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for hl, wl in shapes[1:]:
        prev = levels[-1]
        if hl != prev.shape[0]:
            prev = torch.from_numpy(_eager_weights(prev.shape[0], hl)).to(img.device) @ prev
        if wl != prev.shape[1]:
            prev = prev @ torch.from_numpy(_eager_weights(prev.shape[1], wl)).to(img.device).T
        levels.append(prev)
    return levels


def _gauss_kernel(ksize: int, sigma: float) -> torch.Tensor:
    """[ksize] float32 Gaussian taps, normalized to sum 1."""
    r = (ksize - 1) / 2
    x = torch.arange(ksize, dtype=torch.float32) - r
    k = torch.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding, [...,H,W] -> [...,H,W]
    (batch dims pass through): the vertical pass, then the horizontal,
    each a sum of the ``ksize`` shifted images in tap order."""
    k = _gauss_kernel(ksize, sigma).tolist()
    r = ksize // 2
    H, W = img.shape[-2], img.shape[-1]
    flat = img.reshape(-1, 1, H, W)
    p = F.pad(flat, (0, 0, r, r), mode="reflect")
    v = torch.zeros_like(flat)
    for i in range(ksize):
        v = v + k[i] * p[..., i:i + H, :]
    p = F.pad(v, (r, r, 0, 0), mode="reflect")
    out = torch.zeros_like(flat)
    for i in range(ksize):
        out = out + k[i] * p[..., i:i + W]
    return out.reshape(img.shape)
