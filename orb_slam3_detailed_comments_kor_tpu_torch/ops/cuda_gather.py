"""Per-keypoint patch gather: the ``gather_patches`` CUDA kernel.

Replaces ``gather_patches`` of
``orb_slam3_detailed_comments_kor_tpu/ops/pallas_gather.py`` (Pallas body
``_kernel_factory`` at :29, ``pl.pallas_call`` in
``_gather_patches_pallas`` at :91). Used twice per frame: the [K,48,45]
ORB patches and the [K,11,21] right-image SAD strips. The kernel
(``csrc/gather_patches.cu``) is a pure copy, bound by memory latency; one
block per keypoint reads each patch row by row so the accesses coalesce.
"""

from __future__ import annotations

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda


def gather_patches_plain(img2d, rows, cols, ph: int, pw: int):
    """Plain PyTorch version: advanced-index gather at (already clamped)
    corners."""
    dy = torch.arange(ph, device=img2d.device)
    dx = torch.arange(pw, device=img2d.device)
    return img2d[
        rows[:, None, None] + dy[None, :, None],
        cols[:, None, None] + dx[None, None, :],
    ]


def gather_patches(img2d, rows, cols, ph: int, pw: int):
    """img2d [R,W]; rows/cols [K] int top-left corners (clamped here to
    [0, R-ph] x [0, W-pw]). Returns [K, ph, pw] patches. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    R, W = img2d.shape
    rows = torch.clamp(rows, 0, R - ph).to(torch.int32)
    cols = torch.clamp(cols, 0, W - pw).to(torch.int32)
    if img2d.device.type == "cpu":
        return gather_patches_plain(img2d, rows, cols, ph, pw)
    rows, cols = rows.contiguous(), cols.contiguous()
    _cuda.check_cuda(img2d, rows, cols)
    if img2d.dtype != torch.float32:
        raise ValueError(f"expected float32 image, got {img2d.dtype}")
    K = rows.shape[0]
    out = torch.empty((K, ph, pw), dtype=img2d.dtype, device=img2d.device)
    _cuda.launch(
        "osk_gather_patches", img2d.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), out.data_ptr(), R, W, K, ph, pw, _cuda.stream(),
    )
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
