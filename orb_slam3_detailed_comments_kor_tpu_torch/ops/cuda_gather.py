"""Per-keypoint patch gather: the ``gather_patches`` CUDA kernel.

Replaces ``gather_patches`` of
``orb_slam3_detailed_comments_kor_tpu/ops/pallas_gather.py`` (Pallas body
``_kernel_factory`` at :29, ``pl.pallas_call`` in ``_gather_patches_pallas``
at :91, corner clamp at :116-117). Used twice per frame: the [K,48,45] ORB
patches (int64 rows, int32 columns) and the [K,11,21] right-image SAD
strips (int32 both). The kernel (``csrc/gather_patches.cu``) is a pure
copy, bound by bytes: one warp per keypoint clamps its corner and copies
the patch row by row, so the accesses coalesce. It takes the raw corners of
either integer type, so a call on the card is that one launch and nothing
else.
"""

from __future__ import annotations

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

_CORNER_TYPES = (torch.int32, torch.int64)


def gather_patches_plain(img2d, rows, cols, ph: int, pw: int):
    """Plain PyTorch version: clamp the corners to [0, R-ph] x [0, W-pw],
    as the reference does, and gather with advanced indexing."""
    R, W = img2d.shape
    rows = torch.clamp(rows, 0, R - ph)
    cols = torch.clamp(cols, 0, W - pw)
    dy = torch.arange(ph, device=img2d.device)
    dx = torch.arange(pw, device=img2d.device)
    return img2d[
        rows[:, None, None] + dy[None, :, None],
        cols[:, None, None] + dx[None, None, :],
    ]


def gather_patches(img2d, rows, cols, ph: int, pw: int):
    """img2d [R,W] float32; rows/cols [K] int32 or int64 top-left corners
    (each of either type), clamped to [0, R-ph] x [0, W-pw]. Returns
    [K, ph, pw] patches. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel, which clamps the corners itself (K = 0 launches
    nothing)."""
    if img2d.device.type == "cpu":
        return gather_patches_plain(img2d, rows, cols, ph, pw)
    _cuda.check_cuda(img2d, rows, cols)
    R, W = img2d.shape
    K = rows.shape[0]
    if (img2d.dtype != torch.float32 or rows.dtype not in _CORNER_TYPES
            or cols.dtype not in _CORNER_TYPES or rows.shape != (K,) or cols.shape != (K,)):
        raise ValueError(f"expected a float32 image and int32/int64 [K] corners, got "
                         f"{img2d.dtype}, {rows.dtype} {tuple(rows.shape)}, {cols.dtype} {tuple(cols.shape)}")
    if not (1 <= ph <= R and 1 <= pw <= W):
        raise ValueError(f"patch {ph}x{pw} does not fit the {R}x{W} image")
    if ph * pw >= 2 ** 30:  # the kernel counts a patch's pixels in int
        raise ValueError(f"patch {ph}x{pw} is too large for the kernel")
    out = torch.empty((K, ph, pw), dtype=torch.float32, device=img2d.device)
    if K == 0:
        return out
    _cuda.launch(
        "osk_gather_patches", img2d.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        out.data_ptr(), R, W, K, ph, pw, rows.element_size(), cols.element_size(),
        _cuda.stream(),
    )
    gather_patches.launches += 1
    return out


gather_patches.launches = 0
