"""FAST-9 dual-threshold response + 3x3 NMS: the ``fast_nms`` CUDA kernel.

Replaces ``fast_nms_stack`` of
``orb_slam3_detailed_comments_kor_tpu/ops/pallas_fast.py`` (Pallas body
``_kernel_factory`` at :42, ``pl.pallas_call`` in ``_fast_nms_pallas`` at
:149). The kernel (``csrc/fast_nms.cu``) is memory-bound: one read and
three writes per pixel of the [2·NL, Hp, Wp] level stack, with the circle
test, both score maps and the NMS done out of shared memory. Its plain
version is ``fast.fast_nms_maps``; the per-cell high→low fallback after it
stays plain torch, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda
from orb_slam3_detailed_comments_kor_tpu_torch.ops import fast as fast_ops


def fast_nms_plain(flat, hs, ws, th_high: float, th_low: float):
    """Plain PyTorch version of the kernel: (s_hi, s_lo, raw_lo)."""
    BN, Hp, Wp = flat.shape
    NL = len(hs)
    inb = fast_ops.level_interior(
        tuple(int(v) for v in hs), tuple(int(v) for v in ws), 3, Hp, Wp,
        flat.device,
    ).expand(BN // NL, NL, Hp, Wp).reshape(BN, Hp, Wp)
    return fast_ops.fast_nms_maps(flat, th_high, th_low, inb)


def fast_nms(flat, hs, ws, th_high: float, th_low: float):
    """flat [B·NL, Hp, Wp] float32; hs/ws [NL] int true level extents.

    Returns (s_hi, s_lo, raw_lo), each [B·NL, Hp, Wp]. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel.
    """
    if flat.device.type == "cpu":
        return fast_nms_plain(flat, hs, ws, th_high, th_low)
    _cuda.check_cuda(flat)
    if flat.dtype != torch.float32 or flat.dim() != 3:
        raise ValueError(f"expected float32 [BN,H,W], got {flat.dtype} {tuple(flat.shape)}")
    BN, Hp, Wp = flat.shape
    hs_np = np.ascontiguousarray(hs, dtype=np.int32)
    ws_np = np.ascontiguousarray(ws, dtype=np.int32)
    s_hi = torch.empty_like(flat)
    s_lo = torch.empty_like(flat)
    raw = torch.empty_like(flat)
    _cuda.launch(
        "osk_fast_nms", flat.data_ptr(), s_hi.data_ptr(), s_lo.data_ptr(),
        raw.data_ptr(), BN, Hp, Wp, len(hs_np), hs_np.ctypes.data,
        ws_np.ctypes.data, float(th_high), float(th_low), _cuda.stream(),
    )
    fast_nms.launches += 1
    return s_hi, s_lo, raw


fast_nms.launches = 0


def fast_nms_stack(flat, hs, ws, n_levels: int, th_high: float,
                   th_low: float, cell: int):
    """High/low fallback FAST over a padded level stack.

    flat [B·NL, Hp, Wp] float32; hs/ws [NL] true level extents. Returns
    (score — NMS'd, per-cell high→low fallback applied — and raw_lo, the
    pre-NMS low-threshold response for subpixel refinement).
    """
    if len(hs) != n_levels:
        raise ValueError("hs/ws must have one entry per level")
    s_hi, s_lo, raw = fast_nms(flat, hs, ws, th_high, th_low)
    return fast_ops.cell_fallback(s_hi, s_lo, cell), raw
