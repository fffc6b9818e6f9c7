"""Fused masked Hamming best-2 matcher: the ``masked_best2`` CUDA kernel.

Replaces ``fused_masked_best2`` of
``orb_slam3_detailed_comments_kor_tpu/ops/pallas_matching.py`` (Pallas
body ``_kernel`` at :34, ``pl.pallas_call`` at :123): per row of A, the
best and second-best Hamming distance and the argbest over the allowed
columns of B, without the [N, M] distance matrix. The kernel
(``csrc/masked_best2.cu``) popcounts packed descriptors and is bound by
reading the uint8 mask; one warp per row, lanes striding over columns.

Descriptors may be given as {0,1} bits [N,256] (the reference's layout)
or packed int32 [N,8] (``orb.pack_descriptors``); the kernel takes packed
ones, so callers that hold packed descriptors skip the unpack.
"""

from __future__ import annotations

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops


def _bits(desc):
    return orb_ops.unpack_descriptors(desc) if desc.shape[-1] == 8 else desc


def _packed(desc):
    return desc if desc.shape[-1] == 8 else orb_ops.pack_descriptors(desc)


def fused_masked_best2_plain(bits_a, bits_b, mask):
    """Plain PyTorch version: masked_best2(hamming_matrix(a, b), mask)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching

    dist = matching.hamming_matrix(_bits(bits_a), _bits(bits_b))
    return matching.masked_best2(dist, mask)


def fused_masked_best2(bits_a, bits_b, mask):
    """Fused equivalent of masked_best2(hamming_matrix(a, b), mask).

    bits_a [N,256] {0,1} or [N,8] packed; bits_b likewise [M,...]; mask
    [N,M] bool. Returns (best_idx [N] int32, best [N] f32, second [N] f32);
    rows with no allowed column give idx 0 and best = second = BIG. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if mask.device.type == "cpu":
        return fused_masked_best2_plain(bits_a, bits_b, mask)
    a = _packed(bits_a).to(torch.int32).contiguous()
    b = _packed(bits_b).to(torch.int32).contiguous()
    m = mask.contiguous()
    _cuda.check_cuda(a, b, m)
    N, M = m.shape
    if m.dtype != torch.bool or a.shape != (N, 8) or b.shape != (M, 8):
        raise ValueError(
            f"bad shapes/types: a {tuple(a.shape)} b {tuple(b.shape)} "
            f"mask {tuple(m.shape)} {m.dtype}"
        )
    if a.data_ptr() % 16 or b.data_ptr() % 16:  # rows are read as uint4
        a, b = a.clone(), b.clone()
    idx = torch.empty((N,), dtype=torch.int32, device=m.device)
    best = torch.empty((N,), dtype=torch.float32, device=m.device)
    second = torch.empty((N,), dtype=torch.float32, device=m.device)
    _cuda.launch(
        "osk_masked_best2", a.data_ptr(), b.data_ptr(), m.data_ptr(),
        idx.data_ptr(), best.data_ptr(), second.data_ptr(), N, M,
        _cuda.stream(),
    )
    fused_masked_best2.launches += 1
    return idx, best, second


fused_masked_best2.launches = 0
