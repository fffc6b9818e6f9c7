"""Per-frame front-end: pixels to features (+ stereo depth).

Port of ``Frame``, ``process_stereo``, ``_undistort_xy`` and
``process_mono`` from ``orb_slam3_detailed_comments_kor_tpu/slam/
frontend.py``: both stereo views go through one batched ORB extraction
(one padded level stack), and the stereo matcher reuses that stack and
the left patches; a monocular frame is a batch of one.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid as pyr_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops import stereo as stereo_ops


class Frame(NamedTuple):
    """Working record for one stereo frame; all tensors capacity N."""

    xy: torch.Tensor        # [N,2] float32
    level: torch.Tensor     # [N] int32
    angle: torch.Tensor     # [N] float32
    desc: torch.Tensor      # [N,256] uint8 bits
    desc_packed: torch.Tensor  # [N,8] int32 (bit patterns of uint32 words)
    valid: torch.Tensor     # [N] bool
    u_right: torch.Tensor   # [N] float32 (-1 mono)
    depth: torch.Tensor     # [N] float32 (-1 unknown)
    uv_r: Optional[torch.Tensor] = None  # rig frames only; not ported

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def process_stereo(
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    bf: float,
    n_features: int = 1200,
    n_levels: int = 8,
    scale: float = 1.2,
    cell: int = 32,
) -> Frame:
    """imgs [H,W] float32 (0..255) -> Frame."""
    feats, stack, patches = orb_ops.extract_orb_batch(
        torch.stack([img_l, img_r]),
        n_features=n_features, n_levels=n_levels, scale=scale, cell=cell,
        return_stack=True,
    )
    fl = _view(feats, 0)
    fr = _view(feats, 1)
    n = fl.xy.shape[0]
    sd = stereo_ops.compute_stereo_matches(
        fl, fr, stack[0], stack[1], bf, scale,
        level_hw=pyr_ops.level_shapes(img_l.shape[0], img_l.shape[1], n_levels, scale),
        left_patches=patches[:n],
    )
    return Frame(
        xy=fl.xy,
        level=fl.level,
        angle=fl.angle,
        desc=fl.desc,
        desc_packed=orb_ops.pack_descriptors(fl.desc),
        valid=fl.valid,
        u_right=sd.u_right,
        depth=sd.depth,
    )


@functools.lru_cache(maxsize=8)
def _dist_tensor(dist, device):
    """The coefficients as float32 on ``device``, made once per device: a
    tensor made from host values each frame would wait on the stream."""
    return torch.tensor(dist, dtype=torch.float32).to(device)


def _undistort_xy(xy, cam_params, dist):
    """Keypoint undistortion (``Frame::UndistortKeyPoints``, ``src/Frame.cc:
    733``): extraction runs on the raw image; only the coordinates are
    mapped through the inverse radial-tangential model."""
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    xn = torch.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy], dim=-1)
    xu = cam_mod.undistort_radtan(_dist_tensor(tuple(dist), xy.device), xn)
    return torch.stack([fx * xu[:, 0] + cx, fy * xu[:, 1] + cy], dim=-1)


def process_mono(
    img: torch.Tensor,
    n_features: int = 1200,
    n_levels: int = 8,
    scale: float = 1.2,
    cell: int = 32,
    dist=None,
    cam_params=None,
) -> Frame:
    """img [H,W] float32 (0..255) -> Frame with no right view: ORB on a
    batch of one, keypoints undistorted when ``dist`` (a tuple of floats)
    has a non-zero entry."""
    f = _view(orb_ops.extract_orb_batch(
        img[None], n_features=n_features, n_levels=n_levels, scale=scale, cell=cell,
    ), 0)
    xy = f.xy
    if dist is not None and any(abs(v) > 0 for v in dist):
        xy = _undistort_xy(xy, cam_params, dist)
    n = f.xy.shape[0]
    return Frame(
        xy=xy,
        level=f.level,
        angle=f.angle,
        desc=f.desc,
        desc_packed=orb_ops.pack_descriptors(f.desc),
        valid=f.valid,
        u_right=torch.full((n,), -1.0, device=img.device),
        depth=torch.full((n,), -1.0, device=img.device),
    )


def _view(feats: orb_ops.Features, i: int) -> orb_ops.Features:
    """View ``i`` of a batched Features."""
    return orb_ops.Features(*(a[i] for a in feats))


# Frame fields stored as the reference's uint32 words.
_U32_FIELDS = ("desc_packed",)


def frame_from_numpy(arrays: Dict[str, np.ndarray], device) -> Frame:
    """Frame from the reference's ``Frame._asdict()`` with ``np.asarray``
    on each field; uint32 words become int32 bit views."""
    fields = {}
    for name in Frame._fields:
        a = arrays.get(name)
        if a is None:
            fields[name] = None
            continue
        a = np.asarray(a)
        if name in _U32_FIELDS:
            a = a.view(np.int32)
        fields[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Frame(**fields)


def frame_to_numpy(frame: Frame) -> Dict[str, np.ndarray]:
    """Inverse of ``frame_from_numpy``: int32 words go back to uint32."""
    out = {}
    for name, t in frame._asdict().items():
        if t is None:
            out[name] = None
            continue
        a = t.detach().cpu().numpy()
        out[name] = a.view(np.uint32) if name in _U32_FIELDS else a
    return out
