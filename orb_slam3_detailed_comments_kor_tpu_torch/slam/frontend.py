"""Per-frame front-end: pixels to features (+ stereo depth).

Port of ``Frame``, ``process_stereo``, ``_undistort_xy``,
``process_rgbd``, ``process_mono`` and ``process_stereo_fisheye`` from
``orb_slam3_detailed_comments_kor_tpu/slam/frontend.py``: both stereo
views go through one batched ORB extraction (one padded level stack), and
the stereo matcher reuses that stack and the left patches; a monocular or
RGB-D frame is a batch of one; a raw dual-fisheye pair is matched by
descriptor and triangulated through the rig extrinsic.
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
    """Working record for one frame; all tensors capacity N."""

    xy: torch.Tensor        # [N,2] float32
    level: torch.Tensor     # [N] int32
    angle: torch.Tensor     # [N] float32
    desc: torch.Tensor      # [N,256] uint8 bits
    desc_packed: torch.Tensor  # [N,8] int32 (bit patterns of uint32 words)
    valid: torch.Tensor     # [N] bool
    u_right: torch.Tensor   # [N] float32 (-1 mono)
    depth: torch.Tensor     # [N] float32 (-1 unknown)
    # the matched RIGHT-camera pixel of rig (dual-fisheye) frames, x < 0
    # none; None on the rectified and monocular paths
    uv_r: Optional[torch.Tensor] = None  # [N,2] float32

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


def process_rgbd(
    img: torch.Tensor,
    depth_map: torch.Tensor,
    bf: float,
    n_features: int = 1200,
    n_levels: int = 8,
    scale: float = 1.2,
    cell: int = 32,
    dist=None,
    cam_params=None,
) -> Frame:
    """RGB-D front end (the RGB-D Frame constructor, ``src/Frame.cc:201``):
    ORB on the gray image (a batch of one), the depth sampled at each
    keypoint's rounded raw coordinates, keypoints undistorted when
    ``dist`` (a tuple of floats) has a non-zero entry, and the synthetic
    right u = u - bf / d (ComputeStereoFromRGBD) where d > 0.05, so that the
    stereo pipeline downstream is reused unchanged."""
    f = _view(orb_ops.extract_orb_batch(
        img[None], n_features=n_features, n_levels=n_levels, scale=scale, cell=cell,
    ), 0)
    h, w = depth_map.shape
    xi = torch.clamp(torch.round(f.xy[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(f.xy[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_map[yi, xi]
    xy = f.xy
    if dist is not None and any(abs(v) > 0 for v in dist):
        xy = _undistort_xy(xy, cam_params, dist)
    ok = f.valid & (d > 0.05)
    return Frame(
        xy=xy,
        level=f.level,
        angle=f.angle,
        desc=f.desc,
        desc_packed=orb_ops.pack_descriptors(f.desc),
        valid=f.valid,
        u_right=torch.where(ok, xy[:, 0] - bf / torch.clamp(d, min=1e-6), -1.0),
        depth=torch.where(ok, d, -1.0),
    )


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


def process_stereo_fisheye(
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    params_l: torch.Tensor,
    params_r: torch.Tensor,
    R_rl: torch.Tensor,
    t_rl: torch.Tensor,
    n_features: int = 1200,
    n_levels: int = 8,
    scale: float = 1.2,
    cell: int = 32,
) -> Frame:
    """Dual-fisheye (KannalaBrandt8 x2) stereo front end: the
    stereo-fisheye Frame constructor (``src/Frame.cc:1021``) and its
    descriptor match + triangulation depth (``Frame.cc:1119`` ->
    ``KannalaBrandt8::TriangulateMatches``, ``KannalaBrandt8.cpp:338``).

    The raw views are not rectified: both go through one batched ORB
    extraction, left and right are associated by a nearest-neighbour
    ratio-test match (plain torch, as the reference's XLA matcher), and
    each match is triangulated by the two-view midpoint through the
    left-to-right extrinsic (R_rl, t_rl). A match that passes the gates
    (both depths > 0.05, reprojection error < 2.45 sigma in both cameras,
    parallax cosine < 0.9998) gives the feature a metric left ``depth``
    and its right-camera pixel ``uv_r``; every ``u_right`` is -1."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching as match_ops
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import twoview

    feats = orb_ops.extract_orb_batch(
        torch.stack([img_l, img_r]), n_features=n_features, n_levels=n_levels, scale=scale, cell=cell,
    )
    fl = _view(feats, 0)
    fr = _view(feats, 1)
    res = match_ops.match_nn_ratio(fl.desc, fr.desc, fl.valid, fr.valid, max_dist=50, ratio=0.8)
    ridx = torch.clamp(res.idx, min=0).to(torch.int64)
    xy_r = fr.xy[ridx]
    rays_l = cam_mod.kb8_unproject(params_l, fl.xy)
    rays_r = cam_mod.kb8_unproject(params_r, fr.xy)[ridx]
    X_l, dep_l, dep_r = twoview.triangulate_midpoint(R_rl, t_rl, rays_l, rays_r)
    # TriangulateMatches' gates: cheirality in both views, parallax, and
    # the reprojection error in both cameras at the feature's scale sigma
    uv_l = cam_mod.kb8_project(params_l, X_l)
    uv_r = cam_mod.kb8_project(params_r, X_l @ R_rl.T + t_rl)
    err_l = torch.linalg.vector_norm(uv_l - fl.xy, dim=-1)
    err_r = torch.linalg.vector_norm(uv_r - xy_r, dim=-1)
    sigma = scale ** fl.level.to(torch.float32)
    rl_n = rays_l / torch.clamp(torch.linalg.vector_norm(rays_l, dim=-1, keepdim=True), min=1e-9)
    rr_in_l = rays_r @ R_rl  # right rays in the left frame
    rr_n = rr_in_l / torch.clamp(torch.linalg.vector_norm(rr_in_l, dim=-1, keepdim=True), min=1e-9)
    cos_par = torch.sum(rl_n * rr_n, dim=-1)
    ok = (
        res.valid
        & (dep_l > 0.05) & (dep_r > 0.05)
        & (err_l < 2.45 * sigma) & (err_r < 2.45 * sigma)
        & (cos_par < 0.9998)
    )
    n = fl.xy.shape[0]
    return Frame(
        xy=fl.xy,
        level=fl.level,
        angle=fl.angle,
        desc=fl.desc,
        desc_packed=orb_ops.pack_descriptors(fl.desc),
        valid=fl.valid,
        u_right=torch.full((n,), -1.0, device=img_l.device),
        depth=torch.where(ok, X_l[:, 2], -1.0),
        uv_r=torch.where(ok[:, None], xy_r, -1.0),
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
