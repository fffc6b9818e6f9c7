"""Map checkpoint / resume: save and restore the SLAM state.

Port of ``orb_slam3_detailed_comments_kor_tpu/slam/checkpoint.py`` (format
v3; the reference's ``System::SaveMap/LoadMap`` TODO, ``include/System.h:
179-181``, made real). A snapshot is one ``.npz`` in the reference's layout,
field for field: the active map's ``ms_*`` arrays, the live pose and motion
model, the BoW database (``lc_bow_words``/``lc_bow_wts``), each shelved
Atlas map under ``atlas{i}_`` and the host scalars as JSON bytes in
``meta_json``. Packed descriptors cross the boundary as uint32 words (the
port keeps their int32 bit patterns), so a map that either package saves
loads in the other. Inertial maps add their per-keyframe inertial block
(``ikf_*``), gravity, the frame velocity and the IMU clock, for the active
map and each shelved one (``atlas{i}_ikf_*``, ``atlas{i}_gravity``).
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx

if TYPE_CHECKING:  # pragma: no cover
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem

#: v2: MapState gained kf_uvr and the BoW database became sparse
#: (lc_bow_words/lc_bow_wts); v3: shelved Atlas maps carry their merge
#: prior, inertial state and host keyframe-time / quality mirrors. Fields
#: missing from older snapshots are defaulted on load.
FORMAT_VERSION = 3

#: defaults for MapState fields added after a snapshot was written:
#: name -> callable(the live system's field of that name) -> tensor
_MS_FIELD_DEFAULTS = {
    "kf_uvr": lambda ref: -torch.ones_like(ref),
}


def _pack_map(prefix: str, ms: msx.MapState, out: dict) -> None:
    for name, arr in msx.map_state_to_numpy(ms).items():
        out[f"{prefix}{name}"] = arr


def _unpack_map(prefix: str, z, like: msx.MapState, device) -> msx.MapState:
    fields = {}
    for name in msx.MapState._fields:
        key = f"{prefix}{name}"
        if key in z:
            a = np.asarray(z[key])
            if name in msx._U32_FIELDS:
                a = a.view(np.int32)
            fields[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        elif name in _MS_FIELD_DEFAULTS:
            fields[name] = _MS_FIELD_DEFAULTS[name](getattr(like, name))
        else:
            raise KeyError(f"checkpoint missing field {key} and no default is known")
    return msx.MapState(**fields)


def _pack_tuple(prefix: str, tup, out: dict) -> None:
    for name, t in tup._asdict().items():
        out[f"{prefix}{name}"] = t.detach().cpu().numpy()


def _unpack_tuple(prefix: str, z, device):
    """The inertial keyframe block saved under ``prefix``."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.inertial import InertialKF

    return InertialKF(**{name: torch.from_numpy(np.ascontiguousarray(z[f"{prefix}{name}"])).to(device)
                         for name in InertialKF._fields})


def _sparse_from_dense(dense: torch.Tensor):
    """v1 snapshots carried the dense [K, n_words] database: its top-TOPW
    rows, the lower word first among equal weights (``jax.lax.top_k``)."""
    vals, idx = torch.sort(dense, dim=-1, descending=True, stable=True)
    wts, ids = vals[:, :voc.TOPW], idx[:, :voc.TOPW]
    return torch.where(wts > 0, ids, -1).to(torch.int32), wts


def save_map(slam: "SlamSystem", path: str) -> None:
    """Snapshot the active map, the tracking state and the shelved maps to
    ``path`` (.npz)."""
    out: dict = {}
    _pack_map("ms_", slam.ms, out)
    meta = {
        "version": FORMAT_VERSION,
        "state": int(slam.state),
        "n_kf": int(slam.n_kf),
        "frames_since_kf": int(slam.frames_since_kf),
        "inliers_at_last_kf": int(slam.inliers_at_last_kf),
        "n_frames": int(slam.n_frames),
        "has_velocity": bool(slam.has_velocity),
        "is_inertial": bool(slam.cfg.is_inertial),
        "n_atlas_maps": len(slam.atlas_maps),
    }
    for name in ("R_cw", "t_cw", "vel_R", "vel_t"):
        out[name] = getattr(slam, name).cpu().numpy()
    if slam.cfg.is_inertial:
        _pack_tuple("ikf_", slam.ikf, out)
        out["gravity"] = slam.gravity.cpu().numpy()
        out["frame_vel"] = slam.frame_vel.cpu().numpy()
        meta["imu_initialized"] = bool(slam.imu_initialized)
        meta["last_kf_time"] = None if slam._last_kf_time is None else float(slam._last_kf_time)
        meta["last_frame_time"] = None if slam._last_frame_time is None else float(slam._last_frame_time)
    lc = slam.loop_closer
    if lc.db_words is not None:
        out["lc_bow_words"] = lc.db_words.cpu().numpy()
        out["lc_bow_wts"] = lc.db_wts.cpu().numpy()
        meta["lc_n_loops_closed"] = lc.n_loops_closed
    # shelved Atlas maps (Atlas::CreateNewMap keeps old maps; Atlas.cc:58)
    for i, m in enumerate(slam.atlas_maps):
        _pack_map(f"atlas{i}_ms_", m["ms"], out)
        meta[f"atlas{i}_n_kf"] = int(m["n_kf"])
        meta[f"atlas{i}_traj_end"] = int(m["traj_end"])
        meta[f"atlas{i}_gen"] = int(m.get("gen", -1))
        lc_i = m.get("loop_closer")
        if lc_i is not None and lc_i.db_words is not None:
            out[f"atlas{i}_bow_words"] = lc_i.db_words.cpu().numpy()
            out[f"atlas{i}_bow_wts"] = lc_i.db_wts.cpu().numpy()
        mp = m.get("merge_prior")
        if mp is not None:
            meta[f"atlas{i}_merge_prior"] = [
                np.asarray(mp[0]).reshape(-1).tolist(),
                np.asarray(mp[1]).reshape(-1).tolist(),
                float(mp[2]) if len(mp) > 2 else 0.0,
                float(mp[3]) if len(mp) > 3 else 0.0,
            ]
        if "ikf" in m:
            _pack_tuple(f"atlas{i}_ikf_", m["ikf"], out)
            out[f"atlas{i}_gravity"] = m["gravity"].cpu().numpy()
            meta[f"atlas{i}_imu_initialized"] = bool(m.get("imu_initialized", False))
        meta[f"atlas{i}_kf_times"] = [float(x) for x in m.get("kf_times", [])]
        meta[f"atlas{i}_kf_lowq"] = [bool(x) for x in m.get("kf_lowq", [])]
    meta["kf_times_host"] = [float(x) for x in slam._kf_times_host]
    meta["kf_lowq_host"] = [bool(x) for x in slam._kf_lowq_host]
    out["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)


def load_map(slam: "SlamSystem", path: str) -> None:
    """Restore a snapshot made by either package into an existing
    SlamSystem of the same configuration. Raises ``ValueError`` on a newer
    format or other capacities."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta_json"]).decode())
    if meta["version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    dev = slam.device
    ms = _unpack_map("ms_", z, slam.ms, dev)
    if ms.K != slam.ms.K or ms.N != slam.ms.N or ms.L != slam.ms.L:
        raise ValueError(
            f"capacity mismatch: checkpoint ({ms.K},{ms.N},{ms.L}) vs "
            f"system ({slam.ms.K},{slam.ms.N},{slam.ms.L})"
        )
    slam.ms = ms
    slam.state = meta["state"]
    slam.n_kf = meta["n_kf"]
    slam.frames_since_kf = meta["frames_since_kf"]
    slam.inliers_at_last_kf = meta["inliers_at_last_kf"]
    slam.n_frames = meta["n_frames"]
    slam.has_velocity = meta["has_velocity"]
    slam._kf_times_host = list(meta.get("kf_times_host", []))
    slam._kf_lowq_host = list(meta.get("kf_lowq_host", []))
    for name in ("R_cw", "t_cw", "vel_R", "vel_t"):
        setattr(slam, name, torch.from_numpy(np.asarray(z[name])).to(dev))
    if meta["is_inertial"] and slam.cfg.is_inertial:
        slam.ikf = _unpack_tuple("ikf_", z, dev)
        slam.gravity = torch.from_numpy(np.asarray(z["gravity"])).to(dev)
        slam.frame_vel = torch.from_numpy(np.asarray(z["frame_vel"])).to(dev)
        slam.imu_initialized = meta["imu_initialized"]
        slam._last_kf_time = meta["last_kf_time"]
        slam._last_frame_time = meta["last_frame_time"]
        slam._imu_buf = []
    lc = slam.loop_closer
    if "lc_bow_words" in z and lc.db_words is not None:
        if tuple(z["lc_bow_words"].shape) == tuple(lc.db_words.shape):
            lc.db_words = torch.from_numpy(z["lc_bow_words"]).to(dev)
            lc.db_wts = torch.from_numpy(z["lc_bow_wts"]).to(dev)
            lc.n_loops_closed = meta.get("lc_n_loops_closed", 0)
    elif "lc_bow_db" in z and lc.db_words is not None:
        dense = torch.from_numpy(z["lc_bow_db"]).to(dev)
        if dense.shape[0] == lc.db_words.shape[0]:
            lc.db_words, lc.db_wts = _sparse_from_dense(dense)
            lc.n_loops_closed = meta.get("lc_n_loops_closed", 0)
    # shelved Atlas maps
    slam.atlas_maps = []
    for i in range(meta.get("n_atlas_maps", 0)):
        m = {
            "ms": _unpack_map(f"atlas{i}_ms_", z, slam.ms, dev),
            "n_kf": meta[f"atlas{i}_n_kf"],
            "traj_end": meta[f"atlas{i}_traj_end"],
            "gen": meta.get(f"atlas{i}_gen", -1),
            "loop_closer": None,
        }
        mp = meta.get(f"atlas{i}_merge_prior")
        if mp is not None:
            m["merge_prior"] = (np.asarray(mp[0], np.float64).reshape(3, 3), np.asarray(mp[1], np.float64),
                                float(mp[2]), float(mp[3]))
        if f"atlas{i}_ikf_bg" in z:
            m["ikf"] = _unpack_tuple(f"atlas{i}_ikf_", z, dev)
            m["gravity"] = torch.from_numpy(np.asarray(z[f"atlas{i}_gravity"])).to(dev)
            m["imu_initialized"] = meta.get(f"atlas{i}_imu_initialized", False)
        m["kf_times"] = list(meta.get(f"atlas{i}_kf_times", []))
        m["kf_lowq"] = list(meta.get(f"atlas{i}_kf_lowq", []))
        if f"atlas{i}_bow_words" in z or f"atlas{i}_bow_db" in z:
            lc_i = slam._new_loop_closer()
            if f"atlas{i}_bow_words" in z:
                words = z[f"atlas{i}_bow_words"]
                # the reference loads these rows without a shape check
                if tuple(words.shape) != tuple(lc_i.db_words.shape):
                    raise ValueError(f"atlas{i} BoW database {tuple(words.shape)}, "
                                     f"expected {tuple(lc_i.db_words.shape)}")
                lc_i.db_words = torch.from_numpy(words).to(dev)
                lc_i.db_wts = torch.from_numpy(z[f"atlas{i}_bow_wts"]).to(dev)
            else:
                lc_i.db_words, lc_i.db_wts = _sparse_from_dense(
                    torch.from_numpy(z[f"atlas{i}_bow_db"]).to(dev))
            m["loop_closer"] = lc_i
        slam.atlas_maps.append(m)
    # a loaded map has no pending deferred decision
    slam._pending_decisions = []
    slam._inflight_decisions = None
