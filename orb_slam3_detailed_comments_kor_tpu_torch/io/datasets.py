"""Dataset drivers: EuRoC / TUM-VI / KITTI / TUM-RGBD loaders + settings.

The port's own copy of ``orb_slam3_detailed_comments_kor_tpu/io/
datasets.py``, building this package's ``config`` dataclasses.
Counterpart of the reference's per-dataset example mains
(``Examples/Stereo-Inertial/stereo_inertial_euroc.cc:42-290``,
``Examples/Monocular/mono_tum.cc``, ``Examples/Stereo/stereo_kitti.cc``,
``Examples/RGB-D/rgbd_tum.cc``): image-list/IMU-CSV loading, OpenCV-style
YAML settings parsing (``src/Tracking.cc:538,1083,1169``), and stereo
rectification (``stereo_inertial_euroc.cc:149-202`` uses
``cv::initUndistortRectifyMap`` + ``cv::remap``).

Design: loaders are plain-Python iterators producing numpy grayscale
float32 images in [0,255]; rectification maps are precomputed once as
numpy arrays and applied either by the native C++ remap kernel (see
``native/``) or a numpy fallback. Nothing here touches the device —
the SLAM system owns all device transfers.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from orb_slam3_detailed_comments_kor_tpu_torch import config as cfgm


# ---------------------------------------------------------------------------
# OpenCV-YAML settings parsing
# ---------------------------------------------------------------------------

def _parse_opencv_yaml(path: str) -> Dict[str, object]:
    """Parse the reference's settings dialect (``%YAML:1.0`` + scalar keys +
    ``!!opencv-matrix`` nodes) into a flat dict.

    The reference parses these imperatively with ``cv::FileStorage``
    (``System.cc:68``); keys are dotted (``Camera.fx``). We parse by hand:
    the dialect used by every shipped settings file is flat enough that a
    full YAML engine is unnecessary.
    """
    out: Dict[str, object] = {}
    with open(path) as f:
        text = f.read()
    # strip directives and comments
    lines = []
    for ln in text.splitlines():
        if ln.strip().startswith("%"):
            continue
        # strip comments (settings files never quote '#')
        ln = ln.split("#", 1)[0].rstrip()
        if ln.strip():
            lines.append(ln)

    i = 0
    while i < len(lines):
        ln = lines[i]
        m = re.match(r"^([A-Za-z0-9_.]+):\s*(.*)$", ln.strip())
        if not m:
            i += 1
            continue
        key, val = m.group(1), m.group(2).strip()
        if val == "!!opencv-matrix" or val == "":
            # matrix node: rows/cols/dt/data possibly spanning lines
            j = i + 1
            rows = cols = None
            data_txt = ""
            in_data = False
            while j < len(lines):
                s = lines[j].strip()
                if re.match(r"^[A-Za-z0-9_.]+:", s) and not s.startswith(
                    ("rows:", "cols:", "dt:", "data:")
                ) and not in_data:
                    break
                if s.startswith("rows:"):
                    rows = int(s.split(":", 1)[1])
                elif s.startswith("cols:"):
                    cols = int(s.split(":", 1)[1])
                elif s.startswith("dt:"):
                    pass
                elif s.startswith("data:") or in_data:
                    seg = s.split(":", 1)[1] if s.startswith("data:") else s
                    data_txt += " " + seg
                    in_data = "]" not in data_txt
                j += 1
            if rows is not None and data_txt:
                nums = re.findall(r"[-+0-9.eE]+", data_txt)
                out[key] = np.array([float(x) for x in nums]).reshape(
                    rows, cols
                )
                i = j
                continue
            i += 1
            continue
        # scalar
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val.strip('"')
        i += 1
    return out


def load_settings(path: str, sensor: int) -> "Settings":
    """Load a reference-format YAML settings file into typed config +
    rectification blocks (counterpart of ``Tracking::ParseCamParamFile``)."""
    raw = _parse_opencv_yaml(path)

    def g(key, default=None):
        return raw.get(key, default)

    cam_type = str(g("Camera.type", "PinHole"))
    model = "kannala_brandt8" if "Kannala" in cam_type else "pinhole"
    if model == "pinhole":
        dist = (
            float(g("Camera.k1", 0.0)), float(g("Camera.k2", 0.0)),
            float(g("Camera.p1", 0.0)), float(g("Camera.p2", 0.0)),
        )
    else:
        dist = (
            float(g("Camera.k1", 0.0)), float(g("Camera.k2", 0.0)),
            float(g("Camera.k3", 0.0)), float(g("Camera.k4", 0.0)),
        )
    # stereo-fisheye: second KB8 camera + right→left extrinsic
    # (TUM_512.yaml Camera2.* / Tlr)
    right_intrinsics = None
    tlr = None
    if model == "kannala_brandt8" and g("Camera2.fx") is not None:
        right_intrinsics = tuple(
            float(g(f"Camera2.{k}", 0.0))
            for k in ("fx", "fy", "cx", "cy", "k1", "k2", "k3", "k4")
        )
        m = g("Tlr")
        if m is not None:
            tlr = tuple(np.asarray(m, dtype=np.float64).reshape(-1).tolist())
    camera = cfgm.CameraConfig(
        width=int(g("Camera.width", 752)),
        height=int(g("Camera.height", 480)),
        fx=float(g("Camera.fx", 458.654)),
        fy=float(g("Camera.fy", 457.296)),
        cx=float(g("Camera.cx", 367.215)),
        cy=float(g("Camera.cy", 248.375)),
        dist=dist,
        model=model,
        bf=float(g("Camera.bf", 0.0)),
        right_intrinsics=right_intrinsics,
        tlr=tlr,
        fps=float(g("Camera.fps", 20.0)),
        th_depth=float(g("ThDepth", 35.0)),
        th_far_points=float(g("thFarPoints", 0.0)),
    )
    orb = cfgm.ORBConfig(
        n_features=int(g("ORBextractor.nFeatures", 1200)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
    )
    tbc = g("Tbc")
    imu_kw = {}
    if tbc is not None:
        imu_kw["tbc"] = tuple(np.asarray(tbc).reshape(-1).tolist())
    imu = cfgm.IMUConfig(
        noise_gyro=float(g("IMU.NoiseGyro", 1.7e-4)),
        noise_acc=float(g("IMU.NoiseAcc", 2.0e-3)),
        gyro_walk=float(g("IMU.GyroWalk", 1.9e-5)),
        acc_walk=float(g("IMU.AccWalk", 3.0e-3)),
        frequency=float(g("IMU.Frequency", 200.0)),
        **imu_kw,
    )
    slam_cfg = cfgm.SLAMConfig(
        sensor=sensor, camera=camera, orb=orb, imu=imu,
        tracking=cfgm.TrackingConfig(), capacity=cfgm.CapacityConfig(),
    )

    rect = None
    if g("LEFT.K") is not None:
        rect = RectifyParams(
            k_l=np.asarray(g("LEFT.K")), d_l=np.asarray(g("LEFT.D")).ravel(),
            r_l=np.asarray(g("LEFT.R")), p_l=np.asarray(g("LEFT.P")),
            k_r=np.asarray(g("RIGHT.K")), d_r=np.asarray(g("RIGHT.D")).ravel(),
            r_r=np.asarray(g("RIGHT.R")), p_r=np.asarray(g("RIGHT.P")),
            width=int(g("LEFT.width", camera.width)),
            height=int(g("LEFT.height", camera.height)),
        )
    return Settings(config=slam_cfg, rectify=rect, raw=raw)


@dataclasses.dataclass
class RectifyParams:
    """The LEFT./RIGHT. rectification blocks of EuRoC-style settings
    (``Examples/Stereo-Inertial/EuRoC.yaml:60-103``)."""

    k_l: np.ndarray
    d_l: np.ndarray
    r_l: np.ndarray
    p_l: np.ndarray
    k_r: np.ndarray
    d_r: np.ndarray
    r_r: np.ndarray
    p_r: np.ndarray
    width: int
    height: int


@dataclasses.dataclass
class Settings:
    config: cfgm.SLAMConfig
    rectify: Optional[RectifyParams]
    raw: Dict[str, object]


# ---------------------------------------------------------------------------
# Rectification (initUndistortRectifyMap + remap equivalents)
# ---------------------------------------------------------------------------

def undistort_rectify_map(
    k: np.ndarray, d: np.ndarray, r: np.ndarray, p: np.ndarray,
    width: int, height: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Source-coordinate maps for rectification, mirroring
    ``cv::initUndistortRectifyMap`` (used at
    ``stereo_inertial_euroc.cc:149-202``).

    For each rectified pixel: unproject with the NEW projection P, rotate by
    R^-1 into the original camera, apply radial-tangential distortion, and
    project with the ORIGINAL K. Returns (map_x, map_y) float32 [H,W].
    """
    fx_n, fy_n = p[0, 0], p[1, 1]
    cx_n, cy_n = p[0, 2], p[1, 2]
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    x = (u - cx_n) / fx_n
    y = (v - cy_n) / fy_n
    ones = np.ones_like(x)
    pts = np.stack([x, y, ones], axis=-1) @ np.linalg.inv(r).T
    x = pts[..., 0] / pts[..., 2]
    y = pts[..., 1] / pts[..., 2]
    # radial-tangential distortion (k1,k2,p1,p2[,k3])
    k1 = d[0] if d.size > 0 else 0.0
    k2 = d[1] if d.size > 1 else 0.0
    p1 = d[2] if d.size > 2 else 0.0
    p2 = d[3] if d.size > 3 else 0.0
    k3 = d[4] if d.size > 4 else 0.0
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    map_x = (k[0, 0] * xd + k[0, 2]).astype(np.float32)
    map_y = (k[1, 1] * yd + k[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(
    img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray
) -> np.ndarray:
    """Bilinear remap (``cv::remap`` equivalent), numpy fallback.

    The native C++ kernel in ``native/`` implements the same op; callers
    should go through :class:`Rectifier` which picks the fast path.
    """
    h, w = img.shape
    x0 = np.floor(map_x).astype(np.int32)
    y0 = np.floor(map_y).astype(np.int32)
    fx = map_x - x0
    fy = map_y - y0
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    ia = img[y0c, x0c]
    ib = img[y0c, x1c]
    ic = img[y1c, x0c]
    idd = img[y1c, x1c]
    out = (
        ia * (1 - fx) * (1 - fy) + ib * fx * (1 - fy)
        + ic * (1 - fx) * fy + idd * fx * fy
    )
    valid = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)
    return np.where(valid, out, 0.0).astype(np.float32)


class Rectifier:
    """Precomputed stereo rectification, native-accelerated when available."""

    def __init__(self, params: RectifyParams):
        self.map_lx, self.map_ly = undistort_rectify_map(
            params.k_l, params.d_l, params.r_l, params.p_l,
            params.width, params.height,
        )
        self.map_rx, self.map_ry = undistort_rectify_map(
            params.k_r, params.d_r, params.r_r, params.p_r,
            params.width, params.height,
        )
        self._native = None
        try:
            from orb_slam3_detailed_comments_kor_tpu_torch.io import native_host

            self._native = native_host.load()
        except Exception:
            self._native = None

    def _remap(self, img, mx, my):
        if self._native is not None:
            return self._native.remap_bilinear(img, mx, my)
        return remap_bilinear(img, mx, my)

    def __call__(self, img_l, img_r):
        return (
            self._remap(img_l, self.map_lx, self.map_ly),
            self._remap(img_r, self.map_rx, self.map_ry),
        )


# ---------------------------------------------------------------------------
# Image decode
# ---------------------------------------------------------------------------

def load_gray(path: str) -> np.ndarray:
    """Decode an image file to float32 grayscale [H,W] in [0,255].

    The reference does ``cv::imread`` + ``cvtColor(RGB2GRAY)``
    (``Tracking.cc:1300-1327``). Uses the native decoder when built, else
    PIL.
    """
    try:
        from orb_slam3_detailed_comments_kor_tpu_torch.io import native_host

        nat = native_host.load()
        out = nat.load_gray(path)
        if out is not None:
            return out
    except Exception:
        pass
    from PIL import Image

    im = Image.open(path)
    if im.mode not in ("L", "I;16", "I"):
        im = im.convert("L")
    arr = np.asarray(im)
    if arr.dtype == np.uint16:
        return (arr.astype(np.float32) / 257.0)
    return arr.astype(np.float32)


def load_depth_tum(path: str, depth_factor: float = 5000.0) -> np.ndarray:
    """TUM RGB-D 16-bit depth PNG -> meters (``rgbd_tum.cc`` DepthMapFactor)."""
    from PIL import Image

    arr = np.asarray(Image.open(path)).astype(np.float32)
    return arr / depth_factor


# ---------------------------------------------------------------------------
# IMU CSV
# ---------------------------------------------------------------------------

class ImuLog:
    """Time-indexed IMU samples with between-frames queries (replaces the
    driver-side vImuMeas collection at ``stereo_inertial_euroc.cc:214-234``)."""

    def __init__(self, times: np.ndarray, gyro: np.ndarray, acc: np.ndarray):
        self.times = times  # [M] seconds
        self.gyro = gyro    # [M,3] rad/s
        self.acc = acc      # [M,3] m/s^2

    @staticmethod
    def from_euroc_csv(path: str) -> "ImuLog":
        """mav0/imu0/data.csv: t[ns], wx, wy, wz, ax, ay, az."""
        rows = np.loadtxt(path, delimiter=",", skiprows=1)
        return ImuLog(
            times=rows[:, 0] * 1e-9,
            gyro=rows[:, 1:4].astype(np.float32),
            acc=rows[:, 4:7].astype(np.float32),
        )

    def between(self, t0: float, t1: float):
        """Samples with t0 < t <= t1, as (times [K], gyro [K,3], acc [K,3])."""
        lo = bisect.bisect_right(self.times.tolist(), t0)
        hi = bisect.bisect_right(self.times.tolist(), t1)
        return self.times[lo:hi], self.gyro[lo:hi], self.acc[lo:hi]


# ---------------------------------------------------------------------------
# Sequence loaders
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StereoFrameRef:
    t: float
    left: str
    right: Optional[str] = None
    depth: Optional[str] = None
    # exact integer nanosecond stamp where the dataset provides one (float64
    # seconds cannot represent EuRoC's ~1.4e18 ns stamps exactly)
    t_ns: Optional[int] = None


class EurocSequence:
    """EuRoC MAV / TUM-VI directory layout: ``mav0/cam{0,1}/data.csv`` +
    ``data/<stamp>.png``, ``mav0/imu0/data.csv``
    (``stereo_inertial_euroc.cc:57-111`` LoadImages/LoadIMU)."""

    def __init__(self, root: str, timestamps: Optional[str] = None):
        self.root = root
        cam0 = os.path.join(root, "mav0", "cam0", "data.csv")
        cam1 = os.path.join(root, "mav0", "cam1", "data.csv")
        self.frames: List[StereoFrameRef] = []
        t_l, names_l = self._read_cam_csv(cam0)
        has_right = os.path.exists(cam1)
        if has_right:
            t_r, names_r = self._read_cam_csv(cam1)
            right_by_t = dict(zip(t_r, names_r))
        if timestamps is not None:
            keep = set()
            with open(timestamps) as f:
                for ln in f:
                    ln = ln.strip()
                    if ln:
                        keep.add(int(ln))
        for tn, name in zip(t_l, names_l):
            if timestamps is not None and tn not in keep:
                continue
            left = os.path.join(root, "mav0", "cam0", "data", name)
            right = None
            if has_right and tn in right_by_t:
                right = os.path.join(
                    root, "mav0", "cam1", "data", right_by_t[tn]
                )
            self.frames.append(
                StereoFrameRef(t=tn * 1e-9, left=left, right=right, t_ns=tn)
            )
        imu_csv = os.path.join(root, "mav0", "imu0", "data.csv")
        self.imu = ImuLog.from_euroc_csv(imu_csv) if os.path.exists(imu_csv) else None

    @staticmethod
    def _read_cam_csv(path: str):
        ts, names = [], []
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                parts = ln.split(",")
                ts.append(int(parts[0]))
                names.append(parts[1].strip())
        return ts, names

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i) -> StereoFrameRef:
        return self.frames[i]


class TumRgbdSequence:
    """TUM RGB-D layout: ``rgb.txt`` / ``depth.txt`` association by nearest
    timestamp (``Examples/RGB-D/rgbd_tum.cc`` + ``evaluation/associate.py``)."""

    def __init__(self, root: str, max_dt: float = 0.02,
                 depth_factor: float = 5000.0):
        self.root = root
        self.depth_factor = depth_factor
        rgb = self._read_list(os.path.join(root, "rgb.txt"))
        dep = self._read_list(os.path.join(root, "depth.txt"))
        self.frames: List[StereoFrameRef] = []
        dep_t = np.array([t for t, _ in dep])
        for t, name in rgb:
            j = int(np.argmin(np.abs(dep_t - t))) if len(dep) else -1
            if j >= 0 and abs(dep_t[j] - t) <= max_dt:
                self.frames.append(StereoFrameRef(
                    t=t,
                    left=os.path.join(root, name),
                    depth=os.path.join(root, dep[j][1]),
                ))

    @staticmethod
    def _read_list(path: str):
        out = []
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith("#"):
                    continue
                t, name = ln.split()[:2]
                out.append((float(t), name))
        return out

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i) -> StereoFrameRef:
        return self.frames[i]


class KittiSequence:
    """KITTI odometry layout: ``times.txt`` + ``image_0/`` ``image_1/``
    (``Examples/Stereo/stereo_kitti.cc`` LoadImages)."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "times.txt")) as f:
            times = [float(x) for x in f.read().split()]
        self.frames = []
        for i, t in enumerate(times):
            name = f"{i:06d}.png"
            left = os.path.join(root, "image_0", name)
            right = os.path.join(root, "image_1", name)
            self.frames.append(StereoFrameRef(
                t=t, left=left,
                right=right if os.path.exists(right) else None,
            ))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i) -> StereoFrameRef:
        return self.frames[i]
