"""The port's host side against the JAX package on the same files: settings,
rectification, decoding, the sequence loaders, the online node, the
leveled logger and the profiler block.

The port keeps its own copies of ``io/datasets.py``, ``io/native_host.py``,
``io/online.py`` and ``utils/verbose.py``; both packages read the same
files here. The reference's native library is built from the repository's
``native/host_ops.cpp`` with libpng; the port's from its own
``native/host_ops.cpp``, whose PNG decoder needs zlib alone, into its own
``_build/``.

Tolerances: settings configs field-equal (``dataclasses.asdict``) and
their rectification blocks exactly; ``undistort_rectify_map`` and
``remap_bilinear`` bit-equal; the native remap against numpy within 1e-4;
the port's PNG decoder bit-equal to the reference's libpng build on every
bit depth and colour type it reads, with every row filter, a palette with
and without transparency and several IDAT chunks; gray+alpha equal to
PIL's ``convert("L")`` (8 bits; 16 bits within one grey level, PIL keeping
the high byte); the native decode against PIL within 0.5 grey levels
(exactly for 8-bit gray); loaders, IMU windows and the online node's call
logs exactly.
"""

import dataclasses
import json
import os
import struct
import threading
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from test_datasets_native import EUROC_YAML
from orb_slam3_detailed_comments_kor_tpu.io import datasets as jds
from orb_slam3_detailed_comments_kor_tpu.io import native_host as jnh
from orb_slam3_detailed_comments_kor_tpu.io import online as jon
from orb_slam3_detailed_comments_kor_tpu.utils import verbose as jverbose
from orb_slam3_detailed_comments_kor_tpu_torch.io import datasets as tds
from orb_slam3_detailed_comments_kor_tpu_torch.io import native_host as tnh
from orb_slam3_detailed_comments_kor_tpu_torch.io import online as ton
from orb_slam3_detailed_comments_kor_tpu_torch.utils import timing as ttiming
from orb_slam3_detailed_comments_kor_tpu_torch.utils import verbose as tverbose

# TUM-VI's 512x512 stereo-fisheye settings (TUM_512.yaml's layout: a second
# Kannala-Brandt camera and the right-to-left extrinsic Tlr)
TUMVI_YAML = """%YAML:1.0
Camera.type: "KannalaBrandt8"
Camera.fx: 190.97847715128717
Camera.fy: 190.9733070521226
Camera.cx: 254.93170605935475
Camera.cy: 256.8974428996504
Camera.k1: 0.0034823894022493434
Camera.k2: 0.0007150348452162257
Camera.k3: -0.0020532361418706202
Camera.k4: 0.00020293673591811182
Camera2.fx: 190.44236969414825
Camera2.fy: 190.4344384721956
Camera2.cx: 252.59949716835982
Camera2.cy: 254.91723064636983
Camera2.k1: 0.0034003170790442797
Camera2.k2: 0.001766278153469831
Camera2.k3: -0.00266312569781606
Camera2.k4: 0.0003299517423931039
Tlr: !!opencv-matrix
  rows: 3
  cols: 4
  dt: f
  data: [ 0.999999445773493, 0.000791687752817, 0.000694034010224, 0.101063427414194,
          -0.000823363992158, 0.998899461915674, 0.046895490788700, 0.001946204678584,
          -0.000656143613644, -0.046896036240590, 0.998899560014887, 0.001015350132563]
Camera.width: 512
Camera.height: 512
Camera.fps: 20.0
Camera.bf: 19.3079
Camera.RGB: 1
ThDepth: 40.0
Tbc: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [-0.9995250378696743, 0.0075019185074052044, -0.02989013031643309, 0.045574835649698026,
         0.029615343885863205, -0.03439736061393144, -0.998969345370175, -0.071161801837997044,
         -0.008522328211654736, -0.9993800792498829, 0.03415885127385616, -0.044681254117144367,
         0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 0.000022
IMU.AccWalk: 0.00086
IMU.Frequency: 200
ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""

# a rectification with distortion and a rotated R on both sides (EuRoC's
# LEFT/RIGHT blocks with a 1.5 degree tilt), so the maps are far from the grid
_K = np.array([[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]])
_D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
_c, _s = np.cos(np.radians(1.5)), np.sin(np.radians(1.5))
_R = np.array([[_c, 0.0, _s], [0.0, 1.0, 0.0], [-_s, 0.0, _c]]) @ np.array([[1.0, 0, 0], [0, _c, -_s], [0, _s, _c]])
_P = np.array([[435.2046959714599, 0, 367.4517211914062, -47.9], [0, 435.2046959714599, 252.2008514404297, 0],
               [0, 0, 1, 0]])
SEQ_T0_NS = chip_smoke.DS_T0_NS


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The settings files and a small EuRoC / TUM RGB-D / KITTI layout,
    with absolute EuRoC stamps, written once."""
    root = tmp_path_factory.mktemp("torch_datasets")
    out = {}
    for name, text in (("euroc", EUROC_YAML), ("tumvi", TUMVI_YAML)):
        p = root / f"{name}.yaml"
        p.write_text(text)
        out[name] = str(p)
    rng = np.random.RandomState(1)
    seq = root / "euroc"
    for cam in ("cam0", "cam1"):
        (seq / "mav0" / cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i in range(5):
            tn = SEQ_T0_NS + i * 50_000_000
            chip_smoke.write_png_gray(str(seq / "mav0" / cam / "data" / f"{tn}.png"),
                                      rng.uniform(0, 255, (48, 64)))
            lines.append(f"{tn},{tn}.png")
        (seq / "mav0" / cam / "data.csv").write_text("\n".join(lines))
    (seq / "mav0" / "imu0").mkdir(parents=True)
    rows = ["#timestamp,wx,wy,wz,ax,ay,az"]
    for i in range(60):
        w, a = rng.randn(3) * 0.1, rng.randn(3) + [0, -9.8, 0]
        rows.append(f"{SEQ_T0_NS - 10_000_000 + i * 5_000_000}," + ",".join(f"{v:.9g}" for v in (*w, *a)))
    (seq / "mav0" / "imu0" / "data.csv").write_text("\n".join(rows))
    out["euroc_seq"] = str(seq)
    tum = root / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir(parents=True)
    rgb, dep = ["# rgb"], ["# depth"]
    for i in range(4):
        t = 1305031102.175304 + i * 0.033
        rn, dn = f"rgb/{t:.6f}.png", f"depth/{t + 0.004 * (i - 1):.6f}.png"
        chip_smoke.write_png_gray(str(tum / rn), rng.uniform(0, 255, (32, 40)))
        chip_smoke.write_png_gray(str(tum / dn), rng.uniform(0, 255, (32, 40)))
        rgb.append(f"{t:.6f} {rn}")
        dep.append(f"{t + 0.004 * (i - 1):.6f} {dn}")
    rgb.append(f"{1305031102.175304 + 9.0:.6f} rgb/none.png")  # no depth within 0.02 s
    (tum / "rgb.txt").write_text("\n".join(rgb))
    (tum / "depth.txt").write_text("\n".join(dep))
    out["tum_seq"] = str(tum)
    kitti = root / "kitti"
    for d in ("image_0", "image_1"):
        (kitti / d).mkdir(parents=True)
    for i in range(3):
        for d in ("image_0", "image_1") if i < 2 else ("image_0",):
            chip_smoke.write_png_gray(str(kitti / d / f"{i:06d}.png"), rng.uniform(0, 255, (20, 30)))
    (kitti / "times.txt").write_text("0.000000e+00\n1.037359e-01\n2.073970e-01\n")
    out["kitti_seq"] = str(kitti)
    return out


@pytest.mark.parametrize("name,sensor", [("euroc", "IMU_STEREO"), ("euroc", "STEREO"), ("tumvi", "IMU_STEREO"),
                                         ("tumvi", "MONOCULAR")])
def test_load_settings_equal(files, name, sensor):
    """Every field of the configs built from one settings file, the KB8
    rig's ``Camera2.*`` and ``Tlr`` included, and the rectification blocks."""
    from orb_slam3_detailed_comments_kor_tpu import config as jcfg

    j = jds.load_settings(files[name], getattr(jcfg.SensorType, sensor))
    t = tds.load_settings(files[name], getattr(jcfg.SensorType, sensor))
    assert dataclasses.asdict(j.config) == dataclasses.asdict(t.config)
    if name == "tumvi":
        assert t.config.camera.model == "kannala_brandt8" and len(t.config.camera.right_intrinsics) == 8
        assert len(t.config.camera.tlr) == 12 and t.rectify is None
    else:
        for f in dataclasses.fields(j.rectify):
            assert np.array_equal(getattr(j.rectify, f.name), getattr(t.rectify, f.name)), f.name
    assert j.raw.keys() == t.raw.keys()
    for k, v in j.raw.items():
        assert np.array_equal(v, t.raw[k]) if isinstance(v, np.ndarray) else v == t.raw[k], k


@pytest.mark.parametrize("side", ["left", "right"])
def test_rectification_bit_equal(side):
    """``undistort_rectify_map`` on a distorted, rotated rectification and
    ``remap_bilinear`` through its maps: bit-equal."""
    P = _P if side == "right" else np.c_[_P[:, :3], np.zeros(3)]
    R = _R if side == "right" else _R.T
    jm = jds.undistort_rectify_map(_K, _D, R, P, 96, 80)
    tm = tds.undistort_rectify_map(_K, _D, R, P, 96, 80)
    assert all(np.array_equal(a, b) for a, b in zip(jm, tm))
    u = np.meshgrid(np.arange(96), np.arange(80))[0]
    assert np.abs(jm[0] - u).max() > 1.0  # far from the identity
    img = np.random.RandomState(2).uniform(0, 255, (80, 96)).astype(np.float32)
    # sample inside the image: shift the maps into it
    mx, my = jm[0] - jm[0].min() + 0.25, jm[1] - jm[1].min() + 0.25
    assert np.array_equal(jds.remap_bilinear(img, mx, my), tds.remap_bilinear(img, mx, my))
    assert np.array_equal(jds.remap_bilinear(img, *jm), tds.remap_bilinear(img, *jm))


@pytest.fixture(scope="module")
def nat():
    """The port's native library, built from its own native/host_ops.cpp
    into the port's _build/ (g++ and zlib are part of this environment)."""
    return tnh.load()


def test_native_build_location(nat, tmp_path, monkeypatch):
    """The port builds its own source under its _build/, keyed on the
    source's hash, and loads it again without rebuilding; the build command
    links zlib and pthreads and no libpng, and the library needs no
    libpng."""
    path = tnh.library_path()
    assert os.path.dirname(path) == tnh.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("libhost_ops_") and tnh.load()._lib is nat._lib
    assert tnh.SOURCE == os.path.join(os.path.dirname(tnh.BUILD_DIR), "native", "host_ops.cpp")
    commands = []
    run = tnh.subprocess.run
    monkeypatch.setattr(tnh.subprocess, "run", lambda cmd, **k: commands.append(cmd) or run(cmd, **k))
    monkeypatch.setattr(tnh, "BUILD_DIR", str(tmp_path))
    tnh._build(str(tmp_path / "lib.so"))
    assert len(commands) == 1 and commands[0][0] == "g++" and tnh.SOURCE in commands[0]
    assert [a for a in commands[0] if a.startswith("-l")] == ["-lz", "-lpthread"]
    needed = chip_smoke.needed_libraries(str(tmp_path / "lib.so"))
    assert any(n.startswith("libz.") for n in needed) and not any("png" in n for n in needed), needed


def _png_chunk(kind, data):
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_rows(s, depth):
    """The filtered scanlines of samples [H, W, channels]: packed MSB first
    below 8 bits, 16-bit samples big-endian, row y filtered with type
    y % 5, so that None, Sub, Up, Average and Paeth all occur."""
    h, w, ch = s.shape
    if depth < 8:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.int64)
        padded[:, :w] = s[..., 0]
        groups = padded.reshape(h, -1, per)
        rows = sum(groups[..., k] << (8 - depth * (k + 1)) for k in range(per)).astype(np.uint8)
    else:
        rows = s.reshape(h, w * ch).astype(">u2" if depth == 16 else np.uint8).view(np.uint8).reshape(h, -1)
    raw = rows.astype(np.int64)
    bpp = max(1, ch * depth // 8)
    lines = []
    for y in range(h):
        x = raw[y]
        up = raw[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        kind = y % 5
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][kind]
        lines.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(lines)


# Adam7 passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def write_png(path, samples, color, depth, palette=None, trns=None, n_idat=1, interlace=0):
    """A PNG of ``samples`` ([H, W, channels] integers at ``depth`` bits,
    or palette indices) written by hand with ``zlib`` (see
    ``_filtered_rows``), the zlib stream split into ``n_idat`` IDAT chunks;
    ``interlace=1`` writes the seven Adam7 passes."""
    s = np.asarray(samples)
    s = s.reshape(s.shape[0], s.shape[1], -1)
    h, w, _ = s.shape
    if interlace:
        data = b"".join(_filtered_rows(s[y0::dy, x0::dx], depth) for y0, x0, dy, dx in ADAM7
                        if y0 < h and x0 < w)
    else:
        data = _filtered_rows(s, depth)
    z = zlib.compress(data, 6)
    cut = np.linspace(0, len(z), n_idat + 1).astype(int)
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _png_chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes())
    out += b"".join(_png_chunk(b"IDAT", z[a:b]) for a, b in zip(cut[:-1], cut[1:]))
    with open(path, "wb") as f:
        f.write(out + _png_chunk(b"IEND", b""))


# name -> (PNG colour type, bit depth, channels, palette entries, tRNS, IDAT chunks, shape)
PNG_FORMATS = {
    "gray1": (0, 1, 1, None, False, 1, (23, 37)),
    "gray2": (0, 2, 1, None, False, 1, (23, 37)),
    "gray4": (0, 4, 1, None, False, 1, (23, 37)),
    "gray8": (0, 8, 1, None, False, 1, (23, 37)),
    "gray16": (0, 16, 1, None, False, 1, (23, 37)),
    "rgb8": (2, 8, 3, None, False, 1, (23, 37)),
    "rgb16": (2, 16, 3, None, False, 1, (23, 37)),
    "rgba8": (6, 8, 4, None, False, 1, (23, 37)),
    "rgba16": (6, 16, 4, None, False, 1, (23, 37)),
    "palette8": (3, 8, 1, 200, False, 1, (23, 37)),
    "palette8_trns": (3, 8, 1, 200, True, 1, (23, 37)),
    "palette4": (3, 4, 1, 16, False, 1, (23, 37)),
    "palette1_short": (3, 1, 1, 1, False, 1, (23, 37)),  # index 1 lies past the one PLTE entry
    "gray8_idat7": (0, 8, 1, None, False, 7, (23, 37)),
    "frame480x752": (0, 8, 1, None, False, 3, (480, 752)),
}


def _png_samples(name, rng):
    color, depth, ch, n_pal, trns, n_idat, (h, w) = PNG_FORMATS[name]
    top = 2 ** (min(depth, 8) if color == 3 else depth) - 1
    samples = rng.randint(0, (min(n_pal, top + 1) if name != "palette1_short" else 2) if color == 3 else top + 1,
                          (h, w, ch))
    palette = rng.randint(0, 256, (n_pal, 3)) if color == 3 else None
    alpha = rng.randint(0, 256, n_pal // 2) if trns else None
    return samples, palette, alpha, n_idat


@pytest.mark.parametrize("name", sorted(PNG_FORMATS))
def test_png_decoder_bit_equal_to_libpng(nat, tmp_path, name):
    """The port's zlib-only decoder against the reference's libpng build on
    hand-written files (every row filter type in each): bit-equal."""
    rng = np.random.RandomState(sorted(PNG_FORMATS).index(name))
    samples, palette, alpha, n_idat = _png_samples(name, rng)
    color, depth = PNG_FORMATS[name][:2]
    p = str(tmp_path / "x.png")
    write_png(p, samples, color, depth, palette=palette, trns=alpha, n_idat=n_idat)
    want = jnh.load().load_gray(p)
    got = nat.load_gray(p)
    assert want is not None and got is not None and got.shape == samples.shape[:2]
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(tds.load_gray(p), want)


@pytest.mark.parametrize("depth", [8, 16])
def test_png_gray_alpha_takes_gray_channel(nat, tmp_path, depth):
    """Gray+alpha (F32): the port takes the gray channel, PIL's
    ``convert("L")``; the reference's libpng build reads past each row
    and is off by tens of grey levels."""
    from PIL import Image

    rng = np.random.RandomState(7)
    samples = rng.randint(0, 2 ** depth, (19, 29, 2))
    p = str(tmp_path / "la.png")
    write_png(p, samples, 4, depth)
    got = nat.load_gray(p)
    assert np.array_equal(got, samples[..., 0].astype(np.float32) / (257.0 if depth == 16 else 1.0))
    pil = np.asarray(Image.open(p).convert("L")).astype(np.float32)
    if depth == 8:
        assert np.array_equal(got, pil)
        assert np.abs(jnh.load().load_gray(p) - pil).max() > 5.0  # the reference's fault
    else:
        assert np.abs(got - pil).max() < 1.0


@pytest.mark.parametrize("fault", ["interlaced", "truncated", "bad_idat_crc", "bad_idat_data", "bad_filter"])
def test_png_bad_files_refused(nat, tmp_path, fault):
    """An interlaced, truncated or damaged file returns a nonzero code and
    ``load_gray`` gives None, without a crash; the dataset loader then
    decodes an interlaced file with PIL."""
    rng = np.random.RandomState(11)
    samples = rng.randint(0, 256, (21, 33, 1))
    p = str(tmp_path / "bad.png")
    write_png(p, samples, 0, 8, n_idat=2 if fault == "bad_idat_crc" else 1, interlace=int(fault == "interlaced"))
    with open(p, "rb") as f:
        data = bytearray(f.read())
    at = data.index(b"IDAT") + 4  # the first IDAT's data
    if fault == "truncated":
        data = data[: at + 20]
    elif fault == "bad_idat_crc":
        data[at + 10] ^= 0x40
    elif fault == "bad_idat_data":  # a zlib stream that inflate rejects, with a valid CRC
        n = struct.unpack(">I", data[at - 8:at - 4])[0]
        body = bytes([0x78, 0x9C, 0xFF]) + bytes(n - 3)
        data[at:at + n + 4] = body + struct.pack(">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF)
    elif fault == "bad_filter":  # filter type 9 on the first row, CRC kept valid
        n = struct.unpack(">I", data[at - 8:at - 4])[0]
        raw = bytearray(zlib.decompress(bytes(data[at:at + n])))
        raw[0] = 9
        body = zlib.compress(bytes(raw), 6)
        data = data[:at - 8] + _png_chunk(b"IDAT", body) + _png_chunk(b"IEND", b"")
    with open(p, "wb") as f:
        f.write(bytes(data))
    buf = np.empty((64, 64), np.float32)
    h, w = tnh.ctypes.c_int(), tnh.ctypes.c_int()
    rc = nat._lib.decode_gray(p.encode(), tnh._fptr(buf), 64, 64, tnh.ctypes.byref(h), tnh.ctypes.byref(w))
    assert rc != 0 and nat.load_gray(p) is None
    if fault == "interlaced":
        assert np.array_equal(tds.load_gray(p), samples[..., 0].astype(np.float32))


def test_native_remap_matches_numpy(nat):
    rng = np.random.RandomState(5)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    mx = rng.uniform(-2, 65, (48, 64)).astype(np.float32)
    my = rng.uniform(-2, 49, (48, 64)).astype(np.float32)
    a = nat.remap_bilinear(img, mx, my)
    np.testing.assert_allclose(a, tds.remap_bilinear(img, mx, my), rtol=0, atol=1e-4)
    assert np.array_equal(a, jnh.load().remap_bilinear(img, mx, my))


@pytest.mark.parametrize("kind", ["png8_pil", "png8_stdlib", "png16_pil", "pgm"])
def test_native_decode(nat, tmp_path, kind):
    """The native decoder against PIL (8- and 16-bit PNGs), the stdlib PNG
    writer's files and binary PGM; ``load_gray`` of both packages equal."""
    from PIL import Image

    rng = np.random.RandomState(3)
    arr = rng.uniform(0, 255, (40, 56)).astype(np.uint8)
    p = str(tmp_path / ("x.pgm" if kind == "pgm" else "x.png"))
    if kind == "png8_pil":
        Image.fromarray(arr, mode="L").save(p)
    elif kind == "png8_stdlib":
        chip_smoke.write_png_gray(p, arr)
    elif kind == "png16_pil":
        arr16 = (arr.astype(np.uint16) * 257 + rng.randint(0, 200, arr.shape)).astype(np.uint16)
        Image.fromarray(arr16).save(p)
    else:
        with open(p, "wb") as f:
            f.write(b"P5\n56 40\n255\n" + arr.tobytes())
    out = nat.load_gray(p)
    want = arr.astype(np.float32)
    if kind.startswith("png"):
        pil = np.asarray(Image.open(p)).astype(np.float32)
        want = pil / 257.0 if kind == "png16_pil" else pil
    np.testing.assert_allclose(out, want, rtol=0, atol=0.5 if kind == "png16_pil" else 0.0)
    assert np.array_equal(tds.load_gray(p), jds.load_gray(p))


def test_euroc_sequence_equal(files, tmp_path):
    """Frames, absolute stamps (integer ns kept), IMU windows and the
    timestamp filter."""
    j, t = jds.EurocSequence(files["euroc_seq"]), tds.EurocSequence(files["euroc_seq"])
    assert [dataclasses.astuple(f) for f in j.frames] == [dataclasses.astuple(f) for f in t.frames]
    assert len(t) == 5 and t[0].t_ns == SEQ_T0_NS and t[0].right is not None
    for i in range(1, 5):
        got = t.imu.between(t[i - 1].t, t[i].t)
        for a, b in zip(j.imu.between(j[i - 1].t, j[i].t), got):
            assert np.array_equal(a, b)
        assert len(got[0]) == 10  # 50 ms at 200 Hz, the sample at the frame's stamp included
    stamps = tmp_path / "stamps.txt"
    stamps.write_text("\n".join(str(f.t_ns) for f in t.frames[1:4:2]))
    jf, tf = jds.EurocSequence(files["euroc_seq"], str(stamps)), tds.EurocSequence(files["euroc_seq"], str(stamps))
    assert [f.t_ns for f in tf.frames] == [f.t_ns for f in jf.frames] == [t[1].t_ns, t[3].t_ns]


def test_tum_and_kitti_sequences_equal(files):
    """TUM RGB-D nearest-stamp association (a frame without a depth map
    within 0.02 s is left out) and the KITTI layout (a frame without a
    right image)."""
    j, t = jds.TumRgbdSequence(files["tum_seq"]), tds.TumRgbdSequence(files["tum_seq"])
    assert [dataclasses.astuple(f) for f in j.frames] == [dataclasses.astuple(f) for f in t.frames]
    assert len(t) == 4 and all(f.depth for f in t.frames)
    j, t = jds.KittiSequence(files["kitti_seq"]), tds.KittiSequence(files["kitti_seq"])
    assert [dataclasses.astuple(f) for f in j.frames] == [dataclasses.astuple(f) for f in t.frames]
    assert [f.right is None for f in t.frames] == [False, False, True]


@pytest.mark.parametrize("native", [True, False])
def test_stereo_feeder(files, nat, native, monkeypatch):
    """The prefetching feeder's order and images (decode and rectify)
    against ``load_gray`` + ``remap_bilinear``; without the native library
    it decodes in Python and says so."""
    seq = tds.EurocSequence(files["euroc_seq"])
    mx, my = tds.undistort_rectify_map(_K, _D, np.eye(3), np.c_[_K, np.zeros(3)], 64, 48)
    if not native:
        monkeypatch.setattr(tnh, "load", lambda: (_ for _ in ()).throw(RuntimeError("no native library")))
    feeder = tnh.StereoFeeder([f.left for f in seq.frames], [f.right for f in seq.frames], 48, 64,
                              maps_l=(mx, my), maps_r=(mx, my), depth=3, workers=2)
    assert feeder.native is native
    got = list(feeder)
    assert len(got) == len(seq)
    for (left, right), f in zip(got, seq.frames):
        for img, path in ((left, f.left), (right, f.right)):
            want = tds.remap_bilinear(tds.load_gray(path), mx, my)
            np.testing.assert_allclose(img, want, rtol=0, atol=1e-4 if native else 0.0)


class _Recorder:
    """A stand-in system: records each call of the node's sync loop."""

    def __init__(self):
        self.calls = []

    def _log(self, name, t, *imgs, imu=None):
        self.calls.append((name, t, tuple(float(np.asarray(i).ravel()[0]) for i in imgs),
                           None if imu is None else [float(s[0]) for s in imu]))

    def track_mono(self, img, t):
        self._log("mono", t, img)

    def track_stereo(self, a, b, t):
        self._log("stereo", t, a, b)

    def track_rgbd(self, a, d, t):
        self._log("rgbd", t, a, d)

    def track_mono_inertial(self, img, t, imu):
        self._log("mono_inertial", t, img, imu=imu)

    def track_stereo_inertial(self, a, b, t, imu):
        self._log("stereo_inertial", t, a, b, imu=imu)


def _drive(online, mode, script):
    """Run ``script`` (a list of ("left"|"right"|"imu"|"step", t)) on a
    node of ``online`` over a recorder; returns the calls, processed count,
    drops and step results."""
    sys_ = _Recorder()
    node = online.OnlineNode(sys_, mode=mode, max_queue=3)
    steps = []
    for what, t in script:
        if what == "imu":
            node.publish_imu(t, np.full(3, t), np.zeros(3))
        elif what == "step":
            steps.append(node._step())
        else:
            getattr(node, f"publish_{what}")(t, np.full((2, 2), t, np.float32))
    return sys_.calls, node.n_processed, node.left.n_dropped, node.right.n_dropped, steps


NODE_SCRIPTS = {
    # FIFO order and the oldest frames dropped past max_queue
    "fifo_drop": ("stereo", [("left", 0.0), ("left", 0.05), ("left", 0.1), ("left", 0.15), ("left", 0.2)]
                  + [("right", t) for t in (0.1, 0.15, 0.2)] + [("step", None)] * 4),
    # the right stream starts two frames late: the older unmatched left frames go
    "unmatched": ("stereo", [("left", 0.0), ("left", 0.05), ("right", 0.1), ("left", 0.1), ("step", None),
                             ("right", 0.15), ("left", 0.151), ("step", None), ("step", None)]),
    # a frame waits until an IMU sample newer than it arrives; its window is
    # the samples up to its stamp
    "imu_window": ("stereo_inertial", [("left", 0.0), ("right", 0.0), ("step", None), ("imu", -0.01),
                                       ("step", None), ("imu", 0.002), ("step", None), ("left", 0.05),
                                       ("right", 0.05), ("imu", 0.05), ("step", None), ("imu", 0.07),
                                       ("step", None)]),
    "mono_inertial": ("mono_inertial", [("imu", 0.01), ("left", 0.0), ("step", None), ("left", 0.02),
                                        ("step", None), ("imu", 0.03), ("step", None)]),
    "rgbd": ("rgbd", [("left", 0.0), ("right", 0.004), ("step", None), ("left", 0.03), ("step", None)]),
    "mono": ("mono", [("left", 0.0), ("left", 0.1), ("step", None), ("step", None), ("step", None)]),
}


@pytest.mark.parametrize("case", sorted(NODE_SCRIPTS))
def test_online_node_equal(case):
    """The port's OnlineNode and the reference's make the same calls, drops
    and step results on the same published stream."""
    mode, script = NODE_SCRIPTS[case]
    got = _drive(ton, mode, script)
    assert got == _drive(jon, mode, script)
    assert got[1] >= 1
    if case == "fifo_drop":
        assert got[2] == 2 and [c[1] for c in got[0]] == [0.1, 0.15, 0.2]
    if case == "imu_window":
        assert got[0][0][3] == [-0.01] and got[0][1][3] == [0.002, 0.05]


def test_online_node_threads_and_stop():
    """Producer threads publish left, right and IMU; ``stop`` drains the
    queues, surfaces nothing, and calls the system's ``flush_decisions``."""
    rec = _Recorder()
    rec.flushed = 0
    rec.flush_decisions = lambda: setattr(rec, "flushed", rec.flushed + 1)
    node = ton.OnlineNode(rec, mode="stereo_inertial", max_queue=40).start()
    n = 30
    threads = [threading.Thread(target=lambda: [node.publish_left(i * 0.05, np.full((2, 2), i)) for i in range(n)]),
               threading.Thread(target=lambda: [node.publish_right(i * 0.05, np.full((2, 2), i)) for i in range(n)]),
               threading.Thread(target=lambda: [node.publish_imu(i * 0.005, np.zeros(3), np.zeros(3))
                                                for i in range(10 * n + 1)])]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    node.stop(drain=True, timeout=30.0)
    assert node.n_processed == n and rec.flushed == 1
    assert [c[1] for c in rec.calls] == [i * 0.05 for i in range(n)]
    assert sum(len(c[3]) for c in rec.calls) == 10 * (n - 1) + 1
    with pytest.raises(ValueError):
        ton.OnlineNode(rec, mode="stereo_rgbd")


def test_verbose_equal(capsys):
    """The leveled logger prints at or below its level, to stderr, as the
    reference's."""
    out = []
    for mod in (jverbose, tverbose):
        v = mod.Verbose
        v.set_th_verbosity(v.VERBOSITY_VERBOSE)
        v.normal("a")
        v.verbose("b")
        v.debug("c")
        v.print_mess("d", v.VERBOSITY_QUIET)
        v.set_th_verbosity(v.VERBOSITY_QUIET)
        v.normal("e")
        err = capsys.readouterr().err
        out.append([ln.split("] ", 1)[1] for ln in err.splitlines()])
    assert out[0] == out[1] == ["a", "b", "d"]


def test_torch_profile(tmp_path):
    """``torch_profile`` writes a Chrome trace of the block into its folder,
    and does nothing without one."""
    with ttiming.torch_profile(None):
        torch.ones(3).sum()
    logdir = tmp_path / "prof"
    with ttiming.torch_profile(str(logdir)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = list(logdir.iterdir())
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
