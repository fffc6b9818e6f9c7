"""Smoke test of the PyTorch/CUDA port on one GPU: kernels, then the main path.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--baseline-csrc DIR]

Phase 0  builds the CUDA kernels from ``orb_slam3_detailed_comments_kor_tpu_torch/csrc``
         (one nvcc per source, in parallel), prints each kernel's registers,
         shared memory and spills, and the card's name and power limit.
Phase 1  runs one tracked frame at bench scale (480x752, 1200 features,
         16384 landmarks) while recording the inputs each kernel wrapper
         receives, then holds every kernel against its plain PyTorch version
         on those inputs and on edge cases (exact equality), and times the
         kernel, the plain version and, where one exists, a single PyTorch
         call computing the same function. Times are device times: the
         launches queue behind a sleep kernel, so the host's wrapper is not
         in them. Each wrapper call at the main path's inputs must put
         exactly one device kernel on the stream (torch.profiler's CUDA
         activity), so a kernel's time is the whole call's device work. An
         empty kernel, timed the same way, gives the launch floor. Each
         kernel's bound is the larger of its bytes over the HBM rate and its
         operations over their pipes' instruction rates. With ``--baseline-csrc
         DIR`` (an earlier ``csrc/`` with the same C entries) the script
         builds DIR's kernels into a library of its own and, with
         ``_cuda.launch`` pointed at it, times them on the same inputs in
         turns with the current ones.
Phase 2  the main path: renders 21 strafe frames on the card, initialises the
         map from frame 0 (process_stereo + make_keyframe) and tracks frames
         1-20 with full_frame_step. Every frame must be ok with >= 300
         inliers and a camera-centre error <= 3 cm. The launch counters,
         zeroed before it, must show each kernel's fixed launches per
         tracked frame (LAUNCHES_PER_FRAME) on every tracked frame.
Phase 3  tracks frame 1 again on the CPU (plain versions) from the same map
         and checks that the card and the CPU agree.
Phase 4  the SLAM loop at bench scale: ``slam.system.SlamSystem`` (loop
         closing off) over bench.py's 130-frame strafe sequence, rendered on
         the card, after a warm-up system over its first frames. Blocks on
         each frame's pose (bench.py's latency pass) and prints frame wall
         p50/p99 (frames 5-129), frames/s, the ATE, the keyframes, the peak
         device memory and the device ms of one local-BA, fusion and
         landmark-culling slice. It fails unless the final state is OK, all
         130 frames are recorded, >= 10 keyframes were inserted, the
         counters (zeroed before it) show each kernel's fixed launches per
         tracked frame, a frame that services a local-BA slice and one that
         services a fusion slice make no synchronizing call outside the
         batched decision read, and the ATE is at most the JAX reference's
         (REF_ATE_M) plus 5 mm.
Phase 5  the card against the CPU for the loop: the small configuration
         (240x376, 600 features, 8 keyframe slots) over 16 frames with
         decision_batch=1 on both; keyframes must be inserted at the same
         frames, camera centres agree within TRANS_TOL and rotations within
         ROT_TOL.

The last stdout line is {"ok": true, "device": {...}}; the line before it
lists every kernel with its launches, error, times and bound, and the
launch floor (``launch_floor_ms``). Any failure
raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import glob
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

H, W = 480, 752
FX, BASELINE = 458.0, 0.11
N_FEATURES, CELL = 1200, 32
MAX_KF, MAX_LM = 64, 16384
MIN_INLIERS = 30
N_FRAMES = 21
SPEED = 0.03
TIMING_RUNS = 20
MIN_TRACKED_INLIERS = 300   # the JAX reference tracks 463-691 on this sequence
MAX_CENTRE_ERR = 0.03       # m; the JAX reference stays within 0.0097 m
DEVICE = "cuda:0"
# parity tolerances between the card and the CPU on one tracked frame
ROT_TOL, TRANS_TOL = 1e-3, 2e-3
# Phases 4-5: the SLAM loop. bench.py's stereo configuration and sequence
# (130 strafe frames at 0.03 m/frame, 20 fps, 64 keyframe slots, 4096 local
# landmarks, a keyframe at least every 10 frames), loop closing off.
LOOP_FRAMES, LOOP_WARMUP, FPS = 130, 24, 20.0
# ATE of the JAX reference (orb_slam3_detailed_comments_kor_tpu.slam.system.
# SlamSystem, enable_loop_closing=False) on this configuration and sequence,
# eval.ate.ate_rmse over all 130 frames, run on a CPU by
# tools/jax_loop_ate.py: 14 keyframes, final state OK, 2309 landmarks.
REF_ATE_M = 0.005604550522747823
ATE_MARGIN = 0.005
MIN_LOOP_KF = 10
SMALL_LOOP_FRAMES = 16
SLEEP_MS = 400  # the sleep kernel that a slice call must return before
# H100 SXM (NVIDIA data sheet, 700 W): HBM3 at 3.35 TB/s, and 67 TFLOP/s
# fp32 on the CUDA cores, which counts an FMA as two: 33.5 T fp32
# instructions/s (132 SMs x 128 lanes x 1.98 GHz), also the rate at which
# the SMs issue instructions of any type. Per SM and clock the INT32 pipe
# (add, logic, shift, compare) takes 64 lanes and POPC 16 (CUDA C++
# Programming Guide, arithmetic instruction throughput, cc 9.0).
HBM_BYTES_PER_S = 3.35e12
INSTR_ISSUE_RATE = 33.5e12
OPS_PER_S = {"fp32": 33.5e12, "int32": 16.75e12, "popc": 4.19e12}
# launches of each kernel per tracked frame: process_stereo's FAST
# (ops/orb.py) and its two patch gathers (ops/orb.py, ops/stereo.py), the
# stereo band match (ops/stereo.py) and tracking's three projection
# searches (slam/tracking.py)
LAUNCHES_PER_FRAME = {"fast_nms": 1, "gather_patches": 2, "masked_best2": 4}

# Edge cases of the kernels, checked exactly in phase 1 and by
# tests/test_torch_cuda.py. Matcher: (N, M, byte offset of the mask);
# M % 16 != 0 and the offset mask start rows off a 16-byte boundary, every
# case has an all-masked row (row 0 when N > 1), a one-column row and
# tied distances; N = 1 rows are random or one-column.
MATCH_EDGE_CASES = ((257, 130, 0), (300, 1201, 0), (1, 1201, 0), (1, 130, 0), (64, 1200, 3))
# FAST+NMS: (H, W of level 0, padded width, th_hi, th_lo) over 4 levels and
# 2 views of blocky integer-valued images (tied scores); padded widths are
# multiples of 4 (the kernel's float4 rows) but not of the 128-px tile, 97
# and 120 rows no multiple of the 16-row tile, and the level extents end
# inside tiles. The last case has th_hi < th_lo.
FAST_EDGE_CASES = ((120, 200, 204, 20.0, 7.0), (120, 200, 260, 20.0, 7.0),
                   (97, 301, 304, 7.0, 20.0))
# Patch gather: (R, W, K, ph, pw, row corner type, column corner type), raw
# corners. The first four of a case lie past the top, bottom, left and right
# edges, and int64 ones include -2^40 and 2^40, which a clamp after a cast
# to int32 gets wrong. K = 0, 1 and counts that are no multiple of the
# kernel's 4 keypoints per block; the main path's two patch shapes at
# widths 128 and 131 (no multiple of 4); ph = R with pw = W; a 3-wide patch,
# whose float4 stores span rows.
GATHER_EDGE_CASES = ((300, 128, 97, 48, 45, "int64", "int32"), (300, 131, 97, 48, 45, "int32", "int32"),
                     (200, 131, 5, 11, 21, "int64", "int64"), (200, 128, 1, 11, 21, "int32", "int64"),
                     (60, 131, 0, 48, 45, "int32", "int32"), (48, 45, 7, 48, 45, "int64", "int64"),
                     (40, 128, 33, 40, 3, "int32", "int32"))


def log(*a):
    print(*a, flush=True)


def device_ms(fn, runs=TIMING_RUNS, reps=5):
    """Device milliseconds per call of ``fn()``: the median over ``reps`` of
    ``runs`` back-to-back calls between two CUDA events. A sleep kernel
    holds the stream while the host enqueues the calls, so the events time
    the device's work and not the host's wrapper. Returns (median, min, max)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    per_call = []
    for _ in range(reps):
        torch.cuda._sleep(int(max(2.0 * runs * host_s, 2e-4) * 2e9))  # ~2 GHz SM clock
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(runs):
            fn()
        e.record()
        torch.cuda.synchronize()
        per_call.append(s.elapsed_time(e) / runs)
    return statistics.median(per_call), min(per_call), max(per_call)


def profiled_device_ms(fn, reps=3):
    """Device milliseconds of one call of ``fn()`` as torch.profiler's CUDA
    activity records it: the sum of the durations of the device work it
    put on the stream, the median over ``reps`` calls. Unlike ``device_ms``
    it needs no sleep kernel long enough to cover the host's enqueue, which
    a call of ~1,000 launches can outlast."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times.append(sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == DeviceType.CUDA) / 1e3)
    return statistics.median(times)


def host_ms_behind_sleep(fn):
    """Host ms that one call of ``fn()`` takes while a SLEEP_MS sleep kernel
    holds the stream: about its enqueue time, or at least the sleep if the
    call waits on the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_MS * 1e-3 * 2e9))  # ~2 GHz SM clock
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host_ms


def bound(nbytes, ops, **counts):
    """The least time the card could take: the larger of bytes over the HBM
    rate and the operations' time. ``ops`` maps an instruction type of
    OPS_PER_S to its count; each type takes at least its pipe's time and
    all of them at least the issue time. Returns both times, the bound and
    what sets it, plus ``counts`` (the data-dependent work)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max([n / OPS_PER_S[k] for k, n in ops.items()] + [sum(ops.values()) / INSTR_ISSUE_RATE])
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops, **counts)


def fast_nms_bound(flat, hs, ws, th_hi, th_lo):
    """Bytes: the three outputs over the whole stack, and each level's own
    pixels read once. Instructions on these inputs (fp32, int32): the
    compass pre-test and NMS at every level-interior pixel (32, 8); the
    bright/dark bits at min(th) and their run-of-9 tests where the compass
    test passes (48, 46); both thresholds' bits, their run tests and the
    four margin sums where those bits hold a run of 9 (272, 156)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import fast as fast_ops

    BN, Hp, Wp = flat.shape
    NL = len(hs)
    level_px = sum(int(h) * int(w) for h, w in zip(hs, ws)) * (BN // NL)
    inb = fast_ops.level_interior(tuple(int(v) for v in hs), tuple(int(v) for v in ws),
                                  3, Hp, Wp, flat.device).repeat(BN // NL, 1, 1)
    th = min(th_hi, th_lo)
    n_bright = n_dark = 0
    for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3)):
        d = fast_ops._shift(flat, dy, dx) - flat
        n_bright = n_bright + (d > th).int()
        n_dark = n_dark + (d < -th).int()
    interior = int(inb.sum())
    compass = int((inb & ((n_bright >= 2) | (n_dark >= 2))).sum())
    full = int((inb & (fast_ops.fast_scores_two(flat, th, th)[1] > 0)).sum())
    return bound(3 * flat.numel() * 4 + level_px * 4,
                 {"fp32": interior * 32 + compass * 48 + full * 272,
                  "int32": interior * 8 + compass * 46 + full * 156},
                 interior_px=interior, compass_px=compass, full_test_px=full)


def gather_bound(img2d, rows, cols, ph, pw):
    """Bytes: the corners, the image pixels that the clamped patches cover,
    each read once however many patches overlap it, and every patch pixel
    written once."""
    R, Wi = img2d.shape
    r = torch.clamp(rows, 0, R - ph).long()
    c = torch.clamp(cols, 0, Wi - pw).long()
    # the patches' rectangles as a 2-D difference array, summed along both axes
    d = torch.zeros((R + 1, Wi + 1), dtype=torch.int32, device=img2d.device)
    for dr, dc, sign in ((0, 0, 1), (0, pw, -1), (ph, 0, -1), (ph, pw, 1)):
        d.index_put_((r + dr, c + dc), torch.full(r.shape, sign, dtype=torch.int32, device=r.device),
                     accumulate=True)
    covered = int((d.cumsum(0).cumsum(1)[:R, :Wi] > 0).sum())
    K = rows.shape[0]
    return bound(K * (rows.element_size() + cols.element_size()) + covered * 4 + K * ph * pw * 4, {},
                 covered_px=covered)


def matcher_bound(a, b, m):
    """Bytes: mask, both descriptor sets, three outputs. Instructions: per
    allowed pair 8 POPC and 17 int32 (8 XOR, 7 adds, 2 compares), and one
    int32 compare per 4 mask bytes."""
    N, M = m.shape
    allowed = int(m.sum())
    return bound(N * M + a.numel() * 4 + b.numel() * 4 + N * 12,
                 {"popc": 8 * allowed, "int32": 17 * allowed + N * M // 4},
                 allowed_pairs=allowed)


def matcher_edge_inputs(n, m, offset, dev):
    """Packed descriptors and a mask for one of MATCH_EDGE_CASES."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb

    rng = np.random.default_rng(n * 10007 + m + offset)
    pool = rng.random((16, 256)) > 0.5  # B repeats 16 descriptors: ties
    a = rng.random((n, 256)) > 0.5
    b = pool[rng.integers(0, 16, size=m)]
    mask = rng.random((n, m)) > 0.7
    if n > 1:
        mask[0] = False               # no allowed column
        mask[1] = False
        mask[1, m - 1] = True         # one column: the last (a scalar tail's when unaligned)
    elif m < 1000:
        mask[0] = False
        mask[0, 67] = True            # a one-column single row
    pack = lambda x: orb.pack_descriptors(torch.from_numpy(x.astype(np.uint8)).to(dev))
    buf = torch.zeros(n * m + offset, dtype=torch.bool, device=dev)
    buf[offset:] = torch.from_numpy(mask.reshape(-1)).to(dev)
    return pack(a), pack(b), buf[offset:].view(n, m)


def fast_edge_inputs(h, w, wp, dev):
    """A [8, h, wp] stack of 4 levels x 2 views for one of FAST_EDGE_CASES:
    blocky integer-valued images, zero outside each level. Returns
    (flat, hs, ws)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid

    rng = np.random.default_rng(h * 1009 + wp)
    shapes = pyramid.level_shapes(h, w, 4, 1.2)
    flat = np.zeros((8, h, wp), np.float32)
    for i in range(8):
        hl, wl = shapes[i % 4]
        blocks = rng.integers(0, 256, size=(hl // 5 + 1, wl // 5 + 1))
        flat[i, :hl, :wl] = np.kron(blocks, np.ones((5, 5)))[:hl, :wl] + rng.integers(0, 12, (hl, wl))
    return torch.from_numpy(flat).to(dev), [s[0] for s in shapes], [s[1] for s in shapes]


def gather_edge_inputs(R, W, K, ph, pw, row_type, col_type, dev):
    """A random [R, W] image and raw corners for one of GATHER_EDGE_CASES.
    Returns (img, rows, cols, ph, pw), the gather's arguments."""
    rng = np.random.default_rng(R * 7919 + W * 31 + K)
    img = rng.random((R, W)).astype(np.float32)
    rows = rng.integers(-ph, R + 5, size=K)
    cols = rng.integers(-pw, W + 5, size=K)
    n = min(K, 4)  # past the top, the bottom, the left and the right edge
    rows[:n] = (-7, R - ph + 9, R // 3, R // 2)[:n]
    cols[:n] = (W // 3, W // 2, -9, W - pw + 4)[:n]
    if K > 5:
        if row_type == "int64":
            rows[4] = -(2 ** 40)
        if col_type == "int64":
            cols[5] = 2 ** 40
    as_t = lambda a, t: torch.from_numpy(a.astype(t)).to(dev)
    return torch.from_numpy(img).to(dev), as_t(rows, row_type), as_t(cols, col_type), ph, pw


def device_kernels(fn):
    """Names of the device activities (kernels, copies, fills) that one call
    of ``fn()`` puts on the card, as torch.profiler's CUDA activity records
    them. An empty kernel before and one after bracket the call, each a few
    host milliseconds apart: the profiler can drop a short kernel at the
    edge of its capture window, so it must report both brackets, and what
    lies between them is the call's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f in (_cuda.noop, fn, _cuda.noop):
            time.sleep(0.005)
            f()
            torch.cuda.synchronize()
        time.sleep(0.005)
    on_device = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                       key=lambda e: e.time_range.start)
    names = [e.name for e in on_device]
    if len(names) < 2 or "noop_kernel" not in names[0] or "noop_kernel" not in names[-1]:
        raise AssertionError(f"the profiler did not record the empty kernels around the call: {names}")
    return names[1:-1]


def build_baseline(csrc):
    """The kernels of an earlier ``csrc/`` (the same C entries), built with
    one nvcc into a library of their own and loaded."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

    out = os.path.join(_cuda.BUILD_DIR, "baseline")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libosk_baseline.so")
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", csrc, "-o", so,
           *sorted(glob.glob(os.path.join(csrc, "*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline nvcc failed:\n{proc.stderr[-4000:]}")
    return _cuda.bind(ctypes.CDLL(so))


@contextlib.contextmanager
def launching_from(lib):
    """Within the block every wrapper launches ``lib``'s kernels."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

    def launch(name, *args):
        err = getattr(lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"baseline {name}: CUDA error {err}")

    saved, _cuda.launch = _cuda.launch, launch
    try:
        yield
    finally:
        _cuda.launch = saved


def camera(dev):
    """The pinhole intrinsics [fx, fy, cx, cy] of the sequence."""
    return torch.tensor([FX, FX, W / 2.0, H / 2.0], dtype=torch.float32, device=dev)


def render_sequence(n, cam):
    """The strafe sequence on ``cam``'s device: ground-truth camera-to-world
    rotations and centres (numpy, per frame) and ``n`` stereo pairs."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic

    dev = cam.device
    scene = synthetic.default_scene(dev)
    Rs, ts = synthetic.make_trajectory(n, "strafe", speed=SPEED)
    frames = []
    for i in range(n):
        il, ir, _ = synthetic.stereo_pair(cam, torch.from_numpy(Rs[i]).to(dev),
                                          torch.from_numpy(ts[i]).to(dev), BASELINE, scene, h=H, w=W)
        frames.append((il, ir))
    return Rs, ts, frames


def init_map(il, ir, cam, R_wc, t_wc):
    """The map from one stereo pair (process_stereo + make_keyframe) at the
    ground-truth pose (R_wc, t_wc). Returns (frame, map, R_cw, t_cw)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend, map_state as msx, tracking

    dev = il.device
    frame0 = frontend.process_stereo(il, ir, BASELINE * FX, n_features=N_FEATURES, cell=CELL)
    ms = msx.empty_map(MAX_KF, frame0.n, MAX_LM, device=dev)
    R0 = torch.from_numpy(R_wc.T.copy()).to(dev)
    t0 = -R0 @ torch.from_numpy(t_wc).to(dev)
    ms = tracking.make_keyframe(
        ms, frame0, R0, t0, 0.0, 0, torch.full((ms.L,), -1, dtype=torch.int32, device=dev),
        cam.to(dev), float("inf"),
    )
    return frame0, ms, R0, t0


def step(ms, il, ir, state, cam):
    """One tracked frame: ``full_frame_step`` from ``state`` (R, t, vR, vt,
    has_velocity) on the pair's device."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking

    return tracking.full_frame_step(
        ms, il, ir, *state, cam.to(il.device), BASELINE * FX, W, H,
        n_features=N_FEATURES, cell=CELL, min_inliers=MIN_INLIERS,
    )


def loop_config(small=False):
    """The port's SLAMConfig of the SLAM loop: bench.py's stereo setup, or
    (small) the 240x376 / 600-feature geometry of tests/test_slam_e2e.py
    with 8 keyframe slots (so capacity reclaim runs), a keyframe every
    second frame (kf_ref_ratio 0.5, so that the frame gap decides every
    insertion) and synchronous decisions."""
    from orb_slam3_detailed_comments_kor_tpu_torch.config import (
        CameraConfig, CapacityConfig, ORBConfig, SLAMConfig, SensorType, TrackingConfig,
    )

    if small:
        h, w, fx = 240, 376, 230.0
        return SLAMConfig(
            sensor=SensorType.STEREO,
            camera=CameraConfig(width=w, height=h, fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
                                bf=BASELINE * fx, th_depth=35.0),
            orb=ORBConfig(n_features=600, cell_size=24),
            capacity=CapacityConfig(max_keyframes=8, max_landmarks=4096, max_local_landmarks=2048),
            tracking=TrackingConfig(max_frames_between_kf=2, kf_ref_ratio=0.5, decision_batch=1),
        )
    return SLAMConfig(
        sensor=SensorType.STEREO,
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=BASELINE * FX),
        orb=ORBConfig(n_features=N_FEATURES, cell_size=CELL),
        capacity=CapacityConfig(max_keyframes=MAX_KF, max_landmarks=MAX_LM, max_local_landmarks=4096),
        tracking=TrackingConfig(max_frames_between_kf=10),
    )


def render_loop_sequence(cfg, n, dev):
    """The strafe sequence at ``cfg``'s camera on ``dev``: ground-truth
    centres [n, 3] (numpy) and n stereo pairs."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic

    c = cfg.camera
    cam = torch.tensor([c.fx, c.fy, c.cx, c.cy], dtype=torch.float32, device=dev)
    scene = synthetic.default_scene(dev)
    Rs, ts = synthetic.make_trajectory(n, "strafe", speed=SPEED)
    frames = [synthetic.stereo_pair(cam, torch.from_numpy(Rs[i]).to(dev), torch.from_numpy(ts[i]).to(dev),
                                    BASELINE, scene, h=c.height, w=c.width)[:2] for i in range(n)]
    return ts, frames


def run_loop(cfg, frames, dev, on_frame=None, timer=False):
    """Feed ``frames`` to a new SlamSystem on ``dev``. ``on_frame(i, slam,
    call)`` may wrap each frame's ``call()``; ``timer`` turns on the
    system's host stage timer. Returns (slam, the frames at which a
    keyframe was inserted)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.timing import StageTimer

    slam = SlamSystem(cfg, device=dev)
    slam.timer = StageTimer(enabled=timer)
    kf_at = []
    for i, (il, ir) in enumerate(frames):
        n0 = slam.stats["kf_inserted"]
        call = lambda _i=i, _l=il, _r=ir: slam.track_stereo(_l, _r, _i / FPS)
        on_frame(i, slam, call) if on_frame else call()
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
    return slam, kf_at


def trajectory_diff(traj_a, traj_b):
    """Per-frame camera-centre distances (m) and rotation angles (rad)
    between two ``trajectory_arrays()`` results."""
    dc = np.linalg.norm(traj_a[1].astype(np.float64) - traj_b[1], axis=1)
    M = np.einsum("tji,tjk->tik", traj_a[2].astype(np.float64), traj_b[2].astype(np.float64))
    skew = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return dc, np.arcsin(np.clip(np.linalg.norm(skew, axis=1) / 2.0, 0.0, 1.0))


def max_abs_err(a, b):
    """Largest |a - b| over a pair of tensors or of tuples of tensors."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(
        float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
        for x, y in zip(a, b)
    )


def rotation_angle(Ra, Rb):
    """Angle between two near-equal rotations, from the skew part of
    Raᵀ·Rb (arccos of the trace loses ~1e-4 rad to float32 rounding)."""
    M = Ra.double().T @ Rb.double()
    skew = torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(torch.asin(torch.clamp(torch.linalg.vector_norm(skew) / 2.0, max=1.0)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline-csrc", default=None,
                        help="an earlier csrc/ whose kernels phase 1 times beside the current ones")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")

    from orb_slam3_detailed_comments_kor_tpu_torch.ops import (
        _cuda, cuda_fast, cuda_gather, cuda_matching,
    )
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx

    dev = torch.device(DEVICE)

    # ---- phase 0: card + build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.time()
    _cuda.library()
    log(f"phase 0: kernels built/loaded in {time.time() - t0:.1f} s")
    with open(_cuda.build_log_path()) as f:
        for line in f:
            if any(k in line for k in ("Compiling entry", "Used", "spill")):
                log("  ptxas:", line.strip())
    base_lib = None
    if args.baseline_csrc:
        t0 = time.time()
        base_lib = build_baseline(os.path.abspath(args.baseline_csrc))
        log(f"phase 0: baseline kernels of {args.baseline_csrc} built in {time.time() - t0:.1f} s")

    # ---- scene, trajectory, camera ---------------------------------------
    cam = camera(dev)
    Rs, ts, frames = render_sequence(N_FRAMES, cam)
    torch.cuda.synchronize()

    # ---- phase 1: kernels vs plain at the main path's inputs -------------
    _, ms_p1, R0, t0_ = init_map(*frames[0], cam, Rs[0], ts[0])
    eye = torch.eye(3, device=dev)
    state1 = (R0, t0_, eye, torch.zeros(3, device=dev), torch.tensor(False, device=dev))
    calls = {"fast_nms": [], "gather_patches": [], "masked_best2": []}
    wrapped = (
        (cuda_fast, "fast_nms", "fast_nms"),
        (cuda_gather, "gather_patches", "gather_patches"),
        (cuda_matching, "fused_masked_best2", "masked_best2"),
    )
    originals = {}
    for mod, name, key in wrapped:
        fn = getattr(mod, name)
        originals[key] = fn

        def spy(*args, _fn=fn, _key=key):
            calls[_key].append(args)
            return _fn(*args)

        spy.launches = 0  # the wrapper counts through its module name: the spy, here
        setattr(mod, name, spy)
    try:
        step(ms_p1, *frames[1], state1, cam)
        torch.cuda.synchronize()
    finally:
        for mod, name, key in wrapped:
            setattr(mod, name, originals[key])
    log(f"phase 1: recorded the inputs of {sum(map(len, calls.values()))} kernel calls in one tracked frame")

    # (kernel, case, wrapper, plain, args, bound() or None for an edge case,
    # which is checked but not timed, library call or None)
    checks = []
    (flat, hs, ws, th_hi, th_lo), = calls["fast_nms"]
    checks.append(("fast_nms", "x".join(map(str, flat.shape)), cuda_fast.fast_nms,
                   cuda_fast.fast_nms_plain, (flat, hs, ws, th_hi, th_lo),
                   fast_nms_bound(flat, hs, ws, th_hi, th_lo), None))
    for img2d, rows, cols, ph, pw in calls["gather_patches"]:
        # kernel and plain version take the raw corners, as the main path
        # hands them; the library call gets them clamped, as int64
        ri = torch.clamp(rows, 0, img2d.shape[0] - ph).long()
        ci = torch.clamp(cols, 0, img2d.shape[1] - pw).long()
        library = lambda _i=img2d, _r=ri, _c=ci, _ph=ph, _pw=pw: _i.unfold(0, _ph, 1).unfold(1, _pw, 1)[_r, _c]
        checks.append(("gather_patches", f"{tuple(img2d.shape)} K={rows.shape[0]} {ph}x{pw} "
                       f"corners {rows.dtype}/{cols.dtype}".replace("torch.", ""),
                       cuda_gather.gather_patches, cuda_gather.gather_patches_plain,
                       (img2d, rows, cols, ph, pw), gather_bound(img2d, rows, cols, ph, pw), library))
    gen = torch.Generator(device=dev).manual_seed(0)
    # tracking's [4096 x 1200] calls first: they are the main path's shape
    for a, b, m in sorted(calls["masked_best2"], key=lambda c: -c[0].shape[0]):
        for d in (a, b):  # the main path hands the kernel packed descriptors
            if d.dtype != torch.int32 or d.shape[-1] != 8 or not d.is_contiguous():
                raise AssertionError(f"matcher given {d.dtype} {tuple(d.shape)}, not packed int32 [.,8]")
        checks.append(("masked_best2", f"{a.shape[0]}x{b.shape[0]} geometric mask",
                       cuda_matching.fused_masked_best2, cuda_matching.fused_masked_best2_plain,
                       (a, b, m), matcher_bound(a, b, m), None))
        if gen is not None:  # plus one random mask at the first (largest) shape
            rand = torch.rand(m.shape, generator=gen, device=dev) > 0.7
            rand[::97] = False  # rows with no allowed column
            checks.append(("masked_best2", f"{a.shape[0]}x{b.shape[0]} random mask",
                           cuda_matching.fused_masked_best2, cuda_matching.fused_masked_best2_plain,
                           (a, b, rand), matcher_bound(a, b, rand), None))
            gen = None
    for n, m_, off in MATCH_EDGE_CASES:
        checks.append(("masked_best2", f"edge {n}x{m_} offset {off}", cuda_matching.fused_masked_best2,
                       cuda_matching.fused_masked_best2_plain, matcher_edge_inputs(n, m_, off, dev),
                       None, None))
    for h, w, wp, t_hi, t_lo in FAST_EDGE_CASES:
        flat_e, hs_e, ws_e = fast_edge_inputs(h, w, wp, dev)
        checks.append(("fast_nms", f"edge 8x{h}x{wp} th {t_hi:g}/{t_lo:g}", cuda_fast.fast_nms,
                       cuda_fast.fast_nms_plain, (flat_e, hs_e, ws_e, t_hi, t_lo), None, None))
    for case in GATHER_EDGE_CASES:
        checks.append(("gather_patches", "edge {}x{} K={} {}x{} corners {}/{}".format(*case),
                       cuda_gather.gather_patches, cuda_gather.gather_patches_plain,
                       gather_edge_inputs(*case, dev), None, None))

    counters = {"fast_nms": cuda_fast.fast_nms, "gather_patches": cuda_gather.gather_patches,
                "masked_best2": cuda_matching.fused_masked_best2}
    launch_floor = device_ms(_cuda.noop)
    log(f"phase 1: launch floor (an empty kernel, back to back) {launch_floor[0]:.4f} ms "
        f"({launch_floor[1]:.4f}-{launch_floor[2]:.4f})")
    per_kernel = {}
    for key, case, kern, plain, args_, bnd, library in checks:
        before = counters[key].launches
        out_k = kern(*args_)
        torch.cuda.synchronize()
        # one launch per call; a gather of no keypoints launches nothing
        want = 0 if key == "gather_patches" and args_[1].shape[0] == 0 else 1
        if counters[key].launches - before != want:
            raise AssertionError(f"{key} {case}: {counters[key].launches - before} launches, expected {want}")
        out_p = plain(*args_)
        torch.cuda.synchronize()
        for x, y in zip(*((o,) if isinstance(o, torch.Tensor) else o for o in (out_k, out_p))):
            if x.shape != y.shape or x.dtype != y.dtype:
                raise AssertionError(f"{key} {case}: kernel gives {x.dtype} {tuple(x.shape)}, "
                                     f"plain version {y.dtype} {tuple(y.shape)}")
        err = max_abs_err(out_k, out_p)
        if err != 0.0:
            raise AssertionError(f"{key} {case}: kernel differs from its plain version (max |err| {err})")
        if key == "fast_nms" and bnd is None and int((out_p[1] > 0).sum()) < 100:
            raise AssertionError(f"{key} {case}: too few corners to test anything")
        entry = per_kernel.setdefault(key, dict(max_abs_err=0.0, cases=[], edge_cases=0))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if bnd is None:
            entry["edge_cases"] += 1
            log(f"  {key} {case}: exact")
            continue
        # the call's device work is its one kernel, so `ms` times the call
        on_device = device_kernels(lambda: kern(*args_))
        if len(on_device) != 1:
            raise AssertionError(f"{key} {case}: one wrapper call put {len(on_device)} device "
                                 f"activities on the stream, expected its kernel alone: {on_device}")
        row = dict(case=case, device_kernel=on_device[0], device_kernels=len(on_device), **bnd)
        if base_lib is not None:  # in turns: baseline, current, current, baseline
            def base():
                with launching_from(base_lib):
                    return kern(*args_)

            if max_abs_err(base(), out_p) != 0.0:
                raise AssertionError(f"{key} {case}: baseline kernel differs from the plain version")
            b1, k1, k2, b2 = (device_ms(f) for f in (base, lambda: kern(*args_),
                                                    lambda: kern(*args_), base))
            row["ms"] = statistics.median([k1[0], k2[0]])
            row["ms_range"] = [min(k1[1], k2[1]), max(k1[2], k2[2])]
            row["baseline_ms"] = statistics.median([b1[0], b2[0]])
            row["baseline_ms_range"] = [min(b1[1], b2[1]), max(b1[2], b2[2])]
        else:
            k = device_ms(lambda: kern(*args_))
            row["ms"], row["ms_range"] = k[0], [k[1], k[2]]
        row["plain_ms"] = device_ms(lambda: plain(*args_))[0]
        row["library_ms"] = None
        if library is not None:
            lib_err = max_abs_err(library(), out_p)
            if lib_err != 0.0:
                raise AssertionError(f"{key} {case}: the library call differs from the plain version")
            row["library_ms"] = device_ms(library)[0]
        entry["cases"].append(row)
        base_txt = f", baseline {row['baseline_ms']:.4f} ms" if "baseline_ms" in row else ""
        lib_txt = f", library {row['library_ms']:.4f} ms" if row["library_ms"] is not None else ""
        log(f"  {key} {case}: exact; kernel {row['ms']:.4f} ms ({row['ms_range'][0]:.4f}-"
            f"{row['ms_range'][1]:.4f}){base_txt}, plain {row['plain_ms']:.4f} ms{lib_txt}, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; bytes {bnd['bytes_ms']:.4f}, "
            f"ops {bnd['ops_ms']:.4f}) "
            + " ".join(f"{k} {v}" for k, v in bnd.items() if k.endswith(("_px", "_pairs"))))
    log("phase 1: every kernel equals its plain version exactly, edge cases included")

    # ---- phase 2: the main path --------------------------------------------
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    frame0, ms, R0, t0_ = init_map(*frames[0], cam, Rs[0], ts[0])
    launches0 = {k: fn.launches for k, fn in counters.items()}  # frame 0's
    ms0_np = msx.map_state_to_numpy(ms)
    n_depth = int(((frame0.depth > 0) & frame0.valid).sum())
    log(f"phase 2: frame 0: {int(frame0.valid.sum())} valid features, {n_depth} stereo depths, "
        f"{int(ms.lm_valid.sum())} landmarks")
    state = (R0, t0_, eye, torch.zeros(3, device=dev), torch.tensor(False, device=dev))
    step_ms, wall_ms, results = [], [], []
    for i in range(1, N_FRAMES):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        s.record()
        if i == 2:  # count host syncs inside one step (there should be none)
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ms, frame, tr, R, t, vR, vt, ok = step(ms, *frames[i], state, cam)
            torch.cuda.set_sync_debug_mode("default")
            syncs = sorted({str(w.message).splitlines()[0] for w in caught})
            log(f"  frame 2: {len(caught)} synchronizing calls inside the step {syncs[:5]}")
        else:
            ms, frame, tr, R, t, vR, vt, ok = step(ms, *frames[i], state, cam)
        e.record()
        n_inl = int(tr.n_inliers)  # the step's one host read, and the barrier
        wall_ms.append((time.perf_counter() - w0) * 1e3)
        step_ms.append(s.elapsed_time(e))
        state = (R, t, vR, vt, torch.tensor(True, device=dev))
        centre = (-R.T @ t).cpu().numpy()
        err = float(np.linalg.norm(centre - ts[i]))
        results.append((i, n_inl, bool(ok), err))
        if i == 1:
            frame1_out = (R.cpu(), t.cpu(), n_inl, bool(ok))
        log(f"  frame {i:2d}: n_inliers {n_inl} ok {bool(ok)} centre err {err * 1e3:.2f} mm "
            f"step {step_ms[-1]:.2f} ms (wall {wall_ms[-1]:.2f} ms)")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches = {k: fn.launches for k, fn in counters.items()}
    # launches per tracked frame, as a float so that an uneven count shows
    per_frame = {k: (launches[k] - launches0[k]) / (N_FRAMES - 1) for k in launches}
    bad = [r for r in results
           if not (r[2] and r[1] >= MIN_TRACKED_INLIERS and r[3] <= MAX_CENTRE_ERR)]
    if bad:
        raise AssertionError(
            f"frames failing ok / n_inliers >= {MIN_TRACKED_INLIERS} / "
            f"centre err <= {MAX_CENTRE_ERR} m (frame, n, ok, err): {bad}")
    for k, n in LAUNCHES_PER_FRAME.items():
        if launches0[k] < 1 or per_frame[k] != n:
            raise AssertionError(
                f"{k}: {launches0[k]} launches for frame 0 and {per_frame[k]} per tracked frame "
                f"in the main path, expected >= 1 and {n}")
    log(f"phase 2: {N_FRAMES - 1} frames tracked; n_inliers {min(r[1] for r in results)}-"
        f"{max(r[1] for r in results)}; max centre err {max(r[3] for r in results) * 1e3:.2f} mm")
    log(f"phase 2: step median {statistics.median(step_ms[4:]):.2f} ms (CUDA events, frames 5-20), "
        f"wall median {statistics.median(wall_ms[4:]):.2f} ms; peak device memory {peak:.1f} MiB; "
        f"launches {launches} (frame 0 {launches0}, per tracked frame {per_frame})")

    # ---- phase 3: the card agrees with the CPU on frame 1 -----------------
    cpu = torch.device("cpu")
    ms_cpu = msx.map_state_from_numpy(ms0_np, cpu)
    il, ir = (f.cpu() for f in frames[1])
    state_cpu = (R0.cpu(), t0_.cpu(), torch.eye(3), torch.zeros(3), torch.tensor(False))
    t_cpu = time.time()
    _, _, tr_c, R_c, t_c, _, _, ok_c = step(ms_cpu, il, ir, state_cpu, cam)
    R_g, t_g, n_g, ok_g = frame1_out
    n_c = int(tr_c.n_inliers)
    d_rot = rotation_angle(R_c, R_g)
    d_t = float((t_c - t_g).abs().max())
    log(f"phase 3: CPU frame 1 in {time.time() - t_cpu:.1f} s: n_inliers card {n_g} cpu {n_c}, "
        f"rotation diff {d_rot:.2e} rad, translation diff {d_t:.2e} m")
    if not (d_rot <= ROT_TOL and d_t <= TRANS_TOL and abs(n_c - n_g) <= max(3, 0.02 * n_c)
            and bool(ok_c) == ok_g):
        raise AssertionError("card and CPU disagree on frame 1")

    # ---- phase 4: the SLAM loop at bench scale ----------------------------
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging, tracking
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as slam_mod

    cfg = loop_config()
    t_p4 = time.time()
    gt, loop_frames = render_loop_sequence(cfg, LOOP_FRAMES, dev)
    warm, _ = run_loop(cfg, loop_frames[:LOOP_WARMUP], dev)  # library handles, allocator, first BA
    warm.flush_decisions()
    del warm
    torch.cuda.synchronize()
    log(f"phase 4: rendered {LOOP_FRAMES} frames and warmed up on {LOOP_WARMUP} in {time.time() - t_p4:.1f} s")
    lat, syncs, after0 = [], {}, {}
    read_numpy = slam_mod._HostRead.numpy

    def unwatched_read(self):
        # the batched decision read is the loop's one planned wait: left out
        torch.cuda.set_sync_debug_mode("default")
        try:
            return read_numpy(self)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def timed(i, slam, call):
        head = slam._bg_queue[0][0] if slam._bg_queue else None
        t0 = time.perf_counter()
        if head in ("local_ba_chunk", "fuse") and head not in syncs:
            slam_mod._HostRead.numpy = unwatched_read
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                slam_mod._HostRead.numpy = read_numpy
            found = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
            syncs[head] = (i, len(found), sorted(set(found))[:5])
        else:
            call()
        slam.t_cw.cpu()  # block on the frame's pose, as bench.py's latency pass does
        lat.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            after0.update({k: fn.launches for k, fn in counters.items()})

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_pass = time.perf_counter()
    slam, kf_at = run_loop(cfg, loop_frames, dev, timed, timer=True)
    pass_s = time.perf_counter() - t_pass
    launches4 = {k: fn.launches for k, fn in counters.items()}
    peak4 = torch.cuda.max_memory_allocated() / 2**20
    n_tracked = LOOP_FRAMES - 1
    per_frame4 = {k: (launches4[k] - after0[k]) / n_tracked for k in launches4}
    _, centers, _ = slam.trajectory_arrays()
    ate_m = ate.ate_rmse(centers, gt[: len(centers)])
    lat_s = np.array(lat[5:])
    loop = dict(
        frames=len(slam.trajectory), state=slam.state, keyframes_inserted=slam.stats["kf_inserted"],
        keyframe_frames=kf_at, stats=slam.stats, landmarks=int(slam.ms.lm_valid.sum()),
        ate_m=ate_m, ref_ate_m=REF_ATE_M, frame_p50_ms=float(np.percentile(lat_s, 50)),
        frame_p99_ms=float(np.percentile(lat_s, 99)), frame_max_ms=float(lat_s.max()),
        frames_per_s=LOOP_FRAMES / pass_s, peak_mib=peak4, launches=launches4, launches_frame0=after0,
        launches_per_tracked_frame=per_frame4,
        syncs={k: {"frame": v[0], "count": v[1], "calls": v[2]} for k, v in syncs.items()},
    )
    # one slice of each kind, timed on the device from the final map with the
    # system's own arguments
    ms_f, kf_f, cap = slam.ms, slam.n_kf - 1, cfg.capacity
    slices = {
        "local_ba_chunk": lambda: tracking.local_ba_step(
            ms_f, kf_f, slam.cam_params, cfg.camera.bf, window=min(8, cap.max_local_kfs),
            lm_cap=cap.max_local_landmarks, iters=2),
        "fuse": lambda: map_merging.fuse_duplicate_landmarks(
            ms_f, ms_f.lm_valid & (ms_f.lm_first_kf == kf_f), radius=max(0.5 * slam.baseline, 0.02)),
        "cull_lm": lambda: tracking.cull_landmarks(ms_f),
    }
    loop["slice_device_ms"] = {k: profiled_device_ms(f) for k, f in slices.items()}
    # and one call of each behind a long sleep kernel: a call that waited on
    # the device anywhere (the sync debug mode misses some waits) returns
    # only after the sleep ends
    loop["slice_host_ms_behind_sleep"] = {k: host_ms_behind_sleep(f) for k, f in slices.items()}
    loop["host_stage_ms"] = {k: {"count": v["count"], "p50_ms": v["p50_ms"], "max_ms": v["max_ms"],
                                 "total_ms": v["total_ms"]} for k, v in slam.timer.summary().items()}
    log(f"phase 4 ({smi}): " + json.dumps(loop))
    log(f"phase 4: {LOOP_FRAMES} frames in {pass_s:.2f} s ({loop['frames_per_s']:.2f} frames/s), frame wall "
        f"p50 {loop['frame_p50_ms']:.2f} ms p99 {loop['frame_p99_ms']:.2f} ms; ATE {ate_m * 1e3:.3f} mm "
        f"(JAX reference {REF_ATE_M * 1e3:.3f} mm); {slam.stats['kf_inserted']} keyframes; slices "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in loop["slice_device_ms"].items())
        + f"; peak {peak4:.1f} MiB; phase 4 took {time.time() - t_p4:.1f} s")
    bad = []
    if slam.state != slam_mod.TrackingState.OK:
        bad.append(f"final state {slam.state}")
    if len(slam.trajectory) != LOOP_FRAMES:
        bad.append(f"{len(slam.trajectory)} frames recorded")
    if slam.stats["kf_inserted"] < MIN_LOOP_KF:
        bad.append(f"{slam.stats['kf_inserted']} keyframes inserted")
    for k, n in LAUNCHES_PER_FRAME.items():
        if after0.get(k, 0) < 1 or per_frame4[k] != n:
            bad.append(f"{k}: {after0.get(k)} launches at frame 0, {per_frame4[k]} per tracked frame")
    for slice_kind in ("local_ba_chunk", "fuse"):
        if slice_kind not in syncs or syncs[slice_kind][1] != 0:
            bad.append(f"{slice_kind}: synchronizing calls {syncs.get(slice_kind)}")
    for k, host_ms in loop["slice_host_ms_behind_sleep"].items():
        if host_ms >= 0.5 * SLEEP_MS:
            bad.append(f"{k}: returned after {host_ms:.1f} ms behind a {SLEEP_MS} ms sleep kernel")
    if not ate_m <= REF_ATE_M + ATE_MARGIN:
        bad.append(f"ATE {ate_m} m")
    if bad:
        raise AssertionError("phase 4: " + "; ".join(bad))

    # ---- phase 5: the card against the CPU for the loop ------------------
    t_p5 = time.time()
    small = loop_config(small=True)
    _, frames5 = render_loop_sequence(small, SMALL_LOOP_FRAMES, cpu)
    card, kf_card = run_loop(small, [(a.to(dev), b.to(dev)) for a, b in frames5], dev)
    host, kf_host = run_loop(small, frames5, cpu)
    d_c, d_r = trajectory_diff(card.trajectory_arrays(), host.trajectory_arrays())
    log(f"phase 5: keyframes at {kf_card} (card) {kf_host} (cpu), stats {card.stats} / {host.stats}; "
        f"centre diff max {d_c.max():.2e} m, rotation diff max {d_r.max():.2e} rad; per frame mm "
        f"{np.round(d_c * 1e3, 3).tolist()}; {time.time() - t_p5:.1f} s")
    if kf_card != kf_host or not (d_c.max() <= TRANS_TOL and d_r.max() <= ROT_TOL):
        raise AssertionError("phase 5: card and CPU disagree on the loop")

    sources = {
        "fast_nms": ("csrc/fast_nms.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_fast.py:149"),
        "gather_patches": ("csrc/gather_patches.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_gather.py:91"),
        "masked_best2": ("csrc/masked_best2.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_matching.py:123"),
    }
    kernels = []
    for k, (src, rep) in sources.items():
        info = per_kernel[k]
        main_case = info["cases"][0]  # the first timed case is the main path's shape
        kernels.append({
            "name": k, "route": "cuda",
            "source": "orb_slam3_detailed_comments_kor_tpu_torch/" + src, "replaces": rep,
            "launches": launches[k], "launches_per_frame": int(per_frame[k]),  # checked whole
            "launches_slam_loop": launches4[k], "launches_per_frame_slam_loop": int(per_frame4[k]),
            "max_abs_err": info["max_abs_err"], "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
            "device_kernels_per_call": max(c["device_kernels"] for c in info["cases"]),
            "edge_cases": info["edge_cases"], "cases": info["cases"],
        })
    print(json.dumps({"kernels": kernels, "launch_floor_ms": launch_floor[0]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
