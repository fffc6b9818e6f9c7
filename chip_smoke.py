"""Smoke test of the PyTorch/CUDA port on one GPU: kernels, then the main path.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phase 0  builds the CUDA kernels from ``orb_slam3_detailed_comments_kor_tpu_torch/csrc``
         and prints the card's name and power limit.
Phase 1  runs one tracked frame at bench scale (480x752, 1200 features,
         16384 landmarks) while recording the inputs each kernel wrapper
         receives, then holds every kernel against its plain PyTorch version
         on those inputs (exact equality) and times both with CUDA events.
Phase 2  the main path: renders 21 strafe frames on the card, initialises the
         map from frame 0 (process_stereo + make_keyframe) and tracks frames
         1-20 with full_frame_step. Every frame must be ok with >= 300
         inliers and a camera-centre error <= 3 cm, and each kernel's launch
         counter must have risen during the phase.
Phase 3  tracks frame 1 again on the CPU (plain versions) from the same map
         and checks that the card and the CPU agree.

The last stdout line is {"ok": true, "device": {...}}; the line before it
lists every kernel with its launches, error and times. Any failure raises,
so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, runs=TIMING_RUNS, warmup=3):
    """Median milliseconds of ``fn()`` over ``runs`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_abs_err(a, b):
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
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")

    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import (
        _cuda, cuda_fast, cuda_gather, cuda_matching,
    )
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend, map_state as msx, tracking

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

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
            if "Used" in line or "Compiling entry" in line:
                log("  ptxas:", line.strip())

    # ---- scene, trajectory, camera ---------------------------------------
    cam = torch.tensor([FX, FX, W / 2.0, H / 2.0], dtype=torch.float32, device=dev)
    bf = BASELINE * FX
    scene = synthetic.default_scene(dev)
    Rs, ts = synthetic.make_trajectory(N_FRAMES, "strafe", speed=SPEED)
    frames = []
    for i in range(N_FRAMES):
        R_wc = torch.from_numpy(Rs[i]).to(dev)
        t_wc = torch.from_numpy(ts[i]).to(dev)
        il, ir, _ = synthetic.stereo_pair(cam, R_wc, t_wc, BASELINE, scene, h=H, w=W)
        frames.append((il, ir))
    torch.cuda.synchronize()

    def init_map(il, ir):
        frame0 = frontend.process_stereo(il, ir, bf, n_features=N_FEATURES, cell=CELL)
        ms = msx.empty_map(MAX_KF, frame0.n, MAX_LM, device=il.device)
        R0 = torch.from_numpy(Rs[0].T.copy()).to(il.device)
        t0_ = -R0 @ torch.from_numpy(ts[0]).to(il.device)
        ms = tracking.make_keyframe(
            ms, frame0, R0, t0_, 0.0, 0, torch.full((ms.L,), -1, dtype=torch.int32, device=il.device),
            cam.to(il.device), float("inf"),
        )
        return frame0, ms, R0, t0_

    def step(ms, il, ir, state):
        return tracking.full_frame_step(
            ms, il, ir, *state, cam.to(il.device), bf, W, H,
            n_features=N_FEATURES, cell=CELL, min_inliers=MIN_INLIERS,
        )

    # ---- phase 1: kernels vs plain at the main path's inputs -------------
    _, ms_p1, R0, t0_ = init_map(*frames[0])
    eye = torch.eye(3, device=dev)
    state1 = (R0, t0_, eye, torch.zeros(3, device=dev), torch.tensor(False, device=dev))
    calls = {"fast": [], "gather": [], "match": []}
    wrapped = (
        (cuda_fast, "fast_nms", "fast"),
        (cuda_gather, "gather_patches", "gather"),
        (cuda_matching, "fused_masked_best2", "match"),
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
        step(ms_p1, *frames[1], state1)
        torch.cuda.synchronize()
    finally:
        for mod, name, key in wrapped:
            setattr(mod, name, originals[key])
    log(f"phase 1: recorded {len(calls['fast'])} fast, {len(calls['gather'])} gather, "
        f"{len(calls['match'])} matcher calls of one tracked frame")

    checks = []  # (name, kernel fn, plain fn, args)
    (flat, hs, ws, th_hi, th_lo), = calls["fast"]
    checks.append(("fast_nms " + "x".join(map(str, flat.shape)), cuda_fast.fast_nms,
                   cuda_fast.fast_nms_plain, (flat, hs, ws, th_hi, th_lo)))
    for img2d, rows, cols, ph, pw in calls["gather"]:
        # the wrapper clamps corners; hand both versions the clamped ones
        rows = torch.clamp(rows, 0, img2d.shape[0] - ph).to(torch.int32)
        cols = torch.clamp(cols, 0, img2d.shape[1] - pw).to(torch.int32)
        checks.append((f"gather_patches {tuple(img2d.shape)} K={rows.shape[0]} {ph}x{pw}",
                       cuda_gather.gather_patches, cuda_gather.gather_patches_plain,
                       (img2d, rows, cols, ph, pw)))
    gen = torch.Generator(device=dev).manual_seed(0)
    # tracking's [4096 x 1200] calls first: they are the main path's shape
    for a, b, m in sorted(calls["match"], key=lambda c: -c[0].shape[0]):
        checks.append((f"masked_best2 {a.shape[0]}x{b.shape[0]} geometric mask",
                       cuda_matching.fused_masked_best2,
                       cuda_matching.fused_masked_best2_plain, (a, b, m)))
        if gen is not None:  # plus one random mask at the first (largest) shape
            rand = torch.rand(m.shape, generator=gen, device=dev) > 0.7
            rand[::97] = False  # rows with no allowed column
            checks.append((f"masked_best2 {a.shape[0]}x{b.shape[0]} random mask",
                           cuda_matching.fused_masked_best2,
                           cuda_matching.fused_masked_best2_plain, (a, b, rand)))
            gen = None

    per_kernel = {}
    for name, kern, plain, args in checks:
        out_k = kern(*args)
        torch.cuda.synchronize()
        out_p = plain(*args)
        torch.cuda.synchronize()
        err = max_abs_err(out_k, out_p)
        if err != 0.0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
        ms_k = cuda_ms(lambda: kern(*args))
        ms_p = cuda_ms(lambda: plain(*args))
        log(f"  {name}: exact; kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms (median of {TIMING_RUNS})")
        key = name.split()[0]
        if key not in per_kernel:  # the first check of each kernel is its main-path shape
            per_kernel[key] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p)
        else:
            per_kernel[key]["max_abs_err"] = max(per_kernel[key]["max_abs_err"], err)
    log("phase 1: every kernel equals its plain version exactly")

    # ---- phase 2: the main path --------------------------------------------
    for fn in (cuda_fast.fast_nms, cuda_gather.gather_patches, cuda_matching.fused_masked_best2):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    frame0, ms, R0, t0_ = init_map(*frames[0])
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
                ms, frame, tr, R, t, vR, vt, ok = step(ms, *frames[i], state)
            torch.cuda.set_sync_debug_mode("default")
            syncs = sorted({str(w.message).splitlines()[0] for w in caught})
            log(f"  frame 2: {len(caught)} synchronizing calls inside the step {syncs[:5]}")
        else:
            ms, frame, tr, R, t, vR, vt, ok = step(ms, *frames[i], state)
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
    launches = {
        "fast_nms": cuda_fast.fast_nms.launches,
        "gather_patches": cuda_gather.gather_patches.launches,
        "masked_best2": cuda_matching.fused_masked_best2.launches,
    }
    bad = [r for r in results
           if not (r[2] and r[1] >= MIN_TRACKED_INLIERS and r[3] <= MAX_CENTRE_ERR)]
    if bad:
        raise AssertionError(
            f"frames failing ok / n_inliers >= {MIN_TRACKED_INLIERS} / "
            f"centre err <= {MAX_CENTRE_ERR} m (frame, n, ok, err): {bad}")
    need = {"fast_nms": N_FRAMES - 1, "gather_patches": 2 * (N_FRAMES - 1),
            "masked_best2": 3 * (N_FRAMES - 1)}
    for k, v in need.items():
        if launches[k] < v:
            raise AssertionError(f"{k}: {launches[k]} launches in the main path, expected >= {v}")
    log(f"phase 2: {N_FRAMES - 1} frames tracked; n_inliers {min(r[1] for r in results)}-"
        f"{max(r[1] for r in results)}; max centre err {max(r[3] for r in results) * 1e3:.2f} mm")
    log(f"phase 2: step median {statistics.median(step_ms[4:]):.2f} ms (CUDA events, frames 5-20), "
        f"wall median {statistics.median(wall_ms[4:]):.2f} ms; peak device memory {peak:.1f} MiB; "
        f"launches {launches}")

    # ---- phase 3: the card agrees with the CPU on frame 1 -----------------
    cpu = torch.device("cpu")
    ms_cpu = msx.map_state_from_numpy(ms0_np, cpu)
    il, ir = (f.cpu() for f in frames[1])
    state_cpu = (R0.cpu(), t0_.cpu(), torch.eye(3), torch.zeros(3), torch.tensor(False))
    t_cpu = time.time()
    _, _, tr_c, R_c, t_c, _, _, ok_c = step(ms_cpu, il, ir, state_cpu)
    R_g, t_g, n_g, ok_g = frame1_out
    n_c = int(tr_c.n_inliers)
    d_rot = rotation_angle(R_c, R_g)
    d_t = float((t_c - t_g).abs().max())
    log(f"phase 3: CPU frame 1 in {time.time() - t_cpu:.1f} s: n_inliers card {n_g} cpu {n_c}, "
        f"rotation diff {d_rot:.2e} rad, translation diff {d_t:.2e} m")
    if not (d_rot <= ROT_TOL and d_t <= TRANS_TOL and abs(n_c - n_g) <= max(3, 0.02 * n_c)
            and bool(ok_c) == ok_g):
        raise AssertionError("card and CPU disagree on frame 1")

    sources = {
        "fast_nms": ("csrc/fast_nms.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_fast.py:149"),
        "gather_patches": ("csrc/gather_patches.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_gather.py:91"),
        "masked_best2": ("csrc/masked_best2.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_matching.py:123"),
    }
    kernels = [
        {"name": k, "route": "cuda",
         "source": "orb_slam3_detailed_comments_kor_tpu_torch/" + src, "replaces": rep,
         "launches": launches[k], **per_kernel[k]}
        for k, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
