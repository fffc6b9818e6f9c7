"""Profile the PyTorch port's stereo frame step on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_step_profile.py [--frames 12] [--profiled 4] [--out FILE]
    python3 tools/torch_step_profile.py --loop [--frames 60] [--out FILE]

Renders chip_smoke.py's bench-scale strafe sequence on the card (480x752,
1200 features, 16384 landmarks), initialises the map from frame 0, and tracks
frames 1..F with ``tracking.full_frame_step``, all through chip_smoke.py's own
``render_sequence``, ``init_map`` and ``step``, so the profile is of the step
that the smoke test checks. Frames 1..F-P give the step's
synced wall time (the caller's one read of ``n_inliers`` is the barrier);
the last P frames run under ``torch.profiler`` (CPU and CUDA activity) and
give, per step: device kernels, device activities of any kind, runtime
launch calls (``cudaLaunchKernel``) and device busy time (the sum of the
device activities' durations, on one stream). The device's idle share is
that busy time against the unprofiled step time, since the profiler slows
the host several times over. Prints one JSON line; ``--out`` also writes it, with the device kernels per
step by name and the host ops with the most self time, to FILE.

With ``--loop`` it profiles the SLAM loop instead: chip_smoke.py's
bench-scale ``SlamSystem`` (``loop_config``, loop closing off, as in
phase 4) over the first F frames of the strafe sequence, blocking on each
frame's pose. After a warm-up of 20
frames, the first frame whose dispatch services each kind of background
slice (``local_ba_chunk``, ``fuse``, ``cull_lm``, ``loop``, or none) runs
under the profiler; the others give each kind's unprofiled wall time.
Then one call of each slice (local BA, fusion, landmark culling) runs
alone under the profiler on the final map.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=12, help="tracked frames in all (F)")
    parser.add_argument("--profiled", type=int, default=4, help="last frames profiled (P)")
    parser.add_argument("--out", default=None, help="also write the result, with kernels by name, here")
    parser.add_argument("--loop", action="store_true", help="profile SlamSystem frames by background slice")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: CUDA is not available")
    if not 0 < args.profiled < args.frames:
        sys.exit("torch_step_profile: need 0 < --profiled < --frames")

    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile


    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.loop:
        return profile_loop(args, cs, dev, smi)
    n = args.frames + 1
    cam = cs.camera(dev)
    Rs, ts, frames = cs.render_sequence(n, cam)
    _, ms, R, t = cs.init_map(*frames[0], cam, Rs[0], ts[0])
    state = (R, t, torch.eye(3, device=dev), torch.zeros(3, device=dev), torch.tensor(False, device=dev))

    def step(i):
        nonlocal ms, state
        ms, _, tr, R, t, vR, vt, _ = cs.step(ms, *frames[i], state, cam)
        state = (R, t, vR, vt, torch.tensor(True, device=dev))
        return int(tr.n_inliers)  # the step's one host read, and the barrier

    torch.cuda.synchronize()
    wall, inliers = [], []
    first_profiled = args.frames - args.profiled + 1
    for i in range(1, first_profiled):
        w0 = time.perf_counter()
        inliers.append(step(i))
        wall.append((time.perf_counter() - w0) * 1e3)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(first_profiled, n):
            inliers.append(step(i))
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - w0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    P = args.profiled
    by_name = collections.Counter(e.name for e in kernels)
    # the first steps warm up: the median of the unprofiled ones after frame 2
    step_ms = statistics.median(wall[2:] if len(wall) > 4 else wall)
    result = {
        "device": torch.cuda.get_device_name(0), "smi": smi,
        "frames": args.frames, "profiled": P, "n_inliers": [min(inliers), max(inliers)],
        "step_wall_ms_median": step_ms, "step_wall_ms": wall,
        # the profiler slows the host several times over: this is not a step time
        "profiled_step_wall_ms": window_ms / P,
        "device_kernels_per_step": len(kernels) / P,
        "device_activities_per_step": len(device) / P,
        "cuda_launch_kernel_per_step": sum(e.name == "cudaLaunchKernel" for e in events) / P,
        "device_busy_ms_per_step": busy_ms / P,
        # device idle share of an unprofiled step
        "idle_share": 1.0 - busy_ms / P / step_ms,
    }
    print(json.dumps(result), flush=True)
    if args.out:
        result["kernels_per_step_by_name"] = {k: v / P for k, v in by_name.most_common()}
        host = sorted((a for a in prof.key_averages() if a.device_type == DeviceType.CPU),
                      key=lambda a: -a.self_cpu_time_total)
        # host ops by self time, profiled (so slowed), per step: [calls, self ms]
        result["host_ops_per_step"] = {a.key: [a.count / P, a.self_cpu_time_total / 1e3 / P]
                                       for a in host[:60]}
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


def device_summary(prof, n=1):
    """Per profiled frame: device kernels, device activities, runtime launch
    calls and device busy ms (the sum of the activities' durations)."""
    from torch.autograd import DeviceType

    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    by_time = collections.Counter()
    for e in device:
        by_time[e.name] += e.time_range.elapsed_us()
    return {
        "device_kernels": len(kernels) / n,
        "device_activities": len(device) / n,
        "cuda_launch_kernel": sum(e.name == "cudaLaunchKernel" for e in events) / n,
        "device_busy_ms": sum(e.time_range.elapsed_us() for e in device) / 1e3 / n,
        "kernels_by_name": {k: v / n for k, v in collections.Counter(e.name for e in kernels).most_common(25)},
        "device_ms_by_name": {k: v / 1e3 / n for k, v in by_time.most_common(25)},
    }


def profile_slices(slam, cfg):
    """One call of each mapping slice on the loop's final map, alone under
    the profiler (after a warm call): device busy ms and kernels."""
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging, tracking

    ms, kf, cap = slam.ms, slam.n_kf - 1, cfg.capacity
    slices = {
        "local_ba_chunk": lambda: tracking.local_ba_step(
            ms, kf, slam.cam_params, cfg.camera.bf, window=min(8, cap.max_local_kfs),
            lm_cap=cap.max_local_landmarks, iters=2),
        "fuse": lambda: map_merging.fuse_duplicate_landmarks(
            ms, ms.lm_valid & (ms.lm_first_kf == kf), radius=max(0.5 * slam.baseline, 0.02)),
        "cull_lm": lambda: tracking.cull_landmarks(ms),
    }
    out = {}
    for kind, fn in slices.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out[kind] = device_summary(prof)
    return out


def profile_loop(args, cs, dev, smi) -> int:
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem

    warm = 20
    if args.frames <= warm:
        sys.exit("torch_step_profile: --loop needs more than 20 --frames")
    cfg = cs.loop_config()
    _, frames = cs.render_loop_sequence(cfg, args.frames, dev)
    slam = SlamSystem(cfg, device=dev)
    slam.enable_loop_closing = False  # the strafe loop of chip_smoke.py phase 4
    walls, profiled = collections.defaultdict(list), {}
    torch.cuda.synchronize()
    for i, (il, ir) in enumerate(frames):
        kind = slam._bg_queue[0][0] if slam._bg_queue else "none"
        if i >= warm and kind not in profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                slam.track_stereo(il, ir, i / cs.FPS)
                slam.t_cw.cpu()
            profiled[kind] = dict(frame=i, **device_summary(prof))
            continue
        w0 = time.perf_counter()
        slam.track_stereo(il, ir, i / cs.FPS)
        slam.t_cw.cpu()  # block on the frame's pose
        if i >= warm:
            walls[kind].append((time.perf_counter() - w0) * 1e3)
    result = {"device": torch.cuda.get_device_name(0), "smi": smi, "frames": args.frames, "kinds": {},
              "slices_on_final_map": profile_slices(slam, cfg)}
    for kind, prof_row in profiled.items():
        wall = statistics.median(walls[kind]) if walls[kind] else None
        prof_row.update(frames_unprofiled=len(walls[kind]), wall_ms_median=wall,
                        idle_share=None if wall is None else 1.0 - prof_row["device_busy_ms"] / wall)
        result["kinds"][kind] = prof_row
    brief = lambda rows: {k: {kk: vv for kk, vv in v.items() if not kk.endswith("_by_name")}
                          for k, v in rows.items()}
    text = json.dumps(result | {"kinds": brief(result["kinds"]),
                                "slices_on_final_map": brief(result["slices_on_final_map"])})
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
