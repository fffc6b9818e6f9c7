"""One run of one benchmark cell: set-up, the measured window, the traced
sub-window, the correctness check and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment's settings, as run;
- ``traffic/<mix>.json``: the mix's parameters, with the generator module
  (``generators/<generator>.py``) that reads them;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: one reader per metric.

``run_cell`` takes a ``device``; the command line (``run.py``) always asks
for the card and fails without one.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from slam_bench.reference import check, devtrace
from slam_bench.reference import orb as orb_ref

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "orb_slam3_detailed_comments_kor_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a short sequence, ...)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload named {name!r} in BENCHMARK.json")


def config_file(name: str) -> str:
    return os.path.join(HERE, "configs", f"{name}.json")


def traffic_file(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def limits_file(cell: str) -> str:
    return os.path.join(HERE, "limits", f"{cell}.json")


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str):
    return importlib.import_module(f"slam_bench.generators.{name}")


def metrics_for(bench: dict, cell: str, group: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that cover ``cell``."""
    return [m for m in bench[group] if "workloads" not in m or cell in m["workloads"]]


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


@dataclass
class RunRecord:
    """What a metric reader may read."""

    config: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    window_frames: int = 0
    latencies_ms: Optional[List[float]] = None
    spans: Dict[str, List[float]] = field(default_factory=dict)
    trace_events: Optional[list] = None
    trace_wall_s: float = 0.0
    trace_frames: int = 0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def require_card(chips: int) -> None:
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} visible")


def sequence_length(traffic: dict, seconds: float, inertial: bool) -> int:
    """Set-up frames (an inertial system's set-up runs on to its IMU
    initialisation, at most ``max_frames``), the window's frames and the
    traced sub-window's."""
    su = traffic["setup"]
    return (int(su["max_frames"] if inertial else su["frames"]) + int(traffic["frames_per_window_second"] * seconds)
            + int(traffic["trace"]["frames"]))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda", t_process: Optional[float] = None,
             control: bool = False, log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True),
             config: Optional[dict] = None, traffic: Optional[dict] = None, limits: Optional[dict] = None) -> dict:
    """One run; returns the result line's object. ``config``, ``traffic``
    and ``limits`` default to the cell's files (tests pass small ones)."""
    from slam_bench import sut

    t_start = time.perf_counter() if t_process is None else t_process
    bench = benchmark()
    spec = cell_spec(bench, cell)
    dev = torch.device(device)
    if dev.type == "cuda":
        require_card(int(spec["chips"]))
        dev = torch.device("cuda", dev.index or 0)
    cfg = config or load_json(config_file(spec["config"]))
    mix = traffic or load_json(traffic_file(spec["traffic"]))
    lim = limits if limits is not None else load_json(limits_file(cell))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        sut.build_kernels()

    # ---- set-up: the sequence, the system, the set-up frames -------------
    n_total = sequence_length(mix, seconds, cfg["sensor"] == "stereo_inertial")
    t_r = time.perf_counter()
    seq = generator(mix["generator"]).generate(cfg, mix, seed, n_total, dev)
    log(f"sequence: {n_total} frames from trajectory time {seq.start_s:.3f} s, rendered in "
        f"{time.perf_counter() - t_r:.3f} s")
    if dev.type == "cuda":
        # the peak is the system's: the renderer's batches are freed here
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    system = sut.System(cfg, dev, timer_enabled=trace)
    blocking = mix["feed"] == "blocking"
    su = mix["setup"]
    i = 0
    ready_at = None
    while True:
        if i >= su["max_frames"]:
            raise BenchError(f"set-up did not finish in {su['max_frames']} frames")
        system.feed(seq, i)
        if blocking:
            system.read_pose()
        i += 1
        if system.inertial and ready_at is None and system.inertial_ready():
            ready_at = i
        done = i >= su["frames"]
        if system.inertial:
            done = done and ready_at is not None and i >= ready_at + su["frames_after_imu_init"]
        if done:
            break
    system.read_pose()
    sync(dev)
    setup_s = time.perf_counter() - t_start
    log(f"set-up: {i} frames, {system.n_keyframes()} keyframes, {setup_s:.3f} s"
        + (f", IMU ready after frame {ready_at}" if system.inertial else ""))

    # ---- the measured window ----------------------------------------------
    w0 = i
    last = n_total - int(mix["trace"]["frames"])
    system.timer.reset()
    lat: List[float] = []
    failed = 0
    t_w0 = time.perf_counter()
    while time.perf_counter() - t_w0 < seconds:
        if i >= last:
            raise BenchError(f"the window ran out of frames after {i - w0}: the cell needs a longer sequence "
                             f"(frames_per_window_second of traffic {spec['traffic']!r})")
        t_f = time.perf_counter()
        state = system.feed(seq, i)
        if blocking:
            system.read_pose()
            lat.append((time.perf_counter() - t_f) * 1e3)
        failed += int(state != system.OK)
        i += 1
    system.read_pose()
    sync(dev)
    window_s = time.perf_counter() - t_w0
    attempted = i - w0
    spans = {k: list(v) for k, v in system.timer.samples.items()}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    rec = RunRecord(config=cfg, setup_s=setup_s, window_s=window_s, window_frames=attempted,
                    latencies_ms=lat if blocking else None, spans=spans)
    log(f"window: {attempted} frames in {window_s:.3f} s, {failed} not OK")

    # ---- traced sub-window (after the measured one) ------------------------
    breakdown = None
    busy_s = None
    if trace and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        n_tr = int(mix["trace"]["frames"])
        system.timer.reset()
        sync(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            clocks = (time.perf_counter_ns(), time.time_ns())
            t_t0 = time.perf_counter()
            for _ in range(n_tr):
                system.feed(seq, i)
                if blocking:
                    system.read_pose()
                i += 1
            system.read_pose()
            sync(dev)
            t_t1 = time.perf_counter()
        events = devtrace.device_events(prof)
        rec.trace_events, rec.trace_wall_s, rec.trace_frames = events, t_t1 - t_t0, n_tr
        busy_s = devtrace.busy_us(events) / 1e6
        breakdown = trace_breakdown(events, system.timer.intervals, clocks)

    # ---- correctness, after the window and with the program's state freed
    t_c0 = time.perf_counter()
    system.flush()
    out = system.outputs(float(seq.times[w0]))
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, controls = compare(cfg, seq, out, w0, attempted, dev, control, seed)
    ok, checks = check.verdict(readings, lim)
    log(f"check: {time.perf_counter() - t_c0:.3f} s")

    # ---- metrics -------------------------------------------------------------
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, cell, group):
        v = metric_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
              "device": device_record(dev, int(spec["chips"]), peak)}
    if trace:
        result["device"]["busy_s"] = busy_s
        result["device"]["window_s"] = rec.trace_wall_s
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["end_to_end_traced"] = {m["name"]: metric_reader(m["name"]).read(rec)
                                       for m in metrics_for(bench, cell, "end_to_end")}
    if control:
        result["readings"], result["control"] = readings, controls
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return result


def device_record(dev, count: int, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
            "memory_peak_bytes": peak}


def trace_breakdown(events, intervals, clocks, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host span open at the gap's middle. The
    spans are on ``perf_counter_ns``; ``clocks`` = (perf_counter_ns,
    time_ns) read together at the trace's start puts them on the
    profiler's clock, whichever of the two it keeps (the one whose reading
    lies nearer the first device event)."""
    by_name = sorted(devtrace.time_by_name(events).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(devtrace.idle_gaps(events), key=lambda g: -g[1])[:top]
    first_ns = min((s for s, _, _ in events), default=0.0) * 1e3
    shift = min((0, clocks[1] - clocks[0]), key=lambda d: abs(first_ns - (clocks[0] + d)))
    named = []
    for start_us, len_us in gaps:
        mid_ns = (start_us + len_us / 2.0) * 1e3 - shift
        inner = [(b - a, n) for a, b, n in intervals if a <= mid_ns <= b]
        named.append([min(inner)[1] if inner else "between spans", len_us / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in by_name], "idle_gaps": named}


# --------------------------------------------------------------------------
# The comparison with the plain reference
# --------------------------------------------------------------------------
def compare(cfg: dict, seq, out: dict, w0: int, n_window: int, device, control: bool, seed: int = 0):
    """(readings, control readings) of the numbers the check compares."""
    cam = cfg["camera"]
    bf = float(cam["bf"])
    fps = seq.fps
    readings: Dict[str, Optional[float]] = {}
    controls: Dict[str, Optional[float]] = {}

    # poses of every window frame against the ground truth
    idx = np.arange(w0, w0 + n_window)
    traj_frame = np.round(out["traj_t"] * fps).astype(np.int64)
    pos = {f: k for k, f in enumerate(traj_frame)}
    have = [f for f in idx if f in pos]
    kf_frames = np.round(out["kf_time"].astype(np.float64) * fps).astype(np.int64)
    if len(have) == n_window and n_window >= 3:
        est = out["traj_centres"][[pos[f] for f in have]]
        readings["ate_mm"] = check.ate_mm(est, seq.t_wc[have])
        # control: each frame answered with its latest keyframe's true pose
        held = check.keyframe_held(idx, kf_frames, w0)
        controls["ate_mm"] = check.ate_mm(seq.t_wc[held], seq.t_wc[idx])
    else:
        readings["ate_mm"] = None

    # keyframes of the window: keypoints, descriptors, stereo depths, map
    keep = (kf_frames >= w0) & (kf_frames < seq.n)
    orb = cfg["orb"]
    scale = float(orb["scale_factor"])
    rng = np.random.default_rng(seed & ((1 << 64) - 1))
    lvls, kp_bad, bits = [], [], []
    lvls_ctl, kp_bad_ctl, bits_ctl = [], [], []
    depth_err, depth_ctl, rep, rep_ctl = [], [], [], []
    lm_row = {int(l): r for r, l in enumerate(out["lm_ids"])}
    for k in np.nonzero(keep)[0]:
        f = int(kf_frames[k])
        valid = out["kf_feat_valid"][k]
        xy = out["kf_xy"][k][valid].astype(np.float64)
        ur = out["kf_ur"][k][valid].astype(np.float64)
        lvl = out["kf_level"][k][valid].astype(np.int64)
        levels = check.reference_pyramid(seq.images[f, 0], orb, device)
        maps = orb_ref.keypoint_maps(levels, float(orb["ini_th_fast"]), float(orb["min_th_fast"]))
        lvls.append(lvl)
        kp_bad.append(check.keypoint_faults(maps, xy, lvl, scale))
        bits.append(check.hamming(out["kf_desc"][k][valid], check.reference_descriptors(levels, xy, lvl, orb)))
        z_gt = check.ray_depths(cam, seq.R_wc[f], seq.t_wc[f], xy, device)
        depth_err.append(check.depth_rel_errors(xy[:, 0], ur, bf, z_gt))
        if control:
            # keypoints without the suppression; descriptors in float8
            xy_c, lvl_c = check.unsuppressed_keypoints(maps, dict(zip(*np.unique(lvl, return_counts=True))),
                                                       scale, rng)
            lvls_ctl.append(lvl_c)
            kp_bad_ctl.append(check.keypoint_faults(maps, xy_c, lvl_c, scale))
            ref = check.reference_descriptors(levels, xy, lvl, orb)
            low = check.reference_descriptors(levels, xy, lvl, orb, values_dtype=torch.float8_e4m3fn)
            bits_ctl.append(check.hamming(low, ref))
            depth_ctl.append(check.depth_rel_errors(xy[:, 0], check.integer_disparity_ur(xy[:, 0], bf, z_gt),
                                                    bf, z_gt))
        del levels, maps
        # the map: landmarks observed by this keyframe, by its pose
        obs = out["obs_lm"][k][valid]
        has = np.array([o >= 0 and o in lm_row and out["lm_valid"][lm_row[o]] for o in obs], bool)
        if not has.any():
            continue
        X = out["lm_pos"][[lm_row[o] for o in obs[has]]].astype(np.float64)
        m = int(has.sum())
        R_cw = out["kf_R_cw"][k].astype(np.float64)
        t_cw = out["kf_t_cw"][k].astype(np.float64)
        rep.append(check.reprojection_residuals(cam, bf, np.broadcast_to(R_cw, (m, 3, 3)),
                                                np.broadcast_to(t_cw, (m, 3)), X, xy[has], ur[has]))
        # control: the reference map (scene points at these pixels from
        # the true pose) with the keyframe left at its predecessor's pose
        zg = z_gt[has]
        okz = zg > 0
        prev = int(check.keyframe_held(np.array([f - 1]), kf_frames, w0)[0])
        if control and okz.any() and prev < f:
            Rt = np.broadcast_to(seq.R_wc[f], (m, 3, 3)).astype(np.float64)
            Xg = check.reference_points(cam, Rt, np.broadcast_to(seq.t_wc[f], (m, 3)).astype(np.float64),
                                        xy[has], np.where(okz, zg, 1.0))
            Rp = seq.R_wc[prev].astype(np.float64)
            tp = seq.t_wc[prev].astype(np.float64)
            ur_g = np.where(ur[has] >= 0, xy[has, 0] - bf / np.where(okz, zg, 1.0), -1.0)
            rep_ctl.append(check.reprojection_residuals(cam, bf, np.broadcast_to(Rp.T, (m, 3, 3)),
                                                        np.broadcast_to(-Rp.T @ tp, (m, 3)), Xg, xy[has], ur_g,
                                                        half_pixel=0.5)[okz])
    cat = lambda parts: np.concatenate(parts) if parts and sum(map(len, parts)) else np.zeros(0)
    med = lambda parts: float(np.median(cat(parts))) if len(cat(parts)) else None
    pct = lambda x: None if x is None else 100.0 * x
    readings["kp_bad_pct"] = pct(check.worst_level(cat(kp_bad).astype(np.float64), cat(lvls), np.mean))
    readings["desc_bits"] = check.worst_level(cat(bits).astype(np.float64), cat(lvls), np.median)
    if control:
        controls["kp_bad_pct"] = pct(check.worst_level(cat(kp_bad_ctl).astype(np.float64), cat(lvls_ctl), np.mean))
        controls["desc_bits"] = check.worst_level(cat(bits_ctl).astype(np.float64), cat(lvls), np.median)
    readings["depth_err_pct"] = pct(med(depth_err))
    controls["depth_err_pct"] = pct(med(depth_ctl))
    readings["reproj_px"] = med(rep)
    controls["reproj_px"] = med(rep_ctl)

    readings["ba_gap_pct"], controls["ba_gap_pct"] = compare_bundle_adjustment(cfg, seq, out, w0, control)

    if "pre_valid" in out:
        readings["preint_rel_err"], controls["preint_rel_err"] = compare_preintegration(
            seq, out, kf_frames, keep, control)
    readings["keyframes_checked"] = float(keep.sum())
    return readings, controls


def compare_bundle_adjustment(cfg: dict, seq, out: dict, w0: int, control: bool):
    """The median over the landmarks that the window's keyframes observe
    (and at least two keyframes of the map) of their distance from the
    bundle-adjustment optimum of all their observations with the map's
    keyframe poses held (``check.ba_gaps``), in per cent of depth; and the
    control's: the reference map in the program's place, every landmark
    where its first stereo observation puts it from its keyframe's true
    pose (bundle adjustment left out), judged from the true poses. (The
    median, not a tail: the port's local BA solves a landmark over the
    observations of its covisibility window alone, so landmarks whose
    older observers left the window lie off the all-observation optimum
    in sound runs too; PERF.md.)"""
    cam, bf = cfg["camera"], float(cfg["camera"]["bf"])
    obs = out["map_obs"]
    lm_row = {int(l): r for r, l in enumerate(out["lm_ids"])}
    live = np.array([o >= 0 and out["lm_valid"][lm_row[o]] for o in obs.reshape(-1)], bool).reshape(obs.shape)
    kf, n = np.nonzero(live)
    lm = np.array([lm_row[int(o)] for o in obs[kf, n]], np.int64)
    kf_frames = np.round(out["map_kf_time"].astype(np.float64) * seq.fps).astype(np.int64)
    seen = np.zeros(len(out["lm_ids"]), bool)
    seen[lm[kf_frames[kf] >= w0]] = True
    args = (kf, out["map_xy"][kf, n].astype(np.float64), out["map_ur"][kf, n].astype(np.float64),
            out["map_level"][kf, n], lm)
    scale = float(cfg["orb"]["scale_factor"])
    med = lambda g: (lambda v: 100.0 * float(np.median(v)) if len(v) else None)(g[seen & np.isfinite(g)])
    gap = check.ba_gaps(cam, bf, out["map_R_cw"].astype(np.float64), out["map_t_cw"].astype(np.float64), *args,
                        out["lm_pos"].astype(np.float64), scale)
    if not control:
        return med(gap), None
    # the renderer's pixel centres lie at +0.5
    cam_t = dict(cam, cx=cam["cx"] - 0.5, cy=cam["cy"] - 0.5)
    R_cw = np.transpose(seq.R_wc[kf_frames], (0, 2, 1)).astype(np.float64)
    t_cw = -np.einsum("kij,kj->ki", R_cw, seq.t_wc[kf_frames].astype(np.float64))
    first = {}
    for o, (k, l) in enumerate(zip(kf, lm)):
        if args[2][o] >= 0 and l not in first:
            first[l] = o  # observations run oldest keyframe first
    X0 = np.zeros((len(out["lm_ids"]), 3))
    has = np.zeros(len(X0), bool)
    if first:
        ls, os_ = np.array(list(first.keys())), np.array(list(first.values()))
        X0[ls] = check.stereo_points(cam_t, bf, R_cw[kf[os_]], t_cw[kf[os_]], args[1][os_], args[2][os_])
        has[ls] = True
    gap_c = check.ba_gaps(cam_t, bf, R_cw, t_cw, *args, X0, scale)
    return med(gap), med(np.where(has, gap_c, np.nan))


def compare_preintegration(seq, out, kf_frames, keep, control: bool):
    """Worst relative error of the window keyframes' stored windows against
    float64 integration of the same samples at the true (zero) bias, and
    the control's (that integration carried out in bfloat16). A keyframe's
    window runs from the previous keyframe of the map to it."""
    worst, worst_ctl = None, None
    stamps = seq.imu_t[1:].reshape(-1)
    acc = seq.imu_acc[1:].reshape(-1, 3)
    gyro = seq.imu_gyro[1:].reshape(-1, 3)
    kf_times = out["all_kf_time"].astype(np.float64)
    for k in np.nonzero(keep & out["pre_valid"])[0]:
        t_end = float(seq.times[kf_frames[k]])
        earlier = kf_times[kf_times < float(out["kf_time"][k]) - 1e-4]
        if not len(earlier):
            continue
        t_beg = float(seq.times[int(round(earlier[-1] * seq.fps))])
        sel = (stamps > t_beg + 1e-6) & (stamps <= t_end + 1e-6)
        if not sel.any():
            continue
        ts = stamps[sel]
        dt = np.diff(np.concatenate([[t_beg], ts]))
        # the samples are exact: the true biases are zero
        args = (acc[sel], gyro[sel], dt, np.zeros(3), np.zeros(3))
        ref = check.preintegrate(*args)
        prog = (out["pre_dR"][k].astype(np.float64), out["pre_dV"][k].astype(np.float64),
                out["pre_dP"][k].astype(np.float64))
        e = check.preint_rel_err(prog, ref)
        worst = e if worst is None else max(worst, e)
        if control:
            e_c = check.preint_rel_err(check.preintegrate(*args, dtype=torch.bfloat16), ref)
            worst_ctl = e_c if worst_ctl is None else max(worst_ctl, e_c)
    return worst, worst_ctl
