"""The metric arithmetic on hand-made inputs."""

import math

import numpy as np
import pytest

from slam_bench import harness
from slam_bench.reference import ate, check, devtrace, fast_nms_bytes, orb

CFG = harness.load_json(harness.config_file("euroc_stereo"))


def record(**kw):
    return harness.RunRecord(config=CFG, **kw)


def read(name, rec):
    return harness.metric_reader(name).read(rec)


def test_frames_per_s_is_every_window_frame_over_the_window():
    assert read("frames_per_s", record(window_frames=120, window_s=30.0)) == pytest.approx(4.0)
    assert read("frames_per_s", record(window_frames=0, window_s=0.0)) is None


def test_pose_p90_is_over_all_frames():
    lat = list(range(1, 101))  # 1..100 ms, one slow frame per ten
    assert read("pose_ms_p90.live", record(latencies_ms=lat)) == pytest.approx(np.percentile(lat, 90))
    assert read("pose_ms_p90.live", record(latencies_ms=[5.0] * 89 + [500.0] * 11)) == pytest.approx(500.0)
    assert read("pose_ms_p90.live", record(latencies_ms=None)) is None


def test_device_idle_from_overlapping_intervals():
    # [0,10) and [5,20) overlap: 20 µs busy; [30,40): 10 more; window 100 µs
    ev = [(0.0, "a", 10.0), (5.0, "b", 15.0), (30.0, "c", 10.0)]
    assert devtrace.busy_us(ev) == pytest.approx(30.0)
    assert devtrace.idle_pct(ev, 100.0) == pytest.approx(70.0)
    assert read("device_idle_pct", record(trace_events=ev, trace_wall_s=100e-6, trace_frames=1)) == pytest.approx(70.0)
    assert devtrace.idle_gaps(ev) == [(20.0, 10.0)]
    assert read("device_ops_per_frame", record(trace_events=ev, trace_frames=2)) == pytest.approx(1.5)
    assert read("device_idle_pct", record()) is None


def test_span_metrics_take_top_level_spans_per_frame():
    spans = {"track/dispatch": [100.0, 120.0], "track/decide_sync": [2.0], "mapping/lba": [30.0],
             "mapping/insert_kf": [10.0], "mapping/insert_kf/mapping/imu_init": [8.0], "track/imu": [40.0]}
    rec = record(spans=spans, window_frames=2)
    assert read("track_host_ms", rec) == pytest.approx(111.0)
    assert read("mapping_host_ms", rec) == pytest.approx(20.0)
    assert read("imu_host_ms", rec) == pytest.approx(20.0)
    assert read("vio_host_ms", rec) is None


def test_fast_nms_roofline_counts_the_configuration_not_buffers():
    shapes = fast_nms_bytes.level_shapes(480, 752, 8, 1.2)
    assert shapes[0] == (480, 752) and shapes[1] == (400, 627) and len(shapes) == 8
    px = sum(h * w for h, w in shapes)
    assert fast_nms_bytes.frame_bytes(480, 752, 8, 1.2) == 2 * px * 8
    least = fast_nms_bytes.least_seconds(480, 752, 8, 1.2)
    ev = [(0.0, "fast_nms_kernel(float const*, ...)", 2 * least * 1e6), (0.0, "other", 1.0)]
    assert read("fast_nms_roofline", record(trace_events=ev, trace_frames=1)) == pytest.approx(50.0)
    assert read("fast_nms_roofline", record(trace_events=[(0.0, "other", 1.0)], trace_frames=1)) is None


def test_ate_and_keyframe_held_control():
    gt = np.stack([np.linspace(0, 1, 50), np.zeros(50), np.zeros(50)], 1)
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    assert check.ate_mm(gt @ R.T + 3.0, gt) == pytest.approx(0.0, abs=1e-9)
    assert ate.ate_rmse(gt * 1.1, gt) > 0.0
    held = check.keyframe_held(np.arange(10, 20), np.array([12, 17]), 10)
    assert held.tolist() == [10, 10, 12, 12, 12, 12, 12, 17, 17, 17]


def test_depth_and_descriptor_helpers():
    x = np.array([100.0, 200.0, 300.0])
    z = np.array([2.0, 4.0, -1.0])
    ur = x - 50.38 / z * np.array([1.0, 1.01, 1.0])
    err = check.depth_rel_errors(x, ur, 50.38, z)
    assert err.tolist() == pytest.approx([0.0, 1 - 1 / 1.01])
    ur_int = check.integer_disparity_ur(x, 50.38, z)
    assert ur_int[2] == -1.0 and x[0] - ur_int[0] == 25.0
    a = np.array([[0, 0, 0, 0, 0, 0, 0, -1]], np.int64)
    b = np.zeros((1, 8), np.int64)
    assert check.hamming(a, b).tolist() == [32]
    rows, cols = check.level_rows_cols(np.array([[12.0 * 1.2, 7.4]]), np.array([1]), 1.2)
    assert (rows[0], cols[0]) == (round(7.4 / 1.2), 12)
    assert orb.resize_weights(10, 5).sum(axis=1) == pytest.approx(np.ones(5))


def test_keypoint_check_wants_a_suppressed_fast_corner():
    import torch

    img = torch.full((48, 48), 100.0, dtype=torch.float64)
    img[24, 24] = 200.0  # a bright spot: a corner at its centre only
    img[24, 25] = 150.0  # a weaker corner beside it, suppressed
    maps = orb.keypoint_maps([img], 20.0, 7.0)
    xy = np.array([[24.0, 24.0], [25.0, 24.0], [10.0, 30.0], [24.3, 23.8]])
    bad = check.keypoint_faults(maps, xy, np.zeros(4, np.int64), 1.2)
    assert bad.tolist() == [False, True, True, False]
    cxy, clv = check.unsuppressed_keypoints(maps, {0: 5}, 1.2, np.random.default_rng(0))
    assert len(cxy) == 2 and clv.tolist() == [0, 0]


def test_ba_gap_is_zero_at_the_optimum_and_reads_a_moved_landmark():
    cam = dict(fx=458.0, fy=458.0, cx=376.0, cy=240.0)
    rng = np.random.default_rng(1)
    K, L = 4, 30
    R = np.stack([np.eye(3)] * K)
    t = np.stack([[-0.3 * k, 0.05 * k, 0.0] for k in range(K)])
    X = rng.uniform([-1, -1, 3], [1, 1, 6], (L, 3))
    kf = np.repeat(np.arange(K), L)
    lm = np.tile(np.arange(L), K)
    Xc = X[lm] + t[kf]
    xy = np.stack([cam["fx"] * Xc[:, 0] / Xc[:, 2] + cam["cx"], cam["fy"] * Xc[:, 1] / Xc[:, 2] + cam["cy"]], -1)
    ur = xy[:, 0] - 50.38 / Xc[:, 2]
    level = np.zeros(len(kf), np.int64)
    gap = check.ba_gaps(cam, 50.38, R, t, kf, xy, ur, level, lm, X, 1.2)
    assert np.nanmax(gap) < 1e-9
    moved = X.copy()
    moved[:, 2] *= 1.02
    gap = check.ba_gaps(cam, 50.38, R, t, kf, xy, ur, level, lm, moved, 1.2)
    assert np.allclose(gap, np.linalg.norm(moved - X, axis=-1) / (moved[:, 2]), rtol=1e-3)
    Xs = check.stereo_points(cam, 50.38, R[kf[:L]], t[kf[:L]], xy[:L], ur[:L])
    assert np.allclose(Xs, X, atol=1e-9)


def test_preintegration_reference_and_its_bfloat16_control():
    rng = np.random.default_rng(0)
    acc = rng.normal([0.0, -9.81, 0.0], 0.3, (40, 3))
    gyro = rng.normal(0.0, 0.2, (40, 3))
    dt = np.full(40, 0.005)
    z = np.zeros(3)
    R, V, P = check.preintegrate(acc, gyro, dt, z, z)
    assert np.allclose(R.T @ R, np.eye(3)) and math.isclose(np.linalg.det(R), 1.0, rel_tol=1e-9)
    e_self = check.preint_rel_err((R, V, P), (R, V, P))
    e_bf16 = check.preint_rel_err(check.preintegrate(acc, gyro, dt, z, z, dtype=__import__("torch").bfloat16),
                                  (R, V, P))
    assert e_self == 0.0 and e_bf16 > 1e-4


def test_verdict_fails_a_missing_or_high_reading():
    ok, out = check.verdict({"a": 1.0, "b": 2.0}, {"a": 1.5, "b": 3.0})
    assert ok and out["a"] == {"value": 1.0, "limit": 1.5}
    assert not check.verdict({"a": 2.0}, {"a": 1.5})[0]
    assert not check.verdict({"a": None}, {"a": 1.5})[0]
