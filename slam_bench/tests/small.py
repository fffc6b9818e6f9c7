"""A small configuration and mix for driving the harness on the CPU: the
cell's files with a 376x240 camera at 10 frames/s, 600 features, 32
keyframe slots and a keyframe at least every second frame."""

from slam_bench import harness


def config(name: str) -> dict:
    cfg = harness.load_json(harness.config_file(name))
    cfg["camera"].update(width=376, height=240, fx=230.0, fy=230.0, cx=188.0, cy=120.0, bf=0.11 * 230.0, fps=10.0)
    cfg["orb"].update(n_features=600, cell_size=24)
    cfg["capacity"] = dict(max_keyframes=32, max_landmarks=4096, max_local_landmarks=2048)
    cfg["tracking"] = dict(max_frames_between_kf=2, kf_ref_ratio=0.5, decision_batch=1)
    return cfg


def traffic(name: str, frames_per_second: int = 2) -> dict:
    mix = harness.load_json(harness.traffic_file(name))
    mix.update(fps=10.0, frames_per_window_second=frames_per_second)
    mix["setup"] = dict(frames=4, frames_after_imu_init=2, max_frames=40)
    mix["trace"] = dict(frames=2)
    return mix


def run(cell: str, seconds: float = 4.0, seed: int = 2**31 + 11, **kw) -> dict:
    spec = harness.cell_spec(harness.benchmark(), cell)
    return harness.run_cell(cell, seed, seconds, trace=False, device="cpu", config=config(spec["config"]),
                            traffic=traffic(spec["traffic"]), log=lambda s: None, **kw)
