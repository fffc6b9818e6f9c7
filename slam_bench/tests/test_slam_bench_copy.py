"""The benchmark's frozen renderer and trajectory give what the port's
``io/synthetic`` gives, at a small size on the CPU. (The test may import
the port; the benchmark's reference may not.)"""

import numpy as np
import pytest
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic as port
from slam_bench.reference import synthetic as copy

TIMES = [0.0, 0.35, 3.05, 17.4]


@pytest.mark.parametrize("excitation", [1.0, 2.0])
def test_trajectory_poses_and_imu_equal(excitation):
    a = port.AnalyticTrajectory(excitation=excitation, device="cpu")
    b = copy.AnalyticTrajectory(excitation=excitation, device="cpu")
    for t in TIMES:
        Ra, pa = a.pose(t)
        Rb, pb = b.pose(t)
        assert torch.equal(Ra, Rb) and torch.equal(pa, pb)
        assert torch.allclose(a.velocity(t), b.velocity(t), rtol=0, atol=1e-6)
    # the port differentiates the law automatically, the copy in closed form:
    # equal to float32 rounding
    ts = np.linspace(0.0, 60.0, 1201)
    for x, y in zip(a.imu_at(ts), b.imu_at(ts)):
        assert torch.allclose(x, y, rtol=0, atol=4e-6)
    Rs, ps = b.poses(np.asarray(TIMES))
    for k, t in enumerate(TIMES):
        Ra, pa = a.pose(t)
        assert torch.allclose(Rs[k], Ra, atol=1e-6) and torch.allclose(ps[k], pa, atol=1e-6)


def test_images_and_depth_equal():
    params = torch.tensor([80.0, 80.0, 47.0, 30.0])
    traj = port.AnalyticTrajectory(device="cpu")
    scene_p, scene_c = port.default_scene("cpu"), copy.default_scene("cpu")
    for t in TIMES:
        R, p = traj.pose(t)
        lp, rp, dp = port.stereo_pair(params, R, p, 0.11, scene_p, h=60, w=94)
        lc, rc, dc = copy.stereo_pair(params, R, p, 0.11, scene_c, 60, 94)
        assert torch.equal(lp, lc) and torch.equal(rp, rc) and torch.equal(dp, dc)


def test_batched_render_equals_the_copy_frame_by_frame():
    params = torch.tensor([80.0, 80.0, 47.0, 30.0])
    R, p = copy.AnalyticTrajectory().poses(np.asarray(TIMES))
    scene = copy.default_scene("cpu")
    many = copy.stereo_many(params, R, p, 0.11, scene, 60, 94)
    for k in range(len(TIMES)):
        left, right, _ = copy.stereo_pair(params, R[k], p[k], 0.11, scene, 60, 94)
        assert torch.equal(many[k, 0], left) and torch.equal(many[k, 1], right)


def test_ray_depth_matches_the_rendered_depth_at_pixel_centres():
    params = torch.tensor([80.0, 80.0, 47.0, 30.0])
    R, p = copy.AnalyticTrajectory().pose(1.3)
    scene = copy.default_scene("cpu")
    _, depth = copy.render(params, R, p, scene, 60, 94)
    rows, cols = torch.meshgrid(torch.arange(0, 60, 7), torch.arange(0, 94, 9), indexing="ij")
    uv = torch.stack([cols.reshape(-1) + 0.5, rows.reshape(-1) + 0.5], -1).to(torch.float64)
    z = copy.ray_depth(params, R, p, scene, uv)
    assert torch.allclose(z.float(), depth[rows.reshape(-1), cols.reshape(-1)], rtol=1e-5)
