"""The whole run but the look for a card, on the CPU at a small size, with
the timed path broken underneath: ``correct`` comes out false, held to the
cell's own limits. Faults: a step that returns its state unchanged, an
answer altered where it is produced (the descriptors), and (the inertial
cell) half of each IMU sample window left out; local bundle adjustment
returning the map it was given; the keypoints' suppression broken."""

import pytest
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import fast as fast_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops
from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial, system, tracking
from slam_bench.tests import small

STEREO = "euroc_stereo.offline"
INERTIAL = "euroc_stereo_inertial.offline"
WINDOW_S = 10.0  # about ten frames of the small configuration on the CPU


@pytest.fixture(scope="module")
def sound():
    return small.run(STEREO, seconds=WINDOW_S)


def test_result_line_keys(sound):
    assert list(sound)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(sound)[-1] == "checks"
    assert set(sound["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(sound["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in sound["metrics"].values())
    assert set(sound["checks"]) == {"ate_mm", "kp_bad_pct", "desc_bits", "reproj_px", "ba_gap_pct"}
    assert all(set(c) == {"value", "limit"} for c in sound["checks"].values())
    assert sound["attempted"] >= 2 and sound["failed"] == 0


def test_pose_left_unchanged(monkeypatch, sound):
    orig = system.SlamSystem._after_dispatch

    def frozen(self, out, t):
        R, tc = self.R_cw, self.t_cw
        orig(self, out, t)
        self.R_cw, self.t_cw = R, tc  # the step returns its state unchanged

    monkeypatch.setattr(system.SlamSystem, "_after_dispatch", frozen)
    res = small.run(STEREO, seconds=WINDOW_S)
    assert not res["correct"]
    assert res["checks"]["ate_mm"]["value"] > 3 * sound["checks"]["ate_mm"]["value"]


def test_descriptor_altered_where_produced(monkeypatch, sound):
    orig = orb_ops.pack_descriptors
    monkeypatch.setattr(orb_ops, "pack_descriptors", lambda bits: orig(bits) ^ 0x0F0F0F0F)
    res = small.run(STEREO)
    assert not res["correct"] and res["checks"]["desc_bits"]["value"] >= 64


@pytest.mark.parametrize("cell", [STEREO, INERTIAL])
def test_local_ba_returns_its_input(monkeypatch, cell):
    monkeypatch.setattr(tracking, "local_ba_step", lambda ms, *a, **k: ms)
    monkeypatch.setattr(inertial, "local_vi_ba_step", lambda ms, ikf, *a, **k: (ms, ikf, None))
    res = small.run(cell, seconds=WINDOW_S)
    assert not res["correct"] and res["checks"]["ba_gap_pct"]["value"] > res["checks"]["ba_gap_pct"]["limit"]


def test_keypoints_altered_where_produced(monkeypatch):
    # the suppression compares each pixel with its left neighbour only
    monkeypatch.setattr(fast_ops, "nms3x3", lambda score: torch.where(
        (score >= torch.roll(score, 1, dims=-1)) & (score > 0), score, 0.0))
    res = small.run(STEREO)
    assert not res["correct"] and res["checks"]["kp_bad_pct"]["value"] > res["checks"]["kp_bad_pct"]["limit"]


def test_half_the_imu_samples_left_out(monkeypatch):
    orig = system.SlamSystem._upload_batch

    def halved(self, samples, start, cap):
        b = orig(self, samples, start, cap)
        keep = torch.arange(b.valid.shape[0], device=b.valid.device) % 2 == 0
        return b._replace(valid=b.valid & keep)  # every other sample of the window left out

    monkeypatch.setattr(system.SlamSystem, "_upload_batch", halved)
    res = small.run(INERTIAL, seconds=WINDOW_S)
    assert not res["correct"] and res["checks"]["preint_rel_err"]["value"] > res["checks"]["preint_rel_err"]["limit"]
