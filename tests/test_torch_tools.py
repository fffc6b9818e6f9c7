"""The port's host tools (``tools/torch_train_vocab.py``,
``tools/torch_eval_vocab.py``, ``tools/torch_run_long_synthetic.py``,
``tools/torch_dist_ba_efficiency.py``, ``tools/torch_prof_stages.py``)
against the reference's tools, at small sizes on the CPU.

Tolerances: the image generators and the query augmentations exactly (the
same numpy code on the same ``RandomState``); the trained tree's centroids
exactly and its idf within 1e-6 against the reference's
``train_vocabulary`` and ``compute_idf`` on the same descriptors (the
port's, extracted by the tool); the evaluation's result keys those of the
reference's committed report; the long run's trajectory file byte-equal to
the reference's ``save_euroc`` of the same arrays, and its result keys
those of the reference tool's; the sharded-GBA problem equal to the
reference tool's ``make_problem`` (the same draws, at a tiny size) and
every sharded solve within 1e-3 m of the one-device solve; the stage
profiler's two modes, spans and percentiles on the stereo-inertial pass's
first two frames.
"""

import ast
import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import dist_ba_efficiency  # noqa: E402
import eval_vocab  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_dist_ba_efficiency  # noqa: E402
import torch_eval_vocab  # noqa: E402
import torch_prof_stages  # noqa: E402
import torch_run_long_synthetic  # noqa: E402
import torch_train_vocab  # noqa: E402
import train_vocab  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.io import trajectory as jtraj  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu.models import vocabulary as jvoc  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as tvoc  # noqa: E402

H, W = 240, 376


@pytest.mark.parametrize("name", ["value_noise", "checker", "polygons", "dot_grid", "warp_checker"])
def test_training_textures_match_reference(name):
    for seed in (0, 1):
        ref = getattr(train_vocab, name)(np.random.RandomState(seed), H, W)
        got = getattr(torch_train_vocab, name)(np.random.RandomState(seed), H, W)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["gratings", "blobs", "voronoi", "grating_product"])
def test_held_out_textures_match_reference(name):
    for seed in (0, 1):
        ref = getattr(eval_vocab, name)(np.random.RandomState(seed), H, W)
        got = getattr(torch_eval_vocab, name)(np.random.RandomState(seed), H, W)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["affine_warp", "photometric"])
def test_query_augmentation_matches_reference(name):
    img = eval_vocab.voronoi(np.random.RandomState(3), H, W)
    ref = getattr(eval_vocab, name)(np.random.RandomState(4), img)
    got = getattr(torch_eval_vocab, name)(np.random.RandomState(4), img)
    np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def tiny_vocab(tmp_path_factory):
    """The training tool at 2 views, 3 textures, k=4, depth 2, and the
    descriptors it extracted."""
    out = str(tmp_path_factory.mktemp("vocab") / "vocab.npz")
    descs = []
    extract = torch_train_vocab.corpus_descriptors

    def kept(*a, **k):
        descs.extend(extract(*a, **k))
        return descs
    torch_train_vocab.corpus_descriptors = kept
    try:
        res = torch_train_vocab.main(out, n_views=2, n_textures=3, k=4, depth=2, device="cpu", log=lambda s: None)
    finally:
        torch_train_vocab.corpus_descriptors = extract
    return out, res, descs


def test_train_vocab_tool_matches_reference_training(tiny_vocab):
    """The tool's file against the reference's training on the descriptors
    the tool extracted."""
    out, res, descs = tiny_vocab
    assert res["descriptors"] == sum(len(d) for d in descs) > 1000 and res["images"] == 5
    ref = jvoc.train_vocabulary(np.concatenate(descs), k=4, depth=2, iters=8, seed=0)
    words = [np.asarray(jvoc.transform(ref, jnp.asarray(d), jnp.ones((len(d),), bool))) for d in descs]
    ref = jvoc.compute_idf(ref, words, len(words))
    z = np.load(out)
    assert int(z["k"]) == 4 and int(z["depth"]) == 2
    np.testing.assert_array_equal(z["centroids"], np.asarray(ref.centroids).astype(np.uint8))
    np.testing.assert_allclose(z["idf"], np.asarray(ref.idf), rtol=0, atol=1e-6)


def test_eval_vocab_tool_on_a_few_places(tiny_vocab, tmp_path):
    """The protocol on 5 places and 4 queries (one a family) with the tiny tree (the
    100,000-word default scores each image in ~10 s on one CPU thread):
    the reference report's result keys, and a report that says its
    device."""
    z = np.load(tiny_vocab[0])
    vocab = tvoc.Vocabulary(centroids=torch.from_numpy(z["centroids"].astype(np.float32)), k=int(z["k"]),
                            depth=int(z["depth"]), idf=torch.from_numpy(z["idf"]))
    res = torch_eval_vocab.evaluate(vocab, n_places=5, n_queries=4, device="cpu", log=lambda s: None)
    with open(os.path.join(REPO, "orb_slam3_detailed_comments_kor_tpu", "models", "VOCAB_EVAL.md")) as f:
        ref = json.loads(re.search(r"```json\n(.*?)\n```", f.read(), re.S).group(1))
    assert set(res) == set(ref)
    assert res["n_places_db"] == 5 and res["fp_pairs_of"].endswith("/16")
    assert 0.0 <= res["recall_at_1"] <= res["recall_at_3"] <= 1.0
    out = str(tmp_path / "VOCAB_EVAL.md")
    torch_eval_vocab.write_report(out, res, vocab, torch_eval_vocab.card_and_limit("cpu"))
    with open(out) as f:
        report = f.read()
    assert "Device: cpu." in report and json.loads(re.search(r"```json\n(.*?)\n```", report, re.S).group(1)) == res


def test_long_synthetic_tool_rows_and_keys(tmp_path, monkeypatch):
    """Six frames of the loop trajectory at the small 240x376 geometry
    (16 keyframe and 4,096 landmark slots):
    the reference tool's result keys, and its writer's rows for the
    arrays the tool wrote."""
    written = []
    save = torch_run_long_synthetic.trajectory.save_euroc

    def spy(path, *arrays):
        written.append(arrays)
        save(path, *arrays)
    monkeypatch.setattr(torch_run_long_synthetic.trajectory, "save_euroc", spy)
    prefix = str(tmp_path / "long")
    cfg = torch_run_long_synthetic.config(h=H, w=W, fx=230.0, n_features=600, cell=24)
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, max_keyframes=16,
                                                                max_landmarks=4096, max_local_landmarks=2048))
    res = torch_run_long_synthetic.main(6, prefix, "loop", device="cpu", cfg=cfg, log=lambda s: None)
    with open(os.path.join(REPO, "tools", "run_long_synthetic.py")) as f:
        tree = ast.parse(f.read())
    ref_keys = next({k.value for k in node.value.keys} for node in ast.walk(tree)
                    if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result")
    assert set(res) == ref_keys
    assert res["n_frames"] == 6 and res["state"] == 1 and res["ate_m"] < 0.05
    with open(prefix + "_result.json") as f:
        assert json.load(f) == res
    jtraj.save_euroc(str(tmp_path / "ref_traj.txt"), *written[0])
    with open(prefix + "_traj.txt") as a, open(str(tmp_path / "ref_traj.txt")) as b:
        rows = a.read()
        assert rows == b.read()
    assert len(rows.splitlines()) == 6


def test_dist_ba_efficiency_tool(tmp_path, monkeypatch):
    """The reference tool's problem at K=8, L=64, 4 observations a
    landmark, then one LM iteration of 2 CG steps on meshes of 2 and 4
    shards of the CPU."""
    monkeypatch.setattr(dist_ba_efficiency, "K", 8)
    monkeypatch.setattr(dist_ba_efficiency, "L", 64)
    monkeypatch.setattr(dist_ba_efficiency, "OBS_PER", 4)
    ref = dist_ba_efficiency.make_problem()
    got = torch_dist_ba_efficiency.make_problem(8, 64, 4, device="cpu")
    for a, b in zip(ref[:3] + tuple(ref[3][:6]) + ref[4:], got[:3] + tuple(got[3][:6]) + got[4:]):
        assert np.array_equal(np.asarray(a), b.numpy())
    out = str(tmp_path / "eff.json")
    res = torch_dist_ba_efficiency.main(device="cpu", shards=(2, 4), k=8, n_lm=64, obs_per=4, iters=1, cg=2, reps=1,
                                        out=out, log=lambda s: None)
    with open(out) as f:
        assert json.load(f) == res
    assert [r["devices"] for r in res["rows"]] == [1, 2, 4] and res["device"] == "cpu"
    assert all(r["max_dX_vs_single"] <= 1e-3 for r in res["rows"][1:]) and "not scaling" in res["note"]


def test_prof_stages_tool(monkeypatch, tmp_path):
    """The stereo-inertial pass's first two frames at the small setup (its
    initialization and a tracked frame), no warm-up, with a 16-word
    vocabulary standing in for the 100,000-word default (whose BoW insert
    takes seconds on one CPU thread): both modes, the frame and tracking
    spans, the blocking mode's percentiles."""
    frames = 2
    rng = np.random.RandomState(0)
    tiny = tvoc.Vocabulary(centroids=torch.from_numpy((rng.rand(4 + 16, 256) < 0.5).astype(np.float32)), k=4,
                           depth=2, idf=torch.ones(16))
    monkeypatch.setattr(tvoc, "load_default", lambda device="cuda": tiny)
    out = str(tmp_path / "stages.json")
    res = torch_prof_stages.main("si", frames=frames, warmup=0, device="cpu", small=True, out=out,
                                 log=lambda s: None)
    with open(out) as f:
        assert json.load(f) == res
    for mode in ("throughput", "blocking"):
        rec = res[mode]
        assert rec["state"] == 1 and rec["keyframes"] >= 1 and rec["frames_per_s"] > 0
        assert rec["spans"]["frame"]["count"] == frames and "frame/track/dispatch" in rec["spans"]
    assert res["blocking"]["p50_ms"] <= res["blocking"]["max_ms"] and len(res["blocking"]["slowest_frames"]) == frames
