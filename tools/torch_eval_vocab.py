"""Held-out evaluation of the port's BoW vocabulary at a 512-place database.

Port of ``tools/eval_vocab.py`` and its protocol: 512 synthetic places
from texture families the training corpus never saw (sinusoidal gratings,
Gaussian blob fields, Voronoi cells, grating products), each entered into
the database once; 256 queries re-observe the first 256 places under an
affine warp (±15° rotation, 0.9-1.1 scale, ±12 px shift) and a
photometric jitter (gain 0.7-1.3, bias ±20, σ=8 noise), all from
``RandomState(123)``. Every image gets the production BoW row
(``sparse_bow_soft_from_desc`` on 1,200 ORB features, extracted on the
system's device), densified for an L1 score matrix. Reports recall@1 and
recall@3 (the loop detector takes the top 3, ``KeyFrameDatabase.cc:604``),
the same recall for an oracle that skips the warp, and the false-positive
rate of wrong places above the detection floor (min_score 0.20).

Run (on the card):  python3 tools/torch_eval_vocab.py [--out PATH]
Writes ``orb_slam3_detailed_comments_kor_tpu_torch/models/VOCAB_EVAL.md``
(or PATH) with the device's name and power limit, and prints the result.
``--places`` and ``--queries`` cut the protocol; ``--device cpu`` runs on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops  # noqa: E402

H, W = 240, 376
N_PLACES = 512
N_QUERIES = 256
N_FEATURES = 1200  # the production budget (EuRoC.yaml nFeatures)
MIN_SCORE = 0.20   # the loop detector's floor
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "orb_slam3_detailed_comments_kor_tpu_torch", "models", "VOCAB_EVAL.md")


# ---- held-out texture families ----------------------------------------------

def gratings(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(rng.randint(2, 5)):
        th = rng.uniform(0, np.pi)
        f = rng.uniform(0.05, 0.4)
        ph = rng.uniform(0, 2 * np.pi)
        img += np.sin(f * (np.cos(th) * xx + np.sin(th) * yy) + ph)
    img += 0.3 * rng.randn(h, w).astype(np.float32)
    img -= img.min()
    return 255.0 * img / max(img.max(), 1e-6)


def blobs(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for _ in range(rng.randint(20, 60)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(4, 25)
        a = rng.uniform(-1, 1)
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += 0.05 * rng.randn(h, w).astype(np.float32)
    img -= img.min()
    return 255.0 * img / max(img.max(), 1e-6)


def voronoi(rng, h, w):
    n = rng.randint(24, 80)
    py = rng.uniform(0, h, n).astype(np.float32)
    px = rng.uniform(0, w, n).astype(np.float32)
    val = rng.uniform(0, 255, n).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = (yy[..., None] - py) ** 2 + (xx[..., None] - px) ** 2
    img = val[np.argmin(d, axis=-1)]
    return 0.85 * img + 20 * rng.rand(h, w).astype(np.float32)


def grating_product(rng, h, w):
    a = gratings(rng, h, w)
    b = gratings(rng, h, w)
    img = a * b / 255.0
    img -= img.min()
    return 255.0 * img / max(img.max(), 1e-6)


FAMILIES = [gratings, blobs, voronoi, grating_product]


# ---- query augmentation -----------------------------------------------------

def affine_warp(rng, img):
    """Viewpoint proxy: rotation ±15°, scale 0.9-1.1, translation ±12 px,
    bilinear resampling with clamped edges."""
    h, w = img.shape
    th = rng.uniform(-np.pi / 12, np.pi / 12)
    s = rng.uniform(0.9, 1.1)
    tx, ty = rng.uniform(-12, 12, 2)
    c, si = np.cos(th) / s, np.sin(th) / s
    cy, cx = h / 2.0, w / 2.0
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    xs = c * (xx - cx) + si * (yy - cy) + cx - tx
    ys = -si * (xx - cx) + c * (yy - cy) + cy - ty
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 2)
    fx = np.clip(xs - x0, 0, 1)
    fy = np.clip(ys - y0, 0, 1)
    return (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx + img[y0 + 1, x0 + 1] * fy * fx)


def photometric(rng, img):
    gain = rng.uniform(0.7, 1.3)
    bias = rng.uniform(-20, 20)
    noise = rng.randn(*img.shape).astype(np.float32) * 8.0
    return np.clip(gain * img + bias + noise, 0, 255)


# ---- scoring ------------------------------------------------------------------

def bow_of(vocab, img, device, n_features=N_FEATURES):
    """The production BoW row of one image (exact soft top-3 assignment,
    idf² weights, top-2048 truncation), densified over the words."""
    f = orb_ops.extract_orb(torch.as_tensor(np.asarray(img, np.float32), device=device),
                            n_features=n_features, cell=24)
    ids, wts = voc.sparse_bow_soft_from_desc(vocab, f.desc, f.valid)
    ids, wts = ids.cpu().numpy(), wts.cpu().numpy()
    v = np.zeros((vocab.n_words,), np.float32)
    m = ids >= 0
    v[ids[m]] = wts[m]
    return v


def l1_scores(Q, db):
    """DBoW2's L1 score, 1 - |q - d|₁ / 2, queries x database, row by row."""
    S = np.empty((Q.shape[0], db.shape[0]), np.float32)
    for i in range(Q.shape[0]):
        S[i] = 1.0 - 0.5 * np.abs(Q[i][None, :] - db).sum(-1)
    return S


def card_and_limit(device) -> str:
    """``<name>, <power limit>`` as nvidia-smi gives them, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return out[0] if out else torch.cuda.get_device_name(torch.device(device))


def evaluate(vocab, n_places=N_PLACES, n_queries=N_QUERIES, device="cuda", log=print) -> dict:
    dev = torch.device(device)
    rng = np.random.RandomState(123)
    t0 = time.time()
    places = [FAMILIES[i % len(FAMILIES)](rng, H, W) for i in range(n_places)]
    db = np.stack([bow_of(vocab, p, dev) for p in places])
    log(f"db built: {db.shape} in {time.time() - t0:.0f}s")
    q_bows, q_oracle = [], []
    for i in range(n_queries):
        q_bows.append(bow_of(vocab, photometric(rng, affine_warp(rng, places[i])), dev))
        # the oracle: photometric jitter only, so the detector re-fires at
        # the same pixels and a miss is the vocabulary's, not the detector's
        q_oracle.append(bow_of(vocab, photometric(rng, places[i]), dev))
    log(f"queries built in {time.time() - t0:.0f}s")
    q_true = np.arange(n_queries)
    S, So = l1_scores(np.stack(q_bows), db), l1_scores(np.stack(q_oracle), db)
    ranks, ranks_o = np.argsort(-S, axis=1), np.argsort(-So, axis=1)
    hit3 = np.array([q_true[i] in ranks[i, :3] for i in range(n_queries)])
    hit3_o = np.array([q_true[i] in ranks_o[i, :3] for i in range(n_queries)])
    fam = q_true % len(FAMILIES)
    true_scores = S[q_true, q_true]
    wrong = S.copy()
    wrong[q_true, q_true] = -1
    best_wrong = wrong.max(axis=1)
    fp_pairs = int(np.sum(wrong.reshape(-1) > MIN_SCORE))
    return {
        "n_places_db": n_places,
        "n_queries": n_queries,
        "recall_at_1": round(float(np.mean(ranks[:, 0] == q_true)), 4),
        "recall_at_3": round(float(hit3.mean()), 4),
        "recall_at_3_per_family": {f.__name__: round(float(hit3[fam == fi].mean()), 4)
                                   for fi, f in enumerate(FAMILIES)},
        "recall_at_3_oracle": round(float(hit3_o.mean()), 4),
        "recall_at_3_oracle_per_family": {f.__name__: round(float(hit3_o[fam == fi].mean()), 4)
                                          for fi, f in enumerate(FAMILIES)},
        "true_score_median": round(float(np.median(true_scores)), 4),
        "true_score_p10": round(float(np.percentile(true_scores, 10)), 4),
        "best_wrong_median": round(float(np.median(best_wrong)), 4),
        "best_wrong_p99": round(float(np.percentile(best_wrong, 99)), 4),
        "fp_rate_at_floor": round(fp_pairs / wrong.size, 6),
        "floor": MIN_SCORE,
        "recall_at_3_with_floor": round(float(np.mean(hit3 & (true_scores >= MIN_SCORE))), 4),
        "fp_pairs_of": f"{fp_pairs}/{n_queries * (n_places - 1)}",
        "wall_s": round(time.time() - t0, 1),
    }


def write_report(path, result, vocab, device_line):
    with open(path, "w") as f:
        f.write(
            "# Vocabulary evaluation of the port (held-out places)\n\n"
            f"Asset: the port's `models/default_vocab.npz` (k={vocab.k}, depth={vocab.depth}, "
            f"{vocab.n_words:,} words). Protocol of `tools/eval_vocab.py`, run by "
            "`tools/torch_eval_vocab.py`: held-out places from texture families the training corpus "
            "never saw (gratings, Gaussian blobs, Voronoi cells, grating products), queries "
            "affine-warped (±15° rotation, 0.9-1.1 scale, ±12 px shift) and photometrically jittered "
            "(gain 0.7-1.3, bias ±20, σ=8 noise), 1,200 ORB features a frame, the production BoW row "
            "(`sparse_bow_soft_from_desc`), the detection floor min_score 0.20.\n\n"
            f"Device: {device_line}.\n\n"
            "```json\n" + json.dumps(result, indent=2) + "\n```\n\n"
            "recall@3 is the chance that the true place is among the three candidates handed to "
            "geometric verification; the oracle skips the warp, so its recall isolates the "
            "vocabulary from the detector's repeatability; the false-positive rate is the share of "
            "wrong-place pairs that the floor lets through before the consistency and Sim(3) checks.\n\n"
            "Regenerate: `python3 tools/torch_eval_vocab.py` (on the card).\n")


def main(out=DEFAULT_OUT, n_places=N_PLACES, n_queries=N_QUERIES, device="cuda", log=print) -> dict:
    vocab = voc.load_default(device)
    result = evaluate(vocab, n_places, n_queries, device, log)
    line = card_and_limit(device)
    print(json.dumps(dict(result, device=line)), flush=True)
    write_report(out, result, vocab, line)
    log(f"wrote {out}")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--places", type=int, default=N_PLACES)
    ap.add_argument("--queries", type=int, default=N_QUERIES)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, a.places, a.queries, a.device, log=lambda s: print(s, flush=True))
