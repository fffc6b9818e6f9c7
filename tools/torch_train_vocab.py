"""Train the port's default BoW vocabulary (k=10, depth=5: 100,000 words).

Port of ``tools/train_vocab.py``. The corpus is synthetic: the lattice
scene rendered from 90 viewpoints (yaw ±0.6, pitch ±0.25, roll ±0.2 rad,
a ±1 m box of positions) and 150 procedural textures (value noise,
checkers, random polygons, jittered dot grids, warped checkers; every
third one under a gain and bias jitter), all from ``RandomState(42)``. ORB
runs on the system's device (600 features, 24 px cells); the
hierarchical k-medians and the idf over per-image documents are the
port's ``models/vocabulary.train_vocabulary`` and ``compute_idf``.

Run (on the card):  python3 tools/torch_train_vocab.py [--out PATH]
Writes ``orb_slam3_detailed_comments_kor_tpu_torch/models/default_vocab.npz``
unless ``--out`` names another path, then prints one JSON line: the
descriptor count, the wall times and whether the centroids equal the
committed file's. ``--views``, ``--textures``, ``--k`` and ``--depth`` cut
the corpus and the tree; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops  # noqa: E402
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie  # noqa: E402

H, W, FX = 240, 376, 230.0
K_BRANCH, DEPTH = 10, 5
N_VIEWS, N_TEXTURES = 90, 150
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "orb_slam3_detailed_comments_kor_tpu_torch", "models", "default_vocab.npz")


def value_noise(rng, h, w, octaves=4):
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        s = 2 ** (o + 2)
        g = rng.rand(h // s + 2, w // s + 2).astype(np.float32)
        yy = np.linspace(0, g.shape[0] - 1.001, h)
        xx = np.linspace(0, g.shape[1] - 1.001, w)
        yi, xi = np.floor(yy).astype(int), np.floor(xx).astype(int)
        fy, fx = (yy - yi)[:, None], (xx - xi)[None, :]
        img += (1.0 / (o + 1)) * (
            g[yi][:, xi] * (1 - fy) * (1 - fx)
            + g[yi + 1][:, xi] * fy * (1 - fx)
            + g[yi][:, xi + 1] * (1 - fy) * fx
            + g[yi + 1][:, xi + 1] * fy * fx
        )
    img -= img.min()
    return 255.0 * img / max(img.max(), 1e-6)


def checker(rng, h, w):
    sy, sx = rng.randint(8, 40), rng.randint(8, 40)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 255.0 * (((yy // sy) + (xx // sx)) % 2).astype(np.float32)
    # softened, plus noise, so FAST fires on varied corners
    return 0.8 * img + 40 * rng.rand(h, w).astype(np.float32)


def polygons(rng, h, w):
    """Random filled convex quads: corners at many orientations and
    contrasts."""
    img = 60.0 + 20.0 * rng.rand(h, w).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(rng.randint(8, 20)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        n_v = 4
        ang = np.sort(rng.uniform(0, 2 * np.pi, n_v))
        rad = rng.uniform(8, 45, n_v)
        val = rng.uniform(0, 255)
        inside = np.ones((h, w), bool)
        for i in range(n_v):
            y0, x0 = cy + rad[i] * np.sin(ang[i]), cx + rad[i] * np.cos(ang[i])
            j = (i + 1) % n_v
            y1, x1 = cy + rad[j] * np.sin(ang[j]), cx + rad[j] * np.cos(ang[j])
            inside &= ((x1 - x0) * (yy - y0) - (y1 - y0) * (xx - x0)) <= 0
        img = np.where(inside, 0.7 * val + 0.3 * img, img)
    return np.clip(img, 0, 255)


def dot_grid(rng, h, w):
    """Jittered dot lattices at a random pitch and dot size."""
    img = 200.0 * rng.rand(h, w).astype(np.float32) * 0.15 + 30
    pitch = rng.randint(10, 30)
    r = rng.uniform(2, pitch * 0.35)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    oy, ox = rng.uniform(0, pitch, 2)
    dy = np.abs(((yy + oy) % pitch) - pitch / 2)
    dx = np.abs(((xx + ox) % pitch) - pitch / 2)
    dots = (dy * dy + dx * dx) < r * r
    return np.where(dots, rng.uniform(150, 255), img).astype(np.float32)


def warp_checker(rng, h, w):
    """A checkerboard under a smooth nonlinear warp."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    rng.uniform(0.01, 0.05, 2)  # an amplitude draw the warp never used; kept for the stream
    f = rng.uniform(0.02, 0.08, 2)
    u = xx + 25 * np.sin(f[0] * yy + rng.uniform(0, 6))
    v = yy + 25 * np.sin(f[1] * xx + rng.uniform(0, 6))
    sy, sx = rng.randint(10, 30), rng.randint(10, 30)
    img = 255.0 * ((np.floor(v / sy) + np.floor(u / sx)) % 2)
    return (0.8 * img + 35 * rng.rand(h, w)).astype(np.float32)


FAMILIES = [value_noise, checker, polygons, dot_grid, warp_checker]


def corpus_descriptors(n_views=N_VIEWS, n_textures=N_TEXTURES, seed=42, device="cuda", log=print):
    """Per-image descriptor arrays ([n, 256] uint8 bits) of the scene views,
    then the textures, in the reference tool's order of draws."""
    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    params = torch.tensor([FX, FX, W / 2.0, H / 2.0], device=dev)
    scene = synthetic.default_scene(dev)

    def extract(img):
        f = orb_ops.extract_orb(torch.as_tensor(img, dtype=torch.float32, device=dev), n_features=600, cell=24)
        return f.desc[f.valid].cpu().numpy()

    descs = []
    for i in range(n_views):
        yaw = rng.uniform(-0.6, 0.6)
        pitch = rng.uniform(-0.25, 0.25)
        R = lie.so3_exp(torch.tensor([pitch, yaw, rng.uniform(-0.2, 0.2)], dtype=torch.float32, device=dev))
        t = np.array([rng.uniform(-1.0, 1.0), rng.uniform(-0.4, 0.4), rng.uniform(-1.5, 1.0)])
        img, _ = synthetic.render(params, R, torch.as_tensor(t, dtype=torch.float32, device=dev), scene, h=H, w=W)
        descs.append(extract(img))
        log(f"view {i}: {len(descs[-1])} desc")
    for i in range(n_textures):
        img = FAMILIES[i % len(FAMILIES)](rng, H, W)
        if i % 3 == 2:
            # gain and bias jitter: the same structures under other exposures
            img = np.clip(rng.uniform(0.6, 1.4) * img + rng.uniform(-25, 25), 0, 255)
        descs.append(extract(img))
        log(f"tex {i}: {len(descs[-1])} desc")
    return descs


def train(descs, k=K_BRANCH, depth=DEPTH, device="cuda"):
    """The tree over all descriptors, then idf over per-image documents."""
    all_desc = np.concatenate([d for d in descs if len(d)], axis=0)
    vocab = voc.train_vocabulary(all_desc, k=k, depth=depth, iters=8, seed=0, device=device)
    dev = torch.device(device)
    word_lists = [voc.transform(vocab, torch.as_tensor(d, device=dev), torch.ones((len(d),), dtype=torch.bool,
                                                                                   device=dev))
                  for d in descs if len(d)]
    return voc.compute_idf(vocab, word_lists, len(word_lists)), all_desc.shape[0]


def main(out=DEFAULT_OUT, n_views=N_VIEWS, n_textures=N_TEXTURES, k=K_BRANCH, depth=DEPTH, device="cuda",
         log=print) -> dict:
    t0 = time.time()
    descs = corpus_descriptors(n_views, n_textures, device=device, log=log)
    t1 = time.time()
    vocab, n_desc = train(descs, k, depth, device)
    t2 = time.time()
    centroids = vocab.centroids.cpu().numpy().astype(np.uint8)
    committed = np.load(DEFAULT_OUT)["centroids"] if os.path.exists(DEFAULT_OUT) else None
    np.savez_compressed(out, centroids=centroids, k=k, depth=depth, idf=vocab.idf.cpu().numpy())
    dev = torch.device(device)
    result = dict(
        out=out, descriptors=int(n_desc), images=len(descs), k=k, depth=depth,
        extract_s=round(t1 - t0, 1), train_s=round(t2 - t1, 1), wall_s=round(time.time() - t0, 1),
        centroids_equal_committed=bool(committed is not None and committed.shape == centroids.shape
                                       and np.array_equal(committed, centroids)),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    )
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--views", type=int, default=N_VIEWS)
    ap.add_argument("--textures", type=int, default=N_TEXTURES)
    ap.add_argument("--k", type=int, default=K_BRANCH)
    ap.add_argument("--depth", type=int, default=DEPTH)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.out, a.views, a.textures, a.k, a.depth, a.device, log=lambda s: print(s, flush=True))
