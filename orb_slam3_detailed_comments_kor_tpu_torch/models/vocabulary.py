"""Binary-descriptor vocabulary: the production sparse BoW scheme.

Port of ``Vocabulary``, ``load_default``, ``_level_offset``,
``transform_exact_topk``, ``soft_assign_weights``,
``sparse_bow_soft_from_desc``, ``sparse_l1_score`` and the scheme
constants of ``orb_slam3_detailed_comments_kor_tpu/models/vocabulary.py``
(the DBoW2 replacement). A keyframe's BoW row is its descriptors' exact
top-``SOFT_K`` nearest leaf words with exp(-d/σ) soft weights, idf²
term weights, L1 normalization and top-``TOPW`` truncation; two rows score
by the L1 similarity Σ min(a_w, b_w).

The vocabulary asset is this package's own copy of the reference's
``default_vocab.npz`` (k = 10, depth = 5, 100,000 leaf words).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch


class Vocabulary(NamedTuple):
    """k-ary tree of depth L over 256-bit descriptors (bit-unpacked)."""

    centroids: torch.Tensor  # [n_nodes, 256] float32 in {0,1}; level-major
    k: int                   # branching factor
    depth: int               # levels below root
    idf: torch.Tensor        # [k^depth] inverse document frequency weights

    @property
    def n_words(self) -> int:
        return self.k ** self.depth


#: per-document sparse BoW truncation (2,048 slots keep >99 % of the L1
#: mass of a 1,200-feature frame's soft assignment)
TOPW = 2048
#: production assignment scheme: exact top-SOFT_K nearest leaf words,
#: exp(-d/σ) soft weights, idf^IDF_POW term weighting
SOFT_K = 3
SOFT_SIGMA = 8.0
IDF_POW = 2.0

_DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "default_vocab.npz")
_DEFAULT_CACHE = {}


def load_default(device="cuda") -> Vocabulary:
    """The default vocabulary on ``device`` (the card unless the caller
    names another), cached per process and device: the unpacked centroids
    are ~114 MB and immutable, so every SlamSystem shares one copy."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    vocab = _DEFAULT_CACHE.get(dev)
    if vocab is None:
        z = np.load(_DEFAULT_PATH)
        vocab = Vocabulary(
            centroids=torch.from_numpy(z["centroids"].astype(np.float32)).to(dev),
            k=int(z["k"]),
            depth=int(z["depth"]),
            idf=torch.from_numpy(z["idf"].astype(np.float32)).to(dev),
        )
        _DEFAULT_CACHE[dev] = vocab
    return vocab


def _level_offset(k: int, lvl: int) -> int:
    """Start index of level ``lvl`` (0-based) in the flat centroid array."""
    return sum(k ** (l + 1) for l in range(lvl))


def _k_argmin(dist: torch.Tensor, kk: int):
    """The ``kk`` smallest entries of each row and their columns, in
    order, the lower column first on ties (iterated argmin)."""
    dist = dist.clone()
    ds, cs = [], []
    inf = torch.full((), float("inf"), dtype=dist.dtype, device=dist.device)
    for _ in range(kk):
        a = torch.argmin(dist, dim=1, keepdim=True)
        ds.append(torch.gather(dist, 1, a)[:, 0])
        cs.append(a[:, 0])
        dist.scatter_(1, a, inf.expand(a.shape))
    return torch.stack(ds, dim=1), torch.stack(cs, dim=1)


def transform_exact_topk(
    vocab: Vocabulary, desc_bits: torch.Tensor, valid: torch.Tensor,
    kk: int = 2, chunk: int = 32768,
):
    """Exact top-``kk`` nearest leaf words and their Hamming distances.

    desc_bits [N,256] {0,1}. The [N, chunk] distance blocks are f32
    products of 0/1 vectors, exact since every sum is at most 256 (TF32 is
    off). Returns (ids [N,kk] int32, dist [N,kk] f32); invalid rows get
    id -1.
    """
    n = desc_bits.shape[0]
    d = desc_bits.to(torch.float32)
    d_sum = torch.sum(d, dim=1, keepdim=True)
    off = _level_offset(vocab.k, vocab.depth - 1)
    W = vocab.n_words
    dev = d.device
    best_d = torch.full((n, kk), float("inf"), device=dev)
    best_i = torch.zeros((n, kk), dtype=torch.int64, device=dev)
    for c0 in range(0, W, chunk):
        cents = vocab.centroids[off + c0: off + min(c0 + chunk, W)]
        dist = d_sum + torch.sum(cents, dim=1)[None, :] - 2.0 * (d @ cents.T)
        nd, na = _k_argmin(dist, kk)
        # [2kk]-wide merge, the same iterated selection
        cat_d = torch.cat([best_d, nd], dim=1)
        cat_i = torch.cat([best_i, c0 + na], dim=1)
        best_d, sel = _k_argmin(cat_d, kk)
        best_i = torch.gather(cat_i, 1, sel)
    best_i = torch.where(valid[:, None], best_i, -1).to(torch.int32)
    return best_i, best_d


def soft_assign_weights(dist: torch.Tensor, sigma: float = 16.0):
    """Distance -> per-word weights, L1-normalized per descriptor
    (exp(-d/σ) kernel; σ in Hamming bits)."""
    w = torch.exp(-(dist - dist[:, :1]) / sigma)
    return w / torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-9)


def top_k_stable(v: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of a vector, the lower
    index first among equal values: the reference's ``approx_max_k`` as
    its CPU backend computes it (an exact top-k)."""
    vals, idx = torch.sort(v, descending=True, stable=True)
    return vals[:k], idx[:k]


def sparse_bow_soft_from_desc(
    vocab: Vocabulary, desc_bits: torch.Tensor, valid: torch.Tensor,
    topw: int = TOPW,
):
    """Descriptors -> production sparse BoW row: exact top-K soft
    assignment + idf^IDF_POW weighting + L1 normalization + top-``topw``
    truncation. Returns (ids [topw] int32, -1 past the row's words;
    weights [topw] f32).

    The word counts accumulate with ``index_put_(accumulate=True)``, which
    adds duplicates in input order on every device (sorted, not atomic),
    as the reference's CPU scatter does.
    """
    ids, dist = transform_exact_topk(vocab, desc_bits, valid, kk=SOFT_K)
    w = soft_assign_weights(dist, sigma=SOFT_SIGMA)
    W = vocab.n_words
    contrib = w * valid[:, None].to(torch.float32)
    counts = torch.zeros((W,), dtype=torch.float32, device=w.device)
    counts.index_put_(
        (torch.clamp(ids, min=0).reshape(-1).to(torch.int64),),
        torch.where(ids >= 0, contrib, 0.0).reshape(-1), accumulate=True,
    )
    v = counts * vocab.idf ** IDF_POW
    v = v / torch.clamp(torch.sum(v), min=1e-9)
    wts, out_ids = top_k_stable(v, topw)
    out_ids = torch.where(wts > 0, out_ids, -1)
    return out_ids.to(torch.int32), wts


def sparse_l1_score(q_ids, q_wts, db_ids, db_wts):
    """L1 similarity between a sparse query and sparse database rows:
    Σ_{w ∈ a∩b} min(a_w, b_w), which equals 1 − ½Σ|a−b| for L1-normalized
    documents. q_ids/q_wts [T]; db_ids/db_wts [..., T] -> [...] scores.

    The reference compares every pair of slots ([..., T, T]: 1 GiB per
    float tensor at 64 rows × 2,048 slots). Ids within a row are unique
    (top-k of a dense vector), so each database slot is looked up in the
    sorted query instead; the same terms are summed in another order.
    """
    qs, order = torch.sort(q_ids.to(torch.int64))
    qw = q_wts[order]
    db = db_ids.to(torch.int64)
    pos = torch.clamp(torch.searchsorted(qs, db.reshape(-1)), max=qs.shape[0] - 1).reshape(db.shape)
    hit = (qs[pos] == db) & (db >= 0)
    return torch.sum(torch.where(hit, torch.minimum(db_wts, qw[pos]), 0.0), dim=-1)
