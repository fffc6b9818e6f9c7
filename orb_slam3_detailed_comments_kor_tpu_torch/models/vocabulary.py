"""Binary-descriptor vocabulary: the production sparse BoW scheme.

Port of ``orb_slam3_detailed_comments_kor_tpu/models/vocabulary.py`` (the
DBoW2 replacement), every function of it. A keyframe's BoW row is its
descriptors' exact top-``SOFT_K`` nearest leaf words with exp(-d/σ) soft
weights, idf² term weights, L1 normalization and top-``TOPW`` truncation;
two rows score by the L1 similarity Σ min(a_w, b_w). The dense DBoW2 API
(``transform_exact``, ``bow_vector``, ``bow_vector_soft``, ``l1_score``,
``sparse_bow``, ``score_against_database``) is ported beside it.

Training runs on the host in numpy with the reference's
``np.random.RandomState`` draws in the reference's order, so the centroids
come out bit-equal (the 0/1 distance products are exact in float32); the
trained vocabulary's tensors live on the caller's device.

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


def _kmedians_binary(desc: np.ndarray, k: int, iters: int, rng) -> np.ndarray:
    """k-medians over binary descriptors (majority vote medians)."""
    n = desc.shape[0]
    if n <= k:
        cent = np.zeros((k, desc.shape[1]), np.float32)
        cent[:n] = desc
        return cent
    idx = rng.choice(n, k, replace=False)
    cent = desc[idx].astype(np.float32)
    for _ in range(iters):
        d = (
            desc.sum(1)[:, None] + cent.sum(1)[None, :]
            - 2.0 * desc.astype(np.float32) @ cent.T
        )
        assign = d.argmin(1)
        for c in range(k):
            m = assign == c
            if m.sum() > 0:
                cent[c] = (desc[m].mean(0) > 0.5).astype(np.float32)
            else:
                cent[c] = desc[rng.randint(n)]
    return cent


def train_vocabulary(
    descriptors: np.ndarray, k: int = 10, depth: int = 3, iters: int = 8,
    seed: int = 0, device="cuda",
) -> Vocabulary:
    """Hierarchical k-medians training (host-side, one-time).

    descriptors: [N,256] uint8 bits. Returns a Vocabulary with uniform idf
    (refined later by ``compute_idf`` over a corpus) on ``device``, the
    card unless the caller names another.
    """
    rng = np.random.RandomState(seed)
    desc = np.asarray(descriptors).astype(np.float32)
    levels = []
    assignments = np.zeros((desc.shape[0],), np.int64)
    n_clusters = 1
    for _ in range(depth):
        cents = np.zeros((n_clusters * k, 256), np.float32)
        new_assign = np.zeros_like(assignments)
        for c in range(n_clusters):
            m = assignments == c
            sub = desc[m]
            cent = _kmedians_binary(sub, k, iters, rng)
            cents[c * k:(c + 1) * k] = cent
            if m.sum() > 0:
                d = (
                    sub.sum(1)[:, None] + cent.sum(1)[None, :]
                    - 2.0 * sub @ cent.T
                )
                new_assign[m] = c * k + d.argmin(1)
        levels.append(cents)
        assignments = new_assign
        n_clusters *= k
    centroids = np.concatenate(levels, axis=0)
    return Vocabulary(
        centroids=torch.from_numpy(centroids).to(device),
        k=k,
        depth=depth,
        idf=torch.ones((k ** depth,), dtype=torch.float32, device=device),
    )


def compute_idf(vocab: Vocabulary, word_lists, n_docs: int) -> Vocabulary:
    """Refresh idf from a corpus: idf_w = log(n_docs / (1 + df_w)) + 1,
    floored at 1e-3; on the vocabulary's device."""
    df = np.zeros((vocab.n_words,), np.float32)
    for words in word_lists:
        ws = np.unique(np.asarray(words.cpu() if isinstance(words, torch.Tensor) else words))
        ws = ws[ws >= 0]
        df[ws] += 1
    idf = np.log(max(n_docs, 1) / (1.0 + df)) + 1.0
    return vocab._replace(idf=torch.from_numpy(np.maximum(idf, 1e-3).astype(np.float32)).to(vocab.idf.device))


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


def transform(vocab: Vocabulary, desc_bits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descriptors -> word ids by the hierarchical descent
    (TemplatedVocabulary::transform): [N,256] {0,1} -> [N] int32, -1 where
    invalid. At each level only the k children of the current node are
    compared; the distances are f32 sums of 0/1 products (exact), and
    argmin ties take the lowest child (F4)."""
    d = desc_bits.to(torch.float32)
    dev = d.device
    node = torch.zeros((d.shape[0],), dtype=torch.int64, device=dev)
    kids = torch.arange(vocab.k, device=dev)
    d_sum = torch.sum(d, dim=1, keepdim=True)
    for lvl in range(vocab.depth):
        off = _level_offset(vocab.k, lvl)
        cents = vocab.centroids[off + node[:, None] * vocab.k + kids[None, :]]  # [N,k,256]
        dist = d_sum + torch.sum(cents, dim=2) - 2.0 * torch.sum(d[:, None, :] * cents, dim=2)
        node = node * vocab.k + torch.argmin(dist, dim=1)
    return torch.where(valid, node, -1).to(torch.int32)


def transform_exact(
    vocab: Vocabulary, desc_bits: torch.Tensor, valid: torch.Tensor,
    chunk: int = 32768,
) -> torch.Tensor:
    """Descriptors -> word ids by the exact nearest leaf centroid: [N,256]
    {0,1} -> [N] int32, -1 where invalid.

    The [N, chunk] distance blocks are f32 GEMMs of 0/1 vectors, exact
    since every sum is at most 256 (TF32 is off); ties take the lowest
    word (F4): the first column within a block, the earlier block across
    blocks.
    """
    n = desc_bits.shape[0]
    d = desc_bits.to(torch.float32)
    d_sum = torch.sum(d, dim=1, keepdim=True)
    off = _level_offset(vocab.k, vocab.depth - 1)
    W = vocab.n_words
    best_d = torch.full((n,), float("inf"), device=d.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=d.device)
    for c0 in range(0, W, chunk):
        cents = vocab.centroids[off + c0: off + min(c0 + chunk, W)]
        dist = d_sum + torch.sum(cents, dim=1)[None, :] - 2.0 * (d @ cents.T)
        dm, a = torch.min(dist, dim=1)
        upd = dm < best_d
        best_d = torch.where(upd, dm, best_d)
        best_i = torch.where(upd, c0 + a, best_i)
    return torch.where(valid, best_i, -1).to(torch.int32)


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


def _word_counts(W: int, ids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[W] f32 sums of ``weights`` per word id; ids past the vocabulary are
    dropped (the reference's ``mode="drop"``) and negative ones count as
    word 0 (its ``clip``), so callers zero their weights. Duplicates add
    in input order on every device (``index_put_`` sorts, it does not use
    atomics), as the reference's CPU scatter does."""
    ids = torch.clamp(ids.reshape(-1), min=0).to(torch.int64)
    weights = weights.reshape(-1).to(torch.float32)
    keep = ids < W
    counts = torch.zeros((W,), dtype=torch.float32, device=weights.device)
    counts.index_put_((torch.where(keep, ids, 0),), torch.where(keep, weights, 0.0), accumulate=True)
    return counts


def bow_vector_soft(
    vocab: Vocabulary, ids: torch.Tensor, wts: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Soft word assignments (ids [N,kk], weights [N,kk]) -> L1-normalized
    tf-idf dense vector [n_words]."""
    contrib = wts * valid[:, None].to(torch.float32)
    v = _word_counts(vocab.n_words, ids, torch.where(ids >= 0, contrib, 0.0)) * vocab.idf
    return v / torch.clamp(torch.sum(v), min=1e-9)


def bow_vector(vocab: Vocabulary, words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Word ids [N] -> L1-normalized tf-idf dense vector [n_words]
    (BowVector analog)."""
    v = _word_counts(vocab.n_words, words, valid) * vocab.idf
    return v / torch.clamp(torch.sum(v), min=1e-9)


def l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity: s = 1 − ½·Σ|a−b| ∈ [0,1] (ScoringObject L1)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)


def score_against_database(query_bow: torch.Tensor, db_bows: torch.Tensor) -> torch.Tensor:
    """Score one query against all database rows: [W] vs [K,W] -> [K]."""
    return l1_score(query_bow[None, :], db_bows)


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
    contrib = w * valid[:, None].to(torch.float32)
    v = _word_counts(vocab.n_words, ids, torch.where(ids >= 0, contrib, 0.0)) * vocab.idf ** IDF_POW
    return _truncate(v / torch.clamp(torch.sum(v), min=1e-9), topw)


def _truncate(v: torch.Tensor, topw: int):
    """The ``topw`` largest entries of a normalized BoW vector as (ids
    int32, -1 where the weight is 0; weights), the lower id first among
    equal weights. A vocabulary of fewer words than ``topw`` (one trained
    online) leaves the slots past its words empty (ROADMAP F30)."""
    wts, out_ids = top_k_stable(v, topw)
    out_ids = torch.where(wts > 0, out_ids, -1)
    if v.shape[0] < topw:
        wts = torch.cat([wts, wts.new_zeros(topw - v.shape[0])])
        out_ids = torch.cat([out_ids, out_ids.new_full((topw - v.shape[0],), -1)])
    return out_ids.to(torch.int32), wts


def sparse_bow(vocab: Vocabulary, words: torch.Tensor, valid: torch.Tensor, topw: int = TOPW):
    """Word ids -> sparse BoW: (ids [topw] int32, weights [topw] f32), the
    L1-normalized tf-idf entries (normalized before the truncation), ids
    -1 past the document's distinct words."""
    v = _word_counts(vocab.n_words, words, valid) * vocab.idf
    return _truncate(v / torch.clamp(torch.sum(v), min=1e-9), topw)


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
