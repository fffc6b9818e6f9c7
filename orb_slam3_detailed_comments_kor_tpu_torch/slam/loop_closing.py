"""Loop closing: place recognition, loop correction, pose graph, global BA.

Port of ``LoopCloser`` (with a given vocabulary, or one it trains online
from its first keyframes) and the device programs of
``orb_slam3_detailed_comments_kor_tpu/slam/loop_closing.py``
(``LoopClosing::Run``): per keyframe a BoW candidate search over
covisibility groups (``_detect_core``), temporal-consistency gating,
geometric verification by Sim3 RANSAC gated by reprojection in both
keyframes (``_verify_core_reproj``), hypothesis refinement across
keyframes by projection matching (``_refine_hyp_core``), then the
correction: an essential-graph pose optimization with landmark
re-anchoring (``_correct_core``) and the global BA that the system runs as
bounded slices (``gba_chunk``).

Keyframe and candidate indices and map sizes are Python numbers here, so
that no device scalar is read back to choose a slot. The host reads are
the reference's own: the inlier count of a verification or a hypothesis
step, the two numbers of a closure's log line, the delayed detection
result and a GBA slice's cost (read by the system).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod
from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
from orb_slam3_detailed_comments_kor_tpu_torch.ops import matching, ransac
from orb_slam3_detailed_comments_kor_tpu_torch.optim import ba, factors, pose_graph
from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_ba
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie
from orb_slam3_detailed_comments_kor_tpu_torch.utils.host_read import HostRead


class LoopCloser:
    """Per-map place recognition database + loop correction."""

    def __init__(
        self,
        max_kf: int,
        vocab_k: int = 8,
        vocab_depth: int = 3,
        min_gap: int = 10,
        min_score: float = 0.20,
        min_inliers: int = 20,
        consistency: int = 3,
        vocab: Optional[voc.Vocabulary] = None,
    ):
        self.max_kf = max_kf
        self.vocab_k = vocab_k
        self.vocab_depth = vocab_depth
        self.min_gap = min_gap
        self.min_score = min_score
        self.min_inliers = min_inliers
        self.consistency_needed = consistency
        self.vocab = vocab
        # sparse per-keyframe BoW rows: word ids [K, TOPW] (-1 pad) and
        # L1-normalized weights, on the vocabulary's device
        self.db_words = self.db_wts = None
        # with no vocabulary, keyframe descriptors buffered to train one
        self._train_buf = []
        if vocab is not None:
            dev = vocab.idf.device
            self.db_words = torch.full((max_kf, voc.TOPW), -1, dtype=torch.int32, device=dev)
            self.db_wts = torch.zeros((max_kf, voc.TOPW), dtype=torch.float32, device=dev)
        self._consecutive = 0
        self._last_cand = -1
        self._alternates = []
        self.n_loops_closed = 0
        # deferred detection: (kf_idx, HostRead of the [N_CAND, 2] result)
        # dispatched at keyframe k and consumed at keyframe k+1
        self._pending_detect = None
        # live loop hypothesis carried across keyframes:
        # (cand, R, t, s, n_confirm, n_fail)
        self._hyp = None
        #: projection matches required per hypothesis confirmation
        self.min_proj_matches = 25
        #: geometric confirmations (verify + refinements) to accept
        self.confirmations_needed = 3
        #: keyframes to ignore detection after a closure (a countdown, so
        #: slot compaction cannot invalidate it)
        self._cooldown = 0

    # ------------------------------------------------------------------
    def add_keyframe(self, kf_idx: int, desc_bits, valid) -> None:
        """Register a keyframe in the BoW database (KeyFrameDatabase::add)."""
        if self.vocab is None:
            self._train_online(desc_bits, valid)
            return
        ids, wts = _add_kf_core(self.vocab, desc_bits, valid)
        self.db_words[kf_idx] = ids
        self.db_wts[kf_idx] = wts

    def _train_online(self, desc_bits, valid) -> None:
        """Buffer a keyframe's valid descriptors (one host read); at 3·k^depth
        descriptors or 4 keyframes train a vocabulary on the buffer (6
        k-medians iterations) and fill the database rows of the buffered
        keyframes, in buffer order, as the reference does."""
        both = torch.cat([desc_bits.to(torch.uint8), valid.to(torch.uint8)[:, None]], dim=1).cpu().numpy()
        self._train_buf.append(both[both[:, -1] > 0, :-1])
        if sum(len(b) for b in self._train_buf) < 3 * self.vocab_k ** self.vocab_depth and len(self._train_buf) < 4:
            return
        dev = desc_bits.device
        self.vocab = voc.train_vocabulary(np.concatenate(self._train_buf, axis=0), k=self.vocab_k,
                                          depth=self.vocab_depth, iters=6, device=dev)
        self.db_words = torch.full((self.max_kf, voc.TOPW), -1, dtype=torch.int32, device=dev)
        self.db_wts = torch.zeros((self.max_kf, voc.TOPW), dtype=torch.float32, device=dev)
        for idx, d in enumerate(self._train_buf):
            if len(d):
                ids, wts = voc.sparse_bow_soft_from_desc(
                    self.vocab, torch.from_numpy(d).to(dev), torch.ones((d.shape[0],), dtype=torch.bool, device=dev))
                self.db_words[idx] = ids
                self.db_wts[idx] = wts

    def compact(self, new_of_old) -> None:
        """Remap database rows after keyframe-slot compaction: row r moves
        to new_of_old[r]; rows of culled keyframes are cleared."""
        if self.db_words is None:
            return
        K = self.db_words.shape[0]
        noo = np.asarray(new_of_old)
        old_of_new = np.full((K,), -1, np.int64)
        kept = noo < K
        old_of_new[noo[kept]] = np.nonzero(kept)[0]
        dev = self.db_words.device
        src = torch.from_numpy(np.where(old_of_new >= 0, old_of_new, 0)).to(dev)
        live = torch.from_numpy(old_of_new >= 0).to(dev)[:, None]
        self.db_words = torch.where(live, self.db_words[src], -1)
        self.db_wts = torch.where(live, self.db_wts[src], 0.0)
        # in-flight detection results index pre-compaction slots
        self._pending_detect = None
        self._consecutive = 0
        self._last_cand = -1
        self._hyp = None

    # ------------------------------------------------------------------
    def detect(self, ms: msx.MapState, kf_idx: int, n_kf: int) -> int:
        """BoW top-3 candidates + temporal consistency, synchronously.
        Returns the consistent candidate keyframe or -1."""
        if self.vocab is None or kf_idx < self.min_gap:
            return -1
        cs = _detect_core(self.db_words, self.db_wts, ms, kf_idx, n_kf, self.min_gap)
        return self._consistency_gate(kf_idx, cs.cpu().numpy())

    def detect_async(self, ms: msx.MapState, kf_idx: int, n_kf: int):
        """Dispatch detection for this keyframe and return the result for
        the previously dispatched one as ``(kf_idx_prev, cand)`` (cand -1
        when nothing fired): the one-keyframe lag of the reference's
        asynchronous LoopClosing queue. The result rides a non-blocking
        copy into pinned memory behind a CUDA event."""
        out = self.poll_detect()
        if self.vocab is not None and kf_idx >= self.min_gap:
            cs = _detect_core(self.db_words, self.db_wts, ms, kf_idx, n_kf, self.min_gap)
            self._pending_detect = (kf_idx, HostRead(cs))
        return out

    def poll_detect(self):
        """Consume the deferred detection, if any. Returns (kf_idx, cand)."""
        pending, self._pending_detect = self._pending_detect, None
        if pending is None:
            return -1, -1
        kf_prev, read = pending
        return kf_prev, self._consistency_gate(kf_prev, read.numpy())

    def _consistency_gate(self, kf_idx: int, cs) -> int:
        """Detection fires once ``consistency_needed`` consecutive keyframes
        agreed on (nearly) the same place; the alternates keep a near miss
        from resetting the streak."""
        if self._cooldown > 0:
            self._cooldown -= 1
            self._consecutive = 0
            self._last_cand = -1
            return -1
        cs = np.atleast_2d(np.asarray(cs))
        cands = [int(c) for c, s in cs if s >= self.min_score and c >= 0]
        if not cands:
            self._consecutive = 0
            self._last_cand = -1
            return -1
        hit = -1
        if self._last_cand >= 0:
            for c in cands:
                if abs(c - self._last_cand) <= 3:
                    hit = c
                    break
        if hit >= 0:
            self._consecutive += 1
            self._last_cand = hit
        else:
            self._consecutive = 1
            self._last_cand = cands[0]
        # alternates tried by verify() if the primary fails geometry
        self._alternates = [c for c in cands if c != self._last_cand]
        if self._consecutive >= self.consistency_needed:
            return self._last_cand
        return -1

    # ------------------------------------------------------------------
    def start_hypothesis(self, cand: int, R, t, s) -> None:
        """Seed the cross-keyframe hypothesis from a successful geometric
        verification whose BoW streak is still short."""
        self._hyp = (cand, R, t, s, 1, 0)

    def hypothesis_step(self, ms: msx.MapState, kf_idx: int, cam_params,
                        cam_model: str = "pinhole", fix_scale: bool = True):
        """Refine the live hypothesis against keyframe ``kf_idx``. Returns
        (accepted, cand, R, t, s); one host read (the inlier count)."""
        cand, R, t, s, n_conf, n_fail = self._hyp
        n_inl, R2, t2, s2 = _refine_hyp_core(ms, kf_idx, cand, R, t, s, cam_params,
                                            fix_scale=fix_scale, cam_model=cam_model)
        if int(n_inl) >= self.min_proj_matches:
            n_conf += 1
            if n_conf >= self.confirmations_needed:
                self._hyp = None
                return True, cand, R2, t2, s2
            self._hyp = (cand, R2, t2, s2, n_conf, 0)
        else:
            n_fail += 1
            # two consecutive projection failures kill the hypothesis
            self._hyp = None if n_fail >= 2 else (cand, R, t, s, n_conf, n_fail)
        return False, cand, R, t, s

    def verify(self, ms: msx.MapState, kf_idx: int, cand: int, key,
               fix_scale: bool = True, cam_params=None, cam_model: str = "pinhole"):
        """Geometric verification: descriptor match + Sim3 RANSAC, gated by
        reprojection in both keyframes when a camera is given (else by 3-D
        distance). Returns (ok, R, t, s) with X_correct ≈ s·R·X_drifted + t;
        one host read (the inlier count)."""
        if cam_params is None:
            n_inl, R, t, s = _verify_core(ms.kf_desc, ms.kf_feat_valid, ms.obs_lm, ms.lm_pos,
                                          kf_idx, cand, key, fix_scale)
        else:
            n_inl, R, t, s = _verify_core_reproj(ms, kf_idx, cand, key, cam_params,
                                                 fix_scale, cam_model)
        return int(n_inl) >= self.min_inliers, R, t, s

    # ------------------------------------------------------------------
    def correct(self, ms: msx.MapState, ikf_valid_n: int, kf_idx: int, cand: int,
                R_delta, t_delta, cam_params, bf: float, run_gba: bool = True,
                mode: str = "se3", gravity=None, s_delta=None, ikf=None):
        """CorrectLoop: essential-graph pose optimization + landmark
        re-anchoring + optional global BA. ``mode`` "se3" (stereo), "sim3"
        (monocular) or "4dof" (inertial: yaw and translation about
        ``gravity``, ``LoopClosing.cc:1239-1245``). With ``ikf`` each
        keyframe's world velocity turns with its own correction (and loses
        the sim3 scale), and (ms, ikf) is returned."""
        dev, dt_ = t_delta.device, t_delta.dtype
        if gravity is None and mode == "4dof":  # the reference's default, filled on the device
            gravity = 9.81 * torch.eye(3, dtype=dt_, device=dev)[1]
        sd = torch.ones((), dtype=dt_, device=dev) if s_delta is None else s_delta
        ms, dR_w, s_new = _correct_core(ms, ikf_valid_n, kf_idx, cand, R_delta, t_delta, sd,
                                        cam_params, bf, run_gba, mode, gravity=gravity)
        self.n_loops_closed += 1
        # the closure's ends and delta magnitude (rotation deg, metres)
        tr = torch.diagonal(R_delta, dim1=-2, dim2=-1).sum(-1)
        ang = float(torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))))
        self.last_closure = (int(kf_idx), int(cand), round(ang, 2),
                             round(float(torch.linalg.vector_norm(t_delta)), 3),
                             getattr(self, "_closure_src", "?"))
        # reset consistency tracking and the live hypothesis, and hold
        # detection down for the next keyframes
        self._consecutive = 0
        self._last_cand = -1
        self._hyp = None
        self._cooldown = 10
        if ikf is None:
            return ms
        # the corrected-Sim3 velocity propagation (LoopClosing.cc:1036-1120):
        # stale velocities would feed the next VI-BA window a
        # pre-correction frame
        return ms, ikf._replace(vel=(dR_w @ ikf.vel[..., None])[..., 0] / s_new[:, None])

    # ------------------------------------------------------------------
    def _global_ba(self, ms: msx.MapState, n_kf: int, cam_params, bf: float,
                   cam_model: str = "pinhole", rig=None):
        """Full-map BA (matrix-free PCG Schur)."""
        ms, _ = global_ba(ms, cam_params, bf, cam_model=cam_model, rig=rig)
        return ms

    def gba_chunk(self, ms: msx.MapState, cam_params, bf: float,
                  cam_model: str = "pinhole", rig=None):
        """One bounded GBA slice (2 LM iterations) -> (ms, cost)."""
        return global_ba(ms, cam_params, bf, iters=2, cam_model=cam_model, rig=rig)


def _add_kf_core(vocab: voc.Vocabulary, desc_bits, valid):
    """A keyframe's database row: exact soft top-K assignment."""
    return voc.sparse_bow_soft_from_desc(vocab, desc_bits, valid)


#: BoW candidates returned per query (DetectNBestCandidates' nNumCandidates)
N_CAND = 3


def _detect_core(db_words, db_wts, ms: msx.MapState, kf_idx: int, n_kf: int, min_gap: int):
    """Covisibility-group place-recognition scoring
    (``KeyFrameDatabase::DetectNBestCandidates``): BoW scores accumulated
    over each candidate's covisibility group, the N best groups, each
    group's best member; the floor is the lowest score between the query
    and its own covisible neighbours. Returns [N_CAND, 2] f32: (member kf,
    member score), score -1 for no candidate."""
    K = db_words.shape[0]
    dev = db_words.device
    scores = voc.sparse_l1_score(db_words[kf_idx], db_wts[kf_idx], db_words, db_wts)  # [K]
    kk = torch.arange(K, device=dev)
    near = (kk > kf_idx - min_gap) & (kk <= kf_idx)
    in_map = (kk < n_kf) & ms.kf_valid
    cov = msx.covisibility_weights(ms, kk)  # [K,K]
    grp = (cov >= 15) | (kk[:, None] == kk[None, :])
    covis_q = (cov[kf_idx] >= 15) & in_map & (kk != kf_idx)
    ref_floor = torch.amin(torch.where(covis_q, scores, float("inf")))
    floor = torch.clamp(torch.where(torch.isfinite(ref_floor), ref_floor, 0.02), min=0.02)
    # candidates lie outside the query's covisibility group
    connected = cov[kf_idx] >= 5
    cand_ok = in_map & ~near & ~connected & (scores >= floor)
    s_masked = torch.where(cand_ok, scores, 0.0)
    acc = grp.to(torch.float32) @ s_masked
    acc = torch.where(cand_ok, acc, -1.0)
    top = voc.top_k_stable(acc, N_CAND)[1]
    member_scores = torch.where(grp[top] & cand_ok[None, :], scores[None, :], -1.0)  # [N_CAND, K]
    members = torch.argmax(member_scores, dim=1)
    m_scores = torch.gather(member_scores, 1, members[:, None])[:, 0]
    ok = acc[top] > 0
    return torch.stack([torch.where(ok, members, -1).to(torch.float32),
                        torch.where(ok, m_scores, -1.0)], dim=-1)


def _loop_pairs(kf_desc, kf_feat_valid, obs_lm, lm_pos, kf_idx, cand):
    """Descriptor matches between two keyframes' landmark features:
    (feat_b, pair_ok, src = current-side positions, dst = loop-side)."""
    va = kf_feat_valid[kf_idx] & (obs_lm[kf_idx] >= 0)
    vb = kf_feat_valid[cand] & (obs_lm[cand] >= 0)
    res = matching.match_nn_ratio(kf_desc[kf_idx], kf_desc[cand], va, vb, max_dist=60, ratio=0.85)
    feat_b = torch.clamp(res.idx, min=0).to(torch.int64)
    lm_a = obs_lm[kf_idx]
    lm_b = obs_lm[cand, feat_b]
    pair_ok = res.valid & (lm_a >= 0) & (lm_b >= 0)
    src = lm_pos[torch.clamp(lm_a, min=0).to(torch.int64)]  # current (possibly drifted)
    dst = lm_pos[torch.clamp(lm_b, min=0).to(torch.int64)]  # loop side (older, anchored)
    return feat_b, pair_ok, src, dst


def _verify_core(kf_desc, kf_feat_valid, obs_lm, lm_pos, kf_idx, cand, key, fix_scale: bool = True):
    """Descriptor match + Horn RANSAC on the matched landmark pairs, 3-D
    distance gate (Sim3Solver analog). Returns (n_inliers, R, t, s)."""
    _, pair_ok, src, dst = _loop_pairs(kf_desc, kf_feat_valid, obs_lm, lm_pos, kf_idx, cand)
    rr = ransac.sim3_ransac(src, dst, pair_ok, key, n_hyp=192, inlier_th=0.12, fix_scale=fix_scale)
    return rr.n_inliers, rr.R, rr.t, rr.s


def _verify_core_reproj(ms: msx.MapState, kf_idx, cand, key, cam_params,
                        fix_scale: bool = True, cam_model: str = "pinhole"):
    """Reprojection-gated geometric verification (the production path)."""
    feat_b, pair_ok, src, dst = _loop_pairs(ms.kf_desc, ms.kf_feat_valid, ms.obs_lm, ms.lm_pos,
                                           kf_idx, cand)
    s2a = 1.2 ** (2.0 * ms.kf_level[kf_idx].to(torch.float32))
    s2b = 1.2 ** (2.0 * ms.kf_level[cand, feat_b].to(torch.float32))
    rr = ransac.sim3_ransac_reproj(
        src, dst, ms.kf_xy[kf_idx], ms.kf_xy[cand, feat_b], s2a, s2b,
        (ms.kf_R_cw[kf_idx], ms.kf_t_cw[kf_idx]), (ms.kf_R_cw[cand], ms.kf_t_cw[cand]),
        cam_params, pair_ok, key, n_hyp=192, fix_scale=fix_scale, cam_model=cam_model,
    )
    return rr.n_inliers, rr.R, rr.t, rr.s


def _refine_hyp_core(ms: msx.MapState, kf_idx, cand, R, t, s, cam_params,
                     fix_scale: bool = True, cam_model: str = "pinhole"):
    """Project-and-refine a live loop hypothesis against a new keyframe
    (``LoopClosing::DetectAndReffineSim3FromLastKF``): the loop side's
    landmarks are projected through the inverse warp into the keyframe,
    matched by projection (the ``masked_best2`` kernel), and the warp is
    Gauss-Newton-refined on the matches. Returns (n_inliers, R', t', s')."""
    lm_b = ms.obs_lm[cand]
    lm_ids = torch.clamp(lm_b, min=0).to(torch.int64)
    X_loop = ms.lm_pos[lm_ids]
    ok_b = ms.kf_feat_valid[cand] & (lm_b >= 0) & ms.lm_valid[lm_ids]
    Rk, tk = ms.kf_R_cw[kf_idx], ms.kf_t_cw[kf_idx]
    s2_feat = 1.2 ** (2.0 * ms.kf_level[kf_idx].to(torch.float32))

    def project_cur(R_, t_, s_, d):
        si = 1.0 / torch.clamp(s_, min=1e-9)
        X_cur = si * ((d["X_loop"] - t_) @ R_)
        pc = X_cur @ d["Rk"].T + d["tk"]
        return cam_mod.project(d["cam"], pc, cam_model), pc[:, 2]

    data = dict(X_loop=X_loop, Rk=Rk, tk=tk, cam=cam_params)
    uv0, z0 = project_cur(R, t, s, data)
    vis = ok_b & (z0 > 0.05)
    res = matching.search_by_projection(
        uv0, ms.kf_level[cand], ms.lm_desc[lm_ids], vis,
        ms.kf_xy[kf_idx], ms.kf_level[kf_idx], ms.kf_desc[kf_idx], ms.kf_feat_valid[kf_idx],
        radius=8.0, max_dist=60,
    )
    feat = torch.clamp(res.idx, min=0).to(torch.int64)
    data["uv_obs"] = ms.kf_xy[kf_idx, feat]
    data["sqrt_w"] = torch.sqrt(res.valid.to(torch.float32) / torch.clamp(s2_feat[feat], min=1e-6))

    def residuals(params, R0, t0, s0, d):
        phi, rho, lam = params[:3], params[3:6], params[6]
        dR = lie.so3_exp(phi)
        s_ = s0 * torch.exp(0.0 * lam if fix_scale else lam)
        uv, _ = project_cur(dR @ R0, dR @ t0 + rho, s_, d)
        return ((uv - d["uv_obs"]) * d["sqrt_w"][:, None]).reshape(-1)

    R, t, s = ransac._gauss_newton_sim3(residuals, data, R, t, s, 6, fix_scale)
    R = lie.project_to_so3(R)
    uv1, z1 = project_cur(R, t, s, data)
    chi2 = torch.sum((uv1 - data["uv_obs"]) ** 2, -1) / torch.clamp(s2_feat[feat], min=1e-6)
    inl = res.valid & (chi2 < 9.21) & (z1 > 0.05)
    return torch.sum(inl), R, t, s


#: capacity of strong-covisibility edges in the essential graph
_COV_EDGE_CAP = 192


def _correct_core(ms: msx.MapState, n_kf: int, kf_idx: int, cand: int, R_delta, t_delta, s_delta,
                  cam_params, bf, run_gba: bool, mode: str = "se3", gravity=None):
    """Essential-graph correction of the whole map: temporal chain,
    the ``_COV_EDGE_CAP`` strongest covisibility edges (ties to the lower
    flat index, as ``jax.lax.top_k``) and the loop edge; keyframe 0, the
    candidate and empty slots held. Landmarks follow their anchor
    keyframe. Returns (ms', dR_w [K,3,3], s_new [K])."""
    if mode not in ("se3", "sim3", "4dof"):
        raise ValueError(f"unknown loop correction mode {mode!r}")
    K = ms.K
    dev, dt_ = ms.kf_t_cw.device, ms.kf_t_cw.dtype
    one = torch.ones((), dtype=dt_, device=dev)
    # corrected Sim3 pose of the current keyframe: S_cw' = S_cw ∘ D⁻¹
    Rd_i, td_i, sd_i = lie.sim3_inverse(R_delta, t_delta, s_delta)
    R_corr, t_corr, s_corr = lie.sim3_compose(ms.kf_R_cw[kf_idx], ms.kf_t_cw[kf_idx], one,
                                              Rd_i, td_i, sd_i)
    kk = torch.arange(K, device=dev)
    e_seq = pose_graph.make_edges_from_poses(kk[:-1], kk[1:], ms.kf_R_cw, ms.kf_t_cw)
    e_seq = e_seq._replace(valid=kk[1:] < n_kf)
    cov = msx.covisibility_weights(ms, kk)  # [K, K]
    in_map = (kk[:, None] < n_kf) & (kk[None, :] < n_kf)
    upper = kk[None, :] >= kk[:, None] + 2  # skip self + chain neighbours
    wf = torch.where(in_map & upper, cov, 0).reshape(-1)
    top_w, top_idx = voc.top_k_stable(wf, _COV_EDGE_CAP)
    e_cov = pose_graph.make_edges_from_poses(top_idx // K, top_idx % K, ms.kf_R_cw, ms.kf_t_cw)
    e_cov = e_cov._replace(valid=top_w >= 30)
    Rj_i, tj_i, sj_i = lie.sim3_inverse(ms.kf_R_cw[cand], ms.kf_t_cw[cand], one)
    Rl, tl, sl = lie.sim3_compose(R_corr, t_corr, s_corr, Rj_i, tj_i, sj_i)
    e_loop = pose_graph.PoseGraphEdges(
        i=torch.full((1,), kf_idx, dtype=torch.int64, device=dev),
        j=torch.full((1,), cand, dtype=torch.int64, device=dev),
        R_meas=Rl[None], t_meas=tl[None], s_meas=sl.reshape(1),
        weight=torch.full((1,), 30.0, dtype=dt_, device=dev),
        valid=torch.ones((1,), dtype=torch.bool, device=dev),
    )
    edges = pose_graph.PoseGraphEdges(*(torch.cat(parts) for parts in zip(e_seq, e_cov, e_loop)))
    # out-of-map slots are held fixed so they contribute nothing
    fixed = (kk == cand) | (kk == 0) | (kk >= n_kf) | ~ms.kf_valid

    R_old, t_old = ms.kf_R_cw, ms.kf_t_cw
    s_new = torch.ones((K,), dtype=dt_, device=dev)
    if mode == "sim3":
        R_new, t_new, s_new = pose_graph.optimize_pose_graph_sim3(R_old, t_old, s_new, edges, fixed, iters=15)
        # fold the per-KF scale into the SE3 pose: [R | t/s]
        ms = ms._replace(kf_R_cw=R_new, kf_t_cw=t_new / s_new[:, None])
    elif mode == "4dof":
        R_new, t_new = pose_graph.optimize_pose_graph_4dof(R_old, t_old, gravity, edges, fixed, iters=15)
        ms = ms._replace(kf_R_cw=R_new, kf_t_cw=t_new)
    else:
        R_new, t_new = pose_graph.optimize_pose_graph_se3(R_old, t_old, edges, fixed, iters=15)
        ms = ms._replace(kf_R_cw=R_new, kf_t_cw=t_new)

    # landmark re-anchoring: X' = S_new[a]⁻¹ ∘ S_old[a] (X)
    anchor = torch.clamp(ms.lm_first_kf, 0, max(n_kf - 1, 0)).to(torch.int64)
    s_a = s_new[anchor]
    Ra_new_i, ta_new_i = lie.se3_inverse(R_new[anchor], t_new[anchor])
    pc = (R_old[anchor] @ ms.lm_pos[..., None])[..., 0] + t_old[anchor]
    X_new = ((Ra_new_i @ pc[..., None])[..., 0] + ta_new_i) / s_a[:, None]
    # per-KF world-frame correction ΔR_w = R_newᵀ R_old
    dR_w = R_new.transpose(-1, -2) @ R_old
    n_rot = (dR_w[anchor] @ ms.lm_normal[..., None])[..., 0]
    ms = ms._replace(
        lm_pos=torch.where(ms.lm_valid[:, None], X_new, ms.lm_pos),
        lm_normal=torch.where(ms.lm_valid[:, None], n_rot, ms.lm_normal),
        lm_min_dist=ms.lm_min_dist / s_a,
        lm_max_dist=ms.lm_max_dist / s_a,
    )
    if run_gba:
        ms, _ = _global_ba_core(ms, cam_params, bf)
    return ms, dR_w, s_new


def map_observations(ms: msx.MapState, with_rig: bool = False):
    """Flat Observations table + fixed masks over the whole map state;
    ``with_rig`` appends one right-camera row per feature slot
    (``factors.with_rig_rows``)."""
    K, N = ms.K, ms.N
    dev = ms.obs_lm.device
    kf_col = torch.arange(K, device=dev)[:, None].expand(K, N)
    obs_rows = ms.obs_lm
    feat_ok = ms.kf_feat_valid & (obs_rows >= 0) & ms.kf_valid[:, None]
    # 1 / 1.2 ** (2 level), in the form XLA compiles it to: 1.2 ** (-2 level)
    inv_s2 = 1.2 ** (-2.0 * ms.kf_level.to(torch.float32))
    obs = factors.Observations(
        kf=kf_col.reshape(-1),
        lm=torch.clamp(obs_rows, min=0).to(torch.int64).reshape(-1),
        uv=ms.kf_xy.reshape(-1, 2),
        u_right=ms.kf_ur.reshape(-1),
        inv_sigma2=inv_s2.reshape(-1),
        valid=feat_ok.reshape(-1),
    )
    if with_rig:
        obs = factors.with_rig_rows(obs, ms.kf_uvr.reshape(-1, 2))
    fixed_pose = ~ms.kf_valid | (torch.arange(K, device=dev) == 0)
    fixed_point = ~ms.lm_valid
    return obs, fixed_pose, fixed_point


def _global_ba_core(ms: msx.MapState, cam_params, bf, iters: int = 8,
                    cam_model: str = "pinhole", rig=None):
    """Whole-map BA by the matrix-free PCG Schur solver (memory O(obs)).
    Returns (ms', the final chi² sum over valid observations)."""
    obs, fixed_pose, fixed_point = map_observations(ms, with_rig=rig is not None)
    res = ba.bundle_adjust_cg(
        ms.kf_R_cw, ms.kf_t_cw, ms.lm_pos, obs, fixed_pose, fixed_point, cam_params, bf,
        iters=iters, cg_iters=24, cam_model=cam_model, rig=rig,
    )
    cost = torch.sum(res.chi2 * obs.valid)
    return ms._replace(kf_R_cw=res.R_cw, kf_t_cw=res.t_cw, lm_pos=res.X), cost


#: the mesh of ``global_ba``'s sharded branch; None: ``dist_ba.make_mesh``
#: for the map's device (every visible card, as the reference takes every
#: JAX device; one shard on the CPU)
_GBA_MESH = None


def global_ba(ms: msx.MapState, cam_params, bf, iters: int = 8,
              cam_model: str = "pinhole", rig=None):
    """Production GBA dispatch: the one-device PCG Schur solve, or, when
    the mesh has more than one shard, the observation-sharded
    ``dist_ba.distributed_bundle_adjust_cg``, whose cost is None. Returns
    (ms', cost)."""
    mesh = dist_ba.resolve_mesh(_GBA_MESH, ms.kf_R_cw.device)
    if len(mesh) > 1:
        obs, fixed_pose, fixed_point = map_observations(ms, with_rig=rig is not None)
        R, t, X = dist_ba.distributed_bundle_adjust_cg(
            mesh, ms.kf_R_cw, ms.kf_t_cw, ms.lm_pos, obs, fixed_pose, fixed_point, cam_params, bf,
            iters=iters, cg_iters=24, cam_model=cam_model, rig=rig,
        )
        return ms._replace(kf_R_cw=R, kf_t_cw=t, lm_pos=X), None
    return _global_ba_core(ms, cam_params, bf, iters=iters, cam_model=cam_model, rig=rig)
