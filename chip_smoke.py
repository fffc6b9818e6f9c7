"""Smoke test of the PyTorch/CUDA port on one GPU: kernels, then the main path.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--baseline-csrc DIR]

Phase 0  builds the CUDA kernels from ``orb_slam3_detailed_comments_kor_tpu_torch/csrc``
         (one nvcc per source, in parallel), prints each kernel's registers,
         shared memory and spills, and the card's name and power limit.
Phase 1  runs one tracked frame at bench scale (480x752, 1200 features,
         16384 landmarks) while recording the inputs each kernel wrapper
         receives, then holds every kernel against its plain PyTorch version
         on those inputs and on edge cases (exact equality), and times the
         kernel, the plain version and, where one exists, a single PyTorch
         call computing the same function. Times are device times: the
         launches queue behind a sleep kernel, so the host's wrapper is not
         in them. Each wrapper call at the main path's inputs must put
         exactly one device kernel on the stream (torch.profiler's CUDA
         activity), so a kernel's time is the whole call's device work. An
         empty kernel, timed the same way, gives the launch floor. Each
         kernel's bound is the larger of its bytes over the HBM rate and its
         operations over their pipes' instruction rates. With ``--baseline-csrc
         DIR`` (an earlier ``csrc/`` with the same C entries) the script
         builds DIR's kernels into a library of its own and, with
         ``_cuda.launch`` pointed at it, times them on the same inputs in
         turns with the current ones.
Phase 2  the main path: renders 21 strafe frames on the card, initialises the
         map from frame 0 (process_stereo + make_keyframe) and tracks frames
         1-20 with full_frame_step. Every frame must be ok with >= 300
         inliers and a camera-centre error <= 3 cm. The launch counters,
         zeroed before it, must show each kernel's fixed launches per
         tracked frame (LAUNCHES_PER_FRAME) on every tracked frame.
Phase 3  tracks frame 1 again on the CPU (plain versions) from the same map
         and checks that the card and the CPU agree.
Phase 4  the SLAM loop at bench scale: ``slam.system.SlamSystem`` (loop
         closing set off, as in the JAX reference run that REF_ATE_M comes
         from) over bench.py's 130-frame strafe sequence, rendered on
         the card, after a warm-up system over its first frames. Blocks on
         each frame's pose (bench.py's latency pass) and prints frame wall
         p50/p99 (frames 5-129), frames/s, the ATE, the keyframes, the peak
         device memory and the device ms of one local-BA, fusion and
         landmark-culling slice, and the card-to-card spread of one local-BA
         slice (two runs on the same inputs). It fails unless the final
         state is OK, all 130 frames are recorded, the local-BA slice gives
         the same bits twice, >= 10 keyframes were inserted, the
         counters (zeroed before it) show each kernel's fixed launches per
         tracked frame, a frame that services a local-BA slice and one that
         services a fusion slice make no synchronizing call outside the
         batched decision read, each slice alone captures in a CUDA graph
         (capture refuses any host read or stream wait) and, where its
         device operations fit the launch queue (measured), returns before
         a 400 ms sleep kernel ends, and the ATE is at most the JAX
         reference's (REF_ATE_M) plus 5 mm.
Phase 5  the card against the CPU for the loop (loop closing on, the
         default): the small configuration (240x376, 600 features, 8
         keyframe slots) over 16 frames with decision_batch=1 on both;
         keyframes must be inserted at the same frames, camera centres
         agree within TRANS_TOL and rotations within ROT_TOL.
Phase 6  the loop-closure pass at bench scale (bench.py's
         ``bench_loop_latency``): the same SlamSystem with loop closing on
         over bench.py's 150-frame out-and-back sequence, rendered on the
         card, with bench.py's drift injected at frame 80 after a decision
         flush, after a warm-up pass over its first 24 frames. Blocks on each
         frame's pose and prints the loops closed (keyframe, candidate,
         source), GBA chunks, ATE, frame wall p50/p99 (frames 5-149), the
         correction frame's wall time, the device ms of one BoW insert, one
         detection, one GBA chunk and the correction, the host reads of
         every loop and GBA frame, the card-to-card spread of one GBA
         chunk, each kernel's launches over the pass and the peak memory.
         It fails unless the closures, the frames decided lost and the
         relocalizations equal the JAX reference's (REF_LOOP), the final
         state is OK, the ATE is at most the reference's plus 5
         mm, and no frame makes a host read beyond the reference's own
         (one per verification, hypothesis step and drift-gate check, two
         per correction, one per GBA chunk, two per relocalization search
         and per candidate tried). ``masked_best2`` is then held
         exactly to its plain version at the inputs of each hypothesis
         refinement of the pass (one device kernel per call), and timed.
Phase 7  the Atlas merge pass at bench scale: the scenario of the JAX
         package's tests/test_map_merge.py (40 strafe frames, a flush, 22
         black frames that shelve the map, poses 8-21 replayed, a flush)
         through the same SlamSystem (loop closing on) with a keyframe at
         least every 3 frames, after a warm-up pass over its first 24
         calls. Blocks on each call's
         pose and prints the merge (frame, pair, the call that ran it, its
         wall ms and host reads), the maps and keyframes after it, the
         merges the gate rejected, the live camera-centre error against
         pose 21 and the mean error of the last 10 trajectory centres
         against poses 12-21, frame wall p50/p99, the device ms of one
         ``verify_merge``, ``_concat_maps``, merge pose graph and weld BA,
         each kernel's launches over the pass and the peak memory. It fails
         unless it merges once at the JAX reference's pair with its
         keyframe and map counts (REF_MERGE), the final state is OK, the
         errors are within the reference's plus 2 cm (live) and 3 cm
         (tail), and no call makes a host read beyond the reference's own
         (MERGE_REF_READS, and phase 6's for the loop and lost path).
         ``masked_best2`` is then held exactly to its plain version at the
         inputs of the merge verification's tracking refinement, and timed.
Phase 8  the stereo-inertial pass at bench scale (bench.py's
         ``bench_stereo_inertial``): ``SlamSystem.track_stereo_inertial``
         with bench.py's ``build_config(True)`` over the first 90
         (SI_FRAMES) of bench.py's 130 frames of
         ``synthetic.AnalyticTrajectory`` (cut to fit the script's time) at
         20 fps with 200 Hz IMU samples
         (``bench.py:301-324``), rendered on the card; a 6-frame warm-up
         pass, then one pass that blocks on each frame's pose (frame wall
         p50/p99, frames/s, launches, peak memory; every tracked frame under
         the sync debug mode, its synchronizing calls reported by the slice
         it serviced) and records the kernels' inputs and the stream
         operations of one inertial frame (left out of the percentiles). Prints
         the device ms of one per-frame preintegration, VIO
         step, init-FIBA slice, VI local-BA slice and, when a loop closes, the
         4-DoF correction and one inertial GBA sweep slice, and the stream
         operations of one preintegration and one VIO step. It fails unless
         the final state is OK, the IMU initializes at the JAX reference's
         keyframe count (REF_SI, ``tools/jax_sensor_ref.py --pass si --frames
         90``), the loops closed
         equal the reference's, the keyframes are within 2 of its, the ATE is
         at most its plus 5 mm, the final gravity is within 0.01 rad of its
         (at 90 frames the IMU initialization's: the VIBA1 re-initialization
         at 14 keyframes lies past the cut; phase 13 runs that step on its
         final map), the VI local-BA slice and the VIO step capture in a CUDA graph, two
         runs of a VI local-BA slice give the same bits, frames that service
         no slice make no synchronizing call, and the three kernels
         equal their plain versions at the inertial frame's inputs with one
         device kernel per call.
Phase 9  the monocular pass at bench scale: ``SlamSystem.track_mono``
         (``mono_config()``: the stereo setup with a MONOCULAR sensor and bf
         = 0, loop closing on) over the first 70 (MONO_FRAMES) of phase 4's
         strafe frames (cut from 130 to fit the script's time), left images
         rendered on the card, after a 12-frame warm-up pass that records
         the kernels' inputs at one tracked mono frame. Every frame blocks
         on its pose and runs under the sync debug mode (the batched
         decision read left out). Prints one ``phase 9 (<card>): {json}``
         line: the two-view initialization frame, keyframes, loops and the
         scale-aligned ATE beside the JAX reference's (REF_MONO,
         ``tools/jax_sensor_ref.py --pass mono --frames 70``), frame wall p50/p99,
         frames/s, the peak memory, the launches, the device ms and stream
         operations of one ``full_mono_step``, one keyframe triangulation
         and the two-view initialization, the host reads of the
         initializing call and the synchronizing calls by frame kind. It
         fails unless the state is OK, the initialization frame, loops and
         lost frames equal the reference's, the keyframes are within 2 of
         its, the ATE is at most its plus 5 mm, the initializing call reads
         the host at most MONO_INIT_REF_READS times, tracked frames make no
         synchronizing call, and the three kernels equal their plain
         versions at the mono frame's inputs with one device kernel a call.
Phase 10 the monocular-inertial pass at bench scale: ``track_mono_inertial``
         (``mi_config()``: IMU_MONOCULAR, bf = 0, a keyframe at least every
         6 frames) over the first 60 (MI_FRAMES) of the pass's 130 frames of
         ``AnalyticTrajectory(excitation=3.0)`` at 20 fps with bench.py's
         200 Hz samples (cut to fit the script's time), after a 12-frame warm-up
         pass that records the kernels' inputs. Prints one ``phase 10
         (<card>): {json}`` line (frame wall p50/p99, frames/s, the
         initializations, keyframes, lost frames and relocalizations, the
         ATE with and without scale alignment, the stride-10 path-length
         ratio, the metric scale the IMU initialization solves, gravity,
         the device ms of the scale-estimating ``initialize_imu`` and its
         scale on the card against the CPU at the pass's own inputs, the
         synchronizing calls by frame kind) and fails unless the two-view
         and IMU initializations (frame, keyframes), loops, lost frames and
         final state equal the JAX reference's (REF_MI), the solved scale
         and the stride-10 ratio are within MI_SCALE_REL_TOL of its
         (relative: twice the reference's own move under another float
         association), the card's scale solve is within 1e-4 of the CPU's
         at the same inputs, the gravity is within 0.01 rad of the
         reference's, the ATEs are within the bounds REF_MI's comment gives
         (the reference loses track after its IMU initialization, ROADMAP
         F23), tracked frames make no synchronizing call, and the kernels
         equal their plain versions at one frame's inputs.
Phase 11 the RGB-D pass at bench scale: ``SlamSystem.track_rgbd``
         (``sensor_config("rgbd")``: phase 4's setup with an RGBD sensor,
         loop closing on) over the first 60 of phase 4's 130 strafe
         frames, each the left image and its rendered depth, after a
         6-frame warm-up pass.
         Every frame blocks on its pose under the sync debug mode; the
         kernels' inputs are recorded at frame 10. Prints one ``phase 11
         (<card>): {json}`` line (keyframes, loops, lost frames, ATE beside
         the JAX reference's ``REF_RGBD`` from ``tools/jax_sensor_ref.py
         --pass rgbd --frames 60``; frame wall p50/p99, frames/s, peak memory, the
         device ms and device operations of one ``full_rgbd_step`` and one
         local-BA slice, synchronizing calls by frame kind).
Phase 12 the stereo-fisheye pass: ``track_stereo`` on a rig of two 512x512
         KB8 cameras with TUM-VI's calibration (KB8_TUMVI), ``Tlr`` a 0.10 m
         x-offset (``sensor_config("fisheye")``), over the first 40 frames
         of the same strafe as raw fisheye pairs; as phase 11 against
         ``REF_FISHEYE`` (the reference cut alike), with the
         device ms of one ``full_fisheye_step`` and one rig local-BA slice,
         the valid rig rows of the newest keyframe and the slice's
         run-to-run spread.
Phase 13 the stereo-fisheye-inertial pass (TUM-VI's own mode):
         ``track_stereo_inertial`` on that rig with phase 8's IMU settings
         (``sensor_config("fsi")``) over the first 80 of phase 8's 130
         frames of ``AnalyticTrajectory`` and its 200 Hz samples, the
         kernels' inputs recorded at frame 75 (after the IMU
         initialization);
         against ``REF_FSI`` with the IMU initialization (frame, keyframes)
         and the final gravity, and the device ms, device operations and
         CUDA-graph capture of one rig VIO step and VI local-BA slice. The
         pass ends at 9 keyframes, before VIBA1 (the stereo-inertial
         re-initialization at the init's keyframes + 6), so the phase runs
         that step once on the final map with the system's arguments
         (``viba1_step``) under the sync debug mode, against the gravity
         of the reference's same step on its own final map.
         Phases 11-13 fail unless the final state, loops and lost frames
         equal the reference's, the keyframes are within 2 and the ATE
         within 5 mm of its (phase 13: the IMU initializes at its frame with
         its keyframes, the gravity ends within 0.01 rad of its, and VIBA1
         moves the gravity, makes no synchronizing call and ends within
         0.01 rad of the reference's VIBA1), tracked
         frames make no synchronizing call, the mapping slices capture in a
         CUDA graph, a rig slice gives the same bits twice, the newest
         keyframe has at least 100 rig rows, and the three kernels equal
         their plain versions at the recorded inputs.
Phase 14 the dataset runner: phase 8's stereo-inertial data (the first
         DS_FRAMES frames) written to a temporary directory in the EuRoC MAV
         layout (8-bit PNGs with their data.csv, imu0/data.csv, the ground
         truth, and a settings YAML in the reference's format with
         rectification blocks) with absolute EuRoC-like stamps, run by the
         port's ``examples/run_dataset.py`` on the card (the native
         decode-and-rectify feeder, ``datasets.Rectifier``'s maps, the
         settings' default capacity), every frame under the sync debug
         mode, the kernels' inputs recorded at frame DS_PROFILE_FRAME. Then
         its first DS_ONLINE_FRAMES frames are replayed through
         ``io/online.OnlineNode`` from three producer threads (left, right,
         IMU), and a ``LoopCloser`` without a vocabulary is fed the pass's
         first four keyframes on the card and on the CPU. Prints the
         runner's wall time and frames/s with decoding included, frame wall
         p50/p99, the wait for the feeder's decoded and rectified images
         (``feed_ms`` p50/p99) beside the track call (``track_ms`` p50),
         the IMU initialization, keyframes, loops, lost frames,
         state and ATE beside ``REF_EUROC`` (the JAX package's runner on the
         same layout), the decoder that ran, the online node's processed and
         dropped frames, the peak memory and the synchronizing calls by
         frame kind. It fails unless the state is OK, the IMU initializes at
         the reference's frame with its keyframes, the keyframes are within
         2 of its, the loops and lost frames equal its, the ATE is at most
         its plus 5 mm, the trajectory file has one row per frame, the
         native decoder and feeder ran, built from the port's own
         ``native/host_ops.cpp`` with no libpng on its link line or among
         the libraries it needs, the node processed every frame and
         dropped none and ended OK, tracked frames (fed host arrays) make no
         synchronizing call, the trained vocabularies' centroids are equal
         and their database rows within 1e-5, and the three kernels equal
         their plain versions at the recorded inputs. On frame
         DS_PROFILE_FRAME's inputs it also holds, exactly: the CUDA
         ``fast_nms_stack`` against the plain ``fast_with_fallback_stack``
         on the frame's [16, 480, 768] stack; ``gather_patches`` on the
         ragged [2210, 752] atlas of ``build_pyramid``'s levels (the SAD
         strips of ``compute_stereo_matches``' list branch, timed) against
         its plain version; and ``transform_exact``'s word ids for the
         frame's 1,200 left descriptors, card against CPU, on the committed
         vocabulary.

Phases 6 and 8 also hold the observation-sharded solvers
         (``parallel/``) on their pass's map: ``distributed_bundle_adjust_cg``
         on the mesh [card] (phase 6, 2 LM and 24 CG iterations) and
         ``distributed_full_inertial_ba`` on [card] (phase 8, 2 iterations)
         must give the bits of the one-device slice (``global_ba`` /
         ``inertial.full_inertial_ba``); then ``global_ba`` with its module
         mesh set to four shards of the card (phase 6) and the FIBA on four
         shards (phase 8) must give the same bits twice, cost None, and stay
         within tests/test_dist_ba.py's distributed-versus-single bounds
         (DIST_BOUNDS) of one shard. Each prints the device ms and the
         device operations (kernels, fills, copies) of a one-shard and a
         four-shard call, and the seconds the checks took.
Phase 15 the multi-device dry run (``parallel/dryrun.py``) at the reference's
         sizes (the dense solver at K=4, L=64; the PCG solver at K=128,
         L=32,768, 262,144 observations; the sharded FullInertialBA at K=32,
         L=8,192 on a static chain) on the meshes [card] and [card] x 4.
         Prints each case's device ms and peak memory (above what was
         allocated before it); fails on a non-finite
         output or a four-shard output outside DIST_BOUNDS of one shard.
         One card cannot show scaling across cards: the four shards share
         it.

The last stdout line is {"ok": true, "device": {...}}; the line before it
lists every kernel with its launches, error, times and bound, and the
launch floor (``launch_floor_ms``); a line before those gives each phase's
seconds. Any failure
raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import glob
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

H, W = 480, 752
FX, BASELINE = 458.0, 0.11
N_FEATURES, CELL = 1200, 32
MAX_KF, MAX_LM = 64, 16384
MIN_INLIERS = 30
N_FRAMES = 21
SPEED = 0.03
TIMING_RUNS = 20
MIN_TRACKED_INLIERS = 300   # the JAX reference tracks 463-691 on this sequence
MAX_CENTRE_ERR = 0.03       # m; the JAX reference stays within 0.0097 m
DEVICE = "cuda:0"
# parity tolerances between the card and the CPU on one tracked frame
ROT_TOL, TRANS_TOL = 1e-3, 2e-3
# ... and over the small monocular pass, in the map's gauge (median depth 2
# at initialization): points triangulated at low parallax carry float32
# rounding into every later pose; the card (an NVIDIA H100 80GB HBM3 at
# 700 W) and the CPU differ by up to 2.34 mm on it, the port and the JAX
# reference on the CPU by 1.65 mm
MONO_TRANS_TOL = 5e-3
# Phases 4-5: the SLAM loop. bench.py's stereo configuration and sequence
# (130 strafe frames at 0.03 m/frame, 20 fps, 64 keyframe slots, 4096 local
# landmarks, a keyframe at least every 10 frames), loop closing off.
LOOP_FRAMES, LOOP_WARMUP, FPS = 130, 24, 20.0
# ATE of the JAX reference (orb_slam3_detailed_comments_kor_tpu.slam.system.
# SlamSystem, enable_loop_closing=False) on this configuration and sequence,
# eval.ate.ate_rmse over all 130 frames, run on a CPU by
# tools/jax_loop_ate.py: 14 keyframes, final state OK, 2309 landmarks.
REF_ATE_M = 0.005604550522747823
ATE_MARGIN = 0.005
MIN_LOOP_KF = 10
SMALL_LOOP_FRAMES = 16
# phase 8: bench.py's stereo-inertial pass (a 200 Hz IMU); the frame of the
# pass whose kernel inputs and device operations are recorded (the IMU is
# initialized and the per-frame VIO runs), the warm-up frames; the keyframe and gravity
# tolerances against REF_SI (keyframe decisions follow the device's speed)
SI_FRAMES, SI_IMU_RATE, SI_PROFILE_FRAME, SI_WARMUP = 90, 200.0, 80, 6
SI_KF_TOL, SI_GRAVITY_TOL = 2, 0.01
# tools/jax_sensor_ref.py --pass si --frames 90: tools/jax_si_ref.py's run of
# phase 8's pass cut to its SI_FRAMES (the JAX reference on a CPU, one
# device, asynchronous dispatch off; 219 s): ATE 3.192 mm, 10 keyframes, IMU
# init at frame 65 with 8 keyframes, no loop, 1724 landmarks (the whole
# 130-frame pass: 14 keyframes, ATE 3.553 mm). VIBA1 (at the init's
# keyframes + 6 = 14) lies past the cut: gravity_end is the init's.
REF_SI = dict(ate_m=0.003192163956964573, state=1, n_kf=10,
              keyframe_frames=[0, 5, 13, 25, 33, 45, 53, 65, 73, 85],
              imu_init=dict(frame=65, n_kf=8, gravity=[0.45855143666267395, 9.788538932800293,
                                                       -0.4586262106895447]),
              gravity_end=[0.45855143666267395, 9.788538932800293, -0.4586262106895447],
              loops_closed=0, lost_frames=0, landmarks=1724)
# the small stereo-inertial pass of the CPU tests and the cuda test: 10 fps
SMALL_SI = dict(frames=22, fps=10.0)
# the small monocular pass of the CPU tests and the cuda test (the strafe of
# the JAX package's tests/test_mono.py) and the small monocular-inertial
# pass of the CPU tests (10 fps, AnalyticTrajectory(excitation=3.0))
SMALL_MONO = dict(frames=20, speed=0.05)
SMALL_MI = dict(frames=25, fps=10.0)
SLEEP_MS = 400  # the sleep kernel that a slice call must return before
# Phase 6: bench.py's loop-closure latency pass (``bench_loop_latency``):
# bench.py's stereo configuration, its 150-frame out-and-back sequence at
# 0.045 m/frame, loop closing on, bench.py's drift (``_inject_drift``: mag
# 0.35, yaw 0.03) injected at frame 80 after flushing the decisions.
LOOP6_FRAMES, LOOP6_INJECT_AT, LOOP6_SPEED, LOOP6_WARMUP = 150, 80, 0.045, 24
# The small loop-closure pass of the tests (loop_config(small=True,
# closure=True)): 84 out-and-back frames at 0.05 m/frame, the same drift at
# the turn, and a loop-closer keyframe gap of 3 (the default 10 needs a
# longer run); both packages close one loop at (keyframe 11, candidate 3).
SMALL_CLOSURE = dict(frames=84, speed=0.05, inject_at=42, min_gap=3)
# The JAX reference (orb_slam3_detailed_comments_kor_tpu.slam.system.
# SlamSystem, its defaults) on this configuration and sequence, run on a CPU
# with asynchronous dispatch off by tools/jax_loop_closure_ref.py: one loop
# closed at keyframe 17 against candidate 4 (20.07 deg, 0.054 m; accepted by
# hypothesis refinement) by the loop slice serviced at frame 146; 3 GBA
# chunks, 2 hypothesis steps, 2 verifications; 2 frames decided lost after
# the correction, both relocalized (at frame 148); 18 keyframes, final
# state OK, 2653 landmarks; ATE over all 150 frames 0.069941 m.
REF_LOOP = dict(closures=[(17, 4)], source="hyp", corrected_at_frame=146, gba_chunks=3,
                hypothesis_steps=2, verifications=2, lost_frames=2, relocalizations=2, keyframes=18,
                ate_m=0.06994095752781777)
# Phase 7: the Atlas merge pass, the scenario of the JAX package's
# tests/test_map_merge.py at bench scale: bench.py's stereo configuration
# with a keyframe at least every 3 frames; 40 strafe frames at 0.03
# m/frame (times k/20) and a decision flush; 22 black frames (the hard
# loss: the map, >= 10 keyframes, is shelved after 20 lost frames); strafe
# poses 8-21 replayed and a decision flush.
MERGE_FIRST, MERGE_BLACK, MERGE_REPLAY, MERGE_SPEED, MERGE_KF_GAP = 40, 22, (8, 22), 0.03, 3
MERGE_WARMUP = 24
# The JAX reference (its SlamSystem, defaults) on this scenario, run on a
# CPU with asynchronous dispatch off by tools/jax_merge_ref.py: 14
# keyframes before the blackout, 20 frames decided lost, no relocalization;
# one merge probe (candidate search, verification, gate check), run by the
# final decision flush after frame 75, welding keyframe 4 of the new map to
# keyframe 7 of the shelved one; 1 map and 19 keyframes after it, no merge
# rejected by the gate; final state OK; the live camera centre 6.32 mm
# from pose 21, the last 10 trajectory centres 3.23 mm from poses 12-21 on
# average.
REF_MERGE = dict(merge_frame=75, pair=(4, 7), keyframes=19, maps=1, keyframes_before_blackout=14,
                 merges_rejected_gate=0, candidate_searches=1, verifications=1, gate_checks=1, lost_frames=20,
                 relocalizations=0, live_centre_err_m=0.006322616711258888,
                 tail_mean_err_m=0.0032337591983377934)
MERGE_LIVE_MARGIN, MERGE_TAIL_MARGIN = 0.02, 0.03
# host reads of the reference's merge path, counted in its code
# (slam/map_merging.py): the candidate search reads its scores (1); a
# verification its PnP and tracking-refinement inlier counts (2); the gate the
# live rotation and translation, the transform's rotation twice and its
# translation, the new map's keyframe rotations and translations (7); an
# executed merge the landmark overflow, the keyframe count and the
# keyframe remap three times (5); shelving a map the live pose (2)
MERGE_REF_READS = dict(detect_merge_candidate=1, verify_merge=2, _merge_gate_allows=7,
                       merge_into_shelved=5, _create_map_in_atlas=2)
# H100 SXM (NVIDIA data sheet, 700 W): HBM3 at 3.35 TB/s, and 67 TFLOP/s
# fp32 on the CUDA cores, which counts an FMA as two: 33.5 T fp32
# instructions/s (132 SMs x 128 lanes x 1.98 GHz), also the rate at which
# the SMs issue instructions of any type. Per SM and clock the INT32 pipe
# (add, logic, shift, compare) takes 64 lanes and POPC 16 (CUDA C++
# Programming Guide, arithmetic instruction throughput, cc 9.0).
HBM_BYTES_PER_S = 3.35e12
INSTR_ISSUE_RATE = 33.5e12
OPS_PER_S = {"fp32": 33.5e12, "int32": 16.75e12, "popc": 4.19e12}
# launches of each kernel per tracked frame: process_stereo's FAST
# (ops/orb.py) and its two patch gathers (ops/orb.py, ops/stereo.py), the
# stereo band match (ops/stereo.py) and tracking's three projection
# searches (slam/tracking.py)
LAUNCHES_PER_FRAME = {"fast_nms": 1, "gather_patches": 2, "masked_best2": 4}

# Edge cases of the kernels, checked exactly in phase 1 and by
# tests/test_torch_cuda.py. Matcher: (N, M, byte offset of the mask);
# M % 16 != 0 and the offset mask start rows off a 16-byte boundary, every
# case has an all-masked row (row 0 when N > 1), a one-column row and
# tied distances; N = 1 rows are random or one-column.
MATCH_EDGE_CASES = ((257, 130, 0), (300, 1201, 0), (1, 1201, 0), (1, 130, 0), (64, 1200, 3))
# FAST+NMS: (H, W of level 0, padded width, th_hi, th_lo) over 4 levels and
# 2 views of blocky integer-valued images (tied scores); padded widths are
# multiples of 4 (the kernel's float4 rows) but not of the 128-px tile, 97
# and 120 rows no multiple of the 16-row tile, and the level extents end
# inside tiles. The last case has th_hi < th_lo.
FAST_EDGE_CASES = ((120, 200, 204, 20.0, 7.0), (120, 200, 260, 20.0, 7.0),
                   (97, 301, 304, 7.0, 20.0))
# Patch gather: (R, W, K, ph, pw, row corner type, column corner type), raw
# corners. The first four of a case lie past the top, bottom, left and right
# edges, and int64 ones include -2^40 and 2^40, which a clamp after a cast
# to int32 gets wrong. K = 0, 1 and counts that are no multiple of the
# kernel's 4 keypoints per block; the main path's two patch shapes at
# widths 128 and 131 (no multiple of 4); ph = R with pw = W; a 3-wide patch,
# whose float4 stores span rows.
GATHER_EDGE_CASES = ((300, 128, 97, 48, 45, "int64", "int32"), (300, 131, 97, 48, 45, "int32", "int32"),
                     (200, 131, 5, 11, 21, "int64", "int64"), (200, 128, 1, 11, 21, "int32", "int64"),
                     (60, 131, 0, 48, 45, "int32", "int32"), (48, 45, 7, 48, 45, "int64", "int64"),
                     (40, 128, 33, 40, 3, "int32", "int32"))


# the warning torch.cuda.set_sync_debug_mode("warn") gives at each call
# that waits on the device (the mode's own one-time notice that it is a
# prototype is not one)
SYNC_WARNING = "called a synchronizing CUDA operation"


def log(*a):
    print(*a, flush=True)


def device_ms(fn, runs=TIMING_RUNS, reps=5):
    """Device milliseconds per call of ``fn()``: the median over ``reps`` of
    ``runs`` back-to-back calls between two CUDA events. A sleep kernel
    holds the stream while the host enqueues the calls, so the events time
    the device's work and not the host's wrapper. Returns (median, min, max)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    per_call = []
    for _ in range(reps):
        torch.cuda._sleep(int(max(2.0 * runs * host_s, 2e-4) * 2e9))  # ~2 GHz SM clock
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(runs):
            fn()
        e.record()
        torch.cuda.synchronize()
        per_call.append(s.elapsed_time(e) / runs)
    return statistics.median(per_call), min(per_call), max(per_call)


def device_events(prof):
    """(start µs, name, µs) of each device activity (kernel, copy, fill)
    that the profile ``prof`` recorded, read from the profiler's own
    records: building its FunctionEvent list costs ~60 µs of host time an
    event, seconds for a step of tens of thousands of operations."""
    from torch.autograd import DeviceType

    try:
        return [(e.start_ns() / 1e3, e.name(), e.duration_ns() / 1e3)
                for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    except AttributeError:  # a torch without these accessors
        return [(e.time_range.start, e.name, e.time_range.elapsed_us())
                for e in prof.events() if e.device_type == DeviceType.CUDA]


def profiled_device_ms(fn, reps=3, ops=False):
    """Device milliseconds of one call of ``fn()`` as torch.profiler's CUDA
    activity records it: the sum of the durations of the device work it
    put on the stream, the median over ``reps`` calls after a warm one.
    Unlike ``device_ms`` it needs no sleep kernel long enough to cover the
    host's enqueue, which a call of ~1,000 launches can outlast. With
    ``ops`` it returns (ms, the kernels, fills and copies the first of the
    calls ran on the device). Only the CUDA activity is recorded: recording
    the host's runtime calls as well cost about 0.4 ms of host time per
    operation, tens of seconds for a fisheye step."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times, n_ops = [], None
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        on_device = device_events(prof)
        times.append(sum(us for _, _, us in on_device) / 1e3)
        n_ops = len(on_device) if n_ops is None else n_ops
    return (statistics.median(times), n_ops) if ops else statistics.median(times)


def profiled_call(fn):
    """One call of a warm ``fn()`` under torch.profiler's CUDA activity
    alone: (the device ms of its work, the kernels, fills and copies it ran
    on the device, its result). Leaving the host activity out keeps a call
    of tens of thousands of operations to about its own time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    on_device = device_events(prof)
    return sum(us for _, _, us in on_device) / 1e3, len(on_device), out


def host_ms_behind_sleep(fn):
    """Host ms that one call of ``fn()`` takes while a SLEEP_MS sleep kernel
    holds the stream: about its enqueue time, or at least the sleep if the
    call waits on the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_MS * 1e-3 * 2e9))  # ~2 GHz SM clock
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host_ms


def launch_queue_capacity(limit=4096):
    """How many launches the host can queue behind a busy device before a
    launch blocks: empty kernels enqueued behind a SLEEP_MS sleep kernel,
    counted until one launch takes a quarter of the sleep."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

    _cuda.noop()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_MS * 1e-3 * 2e9))  # ~2 GHz SM clock
    n = limit
    for i in range(limit):
        t0 = time.perf_counter()
        _cuda.noop()
        if (time.perf_counter() - t0) * 1e3 > 0.25 * SLEEP_MS:
            n = i
            break
    torch.cuda.synchronize()
    return n


def graph_capture_error(fn):
    """None if one call of ``fn()`` can be captured in a CUDA graph, else
    the error. Capture refuses any call that waits on the stream or reads
    the device (``.item()``, a copy to or from pageable memory, a stream
    or event synchronization), so a call that captures makes no host read."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except Exception as e:  # the capture's verdict, reported by the caller
        torch.cuda.synchronize()
        return repr(e)[:300]
    del graph
    torch.cuda.synchronize()
    return None


def bound(nbytes, ops, **counts):
    """The least time the card could take: the larger of bytes over the HBM
    rate and the operations' time. ``ops`` maps an instruction type of
    OPS_PER_S to its count; each type takes at least its pipe's time and
    all of them at least the issue time. Returns both times, the bound and
    what sets it, plus ``counts`` (the data-dependent work)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max([n / OPS_PER_S[k] for k, n in ops.items()] + [sum(ops.values()) / INSTR_ISSUE_RATE])
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=1e3 * t_bytes, ops_ms=1e3 * t_ops, **counts)


def fast_nms_bound(flat, hs, ws, th_hi, th_lo):
    """Bytes: the three outputs over the whole stack, and each level's own
    pixels read once. Instructions on these inputs (fp32, int32): the
    compass pre-test and NMS at every level-interior pixel (32, 8); the
    bright/dark bits at min(th) and their run-of-9 tests where the compass
    test passes (48, 46); both thresholds' bits, their run tests and the
    four margin sums where those bits hold a run of 9 (272, 156)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import fast as fast_ops

    BN, Hp, Wp = flat.shape
    NL = len(hs)
    level_px = sum(int(h) * int(w) for h, w in zip(hs, ws)) * (BN // NL)
    inb = fast_ops.level_interior(tuple(int(v) for v in hs), tuple(int(v) for v in ws),
                                  3, Hp, Wp, flat.device).repeat(BN // NL, 1, 1)
    th = min(th_hi, th_lo)
    n_bright = n_dark = 0
    for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3)):
        d = fast_ops._shift(flat, dy, dx) - flat
        n_bright = n_bright + (d > th).int()
        n_dark = n_dark + (d < -th).int()
    interior = int(inb.sum())
    compass = int((inb & ((n_bright >= 2) | (n_dark >= 2))).sum())
    full = int((inb & (fast_ops.fast_scores_two(flat, th, th)[1] > 0)).sum())
    return bound(3 * flat.numel() * 4 + level_px * 4,
                 {"fp32": interior * 32 + compass * 48 + full * 272,
                  "int32": interior * 8 + compass * 46 + full * 156},
                 interior_px=interior, compass_px=compass, full_test_px=full)


def gather_bound(img2d, rows, cols, ph, pw):
    """Bytes: the corners, the image pixels that the clamped patches cover,
    each read once however many patches overlap it, and every patch pixel
    written once."""
    R, Wi = img2d.shape
    r = torch.clamp(rows, 0, R - ph).long()
    c = torch.clamp(cols, 0, Wi - pw).long()
    # the patches' rectangles as a 2-D difference array, summed along both axes
    d = torch.zeros((R + 1, Wi + 1), dtype=torch.int32, device=img2d.device)
    for dr, dc, sign in ((0, 0, 1), (0, pw, -1), (ph, 0, -1), (ph, pw, 1)):
        d.index_put_((r + dr, c + dc), torch.full(r.shape, sign, dtype=torch.int32, device=r.device),
                     accumulate=True)
    covered = int((d.cumsum(0).cumsum(1)[:R, :Wi] > 0).sum())
    K = rows.shape[0]
    return bound(K * (rows.element_size() + cols.element_size()) + covered * 4 + K * ph * pw * 4, {},
                 covered_px=covered)


def matcher_bound(a, b, m):
    """Bytes: mask, both descriptor sets, three outputs. Instructions: per
    allowed pair 8 POPC and 17 int32 (8 XOR, 7 adds, 2 compares), and one
    int32 compare per 4 mask bytes."""
    N, M = m.shape
    allowed = int(m.sum())
    return bound(N * M + a.numel() * 4 + b.numel() * 4 + N * 12,
                 {"popc": 8 * allowed, "int32": 17 * allowed + N * M // 4},
                 allowed_pairs=allowed)


def matcher_edge_inputs(n, m, offset, dev):
    """Packed descriptors and a mask for one of MATCH_EDGE_CASES."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb

    rng = np.random.default_rng(n * 10007 + m + offset)
    pool = rng.random((16, 256)) > 0.5  # B repeats 16 descriptors: ties
    a = rng.random((n, 256)) > 0.5
    b = pool[rng.integers(0, 16, size=m)]
    mask = rng.random((n, m)) > 0.7
    if n > 1:
        mask[0] = False               # no allowed column
        mask[1] = False
        mask[1, m - 1] = True         # one column: the last (a scalar tail's when unaligned)
    elif m < 1000:
        mask[0] = False
        mask[0, 67] = True            # a one-column single row
    pack = lambda x: orb.pack_descriptors(torch.from_numpy(x.astype(np.uint8)).to(dev))
    buf = torch.zeros(n * m + offset, dtype=torch.bool, device=dev)
    buf[offset:] = torch.from_numpy(mask.reshape(-1)).to(dev)
    return pack(a), pack(b), buf[offset:].view(n, m)


def fast_edge_inputs(h, w, wp, dev):
    """A [8, h, wp] stack of 4 levels x 2 views for one of FAST_EDGE_CASES:
    blocky integer-valued images, zero outside each level. Returns
    (flat, hs, ws)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid

    rng = np.random.default_rng(h * 1009 + wp)
    shapes = pyramid.level_shapes(h, w, 4, 1.2)
    flat = np.zeros((8, h, wp), np.float32)
    for i in range(8):
        hl, wl = shapes[i % 4]
        blocks = rng.integers(0, 256, size=(hl // 5 + 1, wl // 5 + 1))
        flat[i, :hl, :wl] = np.kron(blocks, np.ones((5, 5)))[:hl, :wl] + rng.integers(0, 12, (hl, wl))
    return torch.from_numpy(flat).to(dev), [s[0] for s in shapes], [s[1] for s in shapes]


def gather_edge_inputs(R, W, K, ph, pw, row_type, col_type, dev):
    """A random [R, W] image and raw corners for one of GATHER_EDGE_CASES.
    Returns (img, rows, cols, ph, pw), the gather's arguments."""
    rng = np.random.default_rng(R * 7919 + W * 31 + K)
    img = rng.random((R, W)).astype(np.float32)
    rows = rng.integers(-ph, R + 5, size=K)
    cols = rng.integers(-pw, W + 5, size=K)
    n = min(K, 4)  # past the top, the bottom, the left and the right edge
    rows[:n] = (-7, R - ph + 9, R // 3, R // 2)[:n]
    cols[:n] = (W // 3, W // 2, -9, W - pw + 4)[:n]
    if K > 5:
        if row_type == "int64":
            rows[4] = -(2 ** 40)
        if col_type == "int64":
            cols[5] = 2 ** 40
    as_t = lambda a, t: torch.from_numpy(a.astype(t)).to(dev)
    return torch.from_numpy(img).to(dev), as_t(rows, row_type), as_t(cols, col_type), ph, pw


def main_path_checks(calls, label=""):
    """The timed checks of the kernel calls recorded on a main path
    (``calls``: kernel -> argument tuples): (kernel, case, wrapper, plain,
    args, bound, library call or None). The matcher's tracking calls come
    first: theirs is the main path's shape."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_fast, cuda_gather, cuda_matching

    checks = []
    for flat, hs, ws, th_hi, th_lo in calls["fast_nms"]:
        checks.append(("fast_nms", label + "x".join(map(str, flat.shape)), cuda_fast.fast_nms,
                       cuda_fast.fast_nms_plain, (flat, hs, ws, th_hi, th_lo),
                       fast_nms_bound(flat, hs, ws, th_hi, th_lo), None))
    for img2d, rows, cols, ph, pw in calls["gather_patches"]:
        # kernel and plain version take the raw corners, as the main path
        # hands them; the library call gets them clamped, as int64
        ri = torch.clamp(rows, 0, img2d.shape[0] - ph).long()
        ci = torch.clamp(cols, 0, img2d.shape[1] - pw).long()
        library = lambda _i=img2d, _r=ri, _c=ci, _ph=ph, _pw=pw: _i.unfold(0, _ph, 1).unfold(1, _pw, 1)[_r, _c]
        checks.append(("gather_patches", label + f"{tuple(img2d.shape)} K={rows.shape[0]} {ph}x{pw} "
                       f"corners {rows.dtype}/{cols.dtype}".replace("torch.", ""),
                       cuda_gather.gather_patches, cuda_gather.gather_patches_plain,
                       (img2d, rows, cols, ph, pw), gather_bound(img2d, rows, cols, ph, pw), library))
    for a, b, m in sorted(calls["masked_best2"], key=lambda c: -c[0].shape[0]):
        for d in (a, b):  # the main path hands the kernel packed descriptors
            if d.dtype != torch.int32 or d.shape[-1] != 8 or not d.is_contiguous():
                raise AssertionError(f"matcher given {d.dtype} {tuple(d.shape)}, not packed int32 [.,8]")
        checks.append(("masked_best2", label + f"{a.shape[0]}x{b.shape[0]} geometric mask",
                       cuda_matching.fused_masked_best2, cuda_matching.fused_masked_best2_plain,
                       (a, b, m), matcher_bound(a, b, m), None))
    return checks


@contextlib.contextmanager
def recording_kernel_calls(calls):
    """Within the block each kernel wrapper's arguments are appended to
    ``calls[kernel]``; its launches still count on the wrapper."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_fast, cuda_gather, cuda_matching

    wrapped = ((cuda_fast, "fast_nms", "fast_nms"), (cuda_gather, "gather_patches", "gather_patches"),
               (cuda_matching, "fused_masked_best2", "masked_best2"))
    originals = {}
    for mod, name, key in wrapped:
        fn = originals[key] = getattr(mod, name)

        def spy(*args, _fn=fn, _key=key):
            calls.setdefault(_key, []).append(args)
            return _fn(*args)

        spy.launches = 0  # the wrapper counts through its module name: the spy, here
        setattr(mod, name, spy)
    try:
        yield
    finally:
        for mod, name, key in wrapped:
            spy = getattr(mod, name)
            setattr(mod, name, originals[key])
            originals[key].launches += spy.launches


# set once the profiler has lost the brackets of a call in every attempt
_PROFILER_LOST_BRACKETS = []


def device_kernels(fn, attempts=3):
    """Names of the device activities (kernels, copies, fills) that one call
    of ``fn()`` puts on the card, as torch.profiler's CUDA activity records
    them. An empty kernel before and one after bracket the call, each a few
    host milliseconds apart: the profiler can drop a short kernel at the
    edge of its capture window, so it must report both brackets, and what
    lies between them is the call's. A capture that lost a bracket is
    taken again, up to ``attempts`` times; if none kept both, the call's
    device work is counted in a CUDA graph (``graph_device_nodes``), and so
    is every later call's."""
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

    names = []
    for _ in range(0 if _PROFILER_LOST_BRACKETS else attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for f in (_cuda.noop, fn, _cuda.noop):
                time.sleep(0.005)
                f()
                torch.cuda.synchronize()
            time.sleep(0.005)
        names = [name for _, name, _ in sorted(device_events(prof))]
        if len(names) >= 2 and "noop_kernel" in names[0] and "noop_kernel" in names[-1]:
            return names[1:-1]
        time.sleep(0.5)
    # the profiler recorded no bracket in any attempt: count the call's
    # device work in a CUDA graph instead, whose nodes are what one call puts
    # on the stream (no names there). A profiler that lost them once lost
    # them in every later call of the process (each loss cost three
    # captures and 1.5 s of waits), so later calls go to the graph at once.
    if not _PROFILER_LOST_BRACKETS:
        _PROFILER_LOST_BRACKETS.append(len(names))
        log(f"  the profiler recorded {names} around the call {attempts} times; counting its device work "
            "in a CUDA graph, here and in every later call")
    return [f"{kind} (CUDA graph node)" for kind in graph_device_nodes(fn)]


# CUgraphNodeType values of the device work a stream call can put in a graph
GRAPH_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_device_nodes(fn):
    """The kinds of the device nodes (kernel, memcpy, memset) of one call
    of ``fn()`` captured in a CUDA graph, in ``cuGraphGetNodes``' order."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream, as torch asks
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if libcuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        if libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value in GRAPH_NODE_KINDS:
            kinds.append(GRAPH_NODE_KINDS[kind.value])
    del graph
    torch.cuda.synchronize()
    return kinds


def build_baseline(csrc):
    """The kernels of an earlier ``csrc/`` (the same C entries), built with
    one nvcc into a library of their own and loaded."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

    out = os.path.join(_cuda.BUILD_DIR, "baseline")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libosk_baseline.so")
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", csrc, "-o", so,
           *sorted(glob.glob(os.path.join(csrc, "*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline nvcc failed:\n{proc.stderr[-4000:]}")
    return _cuda.bind(ctypes.CDLL(so))


@contextlib.contextmanager
def launching_from(lib):
    """Within the block every wrapper launches ``lib``'s kernels."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import _cuda

    def launch(name, *args):
        err = getattr(lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"baseline {name}: CUDA error {err}")

    saved, _cuda.launch = _cuda.launch, launch
    try:
        yield
    finally:
        _cuda.launch = saved


def camera(dev):
    """The pinhole intrinsics [fx, fy, cx, cy] of the sequence."""
    return torch.tensor([FX, FX, W / 2.0, H / 2.0], dtype=torch.float32, device=dev)


def render_sequence(n, cam):
    """The strafe sequence on ``cam``'s device: ground-truth camera-to-world
    rotations and centres (numpy, per frame) and ``n`` stereo pairs."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic

    dev = cam.device
    scene = synthetic.default_scene(dev)
    Rs, ts = synthetic.make_trajectory(n, "strafe", speed=SPEED)
    frames = []
    for i in range(n):
        il, ir, _ = synthetic.stereo_pair(cam, torch.from_numpy(Rs[i]).to(dev),
                                          torch.from_numpy(ts[i]).to(dev), BASELINE, scene, h=H, w=W)
        frames.append((il, ir))
    return Rs, ts, frames


def init_map(il, ir, cam, R_wc, t_wc):
    """The map from one stereo pair (process_stereo + make_keyframe) at the
    ground-truth pose (R_wc, t_wc). Returns (frame, map, R_cw, t_cw)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend, map_state as msx, tracking

    dev = il.device
    frame0 = frontend.process_stereo(il, ir, BASELINE * FX, n_features=N_FEATURES, cell=CELL)
    ms = msx.empty_map(MAX_KF, frame0.n, MAX_LM, device=dev)
    R0 = torch.from_numpy(R_wc.T.copy()).to(dev)
    t0 = -R0 @ torch.from_numpy(t_wc).to(dev)
    ms = tracking.make_keyframe(
        ms, frame0, R0, t0, 0.0, 0, torch.full((ms.L,), -1, dtype=torch.int32, device=dev),
        cam.to(dev), float("inf"),
    )
    return frame0, ms, R0, t0


def step(ms, il, ir, state, cam):
    """One tracked frame: ``full_frame_step`` from ``state`` (R, t, vR, vt,
    has_velocity) on the pair's device."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking

    return tracking.full_frame_step(
        ms, il, ir, *state, cam.to(il.device), BASELINE * FX, W, H,
        n_features=N_FEATURES, cell=CELL, min_inliers=MIN_INLIERS,
    )


def loop_config(small=False, closure=False):
    """The port's SLAMConfig of the SLAM loop: bench.py's stereo setup, or
    (small) the 240x376 / 600-feature geometry of tests/test_slam_e2e.py
    with 8 keyframe slots (so capacity reclaim runs), a keyframe every
    second frame (kf_ref_ratio 0.5, so that the frame gap decides every
    insertion) and synchronous decisions. ``closure`` (with ``small``):
    the small loop-closure pass (SMALL_CLOSURE) -- 32 keyframe slots, a
    keyframe at least every 7 frames, so that a keyframe's mapping and loop
    slices drain before the next one and its BoW row is in the database
    when its detection runs, and synchronous decisions."""
    from orb_slam3_detailed_comments_kor_tpu_torch.config import (
        CameraConfig, CapacityConfig, ORBConfig, SLAMConfig, SensorType, TrackingConfig,
    )

    if small:
        h, w, fx = 240, 376, 230.0
        return SLAMConfig(
            sensor=SensorType.STEREO,
            camera=CameraConfig(width=w, height=h, fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
                                bf=BASELINE * fx, th_depth=35.0),
            orb=ORBConfig(n_features=600, cell_size=24),
            capacity=CapacityConfig(max_keyframes=32 if closure else 8, max_landmarks=4096,
                                    max_local_landmarks=2048),
            tracking=(TrackingConfig(max_frames_between_kf=7, decision_batch=1) if closure else
                      TrackingConfig(max_frames_between_kf=2, kf_ref_ratio=0.5, decision_batch=1)),
        )
    return SLAMConfig(
        sensor=SensorType.STEREO,
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=BASELINE * FX),
        orb=ORBConfig(n_features=N_FEATURES, cell_size=CELL),
        capacity=CapacityConfig(max_keyframes=MAX_KF, max_landmarks=MAX_LM, max_local_landmarks=4096),
        tracking=TrackingConfig(max_frames_between_kf=10),
    )


def render_loop_sequence(cfg, n, dev, motion="strafe", speed=SPEED):
    """The ``motion`` sequence (strafe, or outback: out and back along x)
    at ``cfg``'s camera on ``dev``: ground-truth centres [n, 3] (numpy)
    and n stereo pairs."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic

    c = cfg.camera
    cam = torch.tensor([c.fx, c.fy, c.cx, c.cy], dtype=torch.float32, device=dev)
    scene = synthetic.default_scene(dev)
    Rs, ts = synthetic.make_trajectory(n, motion, speed=speed)
    frames = [synthetic.stereo_pair(cam, torch.from_numpy(Rs[i]).to(dev), torch.from_numpy(ts[i]).to(dev),
                                    BASELINE, scene, h=c.height, w=c.width)[:2] for i in range(n)]
    return ts, frames


def inject_drift(slam, mag=0.35, yaw=0.03):
    """bench.py's ``_inject_drift`` on the port's map: the newest third of
    the keyframes, their landmarks and the live pose warped by a rigid
    drift; late keyframes' observations of early landmarks cleared, so the
    drifted submap is self-consistent and covisibility-disconnected from
    the early map (the state a long drifting circuit leaves)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie

    ms = slam.ms
    cut = 2 * slam.n_kf // 3
    K = ms.K
    dev = ms.kf_t_cw.device
    R_d, t_d = lie.se3_exp(torch.tensor([0.0, yaw, 0.0, mag * 0.7, mag * 0.7, 0.0], device=dev))
    Rd_i, td_i = lie.se3_inverse(R_d, t_d)
    late_kf = torch.arange(K, device=dev) >= cut
    R_new, t_new = lie.se3_compose(ms.kf_R_cw, ms.kf_t_cw, Rd_i.expand(K, 3, 3), td_i.expand(K, 3))
    late_lm = ms.lm_valid & (ms.lm_first_kf >= cut)
    X_new = ms.lm_pos @ R_d.T + t_d
    early_lm_obs = (ms.obs_lm >= 0) & (ms.lm_first_kf[torch.clamp(ms.obs_lm, min=0).long()] < cut)
    clear = late_kf[:, None] & early_lm_obs
    slam.ms = ms._replace(
        kf_R_cw=torch.where(late_kf[:, None, None], R_new, ms.kf_R_cw),
        kf_t_cw=torch.where(late_kf[:, None], t_new, ms.kf_t_cw),
        lm_pos=torch.where(late_lm[:, None], X_new, ms.lm_pos),
        obs_lm=torch.where(clear, -1, ms.obs_lm),
    )
    slam.R_cw, slam.t_cw = lie.se3_compose(slam.R_cw, slam.t_cw, Rd_i, td_i)
    slam.has_velocity = False


def run_loop(cfg, frames, dev, on_frame=None, timer=False, loop_closing=True, inject_at=None,
             min_gap=None):
    """Feed ``frames`` to a new SlamSystem on ``dev``. ``on_frame(i, slam,
    call)`` may wrap each frame's ``call()``; ``timer`` turns on the
    system's host stage timer; ``loop_closing`` sets
    ``enable_loop_closing``; at frame ``inject_at`` the deferred decisions
    are flushed and ``inject_drift`` applied first (bench.py's loop pass);
    ``min_gap`` overrides the loop closer's keyframe gap. Returns (slam,
    the frames at which a keyframe was inserted)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.timing import StageTimer

    slam = SlamSystem(cfg, device=dev)
    slam.timer = StageTimer(enabled=timer)
    slam.enable_loop_closing = loop_closing
    if min_gap is not None:
        slam.loop_closer.min_gap = min_gap
    kf_at = []
    for i, (il, ir) in enumerate(frames):
        if i == inject_at:
            slam.flush_decisions()
            inject_drift(slam)
        n0 = slam.stats["kf_inserted"]
        call = lambda _i=i, _l=il, _r=ir: slam.track_stereo(_l, _r, _i / FPS)
        on_frame(i, slam, call) if on_frame else call()
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
    return slam, kf_at


def trajectory_diff(traj_a, traj_b):
    """Per-frame camera-centre distances (m) and rotation angles (rad)
    between two ``trajectory_arrays()`` results."""
    dc = np.linalg.norm(traj_a[1].astype(np.float64) - traj_b[1], axis=1)
    M = np.einsum("tji,tjk->tik", traj_a[2].astype(np.float64), traj_b[2].astype(np.float64))
    skew = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1)
    return dc, np.arcsin(np.clip(np.linalg.norm(skew, axis=1) / 2.0, 0.0, 1.0))


def max_abs_err(a, b):
    """Largest |a - b| over a pair of tensors or of tuples of tensors."""
    if isinstance(a, torch.Tensor):
        a, b = (a,), (b,)
    return max(
        float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
        for x, y in zip(a, b)
    )


def rotation_angle(Ra, Rb):
    """Angle between two near-equal rotations, from the skew part of
    Raᵀ·Rb (arccos of the trace loses ~1e-4 rad to float32 rounding)."""
    M = Ra.double().T @ Rb.double()
    skew = torch.stack([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(torch.asin(torch.clamp(torch.linalg.vector_norm(skew) / 2.0, max=1.0)))


def run_checks(checks, counters, per_kernel, base_lib=None):
    """Hold each kernel against its plain version on each case of
    ``checks`` (exact equality, one launch per call) and, for a timed case,
    check that one wrapper call puts exactly one device kernel on the
    stream and time the kernel, the plain version and the library call.
    Results go into ``per_kernel[name]``. A case of the same kernel and
    kind (its label after the frame prefix: the shape and mask) as one
    timed earlier in ``checks`` -- the tracking stages of one frame -- is
    held exactly and counted, not timed again."""
    timed = set()
    for key, case, kern, plain, args_, bnd, library in checks:
        before = counters[key].launches
        out_k = kern(*args_)
        torch.cuda.synchronize()
        # one launch per call; a gather of no keypoints launches nothing
        want = 0 if key == "gather_patches" and args_[1].shape[0] == 0 else 1
        if counters[key].launches - before != want:
            raise AssertionError(f"{key} {case}: {counters[key].launches - before} launches, expected {want}")
        out_p = plain(*args_)
        torch.cuda.synchronize()
        for x, y in zip(*((o,) if isinstance(o, torch.Tensor) else o for o in (out_k, out_p))):
            if x.shape != y.shape or x.dtype != y.dtype:
                raise AssertionError(f"{key} {case}: kernel gives {x.dtype} {tuple(x.shape)}, "
                                     f"plain version {y.dtype} {tuple(y.shape)}")
        err = max_abs_err(out_k, out_p)
        if err != 0.0:
            raise AssertionError(f"{key} {case}: kernel differs from its plain version (max |err| {err})")
        if key == "fast_nms" and bnd is None and int((out_p[1] > 0).sum()) < 100:
            raise AssertionError(f"{key} {case}: too few corners to test anything")
        entry = per_kernel.setdefault(key, dict(max_abs_err=0.0, cases=[], edge_cases=0, repeat_cases=0))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if bnd is None:
            entry["edge_cases"] += 1
            log(f"  {key} {case}: exact")
            continue
        if (key, case.split(": ")[-1]) in timed:
            entry["repeat_cases"] += 1
            log(f"  {key} {case}: exact (timed above)")
            continue
        timed.add((key, case.split(": ")[-1]))
        # the call's device work is its one kernel, so `ms` times the call
        on_device = device_kernels(lambda: kern(*args_))
        if len(on_device) != 1:
            raise AssertionError(f"{key} {case}: one wrapper call put {len(on_device)} device "
                                 f"activities on the stream, expected its kernel alone: {on_device}")
        row = dict(case=case, device_kernel=on_device[0], device_kernels=len(on_device), **bnd)
        if base_lib is not None:  # in turns: baseline, current, current, baseline
            def base():
                with launching_from(base_lib):
                    return kern(*args_)

            if max_abs_err(base(), out_p) != 0.0:
                raise AssertionError(f"{key} {case}: baseline kernel differs from the plain version")
            b1, k1, k2, b2 = (device_ms(f) for f in (base, lambda: kern(*args_),
                                                    lambda: kern(*args_), base))
            row["ms"] = statistics.median([k1[0], k2[0]])
            row["ms_range"] = [min(k1[1], k2[1]), max(k1[2], k2[2])]
            row["baseline_ms"] = statistics.median([b1[0], b2[0]])
            row["baseline_ms_range"] = [min(b1[1], b2[1]), max(b1[2], b2[2])]
        else:
            k = device_ms(lambda: kern(*args_))
            row["ms"], row["ms_range"] = k[0], [k[1], k[2]]
        row["plain_ms"] = device_ms(lambda: plain(*args_))[0]
        row["library_ms"] = None
        if library is not None:
            lib_err = max_abs_err(library(), out_p)
            if lib_err != 0.0:
                raise AssertionError(f"{key} {case}: the library call differs from the plain version")
            row["library_ms"] = device_ms(library)[0]
        entry["cases"].append(row)
        base_txt = f", baseline {row['baseline_ms']:.4f} ms" if "baseline_ms" in row else ""
        lib_txt = f", library {row['library_ms']:.4f} ms" if row["library_ms"] is not None else ""
        log(f"  {key} {case}: exact; kernel {row['ms']:.4f} ms ({row['ms_range'][0]:.4f}-"
            f"{row['ms_range'][1]:.4f}){base_txt}, plain {row['plain_ms']:.4f} ms{lib_txt}, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; bytes {bnd['bytes_ms']:.4f}, "
            f"ops {bnd['ops_ms']:.4f}) "
            + " ".join(f"{k} {v}" for k, v in bnd.items() if k.endswith(("_px", "_pairs"))))


def loop_closure_pass(cfg, frames, dev, counters):
    """Phase 6's timed pass: ``frames`` through a new SlamSystem (loop
    closing on) with bench.py's drift injected at LOOP6_INJECT_AT, blocking
    on each frame's pose. Every frame runs under the sync debug mode with
    the batched decision read and the delayed detection read (the pinned
    copies behind events) left out, so each synchronizing call counted is a
    host read of a value. Records per frame the slice it serviced, its
    wall ms, its synchronizing calls and the loop calls in it, the
    ``masked_best2`` inputs of each hypothesis refinement, the arguments
    of each correction, and the launches of each kernel over the pass."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_matching
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.host_read import HostRead

    rec = dict(frames=[], refine_inputs=[], corrections=[], calls={})
    cur = {}
    lc_cls = loop_closing.LoopCloser
    saved = {n: getattr(lc_cls, n) for n in ("verify", "hypothesis_step", "correct", "gba_chunk")}
    saved_refine = loop_closing._refine_hyp_core
    saved_numpy = HostRead.numpy
    counting = False

    def counted(name):
        def wrapper(self, *a, **k):
            cur[name] = cur.get(name, 0) + 1
            if name == "correct":
                rec["corrections"].append(dict(ms=a[0], args=a[1:], kwargs=k, frame=cur["frame"]))
            return saved[name](self, *a, **k)
        return wrapper

    def refine(*a, **k):
        # record the matcher's inputs at this call; its launches still count
        spy_calls = []
        kern = cuda_matching.fused_masked_best2

        def spy(*args):
            spy_calls.append(args)
            return kern(*args)

        spy.launches = 0  # the wrapper counts through its module name: the spy, here
        cuda_matching.fused_masked_best2 = spy
        try:
            return saved_refine(*a, **k)
        finally:
            cuda_matching.fused_masked_best2 = kern
            kern.launches += spy.launches
            rec["refine_inputs"].extend(spy_calls)

    def unwatched_numpy(self):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return saved_numpy(self)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    for name in saved:
        setattr(lc_cls, name, counted(name))
    loop_closing._refine_hyp_core = refine
    HostRead.numpy = unwatched_numpy

    def on_frame(i, slam, call):
        nonlocal counting
        if not counting:  # count this system's drift-gate and lost-path calls
            counting = True
            count_system_calls(slam, cur)
        kind = slam._bg_queue[0][0] if slam._bg_queue else (
            "gba_chunk" if slam._gba_chunks_left > 0 else "tracking")
        cur.clear()
        cur["frame"] = i
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        slam.t_cw.cpu()  # block on the frame's pose, as bench.py's latency pass does
        ms_wall = (time.perf_counter() - t0) * 1e3
        syncs = [str(w.message).splitlines()[0] for w in caught if SYNC_WARNING in str(w.message)]
        calls = {k: v for k, v in cur.items() if k != "frame"}
        for k, v in calls.items():
            rec["calls"][k] = rec["calls"].get(k, 0) + v
        rec["frames"].append(dict(frame=i, kind=kind, ms=ms_wall, syncs=len(syncs),
                                  sync_calls=sorted(set(syncs))[:3], calls=calls, state=slam.state))

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    try:
        slam, kf_at = run_loop(cfg, frames, dev, on_frame, timer=True, inject_at=LOOP6_INJECT_AT)
    finally:
        for name, fn in saved.items():
            setattr(lc_cls, name, fn)
        loop_closing._refine_hyp_core = saved_refine
        HostRead.numpy = saved_numpy
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return slam, kf_at, rec


def local_ba_spread(slice_fn, ms_in):
    """The largest differences between two runs of a local-BA slice on the
    same inputs: pose translations (m), rotation entries, landmark
    positions (m) and the number of observation slots that differ; all 0
    when the slice is deterministic."""
    a, b = slice_fn(), slice_fn()
    moved = int((a.obs_lm != ms_in.obs_lm).sum()) + int((a.lm_pos != ms_in.lm_pos).any(-1).sum())
    if moved == 0:
        raise AssertionError("the local-BA slice changed nothing: no spread to measure")
    return dict(pose_t_m=max_abs_err(a.kf_t_cw, b.kf_t_cw), pose_R=max_abs_err(a.kf_R_cw, b.kf_R_cw),
                points_m=max_abs_err(a.lm_pos, b.lm_pos), obs_differ=int((a.obs_lm != b.obs_lm).sum()))


def count_system_calls(slam, cur, more=()):
    """Count into ``cur`` the calls of ``slam``'s drift gate ("gate"), its
    lost path ("lost", "relocalize_in", "reloc_attempt", and "relocalized"
    for each successful relocalization) and the (method, key) pairs of
    ``more``."""
    for name, key in (("_loop_gate_allows", "gate"), ("_relocalize_in", "relocalize_in"),
                      ("_reloc_attempt", "reloc_attempt"), ("_handle_lost", "lost"), *more):
        def counted_method(*a, _fn=getattr(slam, name), _key=key, **k):
            cur[_key] = cur.get(_key, 0) + 1
            return _fn(*a, **k)
        setattr(slam, name, counted_method)

    def counted_relocalize(frame, _fn=slam._relocalize):
        ok = _fn(frame)
        cur["relocalized"] = cur.get("relocalized", 0) + int(ok)
        return ok
    slam._relocalize = counted_relocalize


def loop_host_read_allowance(calls):
    """The host reads the reference makes in a frame with these calls: one
    per verification and per hypothesis step (the inlier count), one per
    drift-gate check (the pose segment), two per correction (its log line),
    one per GBA chunk (its cost), and on the lost path two per map searched
    for relocalization (the BoW scores, the covisibility) and two per
    candidate tried (the PnP and the guided-tracking inlier counts)."""
    return (calls.get("verify", 0) + calls.get("hypothesis_step", 0) + calls.get("gate", 0)
            + 2 * calls.get("correct", 0) + calls.get("gba_chunk", 0)
            + 2 * calls.get("relocalize_in", 0) + 2 * calls.get("reloc_attempt", 0))


#: tests/test_dist_ba.py's distributed-versus-single bounds: poses and
#: points (m), velocities (m/s)
DIST_BOUNDS = dict(pose_m=2e-3, point_m=5e-3, vel=2e-2)


def sharded_record(one_device, one_call, four_call, fields, bounds, moved_from):
    """Hold a sharded solve to its one-device solve: ``one_call()`` (one
    shard of the card) must give the bits of ``one_device``, two
    ``four_call()``s (four shards) the same bits, within ``bounds`` (a
    bound per field) of one shard. ``fields`` maps a name to a function of
    a call's result that picks a tensor. Returns (record, failures, the
    first four-shard result)."""
    t0 = time.time()
    four_a = four_call()  # the four-shard shapes' warm-up (the one-device solve warmed one shard's)
    prof_one, prof_four = profiled_call(one_call), profiled_call(four_call)
    one, four_b = prof_one[2], prof_four[2]
    rec = dict(
        one_shard_equals_one_device={k: torch.equal(f(one_device), f(one)) for k, f in fields.items()},
        four_shards_repeat={k: torch.equal(f(four_a), f(four_b)) for k, f in fields.items()},
        four_vs_one={k: max_abs_err(f(four_a), f(one)) for k, f in fields.items()},
        moved_m=max_abs_err(fields["t_cw"](one), moved_from),
        device_ms=dict(one_shard=prof_one[0], four_shards=prof_four[0]),
        device_ops=dict(one_shard=prof_one[1], four_shards=prof_four[1]),
        seconds=time.time() - t0,
    )
    bad = [f"{k}: one shard is not the one-device solve" for k, v in rec["one_shard_equals_one_device"].items()
           if not v]
    bad += [f"{k}: two four-shard solves differ" for k, v in rec["four_shards_repeat"].items() if not v]
    bad += [f"{k}: four shards {rec['four_vs_one'][k]} from one" for k, b in bounds.items()
            if not rec["four_vs_one"][k] <= b]
    if not rec["moved_m"] > 0.0:
        bad.append("the sharded solve did not move the map")
    return rec, bad, four_a


def sharded_gba(ms, cam, bf, chunk, dev):
    """Phase 6's sharded GBA on the pass's map (see the module docstring);
    ``chunk`` is the one-device ``global_ba`` slice's map (iters=2)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_ba
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing

    obs, fixed_pose, fixed_point = loop_closing.map_observations(ms)
    valid = ms.lm_valid

    def one_call():
        R, t, X = dist_ba.distributed_bundle_adjust_cg([dev], ms.kf_R_cw, ms.kf_t_cw, ms.lm_pos, obs, fixed_pose,
                                                        fixed_point, cam, bf, iters=2, cg_iters=24)
        return ms._replace(kf_R_cw=R, kf_t_cw=t, lm_pos=X), None

    def four_call():
        loop_closing._GBA_MESH = [dev] * 4
        try:
            return loop_closing.global_ba(ms, cam, bf, iters=2)
        finally:
            loop_closing._GBA_MESH = None

    fields = {"R_cw": lambda r: r[0].kf_R_cw, "t_cw": lambda r: r[0].kf_t_cw, "points": lambda r: r[0].lm_pos[valid]}
    rec, bad, four = sharded_record((chunk, None), one_call, four_call, fields,
                                    dict(t_cw=DIST_BOUNDS["pose_m"], points=DIST_BOUNDS["point_m"]), ms.kf_t_cw)
    if four[1] is not None:
        bad.append("the four-shard GBA returned a cost")
    return rec, bad


def phase6(dev, counters, per_kernel, smi):
    """Phase 6: bench.py's loop-closure pass at bench scale (see the module
    docstring). Prints its JSON line, raises on a failed check, holds
    ``masked_best2`` against its plain version at the hypothesis
    refinement's recorded inputs (into ``per_kernel``) and returns the
    pass's record."""
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
    from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_matching
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend, loop_closing
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as slam_mod

    cfg = loop_config()

    t_p6 = time.time()
    gt6, frames6 = render_loop_sequence(cfg, LOOP6_FRAMES, dev, "outback", LOOP6_SPEED)
    voc.load_default(dev)  # the vocabulary's upload, once per process
    # a warm-up pass over the sequence's first frames (the loop path's
    # libraries were loaded by the phases before; the whole injected
    # sequence was cut to fit the script's time)
    warm, _ = run_loop(cfg, frames6[:LOOP6_WARMUP], dev)
    warm.flush_decisions()
    del warm
    torch.cuda.synchronize()
    log(f"phase 6: rendered {LOOP6_FRAMES} frames and ran a {LOOP6_WARMUP}-frame warm-up pass in "
        f"{time.time() - t_p6:.1f} s")
    t_pass = time.perf_counter()
    slam6, kf_at6, rec = loop_closure_pass(cfg, frames6, dev, counters)
    pass6_s = time.perf_counter() - t_pass
    lc6 = slam6.loop_closer
    _, centers6, _ = slam6.trajectory_arrays()
    ate6 = ate.ate_rmse(centers6, gt6[: len(centers6)])
    fr = rec["frames"]
    lat6 = np.array([f["ms"] for f in fr[5:]])
    closures = [(c["args"][1], c["args"][2]) for c in rec["corrections"]]
    corr_frames = [c["frame"] for c in rec["corrections"]]
    reads = [dict(frame=f["frame"], kind=f["kind"], syncs=f["syncs"], allowed=loop_host_read_allowance(f["calls"]),
                  calls=f["calls"], state=f["state"], sync_calls=f["sync_calls"])
             for f in fr[1:] if f["syncs"] or f["calls"] or f["kind"] in ("loop", "gba_chunk")]
    # the matcher at the hypothesis refinement's inputs: exact, one kernel a
    # call (before the profiler sessions of the slices below)
    run_checks([("masked_best2", f"{a.shape[0]}x{b.shape[0]} hypothesis refinement (loop pass call {i})",
                 cuda_matching.fused_masked_best2, cuda_matching.fused_masked_best2_plain, (a, b, m),
                 matcher_bound(a, b, m), None) for i, (a, b, m) in enumerate(rec["refine_inputs"])],
               counters, per_kernel)
    # one slice of each loop kind alone, on the device, with the pass's inputs
    cam6 = slam6.cam_params
    frame_last = frontend.process_stereo(*frames6[-1], cfg.camera.bf, n_features=N_FEATURES, cell=CELL)
    corr = rec["corrections"][0] if rec["corrections"] else None
    slices6 = {
        "bow_insert": lambda: loop_closing._add_kf_core(lc6.vocab, frame_last.desc, frame_last.valid),
        "detection": lambda: loop_closing._detect_core(lc6.db_words, lc6.db_wts, slam6.ms, slam6.n_kf - 1,
                                                       slam6.n_kf, lc6.min_gap),
        "gba_chunk": lambda: loop_closing.global_ba(slam6.ms, cam6, cfg.camera.bf, iters=2),
    }
    if corr is not None:
        a = corr["args"]
        slices6["correction"] = lambda: loop_closing._correct_core(
            corr["ms"], a[0], a[1], a[2], a[3], a[4], corr["kwargs"]["s_delta"], cam6, cfg.camera.bf,
            False, corr["kwargs"].get("mode", "se3"))
    slice6_ms = {k: profiled_device_ms(f) for k, f in slices6.items()}
    # the card-to-card spread of one GBA slice: two runs on the same inputs
    (ms_a, cost_a), (ms_b, cost_b) = (loop_closing.global_ba(slam6.ms, cam6, cfg.camera.bf, iters=2)
                                      for _ in range(2))
    gba_spread = dict(
        pose_t_m=max_abs_err(ms_a.kf_t_cw, ms_b.kf_t_cw), pose_R=max_abs_err(ms_a.kf_R_cw, ms_b.kf_R_cw),
        points_m=max_abs_err(ms_a.lm_pos, ms_b.lm_pos), cost=abs(float(cost_a) - float(cost_b)),
        cost_value=float(cost_a))
    sharded6, sharded6_bad = sharded_gba(slam6.ms, cam6, cfg.camera.bf, ms_a, dev)
    corr_ms = [f["ms"] for f in fr if f["frame"] in corr_frames]
    loop6 = dict(
        frames=len(slam6.trajectory), state=slam6.state, loops_closed=lc6.n_loops_closed,
        closures=closures, last_closure=list(getattr(lc6, "last_closure", ())),
        corrected_at_frame=corr_frames, ref=REF_LOOP, gba_chunks=rec["calls"].get("gba_chunk", 0),
        hypothesis_steps=rec["calls"].get("hypothesis_step", 0), verifications=rec["calls"].get("verify", 0),
        lost_frames=rec["calls"].get("lost", 0), relocalizations=rec["calls"].get("relocalized", 0),
        relocalized_at_frame=[f["frame"] for f in fr if f["calls"].get("relocalized")], keyframes=slam6.n_kf, keyframe_frames=kf_at6, stats=slam6.stats,
        landmarks=int(slam6.ms.lm_valid.sum()), ate_m=ate6,
        frame_p50_ms=float(np.percentile(lat6, 50)), frame_p99_ms=float(np.percentile(lat6, 99)),
        frame_max_ms=float(lat6.max()), correction_frame_ms=corr_ms, frames_per_s=LOOP6_FRAMES / pass6_s,
        slice_device_ms=slice6_ms, gba_spread=gba_spread, sharded_gba=sharded6, host_reads=reads,
        refine_matcher_calls=len(rec["refine_inputs"]), launches=rec["launches"], peak_mib=rec["peak_mib"],
        slice_wall_ms={k: dict(count=len(v), median=float(np.median(v)), max=float(np.max(v)))
                       for k in ("tracking", "bow_insert", "loop", "gba_chunk", "local_ba_chunk", "fuse")
                       for v in [[f["ms"] for f in fr[5:] if f["kind"] == k]] if v},
    )
    log(f"phase 6 ({smi}): " + json.dumps(loop6))
    log(f"phase 6: {LOOP6_FRAMES} frames, loops {lc6.n_loops_closed} at {closures} (reference {REF_LOOP['closures']}), "
        f"source {loop6['last_closure'][4:] if loop6['last_closure'] else None}, GBA chunks {loop6['gba_chunks']}; "
        f"ATE {ate6 * 1e3:.3f} mm (JAX reference {REF_LOOP['ate_m'] * 1e3:.3f} mm); frame wall p50 "
        f"{loop6['frame_p50_ms']:.2f} ms p99 {loop6['frame_p99_ms']:.2f} ms, correction frame {corr_ms} ms; "
        "slices " + ", ".join(f"{k} {v:.3f} ms" for k, v in slice6_ms.items())
        + f"; peak {rec['peak_mib']:.1f} MiB; phase 6 took {time.time() - t_p6:.1f} s")
    bad = []
    if slam6.state != slam_mod.TrackingState.OK:
        bad.append(f"final state {slam6.state}")
    if len(slam6.trajectory) != LOOP6_FRAMES:
        bad.append(f"{len(slam6.trajectory)} frames recorded")
    if closures != REF_LOOP["closures"]:
        bad.append(f"closures {closures}, the reference closes {REF_LOOP['closures']}")
    for key in ("lost_frames", "relocalizations"):
        if loop6[key] != REF_LOOP[key]:
            bad.append(f"{key} {loop6[key]}, the reference's {REF_LOOP[key]}")
    if not ate6 <= REF_LOOP["ate_m"] + ATE_MARGIN:
        bad.append(f"ATE {ate6} m")
    for r in reads:
        if r["syncs"] > r["allowed"]:
            bad.append(f"frame {r['frame']} ({r['kind']}): {r['syncs']} host reads, the reference's "
                       f"{r['allowed']} ({r['calls']}; {r['sync_calls']})")
    for k in LAUNCHES_PER_FRAME:
        if rec["launches"][k] < LOOP6_FRAMES - 1:
            bad.append(f"{k}: {rec['launches'][k]} launches over the pass")
    if not rec["refine_inputs"]:
        bad.append("no hypothesis refinement ran masked_best2")
    bad += ["sharded GBA: " + b for b in sharded6_bad]
    if bad:
        raise AssertionError("phase 6: " + "; ".join(bad))

    return rec


def merge_config(small=False):
    """Phase 7's configuration: bench.py's stereo setup (or, ``small``, the
    small loop-closure one) with a keyframe at least every MERGE_KF_GAP
    frames."""
    cfg = loop_config(small=small, closure=small)
    return dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, max_frames_between_kf=MERGE_KF_GAP))


def merge_schedule(frames, black):
    """Phase 7's calls in order: ("frame", (left, right), time) or
    ("flush",)."""
    steps, k = [], 0
    for i in range(MERGE_FIRST):
        steps.append(("frame", frames[i], k / FPS))
        k += 1
    steps.append(("flush",))
    for _ in range(MERGE_BLACK):
        steps.append(("frame", (black, black), k / FPS))
        k += 1
    for i in range(*MERGE_REPLAY):
        steps.append(("frame", frames[i], k / FPS))
        k += 1
    steps.append(("flush",))
    return steps


def run_merge_steps(slam, steps, on_call=None):
    """Feed phase 7's calls to ``slam``; ``on_call(j, slam, call)`` may
    wrap each one."""
    for j, st in enumerate(steps):
        if st[0] == "frame":
            call = lambda _f=st[1], _t=st[2]: slam.track_stereo(_f[0], _f[1], _t)
        else:
            call = slam.flush_decisions
        on_call(j, slam, call) if on_call else call()


@contextlib.contextmanager
def patched(targets):
    """Within the block ``obj.name`` is ``make(original)`` for each
    (obj, name, make) of ``targets``."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    for obj, name, make in targets:
        setattr(obj, name, make(getattr(obj, name)))
    try:
        yield
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def merge_pass(cfg, steps, dev, counters):
    """Phase 7's recorded pass: ``steps`` through a new SlamSystem, each
    call under the sync debug mode (the batched decision and delayed
    detection reads left out) and blocking on the pose. Records per call
    its wall ms, synchronizing calls and the merge, loop and lost-path
    calls in it; the merge (call, frame, pair); the inputs of the first
    ``verify_merge``, ``_concat_maps``, merge pose graph and weld BA; the
    ``masked_best2`` inputs of each verification's tracking refinement; and
    each kernel's launches over the pass."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_matching
    from orb_slam3_detailed_comments_kor_tpu_torch.optim import pose_graph
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing, map_merging, tracking
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.host_read import HostRead

    rec = dict(calls=[], merges=[], inputs={}, refine_inputs=[], totals={})
    cur = {}
    in_merge = []

    def count(key, keep_inputs=False, during_merge=False):
        def make(fn):
            def wrapper(*a, **k):
                if during_merge and not in_merge:
                    return fn(*a, **k)
                cur[key] = cur.get(key, 0) + 1
                if keep_inputs:
                    rec["inputs"].setdefault(key, (a, k))
                return fn(*a, **k)
            return wrapper
        return make

    def verify(fn):
        def wrapper(*a, **k):
            cur["verify_merge"] = cur.get("verify_merge", 0) + 1
            rec["inputs"].setdefault("verify_merge", (a, k))
            kern, spy_calls = cuda_matching.fused_masked_best2, []

            def spy(*args):
                spy_calls.append(args)
                return kern(*args)

            spy.launches = 0  # the wrapper counts through its module name: the spy, here
            cuda_matching.fused_masked_best2 = spy
            try:
                return fn(*a, **k)
            finally:
                cuda_matching.fused_masked_best2 = kern
                kern.launches += spy.launches
                rec["refine_inputs"].extend(spy_calls)
        return wrapper

    def weld(fn):
        def wrapper(slam_, shelf_idx, kf_cur, kf_old, R_d, t_d):
            cur["merge_into_shelved"] = cur.get("merge_into_shelved", 0) + 1
            in_merge.append(True)
            try:
                done = fn(slam_, shelf_idx, kf_cur, kf_old, R_d, t_d)
            finally:
                in_merge.pop()
            rec["merges"].append(dict(call=cur["call"], frame=slam_.n_frames - 1, pair=(kf_cur, kf_old), done=done))
            return done
        return wrapper

    def unwatched_numpy(fn):
        def wrapper(self):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(self)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return wrapper

    lc = loop_closing.LoopCloser
    targets = [(map_merging, "detect_merge_candidate", count("detect_merge_candidate")),
               (map_merging, "verify_merge", verify),
               (map_merging, "_merge_gate_allows", count("_merge_gate_allows")),
               (map_merging, "merge_into_shelved", weld),
               (map_merging, "_concat_maps", count("_concat_maps", keep_inputs=True)),
               (pose_graph, "optimize_pose_graph_se3", count("pose_graph", True, during_merge=True)),
               (tracking, "local_ba_step", count("weld_ba", True, during_merge=True)),
               (HostRead, "numpy", unwatched_numpy)]
    targets += [(lc, n, count(n)) for n in ("verify", "hypothesis_step", "correct", "gba_chunk")]
    slam = SlamSystem(cfg, device=dev)
    count_system_calls(slam, cur, (("_create_map_in_atlas", "_create_map_in_atlas"),
                                   ("_stereo_initialize", "initialize")))

    def on_call(j, slam_, call):
        cur.clear()
        cur["call"] = j
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        slam_.t_cw.cpu()  # block on the pose, as bench.py's latency pass does
        ms_wall = (time.perf_counter() - t0) * 1e3
        syncs = [str(w.message).splitlines()[0] for w in caught if SYNC_WARNING in str(w.message)]
        calls = {k: v for k, v in cur.items() if k != "call"}
        for k, v in calls.items():
            rec["totals"][k] = rec["totals"].get(k, 0) + v
        rec["calls"].append(dict(call=j, kind=steps[j][0], frame=slam_.n_frames - 1, ms=ms_wall, syncs=len(syncs),
                                 sync_calls=sorted(set(syncs))[:3], calls=calls, state=slam_.state,
                                 maps=1 + len(slam_.atlas_maps)))

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with patched(targets):
        run_merge_steps(slam, steps, on_call)
    rec["launches"] = {k: fn.launches for k, fn in counters.items()}
    rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    return slam, rec


def merge_host_read_allowance(calls):
    """The host reads the reference makes in a call with these calls: its
    merge path's (MERGE_REF_READS), its loop and lost path's
    (``loop_host_read_allowance``) and one per stereo initialization (the
    depth count)."""
    return (sum(n * calls.get(k, 0) for k, n in MERGE_REF_READS.items()) + loop_host_read_allowance(calls)
            + calls.get("initialize", 0))


def phase7(dev, counters, per_kernel, smi):
    """Phase 7: the Atlas merge pass at bench scale (see the module
    docstring). Prints its JSON line, raises on a failed check, holds
    ``masked_best2`` against its plain version at the merge verification's
    recorded inputs (into ``per_kernel``) and returns the pass's record."""
    from orb_slam3_detailed_comments_kor_tpu_torch.optim import pose_graph
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_matching
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging, tracking
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as slam_mod

    cfg = merge_config()
    t_p7 = time.time()
    gt, frames = render_loop_sequence(cfg, MERGE_FIRST, dev, "strafe", MERGE_SPEED)
    steps = merge_schedule(frames, torch.zeros((cfg.camera.height, cfg.camera.width), device=dev))
    # a warm-up pass over the first MERGE_WARMUP calls (the whole scenario
    # was cut to fit the script's time)
    warm = slam_mod.SlamSystem(cfg, device=dev)
    run_merge_steps(warm, steps[:MERGE_WARMUP])
    warm.flush_decisions()
    del warm
    torch.cuda.synchronize()
    log(f"phase 7: rendered {MERGE_FIRST} frames and ran a {MERGE_WARMUP}-call warm-up pass in "
        f"{time.time() - t_p7:.1f} s")
    slam, rec = merge_pass(cfg, steps, dev, counters)
    calls = rec["calls"]
    frame_ms = np.array([c["ms"] for c in calls if c["kind"] == "frame"][5:])
    merges = [m for m in rec["merges"] if m["done"]]
    merge_call = calls[merges[0]["call"]] if merges else None
    _, centers, _ = slam.trajectory_arrays()
    last = MERGE_REPLAY[1]
    live_err = float(np.linalg.norm(slam.camera_center() - gt[last - 1]))
    tail_err = float(np.linalg.norm(centers[-10:] - gt[last - 10:last], axis=1).mean())
    # the matcher at the merge verification's tracking refinement: exact, one
    # kernel a call
    run_checks([("masked_best2", f"{a.shape[0]}x{b.shape[0]} merge verification (merge pass call {i})",
                 cuda_matching.fused_masked_best2, cuda_matching.fused_masked_best2_plain, (a, b, m),
                 matcher_bound(a, b, m), None) for i, (a, b, m) in enumerate(rec["refine_inputs"])],
               counters, per_kernel)
    # one call of each merge step alone, on the device, with the pass's inputs
    fns = {"verify_merge": map_merging.verify_merge, "_concat_maps": map_merging._concat_maps,
           "pose_graph": pose_graph.optimize_pose_graph_se3, "weld_ba": tracking.local_ba_step}
    slice_ms = {k: profiled_device_ms(lambda _f=fns[k], _a=a, _k=kw: _f(*_a, **_k))
                for k, (a, kw) in rec["inputs"].items() if k in fns}
    reads = [dict(call=c["call"], kind=c["kind"], frame=c["frame"], syncs=c["syncs"],
                  allowed=merge_host_read_allowance(c["calls"]), calls=c["calls"], sync_calls=c["sync_calls"])
             for c in calls[1:] if c["syncs"] or c["calls"]]
    t = rec["totals"]
    merge7 = dict(
        frames=len(slam.trajectory), state=slam.state, maps=1 + len(slam.atlas_maps), keyframes=slam.n_kf,
        merges=rec["merges"], merge_frame=merges[0]["frame"] if merges else None,
        merge_call_kind=merge_call["kind"] if merge_call else None,
        pair=list(merges[0]["pair"]) if merges else None, ref=REF_MERGE,
        merges_rejected_gate=slam.stats.get("merges_rejected_gate", 0),
        candidate_searches=t.get("detect_merge_candidate", 0), verifications=t.get("verify_merge", 0),
        gate_checks=t.get("_merge_gate_allows", 0), lost_frames=t.get("lost", 0),
        relocalizations=t.get("relocalized", 0), stats=slam.stats,
        live_centre_err_m=live_err, tail_mean_err_m=tail_err,
        frame_p50_ms=float(np.percentile(frame_ms, 50)), frame_p99_ms=float(np.percentile(frame_ms, 99)),
        frame_max_ms=float(frame_ms.max()), merge_call_ms=merge_call["ms"] if merge_call else None,
        merge_call_host_reads=merge_call["syncs"] if merge_call else None,
        merge_call_allowed_reads=merge_host_read_allowance(merge_call["calls"]) if merge_call else None,
        merge_call_calls=merge_call["calls"] if merge_call else None,
        slice_device_ms=slice_ms, host_reads=reads, refine_matcher_calls=len(rec["refine_inputs"]),
        launches=rec["launches"], peak_mib=rec["peak_mib"],
    )
    log(f"phase 7 ({smi}): " + json.dumps(merge7))
    log(f"phase 7: merge {merge7['pair']} at frame {merge7['merge_frame']} ({merge7['merge_call_kind']} call, "
        f"{merge7['merge_call_ms']} ms, {merge7['merge_call_host_reads']} host reads; reference {REF_MERGE['pair']} "
        f"at {REF_MERGE['merge_frame']}); {merge7['maps']} map, {slam.n_kf} keyframes; live centre error "
        f"{live_err * 1e3:.2f} mm, tail {tail_err * 1e3:.2f} mm (reference {REF_MERGE['live_centre_err_m'] * 1e3:.2f}, "
        f"{REF_MERGE['tail_mean_err_m'] * 1e3:.2f}); frame wall p50 {merge7['frame_p50_ms']:.2f} ms p99 "
        f"{merge7['frame_p99_ms']:.2f} ms; " + ", ".join(f"{k} {v:.3f} ms" for k, v in slice_ms.items())
        + f"; peak {rec['peak_mib']:.1f} MiB; phase 7 took {time.time() - t_p7:.1f} s")
    bad = []
    if not merges:
        bad.append("no merge")
    elif tuple(merges[0]["pair"]) != REF_MERGE["pair"] or len(merges) != 1:
        bad.append(f"merges {rec['merges']}, the reference's {REF_MERGE['pair']}")
    if slam.n_kf != REF_MERGE["keyframes"] or merge7["maps"] != REF_MERGE["maps"]:
        bad.append(f"{merge7['maps']} maps and {slam.n_kf} keyframes, the reference's {REF_MERGE['maps']} and "
                   f"{REF_MERGE['keyframes']}")
    if slam.state != slam_mod.TrackingState.OK:
        bad.append(f"final state {slam.state}")
    if not live_err <= REF_MERGE["live_centre_err_m"] + MERGE_LIVE_MARGIN:
        bad.append(f"live centre error {live_err} m")
    if not tail_err <= REF_MERGE["tail_mean_err_m"] + MERGE_TAIL_MARGIN:
        bad.append(f"tail error {tail_err} m")
    for r in reads:
        if r["syncs"] > r["allowed"]:
            bad.append(f"call {r['call']} ({r['kind']}, frame {r['frame']}): {r['syncs']} host reads, the "
                       f"reference's {r['allowed']} ({r['calls']}; {r['sync_calls']})")
    n_tracked = sum(1 for c in calls if c["kind"] == "frame")
    for k in LAUNCHES_PER_FRAME:
        if rec["launches"][k] < n_tracked - MERGE_BLACK - 2:
            bad.append(f"{k}: {rec['launches'][k]} launches over the pass")
    if not rec["refine_inputs"]:
        bad.append("no merge verification ran masked_best2")
    if bad:
        raise AssertionError("phase 7: " + "; ".join(bad))
    return rec


def si_config(small=False):
    """The port's SLAMConfig of the stereo-inertial pass: bench.py's
    ``build_config(True)`` (IMU_STEREO, 480x752, 1200 features, 64
    keyframes, 16384 landmarks, 4096 local, a keyframe at least every 10
    frames, a 200 Hz IMU), or (small) the 240x376 / 600-feature geometry at
    10 fps with 32 keyframe slots, a keyframe every second frame and
    synchronous decisions, so that IMU initialization comes after about 16
    frames."""
    from orb_slam3_detailed_comments_kor_tpu_torch.config import (
        CameraConfig, CapacityConfig, IMUConfig, ORBConfig, SLAMConfig, SensorType, TrackingConfig,
    )

    if small:
        h, w, fx = 240, 376, 230.0
        return SLAMConfig(
            sensor=SensorType.IMU_STEREO,
            camera=CameraConfig(width=w, height=h, fx=fx, fy=fx, cx=w / 2.0, cy=h / 2.0,
                                bf=BASELINE * fx, th_depth=35.0, fps=SMALL_SI["fps"]),
            orb=ORBConfig(n_features=600, cell_size=24),
            imu=IMUConfig(frequency=SI_IMU_RATE),
            capacity=CapacityConfig(max_keyframes=32, max_landmarks=4096, max_local_landmarks=2048),
            tracking=TrackingConfig(max_frames_between_kf=2, kf_ref_ratio=0.5, decision_batch=1),
        )
    return SLAMConfig(
        sensor=SensorType.IMU_STEREO,
        camera=CameraConfig(width=W, height=H, fx=FX, fy=FX, cx=W / 2.0, cy=H / 2.0, bf=BASELINE * FX),
        orb=ORBConfig(n_features=N_FEATURES, cell_size=CELL),
        imu=IMUConfig(frequency=SI_IMU_RATE),
        capacity=CapacityConfig(max_keyframes=MAX_KF, max_landmarks=MAX_LM, max_local_landmarks=4096),
        tracking=TrackingConfig(max_frames_between_kf=10),
    )


def mono_config(small=False):
    """The monocular SLAMConfig. Phase 9's: ``loop_config()``'s geometry
    and capacity (bench.py's stereo setup) with a MONOCULAR sensor and bf =
    0. Small: the JAX package's ``tests/test_slam_e2e.small_config()``
    (240x376, 600 features, 32 keyframe slots) with a MONOCULAR sensor, a
    keyframe at least every 3 frames and synchronous decisions."""
    from orb_slam3_detailed_comments_kor_tpu_torch.config import SensorType, TrackingConfig

    if small:
        return dataclasses.replace(loop_config(small=True, closure=True), sensor=SensorType.MONOCULAR,
                                   tracking=TrackingConfig(max_frames_between_kf=3, decision_batch=1))
    cfg = loop_config()
    return dataclasses.replace(cfg, sensor=SensorType.MONOCULAR, camera=dataclasses.replace(cfg.camera, bf=0.0))


def mi_config(small=False):
    """The monocular-inertial SLAMConfig: ``si_config(small)`` with an
    IMU_MONOCULAR sensor and bf = 0; at bench scale (phase 10) a keyframe
    at least every 6 frames, as ``tests/test_mono_inertial.py:26-39``."""
    from orb_slam3_detailed_comments_kor_tpu_torch.config import SensorType

    cfg = si_config(small)
    tracking = cfg.tracking if small else dataclasses.replace(cfg.tracking, max_frames_between_kf=6)
    return dataclasses.replace(cfg, sensor=SensorType.IMU_MONOCULAR, tracking=tracking,
                               camera=dataclasses.replace(cfg.camera, bf=0.0))


def render_si_sequence(cfg, n, dev, fps=FPS, rate=SI_IMU_RATE, mono=False, excitation=1.0,
                       baseline=BASELINE):
    """bench.py's stereo-inertial data (``bench.py:301-324``) at ``cfg``'s
    camera on ``dev``: the poses of ``synthetic.AnalyticTrajectory`` at
    ``fps``, a stereo pair at each (``mono``: one image; the right camera
    ``baseline`` m along the camera's x, raw fisheye views for a KB8
    camera), and each frame's IMU samples since the previous frame at
    ``rate`` (midpoint-sampled, stamped at the end of their interval), made
    in one batch on ``dev``. ``excitation`` scales the trajectory's
    translation frequencies (the monocular-inertial passes take 3.0, so
    that the scale is observable). Returns (ground-truth body positions
    [n, 3] numpy, the pairs or images, the per-frame sample lists)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic
    from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod

    c = cfg.camera
    cam = cam_mod.camera_params_from_config(c, device=dev)
    scene = synthetic.default_scene(dev)
    traj = synthetic.AnalyticTrajectory(excitation=excitation, device=dev)
    frames, gt, stamps, mids = [], [], [], []
    for i in range(n):
        t = i / fps
        R_wb, p_wb = traj.pose(t)
        gt.append(p_wb.cpu().numpy())
        if mono:
            frames.append(synthetic.render(cam, R_wb, p_wb, scene, h=c.height, w=c.width, model=c.model)[0])
        else:
            frames.append(synthetic.stereo_pair(cam, R_wb, p_wb, baseline, scene, h=c.height, w=c.width,
                                                model=c.model)[:2])
        row = []
        if i > 0:
            t0s = (i - 1) / fps
            k = int(round((t - t0s) * rate))
            dt = (t - t0s) / k
            row = [(t0s + (j + 1) * dt, t0s + (j + 0.5) * dt) for j in range(k)]
        stamps.append(row)
        mids.extend(m for _, m in row)
    acc, gyro = (a.cpu().numpy() for a in traj.imu_at(np.asarray(mids)))
    imu_pf, at = [], 0
    for row in stamps:
        imu_pf.append([(ts, acc[at + j], gyro[at + j]) for j, (ts, _) in enumerate(row)])
        at += len(row)
    return np.stack(gt), frames, imu_pf


def run_si(cfg, frames, imu_pf, dev, on_frame=None, timer=False, fps=FPS):
    """Feed the stereo-inertial sequence to a new SlamSystem on ``dev``
    (loop closing on, the default). ``on_frame(i, slam, call)`` may wrap
    each frame's ``call()``. Returns (slam, the frames at which a keyframe
    was inserted, {frame, n_kf, gravity} at IMU initialization)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.timing import StageTimer

    slam = SlamSystem(cfg, device=dev)
    slam.timer = StageTimer(enabled=timer)
    kf_at, init = [], None
    for i, (il, ir) in enumerate(frames):
        n0 = slam.stats["kf_inserted"]
        call = lambda _i=i, _l=il, _r=ir: slam.track_stereo_inertial(_l, _r, _i / fps, imu_pf[_i])
        on_frame(i, slam, call) if on_frame else call()
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if init is None and slam.imu_initialized:
            init = dict(frame=i, n_kf=slam.n_kf, gravity=slam.gravity.cpu().tolist())
    return slam, kf_at, init


def on_device(x, dev):
    """``x`` (a tensor, or a tuple or NamedTuple of them) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        items = [on_device(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def gravity_angle(a, b):
    """Angle (rad) between two gravity vectors, in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c = np.cross(a, b)
    return float(np.arctan2(np.linalg.norm(c), a @ b))


@contextlib.contextmanager
def recording_last_call(module, name, store, outputs=None):
    """Within the block ``store[name]`` holds the arguments of the latest
    call of ``module.name`` (args, kwargs); ``outputs``, if given, gets
    (args, kwargs, result) of every call."""
    fn = getattr(module, name)

    def spy(*a, **k):
        store[name] = (a, k)
        out = fn(*a, **k)
        if outputs is not None:
            outputs.append((a, k, out))
        return out
    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def sharded_fiba(ms, ikf, gravity, cam, R_cb, t_cb, bf, dev):
    """Phase 8's sharded FullInertialBA on the pass's map after the IMU
    initialization (see the module docstring)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dist_vi_ba
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial

    def on(mesh):
        def call():
            dist_vi_ba._VI_GBA_MESH = mesh
            try:
                return dist_vi_ba.distributed_full_inertial_ba(ms, ikf, gravity, cam, R_cb, t_cb, bf, iters=2)
            finally:
                dist_vi_ba._VI_GBA_MESH = None
        return call

    valid = ms.lm_valid
    fields = {"R_cw": lambda r: r[0].kf_R_cw, "t_cw": lambda r: r[0].kf_t_cw,
              "points": lambda r: r[0].lm_pos[valid], "vel": lambda r: r[1].vel, "bg": lambda r: r[1].bg,
              "ba": lambda r: r[1].ba}
    one_device = inertial.full_inertial_ba(ms, ikf, gravity, cam, R_cb, t_cb, bf, iters=2)
    rec, bad, four = sharded_record(one_device, on([dev]), on([dev] * 4), fields,
                                    dict(t_cw=DIST_BOUNDS["pose_m"], points=DIST_BOUNDS["point_m"],
                                         vel=DIST_BOUNDS["vel"]), ms.kf_t_cw)
    if four[2] is not None:
        bad.append("the four-shard FIBA returned a cost")
    return rec, bad


def phase8(dev, counters, per_kernel, smi):
    """Phase 8: bench.py's stereo-inertial pass at bench scale (see the
    module docstring). Prints its JSON line, raises on a failed check,
    holds the three kernels against their plain versions at one inertial
    frame's inputs (into ``per_kernel``) and returns the pass's record."""
    from torch.profiler import ProfilerActivity, profile

    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
    from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
    from orb_slam3_detailed_comments_kor_tpu_torch.optim import vio
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial, loop_closing
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as slam_mod
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.host_read import HostRead

    cfg = si_config()
    t_p8 = time.time()
    gt8, frames8, imu8 = render_si_sequence(cfg, SI_FRAMES, dev)
    voc.load_default(dev)
    warm, _, _ = run_si(cfg, frames8[:SI_WARMUP], imu8, dev)
    warm.flush_decisions()
    del warm
    torch.cuda.synchronize()
    log(f"phase 8: rendered {SI_FRAMES} frames and their IMU samples and ran a {SI_WARMUP}-frame warm-up pass in "
        f"{time.time() - t_p8:.1f} s")

    # the pass: block on each frame's pose; every tracked frame runs under
    # the sync debug mode with the batched decision read left out, so each
    # synchronizing call counted is a host read of a value. One inertial
    # frame (initialized IMU, VIO on) runs unwatched instead: it records the
    # kernels' inputs and its device operations, and its wall time is left
    # out of the percentiles. The launch counters and the peak memory are
    # the pass's; it records the last per-frame IMU and VIO calls and the
    # loop corrections for the slices timed below.
    lat, frames_rec, kcalls, frame_ops = [], [], {}, {}
    read_numpy = HostRead.numpy

    def unwatched_read(self):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return read_numpy(self)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def timed(i, slam, call):
        kind = slam._bg_queue[0][0] if slam._bg_queue else (
            "gba_chunk" if slam._gba_chunks_left > 0 else "tracking")
        watch, was_init = i > 0 and i != SI_PROFILE_FRAME, slam.imu_initialized
        if i == SI_PROFILE_FRAME:
            if not slam.imu_initialized:
                raise AssertionError(f"phase 8: the IMU is not initialized at frame {i}")
            torch.cuda.synchronize()
            with recording_kernel_calls(kcalls), profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            frame_ops.update(device_ops=len(device_events(prof)), kind=kind)
            frames_rec.append(dict(frame=i, kind=kind, watched=False, after_init=was_init, syncs=0,
                                   sync_calls=[], ms=None))
            return
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if watch:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        slam.t_cw.cpu()  # block on the frame's pose, as bench.py's latency pass does
        lat.append((time.perf_counter() - t0) * 1e3)
        syncs = [str(w.message).splitlines()[0] for w in caught if SYNC_WARNING in str(w.message)]
        if slam.imu_initialized and not was_init:
            kind = "imu_init"  # the frame whose decision initialized the IMU
        frames_rec.append(dict(frame=i, kind=kind, watched=watch, after_init=was_init, syncs=len(syncs),
                               sync_calls=sorted(set(syncs))[:3], ms=lat[-1]))

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    last, corrections = {}, []
    correct = loop_closing.LoopCloser.correct

    def correct_logged(self, *a, **k):
        corrections.append(dict(ms=a[0], args=a[1:], kwargs=k))
        return correct(self, *a, **k)

    loop_closing.LoopCloser.correct = correct_logged
    HostRead.numpy = unwatched_read
    t_pass = time.perf_counter()
    try:
        with recording_last_call(inertial, "advance_imu", last), recording_last_call(vio, "vio_frame_step", last):
            slam, kf_at, init = run_si(cfg, frames8, imu8, dev, timed, timer=True)
            slam.t_cw.cpu()
    finally:
        HostRead.numpy = read_numpy
        loop_closing.LoopCloser.correct = correct
    pass_s = time.perf_counter() - t_pass
    launches8 = {k: fn.launches for k, fn in counters.items()}
    peak8 = torch.cuda.max_memory_allocated() / 2**20
    lat_s = np.array([f["ms"] for f in frames_rec[5:] if f["ms"] is not None])
    _, centers, _ = slam.trajectory_arrays()
    ate8 = ate.ate_rmse(centers, gt8[: len(centers)])
    g_end = slam.gravity.cpu().tolist()
    log(f"phase 8: the pass in {pass_s:.1f} s; frame {SI_PROFILE_FRAME}: {frame_ops}")
    run_checks(main_path_checks(kcalls, f"inertial frame {SI_PROFILE_FRAME}: "), counters, per_kernel)

    # one slice of each kind alone, on the device, with the pass's inputs
    cam8, bf, cap = slam.cam_params, cfg.camera.bf, cfg.capacity
    ms_f, ikf_f, g_f, kf_f = slam.ms, slam.ikf, slam.gravity, slam.n_kf - 1

    def vi_lba():
        return inertial.local_vi_ba_step(ms_f, ikf_f, kf_f, g_f, cam8, slam.R_cb, slam.t_cb, bf, window=10,
                                         lm_cap=cap.max_local_landmarks, iters=2)

    slices = {
        "preintegration": lambda: inertial.advance_imu(*last["advance_imu"][0], **last["advance_imu"][1]),
        "vio_step": lambda: vio.vio_frame_step(*last["vio_frame_step"][0], **last["vio_frame_step"][1]),
        "init_fiba": slam._init_fiba_slice,
        "vi_local_ba": vi_lba,
    }
    if corrections:
        c = corrections[0]
        a, k = c["args"], c["kwargs"]
        slices["correction_4dof"] = lambda: loop_closing._correct_core(
            c["ms"], a[0], a[1], a[2], a[3], a[4], k["s_delta"], cam8, bf, False, k["mode"],
            gravity=k["gravity"])
        W = slam._INIT_FIBA_WINDOW
        slices["gba_sweep"] = lambda: inertial.local_vi_ba_step(
            ms_f, ikf_f, min(W - 1, kf_f), g_f, cam8, slam.R_cb, slam.t_cb, bf, window=W,
            lm_cap=cap.max_local_landmarks, iters=2)
    # one profiled call a slice (tens of thousands of operations each)
    profiled = {k: profiled_device_ms(f, reps=1, ops=True) for k, f in slices.items()}
    slice_ms = {k: v[0] for k, v in profiled.items()}
    slice_ops = {k: profiled[k][1] for k in ("preintegration", "vio_step")}
    capture = {k: graph_capture_error(slices[k]) for k in ("vi_local_ba", "vio_step")}
    # the card-to-card spread of one VI local-BA slice: two runs, same inputs
    (ms_a, ikf_a, cost_a), (ms_b, ikf_b, cost_b) = vi_lba(), vi_lba()
    moved = float((ms_a.kf_t_cw - ms_f.kf_t_cw).abs().max())
    spread = dict(pose_t_m=max_abs_err(ms_a.kf_t_cw, ms_b.kf_t_cw), pose_R=max_abs_err(ms_a.kf_R_cw, ms_b.kf_R_cw),
                  points_m=max_abs_err(ms_a.lm_pos, ms_b.lm_pos), vel=max_abs_err(ikf_a.vel, ikf_b.vel),
                  bias=max(max_abs_err(ikf_a.bg, ikf_b.bg), max_abs_err(ikf_a.ba, ikf_b.ba)),
                  cost=abs(float(cost_a) - float(cost_b)))
    sharded8, sharded8_bad = sharded_fiba(ms_f, ikf_f, g_f, cam8, slam.R_cb, slam.t_cb, bf, dev)
    watched = [f for f in frames_rec if f["watched"]]
    si = dict(
        frames=len(slam.trajectory), state=slam.state,
        keyframes=slam.n_kf, keyframe_frames=kf_at, imu_init=init, gravity_end=g_end,
        gravity_end_vs_ref_rad=gravity_angle(g_end, REF_SI["gravity_end"]),
        loops_closed=slam.loop_closer.n_loops_closed, corrections=[
            [c["args"][1], c["args"][2], c["kwargs"].get("mode")] for c in corrections],
        stats=slam.stats, landmarks=int(slam.ms.lm_valid.sum()), ate_m=ate8, ref=REF_SI,
        frame_p50_ms=float(np.percentile(lat_s, 50)), frame_p99_ms=float(np.percentile(lat_s, 99)),
        frame_max_ms=float(lat_s.max()), frames_per_s=SI_FRAMES / pass_s, peak_mib=peak8,
        launches=launches8, slice_device_ms=slice_ms, slice_device_ops=slice_ops,
        slice_graph_capture_error=capture,
        vi_local_ba_spread=spread, vi_local_ba_moved_m=moved, sharded_fiba=sharded8, inertial_frame=frame_ops,
        syncs_by_kind={k: sum(f["syncs"] for f in watched if f["kind"] == k)
                       for k in sorted({f["kind"] for f in watched})},
        syncs_after_init=sum(f["syncs"] for f in watched if f["after_init"]),
        sync_calls=sorted({c for f in watched for c in f["sync_calls"]})[:8],
        slice_wall_ms={k: dict(count=len(v), median=float(np.median(v)), max=float(np.max(v)))
                       for k in sorted({f["kind"] for f in frames_rec[5:]})
                       for v in [[f["ms"] for f in frames_rec[5:] if f["kind"] == k and f["ms"] is not None]] if v},
        host_stage_ms={k: {"count": v["count"], "p50_ms": v["p50_ms"], "max_ms": v["max_ms"],
                           "total_ms": v["total_ms"]} for k, v in slam.timer.summary().items()},
    )
    log(f"phase 8 ({smi}): " + json.dumps(si))
    log(f"phase 8: {SI_FRAMES} frames in {pass_s:.2f} s ({si['frames_per_s']:.2f} frames/s), frame wall "
        f"p50 {si['frame_p50_ms']:.2f} ms p99 {si['frame_p99_ms']:.2f} ms; ATE {ate8 * 1e3:.3f} mm (JAX reference "
        f"{REF_SI['ate_m'] * 1e3:.3f} mm); {slam.n_kf} keyframes (reference {REF_SI['n_kf']}); IMU init {init} "
        f"(reference {REF_SI['imu_init']['n_kf']} keyframes); loops {si['corrections']}; slices "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in slice_ms.items())
        + f"; {frame_ops.get('device_ops')} device operations in inertial frame {SI_PROFILE_FRAME} "
        + f"(preintegration {slice_ops['preintegration']}, VIO step {slice_ops['vio_step']})"
        + f"; peak {peak8:.1f} MiB; phase 8 took {time.time() - t_p8:.1f} s")
    bad = []
    if slam.state != slam_mod.TrackingState.OK:
        bad.append(f"final state {slam.state}")
    if len(slam.trajectory) != SI_FRAMES:
        bad.append(f"{len(slam.trajectory)} frames recorded")
    if init is None or init["n_kf"] != REF_SI["imu_init"]["n_kf"]:
        bad.append(f"IMU init {init}, the reference's at {REF_SI['imu_init']['n_kf']} keyframes")
    if si["loops_closed"] != REF_SI["loops_closed"]:
        bad.append(f"{si['loops_closed']} loops closed, the reference's {REF_SI['loops_closed']}")
    if abs(slam.n_kf - REF_SI["n_kf"]) > SI_KF_TOL:
        bad.append(f"{slam.n_kf} keyframes, the reference's {REF_SI['n_kf']}")
    if not ate8 <= REF_SI["ate_m"] + ATE_MARGIN:
        bad.append(f"ATE {ate8} m")
    if not si["gravity_end_vs_ref_rad"] <= SI_GRAVITY_TOL:
        bad.append(f"final gravity {si['gravity_end_vs_ref_rad']:.4f} rad from the reference's")
    for k, err in capture.items():
        if err is not None:
            bad.append(f"{k}: not capturable in a CUDA graph: {err}")
    if any(v != 0 for v in spread.values()) or moved == 0.0:
        bad.append(f"the VI local-BA slice: spread {spread}, moved {moved}")
    tracking_syncs = sum(f["syncs"] for f in watched if f["kind"] == "tracking")
    if tracking_syncs:
        bad.append(f"{tracking_syncs} synchronizing calls in tracking frames: {si['sync_calls']}")
    for k in LAUNCHES_PER_FRAME:
        if launches8[k] < SI_FRAMES - 1:
            bad.append(f"{k}: {launches8[k]} launches over the pass")
    bad += ["sharded FIBA: " + b for b in sharded8_bad]
    if bad:
        raise AssertionError("phase 8: " + "; ".join(bad))
    return si


# Phase 9: the monocular pass (the first MONO_FRAMES of phase 4's strafe,
# left images, loop closing on; cut from 130 frames to fit the script's
# time) and phase 10: the monocular-inertial pass (AnalyticTrajectory(
# excitation=3.0) at 20 fps, a 200 Hz IMU). The warm-up pass of each runs
# MONO_WARMUP frames and records the kernels' inputs at frame
# MONO_PROFILE_FRAME, a tracked frame.
MONO_FRAMES, MONO_WARMUP, MONO_PROFILE_FRAME = 70, 12, 10
# phase 10 runs the first MI_FRAMES frames of the pass (cut from 130 to fit
# the script's time: after the IMU initialization at frame 46 the reference
# and the port relocalize every frame, F23)
MI_FRAMES = 60
MONO_KF_TOL, MI_GRAVITY_TOL = 2, 0.01
# launches of each kernel per tracked monocular frame: process_mono's FAST
# and patch gather (ops/orb.py) and tracking's three projection searches
LAUNCHES_PER_MONO_FRAME = {"fast_nms": 1, "gather_patches": 1, "masked_best2": 3}
# tools/jax_sensor_ref.py --pass mono --frames 70 (tools/jax_mono_ref.py's
# --pass mono cut to phase 9's MONO_FRAMES; the JAX reference on a CPU, one
# device, asynchronous dispatch off; 83 s): two-view initialization at
# frame 4, 8 keyframes, no loop, final state OK, 1768 landmarks, ATE over
# all 70 frames after a similarity alignment (ate_rmse(..., with_scale=True))
# 14.87 mm (the whole 130-frame pass: 14 keyframes, 11.96 mm)
REF_MONO = dict(init_frame=4, state=1, n_kf=8, keyframe_frames=[4, 17, 25, 37, 45, 57, 65],
                loops_closed=0, lost_frames=0, landmarks=1768, ate_scale_aligned_m=0.014869181244948938)
# the reference's host reads in the call that initializes (its
# _mono_initialize, slam/system.py:1065-1134): the frame's feature count,
# the match count, the reconstruction's verdict and its point count
MONO_INIT_REF_READS = 4
# tools/jax_sensor_ref.py --pass mi --frames 60 (tools/jax_mono_ref.py's
# --pass mi cut to phase 10's MI_FRAMES; 211 s on a CPU): two-view
# initialization at frame 1; the IMU and the metric scale initialized at
# frame 46 with 12 keyframes; after it the reference tracks no frame (16
# frames decided lost, each relocalized against the re-gauged map; ROADMAP
# F23; its whole 130-frame pass ends 5.084 m off with a stride-10 ratio of
# 2.762); the scale that initialization solves 0.31893 (``imu_scales``);
# final state OK; ATE without scale alignment 0.4959 m, with it 0.4801 m;
# stride-10 path-length ratio 0.1549 (four of its five strides lie before
# the IMU init, in the two-view gauge the trajectory keeps for those
# frames, F24); no loop. Phase 10 holds the solved scale and the stride-10
# ratio within MI_SCALE_REL_TOL (below) of the reference's, relative, the
# unaligned ATE to the reference's times (1 + MI_SCALE_REL_TOL) plus 5 mm,
# and the scale-aligned ATE to the reference's plus 5 mm
REF_MI = dict(init_frame=1, state=1, n_kf=12, keyframe_frames=[1, 6, 14, 22, 26, 34, 38, 46], loops_closed=0,
              lost_frames=16, landmarks=2849, ate_m=0.49592258417904106, ate_scale_aligned_m=0.4800683627175842,
              imu_init=dict(frame=46, n_kf=12, gravity=[1.5408271551132202, 9.688064575195312, -0.05806245282292366]),
              gravity_end=[1.5408271551132202, 9.688064575195312, -0.05806245282292366],
              path_ratio_stride10=0.15488363802433014, imu_scale=0.3189343214035034)
# the same run under two other float associations of the reference's
# (XLA_FLAGS=--xla_cpu_enable_fast_math=true, and
# --xla_cpu_multi_thread_eigen=false): the same frames, keyframes, lost
# frames and IMU-init frame; the solved scale moves by -1.53 % and -0.47 %,
# the stride-10 ratio by +1.43 % and -0.26 %
REF_MI_ORDERS = (dict(imu_scale=0.31405749917030334, path_ratio_stride10=0.15709304809570312),
                 dict(imu_scale=0.31743019819259644, path_ratio_stride10=0.15447425842285156))
# the solved scale and the stride-10 ratio are held relative to REF_MI
# within twice the largest move of the reference's own under another float
# association (the card's is one more, and two can fall on either side):
# 3.06 %; the scale solve on the card at the pass's own inputs within
# MI_SOLVE_TOL of the port's on the CPU (relative scale; gravity in rad),
# the bound the CPU tests hold the CPU's to the reference's at
MI_SCALE_REL_TOL = 2.0 * max(abs(o[k] / REF_MI[k] - 1.0) for o in REF_MI_ORDERS
                             for k in ("imu_scale", "path_ratio_stride10"))
MI_SOLVE_TOL = 1e-4


def render_mono_sequence(cfg, n, dev, speed=SPEED):
    """Phase 4's strafe (0.03 m/frame, or ``speed``) as left images at
    ``cfg``'s camera on ``dev``: ground-truth centres [n, 3] (numpy) and n
    images."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic

    c = cfg.camera
    cam = torch.tensor([c.fx, c.fy, c.cx, c.cy], dtype=torch.float32, device=dev)
    scene = synthetic.default_scene(dev)
    Rs, ts = synthetic.make_trajectory(n, "strafe", speed=speed)
    imgs = [synthetic.render(cam, torch.from_numpy(Rs[i]).to(dev), torch.from_numpy(ts[i]).to(dev), scene,
                             h=c.height, w=c.width)[0] for i in range(n)]
    return ts, imgs


def run_mono(cfg, imgs, dev, imu=None, on_frame=None, timer=False, fps=FPS):
    """Feed monocular images (with ``imu``'s per-frame samples: through
    ``track_mono_inertial``) to a new SlamSystem on ``dev`` (loop closing
    on). ``on_frame(i, slam, call)`` may wrap each frame's ``call()``.
    Returns (slam, keyframe frames, init frame, {frame, n_kf, gravity} at
    IMU initialization)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem, TrackingState
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.timing import StageTimer

    slam = SlamSystem(cfg, device=dev)
    slam.timer = StageTimer(enabled=timer)
    kf_at, init, imu_init = [], None, None
    for i, img in enumerate(imgs):
        n0 = slam.stats["kf_inserted"]
        if imu is None:
            call = lambda _i=i, _m=img: slam.track_mono(_m, _i / fps)
        else:
            call = lambda _i=i, _m=img: slam.track_mono_inertial(_m, _i / fps, imu[_i])
        on_frame(i, slam, call) if on_frame else call()
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if init is None and slam.state == TrackingState.OK:
            init = i
        if imu is not None and imu_init is None and slam.imu_initialized:
            imu_init = dict(frame=i, n_kf=slam.n_kf, gravity=slam.gravity.cpu().tolist())
    return slam, kf_at, init, imu_init


def watched_frames(records, lat, block=True):
    """An ``on_frame`` that runs each frame under the sync debug mode with
    the batched decision read left out, so that each synchronizing call it
    counts is a host read of a value, and records per frame the slice it
    serviced (``kind``), the state before and after, the synchronizing calls
    and the wall ms (blocking on the frame's pose unless ``block`` is
    false)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.host_read import HostRead

    read_numpy = HostRead.numpy
    calls = {}

    def unwatched_read(self):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return read_numpy(self)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    def on_frame(i, slam, call):
        if i == 0:
            count_system_calls(slam, calls)  # frames that take the lost path
        kind = slam._bg_queue[0][0] if slam._bg_queue else (
            "gba_chunk" if slam._gba_chunks_left > 0 else "tracking")
        state0, n_kf0, lost0 = slam.state, slam.n_kf, calls.get("lost", 0)
        init0 = getattr(slam, "imu_initialized", False)
        HostRead.numpy = unwatched_read
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                HostRead.numpy = read_numpy
        if block:
            slam.t_cw.cpu()  # block on the frame's pose, as bench.py's latency pass does
        lat.append((time.perf_counter() - t0) * 1e3)
        syncs = [str(w.message).splitlines()[0] for w in caught if SYNC_WARNING in str(w.message)]
        if getattr(slam, "imu_initialized", False) and not init0:
            kind = "imu_init"
        elif state0 == 0:
            kind = "initializing"
        elif state0 != 1 or slam.state != 1 or calls.get("lost", 0) != lost0:
            kind = "lost"  # decided lost (relocalized or not)
        elif slam.n_kf != n_kf0 and kind == "tracking":
            kind = "keyframe"  # a decision inserted a keyframe inline
        records.append(dict(frame=i, kind=kind, syncs=len(syncs), sync_calls=sorted(set(syncs))[:3],
                            ms=lat[-1]))

    on_frame.calls = calls
    return on_frame


def sync_summary(records):
    return {k: dict(frames=sum(1 for f in records if f["kind"] == k),
                    syncs=sum(f["syncs"] for f in records if f["kind"] == k))
            for k in sorted({f["kind"] for f in records})}


def phase9(dev, counters, per_kernel, smi):
    """Phase 9: the monocular pass at bench scale (see the module
    docstring). Prints its JSON line, raises on a failed check, holds the
    three kernels against their plain versions at one monocular frame's
    inputs (into ``per_kernel``) and returns the pass's record."""
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
    from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import twoview
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as slam_mod
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import tracking

    cfg = mono_config()
    t_p9 = time.time()
    gt9, imgs9 = render_mono_sequence(cfg, MONO_FRAMES, dev)
    voc.load_default(dev)
    torch.cuda.synchronize()
    # the warm-up pass; it records the kernels' inputs in one tracked frame
    kcalls = {}

    def warm_frame(i, slam, call):
        if i != MONO_PROFILE_FRAME:
            call()
            return
        if slam.state != slam_mod.TrackingState.OK:
            raise AssertionError(f"phase 9: frame {i} is not tracked in the warm-up pass")
        torch.cuda.synchronize()
        with recording_kernel_calls(kcalls):
            call()
            torch.cuda.synchronize()

    warm, _, warm_init, _ = run_mono(cfg, imgs9[:MONO_WARMUP], dev, on_frame=warm_frame)
    warm.flush_decisions()
    del warm
    torch.cuda.synchronize()
    log(f"phase 9: rendered {MONO_FRAMES} images and ran a {MONO_WARMUP}-frame warm-up pass (init at frame "
        f"{warm_init}) in {time.time() - t_p9:.1f} s")
    if any(len(kcalls.get(k, ())) < n for k, n in LAUNCHES_PER_MONO_FRAME.items()):
        raise AssertionError(f"phase 9: kernel calls in a tracked frame "
                             f"{ {k: len(v) for k, v in kcalls.items()} }, expected {LAUNCHES_PER_MONO_FRAME}")
    run_checks(main_path_checks(kcalls, f"mono frame {MONO_PROFILE_FRAME}: "), counters, per_kernel)

    # the timed pass: every frame blocks on its pose and runs under the
    # sync debug mode; the launch counters and the peak memory are its own
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    lat, records, last = [], [], {}
    init_reads = []
    mono_init = slam_mod.SlamSystem._mono_initialize

    def init_counted(self, frame, t):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                mono_init(self, frame, t)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        if self.state == slam_mod.TrackingState.OK:
            init_reads.append([str(w.message).splitlines()[0] for w in caught if SYNC_WARNING in str(w.message)])

    slam_mod.SlamSystem._mono_initialize = init_counted
    t_pass = time.perf_counter()
    try:
        with recording_last_call(tracking, "full_mono_step", last), \
                recording_last_call(tracking, "triangulate_with_neighbor", last), \
                recording_last_call(tracking, "add_triangulated_landmarks", last), \
                recording_last_call(twoview, "reconstruct_two_views_hf", last):
            watch = watched_frames(records, lat)
            slam, kf_at, init, _ = run_mono(cfg, imgs9, dev, on_frame=watch, timer=True)
            slam.flush_decisions()
            slam.t_cw.cpu()
    finally:
        slam_mod.SlamSystem._mono_initialize = mono_init
    pass_s = time.perf_counter() - t_pass
    launches9 = {k: fn.launches for k, fn in counters.items()}
    peak9 = torch.cuda.max_memory_allocated() / 2**20
    _, centers, _ = slam.trajectory_arrays()
    ate9 = ate.ate_rmse(centers, gt9[: len(centers)], with_scale=True)

    def insertion():
        fb, Xw, want, nb = tracking.triangulate_with_neighbor(*last["triangulate_with_neighbor"][0],
                                                              **last["triangulate_with_neighbor"][1])
        a = last["add_triangulated_landmarks"][0]
        return tracking.add_triangulated_landmarks(a[0], a[1], nb, fb, Xw, want, *a[6:],
                                                   **last["add_triangulated_landmarks"][1])

    slices = {
        "full_mono_step": lambda: tracking.full_mono_step(*last["full_mono_step"][0], **last["full_mono_step"][1]),
        "keyframe_triangulation": insertion,
        "two_view_init": lambda: twoview.reconstruct_two_views_hf(*last["reconstruct_two_views_hf"][0],
                                                                  **last["reconstruct_two_views_hf"][1]),
    }
    profiled = {k: profiled_device_ms(f, reps=1, ops=True) for k, f in slices.items()}
    slice_ms = {k: v[0] for k, v in profiled.items()}
    slice_ops = {k: v[1] for k, v in profiled.items()}
    # reported, not required: whether each captures in a CUDA graph (the
    # capture of the tracking step is later work)
    capture = {k: graph_capture_error(slices[k]) for k in ("full_mono_step", "keyframe_triangulation")}
    lat_s = np.array(lat[5:])
    n_tracked = sum(1 for f in records if f["kind"] not in ("initializing", "lost"))
    rec = dict(
        frames=len(slam.trajectory), state=slam.state, init_frame=init, keyframes=slam.n_kf, keyframe_frames=kf_at,
        loops_closed=slam.loop_closer.n_loops_closed, stats=slam.stats, lost_frames=watch.calls.get("lost", 0),
        landmarks=int(slam.ms.lm_valid.sum()), ate_scale_aligned_m=ate9, ref=REF_MONO,
        frame_p50_ms=float(np.percentile(lat_s, 50)), frame_p99_ms=float(np.percentile(lat_s, 99)),
        frame_max_ms=float(lat_s.max()), frames_per_s=MONO_FRAMES / pass_s, peak_mib=peak9, launches=launches9,
        tracked_frames=n_tracked, slice_device_ms=slice_ms, slice_device_ops=slice_ops,
        stereo_step_stream_ops=16077, slice_graph_capture_error=capture,
        init_call_host_reads=[len(r) for r in init_reads], init_call_read_sites=init_reads[:1],
        init_ref_host_reads=MONO_INIT_REF_READS, syncs_by_kind=sync_summary(records),
        sync_calls=sorted({c for f in records if f["kind"] == "tracking" for c in f["sync_calls"]})[:8],
        host_stage_ms={k: {"count": v["count"], "p50_ms": v["p50_ms"], "max_ms": v["max_ms"],
                           "total_ms": v["total_ms"]} for k, v in slam.timer.summary().items()},
    )
    log(f"phase 9 ({smi}): " + json.dumps(rec))
    log(f"phase 9: {MONO_FRAMES} frames in {pass_s:.2f} s ({rec['frames_per_s']:.2f} frames/s), frame wall p50 "
        f"{rec['frame_p50_ms']:.2f} ms p99 {rec['frame_p99_ms']:.2f} ms; init at frame {init} (reference "
        f"{REF_MONO['init_frame']}); {slam.n_kf} keyframes (reference {REF_MONO['n_kf']}); scale-aligned ATE "
        f"{ate9 * 1e3:.3f} mm (reference {REF_MONO['ate_scale_aligned_m'] * 1e3:.3f} mm); device ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in slice_ms.items())
        + f"; device operations {slice_ops}; peak {peak9:.1f} MiB; phase 9 took {time.time() - t_p9:.1f} s")
    bad = []
    if slam.state != REF_MONO["state"] or len(slam.trajectory) != MONO_FRAMES:
        bad.append(f"final state {slam.state}, {len(slam.trajectory)} frames recorded")
    if init != REF_MONO["init_frame"]:
        bad.append(f"initialized at frame {init}, the reference at {REF_MONO['init_frame']}")
    if abs(slam.n_kf - REF_MONO["n_kf"]) > MONO_KF_TOL:
        bad.append(f"{slam.n_kf} keyframes, the reference's {REF_MONO['n_kf']}")
    if rec["loops_closed"] != REF_MONO["loops_closed"] or rec["lost_frames"] != REF_MONO["lost_frames"]:
        bad.append(f"{rec['loops_closed']} loops closed and {rec['lost_frames']} frames decided lost, the "
                   f"reference's {REF_MONO['loops_closed']} and {REF_MONO['lost_frames']}")
    if not ate9 <= REF_MONO["ate_scale_aligned_m"] + ATE_MARGIN:
        bad.append(f"scale-aligned ATE {ate9} m")
    if len(init_reads) != 1 or len(init_reads[0]) > MONO_INIT_REF_READS:
        bad.append(f"initialization host reads {rec['init_call_host_reads']}, the reference's {MONO_INIT_REF_READS}")
    tracking_syncs = sum(f["syncs"] for f in records if f["kind"] in ("tracking", "keyframe"))
    if tracking_syncs:
        bad.append(f"{tracking_syncs} synchronizing calls in tracked frames: {rec['sync_calls']}")
    for k, n in LAUNCHES_PER_MONO_FRAME.items():
        if launches9[k] < n * (MONO_FRAMES - 1 - REF_MONO["init_frame"]):
            bad.append(f"{k}: {launches9[k]} launches over the pass")
    if bad:
        raise AssertionError("phase 9: " + "; ".join(bad))
    return rec


def phase10(dev, counters, per_kernel, smi):
    """Phase 10: the monocular-inertial pass at bench scale (see the module
    docstring). Prints its JSON line, raises on a failed check, holds the
    three kernels against their plain versions at one monocular-inertial
    frame's inputs (into ``per_kernel``) and returns the pass's record."""
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial

    cfg = mi_config()
    t_p10 = time.time()
    gt10, frames10, imu10 = render_si_sequence(cfg, MI_FRAMES, dev, mono=True, excitation=3.0)
    torch.cuda.synchronize()
    kcalls = {}

    def warm_frame(i, slam, call):
        if i != MONO_PROFILE_FRAME:
            call()
            return
        torch.cuda.synchronize()
        with recording_kernel_calls(kcalls):
            call()
            torch.cuda.synchronize()

    warm, _, warm_init, _ = run_mono(cfg, frames10[:MONO_WARMUP], dev, imu=imu10, on_frame=warm_frame)
    warm.flush_decisions()
    del warm
    torch.cuda.synchronize()
    log(f"phase 10: rendered {MI_FRAMES} images and their IMU samples and ran a {MONO_WARMUP}-frame warm-up "
        f"pass (init at frame {warm_init}) in {time.time() - t_p10:.1f} s")
    run_checks(main_path_checks(kcalls, f"mono-inertial frame {MONO_PROFILE_FRAME}: "), counters, per_kernel)

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    lat, records, last, solves = [], [], {}, []
    t_pass = time.perf_counter()
    with recording_last_call(inertial, "initialize_imu", last, solves):
        watch = watched_frames(records, lat)
        slam, kf_at, init, imu_init = run_mono(cfg, frames10, dev, imu=imu10, on_frame=watch, timer=True)
        slam.flush_decisions()
        slam.t_cw.cpu()
    pass_s = time.perf_counter() - t_pass
    launches10 = {k: fn.launches for k, fn in counters.items()}
    peak10 = torch.cuda.max_memory_allocated() / 2**20
    _, centers, _ = slam.trajectory_arrays()
    g = gt10[: len(centers)]
    ate10 = ate.ate_rmse(centers, g)
    c10, g10 = centers[::10], g[::10]
    ratio = float(np.linalg.norm(np.diff(c10, axis=0), axis=1).sum() / np.linalg.norm(np.diff(g10, axis=0), axis=1).sum())
    g_end = slam.gravity.cpu().tolist()
    scale_calls = [(a, k, out) for a, k, out in solves if k.get("estimate_scale")]
    scales = [float(out[2]) for _, _, out in scale_calls]
    # the card's scale solve against the port's on the CPU at the pass's
    # own inputs (the CPU's against the reference's: tests/test_torch_mono.py)
    solve = {}
    if scale_calls:
        a, k, _ = scale_calls[0]
        card, host = inertial.initialize_imu(*a, **k), inertial.initialize_imu(*on_device(a, "cpu"), **k)
        solve = dict(scale_card=float(card[2]), scale_cpu=float(host[2]),
                     rerun_vs_pass=float(card[2]) / scales[0] - 1.0,
                     gravity_card_vs_cpu_rad=gravity_angle(card[1].cpu(), host[1]))
    slice_ms = {}
    if "initialize_imu" in last:
        a, k = last["initialize_imu"]
        slice_ms["initialize_imu_scale"] = profiled_device_ms(lambda: inertial.initialize_imu(*a, **k))
    lat_s = np.array(lat[5:])
    rec = dict(
        frames=len(slam.trajectory), state=slam.state, init_frame=init, imu_init=imu_init, keyframes=slam.n_kf,
        keyframe_frames=kf_at, loops_closed=slam.loop_closer.n_loops_closed, stats=slam.stats,
        lost_frames=watch.calls.get("lost", 0), relocalizations=watch.calls.get("relocalized", 0),
        landmarks=int(slam.ms.lm_valid.sum()), ate_m=ate10,
        ate_scale_aligned_m=ate.ate_rmse(centers, g, with_scale=True), path_ratio_stride10=ratio,
        imu_scales=scales, scale_solve_card_vs_cpu=solve,
        gravity_end=g_end, gravity_end_vs_ref_rad=gravity_angle(g_end, REF_MI["gravity_end"]), ref=REF_MI,
        frame_p50_ms=float(np.percentile(lat_s, 50)), frame_p99_ms=float(np.percentile(lat_s, 99)),
        frame_max_ms=float(lat_s.max()), frames_per_s=MI_FRAMES / pass_s, peak_mib=peak10, launches=launches10,
        slice_device_ms=slice_ms, syncs_by_kind=sync_summary(records),
        sync_calls=sorted({c for f in records if f["kind"] in ("tracking", "keyframe") for c in f["sync_calls"]})[:8],
        host_stage_ms={k: {"count": v["count"], "p50_ms": v["p50_ms"], "max_ms": v["max_ms"],
                           "total_ms": v["total_ms"]} for k, v in slam.timer.summary().items()},
    )
    log(f"phase 10 ({smi}): " + json.dumps(rec))
    log(f"phase 10: {MI_FRAMES} frames in {pass_s:.2f} s ({rec['frames_per_s']:.2f} frames/s), frame wall p50 "
        f"{rec['frame_p50_ms']:.2f} ms p99 {rec['frame_p99_ms']:.2f} ms; init at frame {init}, IMU init {imu_init} "
        f"(reference frame {REF_MI['imu_init']['frame']}, {REF_MI['imu_init']['n_kf']} keyframes); ATE "
        f"{ate10:.4f} m (reference {REF_MI['ate_m']:.4f} m), scale-aligned {rec['ate_scale_aligned_m']:.4f} m "
        f"(reference {REF_MI['ate_scale_aligned_m']:.4f} m); stride-10 scale {ratio:.4f} (reference "
        f"{REF_MI['path_ratio_stride10']:.4f}); solved scale {scales} (reference {REF_MI['imu_scale']:.5f}); "
        f"gravity {rec['gravity_end_vs_ref_rad']:.2e} rad from the reference's; "
        f"device ms {slice_ms}; peak {peak10:.1f} MiB; phase 10 took {time.time() - t_p10:.1f} s")
    bad = []
    if slam.state != REF_MI["state"] or len(slam.trajectory) != MI_FRAMES:
        bad.append(f"final state {slam.state}, {len(slam.trajectory)} frames recorded")
    if init != REF_MI["init_frame"]:
        bad.append(f"two-view initialization at frame {init}, the reference's at {REF_MI['init_frame']}")
    if imu_init is None or (imu_init["frame"], imu_init["n_kf"]) != (REF_MI["imu_init"]["frame"],
                                                                     REF_MI["imu_init"]["n_kf"]):
        bad.append(f"IMU init {imu_init}, the reference's {REF_MI['imu_init']}")
    if rec["loops_closed"] != REF_MI["loops_closed"] or rec["lost_frames"] != REF_MI["lost_frames"]:
        bad.append(f"{rec['loops_closed']} loops closed and {rec['lost_frames']} frames decided lost, the "
                   f"reference's {REF_MI['loops_closed']} and {REF_MI['lost_frames']}")
    ate_allowed = REF_MI["ate_m"] * (1.0 + MI_SCALE_REL_TOL) + ATE_MARGIN
    if not ate10 <= ate_allowed:
        bad.append(f"ATE {ate10} m, more than {ate_allowed} m")
    if not rec["ate_scale_aligned_m"] <= REF_MI["ate_scale_aligned_m"] + ATE_MARGIN:
        bad.append(f"scale-aligned ATE {rec['ate_scale_aligned_m']} m")
    if len(scales) != 1 or not abs(scales[0] / REF_MI["imu_scale"] - 1.0) <= MI_SCALE_REL_TOL:
        bad.append(f"solved scales {scales}, the reference's {REF_MI['imu_scale']}")
    if not (solve and abs(solve["scale_card"] / solve["scale_cpu"] - 1.0) <= MI_SOLVE_TOL
            and abs(solve["rerun_vs_pass"]) <= MI_SOLVE_TOL and solve["gravity_card_vs_cpu_rad"] <= MI_SOLVE_TOL):
        bad.append(f"the scale solve on the card against the CPU at the same inputs: {solve}")
    if not abs(ratio / REF_MI["path_ratio_stride10"] - 1.0) <= MI_SCALE_REL_TOL:
        bad.append(f"stride-10 scale {ratio}, the reference's {REF_MI['path_ratio_stride10']}")
    if not rec["gravity_end_vs_ref_rad"] <= MI_GRAVITY_TOL:
        bad.append(f"final gravity {rec['gravity_end_vs_ref_rad']:.4f} rad from the reference's")
    tracking_syncs = sum(f["syncs"] for f in records if f["kind"] in ("tracking", "keyframe"))
    if tracking_syncs:
        bad.append(f"{tracking_syncs} synchronizing calls in tracked frames: {rec['sync_calls']}")
    for k in LAUNCHES_PER_MONO_FRAME:
        if launches10[k] < MI_FRAMES - 1:
            bad.append(f"{k}: {launches10[k]} launches over the pass")
    if bad:
        raise AssertionError("phase 10: " + "; ".join(bad))
    return rec


# Phases 11-13: the RGB-D pass (phase 4's strafe as the left image and its
# rendered depth), the stereo-fisheye pass (the same strafe through two
# 512x512 Kannala-Brandt cameras 0.10 m apart) and the
# stereo-fisheye-inertial pass (phase 8's AnalyticTrajectory through that
# rig, TUM-VI's own mode). Each runs a SENSOR_WARMUP-frame warm-up pass,
# then one pass that blocks on each frame's pose under the sync debug mode
# and records the kernels' inputs at one tracked frame (PROFILE_FRAME).
# Phases 11, 12 and 13 run the first 60, 40 and 80 of their 130 frames (cut
# to fit the script's time as phases 14 and 15 came, against references cut
# alike).
SENSOR_FRAMES, SENSOR_WARMUP = {"rgbd": 60, "fisheye": 40, "fsi": 80}, 6
SENSOR_KF_TOL, FSI_GRAVITY_TOL = 2, 0.01
PROFILE_FRAME = {"rgbd": 10, "fisheye": 10, "fsi": 75}
# TUM-VI's 512x512 Kannala-Brandt calibration (the JAX package's
# tests/test_camera.py:12), both cameras; the right camera 0.10 m along x
KB8_TUMVI = (190.978, 190.973, 254.932, 256.897, 0.00348, 0.000715, -0.00205, 0.000581)
FISH_HW, FISH_BASE = 512, 0.10
# launches of each kernel per tracked frame: the front end's FAST and patch
# gather (one batch: one image, or both fisheye views) and tracking's three
# projection searches (the fisheye's left-right match is the plain matcher)
LAUNCHES_PER_SENSOR_FRAME = {"fast_nms": 1, "gather_patches": 1, "masked_best2": 3}
# tools/jax_sensor_ref.py (one JAX device, asynchronous dispatch off, on a
# CPU): --pass rgbd --frames 60 (40 s; at 90 frames: 10 keyframes, ATE
# 3.491 mm; the whole 130 frames: 14 keyframes, ATE 4.774 mm), --pass
# fisheye --frames 40 (52 s; at 60 frames: 7 keyframes, ATE 3.005 mm; the
# whole 130: 14 keyframes, ATE 2.835 mm, 212 rig rows),
# --pass fsi --frames 80 (189 s; at 90 frames: 10 keyframes, ATE 1.966 mm;
# the whole 130: 14 keyframes, ATE 2.025 mm, 368 rig rows, VIBA1 at 14
# keyframes; a pass that ends before VIBA1 runs it once on its final map:
# viba1_gravity)
REF_RGBD = dict(state=1, n_kf=7, keyframe_frames=[0, 5, 13, 25, 33, 45, 53],
                loops_closed=0, lost_frames=0, landmarks=1730, ate_m=0.003207332983656666)
REF_FISHEYE = dict(state=1, n_kf=5, keyframe_frames=[0, 9, 17, 29, 37],
                   loops_closed=0, lost_frames=0, landmarks=914, ate_m=0.0032515407378539266, rig_rows_newest_kf=304)
REF_FSI = dict(state=1, n_kf=9, keyframe_frames=[0, 9, 17, 29, 37, 49, 57, 69, 77],
               loops_closed=0, lost_frames=0, landmarks=1231, ate_m=0.0019204279506391674, rig_rows_newest_kf=337,
               imu_init=dict(frame=69, n_kf=8, gravity=[0.4552295207977295, 9.788310050964355, -0.4667590260505676]),
               gravity_end=[0.4552295207977295, 9.788310050964355, -0.4667590260505676],
               viba1_gravity=[0.45506468415260315, 9.78825855255127, -0.46800827980041504])
SENSOR_REF = {"rgbd": REF_RGBD, "fisheye": REF_FISHEYE, "fsi": REF_FSI}


def sensor_config(kind, small=False):
    """The SLAMConfig of phase 11 (``rgbd``: ``loop_config()`` with an RGBD
    sensor), 12 (``fisheye``: the same capacity, ORB and keyframe settings
    on two KB8_TUMVI cameras FISH_BASE apart, STEREO) or 13 (``fsi``:
    ``si_config()`` on that rig, IMU_STEREO). ``small``: the fisheye rig of
    the JAX package's tests/test_fisheye.py (256x256, fx 95, 500 features,
    24 keyframe slots) with synchronous decisions, and for ``rgbd`` its
    tests/test_slam_e2e.small_config() with synchronous decisions."""
    from orb_slam3_detailed_comments_kor_tpu_torch.config import (
        CameraConfig, CapacityConfig, ORBConfig, SensorType, TrackingConfig,
    )

    if kind == "rgbd":
        if small:
            cfg = dataclasses.replace(loop_config(small=True, closure=True),
                                      tracking=TrackingConfig(max_frames_between_kf=10, decision_batch=1))
        else:
            cfg = loop_config()
        return dataclasses.replace(cfg, sensor=SensorType.RGBD)
    tlr = (1.0, 0.0, 0.0, FISH_BASE, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    if small:
        hw, fx, dist = 256, 95.0, (0.0034, 0.00077, -0.0039, 0.00095)
        k8 = (fx, fx, hw / 2.0, hw / 2.0) + dist
        cam = CameraConfig(width=hw, height=hw, fx=fx, fy=fx, cx=hw / 2.0, cy=hw / 2.0, bf=FISH_BASE * fx,
                           model="kannala_brandt8", dist=dist, right_intrinsics=k8, tlr=tlr)
        cfg = dataclasses.replace(
            loop_config(), camera=cam, orb=ORBConfig(n_features=500, cell_size=20),
            capacity=CapacityConfig(max_keyframes=24, max_landmarks=4096, max_local_landmarks=2048),
            tracking=TrackingConfig(max_frames_between_kf=8, decision_batch=1))
    else:
        k8 = KB8_TUMVI
        cam = CameraConfig(width=FISH_HW, height=FISH_HW, fx=k8[0], fy=k8[1], cx=k8[2], cy=k8[3],
                           bf=FISH_BASE * k8[0], model="kannala_brandt8", dist=k8[4:], right_intrinsics=k8, tlr=tlr)
        cfg = dataclasses.replace(si_config() if kind == "fsi" else loop_config(), camera=cam)
    if kind == "mono":
        return dataclasses.replace(cfg, sensor=SensorType.MONOCULAR,
                                   camera=dataclasses.replace(cam, bf=0.0, right_intrinsics=None, tlr=None))
    return cfg


def render_sensor_sequence(kind, cfg, n, dev, speed=SPEED):
    """The pass's data at ``cfg``'s camera on ``dev``: ground-truth centres
    [n, 3] (numpy), the per-frame inputs ((image, depth) for ``rgbd``, a
    raw fisheye pair otherwise) and (``fsi``) the per-frame IMU samples."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic
    from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod

    if kind == "fsi":
        return render_si_sequence(cfg, n, dev, baseline=FISH_BASE)
    c = cfg.camera
    cam = cam_mod.camera_params_from_config(c, device=dev)
    scene = synthetic.default_scene(dev)
    Rs, ts = synthetic.make_trajectory(n, "strafe", speed=speed)
    frames = []
    for i in range(n):
        R, t = torch.from_numpy(Rs[i]).to(dev), torch.from_numpy(ts[i]).to(dev)
        if kind == "rgbd":
            frames.append(synthetic.render(cam, R, t, scene, h=c.height, w=c.width))
        elif kind == "mono":
            frames.append(synthetic.render(cam, R, t, scene, h=c.height, w=c.width, model=c.model)[0])
        else:
            frames.append(synthetic.stereo_pair(cam, R, t, FISH_BASE, scene, h=c.height, w=c.width,
                                                model=c.model)[:2])
    return ts, frames, None


def run_sensor(kind, cfg, frames, dev, imu=None, on_frame=None, timer=False, fps=FPS):
    """Feed a pass's frames to a new SlamSystem on ``dev`` (loop closing
    on) through ``track_rgbd``, ``track_mono``, ``track_stereo`` or (with
    ``imu``) ``track_stereo_inertial``. ``on_frame(i, slam, call)`` may
    wrap each frame's ``call()``. Returns (slam, the frames at which a
    keyframe was inserted, {frame, n_kf, gravity} at IMU initialization)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam.system import SlamSystem
    from orb_slam3_detailed_comments_kor_tpu_torch.utils.timing import StageTimer

    slam = SlamSystem(cfg, device=dev)
    slam.timer = StageTimer(enabled=timer)
    track = {"rgbd": slam.track_rgbd, "mono": slam.track_mono, "fisheye": slam.track_stereo,
             "fsi": slam.track_stereo_inertial}[kind]
    kf_at, init = [], None
    for i, f in enumerate(frames):
        n0 = slam.stats["kf_inserted"]
        args = (f,) if kind == "mono" else tuple(f)
        call = lambda _i=i, _a=args: track(*_a, _i / fps, *(() if imu is None else (imu[_i],)))
        on_frame(i, slam, call) if on_frame else call()
        if slam.stats["kf_inserted"] != n0:
            kf_at.append(i)
        if imu is not None and init is None and slam.imu_initialized:
            init = dict(frame=i, n_kf=slam.n_kf, gravity=slam.gravity.cpu().tolist())
    return slam, kf_at, init


def rig_rows(slam, kf):
    """Valid right-camera rows of keyframe ``kf``: its features with a
    matched right pixel."""
    return int(((slam.ms.kf_uvr[kf, :, 0] >= 0) & slam.ms.kf_feat_valid[kf]).sum())


def viba1_step(slam):
    """VIBA1, the stereo-inertial re-initialization that
    ``SlamSystem._insert_keyframe_inertial`` runs at the IMU init's
    keyframes + 6, run once on ``slam``'s map with the system's arguments
    under the sync debug mode: (its gravity, the synchronizing calls it
    made, its device ms)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial

    def step():
        return inertial.initialize_imu(slam.ms, slam.ikf, slam.n_kf, slam.gravity, slam.R_cb, slam.t_cb,
                                       estimate_scale=False)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, g1, _ = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0] for w in caught if SYNC_WARNING in str(w.message)})
    return dict(gravity=g1.cpu().tolist(), sync_calls=syncs[:8], device_ms=profiled_device_ms(step, reps=1))


def sensor_phase(kind, dev, counters, per_kernel, smi):
    """Phases 11 (``rgbd``), 12 (``fisheye``) and 13 (``fsi``): the pass at
    bench scale (see the module docstring). Prints its JSON line, raises on
    a failed check, holds the three kernels against their plain versions at
    one tracked frame's inputs (into ``per_kernel``) and returns the pass's
    record."""
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
    from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
    from orb_slam3_detailed_comments_kor_tpu_torch.optim import vio
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import inertial, tracking

    phase = {"rgbd": 11, "fisheye": 12, "fsi": 13}[kind]
    ref, prof_i, n_frames = SENSOR_REF[kind], PROFILE_FRAME[kind], SENSOR_FRAMES[kind]
    cfg = sensor_config(kind)
    t_ph = time.time()
    gt, frames, imu = render_sensor_sequence(kind, cfg, n_frames, dev)
    voc.load_default(dev)
    warm, _, _ = run_sensor(kind, cfg, frames[:SENSOR_WARMUP], dev, imu=imu)
    warm.flush_decisions()
    del warm
    torch.cuda.synchronize()
    log(f"phase {phase}: rendered {n_frames} frames and ran a {SENSOR_WARMUP}-frame warm-up pass in "
        f"{time.time() - t_ph:.1f} s")

    # the timed pass: every frame blocks on its pose and runs under the sync
    # debug mode; the launch counters and the peak memory are its own, and it
    # records the kernels' inputs at one tracked frame
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    lat, records, last, kcalls = [], [], {}, {}
    watch = watched_frames(records, lat)

    def on_frame(i, slam, call):
        if i != prof_i:
            return watch(i, slam, call)
        if slam.state != 1 or (kind == "fsi" and not slam.imu_initialized):
            raise AssertionError(f"phase {phase}: frame {i} is not tracked (with the IMU)")
        with recording_kernel_calls(kcalls):
            watch(i, slam, call)

    step = {"rgbd": "full_rgbd_step", "fisheye": "full_fisheye_step", "fsi": "full_fisheye_step"}[kind]
    t_pass = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(recording_last_call(tracking, step, last))
        stack.enter_context(recording_last_call(tracking, "local_ba_step", last))
        if kind == "fsi":
            stack.enter_context(recording_last_call(vio, "vio_frame_step", last))
            stack.enter_context(recording_last_call(inertial, "local_vi_ba_step", last))
        slam, kf_at, init = run_sensor(kind, cfg, frames, dev, imu=imu, on_frame=on_frame, timer=True)
        slam.flush_decisions()
        slam.t_cw.cpu()
    pass_s = time.perf_counter() - t_pass
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**20
    _, centers, _ = slam.trajectory_arrays()
    ate_m = ate.ate_rmse(centers, gt[: len(centers)])
    if LAUNCHES_PER_SENSOR_FRAME.keys() - kcalls.keys():
        raise AssertionError(f"phase {phase}: kernel calls at frame {prof_i}: {sorted(kcalls)}")
    t_post = time.time()
    run_checks(main_path_checks(kcalls, f"{kind} frame {prof_i}: "), counters, per_kernel)
    t_checks = time.time() - t_post

    # one call of each kind alone, on the device, with the pass's inputs
    replay = lambda mod, name: (lambda: getattr(mod, name)(*last[name][0], **last[name][1]))
    slices = {step: replay(tracking, step)}
    lba = "local_vi_ba_step" if kind == "fsi" else "local_ba_step"
    if lba in last:
        slices[lba] = replay(inertial if kind == "fsi" else tracking, lba)
    if kind == "fsi":
        slices["vio_frame_step"] = replay(vio, "vio_frame_step")
    profiled = {k: profiled_device_ms(f, reps=1, ops=True) for k, f in slices.items()}
    slice_ms = {k: v[0] for k, v in profiled.items()}
    slice_ops = {k: v[1] for k, v in profiled.items()}
    capture = {k: graph_capture_error(slices[k]) for k in slices if k != step}
    spread = None
    if kind != "rgbd" and lba in last:
        a, k = last[lba]
        if kind == "fsi":
            spread = local_ba_spread(lambda: slices[lba]()[0], a[0])
        else:
            spread = local_ba_spread(slices[lba], a[0])
    lat_s = np.array(lat[5:])
    rec = dict(
        frames=len(slam.trajectory), state=slam.state, keyframes=slam.n_kf, keyframe_frames=kf_at,
        loops_closed=slam.loop_closer.n_loops_closed, stats=slam.stats, lost_frames=watch.calls.get("lost", 0),
        landmarks=int(slam.ms.lm_valid.sum()), ate_m=ate_m, ref=ref,
        frame_p50_ms=float(np.percentile(lat_s, 50)), frame_p99_ms=float(np.percentile(lat_s, 99)),
        frame_max_ms=float(lat_s.max()), frames_per_s=n_frames / pass_s, peak_mib=peak, launches=launches,
        slice_device_ms=slice_ms, slice_device_ops=slice_ops, stereo_step_stream_ops=16077,
        slice_graph_capture_error=capture, syncs_by_kind=sync_summary(records),
        sync_calls=sorted({c for f in records if f["kind"] in ("tracking", "keyframe") for c in f["sync_calls"]})[:8],
        slice_frame_sync_calls=sorted({f"{f['kind']}: {c}" for f in records
                                       if f["kind"] not in ("tracking", "keyframe") for c in f["sync_calls"]})[:8],
        host_stage_ms={k: {"count": v["count"], "p50_ms": v["p50_ms"], "max_ms": v["max_ms"],
                           "total_ms": v["total_ms"]} for k, v in slam.timer.summary().items()},
    )
    if kind != "rgbd":
        rec.update(rig_rows_newest_kf=rig_rows(slam, slam.n_kf - 1), rig_local_ba_spread=spread)
    if kind == "fsi":
        g_end = slam.gravity.cpu().tolist()
        viba1 = viba1_step(slam)
        rec.update(imu_init=init, gravity_end=g_end, gravity_end_vs_ref_rad=gravity_angle(g_end, ref["gravity_end"]),
                   viba1=viba1, viba1_vs_ref_rad=gravity_angle(viba1["gravity"], ref["viba1_gravity"]))
    log(f"phase {phase} ({smi}): " + json.dumps(rec))
    log(f"phase {phase}: {n_frames} frames in {pass_s:.2f} s ({rec['frames_per_s']:.2f} frames/s), frame "
        f"wall p50 {rec['frame_p50_ms']:.2f} ms p99 {rec['frame_p99_ms']:.2f} ms; {slam.n_kf} keyframes (reference "
        f"{ref['n_kf']}); ATE {ate_m * 1e3:.3f} mm (reference {ref['ate_m'] * 1e3:.3f} mm); device ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in slice_ms.items())
        + f"; device operations {slice_ops}; peak {peak:.1f} MiB; phase {phase} took {time.time() - t_ph:.1f} s "
        f"(the pass {pass_s:.1f} s, the kernel checks {t_checks:.1f} s, the slices {time.time() - t_post - t_checks:.1f} s)")
    bad = []
    if slam.state != ref["state"] or len(slam.trajectory) != n_frames:
        bad.append(f"final state {slam.state}, {len(slam.trajectory)} frames recorded")
    if abs(slam.n_kf - ref["n_kf"]) > SENSOR_KF_TOL:
        bad.append(f"{slam.n_kf} keyframes, the reference's {ref['n_kf']}")
    if rec["loops_closed"] != ref["loops_closed"] or rec["lost_frames"] != ref["lost_frames"]:
        bad.append(f"{rec['loops_closed']} loops closed and {rec['lost_frames']} frames decided lost, the "
                   f"reference's {ref['loops_closed']} and {ref['lost_frames']}")
    if not ate_m <= ref["ate_m"] + ATE_MARGIN:
        bad.append(f"ATE {ate_m} m")
    if kind == "fsi":
        if init is None or (init["frame"], init["n_kf"]) != (ref["imu_init"]["frame"], ref["imu_init"]["n_kf"]):
            bad.append(f"IMU init {init}, the reference's {ref['imu_init']}")
        if not rec["gravity_end_vs_ref_rad"] <= FSI_GRAVITY_TOL:
            bad.append(f"final gravity {rec['gravity_end_vs_ref_rad']:.4f} rad from the reference's")
        if viba1["gravity"] == g_end:
            bad.append("VIBA1 left the gravity as it was")
        if viba1["sync_calls"]:
            bad.append(f"VIBA1 made synchronizing calls: {viba1['sync_calls']}")
        if not rec["viba1_vs_ref_rad"] <= FSI_GRAVITY_TOL:
            bad.append(f"VIBA1's gravity {rec['viba1_vs_ref_rad']:.4f} rad from the reference's")
    if kind != "rgbd":
        if rec["rig_rows_newest_kf"] < 100:
            bad.append(f"{rec['rig_rows_newest_kf']} valid rig rows in the newest keyframe")
        if spread is None or any(v != 0 for v in spread.values()):
            bad.append(f"the rig local-BA slice: spread {spread}")
    for k, err in capture.items():
        if err is not None:
            bad.append(f"{k}: not capturable in a CUDA graph: {err}")
    tracking_syncs = sum(f["syncs"] for f in records if f["kind"] in ("tracking", "keyframe"))
    if tracking_syncs:
        bad.append(f"{tracking_syncs} synchronizing calls in tracked frames: {rec['sync_calls']}")
    for k, n in LAUNCHES_PER_SENSOR_FRAME.items():
        if launches[k] < n * (n_frames - 1):
            bad.append(f"{k}: {launches[k]} launches over the pass")
    if bad:
        raise AssertionError(f"phase {phase}: " + "; ".join(bad))
    return rec


# Phase 14: the dataset runner on a recorded sequence. Phase 8's
# stereo-inertial data (bench.py's ``bench_stereo_inertial``, all 130
# frames: with the settings file's tracking defaults, a keyframe at least
# every 20 frames, the IMU initializes at frame 117) written in the EuRoC
# MAV layout with absolute EuRoC-like stamps (ROADMAP F29) and run by the
# port's ``examples/run_dataset.py``; its first DS_ONLINE_FRAMES frames are
# replayed through ``io/online.OnlineNode`` from three producer threads.
DS_FRAMES, DS_ONLINE_FRAMES, DS_PROFILE_FRAME = 130, 15, 125
DS_T0_NS = 1403636579763555584


def write_png_gray(path, img, bits=8):
    """A grayscale PNG of ``img`` (values rounded and clipped to the bit
    depth's range): 8 bits, EuRoC's image format, or 16 bits, TUM RGB-D's
    depth maps; written with the standard library's zlib, one filter-0
    scanline per row."""
    import struct
    import zlib

    a = np.clip(np.rint(np.asarray(img, np.float64)), 0, 2**bits - 1).astype(">u2" if bits == 16 else np.uint8)
    h, w = a.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.view(np.uint8).reshape(h, -1)], axis=1).tobytes()

    def chunk(kind, data):
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def needed_libraries(path):
    """The shared libraries an ELF file names as NEEDED (``readelf -d``)."""
    out = subprocess.run(["readelf", "-d", path], capture_output=True, text=True, check=True).stdout
    return [line.split("[", 1)[1].split("]", 1)[0] for line in out.splitlines() if "(NEEDED)" in line]


def _yaml_matrix(name, m):
    m = np.asarray(m, np.float64)
    data = ", ".join(repr(float(x)) for x in m.reshape(-1))
    return f"{name}: !!opencv-matrix\n   rows: {m.shape[0]}\n   cols: {m.shape[1]}\n   dt: d\n   data: [{data}]\n"


def euroc_settings(cfg):
    """A settings YAML in the reference's format (``Camera.*``,
    ``Camera.bf``, ``ThDepth``, ``ORBextractor.*``, ``IMU.*``, ``Tbc`` and
    the ``LEFT.*`` / ``RIGHT.*`` rectification blocks) for ``cfg``'s
    rectified pinhole pair: K as the camera's, no distortion, R the
    identity, P = [K | 0] and [K | (-bf, 0, 0)], so that the rectification
    maps are the pixel grid up to rounding and ``datasets.Rectifier`` and
    the native remap run."""
    c, o, imu = cfg.camera, cfg.orb, cfg.imu
    K = np.array([[c.fx, 0.0, c.cx], [0.0, c.fy, c.cy], [0.0, 0.0, 1.0]])
    lines = ["%YAML:1.0", 'Camera.type: "PinHole"']
    for k, v in (("fx", c.fx), ("fy", c.fy), ("cx", c.cx), ("cy", c.cy), ("k1", 0.0), ("k2", 0.0), ("p1", 0.0),
                 ("p2", 0.0), ("width", c.width), ("height", c.height), ("fps", c.fps), ("bf", c.bf)):
        lines.append(f"Camera.{k}: {v!r}")
    lines += [f"ThDepth: {c.th_depth!r}", f"ORBextractor.nFeatures: {o.n_features}",
              f"ORBextractor.scaleFactor: {o.scale_factor!r}", f"ORBextractor.nLevels: {o.n_levels}",
              f"ORBextractor.iniThFAST: {o.ini_th_fast}", f"ORBextractor.minThFAST: {o.min_th_fast}",
              f"IMU.NoiseGyro: {imu.noise_gyro!r}", f"IMU.NoiseAcc: {imu.noise_acc!r}",
              f"IMU.GyroWalk: {imu.gyro_walk!r}", f"IMU.AccWalk: {imu.acc_walk!r}",
              f"IMU.Frequency: {imu.frequency!r}", f"LEFT.height: {c.height}", f"LEFT.width: {c.width}"]
    text = "\n".join(lines) + "\n" + _yaml_matrix("Tbc", np.reshape(imu.tbc, (4, 4)))
    for side, px in (("LEFT", 0.0), ("RIGHT", -c.bf)):
        text += (_yaml_matrix(f"{side}.D", np.zeros((1, 5))) + _yaml_matrix(f"{side}.K", K)
                 + _yaml_matrix(f"{side}.R", np.eye(3))
                 + _yaml_matrix(f"{side}.P", np.c_[K, [px, 0.0, 0.0]]))
    return text


def write_euroc_sequence(root, cfg, frames, imu_pf, gt_pos, gt_R, fps=FPS, t0_ns=DS_T0_NS):
    """Write a stereo-inertial sequence in the EuRoC MAV layout under
    ``root``: ``mav0/cam0|cam1/data/<ns>.png`` (8-bit PNGs) with their
    ``data.csv``, ``mav0/imu0/data.csv`` (``t[ns], w, a``), the ground truth
    ``mav0/state_groundtruth_estimate0/data.csv`` (``t[ns], p, q_wxyz``) and
    ``settings.yaml``. ``frames``: (left, right) images (arrays or tensors);
    ``imu_pf``: each frame's samples (t, acc, gyro) with t in seconds from
    the first frame, stamped ``t0_ns`` + t. Returns (root, settings path,
    ground-truth path, the frames' stamps in ns)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import trajectory as traj_io

    mav = os.path.join(root, "mav0")
    stamps = [t0_ns + int(round(i * 1e9 / fps)) for i in range(len(frames))]
    for cam, side in (("cam0", 0), ("cam1", 1)):
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ns, pair in zip(stamps, frames):
                img = pair[side]
                write_png_gray(os.path.join(mav, cam, "data", f"{ns}.png"),
                               img.cpu().numpy() if isinstance(img, torch.Tensor) else img)
                f.write(f"{ns},{ns}.png\n")
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],w_RS_S_z [rad s^-1],"
                "a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],a_RS_S_z [m s^-2]\n")
        for row in imu_pf:
            for t, acc, gyro in row:
                vals = [float(v) for v in np.asarray(gyro, np.float32)] + [float(v) for v in np.asarray(acc, np.float32)]
                f.write(f"{t0_ns + int(round(t * 1e9))}," + ",".join(f"{v:.9g}" for v in vals) + "\n")
    gt_dir = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)
    gt_path = os.path.join(gt_dir, "data.csv")
    q = traj_io._quats_wxyz(np.asarray(gt_R, np.float64))
    with open(gt_path, "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for ns, p, qq in zip(stamps, np.asarray(gt_pos, np.float64), q):
            f.write(f"{ns}," + ",".join(f"{v:.9f}" for v in (*p, *qq)) + "\n")
    settings = os.path.join(root, "settings.yaml")
    with open(settings, "w") as f:
        f.write(euroc_settings(cfg))
    return root, settings, gt_path, stamps


# The small recorded sequence of the CPU and cuda runner tests: 14 frames of
# si_config(small=True)'s 240x376 / 600-feature pair at 20 fps
SMALL_EUROC = dict(frames=14, fps=20.0)


def small_euroc_sequence(root):
    """Write the small stereo-inertial sequence of the runner tests under
    ``root`` in the EuRoC layout (rendered on the CPU). Returns
    ``write_euroc_sequence``'s (root, settings, ground truth, stamps)."""
    from orb_slam3_detailed_comments_kor_tpu_torch.io import synthetic

    n, fps = SMALL_EUROC["frames"], SMALL_EUROC["fps"]
    cfg = si_config(small=True)
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, fps=fps))
    gt, frames, imu = render_si_sequence(cfg, n, "cpu", fps=fps)
    traj = synthetic.AnalyticTrajectory(device="cpu")
    gt_R = np.stack([traj.pose(i / fps)[0].numpy() for i in range(n)])
    return write_euroc_sequence(root, cfg, frames, imu, gt, gt_R, fps=fps)


@contextlib.contextmanager
def keyframes_recorded(cls, name, rec):
    """Within the block every call of ``cls.name`` (a system's ``track_*``)
    appends to ``rec["kf_at"]`` the call's index when it inserted a
    keyframe, and ``rec["slam"]`` holds the system."""
    orig = getattr(cls, name)
    rec.setdefault("kf_at", [])
    rec["calls"] = 0

    def tracked(self, *a, **k):
        i, n0 = rec["calls"], self.stats["kf_inserted"]
        rec["calls"] += 1
        rec["slam"] = self
        out = orig(self, *a, **k)
        if self.stats["kf_inserted"] != n0:
            rec["kf_at"].append(i)
        return out
    setattr(cls, name, tracked)
    try:
        yield rec
    finally:
        setattr(cls, name, orig)


# tools/jax_sensor_ref.py --pass euroc --frames 130: the JAX package's
# examples/run_dataset.py on the same sequence (rendered by the JAX package,
# written by write_euroc_sequence) on a CPU, one device, asynchronous
# dispatch off and every decision read ready at its first chance (146 s).
# The runner builds its configuration from the settings file: the capacity
# and tracking defaults (512 keyframes, 32,768 landmarks, a keyframe at
# least every 20 frames).
REF_EUROC = dict(ate_m=0.0034981964132012526, state=1, n_kf=8, keyframe_frames=[0, 5, 17, 37, 57, 77, 97, 117],
                 imu_init=dict(frame=117, n_kf=8, gravity=[0.4502810537815094, 9.78847599029541,
                                                           -0.4680675268173218]),
                 loops_closed=0, lost_frames=0, landmarks=1621, trajectory_rows=130)
EUROC_KF_TOL = 2


def frame_rest_checks(dev, slam, images, fast_call, counters, per_kernel):
    """Phase 14's holds on one runner frame (``images``: its decoded and
    rectified pair; ``fast_call``: its recorded ``fast_nms`` arguments):
    the CUDA ``fast_nms_stack`` against the plain ``fast_with_fallback_stack``
    on the frame's stack; ``compute_stereo_matches`` over ragged
    ``build_pyramid`` levels, its ``gather_patches`` call on the [ΣH_l, W0]
    atlas held (and timed) against the plain version; ``transform_exact``
    on the frame's left descriptors, card against CPU, on the committed
    vocabulary. Launches of these checks come after the pass's counts were
    read. Returns the record."""
    from orb_slam3_detailed_comments_kor_tpu_torch.models import vocabulary as voc
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_fast, fast as fast_ops, orb as orb_ops
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid, stereo
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import frontend

    cfg = slam.cfg
    flat, hs, ws, th_hi, th_lo = fast_call
    hs, ws = tuple(int(v) for v in hs), tuple(int(v) for v in ws)
    bn, hp, wp = flat.shape
    inb = fast_ops.level_interior(hs, ws, 3, hp, wp, flat.device).expand(bn // len(hs), len(hs), hp, wp)
    inb = inb.reshape(bn, hp, wp)
    cell = cfg.orb.cell_size
    before = {k: fn.launches for k, fn in counters.items()}
    checks = [("fast_nms", f"runner frame {DS_PROFILE_FRAME}: fast_nms_stack {'x'.join(map(str, flat.shape))} "
               f"against fast_with_fallback_stack", lambda *a: cuda_fast.fast_nms_stack(
                   a[0], a[1], a[2], len(hs), a[3], a[4], cell),
               lambda *a: fast_ops.fast_with_fallback_stack(a[0], a[3], a[4], cell, inb),
               (flat, hs, ws, th_hi, th_lo), None, None)]
    il, ir = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in images)
    o = cfg.orb
    feats = orb_ops.extract_orb_batch(torch.stack([il, ir]), n_features=o.n_features, n_levels=o.n_levels,
                                      scale=o.scale_factor, ini_th=o.ini_th_fast, min_th=o.min_th_fast, cell=cell)
    fl, fr = frontend._view(feats, 0), frontend._view(feats, 1)
    pyr_l, pyr_r = (pyramid.build_pyramid(x, o.n_levels, o.scale_factor) for x in (il, ir))
    calls = {"fast_nms": [], "gather_patches": [], "masked_best2": []}
    with recording_kernel_calls(calls):
        sd = stereo.compute_stereo_matches(fl, fr, pyr_l, pyr_r, cfg.camera.bf, o.scale_factor)
        torch.cuda.synchronize()
    gathers = {"fast_nms": [], "gather_patches": calls["gather_patches"], "masked_best2": []}
    checks += main_path_checks(gathers, f"runner frame {DS_PROFILE_FRAME}, ragged atlas: ")
    run_checks(checks, counters, per_kernel)
    words_card = voc.transform_exact(voc.load_default(dev), fl.desc, fl.valid)
    words_cpu = voc.transform_exact(voc.load_default("cpu"), fl.desc.cpu(), fl.valid.cpu())
    rec = dict(fast_stack_exact=True, atlas=list(calls["gather_patches"][0][0].shape),
               ragged_gather_calls=len(calls["gather_patches"]), ragged_stereo_valid=int(sd.valid.sum()),
               descriptors=int(fl.valid.sum()), transform_exact_equal=torch.equal(words_card.cpu(), words_cpu),
               distinct_words=int(torch.unique(words_cpu[words_cpu >= 0]).numel()),
               check_launches={k: fn.launches - before[k] for k, fn in counters.items()})
    log(f"phase 14: frame {DS_PROFILE_FRAME} checks: {rec}")
    return rec


def phase14(dev, counters, per_kernel, smi):
    """Phase 14: the dataset runner on a recorded sequence (see the module
    docstring). Prints its JSON line, raises on a failed check, holds the
    three kernels against their plain versions at one frame's inputs (into
    ``per_kernel``) and returns the pass's record."""
    import shutil
    import tempfile
    import threading

    from orb_slam3_detailed_comments_kor_tpu_torch.config import SensorType
    from orb_slam3_detailed_comments_kor_tpu_torch.examples import run_dataset
    from orb_slam3_detailed_comments_kor_tpu_torch.io import datasets, native_host, online, synthetic
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import loop_closing
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as slam_mod

    ref = REF_EUROC
    t_ph = time.time()
    cfg = si_config()
    gt, frames, imu = render_si_sequence(cfg, DS_FRAMES, dev)
    traj = synthetic.AnalyticTrajectory(device=dev)
    gt_R = np.stack([traj.pose(i / FPS)[0].cpu().numpy() for i in range(DS_FRAMES)])
    try:
        native_host.load()
        so = native_host.library_path()
        native = dict(built=True, library=os.path.basename(so), libs=list(native_host.LIBS),
                      source=os.path.relpath(native_host.SOURCE, os.path.dirname(os.path.abspath(__file__))),
                      needed=needed_libraries(so))
    except Exception as e:  # reported, and failed below
        native = dict(built=False, error=(repr(e) + repr(e.__cause__))[-400:])
    own_source = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(native_host.__file__))), "native",
                              "host_ops.cpp")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_euroc_")
    try:
        t0 = time.time()
        root, settings_path, gt_path, stamps = write_euroc_sequence(tmp, cfg, frames, imu, gt, gt_R)
        write_s = time.time() - t0
        del frames
        log(f"phase 14: rendered {DS_FRAMES} frames and wrote them in the EuRoC layout in {time.time() - t_ph:.1f} s "
            f"(PNGs, CSVs and settings {write_s:.1f} s); native host library {native}")

        # the runner's pass: every frame under the sync debug mode (no block on
        # the pose: the runner's own frame times are what a user sees), the
        # kernels' inputs recorded at one tracked frame after the IMU init;
        # the first four keyframes' descriptors handed to the loop closer kept
        records, lat, kcalls, adds = [], [], {}, []
        watch = watched_frames(records, lat, block=False)
        track = slam_mod.SlamSystem.track_stereo_inertial
        add_kf = loop_closing.LoopCloser.add_keyframe
        rec = {"calls": 0, "kf_at": [], "init": None}

        def tracked(self, *a, **k):
            i, n0 = rec["calls"], self.stats["kf_inserted"]
            rec["calls"] += 1
            call = lambda: track(self, *a, **k)
            if i == DS_PROFILE_FRAME:
                if self.state != 1 or not self.imu_initialized:
                    raise AssertionError(f"phase 14: frame {i} is not tracked with the IMU")
                rec["images"] = (a[0].copy(), a[1].copy())  # the feeder's decoded, rectified pair
                with recording_kernel_calls(kcalls):
                    watch(i, self, call)
            else:
                watch(i, self, call)
            if self.stats["kf_inserted"] != n0:
                rec["kf_at"].append(i)
            if rec["init"] is None and self.imu_initialized:
                rec["init"] = dict(frame=i, n_kf=self.n_kf, gravity=self.gravity.cpu().tolist())
            return self.state

        def add_recorded(self, kf_idx, desc, valid):
            if len(adds) < 4:
                adds.append((desc.clone(), valid.clone()))
            return add_kf(self, kf_idx, desc, valid)

        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        out_path = os.path.join(tmp, "trajectory.csv")
        slam_mod.SlamSystem.track_stereo_inertial = tracked
        loop_closing.LoopCloser.add_keyframe = add_recorded
        try:
            res = run_dataset.main(["--mode", "stereo_inertial", "--dataset", "euroc", "--seq", root,
                                    "--settings", settings_path, "--out", out_path, "--gt", gt_path],
                                   device=dev)
        finally:
            slam_mod.SlamSystem.track_stereo_inertial = track
            loop_closing.LoopCloser.add_keyframe = add_kf
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        slam = res["slam"]
        rows = np.loadtxt(out_path, delimiter=",", ndmin=2)
        if LAUNCHES_PER_FRAME.keys() - kcalls.keys():
            raise AssertionError(f"phase 14: kernel calls at frame {DS_PROFILE_FRAME}: {sorted(kcalls)}")
        t_post = time.time()
        run_checks(main_path_checks(kcalls, f"dataset runner frame {DS_PROFILE_FRAME}: "), counters, per_kernel)
        t_checks = time.time() - t_post
        t_post = time.time()
        rest = frame_rest_checks(dev, res["slam"], rec["images"], kcalls["fast_nms"][0], counters, per_kernel)
        rest["seconds"] = time.time() - t_post

        # the online node: the first DS_ONLINE_FRAMES frames, decoded and
        # rectified, and their IMU samples published by three producer threads
        settings = datasets.load_settings(settings_path, SensorType.IMU_STEREO)
        seq = datasets.EurocSequence(root)
        seq.frames = seq.frames[:DS_ONLINE_FRAMES]
        pairs = list(run_dataset.build_feeder(seq, settings, "stereo_inertial"))
        t_last = seq.frames[-1].t
        tt, gg, aa = seq.imu.between(seq.frames[0].t - 1.0, t_last + 0.5 / FPS)
        slam2 = slam_mod.SlamSystem(settings.config, device=dev)
        node = online.OnlineNode(slam2, "stereo_inertial", max_queue=DS_ONLINE_FRAMES)
        node.start()
        producers = [
            threading.Thread(target=lambda: [node.publish_left(f.t, p[0]) for f, p in zip(seq.frames, pairs)]),
            threading.Thread(target=lambda: [node.publish_right(f.t, p[1]) for f, p in zip(seq.frames, pairs)]),
            threading.Thread(target=lambda: [node.publish_imu(float(t), a, g) for t, a, g in zip(tt, aa, gg)]),
        ]
        t0 = time.perf_counter()
        for th in producers:
            th.start()
        for th in producers:
            th.join()
        node.stop(drain=True, timeout=300.0)
        online_s = time.perf_counter() - t0
        node_rec = dict(processed=node.n_processed, dropped_left=node.left.n_dropped,
                        dropped_right=node.right.n_dropped, state=slam2.state, keyframes=slam2.n_kf,
                        frames=len(slam2.trajectory), seconds=online_s)
        del slam2, node, pairs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # online vocabulary training: a LoopCloser without a vocabulary on the
    # card, fed the pass's first four keyframes, against the same on the CPU
    def trained(device):
        lc = loop_closing.LoopCloser(max_kf=slam.ms.K, vocab=None)
        for i, (d, v) in enumerate(adds):
            lc.add_keyframe(i, d.to(device), v.to(device))
        return lc

    t0 = time.time()
    lc_card, lc_cpu = trained(dev), trained("cpu")
    vocab_s = time.time() - t0

    def dense_rows(lc):
        ids, wts = lc.db_words[: len(adds)].cpu().long(), lc.db_wts[: len(adds)].cpu()
        out = torch.zeros((len(adds), lc.vocab.n_words + 1))
        return out.scatter_add_(1, torch.where(ids >= 0, ids, lc.vocab.n_words), torch.where(ids >= 0, wts, 0.0))

    vocab_rec = dict(
        keyframes=len(adds), descriptors=int(sum(int(v.sum()) for _, v in adds)),
        k=lc_card.vocab_k, depth=lc_card.vocab_depth, trained=lc_card.vocab is not None,
        centroids_equal=bool(lc_card.vocab is not None and torch.equal(lc_card.vocab.centroids.cpu(),
                                                                      lc_cpu.vocab.centroids)),
        rows_max_abs_err=max_abs_err(dense_rows(lc_card), dense_rows(lc_cpu)) if lc_card.vocab is not None else None,
        seconds=vocab_s)

    times, centers, _ = slam.trajectory_arrays()
    lat_runner = np.array(res["frame_ms"][5:])
    feed, track_ms = np.array(res["feed_ms"][5:]), np.array(res["track_ms"][5:])
    record = dict(
        frames=len(slam.trajectory), trajectory_rows=int(rows.shape[0]), state=slam.state, keyframes=slam.n_kf,
        keyframe_frames=rec["kf_at"], imu_init=rec["init"], loops_closed=slam.loop_closer.n_loops_closed,
        lost_frames=watch.calls.get("lost", 0), landmarks=int(slam.ms.lm_valid.sum()), ate_m=res["ate_m"], ref=ref,
        stamps_ns=[stamps[0], stamps[-1]], decoder=res["decoder"], native_host=native,
        runner_wall_s=res["wall_s"], runner_frames_per_s=res["frames_per_s"],
        frame_p50_ms=float(np.percentile(lat_runner, 50)), frame_p99_ms=float(np.percentile(lat_runner, 99)),
        frame_max_ms=float(lat_runner.max()), feed_p50_ms=float(np.percentile(feed, 50)),
        feed_p99_ms=float(np.percentile(feed, 99)), feed_max_ms=float(feed.max()),
        track_p50_ms=float(np.percentile(track_ms, 50)), track_p99_ms=float(np.percentile(track_ms, 99)),
        track_call_p50_ms=float(np.percentile(lat[5:], 50)), peak_mib=peak, launches=launches,
        syncs_by_kind=sync_summary(records),
        sync_calls=sorted({c for f in records if f["kind"] in ("tracking", "keyframe") for c in f["sync_calls"]})[:8],
        online=node_rec, online_vocabulary=vocab_rec, gravity_end=slam.gravity.cpu().tolist(),
        stats=slam.stats, write_s=write_s, kernel_checks_s=t_checks, frame_checks=rest)
    log(f"phase 14 ({smi}): " + json.dumps(record))
    log(f"phase 14: the runner ran {DS_FRAMES} frames in {res['wall_s']:.2f} s ({res['frames_per_s']:.2f} frames/s, "
        f"decode and rectify included), frame wall p50 {record['frame_p50_ms']:.2f} ms p99 "
        f"{record['frame_p99_ms']:.2f} ms: the feeder wait p50 {record['feed_p50_ms']:.3f} ms p99 "
        f"{record['feed_p99_ms']:.3f} ms, the track call p50 {record['track_p50_ms']:.2f} ms; ATE {res['ate_m'] * 1e3:.3f} mm (JAX reference "
        f"{ref['ate_m'] * 1e3:.3f} mm); {slam.n_kf} keyframes (reference {ref['n_kf']}); IMU init {rec['init']} "
        f"(reference {ref['imu_init']}); decoder {res['decoder']}; online node {node_rec}; vocabulary {vocab_rec}; "
        f"peak {peak:.1f} MiB; phase 14 took {time.time() - t_ph:.1f} s")
    bad = []
    if slam.state != ref["state"] or len(slam.trajectory) != DS_FRAMES or rows.shape[0] != DS_FRAMES:
        bad.append(f"final state {slam.state}, {len(slam.trajectory)} frames recorded, {rows.shape[0]} trajectory rows")
    init = rec["init"]
    if init is None or (init["frame"], init["n_kf"]) != (ref["imu_init"]["frame"], ref["imu_init"]["n_kf"]):
        bad.append(f"IMU init {init}, the reference's {ref['imu_init']}")
    if abs(slam.n_kf - ref["n_kf"]) > EUROC_KF_TOL:
        bad.append(f"{slam.n_kf} keyframes, the reference's {ref['n_kf']}")
    if record["loops_closed"] != ref["loops_closed"] or record["lost_frames"] != ref["lost_frames"]:
        bad.append(f"{record['loops_closed']} loops closed and {record['lost_frames']} frames decided lost, the "
                   f"reference's {ref['loops_closed']} and {ref['lost_frames']}")
    if not res["ate_m"] <= ref["ate_m"] + ATE_MARGIN:
        bad.append(f"ATE {res['ate_m']} m")
    # the native decoder and feeder, from the port's own source, which needs
    # zlib and no libpng (the card's machine has none)
    if res["decoder"] != "native" or not native["built"] or native_host.SOURCE != own_source \
            or "-lpng" in native["libs"] or any("png" in n for n in native["needed"]):
        bad.append(f"the native decoder did not run from the port's zlib-only library: {native}, "
                   f"decoder {res['decoder']}")
    if not (rest["fast_stack_exact"] and rest["transform_exact_equal"] and rest["atlas"] == [2210, 752]
            and rest["ragged_stereo_valid"] >= 300):
        bad.append(f"frame {DS_PROFILE_FRAME}'s checks: {rest}")
    if (node_rec["processed"], node_rec["dropped_left"], node_rec["dropped_right"]) != (DS_ONLINE_FRAMES, 0, 0) \
            or node_rec["state"] != slam_mod.TrackingState.OK:
        bad.append(f"the online node: {node_rec}")
    tracking_syncs = sum(f["syncs"] for f in records if f["kind"] in ("tracking", "keyframe"))
    if tracking_syncs:
        bad.append(f"{tracking_syncs} synchronizing calls in tracked frames fed host arrays: {record['sync_calls']}")
    if not (vocab_rec["trained"] and vocab_rec["centroids_equal"] and vocab_rec["rows_max_abs_err"] <= 1e-5):
        bad.append(f"online vocabulary training, card against CPU: {vocab_rec}")
    for k, n in LAUNCHES_PER_FRAME.items():
        if launches[k] < DS_FRAMES - 1:
            bad.append(f"{k}: {launches[k]} launches over the pass")
    if bad:
        raise AssertionError("phase 14: " + "; ".join(bad))
    return record


def phase15(dev, smi):
    """Phase 15: the multi-device dry run on one and four shards of the
    card (see the module docstring). Prints its JSON line and raises on a
    failed check."""
    from orb_slam3_detailed_comments_kor_tpu_torch.parallel import dryrun

    rec, outs = {}, {}
    for shards in (1, 4):
        for name, fn in dryrun.dryrun_cases([dev] * shards).items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs[name, shards] = fn()
            torch.cuda.synchronize()
            rec[f"{name}/{shards}"] = dict(
                peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20,  # above what the earlier phases hold
                finite=all(bool(torch.isfinite(x).all()) for x in outs[name, shards]),
                device_ms=profiled_device_ms(fn, reps=1))
    for name in ("dense", "gba_pcg", "inertial"):
        rec[f"{name}/4"]["vs_one_shard"] = max_abs_err(outs[name, 4], outs[name, 1])
    log(f"phase 15 ({smi}): " + json.dumps(rec))
    bad = [f"{k}: a non-finite output" for k, v in rec.items() if not v["finite"]]
    bad += [f"{k}: {v['vs_one_shard']} from one shard" for k, v in rec.items()
            if v.get("vs_one_shard", 0.0) > DIST_BOUNDS["point_m"]]
    if bad:
        raise AssertionError("phase 15: " + "; ".join(bad))
    return rec


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline-csrc", default=None,
                        help="an earlier csrc/ whose kernels phase 1 times beside the current ones")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")

    from orb_slam3_detailed_comments_kor_tpu_torch.ops import (
        _cuda, cuda_fast, cuda_gather, cuda_matching,
    )
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx

    dev = torch.device(DEVICE)
    phase_s, t_phase = {}, time.time()

    # ---- phase 0: card + build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.time()
    _cuda.library()
    log(f"phase 0: kernels built/loaded in {time.time() - t0:.1f} s")
    with open(_cuda.build_log_path()) as f:
        for line in f:
            if any(k in line for k in ("Compiling entry", "Used", "spill")):
                log("  ptxas:", line.strip())
    base_lib = None
    if args.baseline_csrc:
        t0 = time.time()
        base_lib = build_baseline(os.path.abspath(args.baseline_csrc))
        log(f"phase 0: baseline kernels of {args.baseline_csrc} built in {time.time() - t0:.1f} s")

    phase_s["0"] = time.time() - t_phase
    t_phase = time.time()

    # ---- scene, trajectory, camera ---------------------------------------
    cam = camera(dev)
    Rs, ts, frames = render_sequence(N_FRAMES, cam)
    torch.cuda.synchronize()

    # ---- phase 1: kernels vs plain at the main path's inputs -------------
    _, ms_p1, R0, t0_ = init_map(*frames[0], cam, Rs[0], ts[0])
    eye = torch.eye(3, device=dev)
    state1 = (R0, t0_, eye, torch.zeros(3, device=dev), torch.tensor(False, device=dev))
    calls = {"fast_nms": [], "gather_patches": [], "masked_best2": []}
    with recording_kernel_calls(calls):
        step(ms_p1, *frames[1], state1, cam)
        torch.cuda.synchronize()
    log(f"phase 1: recorded the inputs of {sum(map(len, calls.values()))} kernel calls in one tracked frame")

    checks = main_path_checks(calls)
    # plus one random mask at the matcher's largest shape
    a, b, m = max(calls["masked_best2"], key=lambda c: c[0].shape[0])
    rand = torch.rand(m.shape, generator=torch.Generator(device=dev).manual_seed(0), device=dev) > 0.7
    rand[::97] = False  # rows with no allowed column
    checks.append(("masked_best2", f"{a.shape[0]}x{b.shape[0]} random mask",
                   cuda_matching.fused_masked_best2, cuda_matching.fused_masked_best2_plain,
                   (a, b, rand), matcher_bound(a, b, rand), None))
    for n, m_, off in MATCH_EDGE_CASES:
        checks.append(("masked_best2", f"edge {n}x{m_} offset {off}", cuda_matching.fused_masked_best2,
                       cuda_matching.fused_masked_best2_plain, matcher_edge_inputs(n, m_, off, dev),
                       None, None))
    for h, w, wp, t_hi, t_lo in FAST_EDGE_CASES:
        flat_e, hs_e, ws_e = fast_edge_inputs(h, w, wp, dev)
        checks.append(("fast_nms", f"edge 8x{h}x{wp} th {t_hi:g}/{t_lo:g}", cuda_fast.fast_nms,
                       cuda_fast.fast_nms_plain, (flat_e, hs_e, ws_e, t_hi, t_lo), None, None))
    for case in GATHER_EDGE_CASES:
        checks.append(("gather_patches", "edge {}x{} K={} {}x{} corners {}/{}".format(*case),
                       cuda_gather.gather_patches, cuda_gather.gather_patches_plain,
                       gather_edge_inputs(*case, dev), None, None))

    counters = {"fast_nms": cuda_fast.fast_nms, "gather_patches": cuda_gather.gather_patches,
                "masked_best2": cuda_matching.fused_masked_best2}
    launch_floor = device_ms(_cuda.noop)
    log(f"phase 1: launch floor (an empty kernel, back to back) {launch_floor[0]:.4f} ms "
        f"({launch_floor[1]:.4f}-{launch_floor[2]:.4f})")
    per_kernel = {}
    run_checks(checks, counters, per_kernel, base_lib)
    log("phase 1: every kernel equals its plain version exactly, edge cases included")

    phase_s["1"] = time.time() - t_phase
    t_phase = time.time()

    # ---- phase 2: the main path --------------------------------------------
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    frame0, ms, R0, t0_ = init_map(*frames[0], cam, Rs[0], ts[0])
    launches0 = {k: fn.launches for k, fn in counters.items()}  # frame 0's
    ms0_np = msx.map_state_to_numpy(ms)
    n_depth = int(((frame0.depth > 0) & frame0.valid).sum())
    log(f"phase 2: frame 0: {int(frame0.valid.sum())} valid features, {n_depth} stereo depths, "
        f"{int(ms.lm_valid.sum())} landmarks")
    state = (R0, t0_, eye, torch.zeros(3, device=dev), torch.tensor(False, device=dev))
    step_ms, wall_ms, results = [], [], []
    for i in range(1, N_FRAMES):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        s.record()
        if i == 2:  # count host syncs inside one step (there should be none)
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ms, frame, tr, R, t, vR, vt, ok = step(ms, *frames[i], state, cam)
            torch.cuda.set_sync_debug_mode("default")
            syncs = sorted({str(w.message).splitlines()[0] for w in caught})
            log(f"  frame 2: {len(caught)} synchronizing calls inside the step {syncs[:5]}")
        else:
            ms, frame, tr, R, t, vR, vt, ok = step(ms, *frames[i], state, cam)
        e.record()
        n_inl = int(tr.n_inliers)  # the step's one host read, and the barrier
        wall_ms.append((time.perf_counter() - w0) * 1e3)
        step_ms.append(s.elapsed_time(e))
        state = (R, t, vR, vt, torch.tensor(True, device=dev))
        centre = (-R.T @ t).cpu().numpy()
        err = float(np.linalg.norm(centre - ts[i]))
        results.append((i, n_inl, bool(ok), err))
        if i == 1:
            frame1_out = (R.cpu(), t.cpu(), n_inl, bool(ok))
        log(f"  frame {i:2d}: n_inliers {n_inl} ok {bool(ok)} centre err {err * 1e3:.2f} mm "
            f"step {step_ms[-1]:.2f} ms (wall {wall_ms[-1]:.2f} ms)")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches = {k: fn.launches for k, fn in counters.items()}
    # launches per tracked frame, as a float so that an uneven count shows
    per_frame = {k: (launches[k] - launches0[k]) / (N_FRAMES - 1) for k in launches}
    bad = [r for r in results
           if not (r[2] and r[1] >= MIN_TRACKED_INLIERS and r[3] <= MAX_CENTRE_ERR)]
    if bad:
        raise AssertionError(
            f"frames failing ok / n_inliers >= {MIN_TRACKED_INLIERS} / "
            f"centre err <= {MAX_CENTRE_ERR} m (frame, n, ok, err): {bad}")
    for k, n in LAUNCHES_PER_FRAME.items():
        if launches0[k] < 1 or per_frame[k] != n:
            raise AssertionError(
                f"{k}: {launches0[k]} launches for frame 0 and {per_frame[k]} per tracked frame "
                f"in the main path, expected >= 1 and {n}")
    log(f"phase 2: {N_FRAMES - 1} frames tracked; n_inliers {min(r[1] for r in results)}-"
        f"{max(r[1] for r in results)}; max centre err {max(r[3] for r in results) * 1e3:.2f} mm")
    log(f"phase 2: step median {statistics.median(step_ms[4:]):.2f} ms (CUDA events, frames 5-20), "
        f"wall median {statistics.median(wall_ms[4:]):.2f} ms; peak device memory {peak:.1f} MiB; "
        f"launches {launches} (frame 0 {launches0}, per tracked frame {per_frame})")

    phase_s["2"] = time.time() - t_phase
    t_phase = time.time()

    # ---- phase 3: the card agrees with the CPU on frame 1 -----------------
    cpu = torch.device("cpu")
    ms_cpu = msx.map_state_from_numpy(ms0_np, cpu)
    il, ir = (f.cpu() for f in frames[1])
    state_cpu = (R0.cpu(), t0_.cpu(), torch.eye(3), torch.zeros(3), torch.tensor(False))
    t_cpu = time.time()
    _, _, tr_c, R_c, t_c, _, _, ok_c = step(ms_cpu, il, ir, state_cpu, cam)
    R_g, t_g, n_g, ok_g = frame1_out
    n_c = int(tr_c.n_inliers)
    d_rot = rotation_angle(R_c, R_g)
    d_t = float((t_c - t_g).abs().max())
    log(f"phase 3: CPU frame 1 in {time.time() - t_cpu:.1f} s: n_inliers card {n_g} cpu {n_c}, "
        f"rotation diff {d_rot:.2e} rad, translation diff {d_t:.2e} m")
    if not (d_rot <= ROT_TOL and d_t <= TRANS_TOL and abs(n_c - n_g) <= max(3, 0.02 * n_c)
            and bool(ok_c) == ok_g):
        raise AssertionError("card and CPU disagree on frame 1")

    phase_s["3"] = time.time() - t_phase

    # ---- phase 4: the SLAM loop at bench scale ----------------------------
    from orb_slam3_detailed_comments_kor_tpu_torch.eval import ate
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_merging, tracking
    from orb_slam3_detailed_comments_kor_tpu_torch.slam import system as slam_mod

    cfg = loop_config()
    t_p4 = time.time()
    gt, loop_frames = render_loop_sequence(cfg, LOOP_FRAMES, dev)
    warm, _ = run_loop(cfg, loop_frames[:LOOP_WARMUP], dev, loop_closing=False)  # handles, allocator, first BA
    warm.flush_decisions()
    del warm
    torch.cuda.synchronize()
    log(f"phase 4: rendered {LOOP_FRAMES} frames and warmed up on {LOOP_WARMUP} in {time.time() - t_p4:.1f} s")
    lat, syncs, after0 = [], {}, {}
    read_numpy = slam_mod._HostRead.numpy

    def unwatched_read(self):
        # the batched decision read is the loop's one planned wait: left out
        torch.cuda.set_sync_debug_mode("default")
        try:
            return read_numpy(self)
        finally:
            torch.cuda.set_sync_debug_mode("warn")

    def timed(i, slam, call):
        head = slam._bg_queue[0][0] if slam._bg_queue else None
        t0 = time.perf_counter()
        if head in ("local_ba_chunk", "fuse") and head not in syncs:
            slam_mod._HostRead.numpy = unwatched_read
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                slam_mod._HostRead.numpy = read_numpy
            found = [str(w.message).splitlines()[0] for w in caught if SYNC_WARNING in str(w.message)]
            syncs[head] = (i, len(found), sorted(set(found))[:5])
        else:
            call()
        slam.t_cw.cpu()  # block on the frame's pose, as bench.py's latency pass does
        lat.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            after0.update({k: fn.launches for k, fn in counters.items()})

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t_pass = time.perf_counter()
    slam, kf_at = run_loop(cfg, loop_frames, dev, timed, timer=True, loop_closing=False)
    pass_s = time.perf_counter() - t_pass
    launches4 = {k: fn.launches for k, fn in counters.items()}
    peak4 = torch.cuda.max_memory_allocated() / 2**20
    n_tracked = LOOP_FRAMES - 1
    per_frame4 = {k: (launches4[k] - after0[k]) / n_tracked for k in launches4}
    _, centers, _ = slam.trajectory_arrays()
    ate_m = ate.ate_rmse(centers, gt[: len(centers)])
    lat_s = np.array(lat[5:])
    loop = dict(
        frames=len(slam.trajectory), state=slam.state, keyframes_inserted=slam.stats["kf_inserted"],
        keyframe_frames=kf_at, stats=slam.stats, landmarks=int(slam.ms.lm_valid.sum()),
        ate_m=ate_m, ref_ate_m=REF_ATE_M, frame_p50_ms=float(np.percentile(lat_s, 50)),
        frame_p99_ms=float(np.percentile(lat_s, 99)), frame_max_ms=float(lat_s.max()),
        frames_per_s=LOOP_FRAMES / pass_s, peak_mib=peak4, launches=launches4, launches_frame0=after0,
        launches_per_tracked_frame=per_frame4,
        syncs={k: {"frame": v[0], "count": v[1], "calls": v[2]} for k, v in syncs.items()},
    )
    # one slice of each kind, timed on the device from the final map with the
    # system's own arguments
    ms_f, kf_f, cap = slam.ms, slam.n_kf - 1, cfg.capacity
    slices = {
        "local_ba_chunk": lambda: tracking.local_ba_step(
            ms_f, kf_f, slam.cam_params, cfg.camera.bf, window=min(8, cap.max_local_kfs),
            lm_cap=cap.max_local_landmarks, iters=2),
        "fuse": lambda: map_merging.fuse_duplicate_landmarks(
            ms_f, ms_f.lm_valid & (ms_f.lm_first_kf == kf_f), radius=max(0.5 * slam.baseline, 0.02)),
        "cull_lm": lambda: tracking.cull_landmarks(ms_f),
    }
    profiled = {k: profiled_device_ms(f, ops=True) for k, f in slices.items()}
    loop["slice_device_ms"] = {k: v[0] for k, v in profiled.items()}
    loop["slice_device_ops"] = {k: v[1] for k, v in profiled.items()}
    # the card-to-card spread of one local-BA slice: two runs on the same inputs
    loop["local_ba_spread"] = local_ba_spread(slices["local_ba_chunk"], ms_f)
    # and one call of each captured in a CUDA graph, which refuses any call
    # that waits on the stream or reads the device; and one call of each
    # behind a long sleep kernel: a call that waited on the device anywhere
    # (the sync debug mode misses some waits) returns only after the sleep
    # ends. The sleep decides only for a call that queues fewer stream
    # operations than the launch queue holds: past that, every launch
    # waits for the device to free a slot.
    loop["slice_graph_capture_error"] = {k: graph_capture_error(f) for k, f in slices.items()}
    loop["launch_queue_capacity"] = launch_queue_capacity()
    loop["slice_host_ms_behind_sleep"] = {k: host_ms_behind_sleep(f) for k, f in slices.items()
                                          if loop["slice_device_ops"][k] < loop["launch_queue_capacity"]}
    loop["host_stage_ms"] = {k: {"count": v["count"], "p50_ms": v["p50_ms"], "max_ms": v["max_ms"],
                                 "total_ms": v["total_ms"]} for k, v in slam.timer.summary().items()}
    log(f"phase 4 ({smi}): " + json.dumps(loop))
    log(f"phase 4: {LOOP_FRAMES} frames in {pass_s:.2f} s ({loop['frames_per_s']:.2f} frames/s), frame wall "
        f"p50 {loop['frame_p50_ms']:.2f} ms p99 {loop['frame_p99_ms']:.2f} ms; ATE {ate_m * 1e3:.3f} mm "
        f"(JAX reference {REF_ATE_M * 1e3:.3f} mm); {slam.stats['kf_inserted']} keyframes; slices "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in loop["slice_device_ms"].items())
        + f"; peak {peak4:.1f} MiB; phase 4 took {time.time() - t_p4:.1f} s")
    bad = []
    if slam.state != slam_mod.TrackingState.OK:
        bad.append(f"final state {slam.state}")
    if len(slam.trajectory) != LOOP_FRAMES:
        bad.append(f"{len(slam.trajectory)} frames recorded")
    if slam.stats["kf_inserted"] < MIN_LOOP_KF:
        bad.append(f"{slam.stats['kf_inserted']} keyframes inserted")
    for k, n in LAUNCHES_PER_FRAME.items():
        if after0.get(k, 0) < 1 or per_frame4[k] != n:
            bad.append(f"{k}: {after0.get(k)} launches at frame 0, {per_frame4[k]} per tracked frame")
    for slice_kind in ("local_ba_chunk", "fuse"):
        if slice_kind not in syncs or syncs[slice_kind][1] != 0:
            bad.append(f"{slice_kind}: synchronizing calls {syncs.get(slice_kind)}")
    if any(v != 0 for v in loop["local_ba_spread"].values()):
        bad.append(f"local BA differs between two runs on the same inputs: {loop['local_ba_spread']}")
    for k, err in loop["slice_graph_capture_error"].items():
        if err is not None:
            bad.append(f"{k}: not capturable in a CUDA graph: {err}")
    for k, host_ms in loop["slice_host_ms_behind_sleep"].items():
        if host_ms >= 0.5 * SLEEP_MS:
            bad.append(f"{k}: returned after {host_ms:.1f} ms behind a {SLEEP_MS} ms sleep kernel")
    if not ate_m <= REF_ATE_M + ATE_MARGIN:
        bad.append(f"ATE {ate_m} m")
    if bad:
        raise AssertionError("phase 4: " + "; ".join(bad))

    phase_s["4"] = time.time() - t_p4

    # ---- phase 5: the card against the CPU for the loop ------------------
    t_p5 = time.time()
    small = loop_config(small=True)
    _, frames5 = render_loop_sequence(small, SMALL_LOOP_FRAMES, cpu)
    card, kf_card = run_loop(small, [(a.to(dev), b.to(dev)) for a, b in frames5], dev)
    host, kf_host = run_loop(small, frames5, cpu)
    d_c, d_r = trajectory_diff(card.trajectory_arrays(), host.trajectory_arrays())
    log(f"phase 5: keyframes at {kf_card} (card) {kf_host} (cpu), stats {card.stats} / {host.stats}; "
        f"centre diff max {d_c.max():.2e} m, rotation diff max {d_r.max():.2e} rad; per frame mm "
        f"{np.round(d_c * 1e3, 3).tolist()}; {time.time() - t_p5:.1f} s")
    if kf_card != kf_host or not (d_c.max() <= TRANS_TOL and d_r.max() <= ROT_TOL):
        raise AssertionError("phase 5: card and CPU disagree on the loop")
    phase_s["5"] = time.time() - t_p5

    # ---- phase 6: the loop-closure pass at bench scale ---------------------
    t_p6 = time.time()
    rec6 = phase6(dev, counters, per_kernel, smi)
    phase_s["6"] = time.time() - t_p6

    # ---- phase 7: the Atlas merge pass at bench scale ---------------------
    t_p7 = time.time()
    rec7 = phase7(dev, counters, per_kernel, smi)
    phase_s["7"] = time.time() - t_p7

    # ---- phase 8: the stereo-inertial pass at bench scale ------------------
    t_p8 = time.time()
    rec8 = phase8(dev, counters, per_kernel, smi)
    phase_s["8"] = time.time() - t_p8

    # ---- phases 9 and 10: the monocular and monocular-inertial passes -------
    t_p9 = time.time()
    rec9 = phase9(dev, counters, per_kernel, smi)
    phase_s["9"] = time.time() - t_p9
    t_p10 = time.time()
    rec10 = phase10(dev, counters, per_kernel, smi)
    phase_s["10"] = time.time() - t_p10

    # ---- phases 11-13: the RGB-D, stereo-fisheye and fisheye-inertial passes
    rec_sensor = {}
    for kind, ph in (("rgbd", "11"), ("fisheye", "12"), ("fsi", "13")):
        t_ph = time.time()
        rec_sensor[kind] = sensor_phase(kind, dev, counters, per_kernel, smi)
        phase_s[ph] = time.time() - t_ph

    # ---- phase 14: the dataset runner on a recorded sequence --------------
    t_p14 = time.time()
    rec14 = phase14(dev, counters, per_kernel, smi)
    phase_s["14"] = time.time() - t_p14

    # ---- phase 15: the multi-device dry run ---------------------------------
    t_p15 = time.time()
    phase15(dev, smi)
    phase_s["15"] = time.time() - t_p15
    log("phase seconds: " + json.dumps(phase_s))

    sources = {
        "fast_nms": ("csrc/fast_nms.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_fast.py:149"),
        "gather_patches": ("csrc/gather_patches.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_gather.py:91"),
        "masked_best2": ("csrc/masked_best2.cu", "orb_slam3_detailed_comments_kor_tpu/ops/pallas_matching.py:123"),
    }
    kernels = []
    for k, (src, rep) in sources.items():
        info = per_kernel[k]
        main_case = info["cases"][0]  # the first timed case is the main path's shape
        kernels.append({
            "name": k, "route": "cuda",
            "source": "orb_slam3_detailed_comments_kor_tpu_torch/" + src, "replaces": rep,
            "launches": launches[k], "launches_per_frame": int(per_frame[k]),  # checked whole
            "launches_slam_loop": launches4[k], "launches_per_frame_slam_loop": int(per_frame4[k]),
            "launches_loop_closure_pass": rec6["launches"][k], "launches_merge_pass": rec7["launches"][k],
            "launches_si_pass": rec8["launches"][k], "launches_mono_pass": rec9["launches"][k],
            "launches_mi_pass": rec10["launches"][k], "launches_rgbd_pass": rec_sensor["rgbd"]["launches"][k],
            "launches_fisheye_pass": rec_sensor["fisheye"]["launches"][k],
            "launches_fsi_pass": rec_sensor["fsi"]["launches"][k], "launches_euroc_pass": rec14["launches"][k],
            "max_abs_err": info["max_abs_err"], "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
            "device_kernels_per_call": max(c["device_kernels"] for c in info["cases"]),
            "edge_cases": info["edge_cases"], "repeat_cases": info["repeat_cases"], "cases": info["cases"],
        })
    print(json.dumps({"kernels": kernels, "launch_floor_ms": launch_floor[0]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
