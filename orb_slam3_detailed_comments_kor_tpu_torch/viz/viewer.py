"""Offline viewer: frame overlays, map rendering, and an HTML map export.

Port of ``orb_slam3_detailed_comments_kor_tpu/viz/viewer.py``, the
counterpart of the reference's Pangolin GUI stack — ``Viewer``
(``src/Viewer.cc:130``), ``FrameDrawer`` (``src/FrameDrawer.cc:37`` keypoint
overlay) and ``MapDrawer`` (``src/MapDrawer.cc:123`` points, ``:162``
keyframes + covisibility graph, ``:355`` current camera). A live GL window
makes no sense for a headless machine; instead we render offline artifacts:

- :func:`draw_frame` — the FrameDrawer overlay as a numpy RGB image;
- :func:`render_map` — top-down / 3-view matplotlib rendering of map
  points, keyframe frusta, covisibility edges and the trajectory;
- :func:`export_html` — a self-contained interactive HTML viewer (canvas +
  orbit controls, no external deps) of the same state.

All functions take the SlamSystem (or raw arrays) and never touch device
state except to read it once (one host read per call of ``_map_arrays``).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# FrameDrawer analog
# ---------------------------------------------------------------------------

def draw_frame(
    img: np.ndarray,
    xy: np.ndarray,
    valid: np.ndarray,
    tracked: Optional[np.ndarray] = None,
    radius: int = 3,
) -> np.ndarray:
    """Keypoint overlay (FrameDrawer::DrawFrame): green = tracked landmark,
    blue = extracted only. Returns RGB uint8 [H,W,3]."""
    h, w = img.shape
    out = np.stack([img, img, img], axis=-1).astype(np.float32)
    xy = np.asarray(xy)
    valid = np.asarray(valid)
    tracked = (
        np.zeros(len(xy), bool) if tracked is None else np.asarray(tracked)
    )
    for i in range(len(xy)):
        if not valid[i]:
            continue
        x, y = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if not (radius <= x < w - radius and radius <= y < h - radius):
            continue
        color = (
            np.array([0.0, 255.0, 0.0]) if tracked[i]
            else np.array([80.0, 80.0, 255.0])
        )
        # draw a small square ring
        out[y - radius, x - radius:x + radius + 1] = color
        out[y + radius, x - radius:x + radius + 1] = color
        out[y - radius:y + radius + 1, x - radius] = color
        out[y - radius:y + radius + 1, x + radius] = color
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# MapDrawer analog (matplotlib, headless)
# ---------------------------------------------------------------------------

def _map_arrays(slam):
    """Pull (lm_pos, kf_R, kf_t, kf_valid, centers, cov_edges) to host in
    one read: the map's arrays and the covisibility weights of every
    keyframe slot go up as one float32 vector (the weights are counts,
    exact in float32; a slot's row does not depend on the other rows)."""
    import torch

    from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx

    ms = slam.ms
    K, L = ms.K, ms.L
    wts = msx.covisibility_weights(ms, torch.arange(K, device=ms.kf_valid.device))
    parts = (ms.lm_pos, ms.lm_valid, ms.kf_valid, ms.kf_R_cw, ms.kf_t_cw, wts)
    flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).cpu().numpy()
    sizes = np.cumsum([0] + [p.numel() for p in parts])
    lm_pos, lm_valid, kf_valid, kf_R, kf_t, wts = (
        flat[a:b] for a, b in zip(sizes[:-1], sizes[1:]))
    lm_pos = lm_pos.reshape(L, 3)[lm_valid > 0]
    kf_valid = kf_valid > 0
    kf_R = kf_R.reshape(K, 3, 3)
    kf_t = kf_t.reshape(K, 3)
    wts = wts.reshape(K, K)
    centers = np.einsum("kij,kj->ki", kf_R.transpose(0, 2, 1), -kf_t)
    # covisibility edges (weight >= 15, MapDrawer::DrawKeyFrames uses the
    # covisibility graph with a minimum weight of 100 / essential graph)
    idx = np.nonzero(kf_valid)[0]
    edges = []
    if len(idx) >= 2:
        for a in idx:
            for b in idx:
                if b > a and wts[a, b] >= 15:
                    edges.append((int(a), int(b)))
    return lm_pos, kf_R, kf_t, kf_valid, centers, edges


def render_map(slam, path: str, title: str = "map") -> None:
    """Render the map (points + keyframes + covisibility + trajectory) to a
    PNG with three orthographic views (MapDrawer analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lm, kf_R, kf_t, kf_valid, centers, edges = _map_arrays(slam)
    traj = None
    if slam.trajectory:
        _, tc, _ = slam.trajectory_arrays()
        traj = tc
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    planes = [("x", "z", 0, 2), ("x", "y", 0, 1), ("z", "y", 2, 1)]
    for ax, (nx, ny, i, j) in zip(axes, planes):
        if len(lm):
            ax.scatter(lm[:, i], lm[:, j], s=1, c="k", alpha=0.3,
                       label="landmarks")
        for a, b in edges:
            ax.plot(
                [centers[a, i], centers[b, i]],
                [centers[a, j], centers[b, j]],
                c="0.7", lw=0.5, zorder=1,
            )
        kidx = np.nonzero(kf_valid)[0]
        if len(kidx):
            ax.scatter(centers[kidx, i], centers[kidx, j], s=18, c="b",
                       marker="s", label="keyframes", zorder=3)
        if traj is not None and len(traj):
            ax.plot(traj[:, i], traj[:, j], c="g", lw=1.0,
                    label="trajectory", zorder=2)
        ax.set_xlabel(nx)
        ax.set_ylabel(ny)
        ax.set_aspect("equal")
    axes[0].legend(loc="best", fontsize=8)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


# ---------------------------------------------------------------------------
# Interactive HTML export
# ---------------------------------------------------------------------------

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>SLAM map</title>
<style>body{margin:0;background:#111;color:#ccc;font-family:monospace}
#hud{position:fixed;top:8px;left:8px}
#menu{position:fixed;bottom:8px;left:8px;background:#1b1b1bcc;padding:6px;
border-radius:4px}
#menu button{background:#333;color:#ccc;border:1px solid #555;margin:0 2px;
font-family:monospace;cursor:pointer}
#menu button.on{background:#275;}
#menu input[type=range]{vertical-align:middle;width:220px}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div>
<div id="menu">
<button id="bFollow" title="center the view on the playback camera">Follow
 Camera</button>
<button id="bPlay">&#9654; Play</button>
<button id="bStep" title="advance one frame">Step</button>
<input type="range" id="scrub" min="0" value="0">
<span id="frameno"></span>
</div>
<script>
// menu toggles driving the render loop: Follow Camera / step-by-step
// playback — the offline analog of the reference viewer's menu
// (Viewer.cc:145-241 menuFollowCamera / menuStepByStep / menuStep)
const DATA = __DATA__;
const cv = document.getElementById('c'); const ctx = cv.getContext('2d');
let yaw=0.6, pitch=0.4, dist=6, cx=0, cy=0, cz=0, drag=null;
let follow=false, playing=false, frame=DATA.traj.length?DATA.traj.length-1:0;
function center(){ if(!DATA.lm.length) return;
  let s=[0,0,0]; for(const p of DATA.lm){s[0]+=p[0];s[1]+=p[1];s[2]+=p[2];}
  cx=s[0]/DATA.lm.length; cy=s[1]/DATA.lm.length; cz=s[2]/DATA.lm.length; }
function proj(p){
  let x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  let x1=Math.cos(yaw)*x+Math.sin(yaw)*z, z1=-Math.sin(yaw)*x+Math.cos(yaw)*z;
  let y2=Math.cos(pitch)*y-Math.sin(pitch)*z1,
      z2=Math.sin(pitch)*y+Math.cos(pitch)*z1;
  let d=z2+dist; if(d<0.1) d=0.1;
  const f=0.9*Math.min(cv.width,cv.height);
  return [cv.width/2+f*x1/d, cv.height/2+f*y2/d, d]; }
function draw(){
  cv.width=innerWidth; cv.height=innerHeight;
  if(follow && DATA.traj.length){const p=DATA.traj[frame];
    cx=p[0]; cy=p[1]; cz=p[2];}
  ctx.fillStyle='#111'; ctx.fillRect(0,0,cv.width,cv.height);
  ctx.fillStyle='#999';
  for(const p of DATA.lm){const q=proj(p);
    ctx.fillRect(q[0],q[1],Math.max(1,2/q[2]*8),Math.max(1,2/q[2]*8));}
  ctx.strokeStyle='#3a6'; ctx.lineWidth=1.5; ctx.beginPath();
  for(let i=0;i<=frame && i<DATA.traj.length;i++){const q=proj(DATA.traj[i]);
    i?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);}
  ctx.stroke();
  ctx.strokeStyle='#557'; ctx.lineWidth=0.6;
  for(const e of DATA.cov){const a=proj(DATA.kf[e[0]]),b=proj(DATA.kf[e[1]]);
    ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();}
  ctx.fillStyle='#48f';
  for(const p of DATA.kf){const q=proj(p);ctx.fillRect(q[0]-2,q[1]-2,4,4);}
  if(DATA.traj.length){const q=proj(DATA.traj[frame]);
    ctx.strokeStyle='#f84'; ctx.lineWidth=2;
    ctx.strokeRect(q[0]-5,q[1]-5,10,10);}
  document.getElementById('frameno').textContent =
    DATA.traj.length ? ` ${frame+1}/${DATA.traj.length}` : ' (no traj)';
  document.getElementById('hud').textContent =
    `${DATA.lm.length} landmarks · ${DATA.kf.length} keyframes · `+
    `${DATA.traj.length} poses — drag to orbit, wheel to zoom`; }
const scrub=document.getElementById('scrub');
scrub.max=Math.max(DATA.traj.length-1,0); scrub.value=frame;
scrub.oninput=()=>{frame=+scrub.value; draw();};
function setFrame(f){frame=Math.min(Math.max(f,0),
  Math.max(DATA.traj.length-1,0)); scrub.value=frame; draw();}
document.getElementById('bFollow').onclick=function(){
  follow=!follow; this.classList.toggle('on',follow); draw();};
document.getElementById('bStep').onclick=()=>setFrame(
  frame+1>=DATA.traj.length?0:frame+1);
let timer=null;
document.getElementById('bPlay').onclick=function(){
  playing=!playing; this.classList.toggle('on',playing);
  this.innerHTML=playing?'&#9646;&#9646; Pause':'&#9654; Play';
  if(playing){timer=setInterval(()=>{
    setFrame(frame+1>=DATA.traj.length?0:frame+1);},50);}
  else clearInterval(timer);};
onkeydown=e=>{if(e.key==='ArrowRight')setFrame(frame+1);
  if(e.key==='ArrowLeft')setFrame(frame-1);
  if(e.key===' '){e.preventDefault();
    document.getElementById('bPlay').onclick.call(
      document.getElementById('bPlay'));}};
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return; yaw+=(e.clientX-drag[0])*0.008;
  pitch+=(e.clientY-drag[1])*0.008; drag=[e.clientX,e.clientY]; draw();};
onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); draw();};
onresize=draw; center(); draw();
</script></body></html>
"""


def export_html(slam, path: str, max_points: int = 20000) -> None:
    """Write a dependency-free interactive HTML viewer of the current map."""
    lm, kf_R, kf_t, kf_valid, centers, edges = _map_arrays(slam)
    if len(lm) > max_points:
        sel = np.random.default_rng(0).choice(
            len(lm), max_points, replace=False
        )
        lm = lm[sel]
    traj = []
    if slam.trajectory:
        _, tc, _ = slam.trajectory_arrays()
        traj = np.round(tc, 4).tolist()
    kidx = np.nonzero(kf_valid)[0]
    remap = {int(a): i for i, a in enumerate(kidx)}
    data = {
        "lm": np.round(lm, 4).tolist(),
        "kf": np.round(centers[kidx], 4).tolist(),
        "cov": [[remap[a], remap[b]] for a, b in edges
                if a in remap and b in remap],
        "traj": traj,
    }
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.replace("__DATA__", json.dumps(data)))
