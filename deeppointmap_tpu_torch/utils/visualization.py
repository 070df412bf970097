"""Interactive point-cloud viewer (port of
deeppointmap_tpu/utils/visualization.py; a debug tool).

The reference's ``show_pcd`` (reference: utils/visualization.py:7-54)
opens an Open3D GUI window, which a headless host cannot show. This keeps
the same call signature but renders to a SELF-CONTAINED interactive WebGL
HTML file (no external assets, no network): orbit / pan / zoom with the
mouse, point-size and per-cloud visibility controls, colour by cloud or by
height. Open it in any browser, locally or over a port-forward.

The optional preprocessing mirrors the reference's Open3D calls with this
package's own ops:

* ``filter=True`` -> statistical outlier removal
  (``remove_statistical_outlier(nb_neighbors=20, std_ratio=3)`` in the
  reference) with the NumPy/cKDTree math of
  ``data/transforms.OutlierFilter``;
* ``estimate_normals=True`` -> radius-PCA normals from the radius moments
  of ``ops.normals.filter_sweep`` on ``device`` (the card by default: K2
  with its fused moments, or the route the switches of ops/normals pick;
  the reference calls Open3D's ``KDTreeSearchParamHybrid``); normals are
  drawn as short segments.

``show_pcd`` writes ``<window_name>.html`` (or ``out_html``) and, when a
display/browser is reachable, opens it; on a headless host it prints the
path. Clouds may be NumPy arrays or torch tensors on any device; only
columns [:, :3] (and [:, 3:6] with ``has_normals``) are read, matching the
reference.
"""

from __future__ import annotations

import base64
import json
import os
import re
import webbrowser
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeppointmap_tpu_torch.ops.normals import (filter_sweep,
                                                normals_from_moments)

__all__ = ["show_pcd", "show_posegraph", "write_viewer_html"]

#: default per-cloud palette (RGB in 0..1), cycled when colors is None
_PALETTE = [
    (0.86, 0.37, 0.34), (0.33, 0.66, 0.41), (0.30, 0.51, 0.74),
    (0.87, 0.68, 0.32), (0.62, 0.46, 0.71), (0.36, 0.72, 0.70),
    (0.75, 0.75, 0.75), (0.55, 0.34, 0.29),
]


def _as_np(a) -> np.ndarray:
    """NumPy float32 copy of a NumPy array or a torch tensor (on any
    device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _statistical_outlier_mask(xyz: np.ndarray, nb_neighbors: int = 20,
                              std_ratio: float = 3.0) -> np.ndarray:
    """Open3D remove_statistical_outlier semantics: keep points whose
    mean k-NN distance is within mean + std_ratio * std (the math of
    data/transforms.OutlierFilter, reference: transforms.py:330-352)."""
    from scipy.spatial import cKDTree

    if len(xyz) <= nb_neighbors:
        return np.ones(len(xyz), bool)
    d, _ = cKDTree(xyz).query(xyz, k=nb_neighbors + 1)
    mean_d = d[:, 1:].mean(axis=1)
    return mean_d <= mean_d.mean() + std_ratio * mean_d.std()


def _estimate_normals(xyz: np.ndarray, radius: float = 1.0,
                      max_nn: int = 30, device="cuda") -> np.ndarray:
    """Radius-PCA normals on `device`: one sweep of ops.normals'
    filter_sweep (the 1-NN graph beside the moments, which routes it
    through K2's fused moments on the card) and the smallest eigenvector
    of each neighbourhood's covariance; neighbourhoods of fewer than three
    points get +z. max_nn is kept for signature parity: the moments weigh
    every in-radius neighbour, an upper bound of the hybrid-truncated
    PCA."""
    del max_nn
    p = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(
        device)[None]
    valid = torch.ones(p.shape[:2], dtype=torch.bool, device=p.device)
    moments = filter_sweep(p, valid, 1, float(radius))[2:]
    return normals_from_moments(p, *moments)[0].cpu().numpy()


def _viewer_payload(pcds, colors, has_normals, estimate_normals,
                    estimate_kwargs, filter, device="cuda"):
    clouds = []
    for i, raw in enumerate(pcds):
        arr = _as_np(raw)
        if arr.ndim != 2 or arr.shape[1] < 3:
            raise ValueError(f"cloud {i}: expected (N, >=3), got {arr.shape}")
        xyz = arr[:, :3]
        nrm = None
        if has_normals:
            if arr.shape[1] < 6:
                print("Normals is NOT found")   # reference wording
            else:
                nrm = arr[:, 3:6]
        if filter and len(xyz):
            keep = _statistical_outlier_mask(xyz)
            xyz = xyz[keep]
            nrm = nrm[keep] if nrm is not None else None
        if estimate_normals and len(xyz):
            kw = dict(radius=1.0, max_nn=30)
            if estimate_kwargs is not None:
                if not {"radius", "max_nn"} <= set(estimate_kwargs):
                    raise ValueError("estimate_kwargs needs radius and "
                                     "max_nn")
                kw.update(estimate_kwargs)
            nrm = _estimate_normals(xyz, device=device, **kw)
        color = (tuple(colors[i]) if colors is not None
                 else _PALETTE[i % len(_PALETTE)])
        clouds.append(dict(xyz=np.ascontiguousarray(xyz, np.float32),
                           normals=(np.ascontiguousarray(nrm, np.float32)
                                    if nrm is not None else None),
                           color=color, name=f"cloud {i} ({len(xyz)} pts)"))
    return clouds


# --------------------------------------------------------------------------
# self-contained HTML template. Raw WebGL1 point rendering + hand-rolled
# orbit controls; no external scripts so the file works with zero egress.
_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;
   font:12px system-ui,sans-serif;color:#ddd}
 #c{width:100%;height:100%;display:block}
 #hud{position:fixed;top:8px;left:8px;background:rgba(20,20,20,.85);
   padding:8px 10px;border-radius:6px;max-width:300px}
 #hud label{display:block;margin:2px 0;cursor:pointer}
 #hud .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
   margin-right:6px;vertical-align:-1px}
 #hud .dim{color:#888;margin-top:6px}
 kbd{background:#333;border-radius:3px;padding:0 4px}
</style></head><body>
<canvas id="c"></canvas><div id="hud"><b>__TITLE__</b><div id="list"></div>
<div class="dim">drag rotate &middot; right-drag/shift pan &middot; wheel
 zoom &middot; <kbd>+</kbd>/<kbd>-</kbd> point size &middot; <kbd>h</kbd>
 height colors &middot; <kbd>r</kbd> reset</div></div>
<script>
const DATA = __DATA__;
function decode(b64){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);
 return new Float32Array(u.buffer);}
const canvas=document.getElementById('c');
const gl=canvas.getContext('webgl',{antialias:false});
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
 uniform float ps;varying vec3 vc;
 void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;
 void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,'p'),aC=gl.getAttribLocation(prog,'col');
const uM=gl.getUniformLocation(prog,'mvp'),uS=gl.getUniformLocation(prog,'ps');
// build buffers; compute global bounds
let lo=[1e30,1e30,1e30],hi=[-1e30,-1e30,-1e30];
const clouds=DATA.map(d=>{
 const xyz=decode(d.xyz);const n=xyz.length/3;
 for(let i=0;i<n;i++)for(let k=0;k<3;k++){const v=xyz[3*i+k];
  if(v<lo[k])lo[k]=v;if(v>hi[k])hi[k]=v;}
 const flat=new Float32Array(3*n);
 const hcol=new Float32Array(3*n);
 // height colormap filled later (needs global z-range)
 const buf=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,buf);
 gl.bufferData(gl.ARRAY_BUFFER,xyz,gl.STATIC_DRAW);
 const cbuf=gl.createBuffer();
 let lines=null,nl=0;
 if(d.normals){const nr=decode(d.normals);const seg=new Float32Array(6*n);
  for(let i=0;i<n;i++){for(let k=0;k<3;k++){seg[6*i+k]=xyz[3*i+k];
   seg[6*i+3+k]=xyz[3*i+k]+0.3*nr[3*i+k];}}
  lines=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,lines);
  gl.bufferData(gl.ARRAY_BUFFER,seg,gl.STATIC_DRAW);nl=2*n;}
 return {n:n,buf:buf,cbuf:cbuf,xyz:xyz,color:d.color,name:d.name,
         on:true,lines:lines,nl:nl,flat:flat,hcol:hcol};});
const zlo=lo[2],zr=Math.max(1e-6,hi[2]-lo[2]);
clouds.forEach(c=>{
 for(let i=0;i<c.n;i++){
  for(let k=0;k<3;k++)c.flat[3*i+k]=c.color[k];
  const t=(c.xyz[3*i+2]-zlo)/zr;   // turbo-ish ramp
  c.hcol[3*i]=Math.min(1,Math.max(0,1.6*t-0.1));
  c.hcol[3*i+1]=Math.min(1,Math.max(0,1.5-Math.abs(2.2*t-1.1)));
  c.hcol[3*i+2]=Math.min(1,Math.max(0,1.2-1.6*t));}
 gl.bindBuffer(gl.ARRAY_BUFFER,c.cbuf);
 gl.bufferData(gl.ARRAY_BUFFER,c.flat,gl.STATIC_DRAW);});
const ctr=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const span=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3);
let yaw=0.6,pitch=0.5,dist=span*1.8,pan=[0,0,0],psize=2,hmode=false;
function mat(){
 const w=canvas.width,h=canvas.height,f=1.0/Math.tan(0.4),
  asp=w/h,zn=span/1000,zf=span*20;
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),
  sp=Math.sin(pitch);
 const eye=[ctr[0]+pan[0]+dist*cy*cp,ctr[1]+pan[1]+dist*sy*cp,
  ctr[2]+pan[2]+dist*sp];
 const at=[ctr[0]+pan[0],ctr[1]+pan[1],ctr[2]+pan[2]];
 let zx=eye[0]-at[0],zy=eye[1]-at[1],zz=eye[2]-at[2];
 let zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
 let xx=-zy,xy=zx,xz=0;let xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xy/=xl;
 let yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
 const tx=-(xx*eye[0]+xy*eye[1]+xz*eye[2]);
 const ty=-(yx*eye[0]+yy*eye[1]+yz*eye[2]);
 const tz=-(zx*eye[0]+zy*eye[1]+zz*eye[2]);
 const p00=f/asp,p11=f,p22=(zf+zn)/(zn-zf),p23=2*zf*zn/(zn-zf);
 return new Float32Array([
  p00*xx,p11*yx,p22*zx,-zx, p00*xy,p11*yy,p22*zy,-zy,
  p00*xz,p11*yz,p22*zz,-zz, p00*tx,p11*ty,p22*tz+p23,-tz]);}
function draw(){
 const dpr=window.devicePixelRatio||1;
 canvas.width=canvas.clientWidth*dpr;canvas.height=canvas.clientHeight*dpr;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.clearColor(0.066,0.066,0.066,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(uM,false,mat());gl.uniform1f(uS,psize);
 for(const c of clouds){if(!c.on)continue;
  gl.bindBuffer(gl.ARRAY_BUFFER,c.buf);
  gl.enableVertexAttribArray(aP);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,c.cbuf);
  gl.bufferData(gl.ARRAY_BUFFER,hmode?c.hcol:c.flat,gl.STATIC_DRAW);
  gl.enableVertexAttribArray(aC);gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.POINTS,0,c.n);
  if(c.lines){gl.bindBuffer(gl.ARRAY_BUFFER,c.lines);
   gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
   gl.disableVertexAttribArray(aC);
   gl.vertexAttrib3f(aC,c.color[0],c.color[1],c.color[2]);
   gl.drawArrays(gl.LINES,0,c.nl);
   gl.enableVertexAttribArray(aC);}}
 }
let drag=null;
canvas.addEventListener('contextmenu',e=>e.preventDefault());
canvas.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,
 b:e.button,shift:e.shiftKey};});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
 drag.x=e.clientX;drag.y=e.clientY;
 if(drag.b===2||drag.shift){const s=dist*0.0015;
  const cy=Math.cos(yaw),sy=Math.sin(yaw);
  pan[0]+=sy*dx*s; pan[1]-=cy*dx*s; pan[2]+=dy*s;
 } else {yaw-=dx*0.008;pitch=Math.min(1.55,Math.max(-1.55,pitch+dy*0.008));}
 draw();});
canvas.addEventListener('wheel',e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.0012);draw();},{passive:false});
window.addEventListener('keydown',e=>{
 if(e.key==='+'||e.key==='=')psize=Math.min(12,psize+1);
 else if(e.key==='-')psize=Math.max(1,psize-1);
 else if(e.key==='h')hmode=!hmode;
 else if(e.key==='r'){yaw=0.6;pitch=0.5;dist=span*1.8;pan=[0,0,0];}
 else return; draw();});
window.addEventListener('resize',draw);
const list=document.getElementById('list');
clouds.forEach((c,i)=>{const l=document.createElement('label');
 const sw='<span class="sw" style="background:rgb('+
  c.color.map(v=>Math.round(v*255)).join(',')+')"></span>';
 l.innerHTML='<input type="checkbox" checked> '+sw+c.name;
 l.querySelector('input').addEventListener('change',ev=>{
  c.on=ev.target.checked;draw();});
 list.appendChild(l);});
draw();
</script></body></html>
"""


def write_viewer_html(clouds: list, path: str, title: str) -> str:
    """Serialize prepared clouds into the self-contained viewer file."""
    data = []
    for c in clouds:
        data.append(dict(
            xyz=base64.b64encode(c["xyz"].tobytes()).decode("ascii"),
            normals=(base64.b64encode(c["normals"].tobytes()).decode("ascii")
                     if c["normals"] is not None else None),
            color=list(c["color"]), name=c["name"]))
    html = (_HTML.replace("__TITLE__", title)
            .replace("__DATA__", json.dumps(data)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path


def show_pcd(pcds: Sequence, colors: Optional[List] = None,
             window_name: str = "PCD", has_normals: bool = False,
             estimate_normals: bool = False,
             estimate_kwargs: Optional[dict] = None, filter: bool = False,
             out_html: Optional[str] = None,
             open_browser: Optional[bool] = None, device="cuda") -> str:
    """Interactive viewer for one or more point clouds; returns the path
    of the written HTML file (reference signature:
    utils/visualization.py:7; rendering redesigned for headless hosts).
    `device` is where normals are estimated (the card unless the caller
    asks for the CPU).

    open_browser default: only when a display is present."""
    clouds = _viewer_payload(pcds, colors, has_normals, estimate_normals,
                             estimate_kwargs, filter, device)
    print(f"{window_name:*<30}")
    for c in clouds:
        print(c["name"])
    print("*" * 30)
    if out_html is None:
        safe = re.sub(r"[^-\w.]+", "_", window_name) or "pcd"
        out_html = os.path.abspath(f"{safe}.html")
    write_viewer_html(clouds, out_html, window_name)
    if open_browser is None:
        open_browser = bool(os.environ.get("DISPLAY"))
    if open_browser:
        webbrowser.open("file://" + os.path.abspath(out_html))
    else:
        print(f"viewer written: {out_html}")
    return out_html


def show_posegraph(posegraph, out_html: str, max_keyframes: int = 64,
                   window_name: str = "map") -> str:
    """SLAM-map view: the valid points of each of the first
    `max_keyframes` scans, moved into the world frame by its optimized
    pose, one cloud each, plus the trajectory as a dense polyline cloud.
    Complements recoder's static matplotlib render with an inspectable 3-D
    view."""
    scans = sorted(posegraph.get_all_scans(), key=lambda s: s.timestep)
    pcds, colors = [], []
    for i, s in enumerate(scans[:max_keyframes]):
        if s.full_pcd is None or s.SE3_pred is None:
            continue
        pts = np.asarray(s.full_pcd, np.float32)[np.asarray(s.full_valid,
                                                            bool)]
        if len(pts):
            P = np.asarray(s.SE3_pred, np.float64)
            pcds.append((pts @ P[:3, :3].T + P[:3, 3]).astype(np.float32))
            colors.append(_PALETTE[i % len(_PALETTE)])
    traj = np.stack([np.asarray(s.SE3_pred)[:3, 3] for s in scans])
    if len(traj) > 1:   # densify so the path reads as a line
        seg = np.concatenate([
            np.linspace(traj[i], traj[i + 1], 12, endpoint=False)
            for i in range(len(traj) - 1)] + [traj[-1:]])
        pcds.append(seg.astype(np.float32))
        colors.append((1.0, 1.0, 1.0))
    clouds = _viewer_payload(pcds, colors, False, False, None, False)
    return write_viewer_html(clouds, out_html, window_name)
