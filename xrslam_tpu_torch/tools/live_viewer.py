"""Interactive live viewer (port of `xrslam_tpu/tools/live_viewer.py`).

The reference PC player opens a liteviz OpenGL + imgui window drawing
the live trajectory, landmark cloud, camera frustum, and the feature
image (reference: xrslam-pc/player/src/main.cpp:12 visualizer.h and
xrslam-pc/player/src/visualizer.cpp). The pipeline runs headless on a
GPU host, so the equivalent capability is a zero-dependency web viewer:
a stdlib HTTP server publishes the SLAM state as JSON + PNG and a
self-contained HTML page (canvas software-3D, orbit controls, no
external JS) renders it live in any browser pointed at the host.

Usage (also wired into run_dataset via ``--live PORT``)::

    from xrslam_tpu_torch.tools.live_viewer import LiveViewer
    viewer = LiveViewer(port=8765)          # http://host:8765/
    ... per frame:
    viewer.publish(pose_q=q, pose_p=p, landmarks=X, stats={"fps": fps})
    ... the painter inspection tap feeds frame overlays automatically
    viewer.close()

Everything is host-side display plumbing: it never touches the device
and adds no sync to the pipeline (publish copies a few KB of host
arrays under a lock; the painter tap hands over the frame's host image).
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..utils import inspection

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>xrslam_tpu_torch live</title>
<style>
 body{margin:0;background:#14141c;color:#d8d8e0;font:13px system-ui}
 #wrap{display:flex;height:100vh}
 #view{flex:1;min-width:0}
 #side{width:340px;padding:10px;overflow:auto;border-left:1px solid #333}
 canvas{width:100%;height:100%;display:block;cursor:grab}
 img{width:100%;image-rendering:pixelated;border:1px solid #333}
 table{width:100%;border-collapse:collapse;margin-top:8px}
 td{padding:2px 4px;border-bottom:1px solid #2a2a34}
 td:last-child{text-align:right;font-variant-numeric:tabular-nums}
 h3{margin:6px 0;font-size:13px;color:#9ad}
</style></head><body><div id="wrap">
<div id="view"><canvas id="c"></canvas></div>
<div id="side">
 <h3>camera frame</h3><img id="frame" alt="(no frame yet)">
 <h3>state</h3><table id="stats"></table>
 <div style="margin-top:8px;color:#777">drag: orbit &middot; wheel:
 zoom &middot; shift-drag: pan</div>
</div></div>
<script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=-0.9, pitch=-0.5, dist=8, cx=0, cy=0, cz=0, S=null;
function resize(){cv.width=cv.clientWidth;cv.height=cv.clientHeight;}
window.addEventListener('resize',resize); resize();
let drag=null;
cv.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY,e.shiftKey];});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{
 if(!drag)return; const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
 if(drag[2]){const s=dist/500;
   cx-=s*(Math.cos(yaw)*dx)+0; cy+=s*(Math.sin(yaw)*dx); cz+=s*dy;}
 else {yaw+=dx*0.01; pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.01));}
 drag=[e.clientX,e.clientY,drag[2]]; draw();});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);draw();
 e.preventDefault()},{passive:false});
function proj(p){
 const x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
 const cy_=Math.cos(yaw), sy=Math.sin(yaw),
       cp=Math.cos(pitch), sp=Math.sin(pitch);
 const x1=cy_*x+sy*y, y1=-sy*x+cy_*y;          // yaw about +z
 const y2=cp*y1-sp*z, z2=sp*y1+cp*z;           // pitch
 const zc=x1+dist;                             // camera looks down +x
 if(zc<0.05)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*y2/zc, cv.height/2-f*z2/zc];
}
function line(a,b,col,w){const p=proj(a),q=proj(b); if(!p||!q)return;
 ctx.strokeStyle=col; ctx.lineWidth=w||1; ctx.beginPath();
 ctx.moveTo(p[0],p[1]); ctx.lineTo(q[0],q[1]); ctx.stroke();}
function draw(){
 ctx.fillStyle='#14141c'; ctx.fillRect(0,0,cv.width,cv.height);
 // ground grid (z=0)
 for(let i=-5;i<=5;i++){
  line([i,-5,0],[i,5,0],'#222233'); line([-5,i,0],[5,i,0],'#222233');}
 line([0,0,0],[1,0,0],'#a44',2); line([0,0,0],[0,1,0],'#4a4',2);
 line([0,0,0],[0,0,1],'#44a',2);
 if(!S)return;
 // landmarks
 ctx.fillStyle='#8ab4ff';
 for(const p of S.landmarks){const q=proj(p); if(q)ctx.fillRect(q[0]-1,q[1]-1,2,2);}
 // trajectory
 for(let i=1;i<S.traj.length;i++)
   line(S.traj[i-1],S.traj[i],'#ffd24d',2);
 // camera frustum at latest pose (R: body->world rows via quat)
 if(S.pose){
  const q=S.pose.q, p=S.pose.p;
  const w=q[0],x=q[1],y=q[2],z=q[3];
  const R=[[1-2*(y*y+z*z),2*(x*y-w*z),2*(x*z+w*y)],
           [2*(x*y+w*z),1-2*(x*x+z*z),2*(y*z-w*x)],
           [2*(x*z-w*y),2*(y*z+w*x),1-2*(x*x+y*y)]];
  const tf=(v)=>[p[0]+R[0][0]*v[0]+R[0][1]*v[1]+R[0][2]*v[2],
                 p[1]+R[1][0]*v[0]+R[1][1]*v[1]+R[1][2]*v[2],
                 p[2]+R[2][0]*v[0]+R[2][1]*v[1]+R[2][2]*v[2]];
  const s=0.4, corners=[[s,s,2*s],[s,-s,2*s],[-s,-s,2*s],[-s,s,2*s]].map(tf);
  for(let i=0;i<4;i++){line(p,corners[i],'#ff6a6a',1.5);
   line(corners[i],corners[(i+1)%4],'#ff6a6a',1.5);}
 }
}
async function tick(){
 try{
  const r=await fetch('/state.json'); S=await r.json();
  if(S.frame_seq!==undefined && S.frame_seq!==tick.seq){
    tick.seq=S.frame_seq;
    document.getElementById('frame').src='/frame.png?s='+S.frame_seq;}
  const t=document.getElementById('stats'); t.innerHTML='';
  for(const [k,v] of Object.entries(S.stats||{})){
    const tr=t.insertRow(); tr.insertCell().textContent=k;
    tr.insertCell().textContent=(typeof v==='number')?v.toFixed(3):v;}
  draw();
 }catch(e){}
 setTimeout(tick,200);
}
tick();
</script></body></html>
"""


class LiveViewer:
    """Serve the live SLAM state over HTTP (see module docstring)."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0",
                 max_traj: int = 20000, subscribe_painter: bool = True):
        self._lock = threading.Lock()
        self._traj: list = []
        self._pose = None
        self._landmarks = np.zeros((0, 3))
        self._stats: dict = {}
        self._frame_png: Optional[bytes] = None
        self._frame_seq = 0
        self._max_traj = max_traj
        self._last_encode_t = -1.0

        viewer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                elif path == "/state.json":
                    body = viewer._state_json()
                    ctype = "application/json"
                elif path == "/frame.png":
                    with viewer._lock:
                        body = viewer._frame_png
                    if body is None:
                        self.send_error(404)
                        return
                    ctype = "image/png"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        ThreadingHTTPServer.allow_reuse_address = True
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self.port = self._srv.server_address[1]
        self._th = threading.Thread(target=self._srv.serve_forever,
                                    daemon=True, name="xrslam-live-viewer")
        self._th.start()
        # frame overlays ride the painter inspection tap (reference
        # InspectPainter, include/xrslam/inspection.h:41-57)
        self._subscribed = False
        self._painter_prev = None
        if subscribe_painter:
            self._painter_prev = inspection.inspect_get(
                inspection.PAINTER_ENABLE)
            inspection.inspect(inspection.PAINTER_ENABLE, True)
            inspection.subscribe(inspection.PAINTER_FRAME, self._on_frame)
            self._subscribed = True

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    # ------------------------------------------------------------------
    def publish(self, pose_q=None, pose_p=None, landmarks=None,
                stats=None) -> None:
        """Update the served state. `pose_q` [w,x,y,z] + `pose_p` append
        to the trajectory; `landmarks` (N,3) replaces the cloud."""
        with self._lock:
            if pose_p is not None:
                p = np.asarray(pose_p, dtype=float)
                self._pose = {
                    "q": [float(v) for v in np.asarray(
                        pose_q if pose_q is not None else [1, 0, 0, 0],
                        dtype=float)],
                    "p": [float(v) for v in p],
                }
                self._traj.append([float(v) for v in p])
                if len(self._traj) > self._max_traj:
                    del self._traj[: len(self._traj) - self._max_traj]
            if landmarks is not None:
                self._landmarks = np.asarray(landmarks, dtype=float) \
                    .reshape(-1, 3)[:5000]
            if stats:
                self._stats.update(stats)

    def _on_frame(self, tap: dict) -> None:
        # Runs synchronously on the pipeline thread (inspection
        # subscriber callback): a viewer failure must never crash the
        # SLAM loop, and per-frame PNG encoding is too expensive for the
        # pipeline's critical path: rate-limit to ~10 Hz and drop the
        # frame (with one log line) on any error.
        try:
            now = time.monotonic()
            if now - self._last_encode_t < 0.1:
                return
            self._last_encode_t = now
            from .viz import draw_overlay

            img = draw_overlay(tap["image"], tap["pts"], tap.get("lengths"))
            buf = io.BytesIO()
            try:
                from PIL import Image

                Image.fromarray(img).save(buf, format="PNG")
            except ImportError:  # PIL-less host: serve nothing, keep state
                return
            with self._lock:
                self._frame_png = buf.getvalue()
                self._frame_seq += 1
        except Exception as e:  # noqa: BLE001 - never crash the pipeline
            from ..utils.logging import log_message

            log_message("warning", f"live viewer frame dropped: {e!r}")

    def _state_json(self) -> bytes:
        with self._lock:
            return json.dumps({
                "traj": self._traj,
                "pose": self._pose,
                "landmarks": self._landmarks.tolist(),
                "stats": self._stats,
                "frame_seq": self._frame_seq,
            }).encode()

    def close(self) -> None:
        if self._subscribed:
            inspection.unsubscribe(inspection.PAINTER_FRAME, self._on_frame)
            inspection.inspect(inspection.PAINTER_ENABLE,
                               self._painter_prev)
            self._subscribed = False
        self._srv.shutdown()
        self._srv.server_close()
