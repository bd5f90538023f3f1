"""Interactive viewer over HTTP (torch port of gui/web.py) — the
displayless counterpart of the reference's Open3D window.

The reference GUI (gui/slam_gui.py:34-683) runs in its own process and
provides three interactive capabilities: (1) re-render the live map from a
user-driven free camera with the SAME differentiable renderer
(slam_gui.py:540-571), (2) shaded depth/normal view modes
(slam_gui.py:461-502), and (3) pausing/resuming the SLAM loop via
Packet_vis2main (utils/slam_frontend.py:333-343). Without a display the
window is a browser: a stdlib HTTP server renders frames on demand (drag =
orbit, wheel = zoom), serves a status strip, and drives the same
["pause"]/["unpause"] control-channel grammar (parallel/pipeline.py) the
threaded pipeline implements.

No third-party dependency: ``http.server`` and gui/headless.py's zlib PNG
encoder (the machine with the card has no imaging package). The HTTP
thread renders on the SLAM's device, on the CUDA stream that was current
where the viewer was made (the caller's, as the --live snapshot thread
does); no one updates a map's tensors in place, so the map it reads is a
consistent snapshot.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..slam.render_api import render
from ..utils.logging import Log
from .headless import colorize_depth, depth_to_normals, encode_png

_PAGE = """<!doctype html>
<html><head><title>GS-SLAM viewer (PyTorch/CUDA port)</title><style>
 body { background:#111; color:#ddd; font-family:monospace; margin:12px }
 #frame { border:1px solid #444; cursor:grab; max-width:95vw }
 button { margin-right:6px } .on { background:#3a6 }
 #bar { margin:8px 0 } #status { color:#8c8 }
</style></head><body>
<div id="bar">
 <button onclick="setMode('color')" id="b_color" class="on">color</button>
 <button onclick="setMode('depth')" id="b_depth">depth</button>
 <button onclick="setMode('normal')" id="b_normal">normal</button>
 <button onclick="setFollow(1)" id="b_follow" class="on">follow cam</button>
 <button onclick="setFollow(0)" id="b_free">free orbit</button>
 <button onclick="control('pause')">pause</button>
 <button onclick="control('unpause')">resume</button>
 <span id="status"></span>
</div>
<img id="frame" width="912" draggable="false"/>
<script>
let mode='color', follow=1, yaw=0, pitch=-0.2, dist=1.0, drag=null;
const img=document.getElementById('frame');
function setMode(m){mode=m;for(const x of ['color','depth','normal'])
 document.getElementById('b_'+x).classList.toggle('on',x==m);}
function setFollow(f){follow=f;
 document.getElementById('b_follow').classList.toggle('on',f==1);
 document.getElementById('b_free').classList.toggle('on',f==0);}
function control(a){fetch('/control?action='+a,{method:'POST'});}
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault();};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;setFollow(0);
 yaw+=(e.clientX-drag[0])*0.01;pitch+=(e.clientY-drag[1])*0.01;
 pitch=Math.max(-1.4,Math.min(1.4,pitch));drag=[e.clientX,e.clientY];};
img.onwheel=e=>{setFollow(0);dist*=Math.exp(e.deltaY*0.001);
 e.preventDefault();};
async function tick(){
 try{
  const r=await fetch(`/frame.png?mode=${mode}&follow=${follow}`+
    `&yaw=${yaw.toFixed(3)}&pitch=${pitch.toFixed(3)}`+
    `&dist=${dist.toFixed(3)}&t=${Date.now()}`);
  if(r.ok){const b=await r.blob();
   const u=URL.createObjectURL(b);
   img.onload=()=>URL.revokeObjectURL(u); img.src=u;}
  const s=await (await fetch('/status')).json();
  document.getElementById('status').textContent=
   ` frame ${s.frame}  kf ${s.n_keyframes}  N ${s.n_gaussians}`+
   (s.paused?'  [PAUSED]':'');
 }catch(e){}
 setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class WebViewer:
    """Serves the live map over HTTP. ``slam`` is the SLAM driver; its
    backend and frontend state is read without locks (the map is replaced,
    never written in place, as for the --live snapshot thread)."""

    def __init__(self, slam, port: int = 8433):
        self.slam = slam
        self.port = port
        self.paused = False
        self._server = None
        self._center = None      # cached orbit target (refreshed lazily)
        self._radius = 2.0
        self._center_n = -1
        dev = slam.device
        self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                        else None)

    # ------------------------------------------------------------ camera
    def _orbit_target(self, gm):
        n = int(gm.num_active())
        if n != self._center_n and n > 0:
            act = gm.active
            w = act.to(torch.float32)[:, None]
            c = torch.sum(gm.xyz * w, dim=0) / torch.clamp(torch.sum(w),
                                                           min=1)
            d = torch.linalg.norm(gm.xyz - c, dim=1)
            r = torch.quantile(torch.where(act, d, torch.zeros_like(d)),
                               0.95)
            cr = torch.cat([c, r[None]]).detach().cpu().numpy()
            self._center, self._radius = cr[:3], max(float(cr[3]), 1e-2)
            self._center_n = n
        return self._center, self._radius

    def _free_pose(self, gm, yaw, pitch, dist):
        center, radius = self._orbit_target(gm)
        if center is None:
            return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        r = radius * dist
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cpos = center + r * np.array([sy * cp, sp, cy * cp - 1.0],
                                     np.float32)
        fwd = center - cpos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0, -1, 0], np.float32)
        if abs(float(np.dot(fwd, up))) > 0.95:
            up = np.array([1, 0, 0], np.float32)
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R = np.stack([right, up2, fwd], axis=1).T.astype(np.float32)
        return R, (-R @ cpos).astype(np.float32)

    # ------------------------------------------------------------ render
    def _render_png(self, mode: str, follow: bool, yaw: float,
                    pitch: float, dist: float) -> bytes:
        slam = self.slam
        dev = slam.device
        with torch.cuda.stream(self._stream), torch.no_grad():
            gm = slam.backend.gm
            if int(gm.num_active()) == 0:
                raise RuntimeError("empty map")
            frames = slam.frontend.frames
            if follow and frames:
                rec = frames[max(frames)]
                R, t = rec.R, rec.t
            else:
                R, t = self._free_pose(gm, yaw, pitch, dist)
            cam = slam.cam.replace(
                R=torch.as_tensor(np.asarray(R, np.float32), device=dev),
                t=torch.as_tensor(np.asarray(t, np.float32), device=dev))
            out = render(gm, cam, None, torch.zeros(3, device=dev),
                         pair_capacity=slam.backend.pair_capacity,
                         use_oracle=slam.backend.use_oracle,
                         need_n_touched=False, device=dev)
            depth = out.depth[0].cpu().numpy()
            color = out.color.cpu().numpy()
        if mode == "depth":
            arr = colorize_depth(depth)
        elif mode == "normal":
            arr = depth_to_normals(depth, slam.cam.fx, slam.cam.fy)
        else:
            arr = np.transpose(color, (1, 2, 0))
        return encode_png((np.clip(arr, 0, 1) * 255).astype(np.uint8))

    def _status(self) -> dict:
        slam = self.slam
        frames = slam.frontend.frames
        return dict(
            frame=max(frames) if frames else -1,
            n_keyframes=len(slam.frontend.kf_indices),
            n_gaussians=int(slam.backend.gm.num_active()),
            paused=self.paused,
        )

    def _control(self, action: str):
        """Route pause/unpause through the reference's control grammar:
        the threaded pipeline's control queue when present
        (Packet_vis2main, pipeline.py), else the driver's single-thread
        poll point."""
        if action not in ("pause", "unpause"):
            return
        self.paused = action == "pause"
        q = self.slam.control_queue
        if q is not None:
            q.put([action])

    # ------------------------------------------------------------ server
    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)

                def f(name, default):
                    return float(q.get(name, [default])[0])

                try:
                    if u.path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif u.path == "/frame.png":
                        png = viewer._render_png(
                            q.get("mode", ["color"])[0],
                            f("follow", 1) > 0,
                            f("yaw", 0), f("pitch", -0.2), f("dist", 1))
                        self._send(200, png, "image/png")
                    elif u.path == "/status":
                        self._send(200,
                                   json.dumps(viewer._status()).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except Exception as e:
                    self._send(503, str(e).encode(), "text/plain")

            def do_POST(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if u.path == "/control":
                    viewer._control(q.get("action", [""])[0])
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

        self._server = ThreadingHTTPServer(("127.0.0.1", self.port),
                                           Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        Log(f"interactive viewer at http://127.0.0.1:{self.port}/",
            tag="GUI")
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
