"""Zero-dependency live viewer: stdlib HTTP server + full-control web page
(port of ``gstk_tpu/viewer/http_viewer.py``).

The reference's live viewer is viser-based (``gs_toolkit/viewer/viewer.py:42``,
websocket render state machine) with three GUI panels. This module provides
the same capabilities with only the standard library:

  * orbit/zoom/pan rendering (``/render``) served from the latest scene
    snapshot;
  * a **control panel** (reference ``viewer/control_panel.py:1-494``):
    background color, crop box (enable + min/max corners), SH degree
    override, max render resolution, depth view — all applied server-side
    through ``/settings``;
  * a **keyframe trajectory editor** (reference ``viewer/render_panel.py:
    1-1247``): add/list/reorder/delete keyframes, preview the interpolated
    path in the viewport, download the ``camera_path.json`` that
    ``gs-render trajectory`` consumes;
  * an **export tab** (reference ``viewer/export_panel.py:1-231``): emits
    ready-to-run ``gstk_torch.scripts.export`` / ``.render`` commands for
    the loaded run (``/export_cmd``), with the flags those CLIs take.

Frames are PNGs from the port's zlib encoder
(:func:`gstk_torch.utils.io.encode_png`), lossless; gstk_tpu serves JPEG
through Pillow, which the port does not need.

The trainer publishes scene snapshots via :meth:`TrainingViewer.update_scene`.
Rendering runs in the HTTP threads, beside the train step. The trainer
updates its scene in place (Adam, refinement, capacity growth), so
``update_scene`` keeps a detached clone, taken on the trainer's thread and
stream: a frame never sees a half-updated scene, and the clone is ordered
before every render on the default stream.
"""

from __future__ import annotations

import json
import shlex
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gstk_torch import DeviceLike, resolve_device
from gstk_torch.core.cameras import Camera
from gstk_torch.core.gaussians import FIELD_NAMES, GaussianScene
from gstk_torch.core.scene_box import SceneBox
from gstk_torch.models.vanilla import render_scene
from gstk_torch.utils.io import encode_png

# zlib level of a served frame: the fastest, about a quarter quicker than
# the default on a 640x480 frame (PERF.md, chip_smoke.py phase 15)
FRAME_PNG_LEVEL = 1

_PAGE = """<!DOCTYPE html>
<html><head><title>gstk_torch viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace;display:flex}
#img{display:block;cursor:grab;flex:0 0 auto}
#panel{width:330px;padding:10px;background:#1a1a1a;height:100vh;
  overflow-y:auto;font-size:12px}
#panel h3{margin:12px 0 4px;color:#8cf}
#panel label{display:block;margin:3px 0}
#panel input[type=number]{width:62px;background:#222;color:#ddd;
  border:1px solid #444}
#panel input[type=range]{width:120px}
button{background:#333;color:#ddd;border:1px solid #555;margin:2px;
  cursor:pointer}
#kflist div{padding:2px;border-bottom:1px solid #333}
textarea{width:100%;height:70px;background:#222;color:#9f9;border:none}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px}
</style></head><body>
<div>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan<br/>
<span id="stats"></span></div>
<img id="img" width="640" height="480"/>
</div>
<div id="panel">
<h3>Controls</h3>
<label>background <input type="color" id="bg" value="#26293729"
  oninput="push()"/></label>
<label>output <select id="output" onchange="push()">
  <option value="rgb">rgb</option><option value="depth">depth</option>
</select></label>
<label>sh degree <input type="range" id="sh" min="0" max="3" value="3"
  oninput="document.getElementById('shv').textContent=this.value;push()"/>
  <span id="shv">3</span></label>
<label>max res <input type="number" id="maxres" value="640"
  onchange="push()"/></label>
<label><input type="checkbox" id="cropon" onchange="push()"/> crop box</label>
<div id="cropbox">
min <input type="number" id="cx0" value="-2" step="0.1" onchange="push()"/>
<input type="number" id="cy0" value="-2" step="0.1" onchange="push()"/>
<input type="number" id="cz0" value="-2" step="0.1" onchange="push()"/><br/>
max <input type="number" id="cx1" value="2" step="0.1" onchange="push()"/>
<input type="number" id="cy1" value="2" step="0.1" onchange="push()"/>
<input type="number" id="cz1" value="2" step="0.1" onchange="push()"/>
</div>
<h3>Keyframes</h3>
<button onclick="kfAdd()">add current view</button>
<button onclick="kfClear()">clear</button>
<div id="kflist"></div>
<label>steps/seg <input type="number" id="steps" value="30"/></label>
<button onclick="preview()">preview path</button>
<button onclick="dlTraj()">download camera_path.json</button>
<h3>Export</h3>
<select id="exptype">
<option value="gaussian-splat">gaussian-splat (PLY)</option>
<option value="point-cloud">point-cloud</option>
<option value="offline-tsdf">offline-tsdf (mesh)</option>
<option value="camera-poses">camera-poses</option>
<option value="render-trajectory">render trajectory</option>
</select>
<button onclick="exportCmd()">generate command</button>
<textarea id="expcmd" readonly></textarea>
</div>
<script>
let az=0, el=0.3, r=3.0, cx=0, cy=0, cz=0, drag=false, lx=0, ly=0, shift=false;
const img=document.getElementById('img');
function v(id){return document.getElementById(id).value;}
function settings(){
  const bgc=v('bg');
  return {bg:[parseInt(bgc.substr(1,2),16)/255,parseInt(bgc.substr(3,2),16)/255,
          parseInt(bgc.substr(5,2),16)/255],
    output:v('output'), sh_degree:parseInt(v('sh')),
    max_res:parseInt(v('maxres')),
    crop_enabled:document.getElementById('cropon').checked,
    crop_min:[+v('cx0'),+v('cy0'),+v('cz0')],
    crop_max:[+v('cx1'),+v('cy1'),+v('cz1')]};
}
function push(){fetch('/settings',{method:'POST',
  body:JSON.stringify(settings())}).then(refresh);}
function url(){return `/render?az=${az}&el=${el}&r=${r}&cx=${cx}&cy=${cy}&cz=${cz}&t=${Date.now()}`;}
let busy=false;
function refresh(){ if(busy) return; busy=true;
  const u=url(); const pre=new Image();
  pre.onload=()=>{img.src=u; busy=false;}; pre.onerror=()=>{busy=false;};
  pre.src=u; }
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;shift=e.shiftKey;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-lx, dy=e.clientY-ly; lx=e.clientX; ly=e.clientY;
  if(shift){cx-=dx*0.002*r; cy+=dy*0.002*r;}
  else{az-=dx*0.01; el=Math.max(-1.5,Math.min(1.5,el+dy*0.01));}
  refresh();};
img.onwheel=e=>{e.preventDefault(); r*=Math.exp(e.deltaY*0.001); refresh();};
function kfRefresh(){fetch('/keyframes').then(r=>r.json()).then(d=>{
  const el=document.getElementById('kflist'); el.innerHTML='';
  d.keyframes.forEach((k,i)=>{
    const row=document.createElement('div');
    const p=k[0].map((_,j)=>k[j%3][3].toFixed(2));
    row.innerHTML=`#${i} pos(${k[0][3].toFixed(2)},${k[1][3].toFixed(2)},`+
      `${k[2][3].toFixed(2)}) `+
      `<button onclick="kfMove(${i},-1)">&uarr;</button>`+
      `<button onclick="kfMove(${i},1)">&darr;</button>`+
      `<button onclick="kfDel(${i})">x</button>`+
      `<button onclick="kfGoto(${i})">view</button>`;
    el.appendChild(row);});});}
function kfAdd(){fetch(`/keyframe/add?az=${az}&el=${el}&r=${r}&cx=${cx}&cy=${cy}&cz=${cz}`)
  .then(kfRefresh);}
function kfClear(){fetch('/keyframe/clear').then(kfRefresh);}
function kfDel(i){fetch(`/keyframe/delete?i=${i}`).then(kfRefresh);}
function kfMove(i,d){fetch(`/keyframe/move?i=${i}&dir=${d}`).then(kfRefresh);}
function kfGoto(i){fetch('/keyframes').then(r=>r.json()).then(d=>{
  const k=d.keyframes[i]; // render this exact pose once
  img.src=`/render_pose?i=${i}&t=${Date.now()}`;});}
async function preview(){
  const resp=await fetch(`/trajectory?steps=${v('steps')}`);
  if(!resp.ok){alert(await resp.text());return;}
  const path=await resp.json();
  for(let i=0;i<path.camera_path.length;i+=2){
    await new Promise(res=>{const pre=new Image();
      pre.onload=()=>{img.src=pre.src;res();};
      pre.onerror=res;
      pre.src=`/render_traj?i=${i}&t=${Date.now()}`;});
  }}
function dlTraj(){
  fetch(`/trajectory?steps=${v('steps')}`).then(r=>r.json()).then(d=>{
    const a=document.createElement('a');
    a.href=URL.createObjectURL(new Blob([JSON.stringify(d,null,1)],
      {type:'application/json'}));
    a.download='camera_path.json'; a.click();});}
function exportCmd(){
  fetch(`/export_cmd?type=${v('exptype')}`).then(r=>r.json()).then(d=>{
    document.getElementById('expcmd').value=d.command;});}
setInterval(()=>{fetch('/stats').then(r=>r.json()).then(s=>{
  document.getElementById('stats').textContent=JSON.stringify(s);});
  refresh();}, 2000);
refresh(); kfRefresh();
</script></body></html>"""


def orbit_pose(az: float, el: float, radius: float, center) -> np.ndarray:
    """OpenGL c2w looking at ``center`` from spherical (az, el, radius)."""
    eye = np.asarray(center, np.float64) + radius * np.array(
        [
            np.cos(el) * np.sin(az),
            np.sin(el),
            np.cos(el) * np.cos(az),
        ]
    )
    forward = np.asarray(center, np.float64) - eye
    forward /= np.linalg.norm(forward)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(forward, up)
    if np.linalg.norm(right) < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4, dtype=np.float32)[:3]
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward  # OpenGL: camera looks along -z
    c2w[:3, 3] = eye
    return c2w


DEFAULT_SETTINGS = {
    "bg": [0.149, 0.1647, 0.2157],
    "output": "rgb",
    "sh_degree": 3,
    "max_res": 640,
    "crop_enabled": False,
    "crop_min": [-2.0, -2.0, -2.0],
    "crop_max": [2.0, 2.0, 2.0],
}




class ViewerServer:
    """Background HTTP viewer. ``render_fn(c2w, h, w, settings) -> rgb
    uint8`` (settings dict per DEFAULT_SETTINGS). The socket is bound here;
    :meth:`start` serves it from a daemon thread and :meth:`stop` closes
    it."""

    def __init__(self, render_fn, host: str = "0.0.0.0", port: int = 7007,
                 width: int = 640, height: int = 480,
                 run_info: Optional[dict] = None):
        self.render_fn = render_fn
        self.stats = {}
        self.width = width
        self.height = height
        self.settings = dict(DEFAULT_SETTINGS)
        # gs-export command generation needs the run's config path
        self.run_info = run_info or {}
        # keyframe trajectory editor state (the functional core of the
        # reference's render panel, viewer/render_panel.py:1-1247: collect
        # keyframes, interpolate, emit a camera_path json for gs-render)
        self.keyframes = []
        self._traj_cache = None
        # requests run in threads of their own: edits of the settings and
        # keyframes are read-modify-writes
        self._state_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _render_c2w(self, c2w):
                with outer._state_lock:
                    s = dict(outer.settings)
                scale = min(
                    1.0, s.get("max_res", 640) / max(outer.width, outer.height)
                )
                h = max(16, int(outer.height * scale))
                w = max(16, int(outer.width * scale))
                rgb = outer.render_fn(c2w, h, w, s)
                self._send(encode_png(rgb, FRAME_PNG_LEVEL), "image/png")

            def _send(self, body: bytes, kind: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", kind)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _missing(self, code: int = 404, text: bytes = b""):
                self._send(text, "text/plain", code)

            def _query(self, parsed, cast=str):
                return {k: cast(v[0]) for k, v in parse_qs(parsed.query).items()
                        if k != "t"}

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                elif parsed.path == "/stats":
                    self._json(outer.stats)
                elif parsed.path == "/settings":
                    with outer._state_lock:
                        self._json(dict(outer.settings))
                elif parsed.path == "/render":
                    self._render_c2w(_orbit_query(self._query(parsed, float)))
                elif parsed.path == "/render_pose":
                    i = int(self._query(parsed).get("i", 0))
                    with outer._state_lock:
                        kfs = list(outer.keyframes)
                    if not (0 <= i < len(kfs)):
                        return self._missing()
                    self._render_c2w(kfs[i])
                elif parsed.path == "/render_traj":
                    i = int(self._query(parsed).get("i", 0))
                    poses = outer._traj_cache
                    if poses is None or not (0 <= i < len(poses)):
                        return self._missing()
                    self._render_c2w(poses[i])
                elif parsed.path == "/keyframe/add":
                    # record the current orbit pose as a trajectory keyframe
                    c2w = _orbit_query(self._query(parsed, float))
                    with outer._state_lock:
                        outer.keyframes.append(np.asarray(c2w, np.float32))
                        n = len(outer.keyframes)
                    self._json({"num_keyframes": n})
                elif parsed.path == "/keyframe/clear":
                    with outer._state_lock:
                        outer.keyframes.clear()
                    self._json({"num_keyframes": 0})
                elif parsed.path == "/keyframe/delete":
                    i = int(self._query(parsed).get("i", -1))
                    with outer._state_lock:
                        if 0 <= i < len(outer.keyframes):
                            outer.keyframes.pop(i)
                        n = len(outer.keyframes)
                    self._json({"num_keyframes": n})
                elif parsed.path == "/keyframe/move":
                    q = self._query(parsed)
                    i = int(q.get("i", -1))
                    j = i + int(q.get("dir", 0))
                    with outer._state_lock:
                        kfs = outer.keyframes
                        if 0 <= i < len(kfs) and 0 <= j < len(kfs):
                            kfs[i], kfs[j] = kfs[j], kfs[i]
                        n = len(kfs)
                    self._json({"num_keyframes": n})
                elif parsed.path == "/keyframes":
                    with outer._state_lock:
                        kfs = [k.tolist() for k in outer.keyframes]
                    self._json({"keyframes": kfs})
                elif parsed.path == "/trajectory":
                    # interpolated camera_path json (consumable by
                    # `gs-render trajectory`), like the reference render
                    # panel's export button
                    from gstk_torch.core.trajectories import (
                        interpolate_poses,
                        poses_to_camera_path,
                    )

                    q = self._query(parsed, float)
                    with outer._state_lock:
                        kfs = list(outer.keyframes)
                    if len(kfs) < 2:
                        return self._missing(400, b"need >= 2 keyframes")
                    poses = interpolate_poses(
                        kfs, steps_per_segment=int(q.get("steps", 30)))
                    outer._traj_cache = [
                        np.asarray(p, np.float32) for p in poses
                    ]
                    self._json(poses_to_camera_path(
                        poses,
                        fov_deg=q.get("fov", 70.0),
                        render_height=int(q.get("h", 1080)),
                        render_width=int(q.get("w", 1920)),
                        fps=q.get("fps", 30.0),
                    ))
                elif parsed.path == "/export_cmd":
                    kind = self._query(parsed).get("type", "")
                    self._json({"command": outer.export_command(kind)})
                else:
                    self._missing()

            def do_POST(self):
                parsed = urlparse(self.path)
                n = int(self.headers.get("Content-Length", 0))
                data = json.loads(self.rfile.read(n) or b"{}")
                if parsed.path == "/keyframe/add":
                    # raw keyframe upload: {"c2w": [[...3x4 or 4x4]]}
                    c2w = np.asarray(data["c2w"], np.float32)[:3, :4]
                    with outer._state_lock:
                        outer.keyframes.append(c2w)
                        n = len(outer.keyframes)
                    self._json({"num_keyframes": n})
                elif parsed.path == "/settings":
                    with outer._state_lock:
                        for k in DEFAULT_SETTINGS:
                            if k in data:
                                outer.settings[k] = data[k]
                        settings = dict(outer.settings)
                    self._json(settings)
                else:
                    self._missing()

            def _json(self, obj):
                self._send(json.dumps(obj).encode(), "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def export_command(self, kind: str) -> str:
        """Ready-to-run CLI line for the loaded run (reference
        export_panel.py:1-231 generates the same strings), with the flags
        the port's gs-export and gs-render take."""
        cfg = shlex.quote(str(self.run_info.get("config_path",
                                                "<run>/config.yml")))
        out = shlex.quote(str(self.run_info.get("export_dir", "exports")))
        base = "python -m gstk_torch.scripts.export"
        if kind == "gaussian-splat":
            return f"{base} gaussian-splat --load-config {cfg} --output-dir {out}"
        if kind == "point-cloud":
            return (
                f"{base} point-cloud --load-config {cfg} --output-dir {out} "
                f"--num-points 1000000"
            )
        if kind == "offline-tsdf":
            return (
                f"{base} offline-tsdf --load-config {cfg} --output-dir {out} "
                f"--meshing poisson --clean"
            )
        if kind == "camera-poses":
            return f"{base} camera-poses --load-config {cfg} --output-dir {out}"
        if kind == "render-trajectory":
            # gs-render trajectory writes beside the config and takes no
            # output directory
            return (
                "python -m gstk_torch.scripts.render trajectory --load-config "
                f"{cfg} --trajectory-path camera_path.json"
            )
        return f"unknown export type: {kind}"

    def start(self):
        self._thread.start()
        print(f"Viewer running at http://localhost:{self.port}", flush=True)
        return self

    def update_stats(self, stats: dict):
        self.stats = dict(stats)

    def stop(self):
        """Stop serving and close the socket."""
        if self._thread.is_alive():
            self._httpd.shutdown()
            self._thread.join()
        self._httpd.server_close()


def _orbit_query(q: dict) -> np.ndarray:
    """The c2w of an orbit request's ``az``, ``el``, ``r`` and centre."""
    return orbit_pose(
        q.get("az", 0.0), q.get("el", 0.3), q.get("r", 3.0),
        (q.get("cx", 0.0), q.get("cy", 0.0), q.get("cz", 0.0)),
    )


class TrainingViewer:
    """Glue between the trainer and the HTTP viewer: keeps a scene snapshot
    and renders it on demand through :func:`render_scene` (the compositing
    kernels on a card), with the raster config it is given.

    ``update_scene`` clones the scene, detached, under the lock; a render
    takes the latest clone under the lock and renders it under
    ``torch.no_grad()`` (grad mode is per thread) on ``device`` (``cuda``
    unless given)."""

    def __init__(self, model_config, raster_config, port: int = 7007,
                 run_info: Optional[dict] = None, host: str = "0.0.0.0",
                 device: DeviceLike = None):
        self.model_config = model_config
        self.raster_config = raster_config
        self.device = resolve_device(device)
        self._scene = None
        self._lock = threading.Lock()
        self.server = ViewerServer(self.render, host=host, port=port,
                                   run_info=run_info)

    def render(self, c2w, h: int, w: int, settings: dict) -> np.ndarray:
        """(h, w, 3) uint8 frame of the latest snapshot from ``c2w`` with the
        control panel's ``settings``; black before the first snapshot."""
        with self._lock:
            scene = self._scene
        if scene is None:
            return np.zeros((h, w, 3), np.uint8)
        sh = min(int(settings.get("sh_degree", 3)),
                 self.model_config.sh_degree)
        camera = Camera.create(0.8 * w, 0.8 * w, w / 2, h / 2,
                               np.asarray(c2w, np.float32), device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        bg = torch.tensor(settings.get("bg", [0.15, 0.16, 0.22]), **f32)
        box = None
        if settings.get("crop_enabled"):
            box = SceneBox(aabb=torch.tensor(
                [settings.get("crop_min", [-2, -2, -2]),
                 settings.get("crop_max", [2, 2, 2])], **f32))
        with torch.no_grad():
            out = render_scene(
                scene, camera, h, w, sh_degree=sh, background=bg,
                config=self.model_config, raster_config=self.raster_config,
                crop_box=box,
            )
            img = out["rgb"]
            if settings.get("output") == "depth":
                d, a = out["depth"], out["alpha"] > 0.1
                if bool(a.any()):
                    lo = d[a].min()
                    hi = torch.clamp(d[a].max(), min=1e-6)
                    d = torch.where(
                        a, (d - lo) / torch.clamp(hi - lo, min=1e-6),
                        torch.ones_like(d))
                img = d[..., None].expand(h, w, 3)
            frame = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
        return frame.cpu().numpy()

    def start(self):
        self.server.start()
        return self

    def stop(self):
        self.server.stop()

    def update_scene(self, scene, stats: Optional[dict] = None):
        """Publish a snapshot of ``scene``: a detached clone, so the
        trainer's in-place updates never reach a frame."""
        with self._lock:
            self._scene = GaussianScene(**{
                k: getattr(scene, k).detach().clone() for k in FIELD_NAMES})
        if stats:
            self.server.update_stats(stats)
