"""Interactive web viewer: serve a trained model over HTTP.

Port of ``gsl_tpu/viewer/viewer.py``: the same page and routes (``/``,
``/outputs``, ``/render``, ``/transform``, ``/edit/delete_box``,
``/path/add``, ``/path/save``, ``/path/clear``, ``/path/render.gif``,
``/measure``), rendered by ``ViewerRenderer`` on the model's device. While
the camera moves (requests closer together than `moving_window_s`)
frames render at half resolution, and an idle request renders at full
resolution; a request that comes sooner than ``1 / max_fps`` after the
last render, or repeats the last idle pose, gets the cached frame.

Renders and edits of the model take one lock, so two requests never
render at once (the JAX package takes none): on the card each 1M-row
frame holds its own buffers. The throttle reads the clock under its own
lock (the JAX package reads it before, so a request that loses the race
sees a negative interval and renders at half size). `start` binds the port (0 picks a free one)
and keeps the bound port in `port`.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils.gaussian_model_loader import GaussianModelLoader
from .camera_path import CameraPath, orbit_c2w
from .panels import delete_in_box, transform_state
from .renderer import ViewerRenderer

_PAGE = """<!DOCTYPE html><html><head><title>gsl_tpu_torch viewer</title></head>
<body style="margin:0;background:#111;color:#eee;font-family:sans-serif">
<div style="padding:8px">
  yaw <input id="yaw" type="range" min="-180" max="180" value="0">
  pitch <input id="pitch" type="range" min="-89" max="89" value="-15">
  dist <input id="dist" type="range" min="1" max="30" value="6" step="0.5">
  output <select id="out"></select>
</div>
<details style="padding:8px"><summary>transform</summary>
  tx <input id="tx" size=4 value="0"> ty <input id="ty" size=4 value="0">
  tz <input id="tz" size=4 value="0"> |
  rx <input id="rx" size=4 value="0"> ry <input id="ry" size=4 value="0">
  rz <input id="rz" size=4 value="0"> |
  s <input id="sc" size=4 value="1">
  <button onclick="applyTransform()">apply</button>
  <button onclick="fetch('/transform?reset=1').then(refresh)">reset</button>
</details>
<details style="padding:8px"><summary>edit (delete box)</summary>
  min <input id="bmin" size=12 value="-1,-1,-1">
  max <input id="bmax" size=12 value="1,1,1">
  <button onclick="deleteBox()">delete inside</button>
  <span id="editmsg"></span>
</details>
<details style="padding:8px"><summary>camera path</summary>
  <button onclick="addKeyframe()">add keyframe</button>
  <button onclick="fetch('/path/clear')">clear</button>
  <a href="/path/render.gif" target="_blank">render gif</a>
  <span id="pathmsg"></span>
</details>
<details style="padding:8px"><summary>measure (click two points)</summary>
  <button onclick="measureMode=!measureMode;points=[];this.textContent=
    measureMode?'measuring: click image twice':'measure'">measure</button>
  <span id="measuremsg"></span>
</details>
<img id="view" style="width:100%" />
<script>
const img = document.getElementById('view');
let measureMode = false; let points = [];
async function outputs() {
  const r = await fetch('/outputs'); const names = await r.json();
  const sel = document.getElementById('out');
  for (const n of names) { const o = document.createElement('option');
    o.value = n; o.text = n; sel.add(o); }
}
function refresh() {
  const y = document.getElementById('yaw').value;
  const p = document.getElementById('pitch').value;
  const d = document.getElementById('dist').value;
  const o = document.getElementById('out').value || 'rgb';
  img.src = `/render?yaw=${y}&pitch=${p}&dist=${d}&output=${o}&t=${Date.now()}`;
}
for (const id of ['yaw','pitch','dist','out'])
  document.getElementById(id).addEventListener('input', refresh);
function val(id) { return document.getElementById(id).value; }
async function applyTransform() {
  await fetch(`/transform?tx=${val('tx')}&ty=${val('ty')}&tz=${val('tz')}` +
    `&rx=${val('rx')}&ry=${val('ry')}&rz=${val('rz')}&s=${val('sc')}`);
  refresh();
}
async function deleteBox() {
  const r = await fetch(`/edit/delete_box?min=${val('bmin')}&max=${val('bmax')}`);
  document.getElementById('editmsg').textContent = await r.text();
  refresh();
}
async function addKeyframe() {
  const r = await fetch(`/path/add?yaw=${val('yaw')}&pitch=${val('pitch')}&dist=${val('dist')}`);
  document.getElementById('pathmsg').textContent = await r.text();
}
img.addEventListener('click', async (e) => {
  if (!measureMode) return;
  const r = img.getBoundingClientRect();
  points.push([(e.clientX - r.left) / r.width,
               (e.clientY - r.top) / r.height]);
  if (points.length == 2) {
    const q = `p1=${points[0]}&p2=${points[1]}&yaw=${val('yaw')}` +
      `&pitch=${val('pitch')}&dist=${val('dist')}`;
    const resp = await fetch(`/measure?${q}`);
    document.getElementById('measuremsg').textContent = await resp.text();
    points = [];
  } else {
    document.getElementById('measuremsg').textContent = 'point 1 set';
  }
});
outputs().then(refresh);
</script></body></html>"""


def png_bytes(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


class Viewer:
    def __init__(self, model_path: str, host: str = "0.0.0.0",
                 port: int = 8080, background=(0.0, 0.0, 0.0),
                 image_size: int = 512, max_fps: float = 10.0,
                 moving_window_s: float = 0.4, device=None):
        state, renderer, sh_degree = GaussianModelLoader.load(model_path,
                                                              device)
        self._base_state = state
        self.renderer = ViewerRenderer(state, renderer, sh_degree,
                                       background)
        self.camera_path = CameraPath()
        self.host, self.port = host, port
        self.image_size = image_size
        self.max_fps = max_fps
        self.moving_window_s = moving_window_s
        # throttling state: the time of the last request and render, the
        # last frame and the idle pose it shows
        self._last_request = 0.0
        self._last_render = 0.0
        self._cached_frame = None
        self._cache_key = None
        self._lock = threading.Lock()
        self._render_lock = threading.Lock()
        self._server = None
        # the orbit's centre: the mean of the scene's centres
        self.target = state.params.means[state.alive].mean(0).cpu().numpy()

    def render_image(self, yaw, pitch, dist, size, output="rgb"):
        """The uint8 frame of `output` at an orbit pose, size x size."""
        c2w = orbit_c2w(yaw, pitch, dist, self.target)
        with self._render_lock:
            self.renderer.output_type = output
            return self.renderer.get_outputs(c2w, size, size)

    def render_frame(self, yaw, pitch, dist, output="rgb"):
        """-> (png bytes, resolution): half resolution while the camera
        moves, full when idle; the cached frame when over the fps cap."""
        key = (round(yaw, 3), round(pitch, 3), round(dist, 3), output)
        with self._lock:
            # read under the lock: a request that read the clock before
            # another took the lock would see a negative interval
            now = time.monotonic()
            moving = (now - self._last_request) < self.moving_window_s
            self._last_request = now
            over_budget = (now - self._last_render) < 1.0 / self.max_fps
            if self._cached_frame is not None and (
                    over_budget or key == self._cache_key):
                return self._cached_frame
        size = self.image_size // 2 if moving else self.image_size
        frame = (png_bytes(self.render_image(yaw, pitch, dist, size,
                                             output)), size)
        with self._lock:
            self._last_render = time.monotonic()
            # only an idle frame stands for its pose
            self._cached_frame = frame
            self._cache_key = key if not moving else None
        return frame

    def measure(self, yaw, pitch, dist, p1_uv, p2_uv):
        """Two image points (normalised uv) -> their world distance through
        the expected-depth map; -> (distance, point 1, point 2)."""
        size = self.image_size
        c2w = orbit_c2w(yaw, pitch, dist, self.target)
        with self._render_lock:
            depth = self.renderer.get_depth(c2w, size, size)

        def unproject(uv):
            px = min(int(uv[0] * size), size - 1)
            py = min(int(uv[1] * size), size - 1)
            z = float(depth[py, px])
            f = 0.5 * size / np.tan(0.5 * np.deg2rad(60.0))
            d_cam = np.array([(px + 0.5 - size / 2) / f,
                              (py + 0.5 - size / 2) / f, 1.0]) * z
            return c2w[:3, :3] @ d_cam + c2w[:3, 3]

        a, b = unproject(p1_uv), unproject(p2_uv)
        return float(np.linalg.norm(a - b)), a, b

    def set_state(self, state):
        """Show `state` from now on (drops the cached frame)."""
        with self._render_lock:
            self.renderer.state = state
        with self._lock:
            self._cached_frame = None

    def transform(self, translate, rotate_deg, scale):
        """The loaded model under a transform (edits before it are
        dropped, as in the JAX package)."""
        self.set_state(transform_state(self._base_state, translate,
                                       rotate_deg, scale))

    def delete_box(self, bbox_min, bbox_max) -> int:
        with self._render_lock:
            state, n = delete_in_box(self.renderer.state, bbox_min, bbox_max)
        self.set_state(state)
        return n

    def render_gif(self, n_frames: int = 30) -> bytes:
        return self.camera_path.render_gif(
            lambda yaw, pitch, dist: self.render_image(
                yaw, pitch, dist, self.image_size), n_frames=n_frames)

    def start(self, block: bool = True):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, ctype, body):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(body)

            def _ok(self, text):
                self._send("text/plain", text.encode())

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)

                def g(k, d=None):
                    # a value that has no default must be given
                    return float(q[k][0] if d is None else q.get(k, [d])[0])

                def vec(k):
                    return [float(x) for x in q[k][0].split(",")]

                if u.path == "/":
                    self._send("text/html", _PAGE.encode())
                elif u.path == "/outputs":
                    self._send("application/json", json.dumps(
                        viewer.renderer.available_output_types()).encode())
                elif u.path == "/transform":
                    if q.get("reset"):
                        viewer.set_state(viewer._base_state)
                        return self._ok("reset")
                    viewer.transform((g("tx", 0.0), g("ty", 0.0),
                                      g("tz", 0.0)),
                                     (g("rx", 0.0), g("ry", 0.0),
                                      g("rz", 0.0)), g("s", 1.0))
                    self._ok("ok")
                elif u.path == "/edit/delete_box":
                    n = viewer.delete_box(vec("min"), vec("max"))
                    self._ok(f"deleted {n}")
                elif u.path == "/path/add":
                    viewer.camera_path.add(g("yaw"), g("pitch"), g("dist"))
                    self._ok(f"{len(viewer.camera_path.keyframes)} "
                             "keyframes")
                elif u.path == "/path/save":
                    out = q.get("file", ["camera_path.json"])[0]
                    with open(out, "w") as f:
                        json.dump({"keyframes":
                                   viewer.camera_path.keyframes}, f)
                    self._ok(f"saved {out}")
                elif u.path == "/path/clear":
                    viewer.camera_path.clear()
                    self._ok("cleared")
                elif u.path == "/path/render.gif":
                    self._send("image/gif", viewer.render_gif())
                elif u.path == "/measure":
                    d, _, _ = viewer.measure(
                        g("yaw", "0"), g("pitch", "-15"), g("dist", "6"),
                        vec("p1"), vec("p2"))
                    self._ok(f"distance {d:.4f}")
                elif u.path == "/render":
                    png, _ = viewer.render_frame(
                        g("yaw", "0"), g("pitch", "-15"), g("dist", "6"),
                        q.get("output", ["rgb"])[0])
                    self._send("image/png", png)
                else:
                    self.send_response(404)
                    self.end_headers()

        server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server = server
        self.port = server.server_address[1]
        print(f"viewer at http://{self.host}:{self.port}", flush=True)
        if block:
            server.serve_forever()
        else:
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()
        return server

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
