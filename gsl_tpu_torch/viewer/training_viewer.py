"""In-training web viewer: watch the scene while ``fit`` runs.

Port of ``gsl_tpu/viewer/training_viewer.py``: the page posts its camera
into a one-slot request, and the training loop services it between steps
(`pump`), rendering with the current parameters on the loop's own
thread; the page polls ``/status`` (the last step's scalars and the frame
id) and fetches ``/frame`` (JPEG). `start` binds the port (0 picks a free
one) and keeps the bound port in `port`.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html><html><head><title>gsl_tpu_torch training</title></head>
<body style="margin:0;background:#111;color:#eee;font-family:sans-serif">
<div style="padding:8px">
  <span id="status">waiting...</span><br>
  yaw <input id="yaw" type="range" min="-180" max="180" value="0">
  pitch <input id="pitch" type="range" min="-89" max="89" value="-15">
  dist <input id="dist" type="range" min="1" max="30" value="6" step="0.5">
</div>
<img id="view" style="width:100%" />
<script>
async function tick() {
  const y = document.getElementById('yaw').value;
  const p = document.getElementById('pitch').value;
  const d = document.getElementById('dist').value;
  try {
    const s = await fetch(`/status?yaw=${y}&pitch=${p}&dist=${d}`);
    const st = await s.json();
    document.getElementById('status').textContent =
      `step ${st.step}  loss ${st.loss?.toFixed(4)}  ` +
      `gaussians ${st.n_gaussians}`;
    if (st.frame) document.getElementById('view').src =
      `/frame?t=${st.frame}`;
  } catch (e) {}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class TrainingViewer:
    """Start before the loop; call `pump(step, render_fn, scalars)` at the
    steps the loop chooses."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080,
                 image_size: int = 256, pump_interval: int = 5):
        self.host, self.port = host, port
        self.image_size = image_size
        self.pump_interval = pump_interval
        self._req_lock = threading.Lock()
        self._request: Optional[tuple] = None      # (yaw, pitch, dist)
        self._frame: Optional[bytes] = None
        self._frame_id = 0
        self._scalars = {}
        self._server = None

    # ---- the training loop's side ----
    def pump(self, step: int, render_fn, scalars: dict):
        """Publish `scalars` and, at a pump step, render the pending camera
        request, if any, with render_fn(yaw, pitch, dist) -> uint8 HWC."""
        self._scalars = {"step": step, **{k: float(v) for k, v in
                                          scalars.items()
                                          if np.isscalar(v)
                                          or getattr(v, "ndim", 1) == 0}}
        if step % self.pump_interval != 0:
            return
        with self._req_lock:
            req = self._request
            self._request = None
        if req is None:
            return
        img = render_fn(*req)
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=85)
        self._frame = buf.getvalue()
        self._frame_id += 1

    @property
    def frames(self) -> int:
        """Frames rendered so far."""
        return self._frame_id

    # ---- the server's side ----
    def start(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif u.path == "/status":
                    q = parse_qs(u.query)
                    with viewer._req_lock:
                        viewer._request = (
                            float(q.get("yaw", ["0"])[0]),
                            float(q.get("pitch", ["-15"])[0]),
                            float(q.get("dist", ["6"])[0]))
                    body = dict(viewer._scalars,
                                frame=viewer._frame_id or None)
                    self._send(200, "application/json",
                               json.dumps(body).encode())
                elif u.path == "/frame" and viewer._frame is not None:
                    self._send(200, "image/jpeg", viewer._frame)
                else:
                    self.send_response(404)
                    self.end_headers()

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        print(f"[fit] training viewer at http://{self.host}:{self.port}",
              flush=True)
        return self

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
