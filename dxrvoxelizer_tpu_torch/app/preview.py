"""Live frame preview over HTTP — the swap-chain Present analog.

Port of ``dxrvoxelizer_tpu/app/preview.py`` (stdlib HTTP; the port keeps its
own copy). The reference presents every frame to a Win32 window (the
WM_PAINT loop, Win32Application.cpp:205-211, drives SwapChain::Present,
DXRVoxelizer.cpp:267). A headless GPU host has no display, so the analog is
a localhost endpoint any browser can watch: a stdlib ThreadingHTTPServer
serves an HTML page whose ``<img>`` re-fetches ``/frame.png`` as fast as
frames arrive (self-paced: the next fetch starts when the previous one
decodes, long-polling on the frame sequence number so an idle scene costs
nothing).

The page is also the INPUT surface: pointer drags and wheel turns on the
frame are POSTed to ``/input`` (coalesced client-side), queued, and drained
by the render loop into the orbit camera — the analog of the reference's
window coupling presentation with WM_MOUSEMOVE/WM_MOUSEWHEEL camera input
(DXRVoxelizer.cpp:301-356, Win32Application.cpp:82-220): you drag-orbit and
wheel-zoom the thing you are looking at.

Zero dependencies: PNG via utils/image.encode_png (stdlib zlib). The render
loop stays decoupled — :meth:`PreviewServer.publish` stores a reference to
the latest frame under a lock (a torch tensor is copied to host numpy
once, there); encoding happens in the HTTP worker thread, and the loop can
consult :meth:`wants_frame` to skip the device->host copy entirely while
nobody is watching.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>dxrvoxelizer_tpu_torch live preview</title>
<style>
 body { background: #111; color: #ccc; font: 13px monospace;
        display: flex; flex-direction: column; align-items: center; }
 img { image-rendering: pixelated; margin-top: 12px;
       border: 1px solid #333; }
</style></head>
<body>
<div id="s">connecting&#8230;</div>
<img id="v" alt="frame">
<script>
const v = document.getElementById('v'), s = document.getElementById('s');
let seq = -1, shown = 0, t0 = performance.now();
// pointer input -> POST /input (drag-orbit + wheel-zoom, coalesced ~30ms)
let drag = false, lx = 0, ly = 0, acc = {dx: 0, dy: 0, wheel: 0}, tmr = null;
function flush() {
  if (tmr) return;
  tmr = setTimeout(() => {
    const ev = acc; acc = {dx: 0, dy: 0, wheel: 0}; tmr = null;
    if (ev.dx || ev.dy || ev.wheel)
      fetch('/input', {method: 'POST',
                       headers: {'Content-Type': 'application/json'},
                       body: JSON.stringify(ev)}).catch(() => {});
  }, 30);
}
v.style.touchAction = 'none';
v.addEventListener('pointerdown', e => {
  drag = true; lx = e.clientX; ly = e.clientY;
  v.setPointerCapture(e.pointerId); e.preventDefault();
});
v.addEventListener('pointerup', () => { drag = false; });
v.addEventListener('pointermove', e => {
  if (!drag) return;
  acc.dx += e.clientX - lx; acc.dy += e.clientY - ly;
  lx = e.clientX; ly = e.clientY; flush();
});
v.addEventListener('wheel', e => {
  e.preventDefault(); acc.wheel += (e.deltaY < 0 ? 1 : -1); flush();
}, {passive: false});
async function loop() {
  for (;;) {
    try {
      // long-poll: the server replies when a frame newer than seq exists
      const r = await fetch('/frame.png?after=' + seq);
      if (r.status === 200) {
        seq = parseInt(r.headers.get('X-Frame-Seq') || '-1');
        const blob = await r.blob();
        const url = URL.createObjectURL(blob);
        await new Promise((res) => { v.onload = res; v.src = url; });
        URL.revokeObjectURL(url);
        shown++;
        const dt = (performance.now() - t0) / 1000;
        if (dt > 0.5) {
          s.textContent = 'frame ' + seq + ' \\u00b7 ' +
                          (shown / dt).toFixed(1) + ' fps shown';
          shown = 0; t0 = performance.now();
        }
      }
    } catch (e) { s.textContent = 'disconnected'; return; }
  }
}
loop();
</script>
</body></html>
"""


class PreviewServer:
    """Publish frames; serve them at ``http://host:port/``.

    ``publish(img)`` accepts [H,W,3] float [0,1] or uint8 images (numpy
    arrays or torch tensors on any device). ``wants_frame()`` is True when
    a client is long-polling for a frame newer than the published one — the
    render loop can use it to skip publishes while nobody watches.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Condition()
        self._frame: np.ndarray | None = None
        self._seq = 0
        self._waiters = 0
        self._inputs: list[dict] = []  # queued /input events (drained)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    after = -1
                    if "after=" in self.path:
                        try:
                            after = int(self.path.split("after=")[1]
                                        .split("&")[0])
                        except ValueError:
                            pass
                    frame, seq = server._wait_frame(after)
                    if frame is None:
                        self.send_response(204)  # no frame yet / timeout
                        self.end_headers()
                        return
                    png = encode_png(frame, level=1)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.send_header("X-Frame-Seq", str(seq))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(png)
                elif self.path.startswith("/stats.json"):
                    body = json.dumps({"seq": server._seq}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if self.path.startswith("/input"):
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                        ev = json.loads(self.rfile.read(length) or b"{}")
                    except (ValueError, json.JSONDecodeError):
                        self.send_response(400)
                        self.end_headers()
                        return
                    events = ev if isinstance(ev, list) else [ev]
                    with server._lock:
                        server._inputs.extend(
                            e for e in events if isinstance(e, dict)
                        )
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="preview-http",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def publish(self, img) -> None:
        """Store the latest frame (a tensor is copied to the host here, once)."""
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        host_img = np.asarray(img)
        with self._lock:
            self._frame = host_img
            self._seq += 1
            self._lock.notify_all()

    def wants_frame(self) -> bool:
        """True when a client is waiting for a newer frame than published."""
        with self._lock:
            return self._waiters > 0

    def poll_inputs(self) -> list[dict]:
        """Drain queued browser input events ({dx, dy, wheel} dicts)."""
        with self._lock:
            out, self._inputs = self._inputs, []
            return out

    def apply_camera_inputs(self, cam) -> bool:
        """Drain queued pointer events into an OrbitCamera.

        Drag deltas are screen pixels -> ``cam.orbit`` (the reference's
        WM_MOUSEMOVE radians-per-pixel mapping lives in the camera,
        DXRVoxelizer.cpp:322-341); ``wheel`` is +/- steps -> ``cam.zoom``
        (OnMouseWheel, :343-356). Returns True when anything applied.
        """
        applied = False
        for ev in self.poll_inputs():
            dx = float(ev.get("dx", 0.0) or 0.0)
            dy = float(ev.get("dy", 0.0) or 0.0)
            wheel = float(ev.get("wheel", 0.0) or 0.0)
            if dx or dy:
                # the page sends current-minus-previous; OrbitCamera.orbit
                # takes previous-minus-current (the reference's convention)
                cam.orbit(-dx, -dy)
                applied = True
            if wheel:
                cam.zoom(wheel)
                applied = True
        return applied

    def _wait_frame(self, after: int, timeout: float = 10.0):
        """Block until a frame with seq > after exists (long poll)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            self._waiters += 1
            try:
                while self._seq <= after or self._frame is None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return None, self._seq
                    self._lock.wait(left)
                return self._frame, self._seq
            finally:
                self._waiters -= 1

    def close(self) -> None:
        with self._lock:
            self._lock.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
