"""Live frame-streaming viewer (counterpart of
``loupiote_tpu/app/server.py``): the interactive window's analog for a
host without a display. Frames stream to a browser over HTTP and camera
and settings input comes back:

  GET  /            viewer page (canvas + WASD / mouse handlers)
  GET  /frame?after=N   latest JPEG frame, long-polled past frame N
  GET  /stats       fps / frame timing / scene stats / settings JSON
  POST /input       {"type": "key"|"drag"|"command"|"setting", ...}

One render thread owns every torch and CUDA call (Driver.step, blit and
the JPEG encode, ``image_codec.encode_jpeg``); HTTP threads touch only the
latest-frame slot and the event queue. Run with
``python -m loupiote_tpu_torch serve scene.glb --port 8722``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..image_codec import encode_jpeg
from .input import InputManager

_PAGE = """<!doctype html>
<html><head><title>loupiote viewer</title><style>
body { margin:0; background:#111; color:#ddd; font:13px monospace; }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 10px;
       border-radius:4px; white-space:pre; }
img  { display:block; margin:0 auto; image-rendering:pixelated; }
</style></head><body>
<img id="view" tabindex="0">
<div id="hud">connecting...</div>
<div id="bar" style="position:fixed;top:8px;right:8px;background:#000a;
     padding:6px 10px;border-radius:4px">
  <select id="mode">
    <option value="denoised">denoised</option>
    <option value="pathtrace">pathtrace</option>
    <option value="temporal">temporal</option>
    <option value="gbuffer">gbuffer</option>
    <option value="motion">motion</option>
  </select>
  <button id="shot">&#128247;</button>
</div>
<script>
const img = document.getElementById('view');
const hud = document.getElementById('hud');
let after = -1, dragging = false, lx = 0, ly = 0;
async function frames() {
  for (;;) {
    try {
      const r = await fetch('/frame?after=' + after);
      after = parseInt(r.headers.get('X-Frame-Id'));
      const blob = await r.blob();
      const url = URL.createObjectURL(blob);
      img.onload = () => URL.revokeObjectURL(url);
      img.src = url;
    } catch (e) { await new Promise(r => setTimeout(r, 250)); }
  }
}
async function stats() {
  for (;;) {
    try {
      const s = await (await fetch('/stats')).json();
      hud.textContent = `fps ${s.fps.toFixed(1)}  frame ${s.frame_ms.toFixed(0)}ms` +
        `  accum ${s.accumulate ? 'on' : 'off'} (space)` +
        `\\nWASD/arrows move - drag rotates - ${s.triangles} tris`;
    } catch (e) {}
    await new Promise(r => setTimeout(r, 500));
  }
}
function send(o) { fetch('/input', {method:'POST', body:JSON.stringify(o)}); }
document.getElementById('mode').addEventListener('change', e =>
  send({type:'setting', name:'blit_mode', value:e.target.value}));
document.getElementById('shot').addEventListener('click', () =>
  send({type:'screenshot'}));
const keys = {'w':1,'a':1,'s':1,'d':1,' ':1,'arrowup':'up','arrowdown':'down',
              'arrowleft':'left','arrowright':'right'};
window.addEventListener('keydown', e => { const k = e.key.toLowerCase();
  if (keys[k]) { send({type:'key', key: typeof keys[k]=='string'?keys[k]:k,
                       pressed:true}); e.preventDefault(); } });
window.addEventListener('keyup', e => { const k = e.key.toLowerCase();
  if (keys[k]) send({type:'key', key: typeof keys[k]=='string'?keys[k]:k,
                     pressed:false}); });
img.addEventListener('mousedown', e => { dragging=true; lx=e.clientX; ly=e.clientY; });
window.addEventListener('mouseup', () => dragging=false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  send({type:'drag', dx: e.clientX-lx, dy: e.clientY-ly});
  lx = e.clientX; ly = e.clientY; });
frames(); stats();
</script></body></html>"""


class ViewerServer:
    """HTTP viewer around a Driver. Every torch and CUDA call stays on the
    render thread."""

    def __init__(self, driver, host: str = "127.0.0.1", port: int = 8722,
                 jpeg_quality: int = 85, max_fps: float = 60.0,
                 screenshot_dir: Optional[str] = None):
        self.driver = driver
        self.input = InputManager()
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._frame_lock = threading.Condition()
        self._frame_id = -1
        self._frame_jpeg = b""
        self._stop = threading.Event()
        self._min_dt = 1.0 / max_fps
        self._jpeg_quality = jpeg_quality
        self._stats: dict = {}
        # The loop's split of its last frame, in ms: step, blit, encode.
        self.loop_ms: dict = {}
        self.render_error = None
        # Screenshot directory: server-controlled AND user-owned. A fixed
        # world-writable temporary path could be created (or symlinked)
        # first by another local user to capture or redirect the PNG
        # writes, so the default is a fresh mkdtemp under the user's
        # control, created lazily on first use.
        self._screenshot_dir = screenshot_dir

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/frame"):
                    after = -1
                    if "after=" in self.path:
                        try:
                            after = int(self.path.split("after=")[1]
                                        .split("&")[0])
                        except ValueError:
                            pass
                    fid, data = server.wait_frame(after, timeout=5.0)
                    if data is None:
                        self.send_response(204)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("X-Frame-Id", str(fid))
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path.startswith("/stats"):
                    body = json.dumps(server._stats).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if self.path.startswith("/input"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        server._events.put(json.loads(self.rfile.read(n)))
                        self.send_response(200)
                    except (ValueError, TypeError):
                        self.send_response(400)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        self._http = ThreadingHTTPServer((host, port), Handler)
        self.port = self._http.server_address[1]
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True)
        self._render_thread = threading.Thread(
            target=self._render_loop, daemon=True)

    # -- frame slot ----------------------------------------------------------
    def wait_frame(self, after: int, timeout: float = 5.0):
        deadline = time.time() + timeout
        with self._frame_lock:
            while self._frame_id <= after:
                left = deadline - time.time()
                if left <= 0:
                    return (self._frame_id, self._frame_jpeg or None)
                self._frame_lock.wait(left)
            return self._frame_id, self._frame_jpeg

    def _publish(self, jpeg: bytes):
        with self._frame_lock:
            self._frame_id += 1
            self._frame_jpeg = jpeg
            self._frame_lock.notify_all()

    # -- input ----------------------------------------------------------------
    def _drain_events(self):
        while True:
            try:
                ev = self._events.get_nowait()
            except queue.Empty:
                return
            kind = ev.get("type")
            if kind == "key":
                self.input.handle_key(self.driver, ev.get("key", ""),
                                      bool(ev.get("pressed")))
            elif kind == "drag":
                self.input.handle_mouse_drag(
                    self.driver, float(ev.get("dx", 0)),
                    float(ev.get("dy", 0)))
            elif kind == "command":
                self.driver.run_command(ev.get("command", ""))
            elif kind == "setting":
                name, value = ev.get("name"), ev.get("value")
                if name == "blit_mode":
                    from ..config import BlitMode

                    modes = {"pathtrace": BlitMode.PATHTRACE,
                             "denoised": BlitMode.DENOISED_PATHTRACE,
                             "temporal": BlitMode.TEMPORAL,
                             "gbuffer": BlitMode.GBUFFER,
                             "motion": BlitMode.MOTION_VECTOR}
                    if value in modes:
                        self.driver.settings.blit_mode = modes[value]
                # Only whitelisted settings with validated types: /input is
                # network-facing, so arbitrary setattr from client JSON is
                # off the table.
                elif name == "accumulate":
                    self.driver.settings.accumulate = bool(value)
                elif name == "use_blue_noise":
                    self.driver.settings.use_blue_noise = bool(value)
            elif kind == "screenshot":
                # The path is server-controlled: a client-supplied path
                # would let any network peer write arbitrary files.
                import os
                import time as _t

                if self._screenshot_dir is None:
                    import tempfile

                    self._screenshot_dir = tempfile.mkdtemp(
                        prefix="loupiote_shots_")
                else:
                    os.makedirs(self._screenshot_dir, exist_ok=True)
                    st = os.lstat(self._screenshot_dir)
                    import stat as _stat

                    if (_stat.S_ISLNK(st.st_mode)
                            or st.st_uid != os.getuid()):
                        raise PermissionError(
                            f"screenshot dir {self._screenshot_dir} is a "
                            "symlink or owned by another user")
                path = os.path.join(
                    self._screenshot_dir,
                    f"shot_{int(_t.time() * 1000)}.png")
                self.driver.save_screenshot(path)

    # -- render loop -----------------------------------------------------------
    def _render_loop(self):
        import traceback

        d = self.driver
        errors = 0
        while not self._stop.is_set():
            t0 = time.time()
            try:
                self._drain_events()
                t1 = time.perf_counter()
                d.step()
                # Wait for the frame here, so that step holds its work on
                # the card and blit only its own (tone map and read-back).
                if d.renderer.device.type == "cuda":
                    torch.cuda.synchronize(d.renderer.device)
                t2 = time.perf_counter()
                img = d.renderer.blit()  # (H, W, 3) uint8
                t3 = time.perf_counter()
                jpeg = encode_jpeg(np.asarray(img), self._jpeg_quality)
                t4 = time.perf_counter()
            except Exception:
                self.render_error = traceback.format_exc()
                self._stats = dict(self._stats, render_error=self.render_error)
                errors += 1
                if errors > 10:
                    return
                time.sleep(0.5)
                continue
            self.loop_ms = {"step": (t2 - t1) * 1e3,
                            "blit": (t3 - t2) * 1e3,
                            "encode": (t4 - t3) * 1e3}
            self._publish(jpeg)
            stats = dict(getattr(d, "stats", {}))
            mode = d.settings.blit_mode
            stats.update(fps=d.fps, frame_ms=d.queries.frame_ms,
                         accumulate=d.settings.accumulate,
                         frame_id=self._frame_id,
                         blit_mode=getattr(mode, "value", str(mode)))
            stats.setdefault("triangles", 0)
            self._stats = stats
            dt = time.time() - t0
            if dt < self._min_dt:
                time.sleep(self._min_dt - dt)

    # -- lifecycle --------------------------------------------------------------
    def start(self):
        self._http_thread.start()
        self._render_thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._http.shutdown()
        self._http.server_close()
        self._render_thread.join(timeout=10)

    def serve_forever(self):
        self.start()
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            self.stop()
