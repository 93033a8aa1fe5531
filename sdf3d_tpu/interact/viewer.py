"""Live browser viewer: the reference's interactive window, over HTTP.

The reference opens a GLFW window and runs a mouse/gamepad-navigated frame
loop (``/root/reference/Code/src/main.cpp:48,87-98`` via Neutrino's
``nu::opengl``).  A headless GPU host has no display: frames are device
arrays, possibly on a machine across the network.  The equivalent of "a
window" is a tiny HTTP server:

- ``GET /``        — a self-contained HTML page: a canvas showing the PNG
  stream, with mouse-drag orbit, shift/right-drag pan, and wheel zoom
  forwarded as JSON events (the ``gl->mouse_navigation`` analogue,
  ``main.cpp:93``);
- ``GET /stream``  — ``multipart/x-mixed-replace`` PNG stream (MJPEG-style,
  stdlib-only — no JPEG encoder needed);
- ``GET /frame.png`` — the latest frame, for polling clients/tests;
- ``POST /event``  — ``{"type": "drag"|"pan"|"scroll", ...}`` navigation
  events, queued to the render thread;
- ``GET /stats``   — frame counter + rays/s JSON (the tic/toc analogue,
  ``main.cpp:89,97``).

Threading: HTTP handlers never touch JAX.  They only read
``viewer.latest_png`` (bytes, swapped atomically) and append to the event
queue; the render loop — JAX dispatch, navigation stepping, PNG encode —
runs in the single thread that calls :meth:`LiveViewer.run`.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from sdf3d_tpu.interact.app import InteractiveSession
from sdf3d_tpu.utils.image_io import encode_png

_PAGE = """<!doctype html>
<html><head><title>sdf3d-tpu live</title><style>
body { margin:0; background:#111; color:#ccc; font:13px monospace; }
#hud { position:fixed; top:8px; left:8px; }
#plots { position:fixed; top:8px; right:8px; text-align:right; }
canvas { display:block; background:#1a1a1a; border:1px solid #333; margin-bottom:4px; }
.lbl { font-size:11px; color:#888; }
img  { display:block; margin:0 auto; image-rendering:pixelated; }
</style></head>
<body>
<div id="hud">drag: orbit &nbsp; shift+drag: pan &nbsp; wheel: zoom &nbsp; wasd/arrows/+-: keys</div>
<div id="plots">
  <canvas id="rays" width="240" height="48"></canvas><div class="lbl" id="rays_lbl">rays/s</div>
  <canvas id="loss" width="240" height="48" style="display:none"></canvas><div class="lbl" id="loss_lbl"></div>
</div>
<img id="view" src="/stream">
<script>
const view = document.getElementById('view');
let dragging = false, panning = false, lx = 0, ly = 0;
function post(ev) { fetch('/event', {method: 'POST', body: JSON.stringify(ev)}); }
view.addEventListener('mousedown', e => { dragging = true; panning = e.shiftKey || e.button === 2; lx = e.clientX; ly = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  post({type: panning ? 'pan' : 'drag', dx: (e.clientX - lx) / view.width, dy: (e.clientY - ly) / view.height});
  lx = e.clientX; ly = e.clientY;
});
view.addEventListener('wheel', e => { e.preventDefault(); post({type: 'scroll', amount: -e.deltaY / 240}); }, {passive: false});
view.addEventListener('contextmenu', e => e.preventDefault());
// Keyboard: the same binding table as interact/devices.py (server-side map).
window.addEventListener('keydown', e => {
  const k = e.key.length === 1 ? e.key : e.key.toLowerCase();
  if ('wasd+-='.includes(k) || k.startsWith('arrow')) { e.preventDefault(); post({type: 'key', key: k}); }
});
// Physical gamepads via the Gamepad API: poll sticks each frame and forward
// them — the browser is the device host, the render loop applies the
// reference's deadzone filter (gamepad_navigation analogue).
let padSeen = false;
function pollPad() {
  const pads = navigator.getGamepads ? navigator.getGamepads() : [];
  for (const p of pads) {
    if (!p || !p.connected) continue;
    const a = p.axes, zin = p.buttons[7] ? p.buttons[7].value : 0, zout = p.buttons[6] ? p.buttons[6].value : 0;
    const ev = {type: 'gamepad', lx: a[0]||0, ly: a[1]||0, rx: a[2]||0, ry: a[3]||0, zoom: zin - zout};
    if (padSeen || Math.max(...[ev.lx, ev.ly, ev.rx, ev.ry, ev.zoom].map(Math.abs)) > 0.3) { padSeen = true; post(ev); }
    break;
  }
  requestAnimationFrame(pollPad);
}
requestAnimationFrame(pollPad);
// Live plots (the ImPlot analogue): sparkline of /stats history.
function spark(id, data, color) {
  const c = document.getElementById(id), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  if (!data || data.length < 2) return;
  const lo = Math.min(...data), hi = Math.max(...data), span = (hi - lo) || 1;
  g.strokeStyle = color; g.lineWidth = 1.5; g.beginPath();
  data.forEach((v, i) => {
    const x = i / (data.length - 1) * (c.width - 4) + 2;
    const y = c.height - 3 - (v - lo) / span * (c.height - 6);
    i ? g.lineTo(x, y) : g.moveTo(x, y);
  });
  g.stroke();
}
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  document.getElementById('hud').textContent =
    `frame ${s.frame}  ${(s.rays_per_second/1e6).toFixed(0)} Mrays/s  drag: orbit  shift+drag: pan  wheel: zoom  wasd/arrows/+-: keys`;
  spark('rays', s.history.rays_per_second, '#6cf');
  document.getElementById('rays_lbl').textContent = `${(s.rays_per_second/1e6).toFixed(1)} Mrays/s`;
  const loss = (s.metrics && s.metrics.loss) || [];
  const lc = document.getElementById('loss');
  if (loss.length) {
    lc.style.display = 'block';
    spark('loss', loss, '#fa6');
    document.getElementById('loss_lbl').textContent = `loss ${loss[loss.length-1].toExponential(2)}`;
  }
}, 1000);
</script></body></html>"""


class LiveViewer:
    """Serve an :class:`InteractiveSession` to a browser.

    ``viewer = LiveViewer(session); viewer.run()`` blocks, rendering frames
    and serving them; ctrl-C stops.  For tests/embedding, ``start()`` /
    ``step()`` / ``stop()`` expose the pieces.
    """

    def __init__(self, session: InteractiveSession, host: str = "127.0.0.1", port: int = 8000,
                 max_fps: float = 30.0, compress_level: int = 1, device_readers=()):
        self.session = session
        self.events: queue.Queue = queue.Queue()
        self.latest_png: bytes = b""
        self._frame_event = threading.Event()
        self.max_fps = max_fps
        self.compress_level = compress_level
        #: Points kept per plotted series (sparkline window).
        self.history_len = 120
        #: Named scalar series for the live plots (e.g. fit loss): append
        #: with :meth:`push_metric` from the render/fit loop.
        self.metrics: dict[str, list] = {}
        #: Local input devices polled each frame (JoystickReader /
        #: KeyboardReader from interact/devices.py) — the GLFW device-poll
        #: analogue for headless hosts.
        self.device_readers = list(device_readers)
        self._stop = False
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, "text/html", _PAGE.encode())
                elif self.path.startswith("/frame.png"):
                    self._send(200, "image/png", viewer.latest_png or b"")
                elif self.path.startswith("/stats"):
                    st = viewer.session.stats[-1] if viewer.session.stats else None
                    hist = viewer.session.stats[-viewer.history_len:]
                    body = json.dumps(
                        {
                            "frame": st.frame if st else -1,
                            "seconds": st.seconds if st else 0.0,
                            "rays_per_second": st.rays_per_second if st else 0.0,
                            # Sparkline history (the ImPlot runtime-plot
                            # analogue, reference CMakeLists.txt:61-66).
                            "history": {
                                "rays_per_second": [h.rays_per_second for h in hist],
                                "seconds": [h.seconds for h in hist],
                            },
                            "metrics": {
                                k: v[-viewer.history_len:]
                                for k, v in viewer.metrics.items()
                            },
                        }
                    ).encode()
                    self._send(200, "application/json", body)
                elif self.path.startswith("/stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    try:
                        while not viewer._stop:
                            viewer._frame_event.wait(timeout=1.0)
                            png = viewer.latest_png
                            if not png:
                                continue
                            self.wfile.write(b"--frame\r\nContent-Type: image/png\r\n")
                            self.wfile.write(f"Content-Length: {len(png)}\r\n\r\n".encode())
                            self.wfile.write(png)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.startswith("/event"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        ev = json.loads(self.rfile.read(n) or b"{}")
                    except json.JSONDecodeError:
                        ev = {}
                    viewer.events.put(ev)
                    self._send(200, "application/json", b"{}")
                else:
                    self._send(404, "text/plain", b"not found")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.server.daemon_threads = True
        self._server_thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.server.server_address[:2]

    def start(self) -> None:
        """Start serving HTTP (non-blocking); call :meth:`step` to render."""
        self._server_thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._server_thread.start()

    def push_metric(self, name: str, value: float) -> None:
        """Append a point to a named plot series (e.g. ``loss`` from a fit
        loop); the page draws a sparkline per series (the ImPlot analogue)."""
        self.metrics.setdefault(name, []).append(float(value))
        del self.metrics[name][: -4 * self.history_len]

    def apply_events(self) -> int:
        """Drain queued browser events into the navigation controller."""
        from sdf3d_tpu.interact.devices import apply_key

        n = 0
        nav = self.session.nav
        while True:
            try:
                ev = self.events.get_nowait()
            except queue.Empty:
                return n
            kind = ev.get("type")
            if kind == "drag":
                nav.mouse_drag(float(ev.get("dx", 0.0)), float(ev.get("dy", 0.0)))
            elif kind == "pan":
                nav.mouse_drag(float(ev.get("dx", 0.0)), float(ev.get("dy", 0.0)), pan=True)
            elif kind == "scroll":
                nav.scroll(float(ev.get("amount", 0.0)))
            elif kind == "key":
                apply_key(nav, str(ev.get("key", "")))
            elif kind == "gamepad":
                nav.gamepad(
                    float(ev.get("lx", 0.0)), float(ev.get("ly", 0.0)),
                    float(ev.get("rx", 0.0)), float(ev.get("ry", 0.0)),
                    float(ev.get("zoom", 0.0)),
                )
            n += 1

    def step(self, dt: float = 1 / 30) -> np.ndarray:
        """One frame: poll devices → apply events → navigate → render → publish."""
        for reader in self.device_readers:
            reader.apply(self.session.nav)
        self.apply_events()
        img = self.session.frame(dt)
        self.latest_png = encode_png(img, compress_level=self.compress_level)
        self._frame_event.set()
        self._frame_event.clear()
        return img

    def run(self, max_frames: int | None = None) -> None:
        """Blocking frame loop (the ``while !gl->closed()`` analogue)."""
        self.start()
        host, port = self.address
        print(f"sdf3d-tpu live viewer: http://{host}:{port}/")
        n = 0
        try:
            while not self._stop and (max_frames is None or n < max_frames):
                t0 = time.perf_counter()
                self.step()
                n += 1
                budget = 1.0 / self.max_fps - (time.perf_counter() - t0)
                if budget > 0:
                    time.sleep(budget)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop = True
        self._frame_event.set()
        self.server.shutdown()
