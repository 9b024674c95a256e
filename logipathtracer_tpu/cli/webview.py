"""Browser-based progressive viewer.

The reference presents each accumulated frame through a Vulkan
swapchain window every frame (src/RendererCore.cpp:373-412, presented
from the render loop in src/RendererPT.cpp:550-567) with GLFW key
input (src/Main.cpp:57-93).  On a headless accelerator host there is
no swapchain; the analog here is an HTTP viewer: a stdlib
ThreadingHTTPServer serves the latest accumulated frame to a browser
tab that polls it at display rate, and feeds key events back into the
camera (WASD/QE translate, IJKL/UO rotate — the reference's bindings;
motion resets accumulation exactly like the terminal viewer in
cli/main.py::cmd_view).

Interactive rate at 1080p comes from two decoupled mechanisms
(the reference resets to 1 spp on motion and still presents at display
rate, src/Main.cpp:57-93 + src/RendererPT.cpp:575-581):

  * present is a raw-RGBA blit (/frame.raw -> canvas drawImage, ~8 MB
    over localhost, no encode cost); PNG encoding is on-demand only
    (/frame.png, screenshot path);
  * while the camera is moving, frames render on a reduced-resolution
    PREVIEW renderer (default 1/4 scale = 16x fewer rays) and the
    browser upscales; the first still frame switches back to full-res
    accumulation (which motion marked dirty, so it restarts clean).

Zero dependencies beyond the stdlib.  The render loop runs on the main
thread (JAX dispatch stays single-threaded); the server thread only
reads the last published frame under a lock.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from logipathtracer_tpu.utils.log import get_logger

log = get_logger("webview")

_MOVE = 0.05
_TURN = 0.02
KEYMAP_T = {"w": (2, -_MOVE), "s": (2, _MOVE), "a": (0, -_MOVE),
            "d": (0, _MOVE), "q": (1, _MOVE), "e": (1, -_MOVE)}
KEYMAP_R = {"i": (0, _TURN), "k": (0, -_TURN), "j": (1, _TURN),
            "l": (1, -_TURN), "u": (2, _TURN), "o": (2, -_TURN)}

_PAGE = """<!doctype html>
<html><head><title>logipathtracer</title><style>
body { background: #111; color: #ccc; font: 13px monospace;
       display: flex; flex-direction: column; align-items: center; }
canvas { image-rendering: pixelated; margin-top: 12px;
         max-width: 95vw; max-height: 85vh; }
#stats { margin: 8px; }
</style></head><body>
<canvas id="frame" width="16" height="16"></canvas>
<div id="stats">connecting...</div>
<div>wasd/qe move &middot; ijkl/uo rotate &middot; x quit
     &middot; <a href="/frame.png" download style="color:#8af">png</a></div>
<script>
const canvas = document.getElementById('frame');
const ctx = canvas.getContext('2d');
const stats = document.getElementById('stats');
let gen = 0, fetching = false;
async function blit(g) {
  // Raw-RGBA blit: no server-side encode, no client-side decode.
  // The frame may be a reduced-scale navigation preview; the canvas
  // stays at display resolution and drawImage upscales (pixelated).
  const r = await fetch('/frame.raw?g=' + g);
  if (r.status !== 200) return;
  const w = parseInt(r.headers.get('X-Frame-Width'));
  const h = parseInt(r.headers.get('X-Frame-Height'));
  const dw = parseInt(r.headers.get('X-Display-Width'));
  const dh = parseInt(r.headers.get('X-Display-Height'));
  const buf = new Uint8ClampedArray(await r.arrayBuffer());
  const imgData = new ImageData(buf, w, h);
  if (canvas.width !== dw || canvas.height !== dh) {
    canvas.width = dw; canvas.height = dh;
  }
  if (w === dw && h === dh) { ctx.putImageData(imgData, 0, 0); return; }
  const bmp = await createImageBitmap(imgData);
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(bmp, 0, 0, dw, dh);
}
async function tick() {
  try {
    const r = await fetch('/stats');
    const s = await r.json();
    stats.textContent = `spp ${s.spp}  ${s.samples_per_sec.toFixed(2)}` +
      ` samples/s  ${s.mrays_per_sec.toFixed(2)} Mrays/s` +
      (s.mode === 'navigate' ? '  [navigating: preview scale]' : '') +
      (s.compiling ? '  [compiling scene...]' : '');
    if (s.frame_gen !== gen && !fetching) {
      gen = s.frame_gen;
      fetching = true;
      try { await blit(gen); } finally { fetching = false; }
    }
    if (s.done) return;
  } catch (e) { stats.textContent = 'disconnected'; return; }
  setTimeout(tick, s_poll_ms());
}
function s_poll_ms() { return 60; }
tick();
document.addEventListener('keydown', (ev) => {
  const k = ev.key.toLowerCase();
  if ('wasdqeijkluox'.includes(k) && k.length === 1)
    fetch('/key', {method: 'POST', body: k});
});
</script></body></html>"""


class ViewerState:
    """Shared state between the render loop and the HTTP threads.

    The render loop publishes the latest frame as a uint8 RGBA numpy
    array (a ~5 ms memcpy at 1080p); HTTP threads serve it raw
    (/frame.raw, the display path) and encode PNG only on demand
    (/frame.png, the screenshot path — 0.4-1.6 s at 1080p, cached per
    frame generation)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.frame = None            # uint8 [H, W, 4] RGBA
        self.display_size = (0, 0)   # (w, h) the client should show
        self.frame_gen = 0
        self._png_cache = (-1, b"")
        self.stats = {"spp": 0, "samples_per_sec": 0.0,
                      "mrays_per_sec": 0.0, "compiling": True,
                      "frame_gen": 0, "done": False}
        self.keys = collections.deque()
        self.quit = threading.Event()

    def publish(self, frame, stats: dict, display_size=None):
        """frame: uint8 [H, W, 3|4] or None (compile-phase heartbeat —
        don't make clients refetch nothing)."""
        with self.lock:
            if frame is not None:
                if frame.shape[-1] == 3:
                    rgba = np.empty(frame.shape[:2] + (4,), np.uint8)
                    rgba[..., :3] = frame
                    rgba[..., 3] = 255
                    frame = rgba
                self.frame = frame
                self.display_size = display_size or (
                    frame.shape[1], frame.shape[0])
                self.frame_gen += 1
            self.stats = dict(stats, frame_gen=self.frame_gen,
                              done=self.quit.is_set())

    def snapshot_raw(self):
        with self.lock:
            return self.frame, self.display_size, self.frame_gen

    def snapshot_png(self):
        """PNG of the current frame, encoded at most once per gen."""
        with self.lock:
            frame, gen = self.frame, self.frame_gen
            if gen == self._png_cache[0]:
                return self._png_cache[1]
        if frame is None:
            return b""
        from logipathtracer_tpu.film.png import encode_png
        png = encode_png(frame[..., :3])
        with self.lock:
            if gen >= self._png_cache[0]:
                self._png_cache = (gen, png)
        return png

    def snapshot_stats(self):
        with self.lock:
            return dict(self.stats, done=self.quit.is_set())


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet: one line per poll
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif path == "/frame.raw":
                frame, (dw, dh), gen = state.snapshot_raw()
                if frame is None:
                    self._send(503, "text/plain", b"no frame yet")
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                body = frame.tobytes()
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Frame-Width", str(frame.shape[1]))
                self.send_header("X-Frame-Height", str(frame.shape[0]))
                self.send_header("X-Display-Width", str(dw))
                self.send_header("X-Display-Height", str(dh))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)
            elif path == "/frame.png":
                png = state.snapshot_png()
                if not png:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/png", png)
            elif path == "/stats":
                self._send(200, "application/json",
                           json.dumps(state.snapshot_stats()).encode())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path.split("?", 1)[0] != "/key":
                self._send(404, "text/plain", b"not found")
                return
            n = int(self.headers.get("Content-Length", 0) or 0)
            key = self.rfile.read(n).decode(errors="replace").strip()[:1]
            if key == "x":
                state.quit.set()
            elif key in KEYMAP_T or key in KEYMAP_R:
                state.keys.append(key)
            self._send(200, "text/plain", b"ok")

    return Handler


def _apply_keys(state: ViewerState, renderers) -> int:
    """Drain queued keys into camera motion on every renderer (the
    full-res and preview renderers track the same camera); returns how
    many keys were applied."""
    applied = 0
    while state.keys:
        try:
            key = state.keys.popleft()
        except IndexError:  # racing producer — deque is thread-safe
            break
        for renderer in renderers:
            if key in KEYMAP_T:
                renderer.translate(*KEYMAP_T[key])
            elif key in KEYMAP_R:
                renderer.rotate(*KEYMAP_R[key])
        applied += 1
    return applied


def serve(args, build) -> int:
    """Run the web viewer: ``build(args)`` -> (cfg, scene, renderer)
    or (cfg, scene, renderer, preview_renderer) is invoked on a
    background thread (async scene load, reference parity with
    src/Main.cpp:45 / RendererPT.cpp:608-612) while the server answers
    immediately; the render loop then steps one sample per frame,
    applying queued key events between steps.

    With a preview renderer, frames rendered while camera keys are
    arriving come from it (reduced resolution, upscaled client-side);
    the first key-free frame returns to the full-res renderer, whose
    accumulation the motion already reset (dirty protocol,
    src/RendererPT.cpp:575-581).

    ``--frames N`` renders N progressive frames then exits (smoke/test
    mode; 0 = serve until 'x' or Ctrl-C)."""
    from logipathtracer_tpu.film.image import to_uint8

    state = ViewerState()
    server = ThreadingHTTPServer((args.host, args.port),
                                 _make_handler(state))
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    log.info("viewer at http://%s:%d/ (x or Ctrl-C quits)",
             args.host, port)
    if getattr(args, "port_file", None):
        with open(args.port_file, "w") as fh:
            fh.write(str(port))

    box = {}

    def _load():
        try:
            box["built"] = build(args)
        except Exception as exc:
            box["error"] = exc

    loader = threading.Thread(target=_load, daemon=True)
    loader.start()

    try:
        t0 = time.perf_counter()
        while "built" not in box:
            if "error" in box:
                raise box["error"]
            if state.quit.is_set():
                return 0
            state.publish(None, {"spp": 0, "samples_per_sec": 0.0,
                                 "mrays_per_sec": 0.0, "compiling": True,
                                 "compile_s": round(
                                     time.perf_counter() - t0, 1)})
            time.sleep(0.2)
        built = box["built"]
        cfg, scene, r = built[:3]
        rp = built[3] if len(built) > 3 else None
        display = ((cfg.render_width, cfg.render_height)
                   if cfg is not None else None)
        renderers = [r] + ([rp] if rp is not None else [])
        # Settle window: navigation stays on the preview renderer until
        # the camera has been still this long, so a brief pause between
        # key repeats doesn't stall the loop on a multi-second full-res
        # frame mid-navigation.
        settle_s = getattr(args, "settle_s", 0.35)
        last_key_t = float("-inf")
        frames = 0

        def submit():
            """Dispatch one frame without host syncs (deferred counter
            fetches + device-side RGBA quantization); returns the
            device frame handle + its renderer.  The loop fetches it
            AFTER dispatching the next frame, overlapping frame N+1's
            compute with frame N's device-to-host transfer."""
            if _apply_keys(state, renderers) > 0:
                nonlocal last_key_t
                last_key_t = time.monotonic()
            moving = time.monotonic() - last_key_t < settle_s
            rr = rp if (moving and rp is not None) else r
            # Converge frames may carry several samples per present
            # (--spp-per-frame): each present pays a full pool drain
            # (exactness on read), so batching samples amortizes the
            # drain tail; navigation stays 1 spp/frame (reference
            # reset protocol).
            spp = 1 if rr is rp else max(
                int(getattr(args, "spp_per_frame", 1)), 1)
            if hasattr(rr, "step_nosync") and hasattr(rr, "image_u8"):
                rr.step_nosync(spp)
                frame = rr.image_u8()
                try:
                    frame.copy_to_host_async()
                except Exception:
                    pass
            else:  # stub renderers (tests) lack the async surface
                rr.step(spp)
                frame = None
            return rr, frame

        pending = submit()
        while not state.quit.is_set():
            nxt = (submit() if not state.quit.is_set() else None)
            rr, frame = pending
            img = (np.asarray(frame) if frame is not None
                   else to_uint8(np.asarray(rr.image())))
            state.publish(img,
                          {"spp": rr.sample_count,
                           "samples_per_sec": round(rr.samples_per_sec(), 3),
                           "mrays_per_sec": round(rr.mrays_per_sec(), 3),
                           "mode": ("navigate" if rr is rp
                                    else "converge"),
                           "compiling": False},
                          display_size=display)
            frames += 1
            if args.frames and frames >= args.frames:
                break
            pending = nxt
        state.quit.set()
        # Publish the final stats (done=True) so polling clients stop.
        stats = state.snapshot_stats()
        state.publish(None, {k: v for k, v in stats.items()
                             if k not in ("frame_gen", "done")})
        if args.frames and getattr(args, "linger", 0.0):
            time.sleep(args.linger)
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        state.quit.set()
        server.shutdown()
