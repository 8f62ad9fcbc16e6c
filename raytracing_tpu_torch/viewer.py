"""Live progressive web viewer (``raytracing_tpu.viewer``): a
zero-dependency HTTP server (stdlib ``http.server``) that runs the
progressive renderer in a background thread and shows each chunk of
passes on a canvas, with the reference page's controls (device and scene
select, renderer, sqrt(spp), focal length, lens diameter, orbit,
Start/Stop).

    python -m raytracing_tpu_torch.viewer --port 8000 --width 1024 \\
        --height 1024 --scene-xml scenes/cornell_teapot.xml
    # open http://localhost:8000
    python -m raytracing_tpu_torch.viewer --cpu --width 64 --height 48

It draws through the package's own entry points: ``render.pathtracer.
render_passes`` (kernel 1 in path mode), ``render.direct.render_direct``
(kernel 1's direct mode) and ``render.simple.render_fake_shade`` (plain
PyTorch, as in the JAX package), on the card (``default_device()``) unless
the session is made on the CPU, where the kernels' plain versions run.
Grids are prepared once per scene; a scene that cannot be prepared, or a
config kernel 1 does not cover (``render.mega.supported``), raises rather
than falling back to another route.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>raytracing_tpu_torch viewer</title>
<style>
 body { font-family: system-ui, sans-serif; background:#111; color:#ddd;
        display:flex; flex-direction:column; align-items:center; gap:12px;
        padding:24px; }
 .controls { display:flex; gap:8px; flex-wrap:wrap; align-items:center; }
 input, select, button { background:#222; color:#ddd; border:1px solid #444;
        padding:4px 8px; border-radius:4px; }
 button { cursor:pointer; }
 canvas { image-rendering:pixelated; border:1px solid #333; }
 #status { font-variant-numeric: tabular-nums; color:#8c8; }
</style></head><body>
<h3>raytracing_tpu_torch &mdash; progressive path tracer</h3>
<div class="controls">
 <label>device <select id="device"></select></label>
 <label>scene <select id="scene"></select></label>
 <label>renderer <select id="renderer">
   <option value="path">path (Assign10)</option>
   <option value="direct">direct (Assign08/09)</option>
   <option value="fake">fake shade (Assign01/02)</option>
 </select></label>
 <label>&radic;spp <input id="sqspp" type="number" value="1" min="1" max="8"
        style="width:3em"></label>
 <label>focal <input id="focal" type="number" step="0.1" style="width:5em"
        placeholder="scene"></label>
 <label>lens &empty; <input id="lens" type="number" step="0.01"
        style="width:5em" placeholder="scene"></label>
 <label>orbit <input id="orbit" type="checkbox"></label>
 <button id="start">Start</button>
 <button id="stop">Stop</button>
</div>
<canvas id="cv"></canvas>
<div id="status">idle</div>
<script>
const cv = document.getElementById('cv'), ctx2d = cv.getContext('2d');
const img = new Image();
img.onload = () => { cv.width = img.width; cv.height = img.height;
                     ctx2d.drawImage(img, 0, 0); };
async function tick() {
  const st = await (await fetch('/status')).json();
  document.getElementById('status').textContent =
    `device: ${st.device} | engine: ${st.engine} | pass ${st.passes}` +
    (st.running ? ` | ${st.msegs_per_s.toFixed(1)} M segs/s` : ' | stopped');
  if (st.frame > lastFrame) { lastFrame = st.frame;
                              img.src = '/frame.png?f=' + st.frame; }
}
let lastFrame = -1;
setInterval(tick, 500);
fetch('/scenes').then(r => r.json()).then(names => {
  const sel = document.getElementById('scene');
  for (const n of names) {
    const o = document.createElement('option'); o.value = o.text = n;
    sel.add(o);
  }
});
fetch('/devices').then(r => r.json()).then(devs => {
  const sel = document.getElementById('device');
  devs.forEach((d, i) => {
    const o = document.createElement('option'); o.value = i; o.text = d;
    sel.add(o);
  });
});
document.getElementById('start').onclick = () => {
  const q = new URLSearchParams({
    scene: document.getElementById('scene').value,
    renderer: document.getElementById('renderer').value,
    sqspp: document.getElementById('sqspp').value,
    focal: document.getElementById('focal').value,
    lens: document.getElementById('lens').value,
    device: document.getElementById('device').value,
    orbit: document.getElementById('orbit').checked ? '1' : '' });
  fetch('/start?' + q);
};
document.getElementById('stop').onclick = () => fetch('/stop');
</script></body></html>
"""


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that the device names its card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class RenderSession:
    """Progressive render loop and latest-frame store (thread-safe).

    The loop renders a chunk of passes, publishes the image and repeats
    until stopped. The progressive state (accumulator, key, passes)
    survives Stop/Start with unchanged settings, so accumulation resumes;
    changed settings reset it."""

    def __init__(self, width: int = 320, height: int = 240, bounces: int = 5,
                 chunk_passes: int = 4, scenes: dict | None = None,
                 device=None):
        if device is None:
            from . import default_device
            device = default_device()
        self.width, self.height, self.bounces = width, height, bounces
        self.chunk_passes = chunk_passes
        self.scene_names = list(scenes) if scenes else ["cornell", "spheres"]
        # entries with a path value are XML files; None = builtin name
        self._extra_scenes = {k: v for k, v in (scenes or {}).items() if v}
        self._device = _indexed(torch.device(device))
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._running = False
        self._png = b""
        self._img = None
        self._png_frame = -1
        self._frame = 0
        self._passes = 0
        self._msegs = 0.0
        self._settings = None
        self._state = None
        self._scene_cache: dict = {}
        self._engine = "?"
        self._angle = 0.0

    # -- rendering ---------------------------------------------------------

    def _load(self, name: str):
        if name in self._extra_scenes:
            from .io.scene_xml import load_scene
            return load_scene(self._extra_scenes[name], self.width,
                              self.height, self._device)
        from .cli import load_named_scene
        return load_named_scene(name, self.width, self.height, self._device)

    def _scene_for(self, name: str):
        """Load a scene and prepare its grids once per session and device
        (the reference bins its grids once, before the render loop)."""
        key = (name, str(self._device))
        sc = self._scene_cache.get(key)
        if sc is None:
            from .accel import prepare_grids
            sc = prepare_grids(self._load(name), "auto", mesh_slabs="auto")
            self._scene_cache[key] = sc
        return sc

    def _block_for(self) -> int:
        """Largest pixel-block side (<= 96) that tiles the film: kernel 1's
        blocked layout keeps a warp's rays in one block."""
        g = math.gcd(self.width, self.height)
        for b in (96, 80, 64, 48, 32):
            if g % b == 0:
                return b
        return 0

    def _cfg(self, scene, spp: int):
        from . import RenderConfig
        from .render import mega

        # kernel 1's grid mode past its brute budget; small scenes
        # (cornell) run its brute instances
        gridded = sum(int(g.item_indices.shape[0])
                      for g in (scene.folded_tri_grid or ()))
        use_grid = gridded > 64 or scene.mega_sph_grid is not None
        cfg = RenderConfig(width=self.width, height=self.height, spp=spp,
                           bounces=self.bounces, use_megakernel=True,
                           mega_block=self._block_for(), use_grid=use_grid)
        mega.supported(scene, cfg)        # raises where kernel 1 cannot
        self._engine = "megakernel"
        return cfg

    def _publish(self, img) -> None:
        # the image stays on the device; frame_png moves it to the host
        # and encodes it only when a client asks for it, once per frame
        with self._lock:
            self._img = img
            self._frame += 1

    def step(self, scene="cornell", renderer="path", spp=1,
             focal=None, lens=None, n_passes=1, orbit=False) -> None:
        """One synchronous chunk of ``n_passes`` passes (the loop's body;
        tests call it directly)."""
        from . import replace
        from .render import pathtracer

        dev = self._device
        sc = self._scene_for(scene)
        if focal:
            sc = replace(sc, focal_length=torch.tensor(
                focal, dtype=torch.float32, device=dev))
        if lens:
            sc = replace(sc, lens_radius=torch.tensor(
                lens / 2, dtype=torch.float32, device=dev))
        cfg = self._cfg(sc, spp)
        if orbit:
            # the eye orbits the scene; each chunk restarts accumulation
            self._angle = (self._angle + 3.0 * n_passes) % 360.0
            sc = replace(sc, camera=sc.camera.orbit(sc.bounds, self._angle))
        key = (scene, renderer, spp, focal, lens, orbit, str(dev))
        changed = self._settings != key
        if changed or orbit:
            self._settings = key
            self._state = pathtracer.init_state(cfg, dev)
            if changed:
                self._passes = 0
        if renderer == "fake":
            from .render.simple import render_fake_shade
            cam = replace(sc.camera, cols=cfg.width, rows=cfg.height)
            colors = sc.materials[sc.spheres.mat_id.long()][:, :3]
            img = render_fake_shade(cam, sc.spheres, colors)
            self._engine = "pytorch"     # no hand-written kernel here
            self._passes += n_passes
            self._publish(img)
            return
        if renderer == "direct":
            from .render.direct import render_direct
            img = render_direct(sc, cfg, n_passes=n_passes)
            self._passes += n_passes
            self._publish(img)
            return
        self._state = pathtracer.render_passes(sc, self._state, cfg, n_passes)
        self._passes = int(self._state["passes"])
        self._publish(pathtracer.image(self._state, cfg))

    def _loop(self, device: int = 0, **kw) -> None:
        try:
            self._run(device, **kw)
        finally:                  # a step that raised ends the loop too
            self._running = False

    def _run(self, device: int, **kw) -> None:
        if self._device.type == "cuda":
            n = torch.cuda.device_count()
            self._device = torch.device("cuda",
                                        device if 0 <= device < n else 0)
            torch.cuda.set_device(self._device)
        n_lights = self._scene_for(kw["scene"]).lights.count
        # wavefront segments per pass: path = primary + a shadow ray per
        # light at every depth; direct = primary + shadow rays; fake =
        # primary only
        rays = self.width * self.height * max(kw["spp"], 1)
        if kw.get("renderer") == "direct":
            segs = rays * (1 + n_lights)
        elif kw.get("renderer") == "fake":
            segs = rays
        else:
            segs = rays * (1 + n_lights + self.bounces * (1 + n_lights))
        while self._running:
            t0 = time.perf_counter()
            self.step(n_passes=self.chunk_passes, **kw)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
            dt = max(time.perf_counter() - t0, 1e-9)
            self._msegs = segs * self.chunk_passes / dt / 1e6

    # -- controls (the reference's startRender / stopRender) ----------------

    def start(self, **kw) -> None:
        self.stop()
        self._running = True
        self._thread = threading.Thread(target=self._loop, kwargs=kw,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def status(self) -> dict:
        with self._lock:
            return {"running": self._running, "passes": self._passes,
                    "frame": self._frame, "msegs_per_s": self._msegs,
                    "device": str(self._device), "engine": self._engine}

    def devices(self) -> list:
        """Device inventory for the page's select: every card, or the CPU
        for a session on the CPU."""
        if self._device.type == "cpu":
            return ["[0] cpu: cpu"]
        return [f"[{i}] cuda: {torch.cuda.get_device_name(i)}"
                for i in range(torch.cuda.device_count())]

    def frame_png(self) -> bytes:
        from .io.png import encode_png
        with self._lock:
            img = self._img
            frame = self._frame
            if img is None:
                return self._png
            if frame == self._png_frame and self._png:
                return self._png
        png = encode_png(img)          # host copy and encode outside the lock
        with self._lock:
            if frame >= self._png_frame:
                self._png = png
                self._png_frame = frame
        return png


def make_server(session: RenderSession, port: int = 8000,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):       # quiet
            pass

        def _send(self, body: bytes, ctype: str, code: int = 200) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj) -> None:
            self._send(json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                self._send(INDEX_HTML.encode(), "text/html")
            elif url.path == "/scenes":
                self._json(session.scene_names)
            elif url.path == "/status":
                self._json(session.status())
            elif url.path == "/frame.png":
                png = session.frame_png()
                if png:
                    self._send(png, "image/png")
                else:
                    self._send(b"no frame yet", "text/plain", 404)
            elif url.path == "/devices":
                self._json(session.devices())
            elif url.path == "/start":
                sq = max(int(q.get("sqspp") or 1), 1)
                session.start(
                    scene=q.get("scene", "cornell"),
                    renderer=q.get("renderer", "path"),
                    spp=sq * sq,        # a square, as the reference forces
                    focal=float(q["focal"]) if q.get("focal") else None,
                    lens=float(q["lens"]) if q.get("lens") else None,
                    device=int(q.get("device") or 0),
                    orbit=bool(q.get("orbit")))
                self._send(b"started", "text/plain")
            elif url.path == "/stop":
                session.stop()
                self._send(b"stopped", "text/plain")
            else:
                self._send(b"not found", "text/plain", 404)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    import argparse

    from . import default_device

    p = argparse.ArgumentParser(prog="raytracing_tpu_torch.viewer",
                                description="live progressive web viewer")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--chunk-passes", type=int, default=4)
    p.add_argument("--scene-xml", action="append", default=[],
                   help="extra XML scene file(s) to add to the scene select")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)

    extra = {os.path.splitext(os.path.basename(x))[0]: x
             for x in args.scene_xml}
    scenes = {"cornell": None, "spheres": None, **extra} if extra else None
    session = RenderSession(width=args.width, height=args.height,
                            bounces=args.bounces,
                            chunk_passes=args.chunk_passes, scenes=scenes,
                            device=default_device(cpu=args.cpu))
    srv = make_server(session, args.port, args.host)
    print(f"viewer at http://{args.host}:{srv.server_address[1]}  "
          "(Ctrl-C to quit)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        session.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
