"""Minimal HTTP frame server on the Scene API — the serving-deployment
shape from docs/DEPLOY.md as runnable code.

    GET /render?pipeline=shadow&camera=0.9&light=-0.6   -> image/png
    GET /healthz                                        -> {"ok": true, ...}

Angles are the reference's orbit parameterization (src/app.rs:200-207:
camera at (sin a, 0, cos a), light at (sin b, 0, cos b)).  One Scene per
pipeline is built lazily and reused — after the first request per
pipeline every render is a single warm jit dispatch; a lock serializes
device work (one renderer process per card, DEPLOY.md).  The overflow
flag is surfaced in /healthz as DEPLOY.md prescribes.

Run:  python examples/serve_http.py [asset_dir] [port] [--size N] [--backend B]
      (asset_dir "-" or omitted: the seeded diablo-shaped scene)
Try:  curl -o frame.png 'http://localhost:8000/render?pipeline=shadow&camera=0.9'
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


class FrameService:
    """Lazily-built Scene per pipeline + a device lock (serving pattern)."""

    def __init__(self, asset_dir, size=400, backend="auto"):
        from tiny_renderer_tpu import RenderConfig, load_model
        from tiny_renderer_tpu.models import seeded_model

        self.model = (
            seeded_model("diablo") if asset_dir in (None, "-")
            else load_model(asset_dir, verbose=False)
        )
        self.config = RenderConfig(width=size, height=size)
        self.backend = backend
        self._scenes = {}
        self._lock = threading.Lock()
        self._renders = 0
        self._overflowed = False

    def _scene(self, pipeline):
        from tiny_renderer_tpu import Scene

        scene = self._scenes.get(pipeline)
        if scene is None:
            # Raises ValueError on unknown pipeline names (reference
            # message) — mapped to HTTP 400 by the handler.
            scene = Scene(self.model, pipeline, self.config,
                          backend=self.backend)
            self._scenes[pipeline] = scene
        return scene

    def render_png(self, pipeline, camera_angle, light_angle):
        from tiny_renderer_tpu.utils.png import png_bytes

        with self._lock:
            scene = self._scene(pipeline)
            scene.set_camera(
                [math.sin(camera_angle), 0.0, math.cos(camera_angle)],
                [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
            )
            scene.set_light_direction(
                [math.sin(light_angle), 0.0, math.cos(light_angle)]
            )
            scene.render()
            frame = scene.get_frame_buffer()
            self._renders += 1
            self._overflowed |= bool(scene.overflowed)
        return png_bytes(frame)

    def health(self):
        with self._lock:  # snapshot: handler threads mutate _scenes
            return {
                "ok": not self._overflowed,
                "renders": self._renders,
                "overflowed": self._overflowed,
                "pipelines_warm": sorted(self._scenes),
                "size": [self.config.height, self.config.width],
            }


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            if os.environ.get("SERVE_HTTP_VERBOSE"):
                super().log_message(fmt, *args)

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                body = json.dumps(service.health()).encode()
                return self._send(200, body, "application/json")
            if url.path != "/render":
                return self._send(404, b"not found\n", "text/plain")
            q = parse_qs(url.query)
            try:
                pipeline = q.get("pipeline", ["shadow"])[0]
                camera = float(q.get("camera", ["0.0"])[0])
                light = float(q.get("light", ["-0.6"])[0])
                png = service.render_png(pipeline, camera, light)
            except (ValueError, KeyError) as e:
                return self._send(400, f"error: {e}\n".encode(), "text/plain")
            self._send(200, png, "image/png")

    return Handler


def serve(asset_dir, port=8000, size=400, backend="auto"):
    service = FrameService(asset_dir, size=size, backend=backend)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(service))
    return server, service


def main():
    args = sys.argv[1:]
    size, backend = 400, "auto"
    if "--size" in args:
        i = args.index("--size"); size = int(args[i + 1]); del args[i:i + 2]
    if "--backend" in args:
        i = args.index("--backend"); backend = args[i + 1]; del args[i:i + 2]
    asset = args[0] if args else None
    port = int(args[1]) if len(args) > 1 else 8000
    if backend == "jnp":
        # CPU-only serving: pin the platform BEFORE any jax use, or the
        # arrays still land on the default accelerator device.
        import jax

        jax.config.update("jax_platforms", "cpu")
    server, _ = serve(asset, port=port, size=size, backend=backend)
    print(f"serving {asset or 'the seeded diablo scene'} on http://127.0.0.1:{server.server_address[1]} "
          f"({size}x{size}, backend={backend})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
