"""End-to-end test of the HTTP serving example over a real socket.

The server is the DEPLOY.md single-chip serving pattern as code; this
drives it exactly like a client would (urllib against a loopback port)
and checks the PNG payload against a direct Scene render byte-for-byte.
"""

import importlib.util
import json
import math
import os
import struct
import threading
import urllib.request

import numpy as np
import pytest


@pytest.fixture(scope="module")
def server(asset_root):
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "serve_http.py")
    spec = importlib.util.spec_from_file_location("example_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    srv, service = mod.serve(os.path.join(asset_root, "african_head"),
                             port=0, size=96, backend="jnp")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:  # 4xx/5xx still carry a body
        return e.code, e.headers.get("Content-Type"), e.read()


def test_render_endpoint_serves_scene_pixels(server, asset_root):
    base, _ = server
    status, ctype, body = _get(f"{base}/render?pipeline=phong&camera=0.9")
    assert status == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", body[16:24])
    assert (w, h) == (96, 96)

    # Byte-for-byte against a direct Scene render of the same request.
    from tiny_renderer_tpu import RenderConfig, Scene, load_model
    from tiny_renderer_tpu.utils.png import png_bytes

    scene = Scene(load_model(os.path.join(asset_root, "african_head"),
                             verbose=False),
                  "phong", RenderConfig(width=96, height=96), backend="jnp")
    scene.set_camera([math.sin(0.9), 0.0, math.cos(0.9)],
                     [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    scene.set_light_direction([math.sin(-0.6), 0.0, math.cos(-0.6)])
    scene.render()
    assert body == png_bytes(scene.get_frame_buffer())


def test_render_validates_input(server):
    base, _ = server
    status, _, body = _get(f"{base}/render?pipeline=nope")
    assert status == 400 and b"error" in body
    status, _, body = _get(f"{base}/render?pipeline=phong&camera=abc")
    assert status == 400
    status, _, _ = _get(f"{base}/other")
    assert status == 404


def test_healthz_reports_state(server):
    base, service = server
    # Warm one pipeline ourselves: the assertions below must not depend on
    # which other tests ran first.
    assert _get(f"{base}/render?pipeline=phong")[0] == 200
    status, ctype, body = _get(f"{base}/healthz")
    assert status == 200 and ctype == "application/json"
    h = json.loads(body)
    assert h["ok"] is True and h["overflowed"] is False
    assert h["renders"] >= 1 and "phong" in h["pipelines_warm"]
    assert h["size"] == [96, 96]


def test_concurrent_requests_deterministic(server):
    """The device lock serializes renders; concurrent identical requests
    must all return identical bytes (bit-stable resolve, stateless
    frames)."""
    base, _ = server
    results = [None] * 4
    def fetch(i):
        results[i] = _get(f"{base}/render?pipeline=phong&camera=1.7&light=0.3")
    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert all(r[0] == 200 for r in results)
    assert len({r[2] for r in results}) == 1
