"""Live-display certification for the X11 viewer.

Opens the real X11Viewer, renders one frame on CPU, blits it through a
genuine XPutImage round-trip, injects one synthetic KeyPress ('a') via
XSendEvent through the server, and verifies the InputState handler fired
— the final inch the headless test suite cannot cover (the scripted-Xlib
tests exercise the same code paths without a server; reference surface:
/root/reference/src/app.rs:148-153, :221-224).

Run on ANY host with a display — zero new code needed there:
    DISPLAY=:0 python scripts/x11_smoke.py

Exit codes: 0 = certified, 75 (EX_TEMPFAIL) = no display / skipped.
tests/test_x11_live.py runs this automatically when DISPLAY is set.
"""

from __future__ import annotations

import ctypes
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

EX_SKIP = 75


def main() -> int:
    if not os.environ.get("DISPLAY"):
        print("x11_smoke: no DISPLAY — skipping (exit 75)")
        return EX_SKIP

    # CPU-only: a live-display host need not hold the accelerator.
    import jax

    jax.config.update("jax_platforms", "cpu")

    from tiny_renderer_tpu.viewer_x11 import (
        KEY_PRESS, X11Viewer, XEvent, load_xlib,
    )

    try:
        lib = load_xlib()
        viewer = X11Viewer(200, 200, title="x11_smoke", lib=lib)
    except Exception as e:
        print(f"x11_smoke: viewer unavailable ({e}) — skipping (exit 75)")
        return EX_SKIP

    try:
        # One real rendered frame (tiny procedural scene keeps this fast).
        import jax.numpy as jnp

        from tiny_renderer_tpu import RenderConfig
        from tiny_renderer_tpu.models.procedural import (
            make_textures, make_uv_sphere, to_geom,
        )
        from tiny_renderer_tpu.pipelines.frame import make_frame_fn

        geom = to_geom(make_uv_sphere(stacks=8, slices=16))
        tex = make_textures(64)
        cfg = RenderConfig(width=200, height=200, tri_block=32)
        fn = make_frame_fn("phong", cfg, backend="jnp")
        out = fn(
            {k: jnp.asarray(v) for k, v in geom.items()},
            {k: jnp.asarray(v) for k, v in tex.items()},
            jnp.asarray([0.3, 0.0, 0.95]),
            jnp.asarray([0.2, 0.0, 0.98]),
            jnp.zeros(3),
            jnp.asarray([0.0, 1.0, 0.0]),
        )
        import numpy as np

        frame = np.asarray(out["frame"])[::-1]

        pressed = []
        viewer.connect(pressed.append, lambda key: None)
        viewer.show(frame)  # real XPutImage round-trip

        # Inject a synthetic 'a' KeyPress through the server.
        ev = XEvent()
        ev.xkey.type = KEY_PRESS
        ev.xkey.display = viewer._dpy
        ev.xkey.window = viewer._win
        ev.xkey.keycode = lib.XKeysymToKeycode(viewer._dpy, 0x0061)
        ev.xkey.same_screen = 1
        if not lib.XSendEvent(viewer._dpy, viewer._win, 1, 1 << 0, ctypes.byref(ev)):
            print("x11_smoke: XSendEvent failed")
            return 1
        lib.XSync(viewer._dpy, 0)

        # The event arrives via the normal per-frame drain in show().
        deadline = time.monotonic() + 5.0
        while "a" not in pressed and time.monotonic() < deadline:
            viewer.show(frame)
            time.sleep(0.02)
        if "a" not in pressed:
            print("x11_smoke: injected KeyPress never reached the handler")
            return 1
        print(
            "x11_smoke OK: window mapped, frame blitted via XPutImage, "
            "synthetic KeyPress decoded to 'a'"
        )
        return 0
    finally:
        viewer.close()


if __name__ == "__main__":
    sys.exit(main())
