"""Interactive-loop tests: the REAL run_interactive loop driven by
synthetic key events and a deterministic clock.

No X server exists in this environment, so the window backend is a fake
implementing the viewer interface (connect/show/alive/close); everything
else — input integration, camera/light updates, render, frame fetch — is
the production path.  Expected angles are hand-integrated from the
reference semantics (src/app.rs:63-77, :173-199: a/d camera, q/e light,
speeds scaled by the previous frame's dt; Escape exits).
"""

import math
import types

import numpy as np
import pytest

from tiny_renderer_tpu import RenderConfig, Scene
from tiny_renderer_tpu.app import InputState, run_interactive

DT = 1.0 / 60.0


class FakeClock:
    """Advances a fixed DT per frame: t0 = clock(); ...; dt = clock() - t0."""

    def __init__(self):
        self._t = 0.0
        self._calls = 0

    def __call__(self):
        # The loop calls clock() twice per frame (t0 and end); advancing DT
        # per call makes every frame_time == DT exactly.
        self._t += DT
        return self._t


class FakeViewer:
    """Scripted window: fires key events after each shown frame."""

    def __init__(self, script):
        # script: {frame_index: [("press"|"release", key), ...]}
        self.script = script
        self.frames_shown = 0
        self.alive = True
        self._on_press = None
        self._on_release = None
        self.shown = []

    def connect(self, on_press, on_release):
        self._on_press = on_press
        self._on_release = on_release

    def show(self, frame):
        self.shown.append(np.asarray(frame).copy())
        for kind, key in self.script.get(self.frames_shown, []):
            (self._on_press if kind == "press" else self._on_release)(key)
        self.frames_shown += 1

    def close(self):
        self.alive = False


def _args(camera_angle=0.0, light_angle=0.0):
    return types.SimpleNamespace(
        camera_angle=camera_angle, light_angle=light_angle, no_fps=True
    )


@pytest.fixture(scope="module")
def small_scene(head_model):
    cfg = RenderConfig(width=64, height=64, tri_block=32)
    return Scene(head_model, "phong", cfg, backend="jnp")


def _record_scene_calls(scene, monkeypatch):
    calls = {"camera": [], "light": []}
    orig_cam, orig_light = scene.set_camera, scene.set_light_direction

    def rec_cam(look_from, look_at, up):
        calls["camera"].append(np.asarray(look_from).copy())
        return orig_cam(look_from, look_at, up)

    def rec_light(light):
        calls["light"].append(np.asarray(light).copy())
        return orig_light(light)

    monkeypatch.setattr(scene, "set_camera", rec_cam)
    monkeypatch.setattr(scene, "set_light_direction", rec_light)
    return calls


def test_key_integration_matches_reference(small_scene, monkeypatch):
    """Hold 'd' for 2 frames and 'q' for 1: angles integrate at
    camera_speed/light_speed x dt, using the PREVIOUS frame's dt."""
    calls = _record_scene_calls(small_scene, monkeypatch)
    viewer = FakeViewer(
        {
            0: [("press", "d")],
            2: [("release", "d"), ("press", "q")],
            3: [("release", "q"), ("press", "escape")],
        }
    )
    frame = run_interactive(small_scene, _args(), viewer=viewer, clock=FakeClock())

    assert frame is not None and frame.shape == (64, 64, 3)
    # Frame 0: dt=0 (no previous frame), angles stay 0.
    # Frame 1: 'd' held, but frame_time from frame 0 is DT -> camera += 3*DT.
    # Frame 2: 'd' still held during integration -> camera += 3*DT again.
    # Frame 3: 'q' held -> light -= 3*DT.  Escape after frame 3 ends the loop.
    cfg = small_scene.config
    cam_expected = [0.0, cfg.camera_speed * DT, 2 * cfg.camera_speed * DT,
                    2 * cfg.camera_speed * DT]
    light_expected = [0.0, 0.0, 0.0, -cfg.light_speed * DT]
    assert len(calls["camera"]) == 4
    for i, (a, la) in enumerate(zip(cam_expected, light_expected)):
        np.testing.assert_allclose(
            calls["camera"][i],
            np.array([math.sin(a), 0.0, math.cos(a)], np.float32),
            rtol=1e-6,
            err_msg=f"camera frame {i}",
        )
        np.testing.assert_allclose(
            calls["light"][i],
            np.array([math.sin(la), 0.0, math.cos(la)], np.float32),
            rtol=1e-6,
            err_msg=f"light frame {i}",
        )


def test_returns_final_frame_not_pipelined_previous(small_scene):
    """Pipelined presentation shows frame N-1 while N renders, but on exit
    the RETURNED frame (what --interactive --save writes) must be the last
    rendered frame — the one reflecting the final input state, matching
    the reference's contract (src/app.rs:221-224)."""
    viewer = FakeViewer(
        {
            0: [("press", "d")],  # camera moves every subsequent frame
            3: [("press", "escape")],
        }
    )
    frame = run_interactive(small_scene, _args(), viewer=viewer, clock=FakeClock())
    # The final camera pose (frame 3) was never shown (pipelining lags one
    # frame) but must be what run_interactive returns.  Render it
    # independently for comparison.
    cfg = small_scene.config
    a = 3 * cfg.camera_speed * DT  # integrated over frames 1-3
    small_scene.set_camera(
        np.array([math.sin(a), 0.0, math.cos(a)], np.float32),
        np.zeros(3, np.float32),
        np.array([0.0, 1.0, 0.0], np.float32),
    )
    small_scene.set_light_direction(np.array([0.0, 0.0, 1.0], np.float32))
    small_scene.render()
    expected = small_scene.get_frame_buffer()
    np.testing.assert_array_equal(frame, expected)
    # ... and it is strictly newer than the last frame the viewer showed.
    assert not np.array_equal(frame, viewer.shown[-1])


def test_opposing_keys_cancel(small_scene, monkeypatch):
    calls = _record_scene_calls(small_scene, monkeypatch)
    viewer = FakeViewer(
        {0: [("press", "a"), ("press", "d")], 2: [("press", "escape")]}
    )
    run_interactive(small_scene, _args(), viewer=viewer, clock=FakeClock())
    for v in calls["camera"]:
        np.testing.assert_allclose(v, np.array([0.0, 0.0, 1.0], np.float32))


def test_escape_on_release_exits(small_scene):
    """The reference exits on Escape RELEASE (app.rs:74)."""
    viewer = FakeViewer({1: [("release", "escape")]})
    run_interactive(small_scene, _args(), viewer=viewer, clock=FakeClock())
    assert viewer.frames_shown == 2
    assert not viewer.alive  # loop closed the viewer


def test_window_close_ends_loop(small_scene):
    class ClosingViewer(FakeViewer):
        def show(self, frame):
            super().show(frame)
            if self.frames_shown >= 3:
                self.alive = False  # user closed the window

    viewer = ClosingViewer({})
    frame = run_interactive(small_scene, _args(), viewer=viewer, clock=FakeClock())
    assert viewer.frames_shown == 3
    assert frame is not None


def test_viewer_fallback_chain(small_scene, monkeypatch):
    """DISPLAY set but both viewers unavailable -> headless fallback (the
    reference requires a window; headless-first is our documented
    divergence for display-less accelerator hosts)."""
    import tiny_renderer_tpu.app as app_mod
    import tiny_renderer_tpu.viewer_x11 as vx

    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setattr(
        vx, "load_xlib", lambda: (_ for _ in ()).throw(OSError("no libX11"))
    )
    monkeypatch.setattr(
        app_mod, "MatplotlibViewer",
        lambda: (_ for _ in ()).throw(RuntimeError("no gui")),
    )
    args = _args()
    args.frames = 1
    args.orbit = False
    args.timing = False
    frame = run_interactive(small_scene, args)
    assert frame is not None and frame.shape == (64, 64, 3)


def test_pipelined_presentation_shows_previous_frame(small_scene):
    """The interactive loop presents frame N-1 while N renders (DESIGN.md
    divergence #11): iteration 1 re-shows the startup frame, and from
    iteration 2 on each shown frame is the previous iteration's render."""
    viewer = FakeViewer({0: [("press", "d")], 3: [("press", "escape")]})
    run_interactive(small_scene, _args(), viewer=viewer, clock=FakeClock())
    assert viewer.frames_shown == 4
    # Startup: iteration 0 presents f0; iteration 1 presents f0 again.
    np.testing.assert_array_equal(viewer.shown[1], viewer.shown[0])
    # Camera moved while 'd' was held -> f1 differs from f0; iteration 2
    # shows f1.
    assert (viewer.shown[2] != viewer.shown[1]).any()


def test_input_state_unit():
    s = InputState(0.5, -0.25, camera_speed=3.0, light_speed=2.0)
    s.on_press("d")
    s.on_press("e")
    s.integrate(0.1)
    assert s.camera == pytest.approx(0.5 + 0.3)
    assert s.light == pytest.approx(-0.25 + 0.2)
    s.on_release("d")
    s.on_press("a")
    s.on_press("q")
    s.integrate(0.1)
    assert s.camera == pytest.approx(0.5)    # back down
    assert s.light == pytest.approx(-0.05)   # e and q both held -> net zero
    assert not s.exit
    s.on_press("escape")
    assert s.exit


def test_serial_present_shows_current_frame(small_scene):
    """--serial-present (DESIGN.md divergence #11 opt-out) restores the
    reference's zero-latency contract (src/app.rs:213-218): every shown
    frame is THIS iteration's render, so there is no startup duplicate
    and the returned frame equals the last shown one."""
    import types as _types

    args = _types.SimpleNamespace(
        camera_angle=0.0, light_angle=0.0, no_fps=True, serial_present=True
    )
    viewer = FakeViewer({0: [("press", "d")], 3: [("press", "escape")]})
    frame = run_interactive(small_scene, args, viewer=viewer, clock=FakeClock())
    assert viewer.frames_shown == 4
    # Camera moved while 'd' was held -> iteration 1's render differs from
    # iteration 0's, and serial presentation shows it immediately (the
    # pipelined mode re-shows frame 0 here — see the test above).
    assert (viewer.shown[1] != viewer.shown[0]).any()
    np.testing.assert_array_equal(frame, viewer.shown[-1])
