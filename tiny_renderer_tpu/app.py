"""App / CLI: the reference's entry point, on JAX.

Reference: src/main.rs (CLI: `-p <asset dir>`, `-s <pipeline>`, 800x800
default) + src/app.rs (asset loading, window, per-frame loop with
a/d camera and q/e light orbit at 3.0 rad/s scaled by frame dt, FPS print).

Headless-first: `--frames N` renders N frames (optionally orbiting) without
a display; `--save` writes PNG; `--dump-z/--dump-shadow` expose the debug
buffer views the reference hides behind commented-out code
(src/app.rs:213-215).  `--interactive` opens a matplotlib viewer with the
reference's keybindings when a display is available.

Without `-p` the scene is generated from a seed (models.procedural:
`--scene diablo` 5,022 triangles, `--scene african_head` 2,492).

Examples:
  python -m tiny_renderer_tpu.app -s shadow --frames 100 --orbit --save out.png
  python -m tiny_renderer_tpu.app -p path/to/asset_dir -s phong --save out.png
  python -m tiny_renderer_tpu.app -s occlusion --interactive
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np

from .assets.model import load_model
from .config import RenderConfig
from .models.procedural import SEEDED_SCENES, seeded_model
from .scene import Scene
from .utils.png import downsample_box, write_png
from .utils.timing import FpsCounter, profile_trace


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="tiny_renderer_tpu",
        description="tiny renderer on JAX (capabilities of litzendraht/tiny_renderer)",
    )
    ap.add_argument("-p", dest="asset_path", default=None,
                    help="asset directory (model.obj + 4 TGA maps); "
                         "default: the seeded --scene")
    ap.add_argument("--scene", default="diablo", choices=SEEDED_SCENES,
                    help="seeded reference-shape scene used without -p")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated scene (default 0)")
    # Live registry, not the static PIPELINE_NAMES tuple: pipelines added
    # via register_pipeline() before build_arg_parser() are selectable.
    from .pipelines.frame import PIPELINES

    ap.add_argument("-s", dest="pipeline", default="default",
                    choices=tuple(PIPELINES), help="shader pipeline name")
    ap.add_argument("--size", nargs=2, type=int, default=[800, 800],
                    metavar=("W", "H"), help="frame size (default 800 800)")
    ap.add_argument("--frames", type=int, default=60,
                    help="number of frames to render in headless mode")
    ap.add_argument("--orbit", action="store_true",
                    help="animate camera+light orbit in headless mode")
    ap.add_argument("--camera-angle", type=float, default=0.0,
                    help="initial camera orbit angle (radians)")
    ap.add_argument("--light-angle", type=float, default=0.0,
                    help="initial light orbit angle (radians)")
    ap.add_argument("--save", metavar="PNG", help="write the final frame to PNG")
    ap.add_argument("--save-seq", metavar="DIR",
                    help="render the whole orbit animation as one device "
                         "burst and write frame_%%04d.png into DIR")
    ap.add_argument("--dump-z", metavar="PNG", help="write the z-buffer debug view")
    ap.add_argument("--dump-shadow", metavar="PNG", help="write the shadow-buffer debug view")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "jnp", "pallas_interpret"],
                    help="raster backend (auto: the pallas kernel on a GPU, "
                         "the jnp raster on the CPU; pallas_interpret runs "
                         "the kernel in the Pallas interpreter)")
    ap.add_argument("--depth", type=float, default=255.0,
                    help="z-buffer depth range (reference: 255, shader.rs:214)")
    ap.add_argument("--projection-distance", type=float, default=5.0,
                    help="perspective projection distance c (w' = 1 - z/c; "
                         "reference: 5, shader.rs:204)")
    ap.add_argument("--interactive", action="store_true",
                    help="open an interactive viewer (requires a display)")
    ap.add_argument("--no-fps", action="store_true", help="disable the FPS printout")
    ap.add_argument("--serial-present", action="store_true",
                    help="interactive: present each frame after it renders "
                         "(the reference's zero-latency contract, "
                         "src/app.rs:213-218) instead of the default "
                         "pipelined presentation (blit N-1 while N renders; "
                         "one frame of latency, DESIGN.md divergence #11)")
    ap.add_argument("--timing", action="store_true",
                    help="print a per-frame wall-time summary and a "
                         "per-stage device-time breakdown at exit")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a jax.profiler trace of the run to DIR")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="disable the persistent compilation cache "
                         "($JAX_COMPILATION_CACHE_DIR, else .jax_cache in "
                         "the checkout); repeat runs skip the first-frame "
                         "compile")
    ap.add_argument("--ssaa", type=int, default=1, metavar="N",
                    help="supersampled antialiasing: render at N x the "
                         "requested size and box-average down (headless/"
                         "--save/--save-seq paths; debug dumps stay at "
                         "render resolution).  A quality feature beyond "
                         "the reference — output is NOT parity-comparable")
    ap.add_argument("--knob", action="append", default=[], metavar="NAME=VALUE",
                    help="override a RenderConfig field (repeatable), e.g. "
                         "--knob tex_tile=16 --knob strip_len=32; bools "
                         "accept true/false.  Every perf knob is "
                         "bit-identity-pinned, so output is unchanged — "
                         "this exists for hardware experiments (see "
                         "docs/API.md for the knob table)")
    return ap


def apply_knobs(config, knob_args):
    """Apply --knob NAME=VALUE overrides to a RenderConfig.

    Values are coerced to the field's declared type (bool accepts
    true/false/1/0).  Unknown names and malformed values raise ValueError
    listing the valid fields — unlike unrecognized argv tokens, a mistyped
    knob silently changing nothing would invalidate an experiment."""
    import dataclasses

    fields = {f.name: f for f in dataclasses.fields(type(config))}
    updates = {}
    for spec in knob_args:
        name, sep, raw = spec.partition("=")
        if not sep or name not in fields:
            valid = ", ".join(sorted(fields))
            raise ValueError(
                f"--knob {spec!r}: expected NAME=VALUE with NAME one of: {valid}"
            )
        ftype = fields[name].type
        if isinstance(ftype, str) and ftype.endswith("| None"):
            # Optional fields (e.g. max_incidences: int | None).
            if raw.strip().lower() in ("none", "null"):
                updates[name] = None
                continue
            ftype = ftype.replace("| None", "").strip()
        if ftype in ("bool", bool):
            low = raw.strip().lower()
            if low in ("true", "1", "yes", "on"):
                val = True
            elif low in ("false", "0", "no", "off"):
                val = False
            else:
                raise ValueError(f"--knob {spec!r}: not a bool: {raw!r}")
        elif ftype in ("int", int):
            val = int(raw)
        elif ftype in ("float", float):
            val = float(raw)
        else:
            val = raw
        updates[name] = val
    return dataclasses.replace(config, **updates) if updates else config


def _angles_to_vectors(camera_angle: float, light_angle: float):
    """Camera and light on the unit XZ circle (src/app.rs:200-207)."""
    look_from = np.array(
        [math.sin(camera_angle), 0.0, math.cos(camera_angle)], np.float32
    )
    light = np.array([math.sin(light_angle), 0.0, math.cos(light_angle)], np.float32)
    look_at = np.zeros(3, np.float32)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    return look_from, look_at, up, light


def run_headless(scene: Scene, args) -> np.ndarray:
    cfg = scene.config
    fps = FpsCounter(enabled=not args.no_fps)
    camera_angle = args.camera_angle
    light_angle = args.light_angle
    frame_time = 0.0
    times = []
    for _ in range(max(1, args.frames)):
        t0 = time.monotonic()
        if args.orbit:
            camera_angle += cfg.camera_speed * frame_time
            light_angle -= cfg.light_speed * frame_time
        look_from, look_at, up, light = _angles_to_vectors(camera_angle, light_angle)
        scene.set_camera(look_from, look_at, up)
        scene.set_light_direction(light)
        scene.render()
        # Headless: frames stay on device; only the final one is fetched.
        scene.block_until_ready()
        fps.tick()
        frame_time = time.monotonic() - t0
        times.append(frame_time)
    if args.timing and times:
        steady = times[1:] or times  # drop the compile frame
        print(
            f"frame time: mean {1e3 * sum(steady) / len(steady):.2f} ms, "
            f"min {1e3 * min(steady):.2f} ms over {len(steady)} frames "
            f"(first frame incl. compile: {1e3 * times[0]:.0f} ms)"
        )
        from .pipelines.profile import print_stage_breakdown

        print_stage_breakdown(scene)
    return scene.get_frame_buffer()


class InputState:
    """The reference's per-frame input integration (src/app.rs:55-80,
    :173-199): a/d orbit the camera, q/e orbit the light, at speeds scaled
    by the PREVIOUS frame's dt; Escape exits (the reference fires on key
    release, app.rs:74; we also accept press for backends that don't
    deliver releases).  Divergence: the reference re-arms actions from a
    drained event channel each frame (key auto-repeat keeps them alive);
    we track held keys via press/release pairs — same steady-state
    behavior without depending on OS repeat rate."""

    def __init__(self, camera_angle, light_angle, camera_speed, light_speed):
        self.camera = camera_angle
        self.light = light_angle
        self._camera_speed = camera_speed
        self._light_speed = light_speed
        self.keys: set = set()
        self.exit = False

    def on_press(self, key):
        if key == "escape":
            self.exit = True
        else:
            self.keys.add(key)

    def on_release(self, key):
        if key == "escape":
            self.exit = True
        self.keys.discard(key)

    def integrate(self, dt):
        """Reference keymap (src/app.rs:63-77, :173-199)."""
        if "d" in self.keys:
            self.camera += self._camera_speed * dt
        if "a" in self.keys:
            self.camera -= self._camera_speed * dt
        if "e" in self.keys:
            self.light += self._light_speed * dt
        if "q" in self.keys:
            self.light -= self._light_speed * dt


class MatplotlibViewer:
    """Window backend for the interactive loop (show-image equivalent,
    reference Cargo.toml:12 + src/app.rs:148-153).  Raises on construction
    when no GUI backend is available."""

    def __init__(self):
        import matplotlib

        matplotlib.use("TkAgg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.fig, self._ax = plt.subplots(figsize=(6, 6))
        self._ax.set_axis_off()
        self._im = None
        plt.ion()
        plt.show()

    def connect(self, on_press, on_release):
        self.fig.canvas.mpl_connect(
            "key_press_event", lambda event: on_press(event.key)
        )
        self.fig.canvas.mpl_connect(
            "key_release_event", lambda event: on_release(event.key)
        )

    def show(self, frame):
        if self._im is None:
            self._im = self._ax.imshow(frame)
        else:
            self._im.set_data(frame)
        self.fig.canvas.draw_idle()
        self.fig.canvas.flush_events()

    @property
    def alive(self) -> bool:
        return self._plt.fignum_exists(self.fig.number)

    def close(self):
        self._plt.ioff()
        self._plt.close(self.fig)


def run_interactive(scene: Scene, args, viewer=None, clock=time.monotonic) -> np.ndarray:
    """The reference's windowed frame loop (src/app.rs:155-247).

    `viewer`/`clock` are injectable so tests can drive the REAL loop with
    synthetic key events and a deterministic clock (tests/test_interactive.py);
    by default a matplotlib window is opened when a display exists.
    """
    if viewer is None:
        if not os.environ.get("DISPLAY"):
            print("no display available; falling back to headless")
            return run_headless(scene, args)
        # Prefer the dedicated native window (show-image parity,
        # src/app.rs:148-153); matplotlib is the fallback viewer.
        try:
            from .viewer_x11 import X11Viewer

            viewer = X11Viewer(scene.config.width, scene.config.height)
        except Exception as e:  # pragma: no cover - depends on host GUI
            print(f"X11 viewer unavailable ({e}); trying matplotlib")
            try:
                viewer = MatplotlibViewer()
            except Exception as e2:
                print(
                    f"interactive viewer unavailable ({e2}); falling back to headless"
                )
                return run_headless(scene, args)

    from .utils.transfer import fetch

    cfg = scene.config
    state = InputState(
        args.camera_angle, args.light_angle, cfg.camera_speed, cfg.light_speed
    )
    viewer.connect(state.on_press, state.on_release)
    fps = FpsCounter(enabled=not args.no_fps)
    frame_time = 0.0
    frame = None
    prev_dev = None
    while not state.exit and viewer.alive:
        t0 = clock()
        state.integrate(frame_time)
        look_from, look_at, up, light = _angles_to_vectors(state.camera, state.light)
        scene.set_camera(look_from, look_at, up)
        scene.set_light_direction(light)
        out = scene.render()  # async dispatch of frame N
        if getattr(args, "serial_present", False):
            # Reference contract: present frame N itself (src/app.rs:213-218).
            frame = fetch(out["frame"])[::-1]
            viewer.show(frame)
        else:
            if prev_dev is None:
                prev_dev = out["frame"]  # startup: present the first frame
            # Pipelined presentation: blit frame N-1 while N renders — the
            # device->host fetch overlaps the next frame's compute.  One
            # frame of display latency vs the reference (DESIGN.md
            # divergence #11); input handling cadence is unchanged.
            frame = fetch(prev_dev)[::-1]
            viewer.show(frame)
            prev_dev = out["frame"]
        fps.tick()
        frame_time = clock() - t0
    # The loop presents N-1 while N renders, so on exit the final frame
    # (rendered with the last integrated input state) is still device-side;
    # fetch it so --save and the return value reflect the state at exit,
    # matching the reference's non-pipelined contract.
    if prev_dev is not None:
        frame = fetch(prev_dev)[::-1]
    viewer.close()
    return frame


def run_sequence(scene: Scene, args, ssaa: int = 1) -> np.ndarray:
    """Render the orbit animation as ONE device burst and dump PNG frames."""
    import jax.numpy as jnp

    from .pipelines.frame import make_burst_fn

    cfg = scene.config
    n = max(1, args.frames)
    # Fixed-dt orbit (the interactive loop scales by real frame time; a
    # sequence export uses a deterministic 60 fps step).
    dt = 1.0 / 60.0
    cams = (args.camera_angle + cfg.camera_speed * dt * np.arange(n)).astype(np.float32)
    ligs = (args.light_angle - cfg.light_speed * dt * np.arange(n)).astype(np.float32)
    burst = make_burst_fn(
        args.pipeline, cfg, backend=args.backend, keep_frames=True
    )
    out = burst(scene._geom, scene._textures, jnp.asarray(cams), jnp.asarray(ligs))
    from .utils.transfer import fetch

    frames = fetch(out["frames"])
    os.makedirs(args.save_seq, exist_ok=True)
    for i in range(n):
        write_png(os.path.join(args.save_seq, f"frame_{i:04d}.png"),
                  downsample_box(frames[i][::-1], ssaa))
    print(f"wrote {n} frames to {args.save_seq}")
    # The final frame is returned pre-resolve; main() downsamples for
    # --save (matching the headless path's contract).
    return frames[-1][::-1]


def main(argv=None) -> int:
    # The reference silently ignores unrecognized argv tokens
    # (src/main.rs:16-26); we ignore them too but say so (DESIGN.md
    # divergence #9).
    args, unknown = build_arg_parser().parse_known_args(argv)
    if unknown:
        print(f"ignoring unrecognized arguments: {' '.join(unknown)}",
              file=sys.stderr)
    width, height = args.size

    if not args.no_compile_cache:
        # Must run before the first jit compile to take effect.
        from .utils.compile_cache import enable_compile_cache

        enable_compile_cache()

    if args.asset_path is None:
        model = seeded_model(args.scene, args.seed)
    else:
        model = load_model(args.asset_path)
    print(f"cooking up a scene with '{args.pipeline}' shader pipeline")
    if args.projection_distance == 0.0:
        print("error: --projection-distance must be nonzero", file=sys.stderr)
        return 2
    ssaa = max(1, args.ssaa)
    if ssaa > 1 and args.interactive:
        print("error: --ssaa is headless-only (--save/--save-seq)",
              file=sys.stderr)
        return 2
    config = RenderConfig(
        width=width,
        height=height,
        depth=args.depth,
        projection_coef=-1.0 / args.projection_distance,
    )
    try:
        config = apply_knobs(config, args.knob)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if ssaa > 1:
        # Scale AFTER knobs so --knob width/height overrides compose with
        # --ssaa (render at N x the requested size, downsample at save).
        config = dataclasses.replace(
            config, width=config.width * ssaa, height=config.height * ssaa
        )
    scene = Scene(model, args.pipeline, config, backend=args.backend)

    with profile_trace(args.profile):
        if args.save_seq:
            frame = run_sequence(scene, args, ssaa=ssaa)
        elif args.interactive:
            frame = run_interactive(scene, args)
        else:
            frame = run_headless(scene, args)

    if args.save and frame is not None:
        write_png(args.save, downsample_box(frame, ssaa))
        print(f"wrote {args.save}")
    if args.dump_z:
        write_png(args.dump_z, scene.get_z_buffer())
        print(f"wrote {args.dump_z}")
    if args.dump_shadow:
        write_png(args.dump_shadow, scene.get_shadow_buffer())
        print(f"wrote {args.dump_shadow}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
