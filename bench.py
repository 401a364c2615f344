"""Burst timer on the seeded reference-shape scenes.

For each (scene, pipeline) config it renders an N-frame orbit with
render_burst (one device program: a lax.scan over camera/light angles),
compiles it once untimed, then times `--reps` runs, each ended with
jax.block_until_ready, and reports the median ms/frame.  The device
(platform, device_kind, count) and the card's name and power limit go on
stderr and into the one JSON line printed on stdout.

Usage: python bench.py [--frames 64] [--reps 5] [--all] [--backend auto]
                       [--size 800] [--stress] [--knob NAME=VALUE ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# (seeded scene, pipeline, orbiting light) — BASELINE.json's five configs.
CONFIGS = [
    ("african_head", "default", False),
    ("diablo", "phong", False),
    ("diablo", "darboux", False),
    ("diablo", "shadow", False),
    ("diablo", "occlusion", True),
]
HEADLINE = ("diablo", "shadow")


def bench_config(asset, pipeline, orbit, frames, reps, backend="auto",
                 size=800, subdivide=0, knobs=()):
    """Median ms/frame of an N-frame render_burst of one config."""
    import jax.numpy as jnp

    from tiny_renderer_tpu import RenderConfig, Scene
    from tiny_renderer_tpu.models import seeded_model
    from tiny_renderer_tpu.pipelines.frame import make_burst_fn
    from tiny_renderer_tpu.utils.timing import median_ms

    model = seeded_model(asset, 0)
    if subdivide:
        import dataclasses

        from tiny_renderer_tpu.assets.mesh_tools import subdivide_mesh

        model = dataclasses.replace(
            model, mesh=subdivide_mesh(model.mesh, levels=subdivide)
        )
        asset = f"{asset}_x{4 ** subdivide}"
    config = RenderConfig(width=size, height=size)
    if knobs:
        from tiny_renderer_tpu.app import apply_knobs

        config = apply_knobs(config, knobs)
    scene = Scene(model, pipeline, config, backend=backend)
    cams = jnp.asarray((0.37 + 0.05 * np.arange(frames)).astype(np.float32))
    step = 0.03 if orbit else 0.0
    ligs = jnp.asarray((-0.6 + step * np.arange(frames)).astype(np.float32))
    burst = make_burst_fn(pipeline, config, backend=backend)
    ms, first_ms = median_ms(
        lambda: burst(scene._geom, scene._textures, cams, ligs), reps
    )
    return {
        "asset": asset,
        "pipeline": pipeline,
        "triangles": model.num_triangles,
        "ms_per_frame": ms / frames,
        "fps": frames * 1e3 / ms,
        "compile_and_first_run_s": first_ms / 1e3,
    }


def headline_payload(results, device, gpu, knobs=()):
    """The stdout JSON line: the headline config's ms/frame plus every
    config's number and what it was measured on."""
    head = next(
        (r for r in results if (r["asset"], r["pipeline"]) == HEADLINE),
        results[-1],
    )
    return {
        "metric": f"ms/frame {head['asset']} {head['pipeline']} burst",
        "value": head["ms_per_frame"],
        "unit": "ms",
        "device": device,
        "gpu": gpu,
        "configs": {f"{r['asset']}:{r['pipeline']}": r["ms_per_frame"]
                    for r in results},
        **({"knobs": list(knobs)} if knobs else {}),
    }


def main():
    ap = argparse.ArgumentParser(description="burst timer (see module doc)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--all", action="store_true",
                    help="run all 5 configs (default: the headline only)")
    ap.add_argument("--stress", action="store_true",
                    help="add the 80,352-triangle capacity config")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="skip the persistent XLA compile cache")
    ap.add_argument("--knob", action="append", default=[], metavar="NAME=VALUE",
                    help="override a RenderConfig field for every config "
                         "(repeatable; same syntax/validation as the app CLI)")
    args = ap.parse_args()

    if args.knob:
        # Validate knob names/values before any device work.
        from tiny_renderer_tpu.app import apply_knobs
        from tiny_renderer_tpu.config import RenderConfig

        apply_knobs(RenderConfig(), args.knob)

    if not args.no_compile_cache:
        from tiny_renderer_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
    from tiny_renderer_tpu.utils.timing import device_summary, gpu_name_power

    device = device_summary()
    gpu = gpu_name_power()
    print(f"# device {device}; gpu {gpu}", file=sys.stderr, flush=True)

    configs = [c + (0,) for c in (CONFIGS if args.all else [HEADLINE + (False,)])]
    if args.stress:
        # diablo subdivided twice: 80,352 triangles (16x the reference).
        configs.append(("diablo", "phong", True, 2))
    results = []
    for asset, pipeline, orbit, subdiv in configs:
        r = bench_config(asset, pipeline, orbit, args.frames, args.reps,
                         args.backend, args.size, subdivide=subdiv,
                         knobs=args.knob)
        results.append(r)
        print(
            f"# {r['asset']:13s} {r['pipeline']:9s} {r['ms_per_frame']:9.4f} "
            f"ms/frame ({r['fps']:8.1f} FPS; compile+first run "
            f"{r['compile_and_first_run_s']:.1f} s)",
            file=sys.stderr, flush=True,
        )
    print(json.dumps(headline_payload(results, device, gpu, args.knob)))


if __name__ == "__main__":
    main()
