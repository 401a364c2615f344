"""Render an orbiting-camera animation to an animated GIF.

The reference's user-facing surface is a live window with the model
orbiting under A/D (camera) and Q/E (light) keys (/root/reference/
src/app.rs:200-224); this produces the same orbit as a shareable
artifact for docs/gallery.  One device burst renders every frame
(frames never round-trip per-step), then PIL assembles the GIF.

Usage: python scripts/render_orbit_gif.py [--size 400] [--frames 48]
           [--pipeline shadow] [--asset DIR] [--out docs/gallery/...]
(without --asset: the seeded diablo-shaped scene)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--pipeline", default="shadow")
    ap.add_argument("--asset", default=None, help="asset dir (default: seeded diablo)")
    ap.add_argument("--out", default=None, help="output .gif path")
    ap.add_argument("--fps", type=float, default=24.0, help="GIF playback rate")
    args = ap.parse_args()

    import jax.numpy as jnp

    from tiny_renderer_tpu.assets.model import load_model
    from tiny_renderer_tpu.models import seeded_model
    from tiny_renderer_tpu.config import RenderConfig
    from tiny_renderer_tpu.pipelines.frame import make_burst_fn
    from tiny_renderer_tpu.scene import Scene
    from tiny_renderer_tpu.utils.transfer import fetch

    cfg = RenderConfig(width=args.size, height=args.size)
    model = seeded_model("diablo") if args.asset is None else load_model(args.asset)
    scene = Scene(model, args.pipeline, cfg)

    # One full camera revolution.  The light tracks the camera at a fixed
    # angular offset so every frame is lit (a counter-orbiting light spends
    # half the revolution behind the model) while the shadows still sweep.
    n = args.frames
    cams = (2.0 * np.pi * np.arange(n) / n).astype(np.float32)
    ligs = cams + np.float32(0.7)

    burst = make_burst_fn(args.pipeline, cfg, backend=scene.backend,
                          keep_frames=True)
    out = burst(scene._geom, scene._textures, jnp.asarray(cams),
                jnp.asarray(ligs))
    frames = fetch(out["frames"])[:, ::-1]  # presentation v-flip

    from PIL import Image

    ims = [Image.fromarray(np.asarray(f)) for f in frames]
    out_path = args.out or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "docs", "gallery",
        f"orbit_{os.path.basename(args.asset or 'diablo')}_{args.pipeline}.gif",
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    ims[0].save(out_path, save_all=True, append_images=ims[1:],
                duration=int(1000 / args.fps), loop=0)
    print(f"wrote {len(ims)} frames to {out_path} "
          f"({os.path.getsize(out_path) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
