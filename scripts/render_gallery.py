"""Render the full pipeline x asset gallery to docs/gallery/*.png.

Usage: python scripts/render_gallery.py [--size 400] [--out docs/gallery]
           [--asset-root DIR]
Runs on whatever backend the platform resolves to (the kernel on a GPU).
Without --asset-root the two seeded reference-shape scenes are rendered.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--out", default="docs/gallery")
    ap.add_argument("--asset-root", default=None,
                    help="directory with african_head/ and diablo/ asset dirs")
    args = ap.parse_args()

    from tiny_renderer_tpu import PIPELINE_NAMES, RenderConfig, Scene, load_model
    from tiny_renderer_tpu.models import seeded_model
    from tiny_renderer_tpu.utils.png import write_png

    os.makedirs(args.out, exist_ok=True)
    cfg = RenderConfig(width=args.size, height=args.size)
    for asset in ("african_head", "diablo"):
        model = (
            seeded_model(asset) if args.asset_root is None
            else load_model(os.path.join(args.asset_root, asset), verbose=False)
        )
        for pipeline in PIPELINE_NAMES:
            t0 = time.time()
            scene = Scene(model, pipeline, cfg)
            scene.set_camera(
                np.array([np.sin(0.35), 0.0, np.cos(0.35)], np.float32),
                np.zeros(3, np.float32),
                np.array([0.0, 1.0, 0.0], np.float32),
            )
            scene.set_light_direction(
                np.array([np.sin(-0.5), 0.0, np.cos(-0.5)], np.float32)
            )
            scene.render()
            path = os.path.join(args.out, f"{asset}_{pipeline}.png")
            write_png(path, scene.get_frame_buffer())
            print(f"{path} ({time.time()-t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
