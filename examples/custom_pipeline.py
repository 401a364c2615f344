"""Registering a custom shader pipeline.

The built-in 7 pipelines mirror the reference (shader.rs:100-109); this
example adds two more without touching the framework's internals:

* "toon" — a cel shader that quantizes the Gouraud intensity into bands,
  composed purely from the built-in varying vocabulary; and
* "glow" — the same texture lit by a USER vertex attribute: a varying
  named "attr:glow" declares a (T, 3, 1) per-corner float plane the
  caller supplies (here: height-derived), which the framework
  interpolates exactly like uv.  The reference's closed 7-name dispatch
  has no analog for either.

Registered names work with Scene, render_frame/render_burst on every
backend, the sharded multi-device paths, the CLI (when registered before
build_arg_parser), and the CPU oracle, so the parity machinery applies
to YOUR shader too.

Run:  python examples/custom_pipeline.py [asset_dir] [out.png]
      (also writes <out>-glow.png with the custom-attribute pipeline)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def shade_toon(frag, uniforms, textures, config, xp):
    """Cel shading: texture color scaled by intensity snapped to 4 bands.

    The shared shade signature: frag carries the varyings declared at
    registration ("uv" arrives pre-resolved for sample_frag, "intensity"
    per fragment) plus "x"/"y"; xp is jnp on device and np in the oracle,
    so one function serves both.
    """
    from tiny_renderer_tpu.ops import mathlib as ml
    from tiny_renderer_tpu.pipelines.shaders import BLACK, sample_frag

    color = sample_frag(textures, frag, ("texture",), xp)["texture"]
    bands = xp.float32(4.0)
    t = xp.ceil(xp.clip(frag["intensity"], 0.0, 1.0) * bands) / bands
    return ml.color_blend(color, xp.asarray(BLACK), t, xp)


def shade_glow(frag, uniforms, textures, config, xp):
    """Texture modulated by the interpolated user attribute "attr:glow"."""
    from tiny_renderer_tpu.ops import mathlib as ml
    from tiny_renderer_tpu.pipelines.shaders import BLACK, sample_frag

    color = sample_frag(textures, frag, ("texture",), xp)["texture"]
    t = xp.clip(frag["attr:glow"][..., 0], 0.0, 1.0)
    return ml.color_blend(color, xp.asarray(BLACK), t, xp)


def main():
    import jax.numpy as jnp

    from tiny_renderer_tpu import Scene, load_model, register_pipeline

    register_pipeline(
        "toon",
        shade_toon,
        varying_spec=(("uv", 2, "interp"), ("intensity", 1, "interp")),
        maps=("texture",),
        needs=("vertex_intensity",),
    )
    register_pipeline(
        "glow",
        shade_glow,
        varying_spec=(("uv", 2, "interp"), ("attr:glow", 1, "interp")),
        maps=("texture",),
    )

    from tiny_renderer_tpu.models import seeded_model

    asset = sys.argv[1] if len(sys.argv) > 1 else "-"
    out = sys.argv[2] if len(sys.argv) > 2 else "toon.png"
    model = seeded_model("diablo") if asset == "-" else load_model(asset)
    scene = Scene(model, "toon")
    scene.set_light_direction(jnp.asarray([0.35, 0.0, 0.94], jnp.float32))
    scene.render()
    frame = scene.get_frame_buffer()

    from tiny_renderer_tpu.utils.png import write_png

    write_png(out, frame)
    print(f"wrote {out} ({frame.shape[1]}x{frame.shape[0]})")

    # The custom-attribute pipeline: per-corner "glow" derived from model
    # height (any (T, 3, 1) float values work — skinning weights, AO
    # bakes, per-vertex paint...).
    corners = np.asarray(model.mesh.positions)[np.asarray(model.mesh.pos_idx)]
    glow = np.clip(0.5 + corners[..., 1], 0.0, 1.0)[..., None]
    gscene = Scene(model, "glow", vertex_attrs={"glow": glow})
    gscene.render()
    gout = out.rsplit(".", 1)[0] + "-glow.png"
    write_png(gout, gscene.get_frame_buffer())
    print(f"wrote {gout}")


if __name__ == "__main__":
    main()
