"""Multi-device (sharded) rendering.

Renders one full frame with the screen rows sharded across a
jax.sharding.Mesh — the scale-out path for resolutions/scenes beyond one
card (docs/API.md "Multi-chip"; the sharded output is bit-identical to
single-device, pinned by tests/test_parallel.py).  On a GPU host the mesh
spans the real cards (and the raster is the GPU kernel); on a CPU-only
host the script brings up 8 virtual CPU devices so it runs anywhere (the
XLA flag must be set before the backend initializes, and only affects the
CPU platform).

Run:  python examples/sharded_render.py [asset_dir|-] [out.png] [--replicate-pass1]
      python examples/sharded_render.py [asset_dir] [out.png] --pipelined
        (--pipelined: a 3-frame orbit through render_sequence_pipelined —
         two-pass pipeline parallelism on a ("stage", "rows") mesh; writes
         out.png per frame with a -N suffix)
      --size N renders NxN.  The frame height must be divisible by the
      mesh's row axis (every device, or half of them with --pipelined) and,
      with the GPU kernel, each shard must be whole tile_h-row tiles.  The
      default is the reference's 800x800 on the CPU and 1024x1024 on a GPU
      host, whose shards are whole tiles on 1, 2, 4 or 8 cards.  asset_dir
      "-" or omitted: the seeded diablo-shaped scene.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

CPU_DEVICES = 8

os.environ["XLA_FLAGS"] = (
    " ".join(
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_force_host_platform_device_count")
    )
    + f" --xla_force_host_platform_device_count={CPU_DEVICES}"
).strip()

import jax
import jax.numpy as jnp
import numpy as np

# The real cards when JAX runs on a GPU, else the virtual CPU devices.
N_DEVICES = len(jax.devices())


def main():
    from tiny_renderer_tpu import RenderConfig, load_model
    from tiny_renderer_tpu.models import seeded_model
    from tiny_renderer_tpu.ops.vertex import expand_geometry
    from tiny_renderer_tpu.parallel.sharding import (
        make_row_mesh,
        render_frame_sharded,
    )
    from tiny_renderer_tpu.pipelines.frame import resolve_backend

    argv = list(sys.argv[1:])
    # The GPU kernel needs whole tile_h-row tiles per shard; the CPU's
    # dense raster takes any shard height.
    tile_h = None if resolve_backend("auto") == "jnp" else RenderConfig().tile_h
    size = 800 if tile_h is None else 1024
    if "--size" in argv:
        i = argv.index("--size")
        if i + 1 >= len(argv):
            sys.exit("--size needs a value, e.g. --size 400")
        try:
            size = int(argv[i + 1])
        except ValueError:
            sys.exit(f"--size must be an integer, got {argv[i + 1]!r}")
        del argv[i:i + 2]
    # --replicate-pass1: full-height per-device light pass instead of the
    # all_gather'ed shadow map (the interconnect-vs-FLOPs knob; output
    # identical).
    replicate = "--replicate-pass1" in argv
    # --pipelined: render a short orbit through the two-pass pipeline-
    # parallel path (("stage", "rows") mesh, ppermute shadow handoff).
    pipelined = "--pipelined" in argv
    if replicate and pipelined:
        sys.exit(
            "--replicate-pass1 and --pipelined are mutually exclusive "
            "(replicate_pass1 is a pass-1 strategy; the pipelined path "
            "splits the passes across mesh stages instead)"
        )
    argv = [a for a in argv if a not in ("--replicate-pass1", "--pipelined")]
    if pipelined and N_DEVICES % 2:
        sys.exit(f"--pipelined needs an even device count, have {N_DEVICES}")
    rows = N_DEVICES // 2 if pipelined else N_DEVICES
    if size <= 0 or size % rows != 0:
        sys.exit(
            f"--size must be a positive multiple of the mesh's row "
            f"axis ({rows}), got {size}"
        )
    if tile_h is not None and (size // rows) % tile_h != 0:
        sys.exit(
            f"--size {size} gives {size // rows}-row shards over {rows} "
            f"devices; the GPU kernel needs a multiple of tile_h={tile_h}"
        )
    asset = argv[0] if len(argv) > 0 else "-"
    out = argv[1] if len(argv) > 1 else "sharded.png"

    model = seeded_model("diablo") if asset == "-" else load_model(asset)
    geom = expand_geometry({
        "positions": jnp.asarray(model.mesh.positions),
        "tex_coords": jnp.asarray(model.mesh.tex_coords),
        "normals": jnp.asarray(model.mesh.normals),
        "pos_idx": jnp.asarray(model.mesh.pos_idx),
        "tex_idx": jnp.asarray(model.mesh.tex_idx),
        "normal_idx": jnp.asarray(model.mesh.normal_idx),
    })
    tex = {
        "texture": jnp.asarray(model.texture),
        "normal_map": jnp.asarray(model.normal_map),
        "normal_map_tangent": jnp.asarray(model.normal_map_tangent),
        "specular_map": jnp.asarray(model.specular_map),
    }

    look_at = jnp.zeros(3, jnp.float32)
    up = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)

    from tiny_renderer_tpu.utils.png import write_png

    if pipelined:
        from tiny_renderer_tpu.parallel import (
            make_pp_mesh,
            render_sequence_pipelined,
        )

        mesh = make_pp_mesh(jax.devices()[:N_DEVICES])
        print(f"pp mesh: {dict(mesh.shape)} over {N_DEVICES} devices")
        cfg = RenderConfig(width=size, height=size)
        B = 3
        angles = np.linspace(0.0, 0.9, B, dtype=np.float32)
        lights = jnp.asarray(np.stack(
            [[np.sin(a + 0.35), 0.0, np.cos(a + 0.35)] for a in angles],
            dtype=np.float32))
        froms = jnp.asarray(np.stack(
            [[np.sin(a + 0.25), 0.0, np.cos(a + 0.25)] for a in angles],
            dtype=np.float32))
        result = render_sequence_pipelined(
            geom, tex, lights, froms, look_at, up,
            pipeline="shadow", config=cfg, mesh=mesh,
        )
        base, ext = os.path.splitext(out)
        for i in range(B):
            frame = np.asarray(result["frame"][i])[::-1]  # presentation flip
            write_png(f"{base}-{i}{ext}", frame)
            print(f"wrote {base}-{i}{ext}")
        print(f"overflow={np.asarray(result['overflow']).tolist()}")
        return

    mesh = make_row_mesh(jax.devices()[:N_DEVICES], batch=1)
    print(f"mesh: {dict(mesh.shape)} over {N_DEVICES} devices")
    cfg = RenderConfig(width=size, height=size, replicate_pass1=replicate)
    result = render_frame_sharded(
        geom, tex,
        jnp.asarray([0.35, 0.0, 0.94], jnp.float32),   # light
        jnp.asarray([0.25, 0.0, 0.97], jnp.float32),   # look_from
        look_at, up,
        pipeline="shadow", config=cfg, mesh=mesh,
    )
    frame = np.asarray(result["frame"])[::-1]  # presentation flip

    write_png(out, frame)
    print(f"wrote {out} ({frame.shape[1]}x{frame.shape[0]}, "
          f"overflow={bool(np.asarray(result['overflow']).any())})")


if __name__ == "__main__":
    main()
