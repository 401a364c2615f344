"""Long-running oracle-parity soak over random knob/scene/pose draws.

Reuses the fuzz suite's draw machinery (tests/test_fuzz_configs.py) but
over an arbitrary seed range — the fixed-seed fast tests sample the draw
space 3 ways; a soak samples it hundreds of ways.  Each iteration draws
a random valid RenderConfig, a random triangle soup, and a random
light/camera pose, renders through the REAL kernel path
(pallas_interpret) and the float64 oracle, and asserts the parity
contract (tie-flips <=1% of covered pixels; flagged-deterministic
coverage drop under tight span caps).

CPU-only (forces the cpu platform before any jax import).  On the first failure it prints a one-line
repro (seed + config) and exits 1; a clean run prints a summary line.

Usage: python scripts/fuzz_soak.py [first_seed] [n_seeds] [--sharded]

--sharded: soak the ROW-SHARDED path instead (8 virtual CPU devices):
random poses + sharding knob draws (binning_compact, shard_triangles,
replicate_pass1) through render_frame_sharded must stay BIT-identical
to single-device; every 3rd two-pass draw additionally runs the
pipelined two-pass path (render_sequence_pipelined) and asserts the
same bit-identity per frame.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _overflow_reason(geomj, cfg, pipeline, light, look_from, look_at, up):
    """Ground-truth reasons the overflow flag may be set for this draw:
    per-pass worst bbox span (tiles touched) beyond the caps, or a coord
    exactness trip.  Empty list = the flag would be spurious."""
    import jax.numpy as jnp
    import numpy as np

    from tiny_renderer_tpu.ops import mathlib as ml
    from tiny_renderer_tpu.ops.vertex import triangle_setup
    from tiny_renderer_tpu.pipelines.frame import PIPELINES

    spec = PIPELINES[pipeline]
    passes = []
    if spec.two_pass:
        u1 = ml.shadow_pass_1_prepare(cfg, light, look_at, up, jnp)
        u2 = ml.shadow_pass_2_prepare(cfg, light, look_from, look_at, up, jnp)
        u2["shadow_matrix"] = u1["shadow_matrix"]
        passes = [(u1, "shadow_matrix", False), (u2, "vpmv", True)]
    else:
        passes = [(
            ml.default_prepare(cfg, light, look_from, look_at, up, jnp),
            "vpmv", True,
        )]
    reasons = []
    for p, (uni, mk, cull) in enumerate(passes):
        setup = triangle_setup(
            geomj, uni, cfg, matrix_key=mk, cull=cull, needs=(), xp=jnp
        )
        if bool(np.asarray(setup["coord_overflow"])):
            reasons.append(f"pass{p} coord_overflow")
        v = np.asarray(setup["valid"])
        if v.any():
            sy = int(((np.asarray(setup["y1"])[v] // cfg.tile_h)
                      - (np.asarray(setup["y0"])[v] // cfg.tile_h)).max()) + 1
            sx = int(((np.asarray(setup["x1"])[v] // cfg.tile_w)
                      - (np.asarray(setup["x0"])[v] // cfg.tile_w)).max()) + 1
            if sy > cfg.max_span_y or sx > cfg.max_span_x:
                reasons.append(f"pass{p} span {sy}x{sx} tiles "
                               f"> caps {cfg.max_span_y}x{cfg.max_span_x}")
    return reasons


def _soak_sharded(first, count):
    """Row-sharded (and pipelined) bit-identity soak on the virtual mesh."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests")
    )
    from test_fuzz_configs import _random_scene

    from tiny_renderer_tpu import RenderConfig
    from tiny_renderer_tpu.models.procedural import make_textures
    from tiny_renderer_tpu.parallel import (
        make_pp_mesh,
        make_row_mesh,
        render_frame_sharded,
        render_sequence_pipelined,
    )
    from tiny_renderer_tpu.pipelines.frame import make_frame_fn

    devices = jax.devices()[:8]
    assert len(devices) == 8, "needs the 8-device virtual CPU mesh"
    mesh = make_row_mesh(devices, batch=1)
    pp_mesh = make_pp_mesh(devices)
    pipelines = ["phong", "shadow", "darboux", "occlusion", "specular"]

    t0 = time.time()
    pp_checked = 0
    for i, seed in enumerate(range(first, first + count)):
        rng = np.random.default_rng(seed)
        pipeline = pipelines[seed % len(pipelines)]
        geom = _random_scene(100, seed)
        tex = make_textures(64)
        a, b = rng.uniform(-np.pi, np.pi, 2)
        light = np.array([np.sin(a), 0, np.cos(a)], np.float32)
        look_from = np.array([np.sin(b), 0.3, np.cos(b)], np.float32)
        look_at = np.zeros(3, np.float32)
        up = np.array([0, 1, 0], np.float32)
        cfg = RenderConfig(
            width=96, height=96, tri_block=32,
            binning_compact=bool(rng.integers(2)),
            shard_triangles=bool(rng.integers(2)),
            replicate_pass1=bool(rng.integers(2)),
        )
        repro = f"seed={seed} pipeline={pipeline} cfg={cfg}"
        args = (
            jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
            jnp.asarray(light), jnp.asarray(look_from), jnp.asarray(look_at),
            jnp.asarray(up),
        )
        sharded = render_frame_sharded(
            *args, pipeline=pipeline, config=cfg, mesh=mesh
        )
        single_cfg = dataclasses.replace(cfg, shard_triangles=False)
        single = make_frame_fn(pipeline, single_cfg, backend="jnp")(*args)
        if not np.array_equal(np.asarray(sharded["frame"]),
                              np.asarray(single["frame"])):
            print(f"FAIL sharded != single: {repro}")
            return 1
        two_pass = pipeline in ("shadow", "occlusion")
        if two_pass and seed % 3 == 0:
            pp_cfg = dataclasses.replace(
                cfg, shard_triangles=False, replicate_pass1=False
            )
            lights = jnp.stack([args[2], args[2]])
            froms = jnp.stack([args[3], args[3]])
            pp = render_sequence_pipelined(
                args[0], args[1], lights, froms, args[4], args[5],
                pipeline=pipeline, config=pp_cfg, mesh=pp_mesh,
            )
            pp_single = make_frame_fn(pipeline, pp_cfg, backend="jnp")(*args)
            for f in range(2):
                if not np.array_equal(np.asarray(pp["frame"][f]),
                                      np.asarray(pp_single["frame"])):
                    print(f"FAIL pipelined frame {f} != single: {repro}")
                    return 1
            pp_checked += 1
        if (i + 1) % 10 == 0:
            dt = time.time() - t0
            print(f"[soak/sharded] {i + 1}/{count} ok ({pp_checked} pp) "
                  f"{dt / (i + 1):.1f} s/draw", flush=True)
            jax.clear_caches()  # unbounded unique-signature cache (see above)
    print(f"[soak/sharded] PASS: {count} draws (seeds {first}.."
          f"{first + count - 1}), {pp_checked} pipelined-checked, "
          f"{time.time() - t0:.0f} s total")
    return 0


def main():
    sharded = "--sharded" in sys.argv
    if sharded:
        os.environ["XLA_FLAGS"] = (
            " ".join(
                f for f in os.environ.get("XLA_FLAGS", "").split()
                if not f.startswith("--xla_force_host_platform_device_count")
            )
            + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests")
    )
    from test_fuzz_configs import _random_config, _random_scene

    from tiny_renderer_tpu.models.procedural import make_textures
    from tiny_renderer_tpu.oracle import render_oracle
    from tiny_renderer_tpu.pipelines.frame import make_frame_fn

    argv = [a for a in sys.argv[1:] if a != "--sharded"]
    first = int(argv[0]) if len(argv) > 0 else 1000
    count = int(argv[1]) if len(argv) > 1 else 100
    if sharded:
        return _soak_sharded(first, count)
    pipelines = ["phong", "shadow", "occlusion", "darboux", "specular",
                 "normal_map", "default"]

    t0 = time.time()
    clamped = 0
    for i, seed in enumerate(range(first, first + count)):
        rng = np.random.default_rng(seed)
        pipeline = pipelines[seed % len(pipelines)]
        geom = _random_scene(100, seed)
        tex = make_textures(64)
        a, b = rng.uniform(-np.pi, np.pi, 2)
        light = np.array([np.sin(a), 0, np.cos(a)], np.float32)
        look_from = np.array([np.sin(b), 0, np.cos(b)], np.float32)
        look_at = np.zeros(3, np.float32)
        up = np.array([0, 1, 0], np.float32)
        # Random (tile-unaligned) sizes too — the fixed-size fast fuzz
        # holds 96x96; sizes are a separate bug axis (edge tiles, strip
        # tails).  Biased small to keep the float64 oracle fast.
        w = int(rng.choice([48, 64, 96, 100, 130, 160, 200]))
        h = int(rng.choice([48, 64, 96, 100, 130, 160, 200]))
        cfg = _random_config(rng, w, h)
        repro = f"seed={seed} pipeline={pipeline} cfg={cfg}"

        try:
            fn = make_frame_fn(pipeline, cfg, backend="pallas_interpret")
            args = (
                jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
                jnp.asarray(light), jnp.asarray(look_from),
                jnp.asarray(look_at), jnp.asarray(up),
            )
            r = fn(*args)
            if bool(np.asarray(r["overflow"])):
                # The flag must have a ground-truth reason: a pass whose
                # worst bbox exceeds the span caps in TILES TOUCHED, or a
                # coord-exactness trip (computed from the actual setups,
                # not a cap heuristic — a cap of 4 at tile_h=8 is only
                # 32 px and can legitimately bind).
                # Resolve per-pipeline tuned defaults first: the caps the
                # RENDER actually ran with are the resolved ones.
                reasons = _overflow_reason(
                    args[0], cfg.resolve(pipeline), pipeline, *args[2:]
                )
                if not reasons:
                    print(f"FAIL spurious overflow (no reason found): {repro}")
                    return 1
                r2 = fn(*args)
                if not np.array_equal(np.asarray(r["frame"]),
                                      np.asarray(r2["frame"])):
                    print(f"FAIL nondeterministic clamped render: {repro}")
                    return 1
                clamped += 1
            else:
                o = render_oracle(geom, tex, light, look_from, look_at, up,
                                  pipeline=pipeline, config=cfg)
                mismatch = (
                    (np.asarray(r["frame"]) != o["frame"]).any(axis=-1).mean()
                )
                if mismatch > 0.01:
                    print(f"FAIL mismatch {mismatch:.3%}: {repro}")
                    return 1
                if seed % 5 == 0:
                    # Every 5th unclamped draw: the STRONGEST contract —
                    # the kernel path must be BIT-identical to the jnp
                    # backend under the same knob draw.  (Clamped draws
                    # are excluded: the jnp backend rasterizes densely
                    # with no binning caps, so a flagged coverage drop
                    # legitimately differs — soak seed 3020.)
                    rj = make_frame_fn(pipeline, cfg, backend="jnp")(*args)
                    if not np.array_equal(np.asarray(r["frame"]),
                                          np.asarray(rj["frame"])):
                        print(f"FAIL kernel!=jnp bit-identity: {repro}")
                        return 1
        except Exception as e:  # noqa: BLE001 — a soak must name its repro
            print(f"FAIL exception {e!r}: {repro}")
            raise

        if (i + 1) % 10 == 0:
            dt = time.time() - t0
            print(f"[soak] {i + 1}/{count} ok ({clamped} clamped) "
                  f"{dt / (i + 1):.1f} s/draw", flush=True)
            # Every draw is a fresh jit signature; without this the
            # executable cache grows without bound and a long soak dies
            # in LLVM OOM (observed at ~150 draws x 2 concurrent soaks).
            jax.clear_caches()

    print(f"[soak] PASS: {count} draws (seeds {first}..{first + count - 1}), "
          f"{clamped} flagged-clamped, {time.time() - t0:.0f} s total")
    return 0


if __name__ == "__main__":
    sys.exit(main())
