"""Smoke test of the renderer on the GPU: the quickest proof that the main
path still starts, compiles and renders correctly on the card.

Run from the root of a checkout:

    python chip_smoke.py                # one card: phases (a)-(e)
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Phases on one card (any failed check makes the exit code non-zero and
suppresses the result line):

  (a) the card's name and power limit (nvidia-smi), jax.devices(), the
      raster backend "auto" resolves to (must be the GPU kernel) and the
      matmul precision in effect;
  (b) the seeded diablo-shaped scene (5,022 triangles, 1024^2 maps) at
      800x800, all 7 pipelines, rendered through Scene and through an
      8-frame orbit render_burst, each frame against the NumPy oracle
      (render_oracle) within the tie-flip budget (<0.5% of pixels), with
      no overflow; then the same on the african_head-shaped scene;
  (c) the raster kernel against the dense rasterize_jnp on the card at
      800x800 / 5,022 triangles, both passes of `shadow`: coverage equal,
      winners differ on <0.2% of pixels, z within rtol 1e-5 / atol 1e-4;
      and the kernel's varying planes (phase 2) against compute_varyings
      within rtol 1e-5 / atol 1e-5 on the pixels where both pick the same
      triangle;
  (d) the same frame rendered twice is bit-equal;
  (e) timings, each the median of 5 runs ended with block_until_ready,
      compile kept apart: the raster stage alone (both passes of
      `shadow`, kernel with its binning vs rasterize_jnp), and a 64-frame
      render_burst of every pipeline with backend "pallas" vs "jnp".

--four-cards renders `shadow` row-sharded over a 4-row mesh at 1024x1024
(256 rows per card, whole 16-row tiles; 800/4 = 200 rows is not) and `phong` batch-sharded over a
4-card batch mesh, and requires both to be bit-equal to the single-card
render of the same frames.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU, or outside a checkout, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from tiny_renderer_tpu import PIPELINE_NAMES, RenderConfig, Scene
from tiny_renderer_tpu.models import seeded_model, to_geom
from tiny_renderer_tpu.ops import mathlib as ml
from tiny_renderer_tpu.ops.raster_jnp import rasterize_jnp
from tiny_renderer_tpu.ops.vertex import triangle_setup
from tiny_renderer_tpu.oracle import render_oracle
from tiny_renderer_tpu.pipelines import frame as fr
from tiny_renderer_tpu.pipelines.shaders import VARYING_SPECS, compute_varyings
from tiny_renderer_tpu.utils.compile_cache import enable_compile_cache
from tiny_renderer_tpu.utils.timing import device_summary, gpu_name_power, median_ms

SIZE = 800
SHARD_SIZE = 1024  # row-sharded frame: whole tiles on each of 4 cards
KERNEL = "pallas"  # the backend under test; "auto" must resolve to it
TIE_FLIP_BUDGET = 0.005  # fraction of pixels (CLAUDE.md invariant)
WINNER_BUDGET = 0.002  # kernel vs rasterize_jnp winners
BURST_FRAMES = 64  # frames per timed burst (phase e)
REPS = 5  # timed runs per number (phase e)
MAPS = ("texture", "normal_map", "normal_map_tangent", "specular_map")
LOOK_AT = np.zeros(3, np.float32)
UP = np.array([0.0, 1.0, 0.0], np.float32)

FAILURES: list[str] = []


def check(ok, what):
    """Record one check; failures are printed and fail the run at the end."""
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def orbit(cam, lig):
    """(light, look_from) on the unit XZ circle (src/app.rs:200-207)."""
    light = np.array([np.sin(lig), 0.0, np.cos(lig)], np.float32)
    look_from = np.array([np.sin(cam), 0.0, np.cos(cam)], np.float32)
    return light, look_from


def scene_arrays(model):
    geom = {k: np.asarray(v) for k, v in to_geom(model.mesh).items()}
    tex = {k: getattr(model, k) for k in MAPS}
    return geom, tex


def mismatch(a, b):
    return float((np.asarray(a) != np.asarray(b)).any(axis=-1).mean())


# ── (b) + (d): pipelines against the oracle, determinism ────────────────
def phase_pipelines(name, cams, ligs, determinism):
    model = seeded_model(name, 0)
    geom, tex = scene_arrays(model)
    cfg = RenderConfig(width=SIZE, height=SIZE)
    print(f"-- (b) {name}: {model.num_triangles} triangles, {SIZE}x{SIZE}, "
          f"{len(cams)}-frame bursts", flush=True)
    for pipe in PIPELINE_NAMES:
        scene = Scene(model, pipe, cfg)
        light, look_from = orbit(cams[0], ligs[0])
        scene.set_camera(look_from, LOOK_AT, UP)
        scene.set_light_direction(light)
        out = jax.device_get(scene.render())
        want = render_oracle(geom, tex, light, look_from, LOOK_AT, UP,
                             pipeline=pipe, config=cfg)["frame"]
        m = mismatch(out["frame"], want)
        check(m < TIE_FLIP_BUDGET and not out["overflow"],
              f"{name} {pipe} Scene vs oracle: mismatch {m:.6f} "
              f"overflow {bool(out['overflow'])}")
        if determinism:
            again = np.asarray(scene.render()["frame"])
            check(np.array_equal(again, out["frame"]),
                  f"(d) {name} {pipe} repeat render bit-equal")

        burst = fr.make_burst_fn(pipe, cfg, keep_frames=True)
        res = jax.device_get(burst(scene._geom, scene._textures,
                                   jnp.asarray(cams), jnp.asarray(ligs)))
        worst = 0.0
        for i, (c, l) in enumerate(zip(cams, ligs)):
            light, look_from = orbit(c, l)
            want = render_oracle(geom, tex, light, look_from, LOOK_AT, UP,
                                 pipeline=pipe, config=cfg)["frame"]
            worst = max(worst, mismatch(res["frames"][i], want))
        check(worst < TIE_FLIP_BUDGET and not res["overflow"].any(),
              f"{name} {pipe} burst vs oracle: worst mismatch {worst:.6f} "
              f"overflow {bool(res['overflow'].any())}")


# ── (c): kernel vs rasterize_jnp, phase-2 planes vs compute_varyings ────
def _shadow_setups(geom, cfg, cam, lig, needs):
    light, look_from = (jnp.asarray(v) for v in orbit(cam, lig))
    la, up = jnp.asarray(LOOK_AT), jnp.asarray(UP)
    u1 = ml.shadow_pass_1_prepare(cfg, light, la, up, jnp)
    s1 = triangle_setup(geom, u1, cfg, matrix_key="shadow_matrix", cull=False,
                        needs=(), xp=jnp)
    u2 = ml.shadow_pass_2_prepare(cfg, light, look_from, la, up, jnp)
    u2["shadow_matrix"] = u1["shadow_matrix"]
    return s1, triangle_setup(geom, u2, cfg, needs=needs, xp=jnp)


def phase_raster(geom, cfg):
    print(f"-- (c) kernel vs rasterize_jnp, {SIZE}x{SIZE}, both passes of shadow",
          flush=True)
    needs = fr.PIPELINES["shadow"].needs
    setups = jax.jit(lambda g: _shadow_setups(g, cfg, 0.37, -0.6, needs))(geom)

    @jax.jit
    def kernel(s1, s2):
        z1, _, _, o1 = fr._rasterize(s1, cfg, KERNEL, emit_idx=False)
        z2, i2, _, o2 = fr._rasterize(s2, cfg, KERNEL)
        return z1, z2, i2, o1 | o2

    @jax.jit
    def dense(s1, s2):
        z1, _ = rasterize_jnp(s1, SIZE, SIZE, cfg.tri_block)
        z2, i2 = rasterize_jnp(s2, SIZE, SIZE, cfg.tri_block)
        return z1, z2, i2

    kz1, kz2, ki2, ovf = jax.device_get(kernel(*setups))
    jz1, jz2, ji2 = jax.device_get(dense(*setups))
    check(not ovf, "kernel binning overflow false")
    cov1 = jz1 > ml.F32_MIN
    cov2 = ji2 >= 0
    check(np.array_equal(kz1 > ml.F32_MIN, cov1) and np.array_equal(ki2 >= 0, cov2),
          "coverage equal (both passes)")
    wd = float((ki2 != ji2).mean())
    check(wd < WINNER_BUDGET, f"winning triangle differs on {wd:.6f} of pixels")
    zok = (np.allclose(kz1[cov1], jz1[cov1], rtol=1e-5, atol=1e-4)
           and np.allclose(kz2[cov2], jz2[cov2], rtol=1e-5, atol=1e-4))
    check(zok, "z within rtol 1e-5 / atol 1e-4 (both passes)")

    # Phase 2: the reference varying spec's planes against compute_varyings
    # over the gathered attributes of the kernel's own winners.
    for pipe in ("phong", "shadow", "darboux"):
        vspec = VARYING_SPECS[pipe]
        s2 = jax.jit(lambda g: _shadow_setups(
            g, cfg, 0.37, -0.6, fr.PIPELINES[pipe].needs)[1])(geom)

        @jax.jit
        def planes_and_ref(s2):
            _, idx, varys, _ = fr._rasterize(s2, cfg, KERNEL, spec=vspec)
            got = fr._fragments_from_planes(vspec, varys, SIZE, SIZE)
            frag = fr._gather_fragments(s2, idx, fr._GATHER_KEYS[pipe], cfg)
            return idx, got, compute_varyings(frag, vspec, jnp)

        idx, got, want = jax.device_get(planes_and_ref(s2))
        cov = idx >= 0
        worst = 0.0
        ok = True
        for name, _, _ in vspec:
            a, b = np.asarray(got[name])[cov], np.asarray(want[name])[cov]
            ok &= bool(np.allclose(a, b, rtol=1e-5, atol=1e-5))
            worst = max(worst, float(np.abs(a - b).max(initial=0.0)))
        check(ok, f"{pipe} phase-2 planes vs compute_varyings: max |diff| "
                  f"{worst:.3e} (rtol 1e-5, atol 1e-5)")
    return setups, kernel, dense


# ── (e): timings ────────────────────────────────────────────────────────
def phase_timings(setups, kernel, dense):
    frames, reps = BURST_FRAMES, REPS
    print(f"-- (e) timings: median of {reps} runs, block_until_ready, "
          "compile apart", flush=True)
    rk, ck = median_ms(lambda: kernel(*setups), reps)
    rj, cj = median_ms(lambda: dense(*setups), reps)
    print(f"raster stage, both passes of shadow: kernel+binning {rk:.3f} ms "
          f"(first call {ck:.0f} ms) | rasterize_jnp {rj:.3f} ms "
          f"(first call {cj:.0f} ms)", flush=True)
    timings = {"raster_both_passes_ms": {"pallas": rk, "jnp": rj}, "burst": {}}

    model = seeded_model("diablo", 0)
    cfg = RenderConfig(width=SIZE, height=SIZE)
    scene = Scene(model, "default", cfg)
    cams = (0.37 + 0.05 * np.arange(frames)).astype(np.float32)
    ligs = (-0.6 + 0.03 * np.arange(frames)).astype(np.float32)
    for pipe in PIPELINE_NAMES:
        row = {}
        for backend in (KERNEL, "jnp"):
            tex = fr.prepack_textures(scene._textures, pipe,
                                      tile=cfg.resolve(pipe).tex_tile)
            burst = fr.make_burst_fn(pipe, cfg, backend=backend)
            ms, first = median_ms(
                lambda: burst(scene._geom, tex, jnp.asarray(cams),
                              jnp.asarray(ligs)), reps)
            row["pallas" if backend == KERNEL else backend] = {"ms_per_frame": ms / frames, "first_call_s": first / 1e3}
        timings["burst"][pipe] = row
        print(f"{pipe:10s} {frames}-frame burst: pallas "
              f"{row['pallas']['ms_per_frame']:.4f} ms/frame | jnp "
              f"{row['jnp']['ms_per_frame']:.4f} ms/frame | speedup "
              f"{row['jnp']['ms_per_frame'] / row['pallas']['ms_per_frame']:.1f}x "
              f"(first calls {row['pallas']['first_call_s']:.1f} s / "
              f"{row['jnp']['first_call_s']:.1f} s)", flush=True)
    return timings


# ── --four-cards: the sharded paths against the single-card render ──────
def phase_four_cards():
    from tiny_renderer_tpu.parallel import (
        make_row_mesh,
        render_batch_sharded,
        render_frame_sharded,
    )

    devices = jax.devices()
    check(len(devices) == 4, f"four cards visible: {devices}")
    model = seeded_model("diablo", 0)
    geom = jax.tree.map(jnp.asarray, scene_arrays(model)[0])
    tex = jax.tree.map(jnp.asarray, scene_arrays(model)[1])
    light, look_from = (jnp.asarray(v) for v in orbit(0.37, -0.6))
    cam = (light, look_from, jnp.asarray(LOOK_AT), jnp.asarray(UP))

    # Row-sharded shadow: 1024 rows / 4 cards = 256 rows, 16 tiles of 16.
    cfg = RenderConfig(width=SHARD_SIZE, height=SHARD_SIZE)
    single = jax.device_get(fr.make_frame_fn("shadow", cfg)(geom, tex, *cam))
    for replicate in (False, True):
        c = dataclasses.replace(cfg, replicate_pass1=replicate)
        mesh = make_row_mesh(devices, batch=1)
        out = render_frame_sharded(geom, tex, *cam, pipeline="shadow",
                                   config=c, mesh=mesh)
        spread = len(out["frame"].sharding.device_set)
        out = jax.device_get(out)
        same = all(np.array_equal(out[k], single[k])
                   for k in ("frame", "z", "shadow"))
        check(same and spread == 4 and not np.any(out["overflow"]),
              f"row-sharded shadow {SHARD_SIZE}x{SHARD_SIZE} over {dict(mesh.shape)} "
              f"(replicate_pass1={replicate}) bit-equal to one card; "
              f"output on {spread} cards")

    # Batch-sharded phong: 8 orbit frames over a 4-card batch.
    cfg = RenderConfig(width=SIZE, height=SIZE)
    n = 8
    cams = 0.37 + 0.2 * np.arange(n)
    ligs = -0.6 + 0.1 * np.arange(n)
    lights = np.stack([orbit(c, l)[0] for c, l in zip(cams, ligs)])
    froms = np.stack([orbit(c, l)[1] for c, l in zip(cams, ligs)])
    mesh = make_row_mesh(devices, batch=4)
    out = render_batch_sharded(geom, tex, jnp.asarray(lights), jnp.asarray(froms),
                               cam[2], cam[3], pipeline="phong", config=cfg,
                               mesh=mesh)
    spread = len(out["frame"].sharding.device_set)
    frames = np.asarray(out["frame"])
    fn = fr.make_frame_fn("phong", cfg)
    same = all(
        np.array_equal(frames[i], np.asarray(fn(
            geom, tex, jnp.asarray(lights[i]), jnp.asarray(froms[i]),
            cam[2], cam[3])["frame"]))
        for i in range(n)
    )
    check(same and spread == 4,
          f"batch-sharded phong, {n} frames over {dict(mesh.shape)} bit-equal "
          f"to one card; output on {spread} cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards")
    ap.add_argument("--out", metavar="JSON",
                    help="also write the timings and checks to this file")
    args = ap.parse_args(argv)

    enable_compile_cache()
    dev = device_summary()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: JAX finds no GPU (platform {dev['platform']!r})",
              file=sys.stderr)
        return 2
    gpu = gpu_name_power()
    print(gpu)
    print(jax.devices())
    backend = fr.resolve_backend("auto")
    print(f"backend auto -> {backend}; matmul precision "
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    check(backend == KERNEL, "auto resolves to the GPU kernel")

    record = {"gpu": gpu, "device": dev}
    if args.four_cards:
        phase_four_cards()
    else:
        cams = (0.37 + 0.4 * np.arange(8)).astype(np.float32)
        ligs = (-0.6 + 0.25 * np.arange(8)).astype(np.float32)
        phase_pipelines("diablo", cams, ligs, determinism=True)
        phase_pipelines("african_head", cams, ligs, determinism=False)
        geom = jax.tree.map(jnp.asarray, scene_arrays(seeded_model("diablo"))[0])
        cfg = RenderConfig(width=SIZE, height=SIZE).resolve("shadow")
        setups, kernel, dense = phase_raster(geom, cfg)
        record["timings"] = phase_timings(setups, kernel, dense)

    record["failures"] = FAILURES
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
