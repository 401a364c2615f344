"""Vertex stage + raster core tests (SURVEY.md §4.2-§4.4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.ops import mathlib as ml
from tiny_renderer_tpu.ops.binning import bin_triangles
from tiny_renderer_tpu.ops.raster_jnp import rasterize_jnp
from tiny_renderer_tpu.ops.raster_pallas import rasterize_pallas
from tiny_renderer_tpu.ops.vertex import triangle_setup
from tiny_renderer_tpu.oracle.reference_cpu import _raster_serial


def _identity_uniforms(width, height):
    """Uniforms with vpmv that maps clip space straight to raster coords."""
    cfg = RenderConfig(width=width, height=height)
    look_from = np.array([0, 0, 1], np.float32)
    u = ml.default_prepare(
        cfg, np.array([0, 0, 1], np.float32), look_from,
        np.zeros(3, np.float32), np.array([0, 1, 0], np.float32), np,
    )
    return cfg, u


def _geom_from_triangles(tris):
    """tris: (T, 3, 3) world positions; trivial uv/normals."""
    T = len(tris)
    verts = np.asarray(tris, np.float32).reshape(-1, 3)
    idx = np.arange(3 * T, dtype=np.int32).reshape(T, 3)
    return {
        "positions": verts,
        "tex_coords": np.tile(np.array([[0.25, 0.25]], np.float32), (3 * T, 1)),
        "normals": np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (3 * T, 1)),
        "pos_idx": idx,
        "tex_idx": idx,
        "normal_idx": idx,
    }


class TestVertexStage:
    def test_raster_coords_truncate_toward_zero(self):
        cfg, u = _identity_uniforms(800, 800)
        # Origin maps to exactly (399.5, 399.5) -> trunc toward zero -> 399.
        geom = _geom_from_triangles([[[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0]]])
        s = triangle_setup(geom, u, cfg, needs=(), xp=np)
        assert s["rx"][0, 0] == 399 and s["ry"][0, 0] == 399

    def test_backface_culled(self):
        cfg, u = _identity_uniforms(100, 100)
        ccw = [[[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0]]]
        cw = [[[0, 0, 0], [0, 0.1, 0], [0.1, 0, 0]]]
        s1 = triangle_setup(_geom_from_triangles(ccw), u, cfg, needs=(), xp=np)
        s2 = triangle_setup(_geom_from_triangles(cw), u, cfg, needs=(), xp=np)
        assert s1["valid"][0] and not s2["valid"][0]
        # The shadow depth pass does not cull (shader.rs:679).
        s3 = triangle_setup(_geom_from_triangles(cw), u, cfg, cull=False, needs=(), xp=np)
        assert s3["valid"][0]

    def test_degenerate_culled(self):
        cfg, u = _identity_uniforms(100, 100)
        # Collinear points -> integer cross == 0 (scene.rs:188-191).
        geom = _geom_from_triangles([[[0, 0, 0], [0.1, 0.1, 0], [0.2, 0.2, 0]]])
        s = triangle_setup(geom, u, cfg, needs=(), xp=np)
        assert not s["valid"][0]

    def test_uv_v_flip(self):
        cfg, u = _identity_uniforms(100, 100)
        geom = _geom_from_triangles([[[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0]]])
        geom["tex_coords"] = np.array([[0.2, 0.3]] * 3, np.float32)
        s = triangle_setup(geom, u, cfg, needs=(), xp=np)
        np.testing.assert_allclose(s["uv"][0, 0], [0.2, 0.7])

    def test_offscreen_bbox_invalid(self):
        cfg, u = _identity_uniforms(100, 100)
        geom = _geom_from_triangles([[[50, 50, 0], [51, 50, 0], [50, 51, 0]]])
        s = triangle_setup(geom, u, cfg, needs=(), xp=np)
        assert not s["valid"][0]


def _random_scene(n, seed, spread=0.9):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-0.3, 0.3, (n, 3, 3)).astype(np.float32)
    return _geom_from_triangles(centers + offs)


class TestRasterJnp:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_oracle_raster(self, seed):
        cfg, u = _identity_uniforms(128, 128)
        cfg = RenderConfig(width=128, height=128, tri_block=32)
        geom = _random_scene(200, seed)
        s_np = triangle_setup(geom, u, cfg, needs=(), xp=np)
        z_o, idx_o = _raster_serial(s_np, 128, 128)

        s_j = jax.jit(lambda g: triangle_setup(g, jax.tree.map(jnp.asarray, u), cfg, needs=(), xp=jnp))(
            jax.tree.map(jnp.asarray, geom)
        )
        z_j, idx_j = jax.jit(
            lambda s: rasterize_jnp(s, 128, 128, cfg.tri_block)
        )(s_j)
        idx_j = np.asarray(idx_j)
        z_j = np.asarray(z_j)
        # FMA fusion on the z interpolation can flip winners at exact-tie
        # pixels (shared edges); everything else must agree.
        mismatch = (idx_o != idx_j).mean()
        assert mismatch < 0.002, f"idx mismatch fraction {mismatch}"
        covered = idx_o >= 0
        np.testing.assert_allclose(
            z_j[covered], z_o[covered], rtol=1e-5, atol=1e-4
        )

    def test_depth_tiebreak_first_triangle_wins(self):
        """Two identical triangles: the earlier index must win everywhere
        (process_z_value rejects z <= stored, shader.rs:175)."""
        cfg, u = _identity_uniforms(64, 64)
        cfg = RenderConfig(width=64, height=64, tri_block=8)
        tri = [[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [-0.5, 0.5, 0.0]]
        geom = _geom_from_triangles([tri, tri, tri])
        s = triangle_setup(jax.tree.map(jnp.asarray, geom),
                           jax.tree.map(jnp.asarray, u), cfg, needs=(), xp=jnp)
        z, idx = rasterize_jnp(s, 64, 64, cfg.tri_block)
        idx = np.asarray(idx)
        assert (idx[idx >= 0] == 0).all()

    def test_order_permutation_invariance_modulo_ties(self):
        """Rendering is winner-based: permuting triangle submission order
        must not change output except at exact-z ties (SURVEY.md §4.3)."""
        cfg, u = _identity_uniforms(96, 96)
        cfg = RenderConfig(width=96, height=96, tri_block=16)
        geom = _random_scene(60, 5)
        s = triangle_setup(geom, u, cfg, needs=(), xp=np)
        z1, i1 = _raster_serial(s, 96, 96)

        perm = np.random.default_rng(0).permutation(60)
        geom2 = {
            "positions": geom["positions"],
            "tex_coords": geom["tex_coords"],
            "normals": geom["normals"],
            "pos_idx": geom["pos_idx"][perm],
            "tex_idx": geom["tex_idx"][perm],
            "normal_idx": geom["normal_idx"][perm],
        }
        s2 = triangle_setup(geom2, u, cfg, needs=(), xp=np)
        z2, i2 = _raster_serial(s2, 96, 96)
        # depths identical except where ties were broken differently
        tie_free = z1 == z2
        assert tie_free.mean() > 0.999
        np.testing.assert_array_equal(i1[tie_free] >= 0, i2[tie_free] >= 0)


class TestBinningAndPallas:
    def _setup(self, n=150, seed=3, W=256, H=64):
        cfg = RenderConfig(width=W, height=H, tile_h=8, tile_w=128, tri_block=32)
        _, u = _identity_uniforms(W, H)
        geom = _random_scene(n, seed, spread=0.7)
        s = jax.jit(
            lambda g: triangle_setup(g, jax.tree.map(jnp.asarray, u), cfg, needs=(), xp=jnp)
        )(jax.tree.map(jnp.asarray, geom))
        return cfg, s

    @pytest.mark.parametrize("indirect", [False, True])
    def test_binning_counts_match_bruteforce(self, indirect):
        import dataclasses

        cfg, s = self._setup()
        cfg = dataclasses.replace(cfg, csr_indirect=indirect)
        records, tris, starts, overflow = jax.jit(
            lambda s: bin_triangles(s, cfg)
        )(s)
        starts = np.asarray(starts)
        counts = starts[1:] - starts[:-1]
        sn = jax.tree.map(np.asarray, s)
        # Brute-force per-tile bbox overlap count + ascending-index invariant.
        if indirect:
            assert tris is not None
            gidx = np.asarray(records)[np.asarray(tris)][:, 12].astype(int)
        else:
            assert tris is None
            gidx = np.asarray(records)[:, 12].astype(int)
        for tile in range(cfg.num_tiles):
            ty, tx = divmod(tile, cfg.tiles_x)
            x_lo, x_hi = tx * cfg.tile_w, (tx + 1) * cfg.tile_w - 1
            y_lo, y_hi = ty * cfg.tile_h, (ty + 1) * cfg.tile_h - 1
            expect = [
                t for t in range(sn["valid"].shape[0])
                if sn["valid"][t]
                and sn["x0"][t] <= x_hi and sn["x1"][t] >= x_lo
                and sn["y0"][t] <= y_hi and sn["y1"][t] >= y_lo
            ]
            got = list(gidx[starts[tile] : starts[tile + 1]])
            assert got == expect, f"tile {tile}"
        assert not bool(overflow)

    @pytest.mark.parametrize("W,H", [(256, 64), (200, 72)])
    def test_pallas_interpret_matches_jnp(self, W, H):
        """The kernel (Pallas interpreter) against the dense jnp raster,
        at a tile-multiple frame and at one whose width and height are not
        (200 = 128 + 72 px, 72 = 9 * 8 rows): the kernel writes whole
        tiles and the caller crops."""
        cfg, s = self._setup(W=W, H=H)
        z_j, idx_j = jax.jit(
            lambda s: rasterize_jnp(s, cfg.height, cfg.width, cfg.tri_block)
        )(s)
        records, tris, counts, _ = jax.jit(lambda s: bin_triangles(s, cfg))(s)
        z_p, idx_p, _ = rasterize_pallas(
            records, counts, None, tris,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x,
            interpret=True,
        )
        assert z_p.shape == (cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w)
        z_p = np.asarray(z_p)[: cfg.height, : cfg.width]
        idx_p = np.asarray(idx_p)[: cfg.height, : cfg.width]
        idx_j = np.asarray(idx_j)
        z_j = np.asarray(z_j)
        # The pallas kernel interpolates z via reciprocal-multiply; 1-ulp
        # differences can flip exact ties. Coverage must agree exactly.
        np.testing.assert_array_equal(idx_p >= 0, idx_j >= 0)
        mismatch = (idx_p != idx_j).mean()
        assert mismatch < 0.002, f"winner mismatch {mismatch}"
        covered = idx_j >= 0
        np.testing.assert_allclose(z_p[covered], z_j[covered], rtol=1e-5, atol=1e-4)

    def test_tile_shape_invariant(self):
        """The tile shape only partitions the screen: each pixel sees the
        same triangles in the same ascending order under any tiling, so
        winners and z are bit-identical across tile shapes."""
        import dataclasses

        cfg, s = self._setup()

        def run(th, tw):
            c = dataclasses.replace(cfg, tile_h=th, tile_w=tw,
                                    max_span_y=64 // th, max_span_x=256 // tw)
            records, tris, counts, ovf = jax.jit(
                lambda s: bin_triangles(s, c))(s)
            assert not bool(ovf)
            z, idx, _ = rasterize_pallas(
                records, counts, None, tris,
                tile_h=th, tile_w=tw, tiles_y=c.tiles_y, tiles_x=c.tiles_x,
                interpret=True,
            )
            return np.asarray(z), np.asarray(idx)

        z0, idx0 = run(8, 128)
        for th, tw in ((16, 64), (32, 32), (4, 256)):
            zg, idxg = run(th, tw)
            np.testing.assert_array_equal(idxg, idx0)
            np.testing.assert_array_equal(zg, z0)

    def test_emit_z_false_same_winners(self):
        """emit_z=False drops the z target only: idx identical, z not
        emitted."""
        cfg, s = self._setup()
        records, tris, counts, _ = jax.jit(lambda s: bin_triangles(s, cfg))(s)
        z, idx, _ = rasterize_pallas(
            records, counts, None, tris,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x,
            interpret=True,
        )
        z2, idx2, _ = rasterize_pallas(
            records, counts, None, tris,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x,
            emit_z=False, interpret=True,
        )
        assert z2 is None
        np.testing.assert_array_equal(np.asarray(idx2), np.asarray(idx))

    def test_indirect_matches_gathered(self):
        """csr_indirect is a pure layout change: z/idx bit-identical."""
        import dataclasses

        cfg, s = self._setup()
        outs = {}
        for indirect in (False, True):
            c = dataclasses.replace(cfg, csr_indirect=indirect)
            records, tris, counts, _ = jax.jit(
                lambda s, c=c: bin_triangles(s, c)
            )(s)
            z, idx, _ = rasterize_pallas(
                records, counts, None, tris,
                tile_h=c.tile_h, tile_w=c.tile_w,
                tiles_y=c.tiles_y, tiles_x=c.tiles_x,
                interpret=True,
            )
            outs[indirect] = (np.asarray(z), np.asarray(idx))
        np.testing.assert_array_equal(outs[False][0], outs[True][0])
        np.testing.assert_array_equal(outs[False][1], outs[True][1])

    def test_row_tile_offset_renders_a_window(self):
        """Binning and rasterizing a window of tile rows with
        row_tile_offset (the row-sharded path) gives exactly those rows of
        the full-frame raster."""
        import dataclasses

        cfg, s = self._setup()
        full_rec, full_tris, full_st, _ = jax.jit(
            lambda s: bin_triangles(s, cfg))(s)
        _, idx_full, _ = rasterize_pallas(
            full_rec, full_st, None, full_tris,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w,
            tiles_y=cfg.tiles_y, tiles_x=cfg.tiles_x, emit_z=False,
            interpret=True,
        )
        win = dataclasses.replace(cfg, height=2 * cfg.tile_h)
        for off in (0, 3, cfg.tiles_y - 2):
            rec, tris, st, _ = jax.jit(
                lambda s, o=off: bin_triangles(s, win, row_tile_offset=o))(s)
            _, idx_w, _ = rasterize_pallas(
                rec, st, jnp.full((1,), off, jnp.int32), tris,
                tile_h=win.tile_h, tile_w=win.tile_w,
                tiles_y=win.tiles_y, tiles_x=win.tiles_x, emit_z=False,
                interpret=True,
            )
            rows = slice(off * cfg.tile_h, (off + 2) * cfg.tile_h)
            np.testing.assert_array_equal(
                np.asarray(idx_w), np.asarray(idx_full)[rows])


class TestOverflowFlags:
    def test_span_clamp_flag(self):
        """A triangle covering more tiles than max_span_* sets the overflow
        flag (coverage beyond the cap is dropped deterministically)."""
        cfg = RenderConfig(width=512, height=256, tile_h=8, tile_w=128, max_span_y=2, max_span_x=1)
        _, u = _identity_uniforms(512, 256)
        # One huge triangle covering most of the screen.
        geom = _geom_from_triangles([[[-2, -2, 0], [2, -2, 0], [0, 2, 0]]])
        s = jax.jit(lambda g: triangle_setup(g, jax.tree.map(jnp.asarray, u),
                                             cfg, needs=(), xp=jnp))(
            jax.tree.map(jnp.asarray, geom))
        _, _, _, overflow = jax.jit(lambda s: bin_triangles(s, cfg))(s)
        assert bool(overflow)

    @pytest.mark.slow  # interpret-mode sweep over span-cap grids (~35 s)
    def test_span_caps_output_invariant_when_not_clamping(self):
        """Tightening max_span_y/x is a pure sort-grid shrink: as long as no
        triangle's real span exceeds the caps (overflow False), the frame is
        bit-identical.  This pins the mechanism behind tightening the span
        defaults to the workload's worst spans (SPAN_TUNED_BY_RESOLUTION)."""
        import dataclasses

        from tiny_renderer_tpu.models import seeded_model
        from tiny_renderer_tpu.pipelines.frame import make_frame_fn

        model = seeded_model("diablo")
        m = model.mesh
        geom = {k: jnp.asarray(getattr(m, k)) for k in
                ("positions", "tex_coords", "normals", "pos_idx", "tex_idx",
                 "normal_idx")}
        tex = {"texture": jnp.asarray(model.texture)}
        # 160x160, tile 16x64: spans scale with resolution (worst bbox at
        # 800 is under 80x100 px -> ~16x20 px here), so (2, 2) cannot clamp.
        base = RenderConfig(width=160, height=160, strip_batch=32)
        tight = dataclasses.replace(base, max_span_y=2, max_span_x=2)
        la = jnp.zeros(3, jnp.float32)
        up = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)
        for ang in (0.37, 1.9, 4.4):
            cam = jnp.asarray(
                [np.sin(ang), 0.0, np.cos(ang)], jnp.float32)
            lig = jnp.asarray(
                [np.sin(ang - 2.2), 0.0, np.cos(ang - 2.2)], jnp.float32)
            args = (geom, tex, lig, cam, la, up)
            for backend in ("jnp", "pallas_interpret"):
                a = make_frame_fn("shadow", base, backend=backend)(*args)
                b = make_frame_fn("shadow", tight, backend=backend)(*args)
                assert not bool(b["overflow"])
                np.testing.assert_array_equal(
                    np.asarray(a["frame"]), np.asarray(b["frame"]))

    def test_scene_overflow_property(self, head_model):
        from tiny_renderer_tpu import Scene
        cfg = RenderConfig(width=96, height=96, tri_block=32)
        scene = Scene(head_model, "default", cfg, backend="jnp")
        scene.render()
        assert scene.overflowed is False


class TestConfigValidation:
    @pytest.mark.parametrize("knob,value", [
        ("tile_w", 100), ("tile_w", 0), ("tile_h", 24), ("tile_h", -8),
    ])
    def test_bad_tile_w(self, knob, value):
        """Tiles are kernel blocks: each side must be a power of two."""
        with pytest.raises(ValueError, match=f"{knob} must be a power of two"):
            RenderConfig(**{knob: value})

    @pytest.mark.parametrize("th,tw", [(1, 1), (4, 256), (16, 64), (64, 32)])
    def test_power_of_two_tiles_accepted(self, th, tw):
        cfg = RenderConfig(width=800, height=800, tile_h=th, tile_w=tw)
        assert cfg.tiles_x * tw >= 800 and cfg.tiles_y * th >= 800

    def test_bad_size(self):
        with pytest.raises(ValueError, match="frame size"):
            RenderConfig(width=0)


class TestIncidenceCapOverflow:
    def test_cap_overflow_flagged_and_deterministic(self, head_model):
        """A tiny global incidence cap drops coverage deterministically
        (generation order) and raises the overflow flag; two renders are
        bit-identical."""
        from tiny_renderer_tpu import Scene
        from tiny_renderer_tpu.config import RenderConfig as RC

        cfg = RC(width=96, height=96, tile_h=8, max_incidences=64)
        scene = Scene(head_model, "default", cfg, backend="pallas_interpret")
        scene.render()
        f1 = scene.get_frame_buffer().copy()
        assert scene.overflowed is True
        scene.render()
        f2 = scene.get_frame_buffer()
        np.testing.assert_array_equal(f1, f2)

    def test_no_overflow_has_full_coverage_parity(self, head_model):
        """The same scene without the cap renders more coverage (the cap
        really dropped something) and does not flag."""
        from tiny_renderer_tpu import Scene
        from tiny_renderer_tpu.config import RenderConfig as RC

        capped = Scene(
            head_model, "default",
            RC(width=96, height=96, tile_h=8, max_incidences=64),
            backend="pallas_interpret",
        )
        full = Scene(
            head_model, "default",
            RC(width=96, height=96, tile_h=8),
            backend="pallas_interpret",
        )
        capped.render()
        zc = (capped.get_z_buffer() > 0).sum()
        full.render()
        zf = (full.get_z_buffer() > 0).sum()
        assert full.overflowed is False
        assert zf > zc  # the cap really dropped coverage
