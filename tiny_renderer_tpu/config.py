"""Render configuration.

The reference hardcodes its knobs as scattered compile-time constants
(800x800 at src/main.rs:6-7, depth range 255 at src/scene/shader.rs:214,
projection coef -1/5 at shader.rs:204, shadow bias/dim at shader.rs:778-779,
occlusion constants at shader.rs:916-920, specular scale at shader.rs:521).
Here they live in one frozen dataclass so a config hashes cleanly into jit
static args.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All scene/render constants. Defaults reproduce the reference."""

    width: int = 800   # src/main.rs:6
    height: int = 800  # src/main.rs:7

    # Viewport depth range; z is mapped into [0, depth] (shader.rs:210-218).
    depth: float = 255.0
    # Perspective row coefficient: w' = 1 + coef * z with coef = -1/5
    # (shader.rs:204-208) — i.e. a projection distance of 5.
    projection_coef: float = -1.0 / 5.0

    # Shadow pipeline constants (shader.rs:776-779).
    shadow_bias: float = 1.0
    shadow_dim: float = 0.3

    # Occlusion pipeline constants (shader.rs:916-920).
    occlusion_samples: int = 16
    occlusion_step: float = 0.02
    occlusion_threshold: float = 1.0
    occlusion_depth_scale: float = 20.0

    # Specular pipeline constant (shader.rs:521).
    specular_scale: float = 0.6

    # Collapse duplicate shadow-map indices in the occlusion probe's
    # 17-sample gather before fetching (pipelines.shaders.dedup_gather) —
    # exact by construction (equal indices fetch equal values; plain-gather
    # fallback if a batch exceeds the unique cap).  Whether the
    # sort+permutation overhead beats the saved gather rows is
    # hardware-dependent; default off.
    occlusion_dedup: bool = False

    # Raster tiling (no reference equivalent — the reference scans each
    # triangle's bounding box serially, src/scene.rs:240-241).  One raster
    # kernel program per tile_h x tile_w tile; both powers of two (Triton
    # blocks).  16 x 64 gives 650 programs at 800x800.
    tile_h: int = 16
    tile_w: int = 64
    # Compact real incidences before the binning sort (T-sized per-
    # triangle prefix + monotone scatter; the sort then runs on ~8T keys
    # instead of the full candidate grid).  Default False keeps the
    # full-grid sort.  Bit-identical either way.
    binning_compact: bool = False
    # Indirect CSR records: the kernel receives the compact (T, lanes)
    # per-triangle record table plus the (cap,) sorted triangle-id list
    # and indirects rec[tris[k]] inside the loop, instead of a
    # pre-gathered (cap, lanes) CSR array.  Skips the cap-row record
    # gather in binning.  Bit-identical (tests pin it).
    csr_indirect: bool = True
    # Global cap on (tile, triangle) incidences in the CSR binning; None =
    # max(8*T, 4096) — generous vs the 2-3 incidences/triangle of the
    # reference-shaped scenes at 16 x 64 tiles.
    # Overflow (flagged) drops the tail of the incidence generation order
    # (triangle-major) deterministically.
    max_incidences: int | None = None
    # Max tile span of one triangle's bbox (rows x cols of tiles); coverage
    # beyond is dropped deterministically.  Defaults allow a 256 x 512 px
    # bbox — far beyond anything the reference scenes produce.
    max_span_y: int = 16
    max_span_x: int = 8
    # Triangle-block size for the pure-jnp raster path.  Each scan step
    # materializes (tri_block, H, W) intermediates — keep modest.
    tri_block: int = 64
    # Strip shade writeback: True packs RGB into one i32 word per pixel
    # (scatter + unpack pass); False scatters (SL, 3) u8 rows directly.
    # Bit-identical either way.
    strip_pack_words: bool = True
    # Strip-compacted shading (kernel backends): per-pixel gathers run only
    # on covered strip_len-px strips, in batches of strip_batch strips gated
    # by the covered-strip count (see frame._shade_strips).  compact_shade
    # False restores the full-screen varying-plane shade.
    compact_shade: bool = True
    strip_batch: int = 512
    # Hybrid strip shade: the raster kernel interpolates the pipeline's
    # varyings (kernel_varying_spec — texel-index / intensity / zfrag
    # planes) and the strip shade gathers those planes at STRIP granularity
    # instead of gathering per-triangle attributes per FRAGMENT
    # (_gather_fragments): n_planes (1-3) gather rows per covered strip
    # instead of strip_len, paid for with the kernel's phase-2
    # interpolation loop and the varying planes' writes.  Default off;
    # bit-identity-pinned on the CPU (tests/test_strip_planes.py: kernel
    # interpolation and compute_varyings share the exact-division
    # barycentric expressions).  Inapplicable (falls back to the attribute
    # gather) for pipelines with per-triangle "const" varyings (darboux)
    # where the const fetch is per-fragment either way.
    strip_planes: bool = False
    # Strip length in pixels.  Shorter strips track coverage tighter (fewer
    # wasted gather rows); shade math is reshaped to 128-wide rows so any SL
    # keeps the vector width.  strip_batch * strip_len must be a multiple
    # of 128.
    strip_len: int = 16

    # Shard the TRIANGLE axis of the vertex stage across the "rows" mesh
    # axis (parallel/sharding._tri_sharded_setup): each device transforms
    # its contiguous T/n slice and the per-triangle setup is all_gather'ed
    # before binning.  Row sharding otherwise replicates the whole vertex
    # stage per device — the dominant replicated work for geometry-heavy
    # scenes.  Output is bit-identical (original triangle order and
    # tie-break preserved; tests pin it); default off because the
    # reference scenes (2.5-5k triangles) are far below the crossover.
    shard_triangles: bool = False

    # Row-sharded two-pass rendering: rasterize the light-view depth pass
    # at FULL height on every device instead of per-shard + all_gather.
    # Trades the shadow map's collective (H x W x 4 bytes over "rows")
    # for n x redundant pass-1 raster work — the right side of the trade
    # depends on the interconnect vs raster cost, so it ships as a
    # measurable knob (bit-identical either way: the full-height raster IS
    # the single-device pass 1).  Ignored off the sharded paths.
    replicate_pass1: bool = False

    # Tile-swizzle the packed texture plane (and the kernel's texel-index
    # plane) into tex_tile x tex_tile blocks so uv-adjacent texels are
    # contiguous in the gather table.  A pure permutation — output is
    # bit-identical (tests pin it) — targeting the shade's gather
    # locality.  0 = row-major; a power of two that divides both texture
    # dims applies (else row-major fallback).
    tex_tile: int = 0

    # Tile-swizzle the shade's copy of the pass-1 shadow map the same way
    # (one elementwise relayout per frame; shadow_flat_indices transforms
    # the fetch indices AFTER the reference's flat saturate+clamp, so the
    # fetch is a pure permutation — bit-identical, tests pin it).  Targets
    # the shadow compare and occlusion's 17-probe loop, whose sample
    # coords cluster 2D-locally but scatter across many row-major columns
    # at oblique angles.  Same power-of-two contract as tex_tile; 0 =
    # row-major.
    shadow_tile: int = 0

    # Camera/light orbit speeds in rad/s (src/app.rs:12-13).
    camera_speed: float = 3.0
    light_speed: float = 3.0

    # Apply the per-pipeline tuned defaults at render entry
    # (resolve_for_pipeline): a tuning group is applied only when EVERY
    # field in it still sits at its class default, so explicit non-default
    # settings always win.  Set False for raw-knob experiments (sweeps
    # measuring single-knob deltas must not have the shadow baseline
    # silently become tex_tile=16).
    auto_tune: bool = True

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"invalid frame size {self.width}x{self.height}")
        for knob in ("tile_h", "tile_w"):
            v = getattr(self, knob)
            if v < 1 or (v & (v - 1)) != 0:
                raise ValueError(
                    f"{knob} must be a power of two (a raster kernel block), "
                    f"got {v}"
                )
        if self.max_span_y < 1 or self.max_span_x < 1:
            raise ValueError("binning span caps must be >= 1")
        if self.max_incidences is not None and self.max_incidences < 8:
            raise ValueError("max_incidences must be >= 8")
        if self.occlusion_samples < 1:
            raise ValueError("occlusion_samples must be >= 1")
        if self.strip_batch < 1:
            raise ValueError("strip_batch must be >= 1")
        if self.strip_len < 1 or (self.strip_batch * self.strip_len) % 128 != 0:
            raise ValueError(
                "strip_len must be >= 1 with strip_batch * strip_len a "
                f"multiple of 128, got {self.strip_batch} x {self.strip_len}"
            )
        for knob in ("tex_tile", "shadow_tile"):
            v = getattr(self, knob)
            if v < 0 or (v & (v - 1)) != 0:
                raise ValueError(
                    f"{knob} must be 0 or a power of two, got {v}"
                )

    def resolve(self, pipeline: str) -> "RenderConfig":
        """Alias for resolve_for_pipeline(self, pipeline)."""
        return resolve_for_pipeline(self, pipeline)

    @property
    def padded_width(self) -> int:
        return -(-self.width // self.tile_w) * self.tile_w

    @property
    def padded_height(self) -> int:
        return -(-self.height // self.tile_h) * self.tile_h

    @property
    def tiles_x(self) -> int:
        return self.padded_width // self.tile_w

    @property
    def tiles_y(self) -> int:
        return self.padded_height // self.tile_h

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


# Per-pipeline tuned defaults, each an atomic group.  Layout choices only:
# output is bit-identical either way (tests pin it).  They were chosen by
# measurement on earlier hardware and are not yet measured on the current
# GPU.
#
# * tex_tile=16 on the texture-sampling pipelines except specular, whose
#   three texture-class fetches pay more index arithmetic than the
#   locality saves.
# * occlusion strip_len=8 + strip_batch=1024 (constant 8192 fragments per
#   shade step): SL8's lower strip waste cuts the 17-probe loop's wasted
#   fragments.
PIPELINE_TUNED_DEFAULTS: dict = {
    "shadow": {"tex_tile": 16},
    "phong": {"tex_tile": 16},
    "default": {"tex_tile": 16},
    "normal_map": {"tex_tile": 16},
    "darboux": {"tex_tile": 16},
    "occlusion": {"strip_len": 8, "strip_batch": 1024},
}

# Resolution-conditional span-grid tuned defaults (PIPELINE-INDEPENDENT —
# the span caps size the binning stage's candidate grid, which every
# pipeline shares).  The class default allows a 256x512 px bbox; the
# worst real spans under the app's full orbit parameterization are far
# smaller, so the grid shrinks to 128x256 px at <=800 px frames and
# 160x384 px at <=1200.  Applied only while max_span_y, max_span_x AND
# projection_coef all sit at class defaults (a custom projection changes
# bbox sizes, so it opts out).  Scenes that exceed the caps keep the
# existing contract: deterministic flagged drop (Scene.overflowed).
SPAN_TUNED_BY_RESOLUTION: tuple = (
    (800, {"max_span_y": 8, "max_span_x": 4}),
    (1200, {"max_span_y": 10, "max_span_x": 6}),
)


def resolve_for_pipeline(config: RenderConfig, pipeline: str) -> RenderConfig:
    """Apply PIPELINE_TUNED_DEFAULTS for `pipeline` to fields still at
    their class defaults.  Idempotent; no-op when config.auto_tune is
    False, when the pipeline has no tuning, or when ANY field of the
    group was set explicitly (groups are atomic — e.g. occlusion's
    strip_len/strip_batch pair preserves the fragments-per-step product).

    Called at every render entry point (Scene, make_frame_fn /
    make_burst_fn, render_frame, the sharded paths, the oracle) so any
    route to a kernel sees the same resolved config.
    """
    if not config.auto_tune:
        return config
    defaults = {f.name: f.default for f in dataclasses.fields(RenderConfig)}

    def apply(cfg, group):
        if not group or any(getattr(cfg, k) != defaults[k] for k in group):
            return cfg
        return dataclasses.replace(cfg, **group)

    config = apply(config, PIPELINE_TUNED_DEFAULTS.get(pipeline))
    # Span-grid shrink: resolution-conditional and pipeline-independent;
    # only at the default projection (see SPAN_TUNED_BY_RESOLUTION).
    if config.projection_coef == defaults["projection_coef"]:
        for bound, group in SPAN_TUNED_BY_RESOLUTION:
            if max(config.width, config.height) <= bound:
                config = apply(config, group)
                break
    return config
