"""Jit-compiled frame functions: the entire render as one device program.

The reference renders a frame as serial passes -> polygons -> pixels with
host-side closures (src/scene.rs:199-267).  Here a frame is ONE jit-compiled
function per (pipeline, config): uniforms -> batched vertex stage -> binned
raster (with in-kernel varying interpolation on the Pallas path) -> shading,
with two-pass pipelines (shadow, occlusion) running both raster passes
inside the same program — no host round-trips; the only host<->device
traffic is camera/light vectors in, u8 frame out (SURVEY.md §5.8).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..ops import mathlib as ml
from ..ops.binning import bin_triangles, compact_scatter
from ..ops.raster_jnp import rasterize_jnp
from ..ops.raster_pallas import rasterize_pallas
from ..ops.vertex import triangle_setup
from . import shaders
from .shaders import VARYING_SPECS, compute_varyings, kernel_varying_spec


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Declarative description of one pipeline (reference shader.rs:100-109)."""

    name: str
    needs: tuple  # vertex-stage varyings for the shading pass
    shade: object  # shading function for the final pass
    two_pass: bool = False  # shadow-buffer depth pre-pass (shader.rs:668-963)


PIPELINES = {
    "default": PipelineSpec("default", ("face_intensity",), shaders.shade_default),
    "phong": PipelineSpec("phong", ("vertex_intensity",), shaders.shade_phong),
    "normal_map": PipelineSpec("normal_map", (), shaders.shade_normal_map),
    "specular": PipelineSpec("specular", (), shaders.shade_specular),
    "darboux": PipelineSpec("darboux", ("darboux",), shaders.shade_darboux),
    "shadow": PipelineSpec(
        "shadow", ("vertex_intensity",), shaders.shade_shadow, two_pass=True
    ),
    "occlusion": PipelineSpec("occlusion", (), shaders.shade_occlusion, two_pass=True),
}

# Texture maps each pipeline samples (for word-packing, shaders.pack_textures).
_PIPELINE_MAPS = {
    "default": ("texture",),
    "phong": ("texture",),
    "normal_map": ("texture", "normal_map"),
    "specular": ("texture", "normal_map", "specular_map"),
    "darboux": ("texture", "normal_map_tangent"),
    "shadow": ("texture",),
    "occlusion": (),
}
# shaders._PIPELINE_MAPS_FOR_SPEC is a copy of this table (import-cycle
# avoidance); the kernel varying spec's texel-index plane dimensions must
# agree with the maps pack_textures packs.
assert _PIPELINE_MAPS == shaders._PIPELINE_MAPS_FOR_SPEC

# Vertex-attribute keys the reference (gather) path fetches per fragment to
# feed compute_varyings.
_GATHER_KEYS = {
    "default": ("uv", "intensity"),
    "phong": ("uv", "intensity"),
    "normal_map": ("uv",),
    "specular": ("uv",),
    "darboux": ("uv", "t_norm", "row0n", "row1n", "du", "dv"),
    "shadow": ("uv", "intensity", "zv"),
    "occlusion": ("zv",),
}

# The varying vocabulary custom pipelines may compose from (everything
# compute_varyings + the Pallas kernel's record builder understand):
# varying name -> (allowed modes, triangle_setup gather key).
_VARYING_VOCAB = {
    "uv": (("interp",), "uv", 2),
    "intensity": (("interp",), "intensity", 1),
    "local_z": (("interp",), "t_norm", 3),
    "zfrag": (("zfrag",), "zv", 1),
    "row0": (("const",), "row0n", 3),
    "row1": (("const",), "row1n", 3),
    "du": (("const",), "du", 2),
    "dv": (("const",), "dv", 2),
}
_VALID_NEEDS = ("face_intensity", "vertex_intensity", "darboux")


# Per-name registration generation.  The jitted entry points
# (render_frame_jit / render_burst / the sharded jits) treat the pipeline
# name as a static string; replacing or removing a registration under the
# same name would otherwise keep serving renders traced against the OLD
# shade function.  Bumping a generation that rides in the static jit key
# invalidates exactly that name's executables — stale entries keyed on
# old generations are simply never hit again — instead of clearing every
# pipeline's cache, which forced multi-second recompiles of every cached
# (pipeline, config, backend) in the process (a serving latency spike on
# shader swap, and recompile storms across the test suite).
_REGISTRY_GEN = {}


def registry_generation(name):
    """Current registration generation for a pipeline name (static jit key)."""
    return _REGISTRY_GEN.get(name, 0)


def _bump_registry_generation(name):
    _REGISTRY_GEN[name] = _REGISTRY_GEN.get(name, 0) + 1


def register_pipeline(name, shade, *, varying_spec, maps=(), needs=(),
                      two_pass=False, overwrite=False):
    """Register a custom shader pipeline under `name`.

    Once registered, the name works everywhere a built-in does: Scene /
    render_frame / render_burst on every backend (jnp, pallas,
    pallas_interpret), the sharded multi-device paths, AND the CPU oracle
    (render_oracle shares these tables), so a custom pipeline gets golden
    parity testing for free.  Registration composes the existing
    vertex-stage outputs, plus any number of USER vertex attributes:
    a varying named "attr:<x>" declares a (T, 3, comps) float32 array the
    caller supplies under that exact key in the geometry dict (per
    triangle corner, like pre-expanded uv), interpolated with the same
    barycentric accumulation order as uv.

    Args:
      name: pipeline name (key for Scene(model, name), -s on the CLI when
        registered before build_arg_parser()).
      shade: fragment shading function with the shared signature
        ``shade(frag, uniforms, textures, config, xp) -> (..., 3) u8``
        — xp-agnostic (jnp on device, np in the oracle).  `frag` carries
        the interpolated varyings named in varying_spec plus "x"/"y"
        pixel coords (and "shadow_buffer" when two_pass; fetch via
        shaders._shadow_fetch with shaders.plane_tile_effective).  Use
        shaders.sample_frag for texture reads so the packed/swizzled
        fast paths apply.
      varying_spec: tuple of (name, components, mode) drawn from the
        vocabulary: uv(2, interp), intensity(1, interp),
        local_z(3, interp), zfrag(1, zfrag), row0/row1(3, const),
        du/dv(2, const) — or "attr:<x>"(1-8, interp) for a custom
        per-vertex attribute supplied as geom["attr:<x>"] with shape
        (num_triangles, 3, components).
      maps: texture-map names the shade samples (word-packed together;
        any keys present in the textures dict).
      needs: vertex-stage extras, subset of {face_intensity,
        vertex_intensity, darboux}.
      two_pass: render the light-view depth pre-pass first (the shade
        then receives "shadow_buffer" and shadow_pass_2 uniforms).
      overwrite: allow replacing an existing registration.

    Returns the PipelineSpec.  Raises ValueError on unknown varyings,
    modes, or needs — a typo silently rendering garbage would be much
    worse than an error.
    """
    if name in PIPELINES and not overwrite:
        raise ValueError(
            f"pipeline {name!r} already registered (pass overwrite=True "
            "to replace it)"
        )
    gather = []
    for entry in varying_spec:
        vname, comps, mode = entry
        if vname.startswith("attr:"):
            # Custom per-vertex attribute: the caller supplies a
            # (T, 3, comps) float32 array under this exact key in the
            # geometry dict; it is interpolated like uv.  The reference's
            # closed 7-name dispatch (shader.rs:100-109) has no analog —
            # this is a beyond-reference extension point.
            if mode != "interp":
                raise ValueError(
                    f"custom vertex attribute {vname!r} supports mode "
                    f"'interp', got {mode!r}"
                )
            if not isinstance(comps, int) or not 1 <= comps <= 8:
                raise ValueError(
                    f"custom vertex attribute {vname!r} must have 1-8 "
                    f"components, got {comps!r}"
                )
            if vname not in gather:
                gather.append(vname)
            continue
        if vname not in _VARYING_VOCAB:
            raise ValueError(
                f"unknown varying {vname!r}; available: "
                f"{', '.join(sorted(_VARYING_VOCAB))}, or 'attr:<name>' "
                "for a custom per-vertex attribute"
            )
        modes, key, want_comps = _VARYING_VOCAB[vname]
        if mode not in modes:
            raise ValueError(
                f"varying {vname!r} supports mode {modes[0]!r}, got {mode!r}"
            )
        if comps != want_comps:
            # A wrong count would misalign every later varying's plane /
            # record lanes and render garbage — reject it here.
            raise ValueError(
                f"varying {vname!r} has {want_comps} components, "
                f"got {comps}"
            )
        if key not in gather:
            gather.append(key)
    for n in needs:
        if n not in _VALID_NEEDS:
            raise ValueError(
                f"unknown vertex-stage need {n!r}; valid: {_VALID_NEEDS}"
            )
    # Setup keys only exist when the producing vertex-stage need is on —
    # fail here rather than as a KeyError deep inside jit tracing.
    if "intensity" in gather and not (
        "face_intensity" in needs or "vertex_intensity" in needs
    ):
        raise ValueError(
            "the 'intensity' varying requires needs to include "
            "'face_intensity' or 'vertex_intensity'"
        )
    if any(k in gather for k in ("t_norm", "row0n", "row1n", "du", "dv")) \
            and "darboux" not in needs:
        raise ValueError(
            "local_z/row0/row1/du/dv varyings require needs to include "
            "'darboux'"
        )
    spec = PipelineSpec(name, tuple(needs), shade, two_pass=two_pass)
    if name in PIPELINES:
        # Replacing a live registration: executables traced against the
        # old shade must never be served again under this name.
        _bump_registry_generation(name)
    PIPELINES[name] = spec
    VARYING_SPECS[name] = tuple(varying_spec)
    _PIPELINE_MAPS[name] = tuple(maps)
    shaders._PIPELINE_MAPS_FOR_SPEC[name] = tuple(maps)
    _GATHER_KEYS[name] = tuple(gather)
    return spec


def unregister_pipeline(name):
    """Remove a pipeline registered with register_pipeline (built-ins
    refuse: the reference's 7 names are API surface)."""
    if name in _BUILTIN_PIPELINES:
        raise ValueError(f"cannot unregister built-in pipeline {name!r}")
    if name in PIPELINES:
        # A later re-registration of this name must not hit executables
        # traced against the removed shade.
        _bump_registry_generation(name)
    for table in (PIPELINES, VARYING_SPECS, _PIPELINE_MAPS,
                  shaders._PIPELINE_MAPS_FOR_SPEC, _GATHER_KEYS):
        table.pop(name, None)


_BUILTIN_PIPELINES = frozenset(PIPELINES)


BACKENDS = ("pallas", "pallas_interpret", "jnp")


def resolve_backend(backend="auto"):
    """The raster backend to use, chosen from the platform for "auto".

    "auto" maps the platform JAX runs on to its raster: "gpu" -> "pallas"
    (the binned Triton kernel), "cpu" -> "jnp" (the dense reference
    raster).  Any other platform has no raster and raises.  "pallas"
    compiles only for a GPU and raises elsewhere; "pallas_interpret" runs
    the same kernel in the Pallas interpreter and is never chosen
    automatically.
    """
    platform = jax.default_backend()
    if backend == "auto":
        if platform == "gpu":
            return "pallas"
        if platform == "cpu":
            return "jnp"
        raise ValueError(f"no raster backend for platform {platform!r}")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown raster backend {backend!r}; expected 'auto' or one of "
            f"{BACKENDS}"
        )
    if backend == "pallas" and platform != "gpu":
        raise ValueError(
            f"backend 'pallas' compiles for a GPU, but JAX runs on "
            f"{platform!r}; use 'jnp', or 'pallas_interpret' to run the "
            "kernel in the Pallas interpreter"
        )
    return backend


def _rasterize(setup, config, backend, spec=(), emit_idx=True, emit_z=True,
               rows=None, y0=None):
    """Backend dispatch.

    Returns (z, idx, varys, overflowed) cropped to (rows, width).  rows is
    config.height unless a row-sharded caller rasterizes the slab of that
    many rows starting at global row y0 (a traced scalar; a whole tile row
    on the kernel backends).  varys is None on the jnp backend (the gather
    path computes varyings).  The crops are lazy slices that XLA fuses into
    consumers — keeping shading at the unpadded pixel count.  emit_z=False
    (kernel backends) skips the z target's write when the caller consumes
    idx only.
    """
    H = config.height if rows is None else rows
    W = config.width
    if backend == "jnp":
        z, idx = rasterize_jnp(
            setup, H, W, config.tri_block, y_offset=0 if y0 is None else y0
        )
        return z, idx, None, jnp.asarray(False)
    local = config if rows is None else dataclasses.replace(config, height=rows)
    if y0 is None:
        records, tris, starts, overflowed = bin_triangles(setup, local, spec)
        off = None
    else:
        row_tile = y0 // config.tile_h
        records, tris, starts, overflowed = bin_triangles(
            setup, local, spec, row_tile_offset=row_tile
        )
        off = jnp.reshape(row_tile, (1,)).astype(jnp.int32)
    z, idx, varys = rasterize_pallas(
        records,
        starts,
        off,
        tris,
        tile_h=local.tile_h,
        tile_w=local.tile_w,
        tiles_y=local.tiles_y,
        tiles_x=local.tiles_x,
        spec=spec,
        emit_idx=emit_idx,
        emit_z=emit_z,
        interpret=(backend == "pallas_interpret"),
    )
    return (
        z[:H, :W] if z is not None else None,
        idx[:H, :W] if idx is not None else None,
        varys[:, :H, :W] if varys is not None else None,
        overflowed,
    )


def _pixel_coords(H, W, y_offset=0):
    px = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    py = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) + y_offset
    return px, py


def _unpack_planes(spec, varys):
    """Varying dict from a plane-major array: walk (name, comps, mode),
    scalar planes pass through, vector planes get the component axis moved
    last.  varys is (n_planes, ...) — full frames and strip batches alike."""
    out = {}
    p = 0
    for name, comps, _mode in spec:
        if comps == 1:
            out[name] = varys[p]
        else:
            out[name] = jnp.moveaxis(varys[p : p + comps], 0, -1)
        p += comps
    return out


def _fragments_from_planes(spec, varys, H, W, y_offset=0):
    """Fragment dict from the kernel's interpolated varying planes."""
    frag = _unpack_planes(spec, varys)
    frag["x"], frag["y"] = _pixel_coords(H, W, y_offset)
    return frag


def _gather_fragments(setup, idx, keys, config, y_offset=0, pixel_coords=None):
    """Reference-path fragment inputs: per-pixel gather of vertex attributes.

    All attributes are packed into ONE (T, L) f32 matrix and fetched with a
    single per-pixel gather (one row per pixel), then barycentric
    coordinates are recomputed with the reference's exact f32 expression
    (scene.rs:192-196).  The edge coefficients are integers < 2^24, exact in
    f32.  Used by the jnp backend, the sharded path, and the strip-compacted
    shade (idx of any shape + explicit pixel coords); the NumPy oracle
    mirrors this in oracle/reference_cpu.py.
    """
    shape = idx.shape
    safe = jnp.maximum(idx, 0).astype(jnp.int32)

    cols = [
        setup["a1"].astype(jnp.float32)[:, None],
        setup["b1"].astype(jnp.float32)[:, None],
        setup["c1"].astype(jnp.float32)[:, None],
        setup["a2"].astype(jnp.float32)[:, None],
        setup["b2"].astype(jnp.float32)[:, None],
        setup["c2"].astype(jnp.float32)[:, None],
        setup["cz"].astype(jnp.float32)[:, None],
    ]
    layout = {}
    pos = 7
    for k in keys:
        if k not in setup:
            # Only reachable for custom "attr:" varyings: the built-in
            # keys always exist when their needs are validated.
            raise ValueError(
                f"pipeline requires the custom vertex attribute {k!r}: "
                f"supply geom[{k!r}] with shape (num_triangles, 3, k)"
            )
        a = setup[k]
        flat = a.reshape(a.shape[0], -1).astype(jnp.float32)
        layout[k] = (pos, flat.shape[1], a.shape[1:])
        pos += flat.shape[1]
        cols.append(flat)
    packed = jnp.concatenate(cols, axis=1)  # (T, L)

    g = packed[safe]  # (*shape, L) — the one gather
    frag = {}
    for k, (start, width, kshape) in layout.items():
        frag[k] = g[..., start : start + width].reshape(*shape, *kshape)

    if pixel_coords is None:
        px, py = _pixel_coords(*shape, y_offset)
    else:
        px, py = pixel_coords
    pxf = px.astype(jnp.float32)
    pyf = py.astype(jnp.float32)
    cxf = (g[..., 0] * pxf + g[..., 1] * pyf) + g[..., 2]
    cyf = (g[..., 3] * pxf + g[..., 4] * pyf) + g[..., 5]
    czf = g[..., 6]
    frag["bar"] = jnp.stack(
        [jnp.float32(1.0) - (cxf + cyf) / czf, cxf / czf, cyf / czf], axis=-1
    )
    frag["x"] = px
    frag["y"] = py
    return frag


def _planes_spec(pipeline, textures, config, backend):
    """Kernel varying spec for the strip_planes hybrid, or None when it
    does not apply.

    Pipelines with per-triangle "const" varyings (darboux) are excluded:
    their constants would still need a per-fragment gather, so emitting
    the interpolated planes buys nothing over the packed attribute gather.
    """
    if backend == "jnp" or not config.strip_planes:
        return None
    # Per-triangle "const" varyings (darboux) would still need a
    # per-fragment gather; custom "attr:" planes have no kernel record
    # lanes — both fall back to the packed attribute gather.
    if any(mode == "const" or name.startswith("attr:")
           for (name, _, mode) in VARYING_SPECS[pipeline]):
        return None
    return kernel_varying_spec(pipeline, textures, tile=config.tex_tile)


def _shade_jnp_path(setup, idx, pipeline, config, y_offset=0):
    """Gather + compute_varyings for the non-Pallas backends."""
    frag = _gather_fragments(setup, idx, _GATHER_KEYS[pipeline], config, y_offset)
    varys = compute_varyings(frag, VARYING_SPECS[pipeline], jnp)
    varys["x"] = frag["x"]
    varys["y"] = frag["y"]
    return varys


def render_frame(
    geom,
    textures,
    light_direction,
    look_from,
    look_at,
    up,
    *,
    pipeline,
    config,
    backend,
    needs_z=True,
):
    """Render one frame. Returns dict(frame u8 (H,W,3), z f32, shadow f32).

    Row 0 is raster y=0 (bottom of the world — the reference's frame_buffer
    layout before the presentation flip, scene.rs:92-97).  needs_z=False
    (static) lets the kernel backends skip the camera pass's z-target HBM
    write when the caller only consumes the frame (e.g. burst rendering);
    the returned "z" is then None.
    """
    config = config.resolve(pipeline)
    backend = resolve_backend(backend)
    spec = PIPELINES[pipeline]
    vspec = VARYING_SPECS[pipeline]
    H, W = config.height, config.width

    if geom["pos_idx"].shape[0] == 0:  # empty scene: clear buffers only
        return {
            "frame": jnp.zeros((H, W, 3), jnp.uint8),
            "z": jnp.full((H, W), ml.F32_MIN, jnp.float32) if needs_z else None,
            "shadow": jnp.full((H, W), ml.F32_MIN, jnp.float32),
            "overflow": jnp.asarray(False),
        }

    compact = backend != "jnp" and config.compact_shade
    pspec = _planes_spec(pipeline, textures, config, backend) if compact else None
    if spec.two_pass:
        u1 = ml.shadow_pass_1_prepare(config, light_direction, look_at, up, jnp)
        setup1 = triangle_setup(
            geom, u1, config, matrix_key="shadow_matrix", cull=False, needs=(), xp=jnp
        )
        uniforms = ml.shadow_pass_2_prepare(
            config, light_direction, look_from, look_at, up, jnp
        )
        uniforms["shadow_matrix"] = u1["shadow_matrix"]
    else:
        uniforms = ml.default_prepare(
            config, light_direction, look_from, look_at, up, jnp
        )
        setup1 = None
        ovf1 = jnp.asarray(False)

    setup = triangle_setup(geom, uniforms, config, needs=spec.needs, xp=jnp)

    if spec.two_pass:
        shadow_z, _, _, ovf1 = _rasterize(
            setup1, config, backend, spec=(), emit_idx=False
        )
        ovf1 = ovf1 | setup1["coord_overflow"]
    else:
        shadow_z = jnp.full((H, W), ml.F32_MIN, jnp.float32)
    # Strip-compacted shading (default on the kernel backends): the raster
    # kernel emits idx only and the gather-path shade runs on covered
    # strips — unless strip_planes, where the kernel also interpolates the
    # varying planes the strip shade will consume.  Bit-identical to the
    # varying-plane shade on the same raster
    # (tests/test_pipelines_parity.py); vs the jnp backend only the usual
    # raster tie-flip budget applies.
    if compact:
        kspec = pspec or ()
    else:
        kspec = (
            kernel_varying_spec(pipeline, textures, tile=config.tex_tile)
            if backend != "jnp"
            else vspec
        )
    # The camera pass's z target is consumed only by callers (debug
    # views, parity checks) — shading reads idx / varying planes.
    z, idx, varys, ovf2 = _rasterize(
        setup, config, backend, spec=kspec, emit_z=needs_z
    )
    ovf2 = ovf2 | setup["coord_overflow"]

    # The shade consumes the shadow map through its own (possibly
    # tile-swizzled, config.shadow_tile) copy; callers see row-major.
    shadow_shade = _shadow_for_shade(shadow_z, spec, config)

    if compact:
        if _pk_needed(textures, pipeline, config.tex_tile):
            textures = shaders.pack_textures(
                textures, _PIPELINE_MAPS[pipeline], jnp, tile=config.tex_tile
            )
        frame = _shade_strips(
            setup, idx, pipeline, uniforms, textures, config, shadow_shade,
            planes=varys, planes_spec=kspec,
        )
        return {"frame": frame, "z": z, "shadow": shadow_z, "overflow": ovf1 | ovf2}

    if varys is None:
        frag = _shade_jnp_path(setup, idx, pipeline, config)
    else:
        frag = _fragments_from_planes(kspec, varys, H, W)
        _add_const_gather(frag, kspec, vspec, setup, idx)
    if spec.two_pass:
        frag["shadow_buffer"] = shadow_shade
    if _pk_needed(textures, pipeline, config.tex_tile):
        textures = shaders.pack_textures(
            textures, _PIPELINE_MAPS[pipeline], jnp, tile=config.tex_tile
        )
    colors = spec.shade(frag, uniforms, textures, config, jnp)

    covered = (idx >= 0)[..., None]
    frame = jnp.where(covered, colors, jnp.uint8(0))
    # overflow: a binning coverage cap was hit (raise max_incidences /
    # max_span_* if this fires; SURVEY.md §5.3) or triangles exceeded the
    # int32 exactness envelope (vertex.EXACT_COORD_MAX) and were dropped.
    return {"frame": frame, "z": z, "shadow": shadow_z, "overflow": ovf1 | ovf2}


def _add_const_gather(frag, kspec, vspec, setup, idx):
    """Per-triangle constants dropped from the kernel spec (darboux rows/uv
    deltas) are fetched with one small per-pixel gather of a packed table —
    cheaper than broadcasting each as a full plane."""
    dropped = [e for e in vspec if e[2] == "const" and e not in kspec]
    if not dropped:
        return
    key_of = {"row0": "row0n", "row1": "row1n", "du": "du", "dv": "dv"}
    table = jnp.concatenate([setup[key_of[n]] for (n, _, _) in dropped], axis=1)
    g = table[jnp.maximum(idx, 0).astype(jnp.int32)]  # (H, W, total)
    pos = 0
    for name, comps, _ in dropped:
        frag[name] = g[..., pos : pos + comps]
        pos += comps


def _shadow_for_shade(shadow_z, spec, config):
    """The shadow plane as the shade fetches consume it: tile-swizzled
    when config.shadow_tile applies (the fetch indices are transformed to
    match in shadow_flat_indices — a pure permutation, bit-identical
    output), row-major otherwise.  One relayout per frame, outside the
    strip loop."""
    if not spec.two_pass:
        return shadow_z
    t = shaders.plane_tile_effective(config, shadow_z.shape)
    if not t:
        return shadow_z
    return shaders.swizzle_plane(shadow_z, t, jnp)


def _shade_strips(setup, idx, pipeline, uniforms, textures, config, shadow_z,
                  y_offset=0, planes=None, planes_spec=()):
    """Strip-compacted shading: the gather-bound stage runs only on covered
    config.strip_len-pixel strips.

    idx may be a row slab of the full frame (the sharded path): y_offset is
    the slab's global first row, so pixel coords fed to the shade functions
    (and their shadow-space transforms) stay global while the scatter
    targets stay slab-local.

    The shade's per-pixel gathers (texture words, shadow-map fetches) run
    only where there is coverage, and typical scenes cover ~20% of pixels
    (~22% of 16-px strips).  Strip-level compaction needs only a strip
    mask + cumsum and wide-row gathers/scatters; per-pixel compaction
    would add a per-pixel idx gather and word scatter.

    Covered strips are processed in batches of config.strip_batch strips
    inside a lax.while_loop — ONE compiled shade body, and only the
    batches actual coverage needs ever run (quantization waste is at most
    one batch).  Shading math is the reference gather path
    (_gather_fragments + compute_varyings + spec.shade) evaluated on
    (rows, 128) fragment blocks: elementwise-identical ops to the jnp
    backend, so results stay bit-identical.

    planes/planes_spec (config.strip_planes): kernel-interpolated varying
    planes (n_planes, H, W).  The shade then gathers n_planes strip rows
    per covered strip instead of strip_len attribute rows
    (_gather_fragments) — the kernel's interpolation is expression-
    identical to compute_varyings, so output stays bit-identical.

    Returns the final (H, W, 3) u8 frame (uncovered pixels black).
    """
    spec = PIPELINES[pipeline]
    vspec = VARYING_SPECS[pipeline]
    H, W = idx.shape  # slab height x frame width
    HW = H * W
    # Strip length: shorter strips track coverage tighter (fewer wasted
    # gather rows), while strip ids are still fetched as wide rows.  Shade
    # math is reshaped to (B*SL/128, 128) blocks regardless of SL.
    SL = config.strip_len
    n_strips = -(-HW // SL)
    B = config.strip_batch
    R = (B * SL) // 128  # 128-wide rows per batch (validated in config)

    flat = idx.reshape(-1)
    if n_strips * SL != HW:
        flat = jnp.concatenate(
            [flat, jnp.full((n_strips * SL - HW,), -1, idx.dtype)]
        )
    strips = flat.reshape(n_strips, SL)
    cov = jnp.any(strips >= 0, axis=1)
    count = jnp.sum(cov, dtype=jnp.int32)

    # Compacted covered-strip ids: comp[j] = id of the j-th covered strip.
    # Uncovered strips scatter out of bounds (dropped); the padded tail
    # stays at the n_strips fill, which batches clamp and mask.
    comp_len = (-(-n_strips // B)) * B
    comp = compact_scatter(
        cov, jnp.arange(n_strips, dtype=jnp.int32), comp_len, n_strips
    )

    lane = jax.lax.broadcasted_iota(jnp.int32, (B, SL), 1)
    keys = _GATHER_KEYS[pipeline]

    if planes is not None:
        P = planes.shape[0]
        vflat = planes.reshape(P, -1)
        if n_strips * SL != HW:
            vflat = jnp.concatenate(
                [vflat, jnp.zeros((P, n_strips * SL - HW), planes.dtype)],
                axis=1,
            )
        vstrips = vflat.reshape(P, n_strips, SL)

    def shade_batch(k, acc):
        ids = jax.lax.dynamic_slice_in_dim(comp, k * B, B)  # (B,)
        safe_ids = jnp.minimum(ids, n_strips - 1)
        sidx = strips[safe_ids].reshape(R, 128)  # winning-triangle ids
        base = jnp.minimum(
            (safe_ids[:, None] * SL + lane).reshape(R, 128), HW - 1
        )
        px = base % W
        py = base // W + y_offset
        if planes is None:
            frag = _gather_fragments(
                setup, sidx, keys, config, pixel_coords=(px, py)
            )
            varys = compute_varyings(frag, vspec, jnp)
        else:
            # n_planes strip-row gathers per batch instead of strip_len
            # attribute rows: pv[p, j] is covered strip j's plane p.
            pv = vstrips[:, safe_ids].reshape(P, R, 128)
            varys = _unpack_planes(planes_spec, pv)
        varys["x"] = px
        varys["y"] = py
        if spec.two_pass:
            varys["shadow_buffer"] = shadow_z
        colors = spec.shade(varys, uniforms, textures, config, jnp)  # (R, 128, 3)
        # ids are unique (or the n_strips fill -> out of bounds, dropped):
        # deterministic scatter either way.
        if config.strip_pack_words:
            c32 = colors.astype(jnp.int32)
            word = c32[..., 0] | (c32[..., 1] << 8) | (c32[..., 2] << 16)
            word = jnp.where(sidx >= 0, word, 0).reshape(B, SL)
            return acc.at[ids].set(word, mode="drop")
        vals = jnp.where(
            (sidx >= 0)[..., None], colors, jnp.uint8(0)
        ).reshape(B, SL, 3)
        return acc.at[ids].set(vals, mode="drop")

    def cond(state):
        k, _ = state
        return k * B < count

    def body(state):
        k, acc = state
        return k + 1, shade_batch(k, acc)

    if config.strip_pack_words:
        acc0 = jnp.zeros((n_strips, SL), jnp.int32)
    else:
        acc0 = jnp.zeros((n_strips, SL, 3), jnp.uint8)
    _, out = jax.lax.while_loop(cond, body, (jnp.int32(0), acc0))

    if not config.strip_pack_words:
        return out.reshape(-1, 3)[:HW].reshape(H, W, 3)
    w = out.reshape(-1)[:HW].reshape(H, W)
    return jnp.stack(
        [
            (w & 0xFF).astype(jnp.uint8),
            ((w >> 8) & 0xFF).astype(jnp.uint8),
            ((w >> 16) & 0xFF).astype(jnp.uint8),
        ],
        axis=-1,
    )


def _pk_needed(textures, pipeline, tile=0):
    """True when the pipeline's packed plane is absent OR stored in a
    different layout than config.tex_tile requests (the samplers read the
    layout from the key, so a mismatched prepack must be redone)."""
    names = _PIPELINE_MAPS[pipeline]
    if not names:
        return False
    dims = {textures[n].shape[:2] for n in names}
    if "normal_map_tangent" in names:
        dims.add(textures["normal_map"].shape[:2])
    if len(dims) == 1:
        h, w = next(iter(dims))
        tile = shaders._effective_tile(tile, h, w)
    return shaders._pk_key(names, tile) not in textures


def prepack_textures(textures, pipeline, xp=jnp, tile=0):
    """Pre-pack the word-packed texture plane for a pipeline once (e.g. at
    Scene construction) so per-frame rendering skips the repack traffic.
    `tile` must match the render config's tex_tile (Scene passes it)."""
    return shaders.pack_textures(textures, _PIPELINE_MAPS[pipeline], xp, tile=tile)


@functools.partial(
    jax.jit, static_argnames=("pipeline", "config", "backend", "gen")
)
def render_frame_jit(
    geom, textures, light_direction, look_from, look_at, up, *, pipeline,
    config, backend, gen=0,
):
    # `gen` is the registration generation of `pipeline` (inert in the
    # body; part of the static key so re-registering a name can never
    # serve executables traced against the old shade).
    del gen
    return render_frame(
        geom,
        textures,
        light_direction,
        look_from,
        look_at,
        up,
        pipeline=pipeline,
        config=config,
        backend=backend,
    )


def make_frame_fn(pipeline, config, backend="auto"):
    """Returns fn(geom, textures, light_direction, look_from, look_at, up)."""
    backend = resolve_backend(backend)
    # Resolve per-pipeline tuned defaults HERE so the jit cache keys on
    # the resolved config (render_frame's own resolve is then a no-op).
    return functools.partial(
        render_frame_jit, pipeline=pipeline, config=config.resolve(pipeline),
        backend=backend, gen=registry_generation(pipeline),
    )


@functools.partial(
    jax.jit,
    static_argnames=("pipeline", "config", "backend", "keep_frames", "gen"),
)
def render_burst(
    geom, textures, camera_angles, light_angles, *, pipeline, config, backend,
    keep_frames=False, gen=0,
):
    """Render a whole animation burst in ONE device program.

    camera_angles/light_angles: (N,) f32 orbit angles (the reference's
    camera/light parameterization, src/app.rs:200-207).  Frames are rendered
    by a lax.scan — a single dispatch regardless of N, so host/dispatch
    latency amortizes to zero; this is both the serving-throughput bench path
    and the batch-animation API.

    Returns dict with per-frame u32 checksums and (N,) overflow flags
    (always) and, if keep_frames, the stacked (N, H, W, 3) frames.
    """
    del gen  # static-key-only: see render_frame_jit
    look_at = jnp.zeros((3,), jnp.float32)
    up = jnp.asarray([0.0, 1.0, 0.0], jnp.float32)

    def body(_, ab):
        ca, la = ab
        look_from = jnp.stack([jnp.sin(ca), jnp.float32(0.0), jnp.cos(ca)])
        light = jnp.stack([jnp.sin(la), jnp.float32(0.0), jnp.cos(la)])
        out = render_frame(
            geom, textures, light, look_from, look_at, up,
            pipeline=pipeline, config=config, backend=backend,
            needs_z=False,  # bursts consume frames/checksums only
        )
        checksum = jnp.sum(out["frame"].astype(jnp.uint32))
        y = (checksum, out["overflow"])
        if keep_frames:
            y = y + (out["frame"],)
        return 0, y

    _, ys = jax.lax.scan(body, 0, (camera_angles, light_angles))
    result = {"checksums": ys[0], "overflow": ys[1]}
    if keep_frames:
        result["frames"] = ys[2]
    return result


def make_burst_fn(pipeline, config, backend="auto", keep_frames=False):
    backend = resolve_backend(backend)
    return functools.partial(
        render_burst,
        pipeline=pipeline,
        config=config.resolve(pipeline),
        backend=backend,
        keep_frames=keep_frames,
        gen=registry_generation(pipeline),
    )
