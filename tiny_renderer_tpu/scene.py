"""Scene: the host-side API mirroring the reference's `Scene` struct.

Reference: src/scene.rs:25-149 — holds dims, model, pipeline, light/camera
state, frame/z/shadow buffers, and exposes clear / set_light_direction /
set_camera / render / get_frame_buffer / get_z_buffer / get_shadow_buffer.

Here the buffers live on device and `render()` invokes one jit-compiled
frame function; the getters fetch and convert exactly like the reference
(u8 casts, vertical flip at presentation, scene.rs:92-125).
"""

from __future__ import annotations

import warnings

import numpy as np
import jax
import jax.numpy as jnp

from .assets.model import Model
from .config import RenderConfig
from .ops import mathlib as ml
from .pipelines.frame import PIPELINES, make_frame_fn
from .utils.transfer import fetch


class Scene:
    def __init__(
        self,
        model: Model,
        pipeline_name: str = "default",
        config: RenderConfig | None = None,
        backend: str = "auto",
        vertex_attrs: dict | None = None,
    ):
        if pipeline_name not in PIPELINES:
            # Reference panics with this message (shader.rs:108).
            raise ValueError(
                f"Provided pipeline name is not supported! ({pipeline_name!r}; "
                f"expected one of {sorted(PIPELINES)})"
            )
        # Per-pipeline tuned defaults (config.resolve_for_pipeline):
        # the stored config is the RESOLVED one so the texture prepack,
        # frame fn and debug views all agree on layouts.
        self.config = (config or RenderConfig()).resolve(pipeline_name)
        self.pipeline_name = pipeline_name
        self.backend = backend
        self.model = model

        mesh = model.mesh
        from .ops.vertex import expand_geometry

        # Pre-expand per-triangle attributes once: the index arrays are
        # frame-invariant, so the per-frame vertex stage skips ~60k gather
        # rows.
        self._geom = expand_geometry(
            {
                "positions": jnp.asarray(mesh.positions),
                "tex_coords": jnp.asarray(mesh.tex_coords),
                "normals": jnp.asarray(mesh.normals),
                "pos_idx": jnp.asarray(mesh.pos_idx),
                "tex_idx": jnp.asarray(mesh.tex_idx),
                "normal_idx": jnp.asarray(mesh.normal_idx),
            }
        )
        if vertex_attrs:
            # Custom per-vertex attributes for registered pipelines that
            # declare "attr:<name>" varyings (register_pipeline): each is
            # a (num_triangles, 3, k) float array, per triangle corner.
            for aname, arr in vertex_attrs.items():
                key = aname if aname.startswith("attr:") else f"attr:{aname}"
                self._geom[key] = jnp.asarray(arr, jnp.float32)

        from .pipelines.frame import prepack_textures

        self._textures = prepack_textures(
            {
                "texture": jnp.asarray(model.texture),
                "normal_map": jnp.asarray(model.normal_map),
                "normal_map_tangent": jnp.asarray(model.normal_map_tangent),
                "specular_map": jnp.asarray(model.specular_map),
            },
            pipeline_name,
            tile=self.config.tex_tile,
        )
        self._frame_fn = make_frame_fn(pipeline_name, self.config, backend)

        # Scene state (reference defaults, scene.rs:66-69).
        self._light_direction = np.array([0.0, 0.0, -1.0], np.float32)
        self._look_from = np.array([0.0, 0.0, 1.0], np.float32)
        self._look_at = np.array([0.0, 0.0, 0.0], np.float32)
        self._up = np.array([0.0, 1.0, 0.0], np.float32)
        self._out = None
        self._overflow_warned = False

    # -- reference API ------------------------------------------------------

    def clear(self):
        """Frames are stateless here (recomputed from scene state); kept for
        API parity with scene.rs:128-137."""
        self._out = None

    def set_light_direction(self, light_direction):
        self._light_direction = np.asarray(light_direction, np.float32)

    def set_camera(self, look_from, look_at, up):
        self._look_from = np.asarray(look_from, np.float32)
        self._look_at = np.asarray(look_at, np.float32)
        self._up = np.asarray(up, np.float32)

    def render(self):
        self._out = self._frame_fn(
            self._geom,
            self._textures,
            jnp.asarray(self._light_direction),
            jnp.asarray(self._look_from),
            jnp.asarray(self._look_at),
            jnp.asarray(self._up),
        )
        return self._out

    def block_until_ready(self):
        if self._out is not None:
            jax.block_until_ready(self._out)

    def render_sequence(self, camera_angles, light_angles) -> np.ndarray:
        """Render an animation burst (one device dispatch) and return the
        frames as (N, H, W, 3) u8, presentation-flipped like
        get_frame_buffer.  Angles follow the reference's orbit
        parameterization (src/app.rs:200-207)."""
        from .pipelines.frame import make_burst_fn
        from .utils.transfer import fetch

        burst = make_burst_fn(
            self.pipeline_name, self.config, backend=self.backend,
            keep_frames=True,
        )
        out = burst(
            self._geom,
            self._textures,
            jnp.asarray(np.asarray(camera_angles, np.float32)),
            jnp.asarray(np.asarray(light_angles, np.float32)),
        )
        self._warn_if_overflowed(out["overflow"])
        return fetch(out["frames"])[:, ::-1]

    @property
    def overflowed(self) -> bool:
        """True if the last render hit a binning coverage cap (coverage was
        silently truncated); raise RenderConfig.max_incidences /
        max_span_* if this fires."""
        out = self._require_render()
        return bool(np.asarray(out["overflow"]))

    def get_frame_buffer(self) -> np.ndarray:
        """(H, W, 3) u8, vertically flipped so row 0 is the top of the world
        — matching the reference's presentation flip (scene.rs:92-97)."""
        out = self._require_render()
        self._warn_if_overflowed(out["overflow"])
        return fetch(out["frame"])[::-1]

    def _warn_if_overflowed(self, overflow) -> None:
        """One-time warning at presentation points (where a host fetch is
        already being paid — render() itself stays sync-free): the binning
        coverage caps truncate coverage deterministically, and the
        auto-tuned span caps (config.resolve_for_pipeline) are sized for
        the reference orbit envelope — a custom scene with larger
        screen-space triangles can exceed them without ever polling
        `overflowed`."""
        if self._overflow_warned:
            return
        if bool(np.asarray(overflow).any()):
            self._overflow_warned = True
            warnings.warn(
                "render hit a binning coverage cap (coverage was truncated "
                "deterministically): raise RenderConfig.max_span_y/max_span_x "
                "(or max_incidences if set), or pass auto_tune=False to keep "
                "the wider class-default span grid",
                RuntimeWarning,
                stacklevel=3,
            )

    def get_z_buffer(self) -> np.ndarray:
        """Grayscale u8 debug view of the z-buffer (scene.rs:101-111)."""
        out = self._require_render()
        z = fetch(out["z"])
        g = np.asarray(ml.rust_f32_to_u8(z, np))
        return np.repeat(g[::-1, :, None], 3, axis=2)

    def get_shadow_buffer(self) -> np.ndarray:
        """Grayscale u8 debug view of the shadow buffer (scene.rs:115-125)."""
        out = self._require_render()
        s = fetch(out["shadow"])
        g = np.asarray(ml.rust_f32_to_u8(s, np))
        return np.repeat(g[::-1, :, None], 3, axis=2)

    # -----------------------------------------------------------------------

    def _require_render(self):
        if self._out is None:
            self.render()
        return self._out
