"""Full-resolution (800x800) golden parity vs the oracle.

All 7 pipelines x both seeded scenes — the same matrix chip_smoke.py
checks on the GPU.

Slow (~1 min per config on CPU): run explicitly with
    python -m pytest tests/test_fullsize_parity.py -m slow -q --override-ini 'addopts='
Skipped by default; the 160x160 parity suite covers the same code paths.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tiny_renderer_tpu import RenderConfig
from tiny_renderer_tpu.oracle import render_oracle
from tiny_renderer_tpu.pipelines.frame import make_frame_fn

pytestmark = pytest.mark.slow

ALL_PIPELINES = (
    "default", "phong", "normal_map", "specular", "darboux", "shadow", "occlusion"
)

# Tie-flip budget: PARITY.md certifies <= 0.073% on hardware; 0.1% leaves
# headroom for resolve-order ties only, not semantic drift.
MISMATCH_BUDGET = 0.001


def _run(scene_data, camera, pipeline):
    geom, tex = scene_data
    light, look_from, look_at, up = camera
    cfg = RenderConfig(width=800, height=800, tri_block=64)
    o = render_oracle(geom, tex, light, look_from, look_at, up,
                      pipeline=pipeline, config=cfg)
    fn = make_frame_fn(pipeline, cfg, backend="jnp")
    r = fn(jax.tree.map(jnp.asarray, geom), jax.tree.map(jnp.asarray, tex),
           jnp.asarray(light), jnp.asarray(look_from), jnp.asarray(look_at),
           jnp.asarray(up))
    frame = np.asarray(r["frame"])
    mismatch = (frame != o["frame"]).any(axis=-1).mean()
    assert mismatch <= MISMATCH_BUDGET, (
        f"{pipeline}: 800x800 mismatch {mismatch:.4%}"
    )


@pytest.mark.parametrize("pipeline", ALL_PIPELINES)
def test_fullsize_diablo(diablo_scene_data, camera, pipeline):
    _run(diablo_scene_data, camera, pipeline)


@pytest.mark.parametrize("pipeline", ALL_PIPELINES)
def test_fullsize_head(head_scene_data, camera, pipeline):
    _run(head_scene_data, camera, pipeline)


from conftest import ORBIT_POSES, pose_camera


@pytest.mark.parametrize(
    "pose", ORBIT_POSES, ids=lambda p: f"cam{p[0]:.0f}_light{p[1]:.0f}"
)
def test_fullsize_diablo_shadow_orbit(diablo_scene_data, pose):
    """The flagship config across the orbit sweep at full resolution —
    grazing light exercises shadow-index saturation at real scale."""
    _run(diablo_scene_data, pose_camera(*pose), "shadow")
