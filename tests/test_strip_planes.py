"""config.strip_planes: kernel-interpolated varying planes consumed by the
strip-compacted shade at strip granularity.

The hybrid replaces _gather_fragments' strip_len attribute rows per covered
strip with n_planes (1-3) plane rows; the kernel's phase-2 interpolation and
compute_varyings share the exact-division barycentric expressions
(raster_pallas.py vary_body vs shaders.compute_varyings), so frames must be
BIT-identical with the knob on or off — these tests pin that.
"""

import dataclasses

import numpy as np
import pytest

from tiny_renderer_tpu.config import RenderConfig
from tiny_renderer_tpu.pipelines.frame import _planes_spec, render_frame
from tiny_renderer_tpu.pipelines.shaders import VARYING_SPECS, kernel_varying_spec

from conftest import geom_dict, tex_dict

CFG = RenderConfig(width=256, height=256, strip_batch=64, strip_len=16)
CFG_PLANES = dataclasses.replace(CFG, strip_planes=True)


@pytest.fixture(scope="module")
def scene(head_model):
    return geom_dict(head_model.mesh), tex_dict(head_model)


# strip_planes is a default-off knob: all its
# bit-identity pins run in -m slow (the cheap spec-gating test below
# stays fast).
@pytest.mark.slow
@pytest.mark.parametrize(
    "pipeline",
    ["default", "phong", "normal_map", "specular", "darboux", "shadow",
     "occlusion"],
)
def test_strip_planes_bit_identical(scene, camera, pipeline):
    geom, tex = scene
    light, look_from, look_at, up = camera
    a = render_frame(
        geom, tex, light, look_from, look_at, up,
        pipeline=pipeline, config=CFG, backend="pallas_interpret",
    )
    b = render_frame(
        geom, tex, light, look_from, look_at, up,
        pipeline=pipeline, config=CFG_PLANES, backend="pallas_interpret",
    )
    np.testing.assert_array_equal(np.asarray(a["frame"]), np.asarray(b["frame"]))


def test_planes_spec_gating(scene):
    """darboux (const varyings) and the jnp backend fall back to the
    attribute-gather path; shadow gets the texidx/intensity/zfrag planes."""
    _, tex = scene
    assert _planes_spec("darboux", tex, CFG_PLANES, "pallas") is None
    assert _planes_spec("shadow", tex, CFG_PLANES, "jnp") is None
    assert _planes_spec("shadow", tex, CFG, "pallas") is None  # knob off
    kspec = _planes_spec("shadow", tex, CFG_PLANES, "pallas")
    # tile passed through explicitly: the spec key embeds the config's
    # tex_tile, whatever the shipping default is.
    assert kspec == kernel_varying_spec("shadow", tex, tile=CFG_PLANES.tex_tile)
    assert sum(c for (_, c, _) in kspec) == 3  # texidx + intensity + zfrag
    # occlusion has no maps: the spec passes through unchanged.
    assert _planes_spec("occlusion", tex, CFG_PLANES, "pallas") == VARYING_SPECS[
        "occlusion"
    ]


@pytest.mark.slow  # strip_planes is a default-off knob; single-device
def test_strip_planes_sharded_bit_identical(scene, camera):  # rep stays fast
    """The sharded slab shade honors strip_planes (parallel/sharding.py
    mirrors frame.render_frame's strategy) and stays bit-identical to the
    attribute-gather sharded render."""
    import jax
    import jax.numpy as jnp

    from tiny_renderer_tpu.parallel import make_row_mesh, render_frame_sharded

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_row_mesh(devs[:8], batch=1)
    geom, tex = scene
    gj = jax.tree.map(jnp.asarray, geom)
    tj = jax.tree.map(jnp.asarray, tex)
    cam = [jnp.asarray(v) for v in camera]
    cfg = dataclasses.replace(CFG, width=64, height=64, tile_h=8, strip_batch=32)
    cfgp = dataclasses.replace(cfg, strip_planes=True)
    a = render_frame_sharded(
        gj, tj, *cam, pipeline="shadow", config=cfg, mesh=mesh,
        backend="pallas_interpret",
    )
    b = render_frame_sharded(
        gj, tj, *cam, pipeline="shadow", config=cfgp, mesh=mesh,
        backend="pallas_interpret",
    )
    np.testing.assert_array_equal(np.asarray(a["frame"]), np.asarray(b["frame"]))
