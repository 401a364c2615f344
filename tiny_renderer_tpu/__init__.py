"""tiny_renderer_tpu — a JAX/XLA/Pallas rasterization framework for the GPU.

A ground-up rebuild of the capabilities of litzendraht/tiny_renderer
(a single-threaded Rust CPU software rasterizer) as a data-parallel
framework:

* asset layer: OBJ parser + TGA (RLE) decoder with `image`-crate-equivalent
  semantics (reference: src/app.rs:87-131), NumPy and native C++ backends.
* math layer: the exact camera/viewport matrix stack of the reference
  (reference: src/scene/shader.rs:183-279) as pure functions usable from both
  NumPy (oracle) and JAX (device).
* vertex stage: batched transform + cull over *all* triangles at once,
  lifting the reference's per-triangle mutable `Buffer` varyings
  (src/scene/shader.rs:30-35) to dense (T, ...) arrays.
* raster core: a tile-binned rasterizer with a deterministic, bit-stable
  lexicographic (max z, min triangle index) depth resolve reproducing the
  reference's serial depth-test semantics (src/scene/shader.rs:169-180),
  in two interchangeable implementations: pure-jnp (reference, the CPU
  path) and a Pallas kernel compiled through Triton for the GPU (fast
  path).
* shading: the 7 shader pipelines (src/scene/shader.rs:100-109) as pure,
  vectorized per-pixel functions over a G-buffer; two-pass pipelines
  (shadow, occlusion) run entirely inside one jit-compiled frame function.
* app/CLI: `-p`/`-s` compatible entry point (src/main.rs:16-26) with
  headless rendering, orbit animation, PNG output and an optional
  interactive viewer.
* parallel: shard_map scale-out over screen-row shards on a jax.sharding.Mesh.

The per-frame hot path is a single jit-compiled function; the only
host<->device traffic is the scalar camera/light state in and the final u8
frame out.
"""

import jax

# The renderer's matrix stack and attribute interpolation are f32 and must not
# silently drop to a reduced-precision matmul (bf16, or TF32 on the GPU);
# raster throughput comes from the Pallas kernel, not from large matmuls, so
# full-precision matmuls cost nothing here.
jax.config.update("jax_default_matmul_precision", "highest")

from .config import RenderConfig  # noqa: E402
from .assets.model import Model, load_model  # noqa: E402


def __getattr__(name):
    # Lazy imports: Scene/register_pipeline pull in the full pipeline stack.
    if name == "Scene":
        from .scene import Scene

        return Scene
    if name in ("register_pipeline", "unregister_pipeline"):
        from .pipelines import frame

        return getattr(frame, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__version__ = "0.1.0"

PIPELINE_NAMES = (
    "default",
    "phong",
    "normal_map",
    "specular",
    "darboux",
    "shadow",
    "occlusion",
)

__all__ = [
    "RenderConfig",
    "Scene",
    "Model",
    "load_model",
    "PIPELINE_NAMES",
    "register_pipeline",
    "__version__",
]
