"""splatapult_jax — a differentiable 3D Gaussian-splatting framework.

Re-implements the capability set of hyperlogic/splatapult (a C++/OpenGL real-time
3DGS viewer) as a functional, differentiable, multi-chip JAX/Pallas renderer:

- PLY splat loading into SoA device arrays (ref: src/ply.cpp, src/gaussiancloud.cpp)
- SH color evaluation deg 0..3 (ref: shader/splat_vert.glsl:51-127)
- EWA covariance projection + conic math (ref: shader/splat_vert.glsl:153-203,
  shader/splat_geom.glsl:34-87)
- depth keying / culling (ref: shader/presort_compute.glsl:31-57)
- tile-binned sort replacing the GL radix sorts (ref: shader/multi_radixsort*.glsl)
- front-to-back alpha compositing replacing HW blending (ref: shader/splat_frag.glsl
  + GL_ONE/ONE_MINUS_SRC_ALPHA state in src/app.cpp:153-156)
- camera configs (ref: src/camerasconfig.cpp, src/vrconfig.cpp)

Everything composes under jit/vmap/shard_map; gradients flow to means, scales,
rotations, opacities and SH coefficients.
"""

__version__ = "0.1.0"

from splatapult_jax.io.gaussians import GaussianScene, load_gaussian_ply, save_gaussian_ply
from splatapult_jax.render import (
    Camera,
    RenderConfig,
    calibrate_config,
    render,
    render_batch,
)

__all__ = [
    "GaussianScene",
    "load_gaussian_ply",
    "save_gaussian_ply",
    "RenderConfig",
    "Camera",
    "calibrate_config",
    "render",
    "render_batch",
]
