"""The jitted differentiable render pipeline: bake -> project -> cull -> sort -> composite.

This is the functional re-architecture of the reference's per-frame GPU pipeline
(ref: src/splatrenderer.cpp:153-343 orchestrating presort_compute.glsl,
multi_radixsort*.glsl and the splat_vert/geom/frag chain):

    image = render(scene, camera, config)        # jit-able, vmap-able
    grads flow to means / scales / rotations / opacities / SH.

Differences by design, not translation:
- No host<->device sync: the reference reads back an atomic splat counter every
  frame (ref: src/splatrenderer.cpp:196-204); here culled splats are masked and
  pushed to the end of a static-shape sort instead.
- Front-to-back transmittance compositing in blocks (a scan carrying
  (accumulated color, transmittance)) replaces hardware back-to-front "over"
  blending (ref: src/app.cpp:153-156) — mathematically identical, and the
  carry structure is what makes a memory-light custom VJP possible.
- Precision knob: ``accum_dtype`` mirrors --fp16/--fp32 offscreen accumulation
  (ref: src/app.cpp:1000-1035, README.md:25-29), with bf16 as the
  half-precision type.
- SH knob: ``sh_degree=0`` mirrors --nosh (ref: src/app.cpp:335).
- sRGB knob: mirrors the FRAMEBUFFER_SRGB shader specialization
  (ref: shader/splat_vert.glsl:209-218).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from splatapult_jax.core import transforms
from splatapult_jax.core.project import ALPHA_CUTOFF, ProjectedSplats, project_gaussians, view_dirs
from splatapult_jax.core.sh import eval_sh_radiance
from splatapult_jax.io.gaussians import GaussianScene


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    """Dynamic camera state (traceable pytree).

    cam_to_world: [4, 4] GL-style camera matrix (-Z forward, +Y up), the
        reference's ``cameraMat``. The view matrix is its inverse.
    proj: [4, 4] GL-convention projection (see transforms.perspective /
        projection_from_tan_angles).
    """

    cam_to_world: jax.Array
    proj: jax.Array

    @staticmethod
    def from_fov(cam_to_world, fovy: float, width: int, height: int,
                 near: float = 0.1, far: float = 1000.0) -> "Camera":
        """Default desktop camera: FOVY 45deg, near 0.1, far 1000
        (ref: src/app.cpp:73-75, src/sdl_main.cpp:72-73)."""
        proj = transforms.perspective(fovy, width / height, near, far)
        return Camera(cam_to_world=jnp.asarray(cam_to_world, jnp.float32), proj=proj)

    def with_floor_transform(self, floor_mat) -> "Camera":
        """Compose a world/floor transform onto the camera, the way the VR
        carpet matrix multiplies the eye pose (ref: src/app.cpp:578)."""
        return Camera(
            cam_to_world=jnp.matmul(jnp.asarray(floor_mat, jnp.float32),
                                    self.cam_to_world,
                                    precision=jax.lax.Precision.HIGHEST),
            proj=self.proj,
        )

    @property
    def eye(self) -> jax.Array:
        return self.cam_to_world[..., :3, 3]

    def stereo_pair(self, ipd: float = 0.064, tan_angles=None,
                    near: float = 0.1, far: float = 1000.0) -> "Camera":
        """[2]-batched left/right eye cameras offset along +X by the
        interpupillary distance — the batched analog of the reference's
        OpenXR stereo views (ref: src/xrbuddy.cpp:1689-1800), rendered
        per-eye through render_batch; stereo.render_stereo (one shared
        binning, the lift of the reference's shared per-frame sort,
        src/app.cpp:603-607) is the exact alternative whose union rects
        inflate the instance capacity ~45%.

        tan_angles: optional [2, 4] per-eye asymmetric frustum tangents
        (tan_left, tan_right, tan_up, tan_down — tan_left/tan_down
        negative for a frustum crossing the axis), the values an HMD
        runtime reports per eye (ref: src/xrbuddy.cpp:1802-1832 feeding
        util.cpp:412-480). Each eye then gets its own
        projection_from_tan_angles(near, far) projection; None keeps
        today's symmetric behavior (this camera's proj duplicated).
        far <= near places the far plane at infinity, as the reference's
        CreateProjection does."""
        offsets = jnp.asarray([-ipd / 2.0, ipd / 2.0], jnp.float32)
        right_axis = self.cam_to_world[:3, 0]
        mats = jnp.stack([
            self.cam_to_world.at[:3, 3].add(o * right_axis) for o in offsets
        ])
        if tan_angles is None:
            proj = jnp.stack([self.proj, self.proj])
        else:
            import numpy as _np

            ta = _np.asarray(tan_angles, _np.float32)
            assert ta.shape == (2, 4), (
                f"tan_angles must be [2, 4] (per-eye l, r, u, d), got {ta.shape}")
            proj = jnp.stack([
                transforms.projection_from_tan_angles(
                    float(ta[e, 0]), float(ta[e, 1]), float(ta[e, 2]),
                    float(ta[e, 3]), near, far)
                for e in range(2)
            ])
        return Camera(cam_to_world=mats, proj=proj)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render options (hashable; safe as a jit static arg)."""

    width: int = 1024  # default window 1024x768 (ref: src/sdl_main.cpp:72-73)
    height: int = 768
    sh_degree: Optional[int] = None  # None = use all stored coeffs; 0 = --nosh analog
    srgb_radiance_to_linear: bool = False  # FRAMEBUFFER_SRGB analog
    accum_dtype: str = "float32"  # "float32" | "bfloat16" (--fp32/--fp16 analog)
    pipeline: str = "auto"  # "auto" | "global" | "tiled"
    block_size: int = 64  # splats per composite scan step (global pipeline)
    # 1/256 discard threshold (ref: shader/splat_frag.glsl:38-41). It is a hard
    # discontinuity; set 0.0 for a fully smooth render (e.g. gradient checks).
    alpha_cutoff: float = ALPHA_CUTOFF
    # --- tiled pipeline knobs (ops/tiled.py) ---
    # tiled pipeline geometry, measured on the H100 at the garden shape
    # (PERF.md): 16x16 tiles (one pixel per kernel thread) and 16-instance
    # blocks (the backward kernel's [B, P] tensors stay in registers)
    tile_size: int = 16  # pixels per tile side
    tile_block: int = 16  # instances per compositing block
    # instance-buffer capacity as a (possibly fractional) multiple of N; size
    # it from ops.binning.instance_demand + headroom when the scene/camera are
    # known (bench.py auto-calibrates), or leave the generous default
    max_instance_mult: float = 6.0
    early_stop_eps: float = 0.0  # skip blocks once max transmittance < eps (0 = exact)
    # dtype per-instance gradients ride through the backward transpose sort
    # ("float32" | "bfloat16"); bf16 halves that byte-bound sort's traffic,
    # per-splat sums still accumulate in f32 (see ops/composite._cff_bwd)
    grad_sort_dtype: str = "float32"
    # pack splat RGB as 16-bit fixed point (step 2^-12) so instance feature
    # rows shrink from 64 B to 32 B; geometry and opacity stay exact f32
    # (see ops/composite._pack_color_feats)
    packed_colors: bool = False
    # ordered-grid supersampling factor: render at supersample^2 the pixel
    # count, box-filter down (the reference's USE_SUPERSAMPLING resolve,
    # ref: shader/desktop_frag.glsl:19-30, enabled for the VR mirror window
    # at src/app.cpp:564-566; it averages a 2x2 dFdx/dFdy grid).
    supersample: int = 1
    # viewer mode (the reference's only mode — it has no backward at all):
    # a contract marker; attempting to differentiate a forward_only render
    # raises.
    forward_only: bool = False
    # quantize whole instance feature rows to 16 B (coarser than
    # packed_colors: f16 conic/opacity, ~0.09 px means, 11/11/10-bit colors),
    # halving the instance gather's bytes again
    packed_feats16: bool = False
    # split the tiled pipeline into this many interleaved tile-row bands,
    # each with its OWN binning/sort/gather/composite at ~1/K capacity
    # (max_instance_mult then sizes EACH band): smaller sorts at the price
    # of per-band O(N) plumbing (the backward's per-splat segment machinery
    # runs once per band). Exact: bands own disjoint tile rows, per-tile
    # instance order is identical, per-band backward tails. Whether it pays
    # on one GPU is not measured; parallel/mesh.py's interleaved sharding
    # is the multi-device form of this idea.
    sort_bands: int = 1
    # depth precision in the instance sort key: 32 = exact f32 ordering
    # (default), 20 = top-20 f32 bits packed with the tile id into ONE sort
    # key (12 explicit mantissa bits, ~2.4e-4 relative depth; one sort
    # operand + one comparison key fewer; needs num_tiles < 2048 — at
    # 2048+ the packed sentinel key would overflow int32, so it falls back
    # to exact with a log line), 16 = the coarser bf16 variant (scene-scale
    # image diffs ~30x larger than 20's, PERF.md). Near-equal depths fall to
    # the reference's
    # submission-order tie-break. See ops/binning.TileGrid.depth_bits.
    depth_bits: int = 32


# The TWO documented benchmark profiles (cli bench and bench.py tag which
# one they measured). "exact" is the
# library default (exact f32 everywhere); "production" is bench.py's
# training profile — each knob's error contract is tested and committed
# (PERF.md). packed_feats16 is intentionally NOT part of a profile: it is
# scale-conditional (engages above ~3.1M splats / 100 MB tables).
PROFILES = {
    "exact": dict(depth_bits=32, packed_colors=False, early_stop_eps=0.0,
                  grad_sort_dtype="float32"),
    "production": dict(depth_bits=20, packed_colors=True, early_stop_eps=1e-4,
                       grad_sort_dtype="bfloat16"),
}


def apply_profile(config: "RenderConfig", profile: str) -> "RenderConfig":
    """Overlay a named benchmark profile's precision knobs onto a config."""
    return dataclasses.replace(config, **PROFILES[profile])


def profile_name(config: "RenderConfig") -> str:
    """Classify a config's precision knobs -> "exact" | "production" |
    "custom" (for tagging benchmark JSON output)."""
    for name, knobs in PROFILES.items():
        if all(getattr(config, k) == v for k, v in knobs.items()):
            return name
    return "custom"


@jax.custom_vjp
def _permute_rows(x, order, inv_order):
    """Row permutation with a gather-based transpose.

    jnp.take's default VJP is a scatter-add (it cannot know the indices form a
    permutation) with colliding-index handling; the true transpose of a
    permutation is just the inverse gather.
    """
    return jnp.take(x, order, axis=0)


def _permute_rows_fwd(x, order, inv_order):
    return jnp.take(x, order, axis=0), inv_order


def _permute_rows_bwd(inv_order, g):
    return jnp.take(g, inv_order, axis=0), None, None


_permute_rows.defvjp(_permute_rows_fwd, _permute_rows_bwd)


def prepare_splats(scene: GaussianScene, camera: Camera, config: RenderConfig,
                   sort: bool = True):
    """Shared front end: bake + project + SH (+ optional global depth sort).

    With ``sort=True`` returns per-splat arrays sorted front-to-back with
    culled splats pushed to the back carrying zero alpha — required by the
    global composite, which walks splats in array order. The tiled pipeline
    passes ``sort=False``: ops/binning.bin_splats orders instances by a
    per-instance depth sort key instead, which saves the [N] argsort AND the
    [N, 14]-column permute + its gather-transpose VJP from this hot path.
    """
    means = scene.means
    cov3 = transforms.bake_covariance(scene.quats, scene.log_scales)
    alpha = jax.nn.sigmoid(scene.opacities)  # ref: src/gaussiancloud.cpp:119-122

    view = transforms.invert_rigid(camera.cam_to_world)
    proj: ProjectedSplats = project_gaussians(
        means, cov3, view, camera.proj, (config.width, config.height)
    )

    rgb = eval_sh_radiance(scene.sh, view_dirs(means, camera.eye), config.sh_degree)
    if config.srgb_radiance_to_linear:
        rgb = transforms.srgb_to_linear(rgb)
    # zero masked splats' colors: a culled splat contributes nothing either
    # way, but a NaN radiance (e.g. a NaN position in a real-world capture
    # propagating through the SH view direction) would otherwise poison the
    # global composite's color matmul as 0 * NaN even at zero weight
    rgb = jnp.where(proj.mask[:, None], rgb, 0.0)

    alpha_eff = jnp.where(proj.mask, alpha, 0.0)
    extent = proj.extent
    if config.alpha_cutoff > 0.0:
        # Opacity-aware AABB tightening, exactly lossless: the composite
        # discards any pixel with alpha * exp(-q/2) <= cutoff (the reference's
        # 1/256 test, shader/splat_frag.glsl:38-41), i.e. q >= 2*ln(alpha /
        # cutoff). The binning rect therefore only needs to cover
        # k_eff = sqrt(2*ln(alpha/cutoff)) sigmas instead of the reference's
        # fixed 3.5 (shader/splat_geom.glsl:58) — low-opacity splats shrink,
        # and alpha <= cutoff splats generate zero tile instances.
        from splatapult_jax.core.project import EXTENT_SIGMA

        k2 = 2.0 * jnp.log(
            jnp.maximum(alpha_eff, 1e-37) * (1.0 / config.alpha_cutoff)
        )
        shrink = jnp.sqrt(jnp.clip(k2, 0.0, EXTENT_SIGMA * EXTENT_SIGMA)) / EXTENT_SIGMA
        extent = extent * jax.lax.stop_gradient(shrink)[:, None]
    ng = jax.lax.stop_gradient
    if not sort:
        return {
            "mean2d": proj.mean2d,
            "conic": proj.conic,
            "rgb": rgb,
            "alpha": alpha_eff,
            "depth": ng(proj.depth),
            "radius": ng(proj.radius),
            "extent": ng(extent),
            "mask": ng(proj.mask),
        }

    # Front-to-back order: ascending view depth; culled splats get +inf keys so
    # they land at the end (static-shape replacement for the reference's atomic
    # compaction, ref: shader/presort_compute.glsl:50-55). The reference's
    # stable radix sort draws equal-depth splats back-to-front in submission
    # order (ref: shader/presort_compute.glsl:52-53), so the equivalent
    # front-to-back order must break ties by *descending* index.
    key = jnp.where(proj.mask, proj.depth, jnp.inf)
    n = key.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    _, _, order = jax.lax.sort((key, -idx, idx), num_keys=2)
    inv_order = jnp.zeros((n,), jnp.int32).at[order].set(idx)

    # ONE packed row permutation for every per-splat output (a single [N, 14]
    # gather + a gather-transpose VJP, instead of several independent takes
    # whose VJPs would each scatter-add). Row gathers cost per index, not per
    # byte, so the non-differentiable plumbing columns ride along for free.
    packed = jnp.concatenate(
        [proj.mean2d, proj.conic, rgb, alpha_eff[:, None],
         ng(proj.depth)[:, None], ng(proj.radius)[:, None], ng(extent),
         ng(proj.mask).astype(jnp.float32)[:, None]],
        axis=1,
    )  # [N, 14]
    packed_sorted = _permute_rows(packed, order, inv_order)

    return {
        "mean2d": packed_sorted[:, 0:2],
        "conic": packed_sorted[:, 2:5],
        "rgb": packed_sorted[:, 5:8],
        "alpha": packed_sorted[:, 8],
        "depth": packed_sorted[:, 9],
        "radius": packed_sorted[:, 10],
        "extent": packed_sorted[:, 11:13],
        "mask": packed_sorted[:, 13] > 0.5,
    }


def _composite_global(sorted_splats, config: RenderConfig) -> jax.Array:
    """Whole-image blockwise front-to-back composite.

    O(N * P): every splat is evaluated against every pixel, masked by the 1/256
    cutoff. Correct and differentiable for any scene; intended for small scenes
    and as the second-tier oracle for the tiled pipeline. The scan carry is
    (accumulated premultiplied RGB, transmittance) per pixel; within a block the
    front-to-back products are closed-form via cumprod, and the color gather is
    a [P, B] x [B, 3] matmul (at HIGHEST precision: no TF32 rounding).
    """
    h, w = config.height, config.width
    p = h * w
    dtype = jnp.dtype(config.accum_dtype)
    b = config.block_size

    n = sorted_splats["mean2d"].shape[0]
    nb = -(-n // b)
    pad = nb * b - n

    def pad0(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    mean2d = pad0(sorted_splats["mean2d"]).reshape(nb, b, 2)
    conic = pad0(sorted_splats["conic"]).reshape(nb, b, 3)
    rgb = pad0(sorted_splats["rgb"]).reshape(nb, b, 3)
    alpha = pad0(sorted_splats["alpha"]).reshape(nb, b)

    # gl_FragCoord-style pixel centers, row 0 = top of image
    px = jnp.arange(w, dtype=jnp.float32) + 0.5
    py = h - (jnp.arange(h, dtype=jnp.float32) + 0.5)
    gx = jnp.tile(px[None, :], (h, 1)).reshape(p)
    gy = jnp.tile(py[:, None], (1, w)).reshape(p)

    def step(carry, blk):
        color, trans = carry  # [P, 3], [P]
        m2, cn, cb, ab = blk
        dx = gx[None, :] - m2[:, 0:1]  # [B, P]
        dy = gy[None, :] - m2[:, 1:2]
        # g = exp(-0.5 d^T conic d) (ref: shader/splat_frag.glsl:20-25)
        q = cn[:, 0:1] * dx * dx + 2.0 * cn[:, 1:2] * dx * dy + cn[:, 2:3] * dy * dy
        g = jnp.exp(-0.5 * q)
        wgt = ab[:, None] * g
        if config.alpha_cutoff > 0.0:
            wgt = jnp.where(wgt > config.alpha_cutoff, wgt, 0.0)  # shader/splat_frag.glsl:38-41
        wgt = wgt.astype(dtype)
        one_minus = 1.0 - wgt
        t_cum = jnp.cumprod(one_minus, axis=0)  # transmittance after each splat in block
        t_before = jnp.concatenate([jnp.ones_like(t_cum[:1]), t_cum[:-1]], axis=0)
        eff = t_before * wgt  # [B, P] per-splat effective weight within block
        contrib = jnp.einsum("bp,bc->pc", eff, cb.astype(dtype),
                             preferred_element_type=dtype,
                             precision=jax.lax.Precision.HIGHEST)
        color = color + trans[:, None] * contrib
        trans = trans * t_cum[-1]
        return (color, trans), None

    init = (jnp.zeros((p, 3), dtype), jnp.ones((p,), dtype))
    (color, trans), _ = jax.lax.scan(step, init, (mean2d, conic, rgb, alpha))
    img = jnp.concatenate([color, (1.0 - trans)[:, None]], axis=-1)
    return img.reshape(h, w, 4).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("config",))
def render(scene: GaussianScene, camera: Camera, config: RenderConfig) -> jax.Array:
    """Render one view -> [H, W, 4] premultiplied RGBA (row 0 = top).

    The functional replacement for SplatRenderer::Sort + SplatRenderer::Render
    (ref: src/splatrenderer.cpp:153-343).
    """
    if config.supersample > 1:
        ss = config.supersample
        hi = dataclasses.replace(
            config, supersample=1, width=config.width * ss, height=config.height * ss
        )
        img = render(scene, camera, hi)
        # box-filter resolve (the reference averages the supersample grid,
        # ref: shader/desktop_frag.glsl:22-29)
        h, w = config.height, config.width
        return img.reshape(h, ss, w, ss, 4).mean(axis=(1, 3))
    pipeline = config.pipeline
    if pipeline == "auto":
        pipeline = "tiled" if scene.means.shape[0] >= 4096 else "global"
    if pipeline == "global":
        return _composite_global(prepare_splats(scene, camera, config), config)
    elif pipeline == "tiled":
        from splatapult_jax.ops.tiled import composite_tiled

        # unsorted prepare: the binning sort carries the depth key instead
        return composite_tiled(prepare_splats(scene, camera, config, sort=False), config)
    raise ValueError(f"unknown pipeline {config.pipeline!r}")


@functools.lru_cache(maxsize=32)
def _demand_fns(config: RenderConfig, grid):
    """Jitted demand/peak functions for calibrate_config, cached on the
    hashable (config, grid) pair so repeated calibrations (e.g. per camera
    move) hit the jit cache instead of retracing a fresh closure each call."""
    from splatapult_jax.ops.binning import instance_demand

    @jax.jit
    def demand(scene, cam):
        d = prepare_splats(scene, cam, config, sort=False)
        if grid.row_stride > 1:
            # banded pipeline (config.sort_bands): capacity is PER BAND, so
            # the demand that sizes it is the peak band's
            m2 = d["mean2d"] + jnp.asarray(
                [0.0, float(grid.height - config.height)], jnp.float32)
            offs = jnp.arange(grid.row_stride, dtype=jnp.int32)
            return jnp.max(jax.vmap(
                lambda o: instance_demand(m2, d["extent"], grid, row_offset=o)
            )(offs))
        return instance_demand(d["mean2d"], d["extent"], grid)

    @jax.jit
    def peak(scene, cams):
        # one jitted pass over the whole camera batch (lax.map keeps the
        # per-view demand body compiled once) and ONE readback of the peak —
        # a Python loop here would cost a device round trip per view
        return jnp.max(jax.lax.map(lambda c: demand(scene, c), cams))

    return demand, peak


# Calibrated capacities quantize UP onto this geometric grid (x1.08 steps)
# so nearby cameras/demands resolve to the SAME RenderConfig — and therefore
# the same compiled program. A continuous mult made every materially-new
# demand a new static config -> a full recompile; a camera sweep calibrated
# per-view would be compile-bound. The reference's analog tunes its radix
# workgroup size ONCE per run, not per frame (ref: src/app.cpp:843-874).
# Grid pitch: every capacity-proportional per-step cost (sorts, gather,
# composite) pays the overshoot; 1.08 caps it at 8% (avg ~4%) and still
# shares one compile across a sweep's typical few-percent demand spread.
CAPACITY_BUCKET = 1.08


def bucket_capacity_mult(mult: float, bucket: float = CAPACITY_BUCKET) -> float:
    """Round a capacity multiplier UP to the geometric grid bucket**k."""
    import math

    if bucket <= 1.0 or mult <= 0.0:
        return mult
    k = math.ceil(math.log(mult) / math.log(bucket) - 1e-9)
    q = bucket ** k
    return q if q >= mult else bucket ** (k + 1)


def capacity_mult_for_demand(demand: int, num_splats: int,
                             headroom: float = 1.06,
                             bucket: float = CAPACITY_BUCKET) -> float:
    """Demand -> max_instance_mult: ``headroom`` over the measured demand
    (at least the 4096-slot floor), rounded UP onto the geometric ``bucket``
    grid."""
    return bucket_capacity_mult(
        max(headroom * demand, 4096) / max(num_splats, 1), bucket)


def calibrate_config(scene: GaussianScene, cameras: Camera,
                     config: RenderConfig, headroom: float = 1.06,
                     bucket: float = CAPACITY_BUCKET) -> RenderConfig:
    """Right-size the tiled pipeline's instance capacity for known view(s).

    Measures the true tile-instance demand of each camera (one cheap jitted
    pre-pass; ops.binning.instance_demand) and returns a config whose
    ``max_instance_mult`` fits the peak demand plus ``headroom`` — every
    per-step sort/gather/kernel then runs at measured rather than worst-case
    capacity (the analog of the reference's radix-workgroup auto-tuner,
    ref: src/app.cpp:843-874). Re-calibrate (and pay one recompile) when the
    camera moves enough to change the demand materially; overflow is always
    counted, never silent, so a stale calibration degrades visibly rather
    than incorrectly.

    cameras: a single Camera or a [V]-batched one (leading axis on both
    fields); the peak demand across views is used.

    The returned ``max_instance_mult`` is rounded UP onto the geometric
    ``bucket`` grid (see bucket_capacity_mult) so nearby demands produce an
    IDENTICAL config and reuse its compile; pass bucket=1.0 for the exact
    (continuous) calibration.
    """
    from splatapult_jax.ops.binning import TileGrid

    k = max(getattr(config, "sort_bands", 1), 1)
    ts = config.tile_size
    ty = -(-config.height // ts)
    # banded: pad so tile rows divide the bands. At k == 1 the height stays
    # EXACT: a padded demand grid shifts rect rows and perturbs the
    # measured demand (~0.2%)
    h_cal = config.height if k == 1 else -(-ty // k) * k * ts
    grid = TileGrid.create(width=config.width, height=h_cal,
                           num_splats=scene.means.shape[0],
                           tile_size=ts, row_stride=k)
    demand_fn, peak_fn = _demand_fns(config, grid)

    mats = jnp.asarray(cameras.cam_to_world)
    if mats.ndim == 2:
        demand = int(demand_fn(scene, cameras))
    else:
        demand = int(peak_fn(scene, cameras))
    mult = capacity_mult_for_demand(demand, scene.means.shape[0], headroom,
                                    bucket)
    return dataclasses.replace(config, max_instance_mult=mult)


def render_batch(scene: GaussianScene, cameras: Camera, config: RenderConfig) -> jax.Array:
    """Render a camera batch -> [V, H, W, 4].

    The batch analog of the reference's camera-path cycling (`n`/`p` keys,
    ref: src/app.cpp:650-674) and of its stereo two-view loop
    (ref: src/app.cpp:603-607). Views run as a sequential `lax.map` (one
    compiled body, V executions): a vmap would batch every sort and kernel
    of the tiled pipeline at V times the memory. For cross-device view
    parallelism use parallel.render_batch_sharded, which shards the batch
    over the mesh's `views` axis instead.
    """
    return jax.lax.map(lambda cam: render(scene, cam, config), cameras)
