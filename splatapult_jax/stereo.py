"""Stereo rendering with SHARED tile binning.

The reference sorts once per frame and renders both eyes from the same sorted
order (ref: src/app.cpp:603-607). The analog here shares the *binning*: bin
once over the UNION of the two eyes' tile rects with the shared view depth,
then composite each eye through the same instance lists with its own exact
per-eye features.

Cost: the union rects inflate the instance capacity ~45% (2.49 vs 1.72
instances per splat at the 1M ball view) and with it every capacity-
proportional cost — binning, gather, BOTH eyes' composites — which the one
shared binning must pay back. The reference's trick works for its GLOBAL
depth sort; on a tile-binned pipeline the "shared" structure is capacity-
coupled. Whether it wins on the GPU is not measured; the CLI renders per-eye
unless asked (--shared-bins).

Why this is exact (with the default alpha cutoff), not an approximation:

- **Rect union.** The per-eye tile rect is the lossless opacity-tightened
  AABB (render.prepare_splats): every pixel outside it fails the reference's
  1/256 discard (shader/splat_frag.glsl:38-41). A superset rect therefore
  adds only instances whose per-pixel weights the composite zeroes exactly
  (ops/composite._weights compares the exponent against ln(cutoff)),
  so each eye's image equals what per-eye binning would produce.
- **Shared depth.** The eyes differ by a translation along the camera-right
  axis; view-space z is invariant to an in-plane x translation, so the
  back-to-front order is common to both eyes — the same invariance the
  reference's shared sort relies on. (Numerically the two eyes' depths can
  differ by ~1 ulp through the view-matrix inversion; the shared order
  resolves such near-ties by the deterministic index tie-break.)
- **Per-eye cull masks.** A splat culled for one eye but visible in the
  other rides the shared instance list; the culled eye's feature row gets
  conic = 0 and alpha = 0, making its exponent ln(alpha) = -85 — below the
  cutoff comparison, contributing exactly zero.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from splatapult_jax.ops.binning import bin_splats, instance_demand
from splatapult_jax.ops.composite import composite_from_feats
from splatapult_jax.ops.tiled import (
    _grid_from_config,
    assemble_image,
    pack_features,
)
from splatapult_jax.render import Camera, RenderConfig, prepare_splats


def _eye_cameras(camera: Camera, ipd) -> tuple[Camera, Camera]:
    eyes = camera.stereo_pair(ipd)
    left = Camera(cam_to_world=eyes.cam_to_world[0], proj=eyes.proj[0])
    right = Camera(cam_to_world=eyes.cam_to_world[1], proj=eyes.proj[1])
    return left, right


def _interval_union(c_a, r_a, c_b, r_b):
    """Union of per-splat 1-D intervals [c - r, c + r]; r <= 0 marks an empty
    interval (culled in that eye). Both empty -> (0, 0) = culled."""
    live_a = r_a > 0.0
    live_b = r_b > 0.0
    big = jnp.float32(3.4e38)
    lo = jnp.minimum(jnp.where(live_a, c_a - r_a, big),
                     jnp.where(live_b, c_b - r_b, big))
    hi = jnp.maximum(jnp.where(live_a, c_a + r_a, -big),
                     jnp.where(live_b, c_b + r_b, -big))
    any_live = live_a | live_b
    c = jnp.where(any_live, 0.5 * (lo + hi), 0.0)
    r = jnp.where(any_live, 0.5 * (hi - lo), 0.0)
    return c, r


def stereo_prepare(scene, camera: Camera, config: RenderConfig, ipd=0.064):
    """Per-eye splat dicts + the shared binning geometry.

    Returns (splats_left, splats_right, union_mean2d, union_extent) where the
    union rect covers both eyes' lossless per-eye rects and the shared depth
    is splats_left["depth"] (see module docstring for why it is common)."""
    left, right = _eye_cameras(camera, ipd)
    d_l = prepare_splats(scene, left, config, sort=False)
    d_r = prepare_splats(scene, right, config, sort=False)
    ng = jax.lax.stop_gradient
    ux, rx = _interval_union(
        ng(d_l["mean2d"][:, 0]), d_l["extent"][:, 0],
        ng(d_r["mean2d"][:, 0]), d_r["extent"][:, 0],
    )
    uy, ry = _interval_union(
        ng(d_l["mean2d"][:, 1]), d_l["extent"][:, 1],
        ng(d_r["mean2d"][:, 1]), d_r["extent"][:, 1],
    )
    union_mean2d = jnp.stack([ux, uy], axis=1)
    union_extent = jnp.stack([rx, ry], axis=1)
    return d_l, d_r, union_mean2d, union_extent


@functools.partial(jax.jit, static_argnames=("config",))
def render_stereo(scene, camera: Camera, config: RenderConfig,
                  ipd=0.064) -> jax.Array:
    """Render a stereo pair with ONE shared binning -> [2, H, W, 4].

    The batched-camera alternative (camera.stereo_pair + render_batch) runs
    the full binning per eye; this path shares it, the way the reference
    shares its per-frame sort across eyes (ref: src/app.cpp:603-607).
    """
    d_l, d_r, union_mean2d, union_extent = stereo_prepare(
        scene, camera, config, ipd)
    n = union_mean2d.shape[0]
    grid = _grid_from_config(config, n)
    bins = bin_splats(
        union_mean2d, union_extent, grid,
        depth=jax.lax.stop_gradient(d_l["depth"]),
    )

    imgs = []
    for d in (d_l, d_r):
        # a splat culled in THIS eye must contribute exactly zero even though
        # the shared list may carry it: zero its conic (its projection math
        # can be arbitrarily ill-conditioned behind the guard band) so the
        # exponent is ln(alpha) = ln(0) -> -85, below the discard cutoff
        conic = jnp.where(d["mask"][:, None], d["conic"], 0.0)
        feats = pack_features(d["mean2d"], conic, d["rgb"], d["alpha"])
        out = composite_from_feats(feats, bins, grid)
        imgs.append(assemble_image(out, bins["tile_ok"], grid, config))
    return jnp.stack(imgs)


def stereo_instance_demand(scene, camera: Camera, config: RenderConfig,
                           ipd=0.064):
    """Tile-instance demand of the SHARED stereo binning -> scalar int32
    (for capacity calibration; see render.calibrate_config)."""
    _, _, union_mean2d, union_extent = stereo_prepare(scene, camera, config, ipd)
    grid = _grid_from_config(config, scene.means.shape[0])
    return instance_demand(union_mean2d, union_extent, grid)


def calibrate_config_stereo(scene, camera: Camera, config: RenderConfig,
                            ipd=0.064, headroom: float = 1.06,
                            bucket: float | None = None) -> RenderConfig:
    """render.calibrate_config for the shared stereo binning: sizes the
    instance capacity from the measured UNION demand of both eyes (the
    single-view demand undersizes it — the union ran 2.49 vs 1.72
    inst/splat at the 1M bench view). The mult is
    bucketed onto the render.CAPACITY_BUCKET geometric grid for compile
    reuse across nearby poses (bucket=1.0 for exact)."""
    import dataclasses

    from splatapult_jax.render import CAPACITY_BUCKET, capacity_mult_for_demand

    demand = int(jax.jit(
        stereo_instance_demand, static_argnames=("config",)
    )(scene, camera, config, ipd))
    mult = capacity_mult_for_demand(
        demand, scene.means.shape[0], headroom,
        CAPACITY_BUCKET if bucket is None else bucket,
    )
    return dataclasses.replace(config, max_instance_mult=mult)
