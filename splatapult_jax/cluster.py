"""Camera-path rendering with SHARED tile binning across view clusters.

stereo.render_stereo built the machinery for view PAIRS: bin once over the
union of both views' lossless tile rects with a shared depth, composite each
view with its own exact features. This module generalizes it to the
camera-path workload (BASELINE config 4; the reference's `n`/`p` camera
cycling, ref: src/app.cpp:650-674), the way the reference shares its
per-frame sort across the stereo pair (ref: src/app.cpp:603-607).

Cost: the union rects inflate the instance capacity (+13% at k=2, +41% at
k=4 on a 1.1-degree-step path over the 1M ball) and every capacity-
proportional cost (gather, composite, backward) for EVERY view, which the
one shared binning must pay back; the reference's shared GLOBAL sort does
not obviously lift to a tile-binned pipeline (see stereo.py). Whether it
wins on the GPU is not measured. The machinery is exactness-tested.

Exactness differs from stereo, and the difference is explicit:

- **Rect union** stays lossless exactly as in stereo: union rects only add
  instances whose per-pixel weights the composite zeroes (the 1/256 cutoff
  comparison), so coverage is exact for every view.
- **Shared depth is an APPROXIMATION here.** Stereo's eyes differ by a pure
  in-plane translation, leaving view depth invariant; path steps also move
  ALONG the view axis and rotate, so the cluster renders every view in the
  REFERENCE view's back-to-front order. Two splats composite in the wrong
  order for a non-reference view only if their reference-depth order differs
  from that view's true order, i.e. only when their depth separation is
  smaller than the pose delta's depth perturbation (|dz| + O(theta * r)).
  This is the same class of approximation as the production depth_bits=16
  key (which orders by bf16 depth, ~0.4% relative) — and it is bounded by
  the cluster gate below, tested against per-view rendering, and always
  optional (cluster_size=1 is exact per-view rendering).
- **Per-view cull masks** as in stereo: a splat culled for one view rides
  the shared list with conic = 0, alpha = 0 -> exponent below the cutoff,
  contributing exactly zero to that view.

Clustering policy (`cluster_size` consecutive views per cluster) matches the
path workload: consecutive path cameras overlap most. `max_depth_shift`
gates sharing — a cluster whose poses move more than that fraction of the
scene's depth scale along the reference view axis (or rotate more than the
equivalent) falls back to per-view rendering for its views, so distant path
segments never silently share an order they shouldn't.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from splatapult_jax.ops.binning import bin_splats, instance_demand
from splatapult_jax.ops.composite import composite_from_feats
from splatapult_jax.ops.tiled import _grid_from_config, assemble_image, pack_features
from splatapult_jax.render import Camera, RenderConfig, prepare_splats
from splatapult_jax.stereo import _interval_union


def _view_camera(cameras: Camera, i) -> Camera:
    return Camera(cam_to_world=cameras.cam_to_world[i], proj=cameras.proj[i])


def prepare_cluster(scene, cameras: Camera, config: RenderConfig):
    """Per-view splat dicts + union binning geometry for a [K]-batched camera.

    Returns (per-view dicts list, union_mean2d, union_extent); the shared
    binning depth is view 0's (the cluster reference)."""
    k = cameras.cam_to_world.shape[0]
    ds = [prepare_splats(scene, _view_camera(cameras, i), config, sort=False)
          for i in range(k)]
    ng = jax.lax.stop_gradient
    ux, rx = ng(ds[0]["mean2d"][:, 0]), ds[0]["extent"][:, 0]
    uy, ry = ng(ds[0]["mean2d"][:, 1]), ds[0]["extent"][:, 1]
    for d in ds[1:]:
        ux, rx = _interval_union(ux, rx, ng(d["mean2d"][:, 0]), d["extent"][:, 0])
        uy, ry = _interval_union(uy, ry, ng(d["mean2d"][:, 1]), d["extent"][:, 1])
    return ds, jnp.stack([ux, uy], axis=1), jnp.stack([rx, ry], axis=1)


@functools.partial(jax.jit, static_argnames=("config",))
def render_cluster(scene, cameras: Camera, config: RenderConfig) -> jax.Array:
    """Render a [K]-batched camera cluster with ONE shared binning -> [K, H, W, 4].

    The binning (instance sort machinery) runs once on the union rects with
    the reference view's depth; each view composites the shared instance
    lists with its own exact features. Differentiable: gradients flow through
    every view's features and sum on the shared splats."""
    ds, union_mean2d, union_extent = prepare_cluster(scene, cameras, config)
    grid = _grid_from_config(config, union_mean2d.shape[0])
    bins = bin_splats(
        union_mean2d, union_extent, grid,
        depth=jax.lax.stop_gradient(ds[0]["depth"]),
    )
    imgs = []
    for d in ds:
        conic = jnp.where(d["mask"][:, None], d["conic"], 0.0)
        feats = pack_features(d["mean2d"], conic, d["rgb"], d["alpha"])
        out = composite_from_feats(feats, bins, grid)
        imgs.append(assemble_image(out, bins["tile_ok"], grid, config))
    return jnp.stack(imgs)


def cluster_instance_demand(scene, cameras: Camera, config: RenderConfig):
    """Tile-instance demand of a cluster's SHARED binning -> scalar int32."""
    _, union_mean2d, union_extent = prepare_cluster(scene, cameras, config)
    grid = _grid_from_config(config, scene.means.shape[0])
    return instance_demand(union_mean2d, union_extent, grid)


def calibrate_config_cluster(scene, cameras: Camera, config: RenderConfig,
                             cluster_size: int = 4,
                             headroom: float = 1.06,
                             bucket: float | None = None) -> RenderConfig:
    """Size the instance capacity for the peak UNION demand across the path's
    clusters (the single-view demand undersizes a shared binning; cf.
    stereo.calibrate_config_stereo). Bucketed for compile reuse."""
    from splatapult_jax.render import CAPACITY_BUCKET, capacity_mult_for_demand

    jd = jax.jit(cluster_instance_demand, static_argnames=("config",))
    v = cameras.cam_to_world.shape[0]
    peak = 0
    for c0 in range(0, v, cluster_size):
        sub = _slice_cameras(cameras, c0, min(c0 + cluster_size, v))
        peak = max(peak, int(jd(scene, sub, config)))
    mult = capacity_mult_for_demand(
        peak, scene.means.shape[0], headroom,
        CAPACITY_BUCKET if bucket is None else bucket,
    )
    return dataclasses.replace(config, max_instance_mult=mult)


def _slice_cameras(cameras: Camera, a: int, b: int) -> Camera:
    return Camera(cam_to_world=cameras.cam_to_world[a:b],
                  proj=cameras.proj[a:b])


def scene_depth_scale(scene) -> float:
    """Rotation-to-depth lever arm for the gate below: the 99th-percentile
    splat distance from the scene centroid, in world units. A rotation theta
    perturbs the depth of content at radius r by up to ~theta * r, so the
    lever arm must be the scene's CONTENT radius — a hardcoded 1.0 under-
    estimates the induced error by 25x for a capture whose background shell
    sits at 25 m."""
    means = np.asarray(scene.means)
    c = means.mean(axis=0)
    return float(np.percentile(np.linalg.norm(means - c, axis=1), 99.0))


def cluster_shareable(cameras: Camera, max_depth_shift: float,
                      r_scale: float = 1.0) -> bool:
    """Conservative host-side gate: every non-reference view's pose must stay
    depth-compatible with the reference view's back-to-front order.

    The depth perturbation a pose delta induces on a splat at distance r is
    |dz| (translation along the reference view axis) + 2 sin(theta/2) * r
    (rotation); with r bounded by the scene content radius ``r_scale``
    (see scene_depth_scale) we gate on |dz| + theta * r_scale <=
    max_depth_shift. Units are world units, so callers pass a tolerance
    scaled to their scene (e.g. 0.5% of the scene radius — the same order
    as the depth16 key's relative precision)."""
    mats = np.asarray(cameras.cam_to_world)
    ref = mats[0]
    fwd = -ref[:3, 2]  # GL convention: -Z forward
    for m in mats[1:]:
        dz = abs(float(np.dot(m[:3, 3] - ref[:3, 3], fwd)))
        # rotation angle between the two orientations
        rot = ref[:3, :3].T @ m[:3, :3]
        cos_t = np.clip((np.trace(rot) - 1.0) / 2.0, -1.0, 1.0)
        # f32 pose matrices put identical rotations ~1e-7 below trace 3;
        # arccos amplifies that to ~5e-4 rad — snap numeric noise to zero
        theta = 0.0 if cos_t > 1.0 - 1e-6 else float(np.arccos(cos_t))
        if dz + theta * r_scale > max_depth_shift:
            return False
    return True


def render_path_clustered(scene, cameras: Camera, config: RenderConfig,
                          cluster_size: int = 4,
                          max_depth_shift: float | str | None = "auto") -> jax.Array:
    """Render a [V]-batched camera path, sharing binning across clusters of
    ``cluster_size`` consecutive views -> [V, H, W, 4].

    Clusters whose poses exceed ``max_depth_shift`` (see cluster_shareable)
    fall back to exact per-view rendering — both bodies compile once per
    cluster size. The default "auto" gates at 0.5% of the scene's content
    radius (scene_depth_scale) with that radius as the rotation lever arm —
    so distant path segments never silently share an order they shouldn't;
    pass ``None`` to EXPLICITLY opt into ungated sharing (an always-share
    default would contradict the module's safety promise).
    cluster_size=1 is exact per-view rendering everywhere."""
    from splatapult_jax.render import render

    r_scale = 1.0
    if max_depth_shift == "auto":
        r_scale = max(scene_depth_scale(scene), 1e-6)
        max_depth_shift = 0.005 * r_scale
    v = cameras.cam_to_world.shape[0]
    outs = []
    for c0 in range(0, v, cluster_size):
        sub = _slice_cameras(cameras, c0, min(c0 + cluster_size, v))
        k = sub.cam_to_world.shape[0]
        share = k > 1 and (max_depth_shift is None
                           or cluster_shareable(sub, max_depth_shift, r_scale))
        if share:
            outs.append(render_cluster(scene, sub, config))
        else:
            outs.append(jnp.stack([
                render(scene, _view_camera(sub, i), config) for i in range(k)
            ]))
    return jnp.concatenate(outs, axis=0)
