"""Procedural garden-scale scene: BASELINE config 3's stand-in for
Mip-NeRF-360 "garden" (~1.5M splats, SH degree 3).

No real captured scene ships with either repo (the reference's only fixture is
the 16-splat data/test.ply and its procedural debug cloud,
ref: src/gaussiancloud.cpp:505-578); this module extends that idea to a
full-scale procedural scene whose *summary statistics* match what the INRIA
trainer produces on garden-class captures, so kernels and benchmarks face the
real workload shape rather than a uniform random ball:

- **Layout**: a ground disk, a central table+plant subject, shrub clusters,
  and a distant background shell — the camera orbit sees a mix of near
  large-footprint and far sub-pixel splats, with a large fraction of the
  scene outside any single view's frustum (real captures cull 40-60%%).
- **Surfel anisotropy**: trained splats flatten onto surfaces; ground/table
  splats get a normal-aligned short axis (~25%% of tangent scale).
- **Scale ~ local spacing**: each component's splat scale tracks its mean
  inter-splat spacing (lognormal spread), the equilibrium densification
  reaches — screen footprints of a few pixels at viewing distance.
- **Bimodal opacity**: trained opacity histograms pile up near 1 with a low-
  alpha haze tail; logits are a 65/35 mixture of N(2.2, 1.2) and N(-0.5, 1.5).
- **SH energy decay**: band-ℓ coefficients shrink ~1/(1+ℓ); view-dependent
  sparkle without dominating the DC term.

Deterministic in (num_splats, seed); ~1 s for 1.5M splats. Export through
io.gaussians.save_gaussian_ply produces a trainer-schema .ply the reference
itself could load.
"""

from __future__ import annotations

import numpy as np

from splatapult_jax.io.gaussians import SH_C0, GaussianScene, _scene_from_arrays


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _quat_align_z(normals, rng):
    """Quaternions (w,x,y,z) rotating local +Z onto ``normals`` with a random
    roll about the normal (surfels have no preferred tangent direction)."""
    n = normals.shape[0]
    z = np.asarray([0.0, 0.0, 1.0], np.float32)
    nrm = _unit(normals.astype(np.float32))
    # rotation taking z -> nrm: axis = z x n, angle = acos(z . n)
    axis = np.cross(np.tile(z, (n, 1)), nrm)
    s = np.linalg.norm(axis, axis=-1)
    c = nrm[:, 2]
    axis = np.where(s[:, None] > 1e-6, axis / np.maximum(s[:, None], 1e-12),
                    np.asarray([1.0, 0.0, 0.0], np.float32))
    half = 0.5 * np.arctan2(s, c)
    q_align = np.concatenate([np.cos(half)[:, None],
                              np.sin(half)[:, None] * axis], axis=1)
    # roll about local z, applied first: q = q_align * q_roll
    phi = rng.uniform(0.0, np.pi, n).astype(np.float32)
    q_roll = np.stack([np.cos(phi), np.zeros(n, np.float32),
                       np.zeros(n, np.float32), np.sin(phi)], axis=1)
    w1, x1, y1, z1 = q_align.T
    w2, x2, y2, z2 = q_roll.T
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=1).astype(np.float32)


def _random_quats(n, rng):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _component(rng, n, positions, normals, albedo, albedo_jitter, spacing,
               surfel: bool, scale_spread=0.45):
    """Common per-component splat parameter synthesis."""
    base = np.log(np.maximum(spacing, 1e-5)).astype(np.float32)
    tangent = base + rng.normal(0.0, scale_spread, n).astype(np.float32)
    if surfel:
        log_scales = np.stack(
            [tangent, tangent + rng.normal(0.0, 0.2, n).astype(np.float32),
             tangent + np.float32(np.log(0.25))], axis=1)
        quats = _quat_align_z(normals, rng)
    else:
        log_scales = tangent[:, None] + rng.normal(0.0, 0.25, (n, 3)).astype(np.float32)
        quats = _random_quats(n, rng)
    color = np.clip(
        albedo[None, :] * (1.0 + rng.normal(0.0, albedo_jitter, (n, 3))),
        0.0, 1.0,
    ).astype(np.float32)
    return positions.astype(np.float32), log_scales, quats, color


def make_garden_scene(num_splats: int = 1_500_000, seed: int = 0) -> GaussianScene:
    """Garden-class procedural scene (see module docstring)."""
    rng = np.random.default_rng(seed)
    fractions = {  # component mix
        "ground": 0.42, "table": 0.08, "plant": 0.10, "shrubs": 0.22,
        "background": 0.18,
    }
    counts = {k: int(num_splats * f) for k, f in fractions.items()}
    counts["ground"] += num_splats - sum(counts.values())

    parts = []

    # --- ground: disk of radius 12 m with capture-driven densification —
    # the trainer spends splats where cameras resolve detail, i.e. near the
    # orbit (radius ~4.2 m) and the subject. 60% of ground splats follow a
    # half-normal band around r=3, the rest cover the disk uniformly.
    n = counts["ground"]
    n_band = int(0.6 * n)
    r = np.concatenate([
        np.clip(np.abs(rng.normal(3.0, 2.2, n_band)), 0.0, 12.0),
        12.0 * np.sqrt(rng.uniform(0.0, 1.0, n - n_band)),
    ])
    th = rng.uniform(0.0, 2 * np.pi, n)
    pos = np.stack([r * np.cos(th),
                    rng.normal(0.0, 0.02, n) + 0.03 * np.sin(3 * th) * r / 12.0,
                    r * np.sin(th)], axis=1)
    nrm = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32), (n, 1))
    # local spacing from the sampling pdf: density(r) = n*p(r) / (2 pi r)
    p_band = (np.exp(-0.5 * ((r - 3.0) / 2.2) ** 2)
              + np.exp(-0.5 * ((r + 3.0) / 2.2) ** 2)) / (2.2 * np.sqrt(2 * np.pi))
    p_r = 0.6 * p_band + 0.4 * (2.0 * r / 144.0)
    density = np.maximum(n * p_r / np.maximum(2 * np.pi * r, 0.5), 1.0)
    spacing = 1.0 / np.sqrt(density)
    parts.append(_component(rng, n, pos, nrm, np.asarray([0.22, 0.32, 0.12]),
                            0.35, 1.8 * spacing, surfel=True))

    # --- table: torus (the garden's round table), r_major 0.55, r_minor 0.16
    n = counts["table"]
    u = rng.uniform(0.0, 2 * np.pi, n)
    v = rng.uniform(0.0, 2 * np.pi, n)
    rm, rt = 0.55, 0.16
    pos = np.stack([(rm + rt * np.cos(v)) * np.cos(u),
                    0.75 + rt * np.sin(v),
                    (rm + rt * np.cos(v)) * np.sin(u)], axis=1)
    nrm = np.stack([np.cos(v) * np.cos(u), np.sin(v), np.cos(v) * np.sin(u)], axis=1)
    spacing = np.sqrt(4 * np.pi**2 * rm * rt / max(n, 1))
    parts.append(_component(rng, n, pos, nrm, np.asarray([0.55, 0.48, 0.40]),
                            0.15, 1.8 * spacing, surfel=True))

    # --- plant: foliage ball above the table center
    n = counts["plant"]
    d = rng.standard_normal((n, 3))
    d = _unit(d) * (rng.uniform(0.25, 1.0, (n, 1)) ** (1 / 3))
    pos = d * np.asarray([0.35, 0.45, 0.35]) + np.asarray([0.0, 1.35, 0.0])
    spacing = (4 / 3 * np.pi * 0.35 * 0.45 * 0.35 / max(n, 1)) ** (1 / 3)
    parts.append(_component(rng, n, pos, d, np.asarray([0.15, 0.38, 0.10]),
                            0.45, 1.8 * spacing, surfel=False))

    # --- shrubs: gaussian clusters on a ring
    n = counts["shrubs"]
    k = 14
    centers_th = rng.uniform(0.0, 2 * np.pi, k)
    centers_r = rng.uniform(6.0, 11.0, k)
    centers = np.stack([centers_r * np.cos(centers_th),
                        rng.uniform(0.4, 1.4, k),
                        centers_r * np.sin(centers_th)], axis=1)
    sizes = rng.uniform(0.5, 1.6, k)
    which = rng.integers(0, k, n)
    pos = centers[which] + rng.standard_normal((n, 3)) * sizes[which, None] * [1.0, 0.8, 1.0]
    pos[:, 1] = np.abs(pos[:, 1]) + 0.05
    vol = np.sum(4 / 3 * np.pi * sizes**3 * 0.8)
    spacing = (vol / max(n, 1)) ** (1 / 3)
    parts.append(_component(rng, n, pos, _unit(pos - centers[which]),
                            np.asarray([0.18, 0.30, 0.12]), 0.40,
                            1.6 * spacing, surfel=False))

    # --- background: distant wall/canopy shell band (radius 15-25 m)
    n = counts["background"]
    th = rng.uniform(0.0, 2 * np.pi, n)
    rr = rng.uniform(15.0, 25.0, n)
    y = rng.uniform(0.0, 12.0, n) * (0.3 + 0.7 * rng.uniform(0.0, 1.0, n))
    pos = np.stack([rr * np.cos(th), y, rr * np.sin(th)], axis=1)
    nrm = -np.stack([np.cos(th), np.zeros(n), np.sin(th)], axis=1)
    # background splats are coarse: trained models spend few, large splats on
    # far content (each must still cover a few pixels from 20 m away)
    area = 2 * np.pi * 20.0 * 12.0
    spacing = np.sqrt(area / max(n, 1))
    sky = rng.uniform(0.0, 1.0, n) < 0.25
    albedo = np.where(sky[:, None], np.asarray([0.55, 0.65, 0.85]),
                      np.asarray([0.25, 0.30, 0.22]))
    p, ls, q, c = _component(rng, n, pos, nrm, np.asarray([1.0, 1.0, 1.0]),
                             0.0, 1.6 * spacing, surfel=True)
    c = np.clip(albedo * (1.0 + rng.normal(0.0, 0.25, (n, 3))), 0, 1).astype(np.float32)
    parts.append((p, ls, q, c))

    means = np.concatenate([p[0] for p in parts])
    log_scales = np.concatenate([p[1] for p in parts])
    quats = np.concatenate([p[2] for p in parts])
    colors = np.concatenate([p[3] for p in parts])
    n_all = means.shape[0]

    # Angular-footprint clamp: trained splats converge to screen footprints of
    # roughly 0.5-8 px sigma as seen from the capture cameras — densification
    # splits anything larger, pruning removes sub-resolution dust. Shift each
    # splat's log-scales (preserving anisotropy) so its major axis lands in
    # that band as seen from the orbit (radius 4.2 m, height 1.6 m, fovy 45deg
    # at 1080 rows -> focal ~1304 px/unit).
    focal = 1080.0 / (2.0 * np.tan(np.pi / 8.0))
    r_xz = np.linalg.norm(means[:, [0, 2]], axis=1)
    d_cam = np.sqrt((r_xz - 4.2) ** 2 + (means[:, 1] - 1.6) ** 2) + 0.3
    major = np.max(log_scales, axis=1)
    sigma_px = np.exp(major) * focal / d_cam
    shift = (np.clip(np.log(8.0 / np.maximum(sigma_px, 1e-6)), None, 0.0)
             + np.clip(np.log(0.5 / np.maximum(sigma_px, 1e-6)), 0.0, None))
    log_scales = log_scales + shift[:, None].astype(np.float32)

    # bimodal trained-opacity mixture (logits)
    hi = rng.uniform(0.0, 1.0, n_all) < 0.65
    opacities = np.where(hi, rng.normal(2.2, 1.2, n_all),
                         rng.normal(-0.5, 1.5, n_all)).astype(np.float32)

    # SH: DC encodes albedo (color = 0.5 + SH_C0 * dc, ref shader/splat_vert.
    # glsl:126), higher bands random with 1/(1+l) energy decay
    sh = np.zeros((n_all, 3, 16), np.float32)
    sh[:, :, 0] = (colors - 0.5) / SH_C0
    band = np.asarray([1] * 3 + [2] * 5 + [3] * 7, np.float32)
    sh[:, :, 1:] = (rng.standard_normal((n_all, 3, 15)) * 0.12
                    / (1.0 + band)[None, None, :])

    perm = rng.permutation(n_all)  # no component ordering artifacts
    return _scene_from_arrays(means[perm], sh[perm], opacities[perm],
                              log_scales[perm], quats[perm])


def garden_cameras(num_views: int = 1, radius: float = 4.2, height: float = 1.6,
                   target=(0.0, 0.8, 0.0), width: int = 1920, height_px: int = 1080,
                   fovy: float = np.pi / 4):
    """Orbit camera ring like a garden capture pass -> Camera ([V]-batched
    when num_views > 1). The orbit matches the reference's camera-path
    cycling capability (ref: src/app.cpp:650-674)."""
    import jax.numpy as jnp

    from splatapult_jax.core import transforms as T
    from splatapult_jax.render import Camera

    cams = [
        Camera.from_fov(
            T.look_at(eye=[np.cos(a) * radius, height, np.sin(a) * radius],
                      target=list(target), up=[0.0, 1.0, 0.0]),
            fovy=fovy, width=width, height=height_px,
        )
        for a in np.linspace(0.0, 2 * np.pi, num_views, endpoint=False)
    ]
    if num_views == 1:
        return cams[0]
    from splatapult_jax.render import Camera as C

    return C(cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
             proj=jnp.stack([c.proj for c in cams]))
