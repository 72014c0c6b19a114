"""EWA splat projection: 3D gaussians -> screen-space 2D gaussians + culling.

Re-derivation of the reference's vertex/geometry-shader math
(ref: shader/splat_vert.glsl:153-221, shader/splat_geom.glsl:34-87) and its
presort cull (ref: shader/presort_compute.glsl:42-56), as batched jnp over
[N] splats so it fuses into elementwise code and is differentiable end to
end.

Geometry conventions are GL: view space has -Z forward, clip w = -z_view,
screen coordinates have +y up with pixel centers at (i + 0.5, j + 0.5)
(gl_FragCoord semantics, which shader/splat_frag.glsl:20 relies on).

Numerical-parity constants, each cited where used:
  COV2D_DILATION = 0.3 px  (shader/splat_vert.glsl:193-196)
  EXTENT_SIGMA   = 3.5     (shader/splat_geom.glsl:58)
  PRESORT_CLIP   = 1.5     (shader/presort_compute.glsl:47)
  GUARD_NDC_Z    = 0.25, GUARD_NDC_XY = 2.0 (shader/splat_geom.glsl:48-51)
  ALPHA_CUTOFF   = 1/256   (shader/splat_frag.glsl:38) — applied in compositing
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

COV2D_DILATION = 0.3
EXTENT_SIGMA = 3.5
PRESORT_CLIP = 1.5
GUARD_NDC_Z = 0.25
GUARD_NDC_XY = 2.0
ALPHA_CUTOFF = 1.0 / 256.0


class ProjectedSplats(NamedTuple):
    """Per-splat screen-space quantities, all leading dim [N]."""

    mean2d: jnp.ndarray  # [N, 2] screen-space center in pixels (+y up)
    cov2d: jnp.ndarray  # [N, 3] packed 2D covariance (a, b, c) = (xx, xy, yy)
    conic: jnp.ndarray  # [N, 3] packed inverse covariance (A, B, C)
    depth: jnp.ndarray  # [N] positive view depth (= clip w = -z_view)
    mask: jnp.ndarray  # [N] bool, True = survives culling
    radius: jnp.ndarray  # [N] EXTENT_SIGMA * sqrt(major eigenvalue), px (0 if culled)
    extent: jnp.ndarray  # [N, 2] tight AABB half-extents (rx, ry), px (0 if culled)


def project_gaussians(
    means,  # [N, 3] world-space centers
    cov3,  # [N, 3, 3] world-space covariance
    view_mat,  # [4, 4] world -> view
    proj_mat,  # [4, 4] view -> clip (GL convention)
    viewport,  # (width, height) in pixels; offsets assumed 0
) -> ProjectedSplats:
    width, height = viewport

    # --- view transform t = V * p (ref: shader/splat_vert.glsl:157).
    # Explicit component sums keep the 3-long contractions elementwise.
    mx, my_, mz = means[:, 0], means[:, 1], means[:, 2]
    t = jnp.stack(
        [view_mat[i, 0] * mx + view_mat[i, 1] * my_ + view_mat[i, 2] * mz + view_mat[i, 3]
         for i in range(3)],
        axis=-1,
    )  # [N, 3]
    tz = t[:, 2]

    # --- perspective divide / NDC (ref: shader/splat_vert.glsl:200-203)
    def proj_row(i):
        return (proj_mat[i, 0] * t[:, 0] + proj_mat[i, 1] * t[:, 1]
                + proj_mat[i, 2] * t[:, 2] + proj_mat[i, 3])

    p_clip = jnp.stack([proj_row(0), proj_row(1), proj_row(2)], axis=-1)
    w_clip = proj_row(3)  # = -tz for GL projections
    depth = w_clip
    safe_w = jnp.where(jnp.abs(w_clip) < 1e-12, 1e-12, w_clip)
    ndc = p_clip / safe_w[:, None]  # [N, 3]

    mean2d = jnp.stack(
        [
            0.5 * (width + ndc[:, 0] * width),  # + X0 terms, offsets are 0
            0.5 * (height + ndc[:, 1] * height),
        ],
        axis=-1,
    )

    # --- culling: presort CLIP=1.5 + depth>0 (ref: shader/presort_compute.glsl:47-48)
    # and the geometry-shader guard band (ref: shader/splat_geom.glsl:46-54);
    # the det > 0 test joins below.
    front = (
        (depth > 0.0)
        & (jnp.abs(ndc[:, 0]) < PRESORT_CLIP)
        & (jnp.abs(ndc[:, 1]) < PRESORT_CLIP)
        & (ndc[:, 2] >= GUARD_NDC_Z)
        & (jnp.abs(ndc[:, 0]) <= GUARD_NDC_XY)
        & (jnp.abs(ndc[:, 1]) <= GUARD_NDC_XY)
    )

    # --- Jacobian of projection+viewport at t (ref: shader/splat_vert.glsl:167-181).
    # Only the top-left 2x2 of the projected covariance is kept, and J's third
    # row contributes nothing to it, so the z row (jtz) is dropped entirely.
    # The Jacobian divides by tz twice: for a culled splat near the camera
    # plane it overflows to inf, and in the backward inf * (zero cotangent)
    # is NaN. Culled splats therefore take a stand-in point one unit ahead
    # on the axis (their conic is never used); visible ones are unchanged.
    tx = jnp.where(front, t[:, 0], 0.0)
    ty = jnp.where(front, t[:, 1], 0.0)
    tz_j = jnp.where(front, tz, -1.0)
    sx = proj_mat[0, 0]
    sy = proj_mat[1, 1]
    safe_tz = jnp.where(jnp.abs(tz_j) < 1e-12, 1e-12, tz_j)
    inv_tz = 1.0 / safe_tz
    inv_tz2 = inv_tz * inv_tz
    jsx = -(sx * width) * 0.5 * inv_tz
    jsy = -(sy * height) * 0.5 * inv_tz
    jtx = (sx * width) * 0.5 * tx * inv_tz2
    jty = (sy * height) * 0.5 * ty * inv_tz2

    # JW: rows of the 2x3 matrix [[jsx,0,jtx],[0,jsy,jty]] times W = view rotation.
    # All contractions are written as explicit component sums on [N] vectors:
    # an einsum over 3-long axes would lower to tiny batched dots with
    # padded temporaries; this fuses into one elementwise pass.
    W = view_mat[:3, :3]
    jw0 = [jsx * W[0, k] + jtx * W[2, k] for k in range(3)]  # 3 x [N]
    jw1 = [jsy * W[1, k] + jty * W[2, k] for k in range(3)]
    # cov2d = (JW) V (JW)^T, top-left 2x2 (ref: shader/splat_vert.glsl:183-191)
    v0 = [sum(cov3[:, i, k] * jw0[k] for k in range(3)) for i in range(3)]  # V (JW row0)^T
    v1 = [sum(cov3[:, i, k] * jw1[k] for k in range(3)) for i in range(3)]
    a = sum(jw0[i] * v0[i] for i in range(3)) + COV2D_DILATION  # +0.3 px low-pass
    b = sum(jw0[i] * v1[i] for i in range(3))
    c = sum(jw1[i] * v1[i] for i in range(3)) + COV2D_DILATION
    cov2d = jnp.stack([a, b, c], axis=-1)

    # --- conic = inverse 2x2 (ref: shader/splat_geom.glsl:22-32)
    det = a * c - b * b
    safe_det = jnp.where(jnp.abs(det) < 1e-24, 1e-24, det)
    inv_det = 1.0 / safe_det
    conic = jnp.stack([c * inv_det, -b * inv_det, a * inv_det], axis=-1)

    mask = front & (det > 0.0)

    # --- screen extent from the covariance ellipse's major eigenvalue
    # (ref: shader/splat_geom.glsl:56-79). Only the scalar radius is needed for
    # tile binning; the reference's rotated-quad construction never clips any
    # pixel that passes the 1/256 alpha test (exp(-0.5 r^2) = 1/256 at r ~ 3.33
    # < 3.5 sigma), so a radius-based AABB is a strict superset of its coverage.
    mid = 0.5 * (a + c)
    term = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    lambda_max = mid + term
    radius = EXTENT_SIGMA * jnp.sqrt(jnp.maximum(lambda_max, 0.0))
    radius = jnp.where(mask, radius, 0.0)

    # Tight axis-aligned half-extents: the k-sigma ellipse spans exactly
    # +- k*sqrt(Sigma_xx) in x (and ..._yy in y), which is never larger than
    # the lambda_max square — fewer tile instances for anisotropic splats at
    # identical coverage (the 3.33-sigma discard radius stays inside 3.5).
    rx = EXTENT_SIGMA * jnp.sqrt(jnp.maximum(a, 0.0))
    ry = EXTENT_SIGMA * jnp.sqrt(jnp.maximum(c, 0.0))
    extent = jnp.where(mask[:, None], jnp.stack([rx, ry], axis=-1), 0.0)

    return ProjectedSplats(
        mean2d=mean2d, cov2d=cov2d, conic=conic, depth=depth, mask=mask,
        radius=radius, extent=extent,
    )


def view_dirs(means, eye):
    """Unit directions from the eye to each splat, for SH evaluation
    (ref: shader/splat_vert.glsl:205-206)."""
    d = means - jnp.asarray(eye)[None, :]
    n = jnp.linalg.norm(d, axis=-1, keepdims=True)
    return d / jnp.maximum(n, 1e-12)
