"""Camera, projection, rotation and color-space math (pure jnp, fully traceable).

Covers the math utilities of the reference's util layer (ref: src/core/util.cpp)
and the parameter-to-covariance bake of its scene import
(ref: src/gaussiancloud.cpp:86-94): quaternion -> rotation, cov = R S S^T R^T,
OpenGL-convention projection matrices (including the infinite-far and asymmetric
tan-angle variants of CreateProjection, ref: src/core/util.cpp:412-480), and
sRGB <-> linear conversion (ref: src/core/util.cpp:357-402).

Conventions (identical to the reference / OpenGL):
- camera-to-world matrices ("cameraMat") have -Z forward, +Y up, +X right;
  the view matrix is their inverse.
- clip space is right-handed GL: visible points have view-space z < 0,
  NDC in [-1, 1]^3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normalize(v, eps: float = 1e-12):
    """Safe normalize along the last axis."""
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.maximum(n, eps)


def quat_to_rotmat(q):
    """Quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3].

    Normalizes first, matching glm::mat3(glm::normalize(q)) in the reference
    covariance bake (ref: src/gaussiancloud.cpp:88-89).
    """
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        -2,
    )


def rotmat_to_quat(R):
    """Rotation matrix [..., 3, 3] -> quaternion (w, x, y, z), w >= 0.

    Branch-free Shepperd's method (all four candidate constructions computed,
    the best-conditioned one selected with where-masks) so it is jit/vmap safe.
    Used by covariance -> {rot, scale} export, the analog of the reference's
    Eigen path (ref: src/gaussiancloud.cpp:96-117).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = jnp.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = jnp.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], -1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], -1)

    # pick the construction whose pivot (first component pre-normalization) is largest
    pivots = jnp.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    best = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], -2)  # [..., 4(candidate), 4(wxyz)]
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = normalize(q)
    return jnp.where(q[..., :1] < 0, -q, q)


def bake_covariance(quats, log_scales):
    """{quat, log-scale} -> 3x3 covariance, cov = R S S^T R^T.

    The differentiable equivalent of the reference's import-time bake
    (ref: ComputeCovMatFromRotScale, src/gaussiancloud.cpp:86-94, with
    scale = exp(log_scale) per src/gaussiancloud.cpp:334-340).

    Written as explicit component arithmetic on [...]-shaped vectors rather
    than an einsum: batched 3x3 contractions lower to tiny dots with padded
    temporaries, while elementwise code fuses into one pass.
    """
    R = quat_to_rotmat(quats)  # [..., 3, 3]
    s2 = jnp.exp(2.0 * log_scales)  # diag of S S^T
    cols = []
    for i in range(3):
        row = []
        for j in range(3):
            acc = R[..., i, 0] * s2[..., 0] * R[..., j, 0]
            acc = acc + R[..., i, 1] * s2[..., 1] * R[..., j, 1]
            acc = acc + R[..., i, 2] * s2[..., 2] * R[..., j, 2]
            row.append(acc)
        cols.append(jnp.stack(row, axis=-1))
    return jnp.stack(cols, axis=-2)


def covariance_to_quat_scale(cov):
    """3x3 covariance -> ({quat wxyz}, scale). Inverse of bake_covariance.

    jnp.linalg.eigh replaces the reference's Eigen SelfAdjointEigenSolver
    (ref: ComputeRotScaleFromCovMat, src/gaussiancloud.cpp:96-117), including
    its det<0 flip so the eigenbasis is a proper rotation.
    """
    vals, vecs = jnp.linalg.eigh(cov)
    det = jnp.linalg.det(vecs)
    vecs = vecs * jnp.where(det < 0, -1.0, 1.0)[..., None, None]
    scale = jnp.sqrt(jnp.maximum(vals, 0.0))
    return rotmat_to_quat(vecs), scale


def look_at(eye, target, up):
    """Camera-to-world matrix with -Z pointing from eye toward target (GL style)."""
    eye = jnp.asarray(eye, jnp.float32)
    fwd = normalize(jnp.asarray(target, jnp.float32) - eye)
    right = normalize(jnp.cross(fwd, jnp.asarray(up, jnp.float32)))
    true_up = jnp.cross(right, fwd)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, 0].set(right)
    m = m.at[:3, 1].set(true_up)
    m = m.at[:3, 2].set(-fwd)
    m = m.at[:3, 3].set(eye)
    return m


def invert_rigid(mat):
    """Fast inverse of a rigid (rotation + translation) 4x4."""
    R = mat[..., :3, :3]
    t = mat[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    inv = jnp.zeros_like(mat)
    inv = inv.at[..., :3, :3].set(Rt)
    inv = inv.at[..., :3, 3].set(-jnp.einsum(
        "...ij,...j->...i", Rt, t, precision=jax.lax.Precision.HIGHEST))
    inv = inv.at[..., 3, 3].set(1.0)
    return inv


def perspective(fovy: float, aspect: float, near: float, far: float):
    """Symmetric GL projection from vertical FOV (radians). far <= near => infinite.

    Uses host math for the scalar tangent: a device computation here would
    force a device->host readback at camera-construction time.
    """
    import math

    tan_half = math.tan(fovy / 2.0)
    return projection_from_tan_angles(
        -tan_half * aspect, tan_half * aspect, tan_half, -tan_half, near, far
    )


def projection_from_tan_angles(tan_left, tan_right, tan_up, tan_down, near, far):
    """GL projection from asymmetric view-frustum tangents.

    Re-derivation of the reference's CreateProjection for the GRAPHICS_OPENGL
    branch (ref: src/core/util.cpp:412-480): offsetZ = nearZ, Y up, [-1,1] z
    clip space; far <= near places the far plane at infinity.
    """
    tw = tan_right - tan_left
    th = tan_up - tan_down
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(2.0 / tw)
    m = m.at[0, 2].set((tan_right + tan_left) / tw)
    m = m.at[1, 1].set(2.0 / th)
    m = m.at[1, 2].set((tan_up + tan_down) / th)
    if far <= near:
        m = m.at[2, 2].set(-1.0)
        m = m.at[2, 3].set(-2.0 * near)
    else:
        m = m.at[2, 2].set(-(far + near) / (far - near))
        m = m.at[2, 3].set(-(2.0 * far * near) / (far - near))
    m = m.at[3, 2].set(-1.0)
    return m


def srgb_to_linear(c):
    """Per-channel sRGB -> linear (ref: src/core/util.cpp:357-375,
    shader/splat_vert.glsl:130-140)."""
    c = jnp.asarray(c)
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power(jnp.maximum((c + 0.055) / 1.055, 0.0), 2.4))


def linear_to_srgb(c):
    """Per-channel linear -> sRGB (ref: src/core/util.cpp:377-402)."""
    c = jnp.asarray(c)
    return jnp.where(
        c <= 0.0031308,
        c * 12.92,
        1.055 * jnp.power(jnp.maximum(c, 1e-12), 1.0 / 2.4) - 0.055,
    )
