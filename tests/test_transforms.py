"""Math-core unit tests: rotations, covariance bake, projections, sRGB
(SURVEY.md section 4, item 2)."""

import numpy as np
import jax
import jax.numpy as jnp

from splatapult_jax.core import transforms as T


def _random_quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_to_rotmat_orthonormal(rng):
    q = _random_quats(rng, 32)
    R = np.asarray(T.quat_to_rotmat(q))
    eye = np.einsum("nij,nkj->nik", R, R)
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (32, 1, 1)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_quat_rotmat_roundtrip(rng):
    q = _random_quats(rng, 64)
    q = np.where(q[:, :1] < 0, -q, q)  # canonical hemisphere
    R = T.quat_to_rotmat(q)
    q2 = np.asarray(T.rotmat_to_quat(R))
    np.testing.assert_allclose(q2, q, atol=1e-4)


def test_bake_covariance_psd_and_roundtrip(rng):
    n = 48
    q = _random_quats(rng, n)
    log_s = rng.uniform(-3.0, 0.5, (n, 3)).astype(np.float32)
    cov = np.asarray(T.bake_covariance(q, log_s))
    np.testing.assert_allclose(cov, np.swapaxes(cov, -1, -2), atol=1e-6)
    evals = np.linalg.eigvalsh(cov)
    assert (evals > 0).all()
    # eigendecomposition-based export (the reference's Eigen path,
    # ref: src/gaussiancloud.cpp:96-117) must reproduce the same covariance
    q2, s2 = T.covariance_to_quat_scale(cov)
    cov2 = np.asarray(T.bake_covariance(q2, jnp.log(s2)))
    np.testing.assert_allclose(cov2, cov, atol=1e-5)


def test_look_at_and_invert_rigid():
    cam = T.look_at(eye=[1.0, 2.0, 3.0], target=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0])
    cam = np.asarray(cam)
    # -Z column points from eye toward target
    fwd = -cam[:3, 2]
    expect = -np.asarray([1.0, 2.0, 3.0]) / np.linalg.norm([1.0, 2.0, 3.0])
    np.testing.assert_allclose(fwd, expect, atol=1e-6)
    inv = np.asarray(T.invert_rigid(jnp.asarray(cam)))
    np.testing.assert_allclose(inv @ cam, np.eye(4), atol=1e-6)


def test_perspective_matches_gl_convention():
    # with fovy=90deg, aspect=1: points on the frustum edge map to |ndc| = 1
    P = np.asarray(T.perspective(np.pi / 2, 1.0, 0.1, 100.0))
    p = P @ np.asarray([1.0, 0.0, -1.0, 1.0])  # x = |z| at 45 deg
    np.testing.assert_allclose(p[0] / p[3], 1.0, atol=1e-6)
    near = P @ np.asarray([0.0, 0.0, -0.1, 1.0])
    far = P @ np.asarray([0.0, 0.0, -100.0, 1.0])
    np.testing.assert_allclose(near[2] / near[3], -1.0, atol=1e-5)
    np.testing.assert_allclose(far[2] / far[3], 1.0, atol=1e-5)
    assert p[3] == 1.0  # w = -z_view


def test_infinite_far_projection():
    # far <= near places far plane at infinity (ref: src/core/util.cpp:435-457)
    P = np.asarray(T.projection_from_tan_angles(-1.0, 1.0, 1.0, -1.0, 0.1, 0.0))
    assert P[2, 2] == -1.0
    near = P @ np.asarray([0.0, 0.0, -0.1, 1.0])
    np.testing.assert_allclose(near[2] / near[3], -1.0, atol=1e-6)
    far = P @ np.asarray([0.0, 0.0, -1e9, 1.0])
    np.testing.assert_allclose(far[2] / far[3], 1.0, atol=1e-5)


def test_asymmetric_projection_center():
    # asymmetric frustum (VR-style, ref: src/core/util.cpp:412-480): the
    # tan-angle midpoint must map to ndc 0
    tl, tr, tu, td = -0.5, 1.5, 1.0, -0.25
    P = np.asarray(T.projection_from_tan_angles(tl, tr, tu, td, 0.1, 100.0))
    mid_x, mid_y = (tl + tr) / 2, (tu + td) / 2
    p = P @ np.asarray([mid_x * 2.0, mid_y * 2.0, -2.0, 1.0])
    np.testing.assert_allclose(p[:2] / p[3], 0.0, atol=1e-6)


def test_srgb_roundtrip():
    c = jnp.linspace(0.0, 1.0, 64)
    np.testing.assert_allclose(
        np.asarray(T.srgb_to_linear(T.linear_to_srgb(c))), np.asarray(c), atol=1e-6
    )
    # spot values of the piecewise curve (ref: src/core/util.cpp:357-375)
    np.testing.assert_allclose(float(T.srgb_to_linear(0.04045)), 0.04045 / 12.92, atol=1e-7)
    np.testing.assert_allclose(float(T.srgb_to_linear(1.0)), 1.0, atol=1e-6)


def test_transforms_jit_and_grad():
    q = jnp.asarray([[0.9, 0.1, 0.2, 0.3]])
    ls = jnp.asarray([[-1.0, -2.0, 0.5]])

    def loss(q, ls):
        return jnp.sum(T.bake_covariance(q, ls) ** 2)

    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(q, ls)
    assert all(np.isfinite(np.asarray(x)).all() for x in g)
