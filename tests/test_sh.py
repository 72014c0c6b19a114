"""SH basis tests against the literal shader constants
(ref: shader/splat_vert.glsl:51-127; SURVEY.md section 4, item 2)."""

import numpy as np
import jax.numpy as jnp

from splatapult_jax.core.sh import NUM_COEFFS, eval_sh_radiance, sh_basis


def _shader_basis(v):
    """Direct transcription of the constants table for one direction (oracle)."""
    x, y, z = v
    x2, y2, z2 = x * x, y * y, z * z
    k1 = 0.4886025119029199
    k2 = 1.0925484305920792
    k3 = 0.31539156525252005
    k4 = 0.5462742152960396
    k5 = 0.5900435899266435
    k6 = 2.8906114426405543
    k7 = 0.4570457994644658
    k8 = 0.37317633259011546
    k9 = 1.4453057213202771
    return np.asarray(
        [
            0.28209479177387814,
            -k1 * y, k1 * z, -k1 * x,
            k2 * y * x, -k2 * y * z, k3 * (3 * z2 - 1), -k2 * x * z, k4 * (x2 - y2),
            -k5 * y * (3 * x2 - y2), k6 * y * x * z, -k7 * y * (5 * z2 - 1),
            k8 * z * (5 * z2 - 3), -k7 * x * (5 * z2 - 1), k9 * z * (x2 - y2),
            -k5 * x * (x2 - 3 * y2),
        ]
    )


def test_basis_matches_shader_constants(rng):
    dirs = rng.standard_normal((16, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    got = np.asarray(sh_basis(jnp.asarray(dirs, jnp.float32), degree=3))
    want = np.stack([_shader_basis(v) for v in dirs])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_basis_degree_prefix(rng):
    dirs = rng.standard_normal((8, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    d3 = np.asarray(sh_basis(jnp.asarray(dirs), 3))
    for deg in (0, 1, 2):
        dd = np.asarray(sh_basis(jnp.asarray(dirs), deg))
        assert dd.shape[-1] == NUM_COEFFS[deg]
        np.testing.assert_allclose(dd, d3[:, : NUM_COEFFS[deg]], atol=1e-7)


def test_radiance_offset_and_dc():
    # deg-0: color = 0.5 + k0 * f_dc (ref: shader/splat_vert.glsl:122-126)
    sh = jnp.zeros((2, 3, 1)).at[0, 0, 0].set(1.0)
    dirs = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    rgb = np.asarray(eval_sh_radiance(sh, dirs))
    np.testing.assert_allclose(rgb[0], [0.5 + 0.28209479177387814, 0.5, 0.5], atol=1e-6)
    np.testing.assert_allclose(rgb[1], [0.5, 0.5, 0.5], atol=1e-7)


def test_radiance_truncation_equals_zeroed_tail(rng):
    sh = jnp.asarray(rng.standard_normal((4, 3, 16)), jnp.float32)
    dirs = rng.standard_normal((4, 3))
    dirs = jnp.asarray(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True), jnp.float32)
    trunc = eval_sh_radiance(sh, dirs, degree=1)
    zeroed = eval_sh_radiance(sh.at[:, :, 4:].set(0.0), dirs, degree=3)
    np.testing.assert_allclose(np.asarray(trunc), np.asarray(zeroed), atol=1e-5)
