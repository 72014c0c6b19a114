"""Seeded generator for the tests' 16-splat scene fixture.

Writes ``test.ply`` (16 splats, SH degree 3, the INRIA trainer's vertex
layout) and its ``test_vr.json`` floor pose into a directory. Nothing is
downloaded: the same seed always gives the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

NUM_SPLATS = 16
SEED = 16
# floor pose: a rotation about +Y and this translation (m[:3, 3])
VR_TRANSLATION = (-0.573335, -1.78893, -0.512137)
VR_YAW = 0.61


def make_test_scene(seed: int = SEED):
    """16 splats in a ball of radius ~0.6 around the origin."""
    import jax.numpy as jnp

    from splatapult_jax.io.gaussians import GaussianScene

    rng = np.random.default_rng(seed)
    n = NUM_SPLATS
    sh = np.zeros((n, 3, 16), np.float32)
    sh[:, :, 0] = rng.uniform(-0.5, 1.5, (n, 3))
    sh[:, :, 1:] = rng.normal(0.0, 0.08, (n, 3, 15))
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    return GaussianScene(
        means=jnp.asarray(rng.uniform(-0.6, 0.6, (n, 3)), jnp.float32),
        sh=jnp.asarray(sh),
        opacities=jnp.asarray(rng.uniform(-0.5, 3.0, (n,)), jnp.float32),
        log_scales=jnp.asarray(rng.uniform(-2.8, -1.6, (n, 3)), jnp.float32),
        quats=jnp.asarray(quats),
    )


def vr_floor_matrix() -> np.ndarray:
    """The fixture's 4x4 floorMat (row-major, last row [0, 0, 0, 1])."""
    c, s = np.cos(VR_YAW), np.sin(VR_YAW)
    m = np.eye(4)
    m[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    m[:3, 3] = VR_TRANSLATION
    return m.astype(np.float32)


def write_fixture(directory: str) -> str:
    """Write test.ply + test_vr.json into ``directory`` -> the .ply path."""
    from splatapult_jax.io.configs import save_vr_config
    from splatapult_jax.io.gaussians import save_gaussian_ply

    os.makedirs(directory, exist_ok=True)
    ply = os.path.join(directory, "test.ply")
    save_gaussian_ply(ply, make_test_scene())
    save_vr_config(os.path.join(directory, "test_vr.json"), vr_floor_matrix())
    return ply
