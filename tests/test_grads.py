"""Differentiability tests: pixel-loss gradients to every splat parameter,
checked against central finite differences (BASELINE config 2; SURVEY.md
section 4, item 4)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from splatapult_jax.core import transforms as T
from splatapult_jax.io.gaussians import GaussianScene, make_debug_scene
from splatapult_jax.render import Camera, RenderConfig, render

# alpha_cutoff=0 removes the 1/256 discard discontinuity so finite differences
# are valid everywhere; a separate test covers grads with the cutoff enabled.
CFG = RenderConfig(width=32, height=32, pipeline="global", block_size=8, alpha_cutoff=0.0)
CFG_CUTOFF = RenderConfig(width=32, height=32, pipeline="global", block_size=8)


def _camera():
    cam_to_world = T.look_at(eye=[1.0, 0.9, 1.1], target=[0.25, 0.25, 0.25], up=[0.0, 1.0, 0.0])
    return Camera.from_fov(cam_to_world, fovy=np.pi / 4, width=CFG.width, height=CFG.height)


def _small_scene():
    scene = make_debug_scene()
    # moderate opacity so gradients through sigmoid are informative
    scene.opacities = jnp.full_like(scene.opacities, 0.5)
    # anisotropic scales + rotated quats: with the debug scene's isotropic
    # covariance, quat gradients are *exactly* zero by symmetry (rotating an
    # isotropic gaussian is a no-op), which would defeat the nonzero checks
    rng = np.random.default_rng(11)
    scene.log_scales = scene.log_scales + jnp.asarray(
        rng.uniform(-0.5, 0.5, scene.log_scales.shape), jnp.float32
    )
    quats = rng.standard_normal(scene.quats.shape).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scene.quats = jnp.asarray(quats)
    return scene


def _loss_fn(camera):
    # a fixed random target image makes the pixel loss sensitive to everything
    rng = np.random.default_rng(7)
    target = jnp.asarray(rng.uniform(size=(CFG.height, CFG.width, 4)), jnp.float32)

    def loss(scene):
        img = render(scene, camera, CFG)
        return jnp.mean((img - target) ** 2)

    return loss


def test_grads_nonzero_and_finite():
    scene = _small_scene()
    loss = _loss_fn(_camera())
    grads = jax.grad(loss)(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        g = np.asarray(getattr(grads, name))
        assert np.isfinite(g).all(), f"non-finite grad in {name}"
        assert np.abs(g).max() > 0.0, f"zero grad in {name}"


def test_grads_match_finite_differences():
    scene = _small_scene()
    loss = _loss_fn(_camera())
    grads = jax.grad(loss)(scene)
    rng = np.random.default_rng(3)
    f64 = lambda s: float(loss(s))

    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        g = np.asarray(getattr(grads, name))
        arr = np.asarray(getattr(scene, name), np.float64)
        # probe the 4 largest-|grad| coordinates plus 2 random ones
        flat = np.abs(g).ravel()
        idxs = list(np.argsort(-flat)[:4]) + list(rng.integers(0, flat.size, 2))
        for idx in idxs:
            if flat[idx] == 0.0 and idx not in np.argsort(-flat)[:4]:
                continue
            eps = 3e-3 * max(1.0, abs(arr.ravel()[idx]))
            up = arr.copy().ravel()
            dn = arr.copy().ravel()
            up[idx] += eps
            dn[idx] -= eps
            sup = dataclasses_replace(scene, name, up.reshape(arr.shape))
            sdn = dataclasses_replace(scene, name, dn.reshape(arr.shape))
            fd = (f64(sup) - f64(sdn)) / (2 * eps)
            got = flat[idx] * np.sign(g.ravel()[idx])
            scale = max(abs(fd), abs(got), 1e-4)
            assert abs(fd - got) / scale < 0.08, (
                f"{name}[{idx}]: fd={fd:.6g} analytic={got:.6g}"
            )


def dataclasses_replace(scene: GaussianScene, name: str, value) -> GaussianScene:
    kw = {
        "means": scene.means,
        "sh": scene.sh,
        "opacities": scene.opacities,
        "log_scales": scene.log_scales,
        "quats": scene.quats,
    }
    kw[name] = jnp.asarray(value, jnp.float32)
    return GaussianScene(**kw)


def test_grads_finite_with_cutoff_enabled():
    # with the 1/256 discard active (reference parity) grads must still be
    # finite and generally nonzero — just not finite-difference comparable
    scene = _small_scene()
    cam = _camera()
    target = jnp.zeros((CFG.height, CFG.width, 4))

    def loss(scene):
        return jnp.mean((render(scene, cam, CFG_CUTOFF) - target) ** 2)

    grads = jax.grad(loss)(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        g = np.asarray(getattr(grads, name))
        assert np.isfinite(g).all(), f"non-finite grad in {name}"


def test_grad_jit_compatible():
    scene = _small_scene()
    loss = _loss_fn(_camera())
    g1 = jax.grad(loss)(scene)
    g2 = jax.jit(jax.grad(loss))(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        np.testing.assert_allclose(
            np.asarray(getattr(g1, name)), np.asarray(getattr(g2, name)), atol=1e-5
        )


def test_camera_grads_flow():
    # gradients also flow to camera pose (useful for pose refinement workflows)
    scene = _small_scene()
    cam = _camera()
    target = jnp.zeros((CFG.height, CFG.width, 4))

    def loss(cam_to_world):
        c = Camera(cam_to_world=cam_to_world, proj=cam.proj)
        return jnp.mean((render(scene, c, CFG) - target) ** 2)

    g = np.asarray(jax.grad(loss)(cam.cam_to_world))
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0


@pytest.mark.parametrize("pipeline", ["global", "tiled"])
def test_grads_finite_with_splats_on_camera_plane(pipeline):
    """Culled splats at (almost) zero view depth get zero, not NaN,
    gradients: the projection Jacobian's 1/tz^2 must not overflow for them
    (inf times the zero cotangent would poison means/scales/quats)."""
    scene = _small_scene()
    cam = _camera()
    c2w = np.asarray(cam.cam_to_world, np.float64)
    eye, right, fwd = c2w[:3, 3], c2w[:3, 0], -c2w[:3, 2]
    plane = np.stack([eye + 0.3 * right + s * fwd
                      for s in (0.0, 1e-7, -1e-7, 1e-6)]).astype(np.float32)
    k = plane.shape[0]
    grown = GaussianScene(
        means=jnp.concatenate([scene.means, jnp.asarray(plane)]),
        sh=jnp.concatenate([scene.sh, jnp.full((k,) + scene.sh.shape[1:], 0.5)]),
        opacities=jnp.concatenate([scene.opacities, jnp.full((k,), 2.0)]),
        log_scales=jnp.concatenate([scene.log_scales, jnp.full((k, 3), -2.0)]),
        quats=jnp.concatenate([scene.quats, jnp.tile(
            jnp.asarray([[0.9, 0.1, 0.3, 0.3]]), (k, 1))]),
    )
    cfg = dataclasses.replace(CFG_CUTOFF, pipeline=pipeline, tile_size=16,
                              tile_block=8)
    target = jnp.zeros((cfg.height, cfg.width, 4))

    def loss(s):
        return jnp.mean((render(s, cam, cfg) - target) ** 2)

    grads = jax.grad(loss)(grown)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        g = np.asarray(getattr(grads, name))
        assert np.isfinite(g).all(), f"non-finite grad in {name}"
        assert np.abs(g[-k:]).max() == 0.0, name  # culled: no contribution
