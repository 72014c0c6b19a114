"""Stereo shared-binning tests: the shared-bins render must match per-eye
rendering (the reference's sort-once-render-twice trick, src/app.cpp:603-607,
lifted to shared binning — see splatapult_jax/stereo.py for the exactness
argument)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from splatapult_jax.core import transforms as T
from splatapult_jax.io.gaussians import GaussianScene
from splatapult_jax.render import Camera, RenderConfig, render
from splatapult_jax.stereo import (
    _eye_cameras,
    render_stereo,
    stereo_instance_demand,
)

CFG = RenderConfig(
    width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8,
    max_instance_mult=40,
)


def _camera(eye=(1.2, 1.1, 1.3)):
    c2w = T.look_at(eye=list(eye), target=[0.3, 0.3, 0.3], up=[0.0, 1.0, 0.0])
    return Camera.from_fov(c2w, fovy=np.pi / 4, width=CFG.width, height=CFG.height)


def _random_scene(rng, n=64, spread=0.8):
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return GaussianScene(
        means=jnp.asarray(rng.uniform(-spread, spread, (n, 3)), jnp.float32),
        sh=jnp.asarray(rng.standard_normal((n, 3, 1)) * 0.5, jnp.float32),
        opacities=jnp.asarray(rng.uniform(-1.0, 2.5, (n,)), jnp.float32),
        log_scales=jnp.asarray(rng.uniform(-3.5, -1.5, (n, 3)), jnp.float32),
        quats=jnp.asarray(quats),
    )


def _per_eye(scene, cam, cfg, ipd):
    left, right = _eye_cameras(cam, ipd)
    return np.stack([
        np.asarray(render(scene, left, cfg)),
        np.asarray(render(scene, right, cfg)),
    ])


def test_stereo_matches_per_eye_small_and_large_ipd(rng):
    scene = _random_scene(rng)
    cam = _camera()
    for ipd in (0.064, 0.4):  # 0.4 = exaggerated parallax stresses the union
        want = _per_eye(scene, cam, CFG, ipd)
        got = np.asarray(render_stereo(scene, cam, CFG, ipd))
        assert got.shape == want.shape == (2, 64, 64, 4)
        # identical instance sets per pixel; only block-partition-dependent
        # log-sum association can differ (see test module docstring)
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=f"ipd={ipd}")


def test_stereo_per_eye_culling_exact(rng):
    # a camera close to the scene so some splats cull in exactly one eye
    scene = _random_scene(rng, n=96, spread=1.2)
    cam = _camera(eye=(0.9, 0.6, 0.9))
    ipd = 0.5
    want = _per_eye(scene, cam, CFG, ipd)
    got = np.asarray(render_stereo(scene, cam, CFG, ipd))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_stereo_grads_match_per_eye(rng):
    scene = _random_scene(rng, n=48)
    cam = _camera()

    def loss_shared(s):
        return jnp.mean(render_stereo(s, cam, CFG, 0.1) ** 2)

    def loss_per_eye(s):
        left, right = _eye_cameras(cam, 0.1)
        a = render(s, left, CFG)
        b = render(s, right, CFG)
        return jnp.mean(jnp.stack([a, b]) ** 2)

    la, ga = jax.value_and_grad(loss_shared)(scene)
    lb, gb = jax.value_and_grad(loss_per_eye)(scene)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-5)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(ga, name)), np.asarray(getattr(gb, name))
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-4, err_msg=name)


def test_stereo_forward_only(rng):
    scene = _random_scene(rng)
    cam = _camera()
    cfg_fwd = dataclasses.replace(CFG, forward_only=True)
    want = np.asarray(render_stereo(scene, cam, CFG, 0.064))
    got = np.asarray(render_stereo(scene, cam, cfg_fwd, 0.064))
    np.testing.assert_array_equal(got, want)


def test_stereo_demand_covers_both_eyes(rng):
    scene = _random_scene(rng)
    cam = _camera()
    from splatapult_jax.ops.binning import TileGrid, instance_demand
    from splatapult_jax.render import prepare_splats

    shared = int(stereo_instance_demand(scene, cam, CFG, 0.2))
    grid = TileGrid.create(width=CFG.width, height=CFG.height,
                           num_splats=scene.means.shape[0],
                           tile_size=CFG.tile_size, block=CFG.tile_block)
    left, right = _eye_cameras(cam, 0.2)
    for eye_cam in (left, right):
        d = prepare_splats(scene, eye_cam, CFG, sort=False)
        eye_demand = int(instance_demand(d["mean2d"], d["extent"], grid))
        assert shared >= eye_demand


def test_calibrate_config_stereo_fits_union(rng):
    from splatapult_jax.stereo import calibrate_config_stereo, render_stereo

    scene = _random_scene(rng)
    cam = _camera()
    cfg = dataclasses.replace(CFG, max_instance_mult=0.01)  # would overflow
    cal = calibrate_config_stereo(scene, cam, cfg, ipd=0.3)
    assert cal.max_instance_mult > cfg.max_instance_mult
    # calibrated capacity renders the pair without overflow: equals per-eye
    want = _per_eye(scene, cam, cal, 0.3)
    got = np.asarray(render_stereo(scene, cam, cal, 0.3))
    np.testing.assert_allclose(got, want, atol=2e-5)


# ---------------------------------------------------- per-eye asymmetric frusta


def test_stereo_pair_symmetric_tan_angles_degenerates():
    """Symmetric tan angles reproduce Camera.from_fov's projection exactly,
    so stereo_pair(tan_angles=symmetric) == stereo_pair() in both fields."""
    cam = _camera()
    fovy = np.pi / 4
    t = float(np.tan(fovy / 2.0))
    aspect = CFG.width / CFG.height
    sym = np.asarray([[-t * aspect, t * aspect, t, -t]] * 2, np.float32)
    a = cam.stereo_pair(0.064)
    b = cam.stereo_pair(0.064, tan_angles=sym, near=0.1, far=1000.0)
    np.testing.assert_array_equal(np.asarray(a.cam_to_world),
                                  np.asarray(b.cam_to_world))
    np.testing.assert_allclose(np.asarray(a.proj), np.asarray(b.proj),
                               atol=1e-6)


def test_stereo_pair_asymmetric_frusta_render():
    """Per-eye ASYMMETRIC frusta (the reference's XR per-eye projections,
    src/xrbuddy.cpp:1802-1832 + util.cpp:412-480): each eye renders with its
    own projection; the outward-canted eyes must differ from the symmetric
    pair, and each eye must equal a single render with that projection."""
    from splatapult_jax.core.transforms import projection_from_tan_angles
    from splatapult_jax.render import render_batch

    rng = np.random.default_rng(77)
    scene = _random_scene(rng)
    cam = _camera()
    t = float(np.tan(np.pi / 8))
    # typical HMD shape: wider outward half-angle per eye
    ta = np.asarray([
        [-1.3 * t, 0.8 * t, t, -t],   # left eye: wide to the left
        [-0.8 * t, 1.3 * t, t, -t],   # right eye: wide to the right
    ], np.float32)
    pair_cam = cam.stereo_pair(0.064, tan_angles=ta, near=0.1, far=1000.0)
    got = np.asarray(render_batch(scene, pair_cam, CFG))
    assert got.shape == (2, 64, 64, 4)
    assert np.isfinite(got).all()

    # per-eye equality with single renders under the same asymmetric proj
    for e in range(2):
        eye = Camera(cam_to_world=pair_cam.cam_to_world[e],
                     proj=pair_cam.proj[e])
        single = np.asarray(render(scene, eye, CFG))
        np.testing.assert_allclose(got[e], single, atol=2e-5)

    # the asymmetric pair differs from the symmetric one (frusta point
    # elsewhere) — guards against the tan angles being silently ignored
    sym = np.asarray(render_batch(scene, cam.stereo_pair(0.064), CFG))
    assert np.abs(got - sym).max() > 1e-3


def test_stereo_pair_infinite_far():
    """far <= near places the far plane at infinity (the reference's
    CreateProjection contract, util.cpp:447-457)."""
    cam = _camera()
    t = float(np.tan(np.pi / 8))
    ta = np.asarray([[-t, t, t, -t]] * 2, np.float32)
    pair = cam.stereo_pair(0.064, tan_angles=ta, near=0.1, far=0.0)
    p = np.asarray(pair.proj[0])
    np.testing.assert_allclose(p[2, 2], -1.0)
    np.testing.assert_allclose(p[2, 3], -0.2)
