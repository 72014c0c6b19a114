"""Scene-fitting loop: the loss must decrease when optimizing toward renders of
a perturbed scene (the end-to-end differentiability story, BASELINE config 2)."""

import numpy as np
import jax
import jax.numpy as jnp

from splatapult_jax.core import transforms as T
from splatapult_jax.io.gaussians import GaussianScene, make_debug_scene
from splatapult_jax.render import Camera, RenderConfig, render
from splatapult_jax.train import fit_scene

CFG = RenderConfig(width=48, height=48, pipeline="global", block_size=8, alpha_cutoff=0.0)


def _cameras(n=2):
    cams = [
        Camera.from_fov(
            T.look_at(eye=[np.cos(a) * 1.8, 1.0, np.sin(a) * 1.8],
                      target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
            fovy=np.pi / 4, width=CFG.width, height=CFG.height,
        )
        for a in np.linspace(0.3, 1.5, n)
    ]
    return Camera(
        cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
        proj=jnp.stack([c.proj for c in cams]),
    )


def test_fit_recovers_perturbed_scene():
    target_scene = make_debug_scene()
    cams = _cameras()
    targets = jnp.stack(
        [render(target_scene, Camera(cam_to_world=m, proj=p), CFG)
         for m, p in zip(cams.cam_to_world, cams.proj)]
    )
    # perturb colors and positions, then fit back
    rng = np.random.default_rng(0)
    start = GaussianScene(
        means=target_scene.means + jnp.asarray(rng.normal(0, 0.03, (16, 3)), jnp.float32),
        sh=target_scene.sh + jnp.asarray(rng.normal(0, 0.2, (16, 3, 16)), jnp.float32),
        opacities=target_scene.opacities,
        log_scales=target_scene.log_scales,
        quats=target_scene.quats,
    )
    fitted, losses = fit_scene(start, cams, targets, CFG, steps=30, learning_rate=2e-2)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.5, f"loss did not drop: {losses[0]} -> {losses[-1]}"


def test_fit_with_mesh():
    from splatapult_jax.parallel.mesh import make_render_mesh

    target_scene = make_debug_scene()
    cfg = RenderConfig(width=32, height=32, pipeline="tiled", tile_size=16, tile_block=8,
                       max_instance_mult=20)
    cams = _cameras()
    targets = jnp.stack(
        [render(target_scene, Camera(cam_to_world=m, proj=p), cfg)
         for m, p in zip(cams.cam_to_world, cams.proj)]
    )
    start = GaussianScene(
        means=target_scene.means,
        sh=target_scene.sh * 0.5,
        opacities=target_scene.opacities,
        log_scales=target_scene.log_scales,
        quats=target_scene.quats,
    )
    mesh = make_render_mesh(num_tile_shards=2, num_view_shards=2)
    fitted, losses = fit_scene(start, cams, targets, cfg, steps=5, learning_rate=1e-2, mesh=mesh)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_fit_scan_matches_step_loop():
    """The on-device lax.scan fit (callback=None) must produce the same loss
    curve and parameters as the python step loop (callback given)."""
    target_scene = make_debug_scene()
    cams = _cameras()
    targets = jnp.stack(
        [render(target_scene, Camera(cam_to_world=m, proj=p), CFG)
         for m, p in zip(cams.cam_to_world, cams.proj)]
    )
    start = GaussianScene(
        means=target_scene.means + 0.02,
        sh=target_scene.sh * 0.8,
        opacities=target_scene.opacities,
        log_scales=target_scene.log_scales,
        quats=target_scene.quats,
    )
    f_scan, l_scan = fit_scene(start, cams, targets, CFG, steps=4, learning_rate=1e-2)
    f_loop, l_loop = fit_scene(start, cams, targets, CFG, steps=4, learning_rate=1e-2,
                               callback=lambda *_: None)
    np.testing.assert_allclose(l_scan, l_loop, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(f_scan), jax.tree.leaves(f_loop)):
        # scan and loop fuse differently; allow last-ulp-scale drift
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_fit_demo_tiny_smoke(tmp_path):
    """tools/fit_demo.py --tiny: the training-run artifact generator runs
    end to end (targets -> perturb -> fit -> checkpoint round-trip ->
    artifacts) and the loss drops."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools.fit_demo import main as fit_demo_main

    summary = fit_demo_main(["--tiny", "--out", str(tmp_path)])
    assert summary["loss_final"] < summary["loss_first"]
    assert summary["checkpoint_roundtrip"] == "exact"
    for f in ("before.png", "after.png", "target.png", "loss_curve.json"):
        assert (tmp_path / f).exists(), f
    assert not (tmp_path / "ckpt_mid.npz").exists()  # verified then removed


def test_fit_with_mesh_param_shard():
    """fit_scene(param_shard=True): the ZeRO loop converges like the
    replicated mesh loop (same math; see test_parallel's equality tests)."""
    from splatapult_jax.parallel.mesh import make_render_mesh

    target_scene = make_debug_scene()
    cfg = RenderConfig(width=32, height=32, pipeline="tiled", tile_size=16,
                       tile_block=8, max_instance_mult=20)
    cams = _cameras()
    targets = jnp.stack(
        [render(target_scene, Camera(cam_to_world=m, proj=p), cfg)
         for m, p in zip(cams.cam_to_world, cams.proj)]
    )
    start = GaussianScene(
        means=target_scene.means,
        sh=target_scene.sh * 0.5,
        opacities=target_scene.opacities,
        log_scales=target_scene.log_scales,
        quats=target_scene.quats,
    )
    mesh = make_render_mesh(num_tile_shards=2, num_view_shards=2)
    fitted, losses = fit_scene(start, cams, targets, cfg, steps=5,
                               learning_rate=1e-2, mesh=mesh, param_shard=True)
    assert fitted.means.shape == start.means.shape
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
