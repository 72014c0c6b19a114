"""Adaptive density control (densify.py): clone/split/prune invariants and
the end-to-end adaptive fit loop. The reference viewer has no analog — this
is the trainer-side machinery its input scenes were produced with (INRIA
3DGS section 5.2 semantics), built on train._grad_stat_fit_steps."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from splatapult_jax.core import transforms as T
from splatapult_jax.densify import (
    DensifyConfig, _bucket_capacity, densify_and_prune, fit_scene_adaptive,
)
from splatapult_jax.io.gaussians import GaussianScene, make_debug_scene
from splatapult_jax.render import Camera, RenderConfig, render

CFG = RenderConfig(width=32, height=32, pipeline="tiled", tile_size=16,
                   tile_block=8, max_instance_mult=20)


def _cameras(n=3):
    cams = [
        Camera.from_fov(
            T.look_at(eye=[np.cos(a) * 1.8, 0.9, np.sin(a) * 1.8],
                      target=[0.3, 0.3, 0.3], up=[0.0, 1.0, 0.0]),
            fovy=np.pi / 4, width=CFG.width, height=CFG.height)
        for a in np.linspace(0, 2 * np.pi, n, endpoint=False)
    ]
    return Camera(cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
                  proj=jnp.stack([c.proj for c in cams]))


def test_prune_drops_transparent_splats():
    scene = make_debug_scene()
    n = scene.num_gaussians
    ops = np.asarray(scene.opacities).copy()
    ops[:3] = -12.0  # sigmoid ~ 6e-6 < 1/255
    scene = dataclasses.replace(scene, opacities=jnp.asarray(ops))
    out, stats = densify_and_prune(
        scene, np.zeros(n), DensifyConfig(grad_threshold=np.inf))
    assert stats["pruned"] == 3 and stats["cloned"] == 0 and stats["split"] == 0
    assert out.num_gaussians == n - 3
    # survivors keep their parameters exactly
    np.testing.assert_array_equal(np.asarray(out.means),
                                  np.asarray(scene.means)[3:])


def test_clone_and_split_partition_by_scale():
    scene = make_debug_scene()
    n = scene.num_gaussians
    g = np.zeros(n)
    g[0], g[1] = 10.0, 10.0  # two hot splats
    ls = np.asarray(scene.log_scales).copy()
    ls[0, :] = -6.0   # tiny -> clone
    ls[1, :] = 2.0    # huge -> split
    scene = dataclasses.replace(scene, log_scales=jnp.asarray(ls))
    out, stats = densify_and_prune(
        scene, g, DensifyConfig(grad_threshold=5.0, prune_alpha=0.0))
    assert stats == {"pruned": 0, "cloned": 1, "split": 1,
                     "num_splats": n + 2, "step": stats.get("step", None)} or (
        stats["cloned"] == 1 and stats["split"] == 1
        and stats["num_splats"] == n + 2)
    # split children carry scales / 1.6 (parent at 2.0 was removed, so the
    # two largest log-scales are the children)
    got = np.sort(np.asarray(out.log_scales)[:, 0])
    assert np.isclose(got[-2:], 2.0 - np.log(1.6), atol=1e-5).all()
    assert not np.isclose(got, 2.0, atol=1e-5).any()


def test_split_children_sample_parent_gaussian():
    """Split children land within a few sigma of the parent mean."""
    scene = make_debug_scene()
    n = scene.num_gaussians
    g = np.zeros(n)
    g[4] = 10.0
    ls = np.asarray(scene.log_scales).copy()
    ls[4, :] = 0.5
    scene = dataclasses.replace(scene, log_scales=jnp.asarray(ls))
    parent = np.asarray(scene.means)[4]
    out, stats = densify_and_prune(
        scene, g, DensifyConfig(grad_threshold=5.0, prune_alpha=0.0))
    assert stats["split"] == 1
    children = np.asarray(out.means)[-2:]
    dist = np.linalg.norm(children - parent, axis=1)
    assert (dist < 5.0 * np.exp(0.5) * np.sqrt(3)).all()
    assert (dist > 0).all()


def test_max_splats_budget_respected():
    scene = make_debug_scene()
    n = scene.num_gaussians
    out, stats = densify_and_prune(
        scene, np.full(n, 10.0),
        DensifyConfig(grad_threshold=1.0, prune_alpha=0.0, max_splats=n + 3))
    assert out.num_gaussians <= n + 3


def test_bucket_capacity_geometric():
    assert _bucket_capacity(100) == 1024
    a, b = _bucket_capacity(5000), _bucket_capacity(5001)
    assert a >= 5000 and b >= 5001 and a <= 5000 * 1.3 + 1
    # idempotent: a bucket maps to itself
    assert _bucket_capacity(a) == a


def test_grad_stat_fit_steps_accumulates():
    import optax

    from splatapult_jax.train import _grad_stat_fit_steps

    scene = make_debug_scene()
    cams = _cameras()
    targets = jnp.stack([
        render(scene, Camera(cam_to_world=m, proj=p), CFG)
        for m, p in zip(cams.cam_to_world, cams.proj)])
    pert = dataclasses.replace(scene, means=scene.means + 0.05)
    opt = optax.adam(1e-2)
    out, _, losses, gnorm = _grad_stat_fit_steps(
        pert, opt.init(pert), cams, targets, CFG, opt, 3)
    gnorm = np.asarray(gnorm)
    assert gnorm.shape == (scene.num_gaussians,)
    assert np.isfinite(gnorm).all() and gnorm.max() > 0
    assert len(losses) == 3 and np.isfinite(np.asarray(losses)).all()


def test_fit_scene_adaptive_end_to_end():
    """Start from HALF the splats of the target scene: the adaptive loop must
    densify (events recorded) and end with a lower loss than it started."""
    target_scene = make_debug_scene()
    cams = _cameras(4)
    targets = jnp.stack([
        render(target_scene, Camera(cam_to_world=m, proj=p), CFG)
        for m, p in zip(cams.cam_to_world, cams.proj)])
    half = jax.tree.map(lambda x: x[::2], target_scene)
    fitted, losses, events = fit_scene_adaptive(
        half, cams, targets, CFG, steps=12, densify_every=4,
        learning_rate=2e-2,
        densify=DensifyConfig(grad_percentile=50.0, prune_alpha=1e-4),
        bucket=None)
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert len(events) >= 1
    assert events[0]["cloned"] + events[0]["split"] > 0
    assert losses[-1] < losses[0]
    # result still renders finite
    img = np.asarray(render(fitted, Camera(
        cam_to_world=cams.cam_to_world[0], proj=cams.proj[0]), CFG))
    assert np.isfinite(img).all()


def test_fit_scene_adaptive_bucket_pads_inert():
    """With bucketing, padded splats are inert: the fitted scene's render
    matches the visible content (pads carry alpha ~ 2e-9) and the returned
    scene is sliced back to the true count."""
    target_scene = make_debug_scene()
    cams = _cameras(2)
    targets = jnp.stack([
        render(target_scene, Camera(cam_to_world=m, proj=p), CFG)
        for m, p in zip(cams.cam_to_world, cams.proj)])
    half = jax.tree.map(lambda x: x[::2], target_scene)
    fitted, losses, events = fit_scene_adaptive(
        half, cams, targets, CFG, steps=4, densify_every=2,
        densify=DensifyConfig(grad_percentile=50.0, prune_alpha=1e-4),
        bucket=1.3)
    assert np.isfinite(losses).all()
    # bucketing padded the WORKING set to 1024, but the result is the real set
    assert fitted.num_gaussians < 1024
