"""Scene optimization: fit splat parameters to target images.

The reference is a forward-only viewer; differentiability is the entire point
of this re-architecture (BASELINE north star), and this module is the minimal
production loop on top of it: render -> pixel loss -> grads to every splat
parameter -> optax update, single- or multi-chip (parallel/mesh.py).

This is deliberately a *library* (fit_scene + TrainState), not a full trainer
binary. The INRIA trainer's adaptive density control (clone/split/prune)
lives in densify.py on top of _grad_stat_fit_steps' on-device grad-norm
accumulation; fit_scene itself keeps the splat count static.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from splatapult_jax.io.gaussians import GaussianScene
from splatapult_jax.render import Camera, RenderConfig, render


def l2_image_loss(img, target):
    return jnp.mean((img - target) ** 2)


def _batch_value_and_grad(scene: GaussianScene, cameras: Camera, targets,
                          config: RenderConfig):
    # Per-view gradient ACCUMULATION (lax.scan of one-view value_and_grad
    # into carried sums) rather than differentiating through a view batch:
    # the mean of per-view losses has the mean of per-view grads, so this
    # is the same update. A vmap would batch every sort and kernel of the
    # tiled pipeline at V times the memory, and a lax.map through the batch
    # stacks per-view residuals; self-contained per-view fwd+bwd iterations
    # carry only the gradient sums.
    def view_loss(scene, cam_mat, proj, tgt):
        img = render(scene, Camera(cam_to_world=cam_mat, proj=proj), config)
        return l2_image_loss(img, tgt)

    vg = jax.value_and_grad(view_loss)
    v = targets.shape[0]

    def body(carry, xs):
        acc_loss, acc_g = carry
        cam_mat, proj, tgt = xs
        loss, g = vg(scene, cam_mat, proj, tgt)
        return (acc_loss + loss, jax.tree.map(jnp.add, acc_g, g)), None

    zero_g = jax.tree.map(jnp.zeros_like, scene)
    (loss_sum, gsum), _ = jax.lax.scan(
        body, (jnp.float32(0.0), zero_g),
        (cameras.cam_to_world, cameras.proj, targets))
    return loss_sum / v, jax.tree.map(lambda g: g / v, gsum)


def _train_step_impl(scene: GaussianScene, opt_state, cameras: Camera, targets,
                     config: RenderConfig, optimizer):
    loss, grads = _batch_value_and_grad(scene, cameras, targets, config)
    updates, opt_state = optimizer.update(grads, opt_state, scene)
    scene = optax.apply_updates(scene, updates)
    return scene, opt_state, loss


@functools.partial(jax.jit, static_argnames=("config", "optimizer"))
def train_step(scene: GaussianScene, opt_state, cameras: Camera, targets,
               config: RenderConfig, optimizer):
    """One jitted update over a [V]-batched camera/target set (single chip)."""
    return _train_step_impl(scene, opt_state, cameras, targets, config, optimizer)


_FIT_CHUNK = 32  # scan length compiled once and reused for any step count


@functools.partial(jax.jit, static_argnames=("config", "optimizer", "steps"))
def _fit_steps(scene: GaussianScene, opt_state, cameras: Camera, targets,
               config: RenderConfig, optimizer, steps: int):
    """``steps`` updates inside ONE jitted lax.scan -> (scene, opt_state,
    losses[steps]).

    A python step loop reading the loss back each iteration would force a
    device->host sync per step; scanning on-device costs a single readback
    for the whole loss curve. fit_scene always calls this with steps equal to
    _FIT_CHUNK or the (< _FIT_CHUNK) remainder, so at most two scan programs
    compile regardless of the requested step count.
    """

    def body(carry, _):
        scene, opt_state = carry
        scene, opt_state, loss = _train_step_impl(
            scene, opt_state, cameras, targets, config, optimizer
        )
        return (scene, opt_state), loss

    (scene, opt_state), losses = jax.lax.scan(
        body, (scene, opt_state), None, length=steps
    )
    return scene, opt_state, losses


@functools.partial(jax.jit, static_argnames=("config", "optimizer", "steps"))
def _grad_stat_fit_steps(scene: GaussianScene, opt_state, cameras: Camera,
                         targets, config: RenderConfig, optimizer, steps: int):
    """_fit_steps that ALSO accumulates each splat's positional-gradient
    norm on device -> (scene, opt_state, losses[steps], gnorm_sum[N]).

    The [N] accumulator rides the same lax.scan carry, so adaptive density
    control (densify.py) gets its statistics with zero extra host syncs —
    the INRIA trainer's grad-norm bookkeeping, restructured for XLA."""

    def body(carry, _):
        scene, opt_state, acc = carry
        loss, grads = _batch_value_and_grad(scene, cameras, targets, config)
        acc = acc + jnp.linalg.norm(grads.means, axis=1)
        updates, opt_state = optimizer.update(grads, opt_state, scene)
        scene = optax.apply_updates(scene, updates)
        return (scene, opt_state, acc), loss

    acc0 = jnp.zeros((scene.means.shape[0],), jnp.float32)
    (scene, opt_state, acc), losses = jax.lax.scan(
        body, (scene, opt_state, acc0), None, length=steps)
    return scene, opt_state, losses, acc


def fit_scene(scene: GaussianScene, cameras: Camera, targets, config: RenderConfig,
              steps: int = 100, learning_rate: float = 1e-2,
              optimizer: Optional[optax.GradientTransformation] = None,
              mesh=None, callback: Optional[Callable] = None,
              param_shard: bool = False):
    """Optimize scene parameters against target images.

    mesh: optional jax.sharding.Mesh -> uses the SPMD train step with tile/view
    sharding and grad all-reduce (parallel/mesh.py) instead of the single-chip
    path. Returns (scene, [losses]).

    param_shard=True (mesh only): ZeRO-style parameter sharding — scene and
    optimizer state live sharded over BOTH mesh axes; over 'tiles' grads
    complete through the feature all_gather's transpose instead of a full
    grad all-reduce, over 'views' parameters ride a step-start FSDP gather
    (parallel/mesh.py make_zero_fit_steps; same update up to float
    summation order).
    """
    if optimizer is None:
        # per-parameter learning-rate scaling in the spirit of the INRIA
        # trainer: positions move slowly relative to appearance
        optimizer = optax.multi_transform(
            {
                "means": optax.adam(learning_rate * 0.1),
                "sh": optax.adam(learning_rate),
                "opacities": optax.adam(learning_rate),
                "log_scales": optax.adam(learning_rate * 0.5),
                "quats": optax.adam(learning_rate * 0.1),
            },
            GaussianScene(
                means="means", sh="sh", opacities="opacities",
                log_scales="log_scales", quats="quats",
            ),
        )
    opt_state = optimizer.init(scene)
    losses = []
    if mesh is not None:
        from splatapult_jax.parallel.mesh import (
            make_sharded_fit_steps, shard_targets, sharded_train_step,
            zero_fit_steps,
        )

        if param_shard:
            if callback is not None:
                raise ValueError(
                    "param_shard does not support a per-step callback: the "
                    "ZeRO loop scans whole chunks on-device (one readback "
                    "per chunk; a per-step callback would reintroduce the "
                    "per-step host sync it exists to remove)")
            targets = jnp.asarray(targets)
            zstate, done = None, 0
            while done < steps:
                n = min(_FIT_CHUNK, steps - done)
                scene, zstate, loss_arr = zero_fit_steps(
                    scene, cameras, targets, config, mesh, optimizer, n,
                    opt_state=zstate)
                losses.extend(np.asarray(loss_arr).tolist())
                done += n
            return scene, losses
        targets = shard_targets(jnp.asarray(targets), config, mesh)
        if callback is None:
            # on-device scan in fixed-size chunks, exactly like the
            # single-chip path below: one loss readback per chunk instead of
            # a per-step device->host sync that would stall every chip (and
            # on real devices mask the backward/all-reduce overlap the
            # in-backward psum placement wins).
            done = 0
            while done < steps:
                n = min(_FIT_CHUNK, steps - done)
                fit = make_sharded_fit_steps(config, mesh, optimizer, n)
                scene, opt_state, loss_arr = fit(scene, cameras, targets, opt_state)
                losses.extend(np.asarray(loss_arr).tolist())
                done += n
            return scene, losses
        for step in range(steps):
            loss, scene, opt_state = sharded_train_step(
                scene, cameras, targets, config, mesh, optimizer, opt_state
            )
            losses.append(float(loss))
            callback(step, scene, losses[-1])
        return scene, losses
    targets = jnp.asarray(targets)
    if callback is None:
        # on-device scan in fixed-size chunks: one compile per chunk shape
        # (at most two), a handful of readbacks for the whole loss curve
        losses = []
        done = 0
        while done < steps:
            n = min(_FIT_CHUNK, steps - done)
            scene, opt_state, loss_arr = _fit_steps(
                scene, opt_state, cameras, targets, config, optimizer, n
            )
            losses.extend(np.asarray(loss_arr).tolist())
            done += n
        return scene, losses
    for step in range(steps):
        scene, opt_state, loss = train_step(scene, opt_state, cameras, targets, config, optimizer)
        losses.append(float(loss))
        if callback:
            callback(step, scene, losses[-1])
    return scene, losses
