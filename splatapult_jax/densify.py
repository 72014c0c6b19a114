"""Adaptive density control: clone / split / prune during scene fitting.

The reference is a forward-only viewer and has no analog — it consumes what
the INRIA trainer produced (ref: README.md:70-83). This
module supplies the trainer-side densification loop those scenes were made
with, on top of this framework's gradient machinery (train.py), following
the INRIA 3DGS recipe: splats whose accumulated positional-gradient norm is
high are under-reconstructing — CLONE them where they are small (coverage
gap) and SPLIT them where they are large (over-stretched blob); splats whose
opacity has collapsed are PRUNED.

Structure: gradient statistics accumulate ON DEVICE inside the
jitted fit chunks (a [N] carry in the same lax.scan — no per-step host
sync); the re-shaping itself (clone/split/prune changes N) runs on the HOST
between chunks, because XLA programs are static-shape — resizing inside jit
would force a recompile per step, while a host-side rebuild costs one
O(N) numpy pass per densify interval (hundreds of steps) and one jit
specialization per resulting capacity. fit_scene_adaptive buckets the new
N to a geometric grid for exactly that reason (same philosophy as
render.py's capacity calibration).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from splatapult_jax.io.gaussians import GaussianScene


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """INRIA-style adaptive-density schedule knobs.

    grad_threshold: mean positional-grad norm above which a splat densifies
        (the INRIA default 2e-4 assumes NDC-scale gradients and per-view
        means; fit-loop gradients here are mean-of-L2-per-pixel scale, so
        calibrate per scene — fit_scene_adaptive's ``grad_percentile``
        default sidesteps the unit problem by densifying the top q%).
    scale_split: world-space scale above which a hot splat SPLITS instead of
        cloning (None = scene-extent / 100, scaled from the live scene).
    split_factor: children scales = parent / split_factor (INRIA: 1.6).
    prune_alpha: sigmoid(opacity) below this is pruned.
    max_splats: hard capacity cap; densification stops adding above it.
    """

    grad_threshold: Optional[float] = None
    grad_percentile: float = 97.0
    scale_split: Optional[float] = None
    split_factor: float = 1.6
    prune_alpha: float = 1.0 / 255.0
    max_splats: int = 8_000_000


def _np_scene(scene: GaussianScene):
    return {k: np.asarray(getattr(scene, k))
            for k in ("means", "sh", "opacities", "log_scales", "quats")}


def _quat_rotate(quats, v):
    """Rotate [M, 3] vectors by [M, 4] (w, x, y, z) quaternions (numpy)."""
    q = quats / np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-12)
    w, xyz = q[:, :1], q[:, 1:]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def densify_and_prune(scene: GaussianScene, grad_norms,
                      config: DensifyConfig = DensifyConfig(),
                      rng: Optional[np.random.Generator] = None):
    """One host-side adaptive-density pass -> (new_scene, stats dict).

    grad_norms: [N] accumulated (mean) positional-gradient norms, e.g.
    from fit_scene_adaptive's on-device accumulator.

    Semantics (INRIA 3DGS section 5.2):
      - prune:  sigmoid(opacity) < prune_alpha
      - hot:    grad_norms over the threshold (absolute, or percentile)
      - clone:  hot and max world scale <= scale_split — duplicate in place,
        nudged one positional-gradient step is not available host-side, so
        children are offset by a small sample along the splat's own major
        axis (a zero offset would leave two coincident splats whose grads
        stay locked together).
      - split:  hot and max scale > scale_split — two children at positions
        sampled from the parent's own Gaussian, scales / split_factor;
        parent removed.
    """
    rng = rng if rng is not None else np.random.default_rng(0)
    s = _np_scene(scene)
    n = s["means"].shape[0]
    g = np.asarray(grad_norms, np.float64).reshape(-1)
    assert g.shape[0] == n, (g.shape, n)

    alpha = 1.0 / (1.0 + np.exp(-s["opacities"].astype(np.float64)))
    keep = alpha >= config.prune_alpha

    if config.grad_threshold is not None:
        hot = g >= config.grad_threshold
    else:
        finite = g[np.isfinite(g)]
        thr = np.percentile(finite, config.grad_percentile) if finite.size else np.inf
        hot = g >= thr
    hot &= keep

    scales = np.exp(s["log_scales"].astype(np.float64))
    extent = float(np.linalg.norm(
        s["means"].max(0) - s["means"].min(0))) if n else 1.0
    scale_split = (config.scale_split if config.scale_split is not None
                   else 0.01 * max(extent, 1e-6))
    big = scales.max(axis=1) > scale_split

    clone_idx = np.flatnonzero(hot & ~big)
    split_idx = np.flatnonzero(hot & big)
    budget = max(config.max_splats - int(keep.sum()), 0)
    # splits add 2 children (parent removed: net +1), clones add 1
    if clone_idx.size + 2 * split_idx.size > budget:
        order = np.argsort(-g[np.concatenate([clone_idx, split_idx])])
        picked, cost = [], 0
        cat = np.concatenate([clone_idx, split_idx])
        is_split = np.concatenate([np.zeros_like(clone_idx, bool),
                                   np.ones_like(split_idx, bool)])
        for j in order:
            c = 2 if is_split[j] else 1
            if cost + c > budget:
                continue
            picked.append(j)
            cost += c
        picked = np.asarray(picked, int)
        clone_idx = cat[picked[~is_split[picked]]] if picked.size else cat[:0]
        split_idx = cat[picked[is_split[picked]]] if picked.size else cat[:0]

    parts = {k: [v[keep & ~np.isin(np.arange(n), split_idx)]]
             for k, v in s.items()}

    if clone_idx.size:
        major = np.argmax(s["log_scales"][clone_idx], axis=1)
        axis_local = np.eye(3, dtype=np.float64)[major]
        offs = _quat_rotate(s["quats"][clone_idx].astype(np.float64), axis_local)
        step = scales[clone_idx].max(axis=1, keepdims=True) * 0.5
        child = {k: v[clone_idx].copy() for k, v in s.items()}
        child["means"] = (child["means"].astype(np.float64)
                          + offs * step).astype(s["means"].dtype)
        for k in parts:
            parts[k].append(child[k])

    if split_idx.size:
        m = split_idx.size
        for _ in range(2):
            eps = rng.standard_normal((m, 3))
            local = eps * scales[split_idx]
            world = _quat_rotate(s["quats"][split_idx].astype(np.float64), local)
            child = {k: v[split_idx].copy() for k, v in s.items()}
            child["means"] = (child["means"].astype(np.float64)
                              + world).astype(s["means"].dtype)
            child["log_scales"] = (child["log_scales"]
                                   - np.log(config.split_factor)).astype(
                s["log_scales"].dtype)
            for k in parts:
                parts[k].append(child[k])

    import jax.numpy as jnp

    out = {k: jnp.asarray(np.concatenate(v, axis=0)) for k, v in parts.items()}
    stats = {
        "pruned": int(n - keep.sum()),
        "cloned": int(clone_idx.size),
        "split": int(split_idx.size),
        "num_splats": int(out["means"].shape[0]),
    }
    return GaussianScene(**out), stats


def _bucket_capacity(n: int, grid: float = 1.3) -> int:
    """Round a splat count UP onto a geometric grid so each densify interval
    reuses a previously compiled program instead of recompiling per N (the
    same trick render.py's capacity calibration uses). The scene is padded
    with inert splats to the bucket."""
    import math

    if n <= 1024:
        return 1024
    k = math.ceil(math.log(n / 1024.0) / math.log(grid))
    return int(1024 * grid ** k + 0.5)


def fit_scene_adaptive(scene: GaussianScene, cameras, targets, config,
                       steps: int = 400, densify_every: int = 100,
                       densify_stop: Optional[int] = None,
                       learning_rate: float = 1e-2,
                       densify: DensifyConfig = DensifyConfig(),
                       optimizer=None, bucket: Optional[float] = 1.3,
                       verbose: bool = False):
    """fit_scene with INRIA-style adaptive density control -> (scene, losses,
    events).

    Runs jitted fit chunks of ``densify_every`` steps that ALSO accumulate
    each splat's positional-grad norm on device (one extra [N] scan carry —
    no per-step host sync), then reshapes the scene host-side
    (densify_and_prune) and restarts the optimizer on the new shape (moment
    rows of re-shaped splats are stale either way; the INRIA trainer also
    resets its opacity/moment state at densify boundaries). ``bucket``
    pads the new N onto a geometric grid so jit specializations are reused
    across intervals; None disables padding. ``densify_stop``: last step
    index at which densification may run (default: steps - densify_every).
    """
    import jax
    import jax.numpy as jnp
    import optax

    from splatapult_jax.train import _grad_stat_fit_steps

    if optimizer is None:
        optimizer = optax.adam(learning_rate)
    if densify_stop is None:
        densify_stop = steps - densify_every
    targets = jnp.asarray(targets)

    losses, events = [], []
    done = 0
    while done < steps:
        n_steps = min(densify_every, steps - done)
        n_real = scene.means.shape[0]
        if bucket is not None:
            cap = _bucket_capacity(n_real, bucket)
            if cap > n_real:
                from splatapult_jax.parallel.mesh import _pad_scene

                scene = _pad_scene(scene, cap)
        opt_state = optimizer.init(scene)
        scene, _, loss_arr, gnorm = _grad_stat_fit_steps(
            scene, opt_state, cameras, targets, config, optimizer, n_steps)
        losses.extend(np.asarray(loss_arr).tolist())
        done += n_steps
        scene = jax.tree.map(lambda x: x[:n_real], scene)
        if done <= densify_stop and done < steps:
            scene, stats = densify_and_prune(
                scene, np.asarray(gnorm)[:n_real] / n_steps, densify)
            stats["step"] = done
            events.append(stats)
            if verbose:
                print(f"# densify @ {done}: {stats}")
    return scene, losses, events
