"""Checkpoint/resume for scene parameters and optimizer state.

The reference's only persistence is the floorMat pose file and PLY write-back
(SURVEY.md section 5, checkpoint/resume); with optimization in the framework
(train.py), step-level checkpointing becomes meaningful. Two formats:

- save_scene_npz / load_scene_npz — the scene pytree (+ step metadata)
- save_train_state / load_train_state — full (scene, opt_state) pytrees as
  flattened leaves for exact training resume (structure restored from a
  template, so no pickled code and no checkpoint-library API drift)

PLY export (io.gaussians.save_gaussian_ply) remains the interchange format.
"""

from __future__ import annotations

import os

import numpy as np

from splatapult_jax.io.gaussians import GaussianScene

_FIELDS = ("means", "sh", "opacities", "log_scales", "quats")


def save_scene_npz(path: str, scene: GaussianScene, step: int = 0) -> None:
    np.savez_compressed(
        path,
        step=np.int64(step),
        **{f: np.asarray(getattr(scene, f)) for f in _FIELDS},
    )


def load_scene_npz(path: str):
    """-> (GaussianScene, step)."""
    with np.load(path) as z:
        scene = GaussianScene(**{f: z[f] for f in _FIELDS})
        step = int(z["step"]) if "step" in z else 0
    return scene, step


def save_train_state(directory: str, scene: GaussianScene, opt_state, step: int) -> None:
    """Checkpoint the full (scene, optimizer) train state as flattened pytree
    leaves in one .npz — dependency-free and exact; restore needs a structure
    template (the freshly-initialized opt_state), which training loops always
    have."""
    import jax

    os.makedirs(directory, exist_ok=True)
    leaves = jax.tree_util.tree_leaves((scene, opt_state))
    np.savez_compressed(
        os.path.join(directory, f"step_{step:08d}.npz"),
        step=np.int64(step),
        num_leaves=np.int64(len(leaves)),
        **{f"leaf_{i:04d}": np.asarray(x) for i, x in enumerate(leaves)},
    )


def load_train_state(directory: str, step: int, opt_state_like=None):
    """-> (scene, opt_state, step). opt_state_like supplies the optimizer
    pytree structure (e.g. optimizer.init(scene) on a fresh scene)."""
    import jax

    path = os.path.join(directory, f"step_{step:08d}.npz")
    with np.load(path) as z:
        leaves = [z[f"leaf_{i:04d}"] for i in range(int(z["num_leaves"]))]
        saved_step = int(z["step"])
    template = (
        GaussianScene(**{f: np.zeros(0) for f in _FIELDS}),
        opt_state_like,
    )
    treedef = jax.tree_util.tree_structure(template)
    scene, opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    return scene, opt_state, saved_step
