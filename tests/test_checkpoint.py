"""Checkpoint/resume + stereo-pair tests."""

import numpy as np
import jax.numpy as jnp

from splatapult_jax.core import transforms as T
from splatapult_jax.io.checkpoint import (
    load_scene_npz,
    load_train_state,
    save_scene_npz,
    save_train_state,
)
from splatapult_jax.io.gaussians import make_debug_scene
from splatapult_jax.render import Camera, RenderConfig, render_batch


def _scenes_equal(a, b):
    for f in ("means", "sh", "opacities", "log_scales", "quats"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


def test_scene_npz_roundtrip(tmp_path):
    scene = make_debug_scene()
    path = str(tmp_path / "ckpt.npz")
    save_scene_npz(path, scene, step=42)
    back, step = load_scene_npz(path)
    assert step == 42
    _scenes_equal(scene, back)


def test_train_state_roundtrip(tmp_path):
    import optax

    scene = make_debug_scene()
    opt = optax.adam(1e-2)
    opt_state = opt.init(scene)
    save_train_state(str(tmp_path), scene, opt_state, step=7)
    back, opt_back, step = load_train_state(str(tmp_path), 7, opt_state_like=opt_state)
    assert step == 7
    _scenes_equal(scene, back)


def test_stereo_pair_renders_two_shifted_views():
    scene = make_debug_scene()
    cam = Camera.from_fov(
        T.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=48, height=48,
    )
    pair = cam.stereo_pair(ipd=0.2)  # exaggerated for a visible disparity
    assert pair.cam_to_world.shape == (2, 4, 4)
    # eyes displaced along the camera's +X by the ipd
    sep = np.asarray(pair.cam_to_world[1, :3, 3] - pair.cam_to_world[0, :3, 3])
    np.testing.assert_allclose(np.linalg.norm(sep), 0.2, rtol=1e-5)
    imgs = np.asarray(
        render_batch(scene, pair, RenderConfig(48, 48, pipeline="global", block_size=8))
    )
    assert imgs.shape == (2, 48, 48, 4)
    assert np.abs(imgs[0] - imgs[1]).max() > 1e-3  # disparity visible
