"""Garden-scale procedural scene tests (BASELINE config 3 stand-in)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from splatapult_jax.io.synth import garden_cameras, make_garden_scene
from splatapult_jax.render import RenderConfig, render


@pytest.fixture(scope="module")
def garden_small():
    return make_garden_scene(30_000, seed=0)


def test_garden_deterministic():
    a = make_garden_scene(5_000, seed=3)
    b = make_garden_scene(5_000, seed=3)
    np.testing.assert_array_equal(np.asarray(a.means), np.asarray(b.means))
    np.testing.assert_array_equal(np.asarray(a.sh), np.asarray(b.sh))
    c = make_garden_scene(5_000, seed=4)
    assert not np.array_equal(np.asarray(a.means), np.asarray(c.means))


def test_garden_statistics(garden_small):
    s = garden_small
    assert s.num_gaussians == 30_000
    assert s.sh_degree == 3
    # bimodal trained-style opacities: a solid opaque mode plus a haze tail
    alpha = 1.0 / (1.0 + np.exp(-np.asarray(s.opacities)))
    assert (alpha > 0.8).mean() > 0.35
    assert (alpha < 0.3).mean() > 0.10
    # quats normalized
    qn = np.linalg.norm(np.asarray(s.quats), axis=-1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-5)
    # surfel anisotropy exists: a large fraction of splats have a short axis
    # well under the tangent scales
    ls = np.asarray(s.log_scales)
    aniso = np.exp(ls.min(axis=1) - ls.max(axis=1))
    assert (aniso < 0.5).mean() > 0.3
    # SH energy decays with band: per-coefficient band-3 energy below band-1
    sh = np.asarray(s.sh)
    e1 = np.mean(sh[:, :, 1:4] ** 2)
    e3 = np.mean(sh[:, :, 9:16] ** 2)
    assert e3 < e1


def test_garden_ply_roundtrip(tmp_path, garden_small):
    from splatapult_jax.io.gaussians import load_gaussian_ply, save_gaussian_ply

    small = make_garden_scene(2_000, seed=1)
    path = str(tmp_path / "garden.ply")
    save_gaussian_ply(path, small)
    back = load_gaussian_ply(path)
    np.testing.assert_array_equal(np.asarray(back.means), np.asarray(small.means))
    np.testing.assert_array_equal(np.asarray(back.sh), np.asarray(small.sh))
    np.testing.assert_array_equal(
        np.asarray(back.log_scales), np.asarray(small.log_scales))


def test_garden_renders_with_content():
    garden = make_garden_scene(8_000, seed=0)
    cam = garden_cameras(1, width=160, height_px=96)
    cfg = RenderConfig(width=160, height=96, pipeline="tiled", tile_size=16,
                       tile_block=8, max_instance_mult=8, early_stop_eps=1e-4)
    img = np.asarray(render(garden, cam, cfg))
    assert img.shape == (96, 160, 4)
    assert np.isfinite(img).all()
    # an orbit view of the garden shows substantial coverage even at this
    # tiny splat count (footprints are clamped against the 1080p capture
    # resolution, so an 8k-splat miniature cannot tile the frame solid)
    assert img[..., 3].mean() > 0.2
    # and not monochrome (components have distinct albedos)
    assert img[..., :3].std() > 0.02


def test_garden_camera_ring_batched(garden_small):
    cams = garden_cameras(4, width=64, height_px=64)
    assert cams.cam_to_world.shape == (4, 4, 4)
    # all eyes on the orbit radius at the configured height
    eyes = np.asarray(cams.cam_to_world)[:, :3, 3]
    np.testing.assert_allclose(np.linalg.norm(eyes[:, [0, 2]], axis=1), 4.2,
                               atol=1e-5)
    np.testing.assert_allclose(eyes[:, 1], 1.6, atol=1e-5)
