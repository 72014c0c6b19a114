"""cameras.json / _vr.json / discovery / point-cloud I/O tests."""

import json
import os

import numpy as np

from splatapult_jax.io.configs import (
    discover_scene,
    estimate_floor_plane,
    find_config_file,
    load_cameras_json,
    load_vr_config,
    save_vr_config,
)
from splatapult_jax.io.points import (
    load_point_ply,
    make_debug_points,
    points_as_gaussians,
    save_point_ply,
)


def _write_cameras_json(path):
    # rotation rows = world-from-camera rotation (row-major), identity here
    cams = [
        {
            "id": 0,
            "img_name": "00000",
            "width": 1920,
            "height": 1080,
            "position": [1.0, 2.0, 3.0],
            "rotation": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
            "fx": 960.0,
            "fy": 960.0,
        },
        {
            "id": 1,
            "img_name": "00001",
            "width": 640,
            "height": 480,
            "position": [0.0, 1.0, 0.0],
            "rotation": [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]],
            "fx": 320.0,
            "fy": 320.0,
        },
    ]
    with open(path, "w") as f:
        json.dump(cams, f)


def test_load_cameras_json(tmp_path):
    p = tmp_path / "cameras.json"
    _write_cameras_json(p)
    cams = load_cameras_json(str(p))
    assert len(cams) == 2
    c0 = cams[0]
    np.testing.assert_allclose(c0.position, [1.0, 2.0, 3.0])
    # identity rotation swizzles to diag(1, -1, -1) (-Z forward / +Y up,
    # ref: src/camerasconfig.cpp:50-56)
    np.testing.assert_allclose(c0.cam_to_world[:3, :3], np.diag([1.0, -1.0, -1.0]))
    # fov = 2 atan(w / 2fx) (ref: src/camerasconfig.cpp:47-48)
    np.testing.assert_allclose(c0.fov[0], 2 * np.arctan(1920 / (2 * 960.0)), rtol=1e-6)
    # reference quirk: vertical fov also uses fx
    np.testing.assert_allclose(c0.fov[1], 2 * np.arctan(1080 / (2 * 960.0)), rtol=1e-6)
    # rotation columns of entry 1: cam x-axis = world (0,0,-1)
    c1 = cams[1]
    np.testing.assert_allclose(c1.cam_to_world[:3, 0], [0.0, 0.0, -1.0], atol=1e-7)


def test_estimate_floor_plane(tmp_path):
    p = tmp_path / "cameras.json"
    _write_cameras_json(p)
    cams = load_cameras_json(str(p))
    normal, point = estimate_floor_plane(cams)
    np.testing.assert_allclose(np.linalg.norm(normal), 1.0, rtol=1e-6)
    # identity-swizzled cameras have up = (0,-1,0); avg of two
    assert normal[1] != 0.0
    assert np.isfinite(point).all()
    # empty camera list falls back to +Y (ref: src/camerasconfig.cpp:71-76)
    n2, p2 = estimate_floor_plane([])
    np.testing.assert_allclose(n2, [0.0, 1.0, 0.0])
    np.testing.assert_allclose(p2, [0.0, 0.0, 0.0])


def test_vr_config_roundtrip(tmp_path):
    m = np.arange(16, dtype=np.float32).reshape(4, 4)
    m[3] = [0, 0, 0, 1]
    path = str(tmp_path / "scene_vr.json")
    save_vr_config(path, m)
    back = load_vr_config(path)
    np.testing.assert_allclose(back, m, atol=1e-6)


def test_load_reference_vr_config(test_ply_path):
    # the fixture's pose file beside test.ply (tests/fixture_data.py)
    m = load_vr_config(test_ply_path[: -len(".ply")] + "_vr.json")
    assert m.shape == (4, 4)
    np.testing.assert_allclose(m[3], [0.0, 0.0, 0.0, 1.0])
    # column-major storage means the translation lives in m[:3, 3]
    np.testing.assert_allclose(m[:3, 3], [-0.573335, -1.78893, -0.512137], rtol=1e-5)
    # rotation part is orthonormal
    R = m[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)


def test_find_config_and_discover(tmp_path):
    scene_dir = tmp_path / "scene" / "point_cloud" / "iteration_30000"
    os.makedirs(scene_dir)
    ply = scene_dir / "point_cloud.ply"
    ply.write_bytes(b"")
    cameras = tmp_path / "scene" / "cameras.json"
    cameras.write_text("[]")
    # found two levels up (ref: src/app.cpp:89-119 walks ply dir + 2 parents)
    assert find_config_file("cameras.json", str(scene_dir)) == str(cameras)
    assert find_config_file("nope.json", str(scene_dir)) is None
    found = discover_scene(str(ply))
    assert found["cameras_json"] == str(cameras)
    assert found["vr_json"] is None


def test_points_roundtrip(tmp_path):
    pts = make_debug_points()
    assert pts.num_points == 15
    path = str(tmp_path / "points.ply")
    save_point_ply(path, pts)
    back = load_point_ply(path)
    np.testing.assert_allclose(np.asarray(back.positions), np.asarray(pts.positions), atol=1e-6)
    np.testing.assert_allclose(np.asarray(back.colors), np.asarray(pts.colors), atol=1 / 255.0)


def test_points_as_gaussians_render():
    import jax.numpy as jnp

    from splatapult_jax.core import transforms as T
    from splatapult_jax.render import Camera, RenderConfig, render

    pts = make_debug_points()
    scene = points_as_gaussians(pts, world_radius=0.02)
    cam = Camera.from_fov(
        T.look_at(eye=[1.0, 1.0, 1.0], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=64, height=64,
    )
    img = np.asarray(render(scene, cam, RenderConfig(64, 64, pipeline="global")))
    assert img.shape == (64, 64, 4)
    assert img[..., 3].max() > 0.5  # points visible
    # red/green/blue all present somewhere
    assert img[..., 0].max() > 0.3
    assert img[..., 1].max() > 0.3
    assert img[..., 2].max() > 0.3
