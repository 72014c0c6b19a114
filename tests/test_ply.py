"""PLY parser/writer + GaussianScene conversion tests (SURVEY.md section 4, item 1)."""

import io

import numpy as np

from splatapult_jax.io.ply import read_ply, write_ply, make_ply
from splatapult_jax.io.gaussians import (
    load_gaussian_ply,
    make_debug_scene,
    prune_splats,
    scene_from_ply,
    scene_to_ply,
)


def test_read_test_ply_header(test_ply_path):
    ply = read_ply(test_ply_path)
    assert ply.num_vertices == 16
    # schema the reference expects (ref: src/gaussiancloud.cpp:170-228)
    assert ply.has("x", "y", "z", "opacity")
    assert ply.has(*[f"f_dc_{i}" for i in range(3)])
    assert ply.has(*[f"f_rest_{i}" for i in range(45)])
    assert ply.has(*[f"scale_{i}" for i in range(3)])
    assert ply.has(*[f"rot_{i}" for i in range(4)])


def test_roundtrip_byte_exact(test_ply_path):
    with open(test_ply_path, "rb") as f:
        original = f.read()
    ply = read_ply(test_ply_path)
    buf = io.BytesIO()
    write_ply(buf, ply)
    ply2 = read_ply(io.BytesIO(buf.getvalue()))
    assert ply2.property_names == ply.property_names
    assert ply2.vertices.tobytes() == ply.vertices.tobytes()
    # vertex blob must be byte-identical to the original file's tail
    assert buf.getvalue().endswith(ply.vertices.tobytes())
    assert original.endswith(ply.vertices.tobytes())


def test_scene_from_ply_layout(test_ply_path):
    ply = read_ply(test_ply_path)
    scene = scene_from_ply(ply)
    n = ply.num_vertices
    assert scene.means.shape == (n, 3)
    assert scene.sh.shape == (n, 3, 16)
    assert scene.sh_degree == 3
    # SH channel-block layout (ref: src/gaussiancloud.cpp:265-314)
    np.testing.assert_array_equal(scene.sh[:, 0, 0], ply.column("f_dc_0"))
    np.testing.assert_array_equal(scene.sh[:, 1, 0], ply.column("f_dc_1"))
    np.testing.assert_array_equal(scene.sh[:, 2, 0], ply.column("f_dc_2"))
    np.testing.assert_array_equal(scene.sh[:, 0, 1], ply.column("f_rest_0"))
    np.testing.assert_array_equal(scene.sh[:, 1, 1], ply.column("f_rest_15"))
    np.testing.assert_array_equal(scene.sh[:, 2, 14], ply.column("f_rest_43"))
    np.testing.assert_array_equal(scene.quats[:, 0], ply.column("rot_0"))


def test_scene_nosh_degrade(test_ply_path):
    scene = load_gaussian_ply(test_ply_path, use_full_sh=False)
    assert scene.sh.shape[-1] == 1
    assert scene.sh_degree == 0


def test_scene_export_roundtrip(test_ply_path, tmp_path):
    scene = load_gaussian_ply(test_ply_path)
    out = tmp_path / "roundtrip.ply"
    ply2 = scene_to_ply(scene)
    write_ply(str(out), ply2)
    scene2 = load_gaussian_ply(str(out))
    for a, b in zip(
        (scene.means, scene.sh, scene.opacities, scene.log_scales, scene.quats),
        (scene2.means, scene2.sh, scene2.opacities, scene2.log_scales, scene2.quats),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ascii_ply():
    text = b"""ply
format ascii 1.0
element vertex 2
property float x
property float y
end_header
1.5 2.5
-3 4
"""
    ply = read_ply(io.BytesIO(text))
    np.testing.assert_allclose(ply.column("x"), [1.5, -3.0])
    np.testing.assert_allclose(ply.column("y"), [2.5, 4.0])


def test_make_ply_mixed_dtypes():
    ply = make_ply(
        {
            "x": np.asarray([1.0, 2.0], np.float32),
            "red": np.asarray([255, 0], np.uint8),
        }
    )
    buf = io.BytesIO()
    write_ply(buf, ply)
    back = read_ply(io.BytesIO(buf.getvalue()))
    np.testing.assert_array_equal(back.column("red"), [255, 0])
    assert back.vertices.dtype["red"] == np.uint8


def test_debug_scene_matches_reference_constants():
    # ref: GaussianCloud::InitDebugCloud (src/gaussiancloud.cpp:505-578)
    scene = make_debug_scene()
    assert scene.num_gaussians == 16
    sh_one = 1.0 / (2.0 * 0.28209479177387814)
    # first x-axis splat is red at (0.2, 0, 0)
    np.testing.assert_allclose(scene.means[0], [0.2, 0.0, 0.0], atol=1e-7)
    np.testing.assert_allclose(scene.sh[0, 0, 0], sh_one)
    np.testing.assert_allclose(scene.sh[0, 1, 0], -sh_one)
    # origin splat is white
    np.testing.assert_allclose(scene.means[15], [0.0, 0.0, 0.0])
    np.testing.assert_allclose(scene.sh[15, :, 0], [sh_one] * 3)
    # baked covariance reproduces the reference's COV_DIAG = 0.005
    from splatapult_jax.core.transforms import bake_covariance

    cov = np.asarray(bake_covariance(scene.quats, scene.log_scales))
    np.testing.assert_allclose(cov[0], np.eye(3) * 0.005, atol=1e-9)


def test_prune_splats_keeps_nearest():
    scene = make_debug_scene()
    pruned = prune_splats(scene, origin=[0.0, 0.0, 0.0], num_splats=4)
    assert pruned.num_gaussians == 4
    dists = np.linalg.norm(np.asarray(pruned.means), axis=-1)
    all_dists = np.sort(np.linalg.norm(np.asarray(scene.means), axis=-1))
    np.testing.assert_allclose(np.sort(dists), all_dists[:4])


# ------------------------------------ degree-1/2 SH + adversarial robustness


def _trainer_cols(n=5, rng_seed=3, rest=45, extra=None, pos_dtype=np.float32):
    """Synthetic INRIA-schema columns with ``rest`` f_rest properties."""
    rng = np.random.default_rng(rng_seed)
    cols = {}
    for name in ("x", "y", "z"):
        cols[name] = rng.standard_normal(n).astype(pos_dtype)
    for name in ("nx", "ny", "nz"):
        cols[name] = np.zeros(n, np.float32)
    for i in range(3):
        cols[f"f_dc_{i}"] = rng.standard_normal(n).astype(np.float32)
    for i in range(rest):
        cols[f"f_rest_{i}"] = rng.standard_normal(n).astype(np.float32)
    cols["opacity"] = rng.standard_normal(n).astype(np.float32)
    for i in range(3):
        cols[f"scale_{i}"] = rng.uniform(-5, -3, n).astype(np.float32)
    for i in range(4):
        cols[f"rot_{i}"] = rng.standard_normal(n).astype(np.float32)
    if extra:
        cols.update(extra)
    return cols


def _roundtrip(cols):
    buf = io.BytesIO()
    write_ply(buf, make_ply(cols))
    return read_ply(io.BytesIO(buf.getvalue()))


def test_scene_from_ply_degree1_and_degree2():
    """9 / 24 f_rest coefficients load at K=4 / K=9 (degree-1/2 exports exist
    in the wild; the container and sh_basis support them — no silent
    DC-only degradation)."""
    for rest, k, deg in ((9, 4, 1), (24, 9, 2), (45, 16, 3), (0, 1, 0)):
        scene = scene_from_ply(_roundtrip(_trainer_cols(rest=rest)))
        assert scene.sh.shape == (5, 3, k), (rest, scene.sh.shape)
        assert scene.sh_degree == deg
    # and the per-channel block layout survives a save/load round trip
    scene = scene_from_ply(_roundtrip(_trainer_cols(rest=24)))
    back = scene_from_ply(scene_to_ply(scene))
    np.testing.assert_array_equal(np.asarray(scene.sh), np.asarray(back.sh))


def test_scene_from_ply_unusual_rest_count_uses_largest_degree():
    """An off-schema f_rest count (e.g. 30) keeps the largest COMPLETE degree
    instead of failing or silently dropping to DC."""
    scene = scene_from_ply(_roundtrip(_trainer_cols(rest=30)))
    assert scene.sh.shape[-1] == 9  # 30 >= 24 -> degree 2; not 16 (needs 45)


def test_scene_from_ply_double_positions():
    """float64 position properties load (converted to f32), as the
    reference's property-map conversion does (src/ply.cpp:140-254)."""
    scene = scene_from_ply(_roundtrip(_trainer_cols(pos_dtype=np.float64)))
    assert scene.means.dtype == np.float32
    assert np.isfinite(np.asarray(scene.means)).all()


def test_scene_from_ply_extra_properties_ignored():
    extra = {"red": np.zeros(5, np.uint8), "custom_field": np.ones(5, np.float32)}
    scene = scene_from_ply(_roundtrip(_trainer_cols(extra=extra)))
    assert scene.num_gaussians == 5


def test_read_ply_truncated_blob_raises():
    buf = io.BytesIO()
    write_ply(buf, make_ply(_trainer_cols()))
    data = buf.getvalue()
    with np.testing.assert_raises(ValueError):
        read_ply(io.BytesIO(data[: len(data) - 8]))


def test_scene_with_nan_and_zero_quat_renders_finite():
    """NaN fields and zero-norm quats on SOME splats must not corrupt the
    rest of the render: the bad splat culls (NaN comparisons are false ->
    zero extent; normalize guards the zero quat) and the image stays finite.
    The reference gets nothing comparable — a NaN reaches its GPU sort keys
    unchecked."""
    import jax.numpy as jnp

    from splatapult_jax.core import transforms as T
    from splatapult_jax.io.gaussians import GaussianScene
    from splatapult_jax.render import Camera, RenderConfig, render

    cols = _trainer_cols(n=6)
    cols["x"][0] = np.nan          # NaN position
    cols["rot_0"][1] = 0.0         # zero-norm quat
    cols["rot_1"][1] = 0.0
    cols["rot_2"][1] = 0.0
    cols["rot_3"][1] = 0.0
    cols["opacity"][2] = np.inf    # sigmoid(inf) = 1: legal, must stay finite
    scene = scene_from_ply(_roundtrip(cols))
    scene = GaussianScene(**{f: jnp.asarray(getattr(scene, f))
                             for f in ("means", "sh", "opacities",
                                       "log_scales", "quats")})
    cam = Camera.from_fov(
        T.look_at(eye=[0.0, 0.5, 2.5], target=[0, 0, 0], up=[0, 1, 0]),
        fovy=np.pi / 4, width=64, height=64)
    for pipeline in ("tiled", "global"):
        cfg = RenderConfig(width=64, height=64, pipeline=pipeline,
                           tile_size=16, tile_block=8, max_instance_mult=30)
        img = np.asarray(render(scene, cam, cfg))
        assert np.isfinite(img).all(), pipeline
