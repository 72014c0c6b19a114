"""End-to-end forward renders vs. the float64 oracle (BASELINE config 1) and
projection unit checks (SURVEY.md section 4, items 2-3)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from splatapult_jax.core import transforms as T
from splatapult_jax.core.project import project_gaussians
from splatapult_jax.io.gaussians import load_gaussian_ply, make_debug_scene
from splatapult_jax.reference.raster import reference_render
from splatapult_jax.render import Camera, RenderConfig, render, render_batch


def _debug_camera(width=128, height=128, eye=(1.2, 1.1, 1.3)):
    cam_to_world = T.look_at(eye=list(eye), target=[0.3, 0.3, 0.3], up=[0.0, 1.0, 0.0])
    return Camera.from_fov(cam_to_world, fovy=np.pi / 4, width=width, height=height)


def _oracle(scene, camera, width, height, alpha_cutoff=1.0 / 256.0):
    return reference_render(
        scene.means, scene.sh, scene.opacities, scene.log_scales, scene.quats,
        np.asarray(camera.cam_to_world), np.asarray(camera.proj), width, height,
        alpha_cutoff=alpha_cutoff,
    )


def test_projection_center_matches_pinhole():
    # a splat straight ahead of the camera must project to the image center
    means = jnp.asarray([[0.0, 0.0, -5.0]])
    cov3 = jnp.eye(3)[None] * 0.01
    view = jnp.eye(4)
    proj = T.perspective(np.pi / 4, 1.0, 0.1, 100.0)
    out = project_gaussians(means, cov3, view, proj, (256, 256))
    np.testing.assert_allclose(np.asarray(out.mean2d[0]), [128.0, 128.0], atol=1e-4)
    assert bool(out.mask[0])
    np.testing.assert_allclose(float(out.depth[0]), 5.0, atol=1e-5)


def test_projection_isotropic_cov_scales_with_depth():
    # an isotropic world cov s^2*I at depth d projects to ~ (f*s/d)^2*I + 0.3*I
    s = 0.05
    d = 4.0
    width = height = 256
    means = jnp.asarray([[0.0, 0.0, -d]])
    cov3 = jnp.eye(3)[None] * s * s
    proj = T.perspective(np.pi / 2, 1.0, 0.1, 100.0)  # focal px = height/2 / tan(45) = 128
    out = project_gaussians(means, cov3, jnp.eye(4), proj, (width, height))
    focal_px = height / 2.0
    expect = (focal_px * s / d) ** 2
    cov2 = np.asarray(out.cov2d[0])
    np.testing.assert_allclose(cov2[0], expect + 0.3, rtol=1e-4)
    np.testing.assert_allclose(cov2[2], expect + 0.3, rtol=1e-4)
    np.testing.assert_allclose(cov2[1], 0.0, atol=1e-5)


def test_projection_culling():
    means = jnp.asarray(
        [
            [0.0, 0.0, -5.0],  # visible
            [0.0, 0.0, 5.0],  # behind camera
            [100.0, 0.0, -5.0],  # far off-screen (|ndc.x| > 1.5)
            [0.0, 0.0, -0.11],  # in front of near plane but fails ndc.z >= 0.25
        ]
    )
    cov3 = jnp.tile(jnp.eye(3)[None] * 0.01, (4, 1, 1))
    proj = T.perspective(np.pi / 4, 1.0, 0.1, 1000.0)
    out = project_gaussians(means, cov3, jnp.eye(4), proj, (256, 256))
    np.testing.assert_array_equal(np.asarray(out.mask), [True, False, False, False])


def test_render_debug_scene_matches_oracle():
    scene = make_debug_scene()
    cam = _debug_camera()
    cfg = RenderConfig(width=128, height=128, pipeline="global", block_size=8)
    img = np.asarray(render(scene, cam, cfg))
    want = _oracle(scene, cam, 128, 128)
    assert img.shape == (128, 128, 4)
    assert want[..., 3].max() > 0.5  # scene actually covers pixels
    np.testing.assert_allclose(img, want, atol=2e-5)


def test_render_test_ply_matches_oracle(test_ply_path):
    scene = load_gaussian_ply(test_ply_path)
    # camera derived from the shipped pose file data/test_vr.json would need the
    # floor transform; a generic orbit camera suffices for coverage here.
    cam_to_world = T.look_at(eye=[0.0, 0.5, 2.5], target=[0.0, 0.0, 0.0], up=[0.0, 1.0, 0.0])
    cam = Camera.from_fov(cam_to_world, fovy=np.pi / 4, width=256, height=256)
    cfg = RenderConfig(width=256, height=256, pipeline="global", block_size=16)
    img = np.asarray(render(scene, cam, cfg))
    want = _oracle(scene, cam, 256, 256)
    assert want[..., 3].max() > 0.1
    # The 1/256 discard (shader/splat_frag.glsl:38-41) is a hard discontinuity:
    # pixels where float32 vs float64 evaluation of alpha*g straddles the
    # threshold legitimately differ. Require near-exactness everywhere else.
    diff = np.abs(img - want)
    assert np.mean(diff) < 5e-5
    assert np.quantile(diff, 0.995) < 1e-4
    assert diff.max() < 0.05
    # with the discontinuity disabled the match must be tight everywhere
    img_smooth = np.asarray(
        render(scene, cam, dataclasses.replace(cfg, alpha_cutoff=0.0))
    )
    want_smooth = _oracle(scene, cam, 256, 256, alpha_cutoff=0.0)
    np.testing.assert_allclose(img_smooth, want_smooth, atol=5e-5)


def test_render_nosh_uses_dc_only(test_ply_path):
    scene = load_gaussian_ply(test_ply_path)
    cam = _debug_camera()
    cfg_full = RenderConfig(width=64, height=64, pipeline="global", block_size=16)
    cfg_nosh = RenderConfig(width=64, height=64, pipeline="global", block_size=16, sh_degree=0)
    img_full = np.asarray(render(scene, cam, cfg_full))
    img_nosh = np.asarray(render(scene, cam, cfg_nosh))
    zeroed = jax.tree.map(lambda x: x, scene)
    zeroed.sh = jnp.asarray(np.asarray(scene.sh)).at[:, :, 1:].set(0.0)
    img_zeroed = np.asarray(render(zeroed, cam, cfg_full))
    np.testing.assert_allclose(img_nosh, img_zeroed, atol=1e-5)
    assert np.abs(img_full - img_nosh).max() >= 0.0  # runs without error


def test_render_block_size_invariance():
    # compositing must not depend on the scan block partition
    scene = make_debug_scene()
    cam = _debug_camera(64, 64)
    imgs = [
        np.asarray(render(scene, cam, RenderConfig(64, 64, pipeline="global", block_size=b)))
        for b in (1, 4, 16)
    ]
    np.testing.assert_allclose(imgs[0], imgs[1], atol=1e-5)
    np.testing.assert_allclose(imgs[1], imgs[2], atol=1e-5)


def test_render_bf16_accumulation_close():
    # --fp16 analog (ref: src/app.cpp:1000-1035): bf16 accumulation stays close
    scene = make_debug_scene()
    cam = _debug_camera(64, 64)
    f32 = np.asarray(render(scene, cam, RenderConfig(64, 64, pipeline="global")))
    bf16 = np.asarray(
        render(scene, cam, RenderConfig(64, 64, pipeline="global", accum_dtype="bfloat16"))
    )
    np.testing.assert_allclose(bf16, f32, atol=0.05)


def test_render_bf16_accumulation_tiled():
    # the tiled Pallas kernels honor the same knob: per-block math stays f32,
    # only the carried (color, alpha, T) tile rows round to bf16
    scene = make_debug_scene()
    cam = _debug_camera(64, 64)
    cfg = RenderConfig(64, 64, pipeline="tiled", tile_size=16, tile_block=8,
                       max_instance_mult=20)
    f32 = np.asarray(render(scene, cam, cfg))
    bf16 = np.asarray(
        render(scene, cam, dataclasses.replace(cfg, accum_dtype="bfloat16"))
    )
    assert bf16.dtype == np.float32  # API dtype is unchanged
    np.testing.assert_allclose(bf16, f32, atol=0.05)
    # gradients still flow (approximate under bf16 accumulation)
    g = jax.grad(
        lambda s: float32_loss(s, cam, dataclasses.replace(cfg, accum_dtype="bfloat16"))
    )(scene)
    assert np.isfinite(np.asarray(g.means)).all()


def float32_loss(scene, cam, cfg):
    import jax.numpy as jnp

    return jnp.mean(render(scene, cam, cfg).astype(jnp.float32) ** 2)


def test_render_batch_shape():
    scene = make_debug_scene()
    cams = [
        Camera.from_fov(
            T.look_at(eye=[np.cos(a) * 2, 1.0, np.sin(a) * 2], target=[0, 0, 0], up=[0, 1, 0]),
            fovy=np.pi / 4, width=32, height=32,
        )
        for a in (0.0, 1.0, 2.0)
    ]
    batch = Camera(
        cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
        proj=jnp.stack([c.proj for c in cams]),
    )
    out = np.asarray(render_batch(scene, batch, RenderConfig(32, 32, pipeline="global")))
    assert out.shape == (3, 32, 32, 4)
    # views differ
    assert np.abs(out[0] - out[1]).max() > 1e-3


def test_render_floor_transform_changes_view():
    scene = make_debug_scene()
    cam = _debug_camera(32, 32)
    floor = np.eye(4, dtype=np.float32)
    floor[:3, 3] = [0.5, 0.0, 0.0]
    moved = cam.with_floor_transform(floor)
    a = np.asarray(render(scene, cam, RenderConfig(32, 32, pipeline="global")))
    b = np.asarray(render(scene, moved, RenderConfig(32, 32, pipeline="global")))
    assert np.abs(a - b).max() > 1e-3


def test_render_supersample_resolve():
    # USE_SUPERSAMPLING analog (ref: shader/desktop_frag.glsl:19-30): the
    # supersampled render must equal an explicit hi-res render + box filter
    scene = make_debug_scene()
    cam = _debug_camera(32, 32)
    cfg = RenderConfig(32, 32, pipeline="global", supersample=2)
    ss = np.asarray(render(scene, cam, cfg))
    hi = np.asarray(render(scene, cam, RenderConfig(64, 64, pipeline="global")))
    manual = hi.reshape(32, 2, 32, 2, 4).mean(axis=(1, 3))
    assert ss.shape == (32, 32, 4)
    np.testing.assert_allclose(ss, manual, atol=1e-6)


def test_calibrate_config_right_sizes_capacity():
    """calibrate_config fits the measured demand with headroom: rendering
    under the calibrated capacity matches the generous-default render and
    reports zero overflow."""
    from splatapult_jax.ops.binning import TileGrid, bin_splats
    from splatapult_jax.render import calibrate_config, prepare_splats

    scene = make_debug_scene()
    cfg = RenderConfig(width=64, height=64, pipeline="tiled", tile_size=16,
                       tile_block=8, max_instance_mult=5000)
    cam = _debug_camera(64, 64)
    cal = calibrate_config(scene, cam, cfg)
    assert cal.max_instance_mult < 5000
    a = np.asarray(render(scene, cam, cfg))
    b = np.asarray(render(scene, cam, cal))
    np.testing.assert_allclose(a, b, atol=1e-6)
    d = prepare_splats(scene, cam, cal, sort=False)
    grid = TileGrid.create(width=64, height=64, num_splats=scene.means.shape[0],
                           tile_size=16, block=8,
                           max_instance_mult=cal.max_instance_mult)
    bins = bin_splats(d["mean2d"], d["extent"], grid, depth=d["depth"])
    assert int(bins["num_culled_instances"]) == 0

    # batched cameras: peak demand across views, computed in ONE jitted pass
    import jax.numpy as jnp

    far_cam = _debug_camera(64, 64, eye=(6.0, 6.0, 6.0))  # smaller footprint
    batch = Camera(
        cam_to_world=jnp.stack([cam.cam_to_world, far_cam.cam_to_world]),
        proj=jnp.stack([cam.proj, far_cam.proj]),
    )
    cal_b = calibrate_config(scene, batch, cfg)
    # the batch peak must cover the single-view demand of its worst view
    assert cal_b.max_instance_mult >= cal.max_instance_mult * 0.999


def test_bucket_capacity_mult_grid():
    """bucket_capacity_mult rounds UP onto the geometric grid, never down."""
    from splatapult_jax.render import CAPACITY_BUCKET, bucket_capacity_mult

    for m in (0.3, 1.0, 1.07, 1.7199, 2.49, 5000.0):
        q = bucket_capacity_mult(m)
        assert q >= m * (1 - 1e-12)
        assert q <= m * CAPACITY_BUCKET + 1e-9
        # exact grid points are fixed points
        assert bucket_capacity_mult(q) == q
    assert bucket_capacity_mult(2.0, bucket=1.0) == 2.0  # exact mode


def test_calibrate_config_bucketing_shares_compiles():
    """Nearby cameras (demands within one geometric bucket) must calibrate to
    an IDENTICAL config — the whole point: config equality == compile reuse.
    A 4-view sweep of near-coincident cameras compiles
    once, not 4 times."""
    import bench
    from splatapult_jax.render import calibrate_config

    # big enough that the measured demand (not the 4096 floor) sets the mult
    scene = bench.make_scene(30_000, seed=3)
    cfg = RenderConfig(width=64, height=64, pipeline="tiled", tile_size=16,
                       tile_block=8, max_instance_mult=50)
    cams = [_debug_camera(64, 64, eye=(0.0, 0.8 + dz, 4.5)) for dz in
            (0.0, 0.02, 0.04, 0.06)]
    exacts = [calibrate_config(scene, c, cfg, bucket=1.0) for c in cams]
    # the sweep's demands genuinely differ (else this test proves nothing)...
    mults = sorted(e.max_instance_mult for e in exacts)
    assert mults[0] < mults[-1]
    assert mults[0] > 4096 / 30_000  # demand-driven, not the floor
    # ...yet the bucketed calibrations collapse onto (at most a boundary-
    # straddling pair of) shared configs, each covering its views' demands
    cals = [calibrate_config(scene, c, cfg) for c in cams]
    distinct = {c.max_instance_mult for c in cals}
    assert len(distinct) < len(set(mults))
    assert len(distinct) <= 2
    for cal, exact in zip(cals, exacts):
        assert cal.max_instance_mult >= exact.max_instance_mult * (1 - 1e-12)


def test_capacity_mult_covers_demand():
    """capacity_mult_for_demand: headroom over the demand, bucketed UP, and
    never below the 4096-slot floor."""
    from splatapult_jax.render import bucket_capacity_mult, capacity_mult_for_demand

    n = 1_000_000
    for demand in (10, 1_723_000, 2_300_000):
        mult = capacity_mult_for_demand(demand, n)
        assert mult * n >= max(demand * 1.06, 4096) * (1 - 1e-12)
        assert mult == bucket_capacity_mult(mult)  # on the grid
        assert mult <= max(demand * 1.06, 4096) / n * 1.08 * (1 + 1e-9)
    assert capacity_mult_for_demand(1_723_000, n, bucket=1.0) == 1_723_000 * 1.06 / n
