"""Multi-device SPMD tests on the 8-device CPU mesh (SURVEY.md section 4 item 5;
BASELINE configs 4-5 correctness side): sharded renders must equal single-device
renders, and sharded grads must equal unsharded grads (psum correctness)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from splatapult_jax.core import transforms as T
from splatapult_jax.io.gaussians import make_debug_scene
from splatapult_jax.parallel.mesh import (
    make_render_mesh,
    render_batch_sharded,
    render_sharded,
    shard_targets,
    sharded_train_step,
)
from splatapult_jax.render import Camera, RenderConfig, render, render_batch

CFG = RenderConfig(
    width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8, max_instance_mult=20
)


def _camera(eye=(1.2, 1.1, 1.3), w=64, h=64):
    c2w = T.look_at(eye=list(eye), target=[0.3, 0.3, 0.3], up=[0.0, 1.0, 0.0])
    return Camera.from_fov(c2w, fovy=np.pi / 4, width=w, height=h)


def _camera_batch(n, w=64, h=64):
    cams = [_camera((1.2 + 0.1 * i, 1.0, 1.4 - 0.2 * i), w, h) for i in range(n)]
    return Camera(
        cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
        proj=jnp.stack([c.proj for c in cams]),
    )


def test_device_count():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual CPU devices"


def test_render_sharded_matches_single():
    scene = make_debug_scene()
    cam = _camera()
    want = np.asarray(render(scene, cam, CFG))
    for n_shards in (1, 2, 4):
        mesh = make_render_mesh(num_tile_shards=n_shards)
        got = np.asarray(render_sharded(scene, cam, CFG, mesh))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=f"shards={n_shards}")


def test_render_sharded_nondivisible_height():
    cfg = dataclasses.replace(CFG, width=64, height=48)  # 3 tile rows over 2 shards
    scene = make_debug_scene()
    cam = _camera(w=64, h=48)
    want = np.asarray(render(scene, cam, cfg))
    mesh = make_render_mesh(num_tile_shards=2)
    got = np.asarray(render_sharded(scene, cam, cfg, mesh))
    assert got.shape == (48, 64, 4)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_render_batch_sharded_views_and_tiles():
    scene = make_debug_scene()
    cams = _camera_batch(4)
    want = np.asarray(render_batch(scene, cams, CFG))
    mesh = make_render_mesh(num_tile_shards=2, num_view_shards=4)
    got = np.asarray(render_batch_sharded(scene, cams, CFG, mesh))
    assert got.shape == want.shape == (4, 64, 64, 4)
    np.testing.assert_allclose(got, want, atol=2e-5)


def _random_scene(rng, n=48):
    # anisotropic random scene: the debug scene's identity quats + isotropic
    # covariances make quat grads degenerate (~0), which breaks relative
    # comparisons
    from splatapult_jax.io.gaussians import GaussianScene

    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return GaussianScene(
        means=jnp.asarray(rng.uniform(-0.8, 0.8, (n, 3)), jnp.float32),
        sh=jnp.asarray(rng.standard_normal((n, 3, 1)) * 0.5, jnp.float32),
        opacities=jnp.asarray(rng.uniform(-1, 2.5, (n,)), jnp.float32),
        log_scales=jnp.asarray(rng.uniform(-3.5, -1.5, (n, 3)), jnp.float32),
        quats=jnp.asarray(quats),
    )


def test_sharded_grads_match_unsharded():
    rng = np.random.default_rng(5)
    scene = _random_scene(rng)
    cams = _camera_batch(2)
    targets = jnp.asarray(rng.uniform(size=(2, 64, 64, 4)), jnp.float32)

    # unsharded reference loss/grads
    def loss(scene):
        imgs = render_batch(scene, cams, CFG)
        return jnp.mean((imgs - targets) ** 2)

    want_loss, want_grads = jax.value_and_grad(loss)(scene)

    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    tgt = shard_targets(targets, CFG, mesh)
    got_loss, got_grads, _ = sharded_train_step(scene, cams, tgt, CFG, mesh)

    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a = np.asarray(getattr(got_grads, name))
        b = np.asarray(getattr(want_grads, name))
        scale = np.abs(b).max() + 1e-8
        # psum + fusion-dependent rounding change the summation order vs
        # single-device accumulation
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-4, err_msg=name)


def test_sharded_train_step_with_optimizer():
    import optax

    scene = make_debug_scene()
    cams = _camera_batch(2)
    targets = jnp.zeros((2, 64, 64, 4), jnp.float32)
    mesh = make_render_mesh(num_tile_shards=2, num_view_shards=2)
    tgt = shard_targets(targets, CFG, mesh)
    opt = optax.adam(1e-2)
    opt_state = opt.init(scene)
    loss0, scene1, opt_state = sharded_train_step(scene, cams, tgt, CFG, mesh, opt, opt_state)
    loss1, _, _ = sharded_train_step(scene1, cams, tgt, CFG, mesh, opt, opt_state)
    assert np.isfinite(float(loss0)) and np.isfinite(float(loss1))
    # one adam step toward a black target must reduce the loss
    assert float(loss1) < float(loss0)


def test_sharded_grads_chunked_sh_psum_match():
    # sh_psum_chunks splits the SH all-reduce into per-band collectives
    # (parallel/mesh.py overlap lever); the summed result must be identical
    rng = np.random.default_rng(6)
    scene = _random_scene(rng)
    scene = dataclasses.replace(
        scene, sh=jnp.asarray(rng.standard_normal((48, 3, 16)) * 0.3, jnp.float32))
    cams = _camera_batch(2)
    targets = jnp.asarray(rng.uniform(size=(2, 64, 64, 4)), jnp.float32)
    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    tgt = shard_targets(targets, CFG, mesh)
    loss1, g1, _ = sharded_train_step(scene, cams, tgt, CFG, mesh)
    loss4, g4, _ = sharded_train_step(scene, cams, tgt, CFG, mesh,
                                      sh_psum_chunks=4)
    np.testing.assert_allclose(float(loss1), float(loss4), rtol=1e-6)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(g4, name)), np.asarray(getattr(g1, name))
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-6, err_msg=name)


def test_psum_in_bwd_marker_semantics():
    """_psum_in_bwd is identity forward; its cotangent is all-reduced —
    exactly once (the train step must not psum sh a second time)."""
    import jax
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from splatapult_jax.parallel.mesh import _psum_in_bwd

    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    x = jnp.arange(8.0)

    def shard_fn(x):
        def f(v):
            # per-shard loss depends on the marked value; each shard
            # contributes a different weight so the psum is observable
            w = 1.0 + lax.axis_index("tiles").astype(jnp.float32)
            return jnp.sum(_psum_in_bwd(v, ("views", "tiles")) * w)

        val, grad = jax.value_and_grad(f)(x)
        return val, grad

    val, grad = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(),), out_specs=(P(), P()),
        check_vma=False,
    )(x)
    # forward: identity (per-shard values; any shard's val is its own sum)
    # backward: sum over shards of w = 2 views * (1+2+3+4) = 20 per element
    np.testing.assert_allclose(np.asarray(grad), np.full(8, 20.0), rtol=1e-6)


def test_ring_all_reduce_matches_psum():
    """The manual ppermute ring (parallel/mesh.ring_all_reduce) must equal
    lax.psum for every shard, including non-divisible flat lengths."""
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from splatapult_jax.parallel.mesh import ring_psum

    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    rng = np.random.default_rng(9)
    for shape in ((8, 7, 3), (13,), (5, 2)):  # 21, 13, 10: none divide 4 or 8
        x = jnp.asarray(rng.standard_normal((8,) + shape), jnp.float32)

        def shard_fn(x):
            v = x.reshape(shape) * (1.0 + lax.axis_index("tiles")
                                    + 10.0 * lax.axis_index("views"))
            return ring_psum(v, ("views", "tiles")), lax.psum(v, ("views", "tiles"))

        ring, want = jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(("views", "tiles")),),
            out_specs=(P(), P()), check_vma=False,
        )(x.reshape(8, -1))
        ring, want = np.asarray(ring), np.asarray(want)
        # the ring sums in rotation order; elements that cancel are only
        # accurate relative to the magnitude of the terms, not the result
        scale = np.abs(want).max()
        np.testing.assert_allclose(ring / scale, want / scale,
                                   atol=2e-6, err_msg=str(shape))


def test_sharded_grads_ring_allreduce_match():
    """grad_allreduce='ring' must produce the same grads as the psum path."""
    rng = np.random.default_rng(7)
    scene = _random_scene(rng)
    cams = _camera_batch(2)
    targets = jnp.asarray(rng.uniform(size=(2, 64, 64, 4)), jnp.float32)
    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    tgt = shard_targets(targets, CFG, mesh)
    loss_p, g_p, _ = sharded_train_step(scene, cams, tgt, CFG, mesh)
    loss_r, g_r, _ = sharded_train_step(scene, cams, tgt, CFG, mesh,
                                        grad_allreduce="ring")
    np.testing.assert_allclose(float(loss_r), float(loss_p), rtol=1e-6)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(g_r, name)), np.asarray(getattr(g_p, name))
        scale = np.abs(b).max() + 1e-8
        # the ring sums in a different (rotation) order than psum
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-6, err_msg=name)


# ---------------------------------------------------- band-aware config 5


def test_prepare_sharded_bit_identical_nondivisible():
    """Sharded prepare (slice -> prepare -> all_gather) must reproduce the
    replicated prepare BIT-identically, including when the splat count does
    not divide the shard count (padded rows are inert and sliced away)."""
    rng = np.random.default_rng(7)
    scene = _random_scene(rng, n=50)  # 50 over 4 shards -> chunk 13, pad 2
    cam = _camera()
    for n_shards in (2, 4):
        mesh = make_render_mesh(num_tile_shards=n_shards)
        a = np.asarray(render_sharded(scene, cam, CFG, mesh, shard_prepare=True))
        b = np.asarray(render_sharded(scene, cam, CFG, mesh, shard_prepare=False))
        np.testing.assert_array_equal(a, b, err_msg=f"shards={n_shards}")
    want = np.asarray(render(scene, cam, CFG))
    np.testing.assert_allclose(a, want, atol=2e-5)


def test_sharded_grads_shard_prepare_match():
    """Gradients with the prepare sharded over 'tiles' (slice transpose +
    psum of disjoint slices) must equal the replicated-prepare gradients."""
    rng = np.random.default_rng(8)
    scene = _random_scene(rng, n=50)
    cams = _camera_batch(2)
    targets = jnp.asarray(rng.uniform(size=(2, 64, 64, 4)), jnp.float32)
    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    tgt = shard_targets(targets, CFG, mesh)
    loss_a, ga, _ = sharded_train_step(scene, cams, tgt, CFG, mesh,
                                       shard_prepare=True)
    loss_b, gb, _ = sharded_train_step(scene, cams, tgt, CFG, mesh,
                                       shard_prepare=False)
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-6)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(ga, name)), np.asarray(getattr(gb, name))
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-6, err_msg=name)


def test_band_demands_cover_and_bound():
    """band_instance_demands: each band's demand is <= the full-view demand,
    and the band sum >= the full demand (rects spanning a band boundary are
    counted once per band they touch)."""
    from splatapult_jax.ops.binning import TileGrid, instance_demand
    from splatapult_jax.parallel.mesh import band_instance_demands
    from splatapult_jax.render import prepare_splats

    rng = np.random.default_rng(9)
    scene = _random_scene(rng, n=64)
    cam = _camera()
    num_shards = 4
    bands = np.asarray(jax.jit(
        band_instance_demands, static_argnames=("config", "num_shards")
    )(scene, cam, CFG, num_shards))
    assert bands.shape == (num_shards,)

    splats = prepare_splats(scene, cam, CFG, sort=False)
    grid = TileGrid.create(width=CFG.width, height=CFG.height, num_splats=64,
                           tile_size=CFG.tile_size)
    full = int(instance_demand(splats["mean2d"], splats["extent"], grid))
    assert bands.max() <= full
    assert bands.sum() >= full
    assert bands.sum() > 0


def test_calibrate_config_sharded_shrinks_per_chip_sort():
    """Band calibration must produce a strictly smaller per-chip instance
    capacity than full-view calibration (each chip's sort runs at ~1/D
    rows), while the sharded render still matches single-chip."""
    import dataclasses as dc

    from splatapult_jax.ops.tiled import _grid_from_config
    from splatapult_jax.parallel.mesh import (
        _shard_config, calibrate_config_sharded)
    from splatapult_jax.render import calibrate_config

    rng = np.random.default_rng(10)
    # big enough that the full-view demand clears the 4096-row emax floor
    # (at toy demand both calibrations would hit the floor and tie)
    n = 2048
    scene = _random_scene(rng, n=n)
    cam = _camera()
    mesh = make_render_mesh(num_tile_shards=4)
    base = dc.replace(CFG, max_instance_mult=0.0)
    full_cfg = calibrate_config(scene, cam, base)
    band_cfg = calibrate_config_sharded(scene, cam, base, mesh)
    assert band_cfg.max_instance_mult < full_cfg.max_instance_mult

    # the capacity each chip's band grid actually allocates shrinks too
    g_full = _grid_from_config(_shard_config(full_cfg, 4), n)
    g_band = _grid_from_config(_shard_config(band_cfg, 4), n)
    assert g_band.emax < g_full.emax

    # correctness: the sharded render at BAND capacity matches the single
    # render at FULL capacity (the band demand fits the band config; the
    # single reference needs full-view capacity, which doesn't change the
    # image — only overflow would)
    want = np.asarray(render(scene, cam, full_cfg))
    got = np.asarray(render_sharded(scene, cam, band_cfg, mesh))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_fit_scene_mesh_chunked_matches_per_step():
    """fit_scene's mesh branch without a callback scans on-device (one
    readback per chunk); its loss curve must match the per-step path."""
    import optax

    from splatapult_jax.train import fit_scene

    rng = np.random.default_rng(11)
    scene = _random_scene(rng, n=32)
    cams = _camera_batch(2)
    targets = jnp.asarray(rng.uniform(size=(2, 64, 64, 4)), jnp.float32)
    mesh = make_render_mesh(num_tile_shards=2, num_view_shards=2)
    opt = optax.adam(1e-2)

    _, losses_scan = fit_scene(scene, cams, targets, CFG, steps=5,
                               optimizer=opt, mesh=mesh)
    seen = []
    _, losses_step = fit_scene(scene, cams, targets, CFG, steps=5,
                               optimizer=opt, mesh=mesh,
                               callback=lambda s, sc, l: seen.append(s))
    assert len(losses_scan) == len(losses_step) == 5
    assert seen == [0, 1, 2, 3, 4]
    np.testing.assert_allclose(losses_scan, losses_step, rtol=2e-5)
    assert losses_scan[-1] < losses_scan[0]


def test_render_sharded_contiguous_layout_matches_single():
    """The contiguous band layout stays supported (band_layout A/B)."""
    scene = make_debug_scene()
    cam = _camera()
    want = np.asarray(render(scene, cam, CFG))
    for n_shards in (2, 4):
        mesh = make_render_mesh(num_tile_shards=n_shards)
        got = np.asarray(render_sharded(scene, cam, CFG, mesh,
                                        band_layout="contiguous"))
        np.testing.assert_allclose(got, want, atol=2e-5,
                                   err_msg=f"shards={n_shards}")


def test_sharded_grads_layouts_match():
    """Interleaved and contiguous band layouts must produce the same loss and
    gradients (they partition the same instances differently)."""
    rng = np.random.default_rng(12)
    scene = _random_scene(rng, n=48)
    cams = _camera_batch(2)
    targets = jnp.asarray(rng.uniform(size=(2, 64, 64, 4)), jnp.float32)
    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    li, gi, _ = sharded_train_step(
        scene, cams, shard_targets(targets, CFG, mesh, "interleaved"),
        CFG, mesh, band_layout="interleaved")
    lc, gc, _ = sharded_train_step(
        scene, cams, shard_targets(targets, CFG, mesh, "contiguous"),
        CFG, mesh, band_layout="contiguous")
    np.testing.assert_allclose(float(li), float(lc), rtol=1e-5)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(gi, name)), np.asarray(getattr(gc, name))
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-4, err_msg=name)


def test_band_demands_interleaved_partitions_exactly():
    """Interleaved tile-row ownership partitions instances EXACTLY: the band
    demands must sum to the full-view demand (no rect spans two owners'
    rows twice — each (splat, tile) instance has one owner)."""
    from splatapult_jax.ops.binning import TileGrid, instance_demand
    from splatapult_jax.parallel.mesh import band_instance_demands
    from splatapult_jax.render import prepare_splats

    rng = np.random.default_rng(13)
    scene = _random_scene(rng, n=64)
    cam = _camera()
    bands = np.asarray(jax.jit(
        band_instance_demands,
        static_argnames=("config", "num_shards", "band_layout")
    )(scene, cam, CFG, 4, "interleaved"))
    splats = prepare_splats(scene, cam, CFG, sort=False)
    grid = TileGrid.create(width=CFG.width, height=CFG.height, num_splats=64,
                           tile_size=CFG.tile_size)
    full = int(instance_demand(splats["mean2d"], splats["extent"], grid))
    assert bands.sum() == full, (bands, full)
    assert bands.max() <= full


# --------------------- ZeRO-style parameter sharding ---------------------


def _perturbed(scene):
    return dataclasses.replace(
        scene, means=scene.means + 0.03, opacities=scene.opacities - 0.4)


def _fit_both(scene, cameras, targets, mesh, steps=3):
    import optax

    from splatapult_jax.parallel.mesh import (
        make_sharded_fit_steps, zero_fit_steps,
    )

    opt = optax.adam(1e-2)
    fit = make_sharded_fit_steps(CFG, mesh, opt, steps)
    tg = shard_targets(jnp.asarray(targets), CFG, mesh)
    s_ref, _, losses_ref = fit(scene, cameras, tg, opt.init(scene))
    s_z, opt_state, losses_z = zero_fit_steps(
        scene, cameras, targets, CFG, mesh, opt, steps)
    return (s_ref, np.asarray(losses_ref)), (s_z, np.asarray(losses_z), opt_state)


def test_zero_fit_matches_replicated_sharded():
    """Parameter-sharded (ZeRO) updates == replicated-scene sharded updates:
    the prepare VJP is linear in its cotangent, so completing grads through
    the feature all_gather's transpose psum-scatter is the same math as the
    replicated path's full grad all-reduce."""
    scene = make_debug_scene()
    cam = _camera()
    cameras = Camera(cam_to_world=cam.cam_to_world[None], proj=cam.proj[None])
    targets = np.asarray(render(scene, cam, CFG))[None]
    pert = _perturbed(scene)
    mesh = make_render_mesh(num_tile_shards=4)
    (s_ref, l_ref), (s_z, l_z, _) = _fit_both(pert, cameras, targets, mesh)
    np.testing.assert_allclose(l_z, l_ref, rtol=2e-5, atol=1e-8)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        np.testing.assert_allclose(
            np.asarray(getattr(s_ref, name)), np.asarray(getattr(s_z, name)),
            rtol=1e-4, atol=2e-6, err_msg=name)


def test_zero_fit_views_axis_and_odd_n():
    """2x4 (views x tiles) mesh with a splat count that does not divide the
    tiles axis: padding stays inert and the views-axis grad psum (the only
    cross-chip gradient collective left) completes the update."""
    scene = make_debug_scene()
    n = scene.means.shape[0]
    odd = jax.tree.map(lambda x: x[: n - 1], scene)
    cameras = _camera_batch(2)
    cams = [Camera(cam_to_world=cameras.cam_to_world[i], proj=cameras.proj[i])
            for i in range(2)]
    targets = np.stack([np.asarray(render(odd, c, CFG)) for c in cams])
    pert = _perturbed(odd)
    mesh = make_render_mesh(num_tile_shards=4, num_view_shards=2)
    (s_ref, l_ref), (s_z, l_z, opt_state) = _fit_both(pert, cameras, targets, mesh)
    np.testing.assert_allclose(l_z, l_ref, rtol=2e-5, atol=1e-8)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        np.testing.assert_allclose(
            np.asarray(getattr(s_ref, name)), np.asarray(getattr(s_z, name)),
            rtol=1e-4, atol=2e-6, err_msg=name)
    # continuation round-trips the sharded opt_state
    import optax

    from splatapult_jax.parallel.mesh import zero_fit_steps

    opt = optax.adam(1e-2)
    s_z2, opt_state, l2 = zero_fit_steps(
        s_z, cameras, targets, CFG, mesh, opt, 2, opt_state=opt_state)
    assert l2.shape == (2,) and np.isfinite(np.asarray(l2)).all()


def test_zero_fit_no_full_size_grad_allreduce():
    """The structural point of the ZeRO path: the compiled HLO must carry NO
    all-reduce touching a full-[N] gradient tree — the replicated sharded
    step has exactly that (59 f32 x N variadic all-reduce), the ZeRO step's
    only gradient collective is the chunk-sized views psum (elided here,
    views axis = 1)."""
    import re

    import optax

    from splatapult_jax.parallel.mesh import (
        make_sharded_fit_steps, make_zero_fit_steps, pad_scene_to_mesh,
    )

    scene = make_debug_scene()
    n = scene.means.shape[0]
    cam = _camera()
    cameras = Camera(cam_to_world=cam.cam_to_world[None], proj=cam.proj[None])
    targets = jnp.zeros((1, CFG.height, CFG.width, 4), jnp.float32)
    opt = optax.adam(1e-2)
    mesh = make_render_mesh(num_tile_shards=8)
    tg = shard_targets(targets, CFG, mesh)

    def allreduce_rows(txt):
        rows = []
        for line in txt.splitlines():
            m = re.search(r"= (\(?.*?\)?) all-reduce(-start)?\(", line)
            if m:
                rows.extend(int(d.split(",")[0]) for d in
                            re.findall(r"f32\[(\d+[0-9,]*)\]", m.group(1)))
        return rows

    rep = jax.jit(make_sharded_fit_steps(CFG, mesh, opt, 1)).lower(
        scene, cameras, tg, opt.init(scene)).compile().as_text()
    assert any(r == n for r in allreduce_rows(rep)), (
        "expected the replicated path's full-[N] grad all-reduce")

    padded, true_n = pad_scene_to_mesh(scene, mesh)
    zero = jax.jit(make_zero_fit_steps(CFG, mesh, opt, 1, true_n,
                                       int(scene.sh.shape[-1]))).lower(
        padded, cameras, tg, opt.init(padded)).compile().as_text()
    assert all(r < n for r in allreduce_rows(zero)), (
        f"ZeRO path leaks a full-size grad all-reduce: {allreduce_rows(zero)}")
