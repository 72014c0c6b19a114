"""Tiled pipeline tests: binning invariants, forward equivalence vs. the
global pipeline, and hand-written-VJP equivalence vs. autodiff of the global
pipeline (SURVEY.md section 4 items 2-4; BASELINE config 3 correctness side).

On the CPU the tiled composite runs its plain jnp version
(ops/composite.composite_impl); tests/test_composite.py holds the Triton
kernels' interpret-mode tests."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from splatapult_jax.core import transforms as T
from splatapult_jax.io.gaussians import GaussianScene, make_debug_scene
from splatapult_jax.ops.binning import TileGrid, bin_splats
from splatapult_jax.render import Camera, RenderConfig, render

# small blocks/tiles so CPU tests stay fast
TILED = RenderConfig(
    width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8, max_instance_mult=20
)
GLOBAL = dataclasses.replace(TILED, pipeline="global", block_size=8)


def _camera(cfg=TILED, eye=(1.2, 1.1, 1.3)):
    c2w = T.look_at(eye=list(eye), target=[0.3, 0.3, 0.3], up=[0.0, 1.0, 0.0])
    return Camera.from_fov(c2w, fovy=np.pi / 4, width=cfg.width, height=cfg.height)


def _random_scene(rng, n=64, spread=0.8):
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    sh = rng.standard_normal((n, 3, 1)).astype(np.float32) * 0.5
    opac = rng.uniform(-1.0, 2.5, (n,)).astype(np.float32)
    log_scales = rng.uniform(-3.5, -1.5, (n, 3)).astype(np.float32)
    quats = rng.standard_normal((n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    return GaussianScene(
        means=jnp.asarray(means), sh=jnp.asarray(sh), opacities=jnp.asarray(opac),
        log_scales=jnp.asarray(log_scales), quats=jnp.asarray(quats),
    )


# ---------------------------------------------------------------- binning


def test_binning_basic_invariants():
    grid = TileGrid.create(width=64, height=64, num_splats=4, tile_size=16, block=8)
    # splat 0: interior of one tile; splat 1: culled;
    # splat 2: large, covers everything; splat 3: top-left corner
    mean2d = jnp.asarray([[8.0, 40.0], [0.0, 0.0], [32.0, 32.0], [4.0, 60.0]])
    radius = jnp.asarray([4.0, 0.0, 100.0, 4.0])
    bins = bin_splats(mean2d, radius, grid)
    inst = np.asarray(bins["inst_splat"])
    tcount = np.asarray(bins["tile_count"])
    assert tcount.sum() == 1 + 0 + 16 + 1
    assert int(bins["num_culled_instances"]) == 0
    # splat 2 appears in all 16 tiles
    assert (inst == 2).sum() == 16
    assert (inst == 1).sum() == 0
    # null padding fills the rest
    assert (inst == 4).sum() == inst.shape[0] - 18
    # y axis: screen y=60 (gl, +y up) is near the TOP -> tile row 0
    # tile of splat 3 must be row 0, col 0
    bt = np.asarray(bins["block_tile"])
    nblk = np.asarray(bins["tile_num_blocks"])
    first = np.asarray(bins["tile_first_block"])
    # each nonempty tile owns exactly ceil(count/8) consecutive blocks
    blocks_expected = int(np.sum((tcount + 7) // 8))
    np.testing.assert_array_equal(nblk, (tcount + 7) // 8)
    assert nblk.sum() == blocks_expected
    assert len(np.unique(bt[: blocks_expected])) == (tcount > 0).sum()
    for t in np.flatnonzero(nblk):
        assert (bt[first[t]:first[t] + nblk[t]] == t).all()
    assert (bt[blocks_expected:] == grid.num_tiles).all()


def test_binning_depth_order_preserved():
    # instances within a tile must keep the (front-to-back) input order
    grid = TileGrid.create(width=32, height=32, num_splats=8, tile_size=16, block=8)
    mean2d = jnp.tile(jnp.asarray([[8.0, 8.0]]), (8, 1))  # all in one tile
    radius = jnp.full((8,), 2.0)
    bins = bin_splats(mean2d, radius, grid)
    inst = np.asarray(bins["inst_splat"])
    # the tile owning pixel (8, 8): gl y=8 -> row 24 -> tile row 1; col 0
    members = inst[inst < 8]
    np.testing.assert_array_equal(members, np.arange(8))


def test_binning_depth_key_orders_unsorted_input():
    # with a depth argument, bin_splats must order instances front-to-back
    # per tile regardless of input order (the tiled path no longer pre-sorts)
    grid = TileGrid.create(width=32, height=32, num_splats=8, tile_size=16, block=8)
    mean2d = jnp.tile(jnp.asarray([[8.0, 8.0]]), (8, 1))  # all in one tile
    radius = jnp.full((8,), 2.0)
    rng = np.random.default_rng(3)
    depth = jnp.asarray(rng.permutation(8).astype(np.float32) + 1.0)
    bins = bin_splats(mean2d, radius, grid, depth=depth)
    inst = np.asarray(bins["inst_splat"])
    members = inst[inst < 8]
    np.testing.assert_array_equal(members, np.argsort(np.asarray(depth)))


def test_binning_depth_tie_break_reference_order():
    # equal depth: the reference's stable back-to-front radix draw implies the
    # HIGHER-index splat composites in front (ref: shader/presort_compute.glsl:
    # 52-53); front-to-back order is therefore descending index
    grid = TileGrid.create(width=32, height=32, num_splats=4, tile_size=16, block=8)
    mean2d = jnp.tile(jnp.asarray([[8.0, 8.0]]), (4, 1))
    radius = jnp.full((4,), 2.0)
    depth = jnp.asarray([2.0, 2.0, 1.0, 1.0])
    bins = bin_splats(mean2d, radius, grid, depth=depth)
    inst = np.asarray(bins["inst_splat"])
    members = inst[inst < 4]
    np.testing.assert_array_equal(members, np.asarray([3, 2, 1, 0]))


def test_binning_overflow_reported():
    grid = TileGrid.create(width=32, height=32, num_splats=2, tile_size=16, block=8,
                           max_instance_mult=1)
    # grid.emax = 8; two splats covering all 4 tiles -> 8 instances: fits.
    mean2d = jnp.tile(jnp.asarray([[16.0, 16.0]]), (2, 1))
    radius = jnp.full((2,), 100.0)
    bins = bin_splats(mean2d, radius, grid)
    assert int(bins["num_culled_instances"]) == 0
    # three such splats -> 12 raw instances > emax=8 -> overflow reported
    # (constructed directly: create() rounds emax up to >= 4096 for the
    # backward prefix-sum kernel, which would hide the overflow here)
    import dataclasses

    grid3 = dataclasses.replace(grid, emax=8, mcap=8 + grid.num_tiles * 8)
    mean3 = jnp.tile(jnp.asarray([[16.0, 16.0]]), (3, 1))
    bins3 = bin_splats(mean3, jnp.full((3,), 100.0), grid3)
    assert int(bins3["num_culled_instances"]) > 0


def test_binning_overflow_drops_farthest_with_depth():
    # with a depth key, capacity overflow must drop the FARTHEST splats, not
    # whatever happens to sit late in input order
    import dataclasses

    grid = TileGrid.create(width=32, height=32, num_splats=3, tile_size=16, block=8,
                           max_instance_mult=1)
    grid = dataclasses.replace(grid, emax=8, mcap=8 + grid.num_tiles * 8)
    mean2d = jnp.tile(jnp.asarray([[16.0, 16.0]]), (3, 1))
    radius = jnp.full((3,), 100.0)  # each splat -> 4 tiles; 12 raw > emax 8
    depth = jnp.asarray([5.0, 1.0, 2.0])  # the FIRST splat is the farthest
    bins = bin_splats(mean2d, radius, grid, depth=depth)
    inst = np.asarray(bins["inst_splat"])
    assert int(bins["num_culled_instances"]) == 4
    assert (inst == 0).sum() == 0  # farthest dropped
    assert (inst == 1).sum() == 4 and (inst == 2).sum() == 4
    # depth ties at the threshold: greedy refill keeps capacity exact
    bins2 = bin_splats(mean2d, radius, grid, depth=jnp.asarray([2.0, 1.0, 2.0]))
    inst2 = np.asarray(bins2["inst_splat"])
    assert int(bins2["num_culled_instances"]) == 4
    assert (inst2 == 1).sum() == 4  # strictly nearer always kept
    assert (inst2 == 0).sum() + (inst2 == 2).sum() == 4  # one of the tied pair


# ---------------------------------------------------------------- forward


def test_tiled_matches_global_debug_scene():
    scene = make_debug_scene()
    cam = _camera()
    a = np.asarray(render(scene, cam, TILED))
    b = np.asarray(render(scene, cam, GLOBAL))
    assert a.shape == b.shape == (64, 64, 4)
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_tiled_matches_global_random_scenes():
    rng = np.random.default_rng(101)  # test-local: session rng would make scenes order-dependent
    for trial in range(3):
        scene = _random_scene(rng, n=48)
        cam = _camera(eye=(1.2 + 0.2 * trial, 1.0, 1.4 - 0.3 * trial))
        a = np.asarray(render(scene, cam, TILED))
        b = np.asarray(render(scene, cam, GLOBAL))
        np.testing.assert_allclose(a, b, atol=3e-5, err_msg=f"trial {trial}")


def test_tiled_nonsquare_image():
    cfg = dataclasses.replace(TILED, width=80, height=48)
    gcfg = dataclasses.replace(cfg, pipeline="global")
    scene = make_debug_scene()
    cam = Camera.from_fov(
        T.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=80, height=48,
    )
    a = np.asarray(render(scene, cam, cfg))
    b = np.asarray(render(scene, cam, gcfg))
    assert a.shape == (48, 80, 4)
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_tiled_tile_size_invariance():
    rng = np.random.default_rng(102)
    scene = _random_scene(rng, n=32)
    cam = _camera()
    imgs = []
    for ts, blk in ((8, 8), (16, 8), (32, 16)):
        # small tiles multiply the per-splat instance count; give headroom
        cfg = dataclasses.replace(TILED, tile_size=ts, tile_block=blk, max_instance_mult=64)
        imgs.append(np.asarray(render(scene, cam, cfg)))
    np.testing.assert_allclose(imgs[0], imgs[1], atol=2e-5)
    np.testing.assert_allclose(imgs[1], imgs[2], atol=2e-5)


def test_tiled_empty_view():
    # camera looking away from every splat: defined, fully transparent output
    scene = make_debug_scene()
    c2w = T.look_at(eye=[0.0, 0.0, 5.0], target=[0.0, 0.0, 10.0], up=[0, 1, 0])
    cam = Camera.from_fov(c2w, fovy=np.pi / 4, width=64, height=64)
    img = np.asarray(render(scene, cam, TILED))
    np.testing.assert_allclose(img, 0.0, atol=1e-7)


# ---------------------------------------------------------------- backward


def test_tiled_grads_match_global():
    rng = np.random.default_rng(103)
    scene = _random_scene(rng, n=40)
    cam = _camera()
    target = jnp.asarray(rng.uniform(size=(64, 64, 4)), jnp.float32)

    def loss(cfg):
        return lambda s: jnp.mean((render(s, cam, cfg) - target) ** 2)

    # At the default 1/256 cutoff both pipelines compute the *identical*
    # function (the cutoff radius 3.33 sigma sits inside the 3.5 sigma binning
    # extent), so the hand-written VJP must match global autodiff tightly.
    gt = jax.grad(loss(TILED))(scene)
    gg = jax.grad(loss(GLOBAL))(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(gt, name)), np.asarray(getattr(gg, name))
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        # 1e-4: same function, but XLA fusion choices (which vary with the
        # in-process compilation cache) shift float rounding by ~1e-5
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4, err_msg=name)

    # With cutoff=0 the pipelines differ by the gaussian tail mass beyond the
    # 3.5 sigma binning radius (~exp(-6.125) ~ 2e-3 relative); allow that much.
    gt0 = jax.grad(loss(dataclasses.replace(TILED, alpha_cutoff=0.0)))(scene)
    gg0 = jax.grad(loss(dataclasses.replace(GLOBAL, alpha_cutoff=0.0)))(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(gt0, name)), np.asarray(getattr(gg0, name))
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-3, err_msg=name)


def test_tiled_grads_with_cutoff_finite():
    rng = np.random.default_rng(104)
    scene = _random_scene(rng, n=24)
    cam = _camera()

    def loss(s):
        return jnp.mean(render(s, cam, TILED) ** 2)

    g = jax.grad(loss)(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        assert np.isfinite(np.asarray(getattr(g, name))).all(), name


def test_tiled_grads_bf16_sort_close_to_f32():
    # grad_sort_dtype="bfloat16" rounds only the PER-INSTANCE gradients riding
    # the backward transpose sort (ops/composite._pack_bf16_pairs); per-splat
    # sums stay f32, so grads must match the f32 path to bf16 precision
    rng = np.random.default_rng(105)
    scene = _random_scene(rng, n=48)
    cam = _camera()
    target = jnp.asarray(rng.uniform(size=(64, 64, 4)), jnp.float32)

    def loss(cfg):
        return lambda s: jnp.mean((render(s, cam, cfg) - target) ** 2)

    g32 = jax.grad(loss(TILED))(scene)
    gbf = jax.grad(loss(dataclasses.replace(TILED, grad_sort_dtype="bfloat16")))(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(gbf, name)), np.asarray(getattr(g32, name))
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=1.5e-2, err_msg=name)


def test_tiled_packed_colors_close_to_f32():
    # packed_colors quantizes only the splat RGB to 16-bit fixed point (step
    # 2^-12); images must match the exact path to that precision and grads
    # must flow straight-through past the rounding
    rng = np.random.default_rng(106)
    scene = _random_scene(rng, n=48)
    cam = _camera()
    cfg_p = dataclasses.replace(TILED, packed_colors=True)

    img32 = np.asarray(render(scene, cam, TILED))
    imgp = np.asarray(render(scene, cam, cfg_p))
    # premultiplied contributions sum with weights <= 1, so the image error is
    # bounded by the per-color rounding (1.2e-4) plus discard-boundary flips
    np.testing.assert_allclose(imgp, img32, atol=5e-4)

    target = jnp.asarray(rng.uniform(size=(64, 64, 4)), jnp.float32)

    def loss(cfg):
        return lambda s: jnp.mean((render(s, cam, cfg) - target) ** 2)

    g32 = jax.grad(loss(TILED))(scene)
    gp = jax.grad(loss(cfg_p))(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(gp, name)), np.asarray(getattr(g32, name))
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-3, err_msg=name)


def test_tiled_packed_feats16_bounded_error():
    # packed_feats16 quantizes EVERY feature into 16 B rows (16-bit fixed
    # means ~0.09 px at 1080p — much finer at this test's 64 px frame —
    # f16 conic/ln-alpha, 11/11/10-bit colors). Coarser than packed_colors
    # by design (it exists for the 5M gather regime); the bounds here are
    # the committed error contract.
    rng = np.random.default_rng(107)
    scene = _random_scene(rng, n=48)
    cam = _camera()
    cfg_p = dataclasses.replace(TILED, packed_feats16=True)

    img32 = np.asarray(render(scene, cam, TILED))
    imgp = np.asarray(render(scene, cam, cfg_p))
    diff = np.abs(imgp - img32)
    # f16 conic (0.05% rel) + quantized means/colors; discard-boundary flips
    # dominate the max
    assert diff.max() < 0.05, diff.max()
    assert diff.mean() < 2e-3, diff.mean()

    target = jnp.asarray(rng.uniform(size=(64, 64, 4)), jnp.float32)

    def loss(cfg):
        return lambda s: jnp.mean((render(s, cam, cfg) - target) ** 2)

    g32 = jax.grad(loss(TILED))(scene)
    gp = jax.grad(loss(cfg_p))(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(gp, name)), np.asarray(getattr(g32, name))
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-2, err_msg=name)


def test_packed_feats16_roundtrip_bounds():
    # direct pack/unpack bounds at 1080p geometry (the regime it ships in)
    from splatapult_jax.ops.binning import TileGrid
    from splatapult_jax.ops.composite import (
        NUM_FEATS, _pack_feats16, _unpack_feats)

    grid = TileGrid.create(width=1920, height=1080, num_splats=64,
                           tile_size=32, block=128, packed_feats16=True)
    rng = np.random.default_rng(3)
    feats = np.zeros((256, NUM_FEATS), np.float32)
    feats[:, 0] = rng.uniform(-900, 2800, 256)      # mean_x in guard band
    feats[:, 1] = rng.uniform(-1000, 2000, 256)     # mean_y
    feats[:, 2] = rng.uniform(-1.7, 0.0, 256)       # qa
    feats[:, 3] = rng.uniform(-3.3, 3.3, 256)       # qb
    feats[:, 4] = rng.uniform(-1.7, 0.0, 256)       # qc
    feats[:, 5] = rng.uniform(-85.0, 0.0, 256)      # ln_alpha
    feats[:, 6:9] = rng.uniform(-3.5, 3.5, (256, 3))
    packed = _pack_feats16(jnp.asarray(feats), grid)
    assert packed.shape == (256, 4) and packed.dtype == jnp.int32
    geo, col = _unpack_feats(jnp.asarray(packed), grid)
    geo, col = np.asarray(geo), np.asarray(col)
    assert np.abs(geo[:, 0] - feats[:, 0]).max() <= 3 * 1920 / 65536 * 0.51
    assert np.abs(geo[:, 1] - feats[:, 1]).max() <= 3 * 1080 / 65536 * 0.51
    for i in (2, 3, 4):  # f16: 2^-11 relative
        np.testing.assert_allclose(geo[:, i], feats[:, i], rtol=6e-4, atol=1e-6)
    np.testing.assert_allclose(geo[:, 5], feats[:, 5], rtol=6e-4)
    assert np.abs(col[:, 0] - feats[:, 6]).max() <= 0.51 / 256
    assert np.abs(col[:, 1] - feats[:, 7]).max() <= 0.51 / 256
    assert np.abs(col[:, 2] - feats[:, 8]).max() <= 0.51 / 128


def test_tiled_extent_tightening_lossless_low_opacity():
    # render.prepare_splats shrinks binning AABBs to the sqrt(2*ln(alpha /
    # cutoff))-sigma radius where the kernel's 1/256 discard can pass; splats
    # with alpha <= cutoff generate no instances at all. Output must be
    # bit-identical in behavior to the untightened global composite.
    rng = np.random.default_rng(107)
    scene = _random_scene(rng, n=48)
    # opacities from deeply transparent (below the 1/256 cutoff) to opaque
    opac = np.linspace(-7.0, 3.0, 48).astype(np.float32)
    scene = dataclasses.replace(scene, opacities=jnp.asarray(opac))
    cam = _camera()
    a = np.asarray(render(scene, cam, TILED))
    b = np.asarray(render(scene, cam, GLOBAL))
    np.testing.assert_allclose(a, b, atol=3e-5)


def test_early_stop_noop_when_unsaturated():
    # a thin translucent scene never drives transmittance below eps, so the
    # early-stop path must compute the BIT-IDENTICAL image (same kernel body,
    # the skip predicate just never fires)
    rng = np.random.default_rng(108)
    scene = _random_scene(rng, n=48)
    scene = dataclasses.replace(
        scene, opacities=jnp.full_like(scene.opacities, -2.0))  # alpha ~ 0.12
    cam = _camera()
    a = np.asarray(render(scene, cam, TILED))
    b = np.asarray(render(scene, cam,
                          dataclasses.replace(TILED, early_stop_eps=1e-4)))
    np.testing.assert_array_equal(a, b)


def _opaque_stack_scene(n=64, opacity=3.0):
    """n identical huge splats on one spot: every pixel of the covered
    tiles saturates within the first compositing blocks (at high opacity),
    so early-stop MUST skip the later blocks."""
    means = np.tile(np.asarray([[0.3, 0.3, 0.3]], np.float32), (n, 1))
    means += np.linspace(0, 1e-3, n)[:, None].astype(np.float32)  # distinct depths
    sh = np.tile(np.asarray([[0.8], [0.2], [0.1]], np.float32)[None], (n, 1, 1))
    sh *= np.linspace(1.0, 0.2, n)[:, None, None].astype(np.float32)
    return GaussianScene(
        means=jnp.asarray(means), sh=jnp.asarray(sh),
        opacities=jnp.full((n,), opacity, jnp.float32),
        log_scales=jnp.full((n, 3), -0.5, jnp.float32),  # huge on screen
        quats=jnp.tile(jnp.asarray([[1.0, 0.0, 0.0, 0.0]], jnp.float32), (n, 1)),
    )


def test_early_stop_opaque_scene_error_bounded():
    # deep opaque stacks: skipping blocks once the tile's max transmittance
    # falls below eps can only drop contributions of total premultiplied
    # weight < eps per pixel (the analog of the per-pixel early-out the
    # reference gets from hardware blending, shader/splat_frag.glsl:38-41 +
    # back-to-front saturation)
    scene = _opaque_stack_scene()
    cam = _camera()
    eps = 1e-3
    exact = np.asarray(render(scene, cam, TILED))
    fast = np.asarray(render(scene, cam,
                             dataclasses.replace(TILED, early_stop_eps=eps)))
    assert np.abs(fast - exact).max() <= eps + 1e-6
    # and blocks were actually skipped (64 stacked alpha-0.95 splats cross
    # T < 1e-3 after ~3 of 8 blocks; the skipped tail's contributions are
    # tiny but nonzero, so the images cannot be bitwise identical)
    assert not np.array_equal(fast, exact)


def test_early_stop_predicate_wiring():
    # eps > 1 can never be satisfied by a transmittance (T <= 1), so ONLY the
    # first block of each tile may run: a deep tile must lose its later
    # blocks' contribution entirely — pins the skip predicate itself
    # alpha ~ 0.27: after the first 8-instance block T ~ 0.73^8 ~ 0.08, so
    # the dropped tail is a clearly visible ~8% of the color
    scene = _opaque_stack_scene(opacity=-1.0)
    cam = _camera()
    exact = np.asarray(render(scene, cam, TILED))
    first_only = np.asarray(render(scene, cam,
                                   dataclasses.replace(TILED, early_stop_eps=2.0)))
    diff = np.abs(first_only - exact).max()
    assert diff > 0.01  # later blocks genuinely contributed in exact mode
    assert diff < 1.0


def test_early_stop_grads_finite_and_close():
    rng = np.random.default_rng(110)
    scene = _random_scene(rng, n=120, spread=0.35)
    scene = dataclasses.replace(
        scene, opacities=jnp.full_like(scene.opacities, 3.0))
    cam = _camera()
    target = jnp.asarray(rng.uniform(size=(64, 64, 4)), jnp.float32)

    def loss(cfg):
        return lambda s: jnp.mean((render(s, cam, cfg) - target) ** 2)

    g0 = jax.grad(loss(TILED))(scene)
    g1 = jax.grad(loss(dataclasses.replace(TILED, early_stop_eps=1e-4)))(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(g1, name)), np.asarray(getattr(g0, name))
        assert np.isfinite(a).all(), name
        scale = np.abs(b).max() + 1e-8
        # skipped blocks' splats are occluded: their true grads are O(eps)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-3, err_msg=name)


def test_instance_demand_matches_binning(rng):
    """instance_demand == sum of per-tile counts when capacity is ample, and
    auto-sized capacity from it binned with zero overflow."""
    from splatapult_jax.ops.binning import instance_demand
    from splatapult_jax.render import prepare_splats

    scene = _random_scene(rng, n=96)
    cam = _camera()
    d = prepare_splats(scene, cam, TILED, sort=False)
    grid = TileGrid.create(
        width=TILED.width, height=TILED.height, num_splats=96,
        tile_size=TILED.tile_size, block=TILED.tile_block, max_instance_mult=20,
    )
    demand = int(instance_demand(d["mean2d"], d["extent"], grid))
    bins = bin_splats(d["mean2d"], d["extent"], grid, depth=d["depth"])
    assert demand == int(jnp.sum(bins["tile_count"]))
    assert int(bins["num_culled_instances"]) == 0

    # a fractional mult sized from the demand also bins without overflow
    mult = max(1.06 * demand, 1) / 96
    grid2 = TileGrid.create(
        width=TILED.width, height=TILED.height, num_splats=96,
        tile_size=TILED.tile_size, block=TILED.tile_block,
        max_instance_mult=mult,
    )
    bins2 = bin_splats(d["mean2d"], d["extent"], grid2, depth=d["depth"])
    assert int(bins2["num_culled_instances"]) == 0
    assert demand == int(jnp.sum(bins2["tile_count"]))


# -------------------------------------------------- forward_only / depth_bits


def test_forward_only_image_identical_and_no_mpos(rng):
    """forward_only is a pure contract marker since the m_pos payload was
    deleted for every profile: the rendered image must be bit-identical to
    the default path, and NO binning profile carries an m_pos array."""
    scene = _random_scene(rng)
    cam = _camera()
    cfg_fwd = dataclasses.replace(TILED, forward_only=True)
    a = np.asarray(render(scene, cam, TILED))
    b = np.asarray(render(scene, cam, cfg_fwd))
    np.testing.assert_array_equal(a, b)

    for fwd_only in (True, False):
        grid = TileGrid.create(width=32, height=32, num_splats=8, tile_size=16,
                               block=8, forward_only=fwd_only)
        mean2d = jnp.tile(jnp.asarray([[8.0, 8.0]]), (8, 1))
        bins = bin_splats(mean2d, jnp.full((8,), 2.0), grid,
                          depth=jnp.arange(8, dtype=jnp.float32) + 1.0)
        assert "m_pos" not in bins


def test_forward_only_grad_raises(rng):
    scene = _random_scene(rng, n=16)
    cam = _camera()
    cfg_fwd = dataclasses.replace(TILED, forward_only=True)

    def loss(s):
        return jnp.sum(render(s, cam, cfg_fwd) ** 2)

    with pytest.raises(ValueError, match="forward_only"):
        jax.grad(loss)(scene)


def test_depth16_matches_emulated_order(rng):
    """The packed (tile << 16 | bf16-depth) key must order instances exactly
    like a numpy emulation of (tile, depth>>16, -splat)."""
    import splatapult_jax.ops.binning as B

    grid = TileGrid.create(width=64, height=64, num_splats=48, tile_size=16,
                           block=8, max_instance_mult=20, depth_bits=16)
    mean2d = jnp.asarray(rng.uniform(0, 64, (48, 2)), jnp.float32)
    ext = jnp.asarray(rng.uniform(1.0, 10.0, (48, 2)), jnp.float32)
    # depths engineered to collide at bf16 granularity in places
    base = rng.uniform(0.5, 30.0, (48,)).astype(np.float32)
    base[::4] = base[1::4] * (1.0 + 1e-6)  # sub-bf16 separation -> ties
    depth = jnp.asarray(base)
    bins = bin_splats(mean2d, ext, grid, depth=depth)
    inst = np.asarray(bins["inst_splat"])

    # numpy emulation over the same rects
    x0, r0, nx, ny, cnt = jax.tree.map(
        np.asarray, B._tile_rects(mean2d, ext, grid))
    dbits = np.asarray(depth, np.float32).view(np.int32)
    rows = []
    for s in range(48):
        for j in range(cnt[s]):
            t = (r0[s] + j // nx[s]) * grid.tiles_x + (x0[s] + j % nx[s])
            rows.append((t, dbits[s] >> 16, -s, s))
    rows.sort()
    want = np.asarray([r[3] for r in rows])
    got = inst[inst < 48]
    np.testing.assert_array_equal(got, want)


def test_depth16_image_matches_depth32_when_separated():
    """With depths distinct at bf16 granularity the 16-bit key ordering equals
    the exact ordering, so the image must be bit-identical."""
    scene = make_debug_scene()
    cam = _camera()
    a = np.asarray(render(scene, cam, TILED))
    b = np.asarray(render(scene, cam, dataclasses.replace(TILED, depth_bits=16)))
    np.testing.assert_array_equal(a, b)


def test_depth16_tie_break_reference_order():
    grid = TileGrid.create(width=32, height=32, num_splats=4, tile_size=16,
                           block=8, depth_bits=16)
    mean2d = jnp.tile(jnp.asarray([[8.0, 8.0]]), (4, 1))
    bins = bin_splats(mean2d, jnp.full((4,), 2.0), grid,
                      depth=jnp.asarray([2.0, 2.0, 1.0, 1.0]))
    inst = np.asarray(bins["inst_splat"])
    np.testing.assert_array_equal(inst[inst < 4], np.asarray([3, 2, 1, 0]))


def test_depth16_infeasible_tile_count_falls_back_exact():
    """num_tiles >= 2^15 cannot pack into the key; the sort must silently use
    the exact 32-bit path (identical results to depth_bits=32)."""
    # 4096 x 2048 at tile 16 -> 256 * 128 = 32768 tiles
    g16 = TileGrid.create(width=4096, height=2048, num_splats=4, tile_size=16,
                          block=8, depth_bits=16)
    g32 = dataclasses.replace(g16, depth_bits=32)
    assert g16.num_tiles == 32768
    mean2d = jnp.asarray([[8.0, 8.0], [100.0, 700.0], [2000.0, 1000.0],
                          [100.0, 700.0]], jnp.float32)
    ext = jnp.full((4, 2), 30.0)
    depth = jnp.asarray([3.0, 1.0, 2.0, 1.0 + 1e-7])
    a = jax.tree.map(np.asarray, bin_splats(mean2d, ext, g16, depth=depth))
    b = jax.tree.map(np.asarray, bin_splats(mean2d, ext, g32, depth=depth))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_depth20_matches_emulated_order(rng):
    """The packed (tile << 20 | 20-bit depth) key must order instances exactly
    like a numpy emulation of (tile, depth_bits>>11, -splat)."""
    import splatapult_jax.ops.binning as B

    grid = TileGrid.create(width=64, height=64, num_splats=48, tile_size=16,
                           block=8, max_instance_mult=20, depth_bits=20)
    mean2d = jnp.asarray(rng.uniform(0, 64, (48, 2)), jnp.float32)
    ext = jnp.asarray(rng.uniform(1.0, 10.0, (48, 2)), jnp.float32)
    base = rng.uniform(0.5, 30.0, (48,)).astype(np.float32)
    base[::4] = base[1::4] * (1.0 + 1e-7)  # sub-quantum separation -> ties
    depth = jnp.asarray(base)
    bins = bin_splats(mean2d, ext, grid, depth=depth)
    inst = np.asarray(bins["inst_splat"])

    x0, r0, nx, ny, cnt = jax.tree.map(
        np.asarray, B._tile_rects(mean2d, ext, grid))
    dbits = np.asarray(depth, np.float32).view(np.int32)
    rows = []
    for s in range(48):
        for j in range(cnt[s]):
            t = (r0[s] + j // nx[s]) * grid.tiles_x + (x0[s] + j % nx[s])
            rows.append((t, (dbits[s] >> 11) & 0xFFFFF, -s, s))
    rows.sort()
    want = np.asarray([r[3] for r in rows])
    got = inst[inst < 48]
    np.testing.assert_array_equal(got, want)


def test_depth20_image_matches_depth32_when_separated():
    """With depths distinct at the 13-bit-mantissa granularity the 20-bit key
    ordering equals the exact ordering: bit-identical image."""
    scene = make_debug_scene()
    cam = _camera()
    a = np.asarray(render(scene, cam, TILED))
    b = np.asarray(render(scene, cam, dataclasses.replace(TILED, depth_bits=20)))
    np.testing.assert_array_equal(a, b)


def test_depth20_boundary_2048_tiles_falls_back_exact():
    """At EXACTLY 2048 tiles the packed sentinel key (num_tiles << 20 |
    0xFFFFF) would overflow the int32 sign bit and sort pads/sentinels BEFORE
    every real instance. The gate must be strict <, so a
    2048-tile grid takes the exact path and matches depth_bits=32 bit-exactly.
    """
    # 1024 x 512 at tile 16 -> 64 * 32 = exactly 2048 tiles
    g20 = TileGrid.create(width=1024, height=512, num_splats=4, tile_size=16,
                          block=8, depth_bits=20)
    g32 = dataclasses.replace(g20, depth_bits=32)
    assert g20.num_tiles == 2048
    mean2d = jnp.asarray([[8.0, 8.0], [100.0, 400.0], [900.0, 300.0],
                          [100.0, 400.0]], jnp.float32)
    ext = jnp.full((4, 2), 30.0)
    depth = jnp.asarray([3.0, 1.0, 2.0, 1.0 + 1e-7])
    a = jax.tree.map(np.asarray, bin_splats(mean2d, ext, g20, depth=depth))
    b = jax.tree.map(np.asarray, bin_splats(mean2d, ext, g32, depth=depth))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_depth20_infeasible_tile_count_falls_back_exact():
    """num_tiles > 2^11 cannot pack into the 31-bit key; the sort silently
    uses the exact 32-bit path."""
    # 4K x 2K at tile 32 -> 128 * 64 = 8192 tiles > 2048
    g20 = TileGrid.create(width=4096, height=2048, num_splats=4, tile_size=32,
                          block=8, depth_bits=20)
    g32 = dataclasses.replace(g20, depth_bits=32)
    assert g20.num_tiles == 8192
    mean2d = jnp.asarray([[8.0, 8.0], [100.0, 700.0], [2000.0, 1000.0],
                          [100.0, 700.0]], jnp.float32)
    ext = jnp.full((4, 2), 30.0)
    depth = jnp.asarray([3.0, 1.0, 2.0, 1.0 + 1e-7])
    a = jax.tree.map(np.asarray, bin_splats(mean2d, ext, g20, depth=depth))
    b = jax.tree.map(np.asarray, bin_splats(mean2d, ext, g32, depth=depth))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------- banded sort pipeline


def test_sort_bands_render_bit_identical(rng):
    """config.sort_bands splits the pipeline into interleaved tile-row bands
    (the 2^23 lax.sort cliff lever): per-tile instance segments are identical
    to the unbanded ordering, so the forward image must be BIT-identical."""
    scene = _random_scene(rng, n=96)
    cam = _camera()
    want = np.asarray(render(scene, cam, TILED))
    for k in (2, 4):
        cfg_k = dataclasses.replace(TILED, sort_bands=k)
        got = np.asarray(render(scene, cam, cfg_k))
        np.testing.assert_array_equal(got, want, err_msg=f"bands={k}")


def test_sort_bands_nondivisible_height(rng):
    # 3 tile rows over 2 bands: the banded grid pads the height, shifting
    # mean2d y by the pad — mathematically identity but f32 rounding of
    # (mean + pad) vs (pixel + pad) differs, so allclose rather than
    # bit-equal here (divisible heights, no shift, stay bit-identical)
    scene = _random_scene(rng, n=64)
    cfg = dataclasses.replace(TILED, height=48, sort_bands=2)
    cfg1 = dataclasses.replace(cfg, sort_bands=1)
    cam = _camera()
    a = np.asarray(render(scene, cam, cfg))
    b = np.asarray(render(scene, cam, cfg1))
    assert a.shape == (48, 64, 4)
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_sort_bands_grads_match(rng):
    """Each band's composite differentiates independently (band-capacity
    transpose tails); per-splat grads sum across bands and must match the
    unbanded gradients."""
    scene = _random_scene(rng, n=48)
    cam = _camera()
    cfg2 = dataclasses.replace(TILED, sort_bands=2)

    def loss(cfg):
        return lambda s: jnp.mean(render(s, cam, cfg) ** 2)

    la, ga = jax.value_and_grad(loss(TILED))(scene)
    lb, gb = jax.value_and_grad(loss(cfg2))(scene)
    np.testing.assert_allclose(float(la), float(lb), rtol=1e-6)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(ga, name)), np.asarray(getattr(gb, name))
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=1e-5, err_msg=name)


def test_sort_bands_calibration_sizes_per_band(rng):
    """calibrate_config with sort_bands sizes capacity to the PEAK BAND
    demand (smaller than full-view), and the banded render with that
    capacity matches the unbanded full-capacity render."""
    from splatapult_jax.render import calibrate_config

    scene = _random_scene(rng, n=2048)
    cam = _camera()
    base = dataclasses.replace(TILED, max_instance_mult=0.0)
    cal1 = calibrate_config(scene, cam, dataclasses.replace(base, sort_bands=1))
    cal4 = calibrate_config(scene, cam, dataclasses.replace(base, sort_bands=4))
    assert cal4.max_instance_mult < cal1.max_instance_mult
    a = np.asarray(render(scene, cam, cal4))
    b = np.asarray(render(scene, cam, cal1))
    np.testing.assert_array_equal(a, b)


def test_sort_bands_overflow_counted(rng):
    """Starved per-band capacity must COUNT its drops (never silent)."""
    from splatapult_jax.ops.tiled import composite_tiled
    from splatapult_jax.render import prepare_splats

    # big extents so the raw demand clears the 4096-row emax floor
    scene = _random_scene(rng, n=2048, spread=0.5)
    scene = dataclasses.replace(
        scene, log_scales=scene.log_scales + 1.5)  # inflate footprints
    cam = _camera()
    cfg = dataclasses.replace(TILED, sort_bands=2, max_instance_mult=0.02)
    splats = prepare_splats(scene, cam, cfg, sort=False)
    _, aux = composite_tiled(splats, cfg, return_aux=True)
    assert int(aux["num_culled_instances"]) > 0
