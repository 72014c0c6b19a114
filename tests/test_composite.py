"""The tiled composite's two implementations and its dispatch.

The Triton kernels (ops/composite._fwd_kernel/_bwd_kernel) run here in Pallas
interpret mode against the plain jnp version (the CPU path and reference);
their lowering through the Triton route for CUDA is checked without a GPU by
exporting them. Also: the wrapper's choice of implementation, the per-tile
block ranges, and the slot expansion of ops/binning against a numpy
enumeration. The ``gpu`` test compares tiled, global and the float64 oracle
on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from splatapult_jax.ops import binning as B
from splatapult_jax.ops import composite as C
from splatapult_jax.ops.binning import TileGrid, bin_splats
from splatapult_jax.ops.tiled import pack_features

LAYOUTS = {
    "exact": {},
    "packed_colors": {"packed_colors": True},
    "packed_feats16": {"packed_feats16": True},
}


def _problem(seed, grid, n=96, stack=0):
    """Random splats binned on ``grid`` -> (inst rows, bins). ``stack``
    extra splats pile onto one tile so it owns many blocks."""
    rng = np.random.default_rng(seed)
    w, h = grid.width, grid.height
    mean2d = rng.uniform([-8.0, -8.0], [w + 8.0, h + 8.0], (n, 2))
    ext = rng.uniform(1.0, 18.0, (n, 2))
    conic = np.stack([rng.uniform(0.02, 0.3, n), rng.uniform(-0.02, 0.02, n),
                      rng.uniform(0.02, 0.3, n)], axis=1)
    rgb = rng.uniform(0.0, 1.0, (n, 3))
    alpha = rng.uniform(0.05, 0.99, n)
    if stack:  # wide, nearly opaque splats covering one whole tile
        mean2d[:stack] = [24.0, h - 24.0]
        ext[:stack] = 12.0
        conic[:stack] = [0.004, 0.0, 0.004]
        alpha[:stack] = 0.9
    depth = rng.uniform(0.5, 20.0, n)
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    bins = bin_splats(f32(mean2d), f32(ext), grid, depth=f32(depth))
    feats = pack_features(f32(mean2d), f32(conic), f32(rgb), f32(alpha))
    inst = jnp.take(C._pack_src(feats, grid), bins["inst_splat"], axis=0)
    return inst, bins


def _grid(**kw):
    base = dict(width=64, height=48, num_splats=128, tile_size=16, block=8,
                max_instance_mult=16)
    return TileGrid.create(**{**base, **kw})


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("accum", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_kernel_matches_plain(layout, accum, eps):
    """Interpret-mode kernels == plain version: forward rows, blocks
    composited per tile, and the backward's per-instance gradient columns
    (replaying the same blocks)."""
    grid = _grid(accum_dtype=accum, early_stop_eps=eps, **LAYOUTS[layout])
    inst, bins = _problem(7, grid, stack=40)
    out_p, nd_p = C._fwd_plain(inst, bins, grid)
    out_k, nd_k = C._fwd_kernel(inst, bins, grid, interpret=True)
    np.testing.assert_array_equal(np.asarray(nd_k), np.asarray(nd_p))
    # bf16 carries: one rounding step of the accumulated rows
    atol = 2e-5 if accum == "float32" else 8e-3
    np.testing.assert_allclose(np.asarray(out_k, np.float32),
                               np.asarray(out_p, np.float32), atol=atol)
    if eps > 0.0:  # early stop engaged somewhere
        assert (np.asarray(nd_k) < np.asarray(bins["tile_num_blocks"])).any()

    dout = jax.random.normal(jax.random.PRNGKey(1), out_p.shape, jnp.float32)
    dout = dout.at[:, 5:].set(0.0).astype(out_p.dtype)
    d_p = np.asarray(C._bwd_plain(inst, bins, out_k, nd_k, dout, grid))
    d_k = np.asarray(C._bwd_kernel(inst, bins, out_k, nd_k, dout, grid,
                                   interpret=True))
    assert d_k.shape == (C.NUM_GRAD_COLS, grid.mcap)
    # relative L2 per column; bf16 carries can round one ulp apart when the
    # two replays' f32 carries differ in their last bits
    rtol = 1e-4 if accum == "float32" else 1e-3
    for i in range(C.NUM_GRAD_COLS):
        ref = np.linalg.norm(d_p[i])
        assert ref > 0, i
        assert np.linalg.norm(d_k[i] - d_p[i]) <= rtol * ref, i


def test_empty_and_many_block_tiles():
    """A tile with no instances composites nothing (T = 1, ndone = 0); a
    stacked tile walks all of its blocks in both implementations."""
    grid = _grid()
    inst, bins = _problem(3, grid, n=44, stack=40)
    nblk = np.asarray(bins["tile_num_blocks"])
    assert nblk.max() >= 5 and (nblk == 0).any()
    for out, nd in (C._fwd_plain(inst, bins, grid),
                    C._fwd_kernel(inst, bins, grid, interpret=True)):
        out, nd = np.asarray(out), np.asarray(nd)
        np.testing.assert_array_equal(nd, nblk)
        empty = nblk == 0
        np.testing.assert_array_equal(out[empty, 4], 1.0)
        np.testing.assert_array_equal(out[empty, :4], 0.0)
        np.testing.assert_array_equal(out[:, 5:], 0.0)


def test_kernel_skips_padding_slots():
    """Slots of blocks no tile replays (beyond a tile's early stop, or past
    the last tile's blocks) get zero gradient columns."""
    grid = _grid(early_stop_eps=2.0)  # only each tile's first block runs
    inst, bins = _problem(5, grid, stack=40)
    out, nd = C._fwd_kernel(inst, bins, grid, interpret=True)
    dout = jnp.ones_like(out).at[:, 5:].set(0.0)
    d = np.asarray(C._bwd_kernel(inst, bins, out, nd, dout, grid,
                                 interpret=True))
    first = np.asarray(bins["tile_first_block"])
    nblk = np.asarray(bins["tile_num_blocks"])
    live = np.zeros(grid.num_blocks, bool)
    live[first[nblk > 0]] = True
    slots = np.repeat(live, grid.block)
    assert np.abs(d[:, ~slots]).max() == 0.0
    assert np.abs(d[:, slots]).max() > 0.0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernels_lower_for_cuda(layout):
    """Both kernels lower through Pallas's Triton route for CUDA at a 1080p
    grid (the lowering runs in Python; the GPU compiler is not asked)."""
    grid = TileGrid.create(width=1920, height=1080, num_splats=1000,
                           tile_size=16, block=64, early_stop_eps=1e-4,
                           **LAYOUTS[layout])
    nf = C._num_feats(grid)
    sds = jax.ShapeDtypeStruct
    inst = sds((grid.mcap, nf), jnp.float32 if nf == C.NUM_FEATS else jnp.int32)
    bins = {k: sds((grid.num_tiles,), jnp.int32)
            for k in ("tile_first_block", "tile_num_blocks")}
    bins["block_tile"] = sds((grid.num_blocks,), jnp.int32)
    out = sds((grid.num_tiles, C.OUT_ROWS, grid.tile_pixels), jnp.float32)
    nd = sds((grid.num_tiles,), jnp.int32)
    skip = [jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")]
    for fn, args in (
        (lambda i, b: C._fwd_kernel(i, b, grid), (inst, bins)),
        (lambda i, b, o, n, d: C._bwd_kernel(i, b, o, n, d, grid),
         (inst, bins, out, nd, out)),
    ):
        exp = jax.export.export(jax.jit(fn), platforms=["cuda"],
                                disabled_checks=skip)(*args)
        assert "__gpu$xla.gpu.triton" in exp.mlir_module()


def test_composite_impl_choice(monkeypatch):
    """The plain version on the CPU, the kernel on the GPU; any other
    platform raises."""
    assert C.composite_impl() == "plain"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert C.composite_impl() == "kernel"
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError):
        C.composite_impl()


def test_render_through_kernel_matches_plain(monkeypatch):
    """The whole tiled render and its gradients through the interpret-mode
    kernel match the plain path (the wrapper's custom VJP wiring)."""
    from splatapult_jax.core import transforms as T
    from splatapult_jax.io.gaussians import make_debug_scene
    from splatapult_jax.render import Camera, RenderConfig, render

    cfg = RenderConfig(width=64, height=48, pipeline="tiled", tile_size=16,
                       tile_block=8, max_instance_mult=24)
    cam = Camera.from_fov(
        T.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=64, height=48)
    scene = make_debug_scene()

    def loss(s):
        return jnp.mean(render(s, cam, cfg) ** 2)

    plain, gp = render(scene, cam, cfg), jax.grad(loss)(scene)
    monkeypatch.setattr(C, "composite_impl", lambda: "kernel")
    np.testing.assert_allclose(np.asarray(render(scene, cam, cfg)),
                               np.asarray(plain), atol=2e-6)
    gk = jax.grad(loss)(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(gk, name)), np.asarray(getattr(gp, name))
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), err_msg=name)


# ------------------------------------------------------- block ranges


@pytest.mark.parametrize("row_stride", [1, 2])
def test_tile_block_ranges(row_stride):
    """tile_first_block/tile_num_blocks partition the used blocks in tile
    order: num = ceil(count / B), first = its exclusive cumsum, and every
    block of the range holds only that tile's instances (or null padding)."""
    grid = _grid(row_stride=row_stride, height=64)
    rng = np.random.default_rng(11)
    n = 80
    mean2d = jnp.asarray(rng.uniform(0, 64, (n, 2)), jnp.float32)
    ext = jnp.asarray(rng.uniform(1, 20, (n, 2)), jnp.float32)
    depth = jnp.asarray(rng.uniform(1, 9, n), jnp.float32)
    bins = jax.tree.map(np.asarray, bin_splats(
        mean2d, ext, grid, depth=depth,
        row_offset=1 if row_stride > 1 else None))
    cnt, nblk, first = (bins["tile_count"], bins["tile_num_blocks"],
                        bins["tile_first_block"])
    np.testing.assert_array_equal(nblk, -(-cnt // grid.block))
    np.testing.assert_array_equal(first, np.cumsum(nblk) - nblk)
    if row_stride > 1:  # tiles of rows this shard does not own hold nothing
        rows = np.arange(grid.num_tiles) // grid.tiles_x
        assert (cnt[rows % row_stride != 1] == 0).all()
    bt = bins["block_tile"]
    for t in range(grid.num_tiles):
        assert (bt[first[t]:first[t] + nblk[t]] == t).all()
        slots = bins["inst_splat"][first[t] * grid.block:
                                   (first[t] + nblk[t]) * grid.block]
        assert (slots < n).sum() == cnt[t]
        assert (slots[cnt[t]:] == n).all()  # padding after the real ones


# ------------------------------------------------------- slot expansion


def _numpy_expand(mean2d, ext, grid, row_offset=None):
    """Independent enumeration: for each kept splat in order, its rect's
    owned tiles row-major -> (tile ids, splat ids) of the first total slots."""
    x0, r0, nx, ny, cnt = (np.asarray(a) for a in B._tile_rects(
        mean2d, ext, grid, row_offset=row_offset))
    step = grid.tiles_x * grid.row_stride
    tiles, splats = [], []
    for s in range(len(cnt)):
        if len(tiles) + cnt[s] > grid.emax:
            break  # capacity: whole splats past emax are dropped (no depth)
        for j in range(cnt[s]):
            tiles.append(r0[s] * grid.tiles_x + x0[s] + (j // nx[s]) * step
                         + j % nx[s])
            splats.append(s)
    return np.asarray(tiles, np.int64), np.asarray(splats, np.int64)


EXPAND_CASES = {
    "no_cull": dict(n=300, cull=0.0),
    "dense_cull": dict(n=300, cull=0.8),
    "overflow": dict(n=300, cull=0.0, emax=512),
    "row_stride": dict(n=300, cull=0.2, row_stride=2),
}


@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_expand_matches_numpy(case):
    """Slot expansion (splat-id scatter + cummax fill + rect gather) == a
    numpy enumeration of every kept splat's tiles."""
    c = EXPAND_CASES[case]
    rng = np.random.default_rng(sorted(EXPAND_CASES).index(case))
    grid = TileGrid.create(width=160, height=128, num_splats=c["n"],
                           tile_size=16, block=8, max_instance_mult=8,
                           row_stride=c.get("row_stride", 1))
    if "emax" in c:
        grid = dataclasses.replace(
            grid, emax=c["emax"],
            mcap=c["emax"] + grid.num_tiles // grid.row_stride * grid.block)
    mean2d = rng.uniform(-20, 180, (c["n"], 2)).astype(np.float32)
    ext = rng.uniform(0.5, 30.0, (c["n"], 2)).astype(np.float32)
    ext[rng.uniform(size=c["n"]) < c["cull"]] = 0.0
    off = 1 if grid.row_stride > 1 else None
    x0, r0, nx, ny, cnt = B._tile_rects(jnp.asarray(mean2d), jnp.asarray(ext),
                                        grid, row_offset=off)
    keep = jnp.cumsum(cnt) <= grid.emax
    if case == "overflow":
        assert int(jnp.sum(cnt)) > grid.emax
    cnt = jnp.where(keep, cnt, 0)
    offs = jnp.cumsum(cnt) - cnt
    kept = keep & (cnt > 0)
    want_t, want_s = _numpy_expand(mean2d, ext, grid, row_offset=off)
    tile, s = B._expand_slots(offs, kept, x0, r0, nx, grid, c["n"])
    total = int(jnp.sum(cnt))
    assert total == len(want_t) > 0
    np.testing.assert_array_equal(np.asarray(tile)[:total], want_t)
    np.testing.assert_array_equal(np.asarray(s)[:total], want_s)


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
def test_tiled_global_oracle_on_card(gpu, monkeypatch):
    """On the GPU at a bench-like shape: the tiled render (Triton kernels)
    agrees with the global pipeline and with the float64 oracle; its
    gradients agree with the plain version's."""
    from splatapult_jax.io.synth import garden_cameras, make_garden_scene
    from splatapult_jax.reference.raster import reference_render
    from splatapult_jax.render import RenderConfig, render

    scene = jax.tree.map(jnp.asarray, make_garden_scene(3000, seed=0))
    cam = garden_cameras(1, width=256, height_px=256)
    cfg = RenderConfig(width=256, height=256, pipeline="tiled")
    tiled = np.asarray(render(scene, cam, cfg))
    glob = np.asarray(render(scene, cam, dataclasses.replace(
        cfg, pipeline="global")))
    want = reference_render(scene.means, scene.sh, scene.opacities,
                            scene.log_scales, scene.quats,
                            np.asarray(cam.cam_to_world), np.asarray(cam.proj),
                            256, 256)
    for got in (tiled, glob):
        d = np.abs(got - want)
        assert d.max() <= 5e-3 and d.mean() <= 2e-5, (d.max(), d.mean())

    def loss(s):
        return jnp.mean(render(s, cam, cfg) ** 2)

    gk = jax.grad(loss)(scene)
    monkeypatch.setattr(C, "composite_impl", lambda: "plain")
    gp = jax.grad(loss)(scene)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a, b = np.asarray(getattr(gk, name)), np.asarray(getattr(gp, name))
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b), name
