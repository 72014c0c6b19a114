"""Tiled render path: binning + gather + composite + image assembly.

The production pipeline for real scene sizes (the v0 global path in render.py
is O(N * P) and kept as a second-tier oracle). Differentiability: the binning
indices are non-differentiable plumbing (stop_gradient); gradients flow
through the composite's hand-written VJP, which also transposes the feature
gather (ops/composite.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from splatapult_jax.ops.binning import TileGrid, bin_splats
from splatapult_jax.ops.composite import NULL_LN_ALPHA, NUM_FEATS, composite_from_feats


def _grid_from_config(config, num_splats: int, row_stride: int = 1) -> TileGrid:
    return TileGrid.create(
        width=config.width,
        height=config.height,
        num_splats=num_splats,
        tile_size=config.tile_size,
        block=config.tile_block,
        max_instance_mult=config.max_instance_mult,
        alpha_cutoff=config.alpha_cutoff,
        early_stop_eps=config.early_stop_eps,
        accum_dtype=config.accum_dtype,
        grad_sort_dtype=config.grad_sort_dtype,
        packed_colors=config.packed_colors,
        forward_only=config.forward_only,
        depth_bits=config.depth_bits,
        packed_feats16=config.packed_feats16,
        row_stride=row_stride,
    )


def pack_features(mean2d, conic, rgb, alpha):
    """[N] splat arrays -> [N + 1, 16] feature rows; last row is the null splat.

    The kernel parameterization folds the opacity into the exponent
    (ops/composite.py): qa = -a/2, qb = -b, qc = -c/2 and ln(alpha), so
    w = alpha * exp(-0.5 q) is a single exp. Gradients to conic/alpha flow
    through these transforms by autodiff.
    """
    n = mean2d.shape[0]
    qcoef = conic * jnp.asarray([-0.5, -1.0, -0.5], conic.dtype)
    ln_alpha = jnp.log(jnp.maximum(alpha, 1e-37))[:, None]
    feats = jnp.concatenate(
        [mean2d, qcoef, ln_alpha, rgb,
         jnp.zeros((n, NUM_FEATS - 9), mean2d.dtype)],
        axis=1,
    )
    null = jnp.zeros((1, NUM_FEATS), feats.dtype).at[0, 5].set(NULL_LN_ALPHA)
    return jnp.concatenate([feats, null], axis=0)


def assemble_image(out, tile_ok, grid: TileGrid, config) -> jax.Array:
    """Per-tile composite output [T, 8, P] -> [H, W, 4] image (row 0 = top)."""
    # tiles without instances -> transparent background (the composite
    # already writes it for them; banded and sharded callers pass the
    # union of their owners' tile_ok)
    background = jnp.concatenate(
        [jnp.zeros((4,)), jnp.ones((1,)), jnp.zeros((3,))]
    ).astype(out.dtype)
    out = jnp.where(tile_ok[:, None, None], out, background[None, :, None])

    ts = grid.tile_size
    img = (
        out[:, :4, :]
        .reshape(grid.tiles_y, grid.tiles_x, 4, ts, ts)
        .transpose(0, 3, 1, 4, 2)
        .reshape(grid.tiles_y * ts, grid.tiles_x * ts, 4)
    )
    return img[: config.height, : config.width, :].astype(jnp.float32)


def composite_tiled(sorted_splats, config, return_aux: bool = False):
    """Render sorted splats through the tiled pipeline -> [H, W, 4]."""
    if getattr(config, "sort_bands", 1) > 1:
        return _composite_tiled_banded(sorted_splats, config, return_aux)
    mean2d = sorted_splats["mean2d"]
    n = mean2d.shape[0]
    grid = _grid_from_config(config, n)

    bins = bin_splats(
        jax.lax.stop_gradient(mean2d),
        jax.lax.stop_gradient(sorted_splats["extent"]),
        grid,
        depth=jax.lax.stop_gradient(sorted_splats["depth"]),
    )

    feats = pack_features(
        mean2d, sorted_splats["conic"], sorted_splats["rgb"], sorted_splats["alpha"]
    )
    out = composite_from_feats(feats, bins, grid)
    img = assemble_image(out, bins["tile_ok"], grid, config)
    if return_aux:
        return img, {
            "num_culled_instances": bins["num_culled_instances"],
            "tile_count": bins["tile_count"],
        }
    return img


def _composite_tiled_banded(sorted_splats, config, return_aux: bool = False):
    """composite_tiled split into config.sort_bands interleaved tile-row
    bands, each a full independent bin -> gather -> composite pipeline at
    ~1/K capacity (smaller sorts, RenderConfig.sort_bands).

    Exactness: bands own disjoint tile rows (row_stride/row_offset in
    ops.binning), each tile's instance segment is identical to the unbanded
    ordering, and the combine selects whole tiles — bit-identical forward.
    The backward differentiates each band's composite independently (its
    transpose tail also runs at band capacity); per-splat gradients sum
    across bands through the shared ``feats`` input.
    """
    import dataclasses

    import jax.numpy as _jnp

    k = config.sort_bands
    ts = config.tile_size
    ty = -(-config.height // ts)
    h_pad = -(-ty // k) * k * ts
    cfg_full = dataclasses.replace(config, height=h_pad, sort_bands=1)
    mean2d = sorted_splats["mean2d"] + _jnp.asarray(
        [0.0, float(h_pad - config.height)], _jnp.float32)
    n = mean2d.shape[0]
    grid = _grid_from_config(cfg_full, n, row_stride=k)
    ng = jax.lax.stop_gradient
    feats = pack_features(
        mean2d, sorted_splats["conic"], sorted_splats["rgb"],
        sorted_splats["alpha"],
    )

    out = None
    tile_ok = None
    culled = jnp.int32(0)
    tcount = jnp.zeros((grid.num_tiles,), jnp.int32)
    for b_idx in range(k):
        bins = bin_splats(
            ng(mean2d), ng(sorted_splats["extent"]), grid,
            depth=ng(sorted_splats["depth"]), row_offset=b_idx,
        )
        out_b = composite_from_feats(feats, bins, grid)
        ok_b = bins["tile_ok"]
        out = out_b if out is None else jnp.where(
            ok_b[:, None, None], out_b, out)
        tile_ok = ok_b if tile_ok is None else (tile_ok | ok_b)
        culled = culled + bins["num_culled_instances"]
        tcount = tcount + bins["tile_count"]

    img = assemble_image(out, tile_ok, grid, config)
    if return_aux:
        return img, {"num_culled_instances": culled, "tile_count": tcount}
    return img
