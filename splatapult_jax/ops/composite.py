"""Tile-binned front-to-back alpha compositing, forward + backward.

This replaces the reference's entire per-pixel GPU stage — the geometry-
shader quad expansion (shader/splat_geom.glsl:83-106), the fragment shader's
gaussian evaluation (shader/splat_frag.glsl:20-28) and the fixed-function
back-to-front "over" blending (src/app.cpp:153-156) — with an explicit per-tile
transmittance loop, plus a hand-written VJP the reference (a forward-only
viewer) has no analog of.

Dataflow (see ops/binning.py for how the work-list is built): the instance
buffer is sorted by (tile, depth); every tile owns ``tile_num_blocks[t]``
consecutive B-instance blocks starting at block ``tile_first_block[t]``, padded
with null instances (weight 0). Per tile the composite walks its blocks front
to back, carrying per-pixel colour C and transmittance T:

    w = exp(qh) (0 below the 1/256 cutoff),  C += T * w * rgb,  T *= 1 - w.

Early stop: a tile stops before any block (past its first) whose entering
max-over-pixels T is below ``early_stop_eps``. The forward also returns how
many blocks each tile composited, so the backward replays exactly those.

The backward replays front to back from the saved final colour and T: with
the colour still to come after splat j, S_j = C_fin - C_through_j,

    dL/dw_j = T_j * (rgb_j . dC) - (S_j . dC + (dT - dA) * T_fin) / (1 - w_j),

and the nine per-instance gradient columns are reductions over the tile's
pixels. Per-instance columns land in unique slots, so no atomics are needed;
ops/composite._cff_bwd then segment-sums them per splat.

Two implementations of one contract:
- plain ``jnp``/``lax`` (``_fwd_plain``/``_bwd_plain``): all blocks in parallel
  (chunked through ``lax.map``), then a per-tile sequential join of the block
  results. It is the reference and the CPU path.
- Pallas kernels through Triton (``_fwd_kernel``/``_bwd_kernel``): one program
  per tile, one thread per pixel, walking the tile's blocks with a dynamic
  trip count — the design of the INRIA 3DGS tile rasterizer.
``composite_from_feats`` picks the kernel on ``gpu`` and the plain version on
``cpu``; any other platform raises.

Feature parameterization: the opacity rides inside the exponent —
  w = exp(qa*dx^2 + qb*dx*dy + qc*dy^2 + ln(alpha))
with qa = -a/2, qb = -b, qc = -c/2 from the conic (a, b, c). This fuses the
alpha multiply into the exp and makes the 1/256 discard
(shader/splat_frag.glsl:38-41) a comparison on the exponent.

Layouts (B = block, P = tile_size^2 pixels):
  instance features  [Mcap, 16] f32, cols: mean_x, mean_y, qa, qb, qc,
                     ln_alpha, r, g, b, 0...  (null row: ln_alpha = -100)
                     or the packed [Mcap, 8] / [Mcap, 4] int32 rows below
  per-tile output    [T, 8, P], rows: premult r, g, b, alpha, T, 0, 0, 0
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from splatapult_jax.ops.binning import TileGrid

NUM_FEATS = 16
OUT_ROWS = 8
NULL_LN_ALPHA = -100.0  # exp(-100) ~ 4e-44: no visible contribution
# feature column indices
F_MX, F_MY, F_QA, F_QB, F_QC, F_LNA, F_R, F_G, F_B = range(9)
NUM_GRAD_COLS = 9  # d_mx, d_my, d_qa, d_qb, d_qc, d_lna, dr, dg, db
# packed_colors mode: 16-bit fixed-point color quantization (step 2^-12,
# range +-8); rows shrink to 8 int32 cols = 32 B
COLOR_SCALE = 4096.0
NUM_FEATS_PACKED = 8
# packed_feats16 mode: EVERY feature quantized into 4 int32 = 16 B rows.
# Layout per row:
#   w0: mean_x | mean_y as unsigned 16-bit fixed point over [-W, 2W) x
#       [-H, 2H) (the CLIP=1.5 guard band bounds live means to
#       [-W/2, 1.5W]); step = 3W/65536 (~0.088 px at 1080p)
#   w1: f16(qa) << 16 | f16(qb)
#   w2: f16(qc) << 16 | f16(ln_alpha)
#   w3: r:11 | g:11 | b:10 unsigned fixed point over [-4, 4)
# Coarser than packed_colors (color step 2^-8/2^-7 vs 2^-12; the reference's
# own --fp16 framebuffer is comparable); gated by image/grad-error tests.
# Null rows encode exactly (ln_alpha = -100 is f16-representable).
NUM_FEATS_PACKED16 = 4
MEAN16_STEPS = 65536.0
COLOR11_SCALE = 256.0  # 11-bit channels: step 1/256 over [-4, 4)
COLOR10_SCALE = 128.0  # 10-bit channel:  step 1/128 over [-4, 4)
# clamp of 1 - w in the backward's 1/(1 - w) (alpha -> 1 splats)
_MIN_ONE_MINUS = 1e-9


def _num_feats(grid) -> int:
    if grid.packed_feats16:
        return NUM_FEATS_PACKED16
    return NUM_FEATS_PACKED if grid.packed_colors else NUM_FEATS


def _num_read(grid) -> int:
    """Columns of a row the composite reads (exact rows: the first nine)."""
    return min(_num_feats(grid), 9)


def _mean16_scales(grid):
    """(sx, sy): steps per pixel of the 16-bit mean quantization."""
    return (MEAN16_STEPS / (3.0 * grid.width),
            MEAN16_STEPS / (3.0 * grid.height))


def _f16_bits(x):
    """f32 column [*, 1] -> uint32 of its f16 bit pattern."""
    return lax.bitcast_convert_type(
        x.astype(jnp.float16), jnp.uint16).astype(jnp.uint32)


def _bits_f16(h):
    """int32 whose low 16 bits are an f16 bit pattern -> f32.

    The signed 16-bit value is formed exactly before the narrowing cast (no
    wrap-around), then bit-cast to f16 — a cast Triton lowers."""
    h = h & 0xFFFF
    h = jnp.where(h >= 0x8000, h - 0x10000, h).astype(jnp.int16)
    return lax.bitcast_convert_type(h, jnp.float16).astype(jnp.float32)


def _pack_feats16(feats, grid):
    """[*, 16] f32 feature rows -> [*, 4] int32 (see NUM_FEATS_PACKED16)."""
    sx, sy = _mean16_scales(grid)
    qx = jnp.clip(jnp.round((feats[:, F_MX:F_MX + 1] + grid.width) * sx),
                  0.0, 65535.0).astype(jnp.uint32)
    qy = jnp.clip(jnp.round((feats[:, F_MY:F_MY + 1] + grid.height) * sy),
                  0.0, 65535.0).astype(jnp.uint32)
    w0 = (qx << 16) | qy
    w1 = (_f16_bits(feats[:, F_QA:F_QA + 1]) << 16) | _f16_bits(
        feats[:, F_QB:F_QB + 1])
    w2 = (_f16_bits(feats[:, F_QC:F_QC + 1]) << 16) | _f16_bits(
        feats[:, F_LNA:F_LNA + 1])
    qr = jnp.clip(jnp.round((feats[:, F_R:F_R + 1] + 4.0) * COLOR11_SCALE),
                  0.0, 2047.0).astype(jnp.uint32)
    qg = jnp.clip(jnp.round((feats[:, F_G:F_G + 1] + 4.0) * COLOR11_SCALE),
                  0.0, 2047.0).astype(jnp.uint32)
    qb = jnp.clip(jnp.round((feats[:, F_B:F_B + 1] + 4.0) * COLOR10_SCALE),
                  0.0, 1023.0).astype(jnp.uint32)
    w3 = (qr << 21) | (qg << 10) | qb
    return lax.bitcast_convert_type(
        jnp.concatenate([w0, w1, w2, w3], axis=1), jnp.int32)


def _pack_color_feats(feats):
    """[*, 16] f32 feature rows -> [*, 8] INT32: cols 0-5 the bit-cast f32
    geometry + ln-alpha, RGB as three 16-bit fixed-point halves in cols 6-7.

    The array is int32, not f32 with integer payloads: packed color words
    whose bits happen to form a NaN (any q in [-128, -1] sets the f32
    exponent field all-ones) could have their payload canonicalized by a
    float copy; integer arrays are never touched."""
    q = jnp.clip(
        jnp.round(feats[:, F_R : F_R + 3] * COLOR_SCALE), -32768.0, 32767.0
    ).astype(jnp.int32)
    cw0 = (q[:, 0:1] << 16) | (q[:, 1:2] & 0xFFFF)
    cw1 = q[:, 2:3] << 16
    geo = lax.bitcast_convert_type(feats[:, :6], jnp.int32)
    return jnp.concatenate([geo, cw0, cw1], axis=1)


def _decode(cols, grid):
    """Feature columns of one row layout -> the nine f32 fields.

    ``cols`` is the sequence of a row's columns, each an array of one common
    shape (scalars in the forward kernel, [B] vectors in the backward kernel,
    [..., B] in the plain version): 16 f32 columns in exact mode, 8 int32 in
    packed_colors mode, 4 int32 in packed_feats16 mode. Returns
    (mx, my, qa, qb, qc, ln_alpha, r, g, b)."""
    if grid.packed_feats16:
        w0, w1, w2, w3 = cols
        sx, sy = _mean16_scales(grid)
        # arithmetic >> then mask is exact for these unsigned fields
        mx = ((w0 >> 16) & 0xFFFF).astype(jnp.float32) * (1.0 / sx) - grid.width
        my = (w0 & 0xFFFF).astype(jnp.float32) * (1.0 / sy) - grid.height
        r = ((w3 >> 21) & 0x7FF).astype(jnp.float32) * (1.0 / COLOR11_SCALE) - 4.0
        g = ((w3 >> 10) & 0x7FF).astype(jnp.float32) * (1.0 / COLOR11_SCALE) - 4.0
        b = (w3 & 0x3FF).astype(jnp.float32) * (1.0 / COLOR10_SCALE) - 4.0
        return (mx, my, _bits_f16(w1 >> 16), _bits_f16(w1), _bits_f16(w2 >> 16),
                _bits_f16(w2), r, g, b)
    if not grid.packed_colors:
        return tuple(cols[:9])
    geo = [lax.bitcast_convert_type(c, jnp.float32) for c in cols[:6]]
    inv = 1.0 / COLOR_SCALE
    r = (cols[6] >> 16).astype(jnp.float32) * inv  # arithmetic shift: sign ok
    g = ((cols[6] << 16) >> 16).astype(jnp.float32) * inv  # sign-extend low half
    b = (cols[7] >> 16).astype(jnp.float32) * inv
    return (*geo, r, g, b)


def _unpack_feats(raw, grid):
    """[M, F] encoded rows -> (geometry [M, 6] f32, colors [M, 3] f32)."""
    f = _decode([raw[:, i] for i in range(raw.shape[1])], grid)
    return jnp.stack(f[:6], axis=1), jnp.stack(f[6:], axis=1)


def _pack_src(feats, grid):
    """Feature-table encoding for the instance gather (see _num_feats)."""
    if grid.packed_feats16:
        return _pack_feats16(feats, grid)
    return _pack_color_feats(feats) if grid.packed_colors else feats


def _acc_dtype(grid: TileGrid):
    """Accumulation dtype of the per-tile output rows (--fp16/--fp32 analog,
    ref: src/app.cpp:1000-1035). Per-block math is always f32; only the
    carried (color, alpha, transmittance) rows round to bf16, once per block."""
    return jnp.bfloat16 if grid.accum_dtype == "bfloat16" else jnp.float32


def _round_acc(x, grid):
    acc = _acc_dtype(grid)
    return x if acc == jnp.float32 else x.astype(acc).astype(jnp.float32)


def _pixel_coords(t, grid: TileGrid):
    """gl_FragCoord-style pixel centers of tile(s) ``t`` -> (px, py), each of
    shape t.shape + (P,)."""
    ts = grid.tile_size
    t = jnp.asarray(t)
    if t.ndim:
        t = t[..., None]
    pidx = lax.broadcasted_iota(jnp.int32, (grid.tile_pixels,), 0)
    px = ((t % grid.tiles_x) * ts + pidx % ts).astype(jnp.float32) + 0.5
    py = (grid.height - ((t // grid.tiles_x) * ts + pidx // ts)).astype(
        jnp.float32) - 0.5
    return px, py


def _weights(f, px, py, grid: TileGrid):
    """Composite weights w = alpha * g for splat fields ``f`` (broadcasting
    against the pixel coordinates). The 1/256 discard is a comparison on
    the exponent: w > cutoff  <=>  qh > ln(cutoff)."""
    mx, my, qa, qb, qc, lna = f[:6]
    dx = px - mx
    dy = py - my
    qh = qa * dx * dx + qb * dx * dy + qc * dy * dy + lna
    w = jnp.exp(qh)
    if grid.alpha_cutoff > 0.0:
        w = jnp.where(qh > math.log(grid.alpha_cutoff), w, 0.0)
    return w, dx, dy


def _out_rows(cr, cg, cb, t, grid):
    """Carries -> the eight output rows, in the accumulation dtype."""
    z = jnp.zeros_like(t)
    return [v.astype(_acc_dtype(grid)) for v in (cr, cg, cb, 1.0 - t, t, z, z, z)]


def _excl_cumprod(om):
    """Exclusive cumulative product along axis -2 (the transmittance in
    front of each splat of a block, entering T = 1)."""
    ones = jnp.ones_like(om[..., :1, :])
    return jnp.cumprod(jnp.concatenate([ones, om[..., :-1, :]], axis=-2), axis=-2)


def _block_grads(f, px, py, t_in, c_in, cfin, tfin, dc, da, dt, grid):
    """Per-instance gradient columns of one or more blocks (the plain
    backward's block body; arrays broadcast as [..., B, P]).

    f: nine [..., B, 1] fields; px/py [..., 1, P]; t_in [..., 1, P] and
    c_in (3 x [..., 1, P]) the carries entering the block; cfin/dc (3 x)
    and tfin/da/dt [..., 1, P] the tile's final rows and their cotangents.
    Returns nine [..., B] columns in NUM_GRAD_COLS order."""
    w, dx, dy = _weights(f, px, py, grid)
    om = 1.0 - w
    t_before = t_in * _excl_cumprod(om)
    eff = t_before * w
    r, g, b = f[6:9]
    cdot = r * dc[0] + g * dc[1] + b * dc[2]
    row = (da - dt) * tfin - sum(dc[i] * (cfin[i] - c_in[i]) for i in range(3))
    incl = jnp.cumsum(eff * cdot, axis=-2)
    dw = (incl + row) / jnp.maximum(om, _MIN_ONE_MINUS) + t_before * cdot
    dqh = w * dw
    gx = jnp.sum(dqh * dx, axis=-1)
    gy = jnp.sum(dqh * dy, axis=-1)
    qa, qb, qc = (v[..., 0] for v in f[2:5])
    return (
        -(2.0 * qa * gx + qb * gy),
        -(qb * gx + 2.0 * qc * gy),
        jnp.sum(dqh * dx * dx, axis=-1),
        jnp.sum(dqh * dx * dy, axis=-1),
        jnp.sum(dqh * dy * dy, axis=-1),
        jnp.sum(dqh, axis=-1),
        jnp.sum(eff * dc[0], axis=-1),
        jnp.sum(eff * dc[1], axis=-1),
        jnp.sum(eff * dc[2], axis=-1),
    )


# ----------------------------------------------------------------- plain


def _plain_chunk(grid: TileGrid) -> int:
    """Blocks per lax.map step of the plain version: bounds the [K, B, P]
    intermediates to ~2^24 elements on the card (~2^20 on the CPU). Fixed
    per platform and shape, so a tile's arithmetic never depends on where
    its blocks sit in the buffer."""
    elems = 1 << (24 if jax.default_backend() == "gpu" else 20)
    return max(1, elems // (grid.block * grid.tile_pixels))


def _map_blocks(fn, inst, block_args, grid: TileGrid):
    """Apply ``fn(inst_blocks [K, B, F], *[K, ...] args)`` over every block
    in chunks of K -> outputs with a leading [NB] axis."""
    nb, b = grid.num_blocks, grid.block
    k = min(_plain_chunk(grid), nb)
    nchunks = -(-nb // k)
    pad = nchunks * k - nb
    inst = inst.reshape(nb, b, inst.shape[-1])

    def chunked(x):
        x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        return x.reshape((nchunks, k) + x.shape[1:])

    outs = lax.map(lambda a: fn(*a), (chunked(inst),) + tuple(
        chunked(a) for a in block_args))
    return jax.tree.map(lambda o: o.reshape((nchunks * k,) + o.shape[2:])[:nb],
                        outs)


def _block_fields(inst_blk, grid):
    """[K, B, F] encoded rows -> nine [K, B, 1] f32 fields."""
    cols = [inst_blk[..., i] for i in range(_num_read(grid))]
    return tuple(v[..., None] for v in _decode(cols, grid))


def _block_tiles(bins, grid):
    """Owning tile of every block (dead blocks clamp to the last tile)."""
    return jnp.minimum(bins["block_tile"], grid.num_tiles - 1)


def _replayed_blocks(bins, ndone, grid):
    """[NB] bool: the blocks the forward composited (and the backward
    replays): the first ndone[t] blocks of each tile t."""
    tiles = _block_tiles(bins, grid)
    kth = jnp.arange(grid.num_blocks, dtype=jnp.int32) - bins[
        "tile_first_block"][tiles]
    return (bins["block_tile"] < grid.num_tiles) & (kth < ndone[tiles])


def _plain_blocks(inst, bins, grid):
    """Phase 1: every block composited alone (entering T = 1) ->
    (colour [NB, 3, P], transmittance [NB, P])."""
    def fn(blk, tile):
        f = _block_fields(blk, grid)
        px, py = _pixel_coords(tile, grid)
        w, _, _ = _weights(f, px[:, None, :], py[:, None, :], grid)
        om = 1.0 - w
        excl = _excl_cumprod(om)
        eff = excl * w
        col = jnp.stack([jnp.sum(eff * f[6 + c], axis=1) for c in range(3)],
                        axis=1)
        return col, excl[:, -1] * om[:, -1]

    return _map_blocks(fn, inst, (_block_tiles(bins, grid),), grid)


def _plain_join(blk_col, blk_t, bins, grid, count, record: bool):
    """Phase 2: per tile, fold its first ``count[t]`` blocks in order (the
    only sequential part; vectorised over tiles), with the per-block
    accumulation rounding and — in the forward — early stop. Returns
    (out [T, 8, P], ndone [T]) and, with ``record`` (the backward, which
    passes the forward's ndone as ``count``), the carries entering every
    block: (t_in [NB, P], c_in [NB, 3, P])."""
    first, nblk = bins["tile_first_block"], count
    nt, p, nb = grid.num_tiles, grid.tile_pixels, grid.num_blocks
    eps = 0.0 if record else grid.early_stop_eps

    def cond(c):
        return c[0] < jnp.max(nblk)

    def body(c):
        k, t_run, c_run, ndone, rec = c
        active = k < nblk
        if eps > 0.0:
            active &= (k == 0) | (jnp.max(t_run, axis=1) >= eps)
        blk = jnp.where(active, first + k, nb)  # nb: out of range -> dropped
        idx = jnp.minimum(blk, nb - 1)
        if record:
            rec = (rec[0].at[blk].set(t_run, mode="drop"),
                   rec[1].at[blk].set(c_run, mode="drop"))
        a = active[:, None]
        c_new = _round_acc(c_run + t_run[:, None, :] * blk_col[idx], grid)
        t_new = _round_acc(t_run * blk_t[idx], grid)
        return (k + 1, jnp.where(a, t_new, t_run),
                jnp.where(a[..., None], c_new, c_run),
                ndone + active.astype(jnp.int32), rec)

    rec = ((jnp.ones((nb, p), jnp.float32), jnp.zeros((nb, 3, p), jnp.float32))
           if record else ())
    init = (jnp.int32(0), jnp.ones((nt, p), jnp.float32),
            jnp.zeros((nt, 3, p), jnp.float32), jnp.zeros((nt,), jnp.int32),
            rec)
    _, t_fin, c_fin, ndone, rec = lax.while_loop(cond, body, init)
    out = jnp.stack(_out_rows(c_fin[:, 0], c_fin[:, 1], c_fin[:, 2], t_fin,
                              grid), axis=1)
    return (out, ndone) + ((rec,) if record else ())


def _fwd_plain(inst, bins, grid: TileGrid):
    blk_col, blk_t = _plain_blocks(inst, bins, grid)
    return _plain_join(blk_col, blk_t, bins, grid, bins["tile_num_blocks"],
                       record=False)


def _bwd_plain(inst, bins, out, ndone, dout, grid: TileGrid):
    blk_col, blk_t = _plain_blocks(inst, bins, grid)
    _, _, (t_in, c_in) = _plain_join(blk_col, blk_t, bins, grid, ndone,
                                     record=True)
    tiles = _block_tiles(bins, grid)
    live = _replayed_blocks(bins, ndone, grid)

    def fn(blk, tile, t_in, c_in, live):
        f = _block_fields(blk, grid)
        px, py = _pixel_coords(tile, grid)
        res = out[tile].astype(jnp.float32)[:, :, None, :]  # [K, 8, 1, P]
        d = dout[tile].astype(jnp.float32)[:, :, None, :]
        cols = _block_grads(
            f, px[:, None, :], py[:, None, :], t_in[:, None, :],
            [c_in[:, i, None, :] for i in range(3)],
            [res[:, i] for i in range(3)], res[:, 4],
            [d[:, i] for i in range(3)], d[:, 3], d[:, 4], grid)
        return jnp.where(live[:, None, None], jnp.stack(cols, axis=1), 0.0)

    g = _map_blocks(fn, inst, (tiles, t_in, c_in, live), grid)  # [NB, 9, B]
    return jnp.transpose(g, (1, 0, 2)).reshape(NUM_GRAD_COLS, grid.mcap)


# ------------------------------------------------------- Triton kernels


def _num_warps(grid: TileGrid) -> int:
    return max(1, min(8, grid.tile_pixels // 32))


def _kernel_call(kernel, out_shape, grid: TileGrid, interpret: bool):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(grid.num_tiles,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_num_warps(grid), num_stages=1),
        interpret=interpret,
    )


def _fwd_kernel_body(grid, first_ref, nblk_ref, inst_ref, out_ref, ndone_ref):
    t = pl.program_id(0)
    first = first_ref[t]
    nblk = nblk_ref[t]
    px, py = _pixel_coords(t, grid)
    nf, b, eps = _num_read(grid), grid.block, grid.early_stop_eps

    def cond(c):
        go = c[0] < nblk
        if eps > 0.0:
            go &= (c[0] == 0) | (jnp.max(c[1]) >= eps)
        return go

    def block(c):
        k, t_run, cr, cg, cb = c
        base = (first + k) * b

        def splat(j, s):
            t_run, cr, cg, cb = s
            f = _decode([inst_ref[base + j, i] for i in range(nf)], grid)
            w, _, _ = _weights(f, px, py, grid)
            tw = t_run * w
            return t_run * (1.0 - w), cr + tw * f[6], cg + tw * f[7], cb + tw * f[8]

        s = lax.fori_loop(0, b, splat, (t_run, cr, cg, cb))
        return (k + 1,) + tuple(_round_acc(v, grid) for v in s)

    z = jnp.zeros_like(px)
    k, t_fin, cr, cg, cb = lax.while_loop(
        cond, block, (jnp.int32(0), z + 1.0, z, z, z))
    for i, row in enumerate(_out_rows(cr, cg, cb, t_fin, grid)):
        out_ref[t, i, :] = row
    ndone_ref[t] = k


def _bwd_kernel_body(grid, first_ref, ndone_ref, inst_ref, res_ref, dout_ref,
                     dcols_ref):
    t = pl.program_id(0)
    first = first_ref[t]
    nd = ndone_ref[t]
    px, py = _pixel_coords(t, grid)
    px, py = px[None, :], py[None, :]
    nf, b = _num_read(grid), grid.block
    cfin = [res_ref[t, i, :].astype(jnp.float32)[None, :] for i in range(3)]
    tfin = res_ref[t, 4, :].astype(jnp.float32)[None, :]
    dc = [dout_ref[t, i, :].astype(jnp.float32)[None, :] for i in range(3)]
    da = dout_ref[t, 3, :].astype(jnp.float32)[None, :]
    dt = dout_ref[t, 4, :].astype(jnp.float32)[None, :]
    row0 = (da - dt) * tfin - (dc[0] * cfin[0] + dc[1] * cfin[1]
                               + dc[2] * cfin[2])

    def block(k, c):
        t_run, cr, cg, cb = c
        base = (first + k) * b
        fv = _decode([inst_ref[pl.ds(base, b), i] for i in range(nf)], grid)
        f = [v[:, None] for v in fv]  # [B, 1]
        w, dx, dy = _weights(f, px, py, grid)
        om = 1.0 - w
        # Triton scans only add: the exclusive product of (1 - w) in log space
        lg = jnp.log(jnp.maximum(om, 1e-37))
        lsum = jnp.cumsum(lg, axis=0)
        t_before = t_run * jnp.exp(lsum - lg)
        eff = t_before * w
        cdot = f[6] * dc[0] + f[7] * dc[1] + f[8] * dc[2]
        row = row0 + dc[0] * cr + dc[1] * cg + dc[2] * cb
        incl = jnp.cumsum(eff * cdot, axis=0)
        dw = (incl + row) / jnp.maximum(om, _MIN_ONE_MINUS) + t_before * cdot
        dqh = w * dw
        gx = jnp.sum(dqh * dx, axis=1)
        gy = jnp.sum(dqh * dy, axis=1)
        qa, qb, qc = fv[2], fv[3], fv[4]
        cols = (
            -(2.0 * qa * gx + qb * gy),
            -(qb * gx + 2.0 * qc * gy),
            jnp.sum(dqh * dx * dx, axis=1),
            jnp.sum(dqh * dx * dy, axis=1),
            jnp.sum(dqh * dy * dy, axis=1),
            jnp.sum(dqh, axis=1),
            jnp.sum(eff * dc[0], axis=1),
            jnp.sum(eff * dc[1], axis=1),
            jnp.sum(eff * dc[2], axis=1),
        )
        for i in range(NUM_GRAD_COLS):
            dcols_ref[i, pl.ds(base, b)] = cols[i]
        # the carries round as the forward's do, once per block
        t_new = t_run * jnp.exp(jnp.sum(lg, axis=0, keepdims=True))
        return tuple(_round_acc(v, grid) for v in (
            t_new, cr + jnp.sum(eff * f[6], axis=0, keepdims=True),
            cg + jnp.sum(eff * f[7], axis=0, keepdims=True),
            cb + jnp.sum(eff * f[8], axis=0, keepdims=True)))

    z = jnp.zeros_like(px)
    lax.fori_loop(0, nd, block, (z + 1.0, z, z, z))


def _fwd_kernel(inst, bins, grid: TileGrid, interpret: bool = False):
    p = grid.tile_pixels
    return _kernel_call(
        functools.partial(_fwd_kernel_body, grid),
        (jax.ShapeDtypeStruct((grid.num_tiles, OUT_ROWS, p), _acc_dtype(grid)),
         jax.ShapeDtypeStruct((grid.num_tiles,), jnp.int32)),
        grid, interpret,
    )(bins["tile_first_block"], bins["tile_num_blocks"], inst)


def _bwd_kernel(inst, bins, out, ndone, dout, grid: TileGrid,
                interpret: bool = False):
    d = _kernel_call(
        functools.partial(_bwd_kernel_body, grid),
        jax.ShapeDtypeStruct((NUM_GRAD_COLS, grid.mcap), jnp.float32),
        grid, interpret,
    )(bins["tile_first_block"], ndone, inst, out, dout)
    # the kernel writes only the slots it replays; the rest of its output
    # is uninitialized device memory
    live = jnp.repeat(_replayed_blocks(bins, ndone, grid), grid.block)
    return jnp.where(live[None, :], d, 0.0)


# ------------------------------------------------------------- dispatch


def composite_impl() -> str:
    """Which implementation runs: the kernel on the GPU, the plain version
    on the CPU; other platforms raise. (Tests patch this to drive the
    kernels through the whole render in interpret mode on the CPU.)"""
    platform = jax.default_backend()
    if platform not in ("gpu", "cpu"):
        raise NotImplementedError(
            f"the tiled composite runs on 'gpu' or 'cpu', not {platform!r}")
    return "kernel" if platform == "gpu" else "plain"


def _composite_fwd(inst, bins, grid):
    if composite_impl() == "kernel":
        return _fwd_kernel(inst, bins, grid,
                           interpret=jax.default_backend() == "cpu")
    return _fwd_plain(inst, bins, grid)


def _composite_bwd(inst, bins, out, ndone, dout, grid):
    if composite_impl() == "kernel":
        return _bwd_kernel(inst, bins, out, ndone, dout, grid,
                           interpret=jax.default_backend() == "cpu")
    return _bwd_plain(inst, bins, out, ndone, dout, grid)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def composite_from_feats(feats, bins, grid: TileGrid):
    """Tile-binned composite from per-splat features -> per-tile [T, 8, P].

    feats is [N + 1, 16] (last row = null splat); ``bins`` is the dict from
    ops.binning.bin_splats. Differentiable in feats via the hand-written
    transmittance-replay backward PLUS a sort transpose: per-instance
    gradients ride a sort keyed on the splat index (each splat's instances
    become contiguous) and are segment-reduced with one cumsum — instead of
    the scatter-add XLA would emit for the instance gather's VJP.

    With grid.packed_colors / packed_feats16 the gather reads 8- or 4-column
    int32 rows; the VJP still returns [N + 1, 16] f32 gradients
    (straight-through past the quantization).
    """
    inst = jnp.take(_pack_src(feats, grid), bins["inst_splat"], axis=0)
    return _composite_fwd(inst, bins, grid)[0]


def _cff_fwd(feats, bins, grid):
    if grid.forward_only:
        raise ValueError(
            "composite_from_feats cannot be differentiated with "
            "forward_only=True: the viewer contract declares no backward. "
            "Render with forward_only=False to train."
        )
    inst = jnp.take(_pack_src(feats, grid), bins["inst_splat"], axis=0)
    out, ndone = _composite_fwd(inst, bins, grid)
    # the gathered instance rows are saved rather than regathered
    return out, (inst, bins, out, ndone)


def _blocked_cumsum(x, block: int = 512):
    """Inclusive cumsum along axis 0 as two-level blocked prefix sums
    (block-local cumsums plus a small cross-block prefix)."""
    m = x.shape[0]
    if m % block != 0 or m <= block:
        return jnp.cumsum(x, axis=0)
    xb = x.reshape(m // block, block, *x.shape[1:])
    local = jnp.cumsum(xb, axis=1)
    carry = jnp.cumsum(local[:, -1], axis=0) - local[:, -1]  # excl block prefix
    return (local + carry[:, None]).reshape(x.shape)


def _pack_bf16_pairs(cols):
    """Pack pairs of f32 columns as (bf16 << 16 | bf16) int32 columns."""
    out = []
    for i in range(0, len(cols), 2):
        hi = lax.bitcast_convert_type(cols[i].astype(jnp.bfloat16), jnp.uint16)
        hi = hi.astype(jnp.uint32) << 16
        if i + 1 < len(cols):
            lo = lax.bitcast_convert_type(cols[i + 1].astype(jnp.bfloat16), jnp.uint16)
            hi = hi | lo.astype(jnp.uint32)
        out.append(lax.bitcast_convert_type(hi, jnp.int32))
    return out


def _unpack_bf16_pairs(packed, n_cols):
    """Inverse of _pack_bf16_pairs -> list of f32 columns."""
    cols = []
    for i, p in enumerate(packed):
        u = lax.bitcast_convert_type(p, jnp.uint32)
        hi = lax.bitcast_convert_type((u >> 16).astype(jnp.uint16), jnp.bfloat16)
        cols.append(hi.astype(jnp.float32))
        if 2 * i + 1 < n_cols:
            lo = lax.bitcast_convert_type(u.astype(jnp.uint16), jnp.bfloat16)
            cols.append(lo.astype(jnp.float32))
    return cols


def _cff_bwd(grid, residuals, dout):
    inst, bins, out, ndone = residuals
    d_inst = _composite_bwd(inst, bins, out, ndone, dout, grid)
    # sort transpose: tile-sorted grads -> SPLAT-GROUPED order -> per-splat
    # sums. The sort key is inst_splat itself: ascending splat ids group each
    # splat's instances into exactly the contiguous range [seg_offs_i,
    # seg_offs_i + seg_cnt_i) — the same segments the enumeration order had,
    # because seg_offs is the exclusive cumsum of seg_cnt in splat order —
    # and a segment SUM does not care about the within-segment order.
    # Pad/sentinel slots carry s = N and sort past every real instance; their
    # gradient slots are zero.
    key = bins["inst_splat"]
    if grid.grad_sort_dtype == "bfloat16":
        # pairs of bf16 gradient columns ride one int32 payload each (5
        # operands instead of 9). Only the PER-INSTANCE values round to
        # bf16; the per-splat segment sums below stay f32.
        packed = _pack_bf16_pairs([d_inst[i] for i in range(NUM_GRAD_COLS)])
        sorted_p = lax.sort((key,) + tuple(packed), num_keys=1)
        sorted_cols = (sorted_p[0],) + tuple(
            _unpack_bf16_pairs(sorted_p[1:], NUM_GRAD_COLS)
        )
    else:
        sorted_cols = lax.sort(
            (key,) + tuple(d_inst[i] for i in range(NUM_GRAD_COLS)),
            num_keys=1,
        )
    # per-splat segment sums over the splat-grouped ranges. Segments are
    # CONTIGUOUS (offs is an exact exclusive cumsum of cnt, dropped splats
    # have cnt == 0), so start_i == end_{i-1} and one prefix gather + a
    # first-difference replaces two gathers.
    cs = _blocked_cumsum(jnp.stack([c[: grid.emax] for c in sorted_cols[1:]],
                                   axis=1))  # [emax, 9]
    end = jnp.minimum(bins["seg_offs"] + bins["seg_cnt"], grid.emax)
    at = jnp.clip(end - 1, 0, grid.emax - 1)
    g = jnp.where((end > 0)[:, None], jnp.take(cs, at, axis=0), 0.0)
    d_rows = jnp.diff(g, axis=0, prepend=jnp.zeros((1, NUM_GRAD_COLS), g.dtype))
    d_feats = jnp.concatenate(
        [d_rows, jnp.zeros((d_rows.shape[0], NUM_FEATS - NUM_GRAD_COLS),
                           d_rows.dtype)], axis=1
    )
    d_feats = jnp.concatenate([d_feats, jnp.zeros((1, NUM_FEATS), d_feats.dtype)], axis=0)
    return d_feats, None


composite_from_feats.defvjp(_cff_fwd, _cff_bwd)
