"""Tile binning: splat -> (tile, depth)-ordered instance lists, all static shapes.

This replaces the reference's per-frame GPU sort machinery — the presort
compaction with an atomic counter (ref: shader/presort_compute.glsl:50-55) and
the full 32-bit radix sort of every visible splat (ref: src/splatrenderer.cpp:
153-312, shader/multi_radixsort*.glsl) — with an XLA formulation:

1. Depth ordering happens *inside* the one binning sort: per-instance view
   depth rides as a second sort key (full f32, no quantization — the reference
   quantizes depth into its 32-bit radix keys and saw artifacts at 24 bits,
   ref: src/splatrenderer.cpp:165-169), with descending splat index as the
   tie-break (the reference's stable back-to-front draw order implies
   higher-index-in-front under equal depth, ref: shader/presort_compute.glsl:
   52-53). One multi-key sort replaces globally depth-sorting the splats and
   permuting every per-splat column before binning (legacy mode:
   ``depth=None`` assumes the caller pre-sorted front-to-back and groups by
   tile id alone).
2. Dynamic instance counts are handled with a static-size instance buffer:
   enumeration slots map back to (splat, tile-within-rect) pairs via a
   scatter-at-segment-starts + cummax forward fill. No atomics, no
   data-dependent shapes, no host readback (the reference stalls the pipe
   every frame reading its counter, src/splatrenderer.cpp:196-204).
3. Block alignment happens *inside the sort*: exact per-tile padding entries
   (counted by one bincount-by-sort over the enumerated tile ids) are
   appended before the tile sort, so every
   tile's segment in the sorted order starts at a multiple of the compositing
   block size B and is filled to a multiple of B with *null instances*
   (splat index N -> an all-zero feature row). The sorted order IS the
   instance buffer: no scatter ever materializes it. Tile t owns the
   ceil(count_t / B) blocks from the exclusive cumsum of those counts.

Overflow: if the enumeration capacity ``emax`` is exceeded, whole FARTHEST
splats are dropped — by the depth key when one is given, by input order
(which is depth order for pre-sorted callers) otherwise — so the sorted
structure stays exact; the dropped instance count is reported, never silent.
"""

from __future__ import annotations

import dataclasses
import functools
import logging

import jax.numpy as jnp
from jax import lax

_log = logging.getLogger("splatapult_jax")


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Static geometry of the tiled pipeline (hashable; jit-static)."""

    width: int  # true image width in px
    height: int
    tile_size: int  # TS, pixels per tile side
    block: int  # B, instances per composite block (power of two)
    emax: int  # raw instance enumeration capacity
    mcap: int  # aligned instance buffer capacity (multiple of block)
    alpha_cutoff: float = 1.0 / 256.0
    early_stop_eps: float = 0.0
    # accumulation dtype for the composite output rows ("float32"/"bfloat16"),
    # the reference's --fp32/--fp16 offscreen-FBO knob (ref: src/app.cpp:
    # 1000-1035); per-block math stays f32 either way
    accum_dtype: str = "float32"
    # dtype the PER-INSTANCE gradient columns ride through the backward's
    # transpose sort ("float32"/"bfloat16"). The sort is byte-bound, so bf16
    # halves its payload traffic; per-splat sums still accumulate in f32
    grad_sort_dtype: str = "float32"
    # pack splat RGB as 16-bit fixed point (step 2^-12, range +-8) so feature
    # rows shrink from 64 B to 32 B. Geometry/opacity stay exact f32; max
    # per-splat color error 1.2e-4 (the reference's own --fp16 FBO stores the
    # whole accumulated frame at half precision, far coarser)
    packed_colors: bool = False
    # forward-only rendering (the reference's actual mode — it has no backward
    # at all, SURVEY.md "What the reference is"). The binning
    # carries NO backward-only payload either way (the backward transpose
    # re-keys on inst_splat, see ops/composite._cff_bwd), so this flag is a
    # pure contract marker: differentiating a forward_only composite raises.
    forward_only: bool = False
    # depth precision inside the instance sort key: 32 = full f32 depth bits
    # as a separate key (exact ordering); 20 = the top 20 f32 bits (8 exponent
    # + 12 explicit mantissa bits, relative step ~2.4e-4) PACKED with the tile
    # id into ONE
    # int32 key — one sort operand and one comparison key fewer, at scene-
    # scale image diffs ~30x smaller than depth_bits=16's (bf16 depth gave
    # mean ~2-4e-3 / p99.9 ~0.12 abs image diff on the production scenes,
    # echoing the reference's own 24-bit-key revert,
    # src/splatrenderer.cpp:165-169);
    # 16 = bf16 depth, kept as an opt-in A/B point. For reference scale:
    # the reference ships a 32-bit LINEAR [0, far] radix key
    # (shader/presort_compute.glsl:52-53) whose RELATIVE step at depth d is
    # 2.3e-7*far/d — coarser than depth20 for anything nearer than ~far/500,
    # finer beyond (where splats are subpixel anyway). depth20 requires
    # num_tiles < 2^11 (a 1080p tile32 grid = 2040 qualifies; the sentinel
    # key num_tiles << 20 | 0xFFFFF must fit int32), 16 requires
    # < 2^15; both fall back to 32 otherwise. Ties order by the descending-
    # index tie-break (the reference's submission-order semantics).
    depth_bits: int = 32
    # quantize the WHOLE instance feature row into 4 int32 = 16 B (16-bit
    # fixed means, f16 conic + ln-alpha, 11/11/10-bit colors) so a 5M-splat
    # table stays inside the fast gather regime; coarser than packed_colors
    # — see ops/composite.NUM_FEATS_PACKED16 for the layout and error bounds
    packed_feats16: bool = False
    # INTERLEAVED multi-chip tile-row ownership: with row_stride S > 1 the
    # grid still describes the FULL image (tile ids, pixel coords, sort-key
    # packing are all full-grid), but binning enumerates only the tile rows
    # r with r % S == row_offset (bin_splats' row_offset argument — a traced
    # per-chip value, lax.axis_index). Adjacent tile rows have similar
    # instance density, so striding balances per-chip demand where
    # contiguous bands concentrate it (peak/mean demand up to 2.7 at D=8
    # on the garden stand-in); every (splat, tile)
    # instance still lands on exactly one chip. mcap sizes the alignment
    # pad to the OWNED tile count (num_tiles / S).
    row_stride: int = 1

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_size)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_size)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def num_blocks(self) -> int:  # NB: length of the flat block work-list
        return self.mcap // self.block

    @property
    def tile_pixels(self) -> int:
        return self.tile_size * self.tile_size

    @staticmethod
    def create(width, height, num_splats, tile_size=16, block=16,
               max_instance_mult=6, alpha_cutoff=1.0 / 256.0, early_stop_eps=0.0,
               accum_dtype="float32", grad_sort_dtype="float32",
               packed_colors=False, forward_only=False, depth_bits=32,
               packed_feats16=False, row_stride=1):
        assert block & (block - 1) == 0, "block must be a power of two"
        assert accum_dtype in ("float32", "bfloat16"), accum_dtype
        assert grad_sort_dtype in ("float32", "bfloat16"), grad_sort_dtype
        assert depth_bits in (16, 20, 32), depth_bits
        emax = max(4096, -(-int(max_instance_mult * max(num_splats, 1)) // 4096) * 4096)
        tiles_y = -(-height // tile_size)
        assert tiles_y % row_stride == 0, (
            f"tiles_y={tiles_y} must divide by row_stride={row_stride} "
            f"(pad the image height)")
        tiles = (-(-width // tile_size)) * tiles_y
        # worst-case alignment padding: < block per OWNED tile
        mcap = emax + (tiles // row_stride) * block
        return TileGrid(
            width=width, height=height, tile_size=tile_size, block=block,
            emax=emax, mcap=mcap, alpha_cutoff=alpha_cutoff,
            early_stop_eps=early_stop_eps, accum_dtype=accum_dtype,
            grad_sort_dtype=grad_sort_dtype, packed_colors=packed_colors,
            forward_only=forward_only, depth_bits=depth_bits,
            packed_feats16=packed_feats16, row_stride=row_stride,
        )


def _expand_slots(offs, kept, x0, r0, nx, grid: TileGrid, n: int):
    """Enumeration slot m -> (tile id, splat id) for m < total.

    Forward fill: each kept splat's id is scattered at its segment start and
    a running max (cummax) carries it over the segment; the splat's rect
    (one [N, 4] row gather) then names the slot's tile."""
    emax = grid.emax
    tx_n = grid.tiles_x
    row_step = tx_n * grid.row_stride
    m = jnp.arange(emax, dtype=jnp.int32)
    first_slot = jnp.where(kept, offs, emax)  # emax = dropped
    marks = jnp.full((emax,), -1, jnp.int32).at[first_slot].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop", unique_indices=True
    )
    s = jnp.clip(lax.cummax(marks, axis=0), 0, max(n - 1, 0)).astype(jnp.int32)
    table = jnp.stack([offs, x0, r0, jnp.maximum(nx, 1)], axis=1)  # [N, 4]
    g = jnp.take(table, s, axis=0)  # [emax, 4]
    j = m - g[:, 0]
    tile = (g[:, 2] * tx_n + g[:, 1]) + (j // g[:, 3]) * row_step + j % g[:, 3]
    return tile, s


def sort_key_mode(grid: TileGrid) -> str:
    """The instance-sort key mode this grid ACTUALLY uses (a static property):
    "packed20" / "packed16" when the requested packed depth key fits the tile
    count, "exact32" otherwise (the silent-downgrade cases are logged by
    bin_splats and surfaced by diagnostics.render_stats; the reference prints its sort-path choice at init,
    src/splatrenderer.cpp:86-103)."""
    if grid.depth_bits == 20 and grid.num_tiles < (1 << 11):
        return "packed20"
    if grid.depth_bits == 16 and grid.num_tiles < (1 << 15):
        return "packed16"
    return "exact32"


def _bincount_by_sort(ids, num_bins: int):
    """Exact bincount of int ids in [0, num_bins] via sort + searchsorted.

    An unstable 1-key sort plus a tiny searchsorted (num_bins queries over
    the sorted array) instead of a scatter-add with colliding indices.
    Values equal to ``num_bins`` act as an ignored overflow/sentinel bucket.
    """
    sorted_ids = lax.sort(ids, is_stable=False)
    edges = jnp.searchsorted(sorted_ids, jnp.arange(num_bins + 1, dtype=jnp.int32))
    return edges[1:] - edges[:-1]


def _tile_rects(mean2d, extent, grid: TileGrid, row_offset=None):
    """Per-splat covered tile rectangles -> (x0, r0, nx, ny, cnt).

    The AABB-vs-tile-grid overlap that replaces the reference's geometry-
    shader quad coverage (ref: shader/splat_geom.glsl:83-106): column range
    [x0, x0+nx), row range [r0, r0+ny), cnt = nx*ny (0 = culled).

    With grid.row_stride = S > 1, only tile rows r with r % S == row_offset
    (this chip's ownership; a traced scalar) count: ny becomes the OWNED row
    count inside the rect, r0 the first owned full-grid row, and the rect's
    j-th tile is tile0 + (j // nx) * (S * tiles_x) + j % nx (the row step
    every consumer applies via grid.row_stride)."""
    ts, tx_n, ty_n, h = grid.tile_size, grid.tiles_x, grid.tiles_y, grid.height
    mx, my = mean2d[:, 0], mean2d[:, 1]
    extent = jnp.asarray(extent)
    if extent.ndim == 1:
        rx = ry = extent
    else:
        rx, ry = extent[:, 0], extent[:, 1]
    valid = (rx > 0.0) & (ry > 0.0)
    x0 = jnp.clip(jnp.floor((mx - rx) / ts), 0, tx_n).astype(jnp.int32)
    x1 = jnp.clip(jnp.ceil((mx + rx) / ts), 0, tx_n).astype(jnp.int32)
    # gl y-up -> image rows: row = height - y
    r0 = jnp.clip(jnp.floor((h - my - ry) / ts), 0, ty_n).astype(jnp.int32)
    r1 = jnp.clip(jnp.ceil((h - my + ry) / ts), 0, ty_n).astype(jnp.int32)
    nx = jnp.maximum(x1 - x0, 0)
    s = grid.row_stride
    if s > 1:
        assert row_offset is not None, "row_stride > 1 needs a row_offset"
        d = jnp.asarray(row_offset, jnp.int32)
        ty_owned = ty_n // s
        # owned rows are r = d + k*s; the rect [r0, r1) covers owned indices
        # [ceil((r0-d)/s), ceil((r1-d)/s)). r0 - d >= -(s-1), so the +s-1
        # floor-div form never sees a negative numerator.
        k0 = jnp.clip((r0 - d + s - 1) // s, 0, ty_owned)
        k1 = jnp.clip((r1 - d + s - 1) // s, 0, ty_owned)
        ny = jnp.maximum(k1 - k0, 0)
        r0 = d + k0 * s  # first OWNED full-grid row
    else:
        ny = jnp.maximum(r1 - r0, 0)
    cnt = jnp.where(valid, nx * ny, 0).astype(jnp.int32)
    return x0, r0, nx, ny, cnt


def instance_demand(mean2d, extent, grid: TileGrid, row_offset=None):
    """Total tile-instance count this view would enumerate -> scalar int32.

    The cheap pre-pass behind capacity auto-tuning: measure the demand once,
    then size ``max_instance_mult`` with a small headroom instead of paying
    for worst-case capacity in every sort/gather/kernel of every step (the
    analog of the reference's radix-workgroup auto-tuner,
    ref: src/app.cpp:843-874). With grid.row_stride > 1, the demand of the
    ``row_offset`` chip's interleaved tile rows."""
    _, _, _, _, cnt = _tile_rects(mean2d, extent, grid, row_offset=row_offset)
    return jnp.sum(cnt)  # int32: fine to ~2.1e9 instances


def bin_splats(mean2d, extent, grid: TileGrid, depth=None, row_offset=None):
    """Build the (tile, depth)-ordered instance buffer and flat block work-list.

    Args (all non-differentiable index plumbing; callers stop_gradient):
      mean2d [N, 2] screen centers (gl convention, +y up); front-to-back order
        REQUIRED iff ``depth`` is None
      extent [N, 2] tight AABB half-extents (rx, ry) in px, or [N] isotropic
        radius (both 0 = culled)
      depth [N] view depth per splat (any splat order): rides the tile sort as
        a second key so callers need not pre-sort; ties break by descending
        splat index (reference parity, see module docstring)

    Returns dict:
      inst_splat [mcap] int32 — splat index per aligned instance slot (N = null)
      seg_offs/seg_cnt [N] — per-splat enumeration segments (for the backward
        transpose in ops/composite.py: grads sorted by inst_splat group each
        splat's instances into exactly [seg_offs, seg_offs + seg_cnt))
      block_tile [NB] int32 — owning tile of each B-block (num_tiles for
        the unused blocks past the last tile's)
      tile_first_block/tile_num_blocks [T] int32 — tile t owns blocks
        [first, first + num): num = ceil(count / B), first its exclusive cumsum
      tile_ok [T] bool — tile has at least one instance
      tile_count [T] int32 — true instance count per tile
      num_culled_instances [] int32 — instances dropped by capacity overflow

    With grid.row_stride = S > 1, ``row_offset`` (traced, this chip's
    lax.axis_index) selects the owned tile rows r % S == row_offset; tile
    ids stay FULL-grid (the composite kernels' pixel-coordinate mapping is
    unchanged) and only owned tiles get alignment padding.
    """
    n = mean2d.shape[0]
    ts, tx_n, ty_n = grid.tile_size, grid.tiles_x, grid.tiles_y
    num_tiles, b, emax, mcap = grid.num_tiles, grid.block, grid.emax, grid.mcap
    h = grid.height
    stride = grid.row_stride
    row_step = tx_n * stride  # tile-id step between a rect's owned rows
    owned_tiles = num_tiles // stride
    pad_cap = owned_tiles * b
    assert mcap == emax + pad_cap, (mcap, emax, pad_cap)
    if stride > 1:
        assert row_offset is not None, "row_stride > 1 needs a row_offset"
    d_off = jnp.asarray(row_offset if row_offset is not None else 0, jnp.int32)

    x0, r0, nx, ny, cnt_raw = _tile_rects(mean2d, extent, grid,
                                          row_offset=row_offset)

    # overflow: drop WHOLE splats past the capacity so every kept splat's rect
    # stays complete and the histogram/padding stay exact. With depth given,
    # drop the FARTHEST splats (the least visible — matching what input-order
    # truncation does for pre-sorted callers); the depth-threshold search runs
    # only when an overflow actually occurs (lax.cond).
    offs_raw = jnp.cumsum(cnt_raw) - cnt_raw
    total_raw = offs_raw[-1] + cnt_raw[-1] if n > 0 else jnp.int32(0)
    if depth is None or n == 0:
        keep = offs_raw + cnt_raw <= emax
    else:
        depth_f = jnp.asarray(depth, jnp.float32)

        def _drop_farthest(_):
            d_sorted, c_sorted = lax.sort((depth_f, cnt_raw), num_keys=1)
            cum = jnp.cumsum(c_sorted)
            # last depth-sorted index whose cumulative instance count fits
            k = jnp.searchsorted(cum, jnp.int32(emax), side="right")
            thr = jnp.where(
                k > 0, d_sorted[jnp.clip(k - 1, 0, n - 1)], -jnp.inf
            )
            keep_lt = depth_f < thr  # total of these is <= cum[k-1] <= emax
            used = jnp.sum(jnp.where(keep_lt, cnt_raw, 0))
            # splats exactly at the threshold depth: admit greedily in input
            # order while capacity remains (exact under depth ties)
            at_thr = depth_f == thr
            c_at = jnp.where(at_thr, cnt_raw, 0)
            fits = used + jnp.cumsum(c_at) <= emax
            return keep_lt | (at_thr & fits)

        keep = lax.cond(
            total_raw > emax,
            _drop_farthest,
            lambda _: jnp.ones((n,), bool),
            operand=None,
        )
    cnt = jnp.where(keep, cnt_raw, 0)
    offs = jnp.cumsum(cnt) - cnt  # exclusive
    total = offs[-1] + cnt[-1] if n > 0 else jnp.int32(0)
    overflow = (cnt_raw.sum() - total).astype(jnp.int32)
    kept = keep & (cnt > 0)

    # ---- enumeration slots -> (splat, tile-within-rect) ----
    m = jnp.arange(emax, dtype=jnp.int32)
    valid_m = m < total
    tile, s = _expand_slots(offs, kept, x0, r0, nx, grid, n)
    tile = jnp.where(valid_m, tile, num_tiles)  # sentinel sorts to the end
    s = jnp.where(valid_m, s, n)

    # exact per-tile counts (truncation-aware) -> exact alignment padding.
    # Bincount of the enumerated tile ids by sort (the sentinel bucket is
    # dropped); replaces a corner-delta rect histogram whose two 2N-id sorts
    # cost ~4x this one emax sort.
    tile_count = _bincount_by_sort(tile, num_tiles)

    # ---- alignment padding entries, exact per OWNED tile ----
    # [T_owned, b] candidates; column < pad_t are real pads of that tile
    if stride == 1:
        pad_t = (-tile_count) % b  # in [0, b)
        pad_col = lax.broadcasted_iota(jnp.int32, (num_tiles, b), 1)
        pad_tile_grid = lax.broadcasted_iota(jnp.int32, (num_tiles, b), 0)
    else:
        # owned tile index i -> full-grid tile id (row i//tx * S + d) * tx + col
        cnt_owned = lax.dynamic_index_in_dim(
            tile_count.reshape(ty_n // stride, stride, tx_n), d_off, axis=1,
            keepdims=False,
        ).reshape(-1)  # [owned_tiles], row-major over owned rows
        pad_t = (-cnt_owned) % b
        pad_col = lax.broadcasted_iota(jnp.int32, (owned_tiles, b), 1)
        oidx = lax.broadcasted_iota(jnp.int32, (owned_tiles, b), 0)
        pad_tile_grid = ((oidx // tx_n) * stride + d_off) * tx_n + oidx % tx_n
    pad_tile = jnp.where(pad_col < pad_t[:, None], pad_tile_grid, num_tiles).reshape(-1)

    # ---- ONE sort by tile (+ depth): pads land at each tile's end (+inf
    # depth / after all real entries in input order); sentinels land at the
    # very end. Every tile segment is now exactly ceil(count/b)*b long, so
    # segment starts are b-aligned and the sorted order IS the block-aligned
    # instance buffer.
    tile_all = jnp.concatenate([tile, pad_tile])
    s_all = jnp.concatenate([s, jnp.full((pad_cap,), n, jnp.int32)])
    if depth is not None:
        # per-instance depth + descending-splat-index tie-break as extra sort
        # keys; -s doubles as the inst_splat payload (keys are fully unique —
        # one instance per (splat, tile) — so the sort may be unstable).
        # Depth keys are the f32 BITS as int32 (monotone for non-negative
        # floats): full precision, one per-slot gather.
        imax = jnp.int32(2**31 - 1)
        depth_bits = lax.bitcast_convert_type(
            jnp.maximum(jnp.asarray(depth, jnp.float32), 0.0), jnp.int32
        )
        dep_enum = jnp.take(
            jnp.concatenate([depth_bits, jnp.full((1,), imax, jnp.int32)]), s
        )
        # STRICT < gates (sort_key_mode): the sentinel/pad key is
        # (num_tiles << bits) | mask, which must stay <= INT32_MAX — at
        # exactly 2048 tiles the 20-bit sentinel would wrap the int32 sign
        # bit and sort BEFORE every real instance (silent corruption).
        # packed20: (tile << 20 | top-20 f32 depth bits): 31-bit key with
        # 12 explicit mantissa bits of depth (relative step ~2.4e-4); real
        # depth codes are <= 0x7F800000 >> 11 = 0xFF000 < 0xFFFFF, so the
        # pad/sentinel code sorts strictly after every real instance.
        # packed16: (tile << 16 | bf16 depth), the opt-in A/B point.
        mode = sort_key_mode(grid)
        packed_bits = {"packed20": 20, "packed16": 16, "exact32": 0}[mode]
        if grid.depth_bits != 32 and packed_bits == 0:
            # a requested production default silently downgrading would
            # otherwise be invisible; trace-time notice,
            # once per compiled config
            _log.warning(
                "depth_bits=%d requested but num_tiles=%d exceeds the "
                "packed-key budget (%s); using the exact 3-operand sort",
                grid.depth_bits, num_tiles,
                "< 2048" if grid.depth_bits == 20 else "< 32768")
        if packed_bits:
            b_ = packed_bits
            # 16: bits [31:16] (the bf16 depth);
            # 20: bits [30:11] (sign bit is always 0 for nonneg depths)
            shift = 16 if b_ == 16 else 11
            sentd = (1 << b_) - 1
            key = (tile << b_) | jnp.where(
                valid_m, (dep_enum >> shift) & sentd, sentd
            )
            key_all = jnp.concatenate([key, (pad_tile << b_) | sentd])
            res = lax.sort((key_all, -s_all), num_keys=2, is_stable=False)
            tile_sorted, inst_splat = res[0] >> b_, -res[1]
        else:
            dep_all = jnp.concatenate(
                [jnp.where(valid_m, dep_enum, imax),
                 jnp.full((pad_cap,), imax, jnp.int32)]
            )
            res = lax.sort((tile_all, dep_all, -s_all), num_keys=3,
                           is_stable=False)
            tile_sorted, inst_splat = res[0], -res[2]
    else:
        # input pre-sorted front-to-back: enum order is depth order; a stable
        # tile sort preserves it
        res = lax.sort((tile_all, s_all), num_keys=1, is_stable=True)
        tile_sorted, inst_splat = res[0], res[1]

    # ---- per-tile block ranges: tile t owns blocks [first, first + num) ----
    tile_num_blocks = (tile_count + (b - 1)) // b
    bins = {
        "inst_splat": inst_splat,
        "seg_offs": offs,
        "seg_cnt": cnt,
        # owning tile of each block (num_tiles past the last tile's blocks)
        "block_tile": tile_sorted[::b],
        "tile_first_block": jnp.cumsum(tile_num_blocks) - tile_num_blocks,
        "tile_num_blocks": tile_num_blocks,
        "tile_ok": tile_count > 0,
        "tile_count": tile_count,
        "num_culled_instances": overflow,
    }
    return bins
