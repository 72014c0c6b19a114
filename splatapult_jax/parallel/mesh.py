"""Multi-chip SPMD: tile/view sharding over a jax.sharding.Mesh.

The reference is strictly single-process, single-GPU (SURVEY.md section 2.3);
everything here is new design required by the BASELINE north star:

- **Tile parallelism** (the data-parallel axis of this domain): the image's
  tile *rows* are sharded across the ``tiles`` mesh axis. Each chip runs the
  identical jitted pipeline on its horizontal band — projection/SH are
  computed replicated (cheap, O(N)); binning, the in-sort depth ordering and
  compositing touch only the chip's own band (the dominant cost,
  O(instances * pixels)).
- **View parallelism**: camera batches shard over a ``views`` axis
  (the scaled-up analog of the reference's stereo pair, src/app.cpp:603-607).
- **Gradients**: parameter gradients are partial per shard and completed by an
  explicit psum AFTER per-shard differentiation (_sharded_value_and_grad); XLA
  schedules those collectives asynchronously against the remaining backward
  compute.

Everything works identically on real devices and on the CPU host platform
with ``--xla_force_host_platform_device_count=N`` (how tests and
``__graft_entry__.dryrun_multichip`` exercise it).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from splatapult_jax.render import Camera, RenderConfig, prepare_splats


def make_render_mesh(num_tile_shards: Optional[int] = None, num_view_shards: int = 1,
                     devices=None) -> Mesh:
    """Mesh with ('views', 'tiles') axes over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if num_tile_shards is None:
        num_tile_shards = len(devices) // num_view_shards
    n = num_view_shards * num_tile_shards
    assert n <= len(devices), (n, len(devices))
    import numpy as np

    dev_array = np.asarray(devices[:n]).reshape(num_view_shards, num_tile_shards)
    return Mesh(dev_array, ("views", "tiles"))


def _padded_height(config: RenderConfig, num_shards: int) -> int:
    """Image height padded so tile rows divide evenly across shards."""
    band = config.tile_size * num_shards
    return -(-config.height // band) * band


def _shard_config(config: RenderConfig, num_shards: int) -> RenderConfig:
    # sort_bands is a SINGLE-chip sort-cliff lever; the sharded band pipelines
    # already run at ~1/D capacity, so nested banding is disabled here
    return dataclasses.replace(
        config, height=_padded_height(config, num_shards) // num_shards,
        sort_bands=1)


def _pad_scene(scene, n_pad: int):
    """Pad every per-splat scene leaf to ``n_pad`` rows with INERT values:
    identity quats (a zero quat would hit the normalize divide), -20 logit
    opacity (alpha ~ 2e-9). Padded rows therefore project to finite values —
    no NaN can leak through the backward's slice transpose — and are sliced
    away after the all-gather anyway."""
    n = scene.means.shape[0]
    extra = n_pad - n
    if extra == 0:
        return scene

    def pad0(x):
        return jnp.pad(x, [(0, extra)] + [(0, 0)] * (x.ndim - 1))

    quat_pad = jnp.zeros((extra, 4), scene.quats.dtype).at[:, 0].set(1.0)
    return dataclasses.replace(
        scene,
        means=pad0(scene.means),
        sh=pad0(scene.sh),
        opacities=jnp.concatenate(
            [scene.opacities, jnp.full((extra,), -20.0, scene.opacities.dtype)]
        ),
        log_scales=pad0(scene.log_scales),
        quats=jnp.concatenate([scene.quats, quat_pad]),
    )


def prepare_splats_sharded(scene, camera: Camera, config: RenderConfig,
                           axis_name: str = "tiles"):
    """prepare_splats with the O(N) projection/SH work sharded over a mesh axis.

    Each chip bakes/projects/SH-evaluates its own N/D splat slice; the ~14
    per-splat output floats are then all-gathered so every chip can bin its
    own image band over the full splat set. This replaces the REPLICATED
    O(N) prepare: per-chip prepare compute drops to O(N/D) for a 56 B/splat
    all-gather (~the cost of one feature-row pass, far under the
    SH+projection FLOPs it saves).

    prepare_splats is elementwise per splat, so the reassembled columns are
    BIT-IDENTICAL to the replicated computation. Gradients: the all_gather
    transposes to a psum-scatter and the slice to a zero-padded scatter, so
    each chip's d_scene is nonzero only on its own slice — the existing
    cross-chip grad psum completes it (sums of disjoint slices == the
    replicated gradient).
    """
    d = lax.axis_index(axis_name)
    nd = lax.psum(1, axis_name)  # static axis size
    if nd == 1:
        return prepare_splats(scene, camera, config, sort=False)
    n = scene.means.shape[0]
    chunk = -(-n // nd)
    padded = _pad_scene(scene, chunk * nd)
    local = jax.tree.map(
        lambda x: lax.dynamic_slice_in_dim(x, d * chunk, chunk, axis=0), padded
    )
    sp = prepare_splats(local, camera, config, sort=False)
    return jax.tree.map(
        lambda x: lax.all_gather(x, axis_name, axis=0, tiled=True)[:n], sp
    )


def _composite_band(sorted_splats, shard_index, num_shards, config: RenderConfig):
    """Composite this chip's horizontal band of the image.

    The band becomes a standalone image of height H/num_shards by shifting the
    splats' screen-space y so the band's bottom edge is y = 0; binning and the
    Pallas kernels run unchanged.
    """
    from splatapult_jax.ops.tiled import composite_tiled

    cfg_band = _shard_config(config, num_shards)
    h_pad = _padded_height(config, num_shards)
    band_h = cfg_band.height
    # band d covers image rows [d*band_h, (d+1)*band_h) from the top; in gl
    # (+y up) coordinates its bottom edge sits at h_pad - (d+1)*band_h... but
    # mean2d was produced against the *true* height, so shift relative to that.
    y_bottom = config.height - (shard_index + 1) * band_h
    shifted = dict(sorted_splats)
    shifted["mean2d"] = sorted_splats["mean2d"] - jnp.stack(
        [jnp.zeros_like(y_bottom, dtype=jnp.float32), y_bottom.astype(jnp.float32)]
    )
    return composite_tiled(shifted, cfg_band)  # [band_h, W, 4]


def _composite_band_interleaved(splats, shard_index, num_shards,
                                config: RenderConfig):
    """Composite this chip's INTERLEAVED tile rows (rows r % D == shard_index).

    The grid is the FULL (height-padded) image grid with row_stride = D: tile
    ids, sort keys and the composite kernels' pixel-coordinate mapping are
    all full-image, so mean2d needs only the bottom-padding shift; binning
    enumerates only the owned rows (bin_splats ``row_offset``). Why strided
    ownership is the default: adjacent tile rows have similar splat density,
    so striding balances per-chip demand — the contiguous-band layout
    has a peak/mean demand imbalance up to 2.7x at D=8 on the garden
    stand-in, which alone forfeits the >=85% scaling bar; every (splat, tile) instance still lands on exactly one
    chip either way. Returns the chip's [band_h, W, 4] image whose row
    k*ts + j is image tile row (k*D + shard_index), pixel row j.
    """
    from splatapult_jax.ops.binning import bin_splats
    from splatapult_jax.ops.composite import composite_from_feats
    from splatapult_jax.ops.tiled import (
        _grid_from_config, assemble_image, pack_features,
    )

    h_pad = _padded_height(config, num_shards)
    cfg_full = dataclasses.replace(config, height=h_pad)
    n = splats["mean2d"].shape[0]
    grid = _grid_from_config(cfg_full, n, row_stride=num_shards)
    # content is registered to the TRUE height (row = height - y); lifting y
    # by (h_pad - height) keeps that registration under the padded-height
    # grid and puts the padding rows at the bottom
    dy = float(h_pad - config.height)
    mean2d = splats["mean2d"] + jnp.asarray([0.0, dy], jnp.float32)
    ng = jax.lax.stop_gradient
    bins = bin_splats(ng(mean2d), ng(splats["extent"]), grid,
                      depth=ng(splats["depth"]), row_offset=shard_index)
    feats = pack_features(mean2d, splats["conic"], splats["rgb"],
                          splats["alpha"])
    out = composite_from_feats(feats, bins, grid)
    img = assemble_image(out, bins["tile_ok"], grid, cfg_full)  # [h_pad, W, 4]
    ts = config.tile_size
    ty_owned = h_pad // ts // num_shards
    img5 = img.reshape(ty_owned, num_shards, ts, img.shape[1], 4)
    return lax.dynamic_index_in_dim(
        img5, shard_index, axis=1, keepdims=False
    ).reshape(ty_owned * ts, img.shape[1], 4)


def _band_fn(band_layout: str):
    assert band_layout in ("interleaved", "contiguous"), band_layout
    return (_composite_band_interleaved if band_layout == "interleaved"
            else _composite_band)


def _deinterleave_rows(out, config: RenderConfig, num_shards: int):
    """Chip-major stacked interleaved bands [.., D*band_h, W, 4] -> image rows.

    Chip d's band row k*ts + j is image tile row k*D + d; undo by a reshape
    + transpose on the row axis (free at XLA level)."""
    ts = config.tile_size
    h_pad = _padded_height(config, num_shards)
    ty_owned = h_pad // ts // num_shards
    lead = out.shape[:-3]
    w = out.shape[-2]
    img = out.reshape(lead + (num_shards, ty_owned, ts, w, 4))
    perm = tuple(range(len(lead))) + tuple(
        i + len(lead) for i in (1, 0, 2, 3, 4))
    return img.transpose(perm).reshape(lead + (h_pad, w, 4))


def band_instance_demands(scene, camera: Camera, config: RenderConfig,
                          num_shards: int, band_layout: str = "interleaved"):
    """Tile-instance demand of each chip's tile rows -> [num_shards] int32.

    Applies EXACTLY the rect-clipping the chosen band layout applies
    (interleaved: row_offset on the full strided grid; contiguous: shifted
    mean2d against the band-height grid), so entry d equals the instance
    count chip d's binning would enumerate — the basis of band-aware
    capacity calibration."""
    from splatapult_jax.ops.binning import instance_demand
    from splatapult_jax.ops.tiled import _grid_from_config

    splats = prepare_splats(scene, camera, config, sort=False)
    ds = jnp.arange(num_shards, dtype=jnp.int32)
    if band_layout == "interleaved":
        h_pad = _padded_height(config, num_shards)
        cfg_full = dataclasses.replace(config, height=h_pad)
        grid = _grid_from_config(cfg_full, scene.means.shape[0],
                                 row_stride=num_shards)
        m2 = splats["mean2d"] + jnp.asarray(
            [0.0, float(h_pad - config.height)], jnp.float32)
        return jax.vmap(
            lambda d: instance_demand(m2, splats["extent"], grid, row_offset=d)
        )(ds)
    cfg_band = _shard_config(config, num_shards)
    grid = _grid_from_config(cfg_band, scene.means.shape[0])
    band_h = cfg_band.height
    shift0 = jnp.zeros((), jnp.float32)

    def one(d):
        y_bottom = (config.height - (d + 1) * band_h).astype(jnp.float32)
        m2 = splats["mean2d"] - jnp.stack([shift0, y_bottom])
        return instance_demand(m2, splats["extent"], grid)

    return jax.vmap(one)(ds)


@functools.lru_cache(maxsize=32)
def _band_demand_fns(config: RenderConfig, num_shards: int, band_layout: str):
    @jax.jit
    def one(scene, cam):
        return band_instance_demands(scene, cam, config, num_shards,
                                     band_layout)

    @jax.jit
    def peak(scene, cams):
        # one jitted pass over the whole camera batch, ONE readback of the
        # peak (a python per-view loop would pay a device round trip per view)
        return jnp.max(jax.lax.map(lambda c: jnp.max(one(scene, c)), cams))

    return one, peak


def calibrate_config_sharded(scene, cameras: Camera, config: RenderConfig,
                             mesh: Mesh, headroom: float = 1.06,
                             bucket: float | None = None,
                             band_layout: str = "interleaved") -> RenderConfig:
    """Band-aware capacity calibration for the tile-sharded pipeline.

    Sizes ``max_instance_mult`` to the PEAK PER-BAND demand across the given
    view(s) instead of the full-view demand, so each chip's instance sort —
    the dominant surviving per-step cost — runs at ~1/D of the full-view
    rows (a full-view-calibrated config would make every chip sort
    full-view capacity, structurally forfeiting the >=85% scaling bar).
    SPMD programs need ONE static capacity on every chip, so the peak band
    governs; for a balanced scene that is ~demand/D. Reference frame: the
    reference is single-GPU (src/splatrenderer.cpp) — this is the
    framework's own north-star requirement (BASELINE config 5).
    """
    from splatapult_jax.render import CAPACITY_BUCKET, capacity_mult_for_demand

    num_shards = mesh.shape["tiles"]
    one, peak_fn = _band_demand_fns(config, num_shards, band_layout)
    mats = jnp.asarray(cameras.cam_to_world)
    if mats.ndim == 2:
        peak = int(jnp.max(one(scene, cameras)))
    else:
        peak = int(peak_fn(scene, cameras))
    mult = capacity_mult_for_demand(
        peak, scene.means.shape[0], headroom,
        CAPACITY_BUCKET if bucket is None else bucket,
    )
    return dataclasses.replace(config, max_instance_mult=mult)


def render_sharded(scene, camera: Camera, config: RenderConfig, mesh: Mesh,
                   shard_prepare: bool = True,
                   band_layout: str = "interleaved") -> jax.Array:
    """Single view, tiles sharded across the mesh's 'tiles' axis -> [H, W, 4].

    Scene parameters and the camera are replicated; the output image is sharded
    by rows. Crops away the shard-divisibility padding. ``shard_prepare``
    shards the O(N) projection/SH over the 'tiles' axis too (bit-identical
    output; see prepare_splats_sharded) — disable only for A/B measurement.
    ``band_layout``: "interleaved" (default — balanced per-chip demand, see
    _composite_band_interleaved) or "contiguous" (horizontal bands, kept
    for A/B).
    """
    num_shards = mesh.shape["tiles"]
    prep = prepare_splats_sharded if shard_prepare else (
        lambda s, c, cfg: prepare_splats(s, c, cfg, sort=False))
    band = _band_fn(band_layout)

    def shard_fn(scene, camera):
        splats = prep(scene, camera, config)
        d = lax.axis_index("tiles")
        return band(splats, d, num_shards, config)

    out = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P("tiles", None, None),
        check_vma=False,
    )(scene, camera)
    if band_layout == "interleaved":
        out = _deinterleave_rows(out, config, num_shards)
    return out[: config.height]


def render_batch_sharded(scene, cameras: Camera, config: RenderConfig, mesh: Mesh,
                         shard_prepare: bool = True,
                         band_layout: str = "interleaved") -> jax.Array:
    """[V]-batched cameras -> [V, H, W, 4]; views over 'views', tiles over 'tiles'."""
    num_shards = mesh.shape["tiles"]
    prep = prepare_splats_sharded if shard_prepare else (
        lambda s, c, cfg: prepare_splats(s, c, cfg, sort=False))
    band = _band_fn(band_layout)

    def shard_fn(scene, cameras):
        def one_view(cam):
            splats = prep(scene, cam, config)
            d = lax.axis_index("tiles")
            return band(splats, d, num_shards, config)

        return jax.vmap(one_view)(cameras)

    out = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P("views")),
        out_specs=P("views", "tiles", None, None),
        check_vma=False,
    )(scene, cameras)
    if band_layout == "interleaved":
        out = _deinterleave_rows(out, config, num_shards)
    return out[:, : config.height]


@functools.lru_cache(maxsize=32)
def make_sharded_train_step(config: RenderConfig, mesh: Mesh, optimizer=None,
                            sh_psum_chunks: int = 1,
                            grad_allreduce: str = "psum",
                            shard_prepare: bool = True,
                            band_layout: str = "interleaved"):
    """Build (and cache) the jitted SPMD train step for (config, mesh, optimizer).

    Rebuilding the shard_map per call would re-trace and re-compile the whole
    SPMD program every step; training loops must reuse this compiled function.

    NOTE the lru_cache keys on the ``optimizer`` OBJECT: optax
    GradientTransformations are NamedTuples of fresh closures, so two
    `optax.adam(1e-3)` calls are DIFFERENT keys — construct the optimizer
    once and reuse it, or every call recompiles the whole SPMD program
    (and the cache retains up to 32 of them).
    """

    def step_fn(scene, cameras, targets, opt_state):
        loss, grads = _sharded_value_and_grad(
            scene, cameras, targets, config, mesh,
            sh_psum_chunks=sh_psum_chunks, grad_allreduce=grad_allreduce,
            shard_prepare=shard_prepare, band_layout=band_layout)
        if optimizer is None:
            return loss, grads, None
        updates, opt_state = optimizer.update(grads, opt_state, scene)
        import optax

        new_scene = optax.apply_updates(scene, updates)
        return loss, new_scene, opt_state

    return jax.jit(step_fn)


def sharded_train_step(scene, cameras: Camera, targets, config: RenderConfig, mesh: Mesh,
                       optimizer=None, opt_state=None, sh_psum_chunks: int = 1,
                       grad_allreduce: str = "psum", shard_prepare: bool = True,
                       band_layout: str = "interleaved"):
    """One SPMD optimization step: render camera batch, L2 loss vs targets,
    grads to all splat parameters all-reduced across the mesh, optional optax
    update. Returns (loss, grads_or_updated_scene, new_opt_state).

    Compiled once per (config, mesh, optimizer) via make_sharded_train_step.
    """
    return make_sharded_train_step(config, mesh, optimizer, sh_psum_chunks,
                                   grad_allreduce, shard_prepare, band_layout)(
        scene, cameras, targets, opt_state)


@functools.lru_cache(maxsize=32)
def make_sharded_fit_steps(config: RenderConfig, mesh: Mesh, optimizer,
                           steps: int, sh_psum_chunks: int = 1,
                           grad_allreduce: str = "psum",
                           shard_prepare: bool = True,
                           band_layout: str = "interleaved"):
    """``steps`` SPMD updates inside ONE jitted lax.scan -> (scene, opt_state,
    losses[steps]).

    The multi-chip analog of train._fit_steps: a python step loop reading the
    loss back per step stalls every chip on a device->host sync per step —
    which on real devices would also mask whatever backward/all-reduce overlap
    the in-backward psum placement wins. Scanning
    on-device costs ONE readback for the whole chunk's loss curve.
    """
    import optax

    def fit_fn(scene, cameras, targets, opt_state):
        def body(carry, _):
            scene, opt_state = carry
            loss, grads = _sharded_value_and_grad(
                scene, cameras, targets, config, mesh,
                sh_psum_chunks=sh_psum_chunks, grad_allreduce=grad_allreduce,
                shard_prepare=shard_prepare, band_layout=band_layout)
            updates, opt_state = optimizer.update(grads, opt_state, scene)
            scene = optax.apply_updates(scene, updates)
            return (scene, opt_state), loss

        (scene, opt_state), losses = lax.scan(
            body, (scene, opt_state), None, length=steps)
        return scene, opt_state, losses

    return jax.jit(fit_fn)


def ring_all_reduce(x, axis_name: str):
    """All-reduce over ONE named axis as an explicit ppermute ring.

    The manual alternative SURVEY.md section 5 names for the north-star
    overlap: a ring reduce-scatter (D-1 permute+add steps) followed by a ring
    all-gather (D-1 permute steps), all expressed as `lax.ppermute` — 2(D-1)
    INDEPENDENT small collectives instead of one monolithic all-reduce. A
    monolithic terminal all-reduce may be combined and sunk by XLA,
    leaving nothing to overlap; a chain of permutes gives the latency-hiding scheduler points to interleave the
    remaining backward compute. Bandwidth-optimal: each element crosses each
    link 2(D-1)/D times, the same as the ring the all-reduce would run.
    """
    d = lax.psum(1, axis_name)  # static axis size
    if d == 1:
        return x
    idx = lax.axis_index(axis_name)
    shape = x.shape
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % d
    if pad:
        flat = jnp.pad(flat, (0, pad))
    flat = flat.reshape(d, -1)
    fwd = [(i, (i + 1) % d) for i in range(d)]

    def chunk(k):
        return lax.dynamic_index_in_dim(flat, lax.rem(k + 2 * d, d), axis=0,
                                        keepdims=False)

    # reduce-scatter: a partial created at device m targets chunk (m - 1);
    # after D-1 permute+add hops, device i holds the full sum of chunk i
    acc = chunk(idx - 1)
    for s in range(d - 1):
        acc = lax.ppermute(acc, axis_name, fwd)
        acc = acc + chunk(idx - s - 2)
    # all-gather: circulate the finished chunks back around the ring
    out = lax.dynamic_update_index_in_dim(
        jnp.zeros_like(flat), acc, lax.rem(idx + 2 * d, d), axis=0)
    cur = acc
    for s in range(d - 1):
        cur = lax.ppermute(cur, axis_name, fwd)
        out = lax.dynamic_update_index_in_dim(
            out, cur, lax.rem(idx - s - 1 + 2 * d, d), axis=0)
    out = out.reshape(-1)
    if pad:
        out = out[: out.shape[0] - pad]
    return out.reshape(shape)


def ring_psum(x, axes) -> jax.Array:
    """All-reduce over the named axes via sequential per-axis ppermute rings
    (ring over 'tiles', then 'views' — a sum of sums is the total sum)."""
    for ax in axes:
        x = ring_all_reduce(x, ax)
    return x


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _psum_in_bwd(x, axes):
    """Identity forward; all-reduces the COTANGENT across ``axes``.

    Placing the gradient all-reduce *inside* the backward graph — at the
    exact point the cotangent materializes — instead of after value_and_grad
    returns is what makes overlap possible at all: post-hoc leaf psums can
    be combined into ONE tuple all-reduce scheduled dead last (after the
    entire backward), where no compute remains to hide it behind. d_sh
    materializes at the SH-basis transpose matmul, BEFORE the projection
    backward (d_means/d_quats/d_scales) runs, so an all-reduce issued here
    has the whole projection backward to overlap with on real devices.
    """
    return x


def _psum_in_bwd_fwd(x, axes):
    return x, None


def _psum_in_bwd_bwd(axes, _, g):
    return (lax.psum(g, axes),)


_psum_in_bwd.defvjp(_psum_in_bwd_fwd, _psum_in_bwd_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _ring_psum_in_bwd(x, axes):
    """_psum_in_bwd with the cotangent all-reduced as an explicit ppermute
    ring (see ring_all_reduce) instead of one monolithic lax.psum."""
    return x


def _ring_psum_in_bwd_fwd(x, axes):
    return x, None


def _ring_psum_in_bwd_bwd(axes, _, g):
    return (ring_psum(g, axes),)


_ring_psum_in_bwd.defvjp(_ring_psum_in_bwd_fwd, _ring_psum_in_bwd_bwd)


def _sharded_value_and_grad(scene, cameras: Camera, targets, config: RenderConfig, mesh: Mesh,
                           sh_psum_chunks: int = 1, grad_allreduce: str = "psum",
                           shard_prepare: bool = True,
                           band_layout: str = "interleaved"):
    """(loss, grads) with tile/view sharding and explicit cross-chip psum.

    The SH gradient — 48 of the 61 gradient floats per splat, the
    all-reduce's byte budget — is all-reduced INSIDE the backward via
    _psum_in_bwd, as early as its cotangent exists; the small remaining
    leaves (means/opacities/scales/quats, 13 floats) ride one final psum.
    The reference, being forward-only and single-GPU, has no analog
    (SURVEY.md section 2.3).

    ``sh_psum_chunks > 1`` additionally splits the in-backward SH all-reduce
    into that many coefficient-band chunks with one psum each, giving the
    scheduler independent smaller collectives to pipeline.

    ``grad_allreduce="ring"`` swaps the in-backward SH all-reduce for the
    manual chunked ppermute ring (ring_all_reduce): this XLA combines and
    sinks monolithic terminal all-reduces where nothing can hide them (AOT
    evidence, PERF.md "grad-overlap"); a ring of 2(D-1) independent permutes
    gives the scheduler interleaving points without waiting for async
    all-reduce support. "psum" stays the default.
    """
    assert grad_allreduce in ("psum", "ring"), grad_allreduce
    num_shards = mesh.shape["tiles"]
    band_h = _shard_config(config, num_shards).height
    axes = ("views", "tiles")
    marker = _psum_in_bwd if grad_allreduce == "psum" else _ring_psum_in_bwd
    prep = prepare_splats_sharded if shard_prepare else (
        lambda s, c, cfg: prepare_splats(s, c, cfg, sort=False))
    band_fn = _band_fn(band_layout)
    ts = config.tile_size

    def shard_loss(scene, cameras, targets):
        # SH grads all-reduce in-backward (see _psum_in_bwd). The marker
        # sits OUTSIDE the view vmap: its cotangent is this shard's full
        # d_sh (already summed over the shard's views).
        k = scene.sh.shape[-1]
        if sh_psum_chunks > 1 and k % sh_psum_chunks == 0:
            step = k // sh_psum_chunks
            sh = jnp.concatenate(
                [marker(scene.sh[..., i * step:(i + 1) * step], axes)
                 for i in range(sh_psum_chunks)], axis=-1)
        else:
            sh = marker(scene.sh, axes)
        scene = dataclasses.replace(scene, sh=sh)
        d = lax.axis_index("tiles")

        def one_view(cam, tgt):
            splats = prep(scene, cam, config)
            band = band_fn(splats, d, num_shards, config)
            # crop the shard-divisibility padding rows out of the loss
            i = jnp.arange(band_h)
            if band_layout == "interleaved":
                # band row i is image tile row (i//ts)*D + d, pixel row i%ts
                rows = ((i // ts) * num_shards + d) * ts + i % ts
            else:
                rows = d * band_h + i
            valid = (rows < config.height)[:, None, None]
            return jnp.sum(jnp.where(valid, (band - tgt) ** 2, 0.0))

        # local (this shard's) sum only — the cross-shard psum happens AFTER
        # differentiation; differentiating through lax.psum would scale the
        # cotangents by the device count (psum's transpose is psum).
        return jnp.sum(jax.vmap(one_view)(cameras, targets))

    def loss_fn(scene, cameras, targets):
        denom = targets.shape[0] * mesh.shape["views"] * config.height * config.width * 4
        return shard_loss(scene, cameras, targets) / denom

    grad_fn = jax.value_and_grad(loss_fn)

    def shard_step(scene, cameras, targets):
        loss, grads = grad_fn(scene, cameras, targets)
        # grads.sh was already all-reduced inside the backward (_psum_in_bwd,
        # where compute remains to hide it behind); the small remaining
        # leaves ride one terminal psum. Do NOT tree-map over grads: a
        # second psum of sh would double-count.
        loss = lax.psum(loss, axes)
        grads = dataclasses.replace(
            grads,
            means=lax.psum(grads.means, axes),
            opacities=lax.psum(grads.opacities, axes),
            log_scales=lax.psum(grads.log_scales, axes),
            quats=lax.psum(grads.quats, axes),
        )
        return loss, grads

    return jax.shard_map(
        shard_step,
        mesh=mesh,
        in_specs=(P(), P("views"), P("views", "tiles", None, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )(scene, cameras, targets)


def shard_targets(targets, config: RenderConfig, mesh: Mesh,
                  band_layout: str = "interleaved"):
    """Pad [V, H, W, 4] target images to the sharded height and reorder rows
    to the band layout (callers place them with P('views', 'tiles')
    sharding, whose contiguous row chunks then hold each chip's band).

    "interleaved": row chunk d holds image tile rows r with r % D == d, in
    ascending order — matching _composite_band_interleaved's band rows."""
    num_shards = mesh.shape["tiles"]
    h_pad = _padded_height(config, num_shards)
    pad = h_pad - targets.shape[1]
    if pad:
        targets = jnp.pad(targets, ((0, 0), (0, pad), (0, 0), (0, 0)))
    if band_layout == "interleaved" and num_shards > 1:
        ts = config.tile_size
        v, _, w, c = targets.shape
        ty_owned = h_pad // ts // num_shards
        targets = (
            targets.reshape(v, ty_owned, num_shards, ts, w, c)
            .transpose(0, 2, 1, 3, 4, 5)
            .reshape(v, h_pad, w, c)
        )
    return targets


# --------------------- ZeRO-style parameter sharding ---------------------
#
# The tile-sharded step above keeps the SCENE replicated: every chip holds
# all N splats' parameters and optimizer state, and the per-shard gradients
# are completed by an all-reduce of the FULL ~59-float/splat gradient tree
# (2(D-1)/D x 59 f32 x N — a term that GROWS with D). But
# prepare_splats is the ONLY consumer of the scene parameters, it is
# elementwise per splat, and the sharded prepare already all-gathers its ~14
# output floats per splat. So shard the parameters themselves (the classic
# ZeRO/FSDP recipe, over the splat axis instead of a weight axis) —
# over BOTH mesh axes, so pure view-parallel (data-parallel) meshes get the
# same win:
#
# - chip (v, t) OWNS splats [(t*V + v)*chunk, ...): parameters AND optimizer
#   state live sharded (P(('tiles','views')) on the splat axis, tiles-major)
#   — per-chip param + Adam memory drops from ~244 B/splat x N to x N/(V*T);
# - the two axes move DIFFERENT things, each the cheapest that is correct:
#   * views axis: PARAMETERS cross (classic FSDP) — features cannot, since
#     each views-row renders its own cameras. One 59-float/splat-of-N/T
#     param all_gather per step forward; its transpose reduce-scatters the
#     chunk grads back. Same bytes as the replicated grad psum, but
#     memory sharded V-fold and the gather is a step-START collective the
#     scheduler can overlap with the previous update instead of a terminal
#     all-reduce nothing can hide.
#   * tiles axis: FEATURES cross (prepare_splats is the only consumer of
#     the parameters and is elementwise) — the ~14-column all_gather whose
#     transpose psum-scatters the cotangents. 14 f32 each way instead of
#     the 118 f32/splat gradient all-reduce: total tiles-axis traffic
#     drops 146 -> 28 f32/splat (5.2x), HLO-verified
#     (no full-[N] gradient all-reduce exists in the compiled step).
# - update: optax runs on the owned chunk (O(N/(V*T)) instead of O(N)).
#
# The reference has no analog (single GPU, forward only); this is the
# framework's own BASELINE config-5 north star ("grad all-reduce overlapped"
# becomes "grad all-reduce eliminated on tiles, reshaped to an
# overlappable step-start gather on views").


def pad_scene_to_mesh(scene, mesh: Mesh):
    """Pad scene leaves so the splat count divides the FULL device count
    (views x tiles — the ZeRO path shards parameters over both axes) ->
    (padded_scene, true_n). Pad rows are inert (see _pad_scene) and sit at
    the global tail, so the gathered feature slice [:true_n] drops them."""
    d = mesh.shape["tiles"] * mesh.shape["views"]
    n = scene.means.shape[0]
    chunk = -(-n // d)
    return _pad_scene(scene, chunk * d), n


def _abstract_scene(npad: int, sh_k: int):
    from splatapult_jax.io.gaussians import GaussianScene

    f32 = jnp.float32
    return GaussianScene(
        means=jax.ShapeDtypeStruct((npad, 3), f32),
        sh=jax.ShapeDtypeStruct((npad, 3, sh_k), f32),
        opacities=jax.ShapeDtypeStruct((npad,), f32),
        log_scales=jax.ShapeDtypeStruct((npad, 3), f32),
        quats=jax.ShapeDtypeStruct((npad, 4), f32),
    )


_ZAXES = ("tiles", "views")  # ZeRO shards the splat axis over BOTH mesh axes,
# TILES-MAJOR: chip (v, t) owns chunk t*V + v, so the per-step views-axis
# param all_gather yields the contiguous global block t, and the per-view
# tiles-axis feature all_gather then reassembles global splat order


def _axis0_specs(shapes, npad: int):
    """P(('views','tiles')) for [npad, ...] leaves (splat axis sharded over
    the whole mesh), P() for the rest (optax step counters and other
    scalars stay replicated)."""
    return jax.tree.map(
        lambda x: P(_ZAXES) if (x.ndim >= 1 and x.shape[0] == npad) else P(),
        shapes,
    )


@functools.lru_cache(maxsize=32)
def make_zero_fit_steps(config: RenderConfig, mesh: Mesh, optimizer,
                        steps: int, num_splats: int, sh_k: int,
                        band_layout: str = "interleaved"):
    """``steps`` ZeRO-sharded SPMD updates in ONE jitted lax.scan.

    Signature of the returned fn: (padded_scene, cameras, targets,
    opt_state) -> (padded_scene, opt_state, losses[steps]), where
    padded_scene/opt_state leaves are sharded P(('views', 'tiles')) on the
    splat axis (see pad_scene_to_mesh; opt_state from
    optimizer.init(padded_scene)).

    Numerics: the forward is bit-identical to the replicated sharded step
    (prepare is elementwise; the all_gather reassembles the same columns).
    Gradients are mathematically identical — the prepare VJP is linear in
    its cotangent, so VJP(psum-scattered d_feats) == psum(VJP(d_feats))
    restricted to the owned chunk — differing only in float summation
    order. Same lru_cache caveat as make_sharded_train_step: ``optimizer``
    keys by object identity, construct it once.
    """
    import optax

    num_shards = mesh.shape["tiles"]
    n_dev = num_shards * mesh.shape["views"]
    chunk = -(-num_splats // n_dev)
    npad = chunk * n_dev
    band_h = _shard_config(config, num_shards).height
    band_fn = _band_fn(band_layout)
    ts = config.tile_size
    axes = ("views", "tiles")

    abstract = _abstract_scene(npad, sh_k)
    scene_specs = jax.tree.map(lambda x: P(_ZAXES), abstract)
    v_axis = mesh.shape["views"]
    opt_specs = _axis0_specs(jax.eval_shape(optimizer.init, abstract), npad)

    def shard_body(scene_loc, cameras, targets, opt_loc):
        d = lax.axis_index("tiles")

        def loss_fn(scene_loc):
            # views axis: PARAMETERS cross (classic FSDP) — features cannot,
            # because each views-row computes features under its OWN cameras.
            # One param all_gather per step; its transpose reduce-scatters
            # the chunk grads back, so the views axis trades the replicated
            # path's grad-psum bytes for the same-sized param-gather bytes
            # while still sharding params + optimizer state V-fold.
            scene_row = (scene_loc if v_axis == 1 else jax.tree.map(
                lambda x: lax.all_gather(x, "views", axis=0, tiled=True),
                scene_loc))  # contiguous global block t: rows [t*N/T, ...)

            def one_view(cam, tgt):
                sp = prepare_splats(scene_row, cam, config, sort=False)
                # tiles axis: FEATURES cross (the ~14-column all_gather
                # whose transpose psum-scatters the cotangents; the
                # 118 f32/splat grad all-reduce is gone — 146 -> 28
                # f32/splat total on this axis)
                splats = jax.tree.map(
                    lambda x: lax.all_gather(
                        x, "tiles", axis=0, tiled=True)[:num_splats], sp)
                band = band_fn(splats, d, num_shards, config)
                i = jnp.arange(band_h)
                if band_layout == "interleaved":
                    rows = ((i // ts) * num_shards + d) * ts + i % ts
                else:
                    rows = d * band_h + i
                valid = (rows < config.height)[:, None, None]
                return jnp.sum(jnp.where(valid, (band - tgt) ** 2, 0.0))

            denom = (targets.shape[0] * mesh.shape["views"]
                     * config.height * config.width * 4)
            return jnp.sum(jax.vmap(one_view)(cameras, targets)) / denom

        def body(carry, _):
            scene_loc, opt_loc = carry
            loss, g_loc = jax.value_and_grad(loss_fn)(scene_loc)
            # grads of the owned chunk are complete over BOTH axes: the
            # tiles feature-gather and views param-gather transposes
            # (psum-scatter / reduce-scatter) summed everything on the way
            # back — no explicit gradient collective remains.
            loss = lax.psum(loss, axes)
            updates, opt_loc = optimizer.update(g_loc, opt_loc, scene_loc)
            scene_loc = optax.apply_updates(scene_loc, updates)
            return (scene_loc, opt_loc), loss

        (scene_loc, opt_loc), losses = lax.scan(
            body, (scene_loc, opt_loc), None, length=steps)
        return scene_loc, opt_loc, losses

    return jax.jit(jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(scene_specs, P("views"), P("views", "tiles", None, None),
                  opt_specs),
        out_specs=(scene_specs, opt_specs, P()),
        check_vma=False,
    ))


def zero_fit_steps(scene, cameras: Camera, targets, config: RenderConfig,
                   mesh: Mesh, optimizer, steps: int, opt_state=None,
                   band_layout: str = "interleaved"):
    """Convenience wrapper: pad + init + run make_zero_fit_steps once.

    ``targets`` are RAW [V, H, W, 4] images (shard_targets is applied here).
    Returns (scene[true_n], opt_state, losses[steps]); pass opt_state back
    in to continue (it stays padded/sharded between calls)."""
    padded, n = pad_scene_to_mesh(scene, mesh)
    if opt_state is None:
        opt_state = optimizer.init(padded)
    fit = make_zero_fit_steps(config, mesh, optimizer, steps, n,
                              int(scene.sh.shape[-1]), band_layout)
    targets = shard_targets(jnp.asarray(targets), config, mesh, band_layout)
    padded, opt_state, losses = fit(padded, cameras, targets, opt_state)
    sliced = jax.tree.map(lambda x: x[:n], padded)
    return sliced, opt_state, losses
