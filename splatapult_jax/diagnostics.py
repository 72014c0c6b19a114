"""Observability: render statistics and profiling helpers.

The equivalents of the reference's aux subsystems (SURVEY.md section 5):
Tracy frame zones -> jax.profiler traces with named phases; the FPS HUD ->
structured JSON stats on stdout; GL_ERROR_CHECK -> finite/overflow assertions.
"""

from __future__ import annotations

import contextlib
import json
import time

import jax
import numpy as np


def render_stats(scene, camera, config):
    """Per-frame statistics the reference surfaces via its HUD/logs: splat
    counts, cull survivors, tile-bin occupancy, capacity overflow (never let
    truncation pass silently — SURVEY.md section 7 hard parts)."""
    import jax.numpy as jnp

    from splatapult_jax.ops.binning import bin_splats, sort_key_mode
    from splatapult_jax.ops.tiled import _grid_from_config
    from splatapult_jax.render import prepare_splats

    # mirror the PRODUCTION tiled path: unsorted prepare, depth riding the
    # binning sort (prepare(sort=True) is the legacy/global-pipeline path)
    d = prepare_splats(scene, camera, config, sort=False)
    grid = _grid_from_config(config, scene.means.shape[0])
    bins = bin_splats(
        jax.lax.stop_gradient(d["mean2d"]),
        jax.lax.stop_gradient(d["extent"]),
        grid,
        depth=jax.lax.stop_gradient(d["depth"]),
    )
    tile_count = np.asarray(bins["tile_count"])
    num_instances = int(tile_count.sum())
    return {
        "num_splats": int(scene.means.shape[0]),
        "num_visible": int(np.asarray(d["mask"]).sum()),
        "num_instances": num_instances,
        "num_culled_instances": int(bins["num_culled_instances"]),
        "instance_capacity": grid.mcap,
        # enumeration-capacity utilization; near 1.0 risks overflow culling,
        # far below 1.0 wastes sort/gather/kernel time (size the capacity
        # from ops.binning.instance_demand, as bench.py does)
        "capacity_utilization": round(num_instances / max(grid.emax, 1), 4),
        "tiles": grid.num_tiles,
        "max_tile_instances": int(tile_count.max()),
        "mean_tile_instances": float(tile_count.mean()),
        "empty_tiles": int((tile_count == 0).sum()),
        # the ACTIVE instance-sort key mode (a packed depth key silently
        # falls back to "exact32" past its tile-count budget; the reference
        # prints its sort-path choice at init, src/splatrenderer.cpp:86-103)
        "sort_key_mode": sort_key_mode(grid),
    }


@contextlib.contextmanager
def phase_timer(sink: dict, name: str):
    """Named wall-clock phase (the Tracy ZoneScoped analog). Remember that on
    async backends only whole dispatch+block boundaries are meaningful."""
    t0 = time.perf_counter()
    yield
    sink[name] = sink.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """jax.profiler trace around a region -> view in XProf/TensorBoard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def print_stats(stats: dict) -> None:
    print(json.dumps(stats))
