"""Multi-host SPMD bring-up (BASELINE config 5).

The reference is single-process (SURVEY.md section 2.3); a multi-host job runs
one process per host in single-controller-per-host SPMD. This module is the thin
bring-up layer: call initialize_distributed() first on every host, build a
mesh spanning all hosts' devices, and use parallel.mesh exactly as on one
host — shard_map places each host's tile bands on its local devices and XLA
routes the grad psums over the host's device links (the network across
hosts).

Host-local data feeding: each host only needs the *targets* for its own tile
bands / view slice; scene parameters are replicated. Use
jax.make_array_from_process_local_data for the target shards.
"""

from __future__ import annotations

import logging

import jax

log = logging.getLogger(__name__)


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed.initialize with env-based autodetection.

    On clusters JAX knows (e.g. SLURM) the three arguments autodetect; pass
    them explicitly otherwise (coordinator_address="localhost:<port>" on one
    machine). Safe to call when already initialized or single-process
    (returns False).
    """
    # NB: do NOT probe jax.process_count() here — it initializes the runtime
    # backend, after which jax.distributed.initialize raises (it must run
    # before any backend use). jax.distributed.is_initialized is side-effect
    # free. (Caught by the 2-process test, tests/test_distributed.py.)
    if jax.distributed.is_initialized():
        return True  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        log.info(
            "distributed: process %d/%d, %d local / %d global devices",
            jax.process_index(), jax.process_count(),
            jax.local_device_count(), jax.device_count(),
        )
        return True
    except (ValueError, RuntimeError) as e:
        log.info("single-process mode (%s)", e)
        return False


def make_pod_mesh(num_view_shards: int = 1):
    """Mesh over ALL global devices (every host must call this identically).

    Tile bands are the fast-varying axis so that a host's bands sit on its own
    devices and band-boundary traffic stays on intra-host links.
    """
    from splatapult_jax.parallel.mesh import make_render_mesh

    devices = jax.devices()  # global, identical order on every process
    return make_render_mesh(
        num_tile_shards=len(devices) // num_view_shards,
        num_view_shards=num_view_shards,
        devices=devices,
    )


def local_target_shards(targets_for_local_bands, config, mesh):
    """Assemble a global [V, H_pad, W, 4] target array from per-host shards.

    targets_for_local_bands: this process's block of the (padded) target
    images — its view rows x its tile bands. The global shape is inferred
    from the local block and the P('views', 'tiles') sharding, so this works
    for any process->mesh layout (tile bands split across hosts, whole view
    shards per host as make_pod_mesh lays out, or both); an explicit
    global-shape formula would bake in one layout and silently mis-shape the
    others (a 2-process test caught exactly that, tests/test_distributed.py).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("views", "tiles", None, None))
    return jax.make_array_from_process_local_data(
        sharding, targets_for_local_bands
    )
