"""Worker process for tests/test_distributed.py: one SPMD train step through
the multi-host bring-up layer (parallel/distributed.py) on the CPU platform.

Run as:  python tests/distributed_worker.py <process_id> <num_processes> <port>

Prints machine-checkable lines:
  MESH {'views': ..., 'tiles': ...}
  LOSS <float>
  GRAD <leaf>=<abs-sum>
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# multi-process collectives on the CPU backend ride gloo
jax.config.update("jax_cpu_collectives_implementation", "gloo")

import numpy as np


def build_problem(width=32, height=64, views=4, num_splats=64):
    """Deterministic scene/cameras/targets, identical on every process."""
    import jax.numpy as jnp

    from splatapult_jax.core import transforms as T
    from splatapult_jax.io.gaussians import GaussianScene
    from splatapult_jax.render import Camera, RenderConfig

    rng = np.random.default_rng(7)
    quats = rng.standard_normal((num_splats, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scene = GaussianScene(
        means=jnp.asarray(rng.uniform(-1, 1, (num_splats, 3)), jnp.float32),
        sh=jnp.asarray(rng.standard_normal((num_splats, 3, 16)) * 0.3, jnp.float32),
        opacities=jnp.asarray(rng.uniform(-2, 2, (num_splats,)), jnp.float32),
        log_scales=jnp.asarray(rng.uniform(-5.0, -3.0, (num_splats, 3)), jnp.float32),
        quats=jnp.asarray(quats),
    )
    config = RenderConfig(
        width=width, height=height, pipeline="tiled", tile_size=16,
        tile_block=8, max_instance_mult=16,
    )
    cams = [
        Camera.from_fov(
            T.look_at(eye=[np.cos(a) * 2.5, 0.5, np.sin(a) * 2.5],
                      target=[0, 0, 0], up=[0, 1, 0]),
            fovy=np.pi / 4, width=width, height=height,
        )
        for a in np.linspace(0, 2 * np.pi, views, endpoint=False)
    ]
    cam_batch = Camera(
        cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
        proj=jnp.stack([c.proj for c in cams]),
    )
    targets = rng.uniform(0.0, 1.0, (views, height, width, 4)).astype(np.float32)
    return scene, cam_batch, targets, config


def main():
    process_id, num_processes, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    from splatapult_jax.parallel.distributed import (
        initialize_distributed,
        local_target_shards,
        make_pod_mesh,
    )

    ok = initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    assert ok, "initialize_distributed failed"
    assert jax.process_count() == num_processes, jax.process_count()

    scene, cam_batch, targets, config = build_problem()
    views = targets.shape[0]

    # one view shard per host: each host's tile bands stay on its own devices
    mesh = make_pod_mesh(num_view_shards=num_processes)
    print(f"MESH {dict(mesh.shape)}", flush=True)

    from splatapult_jax.parallel.mesh import shard_targets, sharded_train_step

    padded = np.asarray(shard_targets(targets, config, mesh))
    # this host's view rows (the views axis maps to processes in this layout)
    v_local = views // num_processes
    local = padded[process_id * v_local : (process_id + 1) * v_local]
    tgt = local_target_shards(local, config, mesh)
    assert tgt.shape == padded.shape, (tgt.shape, padded.shape)

    loss, grads, _ = sharded_train_step(scene, cam_batch, tgt, config, mesh)
    print(f"LOSS {float(loss):.9e}", flush=True)
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        g = getattr(grads, name)
        # grads are replicated post-psum: fully addressable on every host
        val = float(jax.jit(lambda x: jax.numpy.sum(jax.numpy.abs(x)))(g))
        print(f"GRAD {name}={val:.9e}", flush=True)


if __name__ == "__main__":
    main()
