"""CI guard for the scaling-efficiency harness (BASELINE configs 4-5).

Runs bench.py's `--mesh` measurement path — the exact code four GPUs would
time — end to end on the virtual 8-device CPU mesh: 1 vs 4 tile shards
of the full SPMD train step, finite rates, a well-formed JSON line. Wall-clock
efficiency is meaningless on virtual devices; what this pins down is that the
measurement machinery cannot rot before it meets real hardware."""

import argparse
import json

import numpy as np
import pytest

import bench
from splatapult_jax.render import RenderConfig


@pytest.mark.parametrize("allreduce", ["psum", "ring"])
def test_bench_mesh_harness_runs_on_virtual_mesh(capsys, allreduce):
    args = argparse.Namespace(
        mesh=4, views=2, width=64, height=64, iters=2, verbose=False,
        allreduce=allreduce,
        # instance_mult 0 exercises the band-aware calibration of
        # the sharded arm (calibrate_config_sharded)
        instance_mult=0.0, shard_prepare=True,
    )
    scene = bench.make_scene(512, seed=0)
    config = RenderConfig(
        width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8,
        max_instance_mult=20,
    )
    bench.bench_mesh(args, scene, config)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["metric"].startswith("rays/s scaling efficiency 1->4")
    assert rec["allreduce"] == allreduce
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert np.isfinite(rec["rate_1chip_px_s"]) and rec["rate_1chip_px_s"] > 0
    assert np.isfinite(rec["rate_4chip_px_s"]) and rec["rate_4chip_px_s"] > 0
    # the sharded arm band-calibrated its capacity below the 1-chip config's
    assert rec["instance_mult_4chip"] <= rec["instance_mult_1chip"]


def test_bench_mesh_sharded_losses_match_across_shard_counts():
    """The quantity bench_mesh rates must be the SAME computation at every
    shard count: loss(1 shard) == loss(4 shards) on identical inputs."""
    import jax
    import jax.numpy as jnp

    from splatapult_jax.io.synth import garden_cameras
    from splatapult_jax.parallel.mesh import (
        _sharded_value_and_grad,
        make_render_mesh,
        shard_targets,
    )
    from splatapult_jax.render import Camera

    scene = bench.make_scene(256, seed=1)
    config = RenderConfig(
        width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8,
        max_instance_mult=20,
    )
    cam1 = garden_cameras(1, width=64, height_px=64)
    cams = Camera(cam_to_world=cam1.cam_to_world[None], proj=cam1.proj[None])
    losses = {}
    for shards in (1, 4):
        mesh = make_render_mesh(num_tile_shards=shards, num_view_shards=1,
                                devices=jax.devices()[:shards])
        targets = shard_targets(jnp.zeros((1, 64, 64, 4), jnp.float32),
                                config, mesh)
        loss, grads = _sharded_value_and_grad(scene, cams, targets, config, mesh)
        losses[shards] = float(loss)
        assert np.all(np.isfinite(np.asarray(grads.means))), shards
    np.testing.assert_allclose(losses[1], losses[4], rtol=1e-5)


def test_bench_mesh_param_shard_arm_runs_on_virtual_mesh(capsys):
    """--param-shard times the ZeRO full train step (sharded params + optax,
    no grad all-reduce) through the same efficiency harness."""
    args = argparse.Namespace(
        mesh=4, views=2, width=64, height=64, iters=2, verbose=False,
        allreduce="psum", instance_mult=0.0, shard_prepare=True,
        param_shard=True,
    )
    scene = bench.make_scene(512, seed=0)
    config = RenderConfig(
        width=64, height=64, pipeline="tiled", tile_size=16, tile_block=8,
        max_instance_mult=20,
    )
    bench.bench_mesh(args, scene, config)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["param_shard"] is True
    assert np.isfinite(rec["value"]) and rec["value"] > 0
    assert np.isfinite(rec["rate_4chip_px_s"]) and rec["rate_4chip_px_s"] > 0
