"""Render statistics / observability tests."""

import numpy as np

from splatapult_jax.core import transforms as T
from splatapult_jax.diagnostics import phase_timer, render_stats
from splatapult_jax.io.gaussians import make_debug_scene
from splatapult_jax.render import Camera, RenderConfig


def test_render_stats():
    scene = make_debug_scene()
    cam = Camera.from_fov(
        T.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=64, height=64,
    )
    cfg = RenderConfig(width=64, height=64, pipeline="tiled", tile_size=16,
                       tile_block=8, max_instance_mult=20)
    stats = render_stats(scene, cam, cfg)
    assert stats["num_splats"] == 16
    assert 0 < stats["num_visible"] <= 16
    assert stats["num_instances"] > 0
    assert stats["num_culled_instances"] == 0
    assert stats["tiles"] == 16
    assert stats["max_tile_instances"] >= stats["mean_tile_instances"]


def test_phase_timer():
    sink = {}
    with phase_timer(sink, "a"):
        pass
    with phase_timer(sink, "a"):
        pass
    assert sink["a"] >= 0.0


def test_sort_key_mode_gates_and_stats_field():
    """sort_key_mode reports the ACTIVE key mode: packed20 under 2048 tiles,
    exact32 at/above it (the sentinel-overflow boundary), and
    render_stats surfaces it."""
    import dataclasses

    from splatapult_jax.ops.binning import TileGrid, sort_key_mode

    g = TileGrid.create(width=1024, height=512, num_splats=8, tile_size=16,
                        depth_bits=20)
    assert g.num_tiles == 2048 and sort_key_mode(g) == "exact32"
    g2 = TileGrid.create(width=1008, height=512, num_splats=8, tile_size=16,
                         depth_bits=20)
    assert g2.num_tiles == 2016 and sort_key_mode(g2) == "packed20"
    assert sort_key_mode(dataclasses.replace(g2, depth_bits=32)) == "exact32"
    assert sort_key_mode(dataclasses.replace(g2, depth_bits=16)) == "packed16"


def test_render_stats_reports_sort_key_mode():
    import dataclasses

    from splatapult_jax.core import transforms as T
    from splatapult_jax.io.gaussians import make_debug_scene
    from splatapult_jax.render import Camera, RenderConfig

    scene = make_debug_scene()
    cam = Camera.from_fov(
        T.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
        fovy=np.pi / 4, width=64, height=64)
    cfg = RenderConfig(width=64, height=64, pipeline="tiled", tile_size=16,
                       tile_block=8, max_instance_mult=20, depth_bits=20)
    stats = render_stats(scene, cam, cfg)
    assert stats["sort_key_mode"] == "packed20"
    stats32 = render_stats(scene, cam, dataclasses.replace(cfg, depth_bits=32))
    assert stats32["sort_key_mode"] == "exact32"


def test_depth20_downgrade_logs_warning(caplog):
    """A requested packed depth key that cannot engage must announce the
    downgrade (trace-time, once per compile)."""
    import logging

    import jax.numpy as jnp

    from splatapult_jax.ops.binning import TileGrid, bin_splats

    grid = TileGrid.create(width=1024, height=512, num_splats=4, tile_size=16,
                           block=8, depth_bits=20)  # exactly 2048 tiles
    mean2d = jnp.asarray([[8.0, 8.0], [100.0, 400.0], [900.0, 300.0],
                          [100.0, 400.0]], jnp.float32)
    with caplog.at_level(logging.WARNING, logger="splatapult_jax"):
        bin_splats(mean2d, jnp.full((4, 2), 30.0), grid,
                   depth=jnp.asarray([3.0, 1.0, 2.0, 1.5]))
    assert any("packed-key budget" in r.message for r in caplog.records)


def test_bench_profiles_agree():
    """The CLI bench's --profile production must configure exactly the knobs
    bench.py's defaults configure (the two bench entry points must not
    silently measure different configurations)."""
    import argparse

    import bench as bench_mod
    from splatapult_jax.render import (
        PROFILES, RenderConfig, apply_profile, profile_name,
    )

    # bench.py's default flags -> its production config
    args = argparse.Namespace(
        width=1920, height=1080, tile_size=16, tile_block=16,
        instance_mult=0.0, early_stop=1e-4, grad_sort_dtype="bfloat16",
        packed_colors=True, packed_feats16=False, fwd_only=False,
        depth_bits=0, splats=1_500_000, sort_bands=1)
    cfg_bench = bench_mod._make_config(args)
    assert profile_name(cfg_bench) == "production"

    # the CLI's exact-default config overlaid with the production profile
    cfg_cli = apply_profile(RenderConfig(width=1920, height=1080), "production")
    for knob in PROFILES["production"]:
        assert getattr(cfg_cli, knob) == getattr(cfg_bench, knob), knob

    # and the library default is the exact profile
    assert profile_name(RenderConfig()) == "exact"
