"""CLI smoke tests: every subcommand drives the real pipeline end to end."""

import json
import os

import numpy as np
import pytest

from splatapult_jax.cli import main
from splatapult_jax.utils.image import load_png


def test_cli_info(capsys, test_ply_path):
    main(["info", test_ply_path])
    out = capsys.readouterr().out
    assert "splats:      16" in out
    assert "sh degree:   3" in out
    assert "test_vr.json" in out


def test_cli_render(tmp_path, test_ply_path):
    out = str(tmp_path / "render.png")
    main([
        "render", test_ply_path, "-o", out, "--width", "64", "--height", "48",
        "--eye", "0", "0.5", "2.5", "--pipeline", "global", "--no-floor",
    ])
    img = load_png(out)
    assert img.shape == (48, 64, 3)
    assert img.max() > 0.05  # something visible


def test_cli_render_vr_pose(tmp_path, test_ply_path):
    # default camera + discovered test_vr.json floor transform
    out = str(tmp_path / "vr.png")
    main(["render", test_ply_path, "-o", out, "--width", "64", "--height", "48",
          "--pipeline", "global"])
    assert os.path.exists(out)


def test_cli_render_nosh_fp16(tmp_path, test_ply_path):
    out = str(tmp_path / "nosh.png")
    main([
        "render", test_ply_path, "-o", out, "--width", "32", "--height", "32",
        "--eye", "0", "0.5", "2.5", "--nosh", "--fp16", "--pipeline", "global",
        "--no-floor",
    ])
    assert os.path.exists(out)


def test_cli_export_and_prune(tmp_path, test_ply_path):
    out = str(tmp_path / "export.ply")
    main(["export", test_ply_path, "-o", out, "--prune", "8"])
    from splatapult_jax.io.gaussians import load_gaussian_ply

    scene = load_gaussian_ply(out)
    assert scene.num_gaussians == 8


def test_cli_path(tmp_path, test_ply_path):
    # synthesize a scene dir with cameras.json next to a copy of the ply
    import shutil

    scene_dir = tmp_path / "scene"
    scene_dir.mkdir()
    ply = scene_dir / "model.ply"
    shutil.copy(test_ply_path, ply)
    cams = []
    for i, a in enumerate((0.0, 0.7)):
        cams.append({
            "id": i, "width": 64, "height": 48,
            "position": [2.0 * np.cos(a), 0.5, 2.0 * np.sin(a)],
            "rotation": np.eye(3).tolist(),
            "fx": 60.0, "fy": 60.0,
        })
    (scene_dir / "cameras.json").write_text(json.dumps(cams))
    out = str(tmp_path / "frames.png")
    main(["path", str(ply), "-o", out, "--width", "64", "--height", "48",
          "--pipeline", "global", "--no-floor"])
    stem = out[:-4]
    assert os.path.exists(f"{stem}_0000.png")
    assert os.path.exists(f"{stem}_0001.png")


def test_cli_points(tmp_path):
    from splatapult_jax.io.points import make_debug_points, save_point_ply

    ply = str(tmp_path / "input.ply")
    save_point_ply(ply, make_debug_points())
    out = str(tmp_path / "points.png")
    main(["points", ply, "-o", out, "--width", "48", "--height", "48",
          "--eye", "1", "1", "1", "--target", "0.3", "0.3", "0.3",
          "--pipeline", "global"])
    img = load_png(out)
    assert img.max() > 0.05


def test_cli_save_pose(tmp_path, test_ply_path):
    # the Return-key pose save (ref: src/app.cpp:700-732): write a floor
    # transform, then confirm a render discovers and applies it
    import shutil

    ply = str(tmp_path / "scene.ply")
    shutil.copy(test_ply_path, ply)
    main(["save-pose", ply, "--eye", "0", "0.5", "2.5", "--no-floor"])
    vr = str(tmp_path / "scene_vr.json")
    assert os.path.exists(vr)
    mat = np.asarray(json.load(open(vr))["floorMat"], np.float32).reshape(4, 4).T
    # floorMat = camera pose lowered 1.5 m along its own up axis
    assert np.isfinite(mat).all() and abs(mat[3, 3] - 1.0) < 1e-6
    out = str(tmp_path / "posed.png")
    main(["render", ply, "-o", out, "--width", "32", "--height", "32",
          "--pipeline", "global"])
    assert os.path.exists(out)


def test_cli_save_pose_idempotent(tmp_path, test_ply_path):
    # repeated saves with the same inputs must write the same matrix — the
    # saved floor transform must never compound into the next save
    import shutil

    ply = str(tmp_path / "scene.ply")
    shutil.copy(test_ply_path, ply)
    vr = str(tmp_path / "scene_vr.json")
    main(["save-pose", ply, "--eye", "0", "0.5", "2.5"])
    first = json.load(open(vr))["floorMat"]
    main(["save-pose", ply, "--eye", "0", "0.5", "2.5"])
    second = json.load(open(vr))["floorMat"]
    np.testing.assert_array_equal(first, second)
    # explicit -o out.png is honored verbatim (no sentinel-default surprise)
    out = str(tmp_path / "out.png")
    main(["save-pose", ply, "--eye", "0", "0.5", "2.5", "-o", out])
    assert os.path.exists(out) and json.load(open(out))["floorMat"] == first


def test_cli_synth_garden_roundtrip(tmp_path, capsys):
    out = str(tmp_path / "garden.ply")
    main(["synth", "garden", "-o", out, "--splats", "3000", "--seed", "2"])
    assert "3000 splats, SH degree 3" in capsys.readouterr().out
    png = str(tmp_path / "garden.png")
    main(["render", out, "-o", png, "--width", "64", "--height", "48",
          "--eye", "4.2", "1.6", "0", "--pipeline", "tiled"])
    img = load_png(png)
    assert img.shape == (48, 64, 3)
    assert img.max() > 0.05


def test_cli_synth_debug(tmp_path, capsys):
    out = str(tmp_path / "debug.ply")
    main(["synth", "debug", "-o", out])
    assert "16 splats" in capsys.readouterr().out


def test_cli_render_stereo_shared_bins(tmp_path, test_ply_path):
    # --stereo drives the shared-binning stereo path (splatapult_jax/stereo.py)
    out = str(tmp_path / "stereo.png")
    main([
        "render", test_ply_path, "-o", out, "--width", "32", "--height", "32",
        "--eye", "0", "0.5", "2.5", "--stereo", "--shared-bins",
        "--pipeline", "tiled", "--no-floor",
    ])
    img = load_png(out)
    assert img.shape == (32, 64, 3)  # L/R side by side


def test_cli_render_stereo_global_fallback(tmp_path, test_ply_path):
    # --stereo with --pipeline global (or --supersample > 1) cannot use the
    # shared-binning path (tiled-only); it must fall back to the per-eye
    # render_batch path and still honor both flags
    out = str(tmp_path / "stereo_g.png")
    main([
        "render", test_ply_path, "-o", out, "--width", "32", "--height", "32",
        "--eye", "0", "0.5", "2.5", "--stereo", "--pipeline", "global",
        "--supersample", "2", "--no-floor",
    ])
    img = load_png(out)
    assert img.shape == (32, 64, 3)  # L/R side by side


def test_cli_fit_orbit(tmp_path, capsys):
    """`fit --orbit --adaptive`: render targets from a debug scene with the
    CLI's own orbit rig, perturb the scene, fit it back. Loss must drop and
    the output PLY must load."""
    import jax
    import jax.numpy as jnp

    from splatapult_jax.cli import _orbit_rig
    from splatapult_jax.io.gaussians import (
        load_gaussian_ply, make_debug_scene, save_gaussian_ply,
    )
    from splatapult_jax.render import Camera, RenderConfig, render
    from splatapult_jax.utils.image import save_png

    scene = make_debug_scene()
    w = h = 32
    cfg = RenderConfig(width=w, height=h, pipeline="tiled", tile_size=16,
                       tile_block=8, max_instance_mult=20)
    rig = _orbit_rig(scene, 3, w, h, fovy=np.deg2rad(45.0))
    for i in range(3):
        img = render(scene, Camera(cam_to_world=rig.cam_to_world[i],
                                   proj=rig.proj[i]), cfg)
        save_png(str(tmp_path / f"t_{i:02d}.png"), np.asarray(img),
                 keep_alpha=True)

    import dataclasses

    pert = dataclasses.replace(scene, means=scene.means + 0.04,
                               opacities=scene.opacities - 0.3)
    in_ply = str(tmp_path / "in.ply")
    out_ply = str(tmp_path / "out.ply")
    save_gaussian_ply(in_ply, pert)

    main(["fit", in_ply, "--targets", str(tmp_path / "t_*.png"),
          "--orbit", "--adaptive", "--densify-every", "4", "--steps", "8",
          "--lr", "0.01", "--tile-size", "16", "-o", out_ply])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["views"] == 3 and rec["steps"] == 8
    assert np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"])
    # an 8-step adaptive run is NOT monotone (the optimizer restarts at the
    # densify boundary, and split children resample positions — at 16 splats
    # that perturbation can exceed the tiny starting loss); convergence is
    # pinned by test_densify's end-to-end test — here assert the loop is
    # sane (absolute bound, no blow-up) and densification actually ran
    assert rec["loss_last"] < 0.01
    assert len(rec["densify_events"]) >= 1
    fitted = load_gaussian_ply(out_ply)
    assert fitted.num_gaussians == rec["splats"]
