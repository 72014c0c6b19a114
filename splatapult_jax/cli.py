"""Command-line driver: render / path / points / export / info / bench.

The functional replacement for the reference's App + SDL main (ref:
src/app.cpp:286-368 flag parsing, src/sdl_main.cpp). Interactive windows and
VR have no analog here; their *capabilities* map to subcommands:

  render   one view of a .ply -> PNG            (the per-frame loop)
  path     all cameras.json views -> PNGs       ('n'/'p' camera cycling,
                                                 src/app.cpp:650-674, batched)
  points   SfM input.ply -> PNG                 (PointRenderer)
  export   import/export round trip             (GaussianCloud::ExportPly)
  info     scene + discovered configs           (asset discovery, app.cpp:418-533)
  bench    throughput benchmark                 (FPS counter + vsync-off mode)

Reference flag parity: --nosh (app.cpp:335), --fp16/--fp32 accumulation
(app.cpp:1000-1035), sRGB handling (FRAMEBUFFER_SRGB), <ply>_vr.json floorMat
auto-discovery and application (app.cpp:443-461, 578).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np

log = logging.getLogger("splatapult_jax")


def _add_common(p):
    p.add_argument("ply", help="path to a 3DGS .ply scene")
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument("--width", type=int, default=1024)  # ref default window (sdl_main.cpp:72)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--fovy", type=float, default=45.0, help="degrees (ref app.cpp:73)")
    p.add_argument("--near", type=float, default=0.1)
    p.add_argument("--far", type=float, default=1000.0)
    p.add_argument("--nosh", action="store_true", help="degree-0 SH only (ref --nosh)")
    p.add_argument("--fp16", action="store_true", help="bf16 accumulation (ref --fp16)")
    p.add_argument("--srgb", action="store_true",
                   help="treat SH radiance as sRGB, composite in linear (ref FRAMEBUFFER_SRGB)")
    p.add_argument("--pipeline", choices=["auto", "global", "tiled"], default="auto")
    p.add_argument("--supersample", type=int, default=1,
                   help="ordered-grid supersampling factor (ref USE_SUPERSAMPLING)")
    p.add_argument("--tile-size", type=int, default=16)
    p.add_argument("--packed-colors", action="store_true",
                   help="16-bit fixed-point splat RGB: faster instance "
                        "gathers, max color error 1.2e-4 (PERF.md)")
    p.add_argument("--no-floor", action="store_true",
                   help="ignore a discovered <ply>_vr.json floor transform")
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--target", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--up", type=float, nargs=3, default=[0.0, 1.0, 0.0])
    p.add_argument("--camera-index", type=int, default=None,
                   help="use this camera from a discovered cameras.json")
    p.add_argument("--show-cameras", action="store_true",
                   help="overlay camera frustums + path (ref 'y'/'h' keys)")
    p.add_argument("-d", "--debug", action="store_true", help="verbose logging (ref -d)")


def _config(args, forward_only: bool = False):
    from splatapult_jax.render import RenderConfig

    return RenderConfig(
        forward_only=forward_only,
        width=args.width,
        height=args.height,
        sh_degree=0 if args.nosh else None,
        srgb_radiance_to_linear=args.srgb,
        accum_dtype="bfloat16" if args.fp16 else "float32",
        pipeline=args.pipeline,
        tile_size=args.tile_size,
        supersample=args.supersample,
        packed_colors=args.packed_colors,
    )


def _load_scene_and_assets(args):
    from splatapult_jax.io.configs import discover_scene, load_cameras_json, load_vr_config
    from splatapult_jax.io.gaussians import load_gaussian_ply

    found = discover_scene(args.ply)
    scene = load_gaussian_ply(args.ply, use_full_sh=not args.nosh)
    cameras = load_cameras_json(found["cameras_json"]) if found["cameras_json"] else []
    floor = None
    if found["vr_json"] and not args.no_floor:
        floor = load_vr_config(found["vr_json"])
        log.info("applying floor transform from %s", found["vr_json"])
    log.info("scene: %d splats, SH degree %d; cameras.json: %s",
             scene.num_gaussians, scene.sh_degree, found["cameras_json"])
    return scene, cameras, floor, found


def _make_camera(args, cameras, floor):
    from splatapult_jax.core import transforms as T
    from splatapult_jax.render import Camera

    if args.camera_index is not None:
        if not cameras:
            sys.exit("no cameras.json discovered for --camera-index")
        info = cameras[args.camera_index]
        cam = Camera.from_fov(info.cam_to_world, fovy=float(info.fov[1]),
                              width=args.width, height=args.height,
                              near=args.near, far=args.far)
    else:
        eye = args.eye
        if eye is None:
            if cameras:
                # default viewpoint: first trainer camera position
                eye = cameras[0].position.tolist()
            else:
                eye = [0.0, 0.5, 2.5]
        cam_to_world = T.look_at(eye=eye, target=args.target, up=args.up)
        cam = Camera.from_fov(cam_to_world, fovy=np.deg2rad(args.fovy),
                              width=args.width, height=args.height,
                              near=args.near, far=args.far)
    if floor is not None and args.camera_index is None and args.eye is None:
        # saved VR viewpoint: the floorMat composes onto a stage-space camera
        # exactly like the carpet matrix (ref: src/app.cpp:578)
        cam = cam.with_floor_transform(np.asarray(floor, np.float32))
    return cam


def _maybe_overlay(img, args, cameras, cam):
    if not args.show_cameras or not cameras:
        return img
    from splatapult_jax.utils.overlay import camera_overlay_lines, draw_lines

    segs = camera_overlay_lines(cameras)
    return draw_lines(img, segs, np.asarray(cam.cam_to_world), np.asarray(cam.proj),
                      args.width, args.height)


def cmd_render(args):
    from splatapult_jax.render import render
    from splatapult_jax.utils.image import save_png

    scene, cameras, floor, _ = _load_scene_and_assets(args)
    cam = _make_camera(args, cameras, floor)
    cfg = _config(args, forward_only=True)
    t0 = time.time()
    if args.stereo:
        # the VR stereo pair (ref: src/xrbuddy.cpp:1689-1800), written side by
        # side; the tile binning is built ONCE and shared across both eyes the
        # way the reference shares its per-frame sort (ref: src/app.cpp:
        # 603-607) — see splatapult_jax/stereo.py for the exactness argument
        if args.show_cameras:
            log.warning("--show-cameras is not drawn on --stereo renders")
        # Default: per-eye rendering. Shared union binning (the lift of the
        # reference's sort-once-render-twice trick) inflates the instance
        # capacity ~45% (the union rects) and every capacity-proportional
        # cost with it; it remains available (exactness-tested) behind
        # --shared-bins.
        tan = getattr(args, "eye_tan_angles", None)
        shared_ok = args.shared_bins and tan is None and args.supersample == 1 and (
            args.pipeline == "tiled"
            or (args.pipeline == "auto" and scene.num_gaussians >= 4096)
        )
        if shared_ok:
            from splatapult_jax.stereo import calibrate_config_stereo, render_stereo

            # the shared binning needs the UNION demand of both eyes
            cfg = calibrate_config_stereo(scene, cam, cfg, args.ipd)
            pair = render_stereo(scene, cam, cfg, args.ipd)
        else:
            if args.shared_bins:
                log.info("stereo: per-eye render path (shared binning needs "
                         "the tiled pipeline, supersample 1 and symmetric "
                         "frusta)")
            from splatapult_jax.render import render_batch

            tan_pair = None if tan is None else np.asarray(tan, np.float32).reshape(2, 4)
            pair = render_batch(
                scene,
                cam.stereo_pair(args.ipd, tan_angles=tan_pair,
                                near=args.near, far=args.far),
                cfg)
        img = np.concatenate([np.asarray(pair[0]), np.asarray(pair[1])], axis=1)
    else:
        img = np.asarray(render(scene, cam, cfg))
    log.info("rendered %dx%d in %.2fs (incl. compile)",
             img.shape[1], img.shape[0], time.time() - t0)
    if not args.stereo:
        img = _maybe_overlay(img, args, cameras, cam)
    save_png(args.output, img, srgb_encode=args.srgb)
    print(f"wrote {args.output}")


def cmd_path(args):
    import jax.numpy as jnp

    from splatapult_jax.render import Camera, render_batch
    from splatapult_jax.utils.image import save_png

    scene, cameras, floor, _ = _load_scene_and_assets(args)
    if not cameras:
        sys.exit("path rendering needs a discoverable cameras.json")
    cameras = cameras[:: args.every]
    cfg = _config(args, forward_only=True)
    mats, projs = [], []
    from splatapult_jax.render import Camera as Cam

    for info in cameras:
        c = Cam.from_fov(info.cam_to_world, fovy=float(info.fov[1]),
                         width=args.width, height=args.height,
                         near=args.near, far=args.far)
        mats.append(c.cam_to_world)
        projs.append(c.proj)
    batch = Camera(cam_to_world=jnp.stack(mats), proj=jnp.stack(projs))
    t0 = time.time()
    if args.batch:
        imgs = np.asarray(render_batch(scene, batch, cfg))
    else:
        from splatapult_jax.render import render

        imgs = np.stack(
            [np.asarray(render(scene, Camera(cam_to_world=m, proj=p), cfg))
             for m, p in zip(mats, projs)]
        )
    log.info("rendered %d views in %.2fs", len(cameras), time.time() - t0)
    stem = args.output[:-4] if args.output.endswith(".png") else args.output
    for i, img in enumerate(imgs):
        save_png(f"{stem}_{i:04d}.png", img, srgb_encode=args.srgb)
    print(f"wrote {len(imgs)} frames to {stem}_*.png")


def cmd_points(args):
    from splatapult_jax.io.points import load_point_ply, points_as_gaussians
    from splatapult_jax.render import render
    from splatapult_jax.utils.image import save_png

    pts = load_point_ply(args.ply, use_linear_colors=args.srgb)
    scene = points_as_gaussians(pts, world_radius=args.point_size)
    cam = _make_camera(args, [], None)
    cfg = _config(args)
    img = np.asarray(render(scene, cam, cfg))
    save_png(args.output, img, srgb_encode=args.srgb)
    print(f"wrote {args.output} ({pts.num_points} points)")


def cmd_export(args):
    from splatapult_jax.io.gaussians import load_gaussian_ply, prune_splats, save_gaussian_ply

    scene = load_gaussian_ply(args.ply, use_full_sh=not args.nosh)
    if args.prune:
        scene = prune_splats(scene, origin=args.prune_origin, num_splats=args.prune)
        print(f"pruned to nearest {scene.num_gaussians} splats")
    save_gaussian_ply(args.output, scene, export_full_sh=not args.nosh)
    print(f"wrote {args.output}")


def cmd_bench(args):
    """Frame time on the LOADED scene (the reference's vsync-off FPS counter,
    ref: src/sdl_main.cpp:126-127,157-164): host clock around
    block_until_ready, median of --iters renders after a compiling one."""
    import jax

    from splatapult_jax.render import apply_profile, calibrate_config, profile_name, render

    scene, cameras, floor, _ = _load_scene_and_assets(args)
    cam = _make_camera(args, cameras, floor)
    cfg = _config(args, forward_only=True)
    if args.profile != "custom":
        cfg = apply_profile(cfg, args.profile)
    cfg = calibrate_config(scene, cam, cfg)
    log.info("auto capacity: %.2f instance slots per splat",
             cfg.max_instance_mult)
    runner = jax.jit(lambda s, c: render(s, c, cfg))
    jax.block_until_ready(runner(scene, cam))
    times = []
    for _ in range(max(args.iters, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(runner(scene, cam))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    dev = jax.devices()[0]
    print(json.dumps({
        "splats": int(scene.num_gaussians), "width": args.width, "height": args.height,
        "ms_per_frame": dt * 1e3, "fps": 1.0 / dt,
        "pixels_per_s": args.width * args.height / dt,
        # which precision profile this measured
        "profile": profile_name(cfg),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


def _orbit_rig(scene, n_views, width, height, fovy, near=0.1, far=1000.0):
    """Deterministic orbit camera batch around the scene centroid (the rig
    `fit --orbit` uses; tests render targets with the same rig)."""
    import jax.numpy as jnp

    from splatapult_jax.core import transforms as T
    from splatapult_jax.render import Camera

    means = np.asarray(scene.means)
    center = means.mean(0)
    radius = max(float(np.percentile(
        np.linalg.norm(means - center, axis=1), 90)) * 2.2, 1e-3)
    mats, projs = [], []
    for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        eye = center + radius * np.asarray(
            [np.cos(a), 0.35, np.sin(a)], np.float32)
        c = Camera.from_fov(
            T.look_at(eye=eye.tolist(), target=center.tolist(),
                      up=[0.0, 1.0, 0.0]),
            fovy=fovy, width=width, height=height, near=near, far=far)
        mats.append(c.cam_to_world)
        projs.append(c.proj)
    return Camera(cam_to_world=jnp.stack(mats), proj=jnp.stack(projs))


def cmd_fit(args):
    """Optimize the scene against target images: the trainer-side loop the
    reference only consumes the output of (ref README.md:70-83 — "generate
    the .ply with the INRIA trainer"; here the framework IS a trainer).
    Targets are PNGs in sorted-glob order; cameras come from a discovered
    cameras.json (same convention as `path`) or a generated orbit rig."""
    import glob as globlib

    import jax.numpy as jnp

    from splatapult_jax.io.gaussians import save_gaussian_ply
    from splatapult_jax.render import Camera
    from splatapult_jax.utils.image import load_png

    scene, cameras, floor, _ = _load_scene_and_assets(args)
    if floor is not None:
        from splatapult_jax.render import with_floor_transform

        scene = with_floor_transform(scene, floor)
    paths = sorted(globlib.glob(args.targets))
    if not paths:
        sys.exit(f"no target images match --targets {args.targets!r}")
    raw = [load_png(p) for p in paths]
    h, w = raw[0].shape[:2]
    t4 = []
    for p, t in zip(paths, raw):
        if t.shape[:2] != (h, w):
            sys.exit(f"target {p} is {t.shape[1]}x{t.shape[0]}, "
                     f"expected {w}x{h} (all targets must match)")
        if t.ndim == 2:
            t = np.repeat(t[..., None], 3, axis=-1)
        if t.shape[-1] == 3:
            # RGB PNGs fit against alpha = 1 (opaque full-frame capture);
            # RGBA PNGs (save_png keep_alpha) carry their own coverage
            t = np.concatenate([t, np.ones_like(t[..., :1])], axis=-1)
        t4.append(t.astype(np.float32))
    targets = jnp.asarray(np.stack(t4))

    args.width, args.height = w, h
    cfg = _config(args)
    if cfg.pipeline == "auto":
        import dataclasses as _dc

        cfg = _dc.replace(cfg, pipeline="tiled")

    if cameras and not args.orbit:
        if len(cameras) < len(paths):
            sys.exit(f"{len(paths)} targets but only {len(cameras)} cameras "
                     f"in cameras.json")
        mats, projs = [], []
        for info in cameras[: len(paths)]:
            c = Camera.from_fov(info.cam_to_world, fovy=float(info.fov[1]),
                                width=w, height=h, near=args.near, far=args.far)
            mats.append(c.cam_to_world)
            projs.append(c.proj)
        batch = Camera(cam_to_world=jnp.stack(mats), proj=jnp.stack(projs))
    else:
        batch = _orbit_rig(scene, len(paths), w, h,
                           fovy=np.deg2rad(args.fovy),
                           near=args.near, far=args.far)
        if not cameras and not args.orbit:
            log.warning("no cameras.json discovered: fitting against a "
                        "generated orbit rig (pass --orbit to silence)")

    from splatapult_jax.render import calibrate_config

    cfg = calibrate_config(scene, batch, cfg)
    t0 = time.time()
    if args.adaptive:
        from splatapult_jax.densify import DensifyConfig, fit_scene_adaptive

        scene, losses, events = fit_scene_adaptive(
            scene, batch, targets, cfg, steps=args.steps,
            densify_every=args.densify_every, learning_rate=args.lr,
            densify=DensifyConfig(max_splats=args.max_splats))
    else:
        from splatapult_jax.train import fit_scene

        scene, losses = fit_scene(scene, batch, targets, cfg,
                                  steps=args.steps, learning_rate=args.lr)
        events = []
    dt = time.time() - t0
    save_gaussian_ply(args.output, scene)
    print(json.dumps({
        "steps": args.steps, "views": len(paths),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "splats": scene.num_gaussians, "densify_events": events,
        "seconds": round(dt, 2), "output": args.output,
    }))


def cmd_save_pose(args):
    """Persist a viewpoint as <ply>_vr.json — the reference's Return-key pose
    save (ref: src/app.cpp:700-732): on desktop it stores the camera matrix
    lowered by 1.5 m as the scene's floor transform, auto-applied on the next
    launch (ref: src/app.cpp:443-461)."""
    from splatapult_jax.io.configs import discover_scene, load_cameras_json, save_vr_config

    # configs only — the splat payload is irrelevant to a 4x4 pose write
    found = discover_scene(args.ply)
    cameras = load_cameras_json(found["cameras_json"]) if found["cameras_json"] else []
    # the reference saves the LIVE world-space camera; composing an already-
    # saved floor transform in would compound on every save, so none is applied
    cam = _make_camera(args, cameras, floor=None)
    floor_mat = np.array(cam.cam_to_world)
    # desktop save: floorMat = cameraMat translated 1.5 m down its own up axis
    # (ref: src/app.cpp:713-721)
    floor_mat[:3, 3] -= args.eye_height * floor_mat[:3, 1]
    out = args.output or (os.path.splitext(args.ply)[0] + "_vr.json")
    save_vr_config(out, floor_mat)
    print(f"wrote {out}")


def cmd_synth(args):
    """Generate a procedural scene .ply — the debug cloud (ref:
    GaussianCloud::InitDebugCloud, src/gaussiancloud.cpp:505-578) or the
    garden-scale capture stand-in (io/synth.py; BASELINE config 3)."""
    from splatapult_jax.io.gaussians import make_debug_scene, save_gaussian_ply

    if args.kind == "debug":
        scene = make_debug_scene()
    else:
        from splatapult_jax.io.synth import make_garden_scene

        scene = make_garden_scene(args.splats, seed=args.seed)
    save_gaussian_ply(args.output, scene)
    print(f"wrote {args.output} ({scene.num_gaussians} splats, "
          f"SH degree {scene.sh_degree})")


def cmd_info(args):
    from splatapult_jax.io.configs import discover_scene, load_cameras_json
    from splatapult_jax.io.gaussians import load_gaussian_ply

    found = discover_scene(args.ply)
    scene = load_gaussian_ply(args.ply)
    print(f"splats:      {scene.num_gaussians}")
    print(f"sh degree:   {scene.sh_degree}")
    means = np.asarray(scene.means)
    print(f"bounds min:  {means.min(axis=0)}")
    print(f"bounds max:  {means.max(axis=0)}")
    for key in ("cameras_json", "vr_json", "input_ply"):
        print(f"{key + ':':13s}{found[key]}")
    if found["cameras_json"]:
        from splatapult_jax.io.configs import estimate_floor_plane

        cams = load_cameras_json(found["cameras_json"])
        print(f"cameras:     {len(cams)}")
        # mean-camera-up floor estimate, the pose fallback the reference uses
        # when no <ply>_vr.json exists (ref: src/camerasconfig.cpp:69-95,
        # src/app.cpp:463-504)
        normal, point = estimate_floor_plane(cams)
        print(f"floor est.:  normal {np.round(normal, 3)} point {np.round(point, 3)}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="splatapult_jax", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one view to PNG")
    _add_common(p)
    p.add_argument("--stereo", action="store_true",
                   help="render an L/R eye pair side by side (the VR stereo "
                        "analog, ref src/xrbuddy.cpp:1689-1800)")
    p.add_argument("--ipd", type=float, default=0.064,
                   help="interpupillary distance in meters for --stereo")
    p.add_argument("--shared-bins", action="store_true",
                   help="bin once for both eyes (stereo.render_stereo; "
                        "exact; whether it beats per-eye rendering on the "
                        "GPU is not measured yet)")
    p.add_argument("--eye-tan-angles", type=float, nargs=8, default=None,
                   metavar=("L_LEFT", "L_RIGHT", "L_UP", "L_DOWN",
                            "R_LEFT", "R_RIGHT", "R_UP", "R_DOWN"),
                   help="per-eye asymmetric frustum tangents for --stereo, "
                        "as an HMD runtime reports them (tan of the "
                        "left/right/up/down half-angles per eye; left/down "
                        "negative) — the reference's per-eye "
                        "XrViewConfiguration projections (src/xrbuddy.cpp:"
                        "1802-1832 -> util.cpp:412-480). Renders per-eye "
                        "(asymmetric frusta differ between eyes, so shared "
                        "binning does not apply)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("path", help="render every cameras.json view")
    _add_common(p)
    p.add_argument("--every", type=int, default=1, help="use every k-th camera")
    p.add_argument("--batch", action="store_true", help="vmap the whole batch at once")
    p.set_defaults(fn=cmd_path)

    p = sub.add_parser("points", help="render an SfM point cloud")
    _add_common(p)
    p.add_argument("--point-size", type=float, default=0.01)
    p.set_defaults(fn=cmd_points)

    p = sub.add_parser("export", help="round-trip a scene back to .ply")
    p.add_argument("ply")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--nosh", action="store_true")
    p.add_argument("--prune", type=int, default=0, help="keep nearest N splats")
    p.add_argument("--prune-origin", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("-d", "--debug", action="store_true")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("bench", help="frame-rate benchmark on a .ply scene")
    p.add_argument("--profile", default="exact",
                   choices=("exact", "production", "custom"),
                   help="precision profile: exact = library defaults (f32 "
                        "depth key/colors/grad sort, no early stop), "
                        "production = bench.py's training profile (depth20 "
                        "+ packed colors + early-stop 1e-4 + bf16 grad "
                        "sort; per-knob error contracts in PERF.md), "
                        "custom = take the individual flags as given. The "
                        "JSON output tags which profile actually ran")
    _add_common(p)
    p.add_argument("--iters", type=int, default=20)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("fit", help="optimize the scene against target PNGs "
                                   "(trainer loop; optional adaptive "
                                   "densification)")
    _add_common(p)
    p.add_argument("--targets", required=True,
                   help="glob of target PNGs, sorted order = camera order")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--adaptive", action="store_true",
                   help="INRIA-style adaptive density control "
                        "(densify.py clone/split/prune)")
    p.add_argument("--densify-every", type=int, default=100)
    p.add_argument("--max-splats", type=int, default=8_000_000)
    p.add_argument("--orbit", action="store_true",
                   help="ignore cameras.json and fit against a generated "
                        "orbit rig (one view per target, same order "
                        "targets were rendered in). The rig derives from "
                        "the INPUT scene's centroid/extent, so targets "
                        "must have been rendered with the same rig "
                        "geometry (_orbit_rig) for poses to align")
    p.set_defaults(fn=cmd_fit, output="fitted.ply")

    p = sub.add_parser(
        "save-pose",
        help="save a viewpoint as <ply>_vr.json (the reference's Return-key "
             "pose save, ref src/app.cpp:700-732)")
    _add_common(p)
    p.add_argument("--eye-height", type=float, default=1.5,
                   help="meters the floor sits below the camera (ref 1.5)")
    # -o default becomes <ply>_vr.json (the common default is a .png)
    p.set_defaults(fn=cmd_save_pose, output=None)

    p = sub.add_parser("synth", help="generate a procedural scene .ply "
                                     "(debug cloud or garden-scale stand-in)")
    p.add_argument("kind", choices=["debug", "garden"])
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--splats", type=int, default=1_500_000,
                   help="garden splat count (BASELINE config 3: ~1.5M)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-d", "--debug", action="store_true")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("info", help="print scene info + discovered configs")
    p.add_argument("ply")
    p.add_argument("-d", "--debug", action="store_true")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    from splatapult_jax.utils.cache import enable_compile_cache

    enable_compile_cache()
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "debug", False) else logging.WARNING,
        format="%(levelname).1s %(name)s: %(message)s",
    )
    if getattr(args, "debug", False):
        log.setLevel(logging.DEBUG)
    else:
        log.setLevel(logging.INFO)
    args.fn(args)


if __name__ == "__main__":
    main()
