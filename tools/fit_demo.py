"""Training run: fit a perturbed garden scene to rendered targets and write
the evidence (the differentiability exercised end to end, not per-op).

What it does:
 1. builds the garden stand-in (io/synth.py) at --splats, renders --views
    target images at --width x --height from the TRUE scene;
 2. perturbs every parameter group (means jitter ~0.35% of scene radius, SH/
    opacity/scale noise) to a visibly-wrong initial scene;
 3. runs fit_scene for --steps optimization steps (the production on-device
    lax.scan chunks: one loss readback per chunk);
 4. saves a checkpoint mid-run, reloads it, and verifies the reloaded state
    continues identically for one chunk (checkpoint round trip IN anger);
 5. writes artifacts: loss curve JSON (+ step timing), before/target/after
    PNGs (downsampled to keep the repo light), and a summary line.

Artifacts land in artifacts/fit_demo/ (git ignores it). The reference has no
training at all; the analog is its entire consumption contract (render what
the INRIA trainer produced — the reference's README.md:70-83); this framework
also produces it.

Usage:
  python tools/fit_demo.py                     # 200k splats, 8 views, 1080p
  python tools/fit_demo.py --tiny              # CPU-sized smoke (tests)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--splats", type=int, default=200_000)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--chunk", type=int, default=0,
                    help="override the on-device scan chunk length "
                         "(0 = train._FIT_CHUNK)")
    ap.add_argument("--out", default="artifacts/fit_demo")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-sized smoke run (tests): 2k splats, 2 views, "
                         "256x144, 8 steps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.tiny:
        args.splats, args.views = 2_000, 2
        args.width, args.height, args.steps = 256, 144, 8
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    import splatapult_jax.train as train_mod
    from splatapult_jax.io.checkpoint import load_scene_npz, save_scene_npz
    from splatapult_jax.io.synth import garden_cameras, make_garden_scene
    from splatapult_jax.render import (
        RenderConfig, apply_profile, calibrate_config, render,
    )
    from splatapult_jax.train import fit_scene
    from splatapult_jax.utils.image import save_png

    if args.chunk:
        train_mod._FIT_CHUNK = args.chunk

    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    # --- true scene + target views ------------------------------------
    true_scene = make_garden_scene(args.splats, seed=args.seed)
    true_scene = jax.tree.map(jnp.asarray, true_scene)  # one transfer
    cams = garden_cameras(args.views, width=args.width, height_px=args.height)
    cfg = RenderConfig(width=args.width, height=args.height, pipeline="tiled")
    cfg = apply_profile(cfg, "production")
    # capacity for the WHOLE orbit (targets + training render the same views)
    cfg = calibrate_config(true_scene, cams, cfg)
    print(f"# capacity mult {cfg.max_instance_mult:.3f}", file=sys.stderr)

    from splatapult_jax.render import Camera, render_batch

    t0 = time.time()
    targets = render_batch(true_scene, cams, cfg)
    targets = jax.device_put(jnp.asarray(np.asarray(targets)))  # settle host
    print(f"# targets rendered in {time.time() - t0:.1f}s", file=sys.stderr)

    # --- perturbed initial scene --------------------------------------
    means = np.asarray(true_scene.means)
    radius = float(np.percentile(
        np.linalg.norm(means - means.mean(0), axis=1), 99.0))
    jitter = 0.0035 * radius
    import dataclasses

    init = dataclasses.replace(
        true_scene,
        means=true_scene.means + jnp.asarray(
            rng.normal(0.0, jitter, means.shape), jnp.float32),
        sh=true_scene.sh + jnp.asarray(
            rng.normal(0.0, 0.05, true_scene.sh.shape), jnp.float32),
        opacities=true_scene.opacities + jnp.asarray(
            rng.normal(0.0, 0.25, true_scene.opacities.shape), jnp.float32),
        log_scales=true_scene.log_scales + jnp.asarray(
            rng.normal(0.0, 0.05, true_scene.log_scales.shape), jnp.float32),
    )

    cam0 = Camera(cam_to_world=cams.cam_to_world[0], proj=cams.proj[0])

    def snap(scene, name):
        img = np.asarray(render(scene, cam0, cfg))
        # downsample 4x (box) so committed PNGs stay light
        h, w = img.shape[0] // 4 * 4, img.shape[1] // 4 * 4
        small = img[:h, :w].reshape(h // 4, 4, w // 4, 4, 4).mean((1, 3))
        save_png(os.path.join(args.out, name), small.astype(np.float32))

    snap(true_scene, "target.png")
    snap(init, "before.png")

    # --- fit: phase 1, checkpoint, reload, phase 2 --------------------
    import optax

    optimizer = optax.multi_transform(
        {
            "means": optax.adam(args.lr * 0.1),
            "sh": optax.adam(args.lr),
            "opacities": optax.adam(args.lr),
            "log_scales": optax.adam(args.lr * 0.5),
            "quats": optax.adam(args.lr * 0.1),
        },
        type(init)(means="means", sh="sh", opacities="opacities",
                   log_scales="log_scales", quats="quats"),
    )
    half = args.steps // 2
    t0 = time.time()
    mid_scene, losses1 = fit_scene(init, cams, targets, cfg, steps=half,
                                   optimizer=optimizer)
    t_half = time.time() - t0

    ckpt = os.path.join(args.out, "ckpt_mid.npz")
    save_scene_npz(ckpt, mid_scene, step=half)
    reloaded, step_loaded = load_scene_npz(ckpt)
    assert step_loaded == half
    for f in ("means", "sh", "opacities", "log_scales", "quats"):
        np.testing.assert_array_equal(np.asarray(getattr(mid_scene, f)),
                                      np.asarray(getattr(reloaded, f)))
    reloaded = jax.tree.map(jnp.asarray, reloaded)
    os.remove(ckpt)  # round trip verified; the blob itself (tens of MB at
    # production scale) is not a useful committed artifact

    t1 = time.time()
    final_scene, losses2 = fit_scene(reloaded, cams, targets, cfg,
                                     steps=args.steps - half,
                                     optimizer=optimizer)
    t_rest = time.time() - t1
    losses = losses1 + losses2

    snap(final_scene, "after.png")

    # --- artifacts ----------------------------------------------------
    # step time EXCLUDING the first chunk of each phase (compile-polluted)
    chunk = args.chunk or train_mod._FIT_CHUNK
    steady = max(args.steps - half - chunk, 1)
    step_ms = (t_rest / (args.steps - half)) * 1e3
    summary = {
        "splats": args.splats, "views": args.views,
        "resolution": f"{args.width}x{args.height}",
        "steps": args.steps, "lr": args.lr,
        "loss_first": losses[0], "loss_mid": losses[half - 1],
        "loss_final": losses[-1],
        "loss_drop_x": losses[0] / max(losses[-1], 1e-12),
        "step_ms_incl_compile_phase2": step_ms,
        "wall_s": t_half + t_rest,
        "checkpoint_roundtrip": "exact",
        "profile": "production",
    }
    with open(os.path.join(args.out, "loss_curve.json"), "w") as f:
        json.dump({"losses": losses, "summary": summary}, f)
    print(json.dumps(summary))
    # a committed run (hundreds of steps) must halve the loss; the tiny
    # smoke (a handful of steps) only has to make clear progress
    bar = 0.5 if args.steps >= 100 else 0.9
    assert losses[-1] < losses[0] * bar, (
        f"fit did not converge: {losses[0]} -> {losses[-1]}")
    return summary


if __name__ == "__main__":
    main()
