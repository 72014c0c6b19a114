#!/usr/bin/env python3
"""Smoke test of the main path on one GPU, through the normal entry points.

    python chip_smoke.py            # phases (a)-(e) on one card
    python chip_smoke.py --mesh4    # only the 4-card ZeRO fit vs one card

(a) device: a GPU is present; its kind, name and power limit.
(b) the Triton composite kernels against the plain jnp version at the
    garden stand-in's real widths (1.5M splats, SH degree 3, 1920x1080,
    calibrated capacity), for the exact and the production profile.
(c) oracle: the tiled GPU render of a 3000-splat garden at 256x256 against
    the float64 reference rasterizer.
(d) viewer: ``cli synth garden`` writes the 1.5M-splat PLY, ``cli render``
    draws it at 1920x1080 (forward only).
(e) trainer: 4 orbit targets rendered from that PLY, a perturbed copy,
    ``cli fit --orbit --steps 10``: loss finite and falling, parameters finite.

One process owns the card. No phase's failure is caught: any failure exits
non-zero. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

# forward rows of two differently fused paths: the 1/256 cutoff flips
# isolated pixels, so a small max and a tiny mean (f32 storage)
FWD_MAX, FWD_MEAN = 5e-3, 2e-5
GRAD_REL_L2 = 1e-3  # per-instance gradient columns, per column (f32)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".smoke_out")


def card_line() -> str:
    """nvidia-smi's name and power limit, read in a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


class Log:
    def __init__(self, kind: str):
        self.kind = kind
        self.t0 = time.time()

    def __call__(self, msg: str):
        print(f"[{self.kind} +{time.time() - self.t0:6.1f}s] {msg}", flush=True)


def timed_ms(fn, *args, reps: int = 5) -> float:
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phase_kernels(log, scene, cam, w=1920, h=1080):
    """(b) kernels vs plain at the garden shape, two row layouts."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax import lax

    from splatapult_jax.ops import composite as C
    from splatapult_jax.ops.binning import bin_splats
    from splatapult_jax.ops.tiled import _grid_from_config, pack_features
    from splatapult_jax.render import (
        RenderConfig, apply_profile, calibrate_config, prepare_splats)

    n = scene.means.shape[0]
    for profile in ("exact", "production"):
        cfg = apply_profile(RenderConfig(width=w, height=h, pipeline="tiled"),
                            profile)
        cfg = calibrate_config(scene, cam, cfg)
        grid = _grid_from_config(cfg, n)

        @jax.jit
        def setup(scene, cam, cfg=cfg, grid=grid):
            sp = prepare_splats(scene, cam, cfg, sort=False)
            ng = lax.stop_gradient
            bins = bin_splats(ng(sp["mean2d"]), ng(sp["extent"]), grid,
                              depth=ng(sp["depth"]))
            feats = pack_features(sp["mean2d"], sp["conic"], sp["rgb"],
                                  sp["alpha"])
            return jnp.take(C._pack_src(feats, grid), bins["inst_splat"],
                            axis=0), bins

        inst, bins = setup(scene, cam)
        fwd = {"kernel": jax.jit(lambda i, b, g=grid: C._fwd_kernel(i, b, g)),
               "plain": jax.jit(lambda i, b, g=grid: C._fwd_plain(i, b, g))}
        bwd = {"kernel": jax.jit(
                   lambda i, b, o, k, d, g=grid: C._bwd_kernel(i, b, o, k, d, g)),
               "plain": jax.jit(
                   lambda i, b, o, k, d, g=grid: C._bwd_plain(i, b, o, k, d, g))}
        out_k, nd_k = fwd["kernel"](inst, bins)
        out_p, _ = fwd["plain"](inst, bins)
        diff = np.abs(np.asarray(out_k[:, :5], np.float32)
                      - np.asarray(out_p[:, :5], np.float32))
        dout = (jax.random.normal(jax.random.PRNGKey(0), out_k.shape)
                .at[:, 5:].set(0.0) * 1e-3).astype(out_k.dtype)
        d_k = np.asarray(bwd["kernel"](inst, bins, out_k, nd_k, dout))
        d_p = np.asarray(bwd["plain"](inst, bins, out_k, nd_k, dout))
        rel = [float(np.linalg.norm(d_k[i] - d_p[i])
                     / max(np.linalg.norm(d_p[i]), 1e-30)) for i in range(9)]
        log(f"(b) {profile}: tile {grid.tile_size} block {grid.block} mcap "
            f"{grid.mcap} tiles {grid.num_tiles} instances "
            f"{int(np.asarray(bins['tile_count']).sum())}")
        log(f"(b) {profile}: fwd rows max|d| {diff.max():.3e} (<= {FWD_MAX}) "
            f"mean|d| {diff.mean():.3e} (<= {FWD_MEAN}), f32, no matmul")
        log(f"(b) {profile}: bwd columns rel L2 max {max(rel):.3e} "
            f"(<= {GRAD_REL_L2}), f32, no matmul")
        assert diff.max() <= FWD_MAX and diff.mean() <= FWD_MEAN, profile
        assert max(rel) <= GRAD_REL_L2 and np.isfinite(d_k).all(), (profile, rel)
        for impl in ("kernel", "plain"):
            tf = timed_ms(fwd[impl], inst, bins)
            tb = timed_ms(bwd[impl], inst, bins, out_k, nd_k, dout)
            ma = fwd[impl].lower(inst, bins).compile().memory_analysis()
            log(f"(b) {profile}: {impl} fwd {tf:.3f} ms bwd {tb:.3f} ms; fwd "
                f"memory_analysis temp {ma.temp_size_in_bytes} B arg "
                f"{ma.argument_size_in_bytes} B out {ma.output_size_in_bytes} B")
        del inst, bins, out_k, out_p


def phase_oracle(log):
    """(c) tiled GPU render vs the float64 oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from splatapult_jax.io.synth import garden_cameras, make_garden_scene
    from splatapult_jax.reference.raster import reference_render
    from splatapult_jax.render import RenderConfig, render

    scene = jax.tree.map(jnp.asarray, make_garden_scene(3000, seed=0))
    cam = garden_cameras(1, width=256, height_px=256)
    cfg = RenderConfig(width=256, height=256, pipeline="tiled")
    img = np.asarray(render(scene, cam, cfg))
    want = reference_render(
        scene.means, scene.sh, scene.opacities, scene.log_scales, scene.quats,
        np.asarray(cam.cam_to_world), np.asarray(cam.proj), 256, 256)
    d = np.abs(img - want)
    log(f"(c) tiled vs float64 oracle, 3000 splats 256x256: max|d| "
        f"{d.max():.3e} (<= {FWD_MAX}) mean|d| {d.mean():.3e} "
        f"(<= {FWD_MEAN}); coverage {float(want[..., 3].mean()):.3f}")
    assert want[..., 3].max() > 0.5
    assert d.max() <= FWD_MAX and d.mean() <= FWD_MEAN


def run_cli(argv):
    """cli.main in-process -> its standard output."""
    from splatapult_jax import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def phase_viewer(log, ply, n=1_500_000, w=1920, h=1080):
    """(d) cli synth + cli render at 1080p."""
    import numpy as np

    from splatapult_jax.utils.image import load_png

    out = run_cli(["synth", "garden", "-o", ply, "--splats", str(n)])
    log(f"(d) cli synth: {out.strip()} ({os.path.getsize(ply)} B)")
    png = os.path.join(OUT_DIR, "garden.png")
    t0 = time.time()
    run_cli(["render", ply, "-o", png, "--width", str(w), "--height", str(h),
             "--eye", "4.2", "1.6", "0", "--target", "0", "0.8", "0",
             "--pipeline", "tiled"])
    img = load_png(png)
    log(f"(d) cli render {w}x{h}: {time.time() - t0:.1f}s incl. compile; "
        f"png {img.shape} mean {img.mean():.4f}")
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    assert img.mean() > 0.02


def phase_trainer(log, ply, w=1920, h=1080):
    """(e) render 4 orbit targets, perturb, cli fit --orbit --steps 10."""
    import dataclasses

    import numpy as np

    from splatapult_jax.cli import _orbit_rig
    from splatapult_jax.io.gaussians import load_gaussian_ply, save_gaussian_ply
    from splatapult_jax.render import RenderConfig, calibrate_config, render_batch
    from splatapult_jax.utils.image import save_png

    scene = load_gaussian_ply(ply)
    rig = _orbit_rig(scene, 4, w, h, fovy=np.deg2rad(45.0))
    cfg = calibrate_config(scene, rig, RenderConfig(
        width=w, height=h, pipeline="tiled", forward_only=True))
    imgs = np.asarray(render_batch(scene, rig, cfg))
    for i, img in enumerate(imgs):
        save_png(os.path.join(OUT_DIR, f"target_{i}.png"), img, keep_alpha=True)
    rng = np.random.default_rng(0)
    sh = np.asarray(scene.sh).copy()
    sh[:, :, 0] += rng.normal(0.0, 0.3, sh[:, :, 0].shape)
    op = np.asarray(scene.opacities) + rng.normal(0.0, 0.5, sh.shape[0])
    perturbed = os.path.join(OUT_DIR, "perturbed.ply")
    save_gaussian_ply(perturbed, dataclasses.replace(
        scene, sh=sh.astype(np.float32), opacities=op.astype(np.float32)))
    fitted = os.path.join(OUT_DIR, "fitted.ply")
    out = run_cli(["fit", perturbed, "--targets",
                   os.path.join(OUT_DIR, "target_*.png"), "--orbit",
                   "--steps", "10", "-o", fitted])
    res = json.loads(out.strip().splitlines()[-1])
    log(f"(e) cli fit 4 views {w}x{h} 10 steps: loss {res['loss_first']:.6f}"
        f" -> {res['loss_last']:.6f} in {res['seconds']}s incl. compile")
    assert np.isfinite([res["loss_first"], res["loss_last"]]).all()
    assert res["loss_last"] < res["loss_first"]
    got = load_gaussian_ply(fitted)
    leaves = [np.asarray(x) for x in (got.means, got.sh, got.opacities,
                                      got.log_scales, got.quats)]
    assert all(np.isfinite(x).all() for x in leaves)  # finite grads -> finite Adam steps
    moved = float(np.abs(np.asarray(got.sh) - sh).max())
    log(f"(e) fitted parameters finite; max |d sh| {moved:.4f}")
    assert moved > 0.0


def phase_mesh4(log, n=1_500_000, w=1920, h=1080):
    """4-card ZeRO fit_scene vs single-card fit_scene, garden 1080p, 4 views."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from splatapult_jax.io.synth import garden_cameras, make_garden_scene
    from splatapult_jax.parallel.mesh import make_render_mesh
    from splatapult_jax.render import RenderConfig, calibrate_config, render_batch
    from splatapult_jax.train import fit_scene

    lr = 1e-2
    scene = jax.tree.map(jnp.asarray, make_garden_scene(n, seed=0))
    cams = garden_cameras(4, width=w, height_px=h)
    cfg = calibrate_config(scene, cams, RenderConfig(
        width=w, height=h, pipeline="tiled"))
    targets = render_batch(scene, cams, cfg) * 0.9
    one, l1 = fit_scene(scene, cams, targets, cfg, steps=1, learning_rate=lr)
    mesh = make_render_mesh(num_tile_shards=4)
    four, l4 = fit_scene(scene, cams, targets, cfg, steps=1, learning_rate=lr,
                         mesh=mesh, param_shard=True)
    rel = abs(l4[0] - l1[0]) / abs(l1[0])
    log(f"(mesh4) first-step loss 1 card {l1[0]:.8f} 4 cards {l4[0]:.8f} "
        f"rel {rel:.2e} (<= 1e-4)")
    assert np.isfinite(l4[0]) and rel <= 1e-4
    # Adam's first step moves each coordinate by ~lr * sign(g): where g sits
    # at the rounding level, the two summation orders may flip its sign, so
    # a coordinate may differ by up to 2 * lr (x the 0.1 / 0.5 group scales
    # at most 1); all but 1% must agree to a tenth of a step.
    for name in ("means", "sh", "opacities", "log_scales", "quats"):
        a = np.asarray(getattr(four, name))[: np.asarray(getattr(one, name)).shape[0]]
        b = np.asarray(getattr(one, name))
        d = np.abs(a - b)
        frac = float((d > 0.1 * lr).mean())
        log(f"(mesh4) {name}: max|d| {d.max():.3e} (<= {2 * lr}), share "
            f"> {0.1 * lr:.0e}: {frac:.2e} (<= 1e-2), f32")
        assert np.isfinite(a).all() and d.max() <= 2 * lr and frac <= 1e-2, name


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the 4-card ZeRO fit against one card")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    need = 4 if args.mesh4 else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1

    from splatapult_jax.utils.cache import enable_compile_cache

    kind = devices[0].device_kind
    log = Log(kind)
    log(f"(a) device {devices[0].platform} {kind} x{len(devices)}; "
        f"compile cache {enable_compile_cache()}")
    print(card_line(), flush=True)

    if args.mesh4:
        phase_mesh4(log)
    else:
        import jax.numpy as jnp

        from splatapult_jax.io.synth import garden_cameras, make_garden_scene

        scene = jax.tree.map(jnp.asarray, make_garden_scene(1_500_000, seed=0))
        phase_kernels(log, scene, garden_cameras(1, width=1920, height_px=1080))
        del scene
        phase_oracle(log)
        shutil.rmtree(OUT_DIR, ignore_errors=True)
        os.makedirs(OUT_DIR)
        try:
            ply = os.path.join(OUT_DIR, "garden.ply")
            phase_viewer(log, ply)
            phase_trainer(log, ply)
        finally:
            shutil.rmtree(OUT_DIR, ignore_errors=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
