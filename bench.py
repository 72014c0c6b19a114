"""Benchmark: fwd+bwd tiled splat rendering throughput on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Metric (BASELINE.json): rays/s (= pixels/s) per chip, forward+backward, 1080p.
The reference publishes no numbers (BASELINE.md); ``vs_baseline`` is therefore
normalized against the interactive rate its design implies on desktop GPU —
60 FPS at its default 1024x768 window (src/sdl_main.cpp:72-73, fps counter
sdl_main.cpp:157-164) = 47.2 Mpixel/s, *forward only*. We report forward+
backward pixels/s against that bar.
"""

import argparse
import json
import os
import time

import numpy as np

REFERENCE_PIXELS_PER_S = 60.0 * 1024 * 768  # implied interactive rate, fwd-only


def make_scene(num_splats: int, seed: int = 0):
    """Uniform random ball of splats (``--scene ball``)."""
    import jax.numpy as jnp

    from splatapult_jax.io.gaussians import GaussianScene

    rng = np.random.default_rng(seed)
    quats = rng.standard_normal((num_splats, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    means = rng.standard_normal((num_splats, 3)).astype(np.float32)
    means *= (rng.uniform(0, 1, (num_splats, 1)) ** (1 / 3)) / np.maximum(
        np.linalg.norm(means, axis=1, keepdims=True), 1e-6
    )
    return GaussianScene(
        means=jnp.asarray(means * 2.0),
        sh=jnp.asarray(rng.standard_normal((num_splats, 3, 16)) * 0.3, jnp.float32),
        opacities=jnp.asarray(rng.uniform(-2.0, 3.0, (num_splats,)), jnp.float32),
        log_scales=jnp.asarray(rng.uniform(-6.5, -4.5, (num_splats, 3)), jnp.float32),
        quats=jnp.asarray(quats),
    )


def make_bench_scene(kind: str, num_splats: int, seed: int = 0):
    if kind == "ball":
        return make_scene(num_splats, seed)
    from splatapult_jax.io.synth import make_garden_scene

    # BASELINE config 3: Mip-NeRF-360-garden-class capture stand-in
    # (trained-scene statistics; io/synth.py documents how)
    return make_garden_scene(num_splats, seed)


_BENCH_OPT = None  # one optax object per process: make_zero_fit_steps caches by identity


def _median_s(fn, args, iters: int) -> float:
    """Median host-clock seconds of ``fn(*args)`` to block_until_ready on
    its whole output, after one compiling warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_mesh(args, scene, config):
    """Scaling-efficiency harness (BASELINE configs 4-5, BASELINE.md: >=85%
    rays/s efficiency 1 -> N). Times the full SPMD train step (render + loss
    + backward + cross-chip grad psum, parallel/mesh.py) on a 1-chip mesh and
    an N-chip tile mesh with the same total work, and reports
    efficiency = (rate_N / N) / rate_1.

    Wall-clock is only meaningful on N real devices; on the virtual CPU mesh
    (--mesh-platform cpu) the harness runs end to end as a rehearsal."""
    import json
    import time

    import jax
    import jax.numpy as jnp

    from splatapult_jax.io.synth import garden_cameras
    from splatapult_jax.parallel.mesh import (
        _sharded_value_and_grad, make_render_mesh, shard_targets,
    )

    n_dev = len(jax.devices())
    n = args.mesh
    if n_dev < n:
        raise SystemExit(
            f"--mesh {n} needs {n} devices, found {n_dev}. For a mechanism "
            f"check without hardware: --mesh-platform cpu (virtual devices)."
        )
    views = max(args.views, 1)
    cam = garden_cameras(views, width=args.width, height_px=args.height)
    if views == 1:
        from splatapult_jax.render import Camera

        cam = Camera(cam_to_world=cam.cam_to_world[None], proj=cam.proj[None])

    rates = {}
    mults = {}
    for shards in (1, n):
        mesh = make_render_mesh(num_tile_shards=shards, num_view_shards=1,
                                devices=jax.devices()[:shards])
        cfg = config
        if shards > 1 and getattr(args, "instance_mult", 1.0) <= 0.0:
            # band-aware capacity for the sharded arm: each chip's instance
            # sort runs at ~1/D of the full-view rows instead of full-view
            # capacity. The 1-chip arm keeps the
            # full-view calibration — each arm at its own best config is
            # the honest efficiency comparison.
            from splatapult_jax.parallel.mesh import calibrate_config_sharded

            cfg = calibrate_config_sharded(scene, cam, config, mesh)
            if args.verbose:
                import sys

                print(f"# mesh={shards}: band-calibrated mult "
                      f"{cfg.max_instance_mult:.3f} (full-view was "
                      f"{config.max_instance_mult:.3f})", file=sys.stderr)
        mults[shards] = cfg.max_instance_mult
        targets = shard_targets(
            jnp.zeros((views, args.height, args.width, 4), jnp.float32),
            cfg, mesh)

        allreduce = getattr(args, "allreduce", "psum")
        shard_prepare = getattr(args, "shard_prepare", True)
        param_shard = getattr(args, "param_shard", False)

        if param_shard:
            # ZeRO arm: the FULL config-5 step (fwd + bwd + sharded optax
            # update, no grad all-reduce) as make_zero_fit_steps compiles
            # it, one step per call. Both shard counts run the same program
            # shape, so the efficiency ratio stays like-for-like.
            import optax

            from splatapult_jax.parallel.mesh import (
                make_zero_fit_steps, pad_scene_to_mesh,
            )

            opt = _BENCH_OPT if _BENCH_OPT is not None else optax.adam(1e-3)
            globals()["_BENCH_OPT"] = opt
            padded, true_n = pad_scene_to_mesh(scene, mesh)
            opt_state = opt.init(padded)
            sh_k = int(scene.sh.shape[-1])

            fit = make_zero_fit_steps(cfg, mesh, opt, 1, true_n, sh_k)
            dt = _median_s(jax.jit(fit), (padded, cam, targets, opt_state),
                           args.iters)
            rates[shards] = args.width * args.height * views / dt
            if args.verbose:
                import sys

                print(f"# mesh={shards} (zero): {dt * 1e3:.2f} ms/step, "
                      f"{rates[shards] / 1e6:.2f} Mpx/s", file=sys.stderr)
            continue

        def step(s, c, t, cfg=cfg, mesh=mesh):
            return _sharded_value_and_grad(
                s, c, t, cfg, mesh, grad_allreduce=allreduce,
                shard_prepare=shard_prepare)

        dt = _median_s(jax.jit(step), (scene, cam, targets), args.iters)
        rates[shards] = args.width * args.height * views / dt
        if args.verbose:
            import sys

            print(f"# mesh={shards}: {dt * 1e3:.2f} ms/step, "
                  f"{rates[shards] / 1e6:.2f} Mpx/s", file=sys.stderr)

    eff = (rates[n] / n) / rates[1]
    print(json.dumps({
        "metric": f"rays/s scaling efficiency 1->{n} chips fwd+bwd",
        "value": eff,
        "unit": "ratio",
        "vs_baseline": eff / 0.85,  # BASELINE.md: >=85% efficiency bar
        "rate_1chip_px_s": rates[1],
        f"rate_{n}chip_px_s": rates[n],
        "allreduce": allreduce,
        "shard_prepare": shard_prepare,
        "param_shard": getattr(args, "param_shard", False),
        "instance_mult_1chip": mults[1],
        f"instance_mult_{n}chip": mults[n],
    }))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--scene", default="both", choices=("garden", "ball", "both"),
        help="garden = BASELINE config 3's trained-capture stand-in "
             "(io/synth.py); ball = a uniform random ball; both (default) "
             "= measure both and print ONE JSON line: the garden result "
             "carrying the ball-1M result as a nested field",
    )
    parser.add_argument("--splats", type=int, default=1_500_000,
                        help="config 3 names ~1.5M splats")
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument("--fwd-only", action="store_true")
    parser.add_argument(
        "--mesh", type=int, default=0,
        help="scaling-efficiency harness (BASELINE configs 4-5): run the "
             "SPMD train step over an N-way tile mesh AND over 1 chip, "
             "report per-chip pixels/s and efficiency. Meaningful numbers "
             "need N real devices; --mesh-platform cpu rehearses the "
             "mechanism on a virtual CPU mesh.",
    )
    parser.add_argument(
        "--shard-prepare", action=argparse.BooleanOptionalAction, default=True,
        help="for --mesh: shard the O(N) projection/SH over the tile axis "
             "(each device prepares N/D splats + one 56 B/splat all-gather) "
             "instead of replicating it; --no-shard-prepare for "
             "the replicated A/B arm",
    )
    parser.add_argument(
        "--param-shard", action="store_true",
        help="for --mesh: time the ZeRO parameter-sharded full train step "
             "(make_zero_fit_steps: sharded params + optax, NO grad "
             "all-reduce) instead of the replicated value_and_grad step",
    )
    parser.add_argument(
        "--allreduce", default="psum", choices=("psum", "ring"),
        help="gradient all-reduce flavor for --mesh: monolithic in-backward "
             "psum, or the explicit ppermute ring whose 2(D-1) independent "
             "collectives the latency-hiding scheduler can overlap with "
             "backward compute",
    )
    parser.add_argument(
        "--views", type=int, default=1,
        help="camera-batch size (BASELINE config 4 analog): vmap over a "
             "circular camera path; throughput counts all views' pixels",
    )
    parser.add_argument(
        "--instance-mult", type=float, default=0.0,
        help="instance-buffer capacity as a multiple of N; 0 (default) "
             "auto-calibrates from the measured instance demand of the bench "
             "view(s) + 6%% headroom (the analog of the reference's "
             "radix-workgroup auto-tuner, src/app.cpp:843-874); overflow is "
             "reported, not silent",
    )
    parser.add_argument("--tile-size", type=int, default=16)
    parser.add_argument("--tile-block", type=int, default=16)
    parser.add_argument(
        "--sort-bands", type=int, default=1,
        help="split the pipeline into K interleaved tile-row bands, each "
             "binning/sorting/compositing at ~1/K capacity (exact; "
             "RenderConfig.sort_bands)",
    )
    parser.add_argument(
        "--depth-bits", type=int, default=0, choices=(0, 16, 20, 32),
        help="depth precision in the instance sort key (0 = auto: the 20-bit "
             "packed key — one sort operand fewer at ~2.4e-4 relative depth "
             "precision; 32 = exact f32 ordering; 16 = the coarser bf16 key)",
    )
    # The bench's default profile is the production-training configuration:
    # two documented, test-covered precision knobs are ON (the library's
    # RenderConfig defaults keep both OFF, i.e. exact f32). Ablations and
    # measured error bounds in PERF.md; disable to measure the exact path.
    parser.add_argument(
        "--grad-sort-dtype", default="bfloat16", choices=("float32", "bfloat16"),
        help="dtype per-instance grads ride through the backward transpose "
             "sort (bf16 halves that sort's bytes; per-splat sums stay f32; "
             "grads within ~0.4%% of peak — float32 for the exact path)",
    )
    parser.add_argument(
        "--packed-colors", action=argparse.BooleanOptionalAction, default=True,
        help="pack splat RGB as 16-bit fixed point (max color error 1.2e-4) "
             "so feature rows shrink to 32 B "
             "(--no-packed-colors for exact f32 colors)",
    )
    parser.add_argument(
        "--packed-feats16", action="store_true",
        help="quantize whole instance feature rows to 16 B (committed error "
             "bounds in tests/test_tiled.py)",
    )
    parser.add_argument(
        "--early-stop", type=float, default=1e-4,
        help="skip blocks once a tile's max transmittance falls below this "
             "(0 = exact; 1e-4 is the standard 3DGS termination threshold)",
    )
    parser.add_argument(
        "--mesh-platform", default="default", choices=("default", "cpu"),
        help="cpu: force the CPU host platform with --mesh virtual devices "
             "(mechanism check for the scaling harness without GPUs)",
    )
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args()

    import jax

    from splatapult_jax.utils.cache import enable_compile_cache

    if args.mesh and args.mesh_platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={args.mesh}"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{jax.default_backend()!r} (--mesh-platform cpu "
                         f"rehearses the mesh harness on virtual devices)")
    enable_compile_cache()

    import jax.numpy as jnp

    if args.scene == "both" and not args.mesh:
        # both scenes, ONE JSON line: the garden result carrying the
        # ball-1M result as a nested field
        ball = _bench_scene_run(args, "ball", 1_000_000)
        garden = _bench_scene_run(args, "garden", args.splats)
        garden["series_ball_1m"] = ball
        print(json.dumps(garden))
        return
    kind = "garden" if args.scene == "both" else args.scene

    scene = make_bench_scene(kind, args.splats)
    # the garden generator returns HOST numpy arrays; without an explicit
    # device_put every timed call would re-transfer the ~350 MB scene
    scene = jax.tree.map(jnp.asarray, scene)
    config = _make_config(args)
    cam = _make_cameras(args, kind)
    if args.instance_mult <= 0.0:
        config = _calibrated(args, scene, cam, config)

    if args.mesh:
        bench_mesh(args, scene, config)
        return
    print(json.dumps(_timed_run(args, kind, scene, cam, config)))


def _make_cameras(args, kind):
    import jax.numpy as jnp
    import numpy as np

    from splatapult_jax.core import transforms as T
    from splatapult_jax.render import Camera

    if kind == "garden":
        from splatapult_jax.io.synth import garden_cameras

        cam = garden_cameras(args.views, width=args.width, height_px=args.height)
    elif args.views > 1:
        cams = [
            Camera.from_fov(
                T.look_at(eye=[np.cos(a) * 4.5, 0.8, np.sin(a) * 4.5],
                          target=[0, 0, 0], up=[0, 1, 0]),
                fovy=np.pi / 4, width=args.width, height=args.height,
            )
            for a in np.linspace(0, 2 * np.pi, args.views, endpoint=False)
        ]
        cam = Camera(
            cam_to_world=jnp.stack([c.cam_to_world for c in cams]),
            proj=jnp.stack([c.proj for c in cams]),
        )
    else:
        cam = Camera.from_fov(
            T.look_at(eye=[0.0, 0.8, 4.5], target=[0, 0, 0], up=[0, 1, 0]),
            fovy=np.pi / 4, width=args.width, height=args.height,
        )
    return cam


def _make_config(args):
    from splatapult_jax.render import RenderConfig

    # production profile: the 20-bit packed depth key (one sort operand +
    # one comparison key fewer at ~2.4e-4 relative depth precision — finer
    # than the reference's shipped 32-bit linear key for near content,
    # shader/presort_compute.glsl:52-53). Exact f32 ordering is one flag
    # away (--depth-bits 32).
    depth_bits = args.depth_bits or 20
    return RenderConfig(
        width=args.width, height=args.height, pipeline="tiled",
        tile_size=args.tile_size, tile_block=args.tile_block,
        max_instance_mult=args.instance_mult,
        early_stop_eps=args.early_stop,
        grad_sort_dtype=args.grad_sort_dtype,
        packed_colors=args.packed_colors,
        packed_feats16=args.packed_feats16,
        forward_only=args.fwd_only,
        sort_bands=args.sort_bands,
        depth_bits=depth_bits,
    )


def _calibrated(args, scene, cam, config):
    """Capacity from the measured demand of the bench view(s)
    (render.calibrate_config). bucket=1.0: the bench measures fixed views,
    so the exact demand-fit capacity is the right measurement (the
    geometric bucketing exists to share compiles across a camera SWEEP)."""
    from splatapult_jax.render import calibrate_config

    config = calibrate_config(scene, cam, config, bucket=1.0)
    if args.verbose:
        import sys

        print(f"# auto capacity: mult {config.max_instance_mult:.3f} "
              f"(exact fit, 6% headroom)", file=sys.stderr)
    return config


def _bench_scene_run(args, kind, splats):
    """Build + time one scene; returns the tagged result dict."""
    import jax
    import jax.numpy as jnp

    a = argparse.Namespace(**vars(args))
    a.splats = splats
    scene = make_bench_scene(kind, splats)
    scene = jax.tree.map(jnp.asarray, scene)  # garden returns host numpy
    config = _make_config(a)
    cam = _make_cameras(a, kind)
    if a.instance_mult <= 0.0:
        config = _calibrated(a, scene, cam, config)
    return _timed_run(a, kind, scene, cam, config)


def _timed_run(args, kind, scene, cam, config):
    import jax
    import jax.numpy as jnp

    from splatapult_jax.render import render, render_batch

    # Timing: host clock around block_until_ready on the step's whole output
    # (image, or loss and every gradient leaf), after a warm-up run that
    # compiles; the median of --iters runs.
    k = args.iters

    render_fn = render if args.views == 1 else render_batch

    if args.fwd_only:
        def one_step(s, c, eps):
            img = render_fn(
                GaussianScene(
                    means=s.means + eps, sh=s.sh, opacities=s.opacities,
                    log_scales=s.log_scales, quats=s.quats,
                ),
                c, config,
            )
            return img
    elif args.views > 1:
        # the production multi-view fwd+bwd structure (train._train_step_impl):
        # a lax.scan of per-view value_and_grad into carried gradient sums —
        # same math as differentiating through the view batch
        from splatapult_jax.render import Camera, render

        def view_loss(s, cam_mat, proj):
            img = render(s, Camera(cam_to_world=cam_mat, proj=proj), config)
            return jnp.mean(img ** 2)

        vg = jax.value_and_grad(view_loss)

        def one_step(s, c, eps):
            sp = GaussianScene(
                means=s.means + eps, sh=s.sh, opacities=s.opacities,
                log_scales=s.log_scales, quats=s.quats,
            )

            def body(carry, xs):
                al, ag = carry
                cm, pj = xs
                l, g = vg(sp, cm, pj)
                return (al + l, jax.tree.map(jnp.add, ag, g)), None

            zero = jax.tree.map(jnp.zeros_like, sp)
            (ls, gs), _ = jax.lax.scan(
                body, (jnp.float32(0.0), zero), (c.cam_to_world, c.proj))
            return ls, gs
    else:
        def loss(s, c):
            return jnp.mean(render_fn(s, c, config) ** 2)

        grad_loss = jax.value_and_grad(loss)

        def one_step(s, c, eps):
            val, grads = grad_loss(
                GaussianScene(
                    means=s.means + eps, sh=s.sh, opacities=s.opacities,
                    log_scales=s.log_scales, quats=s.quats,
                ),
                c,
            )
            return val, grads  # every gradient leaf is live

    from splatapult_jax.io.gaussians import GaussianScene

    runner = jax.jit(one_step)
    call = (scene, cam, jnp.float32(0.0))
    t0 = time.time()
    jax.block_until_ready(runner(*call))
    compile_s = time.time() - t0
    for _ in range(max(args.warmup, 0)):
        jax.block_until_ready(runner(*call))
    dt = _median_s(runner, call, k)

    pixels = args.width * args.height * args.views
    value = pixels / dt
    if args.verbose:
        import sys

        print(
            f"# compile={compile_s:.1f}s step={dt * 1e3:.2f}ms (median of "
            f"{k}) "
            f"splats={args.splats} {args.width}x{args.height} views={args.views} "
            f"mode={'fwd' if args.fwd_only else 'fwd+bwd'} scene={kind}",
            file=sys.stderr,
        )
    from splatapult_jax.render import profile_name

    return {
        "metric": "pixels/s per chip fwd+bwd 1080p"
        if not args.fwd_only
        else "pixels/s per chip fwd 1080p",
        "value": value,
        "unit": "pixels/s",
        "vs_baseline": value / REFERENCE_PIXELS_PER_S,
        "scene": kind,
        "splats": args.splats,
        "step_ms": dt * 1e3,
        "compile_s": compile_s,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        # which precision profile ran (this and the CLI bench both tag it)
        "profile": profile_name(config),
        "packed_feats16": config.packed_feats16,
        "sort_bands": getattr(config, "sort_bands", 1),
    }


if __name__ == "__main__":
    main()
