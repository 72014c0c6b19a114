"""Golden-image regression: renders of the fixtures must stay stable
(SURVEY.md section 4 item 6). Goldens are committed as .npy (+ a PNG to look
at); regenerate with `python tests/test_golden.py regen` after an intentional
image change. The fixture scene's golden comes from the float64 oracle
(reference/raster.py), not from the code under test."""

import os
import sys

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _fixture_case():
    """(scene, camera, config) of the 16-splat fixture golden."""
    from fixture_data import make_test_scene

    from splatapult_jax.core import transforms as T
    from splatapult_jax.render import Camera, RenderConfig

    cam = Camera.from_fov(
        T.look_at(eye=[0.0, 0.5, 2.5], target=[0, 0, 0], up=[0, 1, 0]),
        fovy=np.pi / 4, width=128, height=128,
    )
    cfg = RenderConfig(width=128, height=128, pipeline="global", block_size=16)
    return make_test_scene(), cam, cfg


def _oracle_cases():
    from splatapult_jax.reference.raster import reference_render

    scene, cam, cfg = _fixture_case()
    return {"test_ply_global": reference_render(
        scene.means, scene.sh, scene.opacities, scene.log_scales, scene.quats,
        np.asarray(cam.cam_to_world), np.asarray(cam.proj), cfg.width,
        cfg.height)}


def _render_cases():
    from splatapult_jax.core import transforms as T
    from splatapult_jax.io.gaussians import make_debug_scene
    from splatapult_jax.render import Camera, RenderConfig, render

    scene, cam, cfg = _fixture_case()
    cases = {"test_ply_global": np.asarray(render(scene, cam, cfg))}

    cfg_t = RenderConfig(width=128, height=128, pipeline="tiled", tile_size=16,
                         tile_block=8, max_instance_mult=24)
    cases["debug_tiled"] = np.asarray(
        render(
            make_debug_scene(),
            Camera.from_fov(
                T.look_at(eye=[1.2, 1.1, 1.3], target=[0.3, 0.3, 0.3], up=[0, 1, 0]),
                fovy=np.pi / 4, width=128, height=128,
            ),
            cfg_t,
        )
    )

    # garden stand-in (BASELINE config 3 statistics, io/synth.py) at a
    # CI-friendly scale; the full 1.5M/1080p render of the SAME generator
    # through the CLI is the committed doc artifact tests/golden/garden_*.png
    from splatapult_jax.io.synth import garden_cameras, make_garden_scene

    gcam = garden_cameras(1, width=320, height_px=192)
    gcfg = RenderConfig(width=320, height=192, pipeline="tiled", tile_size=16,
                        tile_block=8, max_instance_mult=8)
    cases["garden_40k_tiled"] = np.asarray(
        render(make_garden_scene(40_000, seed=0), gcam, gcfg))
    return cases


def _save_goldens():
    from splatapult_jax.utils.image import save_png

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    cases = {**_render_cases(), **_oracle_cases()}
    for name, img in cases.items():
        path = os.path.join(GOLDEN_DIR, name + ".npy")
        # skip cases whose stored golden still matches within the test
        # tolerance: regenerating for ONE new case must not churn every
        # committed golden with sub-tolerance float noise (misleading diffs)
        if os.path.exists(path):
            want = np.load(path).astype(np.float32)
            if want.shape == img.shape and np.allclose(img, want, atol=3e-3):
                print(f"  {name}: unchanged within tolerance, kept")
                continue
        np.save(path, img.astype(np.float16))
        save_png(os.path.join(GOLDEN_DIR, name + ".png"), img)  # human-checkable
        print(f"  {name}: rewritten")
    print(f"wrote goldens to {GOLDEN_DIR}")


def test_golden_images():
    cases = _render_cases()
    for name, img in cases.items():
        path = os.path.join(GOLDEN_DIR, name + ".npy")
        assert os.path.exists(path), f"golden {name} missing — run tests/test_golden.py regen"
        want = np.load(path).astype(np.float32)
        # f16 storage + cross-platform float noise tolerance
        np.testing.assert_allclose(img, want, atol=3e-3, err_msg=name)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path[:0] = [here, os.path.dirname(here)]
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")
        _save_goldens()
