"""PNG I/O parity tests (ref: src/core/image.cpp:104-158)."""

import numpy as np

from splatapult_jax.utils.image import composite_to_rgb, load_png, save_png


def _random_premult_rgba(rng, h=7, w=5):
    alpha = rng.uniform(0.0, 1.0, (h, w, 1)).astype(np.float32)
    rgb = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32) * alpha
    return np.concatenate([rgb, alpha], axis=-1)


def test_load_png_premultiplies_rgba(tmp_path, rng):
    """Round-trip: premultiplied render output -> straight-alpha PNG ->
    load_png returns the premultiplied values again (the reference
    premultiplies on load, src/core/image.cpp:128-158)."""
    img = _random_premult_rgba(rng)
    path = str(tmp_path / "premult.png")
    save_png(path, img, keep_alpha=True)  # un-premultiplies for the file
    back = load_png(path)  # default premultiply=True re-multiplies
    assert back.shape == img.shape
    # 8-bit quantization of both the un-premultiplied color and alpha:
    # r_back = round(r/a * 255)/255 * round(a * 255)/255
    a_q = np.round(img[..., 3:] * 255.0) / 255.0
    tol = (1.0 / 255.0) * (a_q + 1.0) / 2.0 + 1e-6
    assert np.all(np.abs(back[..., 3:] - img[..., 3:]) <= 1.0 / 255.0)
    assert np.all(np.abs(back[..., :3] - img[..., :3]) <= tol + 1.0 / 255.0)


def test_load_png_no_premultiply_and_flip(tmp_path, rng):
    img = _random_premult_rgba(rng)
    path = str(tmp_path / "straight.png")
    save_png(path, img, keep_alpha=True)
    straight = load_png(path, premultiply=False)
    premult = load_png(path, premultiply=True)
    # premultiplied = straight * alpha, channel-exact
    np.testing.assert_allclose(
        premult[..., :3], straight[..., :3] * straight[..., 3:], atol=1e-6
    )
    # flip reverses rows (the reference's bottom-up copy, image.cpp:110)
    flipped = load_png(path, premultiply=False, flip=True)
    np.testing.assert_array_equal(flipped, straight[::-1])


def test_load_png_rgb_untouched(tmp_path, rng):
    rgb = rng.uniform(0.0, 1.0, (4, 6, 3)).astype(np.float32)
    path = str(tmp_path / "rgb.png")
    save_png(path, rgb)
    back = load_png(path)  # premultiply is a no-op without alpha
    assert back.shape == (4, 6, 3)
    assert np.all(np.abs(back - np.clip(rgb, 0, 1)) <= 1.0 / 255.0)


def test_composite_to_rgb_background():
    img = np.zeros((2, 2, 4), np.float32)
    img[..., 3] = 0.25  # quarter-covered black splat
    out = composite_to_rgb(img, background=(1.0, 1.0, 1.0))
    np.testing.assert_allclose(out, 0.75, atol=1e-6)
