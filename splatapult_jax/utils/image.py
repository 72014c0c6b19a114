"""PNG image I/O for render outputs.

Replaces the reference's libpng loader/off-screen resolve (ref:
src/core/image.cpp:22-158, src/app.cpp:166-212): premultiplied-alpha handling,
optional linear -> sRGB encode on write, straight-alpha PNG output.

The PNG codec is a small stdlib (zlib/struct) one: 8-bit writes; reads of
non-interlaced grey, grey+alpha, RGB, RGBA and palette images at 8 bits, and
grey/RGB(A) at 16 bits.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples/px


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_png(path: str, pixels: np.ndarray) -> None:
    """[H, W, 3|4] uint8 -> an 8-bit RGB/RGBA PNG (filter 0 on every row)."""
    h, w, c = pixels.shape
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), pixels.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> [H, stride] uint8."""
    rows = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, cur = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 1:  # sub: a running sum along x per byte lane
            cur = cur.reshape(-1, bpp).cumsum(axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # up
            cur = (cur + prev) & 0xFF
        elif ftype == 3:  # average
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _read_png(path: str) -> np.ndarray:
    """PNG -> [H, W, C] uint8/uint16 samples (palette images expand to RGB(A))."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, trns, hdr = 8, [], None, None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    c = _CHANNELS[ctype]
    bpp = c * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        return px.view(">u2").reshape(h, w, c).astype(np.uint16)
    px = px.reshape(h, w, c)
    if ctype == 3:
        rgb = palette[px[..., 0]]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[: len(trns)] = trns
        return np.concatenate([rgb, alpha[px[..., 0]][..., None]], axis=-1)
    return px


def composite_to_rgb(img, background=None, srgb_encode: bool = False):
    """[H, W, 4] premultiplied RGBA -> [H, W, 3] uint8-ready floats in [0, 1].

    ``background`` (RGB) is composited under the image the way the GL
    framebuffer clear color sits under the blended splats.
    """
    img = np.asarray(img, np.float32)
    rgb = img[..., :3]
    alpha = img[..., 3:4]
    if background is not None:
        bg = np.asarray(background, np.float32).reshape(1, 1, 3)
        rgb = rgb + (1.0 - alpha) * bg
    if srgb_encode:
        rgb = np.where(
            rgb <= 0.0031308,
            rgb * 12.92,
            1.055 * np.power(np.clip(rgb, 1e-12, None), 1.0 / 2.4) - 0.055,
        )
    return np.clip(rgb, 0.0, 1.0)


def save_png(path: str, img, background=(0.0, 0.0, 0.0), srgb_encode: bool = False,
             keep_alpha: bool = False) -> None:
    """Write [H, W, 4] premultiplied RGBA (or [H, W, 3] RGB) to a PNG."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[-1] == 4 and keep_alpha:
        alpha = np.clip(img[..., 3], 0.0, 1.0)
        # un-premultiply for straight-alpha PNG
        rgb = np.clip(img[..., :3] / np.maximum(alpha[..., None], 1e-6), 0.0, 1.0)
        if srgb_encode:
            rgb = composite_to_rgb(
                np.concatenate([rgb, np.ones_like(alpha)[..., None]], -1),
                srgb_encode=True,
            )
        out = np.concatenate([rgb, alpha[..., None]], axis=-1)
        _write_png(path, (out * 255.0 + 0.5).astype(np.uint8))
        return
    if img.shape[-1] == 4:
        rgb = composite_to_rgb(img, background=background, srgb_encode=srgb_encode)
    else:
        rgb = np.clip(img, 0.0, 1.0)
    _write_png(path, (rgb * 255.0 + 0.5).astype(np.uint8))


def load_png(path: str, premultiply: bool = True, flip: bool = False) -> np.ndarray:
    """PNG -> [H, W, C] float32 in [0, 1].

    Parity with the reference loader (ref: src/core/image.cpp:104-158):

    - ``premultiply``: images with an alpha channel (RGBA or LA) get their
      color channels multiplied by alpha (ref Image::MultiplyAlpha,
      src/core/image.cpp:128-158) — the renderer composites and fits against
      *premultiplied* RGBA, so PNG targets must enter in the same space.
      No-op for alpha-less images.
    - ``flip``: the reference copies rows bottom-up because GL textures have
      row 0 at the bottom (src/core/image.cpp:110). This framework's images
      are row-0-top throughout, so the default keeps the file's top-down
      order; pass flip=True for GL-ordered consumers.
    """
    px = _read_png(path)
    img = px.astype(np.float32) / (65535.0 if px.dtype == np.uint16 else 255.0)
    if img.shape[-1] == 1:
        img = img[..., 0]
    if flip:
        img = img[::-1].copy()
    if premultiply and img.ndim == 3 and img.shape[-1] in (2, 4):
        img = np.concatenate(
            [img[..., :-1] * img[..., -1:], img[..., -1:]], axis=-1
        )
    return img
