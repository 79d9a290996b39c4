"""The downscale of textures above MAX_TEXTURE_DIM (host side, numpy).

The reference package resizes such an image with Pillow's default
`Image.resize` (toyrenderer_tpu/scene/textures.py:133-136); this is that
resize of an RGBA image, bit for bit:

1. premultiply: each colour channel becomes c * a / 255 rounded as
   Pillow's MULDIV255 ((t >> 8) + t) >> 8 with t = c * a + 128;
2. a separable bicubic filter (a = -0.5) whose support widens with the
   scale (2 x in / out source pixels each side), its weights normalised
   in double precision and then rounded to 22-bit fixed point; the
   horizontal pass first, over the source rows the vertical pass reads,
   each output the weighted integer sum plus one half, shifted down and
   clamped to 0..255;
3. unpremultiply: c * 255 // a, clamped, where 0 < a < 255.
"""

from __future__ import annotations

import math

import numpy as np

MAX_TEXTURE_DIM = 1024
_PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0                     # the bicubic filter's support


def target_size(w: int, h: int, max_dim: int = MAX_TEXTURE_DIM):
    """(width, height) the reference resizes a w x h image to: scaled so
    its larger side is max_dim, each side truncated, at least 1."""
    scale = max(w, h) / max_dim
    if scale <= 1.0:
        return w, h
    return max(int(w / scale), 1), max(int(h / scale), 1)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """(first source index (out,) i64, fixed-point weights (out, k) i64,
    k): the filter taps of each output sample, as Pillow's
    precompute_coeffs and normalize_coeffs_8bpc make them."""
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    xmax = xmax - xmin
    taps = np.arange(ksize)
    w = _bicubic(((xmin[:, None] + taps[None]).astype(np.float64)
                  - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    # Pillow sums the weights left to right; so does a row-wise cumsum
    ww = np.cumsum(w, 1)[:, -1:]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    scaled = w * (1 << _PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, -0.5 + scaled, 0.5 + scaled))
    return xmin, kk.astype(np.int64), xmax, ksize


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass(img: np.ndarray, xmin, kk, xmax, axis: int) -> np.ndarray:
    """One pass over `axis` (1: columns, 0: rows) of (H, W, 4) u8."""
    n_in = img.shape[axis]
    acc = np.full((len(xmin),) + tuple(
        s for i, s in enumerate(img.shape) if i != axis),
        1 << (_PRECISION_BITS - 1), np.int64)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    for t in range(kk.shape[1]):
        idx = np.minimum(xmin + t, n_in - 1)
        k = np.where(t < xmax, kk[:, t], 0)
        acc += src[idx] * k.reshape((-1,) + (1,) * (src.ndim - 1))
    return np.moveaxis(_clip8(acc), 0, axis)


def premultiply(img: np.ndarray) -> np.ndarray:
    """RGBA -> premultiplied RGBa (Pillow's rgbA2rgba)."""
    c = img[..., :3].astype(np.uint32)
    t = c * img[..., 3:4].astype(np.uint32) + 128
    out = img.copy()
    out[..., :3] = (((t >> 8) + t) >> 8).astype(np.uint8)
    return out


def unpremultiply(img: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA (Pillow's rgba2rgbA): c * 255 // a, clamped, where
    0 < a < 255; the colour as it is elsewhere."""
    a = img[..., 3:4].astype(np.uint32)
    part = (a > 0) & (a < 255)
    c = img[..., :3].astype(np.uint32)
    div = np.minimum(c * 255 // np.where(part, a, 1), 255)
    out = img.copy()
    out[..., :3] = np.where(part, div, c).astype(np.uint8)
    return out


def resize_rgba(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, 4) u8 RGBA -> (h, w, 4): Pillow's default resize (see the
    module docstring)."""
    src_h, src_w = img.shape[:2]
    x = premultiply(np.ascontiguousarray(img, np.uint8))
    ymin, ky, ymax, _ = _coeffs(src_h, h)
    first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
    if w != src_w:
        xmin, kx, xmax, _ = _coeffs(src_w, w)
        x = _pass(x[first:last], xmin, kx, xmax, 1)
        ymin = ymin - first
    if h != src_h:
        x = _pass(x, ymin, ky, ymax, 0)
    return unpremultiply(x)
