"""The port's PNG decoder (scene/png.py) on every PNG kind, and its
downscale of large textures (scene/resize.py), against Pillow on files
these tests write themselves (the PNGs with tests/test_torch_scene.py's
zlib writer): bit-equal throughout.

* Every legal (colour type, bit depth): grey at 1, 2, 4, 8 and 16 bits,
  RGB at 8 and 16, palette at 1, 2, 4 and 8, grey + alpha and RGBA at 8
  and 16; each plain and Adam7-interlaced, with random samples and all
  five scanline filters; against Pillow's `convert("RGBA")`, which is
  what the reference package's loader returns.
* `tRNS` on grey (at each depth), RGB (8 and 16 bits) and palette images
  (a short alpha table, and indices past the palette), each with a key
  that some pixels match.
* A corrupt file (a bad chunk CRC, truncated data) raises PngError.
* The resize: Pillow's default `Image.resize` of an RGBA image (its
  premultiplied bicubic in fixed point) at 1500x900, 2048x2048 and
  3000x100 with random alpha, to the reference's target size, and the
  loader's whole path (`_decode_image`) on such a PNG.
* The loader on other formats: GIF and BMP (Pillow decodes them, the
  port not yet) raise, naming the ROADMAP item; unknown bytes are a
  missing texture, counted in `textures.decode_failures`.
"""

import io
import struct

import numpy as np
import pytest

from test_torch_scene import _encode_png
from toyrenderer_tpu_torch.scene import resize
from toyrenderer_tpu_torch.scene.png import PngError, decode_png

Image = pytest.importorskip("PIL.Image")

KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pil_rgba(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))


def _samples(rng, ctype, depth, h=19, w=23, n_pal=None):
    hi = (n_pal or (1 << depth)) if ctype == 3 else 1 << depth
    return rng.integers(0, hi, size=(h, w, CHANNELS[ctype])).astype(
        np.uint16 if depth == 16 else np.uint8)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", KINDS,
                         ids=[f"type{c}-{d}bit" for c, d in KINDS])
def test_png_kind_matches_pil(ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    img = _samples(rng, ctype, depth)
    chunks = ()
    if ctype == 3:
        chunks = ((b"PLTE", rng.integers(0, 256, 3 << depth,
                                         dtype=np.uint8).tobytes()),)
    raw = _encode_png(img, [0, 1, 2, 3, 4], ctype, depth, interlace, chunks)
    np.testing.assert_array_equal(decode_png(raw), _pil_rgba(raw))


TRNS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 4),
        (3, 8)]


@pytest.mark.parametrize("ctype,depth", TRNS,
                         ids=[f"type{c}-{d}bit" for c, d in TRNS])
def test_png_trns_matches_pil(ctype, depth):
    rng = np.random.default_rng(ctype * 10 + depth)
    if ctype == 3:
        # a palette shorter than the index range, and a shorter alpha table
        n_pal = (1 << depth) - 3
        img = _samples(rng, 3, depth)
        chunks = ((b"PLTE", rng.integers(0, 256, 3 * n_pal,
                                         dtype=np.uint8).tobytes()),
                  (b"tRNS", rng.integers(0, 256, n_pal // 2,
                                         dtype=np.uint8).tobytes()))
    else:
        # few distinct values, so the key matches some pixels (Pillow
        # compares a 2- or 4-bit key with the scaled grey: 0 is a key
        # that matches)
        levels = rng.integers(0, 1 << depth, 4)
        levels[0] = 0
        img = levels[rng.integers(0, 4, (19, 23, CHANNELS[ctype]))].astype(
            np.uint16 if depth == 16 else np.uint8)
        key = img[3, 5] if depth not in (2, 4) else np.zeros(1, np.uint8)
        chunks = ((b"tRNS", struct.pack(f">{key.size}H",
                                        *(int(k) for k in key))),)
    raw = _encode_png(img, [1, 4], ctype, depth, 0, chunks)
    want = _pil_rgba(raw)
    if ctype != 3 and depth not in (1, 16):
        assert (want[..., 3] == 0).any()
    np.testing.assert_array_equal(decode_png(raw), want)


def test_corrupt_png_raises():
    rng = np.random.default_rng(1)
    raw = bytearray(_encode_png(_samples(rng, 6, 8), [0], 6))
    bad_crc = bytes(raw[:29]) + bytes([raw[29] ^ 1]) + bytes(raw[30:])
    for data in (bad_crc, bytes(raw[:60])):
        with pytest.raises(PngError):
            decode_png(data)


@pytest.mark.parametrize("w,h", [(1500, 900), (2048, 2048), (3000, 100)])
def test_resize_matches_pil(w, h):
    rng = np.random.default_rng(w + h)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    # smooth regions and fully transparent / opaque runs beside the noise
    img[: h // 3, :, 3] = 255
    img[h // 3: h // 2, :, 3] = 0
    img[:, : w // 4, :3] = np.linspace(0, 255, w // 4)[None, :, None].astype(
        np.uint8)
    size = resize.target_size(w, h)
    want = np.asarray(Image.fromarray(img, "RGBA").resize(size))
    got = resize.resize_rgba(img, *size)
    assert got.shape == want.shape == (size[1], size[0], 4)
    np.testing.assert_array_equal(got, want)


def test_loader_downscales_large_png():
    from toyrenderer_tpu_torch.scene.gltf import GltfTexture
    from toyrenderer_tpu_torch.scene.textures import _decode_image
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (1100, 1300, 4), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG")
    raw = buf.getvalue()
    pil = Image.open(io.BytesIO(raw)).convert("RGBA")
    scale = max(pil.size) / 1024
    want = np.asarray(pil.resize((max(int(pil.size[0] / scale), 1),
                                  max(int(pil.size[1] / scale), 1))))
    got = _decode_image(GltfTexture(uri=None, image_bytes=raw))
    np.testing.assert_array_equal(got, want)


def test_loader_other_formats():
    """A format the reference decodes through Pillow and the port does not
    yet (GIF, BMP) raises, naming the ROADMAP item; bytes no decoder
    knows are a missing texture, counted, as the reference leaves them."""
    from toyrenderer_tpu_torch.scene import textures as TT
    from toyrenderer_tpu_torch.scene.gltf import GltfTexture
    img = np.zeros((8, 8, 3), np.uint8)
    for fmt in ("GIF", "BMP"):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format=fmt)
        with pytest.raises(NotImplementedError, match=f"{fmt}.*item 6"):
            TT._decode_image(GltfTexture(uri=None,
                                         image_bytes=buf.getvalue()))
    before = len(TT.decode_failures)
    with pytest.warns(UserWarning, match="not decoded"):
        assert TT._decode_image(GltfTexture(
            uri=None, image_bytes=b"not an image at all")) is None
    assert TT.decode_failures[before:] == ["embedded image (19 bytes)"]
