"""The port's baseline JPEG decoder (scene/jpeg.py) against Pillow, on
files Pillow's encoder writes here: bit-equal throughout (Pillow decodes
with libjpeg-turbo: islow IDCT, fancy upsampling, fixed-point YCbCr).

* Colour at 4:4:4, 4:2:2 and 4:2:0, quality 50 and 95, at sizes that are
  and are not multiples of the MCU; grey; restart markers (DRI, a
  restart every 3 MCUs).
* Pillow's colour handling of three components: without a JFIF marker,
  an Adobe APP14 marker with transform 0 (RGB: no conversion) and with
  transform 1 (YCbCr), and component ids 'R', 'G', 'B' (RGB).
* Pillow's progressive and CMYK JPEGs, bit-equal through the decoder
  and the texture loader (tests/test_torch_jpeg_modes.py holds every
  other kind); a truncated file raises JpegError, and the texture
  loader leaves it missing and counts it, as the reference leaves it.
* The loader's whole path on a JPEG above MAX_TEXTURE_DIM: decoded and
  downscaled as the reference's Pillow path does.
"""

import io
import struct

import numpy as np
import pytest

from toyrenderer_tpu_torch.scene import textures as TT
from toyrenderer_tpu_torch.scene.gltf import GltfTexture
from toyrenderer_tpu_torch.scene.jpeg import JpegError, decode_jpeg

Image = pytest.importorskip("PIL.Image")


def _picture(h, w, seed=0, ch=3):
    """Smooth gradients under noise: every block has AC terms."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0) * 100 + 128, np.cos(y / 5.0) * 100 + 128,
                     ((x + y) % 64) * 4.0], -1)
    img = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def _encode(img, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))


@pytest.mark.parametrize("size", [(64, 64), (37, 53), (129, 250)],
                         ids=["mcu-multiple", "small-odd", "wide-odd"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_colour_jpeg_matches_pil(subsampling, quality, size):
    raw = _encode(_picture(*size, seed=quality), quality=quality,
                  subsampling=subsampling)
    np.testing.assert_array_equal(decode_jpeg(raw), _pil(raw))


def test_grey_and_restart_jpeg_match_pil():
    raw = _encode(_picture(77, 91, ch=1), quality=80)
    np.testing.assert_array_equal(decode_jpeg(raw), _pil(raw))
    raw = _encode(_picture(100, 120, seed=3), quality=80, subsampling=2,
                  restart_marker_blocks=3)
    assert b"\xff\xdd" in raw and b"\xff\xd0" in raw
    np.testing.assert_array_equal(decode_jpeg(raw), _pil(raw))


def _without_jfif(raw: bytes, extra: bytes = b"", ids=None) -> bytes:
    """The file without its JFIF APP0 segment, `extra` segments after
    SOI, and the frame's and the scan's component ids replaced by `ids`."""
    out, pos = [b"\xff\xd8", extra], 2
    while True:
        m = raw[pos + 1]
        n = struct.unpack(">H", raw[pos + 2:pos + 4])[0]
        seg = bytearray(raw[pos:pos + 2 + n])
        if ids is not None and m == 0xC0:
            for k, cid in enumerate(ids):
                seg[4 + 6 + 3 * k] = cid
        if ids is not None and m == 0xDA:
            for k, cid in enumerate(ids):
                seg[4 + 1 + 2 * k] = cid
        if m != 0xE0:
            out.append(bytes(seg))
        pos += 2 + n
        if m == 0xDA:
            return b"".join(out) + raw[pos:]


def _adobe(transform: int) -> bytes:
    p = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
    return b"\xff\xee" + struct.pack(">H", len(p) + 2) + p


@pytest.mark.parametrize("variant", ["adobe-rgb", "adobe-ycc", "ids-rgb"])
def test_colour_space_markers_match_pil(variant):
    raw = _encode(_picture(40, 56, seed=5), quality=85, subsampling=0)
    if variant == "ids-rgb":
        raw = _without_jfif(raw, ids=(82, 71, 66))
        assert Image.open(io.BytesIO(raw)).getbands() == ("R", "G", "B")
    else:
        raw = _without_jfif(raw, _adobe(0 if variant == "adobe-rgb" else 1))
    want = _pil(raw)
    np.testing.assert_array_equal(decode_jpeg(raw), want)


def test_unported_and_corrupt_jpegs():
    img = _picture(48, 48, seed=7)
    for raw in (_encode(img, progressive=True),
                _encode(img, mode="CMYK")):
        want = _pil(raw)
        np.testing.assert_array_equal(decode_jpeg(raw), want)
        np.testing.assert_array_equal(
            TT._decode_image(GltfTexture(uri=None, image_bytes=raw)), want)
    cut = _encode(img)[:300]
    with pytest.raises(JpegError):
        decode_jpeg(cut)
    with pytest.raises(OSError):                  # the reference: missing
        _pil(cut)
    before = len(TT.decode_failures)
    with pytest.warns(UserWarning, match="not decoded"):
        assert TT._decode_image(GltfTexture(uri=None, image_bytes=cut)) is None
    assert len(TT.decode_failures) == before + 1


def test_loader_downscales_large_jpeg():
    raw = _encode(_picture(700, 1100, seed=2), quality=90)
    pil = Image.open(io.BytesIO(raw)).convert("RGBA")
    scale = max(pil.size) / 1024
    want = np.asarray(pil.resize((max(int(pil.size[0] / scale), 1),
                                  max(int(pil.size[1] / scale), 1))))
    got = TT._decode_image(GltfTexture(uri=None, image_bytes=raw))
    np.testing.assert_array_equal(got, want)
