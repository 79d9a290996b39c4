"""Every kind of JPEG that Pillow decodes, through the port's decoder
(scene/jpeg.py), bit-equal to Pillow's Image.open(...).convert("RGBA")
(libjpeg-turbo 3.1 here), with no tolerance; and the kinds Pillow
refuses, which the port's loader leaves missing and counts, as the
reference's loader (toyrenderer_tpu/scene/textures.py:109-139) leaves
them.

* Pillow's progressive JPEGs at 4:4:4, 4:2:2 and 4:2:0, quality 50 and
  95, sizes that are and are not multiples of the MCU; with restart
  markers; grey; Pillow's CMYK.
* Streams tests/jpeg_streams.py writes from coefficient sets: progressive
  Huffman under libjpeg's default script, spectral selection alone and
  two incomplete scripts (which libjpeg smooths), sequential and
  progressive arithmetic coding (with and without DAC conditioning), at
  h2v1, h2v2, h1v2, h4v1, h4v2, h3v1 and mixed samplings, CMYK and YCCK,
  restarts in every mode.  Each complete one also decodes bit-equal to
  the sequential Huffman stream of the same coefficients (the
  transcoding oracle, independent of Pillow's writer), and
  read_coefficients gives back the coefficients it was written from.
* Lossless streams (predictors 1-7, the point transform, restarts,
  subsampling, grey, RGB, CMYK).
* Refused: 12-bit samples, hierarchical and arithmetic lossless frames,
  non-integral sampling, an MCU of more than 10 blocks, sampling
  factors above 4, a lossless frame that needs a colour conversion.
"""

import io
import struct
from dataclasses import replace

import numpy as np
import pytest

import jpeg_streams as JS
from toyrenderer_tpu.scene import textures as JX
from toyrenderer_tpu.scene.gltf import GltfTexture as JxTexture
from toyrenderer_tpu_torch.scene import textures as TT
from toyrenderer_tpu_torch.scene.gltf import GltfTexture
from toyrenderer_tpu_torch.scene.jpeg import (
    JpegError, decode_jpeg, read_coefficients)

Image = pytest.importorskip("PIL.Image")


def _picture(h, w, seed=0, ch=3):
    """Smooth gradients under noise: every block has AC terms."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7.0) * 100 + 128, np.cos(y / 5.0) * 100 + 128,
                     ((x + y) % 64) * 4.0, np.sin((x - y) / 9.0) * 90 + 120],
                    -1)[..., :ch]
    return np.clip(base + rng.normal(0, 20, (h, w, ch)), 0,
                   255).astype(np.uint8)


def _encode(img, mode=None, **kw) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(img)
    (im.convert(mode) if mode else im).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil(raw: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))


def _same_coefficients(a, b):
    """Equal components and blocks on each component's own grid."""
    assert [(c.id, c.h, c.v) for c in a.components] == [
        (c.id, c.h, c.v) for c in b.components]
    for ca, cb in zip(a.components, b.components):
        np.testing.assert_array_equal(ca.quant, cb.quant)
        np.testing.assert_array_equal(
            ca.blocks[:ca.blocks_high, :ca.blocks_wide],
            cb.blocks[:cb.blocks_high, :cb.blocks_wide])


# -- Pillow's own progressive JPEGs -------------------------------------------

@pytest.mark.parametrize("size", [(64, 64), (37, 53), (129, 250)],
                         ids=["mcu-multiple", "small-odd", "wide-odd"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_pillow_progressive_matches(subsampling, quality, size):
    img = _picture(*size, seed=quality)
    raw = _encode(img, quality=quality, subsampling=subsampling,
                  progressive=True)
    np.testing.assert_array_equal(decode_jpeg(raw), _pil(raw))
    # the same coefficients as Pillow's baseline file of the image
    _same_coefficients(read_coefficients(raw), read_coefficients(
        _encode(img, quality=quality, subsampling=subsampling)))


@pytest.mark.parametrize("variant", ["restart", "grey", "cmyk",
                                     "cmyk-progressive"])
def test_pillow_progressive_variants(variant):
    img = _picture(100, 120, seed=3)
    raw = {"restart": lambda: _encode(img, quality=80, subsampling=2,
                                      progressive=True,
                                      restart_marker_blocks=3),
           "grey": lambda: _encode(img[..., 0], quality=80,
                                   progressive=True),
           "cmyk": lambda: _encode(img, mode="CMYK", quality=80),
           "cmyk-progressive": lambda: _encode(img, mode="CMYK", quality=80,
                                               progressive=True)}[variant]()
    if variant == "restart":
        assert b"\xff\xdd" in raw and b"\xff\xd0" in raw
    np.testing.assert_array_equal(decode_jpeg(raw), _pil(raw))


def test_quantisation_tables_match_pillow():
    raw = _encode(_picture(40, 48, seed=1), quality=63, subsampling=2)
    co = read_coefficients(raw)
    tables = Image.open(io.BytesIO(raw)).quantization   # natural order
    assert [c.table for c in co.components] == [0, 1, 1]
    for c in co.components:
        assert c.quant.tolist() == list(tables[c.table])


# -- streams written from coefficient sets ------------------------------------

SAMPLINGS = {
    "444": [(1, 1)] * 3, "422": [(2, 1), (1, 1), (1, 1)],
    "420": [(2, 2), (1, 1), (1, 1)], "h1v2": [(1, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)], "410": [(4, 2), (1, 1), (1, 1)],
    "h3v1": [(3, 1), (1, 1), (1, 1)], "mixed": [(2, 2), (1, 2), (2, 1)]}
# (coding, progression, complete)
KINDS = {"progressive": ("huffman", "default", True),
         "spectral": ("huffman", "spectral", True),
         "early": ("huffman", "early", False),
         "dc-only": ("huffman", "dc-only", False),
         "arithmetic": ("arithmetic", None, True),
         "progressive-arithmetic": ("arithmetic", "default", True)}


def _check(co, raw, complete: bool):
    """raw bit-equal to Pillow; if its progression is complete, also to
    the sequential Huffman stream of co, with co's coefficients read
    back."""
    got = decode_jpeg(raw)
    np.testing.assert_array_equal(got, _pil(raw))
    if complete:
        base = JS.write(co)
        np.testing.assert_array_equal(got, decode_jpeg(base))
        _same_coefficients(read_coefficients(raw), co)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_written_kinds_match_pillow(sampling, kind):
    coding, progression, complete = KINDS[kind]
    co = JS.coefficients(_picture(45, 61, seed=len(sampling + kind)),
                         SAMPLINGS[sampling], quality=80)
    _check(co, JS.write(co, coding, progression), complete)


@pytest.mark.parametrize("kind", ["huffman", "progressive", "early",
                                  "arithmetic", "progressive-arithmetic",
                                  "arithmetic-dac",
                                  "progressive-arithmetic-dac"])
def test_restarts_in_every_mode(kind):
    co = JS.coefficients(_picture(70, 90, seed=9), SAMPLINGS["420"],
                         quality=90)
    coding = "arithmetic" if "arithmetic" in kind else "huffman"
    progression = ("early" if kind == "early" else
                   "default" if kind.startswith("progressive") else None)
    # DAC: DC table 0 with L = 1, U = 4, table 1 with L = U = 0; AC
    # table 0 with Kx = 2, table 1 with Kx = 12
    dac = {0: 0x41, 1: 0x00, 16: 2, 17: 12} if kind.endswith("dac") else None
    raw = JS.write(co, coding, progression, restart=5, dac=dac)
    assert all(bytes([0xFF, 0xD0 + n]) in raw for n in range(5))
    if dac:
        assert b"\xff\xcc" in raw
    _check(co, raw, kind != "early")


# colour spaces: (sampling, JFIF, Adobe transform, component ids)
SPACES = {"cmyk-adobe0": ([(1, 1)] * 4, False, 0, None),
          "cmyk-no-adobe": ([(2, 1), (1, 1), (1, 1), (2, 1)], False, None,
                            None),
          "ycck-adobe2": ([(2, 2), (1, 1), (1, 1), (2, 2)], False, 2, None),
          "ycck-adobe1": ([(1, 1)] * 4, False, 1, None),
          "rgb-adobe0": ([(1, 1)] * 3, False, 0, None),
          "rgb-ids": ([(2, 1), (1, 1), (1, 1)], False, None, (82, 71, 66)),
          "ycc-unknown-ids": ([(1, 2), (1, 1), (1, 1)], False, None,
                              (5, 6, 7)),
          "grey": ([(1, 1)], True, None, None),
          "grey-2x2": ([(2, 2)], True, None, None)}


@pytest.mark.parametrize("kind", ["huffman", "progressive",
                                  "progressive-arithmetic"])
@pytest.mark.parametrize("space", list(SPACES))
def test_colour_spaces_match_pillow(space, kind):
    sampling, jfif, adobe, ids = SPACES[space]
    co = JS.coefficients(_picture(38, 50, seed=4, ch=len(sampling)),
                         sampling, quality=85, ids=ids, jfif=jfif,
                         adobe=adobe)
    coding = "arithmetic" if "arithmetic" in kind else "huffman"
    raw = JS.write(co, coding, None if kind == "huffman" else "default")
    _check(co, raw, True)


def _strip(raw: bytes, marker: int) -> bytes:
    """raw without its marker segments of type `marker` before the scan."""
    out, pos = [raw[:2]], 2
    while True:
        m = raw[pos + 1]
        n = struct.unpack(">H", raw[pos + 2:pos + 4])[0]
        if m != marker:
            out.append(raw[pos:pos + 2 + n])
        pos += 2 + n
        if m == 0xDA:
            return b"".join(out) + raw[pos:]


def test_default_huffman_tables():
    """Without DHT, libjpeg-turbo decodes with the Annex K tables (as
    Motion-JPEG frames rely on)."""
    raw = _strip(_encode(_picture(33, 47, seed=2), quality=75), 0xC4)
    assert b"\xff\xc4" not in raw
    np.testing.assert_array_equal(decode_jpeg(raw), _pil(raw))


# -- lossless -----------------------------------------------------------------

LOSSLESS = {**{f"predictor-{p}": dict(predictor=p) for p in range(1, 8)},
            "pt2-restart": dict(predictor=4, pt=2, restart_rows=3),
            "420-restart": dict(sampling=[(2, 2), (1, 1), (1, 1)],
                                predictor=6, restart_rows=2, adobe=0),
            "h1v2-per-component": dict(sampling=[(1, 2), (1, 1), (1, 1)],
                                       predictor=7, interleave=False,
                                       restart_rows=2),
            "grey": dict(ch=1, predictor=5, restart_rows=4, jfif=True),
            "cmyk": dict(ch=4, sampling=[(2, 1), (1, 1), (1, 1), (2, 1)],
                         predictor=3)}


@pytest.mark.parametrize("case", list(LOSSLESS))
def test_lossless_matches_pillow(case):
    kw = dict(LOSSLESS[case])
    ch = kw.pop("ch", 3)
    sampling = kw.pop("sampling", [(1, 1)] * ch)
    kw.setdefault("jfif", False)
    raw = JS.write_lossless(_picture(29, 37, seed=1, ch=ch), sampling, **kw)
    np.testing.assert_array_equal(decode_jpeg(raw), _pil(raw))
    with pytest.raises(JpegError, match="lossless"):
        read_coefficients(raw)


# -- what Pillow refuses ------------------------------------------------------

def _patched(raw: bytes, marker: bytes, edits: dict) -> bytes:
    """raw with the bytes at offsets (from `marker`'s 0xFF) replaced."""
    out = bytearray(raw)
    i = raw.index(marker)
    for off, val in edits.items():
        out[i + off] = val
    return bytes(out)


def _refused(kind: str) -> bytes:
    img = _picture(29, 37, seed=5)
    base = _encode(img, quality=80, subsampling=2)
    if kind == "12-bit":
        return _patched(base, b"\xff\xc0", {1: 0xC1, 4: 12})
    if kind == "hierarchical":
        return _patched(base, b"\xff\xc0", {1: 0xC5})
    if kind == "non-integral":                    # Y 3x1 beside Cb 2x1
        return _patched(base, b"\xff\xc0", {11: 0x31, 14: 0x21})
    if kind == "mcu-over-10":                     # Y 4x4 + Cb + Cr
        return _patched(base, b"\xff\xc0", {11: 0x44})
    if kind == "sampling-5":
        return _patched(base, b"\xff\xc0", {11: 0x51})
    lossless = JS.write_lossless(img, [(1, 1)] * 3,
                                 jfif=kind == "lossless-ycc")
    if kind == "arithmetic-lossless":
        return _patched(lossless, b"\xff\xc3", {1: 0xCB})
    return lossless


@pytest.mark.parametrize("kind", ["12-bit", "hierarchical", "non-integral",
                                  "mcu-over-10", "sampling-5",
                                  "arithmetic-lossless", "lossless-ycc"])
def test_refused_kinds_left_missing(kind):
    raw = _refused(kind)
    with pytest.raises((OSError, SyntaxError)):
        _pil(raw)
    with pytest.raises(JpegError):
        decode_jpeg(raw)
    assert JX._decode_image(JxTexture(uri=None, image_bytes=raw)) is None
    before = len(TT.decode_failures)
    with pytest.warns(UserWarning, match="not decoded"):
        assert TT._decode_image(GltfTexture(uri=None, image_bytes=raw)) \
            is None
    assert len(TT.decode_failures) == before + 1


# -- the loader against the reference's ---------------------------------------

def _loader_input(kind: str) -> bytes:
    img = _picture(64, 80, seed=6, ch=4)
    co = JS.coefficients(img[..., :3], SAMPLINGS["420"], quality=85)
    return {
        "pillow-progressive": lambda: _encode(img[..., :3], quality=85,
                                              progressive=True),
        "early": lambda: JS.write(co, progression="early"),
        "progressive-arithmetic": lambda: JS.write(co, "arithmetic",
                                                   "default", restart=4),
        "ycck": lambda: JS.write(JS.coefficients(
            img, SPACES["ycck-adobe2"][0], quality=85, jfif=False,
            adobe=2), progression="default"),
        "lossless": lambda: JS.write_lossless(img[..., :3], [(1, 1)] * 3,
                                              predictor=7, jfif=False),
    }[kind]()


@pytest.mark.parametrize("kind", ["pillow-progressive", "early",
                                  "progressive-arithmetic", "ycck",
                                  "lossless"])
def test_loader_matches_reference(kind):
    raw = _loader_input(kind)
    want = JX._decode_image(JxTexture(uri=None, image_bytes=raw))
    assert want is not None
    got = TT._decode_image(GltfTexture(uri=None, image_bytes=raw))
    np.testing.assert_array_equal(got, want)
    atlas = TT.build_atlas(images=[got])
    ref = JX.build_atlas(images=[want])
    np.testing.assert_array_equal(atlas.texels, ref.texels)


def test_incomplete_script_smooths():
    """libjpeg smooths a frame whose scans stop early and never a
    complete one: the early script's pixels differ from those of its
    coefficients decoded without smoothing."""
    co = JS.coefficients(_picture(45, 61, seed=8), SAMPLINGS["420"],
                         quality=80)
    early = read_coefficients(JS.write(co, progression="early"))
    assert early.coef_bits is not None and (early.coef_bits[:, 1:] > 0).any()
    smoothed = decode_jpeg(JS.write(co, progression="early"))
    plain = decode_jpeg(JS.write(replace(early, coef_bits=None)))
    assert (smoothed != plain).any()
    full = read_coefficients(JS.write(co, progression="default"))
    assert (full.coef_bits == 0).all()
