"""The port's DDS loader (scene/dds.py, its own copy of the reference's)
and the texture loader's DDS rule, against the reference package's
`toyrenderer_tpu.scene.dds.load_dds`, on files written here with numpy:
every mip bit-equal.

* BC1 (both colour modes), BC2, BC3, BC4 and BC5 with random block bytes,
  and RGBA8 / BGRA8, each under a legacy header (FourCC, or RGB masks) and
  a DX10 header, with a full mip chain of a non-square, non-multiple-of-4
  size.
* Unsupported formats and truncated files: None in both.
* `_decode_image` drops the mips above MAX_TEXTURE_DIM (a 2048 x 512 chain
  keeps 1024 x 256 down), keeps the last mip where every mip is too
  large, and a DDS format without a decoder is a missing texture,
  counted, as in the reference (its textures.py:121-127).
"""

import struct

import numpy as np
import pytest

from toyrenderer_tpu.scene.dds import load_dds as jax_load_dds

from toyrenderer_tpu_torch.scene import dds as TD
from toyrenderer_tpu_torch.scene import textures as TT
from toyrenderer_tpu_torch.scene.gltf import GltfTexture

FOURCC = {"BC1": b"DXT1", "BC2": b"DXT3", "BC3": b"DXT5", "BC4": b"ATI1",
          "BC5": b"ATI2"}
DXGI = {"BC1": 71, "BC2": 74, "BC3": 77, "BC4": 80, "BC5": 83, "RGBA8": 28,
        "BGRA8": 87}


def _dds(fmt: str, w: int, h: int, mips: int, dx10: bool, rng,
         truncate: int = 0) -> bytes:
    """A DDS file of random texel data; legacy headers give RGBA8 / BGRA8
    by their red mask."""
    head = np.zeros(31, np.uint32)
    head[0], head[1], head[2], head[3] = 124, 0x2100F, h, w
    head[6] = mips
    head[18] = 32
    extra = b""
    if dx10:
        head[20] = 0x4
        head[21] = struct.unpack("<I", b"DX10")[0]
        extra = struct.pack("<5I", DXGI[fmt], 3, 0, 1, 0)
    elif fmt in FOURCC:
        head[20] = 0x4
        head[21] = struct.unpack("<I", FOURCC[fmt])[0]
    else:
        head[20], head[22] = 0x41, 32
        head[23] = 0xFF if fmt == "RGBA8" else 0xFF0000
    body = b"".join(
        rng.integers(0, 256, TD.mip_byte_size(fmt, max(w >> m, 1),
                                              max(h >> m, 1)),
                     dtype=np.uint8).tobytes() for m in range(mips))
    raw = b"DDS " + head.tobytes() + extra + body
    return raw[:len(raw) - truncate] if truncate else raw


FORMATS = ["BC1", "BC2", "BC3", "BC4", "BC5", "RGBA8", "BGRA8"]


@pytest.mark.parametrize("dx10", [False, True], ids=["legacy", "dx10"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_dds_matches_reference(fmt, dx10):
    rng = np.random.default_rng(FORMATS.index(fmt) * 2 + dx10)
    raw = _dds(fmt, 37, 22, 6, dx10, rng)
    want = jax_load_dds(raw)
    got = TD.load_dds(raw)
    assert len(got) == len(want) == 6
    for m, (g, wnt) in enumerate(zip(got, want)):
        assert g.dtype == np.uint8 and g.shape == (max(22 >> m, 1),
                                                   max(37 >> m, 1), 4)
        np.testing.assert_array_equal(g, wnt)
    if fmt == "BC1":           # both BC1 modes occur in the random blocks
        assert (got[0][..., 3] == 0).any() and (got[0][..., 3] == 255).any()


def test_unsupported_and_truncated_dds():
    rng = np.random.default_rng(9)
    raw = bytearray(_dds("BC3", 16, 16, 3, True, rng))
    raw[128:132] = struct.pack("<I", 95)               # BC6H: no decoder
    assert TD.load_dds(bytes(raw)) is None is jax_load_dds(bytes(raw))
    short = _dds("BC1", 16, 16, 5, False, rng, truncate=40)
    got, want = TD.load_dds(short), jax_load_dds(short)
    assert len(got) == len(want) < 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_texture_loader_dds_mips_and_failures():
    rng = np.random.default_rng(4)
    raw = _dds("BC1", 2048, 512, 4, False, rng)
    mips = TT._decode_image(GltfTexture(uri=None, image_bytes=raw))
    want = jax_load_dds(raw)
    assert [m.shape[:2] for m in mips] == [(256, 1024), (128, 512), (64, 256)]
    for g, w in zip(mips, want[1:]):
        np.testing.assert_array_equal(g, w)
    one = _dds("RGBA8", 4096, 8, 1, True, rng)
    kept = TT._decode_image(GltfTexture(uri=None, image_bytes=one))
    assert len(kept) == 1 and kept[0].shape == (8, 4096, 4)

    bad = bytearray(_dds("BC3", 16, 16, 1, True, rng))
    bad[128:132] = struct.pack("<I", 95)
    before = len(TT.decode_failures)
    with pytest.warns(UserWarning, match="not decoded"):
        assert TT._decode_image(GltfTexture(uri=None,
                                            image_bytes=bytes(bad))) is None
    assert len(TT.decode_failures) == before + 1
