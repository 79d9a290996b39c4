"""The port's scene loader against the reference package's, its PNG
decoder against an imaging library, and the port's import rules.

Scene arrays are compared exactly: both loaders run the same numpy logic
and the same native builders, so any difference is a porting fault.
PNG decoding is compared byte for byte (a lossless format).
"""

import io
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from toyrenderer_tpu.scene import load_scene as jax_load_scene
from toyrenderer_tpu.scene.gltf import load_gltf as jax_load_gltf

from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.png import PngError, decode_png

ROOT = Path(__file__).resolve().parent.parent
_HOST = ('sun_direction', 'sun_color', 'camera_position',
         'camera_rotation', 'world_aabb')
_SCALARS = ('node_depth', 'num_vertices', 'num_meshlets', 'num_primitives',
            'num_instances', 'num_nodes', 'num_textures', 'sun_intensity',
            'camera_yfov', 'camera_znear')


@pytest.mark.parametrize("name", ["cornell.gltf", "courtyard.glb"])
def test_load_scene_matches_reference(name, tmp_path, monkeypatch):
    path = ROOT / "resources" / name
    want = jax_load_scene(path, use_cache=False)
    # the port's cache lives in its build directory: point it at tmp
    from toyrenderer_tpu_torch.scene import scenebuild
    monkeypatch.setattr(scenebuild, "BUILD_DIR", tmp_path)
    got = load_scene(path)
    cached = load_scene(path)                 # read back from the cache
    assert list(tmp_path.glob("scenes/*.npz"))
    for scene in (got, cached):
        for f in (*want._DEVICE_FIELDS, *_HOST):
            a, b = getattr(want, f), getattr(scene, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a, err_msg=f)
        for f in _SCALARS:
            assert getattr(scene, f) == getattr(want, f), f
        for a, b in zip(want.meshlet_windows(), scene.meshlet_windows()):
            np.testing.assert_array_equal(b, a)
        assert scene.tex_analytic_ok() == want.tex_analytic_ok()
    if name == "courtyard.glb":
        assert got.num_textures > 0           # the texture path ran


def test_device_scene_is_torch():
    s = load_scene(ROOT / "resources" / "cornell.gltf", use_cache=False)
    d = s.to_device("cpu")
    assert d.positions.dtype == torch.float32
    assert d.meshlet_tris.dtype == torch.int32
    assert d.device == torch.device("cpu")
    np.testing.assert_array_equal(
        d.tex_texels.numpy().view(np.uint32), s.tex_texels)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No CUDA device and no explicit device: raise, never carry on on
    the CPU."""
    from toyrenderer_tpu_torch.engine import RenderSettings, make_render_fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = load_scene(ROOT / "resources" / "cornell.gltf", use_cache=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.to_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_render_fn(RenderSettings())


def _courtyard_pngs():
    doc = jax_load_gltf(ROOT / "resources" / "courtyard.glb")
    return [t.image_bytes for t in doc.textures]


def test_png_decodes_courtyard_textures_like_pil():
    pngs = _courtyard_pngs()
    assert len(pngs) == 21
    for raw in pngs:
        want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
        np.testing.assert_array_equal(decode_png(raw), want)


_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _filter_rows(data: np.ndarray, filters, bpp: int, row0: int = 0):
    """Filtered scanlines of (H, row bytes) bytes, row y with filter type
    filters[(row0 + y) % len(filters)]; bpp: the bytes a filter steps."""
    data = data.astype(np.int32)
    rows = []
    for y in range(data.shape[0]):
        f = filters[(row0 + y) % len(filters)]
        cur = data[y]
        up = data[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - left
        elif f == 2:
            out = cur - up
        elif f == 3:
            out = cur - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
            out = cur - pred
        rows.append(bytes([f]) + (out & 0xFF).astype(np.uint8).tobytes())
    return rows


def _pack_rows(img: np.ndarray, depth: int) -> np.ndarray:
    """Samples (H, W, C) -> (H, row bytes) u8 at `depth` bits a sample."""
    h, w, ch = img.shape
    flat = img.reshape(h, w * ch).astype(np.uint16)
    if depth == 16:
        return np.stack([flat >> 8, flat & 0xFF], -1).reshape(
            h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _encode_png(img: np.ndarray, filters, color_type: int,
                depth: int = 8, interlace: int = 0, chunks=()) -> bytes:
    """Minimal PNG writer: samples (H, W, C) (u16 at depth 16) packed at
    `depth` bits, each scanline with the given filter types in turn; the
    seven Adam7 passes when `interlace`; `chunks` ((kind, data), e.g.
    PLTE and tRNS) before IDAT."""
    h, w, ch = img.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        rows, n = [], 0
        for r0, c0, dr, dc in _ADAM7:
            sub = img[r0::dr, c0::dc]
            if sub.size:
                rows += _filter_rows(_pack_rows(sub, depth), filters, bpp, n)
                n += sub.shape[0]
    else:
        rows = _filter_rows(_pack_rows(img, depth), filters, bpp)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    head = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
            + b"".join(chunk(k, d) for k, d in chunks)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels,color_type", [(3, 2), (4, 6)])
def test_png_all_five_filters_match_pil(channels, color_type):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=(23, 17, channels), dtype=np.uint8)
    raw = _encode_png(img, filters=[0, 1, 2, 3, 4, 4, 3, 1],
                      color_type=color_type)
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
    got = decode_png(raw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., :channels], img)


@pytest.mark.parametrize("kw", [
    dict(color_type=3, chunks=((b"PLTE", bytes(range(48))),)),
    dict(depth=16), dict(interlace=1), dict(color_type=0)],
    ids=["palette", "16-bit", "interlaced", "grey"])
def test_png_kinds_match_pil(kw):
    """The kinds the decoder once refused: palette, 16-bit, interlaced
    and grey, at Pillow's convert("RGBA"), bit for bit (every kind:
    tests/test_torch_image_kinds.py)."""
    kw = {**dict(color_type=6), **kw}
    rng = np.random.default_rng(11)
    ch = {0: 1, 3: 1, 6: 4}[kw['color_type']]
    hi = {3: 16, 0: 256}.get(kw['color_type'], 1 << kw.get('depth', 8))
    img = rng.integers(0, hi, size=(13, 9, ch)).astype(
        np.uint16 if kw.get('depth') == 16 else np.uint8)
    raw = _encode_png(img, [0, 1, 2, 3, 4], **kw)
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
    np.testing.assert_array_equal(decode_png(raw), want)


def test_texture_loader_decodes_dds():
    """A DDS texture (RGBA8, legacy header) decodes as the reference's
    loader decodes it (scene/dds.py, its copy)."""
    from toyrenderer_tpu.scene.dds import load_dds
    from toyrenderer_tpu_torch.scene.gltf import GltfTexture
    from toyrenderer_tpu_torch.scene.textures import _decode_image
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(8, 16, 4), dtype=np.uint8)
    head = np.zeros(31, np.uint32)
    head[0], head[1], head[2], head[3] = 124, 0x100F, 8, 16
    head[18] = 32                                  # pixel format size
    head[20], head[22] = 0x41, 32                  # RGB | alpha, 32 bits
    head[23:27] = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)
    raw = b"DDS " + head.tobytes() + img.tobytes()
    want = load_dds(raw)
    got = _decode_image(GltfTexture(uri=None, image_bytes=raw))
    assert isinstance(got, list) and len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], img)


def test_port_imports_nothing_of_jax_or_the_reference():
    """The port and chip_smoke.py import torch and numpy, never jax, the
    imaging library or anything of the reference package."""
    files = sorted((ROOT / "toyrenderer_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    assert ROOT / "toyrenderer_tpu_torch" / "tools" / "rtbench.py" in files
    bad = re.compile(r"toyrenderer_tpu\.|import jax|from jax|PIL")
    for f in files:
        for n, line in enumerate(f.read_text().splitlines(), 1):
            assert not bad.search(line), f"{f}:{n}: {line}"
