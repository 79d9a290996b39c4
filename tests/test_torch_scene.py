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


def _encode_png(img: np.ndarray, filters, color_type: int,
                depth: int = 8, interlace: int = 0) -> bytes:
    """Minimal PNG writer applying the given per-row filter types."""
    h, w, ch = img.shape
    data = img.astype(np.int32)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur = data[y].reshape(-1)
        up = data[y - 1].reshape(-1) if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
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

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    head = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
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


@pytest.mark.parametrize("kw", [dict(color_type=3), dict(depth=16),
                                dict(interlace=1), dict(color_type=0)])
def test_png_rejects_unsupported_kinds(kw):
    img = np.zeros((4, 4, 4), np.uint8)
    raw = _encode_png(img, [0], **{**dict(color_type=6), **kw})
    with pytest.raises(PngError):
        decode_png(raw)


def test_texture_loader_raises_on_dds():
    from toyrenderer_tpu_torch.scene.gltf import GltfTexture
    from toyrenderer_tpu_torch.scene.textures import _decode_image
    tex = GltfTexture(uri=None, image_bytes=b"DDS " + bytes(124))
    with pytest.raises(NotImplementedError, match="DDS"):
        _decode_image(tex)


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
