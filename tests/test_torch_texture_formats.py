"""The texture loader on the image formats the reference decodes through
Pillow (toyrenderer_tpu/scene/textures.py:109-139) and the port does
not yet (ROADMAP queue 1 item 6): each file, written by Pillow's own
writer, is decoded by the reference's loader, and the port's loader
raises NotImplementedError naming the format and the ROADMAP item
instead of leaving the texture silently missing.  (TGA carries no
signature: the port cannot tell it from bytes no decoder knows.)
"""

import io

import numpy as np
import pytest

from toyrenderer_tpu.scene import textures as JX
from toyrenderer_tpu.scene.gltf import GltfTexture as JxTexture
from toyrenderer_tpu_torch.scene import textures as TT
from toyrenderer_tpu_torch.scene.gltf import GltfTexture

Image = pytest.importorskip("PIL.Image")

# (name the port's error gives, Pillow's format, the image mode written)
FORMATS = {"PNM": ("PPM", "RGB"), "PNM-grey": ("PPM", "L"),
           "PNM-float": ("PPM", "F"), "QOI": ("QOI", "RGB"),
           "SGI": ("SGI", "RGB"), "PCX": ("PCX", "RGB"), "IM": ("IM", "RGB"),
           "JPEG 2000": ("JPEG2000", "RGB"),
           "JPEG 2000-codestream": ("JPEG2000", "RGB"),
           "BLP": ("BLP", "P"), "ICNS": ("ICNS", "RGBA"),
           "MSP": ("MSP", "1"), "XBM": ("XBM", "1"), "AVIF": ("AVIF", "RGB")}


@pytest.mark.parametrize("name", list(FORMATS))
def test_unported_format_raises(name):
    Image.init()
    fmt, mode = FORMATS[name]
    if fmt not in Image.SAVE:
        pytest.skip(f"this Pillow writes no {fmt}")
    rng = np.random.default_rng(len(name))
    img = Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    buf = io.BytesIO()
    kw = {"no_jp2": True} if name.endswith("codestream") else {}
    img.convert(mode).save(buf, format=fmt, **kw)
    raw = buf.getvalue()
    assert JX._decode_image(JxTexture(uri=None, image_bytes=raw)) is not None
    label = name.split("-")[0]
    with pytest.raises(NotImplementedError, match=f"{label}.*item 6"):
        TT._decode_image(GltfTexture(uri=None, image_bytes=raw))
