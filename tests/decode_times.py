"""Time the port's texture decoders on the CPU, beside Pillow's (the
reference's path), on inputs written here from a seed: a 1024 x 1024
RGBA PNG (Pillow's encoder), a 1024 x 1024 4:2:0 quality-90 JPEG,
baseline and progressive, a 1024 x 1024 BC1 DDS, and the downscale of a 2048 x 2048 RGBA image to
1024 x 1024.  Prints the best of 3 runs of each, in seconds.

    python tests/decode_times.py
"""

import io
import time

import numpy as np
from PIL import Image

from toyrenderer_tpu_torch.scene import resize
from toyrenderer_tpu_torch.scene.dds import load_dds
from toyrenderer_tpu_torch.scene.jpeg import decode_jpeg
from toyrenderer_tpu_torch.scene.png import decode_png


def best(fn, n=3) -> float:
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return min(times)


def main():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:1024, 0:1024]
    img = np.clip(np.stack([np.sin(x / 7.0) * 100 + 128,
                            np.cos(y / 5.0) * 100 + 128, ((x + y) % 64) * 4.0,
                            np.full_like(x, 200.0)], -1)
                  + rng.normal(0, 8, (1024, 1024, 4)), 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG")
    png = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(img[..., :3]).save(buf, format="JPEG", quality=90,
                                       subsampling=2)
    jpg = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(img[..., :3]).save(buf, format="JPEG", quality=90,
                                       subsampling=2, progressive=True)
    pjpg = buf.getvalue()
    head = np.zeros(31, np.uint32)
    head[0], head[1], head[2], head[3], head[6] = 124, 0x100F, 1024, 1024, 1
    head[18], head[20] = 32, 0x4
    head[21] = int.from_bytes(b"DXT1", "little")
    dds = (b"DDS " + head.tobytes()
           + rng.integers(0, 256, 1024 * 1024 // 2, dtype=np.uint8).tobytes())
    big = rng.integers(0, 256, (2048, 2048, 4), dtype=np.uint8)

    def pil(raw):
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGBA"))
    rows = [("png 1 MP RGBA", best(lambda: decode_png(png)),
             best(lambda: pil(png))),
            ("jpeg 1 MP 4:2:0 q90", best(lambda: decode_jpeg(jpg)),
             best(lambda: pil(jpg))),
            ("jpeg progressive, same", best(lambda: decode_jpeg(pjpg)),
             best(lambda: pil(pjpg))),
            ("dds BC1 1 MP", best(lambda: load_dds(dds)), None),
            ("resize 4 MP -> 1 MP", best(lambda: resize.resize_rgba(
                big, 1024, 1024), 1), best(lambda: Image.fromarray(
                    big, "RGBA").resize((1024, 1024)), 1))]
    for name, port, ref in rows:
        print(f"{name:24s} port {port:.3f} s" + (
            f"   Pillow {ref:.4f} s" if ref is not None else ""))


if __name__ == "__main__":
    main()
