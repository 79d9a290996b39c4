"""Material mip-atlas build (host side).

The port's copy of toyrenderer_tpu/scene/textures.py: the same atlas, row
for row, so both packages sample the same texels.  Images decode with the
port's own readers -- DDS (scene/dds.py), every PNG kind (scene/png.py)
and every JPEG that Pillow decodes (scene/jpeg.py: sequential,
progressive, arithmetic-coded, lossless; grey, YCbCr, RGB, CMYK, YCCK)
-- to the reference's pixels, and images above MAX_TEXTURE_DIM
downscale as the reference's do (scene/resize.py).  An image that
cannot be decoded is left missing, as in the reference, and counted
(`decode_failures`): corrupt data, and the JPEGs Pillow refuses too
(12-bit, hierarchical, non-integral sampling).

Atlas entries are MATERIAL MAP SETS, not single textures: each textured
material contributes one entry whose texel rows interleave all four glTF
maps -- base color, normal, metallic-roughness, emissive -- resampled to
a common resolution, each as its 2x2 bilinear quad: 16 u32 per texel
row.  One row gather per pixel yields the bilinear footprints of every
map the BRDF needs.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from toyrenderer_tpu_torch.device import resolve_device
from toyrenderer_tpu_torch.scene.dds import load_dds
from toyrenderer_tpu_torch.scene.jpeg import decode_jpeg
from toyrenderer_tpu_torch.scene.png import SIGNATURE, decode_png
from toyrenderer_tpu_torch.scene.resize import resize_rgba, target_size


class DecodeError(ValueError):
    """Image data that cannot be decoded (the reference cannot either)."""


MAX_TEXTURE_DIM = 1024
MAX_MIPS = 11
ROW_U32 = 16          # 4 maps x 2x2 quad per texel row
ATLAS_ALIGN = 2048    # rows: each texture's mip chain starts on this
#   boundary so its base offset encodes as base//ATLAS_ALIGN < 2^10 and
#   rides per-triangle resolve records (gbuffer.py records carry
#   tex + 64*base11); the sampler then derives every mip's offset/size
#   ANALYTICALLY from w0/h0 -- floor-halving mips make
#   w_m = max(w0 >> m, 1) exact
_NEUTRAL = (
    np.asarray([255, 255, 255, 255], np.uint8),   # base: white
    np.asarray([128, 128, 255, 255], np.uint8),   # normal: +Z
    np.asarray([255, 255, 255, 255], np.uint8),   # MR: factors pass
    np.asarray([255, 255, 255, 255], np.uint8),   # emissive: factor passes
)

WRAP_REPEAT = 0
WRAP_CLAMP = 1


@dataclass
class TextureAtlas:
    """Host-side material atlas; `to_device()` -> the sampler's dict of
    tensors.

    Texel storage is QUAD-EXPANDED per map: row i holds, for each of the 4
    material maps, the 2x2 bilinear footprint of texel i -- [T(x,y),
    T(x+1,y), T(x,y+1), T(x+1,y+1)] with the wrap mode baked at the edges
    -- so ONE 64-byte row gather per pixel serves bilinear sampling of all
    maps.
    """
    texels: np.ndarray          # (N, 16) u32 packed RGBA8 quad-map rows
    # descriptor per (texture, mip): -1 offset == mip not resident
    desc_offset: np.ndarray     # (T, MAX_MIPS) i32
    desc_width: np.ndarray      # (T, MAX_MIPS) i32
    desc_height: np.ndarray     # (T, MAX_MIPS) i32
    num_mips: np.ndarray        # (T,) i32
    wrap_mode: np.ndarray       # (T,) i32
    min_resident_mip: np.ndarray  # (T,) i32 (virtual-texture clamp)
    num_textures: int = 0

    def packed_desc(self) -> np.ndarray:
        """(T * MAX_MIPS, 4) i32 rows [offset, width, height, 0] with mip
        clamping and residency REDIRECTION baked in: the row for (t, m)
        points at the finest RESIDENT mip >= m.  Sampling needs exactly one
        desc-row gather — no separate num_mips / min_mip / offset fetches.
        """
        t = self.desc_offset.shape[0]
        desc = np.zeros((t, MAX_MIPS, 4), np.int32)
        for ti in range(t):
            last = max(int(self.num_mips[ti]) - 1, 0)
            for m in range(MAX_MIPS):
                r = min(max(m, int(self.min_resident_mip[ti])), last)
                # walk coarser until resident
                while r < last and self.desc_offset[ti, r] < 0:
                    r += 1
                desc[ti, m] = (self.desc_offset[ti, r],
                               self.desc_width[ti, r],
                               self.desc_height[ti, r], 0)
        return desc.reshape(t * MAX_MIPS, 4)

    def to_device(self, device=None) -> dict:
        """The sampler's atlas dict on `device` (default: the CUDA
        device): texels as int32 bit for bit (u32 RGBA8 patterns), the
        packed descriptor rows, wrap modes and min resident mips."""
        dev = resolve_device(device)

        def on(a):
            return torch.from_numpy(np.array(a, np.int32)).to(dev)
        return dict(
            tex_texels=torch.from_numpy(np.ascontiguousarray(
                self.texels, np.uint32).view(np.int32)).to(dev),
            tex_desc=on(self.packed_desc()),
            tex_wrap=on(self.wrap_mode),
            tex_min_mip=on(self.min_resident_mip))


# signatures of the image formats the reference package decodes (its
# imaging library both writes and reads them) and the port does not yet:
# such a texture raises NotImplementedError (ROADMAP queue 1 item 6).
# TGA has no signature, so a TGA texture is left missing.
_UNPORTED_FORMATS = (
    (b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
    (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"\x00\x00\x01\x00", "ICO"),
    *((b"P" + bytes([c]), "PNM") for c in b"0123456fy"),
    (b"qoif", "QOI"), (b"\x01\xda", "SGI"),
    *((bytes([10, v]), "PCX") for v in (0, 2, 3, 5)),
    (b"Image type:", "IM"), (b"\xff\x4f\xff\x51", "JPEG 2000"),
    (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
    (b"BLP1", "BLP"), (b"BLP2", "BLP"), (b"icns", "ICNS"),
    (b"DanM", "MSP"), (b"LinS", "MSP"))


def _unported_format(raw: bytes) -> str | None:
    """The name of the format whose signature `raw` starts with, among
    those the reference decodes and the port does not yet."""
    for magic, name in _UNPORTED_FORMATS:
        if raw.startswith(magic):
            return name
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "WebP"
    if raw[4:8] == b"ftyp" and raw[8:12] in (b"avif", b"avis"):
        return "AVIF"
    if raw.lstrip().startswith(b"#define"):
        return "XBM"
    return None


# the textures the loader could not decode (the reference package leaves
# them missing too), by name, since the process started
decode_failures: list[str] = []


def _read_image(raw: bytes) -> np.ndarray | list:
    """Image bytes -> (H, W, 4) u8 RGBA, or a DDS file's mip list (the
    mips above MAX_TEXTURE_DIM dropped, the chain kept aligned, as the
    reference does).  Raises DecodeError for data the reference cannot
    decode either, NotImplementedError for a format it decodes that the
    port does not."""
    if raw[:4] == b"DDS ":
        mips = load_dds(raw)
        if mips is None:
            raise DecodeError("DDS format not supported")
        return [m for m in mips
                if max(m.shape[:2]) <= MAX_TEXTURE_DIM] or mips[-1:]
    if raw[:8] == SIGNATURE:
        img = decode_png(raw)
    elif raw[:3] == b"\xff\xd8\xff":
        img = decode_jpeg(raw)
    else:
        name = _unported_format(raw)
        if name is not None:
            raise NotImplementedError(
                f"texture format {name}: the port decodes DDS, PNG and JPEG "
                "(ROADMAP queue 1 item 6)")
        raise DecodeError(f"unknown image format {raw[:4]!r}")
    h, w = img.shape[:2]
    if max(h, w) > MAX_TEXTURE_DIM:
        img = resize_rgba(img, *target_size(w, h, MAX_TEXTURE_DIM))
    return img


def _decode_image(tex) -> np.ndarray | list | None:
    """GltfTexture -> (H, W, 4) u8 RGBA, a DDS mip list, or None: when it
    names no image, or, as in the reference package (its
    textures.py:109-139), when its image cannot be read or decoded
    (truncated or corrupt data, a DDS format without a decoder, a JPEG
    that Pillow refuses: 12-bit, hierarchical, non-integral sampling);
    each such texture is appended to `decode_failures` with a warning
    naming it.  Images above MAX_TEXTURE_DIM are downscaled as the
    reference does (scene/resize.py).  A format the reference decodes
    and the port does not yet (GIF, BMP, TIFF, ICO, WebP, PNM, QOI, SGI,
    PCX, IM, JPEG 2000, BLP, ICNS, MSP, XBM, AVIF) raises
    NotImplementedError."""
    base_dir = getattr(tex, 'base_dir', None)
    try:
        if tex.image_bytes is not None:
            raw = tex.image_bytes
        elif tex.uri is not None and base_dir is not None:
            raw = (base_dir / tex.uri).read_bytes()
        else:
            return None
        return _read_image(raw)
    except (OSError, ValueError) as e:   # DecodeError, PngError, JpegError
        name = (tex.uri if tex.uri is not None
                else f"embedded image ({len(tex.image_bytes)} bytes)")
        decode_failures.append(name)
        warnings.warn(f"texture {name} not decoded ({e}): left missing, as "
                      "the reference leaves it", stacklevel=2)
        return None


def _pack_rgba8(img: np.ndarray) -> np.ndarray:
    i = img.astype(np.uint32)
    return i[..., 0] | (i[..., 1] << 8) | (i[..., 2] << 16) | (i[..., 3] << 24)


def _quad_expand(packed: np.ndarray, wrap: int) -> np.ndarray:
    """(H, W) u32 -> (H*W, 4) u32 rows of each texel's 2x2 footprint."""
    if wrap == WRAP_REPEAT:
        xp = np.roll(packed, -1, axis=1)
        yp = np.roll(packed, -1, axis=0)
        xyp = np.roll(yp, -1, axis=1)
    else:
        xp = np.concatenate([packed[:, 1:], packed[:, -1:]], axis=1)
        yp = np.concatenate([packed[1:], packed[-1:]], axis=0)
        xyp = np.concatenate([yp[:, 1:], yp[:, -1:]], axis=1)
    return np.stack([packed, xp, yp, xyp], -1).reshape(-1, 4)


def _downsample2x(img: np.ndarray) -> np.ndarray:
    """Box-filter 2x downsample of (H, W, 4) u8 (sRGB-naive, like most
    runtime mippers).  Dims follow EXACT floor-halving max(d//2, 1) —
    the analytic-descriptor path (ops/texture.analytic_desc) depends on
    it; a dim already at 1 duplicates so non-square chains never
    degenerate to zero-size mips (128x32 used to produce (2, 0))."""
    h, w = img.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    if h == 1:
        img = np.repeat(img, 2, axis=0)
    if w == 1:
        img = np.repeat(img, 2, axis=1)
    img = img[:h2 * 2, :w2 * 2].astype(np.uint16)
    out = (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2]
           + img[1::2, 1::2] + 2) // 4
    return out.astype(np.uint8)


def build_mips(img: np.ndarray) -> list[np.ndarray]:
    mips = [img]
    while max(mips[-1].shape[:2]) > 1 and len(mips) < MAX_MIPS:
        mips.append(_downsample2x(mips[-1]))
    return mips


def _resample(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest resample of (H, W, 4) u8 to (h, w, 4) (maps of one material
    are unified to a common resolution at build)."""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    ys = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[ys[:, None], xs[None, :]]


def build_atlas(doc=None, material_maps: list[dict] | None = None,
                images: list[np.ndarray] | None = None,
                wrap_modes=None) -> TextureAtlas:
    """Build the material atlas.

    doc: GltfDocument -- one entry per material that references any
    texture (base/normal/MR/emissive indices on GltfMaterial).
    material_maps: explicit list of {'base'|'normal'|'mr'|'emissive':
    (H, W, 4) u8, 'wrap': int} dicts (procedural scenes, tests), after
    the document's entries.  images: base-colour-only shorthand for
    material_maps (wrap_modes: their wrap modes, default REPEAT).
    Entry order == the order of textured materials, then the given
    maps; callers map material index -> entry id (scenebuild wires
    mat_base_color_tex).
    """
    if images is not None:
        wraps_in = list(wrap_modes or [WRAP_REPEAT] * len(images))
        material_maps = list(material_maps or []) + [
            dict(base=img, wrap=wraps_in[i]) for i, img in enumerate(images)]
    entries: list[dict] = []
    decoded: dict[int, np.ndarray | None] = {}

    def get(ti):
        if ti < 0 or ti >= len(doc.textures):
            return None
        if ti not in decoded:
            t = doc.textures[ti]
            t.base_dir = doc.base_dir
            decoded[ti] = _decode_image(t)
        return decoded[ti]

    for m in (doc.materials if doc is not None else ()):
        # one entry per material that REFERENCES any texture, keeping
        # entry ids aligned with scenebuild._material_atlas_entries
        if (m.base_color_texture < 0 and m.normal_texture < 0
                and m.metallic_roughness_texture < 0
                and m.emissive_texture < 0):
            continue
        maps = dict(base=get(m.base_color_texture),
                    normal=get(m.normal_texture),
                    mr=get(m.metallic_roughness_texture),
                    emissive=get(m.emissive_texture))
        bt = m.base_color_texture
        wrap = WRAP_REPEAT
        if 0 <= bt < len(doc.textures):
            wrap = (WRAP_CLAMP if doc.textures[bt].wrap_s == 33071
                    else WRAP_REPEAT)
        maps['wrap'] = wrap
        entries.append(maps)
    if material_maps is not None:
        entries.extend(material_maps)

    n = max(len(entries), 1)
    offsets = np.full((n, MAX_MIPS), -1, np.int32)
    widths = np.zeros((n, MAX_MIPS), np.int32)
    heights = np.zeros((n, MAX_MIPS), np.int32)
    num_mips = np.zeros((n,), np.int32)
    wraps = np.zeros((n,), np.int32)
    chunks = []
    cursor = 0
    keys = ('base', 'normal', 'mr', 'emissive')
    for ei, ent in enumerate(entries):
        a = (-cursor) % ATLAS_ALIGN      # align the chain base (above)
        if a:
            chunks.append(np.zeros((a, ROW_U32), np.uint32))
            cursor += a
        wrap = int(ent.get('wrap', WRAP_REPEAT))
        wraps[ei] = wrap
        # resolution = the base map's (or the largest present map's)
        # a DDS map is its mip list: its first (finest kept) mip is the
        # map, whose chain build_mips makes as for any image
        maps = {k: v[0] if isinstance(v, list) else v
                for k, v in ((k, ent.get(k)) for k in keys)}
        ref = maps['base']
        if ref is None:
            sizes = [v.shape[:2] for v in maps.values() if v is not None]
            ref_hw = max(sizes, key=lambda s: s[0] * s[1])
        else:
            ref_hw = ref.shape[:2]
        per_map_mips = []
        for mi_k, k in enumerate(keys):
            img = maps[k]
            if img is None:
                img = np.broadcast_to(
                    _NEUTRAL[mi_k], (1, 1, 4)).copy()
            img = _resample(img, *ref_hw)
            per_map_mips.append(build_mips(img))
        n_m = min(len(mm) for mm in per_map_mips)
        for mi in range(min(n_m, MAX_MIPS)):
            packed = np.concatenate(
                [_quad_expand(_pack_rgba8(per_map_mips[k][mi]), wrap)
                 for k in range(4)], axis=1)            # (HW, 16)
            offsets[ei, mi] = cursor
            heights[ei, mi], widths[ei, mi] = (
                per_map_mips[0][mi].shape[:2])
            chunks.append(packed)
            cursor += packed.shape[0]
            num_mips[ei] = mi + 1
    if not chunks:
        texels = np.zeros((1, ROW_U32), np.uint32)
        texels[:, 0:4] = 0xFFFFFFFF
        num_mips[0] = 1
        widths[0, 0] = heights[0, 0] = 1
        offsets[0, 0] = 0
    else:
        texels = np.concatenate(chunks)
    pad = (-len(texels)) % 128
    if pad:
        texels = np.concatenate(
            [texels, np.zeros((pad, ROW_U32), np.uint32)])
    return TextureAtlas(
        texels=texels.astype(np.uint32),
        desc_offset=offsets, desc_width=widths, desc_height=heights,
        num_mips=num_mips, wrap_mode=wraps,
        min_resident_mip=np.zeros((n,), np.int32),
        num_textures=len(entries))


def checkerboard(size: int = 256, tiles: int = 8,
                 c0=(255, 255, 255), c1=(40, 40, 40)) -> np.ndarray:
    """Procedural test texture: (size, size, 4) u8, opaque."""
    y, x = np.meshgrid(np.arange(size), np.arange(size), indexing='ij')
    m = ((x * tiles // size) + (y * tiles // size)) % 2
    img = np.where(m[..., None] == 0,
                   np.asarray(c0, np.uint8), np.asarray(c1, np.uint8))
    return np.concatenate(
        [img, np.full((size, size, 1), 255, np.uint8)], -1)


def bump_normal_map(size: int = 256, bumps: int = 16,
                    amplitude: float = 1.0) -> np.ndarray:
    """Procedural tangent-space normal map: a sine-bump height field's
    analytic gradient, encoded glTF-style (+Y up, 0.5-biased)."""
    t = np.linspace(0, 2 * np.pi * bumps, size, endpoint=False)
    y, x = np.meshgrid(t, t, indexing='ij')
    dhdx = amplitude * np.cos(x) * np.sin(y)
    dhdy = amplitude * np.sin(x) * np.cos(y)
    n = np.stack([-dhdx, -dhdy, np.ones_like(dhdx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = ((n * 0.5 + 0.5) * 255.0 + 0.5).astype(np.uint8)
    return np.concatenate(
        [rgb, np.full((size, size, 1), 255, np.uint8)], -1)
