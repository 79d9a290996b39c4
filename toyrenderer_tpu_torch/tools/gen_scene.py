"""Generate `courtyard.glb` -- the Sponza-class bench asset.

Counterpart of toyrenderer_tpu/tools/gen_scene.py: the same geometry,
layout, materials and textures, drawn with the same numpy RNG calls in
the same order, so a seed gives the same scene.  The textures are
written by the port's own PNG writer (scene/png.encode_png: filter 0,
zlib level 6) where the reference's go through Pillow, so the PNG bytes
differ and the texels do not; the meshopt views are encoded by the
port's copy of the codec (scene/meshopt.py), byte for byte the
reference's.

A colonnaded courtyard in the spirit of the reference's flagship content
(Sponza: ~260k tris, skewed triangle sizes, alpha-tested foliage, dozens
of textures): stone floor slabs, two rows of fluted columns with arches,
brick walls, wooden roof beams, wavy curtains (double-sided), alpha-MASKED
hanging banners and potted plants with cutout leaf cards, plus a camera
and a directional sun.  Exported as a real GLB with EXT_meshopt_compression
(vertex + index codecs) and embedded PNG textures, so loading it exercises
the full SceneLoading.cpp-parity path: GLB container -> meshopt decode ->
image decode -> meshletize/LOD -> atlas.

Usage:
  python -m toyrenderer_tpu_torch.tools.gen_scene \
      [--out resources/courtyard.glb] [--no-compress] [--scale 1.0] \
      [--seed 7]
(--scale 3 writes the 3x3-courtyard plaza, resources/plaza.glb.)
"""

from __future__ import annotations

import argparse
import json
import os
import struct

import numpy as np

from toyrenderer_tpu_torch.scene import meshopt as M
from toyrenderer_tpu_torch.scene.png import encode_png


# ---------------------------------------------------------------------------
# mesh primitives (positions, normals, uvs, indices)
# ---------------------------------------------------------------------------

class MeshAcc:
    def __init__(self):
        self.pos, self.nrm, self.uv, self.idx = [], [], [], []
        self.base = 0

    def add(self, p, n, t, i):
        self.pos.append(np.asarray(p, np.float32))
        self.nrm.append(np.asarray(n, np.float32))
        self.uv.append(np.asarray(t, np.float32))
        self.idx.append(np.asarray(i, np.uint32) + self.base)
        self.base += len(p)

    def bake(self):
        return (np.concatenate(self.pos), np.concatenate(self.nrm),
                np.concatenate(self.uv), np.concatenate(self.idx))


def box(w, h, d, uv_scale=1.0, tess=1, bump=0.0, rng=None):
    """Axis-aligned box centered at origin (y up from 0).

    tess subdivides every face tess x tess (Sponza-style dense surfaces);
    bump displaces subdivided faces along their normal (worn stone)."""
    m = MeshAcc()
    x, y, z = w / 2, h, d / 2
    faces = [
        # +x, -x, +y, -y, +z, -z : (corner, edge_u, edge_v, normal)
        ([x, 0, -z], [0, 0, 2 * z], [0, y, 0], [1, 0, 0]),
        ([-x, 0, z], [0, 0, -2 * z], [0, y, 0], [-1, 0, 0]),
        ([-x, y, -z], [2 * x, 0, 0], [0, 0, 2 * z], [0, 1, 0]),
        ([-x, 0, z], [2 * x, 0, 0], [0, 0, -2 * z], [0, -1, 0]),
        ([-x, 0, z], [2 * x, 0, 0], [0, y, 0], [0, 0, 1]),
        ([x, 0, -z], [-2 * x, 0, 0], [0, y, 0], [0, 0, -1]),
    ]
    for c, eu, ev, n in faces:
        c, eu, ev, n = map(np.asarray, (c, eu, ev, n))
        lu = np.linalg.norm(eu) * uv_scale
        lv = np.linalg.norm(ev) * uv_scale
        uu, vv = np.meshgrid(np.linspace(0, 1, tess + 1),
                             np.linspace(0, 1, tess + 1), indexing='ij')
        p = (c[None, None] + uu[..., None] * eu[None, None]
             + vv[..., None] * ev[None, None])
        if bump > 0.0 and rng is not None:
            interior = ((uu > 0) & (uu < 1) & (vv > 0) & (vv < 1))
            disp = rng.uniform(-bump, bump, uu.shape) * interior
            p = p + disp[..., None] * n[None, None]
        t = np.stack([uu * lu, vv * lv], -1)
        k = tess + 1
        idx = []
        for i in range(tess):
            for j in range(tess):
                a = i * k + j
                idx += [a, a + k, a + 1, a + 1, a + k, a + k + 1]
        m.add(p.reshape(-1, 3), np.tile(n, (k * k, 1)),
              t.reshape(-1, 2), idx)
    return m.bake()


def lathe(profile, segments=24, uv_scale=1.0, flutes=0.0):
    """Surface of revolution around +y.  profile: list of (radius, y)."""
    prof = np.asarray(profile, np.float32)
    ang = np.linspace(0, 2 * np.pi, segments + 1)
    pos, nrm, uv, idx = [], [], [], []
    n_ring = segments + 1
    for j, (r, y) in enumerate(prof):
        rr = r * (1.0 + flutes * 0.06 * np.cos(ang * 12))
        x = np.cos(ang) * rr
        z = np.sin(ang) * rr
        pos.append(np.stack([x, np.full_like(x, y), z], -1))
        nrm.append(np.stack([np.cos(ang), np.zeros_like(ang),
                             np.sin(ang)], -1))
        uv.append(np.stack([ang / (2 * np.pi) * 4,
                            np.full_like(ang, y * uv_scale)], -1))
    for j in range(len(prof) - 1):
        for s in range(segments):
            a = j * n_ring + s
            b = a + n_ring
            idx += [a, a + 1, b, a + 1, b + 1, b]
    p = np.concatenate(pos).astype(np.float32)
    n = np.concatenate(nrm).astype(np.float32)
    # fix normals for sloped profile segments via neighbor differencing
    return p, n, np.concatenate(uv).astype(np.float32), \
        np.asarray(idx, np.uint32)


def arch(width, height, depth, thickness, segments=24):
    """Semicircular arch in the XZ=0 plane spanning `width`."""
    m = MeshAcc()
    r_out = width / 2
    r_in = r_out - thickness
    ang = np.linspace(0, np.pi, segments + 1)
    for z in (-depth / 2, depth / 2):
        # front/back ring faces
        xo = np.cos(ang) * r_out
        yo = np.sin(ang) * r_out + height
        xi = np.cos(ang) * r_in
        yi = np.sin(ang) * r_in + height
        p = np.concatenate([np.stack([xo, yo, np.full_like(xo, z)], -1),
                            np.stack([xi, yi, np.full_like(xi, z)], -1)])
        n = np.tile([0, 0, 1 if z > 0 else -1], (len(p), 1))
        t = np.concatenate([np.stack([ang, np.zeros_like(ang)], -1),
                            np.stack([ang, np.ones_like(ang)], -1)])
        i = []
        for s in range(segments):
            a, b = s, s + 1
            c, d = s + segments + 1, s + segments + 2
            if z > 0:
                i += [a, b, c, b, d, c]
            else:
                i += [a, c, b, b, c, d]
        m.add(p, n, t, i)
    # inner surface
    xi = np.cos(ang) * r_in
    yi = np.sin(ang) * r_in + height
    p = np.concatenate([
        np.stack([xi, yi, np.full_like(xi, -depth / 2)], -1),
        np.stack([xi, yi, np.full_like(xi, depth / 2)], -1)])
    n = np.concatenate([np.stack([-np.cos(ang), -np.sin(ang),
                                  np.zeros_like(ang)], -1)] * 2)
    t = np.concatenate([np.stack([ang * 2, np.zeros_like(ang)], -1),
                        np.stack([ang * 2, np.ones_like(ang)], -1)])
    i = []
    for s in range(segments):
        a, b = s, s + 1
        c, d = s + segments + 1, s + segments + 2
        i += [a, c, b, b, c, d]
    m.add(p, n, t, i)
    return m.bake()


def curtain(width, height, waves=3.0, nx=32, ny=20, amp=0.25):
    xs = np.linspace(0, width, nx)
    ys = np.linspace(0, height, ny)
    xx, yy = np.meshgrid(xs, ys)
    sag = 1.0 - (yy / height)                     # more wave at the bottom
    zz = np.sin(xx / width * waves * 2 * np.pi) * amp * (0.3 + 0.7 * sag)
    pos = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
    # analytic normal of z = f(x)
    dz = (np.cos(xx / width * waves * 2 * np.pi) * amp
          * (0.3 + 0.7 * sag) * waves * 2 * np.pi / width)
    n = np.stack([-dz, np.zeros_like(dz), np.ones_like(dz)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nrm = n.reshape(-1, 3).astype(np.float32)
    uv = np.stack([xx / width, 1 - yy / height],
                  -1).reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            a = j * nx + i
            idx += [a, a + 1, a + nx, a + 1, a + nx + 1, a + nx]
    return pos, nrm, uv, np.asarray(idx, np.uint32)


def quad_card(w, h):
    """Vertical quad (for leaves / banners), origin at bottom center."""
    p = np.asarray([[-w / 2, 0, 0], [w / 2, 0, 0], [w / 2, h, 0],
                    [-w / 2, h, 0]], np.float32)
    n = np.tile([0, 0, 1], (4, 1)).astype(np.float32)
    t = np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    return p, n, t, np.asarray([0, 1, 2, 0, 2, 3], np.uint32)


def plant(rng, n_leaves=48):
    """Pot (lathe) + crossed cutout leaf cards."""
    m = MeshAcc()
    pot = lathe([(0.16, 0.0), (0.22, 0.05), (0.26, 0.3), (0.24, 0.34),
                 (0.2, 0.34)], segments=20)
    m.add(*pot[:3], pot[3])
    return m.bake()


def leaf_cards(rng, n_leaves=48):
    m = MeshAcc()
    for _ in range(n_leaves):
        w = rng.uniform(0.25, 0.5)
        h = rng.uniform(0.4, 0.8)
        p, n, t, i = quad_card(w, h)
        yaw = rng.uniform(0, 2 * np.pi)
        pitch = rng.uniform(-0.8, -0.1)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        ry = np.asarray([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rx = np.asarray([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        r = ry @ rx
        off = np.asarray([rng.uniform(-0.1, 0.1), 0.3,
                          rng.uniform(-0.1, 0.1)])
        m.add(p @ r.T + off, n @ r.T, t, i)
    return m.bake()


# ---------------------------------------------------------------------------
# procedural textures (RGBA u8 arrays, written as PNG)
# ---------------------------------------------------------------------------


def tex_stone(rng, size=256, base=(168, 160, 150), tile=8):
    y, x = np.mgrid[0:size, 0:size]
    noise = rng.normal(0, 1, (size // 8, size // 8))
    noise = np.kron(noise, np.ones((8, 8)))[:size, :size]
    grid = (((y // (size // tile)) + (x // (size // tile))) % 2) * 10.0
    mortar = ((y % (size // tile) < 2) | (x % (size // tile) < 2)) * -35.0
    v = np.clip(np.asarray(base)[None, None]
                + (noise * 8 + grid + mortar)[..., None], 0, 255)
    return np.concatenate([v, np.full((size, size, 1), 255)],
                          -1).astype(np.uint8)


def tex_brick(rng, size=256, base=(150, 92, 72)):
    y, x = np.mgrid[0:size, 0:size]
    bh, bw = size // 8, size // 4
    row = y // bh
    xo = (x + (row % 2) * bw // 2) % bw
    mortar = ((y % bh < 3) | (xo < 3))
    shade = rng.normal(0, 6, 8)
    v = (np.asarray(base)[None, None] + np.where(
        mortar[..., None], 60, 0) + shade[row % 8][..., None])
    n = rng.normal(0, 5, (size, size, 1))
    v = np.clip(v + n, 0, 255)
    return np.concatenate([v, np.full((size, size, 1), 255)],
                          -1).astype(np.uint8)


def tex_wood(rng, size=256, base=(120, 82, 50)):
    y, x = np.mgrid[0:size, 0:size]
    rings = np.sin(x / size * 40 + rng.normal(0, 1.2, (size, size)) * 0.6)
    v = np.asarray(base)[None, None] + rings[..., None] * 14
    v = np.clip(v + rng.normal(0, 4, (size, size, 1)), 0, 255)
    return np.concatenate([v, np.full((size, size, 1), 255)],
                          -1).astype(np.uint8)


def tex_fabric(rng, size=256, base=(140, 30, 34)):
    y, x = np.mgrid[0:size, 0:size]
    weave = (np.sin(x * 0.9) + np.sin(y * 0.9)) * 6
    stripe = ((y // 32) % 2) * 18.0
    v = np.clip(np.asarray(base)[None, None]
                + (weave + stripe)[..., None], 0, 255)
    return np.concatenate([v, np.full((size, size, 1), 255)],
                          -1).astype(np.uint8)


def tex_leaf(rng, size=256):
    """RGBA leaf cluster with real alpha holes (cutout foliage)."""
    img = np.zeros((size, size, 4), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for _ in range(9):
        cx, cy = rng.uniform(0.15, 0.85, 2)
        ang = rng.uniform(0, np.pi)
        la, lb = rng.uniform(0.18, 0.3), rng.uniform(0.05, 0.1)
        dx, dy = xx - cx, yy - cy
        u = dx * np.cos(ang) + dy * np.sin(ang)
        v = -dx * np.sin(ang) + dy * np.cos(ang)
        inside = (u / la) ** 2 + (v / lb) ** 2 < 1.0
        g = rng.integers(90, 150)
        col = np.asarray([30, g, 35, 255], np.uint8)
        vein = np.abs(v) < 0.004
        img[inside] = col
        img[inside & vein] = [20, max(g - 40, 30), 25, 255]
    return img


def tex_banner(rng, size=256, base=(40, 60, 140)):
    """RGBA banner with an emblem and worn-out alpha holes + fringe."""
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = base[0]
    img[..., 1] = base[1]
    img[..., 2] = base[2]
    img[..., 3] = 255
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    emblem = ((xx - 0.5) ** 2 + (yy - 0.4) ** 2) < 0.04
    img[emblem, 0:3] = [220, 190, 80]
    # fringe: triangular bottom cut
    fr = yy > 0.9 + 0.06 * np.sin(xx * 40)
    img[fr, 3] = 0
    # moth holes
    for _ in range(14):
        cx, cy, r = rng.uniform(0.05, 0.95), rng.uniform(0.1, 0.9), \
            rng.uniform(0.01, 0.04)
        hole = ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r
        img[hole, 3] = 0
    return img


def tex_normal_bumps(rng, size=256, bumps=40):
    h = np.zeros((size, size), np.float32)
    y, x = np.mgrid[0:size, 0:size]
    for _ in range(bumps):
        cx, cy = rng.uniform(0, size, 2)
        r = rng.uniform(6, 24)
        d2 = (x - cx) ** 2 + (y - cy) ** 2
        h += np.exp(-d2 / (r * r)) * rng.uniform(0.3, 1.0)
    gx = np.gradient(h, axis=1)
    gy = np.gradient(h, axis=0)
    n = np.stack([-gx * 3, -gy * 3, np.ones_like(h)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = ((n * 0.5 + 0.5) * 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((size, size, 1), 255, np.uint8)],
                          -1)


def tex_mr(rough, metal, size=64):
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = int(rough * 255)           # G = roughness
    img[..., 2] = int(metal * 255)           # B = metallic
    img[..., 3] = 255
    return img


# ---------------------------------------------------------------------------
# GLB writer with meshopt compression
# ---------------------------------------------------------------------------

class GlbBuilder:
    def __init__(self, compress=True):
        self.bin = bytearray()
        self.views = []
        self.accessors = []
        self.meshes = []
        self.materials = []
        self.images = []
        self.textures = []
        self.nodes = []
        self.compress = compress
        self.fallback_bytes = 0

    def _pad(self, align=4):
        while len(self.bin) % align:
            self.bin.append(0)

    def add_view_raw(self, data: bytes, stride=None):
        self._pad()
        v = {"buffer": 0, "byteOffset": len(self.bin),
             "byteLength": len(data)}
        if stride:
            v["byteStride"] = stride
        self.bin += data
        self.views.append(v)
        return len(self.views) - 1

    def add_view_meshopt(self, raw: np.ndarray, stride: int, mode: str):
        """raw: (count, stride) u8 for ATTRIBUTES, or u32 array for
        TRIANGLES."""
        if mode == "ATTRIBUTES":
            count = raw.shape[0]
            enc = M.encode_vertex_buffer(raw)
            length = count * stride
        else:
            count = raw.size
            enc = M.encode_index_buffer(raw)
            length = count * stride
        self._pad()
        ext = {"buffer": 0, "byteOffset": len(self.bin),
               "byteLength": len(enc), "byteStride": stride,
               "count": count, "mode": mode}
        self.bin += enc
        v = {"buffer": 1, "byteOffset": self.fallback_bytes,
             "byteLength": length,
             "extensions": {"EXT_meshopt_compression": ext}}
        if mode == "ATTRIBUTES":
            v["byteStride"] = stride
        self.fallback_bytes += length
        self.views.append(v)
        return len(self.views) - 1

    def add_mesh(self, name, pos, nrm, uv, idx, material):
        pos = np.ascontiguousarray(pos, np.float32)
        nrm = np.ascontiguousarray(nrm, np.float32)
        uv = np.ascontiguousarray(uv, np.float32)
        idx = np.ascontiguousarray(idx, np.uint32)
        inter = np.concatenate([pos, nrm, uv], 1).view(np.uint8)
        if self.compress:
            vview = self.add_view_meshopt(inter, 32, "ATTRIBUTES")
            iview = self.add_view_meshopt(idx, 4, "TRIANGLES")
        else:
            vview = self.add_view_raw(inter.tobytes(), stride=32)
            iview = self.add_view_raw(idx.tobytes())
        n = len(pos)
        a0 = len(self.accessors)
        self.accessors += [
            {"bufferView": vview, "byteOffset": 0, "componentType": 5126,
             "count": n, "type": "VEC3",
             "min": [float(x) for x in pos.min(0)],
             "max": [float(x) for x in pos.max(0)]},
            {"bufferView": vview, "byteOffset": 12, "componentType": 5126,
             "count": n, "type": "VEC3"},
            {"bufferView": vview, "byteOffset": 24, "componentType": 5126,
             "count": n, "type": "VEC2"},
            {"bufferView": iview, "componentType": 5125,
             "count": int(idx.size), "type": "SCALAR"},
        ]
        self.meshes.append({"name": name, "primitives": [{
            "attributes": {"POSITION": a0, "NORMAL": a0 + 1,
                           "TEXCOORD_0": a0 + 2},
            "indices": a0 + 3, "material": material}]})
        return len(self.meshes) - 1

    def add_texture(self, img: np.ndarray):
        data = encode_png(img)
        view = self.add_view_raw(data)
        self.images.append({"bufferView": view, "mimeType": "image/png"})
        self.textures.append({"source": len(self.images) - 1})
        return len(self.textures) - 1

    def add_material(self, name, base_tex=-1, normal_tex=-1, mr_tex=-1,
                     base_color=(1, 1, 1, 1), rough=0.9, metal=0.0,
                     alpha_mode="OPAQUE", cutoff=0.5, double_sided=False,
                     emissive=(0, 0, 0)):
        m = {"name": name, "pbrMetallicRoughness": {
            "baseColorFactor": list(base_color),
            "roughnessFactor": rough, "metallicFactor": metal}}
        if base_tex >= 0:
            m["pbrMetallicRoughness"]["baseColorTexture"] = {
                "index": base_tex}
        if mr_tex >= 0:
            m["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {
                "index": mr_tex}
        if normal_tex >= 0:
            m["normalTexture"] = {"index": normal_tex}
        if alpha_mode != "OPAQUE":
            m["alphaMode"] = alpha_mode
            if alpha_mode == "MASK":
                m["alphaCutoff"] = cutoff
        if double_sided:
            m["doubleSided"] = True
        if any(emissive):
            m["emissiveFactor"] = list(emissive)
        self.materials.append(m)
        return len(self.materials) - 1

    def add_node(self, name, mesh=-1, t=(0, 0, 0), r=(0, 0, 0, 1),
                 s=(1, 1, 1), camera=-1, light=-1):
        n = {"name": name}
        if mesh >= 0:
            n["mesh"] = mesh
        if tuple(t) != (0, 0, 0):
            n["translation"] = [float(x) for x in t]
        if tuple(r) != (0, 0, 0, 1):
            n["rotation"] = [float(x) for x in r]
        if tuple(s) != (1, 1, 1):
            n["scale"] = [float(x) for x in s]
        if camera >= 0:
            n["camera"] = camera
        if light >= 0:
            n["extensions"] = {"KHR_lights_punctual": {"light": light}}
        self.nodes.append(n)
        return len(self.nodes) - 1

    def finish(self, path, cameras, lights):
        self._pad()
        gltf = {
            "asset": {"version": "2.0",
                      "generator": "toyrenderer_tpu_torch gen_scene"},
            "buffers": [{"byteLength": len(self.bin)}],
            "bufferViews": self.views,
            "accessors": self.accessors,
            "meshes": self.meshes,
            "materials": self.materials,
            "images": self.images,
            "textures": self.textures,
            "samplers": [{"wrapS": 10497, "wrapT": 10497}],
            "nodes": self.nodes,
            "scenes": [{"nodes": list(range(len(self.nodes)))}],
            "scene": 0,
            "cameras": cameras,
            "extensions": {"KHR_lights_punctual": {"lights": lights}},
            "extensionsUsed": ["KHR_lights_punctual"],
        }
        if self.compress:
            gltf["buffers"].append(
                {"byteLength": max(self.fallback_bytes, 4),
                 "extensions": {"EXT_meshopt_compression":
                                {"fallback": True}}})
            gltf["extensionsUsed"].append("EXT_meshopt_compression")
            gltf["extensionsRequired"] = ["EXT_meshopt_compression"]
        if not self.images:
            gltf.pop("images")
            gltf.pop("textures")
        js = json.dumps(gltf, separators=(",", ":")).encode()
        js += b" " * ((-len(js)) % 4)
        total = 12 + 8 + len(js) + 8 + len(self.bin)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, total))
            f.write(struct.pack("<II", len(js), 0x4E4F534A))
            f.write(js)
            f.write(struct.pack("<II", len(self.bin), 0x004E4942))
            f.write(bytes(self.bin))


# ---------------------------------------------------------------------------
# the courtyard
# ---------------------------------------------------------------------------

def build(out_path, compress=True, scale=1.0, seed=7):
    rng = np.random.default_rng(seed)
    g = GlbBuilder(compress=compress)

    # --- textures + materials ------------------------------------------------
    bump = g.add_texture(tex_normal_bumps(rng))
    mr_rough = g.add_texture(tex_mr(0.92, 0.0))
    mr_glossy = g.add_texture(tex_mr(0.35, 0.0))
    stones = []
    for base in ((168, 160, 150), (150, 148, 142), (176, 166, 148),
                 (140, 138, 132)):
        t = g.add_texture(tex_stone(rng, base=base))
        stones.append(g.add_material(
            f"stone{len(stones)}", base_tex=t, normal_tex=bump,
            mr_tex=mr_rough))
    marble_t = g.add_texture(tex_stone(rng, base=(208, 204, 196), tile=2))
    marble = g.add_material("marble", base_tex=marble_t, mr_tex=mr_glossy)
    brick_t = g.add_texture(tex_brick(rng))
    brick = g.add_material("brick", base_tex=brick_t, normal_tex=bump,
                           mr_tex=mr_rough)
    brick2_t = g.add_texture(tex_brick(rng, base=(132, 84, 66)))
    brick2 = g.add_material("brick2", base_tex=brick2_t, normal_tex=bump,
                            mr_tex=mr_rough)
    wood_t = g.add_texture(tex_wood(rng))
    wood = g.add_material("wood", base_tex=wood_t, mr_tex=mr_rough)
    pot_t = g.add_texture(tex_stone(rng, base=(150, 96, 70), tile=1))
    pot_m = g.add_material("terracotta", base_tex=pot_t, mr_tex=mr_rough)
    fabrics = []
    for base in ((140, 30, 34), (32, 80, 120), (120, 100, 30)):
        t = g.add_texture(tex_fabric(rng, base=base))
        fabrics.append(g.add_material(
            f"fabric{len(fabrics)}", base_tex=t, double_sided=True,
            mr_tex=mr_rough))
    leaves = []
    for _ in range(3):
        t = g.add_texture(tex_leaf(rng))
        leaves.append(g.add_material(
            f"leaf{len(leaves)}", base_tex=t, alpha_mode="MASK",
            cutoff=0.5, double_sided=True, mr_tex=mr_rough))
    banners = []
    for base in ((40, 60, 140), (140, 40, 44), (44, 110, 60)):
        t = g.add_texture(tex_banner(rng, base=base))
        banners.append(g.add_material(
            f"banner{len(banners)}", base_tex=t, alpha_mode="MASK",
            cutoff=0.5, double_sided=True, mr_tex=mr_rough))
    gold = g.add_material("gold", base_color=(0.9, 0.75, 0.3, 1.0),
                          rough=0.3, metal=1.0)

    # --- meshes -------------------------------------------------------------
    col_len, col_wid = 36.0, 16.0       # courtyard inner dimensions
    # dense, skewed tessellation (Sponza-class): worn slabs/walls are
    # displaced grids, columns are high-segment fluted lathes
    slab = g.add_mesh("slab", *box(2.0, 0.12, 2.0, uv_scale=0.5, tess=10,
                                   bump=0.012, rng=rng), stones[0])
    slab2 = g.add_mesh("slab2", *box(2.0, 0.12, 2.0, uv_scale=0.5,
                                     tess=10, bump=0.012, rng=rng),
                       stones[1])
    col_prof = [(0.5, 0.0), (0.52, 0.12), (0.38, 0.3)]
    col_prof += [(0.36 + 0.015 * np.sin(k * 0.9), 0.3 + 3.3 * k / 22)
                 for k in range(1, 22)]
    col_prof += [(0.4, 3.8), (0.55, 3.92), (0.56, 4.0)]
    column = g.add_mesh("column", *lathe(col_prof, segments=44,
                                         flutes=1.0), marble)
    arch_m = g.add_mesh("arch", *arch(4.0, 3.8, 0.5, 0.45, segments=44),
                        brick)
    wall = g.add_mesh("wall", *box(2.0, 6.5, 0.5, uv_scale=0.5, tess=12,
                                   bump=0.02, rng=rng), brick2)
    beam = g.add_mesh("beam", *box(0.3, 0.3, col_wid + 2, uv_scale=1.0,
                                   tess=4), wood)
    curtain_m = g.add_mesh("curtain", *curtain(3.2, 4.5, nx=56, ny=36),
                           fabrics[0])
    curtain_m2 = g.add_mesh("curtain2", *curtain(3.2, 4.5, waves=4.0,
                                                 nx=56, ny=36),
                            fabrics[1])
    banner_meshes = [g.add_mesh(f"banner{i}", *quad_card(1.6, 2.6), b)
                     for i, b in enumerate(banners)]
    pot = g.add_mesh("pot", *plant(rng), pot_m)
    leaf_meshes = [g.add_mesh(f"leaves{i}", *leaf_cards(rng, 90), m)
                   for i, m in enumerate(leaves)]
    vase = g.add_mesh("vase", *lathe(
        [(0.12, 0.0), (0.3, 0.25), (0.16, 0.6), (0.14, 0.75),
         (0.18, 0.8)], segments=36), gold)
    crate = g.add_mesh("crate", *box(0.9, 0.9, 0.9, uv_scale=1.0,
                                     tess=3), wood)
    # centerpiece statue: high-tessellation lathe on a plinth
    statue_prof = [(0.9, 0.0), (0.95, 0.1), (0.6, 0.22)]
    statue_prof += [(0.45 + 0.2 * abs(np.sin(k * 0.55)),
                     0.25 + 2.6 * k / 30) for k in range(1, 30)]
    statue_prof += [(0.12, 2.9), (0.3, 3.1), (0.02, 3.3)]
    statue = g.add_mesh("statue", *lathe(statue_prof, segments=64),
                        marble)

    # --- layout -------------------------------------------------------------
    # one courtyard CELL; `scale` >= 2 replicates it on a grid into a
    # plaza (shared meshes/materials, ~scale^2 x the instances and
    # drawn triangles -- the Bistro-scale stress content)
    def cell(ox, oz, pref):
        def addn(name, mesh, t, r=None):
            kw = {'r': r} if r is not None else {}
            g.add_node(pref + name, mesh=mesh,
                       t=(t[0] + ox, t[1], t[2] + oz), **kw)
        # floor
        nx = int(col_len // 2) + 2
        nz = int(col_wid // 2) + 2
        for i in range(nx):
            for j in range(nz):
                x = (i - nx / 2 + 0.5) * 2
                z = (j - nz / 2 + 0.5) * 2
                addn(f"floor{i}_{j}",
                     slab if (i + j) % 2 == 0 else slab2, (x, 0, z))
        # two colonnade rows + arches
        n_cols = 9
        for i in range(n_cols):
            x = (i - n_cols / 2 + 0.5) * 4.0
            for z in (-col_wid / 2 + 1.5, col_wid / 2 - 1.5):
                addn(f"col{i}_{z:.0f}", column, (x, 0.1, z))
        for i in range(n_cols - 1):
            x = (i - n_cols / 2 + 1.0) * 4.0
            for z in (-col_wid / 2 + 1.5, col_wid / 2 - 1.5):
                addn(f"arch{i}_{z:.0f}", arch_m, (x, 0.1, z))
        # outer walls
        nwx = int(col_len // 2) + 2
        for i in range(nwx):
            x = (i - nwx / 2 + 0.5) * 2
            addn(f"walln{i}", wall, (x, 0, -col_wid / 2 - 1.0))
            addn(f"walls{i}", wall, (x, 0, col_wid / 2 + 1.0))
        side = [0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)]
        nwz = int(col_wid // 2) + 2
        for j in range(nwz):
            z = (j - nwz / 2 + 0.5) * 2
            addn(f"walle{j}", wall, (col_len / 2 + 1.0, 0, z), r=side)
            addn(f"wallw{j}", wall, (-col_len / 2 - 1.0, 0, z), r=side)
        # roof beams
        for i in range(int(col_len // 2)):
            x = (i - col_len / 4 + 0.5) * 2
            addn(f"beam{i}", beam, (x, 6.2, 0))
        # curtains between some columns
        rot90 = [0.0, np.sin(np.pi / 4), 0.0, np.cos(np.pi / 4)]
        for i, xi in enumerate((-14, -6, 2, 10)):
            addn(f"curt{i}",
                 curtain_m if i % 2 == 0 else curtain_m2,
                 (xi, 1.2, -col_wid / 2 + 1.5))
            addn(f"curtb{i}",
                 curtain_m2 if i % 2 == 0 else curtain_m,
                 (xi + 2, 1.2, col_wid / 2 - 1.5))
        # banners hanging from beams
        for i in range(6):
            x = (i - 2.5) * 5.5
            addn(f"ban{i}", banner_meshes[i % 3],
                 (x, 3.4, (-1) ** i * 2.0),
                 r=rot90 if i % 2 == 0 else (0, 0, 0, 1))
        # plants along the colonnade
        k = 0
        for i in range(n_cols - 1):
            x = (i - n_cols / 2 + 1.0) * 4.0
            for z in (-col_wid / 2 + 2.6, col_wid / 2 - 2.6):
                addn(f"pot{k}", pot, (x, 0.12, z))
                addn(f"leaves{k}", leaf_meshes[k % 3], (x, 0.12, z))
                k += 1
        # centerpiece
        addn("statue", statue, (3.0, 0.12, 0.0))
        # props
        for i in range(8):
            x = rng.uniform(-col_len / 2 + 3, col_len / 2 - 3)
            z = rng.uniform(-col_wid / 2 + 3, col_wid / 2 - 3)
            if i % 2 == 0:
                addn(f"vase{i}", vase, (x, 0.12, z))
            else:
                yaw = rng.uniform(0, np.pi)
                addn(f"crate{i}", crate, (x, 0.12, z),
                     r=(0, np.sin(yaw / 2), 0, np.cos(yaw / 2)))

    n_cells = max(int(round(scale)), 1)
    pitch_x, pitch_z = col_len + 8.0, col_wid + 10.0
    for cx in range(n_cells):
        for cz in range(n_cells):
            ox = (cx - (n_cells - 1) / 2) * pitch_x
            oz = (cz - (n_cells - 1) / 2) * pitch_z
            cell(ox, oz, "" if n_cells == 1 else f"c{cx}{cz}_")

    # camera at one end looking down the colonnade; sun tilted in
    cameras = [{"type": "perspective", "perspective":
                {"yfov": 1.05, "znear": 0.05}}]
    # camera looks down its node's -Z; rotate -Z onto +x (down the
    # colonnade): -90 deg about +Y, slightly nudged
    cy = -(np.pi / 2 - 0.06)
    g.add_node("camera", camera=0, t=(-col_len / 2 + 2.5, 2.2, 0.4),
               r=(0.0, float(np.sin(cy / 2)), 0.0, float(np.cos(cy / 2))))
    lights = [{"type": "directional", "color": [1.0, 0.96, 0.9],
               "intensity": 6.0, "name": "sun"}]
    # sun node: -Z of the node is the light direction; tilt down+sideways
    g.add_node("sun", light=0,
               r=[-0.35, 0.28, 0.12, float(np.sqrt(
                   1 - 0.35 ** 2 - 0.28 ** 2 - 0.12 ** 2))])

    g.finish(out_path, cameras, lights)
    total_tris = sum(
        g.accessors[m["primitives"][0]["indices"]]["count"] // 3
        * sum(1 for n in g.nodes if n.get("mesh") == mi)
        for mi, m in enumerate(g.meshes))
    return dict(meshes=len(g.meshes), nodes=len(g.nodes),
                materials=len(g.materials), textures=len(g.textures),
                drawn_tris=total_tris)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="resources/courtyard.glb")
    p.add_argument("--no-compress", action="store_true")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    info = build(args.out, compress=not args.no_compress,
                 scale=args.scale, seed=args.seed)
    info["bytes"] = os.path.getsize(args.out)
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
