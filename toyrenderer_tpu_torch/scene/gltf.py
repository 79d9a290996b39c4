"""Pure-Python glTF 2.0 loader producing numpy arrays.

The port's own copy of toyrenderer_tpu/scene/gltf.py (same numpy logic,
so both packages build the same scene), with its keyframe animation
channels (translation / rotation / scale; CUBICSPLINE keeps its value
keys, played linearly).

Capability counterpart of the reference's cgltf-based loader
(source/SceneLoading.cpp:24-1143): meshes/primitives with POSITION / NORMAL /
TEXCOORD_0 / TANGENT, indices, pbrMetallicRoughness (+ spec-gloss fallback,
transmission -> blend, double-sided -> mask promotion per
SceneLoading.cpp:371-537), node hierarchy with TRS or matrix, perspective
cameras, KHR_lights_punctual directional sun, .gltf + .bin / data-URI /
.glb containers.  No external glTF library is used (none is installed).

Design difference from the reference: output is numpy struct-of-arrays ready
for dense TPU upload, not interleaved vertex structs.
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# glTF componentType -> numpy dtype
_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8,
    5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}

# Alpha modes (matches the semantic of the reference's material handling)
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2


@dataclass
class GltfPrimitive:
    positions: np.ndarray            # (N, 3) f32
    normals: np.ndarray              # (N, 3) f32
    uvs: np.ndarray                  # (N, 2) f32
    indices: np.ndarray              # (M,) u32, triangles
    material: int                    # material index (always valid)


@dataclass
class GltfMesh:
    name: str
    primitives: list[GltfPrimitive]


@dataclass
class GltfMaterial:
    name: str = ""
    base_color: np.ndarray = field(
        default_factory=lambda: np.ones(4, np.float32))
    metallic: float = 0.0
    roughness: float = 1.0
    emissive: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    alpha_mode: int = ALPHA_OPAQUE
    alpha_cutoff: float = 0.5
    double_sided: bool = False
    base_color_texture: int = -1
    metallic_roughness_texture: int = -1
    normal_texture: int = -1
    emissive_texture: int = -1


@dataclass
class GltfNode:
    name: str
    parent: int                      # -1 for roots
    translation: np.ndarray          # (3,)
    rotation: np.ndarray             # (4,) xyzw
    scale: np.ndarray                # (3,)
    matrix: np.ndarray | None        # (4, 4) column-vector or None
    mesh: int = -1
    camera: int = -1
    light: int = -1


@dataclass
class GltfCamera:
    name: str
    yfov: float
    znear: float
    aspect: float | None


@dataclass
class GltfLight:
    name: str
    kind: str                        # 'directional' | 'point' | 'spot'
    color: np.ndarray
    intensity: float


@dataclass
class GltfTexture:
    uri: str | None                  # relative path, or None if embedded
    image_bytes: bytes | None        # raw container bytes if embedded
    wrap_s: int = 10497              # REPEAT
    wrap_t: int = 10497


@dataclass
class GltfAnimationChannel:
    node: int
    path: str                        # 'translation' | 'rotation' | 'scale'
    times: np.ndarray                # (K,) f32
    values: np.ndarray               # (K, 3|4) f32
    interpolation: str = "LINEAR"    # 'LINEAR' | 'STEP'


@dataclass
class GltfDocument:
    meshes: list[GltfMesh]
    materials: list[GltfMaterial]
    nodes: list[GltfNode]            # parent-before-child order NOT guaranteed
    root_nodes: list[int]
    cameras: list[GltfCamera]
    lights: list[GltfLight]
    textures: list[GltfTexture]
    base_dir: Path
    animations: list[GltfAnimationChannel] = field(default_factory=list)


def _read_buffer(buf: dict, base_dir: Path, glb_bin: bytes | None) -> bytes:
    uri = buf.get("uri")
    if uri is None:
        if buf.get("extensions", {}).get(
                "EXT_meshopt_compression", {}).get("fallback"):
            return b""                   # fallback buffer: data optional
        assert glb_bin is not None, "buffer without uri outside GLB"
        return glb_bin
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    return (base_dir / uri).read_bytes()


def _materialize_views(gltf: dict, buffers: list[bytes]) -> list[bytes]:
    """Per-bufferView bytes, decoding EXT_meshopt_compression views
    (SceneLoading.cpp:239-301 parity — the reference decompresses every
    compressed view up front too)."""
    views: list[bytes] = []
    for bv in gltf.get("bufferViews", []):
        ext = bv.get("extensions", {}).get("EXT_meshopt_compression")
        if ext is not None:
            from toyrenderer_tpu_torch.scene.meshopt import decode_buffer_view
            views.append(decode_buffer_view(ext, buffers[ext["buffer"]]))
            continue
        data = buffers[bv["buffer"]]
        off = bv.get("byteOffset", 0)
        views.append(data[off:off + bv.get("byteLength",
                                           len(data) - off)])
    return views


def _view_stride(gltf: dict, view_idx: int) -> int:
    bv = gltf["bufferViews"][view_idx]
    ext = bv.get("extensions", {}).get("EXT_meshopt_compression")
    if ext is not None:
        return ext["byteStride"]
    return bv.get("byteStride", 0)


def _read_accessor(gltf: dict, views: list[bytes], idx: int) -> np.ndarray:
    """Decode accessor `idx` to an (count, comps) numpy array (f32/u32)."""
    acc = gltf["accessors"][idx]
    count = acc["count"]
    comps = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize
    out = np.zeros((count, comps), dtype=dtype)

    if "bufferView" in acc:
        data = views[acc["bufferView"]]
        start = acc.get("byteOffset", 0)
        stride = _view_stride(gltf, acc["bufferView"]) or comps * itemsize
        if stride == comps * itemsize:
            flat = np.frombuffer(
                data, dtype=dtype, count=count * comps, offset=start)
            out = flat.reshape(count, comps).copy()
        else:
            raw = np.frombuffer(data, dtype=np.uint8)
            for i in range(comps):
                col_off = start + i * itemsize
                col = np.lib.stride_tricks.as_strided(
                    raw[col_off:], shape=(count, itemsize),
                    strides=(stride, 1)).copy()
                out[:, i] = col.view(dtype)[:, 0]

    # sparse accessors (rare; used by some exporters for morph-free edits)
    sparse = acc.get("sparse")
    if sparse:
        sc = sparse["count"]
        iv = sparse["indices"]
        ind_dtype = _COMPONENT_DTYPES[iv["componentType"]]
        ind = np.frombuffer(views[iv["bufferView"]], dtype=ind_dtype,
                            count=sc, offset=iv.get("byteOffset", 0))
        vv = sparse["values"]
        val = np.frombuffer(views[vv["bufferView"]], dtype=dtype,
                            count=sc * comps,
                            offset=vv.get("byteOffset", 0))
        out[ind] = val.reshape(sc, comps)

    if acc.get("normalized") and dtype != np.float32:
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / float(info.max)
    return out


def _accessor_f32(gltf, views, idx):
    a = _read_accessor(gltf, views, idx)
    return a.astype(np.float32)


def _parse_json_and_bin(path: Path) -> tuple[dict, bytes | None]:
    raw = path.read_bytes()
    if raw[:4] == b"glTF":                       # GLB container
        _, _, _ = struct.unpack("<III", raw[:12])
        off = 12
        doc = None
        bin_chunk = None
        while off < len(raw):
            clen, ctype = struct.unpack("<II", raw[off:off + 8])
            chunk = raw[off + 8:off + 8 + clen]
            if ctype == 0x4E4F534A:              # 'JSON'
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:            # 'BIN'
                bin_chunk = chunk
            off += 8 + clen
        assert doc is not None
        return doc, bin_chunk
    return json.loads(raw), None


def load_gltf(path: str | Path) -> GltfDocument:
    """Parse a .gltf/.glb file into a GltfDocument of numpy arrays."""
    path = Path(path)
    gltf, glb_bin = _parse_json_and_bin(path)
    base_dir = path.parent
    buffers = [_read_buffer(b, base_dir, glb_bin)
               for b in gltf.get("buffers", [])]
    views = _materialize_views(gltf, buffers)

    # --- materials (always at least one default, like the reference's
    #     fallback material path) -------------------------------------------
    materials: list[GltfMaterial] = []
    for m in gltf.get("materials", []):
        mat = GltfMaterial(name=m.get("name", ""))
        pbr = m.get("pbrMetallicRoughness", {})
        mat.base_color = np.asarray(
            pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        mat.metallic = float(pbr.get("metallicFactor", 1.0))
        mat.roughness = float(pbr.get("roughnessFactor", 1.0))
        if "baseColorTexture" in pbr:
            mat.base_color_texture = pbr["baseColorTexture"]["index"]
        if "metallicRoughnessTexture" in pbr:
            mat.metallic_roughness_texture = (
                pbr["metallicRoughnessTexture"]["index"])
        # spec-gloss extension fallback (reference converts it too)
        sg = m.get("extensions", {}).get("KHR_materials_pbrSpecularGlossiness")
        if sg is not None:
            mat.base_color = np.asarray(
                sg.get("diffuseFactor", [1, 1, 1, 1]), np.float32)
            mat.roughness = 1.0 - float(sg.get("glossinessFactor", 1.0))
            if "diffuseTexture" in sg:
                mat.base_color_texture = sg["diffuseTexture"]["index"]
        mat.emissive = np.asarray(
            m.get("emissiveFactor", [0, 0, 0]), np.float32)
        strength = m.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {})
        mat.emissive = mat.emissive * float(
            strength.get("emissiveStrength", 1.0))
        if "normalTexture" in m:
            mat.normal_texture = m["normalTexture"]["index"]
        if "emissiveTexture" in m:
            mat.emissive_texture = m["emissiveTexture"]["index"]
        mode = m.get("alphaMode", "OPAQUE")
        mat.alpha_mode = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASK,
                          "BLEND": ALPHA_BLEND}[mode]
        mat.alpha_cutoff = float(m.get("alphaCutoff", 0.5))
        mat.double_sided = bool(m.get("doubleSided", False))
        # transmission -> blend, like SceneLoading.cpp:371-537
        if "KHR_materials_transmission" in m.get("extensions", {}):
            mat.alpha_mode = ALPHA_BLEND
        materials.append(mat)
    if not materials:
        materials.append(GltfMaterial(name="default"))

    # --- textures / images -------------------------------------------------
    samplers = gltf.get("samplers", [])
    textures: list[GltfTexture] = []
    for t in gltf.get("textures", []):
        img = gltf["images"][t["source"]] if "source" in t else {}
        uri = img.get("uri")
        image_bytes = None
        if uri and uri.startswith("data:"):
            image_bytes = base64.b64decode(uri.split(",", 1)[1])
            uri = None
        elif uri is None and "bufferView" in img:
            image_bytes = views[img["bufferView"]]
        tex = GltfTexture(uri=uri, image_bytes=image_bytes)
        if "sampler" in t and t["sampler"] < len(samplers):
            s = samplers[t["sampler"]]
            tex.wrap_s = s.get("wrapS", 10497)
            tex.wrap_t = s.get("wrapT", 10497)
        textures.append(tex)

    # --- meshes -------------------------------------------------------------
    meshes: list[GltfMesh] = []
    for m in gltf.get("meshes", []):
        prims = []
        for p in m.get("primitives", []):
            if p.get("mode", 4) != 4:            # triangles only
                continue
            attrs = p["attributes"]
            pos = _accessor_f32(gltf, views, attrs["POSITION"])[:, :3]
            n_verts = pos.shape[0]
            if "NORMAL" in attrs:
                nrm = _accessor_f32(gltf, views, attrs["NORMAL"])[:, :3]
            else:
                nrm = np.zeros((n_verts, 3), np.float32)
            if "TEXCOORD_0" in attrs:
                uv = _accessor_f32(gltf, views, attrs["TEXCOORD_0"])[:, :2]
            else:
                uv = np.zeros((n_verts, 2), np.float32)
            if "indices" in p:
                idx = _read_accessor(gltf, views, p["indices"])[:, 0]
                idx = idx.astype(np.uint32)
            else:
                idx = np.arange(n_verts, dtype=np.uint32)
            if "NORMAL" not in attrs:
                nrm = _face_normals_to_vertex(pos, idx)
            prims.append(GltfPrimitive(
                positions=pos, normals=nrm, uvs=uv, indices=idx,
                material=p.get("material", len(materials) - 1)
                if p.get("material", -1) >= 0 else len(materials) - 1))
        meshes.append(GltfMesh(name=m.get("name", ""), primitives=prims))

    # --- nodes ---------------------------------------------------------------
    raw_nodes = gltf.get("nodes", [])
    parents = [-1] * len(raw_nodes)
    for i, n in enumerate(raw_nodes):
        for c in n.get("children", []):
            parents[c] = i
    nodes: list[GltfNode] = []
    for i, n in enumerate(raw_nodes):
        mat = None
        if "matrix" in n:
            mat = np.asarray(n["matrix"], np.float32).reshape(4, 4).T
        light = n.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("light", -1)
        nodes.append(GltfNode(
            name=n.get("name", f"node{i}"),
            parent=parents[i],
            translation=np.asarray(n.get("translation", [0, 0, 0]), np.float32),
            rotation=np.asarray(n.get("rotation", [0, 0, 0, 1]), np.float32),
            scale=np.asarray(n.get("scale", [1, 1, 1]), np.float32),
            matrix=mat,
            mesh=n.get("mesh", -1),
            camera=n.get("camera", -1),
            light=light,
        ))
    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [{}])
    root_nodes = scenes[scene_idx].get("nodes", list(range(len(nodes))))

    # --- cameras / lights ----------------------------------------------------
    cameras = []
    for c in gltf.get("cameras", []):
        if c.get("type") != "perspective":
            continue
        p = c["perspective"]
        cameras.append(GltfCamera(
            name=c.get("name", ""), yfov=float(p["yfov"]),
            znear=float(p.get("znear", 0.1)),
            aspect=p.get("aspectRatio")))
    lights = []
    for l in gltf.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("lights", []):
        lights.append(GltfLight(
            name=l.get("name", ""), kind=l.get("type", "directional"),
            color=np.asarray(l.get("color", [1, 1, 1]), np.float32),
            intensity=float(l.get("intensity", 1.0))))

    # --- animations ----------------------------------------------------------
    channels: list[GltfAnimationChannel] = []
    for anim in gltf.get("animations", []):
        samplers_a = anim.get("samplers", [])
        for ch in anim.get("channels", []):
            target = ch["target"]
            if target.get("path") not in ("translation", "rotation", "scale"):
                continue
            s = samplers_a[ch["sampler"]]
            times = _accessor_f32(gltf, views, s["input"])[:, 0]
            values = _accessor_f32(gltf, views, s["output"])
            interp = s.get("interpolation", "LINEAR")
            if interp == "CUBICSPLINE":
                # keep only the value keys (drop in/out tangents)
                values = values.reshape(len(times), 3, -1)[:, 1, :]
                interp = "LINEAR"
            channels.append(GltfAnimationChannel(
                node=target["node"], path=target["path"],
                times=times, values=values, interpolation=interp))

    return GltfDocument(
        meshes=meshes, materials=materials, nodes=nodes,
        root_nodes=root_nodes, cameras=cameras, lights=lights,
        textures=textures, base_dir=base_dir, animations=channels)


def _face_normals_to_vertex(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals when the asset has none."""
    tri = idx.reshape(-1, 3)
    e1 = pos[tri[:, 1]] - pos[tri[:, 0]]
    e2 = pos[tri[:, 2]] - pos[tri[:, 0]]
    fn = np.cross(e1, e2)
    out = np.zeros_like(pos)
    for k in range(3):
        np.add.at(out, tri[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)
