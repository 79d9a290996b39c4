"""Scene build: glTF document -> dense global buffers, and their torch form.

The port's copy of toyrenderer_tpu/scene/scenebuild.py: `build_scene`
produces the same `SceneBuffers`, array for array, from the port's own
loaders; `SceneBuffers.to_device` returns a `DeviceScene`, a dataclass of
torch tensors, in place of the JAX pytree.  The cache lives in the port's
build directory, never beside the asset.

Layout (shared with the reference package): struct-of-arrays with padded
static shapes; meshlets carry GLOBAL vertex indices in fixed (M, 96, 3)
arrays; the node hierarchy is parent-indexed with a precomputed depth.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from toyrenderer_tpu_torch._build import BUILD_DIR
from toyrenderer_tpu_torch.device import resolve_device
from toyrenderer_tpu_torch.scene import gltf as G
from toyrenderer_tpu_torch.scene import lod as LOD
from toyrenderer_tpu_torch.scene import meshlet as ML
from toyrenderer_tpu_torch.scene import textures as TX

CACHE_VERSION = 2
MAX_LODS = LOD.MAX_LODS


def _pad_to(x: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="constant")


def _material_atlas_entries(mats) -> list[int]:
    """Material -> atlas entry id: textured materials get consecutive
    entries in material order (matching textures.build_atlas(doc)); the
    rest sample neutral maps (-1)."""
    out = []
    nxt = 0
    for m in mats:
        textured = (m.base_color_texture >= 0 or m.normal_texture >= 0
                    or m.metallic_roughness_texture >= 0
                    or m.emissive_texture >= 0)
        out.append(nxt if textured else -1)
        nxt += 1 if textured else 0
    return out


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


@dataclass
class SceneBuffers:
    """All numpy (host) arrays; `to_device()` moves them to torch.

    Shapes: V vertices, M meshlets, P primitives, I instances, N nodes,
    K materials.  All leading dims padded; *_count fields give real sizes.
    """
    # geometry
    positions: np.ndarray            # (V, 3) f32
    normals: np.ndarray              # (V, 3) f32
    uvs: np.ndarray                  # (V, 2) f32
    # meshlets (global vertex indices)
    meshlet_tris: np.ndarray         # (M, 96, 3) i32
    meshlet_tri_count: np.ndarray    # (M,) i32
    meshlet_center: np.ndarray       # (M, 3) f32 (primitive-local space)
    meshlet_radius: np.ndarray       # (M,) f32
    meshlet_cone_axis: np.ndarray    # (M, 3) f32
    meshlet_cone_cutoff: np.ndarray  # (M,) f32
    meshlet_prim: np.ndarray         # (M,) i32 owning primitive
    # primitives (a glTF mesh primitive == reference "Mesh")
    prim_meshlet_offset: np.ndarray  # (P, LODS) i32
    prim_meshlet_count: np.ndarray   # (P, LODS) i32
    prim_lod_count: np.ndarray       # (P,) i32
    prim_lod_error: np.ndarray       # (P, LODS) f32 object-space error
    prim_center: np.ndarray          # (P, 3) f32 bounding sphere (local)
    prim_radius: np.ndarray          # (P,) f32
    prim_material: np.ndarray        # (P,) i32
    # instances (node x primitive)
    inst_node: np.ndarray            # (I,) i32
    inst_prim: np.ndarray            # (I,) i32
    # node hierarchy + rest-pose local TRS
    node_parent: np.ndarray          # (N,) i32, -1 root
    node_translation: np.ndarray     # (N, 3) f32
    node_rotation: np.ndarray        # (N, 4) f32 xyzw
    node_scale: np.ndarray           # (N, 3) f32
    node_depth: int                  # max hierarchy depth (static)
    # materials
    mat_base_color: np.ndarray       # (K, 4) f32
    mat_metal_rough: np.ndarray      # (K, 2) f32
    mat_emissive: np.ndarray         # (K, 3) f32
    mat_alpha_mode: np.ndarray       # (K,) i32
    mat_alpha_cutoff: np.ndarray     # (K,) f32
    mat_double_sided: np.ndarray     # (K,) i32
    mat_base_color_tex: np.ndarray   # (K,) i32 (texture id, -1 none)
    # counts (unpadded)
    num_vertices: int = 0
    num_meshlets: int = 0
    num_primitives: int = 0
    num_instances: int = 0
    num_nodes: int = 0
    num_materials: int = 0
    # lighting / camera defaults pulled from the asset
    sun_direction: np.ndarray = field(
        default_factory=lambda: np.array([0.0, -1.0, 0.0], np.float32))
    sun_color: np.ndarray = field(
        default_factory=lambda: np.ones(3, np.float32))
    sun_intensity: float = 1.0
    camera_position: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 1.0, 5.0], np.float32))
    camera_rotation: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    camera_yfov: float = 1.0
    camera_znear: float = 0.1
    world_aabb: np.ndarray = field(
        default_factory=lambda: np.asarray(
            [[-1, -1, -1], [1, 1, 1]], np.float32))
    # material texture atlas (see scene/textures.py); default = neutral
    tex_texels: np.ndarray = field(
        default_factory=lambda: np.full(
            (128, TX.ROW_U32), 0xFFFFFFFF, np.uint32))
    tex_offset: np.ndarray = field(
        default_factory=lambda: np.zeros((1, TX.MAX_MIPS), np.int32))
    tex_width: np.ndarray = field(
        default_factory=lambda: np.ones((1, TX.MAX_MIPS), np.int32))
    tex_height: np.ndarray = field(
        default_factory=lambda: np.ones((1, TX.MAX_MIPS), np.int32))
    tex_num_mips: np.ndarray = field(
        default_factory=lambda: np.ones((1,), np.int32))
    tex_wrap: np.ndarray = field(
        default_factory=lambda: np.zeros((1,), np.int32))
    tex_min_mip: np.ndarray = field(
        default_factory=lambda: np.zeros((1,), np.int32))
    tex_desc: np.ndarray = field(
        default_factory=lambda: np.tile(
            np.asarray([[0, 1, 1, 0]], np.int32), (TX.MAX_MIPS, 1)))
    num_textures: int = 0
    # packed animation channels (scene/animation.py)
    anim_node: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    anim_path: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    anim_interp: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))
    anim_key_offset: np.ndarray = field(
        default_factory=lambda: np.zeros(1, np.int32))
    anim_times: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float32))
    anim_values: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.float32))
    anim_duration: float = 0.0

    def animation_data(self):
        """The scene's channels as scene/animation.AnimationData."""
        from toyrenderer_tpu_torch.scene.animation import AnimationData
        return AnimationData(
            node=self.anim_node, path=self.anim_path,
            interp=self.anim_interp, key_offset=self.anim_key_offset,
            times=self.anim_times, values=self.anim_values,
            duration=self.anim_duration)

    def attach_atlas(self, atlas: "TX.TextureAtlas"):
        self.tex_texels = atlas.texels
        self.tex_offset = atlas.desc_offset
        self.tex_width = atlas.desc_width
        self.tex_height = atlas.desc_height
        self.tex_num_mips = atlas.num_mips
        self.tex_wrap = atlas.wrap_mode
        self.tex_min_mip = atlas.min_resident_mip
        self.tex_desc = atlas.packed_desc()
        self.num_textures = atlas.num_textures

    _DEVICE_FIELDS = (
        "positions normals uvs meshlet_tris meshlet_tri_count meshlet_center "
        "meshlet_radius meshlet_cone_axis meshlet_cone_cutoff meshlet_prim "
        "prim_meshlet_offset prim_meshlet_count prim_lod_count prim_lod_error "
        "prim_center prim_radius prim_material inst_node inst_prim "
        "node_parent node_translation node_rotation node_scale "
        "mat_base_color mat_metal_rough mat_emissive mat_alpha_mode "
        "mat_alpha_cutoff mat_double_sided mat_base_color_tex "
        "tex_texels tex_offset tex_width tex_height tex_num_mips "
        "tex_wrap tex_min_mip tex_desc").split()

    def meshlet_windows(self):
        """Meshlet-major vertex windows: (ml_verts (M, 64, 8) f32
        [pos3 | nrm3 | uv2], ml_local_tris (M, 96, 3) i32 in [0, 64)).

        Each meshlet's <=64 unique vertices are copied into a contiguous
        window, so the frame transforms vertices at window rate and
        gathers per-triangle attributes from the window (the reference
        package's layout).  Derived from the flat arrays."""
        cached = self.__dict__.get('_ml_windows')
        if cached is not None:
            return cached
        G = np.asarray(self.meshlet_tris, np.int64)       # (M, 96, 3)
        m = G.shape[0]
        # padded triangle slots reference the PRIMITIVE's vertex 0,
        # which may not be among the meshlet's 64 real vertices (the
        # 65th-unique off-by-one); remap padding to the meshlet's own
        # first vertex — padded tris are invalid (tri_count) and never
        # consumed
        tc = np.asarray(self.meshlet_tri_count).reshape(m, 1)
        pad = np.arange(G.shape[1])[None, :] >= tc        # (M, 96)
        first = G[:, 0, 0]
        G = np.where(pad[..., None], first[:, None, None], G)
        flat = G.reshape(m, 288)
        order = np.argsort(flat, axis=1, kind='stable')
        s = np.take_along_axis(flat, order, axis=1)
        newv = np.ones((m, 288), bool)
        newv[:, 1:] = s[:, 1:] != s[:, :-1]
        ranks = np.cumsum(newv, axis=1) - 1
        if ranks.max(initial=0) >= ML.MESHLET_MAX_VERTS:
            raise ValueError("meshlet exceeds the 64-unique-vertex budget")
        w = np.zeros((m, ML.MESHLET_MAX_VERTS), np.int64)
        np.put_along_axis(w, ranks, s, axis=1)
        local = np.empty((m, 288), np.int32)
        np.put_along_axis(local, order, ranks.astype(np.int32), axis=1)
        pos = np.asarray(self.positions, np.float32)[w]
        nrm = np.asarray(self.normals, np.float32)[w]
        uv = np.asarray(self.uvs, np.float32)[w]
        verts = np.concatenate([pos, nrm, uv], axis=-1)
        out = (verts, local.reshape(m, 96, 3))
        self.__dict__['_ml_windows'] = out
        return out

    def tex_analytic_ok(self) -> bool:
        """True when the atlas supports ANALYTIC mip descriptors: every
        chain base ATLAS_ALIGN-aligned with base//ALIGN < 2^10 and
        tex id < 64 -- the record encoding tex + 64*base11 then stays
        < 2^16."""
        if self.num_textures <= 0 or self.num_textures >= 64:
            return False
        base = np.asarray(self.tex_offset[:self.num_textures, 0])
        return bool(np.all(base % TX.ATLAS_ALIGN == 0)
                    and np.all(base // TX.ATLAS_ALIGN < 1024))

    def to_device(self, device=None) -> "DeviceScene":
        """Torch scene on `device` (default: the CUDA device; raises
        when there is none -- pass device='cpu' for the plain path).
        The u32 texel atlas is carried bit for bit as int32."""
        dev = resolve_device(device)
        arrays = {f: getattr(self, f) for f in self._DEVICE_FIELDS}
        arrays['ml_verts'], arrays['ml_local_tris'] = self.meshlet_windows()
        return DeviceScene.from_arrays(
            arrays, dev, node_depth=self.node_depth,
            num_textures=self.num_textures,
            tex_analytic=self.tex_analytic_ok(),
            num_instances=self.num_instances)


@dataclass
class DeviceScene:
    """The frame's scene: torch tensors on one device + static counts."""
    positions: torch.Tensor
    normals: torch.Tensor
    uvs: torch.Tensor
    meshlet_tris: torch.Tensor
    meshlet_tri_count: torch.Tensor
    meshlet_prim: torch.Tensor
    meshlet_center: torch.Tensor   # (M, 3) culling spheres and cones
    meshlet_radius: torch.Tensor
    meshlet_cone_axis: torch.Tensor
    meshlet_cone_cutoff: torch.Tensor
    prim_meshlet_offset: torch.Tensor  # (P, LODS) meshlet range per LOD
    prim_meshlet_count: torch.Tensor
    prim_lod_count: torch.Tensor
    prim_lod_error: torch.Tensor
    prim_center: torch.Tensor
    prim_radius: torch.Tensor
    prim_material: torch.Tensor
    inst_node: torch.Tensor
    inst_prim: torch.Tensor
    node_parent: torch.Tensor
    mat_base_color: torch.Tensor
    mat_metal_rough: torch.Tensor
    mat_emissive: torch.Tensor
    mat_alpha_cutoff: torch.Tensor
    mat_double_sided: torch.Tensor
    mat_base_color_tex: torch.Tensor
    ml_verts: torch.Tensor         # (M, 64, 8) meshlet vertex windows
    ml_local_tris: torch.Tensor    # (M, 96, 3) window-local indices
    tex_texels: torch.Tensor       # (N, 16) int32 (u32 RGBA8 bit patterns)
    tex_offset: torch.Tensor
    tex_width: torch.Tensor
    tex_height: torch.Tensor
    tex_wrap: torch.Tensor
    tex_min_mip: torch.Tensor
    tex_desc: torch.Tensor         # (T * MAX_MIPS, 4) packed desc rows
    node_depth: int = 0
    num_textures: int = 0
    tex_analytic: bool = False     # records carry tex + 64*base11; the
    #   sampler derives mip descriptors analytically (textures.ATLAS_ALIGN)
    num_instances: int = 0         # real instances; the arrays are padded

    _STATICS = ('node_depth', 'num_textures', 'tex_analytic',
                'num_instances')

    @classmethod
    def from_arrays(cls, arrays: dict, device, node_depth: int,
                    num_textures: int, tex_analytic: bool,
                    num_instances: int) -> "DeviceScene":
        """Build from numpy arrays named as the fields (extra keys are
        ignored); float arrays become float32, integer arrays int32."""
        kw = {}
        for f in cls.__dataclass_fields__:
            if f in cls._STATICS:
                continue
            a = np.asarray(arrays[f])
            if f == 'tex_texels':
                a = np.ascontiguousarray(a, np.uint32).view(np.int32)
            elif a.dtype.kind == 'f':
                a = a.astype(np.float32)
            else:
                a = a.astype(np.int32)
            kw[f] = torch.from_numpy(np.array(a)).to(device)
        return cls(node_depth=int(node_depth), num_textures=int(num_textures),
                   tex_analytic=bool(tex_analytic),
                   num_instances=int(num_instances), **kw)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def atlas_dict(self) -> dict:
        """The sampler's atlas.  With analytic descriptors the resolve
        records carry tex + 64*base11 (pack_resolve_records): '_enc'
        tells finish_gbuffer to decode them, '_analytic' to derive the
        mip descriptors from them (a streaming override clears it,
        engine/frame.frame_atlas)."""
        d = dict(tex_texels=self.tex_texels, tex_desc=self.tex_desc,
                 tex_wrap=self.tex_wrap, tex_min_mip=self.tex_min_mip)
        if self.tex_analytic:
            d['_enc'] = True
            d['_analytic'] = True
        return d


def build_scene(doc: G.GltfDocument, scale: float = 1.0,
                max_lods: int = MAX_LODS) -> SceneBuffers:
    """Flatten a GltfDocument into global dense buffers with meshlets+LODs."""
    positions, normals, uvs = [], [], []
    vert_base = 0

    meshlet_tris, meshlet_tc = [], []
    meshlet_center, meshlet_radius = [], []
    meshlet_axis, meshlet_cutoff = [], []
    meshlet_prim = []

    prim_offsets, prim_counts, prim_errors, prim_lods = [], [], [], []
    prim_center, prim_radius, prim_material = [], [], []

    mesh_prim_ids: list[list[int]] = []   # glTF mesh -> primitive table ids
    meshlets_emitted = 0

    for mesh in doc.meshes:
        ids = []
        for prim in mesh.primitives:
            pid = len(prim_offsets)
            ids.append(pid)
            pos = prim.positions * scale
            positions.append(pos)
            normals.append(prim.normals)
            uvs.append(prim.uvs)

            chain = LOD.build_lod_chain(pos, prim.indices, max_lods,
                                        normals=prim.normals)
            offs = np.zeros(MAX_LODS, np.int32)
            cnts = np.zeros(MAX_LODS, np.int32)
            errs = np.zeros(MAX_LODS, np.float32)
            for li, (idx, err) in enumerate(zip(chain.indices, chain.errors)):
                ml = ML.build_meshlets(idx, pos)
                offs[li] = meshlets_emitted
                cnts[li] = ml.count
                errs[li] = err
                meshlets_emitted += ml.count
                if ml.count:
                    meshlet_tris.append(ml.tri_vertex_indices + vert_base)
                    meshlet_tc.append(ml.tri_count)
                    meshlet_center.append(ml.center)
                    meshlet_radius.append(ml.radius)
                    meshlet_axis.append(ml.cone_axis)
                    meshlet_cutoff.append(ml.cone_cutoff)
                    meshlet_prim.append(np.full(ml.count, pid, np.int32))
            prim_offsets.append(offs)
            prim_counts.append(cnts)
            prim_errors.append(errs)
            prim_lods.append(len(chain.indices))

            c = 0.5 * (pos.min(0) + pos.max(0)) if len(pos) else np.zeros(3)
            r = float(np.linalg.norm(pos - c, axis=-1).max()) if len(pos) else 0
            prim_center.append(c.astype(np.float32))
            prim_radius.append(r)
            prim_material.append(prim.material)
            vert_base += len(pos)
        mesh_prim_ids.append(ids)

    # nodes and instances ----------------------------------------------------
    n_nodes = len(doc.nodes)
    node_parent = np.full(max(n_nodes, 1), -1, np.int32)
    node_t = np.zeros((max(n_nodes, 1), 3), np.float32)
    node_r = np.tile(np.array([0, 0, 0, 1], np.float32), (max(n_nodes, 1), 1))
    node_s = np.ones((max(n_nodes, 1), 3), np.float32)
    inst_node, inst_prim = [], []
    for i, nd in enumerate(doc.nodes):
        node_parent[i] = nd.parent
        if nd.matrix is not None:
            t, r, s = _decompose_trs(nd.matrix)
            node_t[i], node_r[i], node_s[i] = t, r, s
        else:
            node_t[i] = nd.translation
            node_r[i] = nd.rotation
            node_s[i] = nd.scale
        if nd.mesh >= 0:
            for pid in mesh_prim_ids[nd.mesh]:
                inst_node.append(i)
                inst_prim.append(pid)
    # hierarchy depth
    depth = 1
    d = np.zeros(max(n_nodes, 1), np.int32)
    for i in range(n_nodes):
        p = node_parent[i]
        if p >= 0:
            assert p < i or True
    # compute depths iteratively (parents may come after children in glTF)
    changed = True
    it = 0
    while changed and it < 64:
        changed = False
        it += 1
        for i in range(n_nodes):
            p = node_parent[i]
            if p >= 0 and d[i] != d[p] + 1:
                d[i] = d[p] + 1
                changed = True
    depth = int(d.max()) + 1 if n_nodes else 1

    # sun + camera defaults ---------------------------------------------------
    sun_dir = np.array([0.0, -1.0, 0.0], np.float32)
    sun_color = np.ones(3, np.float32)
    sun_intensity = 10.0
    cam_pos = np.array([0.0, 1.0, 5.0], np.float32)
    cam_rot = np.array([0, 0, 0, 1], np.float32)
    cam_yfov, cam_znear = 1.0, 0.1
    world = _world_matrices_host(node_parent[:n_nodes], node_t[:n_nodes],
                                 node_r[:n_nodes], node_s[:n_nodes])
    for i, nd in enumerate(doc.nodes):
        if nd.light >= 0 and nd.light < len(doc.lights):
            li = doc.lights[nd.light]
            if li.kind == "directional":
                # glTF: light shines down its node's -Z
                sun_dir = (-world[i][:3, 2]).astype(np.float32)
                sun_dir /= max(np.linalg.norm(sun_dir), 1e-8)
                sun_color = li.color
                sun_intensity = li.intensity
        if nd.camera >= 0 and nd.camera < len(doc.cameras):
            cam = doc.cameras[nd.camera]
            cam_pos = world[i][:3, 3].astype(np.float32) * scale
            # extract rotation (assumes no shear on camera nodes)
            r3 = world[i][:3, :3]
            r3 = r3 / np.linalg.norm(r3, axis=0, keepdims=True)
            cam_rot = _mat3_to_quat(r3)
            cam_yfov, cam_znear = cam.yfov, cam.znear

    # world AABB over instanced bounding spheres (rest pose) — sizes the
    # DDGI probe volume like the reference (GIRenderer.cpp:43-156)
    aabb_min = np.full(3, 1e30, np.float32)
    aabb_max = np.full(3, -1e30, np.float32)
    for n_i, p_i in zip(inst_node, inst_prim):
        w_m = world[n_i]
        c = (w_m[:3, :3] @ prim_center[p_i]) + w_m[:3, 3]
        r = prim_radius[p_i] * float(
            np.linalg.norm(w_m[:3, :3], axis=0).max())
        aabb_min = np.minimum(aabb_min, c - r)
        aabb_max = np.maximum(aabb_max, c + r)
    if not inst_node:
        aabb_min, aabb_max = -np.ones(3, np.float32), np.ones(3, np.float32)
    world_aabb = np.stack([aabb_min, aabb_max]).astype(np.float32)

    # pack + pad ---------------------------------------------------------------
    V = _round_up(vert_base, 128)
    cat = lambda xs, d: (np.concatenate(xs, 0) if xs else
                         np.zeros((0,) + d, np.float32))
    pos_all = _pad_to(cat(positions, (3,)).astype(np.float32), V)
    nrm_all = _pad_to(cat(normals, (3,)).astype(np.float32), V)
    uv_all = _pad_to(cat(uvs, (2,)).astype(np.float32), V)

    m_count = sum(len(t) for t in meshlet_tc)
    M = _round_up(max(m_count, 1), 8)
    mt = _pad_to(np.concatenate(meshlet_tris, 0).astype(np.int32)
                 if meshlet_tris else
                 np.zeros((0, ML.MESHLET_MAX_TRIS, 3), np.int32), M)
    mtc = _pad_to(np.concatenate(meshlet_tc, 0).astype(np.int32)
                  if meshlet_tc else np.zeros((0,), np.int32), M)
    mc = _pad_to(np.concatenate(meshlet_center, 0).astype(np.float32)
                 if meshlet_center else np.zeros((0, 3), np.float32), M)
    mr = _pad_to(np.concatenate(meshlet_radius, 0).astype(np.float32)
                 if meshlet_radius else np.zeros((0,), np.float32), M)
    ma = _pad_to(np.concatenate(meshlet_axis, 0).astype(np.float32)
                 if meshlet_axis else np.zeros((0, 3), np.float32), M)
    mcut = _pad_to(np.concatenate(meshlet_cutoff, 0).astype(np.float32)
                   if meshlet_cutoff else np.ones((0,), np.float32), M)
    mp = _pad_to(np.concatenate(meshlet_prim, 0).astype(np.int32)
                 if meshlet_prim else np.zeros((0,), np.int32), M)

    P = max(len(prim_offsets), 1)
    I = max(len(inst_node), 1)
    K = max(len(doc.materials), 1)

    mats = doc.materials
    scene_out = SceneBuffers(
        positions=pos_all, normals=nrm_all, uvs=uv_all,
        meshlet_tris=mt, meshlet_tri_count=mtc, meshlet_center=mc,
        meshlet_radius=mr, meshlet_cone_axis=ma, meshlet_cone_cutoff=mcut,
        meshlet_prim=mp,
        prim_meshlet_offset=_pad_to(np.stack(prim_offsets) if prim_offsets
                                    else np.zeros((0, MAX_LODS), np.int32), P),
        prim_meshlet_count=_pad_to(np.stack(prim_counts) if prim_counts
                                   else np.zeros((0, MAX_LODS), np.int32), P),
        prim_lod_count=_pad_to(np.asarray(prim_lods, np.int32), P),
        prim_lod_error=_pad_to(np.stack(prim_errors) if prim_errors
                               else np.zeros((0, MAX_LODS), np.float32), P),
        prim_center=_pad_to(np.stack(prim_center) if prim_center
                            else np.zeros((0, 3), np.float32), P),
        prim_radius=_pad_to(np.asarray(prim_radius, np.float32), P),
        prim_material=_pad_to(np.asarray(prim_material, np.int32), P),
        inst_node=_pad_to(np.asarray(inst_node, np.int32), I),
        inst_prim=_pad_to(np.asarray(inst_prim, np.int32), I),
        node_parent=node_parent, node_translation=node_t,
        node_rotation=node_r, node_scale=node_s, node_depth=depth,
        mat_base_color=np.stack([m.base_color for m in mats]),
        mat_metal_rough=np.asarray(
            [[m.metallic, m.roughness] for m in mats], np.float32),
        mat_emissive=np.stack([m.emissive for m in mats]),
        mat_alpha_mode=np.asarray([m.alpha_mode for m in mats], np.int32),
        mat_alpha_cutoff=np.asarray([m.alpha_cutoff for m in mats], np.float32),
        mat_double_sided=np.asarray(
            [1 if m.double_sided else 0 for m in mats], np.int32),
        mat_base_color_tex=np.asarray(
            _material_atlas_entries(mats), np.int32),
        num_vertices=vert_base, num_meshlets=m_count,
        num_primitives=len(prim_offsets), num_instances=len(inst_node),
        num_nodes=n_nodes, sun_direction=sun_dir, sun_color=sun_color,
        sun_intensity=sun_intensity, camera_position=cam_pos,
        camera_rotation=cam_rot, camera_yfov=cam_yfov,
        camera_znear=cam_znear, world_aabb=world_aabb)
    if doc.textures:
        # one material-map-set atlas entry per TEXTURED material (order
        # matches _material_atlas_entries)
        scene_out.attach_atlas(TX.build_atlas(doc))
    if doc.animations:
        from toyrenderer_tpu_torch.scene.animation import pack_animations
        ad = pack_animations(doc.animations)
        scene_out.anim_node, scene_out.anim_path = ad.node, ad.path
        scene_out.anim_interp = ad.interp
        scene_out.anim_key_offset = ad.key_offset
        scene_out.anim_times, scene_out.anim_values = ad.times, ad.values
        scene_out.anim_duration = ad.duration
    return scene_out


def _world_matrices_host(parent, t, r, s) -> np.ndarray:
    """Host-side world matrices (numpy) for scene-build-time queries."""
    n = len(parent)
    local = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        local[i] = _compose_np(t[i], r[i], s[i])
    world = local.copy()
    # iterate until stable (parents may be in any order)
    for _ in range(64):
        changed = False
        for i in range(n):
            p = parent[i]
            if p >= 0:
                w = world[p] @ local[i]
                if not np.allclose(w, world[i]):
                    world[i] = w
                    changed = True
        if not changed:
            break
    return world


def _compose_np(t, q, s):
    q = q / np.linalg.norm(q)
    x, y, z, w = q
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = t
    return m


def _decompose_trs(m: np.ndarray):
    t = m[:3, 3].copy()
    a = m[:3, :3]
    s = np.linalg.norm(a, axis=0)
    s[s == 0] = 1.0
    r3 = a / s[None, :]
    if np.linalg.det(r3) < 0:
        s[0] = -s[0]
        r3 = a / s[None, :]
    return t.astype(np.float32), _mat3_to_quat(r3), s.astype(np.float32)


def _mat3_to_quat(m: np.ndarray) -> np.ndarray:
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], np.float32)
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# Cache (reference: <scene>_CachedData.bin, SceneLoading.cpp:1090-1142)
# ---------------------------------------------------------------------------

def cache_path(path: Path, scale: float) -> Path:
    """Where load_scene keeps the build of `path` at `scale`: the build
    directory, keyed on the file's name, its bytes and the scale."""
    h = hashlib.sha256()
    h.update(path.read_bytes())
    h.update(repr((CACHE_VERSION, float(scale))).encode())
    return BUILD_DIR / "scenes" / f"{path.name}.{h.hexdigest()[:16]}.npz"


_SCALARS = ('node_depth', 'num_vertices', 'num_meshlets', 'num_primitives',
            'num_instances', 'num_nodes', 'num_textures', 'sun_intensity',
            'camera_yfov', 'camera_znear', 'anim_duration')
_HOST_ARRAYS = ('sun_direction', 'sun_color', 'camera_position',
                'camera_rotation', 'world_aabb', 'anim_node', 'anim_path',
                'anim_interp', 'anim_key_offset', 'anim_times',
                'anim_values')


def save_scene_cache(cache: Path, scene: SceneBuffers):
    """Write the scene under the build directory (renamed into place,
    so a concurrent reader never sees a partial file)."""
    cache.parent.mkdir(parents=True, exist_ok=True)
    arrays = {f: getattr(scene, f)
              for f in (*SceneBuffers._DEVICE_FIELDS, *_HOST_ARRAYS)}
    scalars = np.array([getattr(scene, f) for f in _SCALARS], np.float64)
    tmp = cache.with_suffix(f".{os.getpid()}.tmp.npz")
    np.savez(tmp, __scalars=scalars, **arrays)
    os.replace(tmp, cache)


def load_scene_cache(cache: Path) -> SceneBuffers:
    with np.load(cache) as z:
        kw = {f: z[f] for f in (*SceneBuffers._DEVICE_FIELDS, *_HOST_ARRAYS)}
        scalars = z["__scalars"]
    for f, v in zip(_SCALARS, scalars):
        kw[f] = (float(v) if f.startswith(('sun_', 'camera_', 'anim_'))
                 else int(v))
    return SceneBuffers(**kw)


def load_scene(path: str | Path, scale: float = 1.0,
               use_cache: bool = True) -> SceneBuffers:
    """Load a .gltf/.glb into SceneBuffers; with use_cache a previous
    build of the same file (same bytes, same scale) is read back from
    the build directory instead of rebuilt."""
    path = Path(path)
    cache = cache_path(path, scale)
    if use_cache and cache.exists():
        return load_scene_cache(cache)
    scene = build_scene(G.load_gltf(path), scale=scale)
    if use_cache:
        save_scene_cache(cache, scene)
    return scene
