"""Procedural test and benchmark scenes.

The port's copy of toyrenderer_tpu/scene/procedural.py: the same numpy
generators, built through the port's own build_scene, so both packages
get the same arrays from the same seed.  The stress scene is a ground
plane and a field of boxes and spheres with varied materials; with
`textured=True` it carries three 512-px / 256-px material-map sets whose
mip 0 splits into 64x64 virtual-texture tiles.
"""

from __future__ import annotations

import numpy as np

from toyrenderer_tpu_torch.scene import gltf as G
from toyrenderer_tpu_torch.scene import textures as TX
from toyrenderer_tpu_torch.scene.scenebuild import SceneBuffers, build_scene


def _uv_sphere(n_lat: int, n_lon: int) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray, np.ndarray]:
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon + 1)
    th, ph = np.meshgrid(lat, lon, indexing='ij')
    x = np.sin(th) * np.cos(ph)
    y = np.cos(th)
    z = np.sin(th) * np.sin(ph)
    pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    nrm = pos.copy()
    uv = np.stack([ph / (2 * np.pi), th / np.pi], -1).reshape(-1, 2)
    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * (n_lon + 1) + j
            b = a + n_lon + 1
            idx += [[a, b, a + 1], [a + 1, b, b + 1]]
    return pos, nrm, uv.astype(np.float32), np.asarray(idx, np.uint32).reshape(-1)


def _box() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    # 24-vertex box with per-face normals, CCW outward winding
    faces = [
        (+0, [1, 0, 0]), (+1, [-1, 0, 0]),
        (+2, [0, 1, 0]), (+3, [0, -1, 0]),
        (+4, [0, 0, 1]), (+5, [0, 0, -1]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for f, n in faces:
        n = np.asarray(n, np.float32)
        u = np.asarray([n[1], n[2], n[0]], np.float32)
        v = np.cross(n, u)
        base = len(pos)
        for (su, sv) in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            pos.append(n + u * su + v * sv)
            nrm.append(n)
            uv.append([(su + 1) / 2, (sv + 1) / 2])
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    pos = np.asarray(pos, np.float32)
    # fix winding: ensure cross(e1,e2) aligns with the face normal
    idx = np.asarray(idx, np.int64)
    e1 = pos[idx[:, 1]] - pos[idx[:, 0]]
    e2 = pos[idx[:, 2]] - pos[idx[:, 0]]
    fn = np.cross(e1, e2)
    stored = np.asarray(nrm, np.float32)[idx[:, 0]]
    flip = (fn * stored).sum(-1) < 0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    return (pos, np.asarray(nrm, np.float32),
            np.asarray(uv, np.float32), idx.reshape(-1).astype(np.uint32))


def make_stress_doc(n_objects: int = 256, sphere_res: int = 24,
                    seed: int = 0, spread: float = 40.0) -> G.GltfDocument:
    """A Sponza-class stress scene: a ground plane + a field of boxes and
    spheres with varied materials.  ~n_objects * 2*sphere_res^2 triangles."""
    rng = np.random.default_rng(seed)

    sp, sn, suv, sidx = _uv_sphere(sphere_res, sphere_res)
    bp, bn, buv, bidx = _box()
    gp = np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                    np.float32) * spread * 1.5
    gn = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    guv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    gidx = np.asarray([0, 2, 1, 0, 3, 2], np.uint32)

    n_materials = 16
    materials = []
    for k in range(n_materials):
        m = G.GltfMaterial(name=f"mat{k}")
        m.base_color = np.asarray(
            [*rng.uniform(0.2, 0.9, 3), 1.0], np.float32)
        m.metallic = float(rng.uniform(0, 1) > 0.7)
        m.roughness = float(rng.uniform(0.1, 0.95))
        if k % 7 == 0:
            m.emissive = rng.uniform(0, 4, 3).astype(np.float32)
        materials.append(m)
    ground_mat = G.GltfMaterial(name="ground")
    ground_mat.base_color = np.asarray([0.5, 0.5, 0.55, 1.0], np.float32)
    ground_mat.roughness = 0.9
    materials.append(ground_mat)

    meshes = [
        G.GltfMesh(name="sphere", primitives=[G.GltfPrimitive(
            positions=sp, normals=sn, uvs=suv, indices=sidx, material=0)]),
        G.GltfMesh(name="box", primitives=[G.GltfPrimitive(
            positions=bp, normals=bn, uvs=buv, indices=bidx, material=1)]),
        G.GltfMesh(name="ground", primitives=[G.GltfPrimitive(
            positions=gp, normals=gn, uvs=guv, indices=gidx,
            material=n_materials)]),
    ]
    # per-material primitive variants so instances get varied materials
    # (cheap: share vertex arrays, new primitive records)
    sphere_prims = [G.GltfPrimitive(positions=sp, normals=sn, uvs=suv,
                                    indices=sidx, material=k)
                    for k in range(n_materials)]
    box_prims = [G.GltfPrimitive(positions=bp, normals=bn, uvs=buv,
                                 indices=bidx, material=k)
                 for k in range(n_materials)]
    meshes = ([G.GltfMesh(name=f"sphere{k}", primitives=[p])
               for k, p in enumerate(sphere_prims)]
              + [G.GltfMesh(name=f"box{k}", primitives=[p])
                 for k, p in enumerate(box_prims)]
              + [meshes[2]])

    nodes = [G.GltfNode(name="ground", parent=-1,
                        translation=np.zeros(3, np.float32),
                        rotation=np.asarray([0, 0, 0, 1], np.float32),
                        scale=np.ones(3, np.float32),
                        matrix=None, mesh=len(meshes) - 1)]
    for i in range(n_objects):
        kind = int(rng.uniform() > 0.5)             # sphere or box
        mat = int(rng.integers(0, n_materials))
        mesh_id = mat if kind == 0 else n_materials + mat
        s = float(rng.uniform(0.4, 1.6))
        t = np.asarray([rng.uniform(-spread, spread), s,
                        rng.uniform(-spread, spread)], np.float32)
        ang = rng.uniform(0, 2 * np.pi)
        q = np.asarray([0, np.sin(ang / 2), 0, np.cos(ang / 2)], np.float32)
        nodes.append(G.GltfNode(
            name=f"obj{i}", parent=-1, translation=t, rotation=q,
            scale=np.full(3, s, np.float32), matrix=None, mesh=mesh_id))

    lights = [G.GltfLight(name="sun", kind="directional",
                          color=np.ones(3, np.float32), intensity=20.0)]
    sun_node = G.GltfNode(
        name="sun", parent=-1, translation=np.zeros(3, np.float32),
        rotation=_quat_from_dir(np.asarray([0.4, -1.0, 0.3])),
        scale=np.ones(3, np.float32), matrix=None, light=0)
    nodes.append(sun_node)

    return G.GltfDocument(
        meshes=meshes, materials=materials, nodes=nodes,
        root_nodes=list(range(len(nodes))), cameras=[], lights=lights,
        textures=[], base_dir=None)


def _quat_from_dir(d: np.ndarray) -> np.ndarray:
    """Quaternion rotating -Z onto direction d (for glTF light nodes)."""
    d = d / np.linalg.norm(d)
    z = np.asarray([0.0, 0.0, -1.0])
    axis = np.cross(z, d)
    s = np.linalg.norm(axis)
    if s < 1e-8:
        return (np.asarray([0, 0, 0, 1], np.float32) if d[2] < 0
                else np.asarray([1, 0, 0, 0], np.float32))
    axis /= s
    ang = np.arccos(np.clip(np.dot(z, d), -1, 1))
    return np.asarray([*(axis * np.sin(ang / 2)), np.cos(ang / 2)],
                      np.float32)


def make_stress_scene(n_objects: int = 256, sphere_res: int = 24,
                      seed: int = 0, textured: bool = False) -> SceneBuffers:
    """The stress scene built (make_stress_doc), with the bench camera;
    textured=True attaches the three material-map sets (the ground and
    every third material textured)."""
    doc = make_stress_doc(n_objects=n_objects, sphere_res=sphere_res,
                          seed=seed)
    scene = build_scene(doc)
    if textured:
        # full material map sets so the bench exercises the one-row
        # multi-map sampler (base + normal + MR; see scene/textures.py)
        atlas = TX.build_atlas(material_maps=[
            dict(base=TX.checkerboard(512, 8),
                 normal=TX.bump_normal_map(512, 16),
                 mr=TX.checkerboard(512, 8, (255, 200, 60),
                                    (255, 60, 220))),
            dict(base=TX.checkerboard(512, 32, (230, 120, 60),
                                      (80, 40, 200)),
                 normal=TX.bump_normal_map(512, 48, amplitude=1.5)),
            dict(base=TX.checkerboard(256, 4, (255, 255, 255),
                                      (128, 128, 128)),
                 normal=TX.bump_normal_map(256, 8)),
        ])
        scene.attach_atlas(atlas)
        # ground gets the big checker; every 3rd material gets one too
        k = scene.mat_base_color_tex.shape[0]
        tex_ids = np.full((k,), -1, np.int32)
        tex_ids[::3] = np.arange((k + 2) // 3) % 2
        tex_ids[-1] = 2   # ground material (appended last in the doc)
        scene.mat_base_color_tex = tex_ids
    # benchmark camera: elevated, looking across the field
    scene.camera_position = np.asarray([0.0, 6.0, 55.0], np.float32)
    scene.camera_rotation = np.asarray(
        [-0.06, 0.0, 0.0, 0.998], np.float32)
    scene.camera_yfov = 1.0
    return scene
