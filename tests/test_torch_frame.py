"""The port's whole default frame against the reference package's.

Both packages get the same scene arrays, frame inputs and carry (the
reference's, handed over as numpy).  The reference runs on the CPU:

* Cornell (untextured, 448x256) through its XLA fill path, and again
  through both packages' brute-force raster (`use_bruteforce_raster`);
  the port matches it pixel for pixel.
* The courtyard (textured, alpha-masked foliage, 384x216) through its
  Pallas fill in interpret mode -- the semantics the port's kernel
  implements: pixels no triangle covers carry zero planes, which the
  quad texture sampler sees at silhouettes (the XLA path carries record
  0 there instead).  The pairs are those of instances within 8 units of
  the camera: the full unculled LOD0 set puts up to 55k pairs in one
  384x216 tile, which neither package can run on a CPU in a test, and a
  capacity overflow would drop different triangles in each.

Tolerances for the courtyard: the geometry stage's 4x4 products round
differently (XLA fuses multiply-adds, PyTorch does not), so clip
coordinates move by an ulp and a pixel centre within that of an edge or
a depth tie can change its triangle: ids must agree on 99.95% of the
pixels and the u8 image within 1 on 99.9% (measured: 99.989% and
99.983%).  Where the triangle differs the colour may differ by anything,
so the maximum is not bounded.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from toyrenderer_tpu.engine import RenderSettings as JaxSettings
from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine import init_carry as jax_init_carry
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.engine.frame import render_frame as jax_render
from toyrenderer_tpu.ops.geometry import node_world_matrices
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu.scene import load_scene as jax_load_scene

from test_torch_raster import _one_torch_thread, scene_arrays  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, init_carry, render_frame)
from toyrenderer_tpu_torch.ops import raster_cuda
from toyrenderer_tpu_torch.weights import (
    carry_from_numpy, frame_inputs_from_numpy, scene_from_numpy)


def _render_both(path, w, h, near=None, **kw):
    """Render the default frame in both packages; returns (reference
    image, aux), (port image, aux), and the port's inputs."""
    sh = jax_load_scene(path, use_cache=False)
    js = sh.to_device()
    mk_i, mk_m = static_meshlet_pairs(sh, 'mask')
    pi, pm = static_meshlet_pairs(sh, 'not_mask' if len(mk_i) else 'all')
    if near is not None:
        world = np.asarray(node_world_matrices(
            js, jnp.asarray(sh.node_translation),
            jnp.asarray(sh.node_rotation), jnp.asarray(sh.node_scale)))
        inst = world[sh.inst_node]
        cen = (np.einsum('nij,nj->ni', inst[:, :3, :3],
                         sh.prim_center[sh.inst_prim]) + inst[:, :3, 3])
        keep = np.linalg.norm(cen - sh.camera_position, axis=1) < near
        pi, pm = pi[keep[pi]], pm[keep[pi]]
        mk_i, mk_m = mk_i[keep[mk_i]], mk_m[keep[mk_i]]
    common = dict(width=w, height=h, manual_exposure=0.25, **kw)
    jst = JaxSettings(**common, use_pallas_fill=near is not None)
    fi = jax_fi(sh, JView.from_scene(sh, w, h).matrices())
    jc = jax_init_carry(js, jst)
    mask = {}
    if len(mk_i):
        mask = dict(mask_pair_inst=jnp.asarray(mk_i),
                    mask_pair_meshlet=jnp.asarray(mk_m))

    @jax.jit
    def frame(s, a, b, f, c, m):
        return jax_render(s, a, b, f, c, settings=jst, **m)
    jimg, _, jaux = frame(js, jnp.asarray(pi), jnp.asarray(pm), fi, jc, mask)

    port = dict(
        scene=scene_from_numpy(scene_arrays(js), "cpu"),
        pi=torch.from_numpy(pi), pm=torch.from_numpy(pm),
        fi=frame_inputs_from_numpy(fi, "cpu"),
        carry=carry_from_numpy({k: np.asarray(v) for k, v in jc.items()},
                               "cpu"),
        mask={k: torch.from_numpy(np.array(v)) for k, v in mask.items()},
        settings=RenderSettings(**common))
    img, new_carry, aux = render_frame(
        port['scene'], port['pi'], port['pm'], port['fi'], port['carry'],
        port['settings'], **port['mask'])
    assert int(new_carry['frame_index']) == 1
    return (np.asarray(jimg), jaux), (img.numpy(), aux), port


def test_cornell_frame_matches_reference():
    (jimg, jaux), (img, aux), _ = _render_both(
        "resources/cornell.gltf", 448, 256, max_tris_per_tile=128,
        max_big_tris=64)
    assert img.shape == (256, 448, 3) and img.dtype == np.uint8
    np.testing.assert_array_equal(aux['tri_id'].numpy(),
                                  np.asarray(jaux['tri_id']))
    np.testing.assert_allclose(aux['depth'].numpy(), np.asarray(jaux['depth']),
                               rtol=1e-5, atol=1e-7)
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert diff.max() <= 1, diff.max()
    for k, v in jaux.items():
        if k.startswith('raster_') or k == 'resolved_pixels':
            assert int(aux[k]) == int(v), k


def test_cornell_bruteforce_frame_matches_reference():
    # use_bruteforce_raster: every triangle at every pixel, then the
    # per-pixel resolve, in both packages
    (jimg, jaux), (img, aux), _ = _render_both(
        "resources/cornell.gltf", 448, 256, use_bruteforce_raster=True)
    assert img.shape == (256, 448, 3) and img.dtype == np.uint8
    assert (aux['tri_id'].numpy() >= 0).mean() > 0.5
    np.testing.assert_array_equal(aux['tri_id'].numpy(),
                                  np.asarray(jaux['tri_id']))
    np.testing.assert_allclose(aux['depth'].numpy(), np.asarray(jaux['depth']),
                               rtol=1e-5, atol=1e-7)
    diff = np.abs(img.astype(int) - jimg.astype(int))
    assert diff.max() <= 1, diff.max()
    assert raster_cuda.launches == 0     # CPU tensors ran the plain version


def test_courtyard_frame_matches_reference():
    k, b = 1376, 416                      # >= the view's max tile / big
    (jimg, jaux), (img, aux), port = _render_both(
        "resources/courtyard.glb", 384, 216, near=8.0, max_tris_per_tile=k,
        max_big_tris=b, pair_capacity=8192)
    assert port['scene'].num_textures > 0 and port['mask']
    ids_eq = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
    assert ids_eq > 0.9995, ids_eq
    diff = np.abs(img.astype(int) - jimg.astype(int)).max(-1)
    assert (diff <= 1).mean() > 0.999, (diff <= 1).mean()
    for key, v in jaux.items():
        if 'drop' in key:
            assert int(aux[key]) == int(v) == 0, key
    # the masked set and the textures both reach the image
    s = port['settings']
    for variant, mask in ((s, {}), (dataclasses.replace(
            s, enable_textures=False), port['mask'])):
        other, _, _ = render_frame(port['scene'], port['pi'], port['pm'],
                                   port['fi'], port['carry'], variant, **mask)
        assert (other.numpy() != img).any(axis=-1).mean() > 0.001
    assert raster_cuda.launches == 0     # CPU tensors ran the plain version


def test_init_carry_matches_reference():
    sh = jax_load_scene("resources/cornell.gltf", use_cache=False)
    js = sh.to_device()
    want = jax_init_carry(js, JaxSettings(width=64, height=32))
    got = init_carry(scene_from_numpy(scene_arrays(js), "cpu"),
                     RenderSettings(width=64, height=32))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_render_settings_match_reference():
    """Same fields, same defaults; and the same raster config."""
    want = {f.name: f.default for f in dataclasses.fields(JaxSettings)}
    got = {f.name: f.default for f in dataclasses.fields(RenderSettings)}
    assert got == want
    a = dataclasses.asdict(JaxSettings().raster_config())
    b = dataclasses.asdict(RenderSettings().raster_config())
    assert a == b
