"""Whole frames on a mesh of CPU devices: the port's renderers
(toyrenderer_tpu_torch/parallel/sharding.py) against the port's own
frame off the mesh and against the reference package's renderers
(toyrenderer_tpu/parallel/sharding.py) on the 8 virtual CPU devices of
tests/conftest.py.

* Culled Cornell at 448x256 with RT sun shadows and DDGI (one probe
  update; a small probe grid): `make_sp_frame_renderer` on a mesh of 8
  against a mesh of 1 in the port (both on the mesh branch; the u8
  image within 1 on >= 99.9% of the pixels), and the port on its mesh
  of 8 against the reference's `make_sp_frame_renderer` on 8 devices
  (ids on >= 99.95%, the image within 1 on >= 99.9%: the tolerance of
  the port's single-device frames against the reference's,
  tests/test_torch_culled_courtyard.py).  The reference on the CPU
  shards only its rays (its raster takes its XLA fill there), with a
  step budget (4096) no ray reaches.  No drops.
* The view batch: 4 views of Cornell on a ('dp', 'sp') = (4, 2) mesh
  against the reference's `make_view_batch_renderer` on the same mesh
  of devices (each image within 1 on >= 99.9%), and each view against
  the port's frame of it alone (the same bound).
* ROADMAP queue 3, the peel bound on a mesh: the glass frame (the
  stress scene's ground and instance 1 in glass, 2 OIT layers) on a
  mesh of 4 equals the port's frame without a mesh (within 1 on
  >= 99.9%), and its second layer changes the image.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyrenderer_tpu.engine import RenderSettings as JaxSettings
from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine import init_carry as jax_init_carry
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import ddgi as JD
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu.parallel import sharding as JP

from test_torch_bvh import _static_arrays
from test_torch_culling import _scene, t
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, init_carry, make_render_fn)
from toyrenderer_tpu_torch.ops import ddgi as TD
from toyrenderer_tpu_torch.parallel import (
    Mesh, make_sp_frame_renderer, make_view_batch_renderer, replicate_scene)
from toyrenderer_tpu_torch.weights import carry_from_numpy, rt_static_from_numpy

W, H = 448, 256
CPU = torch.device('cpu')
TRACED = dict(width=W, height=H, manual_exposure=0.25, enable_culling=True,
              enable_shadows=True, enable_gi=True, gi_update_phases=1)
PROBES = dict(max_probes_axis=4, rays_per_probe=64)


def within_1(a, b) -> float:
    diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return float((diff.max(-1) <= 1).mean())


def _drops(aux) -> dict:
    return {k: int(v) for k, v in aux.items() if k.endswith('dropped')}


@pytest.fixture(scope="module")
def cornell():
    sh, js, ts = _scene("cornell.gltf")
    pi, pm = static_meshlet_pairs(sh, 'all')
    rts = JB.build_rt_static(sh, pi, pm)
    view = JView.from_scene(sh, W, H)
    view.enable_jitter = False
    return dict(sh=sh, js=js, ts=ts, pi=pi, pm=pm, rts=rts,
                trs=rt_static_from_numpy(_static_arrays(rts), "cpu"),
                fi=jax_fi(sh, view.matrices()),
                jvol=JD.volume_from_aabb(*sh.world_aabb, **PROBES),
                tvol=TD.volume_from_aabb(*sh.world_aabb, **PROBES))


def _port_carry(c):
    """The reference's initial carry of the traced frame, in the port."""
    jc = jax_init_carry(c['js'], JaxSettings(**TRACED), c['jvol'])
    return carry_from_numpy({k: tuple(map(np.asarray, v))
                             if isinstance(v, tuple) else np.asarray(v)
                             for k, v in jc.items()}, "cpu")


@pytest.fixture(scope="module")
def port_traced(cornell):
    """The port's traced frame on meshes of 8 and of 1."""
    c = cornell
    st = RenderSettings(**TRACED)
    out = {}
    for n in (8, 1):
        fn = make_sp_frame_renderer(Mesh([CPU] * n, ('sp',)), st,
                                    ddgi_volume=c['tvol'])
        out[n] = fn(c['ts'], t(c['pi']), t(c['pm']), c['fi'],
                    _port_carry(c), rt_static=c['trs'])
    return out


def test_sp_frame_mesh_8_matches_mesh_1(port_traced):
    img8, _, aux8 = port_traced[8]
    img1, _, aux1 = port_traced[1]
    assert img8.shape == (H, W, 3)
    assert within_1(img8, img1) >= 0.999
    assert aux8['ddgi_updated'] and aux1['ddgi_updated']
    for aux in (aux8, aux1):
        drops = _drops(aux)
        assert drops and not any(drops.values()), drops
    lit = aux8['shadow'].numpy()
    assert 0.01 < (lit > 0.5).mean() < 0.99


def test_sp_frame_matches_reference(cornell, port_traced):
    c = cornell
    jst = JaxSettings(**TRACED, shadow_max_steps=4096, gi_max_steps=4096)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    jimg, jcarry, jaux = JP.make_sp_frame_renderer(
        mesh, jst, ddgi_volume=c['jvol'])(
        JP.replicate_scene(c['js'], mesh), jnp.asarray(c['pi']),
        jnp.asarray(c['pm']), c['fi'],
        jax_init_carry(c['js'], jst, c['jvol']), rt_static=c['rts'])
    img, carry, aux = port_traced[8]
    ids = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
    assert ids >= 0.9995, ids
    assert within_1(img, jimg) >= 0.999
    np.testing.assert_allclose(carry['ddgi_irradiance'].numpy(),
                               np.asarray(jcarry['ddgi_irradiance']),
                               rtol=1e-3, atol=1e-3)


def test_view_batch_matches_reference(cornell):
    c = cornell
    st = RenderSettings(width=W, height=H, manual_exposure=0.25)
    jst = JaxSettings(width=W, height=H, manual_exposure=0.25)
    fis = []
    for k in range(4):
        v = JView.from_scene(c['sh'], W, H)
        v.enable_jitter = False
        v.move(right=0.4 * k)
        fis.append(jax_fi(c['sh'], v.matrices()))
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                              ("dp", "sp"))
    jc = jax_init_carry(c['js'], jst)
    jimgs, _ = JP.make_view_batch_renderer(jmesh, jst)(
        JP.replicate_scene(c['js'], jmesh), jnp.asarray(c['pi']),
        jnp.asarray(c['pm']),
        jax.tree.map(lambda *xs: jnp.stack(xs), *fis),
        jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + x.shape), jc))
    mesh = Mesh(np.asarray([[CPU] * 2] * 4, object), ('dp', 'sp'))
    fn = make_view_batch_renderer(mesh, st)
    carries = [init_carry(c['ts'], st) for _ in fis]
    imgs, new = fn(replicate_scene(c['ts'], mesh), t(c['pi']), t(c['pm']),
                   fis, carries)
    assert imgs.shape == (4, H, W, 3) and len(new) == 4
    single = make_render_fn(st, device='cpu')
    for k in range(4):
        assert within_1(imgs[k], jimgs[k]) >= 0.999, k
        alone, _, _ = single(c['ts'], t(c['pi']), t(c['pm']), fis[k],
                             init_carry(c['ts'], st))
        assert within_1(imgs[k], alone) >= 0.999, k
    assert np.abs(imgs[0].numpy().astype(int)
                  - imgs[3].numpy().astype(int)).mean() > 0.05
    with pytest.raises(ValueError, match="dp=4"):
        fn(c['ts'], t(c['pi']), t(c['pm']), fis[:3], carries[:3])


def test_glass_frame_on_a_mesh_keeps_the_peel_bound():
    """ROADMAP queue 3: 2 OIT layers on a mesh of 4 equal the frame
    without a mesh; the reference's mesh branch would composite layer 0
    twice (its sharded raster has no peel bound)."""
    from toyrenderer_tpu_torch.engine import View, default_frame_inputs
    from toyrenderer_tpu_torch.ops.geometry import (
        static_meshlet_pairs as pairs_of)
    from toyrenderer_tpu_torch.scene.gltf import ALPHA_BLEND
    from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
    w, h = 192, 128                                  # tiles_y 8
    s = make_stress_scene(n_objects=8, sphere_res=8, seed=9)
    for inst, colour in ((0, [0.1, 0.9, 0.1, 0.4]),
                         (1, [0.9, 0.1, 0.1, 0.5])):
        mat = int(s.prim_material[int(s.inst_prim[inst])])
        s.mat_alpha_mode[mat] = ALPHA_BLEND
        s.mat_base_color[mat] = colour
    scene = s.to_device(CPU)
    view = View.from_scene(s, w, h)
    view.enable_jitter = False
    fi = default_frame_inputs(s, view.matrices())
    pi, pm = (torch.from_numpy(a) for a in pairs_of(s, 'opaque'))
    ti, tm = (torch.from_numpy(a) for a in pairs_of(s, 'blend'))
    imgs = {}
    for layers in (1, 2):
        st = RenderSettings(width=w, height=h, manual_exposure=0.05,
                            max_tris_per_tile=256, max_big_tris=64,
                            enable_transparency=True, oit_layers=layers)
        kw = dict(trans_pair_inst=ti, trans_pair_meshlet=tm)
        plain, _, _ = make_render_fn(st, device='cpu')(
            scene, pi, pm, fi, init_carry(scene, st), **kw)
        meshed, _, aux = make_sp_frame_renderer(
            Mesh([CPU] * 4, ('sp',)), st)(
            scene, pi, pm, fi, init_carry(scene, st), **kw)
        assert within_1(meshed, plain) >= 0.999, layers
        drops = _drops(aux)
        assert 'raster_trans_dropped' in drops and not any(drops.values())
        imgs[layers] = meshed.numpy().astype(int)
    changed = np.abs(imgs[2] - imgs[1]).max(-1)
    assert (changed > 10).sum() > 20
