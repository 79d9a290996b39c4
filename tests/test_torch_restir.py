"""ReSTIR DI (ops/restir.py) against the reference package.

On the reference's own stress inputs (tests/test_restir.py:88-100: the
stress scene with 24 objects, sphere_res 8, seed 3, whose every 7th
material is emissive):

* `collect_emissive_lights` over the scene's world triangles: the same
  light list (count, slots, emission, areas within 1e-6).
* `restir_di` on a 96x64 view of that scene (the port's GBuffer: world
  positions from depth, normals, albedo), three frames with the
  reservoir threaded (temporal reuse from frame 1) and spatial reuse, the
  visibility rays through one tree (the reference's, handed over): the
  radiance within 1e-4 relative, the reservoirs equal (light ids exactly).
  The reference traces on the CPU with its XLA lockstep walk, cut at
  max_steps=64; the port's walk is not cut, so a further test holds the
  two walks' hits equal on the view's visibility rays.
* With TR_RT_CHUNKS=1 (the chunk route in both packages), the same
  three frames, to the same tolerances.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops import geometry as JG
from toyrenderer_tpu.ops import restir as JR
from toyrenderer_tpu.scene.procedural import make_stress_scene as jax_stress

from test_torch_raster import _one_torch_thread, scene_arrays  # noqa: F401
from toyrenderer_tpu_torch.engine import View, default_frame_inputs
from toyrenderer_tpu_torch.engine import frame as TF
from toyrenderer_tpu_torch.engine.frame import RenderSettings
from toyrenderer_tpu_torch.ops import geometry as TG
from toyrenderer_tpu_torch.ops import restir as TR
from toyrenderer_tpu_torch.ops.gbuffer import finish_gbuffer
from toyrenderer_tpu_torch.ops.lighting import world_pos_from_depth
from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
from toyrenderer_tpu_torch.weights import (
    bvh_from_numpy, frame_inputs_from_numpy)

W, H = 96, 64


@pytest.fixture(scope="module")
def stress():
    js_host = jax_stress(n_objects=24, sphere_res=8, seed=3)
    d = js_host.to_device()
    world = JG.node_world_matrices(d, d.node_translation, d.node_rotation,
                                   d.node_scale)
    iw, _ = JG.instance_transforms(d, world)
    pi, pm = JG.static_meshlet_pairs(js_host)
    jtris = JB.world_triangles(d, iw, jnp.asarray(pi), jnp.asarray(pm))
    jbvh = JB.build_bvh(*jtris)
    host = make_stress_scene(n_objects=24, sphere_res=8, seed=3)
    scene = host.to_device("cpu")
    tpi, tpm = torch.from_numpy(pi), torch.from_numpy(pm)
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, W, H).matrices()), "cpu")
    tw = TG.node_world_matrices(scene, fi['node_translation'],
                                fi['node_rotation'], fi['node_scale'])
    tiw, tadj = TG.instance_transforms(scene, tw)
    cfg = RenderSettings(width=W, height=H).raster_config()
    geo = TG.meshlet_clip_triangles(scene, tiw, fi['view_proj'], tpi, tpm)
    _, _, depth, tri_id, interp, _ = TF._raster_with_records(
        scene, geo, cfg, tiw, tadj, tiw, fi['prev_view_proj_nojitter'])
    gb = finish_gbuffer(interp, depth, tri_id, fi['jitter'], cfg)
    surf = dict(wp=world_pos_from_depth(depth, fi['inv_view_proj'], W, H),
                normal=gb['normal_f'], albedo=gb['albedo_f'],
                hit=depth > 0.0)
    return dict(jd=d, jiw=iw, pi=pi, pm=pm, jtris=jtris, jbvh=jbvh,
                scene=scene, tiw=tiw,
                tbvh=bvh_from_numpy(dict(
                    child_boxes=np.asarray(jbvh.child_boxes),
                    leaf_rows=np.asarray(jbvh.leaf_rows),
                    level_offset=jbvh.level_offset,
                    num_levels=jbvh.num_levels), "cpu"),
                surf={k: v.numpy() for k, v in surf.items()})


def _lights(stress):
    jl = JR.collect_emissive_lights(stress['jd'], jnp.asarray(stress['pi']),
                                    jnp.asarray(stress['pm']),
                                    *stress['jtris'][:3], max_lights=512)
    tl = TR.collect_emissive_lights(stress['scene'], *_port_tris(stress),
                                    max_lights=512)
    return jl, tl


def _port_tris(stress):
    """The pairs and the reference's world triangles, as tensors (both
    packages' world_triangles agree to an ulp; the light test is held on
    the same triangles)."""
    return (*(torch.from_numpy(a) for a in (stress['pi'], stress['pm'])),
            *(torch.from_numpy(np.array(v)) for v in stress['jtris'][:3]))


def test_collect_emissive_lights_matches_reference(stress):
    jl, tl = _lights(stress)
    n = int(jl['count'])
    assert n > 0 and int(tl['count']) == n
    np.testing.assert_array_equal(tl['valid'].numpy(), np.asarray(jl['valid']))
    for k in ('v0', 'e1', 'e2', 'emission', 'area'):
        np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert (tl['emission'].numpy()[:n].sum(-1) > 0).all()
    # a capacity below the count keeps the first lights in stream order
    few = TR.collect_emissive_lights(stress['scene'], *_port_tris(stress),
                                     max_lights=5)
    assert int(few['count']) == 5
    np.testing.assert_array_equal(few['v0'].numpy(), tl['v0'].numpy()[:5])


def test_restir_di_matches_reference(stress):
    jl, tl = _lights(stress)
    s = stress['surf']
    # every visibility ray of the view within the reference's 64 visits
    probe = TR.restir_di(stress['tbvh'], tl, *(torch.from_numpy(s[k]) for k
                         in ('wp', 'normal', 'albedo', 'hit')),
                         torch.tensor(0, dtype=torch.int32))
    assert probe[0].shape == (H, W, 3)
    hold_restir_frames(stress, jl, tl)


def hold_restir_frames(stress, jl, tl):
    """Three frames of restir_di in both packages, the reservoir threaded
    and spatial reuse on: radiance within 1e-4 relative, reservoirs
    equal (light ids exactly)."""
    s = stress['surf']
    jres = {k: jnp.zeros((H, W), jnp.int32 if k == 'li' else jnp.float32)
            for k in ('li', 'r1', 'r2', 'w', 'm')}
    tres = {k: torch.from_numpy(np.array(v)) for k, v in jres.items()}
    motion = np.zeros((H, W, 2), np.float32)
    lit_any = 0.0
    for f in range(3):
        jlit, jres = JR.restir_di(
            stress['jbvh'], jl, *(jnp.asarray(s[k]) for k in
                                  ('wp', 'normal', 'albedo', 'hit')),
            jnp.asarray(f, jnp.int32), prev_reservoir=jres,
            motion=jnp.asarray(motion))
        tlit, tres = TR.restir_di(
            stress['tbvh'], tl, *(torch.from_numpy(s[k]) for k in
                                  ('wp', 'normal', 'albedo', 'hit')),
            torch.tensor(f, dtype=torch.int32), prev_reservoir=tres,
            motion=torch.from_numpy(motion))
        want = np.asarray(jlit)
        np.testing.assert_allclose(tlit.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"frame {f}")
        np.testing.assert_array_equal(tres['li'].numpy(),
                                      np.asarray(jres['li']))
        for k in ('r1', 'r2', 'w', 'm'):
            np.testing.assert_allclose(tres[k].numpy(), np.asarray(jres[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        lit_any = max(lit_any, float((want.sum(-1) > 0).mean()))
    assert lit_any > 0.05


def test_restir_visibility_rays_match_reference_walk(stress):
    """The view's visibility rays (every pixel's) through the port's walk
    -- K3's plain version, not cut -- and the reference's XLA lockstep
    walk at ReSTIR's max_steps=64: the same hits, so the cut does not
    reach these rays."""
    calls = []
    real = TR.traverse_auto

    def spy(bvh, o, d, t_max, **kw):
        out = real(bvh, o, d, t_max, **kw)
        calls.append((o, d, t_max, kw, out))
        return out
    s = stress['surf']
    _, tl = _lights(stress)
    TR.traverse_auto = spy
    try:
        TR.restir_di(stress['tbvh'], tl, *(torch.from_numpy(s[k]) for k in
                                          ('wp', 'normal', 'albedo', 'hit')),
                     torch.tensor(2, dtype=torch.int32))
    finally:
        TR.traverse_auto = real
    assert len(calls) == 1
    o, d, t_max, kw, out = calls[0]
    assert o.shape == (H * W, 3) and kw['any_hit'] and 'live' not in kw
    want = JB.traverse(stress['jbvh'], jnp.asarray(o.numpy()),
                       jnp.asarray(d.numpy()), jnp.asarray(t_max.numpy()),
                       max_steps=64, any_hit=True)
    np.testing.assert_array_equal(out['hit'].numpy(),
                                  np.asarray(want['hit']))
    assert 0.01 < float(out['hit'].float().mean()) < 0.99


def test_restir_chunked_route_matches_reference(stress, monkeypatch):
    """With TR_RT_CHUNKS=1 the visibility rays take the chunk route in
    both packages (K8's plain fold here): the same frames, with the
    tolerances of test_restir_di_matches_reference."""
    jl, tl = _lights(stress)
    monkeypatch.setenv('TR_RT_CHUNKS', '1')
    hold_restir_frames(stress, jl, tl)
