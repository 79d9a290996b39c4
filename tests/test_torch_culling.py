"""The port's HZB, culling and 2-phase culled frame against the reference
package's.

HZB and culling get the SAME inputs in both packages (instance matrices,
frame inputs and depth handed over as numpy) and are compared exactly,
mip levels included: ceil(log2(extent)) picks the mip, so an extent
within an ulp of a power of two would change the level if the packages
computed log2 differently.

The culled frame runs in both packages, two frames with the carry (and
its HZB) threaded, the reference through its Pallas fill in interpret
mode.  Ids exact, u8 image within 1, culling counters equal.  The
geometry stage's 4x4 products round differently (XLA sums the four
products pairwise or by fused multiply-adds, depending on the product's
shape; PyTorch rounds each product), so clip coordinates may move by an
ulp.  A LOD-simplified mesh holds collapsed triangles (two vertices
identical): their orientation is the sign of rounding noise, so setup
keeps such a triangle in one package and rejects it in the other.  It
covers no pixel, but counts in `tris` / `binned_pairs` / `big_tris`;
those counters may differ by at most the view's collapsed triangles
(and their pairs), counted here from the port's own pair list.  Depth
and the HZB built from it are held as tests/test_torch_frame.py holds
the frame's depth, to rtol 1e-5: the clip coordinates' ulps reach it.
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
from toyrenderer_tpu.engine.frame import render_frame as jax_render
from toyrenderer_tpu.ops import culling as JC
from toyrenderer_tpu.ops import geometry as JG
from toyrenderer_tpu.ops import hzb as JH
from toyrenderer_tpu.scene import load_scene as jax_load_scene
from toyrenderer_tpu.scene.procedural import make_stress_scene

from test_torch_raster import _one_torch_thread, scene_arrays  # noqa: F401
from toyrenderer_tpu_torch.engine import RenderSettings, render_frame
from toyrenderer_tpu_torch.ops import culling as TC
from toyrenderer_tpu_torch.ops import geometry as TG
from toyrenderer_tpu_torch.ops import hzb as TH
from toyrenderer_tpu_torch.weights import (
    carry_from_numpy, frame_inputs_from_numpy, scene_from_numpy)


def t(x):
    return torch.from_numpy(np.array(x))


def _scene(name):
    sh = (make_stress_scene(n_objects=16, sphere_res=10, seed=5)
          if name == 'stress' else
          jax_load_scene(f"resources/{name}", use_cache=False))
    js = sh.to_device()
    return sh, js, scene_from_numpy(scene_arrays(js), "cpu")


@jax.jit
def _jax_levels(mips, u0, v0, u1, v1):
    """The reference hzb_test_bbox's mip choice (ops/hzb.py:93-105)."""
    h0, w0 = mips[0].shape
    su, sv = 200 / (2.0 * w0), 120 / (2.0 * h0)
    ext_x = (jnp.clip(u1, 0.0, 1.0) * su - jnp.clip(u0, 0.0, 1.0) * su) * w0
    ext_y = (jnp.clip(v1, 0.0, 1.0) * sv - jnp.clip(v0, 0.0, 1.0) * sv) * h0
    ext = jnp.maximum(jnp.maximum(ext_x, ext_y), 1e-6)
    return jnp.clip(jnp.ceil(jnp.log2(ext)), 0, len(mips) - 1).astype(
        jnp.int32)


def test_hzb_matches_reference():
    """Build, init and query on seeded random depth (200x120: padded to
    a 128x64 mip 0, 7 mips), with random boxes and boxes whose extent is
    a power of two texels at their level."""
    w, h = 200, 120
    rng = np.random.default_rng(11)
    # 8x8 blocks of depth with per-pixel noise, and a patch of sky
    depth = np.repeat(np.repeat(rng.uniform(0.2, 1.0, (h // 8, w // 8)),
                                8, 0), 8, 1)
    depth = (depth * rng.uniform(0.9, 1.0, (h, w))).astype(np.float32)
    depth[:40, 150:] = 0.0
    jm = JH.build_hzb(jnp.asarray(depth), w, h)
    tm = TH.build_hzb(t(depth), w, h)
    assert len(tm) == len(jm) == TH.num_hzb_mips(w, h) == 7
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(TH.init_hzb(w, h), JH.init_hzb(w, h)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    n = 4000
    u0 = rng.uniform(-0.1, 1.0, n).astype(np.float32)
    v0 = rng.uniform(-0.1, 1.0, n).astype(np.float32)
    ext = np.exp2(rng.uniform(-8, 0.5, n)).astype(np.float32)
    u1 = (u0 + ext * rng.uniform(0.2, 1.0, n)).astype(np.float32)
    v1 = (v0 + ext * rng.uniform(0.2, 1.0, n)).astype(np.float32)
    # extents of exactly 2^k texels of mip 0 (128 texels cover 256/200)
    k = rng.integers(0, 7, 500)
    u0[:500] = np.float32(0.25)
    u1[:500] = (u0[:500] + np.exp2(k) * (200 / 256 / 128)).astype(np.float32)
    v1[:500] = v0[:500]
    d_near = rng.uniform(0.0, 1.0, n).astype(np.float32)
    args = [u0, v0, u1, v1]
    want = np.asarray(JH.hzb_test_bbox(jm, *map(jnp.asarray, args),
                                       jnp.asarray(d_near), w, h))
    got = TH.hzb_test_bbox(tm, *map(t, args), t(d_near), w, h)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.2 < want.mean() < 0.95
    level, _ = TH.hzb_level(tm, *map(t, args), w, h)
    np.testing.assert_array_equal(
        level.numpy(), np.asarray(_jax_levels(jm, *map(jnp.asarray, args))))
    assert len(np.unique(level.numpy())) == 7


@pytest.mark.parametrize("name", ["stress", "courtyard.glb"])
def test_culling_matches_reference(name):
    """cull_instances (without and with an HZB), select_lod, build_pairs
    and cull_meshlets on the same instance matrices; the HZB is a near
    wall over the left half of the screen."""
    sh, js, ts = _scene(name)
    w, h = 192, 96
    fi = jax_fi(sh, JView.from_scene(sh, w, h).matrices())
    tfi = frame_inputs_from_numpy(fi, "cpu")
    world = JG.node_world_matrices(js, fi['node_translation'],
                                   fi['node_rotation'], fi['node_scale'])
    iw, _ = JG.instance_transforms(js, world)
    tiw = t(iw)
    depth = np.zeros((h, w), np.float32)
    depth[:, :w // 2] = 0.5
    jhzb = JH.build_hzb(jnp.asarray(depth), w, h)
    thzb = TH.build_hzb(t(depth), w, h)
    cull_args = ('cull_frustum_planes', 'cull_cam_pos', 'proj_scale_px')
    cap = 4096
    lod_kw = dict(error_threshold_px=2.0)
    for with_hzb in (False, True):
        hz = dict(hzb=jhzb, hzb_view_proj=fi['view_proj_nojitter'],
                  hzb_inst_world=iw) if with_hzb else {}
        thz = dict(hzb=thzb, hzb_view_proj=tfi['view_proj_nojitter'],
                   hzb_inst_world=tiw) if with_hzb else {}
        jc = JC.cull_instances(js, iw, *(fi[k] for k in cull_args), w, h,
                               **hz, **lod_kw)
        tc = TC.cull_instances(ts, tiw, *(tfi[k] for k in cull_args), w, h,
                               **thz, **lod_kw)
        for k in ('visible', 'occluded_candidate', 'lod'):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]),
                                          err_msg=k)
        vis = np.asarray(jc['visible'])
        assert vis.any() and not vis[sh.num_instances:].any()
        assert np.asarray(jc['occluded_candidate']).any() == with_hzb
        jp = JC.build_pairs(js, jc['visible'], jc['lod'], cap)
        tp = TC.build_pairs(ts, tc['visible'], tc['lod'], cap)
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jv = JC.cull_meshlets(js, *jp[:3], iw, fi['cull_frustum_planes'],
                              fi['cull_cam_pos'], w, h, **{
                                  k: v for k, v in hz.items()
                                  if k != 'hzb_inst_world'})
        tv = TC.cull_meshlets(ts, *tp[:3], tiw, tfi['cull_frustum_planes'],
                              tfi['cull_cam_pos'], w, h, **{
                                  k: v for k, v in thz.items()
                                  if k != 'hzb_inst_world'})
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert np.asarray(jv).sum() < np.asarray(jp[2]).sum()
    # LOD selection reaches coarser levels, and forced_lod pins them
    prim = js.inst_prim[:sh.num_instances]
    dist = jnp.linspace(1.0, 400.0, prim.shape[0])
    want = np.asarray(JC.select_lod(js, prim, dist, fi['proj_scale_px']))
    got = TC.select_lod(ts, t(prim), t(dist), tfi['proj_scale_px'])
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 0
    got1 = TC.select_lod(ts, t(prim), t(dist), tfi['proj_scale_px'],
                         forced_lod=1)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(JC.select_lod(
        js, prim, dist, fi['proj_scale_px'], forced_lod=1)))


def _collapsed(ts, tfi, st, cap):
    """Collapsed triangles (two bit-identical clip vertices) of the view's
    pair list after frustum, LOD and meshlet culling but no occlusion
    (the port's culling): a superset of both phases' lists."""
    world = TG.node_world_matrices(ts, tfi['node_translation'],
                                   tfi['node_rotation'], tfi['node_scale'])
    iw, _ = TG.instance_transforms(ts, world)
    args = (tfi['cull_frustum_planes'], tfi['cull_cam_pos'])
    c = TC.cull_instances(ts, iw, *args, tfi['proj_scale_px'], st.width,
                          st.height, error_threshold_px=st.lod_error_px)
    pi, pm, pv, _ = TC.build_pairs(ts, c['visible'], c['lod'], cap)
    pv = TC.cull_meshlets(ts, pi, pm, pv, iw, *args, st.width, st.height)
    geo = TG.meshlet_clip_triangles(ts, iw, tfi['view_proj'], pi, pm, pv)
    v = geo['clip']
    same = ((v[:, 0] == v[:, 1]).all(-1) | (v[:, 1] == v[:, 2]).all(-1)
            | (v[:, 0] == v[:, 2]).all(-1))
    return int((same & geo['tri_valid']).sum())


def check_counters(aux, jaux, collapsed, st):
    """Every early_ / late_ counter of the reference's frame, in the
    port's: the culling counters equal; the raster `tris` and
    `binned_pairs` counters within the collapsed triangles (times the
    slot grid for pairs), which XLA's summation order counts in one
    package and not the other; and the collapsed triangles at most 5% of
    the triangles the frame set up (measured: 4 of 86 and of 88 in the
    stress scene's two frames, where each of early_ / late_ tris and
    binned_pairs differed by 1 in the first; none on cornell and the
    courtyard, whose counters are all equal)."""
    keys = [k for k in jaux if k.startswith(('early_', 'late_'))]
    assert keys and set(keys) <= set(aux)
    set_up = int(jaux['early_tris']) + int(jaux['late_tris'])
    assert collapsed <= 0.05 * set_up, (collapsed, set_up)
    slots = st.bin_slots_x * st.bin_slots_y
    for k in keys:
        got, want = int(aux[k]), int(jaux[k])
        if k.endswith(('_tris', '_binned_pairs')):
            bound = collapsed * (slots if 'pairs' in k else 1)
            assert abs(got - want) <= bound, (k, got, want, collapsed)
        else:
            assert got == want, (k, got, want)


@pytest.mark.parametrize("name,size,caps,late_drawn", [
    ("stress", (192, 96), dict(max_tris_per_tile=256, max_big_tris=64,
                               tile_batch=4), True),
    # Cornell's instances span both halves: none hides behind the wall
    ("cornell.gltf", (448, 256), dict(max_tris_per_tile=128,
                                      max_big_tris=64), False),
])
def test_culled_frame_matches_reference(name, size, caps, late_drawn):
    sh, js, ts = _scene(name)
    w, h = size
    pi, pm = JG.static_meshlet_pairs(sh)
    common = dict(width=w, height=h, manual_exposure=0.1,
                  enable_culling=True, **caps)
    jst = JaxSettings(**common, use_pallas_fill=True)
    st = RenderSettings(**common)

    @jax.jit
    def frame(s, a, b, f, c):
        return jax_render(s, a, b, f, c, settings=jst)
    # the first frame culls against a carried HZB of a near wall over the
    # left half of the screen, with the instances where they are: the
    # early phase drops what lies behind the wall, and the late phase,
    # testing against the frame's own depth, draws it
    jc = dict(jax_init_carry(js, jst))
    fi0 = jax_fi(sh, JView.from_scene(sh, w, h).matrices())
    world = JG.node_world_matrices(js, fi0['node_translation'],
                                   fi0['node_rotation'], fi0['node_scale'])
    jc['prev_inst_world'] = JG.instance_transforms(js, world)[0]
    wall = np.zeros((h, w), np.float32)
    wall[:, :w // 2] = 0.9
    jc['hzb'] = JH.build_hzb(jnp.asarray(wall), w, h)
    tc = carry_from_numpy({k: tuple(map(np.asarray, v))
                           if isinstance(v, tuple) else np.asarray(v)
                           for k, v in jc.items()}, "cpu")
    view = JView.from_scene(sh, w, h)
    late = []
    for _ in range(2):
        mats = view.matrices()
        fi = jax_fi(sh, mats)
        tfi = frame_inputs_from_numpy(fi, "cpu")
        collapsed = _collapsed(ts, tfi, st, len(pi))
        jimg, jc, jaux = frame(js, jnp.asarray(pi), jnp.asarray(pm), fi, jc)
        img, tc, aux = render_frame(ts, t(pi), t(pm), tfi, tc, st)
        view.advance(mats)
        np.testing.assert_array_equal(aux['tri_id'].numpy(),
                                      np.asarray(jaux['tri_id']))
        assert np.abs(img.numpy().astype(int)
                      - np.asarray(jimg).astype(int)).max() <= 1
        check_counters(aux, jaux, collapsed, st)
        assert int(aux['early_instances']) > 0
        late.append(int(aux['late_instances']))
        np.testing.assert_allclose(aux['depth'].numpy(),
                                   np.asarray(jaux['depth']), rtol=1e-5,
                                   atol=1e-7)
        for a, b in zip(tc['hzb'], jc['hzb']):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
    assert (late[0] > 0) == late_drawn
