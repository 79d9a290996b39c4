"""The debug views and the probe overlay against the reference package.

* `lighting.debug_view` for every mode 0-14 on Cornell's GBuffer (64x32,
  the port's resolve; float planes and packed words), with the frame's
  extras, and again without them: the reference's fallthroughs return
  the albedo for DEBUG_GI (10), DEBUG_LOD (12), mode 0 and any mode
  whose plane is missing.  The MinMip view (14) also on a synthetic mip
  plane, where its digits draw.  Equal to the reference's within 1e-6.
* Cornell 64x32 frames with debug_mode 6 (the depth view: a device
  reduction) and 11 (the meshlet hash) against the reference's frames:
  the u8 images equal.
* `ddgi.visualize_probes` on a 96x64 view of 64 probes whose 32 px
  patches overlap, so the overwrite order decides: within 1e-5 of the
  reference's fori_loop of splats.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import ddgi as JD
from toyrenderer_tpu.ops import lighting as JL

from test_torch_frame import _render_both
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import View, default_frame_inputs
from toyrenderer_tpu_torch.engine import frame as TF
from toyrenderer_tpu_torch.engine.frame import RenderSettings
from toyrenderer_tpu_torch.ops import ddgi as TD
from toyrenderer_tpu_torch.ops import geometry as geo_mod
from toyrenderer_tpu_torch.ops import lighting as TL
from toyrenderer_tpu_torch.ops.gbuffer import finish_gbuffer
from toyrenderer_tpu_torch.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

W, H = 64, 32


@pytest.fixture(scope="module")
def cornell():
    """Cornell's GBuffer (both forms) and the frame's extras, numpy."""
    host = load_scene("resources/cornell.gltf", use_cache=False)
    scene = host.to_device("cpu")
    fi = frame_inputs_from_numpy(default_frame_inputs(
        host, View.from_scene(host, W, H).matrices()), "cpu")
    pi, pm = (torch.from_numpy(a) for a in static_meshlet_pairs(host, 'all'))
    world = geo_mod.node_world_matrices(scene, fi['node_translation'],
                                        fi['node_rotation'],
                                        fi['node_scale'])
    iw, adj = geo_mod.instance_transforms(scene, world)
    cfg = RenderSettings(width=W, height=H).raster_config()
    geo = geo_mod.meshlet_clip_triangles(scene, iw, fi['view_proj'], pi, pm)
    _, _, depth, tri_id, interp, _ = TF._raster_with_records(
        scene, geo, cfg, iw, adj, iw, fi['prev_view_proj_nojitter'])
    out = {}
    for form, planes in (('planes', True), ('packed', False)):
        gb = finish_gbuffer(interp, depth, tri_id, fi['jitter'], cfg,
                            emit_planes=planes)
        out[form] = {k: v.numpy() for k, v in gb.items()}
    rng = np.random.default_rng(4)
    gb = out['planes']
    out['extras'] = dict(
        motion=gb['motion'] + rng.normal(0, 3, gb['motion'].shape).astype(
            np.float32),
        uv=gb['uv'] + rng.uniform(-2, 2, gb['uv'].shape).astype(np.float32),
        shadow=rng.uniform(0, 1, (H, W)).astype(np.float32),
        ao=rng.uniform(0, 1, (H, W)).astype(np.float32),
        tri_id=tri_id.numpy())
    assert (out['extras']['tri_id'] >= 0).mean() > 0.5
    return out


def _both(gb, mode, extras):
    want = np.asarray(JL.debug_view(
        {k: jnp.asarray(v) for k, v in gb.items()}, mode,
        extras={k: jnp.asarray(v) for k, v in extras.items()}))
    got = TL.debug_view({k: torch.from_numpy(v) for k, v in gb.items()},
                        mode, extras={k: torch.from_numpy(v)
                                      for k, v in extras.items()}).numpy()
    assert got.shape == want.shape == (H, W, 3)
    return got, want


@pytest.mark.parametrize("mode", range(15))
@pytest.mark.parametrize("form", ['planes', 'packed'])
def test_debug_view_matches_reference(cornell, mode, form):
    got, want = _both(cornell[form], mode, cornell['extras'])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    fallthrough = mode in (0, TL.DEBUG_GI, TL.DEBUG_LOD, TL.DEBUG_MIP)
    albedo, _ = _both(cornell[form], TL.DEBUG_ALBEDO, {})
    assert np.array_equal(got, albedo) == (fallthrough or mode == 1)


@pytest.mark.parametrize("mode", [7, 8, 9, 11, 13, 14])
def test_debug_view_without_its_plane_shows_albedo(cornell, mode):
    got, want = _both(cornell['planes'], mode, {})
    albedo, _ = _both(cornell['planes'], TL.DEBUG_ALBEDO, {})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, albedo)


def test_mip_view_draws_digits(cornell):
    """DEBUG_MIP on a desired-mip plane spanning -1 (untextured) to 12:
    the heat map, the darkened pads and the digits of each 32 px block."""
    ys, xs = np.mgrid[0:H, 0:W]
    mip = ((xs // 7 + ys // 5) % 14 - 1).astype(np.float32) + 0.25
    got, want = _both(cornell['planes'], TL.DEBUG_MIP,
                      dict(tex_desired_mip=mip))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got == 1.0).all(-1).sum() > 10          # digit pixels


@pytest.mark.parametrize("mode", [TL.DEBUG_DEPTH, TL.DEBUG_MESHLET])
def test_debug_frame_matches_reference(mode):
    (jimg, _), (img, _), _ = _render_both("resources/cornell.gltf", W, H,
                                          debug_mode=mode)
    assert img.dtype == np.uint8
    np.testing.assert_array_equal(img, np.asarray(jimg))


def test_probe_overlay_matches_reference():
    host = load_scene("resources/cornell.gltf", use_cache=False)
    lo, hi = (np.asarray(x, np.float32) for x in host.world_aabb)
    args = dict(origin=tuple(float(x) for x in lo),
                spacing=tuple(float(x) for x in (hi - lo) / 3.0),
                counts=(4, 4, 4), rays_per_probe=32)
    jvol, tvol = JD.DdgiVolume(**args), TD.DdgiVolume(**args)
    w, h = 96, 64
    view = View.from_scene(host, w, h)
    view.move(forward=-1.5)
    m = view.matrices()
    rng = np.random.default_rng(9)
    p = tvol.num_probes
    hdr = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    depth = np.where(rng.uniform(size=(h, w)) < 0.3, 0.0,
                     rng.uniform(0, 0.02, (h, w))).astype(np.float32)
    irr = rng.uniform(0, 2, (p, 64, 3)).astype(np.float32)
    off = rng.normal(0, 0.05, (p, 3)).astype(np.float32)
    vp = np.asarray(m['view_proj_nojitter'], np.float32)
    cam = np.asarray(m['cam_pos'], np.float32)
    # spheres of 1 unit: patch-sized discs that overlap on screen
    want = np.asarray(JD.visualize_probes(
        jnp.asarray(hdr), jnp.asarray(depth), jvol, jnp.asarray(irr),
        jnp.asarray(vp), jnp.asarray(cam), radius_world=1.0,
        probe_offset=jnp.asarray(off)))
    got = TD.visualize_probes(
        torch.from_numpy(hdr), torch.from_numpy(depth), tvol,
        torch.from_numpy(irr), torch.from_numpy(vp), torch.from_numpy(cam),
        radius_world=1.0, probe_offset=torch.from_numpy(off)).numpy()
    drawn = (want != hdr).any(-1)
    assert drawn.mean() > 0.2, drawn.mean()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the patches overlap, so the overwrite order decides pixels: the
    # reference with the probes reversed draws another image
    rev = np.asarray(JD.visualize_probes(
        jnp.asarray(hdr), jnp.asarray(depth), jvol,
        jnp.asarray(irr[::-1].copy()), jnp.asarray(vp), jnp.asarray(cam),
        radius_world=1.0, probe_offset=jnp.asarray(off)))
    assert (rev != want).any()
