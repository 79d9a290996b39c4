"""The packed GBuffer frame (`pack_gbuffer=True`) and the packed frame
inputs against the reference package.

* Cornell at 64x32 (the reference on its XLA fill path) and the whole
  courtyard culled at 384x216 with the compact masked merge
  (`peel_merge_frac=0.1`, the reference's Pallas fills in interpret
  mode), each with `pack_gbuffer=True`: every resolve -- the opaque
  fill, the masked set's compact merge (or its dense layers) -- writes
  the four u32 words, and lighting reads them back.  Tolerances as the
  float-plane frames are held (tests/test_torch_frame.py,
  tests/test_torch_culled_courtyard.py): ids equal on >= 99.95% of the
  pixels; the image within 1 on >= 99.5% (the reference's CPU exp2 is
  inexact at integer exponents, so an RGB9E5 emissive word may decode an
  ulp apart, and the quad sampler sees an ulp of geometry rounding).
* The dense masked path (`peel_merge_frac=0`) with packed words, the
  port's frame against its own float-plane frame.
* `pack_frame_inputs`: its vector equals the reference's `fi_vec`, and a
  frame rendered from the packed set is bit-equal to one rendered from
  the dict.
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
from toyrenderer_tpu.engine.frame import pack_frame_inputs as jax_pack
from toyrenderer_tpu.engine.frame import render_frame as jax_render
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs

from test_torch_culling import _scene, t
from test_torch_frame import _render_both
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, default_frame_inputs, init_carry, make_render_fn,
    pack_frame_inputs, render_frame, unpack_frame_inputs)
from toyrenderer_tpu_torch.engine.capacity import (
    culled_pair_counts, sized_culled_settings, sized_raster_config)
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.weights import (
    carry_from_numpy, frame_inputs_from_numpy)


def _close(img, jimg) -> float:
    diff = np.abs(np.asarray(img).astype(int) - np.asarray(jimg).astype(int))
    return float((diff.max(-1) <= 1).mean())


def test_cornell_packed_frame_matches_reference():
    (jimg, jaux), (img, aux), port = _render_both(
        "resources/cornell.gltf", 64, 32, pack_gbuffer=True)
    ids_eq = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
    assert ids_eq >= 0.9995, ids_eq
    assert _close(img, jimg) >= 0.995
    assert (aux['tri_id'].numpy() >= 0).mean() > 0.5
    # the packed frame is a frame of its own: its words round the planes
    floats, _, _ = render_frame(
        port['scene'], port['pi'], port['pm'], port['fi'], port['carry'],
        dataclasses.replace(port['settings'], pack_gbuffer=False))
    assert _close(img, floats.numpy()) >= 0.99


def test_courtyard_culled_packed_frame_matches_reference():
    sh, js, ts = _scene("courtyard.glb")
    w, h = 384, 216
    mk_i, mk_m = static_meshlet_pairs(sh, 'mask')
    pi, pm = static_meshlet_pairs(sh, 'not_mask')
    cap = max(int(len(pi) * 0.6), 256)
    pi, pm = pi[:cap], pm[:cap]
    kw = dict(width=w, height=h, manual_exposure=0.25, enable_culling=True,
              peel_merge_frac=0.1, pack_gbuffer=True)
    fi = jax_fi(sh, JView.from_scene(sh, w, h).matrices())
    tfi = frame_inputs_from_numpy(fi, "cpu")
    bench = RenderSettings(**kw)
    counts = culled_pair_counts(ts, tfi, bench, cap, (t(mk_i), t(mk_m)))
    st = sized_culled_settings(bench, counts)
    assert sized_raster_config(st, counts) == st.raster_config()
    jst = JaxSettings(**kw, use_pallas_fill=True, **{
        k: getattr(st, k)
        for k in ('max_tris_per_tile', 'max_big_tris', 'pair_capacity')})
    mask = dict(mask_pair_inst=jnp.asarray(mk_i),
                mask_pair_meshlet=jnp.asarray(mk_m))
    jc = jax_init_carry(js, jst)
    jimg, _, jaux = jax.jit(lambda s, a, b, f, c, m: jax_render(
        s, a, b, f, c, settings=jst, **m))(
        js, jnp.asarray(pi), jnp.asarray(pm), fi, jc, mask)
    tc = carry_from_numpy({k: tuple(map(np.asarray, v))
                           if isinstance(v, tuple) else np.asarray(v)
                           for k, v in jc.items()}, "cpu")
    img, _, aux = make_render_fn(st, device="cpu")(
        ts, t(pi), t(pm), fi, tc, mask_pair_inst=t(mk_i),
        mask_pair_meshlet=t(mk_m))
    ids_eq = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
    assert ids_eq >= 0.9995, ids_eq
    assert _close(img.numpy(), jimg) >= 0.995
    drops = {k: int(v) for k, v in aux.items() if k.endswith('dropped')}
    assert drops and not any(drops.values()), drops
    assert int(aux['raster_mask_tris']) > 0


def test_dense_masked_packed_frame_matches_float_frame():
    """The dense per-layer masked merge carries the packed words; its
    frame is the float-plane frame up to the words' rounding."""
    host = load_scene("resources/courtyard.glb", use_cache=False)
    scene = host.to_device("cpu")
    w, h = 128, 64
    view = View.from_scene(host, w, h)
    view.rotate_yaw_pitch(0.0, -0.6)
    fi = default_frame_inputs(host, view.matrices())
    mk_i, mk_m = (torch.from_numpy(a) for a in
                  static_meshlet_pairs(host, 'mask'))
    pi, pm = (torch.from_numpy(a) for a in
              static_meshlet_pairs(host, 'not_mask'))
    base = RenderSettings(width=w, height=h, manual_exposure=0.25,
                          enable_culling=True, peel_merge_frac=0.0)
    out = {}
    for packed in (False, True):
        st = dataclasses.replace(base, pack_gbuffer=packed)
        out[packed] = render_frame(
            scene, pi, pm, frame_inputs_from_numpy(fi, "cpu"),
            init_carry(scene, st), st, mask_pair_inst=mk_i,
            mask_pair_meshlet=mk_m)
    (img_f, _, aux_f), (img_p, _, aux_p) = out[False], out[True]
    np.testing.assert_array_equal(aux_p['tri_id'].numpy(),
                                  aux_f['tri_id'].numpy())
    assert int(aux_p['raster_mask_tris']) > 0
    assert _close(img_p.numpy(), img_f.numpy()) >= 0.99


def test_pack_frame_inputs_matches_reference_and_frame():
    host = load_scene("resources/cornell.gltf", use_cache=False)
    scene = host.to_device("cpu")
    fi = default_frame_inputs(host, View.from_scene(host, 64, 32).matrices())
    packed = pack_frame_inputs(fi, "cpu")
    want = np.asarray(jax_pack(fi)['fi_vec'])
    np.testing.assert_array_equal(packed['fi_vec'].numpy(), want)
    # node arrays upload once per host object
    assert pack_frame_inputs(fi, "cpu")['node_rotation'] is \
        packed['node_rotation']
    unpacked = unpack_frame_inputs(packed)
    for k, v in frame_inputs_from_numpy(fi, "cpu").items():
        np.testing.assert_array_equal(unpacked[k].numpy(), v.numpy(),
                                      err_msg=k)
    pi, pm = (torch.from_numpy(a) for a in static_meshlet_pairs(host, 'all'))
    st = RenderSettings(width=64, height=32, manual_exposure=0.01,
                        enable_taa=True)
    render = make_render_fn(st, "cpu")
    a = render(scene, pi, pm, fi, init_carry(scene, st))
    b = render(scene, pi, pm, packed, init_carry(scene, st))
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    for k in ('taa_history', 'prev_depth', 'exposure'):
        np.testing.assert_array_equal(a[1][k].numpy(), b[1][k].numpy())
