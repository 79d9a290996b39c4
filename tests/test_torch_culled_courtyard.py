"""The whole courtyard, culled, against the reference package's frame.

The bench's deferred configuration (bench.py:140-236): 2-phase culling
with screen-error LOD, the compact masked merge at peel_merge_frac 0.10,
the opaque pair list cut to 60% of LOD0 (it only sets the early phase's
capacity), and K / B / the pair budget sized from content by the port's
probe (engine/capacity.py).  Every one of the 367 instances is in play;
culling and LOD make that affordable at 384x216 on a CPU, where the
unculled LOD0 set is not.  The reference runs through its Pallas fills
in interpret mode.

The reference's frame cannot take sized span-class caps (they are not
RenderSettings fields), so the test first shows through the port's
probe that the default caps drop nothing here in either set: both
packages then draw the same triangles.

Tolerances as tests/test_torch_frame.py holds the unculled courtyard:
ids on >= 99.95% of pixels and the u8 image within 1 on >= 99.9% (the
geometry stage's 4x4 products round differently, so a pixel centre
within an ulp of an edge may change triangle); culling counters equal,
raster counters up to the collapsed triangles (see
tests/test_torch_culling.py); no drops.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from toyrenderer_tpu.engine import RenderSettings as JaxSettings
from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.engine import init_carry as jax_init_carry
from toyrenderer_tpu.engine.frame import default_frame_inputs as jax_fi
from toyrenderer_tpu.engine.frame import render_frame as jax_render
from toyrenderer_tpu.ops.geometry import static_meshlet_pairs

from test_torch_culling import _collapsed, _scene, check_counters, t
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import RenderSettings, make_render_fn
from toyrenderer_tpu_torch.engine.capacity import (
    culled_pair_counts, sized_culled_settings, sized_raster_config)
from toyrenderer_tpu_torch.weights import (
    carry_from_numpy, frame_inputs_from_numpy)

W, H = 384, 216


def test_whole_courtyard_culled_matches_reference():
    sh, js, ts = _scene("courtyard.glb")
    mk_i, mk_m = static_meshlet_pairs(sh, 'mask')
    pi, pm = static_meshlet_pairs(sh, 'not_mask')
    cap = max(int(len(pi) * 0.6), 256)
    pi, pm = pi[:cap], pm[:cap]
    bench_kw = dict(width=W, height=H, manual_exposure=0.25,
                    enable_culling=True, peel_merge_frac=0.10)
    bench = RenderSettings(**bench_kw)
    fi = jax_fi(sh, JView.from_scene(sh, W, H).matrices())
    tfi = frame_inputs_from_numpy(fi, "cpu")
    counts = culled_pair_counts(ts, tfi, bench, cap, (t(mk_i), t(mk_m)))
    st = sized_culled_settings(bench, counts)
    # the default class caps drop nothing at this size, in either set
    assert sized_raster_config(st, counts) == st.raster_config()
    for name, c in counts.items():
        assert not any(c['drop'].values()), (name, c['drop'])
    assert counts['opaque']['pairs_wanted'] <= cap

    jst = JaxSettings(**bench_kw, use_pallas_fill=True, **{
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
    sized = {k: sized_raster_config(st, {k: c}) for k, c in counts.items()}
    img, _, aux = make_render_fn(
        st, device="cpu", raster_cfg=sized['opaque'],
        mask_raster_cfg=sized['masked'])(
        ts, t(pi), t(pm), fi, tc, mask_pair_inst=t(mk_i),
        mask_pair_meshlet=t(mk_m))

    ids_eq = (aux['tri_id'].numpy() == np.asarray(jaux['tri_id'])).mean()
    assert ids_eq >= 0.9995, ids_eq
    diff = np.abs(img.numpy().astype(int)
                  - np.asarray(jimg).astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.999, (diff <= 1).mean()
    check_counters(aux, jaux, _collapsed(ts, tfi, st, cap), st)
    drops = {k: int(v) for k, v in aux.items() if k.endswith('dropped')}
    assert drops and not any(drops.values()), drops
    assert int(aux['early_instances']) > 200
    assert int(aux['raster_mask_tris']) > 0
