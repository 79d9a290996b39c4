"""The port against the stored Cornell golden image
(tests/goldens/cornell_allon_448x256.png), rendered as
tests/test_goldens.py's `_render_allon` renders it: 448x256, four frames,
sun-map shadows, GTAO, DDGI whose probe rays trace the per-frame morton
tree (no static topology: bvh.build_bvh every frame) and whose probe
hits read the sun map, TAA and bloom.  The image is compared with the
golden test's own metric and tolerance (tests/test_goldens.py:102-103:
blurred linear-RGB difference, mean < 0.010, p99 < 0.060); the golden
is read with the port's PNG decoder.

The courtyard golden is not held here (see ROADMAP queue 3: it was
rendered with a sun map whose CPU branch dropped 71% of the casters).
"""

import numpy as np
import torch

from test_goldens import GOLDEN_DIR, _perceptual_diff
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, default_frame_inputs, init_carry, make_render_fn)
from toyrenderer_tpu_torch.ops import bvh_cuda
from toyrenderer_tpu_torch.ops.ddgi import volume_from_aabb
from toyrenderer_tpu_torch.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.png import decode_png

W, H = 448, 256


def test_cornell_allon_golden():
    host = load_scene("resources/cornell.gltf", use_cache=False)
    scene = host.to_device("cpu")
    mk_i, _ = static_meshlet_pairs(host, 'mask')
    assert len(mk_i) == 0
    pi, pm = (np.asarray(a) for a in static_meshlet_pairs(host, 'all'))
    vol = volume_from_aabb(*host.world_aabb)
    settings = RenderSettings(
        width=W, height=H, manual_exposure=0.01, enable_shadows=True,
        shadow_technique='map', enable_ao=True, enable_gi=True,
        enable_taa=True, enable_bloom=True)
    render = make_render_fn(settings, device="cpu")
    carry = init_carry(scene, settings, vol)
    view = View.from_scene(host, W, H)
    pi, pm = torch.from_numpy(pi), torch.from_numpy(pm)
    bvh_cuda.reset_launches()
    updates = 0
    for _ in range(4):
        mats = view.matrices()
        img, carry, aux = render(scene, pi, pm,
                                 default_frame_inputs(host, mats), carry,
                                 ddgi_volume=vol)
        view.advance(mats)
        updates += aux['ddgi_updated']
        assert int(aux['shadow_map_dropped']) == 0
    assert updates == 4                    # gi_update_phases 1: every frame
    assert not any(bvh_cuda.launches_by_kernel.values())
    with open(f"{GOLDEN_DIR}/cornell_allon_448x256.png", "rb") as f:
        ref = decode_png(f.read())[..., :3]
    mean, p99 = _perceptual_diff(ref, img.numpy())
    assert mean < 0.010, mean
    assert p99 < 0.060, p99
