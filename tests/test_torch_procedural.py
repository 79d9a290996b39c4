"""The port's stress scene (scene/procedural.py) against the reference
package's: the same document and the same scene arrays from the same
seed, untextured and with its three material-map sets, and the atlas
builders (build_atlas from images / material maps, checkerboard,
bump_normal_map) texel for texel."""

import numpy as np
import pytest

from toyrenderer_tpu.scene import procedural as JP
from toyrenderer_tpu.scene import textures as JX

from toyrenderer_tpu_torch.scene import procedural as TP
from toyrenderer_tpu_torch.scene import textures as TX


@pytest.mark.parametrize("textured", [False, True])
def test_stress_scene_matches_reference(textured):
    kw = dict(n_objects=24, sphere_res=10, seed=3, textured=textured)
    ref = JP.make_stress_scene(**kw)
    port = TP.make_stress_scene(**kw)
    fields = [k for k, v in vars(port).items() if not k.startswith('_')]
    assert len(fields) > 40
    for k in fields:
        got, want = getattr(port, k), getattr(ref, k)
        if isinstance(got, np.ndarray):
            assert got.dtype == np.asarray(want).dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert got == want, k
    assert port.num_textures == (3 if textured else 0)
    if textured:
        assert port.tex_analytic_ok()
        # mip 0 of the 512-px sets splits into 8 x 8 tiles of 64 texels
        assert port.tex_width[0, 0] == 512 and port.tex_height[1, 0] == 512


def test_atlas_builders_match_reference():
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            for h, w in ((5, 9), (64, 32), (1, 17))]
    maps = [dict(base=TX.checkerboard(64, 4, (200, 10, 30), (5, 6, 7)),
                 normal=TX.bump_normal_map(32, 3, amplitude=0.7),
                 wrap=1)]
    np.testing.assert_array_equal(TX.checkerboard(96, 6),
                                  JX.checkerboard(96, 6))
    np.testing.assert_array_equal(TX.bump_normal_map(64, 5, 1.5),
                                  JX.bump_normal_map(64, 5, 1.5))
    got = TX.build_atlas(material_maps=maps, images=imgs,
                         wrap_modes=[1, 0, 1])
    want = JX.build_atlas(material_maps=maps, images=imgs,
                          wrap_modes=[1, 0, 1])
    for f in ('texels', 'desc_offset', 'desc_width', 'desc_height',
              'num_mips', 'wrap_mode', 'min_resident_mip'):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.num_textures == want.num_textures == 4
    dev = got.to_device("cpu")
    ref = want.to_device()
    for k, v in ref.items():
        v = np.asarray(v)
        np.testing.assert_array_equal(
            dev[k].numpy(), v.view(np.int32) if v.dtype == np.uint32 else v,
            err_msg=k)
