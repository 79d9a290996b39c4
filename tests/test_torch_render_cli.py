"""The port's render CLI (toyrenderer_tpu_torch/tools/render.py) on the
CPU: Cornell at 224x128 for 2 frames.  The PNG it writes, read back by
the port's decoder, equals the image of the same frames rendered through
`make_render_fn` directly, and its printed coverage is that frame's.
Each flag of a pass the port does not have yet raises
NotImplementedError naming its ROADMAP item.
"""

import re

import numpy as np
import pytest
import torch

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine import (
    RenderSettings, View, default_frame_inputs, init_carry, make_render_fn)
from toyrenderer_tpu_torch.ops.bvh import build_rt_static
from toyrenderer_tpu_torch.ops.geometry import static_meshlet_pairs
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene.png import decode_png
from toyrenderer_tpu_torch.tools import render as cli

W, H = 224, 128
SCENE = "resources/cornell.gltf"


def _direct(frames, **kw):
    """The CLI's frames through make_render_fn, with default capacities
    (the sized ones only raise caps Cornell does not reach)."""
    host = load_scene(SCENE, use_cache=False)
    scene = host.to_device("cpu")
    pi, pm = (torch.from_numpy(a) for a in static_meshlet_pairs(host, 'all'))
    st = RenderSettings(width=W, height=H, manual_exposure=0.01, **kw)
    extra = {}
    if st.enable_shadows:
        extra['rt_static'] = build_rt_static(host, pi.numpy(), pm.numpy(),
                                             device="cpu")
    render = make_render_fn(st, device="cpu")
    carry = init_carry(scene, st)
    view = View.from_scene(host, W, H)
    for _ in range(frames):
        mats = view.matrices()
        img, carry, aux = render(scene, pi, pm,
                                 default_frame_inputs(host, mats), carry,
                                 **extra)
        view.advance(mats)
    return img.numpy(), int((aux['tri_id'] >= 0).sum())


@pytest.mark.parametrize("flags,kw", [
    (["--shadows", "--shadowtechnique", "map", "--taa", "--bloom", "--ao"],
     dict(enable_shadows=True, shadow_technique='map', enable_taa=True,
          enable_bloom=True, enable_ao=True)),
    (["--bruteforceraster"], dict(use_bruteforce_raster=True)),
], ids=["map-shadows", "bruteforce"])
def test_cli_writes_the_frame(tmp_path, capsys, flags, kw):
    out = tmp_path / "frame.png"
    stats = tmp_path / "stats.json"
    rc = cli.main(["--scene", SCENE, "--displayresolution", f"{W}x{H}",
                   "--frames", "2", "--exposure", "0.01", "--device", "cpu",
                   "--nocache", "--output", str(out), "--stats", str(stats),
                   *flags])
    assert rc == 0
    printed = capsys.readouterr().out
    img = decode_png(out.read_bytes())
    assert img.shape == (H, W, 4) and (img[..., 3] == 255).all()
    want, covered = _direct(2, **kw)
    np.testing.assert_array_equal(img[..., :3], want)
    assert f"[stats] covered pixels: {covered}/{W * H}" in printed
    assert re.search(r"^\[frame 1\] frame: [0-9.]+ ms$", printed, re.M)
    assert stats.exists() and '"coverage"' in stats.read_text()


@pytest.mark.parametrize("flags", [
    ["--vtstream", "tile"], ["--animate"], ["--restir"], ["--transparency"],
    ["--showprobes"], ["--debugview", "2"], ["--passtable"],
    ["--orbit", "0.1"], ["--scene", "stress"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--device", "cpu", *flags])
