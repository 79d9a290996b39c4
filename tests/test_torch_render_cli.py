"""The port's render CLI (toyrenderer_tpu_torch/tools/render.py) on the
CPU: Cornell at 224x128 for 2 frames.  The PNG it writes, read back by
the port's decoder, equals the image of the same frames rendered through
`make_render_fn` directly, and its printed coverage is that frame's.
The textured stress scene streams through `--vtstream tile` and
`--vtstream mip` (224x128, 2 frames) as the same loop does directly.
No flag raises any longer: `--passtable`, the last one ported, renders
one more frame under the profiler and prints its per-pass table (the
slice-8 and slice-9 flags: tests/test_torch_render_cli_flags.py).
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
from toyrenderer_tpu_torch.weights import frame_inputs_from_numpy

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


@pytest.mark.parametrize("mode,pool", [("tile", 24), ("mip", 2)])
def test_cli_streams_the_stress_scene(tmp_path, capsys, mode, pool):
    """--scene stress --vtstream tile|mip: the residency overrides ride
    the frames from frame 0 and each frame's feedback drives the next
    update; the PNG equals the same loop through make_render_fn and the
    port's managers, and the managers' stats are the ones printed."""
    from toyrenderer_tpu_torch.engine import capacity, streaming
    from toyrenderer_tpu_torch.scene.procedural import make_stress_scene
    out = tmp_path / "stress.png"
    rc = cli.main(["--scene", "stress", "--displayresolution", f"{W}x{H}",
                   "--frames", "2", "--exposure", "0.1", "--device", "cpu",
                   "--vtstream", mode, "--vtpool", str(pool),
                   "--output", str(out)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert f"[vt] {mode}-granularity streaming, pool budget {pool}" in printed

    host = make_stress_scene(n_objects=64, sphere_res=16, textured=True)
    scene = host.to_device("cpu")
    pi, pm = (torch.from_numpy(a) for a in static_meshlet_pairs(host, 'all'))
    st = RenderSettings(width=W, height=H, manual_exposure=0.1)
    view = View.from_scene(host, W, H)
    counts = capacity.tile_pair_counts(scene, frame_inputs_from_numpy(
        default_frame_inputs(host, view.matrices()), "cpu"), st,
        {"opaque": (pi, pm)})
    st = capacity.sized_settings(st, counts)
    render = make_render_fn(st, device="cpu",
                            raster_cfg=capacity.sized_raster_config(
                                st, counts))
    atlas = streaming.scene_atlas(host)
    if mode == "tile":
        mgr = streaming.TileStreamingManager(atlas, pool_tiles=pool,
                                             device="cpu")
        ov = mgr.update(np.full(mgr.table_size, np.inf))
    else:
        mgr = streaming.TextureStreamingManager(atlas, pool_texels=pool << 16,
                                                device="cpu")
        ov = mgr.update(np.full(host.num_textures, np.inf))
    carry = init_carry(scene, st)
    stats = []
    for _ in range(2):
        mats = view.matrices()
        img, carry, aux = render(scene, pi, pm, dict(
            default_frame_inputs(host, mats), **ov), carry)
        view.advance(mats)
        ov = mgr.update(aux['vt_tile_feedback' if mode == 'tile'
                            else 'tex_feedback'])
        stats.append(str(mgr.stats))
    assert ov['tex_texels'] is mgr.pool
    np.testing.assert_array_equal(decode_png(out.read_bytes())[..., :3],
                                  img.numpy())
    vt_lines = [ln for ln in printed.splitlines()
                if ln.startswith("[vt] update")]
    assert [ln.split(", ", 2)[2] for ln in vt_lines] == stats
    assert int((aux['tri_id'] >= 0).sum()) > 0


@pytest.mark.parametrize("flags", [["--passtable"]])
def test_unported_flags_raise(flags, tmp_path, capsys):
    assert not hasattr(cli, '_NOT_PORTED')
    assert cli.main(["--device", "cpu", "--displayresolution", "64x32",
                     "--output", str(tmp_path / "p.png"), *flags]) == 0
    rows = [ln[len("[passes] "):] for ln in capsys.readouterr().out
            .splitlines() if ln.startswith("[passes] ")]
    names = {r.split()[0] for r in rows[1:] if r.split()}
    assert {'UpdateInstanceConsts', 'BasePass(fill+resolve)',
            'DeferredLighting', 'PostProcess'} <= names
    assert any(r.startswith("busy (union)") for r in rows)
