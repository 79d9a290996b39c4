"""The port's last tools and the codecs they write with, against the
reference package's.

* tools/gen_scene.py: the port's `build(scale=1.0, seed=7)` written
  into tmp_path, loaded by the port's `load_scene` beside the committed
  resources/courtyard.glb (the reference generator's output), and its
  CLI's --no-compress beside the reference generator's --no-compress
  file: every scene array equal -- the
  vertices, meshlets, LODs, instances, nodes, materials and the texture
  atlas's texels.  Its PNG bytes are its own (no Pillow), the texels
  the same.  Every meshopt-compressed view equals the committed file's
  bytes, and the reference encoder's on the same decoded data.
* The meshopt encoders (scene/meshopt.py) byte-equal to the reference's
  on random buffers; the PNG writer (scene/png.encode_png) read back
  bit-equal by the port's decoder and by Pillow at 1-4 channels; the
  JPEG encoder (scene/jpeg_encode.py) read back equal by the port's
  decoder and Pillow, its PSNR against the source at most 0.5 dB below
  Pillow's own quality-88 encode (a seeded synthetic frame and the
  Cornell golden).
* tools/shell.py on Cornell (--device cpu --port 0 --max-frames 2) in a
  thread: GET /, /frame.jpg, /stats.json, POST debug and toggle; the
  toggle shows in /stats.json, the JPEG decodes to within 28 dB PSNR of
  the frame it encodes.
* tools/fillbench.py and tools/rtbench.py --scene stress on the CPU at a
  tiny size print their lines; rtbench's stress rows hit what the
  reference's traversal hits on the same rays (its XLA lockstep walk on
  the reference's stress-scene tree, a step budget no ray reaches).
"""

import dataclasses
import io
import json
import re
import struct
import threading
import urllib.request

import numpy as np
import pytest

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.scene import meshopt as TM
from toyrenderer_tpu_torch.scene.jpeg import decode_jpeg
from toyrenderer_tpu_torch.scene.jpeg_encode import encode_jpeg
from toyrenderer_tpu_torch.scene.png import decode_png, encode_png
from toyrenderer_tpu_torch.tools import gen_scene

COURTYARD = "resources/courtyard.glb"


def _glb(path):
    """(json, bin chunk) of a GLB file."""
    raw = open(path, "rb").read()
    jlen = struct.unpack("<I", raw[12:16])[0]
    js = json.loads(raw[20:20 + jlen])
    blen = struct.unpack("<I", raw[20 + jlen:24 + jlen])[0]
    return js, raw[28 + jlen:28 + jlen + blen]


def _meshopt_views(path):
    js, binary = _glb(path)
    out = []
    for v in js["bufferViews"]:
        ext = v.get("extensions", {}).get("EXT_meshopt_compression")
        if ext:
            off = ext["byteOffset"]
            out.append((ext, binary[off:off + ext["byteLength"]]))
    return out


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("gen")
    info = gen_scene.build(str(d / "c.glb"), compress=True, scale=1.0,
                           seed=7)
    return dict(dir=d, info=info, compressed=d / "c.glb")


@pytest.fixture(scope="module")
def committed():
    return load_scene(COURTYARD, use_cache=False)


def _assert_scenes_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(b, (int, float, str)):
            assert a == b, f.name


def test_gen_scene_loads_as_the_committed_courtyard(built, committed):
    got = load_scene(built['compressed'], use_cache=False)
    _assert_scenes_equal(got, committed)
    assert got.tex_texels.size > 0
    js, _ = _glb(built['compressed'])
    js_w, _ = _glb(COURTYARD)
    for k in ('accessors', 'meshes', 'materials', 'nodes', 'textures',
              'cameras', 'extensions', 'extensionsRequired'):
        assert js[k] == js_w[k], k
    assert built['info']['textures'] == len(js_w['textures'])


def test_gen_scene_cli_no_compress(built, capsys):
    """--no-compress against the reference generator's --no-compress
    output (the committed file is compressed, and the index codec
    rotates each triangle's corners, which moves the LODs' simplified
    meshlets: an uncompressed file loads as the other uncompressed one)."""
    from toyrenderer_tpu.tools.gen_scene import build as jax_build
    out = built['dir'] / "raw.glb"
    assert gen_scene.main(["--out", str(out), "--no-compress"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["bytes"] == out.stat().st_size
    js, _ = _glb(out)
    assert "EXT_meshopt_compression" not in js.get("extensionsUsed", [])
    ref = built['dir'] / "reference_raw.glb"
    jax_build(str(ref), compress=False, scale=1.0, seed=7)
    _assert_scenes_equal(load_scene(out, use_cache=False),
                         load_scene(ref, use_cache=False))


def test_gen_scene_meshopt_views_match_reference(built):
    """Every compressed view is the committed file's, byte for byte, and
    the reference encoder's on the same decoded data."""
    from toyrenderer_tpu.scene import meshopt as JM
    got = _meshopt_views(built['compressed'])
    want = _meshopt_views(COURTYARD)
    assert len(got) == len(want) == 2 * 18
    for (ext, data), (ext_w, data_w) in zip(got, want):
        # the views' places in the binary chunk differ: the PNGs before
        # them are other bytes
        assert ({k: v for k, v in ext.items() if k != 'byteOffset'}
                == {k: v for k, v in ext_w.items() if k != 'byteOffset'})
        assert data == data_w
        if ext["mode"] == "ATTRIBUTES":
            raw = TM.decode_vertex_buffer(data, ext["count"],
                                          ext["byteStride"])
            assert JM.encode_vertex_buffer(raw) == data
        else:
            raw = TM.decode_index_buffer(data, ext["count"])
            assert JM.encode_index_buffer(raw) == data


def test_meshopt_encoders_match_reference():
    from toyrenderer_tpu.scene import meshopt as JM
    rng = np.random.default_rng(3)
    verts = rng.integers(0, 256, (517, 32), dtype=np.uint8)
    verts[:, :12] = np.cumsum(rng.integers(0, 3, (517, 12)), 0) % 256
    tris = rng.integers(0, 517, 3 * 400).astype(np.uint32)
    seq = np.cumsum(rng.integers(0, 40, 333)).astype(np.uint32)
    pairs = ((TM.encode_vertex_buffer, JM.encode_vertex_buffer, verts),
             (TM.encode_index_buffer, JM.encode_index_buffer, tris),
             (TM.encode_index_sequence, JM.encode_index_sequence, seq))
    for mine, ref, data in pairs:
        assert mine(data) == ref(data), mine.__name__
    np.testing.assert_array_equal(
        TM.decode_vertex_buffer(TM.encode_vertex_buffer(verts), 517, 32),
        verts)
    np.testing.assert_array_equal(
        TM.decode_index_buffer(TM.encode_index_buffer(tris), tris.size),
        tris)
    np.testing.assert_array_equal(
        TM.decode_index_sequence(TM.encode_index_sequence(seq), seq.size),
        seq)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_writer_round_trips(channels):
    from PIL import Image
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels), dtype=np.uint8)
    raw = encode_png(img)
    pil = np.asarray(Image.open(io.BytesIO(raw))).reshape(img.shape)
    np.testing.assert_array_equal(pil, img)
    rgba = decode_png(raw)
    if channels >= 3:
        np.testing.assert_array_equal(rgba[..., :3], img[..., :3])
    else:
        np.testing.assert_array_equal(rgba[..., 0], img[..., 0])
    alpha = img[..., -1] if channels in (2, 4) else 255
    np.testing.assert_array_equal(rgba[..., 3], np.broadcast_to(
        alpha, img.shape[:2]))


def _psnr(a, b) -> float:
    err = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / err))


def _frames():
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:270, 0:481]
    synth = np.stack([128 + 100 * np.sin(xx / 37.0) * np.cos(yy / 23.0),
                      128 + 90 * np.sin((xx + yy) / 51.0),
                      xx * 255.0 / 481], -1)
    synth = np.clip(synth + rng.normal(0, 6, synth.shape), 0, 255)
    golden = decode_png(open("tests/goldens/cornell_allon_448x256.png",
                             "rb").read())[..., :3]
    return {"synthetic": synth.astype(np.uint8), "cornell golden": golden}


@pytest.mark.parametrize("name", ["synthetic", "cornell golden"])
def test_jpeg_encoder_against_pillow(name):
    from PIL import Image
    img = _frames()[name]
    raw = encode_jpeg(img, quality=88)
    mine = decode_jpeg(raw)[..., :3]
    pil = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    np.testing.assert_array_equal(mine, pil)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=88)
    ref = np.asarray(Image.open(buf).convert("RGB"))
    assert _psnr(mine, img) >= _psnr(ref, img) - 0.5, (
        _psnr(mine, img), _psnr(ref, img))
    with pytest.raises(ValueError):
        encode_jpeg(img[..., :2])


def test_shell_serves_frames_and_input():
    from toyrenderer_tpu_torch.tools import shell
    seen = {}

    def get(port, path, body=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=body)
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    def ready(port):
        seen['port'] = port
        seen['page'] = get(port, "/")
        for ev in ({"toggle": "ao"}, {"debug": 0}, {"look": [0.01, 0.0]}):
            assert get(port, "/input", json.dumps(ev).encode())[0] == 200

    def frame(n, image):
        p = seen['port']
        seen[n] = (get(p, "/frame.jpg"), json.loads(get(p,
                                                        "/stats.json")[2]),
                   image)

    result = {}
    th = threading.Thread(target=lambda: result.update(rc=shell.main(
        ["--scene", "resources/cornell.gltf", "--device", "cpu", "--port",
         "0", "--max-frames", "2", "--displayresolution", "224x128"],
        on_ready=ready, on_frame=frame)))
    th.start()
    th.join(timeout=300)
    assert not th.is_alive() and result.get('rc') == 0
    status, ctype, page = seen['page']
    assert status == 200 and ctype == "text/html" and b"/frame.jpg" in page
    for n in (1, 2):
        (status, ctype, jpg), stats, image = seen[n]
        assert status == 200 and ctype == "image/jpeg"
        assert image.shape == (128, 224, 3) and image.dtype == np.uint8
        got = decode_jpeg(jpg)[..., :3]
        assert _psnr(got, image) > 28.0, _psnr(got, image)
        assert stats['toggles']['ao'] is True
        assert stats['stats']['resolution'] == "224x128"
        assert stats['stats']['covered px'] > 0


def test_fillbench_prints_its_line(capsys):
    from toyrenderer_tpu_torch.tools import fillbench
    out = fillbench.run(["--device", "cpu", "--scene",
                         "resources/cornell.gltf", "--width", "256",
                         "--height", "128", "--reps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert line == out
    assert out['binned_pairs'] > 0 and not any(out['dropped'].values())
    assert set(out['ms']) == {'setup', 'bin_pairs_stream',
                              'pack_resolve_records', 'fill_resolve_stream'}
    assert 0 < out['coverage'] <= 1


def test_rtbench_stress_rows_match_reference_hits(capsys):
    import jax.numpy as jnp
    from toyrenderer_tpu.ops import bvh as JB
    from toyrenderer_tpu.ops import geometry as JG
    from toyrenderer_tpu.scene.procedural import (
        make_stress_scene as jax_stress)
    from toyrenderer_tpu.scene.scenebuild import _world_matrices_host
    from toyrenderer_tpu_torch.tools import rtbench
    rows = rtbench.run(["--objects", "8", "--rays", "4096", "--reps", "1",
                        "--nosah", "--device", "cpu"])
    printed = re.findall(r"^(\S+)\s+[\d.]+ Mrays/s", capsys.readouterr().out,
                         re.M)
    assert printed == [r['name'] for r in rows]
    jh = jax_stress(n_objects=8, sphere_res=24, textured=False)
    pi, pm = JG.static_meshlet_pairs(jh)
    world = _world_matrices_host(jh.node_parent, jh.node_translation,
                                 jh.node_rotation, jh.node_scale)
    iw = world[np.asarray(jh.inst_node)].astype(np.float32)
    jb = JB.refit_bvh(JB.build_rt_static(jh, pi, pm), jnp.asarray(iw))
    for r in rows:
        if r['name'] not in ('shadow(any-hit)', 'probe(closest)',
                             'probe(gdir)'):
            continue
        o, d = r['o'].numpy(), r['d'].numpy()
        ref = JB.traverse(jb, jnp.asarray(o), jnp.asarray(d),
                          jnp.full(o.shape[0], 1e4, jnp.float32),
                          max_steps=4096, any_hit=r['any_hit'])
        assert int(np.asarray(ref['steps']).max()) < 4096
        hits, ref_hits = int(r['result']['hit'].sum()), int(
            np.asarray(ref['hit']).sum())
        assert abs(hits - ref_hits) <= max(1, int(1e-4 * o.shape[0])), (
            r['name'], hits, ref_hits)
        assert 0 < hits < o.shape[0]
