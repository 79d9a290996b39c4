"""glTF animation (scene/animation.py, the glTF loader's channels, the
scene cache's keys) against the reference package.

* `AnimationPlayer` on the cases of the reference's tests/test_animation.py
  (linear translation with its clamps, STEP, the slerp midpoint, looping)
  and on random channels of every path: the port's patched TRS equal to
  the reference's.
* A glTF with LINEAR, STEP and CUBICSPLINE channels (Cornell with an
  animation added): the port's loader reads the same channels as the
  reference's, and both builds pack the same arrays.
* The animated Cornell through the port's scene cache (the reference
  test's round trip: one synthesized rotation channel): the channels
  survive it.
"""

import base64
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from toyrenderer_tpu.scene import animation as JA
from toyrenderer_tpu.scene import gltf as JGL
from toyrenderer_tpu.scene import scenebuild as JSB

from toyrenderer_tpu_torch.scene import animation as TA
from toyrenderer_tpu_torch.scene import gltf as TGL
from toyrenderer_tpu_torch.scene import scenebuild as TSB

CORNELL = Path("resources/cornell.gltf")


def _chans(mod, specs):
    return [mod.GltfAnimationChannel(
        node=n, path=p, times=np.asarray(t, np.float32),
        values=np.asarray(v, np.float32), interpolation=i)
        for n, p, t, v, i in specs]


def _players(specs, loop):
    return (JA.AnimationPlayer(JA.pack_animations(_chans(JGL, specs)),
                               loop=loop),
            TA.AnimationPlayer(TA.pack_animations(_chans(TGL, specs)),
                               loop=loop))


def _rest(n):
    return (np.zeros((n, 3), np.float32),
            np.tile(np.asarray([0, 0, 0, 1], np.float32), (n, 1)),
            np.ones((n, 3), np.float32))


S2 = float(np.sin(np.pi / 4))
CASES = {
    'linear': ([(0, "translation", [0.0, 2.0], [[0, 0, 0], [4, 0, 0]],
                 "LINEAR")], False, [1.0, -1.0, 99.0],
               lambda t, r, s, x: np.allclose(
                   t[0], {1.0: [2, 0, 0], -1.0: [0, 0, 0],
                          99.0: [4, 0, 0]}[x], atol=1e-6)
               and np.allclose(t[1], 0)),
    'step': ([(0, "scale", [0.0, 1.0], [[1, 1, 1], [2, 2, 2]], "STEP")],
             False, [0.6, 1.0],
             lambda t, r, s, x: np.allclose(s[0], {0.6: 1.0, 1.0: 2.0}[x])),
    'slerp': ([(0, "rotation", [0.0, 1.0],
                [[0, 0, 0, 1], [0, 0, S2, np.cos(np.pi / 4)]], "LINEAR")],
              False, [0.5],
              lambda t, r, s, x: np.allclose(
                  r[0], [0, 0, np.sin(np.pi / 8), np.cos(np.pi / 8)],
                  atol=1e-5) and abs(np.linalg.norm(r[0]) - 1) < 1e-6),
    'loop': ([(0, "translation", [0.0, 2.0], [[0, 0, 0], [4, 0, 0]],
               "LINEAR")], True, [0.5, 2.5],
             lambda t, r, s, x: np.allclose(t[0], [1, 0, 0], atol=1e-6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_player_cases_match_reference(case):
    specs, loop, times, check = CASES[case]
    jp, tp = _players(specs, loop)
    for x in times:
        want = jp.evaluate(x, *_rest(2))
        got = tp.evaluate(x, *_rest(2))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert check(*got, x), (case, x)


def test_player_random_channels_match_reference():
    rng = np.random.default_rng(2)
    specs = []
    for c in range(9):
        k = int(rng.integers(1, 6))
        times = np.sort(rng.uniform(0, 3, k)).astype(np.float32)
        path = ("translation", "rotation", "scale")[c % 3]
        vals = rng.normal(size=(k, 4 if path == "rotation" else 3))
        if path == "rotation":
            vals /= np.linalg.norm(vals, axis=-1, keepdims=True)
        specs.append((c % 4, path, times, vals, ("LINEAR", "STEP")[c % 2]))
    for loop in (False, True):
        jp, tp = _players(specs, loop)
        assert tp.data.duration == jp.data.duration
        for x in np.linspace(-0.5, 7.0, 31):
            for a, b in zip(tp.evaluate(float(x), *_rest(4)),
                            jp.evaluate(float(x), *_rest(4))):
                np.testing.assert_array_equal(a, b)
    # no channel: the inputs come back as they are
    empty = TA.AnimationPlayer(TA.pack_animations([]))
    rest = _rest(2)
    assert not empty.enabled and empty.evaluate(1.0, *rest)[0] is rest[0]


def _animated_gltf(dst: Path) -> Path:
    """Cornell with three channels (LINEAR rotation, STEP translation,
    CUBICSPLINE scale) in a data-URI buffer, written beside a copy of
    its .bin."""
    g = json.loads(CORNELL.read_text())
    t = np.asarray([0.0, 1.0, 2.5], np.float32)
    rot = np.asarray([[0, 0, 0, 1], [0, 0.6, 0, 0.8], [0, 1, 0, 0]],
                     np.float32)
    tra = np.asarray([[0, 0, 0], [0.5, 0, 0], [0, 0.25, 0]], np.float32)
    sca = np.repeat(np.asarray([[1, 1, 1], [1.5, 1, 1], [1, 2, 1]],
                               np.float32), 3, axis=0)   # in, value, out
    sca[0::3] = 0.0
    sca[2::3] = 0.0
    blob = b"".join(a.tobytes() for a in (t, rot, tra, sca))
    bi = len(g["buffers"])
    g["buffers"].append({"byteLength": len(blob), "uri":
                         "data:application/octet-stream;base64,"
                         + base64.b64encode(blob).decode()})
    views, offs = g["bufferViews"], [0, 12, 60, 96]
    acc = g["accessors"]
    first = len(acc)
    for off, (n, typ) in zip(offs, [(3, "SCALAR"), (3, "VEC4"),
                                     (3, "VEC3"), (9, "VEC3")]):
        views.append({"buffer": bi, "byteOffset": off,
                      "byteLength": n * {"SCALAR": 4, "VEC3": 12,
                                         "VEC4": 16}[typ]})
        acc.append({"bufferView": len(views) - 1, "componentType": 5126,
                    "count": n, "type": typ})
    ti = first
    g["animations"] = [{"samplers": [
        {"input": ti, "output": ti + 1},
        {"input": ti, "output": ti + 2, "interpolation": "STEP"},
        {"input": ti, "output": ti + 3, "interpolation": "CUBICSPLINE"}],
        "channels": [
            {"sampler": 0, "target": {"node": 0, "path": "rotation"}},
            {"sampler": 1, "target": {"node": 0, "path": "translation"}},
            {"sampler": 2, "target": {"node": 1, "path": "scale"}},
            {"sampler": 0, "target": {"node": 1, "path": "weights"}}]}]
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(CORNELL.with_suffix(".bin"), dst / "cornell.bin")
    out = dst / "cornell_animated.gltf"
    out.write_text(json.dumps(g))
    return out


def test_gltf_animation_channels_match_reference(tmp_path):
    path = _animated_gltf(tmp_path)
    jd, td = JGL.load_gltf(path), TGL.load_gltf(path)
    assert len(td.animations) == len(jd.animations) == 3
    for a, b in zip(td.animations, jd.animations):
        assert (a.node, a.path, a.interpolation) == (b.node, b.path,
                                                     b.interpolation)
        np.testing.assert_array_equal(a.times, b.times)
        np.testing.assert_array_equal(a.values, b.values)
    js = JSB.build_scene(jd)
    ts = TSB.build_scene(td)
    for f in ('anim_node', 'anim_path', 'anim_interp', 'anim_key_offset',
              'anim_times', 'anim_values'):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                      err_msg=f)
    assert ts.anim_duration == js.anim_duration == 2.5
    # the port's cache keeps them
    back = TSB.load_scene_cache(_saved(path, ts))
    np.testing.assert_array_equal(back.anim_values, ts.anim_values)
    assert back.animation_data().num_channels == 3


def _saved(path: Path, scene) -> Path:
    cache = TSB.cache_path(path, 1.0)
    TSB.save_scene_cache(cache, scene)
    return cache


def write_animated_cornell(dst: Path) -> Path:
    """The reference test's animated Cornell (tests/test_animation.py:
    74-95): Cornell with one synthesized rotation channel (node 0, a half
    turn about z over 4 s), saved as the port's scene cache of a copy of
    cornell.gltf in `dst`, so load_scene(copy) reads the channel."""
    dst.mkdir(parents=True, exist_ok=True)
    copy = dst / "cornell_animated.gltf"
    shutil.copy(CORNELL, copy)
    shutil.copy(CORNELL.with_suffix(".bin"), dst / "cornell.bin")
    s = TSB.load_scene(copy, use_cache=False)
    data = TA.pack_animations(_chans(TGL, [(0, "rotation", [0.0, 4.0],
                                            [[0, 0, 0, 1], [0, 0, 1, 0]],
                                            "LINEAR")]))
    s.anim_node, s.anim_path = data.node, data.path
    s.anim_interp, s.anim_key_offset = data.interp, data.key_offset
    s.anim_times, s.anim_values = data.times, data.values
    s.anim_duration = data.duration
    _saved(copy, s)
    return copy


def test_animated_scene_roundtrip(tmp_path):
    copy = write_animated_cornell(tmp_path)
    s2 = TSB.load_scene(copy)
    d2 = s2.animation_data()
    assert d2.num_channels == 1 and d2.duration == 4.0
    np.testing.assert_array_equal(d2.values, [[0, 0, 0, 1], [0, 0, 1, 0]])
    # the reference's round trip of the same channel
    js = JSB.load_scene(str(CORNELL), use_cache=False)
    data = JA.pack_animations(_chans(JGL, [(0, "rotation", [0.0, 4.0],
                                            [[0, 0, 0, 1], [0, 0, 1, 0]],
                                            "LINEAR")]))
    np.testing.assert_array_equal(d2.values, data.values)
    np.testing.assert_array_equal(s2.positions, js.positions)
    # a plain load of Cornell carries no channel
    assert TSB.load_scene(CORNELL, use_cache=False).animation_data() \
        .num_channels == 0
