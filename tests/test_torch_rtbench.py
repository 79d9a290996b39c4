"""The port's ray-traversal benchmark (toyrenderer_tpu_torch/tools/
rtbench.py) against the reference package's (toyrenderer_tpu/tools/
rtbench.py).

* `ray_sets` on the courtyard's bounds and sun at 65,536 rays: the
  shadow, probe and gdir sets equal the reference's element for element
  (numpy arithmetic on both sides; the cone blocking is a permutation).
* `main` on the CPU (the plain versions) at 16,384 rays without the SAH
  tree runs and prints the five complete-tree rows; the binned rows hit
  what the per-ray rows hit, also with each TR_BIN_* knob set.
* `--scene stress` (the default) with no objects raises; its rows run
  in tests/test_torch_tools.py.
"""

import re

import numpy as np
import pytest

from toyrenderer_tpu.tools import rtbench as JR

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.scene import load_scene
from toyrenderer_tpu_torch.tools import rtbench as TR


def test_ray_sets_match_reference():
    host = load_scene(TR.COURTYARD)
    lo, hi = (np.asarray(x) for x in host.world_aabb)
    sun = np.asarray(host.sun_direction)
    want = JR.ray_sets(65536, lo, hi, sun)
    got = TR.ray_sets(65536, lo, hi, sun)
    for w_set, g_set in zip(want, got):
        for w, g in zip(w_set, g_set):
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_array_equal(g, np.asarray(w))


def test_main_prints_the_complete_tree_rows(capsys):
    rc = TR.main(["--scene", "courtyard", "--rays", "16384", "--reps", "1",
                  "--nosah", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    rows = re.findall(r"^(\S+)\s+([\d.]+) Mrays/s\s+hit=([\d.]+) "
                      r"visits/ray=([\d.]+)\s+\(([\d.]+) ms\)$", out, re.M)
    names = [r[0] for r in rows]
    assert names == ["shadow(any-hit)", "probe(closest)", "probe(gdir)",
                     "probe(binned)", "shadow(binned)"], out
    hit = {r[0]: float(r[2]) for r in rows}
    assert hit["probe(binned)"] == hit["probe(closest)"]
    assert hit["shadow(binned)"] == hit["shadow(any-hit)"]
    assert all(float(r[1]) > 0 for r in rows)
    assert 0.01 < hit["probe(closest)"] < 0.99


def test_bin_knobs_reach_traverse_binned(monkeypatch, capsys):
    """TR_BIN_ROUNDS, TR_BIN_PACKET and TR_BIN_ENTRIES set the binned
    rows' traverse_binned arguments; the rows still hit what the
    per-ray rows hit."""
    seen = []
    real = TR.bvh_cuda.traverse_binned

    def spy(*args, **kw):
        seen.append((kw['rounds'], kw['packet'], kw['max_entries']))
        return real(*args, **kw)
    monkeypatch.setattr(TR.bvh_cuda, "traverse_binned", spy)
    monkeypatch.setenv("TR_BIN_ROUNDS", "1")
    monkeypatch.setenv("TR_BIN_PACKET", "512")
    monkeypatch.setenv("TR_BIN_ENTRIES", "32")
    rows = TR.run(["--scene", "courtyard", "--rays", "4096", "--reps", "1",
                   "--nosah", "--device", "cpu"])
    capsys.readouterr()
    assert seen and set(seen) == {(1, 512, 32)}
    by = {r["name"]: r["result"] for r in rows}
    for binned, per_ray in (("probe(binned)", "probe(closest)"),
                            ("shadow(binned)", "shadow(any-hit)")):
        assert bool((by[binned]["hit"] == by[per_ray]["hit"]).all())


def test_stress_scene_raises():
    with pytest.raises(ValueError, match="--objects"):
        TR.main(["--scene", "stress", "--objects", "0", "--device", "cpu"])
