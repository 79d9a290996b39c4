"""The per-frame morton tree (`bvh.morton3d`, `bvh.build_bvh`) against the
reference package's, on random points and on the courtyard's triangles.

Both packages get the same world-space triangles (the reference's
`world_triangles` of the courtyard's opaque pairs, as numpy).  The codes
are integers and compared exactly; the sort is stable in both, so the
payloads (the triangle order) are equal.  The boxes and leaf rows are
float32 sums and differences of the same vertices, held to rtol 1e-6
(the centroid's 1/3 product and the edge vectors round alike; XLA may
fuse where PyTorch rounds twice).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import bvh as JB
from toyrenderer_tpu.ops.geometry import (
    instance_transforms, node_world_matrices, static_meshlet_pairs)
from toyrenderer_tpu.scene import load_scene

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import bvh as TB


def test_morton_codes_match_reference():
    rng = np.random.default_rng(3)
    p = rng.uniform(-0.1, 1.1, size=(4096, 3)).astype(np.float32)
    p[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1023 / 1024] * 3,
             [0.999, 0, 1], [2, -1, 0.3], [0, 1, 0], [0.25, 0.75, 0.125]]
    want = np.asarray(JB.morton3d(jnp.asarray(p))).astype(np.int64)
    got = TB.morton3d(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < 2 ** 30 and len(np.unique(got)) > 3000


@pytest.fixture(scope="module")
def courtyard_tris():
    sh = load_scene("resources/courtyard.glb", use_cache=False)
    js = sh.to_device()
    pi, pm = static_meshlet_pairs(sh, 'not_mask')
    world = node_world_matrices(
        js, jnp.asarray(sh.node_translation), jnp.asarray(sh.node_rotation),
        jnp.asarray(sh.node_scale))
    iw, _ = instance_transforms(js, world)
    v0, v1, v2, valid = JB.world_triangles(js, iw, jnp.asarray(pi),
                                           jnp.asarray(pm))
    return tuple(np.asarray(x) for x in (v0, v1, v2, valid))


@pytest.mark.parametrize("n", [None, 20_000])
def test_build_bvh_matches_reference(courtyard_tris, n):
    """The whole opaque courtyard (523,584 triangle slots, padding
    included), and its first 20,000 slots (a tree with a part-filled
    last level)."""
    tris = tuple(x[:n] for x in courtyard_tris)
    want = JB.build_bvh(*(jnp.asarray(x) for x in tris))
    got = TB.build_bvh(*(torch.from_numpy(np.array(x)) for x in tris))
    assert got.num_levels == want.num_levels
    assert got.level_offset == want.level_offset
    w_leaf = np.asarray(want.leaf_rows)
    g_leaf = got.leaf_rows.numpy()
    assert g_leaf.shape == w_leaf.shape
    pay = slice(9 * TB.LEAF_TRIS, None)              # the payload lanes
    np.testing.assert_array_equal(g_leaf[:, pay], w_leaf[:, pay])
    assert (g_leaf[:, pay] >= 0).sum() == tris[3].sum()
    np.testing.assert_allclose(g_leaf, w_leaf, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.child_boxes.numpy(),
                               np.asarray(want.child_boxes), rtol=1e-6,
                               atol=1e-6)
