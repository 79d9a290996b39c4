"""The streamed fills' chunk grid, on the CPU.

K1 and K2 (csrc/fill_resolve.cu, csrc/fill_peel.cu) walk a warp's region
exactly as the plain fills do where an init depth or occluder there is
below -1, or (K1) where a record's depth may be NaN: every record of the
tile in stream order, chunks of `cfg.chunk` positions, empty slots up to
the longest list of the tile's batch of `cfg.tile_batch` tiles.  The
kernels read each tile's list length from `raster_cuda.stream_layout`'s
`tile_len`; this test holds it against the plain walk's list lengths.
The card tests (tests/test_torch_kernel.py) hold the kernels' exact pass
against the plain fills.
"""

import numpy as np
import pytest
import torch

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import peel_cuda as PC
from toyrenderer_tpu_torch.ops import raster as R
from toyrenderer_tpu_torch.ops import raster_cuda as RC


def _inputs(tile_batch, pair_capacity=1 << 16, t=300, seed=11):
    """Random triangles at 500x100 (ragged tiles) left of column 350, so
    the last tile of each row holds none; (setup, bins, cfg, tri_rec)."""
    rng = np.random.default_rng(seed)
    tris = np.zeros((t, 3, 4), np.float32)
    size = np.where(rng.uniform(size=(t, 1, 1)) < 0.02, 0.8, 0.06)
    tris[..., :2] = (rng.uniform(-1.0, 1.0, size=(t, 1, 2))
                     + rng.uniform(-1.0, 1.0, size=(t, 3, 2)) * size)
    tris[..., 0] = np.minimum(tris[..., 0], 0.4)
    tris[..., 2] = rng.uniform(0.1, 0.9, size=(t, 3))
    tris[..., 3] = 1.0
    geo = dict(clip=tris, vtx_ids=np.zeros((t, 3), np.int32),
               inst_id=np.zeros(t, np.int32), mat_id=np.zeros(t, np.int32),
               double_sided=np.ones(t, bool), tri_valid=np.ones(t, bool),
               pair_meshlet=np.zeros(1, np.int32),
               pair_inst=np.zeros(1, np.int32))
    geo = {k: torch.from_numpy(v) for k, v in geo.items()}
    cfg = R.RasterConfig(width=500, height=100, max_tris_per_tile=512,
                         max_big_tris=256, pair_capacity=pair_capacity,
                         compact_frac=1.0, short_frac=1.0, rest_frac=1.0,
                         tile_batch=tile_batch)
    setup = R.setup_triangles(geo, cfg)
    bins = R.bin_pairs_stream(setup, cfg)
    return setup, bins, cfg, RC.pack_tri_records(setup)


def _list_lengths(inp):
    """Per tile: the length of its list in the plain fills' walk (its
    own pairs and the big triangles whose bbox holds it)."""
    table, big_table = RC.walk_tables(inp.bins, inp.lay, inp.cfg)
    return [int((table[tile] >= 0).sum() + (big_table[tile] >= 0).sum())
            for tile in range(inp.cfg.num_tiles)]


@pytest.mark.parametrize("pair_capacity", [1 << 16, 64])
def test_tile_len_is_the_plain_walk_length(pair_capacity):
    setup, bins, cfg, rec = _inputs(32, pair_capacity, t=3000)
    inp = PC.peel_inputs(setup, bins, cfg, 1)
    assert inp.lay['tile_len'].tolist() == _list_lengths(inp)
    visited = inp.lay['n_chunks'] > 0
    assert not bool(inp.lay['tile_len'][~visited].any())
    if pair_capacity == 64:
        assert not bool(visited.all())
