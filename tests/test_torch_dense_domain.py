"""The port's dense fill (`raster.fill_visibility`, the plain version of
the dense-table kernel K7) against the reference package's XLA fill off
the frames' domain, on the CPU.

The reference's XLA fill walks each tile's table row from slot 0 in
chunks of min(chunk, K) slots, then the whole big list in chunks of
min(chunk, B); an empty slot scores -1 and emits id -1, a chunk whose
maximum is NaN loses at that pixel.  On a frame's inputs (init depth at
least -1, no NaN) none of that shows; here it does: init depths below
-1, where a missed centre or an empty slot wins with id -1; NaN depths;
tiles whose own list is empty.  Both packages get the reference's setup
and table (handed over as numpy).  Tolerances: ids exact; depth within
rtol 1e-6, atol 1e-7 (tests/test_torch_fill.py's bound: XLA may fuse a
multiply-add the port rounds twice), NaN where the reference has NaN.
The port's result is the same at every `tile_batch`, bit for bit.  The
card tests (tests/test_torch_kernel.py) hold the kernel against this
plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import raster as JR

from test_torch_fill import CFG, cornell  # noqa: F401
from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.ops import raster as TR

EMIT_BASE = 1000
INIT_ID = 5
CASES = ["benign", "floor", "nan", "empty_rows", "invalid", "all"]


def _case(cornell, case):
    """(setup, table, big, init_z, init_id) for one case: the Cornell
    setup and its dense table; `floor` starts the left half of the view
    at depth -2 and the top rows of the right half at -1; `nan` puts a
    NaN in the first vertex's z of every 7th triangle (its depth is NaN
    wherever it covers a centre); `empty_rows` empties the own list of
    every third tile and starts the view at -2 there; `invalid` puts a
    triangle the setup does not keep (a back face, or off the view) in
    the first slot of every list and the first slots of the big list (it
    scores -1, and its id wins where the chunk's other slots score -1
    too); `all` does the four at once."""
    cfg = cornell['cfg']
    h, w = cfg.height, cfg.width
    setup = dict(cornell['setup'])
    if case in ("nan", "all"):
        setup['zs'] = setup['zs'].at[::7, 0].set(jnp.nan)
    table, _, big, _ = JR.bin_triangles(setup, cfg)
    table = np.array(table)
    init_z = np.zeros((h, w), np.float32)
    if case in ("floor", "all"):
        init_z[:, :w // 2] = -2.0
        init_z[:64, w // 2:] = -1.0
    big = np.array(big)
    if case in ("invalid", "all"):
        dropped = np.flatnonzero(~np.asarray(setup['valid']))[::8]
        listed = np.flatnonzero(table[:, 0] >= 0)
        table[listed, 0] = dropped[np.arange(listed.size) % dropped.size]
        big = np.concatenate([dropped, big])[:big.size].astype(np.int32)
    if case in ("empty_rows", "all"):
        emptied = np.arange(0, cfg.num_tiles, 3)
        assert (table[emptied] >= 0).any()
        table[emptied] = -1
        for tile in emptied:
            ty, tx = divmod(int(tile), cfg.tiles_x)
            init_z[ty * cfg.tile_h:(ty + 1) * cfg.tile_h,
                   tx * cfg.tile_w:(tx + 1) * cfg.tile_w] = -2.0
    assert ((table >= 0).sum(1) == 0).any()
    init_id = np.full((h, w), INIT_ID, np.int32)
    return setup, table, big, init_z, init_id


def _port(setup, table, big, init_z, init_id, tile_batch=32):
    cfg = TR.RasterConfig(**CFG, tile_batch=tile_batch)
    tsetup = {k: torch.from_numpy(np.array(v)) for k, v in setup.items()}
    z, tid = TR.fill_visibility(
        tsetup, torch.from_numpy(table), torch.from_numpy(big), cfg,
        init_depth=torch.from_numpy(init_z),
        init_tri_id=torch.from_numpy(init_id), emit_base=EMIT_BASE)
    return z.numpy(), tid.numpy()


@pytest.mark.parametrize("case", CASES)
def test_dense_fill_matches_xla_fill_off_domain(cornell, case):
    setup, table, big, init_z, init_id = _case(cornell, case)
    z_j, id_j = JR.fill_visibility(
        setup, jnp.asarray(table), jnp.asarray(big), cornell['cfg'],
        init_depth=jnp.asarray(init_z), init_tri_id=jnp.asarray(init_id),
        emit_base=EMIT_BASE)
    z_j, id_j = np.asarray(z_j), np.asarray(id_j)
    z_t, id_t = _port(setup, table, big, init_z, init_id)
    np.testing.assert_array_equal(id_t, id_j)
    np.testing.assert_allclose(z_t, z_j, rtol=1e-6, atol=1e-7)
    assert (id_j >= EMIT_BASE).mean() > 0.3     # the fill won pixels
    if case in ("floor", "empty_rows", "all"):
        # an empty slot or a missed centre won below -1
        assert (id_j[init_z < -1] == -1).any()
    if case in ("nan", "all"):
        # a chunk with a NaN depth lost pixels a NaN-free chunk would win
        setup, table = cornell['setup'], np.array(JR.bin_triangles(
            cornell['setup'], cornell['cfg'])[0])
        _, id_clean = _port(setup, table, big, init_z, init_id)
        assert (id_clean != id_t).any()


@pytest.mark.parametrize("case", CASES)
def test_dense_fill_does_not_depend_on_tile_batch(cornell, case):
    args = _case(cornell, case)
    z32, id32 = _port(*args, tile_batch=32)
    for tile_batch in (1, 4):
        z, tid = _port(*args, tile_batch=tile_batch)
        np.testing.assert_array_equal(tid, id32)
        np.testing.assert_array_equal(z, z32)
