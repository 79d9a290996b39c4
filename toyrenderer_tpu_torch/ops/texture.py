"""Material texture sampling from the flat quad-map atlas.

Counterpart of toyrenderer_tpu/ops/texture.py (reference:
lightingcommon.hlsli:358-406 bindless material sampling, sampler-feedback
write and MinMip residency clamp): bilinear taps gathered from the flat
atlas, mip selection from analytic UV derivatives.  Mip descriptors are
either ANALYTIC (derived from the base size and the ATLAS_ALIGN-aligned
chain base the records carry; `base_rows` given) or one gathered
descriptor row per tap (`tex_desc`: residency redirection baked in by
the streaming managers, engine/streaming.py).  With a tile table
(`tex_tile_table`) the mip's texels live in 64x64-texel pool tiles
(`_texel_index`), and the samplers report the tile each pixel read
(`tile_id`) for the per-tile feedback (`vt_tile_feedback`).
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops.packing import unpack_rgba8
from toyrenderer_tpu_torch.scene.textures import (
    ATLAS_ALIGN, MAX_MIPS, WRAP_REPEAT)

VT_TILE = 64                       # texels per tile side
VT_TILE_ROWS = VT_TILE * VT_TILE   # rows of one pool tile

_NEUTRAL = ((1.0, 1.0, 1.0, 1.0), (0.5, 0.5, 1.0, 1.0),
            (1.0, 1.0, 1.0, 1.0), (1.0, 1.0, 1.0, 1.0))
_MAPS = ('base', 'normal', 'mr', 'emissive')


def analytic_desc(w0, h0, mip):
    """Gather-free mip descriptor: (off_rel, mw, mh, mip_clamped).  Mips
    are stored contiguously with floor-halving dims, so mip m starts
    sum_{j<m} max(w0>>j,1)*max(h0>>j,1) rows past the chain base."""
    w0i = torch.clamp(w0.to(torch.int32), min=1)
    h0i = torch.clamp(h0.to(torch.int32), min=1)
    nm = torch.floor(torch.log2(torch.maximum(w0i, h0i).to(torch.float32))
                     ).to(torch.int32) + 1
    mip = torch.minimum(mip, torch.clamp(nm - 1, max=MAX_MIPS - 1))
    off = torch.zeros_like(mip)
    for j in range(MAX_MIPS - 1):
        off = off + torch.where(
            mip > j, torch.clamp(w0i >> j, min=1) * torch.clamp(h0i >> j,
                                                                min=1), 0)
    mw = torch.clamp(w0i >> mip, min=1)
    mh = torch.clamp(h0i >> mip, min=1)
    return off, mw, mh, mip


def mip_from_derivatives(duv_dx, duv_dy, width, height):
    """Standard isotropic LOD: log2 of the max screen footprint in texels."""
    fx = (torch.square(duv_dx[..., 0] * width)
          + torch.square(duv_dx[..., 1] * height))
    fy = (torch.square(duv_dy[..., 0] * width)
          + torch.square(duv_dy[..., 1] * height))
    rho2 = torch.clamp(torch.maximum(fx, fy), min=1e-12)
    return 0.5 * torch.log2(rho2)


def _texel_index(atlas: dict, row, x, y, mw):
    """Texel-row index of (x, y) in the mip that descriptor `row`
    (..., 4) [offset, w, h, tile base] describes; returns (index, tile
    id), the tile id None without a tile table.

    Contiguous mips address offset + y*mw + x.  With a tile table
    ('tex_tile_table', engine/streaming.TileStreamingManager) a desc row
    whose slot 3 holds a tile base >= 0 stores its mip as scattered
    64x64-texel pool tiles: the table maps (tile base + tile-grid index)
    -> packed (delta << 24 | pool slot), delta > 0 redirecting to the
    co-located tile of a 2^delta coarser mip (per-region residency
    fallback).  Tile id is -1 off the tiled path."""
    base = row[..., 0]
    flat = base + y * mw + x
    if 'tex_tile_table' not in atlas:
        return flat, None
    table = atlas['tex_tile_table']
    tb = row[..., 3]
    wt = torch.div(mw + VT_TILE - 1, VT_TILE, rounding_mode='floor')
    tid = (tb + torch.div(y, VT_TILE, rounding_mode='floor') * wt
           + torch.div(x, VT_TILE, rounding_mode='floor'))
    ent = table[torch.clamp(tid, 0, table.shape[0] - 1).long()]
    delta = ent >> 24
    slot = ent & 0xFFFFFF
    xs = x >> delta
    ys = y >> delta
    idx_vt = (slot * VT_TILE_ROWS + torch.remainder(ys, VT_TILE) * VT_TILE
              + torch.remainder(xs, VT_TILE))
    vt = tb >= 0
    return torch.where(vt, idx_vt, flat), torch.where(vt, tid, -1)


def _texel_rows(atlas: dict, desc, wrap, u, v):
    """Atlas rows (..., 16) of the 2x2 footprint at texel coords (u, v),
    the footprint's integer origin (x0, y0) as floats, and the tile id
    (None off the tiled path).  desc: (off, mw, mh) of the analytic path
    or a gathered descriptor row (..., 4)."""
    if isinstance(desc, tuple):
        off, mw, mh = desc
    else:
        mw, mh = desc[..., 1], desc[..., 2]
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)
    rep_x = torch.remainder(x0i, torch.clamp(mw, min=1))
    rep_y = torch.remainder(y0i, torch.clamp(mh, min=1))
    x = torch.where(wrap == WRAP_REPEAT, rep_x,
                    torch.minimum(torch.clamp(x0i, min=0), mw - 1))
    y = torch.where(wrap == WRAP_REPEAT, rep_y,
                    torch.minimum(torch.clamp(y0i, min=0), mh - 1))
    if isinstance(desc, tuple):
        idx, tile_id = off + y * mw + x, None
    else:
        idx, tile_id = _texel_index(atlas, desc, x, y, mw)
    texels = atlas['tex_texels']
    idx = torch.clamp(idx, 0, texels.shape[0] - 1)
    return texels[idx.long()], x0, y0, tile_id


def _bilinear(quad, fx, fy):
    """quad (..., 16) = 4 texels x RGBA; fx / fy (..., 1)."""
    return ((quad[..., 0:4] * (1 - fx) + quad[..., 4:8] * fx) * (1 - fy)
            + (quad[..., 8:12] * (1 - fx) + quad[..., 12:16] * fx) * fy)


def sample_material_maps(atlas: dict, ent_id, uv, duv_dx=None, duv_dy=None,
                         wrap=None, base_wh=None, base_rows=None,
                         aniso: int = 1):
    """Per-pixel bilinear sampling of all four material maps with one
    atlas row gather per tap.  aniso > 1 spreads `aniso` taps along the
    major UV-gradient axis, the mip chosen from the major footprint
    divided by the tap count (the D3D anisotropic LOD rule).

    ent_id (...,) i32 atlas entries (< 0 -> neutral maps), uv (..., 2),
    duv_dx / duv_dy the analytic derivatives (None: mip 0).  wrap /
    base_wh: per-pixel wrap modes and base sizes (None: gathered from
    tex_wrap and the entry's mip-0 descriptor row).  base_rows: the
    chain bases of the analytic descriptor path; None gathers one
    descriptor row per pixel from tex_desc.  Returns dict(base, normal,
    mr, emissive (..., 4), desired (...,)) and, with a tile table,
    tile_id (...,) (the first tap's tile, -1 off the tiled path)."""
    tid = torch.clamp(ent_id, min=0).long()
    if base_wh is None:
        d0 = atlas['tex_desc'][tid * MAX_MIPS]
        w0 = d0[..., 1].to(torch.float32)
        h0 = d0[..., 2].to(torch.float32)
    else:
        w0, h0 = base_wh
    if wrap is None:
        wrap = atlas['tex_wrap'][tid]
    d_major = None
    if duv_dx is not None and aniso > 1:
        fx2 = (torch.square(duv_dx[..., 0] * w0)
               + torch.square(duv_dx[..., 1] * h0))
        fy2 = (torch.square(duv_dy[..., 0] * w0)
               + torch.square(duv_dy[..., 1] * h0))
        p_max = torch.sqrt(torch.clamp(torch.maximum(fx2, fy2), min=1e-12))
        p_min = torch.sqrt(torch.clamp(torch.minimum(fx2, fy2), min=1e-12))
        desired = torch.log2(torch.maximum(p_max / aniso, p_min))
        d_major = torch.where((fx2 >= fy2)[..., None], duv_dx, duv_dy)
    elif duv_dx is not None:
        desired = mip_from_derivatives(duv_dx, duv_dy, w0, h0)
    else:
        desired = torch.zeros(uv.shape[:-1], dtype=torch.float32,
                              device=uv.device)
    mip = torch.clamp(torch.round(desired), 0.0,
                      MAX_MIPS - 1.0).to(torch.int32)
    if base_rows is not None:
        off_rel, mw, mh, mip = analytic_desc(w0, h0, mip)
        desc = (base_rows + off_rel, mw, mh)
    else:
        desc = atlas['tex_desc'][tid * MAX_MIPS + mip.long()]   # (..., 4)
        mw, mh = desc[..., 1], desc[..., 2]
    tile_id = []

    def tap(uv_t):
        u = uv_t[..., 0] * mw.to(torch.float32) - 0.5
        v = uv_t[..., 1] * mh.to(torch.float32) - 0.5
        rows, x0, y0, tid_t = _texel_rows(atlas, desc, wrap, u, v)
        tile_id.append(tid_t)
        fx = (u - x0)[..., None]
        fy = (v - y0)[..., None]
        return [_bilinear(unpack_rgba8(rows[..., mi * 4:(mi + 1) * 4]
                                       ).flatten(-2), fx, fy)
                for mi in range(4)]

    if d_major is None:
        acc = tap(uv)
    else:
        acc = None
        for i in range(aniso):
            t = (i + 0.5) / aniso - 0.5
            m = tap(uv + d_major * t)
            acc = m if acc is None else [a + b for a, b in zip(acc, m)]
        acc = [a * (1.0 / aniso) for a in acc]
    valid = (ent_id >= 0)[..., None]
    out = {name: torch.where(valid, acc[mi], acc[mi].new_tensor(_NEUTRAL[mi]))
           for mi, name in enumerate(_MAPS)}
    out['desired'] = desired
    if tile_id[0] is not None:
        out['tile_id'] = torch.where(ent_id >= 0, tile_id[0], -1)
    return out


def _minpool2(x):
    """2x2 stride-2 min pool of a 2D plane."""
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).amin(dim=(1, 3))


def _avgpool2(x):
    """2x2 stride-2 average over the last two axes (H, W even)."""
    h, w = x.shape[-2:]
    q = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
    return (((q[..., 0, :, 0] + q[..., 0, :, 1]) + q[..., 1, :, 0])
            + q[..., 1, :, 1]) * 0.25


def _maxpool2(x):
    h, w = x.shape
    return x.reshape(h // 2, 2, w // 2, 2).amax(dim=(1, 3))


def _quad_expand(x):
    """(Hq, Wq, ...) -> (2Hq, 2Wq, ...) nearest expansion."""
    return x.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def sample_material_maps_quad(atlas: dict, ent_id, uv, duv_dx, duv_dy,
                              wrap, base_wh, base_rows=None):
    """Quad-shared material sampling: ONE atlas row gather per 2x2 pixel
    quad at mip+1 (its 2x2 texel row covers all four pixels); each pixel
    then applies its OWN bilinear weights inside that footprint.  The
    quad representative is the per-field 2x2 min.  Inputs are full
    resolution (H, W[, n]) with H, W even; base_rows None gathers the
    quad's descriptor row from tex_desc.  Returns the dict of
    sample_material_maps at full resolution ('desired' is the biased
    mip the quad sampled, expanded).
    """
    f32 = torch.float32
    big = 1 << 20
    u0_q = _minpool2(uv[..., 0])
    v0_q = _minpool2(uv[..., 1])
    des_px = mip_from_derivatives(duv_dx, duv_dy, base_wh[0], base_wh[1])
    des_q = _maxpool2(des_px) + 1.0
    mip = torch.clamp(torch.round(des_q), 0.0, MAX_MIPS - 1.0
                      ).to(torch.int32)

    if base_rows is not None:
        # pool base+tex as ONE key (base is a multiple of ATLAS_ALIGN >
        # tex, so the min picks one pixel's pair and it decodes back
        # exactly), then take that pixel's w0/h0/wrap through a
        # match-masked pool
        big2 = 1 << 30
        v_px = torch.where(ent_id >= 0,
                           base_rows + torch.clamp(ent_id, min=0), big2)
        v_q = _minpool2(v_px)
        sel = v_px == _quad_expand(v_q)
        w0_q = _minpool2(torch.where(sel, base_wh[0], float('inf')))
        h0_q = _minpool2(torch.where(sel, base_wh[1], float('inf')))
        wrap_q = _minpool2(torch.where(sel, wrap, big))
        safe_v = torch.where(v_q < big2, v_q, 0)
        base_q = (torch.div(safe_v, ATLAS_ALIGN, rounding_mode='floor')
                  * ATLAS_ALIGN)
        w0_q = torch.where(torch.isfinite(w0_q), w0_q, 1.0)
        h0_q = torch.where(torch.isfinite(h0_q), h0_q, 1.0)
        off_rel, mw, mh, mip = analytic_desc(w0_q, h0_q, mip)
        desc = (base_q + off_rel, mw, mh)
    else:
        tid_q = torch.clamp(torch.clamp(
            _minpool2(torch.where(ent_id >= 0, ent_id, big)),
            max=atlas['tex_wrap'].shape[0] - 1), min=0)
        wrap_q = _minpool2(wrap)
        desc = atlas['tex_desc'][(tid_q * MAX_MIPS + mip).long()]
        mw, mh = desc[..., 1], desc[..., 2]

    u_q = u0_q * mw.to(f32) - 0.5
    v_q = v0_q * mh.to(f32) - 0.5
    rows_q, x0, y0, tile_q = _texel_rows(atlas, desc, wrap_q, u_q, v_q)
    meta = _quad_expand(torch.stack([x0, y0, mw.to(f32), mh.to(f32),
                                     u_q, v_q], dim=-1))      # (H, W, 6)
    # unpack at QUAD rate, then expand the f32 texel planes
    quads = [_quad_expand(unpack_rgba8(rows_q[..., mi * 4:(mi + 1) * 4]
                                       ).flatten(-2))
             for mi in range(4)]                               # (H, W, 16)

    # full-res per-pixel weights INSIDE the quad's 2x2 footprint
    u_p = uv[..., 0] * meta[..., 2] - 0.5
    v_p = uv[..., 1] * meta[..., 3] - 0.5
    fx = torch.clamp(u_p - meta[..., 0], 0.0, 1.0)[..., None]
    fy = torch.clamp(v_p - meta[..., 1], 0.0, 1.0)[..., None]
    # REPEAT wrap discontinuity inside a quad: offsets land far outside
    # [0, 1]; snap those pixels to the representative's own weights
    ok_u = torch.abs(u_p - meta[..., 4]) < 2.0
    ok_v = torch.abs(v_p - meta[..., 5]) < 2.0
    fq_x = torch.clamp(meta[..., 4] - meta[..., 0], 0.0, 1.0)[..., None]
    fq_y = torch.clamp(meta[..., 5] - meta[..., 1], 0.0, 1.0)[..., None]
    fx = torch.where(ok_u[..., None], fx, fq_x)
    fy = torch.where(ok_v[..., None], fy, fq_y)
    valid = (ent_id >= 0)[..., None]
    out = {}
    for mi, name in enumerate(_MAPS):
        c = _bilinear(quads[mi], fx, fy)
        out[name] = torch.where(valid, c, c.new_tensor(_NEUTRAL[mi]))
    out['desired'] = _quad_expand(des_q)
    if tile_q is not None:
        out['tile_id'] = torch.where(valid[..., 0], _quad_expand(tile_q), -1)
    return out


def srgb_to_linear(c):
    """Polynomial sRGB -> linear approximation (max err ~1e-3), applied to
    base/emissive samples (the reference uses hardware sRGB views)."""
    return c * (c * (c * 0.305306011 + 0.682171111) + 0.012522878)


def sample_texture(atlas: dict, tex_id, uv, duv_dx=None, duv_dy=None,
                   feedback: bool = False, wrap=None, base_wh=None):
    """Base-colour-only sample (..., 4) through the descriptor rows
    (with `feedback`, also the desired mip); a thin wrapper over
    sample_material_maps."""
    maps = sample_material_maps(atlas, tex_id, uv, duv_dx, duv_dy,
                                wrap=wrap, base_wh=base_wh)
    if feedback:
        return maps['base'], maps['desired']
    return maps['base']


_MIN_ROWS = 256      # rows of partial minima in _segment_min


def _segment_min(ids, values, n: int):
    """(n,) f32 minimum of `values` per id in [0, n); +inf where no
    value has that id (ids outside [0, n) are ignored).

    Value i scatters its minimum into row i % _MIN_ROWS of a table of
    partial minima, which then reduces over its rows: neighbouring
    pixels, which mostly share an id, land on different addresses (one
    row of a few ids for millions of pixels serialises on each id's
    atomic).  The minimum is exact either way."""
    ids = ids.reshape(-1)
    rows = torch.arange(ids.shape[0], device=ids.device) % _MIN_ROWS
    flat = torch.where((ids >= 0) & (ids < n), ids, n).long() + rows * (n + 1)
    out = torch.full((_MIN_ROWS * (n + 1),), float('inf'),
                     dtype=torch.float32, device=values.device)
    out.scatter_reduce_(0, flat, values.reshape(-1).to(torch.float32),
                        'amin')
    return out.view(_MIN_ROWS, n + 1)[:, :n].amin(0)


def vt_tile_feedback(tile_id, desired_mip, num_tiles: int):
    """Per-TILE min desired mip -- sampler feedback at 64x64-texel tile
    granularity (TextureFeedbackManager.cpp resolve parity).  tile_id
    (H, W) i32 from the sampler (-1 = no tile sampled); returns
    (num_tiles,) f32 with +inf for untouched tiles."""
    return _segment_min(tile_id, desired_mip, num_tiles)


def texture_feedback(tex_id, desired_mip, num_textures: int):
    """Per-texture minimum of the per-pixel desired mips -- the sampler-
    feedback readback TextureStreamingManager consumes on the host.
    Returns (num_textures,) f32; +inf where unused.  One scatter-min for
    any texture count (the reference package takes masked reductions up
    to 64 textures and a segment min above; both give this result)."""
    return _segment_min(tex_id, desired_mip, num_textures)
