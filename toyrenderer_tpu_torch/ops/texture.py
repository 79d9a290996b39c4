"""Material texture sampling from the flat quad-map atlas.

Counterpart of toyrenderer_tpu/ops/texture.py (reference:
lightingcommon.hlsli:358-406 bindless material sampling): bilinear taps
gathered from the flat atlas, mip selection from analytic UV
derivatives.  Descriptors are ANALYTIC (derived from the base size and
the ATLAS_ALIGN-aligned chain base the records carry): the port's
scenes always build that atlas.  Sampler feedback and virtual-texture
residency wait for a later slice.
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.ops.packing import unpack_rgba8
from toyrenderer_tpu_torch.scene.textures import (
    ATLAS_ALIGN, MAX_MIPS, WRAP_REPEAT)

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


def _texel_rows(atlas: dict, off, mw, mh, wrap, u, v):
    """Atlas rows (..., 16) of the 2x2 footprint at texel coords (u, v),
    plus the footprint's integer origin (x0, y0) as floats."""
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
    texels = atlas['tex_texels']
    idx = torch.clamp(off + y * mw + x, 0, texels.shape[0] - 1)
    return texels[idx.long()], x0, y0


def _bilinear(quad, fx, fy):
    """quad (..., 16) = 4 texels x RGBA; fx / fy (..., 1)."""
    return ((quad[..., 0:4] * (1 - fx) + quad[..., 4:8] * fx) * (1 - fy)
            + (quad[..., 8:12] * (1 - fx) + quad[..., 12:16] * fx) * fy)


def sample_material_maps(atlas: dict, ent_id, uv, duv_dx, duv_dy, wrap,
                         base_wh, base_rows, aniso: int = 1):
    """Per-pixel bilinear sampling of all four material maps with one
    atlas row gather per tap.  aniso > 1 spreads `aniso` taps along the
    major UV-gradient axis, the mip chosen from the major footprint
    divided by the tap count (the D3D anisotropic LOD rule).

    ent_id (...,) i32 atlas entries (< 0 -> neutral maps); returns
    dict(base, normal, mr, emissive (..., 4), desired (...,))."""
    w0, h0 = base_wh
    d_major = None
    if aniso > 1:
        fx2 = (torch.square(duv_dx[..., 0] * w0)
               + torch.square(duv_dx[..., 1] * h0))
        fy2 = (torch.square(duv_dy[..., 0] * w0)
               + torch.square(duv_dy[..., 1] * h0))
        p_max = torch.sqrt(torch.clamp(torch.maximum(fx2, fy2), min=1e-12))
        p_min = torch.sqrt(torch.clamp(torch.minimum(fx2, fy2), min=1e-12))
        desired = torch.log2(torch.maximum(p_max / aniso, p_min))
        d_major = torch.where((fx2 >= fy2)[..., None], duv_dx, duv_dy)
    else:
        desired = mip_from_derivatives(duv_dx, duv_dy, w0, h0)
    mip = torch.clamp(torch.round(desired), 0.0,
                      MAX_MIPS - 1.0).to(torch.int32)
    off_rel, mw, mh, mip = analytic_desc(w0, h0, mip)
    off = base_rows + off_rel

    def tap(uv_t):
        u = uv_t[..., 0] * mw.to(torch.float32) - 0.5
        v = uv_t[..., 1] * mh.to(torch.float32) - 0.5
        rows, x0, y0 = _texel_rows(atlas, off, mw, mh, wrap, u, v)
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
                              wrap, base_wh, base_rows):
    """Quad-shared material sampling: ONE atlas row gather per 2x2 pixel
    quad at mip+1 (its 2x2 texel row covers all four pixels); each pixel
    then applies its OWN bilinear weights inside that footprint.  The
    quad representative is the per-field 2x2 min.  Inputs are full
    resolution (H, W[, n]) with H, W even; returns the dict of
    sample_material_maps at full resolution.
    """
    f32 = torch.float32
    u0_q = _minpool2(uv[..., 0])
    v0_q = _minpool2(uv[..., 1])
    des_px = mip_from_derivatives(duv_dx, duv_dy, base_wh[0], base_wh[1])
    des_q = _maxpool2(des_px) + 1.0
    mip = torch.clamp(torch.round(des_q), 0.0, MAX_MIPS - 1.0
                      ).to(torch.int32)

    # pool base+tex as ONE key (base is a multiple of ATLAS_ALIGN > tex,
    # so the min picks one pixel's pair and it decodes back exactly),
    # then take that pixel's w0/h0/wrap through a match-masked pool
    big = 1 << 20
    big2 = 1 << 30
    v_px = torch.where(ent_id >= 0, base_rows + torch.clamp(ent_id, min=0),
                       big2)
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
    off = base_q + off_rel

    u_q = u0_q * mw.to(f32) - 0.5
    v_q = v0_q * mh.to(f32) - 0.5
    rows_q, x0, y0 = _texel_rows(atlas, off, mw, mh, wrap_q, u_q, v_q)
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
    return out


def srgb_to_linear(c):
    """Polynomial sRGB -> linear approximation (max err ~1e-3), applied to
    base/emissive samples (the reference uses hardware sRGB views)."""
    return c * (c * (c * 0.305306011 + 0.682171111) + 0.012522878)
