"""Visibility-buffer resolve -> GBuffer shading planes + motion vectors.

Counterpart of toyrenderer_tpu/ops/gbuffer.py.  `pack_resolve_records`
folds everything a pixel needs into ONE dense (T, 64) f32 record per
triangle; the fill kernel's epilogue (or, for CPU tensors,
`resolve_interpolants`) turns the winner's record into the 32-plane
interpolant stack; `finish_gbuffer` textures it into the float shading
planes the lighting pass reads, or (`emit_planes=False`, the frame's
`pack_gbuffer=True`) into the reference's packed 4 x u32 GBuffer
(lightingcommon.hlsli:28-57: albedo RGBA8, octahedral normal, RGB9E5
emissive, roughness / metallic RGBA8 with the material id in the high
half), which `unpack_gbuffer` reads back.
"""

from __future__ import annotations

import torch

from toyrenderer_tpu_torch.mathlib.transforms import cross, normalize
from toyrenderer_tpu_torch.ops import packing as P
from toyrenderer_tpu_torch.scene.textures import ATLAS_ALIGN

RESOLVE_REC = 64
# record layout (f32 slots):
#   0:9   edge equations        9:12  inv_scale
#  12:21  world-space vertex normals (3 x 3)
#  21:27  vertex UVs (3 x 2)
#  27:36  previous-frame clip x,y,w per vertex (3 x 3)
#  36:40  base color RGBA      40:42  metallic, roughness
#  42:45  emissive             45    material id
#  46     material atlas entry (-1 none; tex + 64*base11 when analytic)
#  47     texture statics A: w0 + 4096*wrap
#  48     alpha cutoff
#  49:58  world-space vertex positions (3 x 3)
#  58     texture statics B: h0
#  59:64  padding


def pack_resolve_records(setup: dict, scene, inst_world, inst_adj,
                         prev_inst_world, prev_view_proj_nojit):
    """(T, 64) f32 per-triangle resolve records (dense over triangles).

    Vertex attributes come from each pair's 64-vertex meshlet window
    (scene.ml_verts), transformed at window rate and gathered per
    triangle by window-local index."""
    t = setup['valid'].shape[0]
    mat = setup['mat_id'].long()
    p_in = setup['pair_inst'].long()
    pm = setup['pair_meshlet'].long()
    tp = pm.shape[0]

    # fold prev view-proj into the per-INSTANCE matrices first
    prev_mat = torch.matmul(prev_view_proj_nojit, prev_inst_world)
    win = scene.ml_verts[pm]                               # (Tp, 64, 8)
    lt = scene.ml_local_tris[pm].long()                    # (Tp, 96, 3)
    wpos, wnrm, wuv = win[..., 0:3], win[..., 3:6], win[..., 6:8]
    wpos_h = torch.cat([wpos, torch.ones_like(wpos[..., :1])], -1)
    # vertex normals stay UNNORMALIZED (the per-pixel normalize after
    # interpolation recovers direction)
    nrm_w = torch.matmul(wnrm, inst_adj[p_in].transpose(-1, -2))
    prevc = torch.matmul(wpos_h, prev_mat[p_in].transpose(-1, -2))
    prevc = prevc[..., [0, 1, 3]]                          # (Tp, 64, 3)
    worldp = torch.matmul(wpos_h, inst_world[p_in].transpose(-1, -2))
    feats = torch.cat([nrm_w, wuv, prevc, worldp[..., :3]], -1)
    rows = torch.arange(tp, device=pm.device)[:, None, None]
    tri = feats[rows, lt].reshape(t, 3, feats.shape[-1])   # (T, 3, 11)
    n_w, uv = tri[..., 0:3], tri[..., 3:5]
    prev_xyw, world_pos = tri[..., 5:8], tri[..., 8:11]

    base = scene.mat_base_color[mat]                       # (T, 4)
    mr = scene.mat_metal_rough[mat]                        # (T, 2)
    emis = scene.mat_emissive[mat]                         # (T, 3)

    # texture statics per MATERIAL first (M is tiny), then one gather
    m_tex = scene.mat_base_color_tex
    m_safe = torch.clamp(m_tex, min=0).long()
    if scene.tex_analytic:
        # analytic-descriptor encoding: tex + 64*base11 (< 2^16)
        m_base = torch.div(scene.tex_offset[m_safe, 0], ATLAS_ALIGN,
                           rounding_mode='floor')
        m_tex = torch.where(m_tex >= 0, m_tex + 64 * m_base, -1)
    m_statics_a = scene.tex_width[m_safe, 0] + 4096 * scene.tex_wrap[m_safe]
    m_h0 = scene.tex_height[m_safe, 0]

    f32 = torch.float32
    return torch.cat([
        setup['edges'].reshape(t, 9),
        setup['inv_s'],
        n_w.reshape(t, 9),
        uv.reshape(t, 6),
        prev_xyw.reshape(t, 9),
        base, mr, emis,
        mat.to(f32)[:, None],
        m_tex[mat].to(f32)[:, None],
        m_statics_a[mat].to(f32)[:, None],
        scene.mat_alpha_cutoff[mat][:, None],
        world_pos.reshape(t, 9),
        m_h0[mat].to(f32)[:, None],
        torch.zeros((t, 5), dtype=f32, device=base.device),
    ], dim=1).contiguous()


# interpolant plane stack, CHANNEL-FIRST (INTERP_C, H, W): the layout the
# fill kernel's epilogue writes
INTERP_C = 32
I_NRM = slice(0, 3)      # interpolated (normalized) world normal
I_UV = slice(3, 5)       # interpolated UV
I_DUVX = slice(5, 7)     # analytic dUV/dx
I_DUVY = slice(7, 9)     # analytic dUV/dy
I_T = slice(9, 12)       # cotangent T (max-normalized; 0 if degenerate)
I_B = slice(12, 15)      # cotangent B
I_BASE = slice(15, 19)   # material base color factor RGBA
I_MR = slice(19, 21)     # metallic, roughness factors
I_EMIS = slice(21, 24)   # emissive factor
I_MAT = 24               # material id (f32-exact)
I_TEX = 25               # material atlas entry (-1 none)
I_WS = 26                # texture statics A (w0 + 4096*wrap)
I_CUT = 27               # alpha cutoff
I_PREV = slice(28, 31)   # previous-frame clip x, y, w
I_H0 = 31                # texture statics B (h0)


def _pixel_centres(h: int, w: int, device):
    px = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    py = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    return px[None, :].expand(h, w), py[:, None].expand(h, w)


def resolve_interpolants(records, depth, tri_id, cfg, pixel_xy=None,
                         screen_wh=None):
    """Per-pixel barycentric resolve: (T, 64) records + visibility buffer
    -> (INTERP_C, H, W) interpolant planes (layout above).

    The plain version of the fill kernel's epilogue; it evaluates every
    sum in the kernel's order (the reference package divides by the
    screen size where both multiply by its reciprocal: ~1 ulp apart).
    pixel_xy: (px, py) the true pixel centres of an image whose pixels
    come from anywhere on screen (masked_peel_merge_compact's compact
    quads); screen_wh: the real screen size when the image is not the
    screen (edge equations are normalized to it).
    """
    h, w = depth.shape
    sw, sh = (w, h) if screen_wh is None else screen_wh
    rec = records[torch.clamp(tri_id, min=0).long()]      # (H, W, 64)
    if pixel_xy is None:
        px, py = _pixel_centres(h, w, depth.device)
    else:
        px, py = pixel_xy
    # multiply by the f32 reciprocal of the screen size, as the kernel
    # does: a division by a Python number may run as exactly that on one
    # device and as a true division on another
    inv_w, inv_h = 1.0 / sw, 1.0 / sh
    pxn = px * inv_w
    pyn = py * inv_h

    def r(k):
        return rec[..., k]

    def bary_at(dpx, dpy):
        xx = pxn + dpx * inv_w
        yy = pyn + dpy * inv_h
        lw = [(r(3 * v) * xx + r(3 * v + 1) * yy + r(3 * v + 2)) * r(9 + v)
              for v in range(3)]
        d = lw[0] + lw[1] + lw[2]
        d = torch.where(torch.abs(d) < 1e-30, 1e-30, d)
        return [x / d for x in lw]

    def lerp(base, stride, n, pc):
        return [r(base + i) * pc[0] + r(base + stride + i) * pc[1]
                + r(base + 2 * stride + i) * pc[2] for i in range(n)]

    pc = bary_at(0.0, 0.0)
    pc_x = bary_at(1.0, 0.0)
    pc_y = bary_at(0.0, 1.0)
    nr = torch.stack(lerp(12, 3, 3, pc), -1)
    n_w = normalize(nr)
    uv = lerp(21, 2, 2, pc)
    duv_dx = [a - b for a, b in zip(lerp(21, 2, 2, pc_x), uv)]
    duv_dy = [a - b for a, b in zip(lerp(21, 2, 2, pc_y), uv)]
    prev_xyw = lerp(27, 3, 3, pc)
    pos = lerp(49, 3, 3, pc)
    dp1 = torch.stack([a - b for a, b in zip(lerp(49, 3, 3, pc_x), pos)], -1)
    dp2 = torch.stack([a - b for a, b in zip(lerp(49, 3, 3, pc_y), pos)], -1)

    # cotangent frame (Schueler; CalculateTBNWithoutTangent parity,
    # toyrenderer_common.hlsli:235-247); degenerate UVs -> T = B = 0
    dp1perp = cross(n_w, dp1)
    dp2perp = cross(dp2, n_w)
    t_vec = dp2perp * duv_dx[0][..., None] + dp1perp * duv_dy[0][..., None]
    b_vec = dp2perp * duv_dx[1][..., None] + dp1perp * duv_dy[1][..., None]

    def sq(v):
        x, y, z = v.unbind(-1)
        return x * x + y * y + z * z
    m2 = torch.maximum(sq(t_vec), sq(b_vec))
    inv_max = (1.0 / torch.sqrt(torch.clamp(m2, min=1e-20)))[..., None]
    # constant UVs make duv pure rounding noise: gate on |duv|^2
    duv2 = ((duv_dx[0] * duv_dx[0] + duv_dx[1] * duv_dx[1])
            + (duv_dy[0] * duv_dy[0] + duv_dy[1] * duv_dy[1]))
    ok_tbn = ((m2 > 1e-16) & (duv2 > 1e-12))[..., None]
    t_n = torch.where(ok_tbn, t_vec * inv_max, 0.0)
    b_n = torch.where(ok_tbn, b_vec * inv_max, 0.0)

    planes = [n_w[..., i] for i in range(3)] + uv + duv_dx + duv_dy
    planes += [t_n[..., i] for i in range(3)] + [b_n[..., i] for i in range(3)]
    planes += [r(k) for k in range(36, 49)] + prev_xyw + [r(58)]
    return torch.stack(planes, 0)


def finish_gbuffer(interp, depth, tri_id, jitter, cfg, atlas=None,
                   num_textures: int = 0, quad_taps: bool = False,
                   aniso: int = 1, pixel_xy=None, screen_wh=None,
                   feedback: bool = True, emit_planes: bool = True):
    """Interpolant planes (INTERP_C, H, W) -> textured shading planes,
    or with emit_planes=False the packed GBuffer words gbuffer0-3 (int32
    bit patterns of the reference's u32 words) in their place.

    jitter: (2,) current sub-pixel jitter in pixels (motion vectors are
    unjittered).  atlas: the sampler's atlas dict (tex_texels, tex_desc,
    tex_wrap, tex_min_mip, optionally tex_tile_table, and the flags
    '_enc': records carry tex + 64*base11, '_analytic': derive the mip
    descriptors from it instead of gathering desc rows) or None for
    untextured shading.  pixel_xy / screen_wh: as resolve_interpolants
    takes them (motion vectors are in screen pixels).
    With an atlas and `feedback` the result also holds the sampler
    feedback: tex_feedback (num_textures,) (per-texture min desired mip,
    +inf where unused), tex_desired_mip (H, W) (-1 off textured pixels)
    and, with a tile table, vt_tile_feedback (table size,) (per tile).
    The masked set's layers pass feedback=False: their feedback is
    never read (reference package, gbuffer.py:553-556).
    """
    h, w = depth.shape
    sw, sh = (w, h) if screen_wh is None else screen_wh
    hit = tri_id >= 0
    if pixel_xy is None:
        px, py = _pixel_centres(h, w, depth.device)
    else:
        px, py = pixel_xy

    def ch(sl):
        return torch.movedim(interp[sl], 0, -1)

    n_w = ch(I_NRM)
    uv = ch(I_UV)
    prev_xyw = ch(I_PREV)
    pw_safe = torch.where(torch.abs(prev_xyw[..., 2:3]) < 1e-8, 1e-8,
                          prev_xyw[..., 2:3])
    prev_ndc = prev_xyw[..., :2] / pw_safe
    prev_px = torch.stack([(prev_ndc[..., 0] * 0.5 + 0.5) * sw,
                           (0.5 - prev_ndc[..., 1] * 0.5) * sh], -1)
    cur_px = torch.stack([px - jitter[0], py - jitter[1]], -1)
    motion = torch.where((hit & (prev_xyw[..., 2] > 0))[..., None],
                         cur_px - prev_px, 0.0)

    base_color = ch(I_BASE)
    metal = torch.clamp(interp[19], 0.0, 1.0)
    rough = torch.clamp(interp[20], 0.02, 1.0)
    emissive = torch.clamp(ch(I_EMIS), min=0.0)

    fb = {}
    if atlas is not None:
        from toyrenderer_tpu_torch.ops.texture import (
            sample_material_maps, sample_material_maps_quad, srgb_to_linear,
            texture_feedback, vt_tile_feedback)
        tex_id = interp[I_TEX].to(torch.int32)
        tex_id = torch.where(hit, tex_id, -1)
        base_rows = None
        if atlas.get('_enc'):
            # records carry tex + 64*base11: decode the plain id and,
            # unless a streaming override rewrote the desc rows, the
            # chain base for the analytic descriptor path
            if atlas.get('_analytic'):
                base_rows = torch.where(
                    tex_id >= 0, torch.div(tex_id, 64, rounding_mode='floor')
                    * ATLAS_ALIGN, 0)
            tex_id = torch.where(tex_id >= 0, torch.remainder(tex_id, 64),
                                 -1)
        duv_dx = ch(I_DUVX)
        duv_dy = ch(I_DUVY)
        statics = torch.round(interp[I_WS]).to(torch.int32)
        tw0 = torch.remainder(statics, 4096).to(torch.float32)
        twrap = torch.div(statics, 4096, rounding_mode='floor')
        th0 = torch.round(interp[I_H0])
        if quad_taps and aniso <= 1 and h % 2 == 0 and w % 2 == 0:
            maps = sample_material_maps_quad(
                atlas, tex_id, uv, duv_dx, duv_dy, wrap=twrap,
                base_wh=(tw0, th0), base_rows=base_rows)
        else:
            maps = sample_material_maps(
                atlas, tex_id, uv, duv_dx, duv_dy, wrap=twrap,
                base_wh=(tw0, th0), aniso=aniso, base_rows=base_rows)
        tex_rgba = torch.cat([srgb_to_linear(maps['base'][..., :3]),
                              maps['base'][..., 3:4]], -1)
        base_color = base_color * tex_rgba
        # glTF MR texture: G = roughness, B = metallic, factors multiply
        rough = rough * maps['mr'][..., 1]
        metal = metal * maps['mr'][..., 2]
        emissive = emissive * srgb_to_linear(maps['emissive'][..., :3])

        # normal mapping in the precomputed cotangent frame
        t_n = ch(I_T)
        b_n = ch(I_B)
        n_ts = maps['normal'][..., :3] * 2.0 - 1.0
        n_mapped = normalize(t_n * n_ts[..., 0:1] + b_n * n_ts[..., 1:2]
                             + n_w * n_ts[..., 2:3])
        ok_tbn = (torch.maximum(torch.sum(t_n * t_n, -1),
                                torch.sum(b_n * b_n, -1)) > 0.0)
        n_w = torch.where((ok_tbn & (tex_id >= 0))[..., None], n_mapped, n_w)
        desired = maps['desired']
        if feedback:
            fb = dict(
                tex_feedback=texture_feedback(tex_id, desired, num_textures),
                tex_desired_mip=torch.where(hit & (tex_id >= 0), desired,
                                            -1.0))
            if 'tile_id' in maps:
                fb['vt_tile_feedback'] = vt_tile_feedback(
                    torch.where(hit, maps['tile_id'], -1), desired,
                    atlas['tex_tile_table'].shape[0])

    h3 = hit[..., None]
    out = dict(
        alpha=torch.where(hit, base_color[..., 3], 0.0),
        alpha_cutoff=interp[I_CUT],
        motion=motion,
        depth=depth,
        uv=torch.where(h3, uv, 0.0),
        **fb,
    )
    if emit_planes:
        out.update(albedo_f=torch.where(h3, base_color[..., :3], 0.0),
                   normal_f=torch.where(h3, n_w, 0.0),
                   emissive_f=torch.where(h3, emissive, 0.0),
                   rough_f=torch.where(hit, rough, 0.0),
                   metal_f=torch.where(hit, metal, 0.0))
        return out
    # the packed words (reference package, gbuffer.py:380-405); the
    # material id rides the high half of gbuffer3, clamped to 16 bits
    mat_id = torch.clamp(interp[I_MAT].to(torch.int64), max=0xFFFF)
    zero = torch.zeros_like(rough)
    words = (P.pack_rgba8_u32(base_color), P.pack_normal_oct_u32(n_w),
             P.pack_rgb9e5_u32(emissive),
             P.pack_rgba8_u32(torch.stack([rough, metal, zero, zero], -1))
             | P.u32_bits(mat_id << 16))
    for i, g in enumerate(words):
        out[f'gbuffer{i}'] = torch.where(hit, g, 0)
    return out


def resolve_gbuffer(records, depth, tri_id, jitter, cfg, atlas=None,
                    num_textures: int = 0, quad_taps: bool = False,
                    aniso: int = 1, emit_planes: bool = True):
    """Per-pixel resolve + GBuffer from either input form: (T, 64) raw
    records + visibility buffer (resolve_interpolants first), or the
    (INTERP_C, H, W) planes the fill kernel already wrote."""
    if records.ndim == 3 and records.shape[0] == INTERP_C:
        interp = records
    else:
        interp = resolve_interpolants(records, depth, tri_id, cfg)
    return finish_gbuffer(interp, depth, tri_id, jitter, cfg, atlas=atlas,
                          num_textures=num_textures, quad_taps=quad_taps,
                          aniso=aniso, emit_planes=emit_planes)


def unpack_gbuffer(gb: dict):
    """GBuffer channels -> shading inputs (lightingcommon.hlsli unpack):
    the float planes when the GBuffer has them, else the packed words
    gbuffer0-3 decoded (reference package, gbuffer.py:438-455)."""
    if 'albedo_f' in gb:
        return dict(albedo=gb['albedo_f'], normal=gb['normal_f'],
                    emissive=gb['emissive_f'], roughness=gb['rough_f'],
                    metallic=gb['metal_f'], depth=gb['depth'])
    rm = P.unpack_rgba8_u32(gb['gbuffer3'] & 0xFFFF)
    return dict(albedo=P.unpack_rgba8_u32(gb['gbuffer0'])[..., :3],
                normal=P.unpack_normal_oct_u32(gb['gbuffer1']),
                emissive=P.unpack_rgb9e5_u32(gb['gbuffer2']),
                roughness=rm[..., 0], metallic=rm[..., 1], depth=gb['depth'])


def _merges(k: str, channels) -> bool:
    """Does the compact merge carry channel k back?  By default every
    shading channel (not uv, which only debug views read)."""
    if k in ('alpha', 'alpha_cutoff', 'depth'):
        return False
    return k != 'uv' if channels is None else k in channels


def masked_peel_merge_compact(records, peel_depth, peel_tid, jitter, cfg,
                              cap_quads: int, atlas=None,
                              quad_taps: bool = False, aniso: int = 1,
                              channels=None, emit_planes: bool = True):
    """Every masked peel layer -> the merged winner's channels, resolved
    and textured only on the 2x2 quads that hold a fragment
    (reference package, gbuffer.py:456-626).

    The reference renderer alpha-tests cutout fragments inside the base
    pass (basepass.hlsl ALPHA_MASK_MODE discard), so the nearest passing
    fragment wins.  Here the L peel layers (fill_peel_stream, occluder-
    seeded and nearest first) must be textured to learn their alpha; the
    masked set covers a small share of the screen, so the quads holding
    any layer's fragment are compacted (a stable sort of their quad
    index), every layer is resolved and textured at compact rate, the
    nearest alpha-passing fragment wins, and one quad-rate gather (slot
    = cumsum rank of the hit quads) brings the winner's channels back.
    Compact images keep the quad layout, so the quad texture sampler's
    2x2 pools see the same pixels as at full resolution.

    records: (T, 64) the masked set's resolve records; peel_depth /
    peel_tid: (L, H, W).  Quads past cap_quads drop their fragments.
    emit_planes=False resolves the packed words (finish_gbuffer), which
    ride the row table as their bits.
    Returns full-resolution {'passes' (H, W) bool, 'depth', 'tri_id',
    <channels>}; tri_id is -1 where no layer passed.
    """
    n_layers, h, w = peel_tid.shape
    if h % 2 or w % 2:
        raise ValueError("the compact merge needs an even image size")
    hq, wq = h // 2, w // 2
    q = hq * wq
    c = 256
    r = max(-(-min(cap_quads, q) // c), 4)
    cap = r * c
    dev = peel_tid.device
    i32 = torch.int32

    hit_any = (peel_tid >= 0).any(dim=0)                   # (H, W)
    hitq = hit_any.reshape(hq, 2, wq, 2).any(dim=3).any(dim=1).reshape(-1)
    # ascending quad order of the hit quads == their cumsum rank, so the
    # build side (sort) and the expand side (cumsum) agree on slots
    arange_q = torch.arange(q, dtype=i32, device=dev)
    order = torch.sort(torch.where(hitq, arange_q, q), stable=True).values
    if order.shape[0] < cap:
        order = torch.cat([order, order.new_full((cap - q,), q)])
    order = order[:cap]
    okq = order < q
    oq = torch.where(okq, order, 0)
    qy, qx = oq // wq, oq % wq
    d2 = torch.arange(2, dtype=i32, device=dev)
    py_i = 2 * qy[:, None, None] + d2[None, :, None]       # (cap, 2, 1)
    px_i = 2 * qx[:, None, None] + d2[None, None, :]       # (cap, 1, 2)
    flat_v = (py_i * w + px_i).reshape(-1).long()          # (cap * 4,)

    def quads_to_img(v):
        rest = v.shape[3:]
        v = v.reshape(r, c, 2, 2, *rest).movedim(2, 1)
        return v.reshape(2 * r, 2 * c, *rest)

    # one packed gather pulls every layer's depth and id into compact space
    dz = torch.cat([peel_depth.movedim(0, -1),
                    peel_tid.movedim(0, -1).contiguous().view(torch.float32)],
                   -1).reshape(h * w, 2 * n_layers)
    img = quads_to_img(dz[flat_v].reshape(cap, 2, 2, 2 * n_layers))
    ok_img = quads_to_img(okq[:, None, None].expand(cap, 2, 2))
    pix = (quads_to_img(px_i.expand(cap, 2, 2)).to(torch.float32) + 0.5,
           quads_to_img(py_i.expand(cap, 2, 2)).to(torch.float32) + 0.5)

    # resolve + texture every layer at compact rate; the nearest passing
    # fragment wins (layers arrive nearest first)
    win = depth_w = tid_w = None
    merged = {}
    for li in range(n_layers):
        depth_c = img[..., li]
        tid_c = img[..., n_layers + li].contiguous().view(i32)
        tid_c = torch.where(ok_img, tid_c, -1)
        interp = resolve_interpolants(records, depth_c, tid_c, cfg,
                                      pixel_xy=pix, screen_wh=(w, h))
        gb_l = finish_gbuffer(interp, depth_c, tid_c, jitter, cfg,
                              atlas=atlas, quad_taps=quad_taps, aniso=aniso,
                              pixel_xy=pix, screen_wh=(w, h),
                              feedback=False, emit_planes=emit_planes)
        # occluder-seeded peel: tid >= 0 already means in front of the
        # opaque surface
        p_l = (gb_l['alpha'] >= gb_l['alpha_cutoff']) & (tid_c >= 0)
        sel = p_l if win is None else p_l & ~win
        for k, v in gb_l.items():
            if not _merges(k, channels):
                continue
            s = sel[..., None] if v.ndim == 3 else sel
            merged[k] = torch.where(s, v, torch.zeros_like(v)
                                    if k not in merged else merged[k])
        depth_w = torch.where(sel, depth_c, 0.0 if depth_w is None
                              else depth_w)
        tid_w = torch.where(sel, tid_c, -1 if tid_w is None else tid_w)
        win = p_l if win is None else win | p_l

    # the winner's channels (+ depth, tri_id) in ONE quad-rate row table:
    # all 4 pixels of a quad ride one row.  tri_id rides as a float VALUE
    # (exact below 2^24): the pad row, for quads with no slot, reads -1;
    # the packed words ride as their bits (the pad row's are 0)
    named = dict(depth=depth_w, tri_id=tid_w.to(torch.float32), **merged)
    words = {k for k, v in named.items() if v.dtype == torch.int32}
    parts = [(v.view(torch.float32) if k in words else v)
             for k, v in named.items()]
    parts = [v[..., None] if v.ndim == 2 else v for v in parts]
    widths = [p.shape[-1] for p in parts]
    packed = torch.cat(parts, -1)                          # (2R, 2C, ct)
    ct = packed.shape[-1]
    pq = packed.reshape(r, 2, c, 2, ct).movedim(1, 2)
    pad = torch.zeros((4, ct), dtype=torch.float32, device=dev)
    pad[:, 1] = -1.0
    table = torch.cat([pq.reshape(cap, 4 * ct), pad.reshape(1, 4 * ct)])
    slot = torch.cumsum(hitq.to(i32), 0, dtype=i32) - 1
    idx = torch.where(hitq & (slot < cap), slot, cap).reshape(hq, wq)
    rows = table[idx.long()].reshape(hq, wq, 2, 2, ct).movedim(2, 1)
    rows = rows.reshape(h, w, ct)

    out = {}
    o = 0
    for k, wd in zip(named, widths):
        v = rows[..., o:o + wd]
        o += wd
        v = v[..., 0] if wd == 1 else v
        out[k] = v.contiguous().view(i32) if k in words else v
    out['tri_id'] = torch.round(out['tri_id']).to(i32)
    out['passes'] = out['tri_id'] >= 0
    return out
