"""Ray-traced sun shadows with cone sampling, and the checkerboard
half-grid the frame traces.

Counterpart of toyrenderer_tpu/ops/shadows.py (reference:
source/ShadowMaskRenderer.cpp + shadowmask.hlsl:65-145, inline-RT shadow
rays with blue-noise cone sampling for the soft sun): one any-hit ray
per pixel through the tree (ops/bvh_cuda.py, K3), cone-sampled by
interleaved-gradient noise rotated per frame; with TR_SHADOW_GDIR=1 one
cone sample per 64x2 strip, so the rays trace through the grouped-
direction kernel K5.  The denoiser is
ops/denoise.py.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from toyrenderer_tpu_torch.ops.bvh_cuda import traverse_auto

SUN_ANGULAR_RADIUS = float(np.radians(0.265))
RAY_BLOCK = 64          # rays are ordered in 64x64 pixel blocks


def interleaved_gradient_noise(h: int, w: int, frame_index):
    """Per-pixel noise in [0, 1), decorrelated across frames (the
    reference's blue-noise texture's stand-in).  frame_index: an int32
    tensor scalar."""
    dev = frame_index.device
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(
        h, w)
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(
        h, w)
    f = torch.remainder(frame_index.to(torch.float32), 64.0)
    x = x + 5.588238 * f
    y = y + 5.588238 * f
    v = 52.9829189 * torch.remainder(0.06711056 * x + 0.00583715 * y, 1.0)
    return torch.remainder(v, 1.0)


def _orthonormal_basis(d):
    """Branchless orthonormal basis (Duff et al.) for directions (..., 3)."""
    sign = torch.where(d[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + d[..., 2])
    b = d[..., 0] * d[..., 1] * a
    t = torch.stack([1.0 + sign * d[..., 0] ** 2 * a, sign * b,
                     -sign * d[..., 0]], -1)
    bt = torch.stack([b, sign + d[..., 1] ** 2 * a, -d[..., 1]], -1)
    return t, bt


def cone_sample(direction, r1, r2, half_angle: float):
    """Directions in a cone around `direction` (uniform disc)."""
    t, bt = _orthonormal_basis(direction)
    radius = float(np.tan(np.float32(half_angle))) * torch.sqrt(r1)
    phi = float(np.float32(2.0 * math.pi)) * r2
    offs = (t * (radius * torch.cos(phi))[..., None]
            + bt * (radius * torch.sin(phi))[..., None])
    d = direction + offs
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-8)


def _to_blocks(img, blk: int = RAY_BLOCK):
    """(H, W, ...) -> (Hp * Wp, ...): zero-padded to whole 64x64 blocks,
    ordered block by block (a block's rays are neighbours on screen)."""
    h, w = img.shape[:2]
    hp, wp = -(-h // blk) * blk, -(-w // blk) * blk
    pad = [0, 0] * (img.dim() - 2) + [0, wp - w, 0, hp - h]
    x = torch.nn.functional.pad(img, pad)
    x = x.reshape(hp // blk, blk, wp // blk, blk, *img.shape[2:])
    return x.transpose(1, 2).reshape(-1, *img.shape[2:])


def _from_blocks(v, h: int, w: int, blk: int = RAY_BLOCK):
    hp, wp = -(-h // blk) * blk, -(-w // blk) * blk
    x = v.reshape(hp // blk, wp // blk, blk, blk)
    return x.transpose(1, 2).reshape(hp, wp)[:h, :w]


def _shadow_gdir_enabled() -> bool:
    return os.environ.get('TR_SHADOW_GDIR', '0') == '1'


def trace_shadow_mask(bvh, world_pos, normal, hit_mask, sun_dir_to_light,
                      frame_index, half_angle: float = SUN_ANGULAR_RADIUS,
                      normal_bias: float = 2e-2, t_max: float = 1e4,
                      max_steps: int = 96, gdir: bool | None = None,
                      sp_mesh=None):
    """1 spp cone-sampled sun visibility per pixel.

    world_pos, normal (H, W, 3), hit_mask (H, W) bool, sun_dir_to_light
    (3,) surface -> sun.  Returns (H, W) f32, 1 = lit; pixels facing away
    from the sun are 0, sky pixels 1.  Only the rays of lit-side
    geometry trace (the others are dead rays: their value comes from
    the facing and sky terms).  max_steps is accepted; it does not bound
    the traversal (see bvh_cuda.traverse_auto).  gdir (None: read
    TR_SHADOW_GDIR, as the reference does): one cone sample per 64x2
    strip of the 64x64 ray blocks, so every 128 rays share a direction
    and trace through the grouped-direction kernel K5, its directions
    in the `group_dirs` side table.  sp_mesh = (Mesh, axis) traces the
    rays in slices over the axis's devices (traverse_auto)."""
    h, w = hit_mask.shape
    if gdir is None:
        gdir = _shadow_gdir_enabled()
    origins = world_pos + normal * normal_bias
    gd = None
    if gdir:
        hp = -(-h // RAY_BLOCK) * RAY_BLOCK
        wp = -(-w // RAY_BLOCK) * RAY_BLOCK
        sh, sw = hp // 2, wp // RAY_BLOCK
        r1 = interleaved_gradient_noise(sh, sw, frame_index)
        r2 = interleaved_gradient_noise(sh, sw, frame_index + 17)
        strips = cone_sample(sun_dir_to_light.expand(sh, sw, 3), r1, r2,
                             half_angle)                  # (hp/2, wp/64, 3)
        dirs = strips.repeat_interleave(2, 0).repeat_interleave(
            RAY_BLOCK, 1)[:h, :w]
        # strip (ty * 32 + j, tx) -> group (block-major, then row pair)
        gd = strips.reshape(hp // RAY_BLOCK, RAY_BLOCK // 2, wp // RAY_BLOCK,
                            3).transpose(1, 2).reshape(-1, 3).contiguous()
    else:
        r1 = interleaved_gradient_noise(h, w, frame_index)
        r2 = interleaved_gradient_noise(h, w, frame_index + 17)
        dirs = cone_sample(sun_dir_to_light.expand(world_pos.shape), r1, r2,
                           half_angle)
    ndotl = torch.sum(normal * sun_dir_to_light, -1)
    live = _to_blocks((hit_mask & (ndotl > 0.0)).to(torch.float32))
    res = traverse_auto(bvh, _to_blocks(origins).contiguous(),
                        _to_blocks(dirs).contiguous(), t_max=t_max,
                        max_steps=max_steps, any_hit=True, live=live,
                        group_dirs=gd, sp_mesh=sp_mesh)
    lit = 1.0 - _from_blocks(res['hit'].to(torch.float32), h, w)
    lit = torch.where(ndotl <= 0.0, 0.0, lit)
    return torch.where(hit_mask, lit, 1.0)


def _parity_rows(h: int, parity, device):
    """(H,) bool: rows whose kept (traced) cell is the odd column."""
    ys = torch.arange(h, dtype=torch.int32, device=device)
    return torch.remainder(ys + parity, 2) == 1


def checkerboard_pack(imgs, parity):
    """Compact the checkerboard half of each (H, W[, C]) image to
    (H, W//2[, C]): the kept cells are x = 2k + ((y + parity) % 2).
    parity: an int32 tensor scalar (the frame's parity), so alternating
    frames trace complementary halves."""
    out = []
    for img in imgs:
        h, w = img.shape[:2]
        x = img.reshape(h, w // 2, 2, *img.shape[2:])
        sel = _parity_rows(h, parity, img.device).reshape(
            h, *([1] * (x.dim() - 2)))
        out.append(torch.where(sel, x[:, :, 1], x[:, :, 0]))
    return out


def checkerboard_unpack(traced, parity):
    """Expand a packed (H, K) traced grid back to (H, 2K): traced cells
    keep their value, each untraced one takes the mean of its two row
    neighbours (both traced this frame).  As in the reference, the fill
    takes no account of sky or backfacing cells."""
    h, k = traced.shape
    right = torch.cat([traced[:, 1:], traced[:, -1:]], dim=1)
    left = torch.cat([traced[:, :1], traced[:, :-1]], dim=1)
    fill0 = 0.5 * (traced + right)   # parity-even rows: odd x untraced
    fill1 = 0.5 * (left + traced)    # parity-odd rows: even x untraced
    sel = _parity_rows(h, parity, traced.device)[:, None]
    even = torch.where(sel, fill1, traced)
    odd = torch.where(sel, traced, fill0)
    return torch.stack([even, odd], dim=2).reshape(h, 2 * k)
