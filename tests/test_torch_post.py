"""The port's post passes (TAA, the shadow denoiser's temporal
accumulate, auto-exposure, bloom, the final compose) against the
reference package's, on seeded numpy inputs handed to both.

TAA and the temporal accumulate resample history through the warp (K4)
on every device, with its fast-motion rejection, as the reference
package does on its accelerator; on the CPU the reference takes its
bilinear gather instead, with no rejection.  The two branches agree
where |motion| <= 6 px (inside the warp's reach and under its rejection
threshold, 7 px for TAA and 14 for the half-resolution denoiser), so
there the port is held to the reference's CPU functions as they are.
With motion up to 20 px (a part of the pixels moving 7-20 px, the rest
less) the port is held to the reference's accelerator branch,
rebuilt here from its own pieces with the Pallas warp in interpret mode
(nothing in the reference package is patched).

Tolerances: TAA and the temporal accumulate 2e-5 absolute on values in
[0, 1] (the gather and the warp form the sample coordinate in a
different order, an ulp apart); exposure, bloom and the compose 1e-5
relative (sums in another order), the u8 image within 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyrenderer_tpu.ops import bloom as JB
from toyrenderer_tpu.ops import denoise as JD
from toyrenderer_tpu.ops import exposure as JE
from toyrenderer_tpu.ops import postprocess as JP
from toyrenderer_tpu.ops import taa as JT
from toyrenderer_tpu.ops.warp_pallas import MAX_DISP
from toyrenderer_tpu.ops.warp_pallas import warp_bilinear as jax_warp

from toyrenderer_tpu_torch.ops import bloom as TB
from toyrenderer_tpu_torch.ops import denoise as TD
from toyrenderer_tpu_torch.ops import exposure as TE
from toyrenderer_tpu_torch.ops import postprocess as TP
from toyrenderer_tpu_torch.ops import taa as TT


def t(x):
    return torch.from_numpy(np.array(x))


def _motion(rng, h, w, lo, hi):
    """Motion with |component| in [lo, hi] (random signs)."""
    mag = rng.uniform(lo, hi, size=(h, w, 2))
    sign = rng.choice([-1.0, 1.0], size=(h, w, 2))
    return (mag * sign).astype(np.float32)


def _jax_taa_kernel_branch(color, motion, history, valid, blend=0.9,
                           clip_gamma=1.0):
    """The reference's taa_resolve on its accelerator branch
    (taa.py:82-90): the warp and the fast-motion rejection."""
    h, w = color.shape[:2]
    py = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + 0.5
    px = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + 0.5
    prev_y = py - motion[..., 1] - 0.5
    prev_x = px - motion[..., 0] - 0.5
    hist = jax_warp(history, motion, interpret=True)
    fast = ((jnp.abs(motion[..., 0]) > MAX_DISP - 1.0)
            | (jnp.abs(motion[..., 1]) > MAX_DISP - 1.0))
    mean, sigma = JT._neighborhood_moments(color)
    hist = jnp.clip(hist, mean - sigma * clip_gamma, mean + sigma * clip_gamma)
    off = ((prev_y < 0) | (prev_y > h - 1) | (prev_x < 0) | (prev_x > w - 1)
           | fast)
    alpha = jnp.where(off[..., None], 0.0, blend * valid)
    return color * (1.0 - alpha) + hist * alpha


def _jax_accumulate_kernel_branch(signal, motion, history, valid, depth,
                                  prev_depth, blend=0.9, tol=0.1):
    """The reference's temporal_accumulate on its accelerator branch
    (denoise.py:50-62): the half-resolution warp and its rejection."""
    h, w = signal.shape
    py = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + 0.5
    px = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + 0.5
    prev_y = py - motion[..., 1] - 0.5
    prev_x = px - motion[..., 0] - 0.5

    def avgpool(a):
        return jax.lax.reduce_window(a, 0.0, jax.lax.add, (2, 2), (2, 2),
                                     'VALID') * 0.25
    pack_h = jnp.stack([avgpool(history), avgpool(prev_depth)], -1)
    mot_h = jnp.stack([avgpool(motion[..., 0]) * 0.5,
                       avgpool(motion[..., 1]) * 0.5], -1)
    both = jax_warp(pack_h, mot_h, interpret=True)
    both = jnp.repeat(jnp.repeat(both, 2, 0), 2, 1)
    lim = 2.0 * (MAX_DISP - 1.0)
    fast = (jnp.abs(motion[..., 0]) > lim) | (jnp.abs(motion[..., 1]) > lim)
    off = ((prev_y < 0) | (prev_y > h - 1) | (prev_x < 0) | (prev_x > w - 1)
           | fast)
    safe = jnp.maximum(depth, 1e-8)
    psafe = jnp.maximum(both[..., 1], 1e-8)
    rel = jnp.abs(1.0 / safe - 1.0 / psafe) * safe
    disocc = (rel > tol) | (both[..., 1] <= 0.0) | (depth <= 0.0)
    alpha = jnp.where(off | disocc, 0.0, blend * valid)
    return signal * (1.0 - alpha) + both[..., 0] * alpha


@pytest.mark.parametrize("lo,hi,valid", [(0.0, 6.0, 1.0), (0.0, 6.0, 0.0),
                                         (0.0, 20.0, 1.0)])
def test_taa_matches_reference(lo, hi, valid):
    rng = np.random.default_rng(int(hi * 10 + valid))
    h, w = 72, 136                        # min >= 64: the warp branch
    color = rng.uniform(size=(h, w, 3)).astype(np.float32)
    hist = rng.uniform(size=(h, w, 3)).astype(np.float32)
    mot = _motion(rng, h, w, lo, hi)
    if hi <= 6.0:
        want, _ = JT.taa_resolve(jnp.asarray(color), jnp.asarray(mot),
                                 jnp.asarray(hist), jnp.float32(valid))
    else:
        want = _jax_taa_kernel_branch(jnp.asarray(color), jnp.asarray(mot),
                                      jnp.asarray(hist), jnp.float32(valid))
    got, new_hist = TT.taa_resolve(t(color), t(mot), t(hist),
                                   torch.tensor(valid))
    assert torch.equal(got, new_hist)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_taa_small_frames_take_the_gather():
    """Below 64 px the reference's gather runs on every device, no
    rejection."""
    rng = np.random.default_rng(5)
    h, w = 40, 56
    color = rng.uniform(size=(h, w, 3)).astype(np.float32)
    hist = rng.uniform(size=(h, w, 3)).astype(np.float32)
    mot = _motion(rng, h, w, 0.0, 15.0)
    want, _ = JT.taa_resolve(jnp.asarray(color), jnp.asarray(mot),
                             jnp.asarray(hist), jnp.float32(1.0))
    got, _ = TT.taa_resolve(t(color), t(mot), t(hist), torch.tensor(1.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def _denoise_inputs(rng, h, w, lo, hi):
    sig = rng.uniform(size=(h, w)).astype(np.float32)
    hist = rng.uniform(size=(h, w)).astype(np.float32)
    # smooth depth (most history kept), a sky patch (depth 0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (0.2 + 0.1 * np.sin(xx / 23.0) * np.cos(yy / 17.0)).astype(
        np.float32)
    depth[: h // 5, : w // 4] = 0.0
    prev = (depth * rng.uniform(0.97, 1.03, size=(h, w))).astype(np.float32)
    return sig, _motion(rng, h, w, lo, hi), hist, depth, prev


@pytest.mark.parametrize("h,w,lo,hi", [
    (128, 200, 0.0, 6.0),        # the warp branch, inside the reach
    (128, 200, 0.0, 20.0),       # the warp branch, beyond it in part
    (64, 96, 0.0, 10.0),         # min < 128: the half-res gather
    (63, 96, 0.0, 10.0),         # odd: the full-rate gather
])
def test_temporal_accumulate_matches_reference(h, w, lo, hi):
    rng = np.random.default_rng(h + w + int(hi))
    sig, mot, hist, depth, prev = _denoise_inputs(rng, h, w, lo, hi)
    args = [jnp.asarray(x) for x in (sig, mot, hist)]
    dargs = [jnp.asarray(depth), jnp.asarray(prev)]
    if min(h, w) >= 128 and hi > 6.0:
        want = _jax_accumulate_kernel_branch(*args, jnp.float32(1.0),
                                             *dargs)
    else:
        want = JD.temporal_accumulate(*args, jnp.float32(1.0), *dargs)
    got = TD.temporal_accumulate(t(sig), t(mot), t(hist), torch.tensor(1.0),
                                 t(depth), t(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_depth_aware_blur_and_denoise_match_reference():
    rng = np.random.default_rng(9)
    sig, mot, hist, depth, prev = _denoise_inputs(rng, 128, 160, 0.0, 5.0)
    want = JD.depth_aware_blur(jnp.asarray(sig), jnp.asarray(depth))
    got = TD.depth_aware_blur(t(sig), t(depth))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    jw, jh = JD.denoise_shadow(*(jnp.asarray(x) for x in (sig, mot, hist)),
                               jnp.float32(1.0), jnp.asarray(depth),
                               jnp.asarray(prev))
    tw, th = TD.denoise_shadow(t(sig), t(mot), t(hist), torch.tensor(1.0),
                               t(depth), t(prev))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=2e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=2e-5)


def _hdr(rng, h, w):
    """HDR radiance over several decades, some true black, a hot spot."""
    hdr = np.exp(rng.uniform(-8.0, 3.0, size=(h, w, 3))).astype(np.float32)
    hdr[:7, :9] = 0.0
    hdr[h // 2 - 2:h // 2 + 2, w // 2 - 2:w // 2 + 2] = 400.0
    return hdr


def test_exposure_matches_reference():
    rng = np.random.default_rng(3)
    hdr = _hdr(rng, 90, 160)
    hist_j = np.asarray(JE.luminance_histogram(jnp.asarray(hdr)))
    hist_t = TE.luminance_histogram(t(hdr))
    np.testing.assert_array_equal(hist_t.numpy(), hist_j)   # integer counts
    np.testing.assert_allclose(
        float(TE.average_log_luminance(hist_t)),
        float(JE.average_log_luminance(jnp.asarray(hist_j))), rtol=1e-5)
    for prev in (0.25, 3.0):
        je, jaux = JE.adapt_exposure(jnp.asarray(hdr), jnp.float32(prev))
        te, taux = TE.adapt_exposure(t(hdr), torch.tensor(prev))
        np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
        for k in ('avg_luminance', 'target_exposure'):
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=1e-5)


@pytest.mark.parametrize("h,w,mips", [(90, 160, 6), (67, 101, 6),
                                      (32, 48, 3)])
def test_bloom_matches_reference(h, w, mips):
    """Even and odd sizes (edge padding, cropped upsample), and a chain cut
    short by the 4-texel floor."""
    rng = np.random.default_rng(h * w)
    hdr = _hdr(rng, h, w)
    want = np.asarray(JB.bloom(jnp.asarray(hdr), num_mips=mips))
    got = TB.bloom(t(hdr), num_mips=mips)
    assert got.shape == (h, w, 3) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_compose_final_with_bloom_matches_reference():
    rng = np.random.default_rng(4)
    hdr = _hdr(rng, 48, 64)
    bl = np.asarray(JB.bloom(jnp.asarray(hdr)))
    want = np.asarray(JP.compose_final(jnp.asarray(hdr), 0.25,
                                       bloom=jnp.asarray(bl),
                                       bloom_strength=0.04)).astype(int)
    got = TP.compose_final(t(hdr), 0.25, bloom=t(bl),
                           bloom_strength=0.04).numpy().astype(int)
    assert np.abs(got - want).max() <= 1
    plain = TP.compose_final(t(hdr), 0.25).numpy().astype(int)
    assert (plain != got).any()                  # the lerp changes pixels
