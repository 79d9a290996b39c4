"""The port's GTAO against the reference package's, on the same depth
and normals: the full-resolution AO at several rotation phases, and the
frame's AO pass -- half-resolution horizons (reverse-Z max-pooled depth,
mean-pooled normals), the nearest 2x expansion and the full-resolution
depth-aware blur (radius 2) -- as the reference's frame composes it
(frame.py:1125-1157).

The inputs: a cornell camera at 192x108, a smooth reverse-Z depth field
made from a seed with numpy (a corner of sky, depth 0), and the normals
of the world positions it gives (finite differences).  Tolerance: AO
within 1e-4 on >= 99.9% of the pixels and within 2e-3 everywhere.  The
horizon cosines round differently in the two packages (XLA fuses some
products into multiply-adds) and the arc integral takes arccos of them,
whose slope grows without bound as a cosine nears 1; the rare pixel with
a horizon at grazing angle carries that ulp into the 1e-3 range.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyrenderer_tpu.engine import View as JView
from toyrenderer_tpu.mathlib.transforms import normalize
from toyrenderer_tpu.ops import denoise as JD
from toyrenderer_tpu.ops import gtao as JA
from toyrenderer_tpu.ops.lighting import world_pos_from_depth
from toyrenderer_tpu.scene import load_scene as jax_load_scene

from test_torch_raster import _one_torch_thread  # noqa: F401
from toyrenderer_tpu_torch.engine.frame import _ambient_occlusion
from toyrenderer_tpu_torch.ops import gtao as TA

W, H = 192, 108


@pytest.fixture(scope="module")
def inputs():
    sh = jax_load_scene("resources/cornell.gltf", use_cache=False)
    mats = JView.from_scene(sh, W, H).matrices()
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    a = rng.uniform(0.5, 2.0, 4)
    depth = (0.02 + 0.006 * np.sin(xx / W * a[0] * 6 + a[1])
             * np.cos(yy / H * a[2] * 6 + a[3])
             + 0.01 * (xx > W * 0.6) * (yy > H * 0.5)       # a step
             + 0.003 * xx / W).astype(np.float32)
    depth[:H // 5, :W // 6] = 0.0                           # sky
    ivp = np.asarray(mats['inv_view_proj'], np.float32)
    with np.errstate(all='ignore'):       # sky: depth 0, no position
        wp = np.asarray(world_pos_from_depth(jnp.asarray(depth),
                                             jnp.asarray(ivp), W, H))
        n = np.cross(np.gradient(wp, axis=1), np.gradient(wp, axis=0))
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    n[~np.isfinite(n).all(-1) | (depth == 0)] = (0.0, 1.0, 0.0)
    cam = np.asarray(mats['cam_pos'], np.float32)
    return depth, n.astype(np.float32), cam, ivp


def _close(got, want):
    diff = np.abs(got - want)
    assert (diff <= 1e-4).mean() >= 0.999, (diff <= 1e-4).mean()
    assert diff.max() <= 2e-3, diff.max()


@pytest.mark.parametrize("frame", [0, 3, 5])
def test_gtao_matches_reference(inputs, frame):
    depth, n, cam, ivp = inputs
    want = np.asarray(jax.jit(JA.gtao)(
        jnp.asarray(depth), jnp.asarray(n), jnp.asarray(cam),
        jnp.asarray(ivp), jnp.asarray(frame, jnp.int32)))
    got = TA.gtao(torch.from_numpy(depth), torch.from_numpy(n),
                  torch.from_numpy(cam), torch.from_numpy(ivp),
                  torch.tensor(frame, dtype=torch.int32)).numpy()
    _close(got, want)
    assert (got[depth == 0] == 1.0).all()
    hit = got[depth > 0]
    assert 0.0 <= hit.min() and hit.max() <= 1.0 and hit.mean() < 0.99


def test_frame_ao_pass_matches_reference(inputs):
    """Half-res horizons, the 2x expansion and the depth-aware blur."""
    depth, n, cam, ivp = inputs
    frame = 6
    want = np.asarray(jax.jit(_reference_ao_pass)(
        jnp.asarray(depth), jnp.asarray(n), jnp.asarray(cam),
        jnp.asarray(ivp), jnp.asarray(frame, jnp.int32)))
    got = _ambient_occlusion(
        torch.from_numpy(depth), torch.from_numpy(n),
        dict(cam_pos=torch.from_numpy(cam),
             inv_view_proj=torch.from_numpy(ivp)),
        torch.tensor(frame, dtype=torch.int32), radius=1.5,
        half_res=True).numpy()
    _close(got, want)
    assert 0.0 < got.mean() < 1.0


def _reference_ao_pass(d, n, cam, ivp, frame):
    """The reference frame's AO block (frame.py:1125-1157)."""
    d_h = jax.lax.reduce_window(d, -jnp.inf, jax.lax.max, (2, 2), (2, 2),
                                'VALID')
    n_h = normalize(jax.lax.reduce_window(n, 0.0, jax.lax.add, (2, 2, 1),
                                          (2, 2, 1), 'VALID') * 0.25)
    ao_h = JA.gtao(d_h, n_h, cam, ivp, frame, radius=1.5)
    ao = jnp.broadcast_to(ao_h[:, None, :, None],
                          (H // 2, 2, W // 2, 2)).reshape(H, W)
    return JD.depth_aware_blur(ao, d, radius=2)
