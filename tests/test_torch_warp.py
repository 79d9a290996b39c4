"""The port's reprojection warp (K4's plain version) against the reference
package's Pallas warp kernel in interpret mode.

Same image and motion (seeded numpy) in both.  The plain version sums
each channel as the kernel does once the kernel's zero-weight taps are
left out (they add exact zeros), so the two agree to rounding: 1e-6
absolute on values in [0, 1), with motion inside the +-8 px reach and
beyond it (where both clamp the displacement).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops.warp_pallas import MAX_DISP as JAX_MAX_DISP
from toyrenderer_tpu.ops.warp_pallas import warp_bilinear as jax_warp

from toyrenderer_tpu_torch.ops import warp_cuda as W


def _inputs(h, w, c, reach, seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(h, w, c)).astype(np.float32)
    mot = rng.uniform(-reach, reach, size=(h, w, 2)).astype(np.float32)
    return img, mot


@pytest.mark.parametrize("h,w,c,reach", [
    (64, 1024, 3, 6.0),          # TAA's shape of input, inside the reach
    (64, 1024, 2, 20.0),         # the denoiser's, far beyond it
    (40, 600, 3, 9.5),           # not a multiple of the TPU tiles
])
def test_plain_warp_matches_pallas_kernel(h, w, c, reach):
    assert W.MAX_DISP == JAX_MAX_DISP
    img, mot = _inputs(h, w, c, reach, seed=h + w + c)
    want = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(mot),
                               interpret=True))
    got = W.warp_bilinear_plain(torch.from_numpy(img), torch.from_numpy(mot))
    assert got.shape == (h, w, c) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    img, mot = _inputs(48, 80, 3, 12.0, seed=1)
    before = W.launches
    got = W.warp_bilinear(torch.from_numpy(img), torch.from_numpy(mot))
    assert W.launches == before                  # no kernel on the CPU
    want = W.warp_bilinear_plain(torch.from_numpy(img), torch.from_numpy(mot))
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        W.warp_bilinear(torch.empty((4, 4, 3), device='meta'),
                        torch.empty((4, 4, 2), device='meta'))


def test_zero_motion_is_identity_and_edges_clamp():
    """No motion returns the image bit for bit; motion that points past
    the image's edge samples the edge."""
    img, _ = _inputs(16, 24, 2, 0.0, seed=2)
    zero = torch.zeros((16, 24, 2))
    assert torch.equal(W.warp_bilinear_plain(torch.from_numpy(img), zero),
                       torch.from_numpy(img))
    left = torch.zeros((16, 24, 2))
    left[..., 0] = 30.0                          # prev = x - 30 < 0
    out = W.warp_bilinear_plain(torch.from_numpy(img), left).numpy()
    # displacement clamped to the reach: x < 8 lands on column 0
    np.testing.assert_array_equal(out[:, :7], np.repeat(img[:, :1], 7, 1))
