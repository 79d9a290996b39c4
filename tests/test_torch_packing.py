"""The packed GBuffer's codecs (ops/packing.py) against the reference
package's, bit for bit: the four packers on random and edge inputs (0,
1, out of range, negative, zero-length and axis-aligned normals) give
the same u32 words, and the four unpackers give the same floats on
random words and on every edge word.  Then `unpack_gbuffer` of packed
planes against the reference's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyrenderer_tpu.ops import gbuffer as JG
from toyrenderer_tpu.ops import packing as JP

from toyrenderer_tpu_torch.ops import gbuffer as TG
from toyrenderer_tpu_torch.ops import packing as TP


def _words(a) -> np.ndarray:
    """A packer's result as u32 (the port holds u32 bits in int32)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.int64).astype(np.uint32) if a.dtype == np.int64 \
        else a.view(np.uint32) if a.dtype == np.int32 else a


def _unit_edges() -> np.ndarray:
    """Axis-aligned, diagonal, zero-length and signed-zero vectors."""
    e = [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
         [0, 0, 1], [0, 0, -1], [-0.0, 0, -1], [0.0, -0.0, 0.0]]
    s = 1 / np.sqrt(3.0)
    e += [[sx * s, sy * s, sz * s] for sx in (-1, 1) for sy in (-1, 1)
          for sz in (-1, 1)]
    e += [[0.6, 0.8, 0], [0, -0.6, -0.8], [1e-30, 0, -1e-30]]
    return np.asarray(e, np.float32)


def _vectors(rng) -> np.ndarray:
    v = rng.normal(size=(4096, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return np.concatenate([v, _unit_edges()])


def _colours(rng) -> np.ndarray:
    c = rng.uniform(-0.25, 1.25, size=(4096, 4)).astype(np.float32)
    ramp = np.linspace(0.0, 1.0, 1024, dtype=np.float32)   # every step
    edges = np.asarray([[0, 1, -1, 2], [0.5, 1 / 255, 254.5 / 255, 1e-8],
                        [1 / 1023, 0.5 / 1023, 1022.5 / 1023, 1 / 3],
                        [-0.0, 0.99999994, 1.0000001, 0.5 / 3]],
                       np.float32)
    return np.concatenate([c, np.repeat(ramp[:, None], 4, 1), edges])


PACKERS = {
    'pack_normal_oct_u32': _vectors,
    'pack_unit_vector_r10g10b10': _vectors,
    'pack_rgba8_u32': _colours,
    'pack_r10g10b10a2_u32': _colours,
}


@pytest.mark.parametrize("name", sorted(PACKERS))
def test_packer_matches_reference(name):
    x = PACKERS[name](np.random.default_rng(7))
    want = _words(getattr(JP, name)(jnp.asarray(x)))
    got = getattr(TP, name)(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_words(got), want)


def _random_words(rng) -> np.ndarray:
    u = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    edges = [0, 1, 0xFFFF, 0x10000, 0xFFFF0000, 0x7FFFFFFF, 0x80000000,
             0xFFFFFFFF, 0x3FF, 0x3FF << 10, 0x3FF << 20, 3 << 30,
             0x7FFF7FFF, 0x80008000]
    return np.concatenate([u, np.asarray(edges, np.uint64)]).astype(
        np.uint32)


@pytest.mark.parametrize("name", [
    'unpack_normal_oct_u32', 'unpack_unit_vector_r10g10b10',
    'unpack_rgba8_u32', 'unpack_r10g10b10a2_u32'])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_unpacker_matches_reference(name, dtype):
    u = _random_words(np.random.default_rng(11))
    want = np.asarray(getattr(JP, name)(jnp.asarray(u)))
    src = (torch.from_numpy(u.view(np.int32)) if dtype == torch.int32
           else torch.from_numpy(u.astype(np.int64)))
    got = getattr(TP, name)(src).numpy()
    np.testing.assert_array_equal(got, want)


def test_round_trip_through_the_codecs():
    rng = np.random.default_rng(5)
    n = torch.from_numpy(_vectors(rng)[:4096])
    back = TP.unpack_normal_oct_u32(TP.pack_normal_oct_u32(n))
    assert float((back - n).abs().max()) < 1e-4
    c = torch.from_numpy(rng.uniform(0, 1, (512, 4)).astype(np.float32))
    assert float((TP.unpack_rgba8_u32(TP.pack_rgba8_u32(c)) - c).abs().max()
                 ) <= 0.5 / 255 + 1e-7


def test_unpack_gbuffer_of_packed_planes():
    """The packed GBuffer's four words (random, plus words of real
    colours and normals) unpack to the reference's shading inputs."""
    rng = np.random.default_rng(3)
    h, w = 16, 24
    planes = {f'gbuffer{i}': rng.integers(0, 2 ** 32, (h, w),
                                          dtype=np.uint64).astype(np.uint32)
              for i in range(4)}
    planes['gbuffer1'][0] = np.asarray(JP.pack_normal_oct_u32(
        jnp.asarray(_vectors(rng)[:w])))
    planes['gbuffer2'][1] = np.asarray(JP.pack_rgb9e5_u32(jnp.asarray(
        rng.uniform(0, 8, (w, 3)).astype(np.float32))))
    depth = rng.uniform(0, 1, (h, w)).astype(np.float32)
    want = JG.unpack_gbuffer(dict({k: jnp.asarray(v)
                                   for k, v in planes.items()},
                                  depth=jnp.asarray(depth)))
    got = TG.unpack_gbuffer(dict({k: torch.from_numpy(v.view(np.int32))
                                  for k, v in planes.items()},
                                 depth=torch.from_numpy(depth)))
    assert got.keys() == want.keys()
    for k in want:
        if k == 'emissive':
            # the reference's CPU exp2 is inexact at integer exponents
            # (ROADMAP queue 3); the port builds 2^e from its bits
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=2e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
