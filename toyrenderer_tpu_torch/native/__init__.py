"""Native (C++) host-side builders, compiled with g++ at first use.

The four sources are the JAX package's own host builders, copied so the
port imports nothing of it: the EXT_meshopt_compression codecs, the
greedy meshlet builder, the quadric simplifier and the binned-SAH 8-wide
tree builder of the GI tree.  There is no Python
fallback: a fallback would produce other meshlets and LODs than the
reference scene (and the SAH tree the reference's native builder
gives), so a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from toyrenderer_tpu_torch._build import shared_library

_DIR = Path(__file__).parent
_GXX = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17"]


def _load(src: str) -> ctypes.CDLL:
    so = shared_library(_GXX, _DIR / src, "_" + src.replace(".cpp", ".so"))
    return ctypes.CDLL(str(so))


@functools.lru_cache(maxsize=1)
def simplify_lib() -> ctypes.CDLL:
    """ctypes handle to the quadric simplifier."""
    lib = _load("simplify.cpp")
    lib.simplify_qem.restype = ctypes.c_int64
    lib.simplify_qem.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,   # indices, n_idx
        ctypes.c_void_p, ctypes.c_void_p,  # positions, normals
        ctypes.c_int64,                    # n_verts
        ctypes.c_int64,                    # target_idx
        ctypes.c_float,                    # normal_weight
        ctypes.c_void_p, ctypes.c_void_p,  # out_indices, out_error
    ]
    return lib


@functools.lru_cache(maxsize=1)
def meshopt_lib() -> ctypes.CDLL:
    """ctypes handle to the EXT_meshopt_compression codecs."""
    lib = _load("meshopt_codec.cpp")
    fn = lib.mcodec_encode_vertex_buffer
    fn.restype = ctypes.c_ssize_t
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                   ctypes.c_size_t, ctypes.c_size_t]
    for name in ("mcodec_encode_index_buffer",
                 "mcodec_encode_index_sequence"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_ssize_t
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                       ctypes.c_size_t]
    fn = lib.mcodec_decode_vertex_buffer
    fn.restype = ctypes.c_ssize_t
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                   ctypes.c_void_p, ctypes.c_size_t]
    for name in ("mcodec_decode_index_buffer",
                 "mcodec_decode_index_sequence"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_ssize_t
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                       ctypes.c_size_t]
    for name in ("mcodec_decode_filter_oct", "mcodec_decode_filter_quat",
                 "mcodec_decode_filter_exp"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t]
    return lib


@functools.lru_cache(maxsize=1)
def meshlet_lib() -> ctypes.CDLL:
    """ctypes handle to the meshlet builder."""
    lib = _load("meshlet.cpp")
    lib.build_meshlets.restype = ctypes.c_int64
    lib.build_meshlets.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,   # indices, n_tris
        ctypes.c_void_p, ctypes.c_int64,   # positions, n_verts
        ctypes.c_void_p, ctypes.c_void_p,  # out_tris, out_tri_count
        ctypes.c_void_p, ctypes.c_void_p,  # out_center, out_radius
        ctypes.c_void_p, ctypes.c_void_p,  # out_axis, out_cutoff
        ctypes.c_int64,                    # max_meshlets
    ]
    return lib


@functools.lru_cache(maxsize=1)
def sah_lib() -> ctypes.CDLL:
    """ctypes handle to the binned-SAH 8-wide BVH builder."""
    lib = _load("sah.cpp")
    lib.build_sah8.restype = ctypes.c_int64
    lib.build_sah8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,      # tlo, thi
        ctypes.c_int64,                        # n
        ctypes.c_int32, ctypes.c_int32,        # leaf_tris, nbins
        ctypes.c_int64, ctypes.c_int64,        # max_nodes, max_leaves
        ctypes.c_void_p, ctypes.c_void_p,      # out_child, out_axis
        ctypes.c_void_p, ctypes.c_void_p,      # out_leaf, out_counts
    ]
    return lib
