"""EXT_meshopt_compression codecs (numpy in/out).

Counterpart of toyrenderer_tpu/scene/meshopt.py: the decoders the glTF
loader runs, and the encoders tools/gen_scene.py writes compressed
assets with (native/meshopt_codec.cpp's, through ctypes).  Modes map per
the extension spec: ATTRIBUTES -> vertex codec, TRIANGLES -> index codec,
INDICES -> index sequence codec; filters OCTAHEDRAL / QUATERNION /
EXPONENTIAL post-process decoded elements.
"""

from __future__ import annotations

import numpy as np

from toyrenderer_tpu_torch.native import meshopt_lib


class MeshoptError(RuntimeError):
    pass


def encode_vertex_buffer(data: np.ndarray) -> bytes:
    """data: (count, stride_bytes) u8 -> compressed bytes."""
    data = np.ascontiguousarray(data, np.uint8)
    count, stride = data.shape
    cap = 1 + count * stride * 2 + max(stride, 32) + 1024
    out = np.zeros(cap, np.uint8)
    n = meshopt_lib().mcodec_encode_vertex_buffer(
        out.ctypes.data, cap, data.ctypes.data, count, stride)
    if n < 0:
        raise MeshoptError("vertex encode failed")
    return out[:n].tobytes()


def encode_index_buffer(indices: np.ndarray) -> bytes:
    """Triangle indices (a multiple of 3, u32) -> compressed bytes."""
    idx = np.ascontiguousarray(indices.reshape(-1), np.uint32)
    cap = 1 + len(idx) * 6 + 16 + 1024
    out = np.zeros(cap, np.uint8)
    n = meshopt_lib().mcodec_encode_index_buffer(
        out.ctypes.data, cap, idx.ctypes.data, len(idx))
    if n < 0:
        raise MeshoptError("index encode failed")
    return out[:n].tobytes()


def encode_index_sequence(indices: np.ndarray) -> bytes:
    """Any index sequence (u32) -> compressed bytes."""
    idx = np.ascontiguousarray(indices.reshape(-1), np.uint32)
    cap = 1 + len(idx) * 5 + 64
    out = np.zeros(cap, np.uint8)
    n = meshopt_lib().mcodec_encode_index_sequence(
        out.ctypes.data, cap, idx.ctypes.data, len(idx))
    if n < 0:
        raise MeshoptError("index sequence encode failed")
    return out[:n].tobytes()


def decode_vertex_buffer(src: bytes, count: int, stride: int) -> np.ndarray:
    buf = np.frombuffer(src, np.uint8)
    out = np.zeros((count, stride), np.uint8)
    n = meshopt_lib().mcodec_decode_vertex_buffer(
        out.ctypes.data, count, stride, buf.ctypes.data, len(buf))
    if n < 0:
        raise MeshoptError("vertex decode failed")
    return out


def decode_index_buffer(src: bytes, count: int,
                        stride: int = 4) -> np.ndarray:
    """Returns (count,) u32 (or u16 downcast if stride == 2)."""
    buf = np.frombuffer(src, np.uint8)
    out = np.zeros(count, np.uint32)
    n = meshopt_lib().mcodec_decode_index_buffer(
        out.ctypes.data, count, buf.ctypes.data, len(buf))
    if n < 0:
        raise MeshoptError("index decode failed")
    return out.astype(np.uint16) if stride == 2 else out


def decode_index_sequence(src: bytes, count: int,
                          stride: int = 4) -> np.ndarray:
    buf = np.frombuffer(src, np.uint8)
    out = np.zeros(count, np.uint32)
    n = meshopt_lib().mcodec_decode_index_sequence(
        out.ctypes.data, count, buf.ctypes.data, len(buf))
    if n < 0:
        raise MeshoptError("index sequence decode failed")
    return out.astype(np.uint16) if stride == 2 else out


def apply_filter(data: np.ndarray, name: str) -> np.ndarray:
    """In-place post-decode filter on (count, stride) u8 elements."""
    data = np.ascontiguousarray(data, np.uint8)
    count, stride = data.shape
    lib = meshopt_lib()
    if name == "OCTAHEDRAL":
        lib.mcodec_decode_filter_oct(data.ctypes.data, count, stride)
    elif name == "QUATERNION":
        lib.mcodec_decode_filter_quat(data.ctypes.data, count, stride)
    elif name == "EXPONENTIAL":
        lib.mcodec_decode_filter_exp(data.ctypes.data, count, stride)
    elif name and name != "NONE":
        raise MeshoptError(f"unknown meshopt filter {name!r}")
    return data


def decode_buffer_view(mc: dict, compressed: bytes) -> bytes:
    """Decode one EXT_meshopt_compression bufferView extension object.

    mc: the extension dict (mode, filter, count, byteStride,
    byteOffset, byteLength); compressed: the owning buffer's bytes.
    Returns count*byteStride bytes.
    """
    off = mc.get("byteOffset", 0)
    src = compressed[off:off + mc["byteLength"]]
    count = mc["count"]
    stride = mc["byteStride"]
    mode = mc.get("mode", "ATTRIBUTES")
    if mode == "ATTRIBUTES":
        out = decode_vertex_buffer(src, count, stride)
        out = apply_filter(out, mc.get("filter", "NONE"))
        return out.tobytes()
    if mode == "TRIANGLES":
        return decode_index_buffer(src, count, stride).tobytes()
    if mode == "INDICES":
        return decode_index_sequence(src, count, stride).tobytes()
    raise MeshoptError(f"unknown meshopt mode {mode!r}")
