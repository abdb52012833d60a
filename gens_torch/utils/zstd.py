"""Zstandard decompression through the port's own decoder,
``gens_torch/native/zstd_decode.cpp`` (RFC 8878, host code), bound with
ctypes. It reads the zstd frames of an orbax checkpoint (OCDBT nodes and
zarr chunks) where neither ``zstandard`` nor tensorstore is installed, and
it is the only decoder the port uses: nothing falls back to another one.

The library is compiled with ``g++`` at first use into ``build/gens_torch/``
(:func:`gens_torch.mesh.isosurface.build_native`); a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from gens_torch.mesh.isosurface import build_native

# the counters of zstd_decode.cpp's ``Stat``, in its order
STAT_NAMES = ("frames", "skippable_frames", "raw_blocks", "rle_blocks",
              "compressed_blocks", "raw_literals", "rle_literals",
              "huffman_1_stream", "huffman_4_streams", "treeless_literals",
              "fse_weights", "direct_weights", "seq_predefined", "seq_rle",
              "seq_fse", "seq_repeat", "repeat_offsets", "checksums",
              "no_sequences")

_lib: Optional[ctypes.CDLL] = None


class ZstdError(ValueError):
    """A corrupt or unsupported zstd frame (a dictionary ID among them)."""


def build_library() -> str:
    """Compile gens_torch/native/zstd_decode.cpp unless built; returns the
    path."""
    return build_native("gens_torch/native/zstd_decode.cpp")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.zstd_decompress.restype = ctypes.c_void_p
        lib.zstd_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_char_p, ctypes.c_size_t]
        lib.zstd_free.restype = None
        lib.zstd_free.argtypes = [ctypes.c_void_p]
        lib.zstd_num_stats.restype = ctypes.c_int
        lib.zstd_num_stats.argtypes = []
        if lib.zstd_num_stats() != len(STAT_NAMES):
            raise RuntimeError("zstd_decode.cpp counts other features than "
                               "STAT_NAMES names")
        _lib = lib
    return _lib


def _decompress(data: bytes, stats: Optional[np.ndarray]) -> bytes:
    lib = _load()
    data = bytes(data)
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    sp = (None if stats is None
          else stats.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    ptr = lib.zstd_decompress(data, len(data), ctypes.byref(n), sp, err,
                              len(err))
    if not ptr:
        raise ZstdError(err.value.decode())
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.zstd_free(ptr)


def decompress(data: bytes) -> bytes:
    """The content of every frame in ``data``, concatenated (skippable
    frames skipped). Raises :class:`ZstdError` on a corrupt frame, a
    content checksum that does not match and a frame that names a
    dictionary."""
    return _decompress(data, None)


def decompress_with_stats(data: bytes) -> Tuple[bytes, Dict[str, int]]:
    """:func:`decompress` and the count of each format feature the frames
    used (blocks by type, literals by kind, sequence tables by mode, ...;
    :data:`STAT_NAMES`), for tests that show which paths an input takes."""
    stats = np.zeros(len(STAT_NAMES), np.uint64)
    out = _decompress(data, stats)
    return out, dict(zip(STAT_NAMES, (int(v) for v in stats)))
