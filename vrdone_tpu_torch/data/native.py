# Copy of vrdone_tpu/data/native.py, kept so that the port imports nothing of
# vrdone_tpu; tests/test_torch_copies.py pins it to the original.
"""ctypes bindings for the native host-side tracklet ops
(native/tracklet_ops.cpp), with numpy fallbacks when the shared library has
not been built. Build with: bash native/build.sh
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                        "libtracklet_ops.so")
    path = os.path.abspath(path)
    if not os.path.exists(path):
        _LIB = False
        return _LIB
    lib = ctypes.CDLL(path)
    lib.viou_dedup.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_uint8)]
    lib.viou_dedup.restype = None
    lib.pack_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
    lib.pack_pairs.restype = None
    lib.pack_pairs_nz.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
    lib.pack_pairs_nz.restype = None
    _LIB = lib
    return _LIB


def have_native() -> bool:
    return bool(_load())


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def viou_dedup(bboxes_list: list[np.ndarray], durations: np.ndarray,
               cat_ids: np.ndarray, viou_thr: float = 0.9) -> np.ndarray:
    """Containment dedup of same-category tracklets; returns (n,) bool keep
    mask. Native when built, else the numpy sweep in datasets._test_pairs
    is used by the caller."""
    lib = _load()
    n = len(bboxes_list)
    if not lib:
        raise RuntimeError("native library not built")
    boxes = np.ascontiguousarray(
        np.concatenate(bboxes_list, axis=0), dtype=np.float32)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in bboxes_list], out=offsets[1:])
    durations = np.ascontiguousarray(durations, dtype=np.int64)
    cat_ids = np.ascontiguousarray(cat_ids, dtype=np.int64)
    valid = np.zeros(n, np.uint8)
    lib.viou_dedup(_ptr(boxes, ctypes.c_float), _ptr(offsets, ctypes.c_int64),
                   _ptr(durations, ctypes.c_int64),
                   _ptr(cat_ids, ctypes.c_int64),
                   n, viou_thr, _ptr(valid, ctypes.c_uint8))
    return valid.astype(bool)


def pack_pairs(features: list[np.ndarray], pack: int, t: int,
               c: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack ragged (T_i, C) features into ((pack, t, c), (pack, t) bool).

    Zero-copy-padding: the outputs come from np.zeros (calloc), and the
    native side only writes payload rows (pack_pairs_nz) — padding stays
    on kernel zero pages, so the host-memory traffic is the payload, not
    the full buffer."""
    lib = _load()
    if not lib:
        raise RuntimeError("native library not built")
    n = len(features)
    feats = [np.ascontiguousarray(f, dtype=np.float32) for f in features]
    ptrs = (ctypes.POINTER(ctypes.c_float) * max(n, 1))(
        *[f.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
          for f in feats] or [ctypes.POINTER(ctypes.c_float)()])
    lens = np.asarray([f.shape[0] for f in feats] or [0], np.int64)
    out = np.zeros((pack, t, c), np.float32)
    mask = np.zeros((pack, t), np.uint8)
    lib.pack_pairs_nz(ptrs, _ptr(lens, ctypes.c_int64),
                      n, pack, t, c, _ptr(out, ctypes.c_float),
                      _ptr(mask, ctypes.c_uint8))
    return out, mask.astype(bool)
