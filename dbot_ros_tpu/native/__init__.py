"""Native (C++) host-runtime components with graceful Python fallbacks.

The reference implements its host plumbing (mesh loading, image conversion,
frame buffering) in C++; here the equivalents live in ``host_runtime.cpp``
compiled to a shared library and bound via ctypes. The library is not
committed: :func:`load_native` builds it from the source at first use when
``g++`` is present (or build it ahead with
``python -m dbot_ros_tpu.native.build``). Every entry point has a
pure-Python/NumPy fallback so the framework works without it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_LIB_TRIED = False


def _lib_path() -> str:
    return os.path.join(os.path.dirname(__file__), "libdbot_host.so")


def _ensure_built(path: str) -> bool:
    """Build the library from ``host_runtime.cpp`` if it is missing or
    older than the source; False when it cannot be built here."""
    src = os.path.join(os.path.dirname(path), "host_runtime.cpp")
    if (os.path.exists(path)
            and os.path.getmtime(path) >= os.path.getmtime(src)):
        return True
    from dbot_ros_tpu.native import build

    try:
        build.build(verbose=False)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(path)


def load_native():
    """Load (and cache) the native library, building it at first use;
    None when it is unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _lib_path()
    if not _ensure_built(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.dbot_parse_obj.restype = ctypes.c_int
        lib.dbot_parse_obj.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_void_p),  # out vertices
            ctypes.POINTER(ctypes.c_longlong),  # out n_vertices
            ctypes.POINTER(ctypes.c_void_p),  # out faces
            ctypes.POINTER(ctypes.c_longlong),  # out n_faces
        ]
        lib.dbot_free.restype = None
        lib.dbot_free.argtypes = [ctypes.c_void_p]
        lib.dbot_preprocess_depth.restype = ctypes.c_int
        lib.dbot_preprocess_depth.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def _bind_ring(lib):
    lib.dbot_ring_create.restype = ctypes.c_void_p
    lib.dbot_ring_create.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.dbot_ring_destroy.restype = None
    lib.dbot_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.dbot_ring_push.restype = ctypes.c_int
    lib.dbot_ring_push.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_double]
    lib.dbot_ring_pop_latest.restype = ctypes.c_longlong
    lib.dbot_ring_pop_latest.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_float),
                                         ctypes.POINTER(ctypes.c_double)]
    lib.dbot_ring_size.restype = ctypes.c_longlong
    lib.dbot_ring_size.argtypes = [ctypes.c_void_p]


class FrameRing:
    """SPSC depth-frame ring buffer (native; ref: the camera-callback ↔
    tracker-thread decoupling in ObjectTrackerRos, R5/P4).

    Drop-oldest semantics: a tracker wants the freshest frame. Falls back
    to a plain Python deque when the native library is absent.
    """

    def __init__(self, frame_shape, capacity: int = 8):
        self.frame_shape = tuple(frame_shape)
        self.frame_floats = int(np.prod(frame_shape))
        self.capacity = capacity
        lib = load_native()
        self._lib = None
        self._ring = None
        if lib is not None:
            _bind_ring(lib)
            ring = lib.dbot_ring_create(self.frame_floats, capacity)
            if ring:
                self._lib, self._ring = lib, ring
        if self._ring is None:
            from collections import deque
            self._deque = deque(maxlen=capacity)

    @property
    def is_native(self) -> bool:
        return self._ring is not None

    def push(self, frame: np.ndarray, stamp: float = 0.0):
        frame = np.ascontiguousarray(frame, np.float32)
        if self._ring is not None:
            self._lib.dbot_ring_push(
                self._ring,
                frame.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                float(stamp))
        else:
            self._deque.append((frame.copy(), float(stamp)))

    def pop_latest(self):
        """→ (frame, stamp, skipped) or None if empty."""
        if self._ring is not None:
            out = np.empty(self.frame_shape, np.float32)
            stamp = ctypes.c_double()
            skipped = self._lib.dbot_ring_pop_latest(
                self._ring,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(stamp))
            if skipped < 0:
                return None
            return out, stamp.value, int(skipped)
        if not self._deque:
            return None
        skipped = len(self._deque) - 1
        while len(self._deque) > 1:
            self._deque.popleft()
        frame, stamp = self._deque.popleft()
        return frame, stamp, skipped

    def __len__(self):
        if self._ring is not None:
            return int(self._lib.dbot_ring_size(self._ring))
        return len(self._deque)

    def __del__(self):
        if getattr(self, "_ring", None) is not None:
            self._lib.dbot_ring_destroy(self._ring)
            self._ring = None


def try_parse_obj_native(path: str):
    """Parse an OBJ with the native parser → (V (n,3) f64, F (m,3) i64)|None."""
    lib = load_native()
    if lib is None:
        return None
    vp = ctypes.c_void_p()
    fp = ctypes.c_void_p()
    nv = ctypes.c_longlong()
    nf = ctypes.c_longlong()
    rc = lib.dbot_parse_obj(path.encode(), ctypes.byref(vp), ctypes.byref(nv),
                            ctypes.byref(fp), ctypes.byref(nf))
    if rc != 0:
        return None
    try:
        v = np.ctypeslib.as_array(
            ctypes.cast(vp, ctypes.POINTER(ctypes.c_double)),
            shape=(nv.value, 3)).copy()
        f = np.ctypeslib.as_array(
            ctypes.cast(fp, ctypes.POINTER(ctypes.c_longlong)),
            shape=(nf.value, 3)).copy()
    finally:
        lib.dbot_free(vp)
        lib.dbot_free(fp)
    return v, f


def preprocess_depth_u16(depth_mm: np.ndarray, downsampling: int,
                         invalid_value: float = float("nan")) -> np.ndarray:
    """uint16 millimeter depth → float32 meters, downsampled, NaN-sanitized.

    Native when available (SIMD-friendly strided loop in C++), NumPy
    otherwise. Mirrors the reference's ``ri::to_eigen`` conversion
    (dbot_ros ros_interface.h) which downsamples by strided pixel picking.
    """
    h, w = depth_mm.shape
    oh, ow = h // downsampling, w // downsampling
    lib = load_native()
    if lib is not None and depth_mm.dtype == np.uint16:
        src = np.ascontiguousarray(depth_mm)
        out = np.empty((oh, ow), np.float32)
        rc = lib.dbot_preprocess_depth(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            h, w, downsampling, int(0),
            ctypes.c_float(invalid_value),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc == 0:
            return out
    d = depth_mm[::downsampling, ::downsampling][:oh, :ow].astype(np.float32)
    d = d / 1000.0
    d[d <= 0.0] = invalid_value
    return d
