"""Native (C++) runtime components, loaded via ctypes.

Provides accelerated host-side pieces analogous to the reference's native
runtime (PNG encoding, BVH/morton build). Pure-Python fallbacks live in
utils/; importing a symbol raises if the shared library hasn't been built
(run ``make -C native`` / ``python -m rust_ray_tracer_tpu.native.build``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None


def build(force: bool = False) -> str:
    """Compile librrt_native.so via make; returns the path. ``force``
    rebuilds even when the library looks up to date (a copied tree can
    carry a library built for another machine)."""
    import subprocess

    here = os.path.dirname(__file__)
    path = os.path.join(here, "librrt_native.so")
    if force or not os.path.exists(path):
        subprocess.run(["make", "-B", "-C", here] if force
                       else ["make", "-C", here], check=True,
                       capture_output=True)
    return path


def _lib():
    global _LIB
    if _LIB is None:
        here = os.path.dirname(__file__)
        path = os.path.join(here, "librrt_native.so")
        if not os.path.exists(path):
            try:
                build()
            except Exception as e:
                raise ImportError(f"librrt_native.so not built: {e}") from e
        _LIB = ctypes.CDLL(path)
        _LIB.rrt_png_encode.restype = ctypes.c_longlong
        _LIB.rrt_png_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
        _LIB.rrt_morton_sort.restype = None
        _LIB.rrt_morton_sort.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        _LIB.rrt_lbvh_build.restype = None
        _LIB.rrt_lbvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
    return _LIB


def png_encode_native(rgb: np.ndarray) -> bytes:
    """Encode [H,W,3] u8 to PNG via the C++ encoder."""
    lib = _lib()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    cap = h * (w * 3 + 1) + (1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.rrt_png_encode(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n <= 0:
        raise RuntimeError("native png encode failed")
    return out[:n].tobytes()


def morton_sort_native(centroids: np.ndarray) -> np.ndarray:
    """Sort primitive centroids along a Morton curve; returns the
    permutation (int32 [N])."""
    lib = _lib()
    c = np.ascontiguousarray(centroids, np.float32)
    n = c.shape[0]
    perm = np.empty(n, np.int32)
    lib.rrt_morton_sort(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return perm


def lbvh_build_native(aabb_min: np.ndarray, aabb_max: np.ndarray):
    """Binary radix LBVH over Morton-SORTED leaf boxes.

    Returns (left [n-1], right [n-1], node_min [2n-1,3], node_max
    [2n-1,3]); node ids: internal [0, n-1), leaf i at (n-1)+i; root 0.
    """
    lib = _lib()
    mn = np.ascontiguousarray(aabb_min, np.float32)
    mx = np.ascontiguousarray(aabb_max, np.float32)
    n = mn.shape[0]
    left = np.zeros(max(n - 1, 1), np.int32)
    right = np.zeros(max(n - 1, 1), np.int32)
    node_min = np.zeros((2 * n - 1, 3), np.float32)
    node_max = np.zeros((2 * n - 1, 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rrt_lbvh_build(mn.ctypes.data_as(fp), mx.ctypes.data_as(fp), n,
                       left.ctypes.data_as(ip), right.ctypes.data_as(ip),
                       node_min.ctypes.data_as(fp),
                       node_max.ctypes.data_as(fp))
    return left[:n - 1], right[:n - 1], node_min, node_max
