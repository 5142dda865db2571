"""ctypes binding for the native C++ binned-SAH BVH builder.

Builds native/libsge_native.so on first use with native/build.sh (plain
ctypes binding; the library is portable x86-64, never tuned to the build
host's CPU). Produces the same BVHTopology contract
as the Python builders in render.bvh with SAH-quality splits — the highest
traversal quality / fastest host build combination.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .bvh import BVHTopology

_LIB = None
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "native")


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.join(_NATIVE_DIR, "libsge_native.so")
    src = os.path.join(_NATIVE_DIR, "bvh_builder.cpp")
    # Rebuild when the library is missing or older than its source, so a
    # library left over from another machine or revision is never loaded.
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        try:
            subprocess.run(["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                           check=True, capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            raise NativeBuildError(f"native/build.sh failed: {e}") from e
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise NativeBuildError(f"cannot load {so}: {e}") from e
    lib.build_bvh_sah.restype = ctypes.c_int32
    lib.build_bvh_sah.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ]
    _LIB = lib
    return lib


def build_bvh_sah(tri_min: np.ndarray, tri_max: np.ndarray,
                  leaf_size: int = 12) -> BVHTopology:
    lib = _load()
    t = len(tri_min)
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    # The C++ builder's contract is <= 2T+1 nodes for any input (every split
    # strictly reduces the range); an occupancy-based estimate under-allocates
    # on adversarial geometry (peel-1 SAH chains) and the builder memcpys all
    # m nodes before the Python-side assert runs.
    cap = 2 * t + 64

    def buf(dtype):
        return np.zeros(cap, dtype)

    skip, first, count = buf(np.int32), buf(np.int32), buf(np.int32)
    left, right, parent, depth = (buf(np.int32) for _ in range(4))
    order = np.zeros(t, np.int64)

    def p32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    m = lib.build_bvh_sah(
        tri_min.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        tri_max.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t, leaf_size, p32(skip), p32(first), p32(count), p32(left),
        p32(right), p32(parent), p32(depth),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    assert 0 < m <= cap, f"native builder returned {m} nodes (cap {cap})"

    skip, first, count = skip[:m], first[:m], count[:m]
    left, right, parent, depth = left[:m], right[:m], parent[:m], depth[:m]

    internal = np.nonzero(count == 0)[0]
    levels = []
    if len(internal):
        for d in range(int(depth[internal].max()), -1, -1):
            lv = internal[depth[internal] == d]
            if len(lv):
                levels.append(lv.astype(np.int32))

    leaf_slots = np.full((m, leaf_size), -1, np.int32)
    leaves = np.nonzero(count > 0)[0]
    for i in leaves:
        c = count[i]
        s = first[i]
        leaf_slots[i, :c] = np.arange(s, s + c)

    return BVHTopology(skip=skip, first_tri=first, tri_count=count,
                       left=left, right=right,
                       tri_order=order.astype(np.int32),
                       levels=tuple(levels), leaf_slots=leaf_slots)
