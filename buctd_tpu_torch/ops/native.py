"""ctypes bindings of the host box NMS (csrc/host_nms.cpp).

Counterpart of buctd_tpu/ops/native.py (``cpu_nms`` :59, ``gpu_nms`` :76) and
the reference's compiled extensions (lib/nms/cpu_nms.pyx, gpu_nms.pyx +
nms_kernel.cu).  The port keeps its own copy of the JAX package's
native/nms.cpp; _build.py::build_host compiles it with the host C++ compiler
into ``buctd_tpu_torch/_build/`` at first use.  A failed build raises with the
compiler's message: there is no silent numpy fallback.  A caller who wants
numpy calls ops/nms.py::nms.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build


def _lib() -> ctypes.CDLL:
    """The built library (loaded once by _build), its two entry points typed."""
    lib = _build.load_host("host_nms")
    for name in ("buctd_cpu_nms", "buctd_mask_nms"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
                       ctypes.POINTER(ctypes.c_int)]
    return lib


def _call(fn, dets: np.ndarray, thresh: float) -> np.ndarray:
    keep = np.empty(len(dets), np.int32)
    num = fn(dets.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(dets),
             ctypes.c_float(thresh), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return keep[:num]


def cpu_nms(dets: np.ndarray, thresh: float) -> list:
    """Greedy box NMS over dets (N, 5) = (x1, y1, x2, y2, score), exact
    cpu_nms.pyx semantics: kept indices into ``dets``, in score order."""
    dets = np.ascontiguousarray(dets, np.float32)
    if len(dets) == 0:
        return []
    return _call(_lib().buctd_cpu_nms, dets, thresh).tolist()


def gpu_nms(dets: np.ndarray, thresh: float, device_id: int = 0) -> list:
    """The reference's gpu_nms surface (gpu_nms.pyx:16-34): sort by score
    (numpy's ``argsort()[::-1]``), the bitmask greedy over the sorted boxes,
    the ORIGINAL indices of the kept boxes.  ``device_id`` is accepted for
    the API; the bitmask scan runs on the host, as in the JAX package."""
    del device_id
    dets = np.ascontiguousarray(dets, np.float32)
    if len(dets) == 0:
        return []
    order = dets[:, 4].argsort()[::-1]
    keep = _call(_lib().buctd_mask_nms, np.ascontiguousarray(dets[order]), thresh)
    return order[keep].tolist()
