"""ctypes binding of the native C++ loader core (``native/loader.cc``):
threaded JPEG decode + bbox crop + bilinear resize into fixed-size uint8
RGB batches.

Counterpart of pytorch_pose_estimation_tpu/data/native_loader.py, with its
own build: at first use the source is compiled with g++ and the flags of
``native/Makefile`` into ``build/native/<hash of the source and
flags>/libppe_loader.so`` (a lock, a directory per hash, an atomic rename,
as ``ops/kernels.py`` builds the CUDA kernels).  The library that ``make -C
native`` leaves in ``native/`` is never loaded, and nothing is written
there.  Importing this module builds nothing.

``available()`` tries the build once and caches the outcome; when it
failed, ``build_error()`` holds the compiler's message.  The data modules
take the native path when ``use_native`` is None and the library is
available, or when ``use_native`` is True; otherwise cv2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "loader.cc"
_BUILD_ROOT = _REPO / "build" / "native"
# native/Makefile's CXXFLAGS (less -Wall) and LDFLAGS
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17")
_LD_FLAGS = ("-shared", "-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_tried = False
_lock = threading.Lock()


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_CXX_FLAGS + _LD_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _build(so: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native loader is "
                           f"built from {_SOURCE} with g++ at first use")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = [cxx, *_CXX_FLAGS, str(_SOURCE), "-o", str(tmp), *_LD_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native loader build failed:\n$ {' '.join(cmd)}"
                           f"\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or none


def _load() -> None:
    """Build (if needed) and load the library, once per process."""
    global _lib, _error, _tried
    with _lock:
        if _tried:
            return
        _tried = True
        try:
            so = _BUILD_ROOT / _source_hash() / "libppe_loader.so"
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError) as e:
            _error = str(e)
            return
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.ppe_batch_decode_crop_resize.restype = ctypes.c_int
        lib.ppe_batch_decode_crop_resize.argtypes = [
            ctypes.c_int,                      # n
            u8p,                               # blobs
            ctypes.POINTER(ctypes.c_int64),    # offsets
            ip,                                # lens
            ip,                                # boxes
            ctypes.c_int, ctypes.c_int,        # out_h, out_w
            u8p,                               # out
            ctypes.c_int,                      # n_threads
        ]
        lib.ppe_decode_jpeg.restype = ctypes.c_int
        lib.ppe_decode_jpeg.argtypes = [u8p, ctypes.c_int, u8p, ctypes.c_int,
                                        ip, ip]
        _lib = lib


def available() -> bool:
    """Whether the library is built and loaded (building it on the first
    call)."""
    _load()
    return _lib is not None


def build_error() -> Optional[str]:
    """Why the library is not available (the compiler's message), or
    None."""
    _load()
    return _error


def _require() -> ctypes.CDLL:
    if not available():
        raise RuntimeError(f"native loader not available: {_error}")
    return _lib


def resolve_use_native(use_native: Optional[bool]) -> bool:
    """A data module's ``use_native``: None = native when the library is
    available, True = native (raises with the build's error when it is
    not), False = cv2."""
    if use_native is None:
        return available()
    if use_native:
        _require()
    return bool(use_native)


def _as_u8_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_jpeg(blob: bytes, max_dim: int = 8192) -> np.ndarray:
    """Decode one JPEG blob to an RGB uint8 [H, W, 3] array."""
    lib = _require()
    buf = np.frombuffer(blob, np.uint8)
    out = np.empty(max_dim * max_dim * 3 // 16, np.uint8)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.ppe_decode_jpeg(_as_u8_ptr(buf), len(blob), _as_u8_ptr(out),
                             out.size, ctypes.byref(w), ctypes.byref(h))
    if rc == 2:  # output buffer too small: retry at full size
        out = np.empty(max_dim * max_dim * 3, np.uint8)
        rc = lib.ppe_decode_jpeg(_as_u8_ptr(buf), len(blob), _as_u8_ptr(out),
                                 out.size, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise RuntimeError(f"JPEG decode failed (rc={rc})")
    return out[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def batch_decode_crop_resize(blobs: Sequence[bytes],
                             boxes: Sequence[Tuple[int, int, int, int]],
                             out_h: int, out_w: int,
                             n_threads: int = 4) -> np.ndarray:
    """Decode + crop + resize a batch.  boxes are (x1, y1, w, h) with the
    reference's inclusive crop semantics (img[y1:y1+h+1, x1:x1+w+1],
    reference: dataset/sbp_coco_dataset.py:45-51); w < 0 selects the whole
    image.  Returns uint8 [N, out_h, out_w, 3]; raises on decode failure."""
    lib = _require()
    n = len(blobs)
    lens = np.asarray([len(b) for b in blobs], np.int32)
    offsets = np.zeros(n, np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    concat = np.frombuffer(b"".join(blobs), np.uint8)
    boxes_arr = np.asarray(boxes, np.int32).reshape(n * 4)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    failed = lib.ppe_batch_decode_crop_resize(
        n, _as_u8_ptr(concat),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        boxes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        int(out_h), int(out_w), _as_u8_ptr(out), int(n_threads))
    if failed:
        raise RuntimeError(f"native loader: {failed}/{n} samples failed "
                           "to decode")
    return out
