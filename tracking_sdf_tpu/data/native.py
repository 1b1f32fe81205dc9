"""ctypes bindings for the native (C++) frame loader.

native/loader.cpp is a threaded PNG-decode + prefetch pipeline (the runtime
role of the reference's ROS nodelet image chain, launch/kinect_normal.launch)
that overlaps disk IO and decode with device compute. The shared library is
built on demand with `make -C native` (g++ + zlib, both in the base image);
everything degrades gracefully to the numpy codec (data.png) when the
toolchain or library is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libtsdf_native.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> bool:
    global _build_err
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"],
            check=True, capture_output=True, timeout=120,
        )
        return os.path.exists(_SO_PATH)
    except subprocess.CalledProcessError as e:
        # keep the compiler's complaint for the stale-.so warning below
        _build_err = (e.stderr or e.stdout or b"").decode(
            "utf-8", "replace").strip()[-2000:]
        return False
    except Exception as e:
        _build_err = f"{type(e).__name__}: {e}"
        return False


_build_err: Optional[str] = None


def load_library(build_if_missing: bool = True):
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if build_if_missing:
            # ALWAYS run make (a no-op when fresh — the Makefile tracks
            # loader.cpp): gating on file existence kept serving STALE
            # binaries after source fixes (the raw-open race fix shipped
            # while hosts still had the racy .so)
            if not _build():
                if not os.path.exists(_SO_PATH):
                    return None
                # the rebuild FAILED but an old .so exists: loading it is
                # the stale-binary hazard the always-make policy exists to
                # prevent — load it (graceful degradation) but say so,
                # with the captured compiler output
                import warnings
                warnings.warn(
                    "native loader rebuild failed; loading PRE-EXISTING "
                    f"{_SO_PATH} which may be stale. Compiler said:\n"
                    f"{_build_err or '(no output captured)'}",
                    RuntimeWarning, stacklevel=2)
        elif not os.path.exists(_SO_PATH):
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.tsdf_decode_depth.restype = ctypes.c_int
        lib.tsdf_decode_depth.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.tsdf_decode_rgb.restype = ctypes.c_int
        lib.tsdf_decode_rgb.argtypes = lib.tsdf_decode_depth.argtypes
        lib.tsdf_loader_open.restype = ctypes.c_void_p
        lib.tsdf_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.tsdf_loader_dims.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.tsdf_loader_next.restype = ctypes.c_int
        lib.tsdf_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.tsdf_loader_open_raw.restype = ctypes.c_void_p
        lib.tsdf_loader_open_raw.argtypes = lib.tsdf_loader_open.argtypes
        lib.tsdf_loader_next_raw.restype = ctypes.c_int
        lib.tsdf_loader_next_raw.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
        ]
        lib.tsdf_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def decode_depth(path: str) -> np.ndarray:
    """One-shot native 16-bit depth PNG decode -> float32 meters, NaN holes."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    cap = 4096 * 4096
    out = np.empty(cap, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.tsdf_decode_depth(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w), ctypes.byref(h), cap,
    )
    if rc != 0:
        raise ValueError(f"native depth decode failed ({rc}): {path}")
    return out[: w.value * h.value].reshape(h.value, w.value).copy()


def decode_rgb(path: str) -> np.ndarray:
    """One-shot native 8-bit PNG decode -> float32 RGB in [0, 1]."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    cap = 4096 * 4096 * 3
    out = np.empty(cap, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.tsdf_decode_rgb(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(w), ctypes.byref(h), cap,
    )
    if rc != 0:
        raise ValueError(f"native rgb decode failed ({rc}): {path}")
    return out[: w.value * h.value * 3].reshape(h.value, w.value, 3).copy()


class PrefetchingLoader:
    """Ordered iterator over (index, depth, rgb|None) with native prefetch.

    ``raw=True`` yields the TUM wire formats — depth uint16 (0 = hole),
    rgb uint8 — instead of decoded float32: 6x fewer bytes for consumers
    that decode on-device (pipeline.runner.process_chunk)."""

    def __init__(
        self,
        depth_paths: List[str],
        rgb_paths: Optional[List[Optional[str]]] = None,
        prefetch: int = 8,
        threads: int = 0,
        raw: bool = False,
    ):
        self._lib = load_library()
        if self._lib is None:
            raise RuntimeError("native loader unavailable")
        n = len(depth_paths)
        self._n = n
        dp = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
        rp_list = rgb_paths if rgb_paths is not None else [None] * n
        rp = (ctypes.c_char_p * n)(
            *[(p.encode() if p else None) for p in rp_list]
        )
        self._has_rgb = any(p is not None for p in rp_list)
        self._raw = raw
        opener = (self._lib.tsdf_loader_open_raw if raw
                  else self._lib.tsdf_loader_open)
        self._handle = opener(dp, rp, n, prefetch, threads)
        if not self._handle:
            raise RuntimeError("tsdf_loader_open failed (first frame unreadable?)")
        w = ctypes.c_int()
        h = ctypes.c_int()
        self._lib.tsdf_loader_dims(self._handle, ctypes.byref(w), ctypes.byref(h))
        self.width, self.height = w.value, h.value

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray, Optional[np.ndarray]]]:
        if self._raw:
            yield from self._iter_raw()
            return
        while True:
            depth = np.empty((self.height, self.width), np.float32)
            rgb = np.empty((self.height, self.width, 3), np.float32)
            rc = self._lib.tsdf_loader_next(
                self._handle,
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if rc == -1:
                return
            if rc == -2:
                continue  # skip undecodable frame, like the reference drops bad msgs
            has_rgb = self._has_rgb and rgb.ravel()[0] != -1.0
            yield rc, depth, (rgb if has_rgb else None)

    def _iter_raw(self):
        while True:
            depth = np.empty((self.height, self.width), np.uint16)
            rgb = np.empty((self.height, self.width, 3), np.uint8)
            has = ctypes.c_int()
            rc = self._lib.tsdf_loader_next_raw(
                self._handle,
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(has),
            )
            if rc == -1:
                return
            if rc == -2:
                continue
            yield rc, depth, (rgb if has.value else None)

    def close(self) -> None:
        if self._handle:
            self._lib.tsdf_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
