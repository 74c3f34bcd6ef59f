"""Native host predictor (C, ctypes-loaded, compiled on demand): the
predictor half of `lightgbm_tpu/native/`.

The reference keeps its host predictor in C++ (src/application/
predictor.hpp, OpenMP over rows); `predict.c` is the same traversal over
flat tree arrays.  It is what host prediction runs, and the yardstick the
card's traversal is timed against.  The source is compiled with the
toolchain's `cc` at first use into `build/native/` at the root of the
checkout (named by a hash of the source and flags, so an edited source
rebuilds) and loaded with ctypes.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_pred_lib = None
_pred_tried = False


def _compile(src_path: Path, tag: str,
             extra_flags: tuple = ()) -> Optional[str]:
    """Compile src to a shared library under BUILD_DIR; returns its path
    or None.  extra_flags are best-effort: compilation retries without
    them."""
    src = src_path.read_bytes()
    h = hashlib.sha256(src + repr(extra_flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{tag}-{h}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for flags in ((*extra_flags,), ()) if extra_flags else ((),):
        for cc in ("cc", "gcc", "clang"):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                r = subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", *flags, "-o", tmp,
                     str(src_path), "-lm"],
                    capture_output=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                os.unlink(tmp)
                continue
            if r.returncode == 0:
                os.replace(tmp, out)
                return str(out)
            os.unlink(tmp)
    return None


def predictor_lib():
    """The compiled batch predictor (OpenMP over rows when the compiler
    supports it; ref: src/application/predictor.hpp), or None when no
    compiler works."""
    global _pred_lib, _pred_tried
    if _pred_tried:
        return _pred_lib
    _pred_tried = True
    path = _compile(_SRC_DIR / "predict.c", "predict",
                    extra_flags=("-fopenmp",))
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    c_dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    c_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    c_long = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.lgbt_predict_batch.argtypes = [
        c_dbl, ctypes.c_long, ctypes.c_long,
        c_i32, c_dbl, c_i8, c_i32, c_i32, c_dbl, c_u32, c_i32,
        c_long, c_long, c_long, c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_int, c_dbl]
    lib.lgbt_predict_batch.restype = None
    lib.lgbt_predict_leaf.argtypes = [
        c_dbl, ctypes.c_long, ctypes.c_long,
        c_i32, c_dbl, c_i8, c_i32, c_i32, c_u32, c_i32,
        c_long, c_long, c_long,
        ctypes.c_long, c_i32]
    lib.lgbt_predict_leaf.restype = None
    _pred_lib = lib
    return lib


class PackedPredictor:
    """Flattened tree arrays for repeated native predict calls (the
    packing is O(model size); callers cache one per model slice)."""

    def __init__(self, trees):
        self.ok = not any(getattr(t, "is_linear", False) for t in trees)
        if not self.ok:
            return
        self._pack(trees)

    def _pack(self, trees):
        self.T = len(trees)
        sf, th, dt, lc, rc, lv, cw, cb = [], [], [], [], [], [], [], []
        node_off = [0]
        leaf_off = [0]
        cw_off = [0]
        cb_off = [0]
        for t in trees:
            nl = t.num_leaves
            ni = max(nl - 1, 0)
            sf.append(np.asarray(t.split_feature[:ni], np.int32))
            th.append(np.asarray(t.threshold[:ni], np.float64))
            dt.append(np.asarray(t.decision_type[:ni], np.int8))
            lc.append(np.asarray(t.left_child[:ni], np.int32))
            rc.append(np.asarray(t.right_child[:ni], np.int32))
            lv.append(np.asarray(t.leaf_value[:max(nl, 1)], np.float64))
            words = np.asarray(t.cat_threshold, np.uint32)
            bounds = np.asarray(t.cat_boundaries, np.int32)
            cw.append(words)
            cb.append(bounds)
            node_off.append(node_off[-1] + ni)
            leaf_off.append(leaf_off[-1] + max(nl, 1))
            cw_off.append(cw_off[-1] + len(words))
            cb_off.append(cb_off[-1] + len(bounds))

        def cat(parts, dtype):
            return (np.concatenate(parts) if parts
                    else np.zeros(0, dtype)).astype(dtype)
        self.sf = cat(sf, np.int32)
        self.th = cat(th, np.float64)
        self.dt = cat(dt, np.int8)
        self.lc = cat(lc, np.int32)
        self.rc = cat(rc, np.int32)
        self.lv = cat(lv, np.float64)
        self.cw = cat(cw, np.uint32)
        self.cb = cat(cb, np.int32)
        self.node_off = np.asarray(node_off, np.int64)
        self.leaf_off = np.asarray(leaf_off, np.int64)
        self.cw_off = np.asarray(cw_off, np.int64)
        self.cb_off = np.asarray(cb_off, np.int64)

    def predict_leaf(self, X: np.ndarray) -> Optional[np.ndarray]:
        """[n, T] leaf indices, or None when unavailable."""
        lib = predictor_lib()
        if lib is None or not self.ok:
            return None
        X = np.ascontiguousarray(X, np.float64)
        n = X.shape[0]
        out = np.zeros((n, self.T), np.int32)
        lib.lgbt_predict_leaf(
            X, n, X.shape[1], self.sf, self.th, self.dt, self.lc, self.rc,
            self.cw, self.cb, self.node_off, self.cw_off, self.cb_off,
            self.T, out)
        return out

    def predict(self, X: np.ndarray, K: int,
                average: bool) -> Optional[np.ndarray]:
        """[n, K] float64 raw scores, or None when unavailable."""
        lib = predictor_lib()
        if lib is None or not self.ok:
            return None
        X = np.ascontiguousarray(X, np.float64)
        n = X.shape[0]
        out = np.zeros((n, K), np.float64)
        lib.lgbt_predict_batch(
            X, n, X.shape[1], self.sf, self.th, self.dt, self.lc, self.rc,
            self.lv, self.cw, self.cb, self.node_off, self.leaf_off,
            self.cw_off, self.cb_off, self.T, K, int(bool(average)), out)
        return out


class SingleRowFastPredictor:
    """Cached single-row predict state (ref: c_api.h:1350-1379
    LGBM_BoosterPredictForMatSingleRowFastInit / ...SingleRowFast, whose
    FastConfig caches the parsed config and buffers, c_api.cpp:125-160).

    Everything reusable is prepared ONCE: the flattened tree pack, the
    input/output buffers, and the host-side output conversion; a
    predict() call is one buffer write and one ctypes call."""

    def __init__(self, packed: PackedPredictor, num_features: int,
                 K: int, average: bool, convert=None):
        self._packed = packed
        self._K = K
        self._convert = convert
        self._X = np.zeros((1, num_features), np.float64)
        self._out = np.zeros((1, K), np.float64)
        self._lib = predictor_lib()
        if self._lib is None or not packed.ok:
            return
        # marshalling 19 ndpointer args costs ~10us EACH per call: bind
        # the raw pointers ONCE through a second (argtype-free) handle;
        # every buffer is owned by this object or the pack, so the
        # addresses are stable for the predictor's lifetime
        p = packed
        lib2 = ctypes.CDLL(self._lib._name)
        self._fn = lib2.lgbt_predict_batch
        self._fn.restype = None
        vp = ctypes.c_void_p
        cl = ctypes.c_long
        self._cargs = (
            vp(self._X.ctypes.data), cl(1), cl(num_features),
            vp(p.sf.ctypes.data), vp(p.th.ctypes.data),
            vp(p.dt.ctypes.data), vp(p.lc.ctypes.data),
            vp(p.rc.ctypes.data), vp(p.lv.ctypes.data),
            vp(p.cw.ctypes.data), vp(p.cb.ctypes.data),
            vp(p.node_off.ctypes.data), vp(p.leaf_off.ctypes.data),
            vp(p.cw_off.ctypes.data), vp(p.cb_off.ctypes.data),
            cl(p.T), cl(K), ctypes.c_int(int(bool(average))),
            vp(self._out.ctypes.data))

    @property
    def ok(self) -> bool:
        return self._lib is not None and self._packed.ok

    def predict(self, row) -> np.ndarray:
        """row: [F] array-like -> [K] predictions (converted unless the
        predictor was built raw)."""
        self._X[0, :] = row
        self._out[0, :] = 0.0        # the C kernel accumulates (+=)
        self._fn(*self._cargs)
        out = self._out[0]
        if self._convert is not None:
            out = self._convert(out)
        return out.copy()


def predict_batch_native(trees, X: np.ndarray, K: int,
                         average: bool) -> Optional[np.ndarray]:
    """One-shot native prediction (packs then predicts); callers with
    repeated predicts should cache a PackedPredictor instead."""
    if predictor_lib() is None:
        return None
    packed = PackedPredictor(trees)
    return packed.predict(X, K, average) if packed.ok else None
