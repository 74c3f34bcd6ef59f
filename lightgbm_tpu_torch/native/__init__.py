"""Native host code (C, ctypes-loaded, compiled on demand): the host
predictor, the text parser and TreeSHAP of `lightgbm_tpu/native/`.

The reference keeps its host predictor in C++ (src/application/
predictor.hpp, OpenMP over rows); `predict.c` is the same traversal over
flat tree arrays.  It is what host prediction runs, and the yardstick the
card's traversal is timed against.  `parser.c` holds the dense and
LibSVM tokenizing loops of file loading (ref: src/io/parser.cpp;
`io/parser.py` falls back to NumPy when it does not build).
`treeshap.c` computes SHAP contributions (`pred_contrib`); the Python
`_tree_shap_py` is its fallback.  Each source
is compiled with the toolchain's `cc` at first use into `build/native/`
at the root of the checkout (named by a hash of the source and flags, so
an edited source rebuilds) and loaded with ctypes.  Nothing is built at
import time.
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
_parser_lib = None
_parser_tried = False
_shap_lib = None
_shap_tried = False
# trees explained by each TreeSHAP route since import
TREESHAP_CALLS = {"native": 0, "python": 0}


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


def parser_lib():
    """The compiled text parser, or None when no compiler works (ref:
    src/io/parser.cpp: the reference's parsers are C++ too)."""
    global _parser_lib, _parser_tried
    if _parser_tried:
        return _parser_lib
    _parser_tried = True
    path = _compile(_SRC_DIR / "parser.c", "parser")
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    c_dbl = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.lgbt_parse_dense.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_long,
        ctypes.c_long, c_dbl]
    lib.lgbt_parse_dense.restype = ctypes.c_long
    lib.lgbt_libsvm_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.lgbt_libsvm_scan.restype = ctypes.c_long
    lib.lgbt_parse_libsvm.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        c_dbl, c_dbl]
    lib.lgbt_parse_libsvm.restype = ctypes.c_long
    _parser_lib = lib
    return lib


def parse_dense_native(data: bytes, delim: str, n_rows: int,
                       n_cols: int) -> Optional[np.ndarray]:
    """Dense text -> [n_rows, n_cols] float64 (NaN missing), or None when
    the native parser is unavailable; raises ValueError on a bad token or
    a ragged row."""
    lib = parser_lib()
    if lib is None:
        return None
    out = np.empty((n_rows, n_cols), np.float64)
    got = lib.lgbt_parse_dense(data, len(data), delim.encode()[:1],
                               n_rows, n_cols, out)
    if got < 0:
        raise ValueError("bad token or inconsistent column count on data "
                         f"line {-got}")
    return out[:got]


def parse_libsvm_native(data: bytes, line_offset: int = 0):
    """LibSVM text -> (features [n, max_idx+1] float64, labels [n]), or
    None when the native parser is unavailable.  line_offset shifts
    error line numbers for chunked (streamed) inputs."""
    lib = parser_lib()
    if lib is None:
        return None
    max_idx = ctypes.c_long(-1)
    n = lib.lgbt_libsvm_scan(data, len(data), ctypes.byref(max_idx))
    n_cols = max(int(max_idx.value) + 1, 1)
    feats = np.zeros((n, n_cols), np.float64)
    labels = np.empty(n, np.float64)
    got = lib.lgbt_parse_libsvm(data, len(data), n, n_cols, labels, feats)
    if got < 0:
        raise ValueError("malformed libsvm pair on data line "
                         f"{line_offset - got}")
    return feats[:got], labels[:got]


def treeshap_lib():
    """The compiled TreeSHAP library, or None when no compiler works."""
    global _shap_lib, _shap_tried
    if _shap_tried:
        return _shap_lib
    _shap_tried = True
    path = _compile(_SRC_DIR / "treeshap.c", "treeshap")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    c_int_p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c_dbl_p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    c_i8_p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    c_u32_p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.treeshap_batch.argtypes = [
        c_int_p, c_dbl_p, c_i8_p, c_int_p, c_int_p,      # split/thr/dt/lc/rc
        c_dbl_p, c_dbl_p, c_dbl_p,                       # leaf_value/ic/lc
        c_u32_p, c_int_p, ctypes.c_int, ctypes.c_int,    # cat, num_cat, nl
        c_dbl_p, ctypes.c_long, ctypes.c_int,            # X, rows, xcols
        c_dbl_p, ctypes.c_int, c_dbl_p]                  # phi, ncol, scratch
    lib.treeshap_batch.restype = ctypes.c_int
    _shap_lib = lib
    return lib


def tree_shap(tree, X: np.ndarray, phi: np.ndarray) -> None:
    """Add one tree's SHAP values to phi [n, ncol] (the last column is the
    expected value): native when a compiler is available, else the
    Python fallback (ref: tree.h:139 PredictContrib)."""
    n = X.shape[0]
    ncol = phi.shape[1]
    nl = tree.num_leaves
    if nl <= 1:
        phi[:, -1] += tree.leaf_value[0]
        return
    ni = nl - 1
    # from the child arrays: a tree read from model text has no leaf_depth
    depth, stack = 0, [(0, 0)]
    while stack:
        node, d = stack.pop()
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                stack.append((int(child), d + 1))
            else:
                depth = max(depth, d + 1)
    lib = treeshap_lib()
    X = np.ascontiguousarray(X, np.float64)
    if lib is not None:
        scratch = np.zeros(((depth + 2) * (depth + 3) // 2) * 4, np.float64)
        if tree.num_cat:
            cat_thr = np.ascontiguousarray(tree.cat_threshold, np.uint32)
            cat_b = np.ascontiguousarray(tree.cat_boundaries, np.int32)
        else:
            cat_thr = np.zeros(1, np.uint32)
            cat_b = np.zeros(2, np.int32)
        rc = lib.treeshap_batch(
            np.ascontiguousarray(tree.split_feature[:ni], np.int32),
            np.ascontiguousarray(tree.threshold[:ni], np.float64),
            np.ascontiguousarray(tree.decision_type[:ni], np.int8),
            np.ascontiguousarray(tree.left_child[:ni], np.int32),
            np.ascontiguousarray(tree.right_child[:ni], np.int32),
            np.ascontiguousarray(tree.leaf_value[:nl], np.float64),
            np.ascontiguousarray(tree.internal_count[:ni], np.float64),
            np.ascontiguousarray(tree.leaf_count[:nl], np.float64),
            cat_thr, cat_b, int(tree.num_cat), int(nl),
            X, n, X.shape[1], phi, ncol, scratch)
        if rc == 0:
            TREESHAP_CALLS["native"] += 1
            return
    TREESHAP_CALLS["python"] += 1
    _tree_shap_py(tree, X, phi)


def _tree_shap_py(tree, X, phi):
    """TreeSHAP in Python (Lundberg et al. 2018, Algorithm 2): slow, the
    fallback when no C compiler is available."""
    nl = tree.num_leaves

    def node_count(nd):
        return (tree.leaf_count[~nd] if nd < 0
                else tree.internal_count[nd])

    expected = float(np.dot(tree.leaf_value[:nl], tree.leaf_count[:nl])
                     / max(tree.internal_count[0], 1))

    def extend(path, zf, of, fi):
        path = path + [[fi, zf, of, 1.0 if not path else 0.0]]
        d = len(path) - 1
        for i in range(d - 1, -1, -1):
            path[i + 1][3] += of * path[i][3] * (i + 1) / (d + 1)
            path[i][3] = zf * path[i][3] * (d - i) / (d + 1)
        return path

    def unwound_sum(path, pi):
        d = len(path) - 1
        of, zf = path[pi][2], path[pi][1]
        nop = path[d][3]
        total = 0.0
        for i in range(d - 1, -1, -1):
            if of != 0:
                tmp = nop * (d + 1) / ((i + 1) * of)
                total += tmp
                nop = path[i][3] - tmp * zf * (d - i) / (d + 1)
            else:
                total += path[i][3] / (zf * (d - i) / (d + 1))
        return total

    def unwind(path, pi):
        d = len(path) - 1
        of, zf = path[pi][2], path[pi][1]
        nop = path[d][3]
        path = [list(e) for e in path]
        for i in range(d - 1, -1, -1):
            if of != 0:
                tmp = path[i][3]
                path[i][3] = nop * (d + 1) / ((i + 1) * of)
                nop = tmp - path[i][3] * zf * (d - i) / (d + 1)
            else:
                path[i][3] = path[i][3] * (d + 1) / (zf * (d - i))
        for i in range(pi, d):
            path[i][:3] = path[i + 1][:3]
        return path[:d]

    def recurse(r, node, path, zf, of, fi, ph):
        path = extend([list(e) for e in path], zf, of, fi)
        if node < 0:
            v = tree.leaf_value[~node]
            for i in range(1, len(path)):
                w = unwound_sum(path, i)
                ph[path[i][0]] += w * (path[i][2] - path[i][1]) * v
            return
        feat = tree.split_feature[node]
        go_left = bool(tree._decision(
            np.asarray([X[r, feat]]), np.asarray([node]))[0])
        hot = tree.left_child[node] if go_left else tree.right_child[node]
        cold = (tree.right_child[node] if go_left
                else tree.left_child[node])
        w = node_count(node)
        hzf = node_count(hot) / w
        czf = node_count(cold) / w
        izf = iof = 1.0
        pi = next((i for i, e in enumerate(path) if e[0] == feat), None)
        if pi is not None:
            izf, iof = path[pi][1], path[pi][2]
            path = unwind(path, pi)
        recurse(r, hot, path, hzf * izf, iof, feat, ph)
        recurse(r, cold, path, czf * izf, 0.0, feat, ph)

    for r in range(X.shape[0]):
        recurse(r, 0, [], 1.0, 1.0, -1, phi[r])
        phi[r, -1] += expected
