"""Text parsers: CSV / TSV / LibSVM with format auto-detection (the
PyTorch port's copy of `lightgbm_tpu/io/parser.py`).

Mirrors the reference parser behavior (ref: src/io/parser.cpp:1-395): detect the
delimiter and sparse (LibSVM `idx:value`) format from the first lines, resolve the
label column, return dense float64 rows (NaN for missing).  The token loops run in
the native parser (`native/parser.c`) when it builds, else in NumPy and Python.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils import log


def _detect_format(sample_lines: List[str]) -> Tuple[str, str]:
    """Return (kind, delimiter) where kind in {'libsvm','dense'}
    (ref: parser.cpp GetDelimiter/DecideParser)."""
    # libsvm if any token beyond the first contains ':'
    for line in sample_lines:
        toks = line.replace("\t", " ").replace(",", " ").split()
        if any(":" in t for t in toks[1:]):
            return "libsvm", " "
    first = sample_lines[0]
    for delim in ("\t", ",", " "):
        if delim in first:
            return "dense", delim
    return "dense", "\t"


def _header_names_of(header_line: str):
    """Split a header line on the first matching delimiter."""
    for d in ("\t", ",", " "):
        if d in header_line:
            return header_line.split(d)
    return [header_line]


def _label_index(label_column: str, header_names) -> int:
    """'' (first column), 'N' (index), or 'name:COL' (header name)
    (ref: dataset_loader.cpp:35-130 SetHeader label resolution)."""
    if not label_column:
        return 0
    if label_column.startswith("name:"):
        name = label_column[5:]
        if header_names is None or name not in header_names:
            log.fatal(f"Label column '{name}' not found in header")
        return header_names.index(name)
    return int(label_column)


def parse_file(path: str, has_header: bool = False,
               label_column: str = "") -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
    """Parse a data file -> (features [n, F] float64 with NaN missing, labels [n],
    feature_names or None).

    label_column: '' (first column), 'N' (index), or 'name:COL' (header name)
    (ref: dataset_loader.cpp:35-130 SetHeader label resolution).
    """
    with open(path) as f:
        lines = [ln.rstrip("\n\r") for ln in f if ln.strip()]
    if not lines:
        log.fatal(f"Empty data file: {path}")
    header_names: Optional[List[str]] = None
    if has_header:
        header_line = lines[0]
        lines = lines[1:]
        if not lines:
            log.fatal(f"Data file has a header but no data rows: {path}")
    kind, delim = _detect_format(lines[:32])
    if has_header:
        header_names = _header_names_of(header_line)
    label_idx = _label_index(label_column, header_names)

    if kind == "libsvm":
        feats, labels = _parse_libsvm_lines(lines)
        return feats, labels, None  # libsvm ignores header feature names

    feats, labels = _parse_dense_lines(lines, delim, label_idx)
    if header_names is not None:
        feat_names = [h for i, h in enumerate(header_names) if i != label_idx]
    else:
        feat_names = None
    return feats, labels, feat_names


def _parse_libsvm_lines(lines, width_hint: int = 0, line_offset: int = 0):
    """LibSVM lines -> (feats [n, max(width_hint, max_idx+1)], labels).
    Native hot loop (ref: parser.cpp LibSVMParser) with Python fallback."""
    from ..native import parser_lib
    have_native = parser_lib() is not None
    if have_native:
        from ..native import parse_libsvm_native
        parsed = parse_libsvm_native("\n".join(lines).encode(),
                                     line_offset=line_offset)
        if parsed is not None:
            feats, labels = parsed
            if width_hint and feats.shape[1] < width_hint:
                feats = np.pad(feats,
                               ((0, 0), (0, width_hint - feats.shape[1])))
            return feats, labels
    labels = np.empty(len(lines), dtype=np.float64)
    rows: List[List[Tuple[int, float]]] = []
    max_idx = width_hint - 1
    for i, line in enumerate(lines):
        toks = line.split()
        labels[i] = float(toks[0])
        row = []
        for t in toks[1:]:
            k, v = t.split(":", 1)
            ki = int(k)
            if ki < 0:
                # match the native parser's rejection — same exception
                # type and message shape as parse_libsvm_native
                # (native/parser.c lgbt_parse_libsvm): a negative index
                # must not train silently via negative indexing
                raise ValueError("malformed libsvm pair on data line "
                                 f"{line_offset + i + 1}")
            row.append((ki, float(v)))
            max_idx = max(max_idx, ki)
        rows.append(row)
    feats = np.zeros((len(lines), max_idx + 1), dtype=np.float64)
    for i, row in enumerate(rows):
        for k, v in row:
            feats[i, k] = v
    return feats, labels


def _parse_dense_lines(lines, delim: str, label_idx: int):
    """Dense delimited lines -> (feats, labels).  Native tokenizer when
    available (ref: parser.cpp CSVParser), else the vectorized Python
    path (handles '' -> NaN identically)."""
    from ..native import parser_lib
    n_cols = len(lines[0].split(delim))
    mat = None
    if parser_lib() is not None:
        from ..native import parse_dense_native
        mat = parse_dense_native("\n".join(lines).encode(), delim,
                                 len(lines), n_cols)
    if mat is None:
        mat = np.array(
            [[(np.nan if tok == "" or tok.lower() in ("na", "nan", "null")
               else float(tok))
              for tok in line.split(delim)] for line in lines],
            dtype=np.float64)
    labels = mat[:, label_idx].copy()
    feats = np.delete(mat, label_idx, axis=1)
    return feats, labels


def parse_file_stream(path: str, has_header: bool = False,
                      label_column: str = "", chunk_rows: int = 65536,
                      num_features: int = 0):
    """Stream a data file in bounded row chunks, yielding (feats, labels)
    per chunk — the TPU-native analogue of the reference's double-buffered
    PipelineReader predict path (ref: predictor.hpp:30, application's
    predict loop): peak memory is one chunk, not the file.

    num_features: width hint for LibSVM chunks (a chunk may not contain
    the globally-largest feature index; predictions need the model's
    feature count)."""
    header_names: Optional[List[str]] = None
    kind = delim = None
    label_idx = 0
    buf: List[str] = []
    offset = 0

    def parse_chunk(chunk, off):
        if kind == "libsvm":
            return _parse_libsvm_lines(chunk, width_hint=num_features,
                                       line_offset=off)
        return _parse_dense_lines(chunk, delim, label_idx)

    with open(path) as f:
        if has_header:
            header_line = f.readline().rstrip("\n\r")
            if not header_line:
                log.fatal(f"Empty data file: {path}")
            header_names = _header_names_of(header_line)
        label_idx = _label_index(label_column, header_names)
        for ln in f:
            ln = ln.rstrip("\n\r")
            if not ln.strip():
                continue
            buf.append(ln)
            if kind is None and len(buf) >= 32:
                kind, delim = _detect_format(buf[:32])
            if len(buf) >= chunk_rows:
                if kind is None:
                    kind, delim = _detect_format(buf)
                yield parse_chunk(buf, offset)
                offset += len(buf)
                buf = []
    if buf:
        if kind is None:
            kind, delim = _detect_format(buf)
        yield parse_chunk(buf, offset)
    elif offset == 0:
        log.fatal(f"Empty data file: {path}")
