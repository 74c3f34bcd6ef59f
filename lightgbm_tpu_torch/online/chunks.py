"""Chunk sources for the online continual-learning loop (PyTorch port of
`lightgbm_tpu/online/chunks.py`; docs/Online.md).  Host code: the chunk
files and their reading are the JAX package's, so a chunk either package
writes reads the same in the other.

A `ChunkSource` sequences arriving row chunks with MONOTONE generation
ids: `poll()` yields the next unconsumed generation (or None), never the
same generation twice, never out of order.  Generation ids are the
loop's clock — the trainer checkpoints, publishes and measures
freshness per generation, and a resumed trainer re-opens its source at
`last_checkpointed_generation + 1`.

Two implementations:

* `DirectoryChunkSource` — a directory watcher: producers land files
  named `chunk-<generation>.npz|npy|csv` (the generation is the file
  name, so ordering survives any producer) and MUST rename them into
  place atomically (`write_chunk` below does; a torn partial write
  surfaces as a corrupt chunk, which the trainer skips).  npz chunks
  carry `X` and `y` arrays; npy/csv chunks are one 2-D matrix whose
  FIRST column is the label (the CLI-file convention).
* `MemoryChunkSource` — an in-process feeder for tests and the bench:
  `push(X, y)` assigns the next generation and stamps its arrival.

A chunk that cannot be read (torn write, injected `online_chunk_corrupt`
fault, malformed matrix) is returned with `error` set instead of
raising: the SOURCE advances past it (monotonicity holds), and the
TRAINER decides — skip the generation, keep the previous one serving.
"""

from __future__ import annotations

import io
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..utils import atomic_write_bytes

_CHUNK_RE = re.compile(r"^chunk-(\d+)\.(npz|npy|csv)$")


@dataclass
class Chunk:
    """One generation of fresh rows.  `t_arrival` is the monotonic stamp
    the source first saw it (the freshness-lag epoch); `error` set means
    the bytes could not be read — skip, do not train."""

    generation: int
    X: Optional[np.ndarray]
    y: Optional[np.ndarray]
    t_arrival: float
    path: Optional[str] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def num_rows(self) -> int:
        return 0 if self.X is None else int(self.X.shape[0])


class ChunkSource:
    """Base protocol: `poll()` -> next Chunk or None; `close()`."""

    def poll(self) -> Optional[Chunk]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryChunkSource(ChunkSource):
    """In-process feeder (tests/bench): `push(X, y)` assigns the next
    monotone generation and stamps arrival; `poll()` pops in order.
    Thread-safe — a feeder thread pushes while the
    trainer thread polls."""

    def __init__(self, start_generation: int = 1):
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._next_gen = int(start_generation)

    def push(self, X, y) -> int:
        X = np.asarray(X)
        y = np.asarray(y)
        if X.ndim != 2 or X.shape[0] == 0 or len(y) != X.shape[0]:
            raise ValueError(f"chunk must be a non-empty 2-D matrix with "
                             f"matching labels (got X {X.shape}, "
                             f"y {np.shape(y)})")
        with self._lock:
            gen = self._next_gen
            self._next_gen += 1
            self._queue.append(Chunk(gen, X, y, time.monotonic()))
        return gen

    def poll(self) -> Optional[Chunk]:
        with self._lock:
            chunk = self._queue.popleft() if self._queue else None
        if chunk is not None:
            from ..reliability import faults
            if faults.active() and faults.maybe_online_chunk_corrupt(
                    chunk.generation):
                chunk = Chunk(chunk.generation, None, None,
                              chunk.t_arrival,
                              error="injected online_chunk_corrupt")
        return chunk

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)


def _read_chunk(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Decode one chunk file -> (X, y).  Raises OSError/ValueError/
    KeyError on damage — the caller converts that into an error Chunk."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path, allow_pickle=False) as z:
            X = np.asarray(z["X"])
            y = np.asarray(z["y"])
    else:
        if ext == ".npy":
            mat = np.asarray(np.load(path, allow_pickle=False))
        else:  # .csv: label-first-column, comma-separated
            mat = np.genfromtxt(path, delimiter=",", dtype=np.float64)
        mat = np.atleast_2d(mat)
        if mat.shape[1] < 2:
            raise ValueError(f"chunk matrix needs a label column plus at "
                             f"least one feature (shape {mat.shape})")
        y = mat[:, 0]
        X = mat[:, 1:]
    if X.ndim != 2 or X.shape[0] == 0 or len(y) != X.shape[0]:
        raise ValueError(f"malformed chunk: X {X.shape}, y {np.shape(y)}")
    if not np.all(np.isfinite(np.asarray(y, np.float64))):
        raise ValueError("chunk labels contain non-finite values")
    return X, y


def write_chunk(directory: str, generation: int, X, y) -> str:
    """Land one npz chunk ATOMICALLY (temp sibling + os.replace): the
    watcher can never observe a half-written chunk — it either sees
    nothing or the complete file.  Producers should use this (or the
    same rename idiom) rather than writing `chunk-*.npz` in place."""
    X = np.asarray(X)
    y = np.asarray(y)
    buf = io.BytesIO()
    np.savez(buf, X=X, y=y)
    path = os.path.join(os.fspath(directory), f"chunk-{generation:07d}.npz")
    atomic_write_bytes(path, buf.getvalue())
    return path


class DirectoryChunkSource(ChunkSource):
    """Directory watcher: yields `chunk-<gen>.*` files in generation
    order, starting at `start_generation` (a resumed trainer passes
    `last_checkpointed + 1`, so already-consumed chunks are never
    re-trained).  Gaps in the id sequence are allowed — the smallest
    unconsumed generation wins each poll; ids below the cursor are
    ignored forever (monotonicity).  Non-matching names (temp files,
    dotfiles) are invisible, which is what makes the atomic-rename
    producer contract sufficient."""

    def __init__(self, directory: str, start_generation: int = 1):
        self.dir = os.fspath(directory)
        self._next_gen = int(start_generation)

    def fast_forward(self, last_consumed: int) -> None:
        """Advance the cursor past `last_consumed` (a resumed trainer
        calls this with its checkpointed generation; never rewinds)."""
        self._next_gen = max(self._next_gen, int(last_consumed) + 1)

    def poll(self) -> Optional[Chunk]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return None
        best: Optional[Tuple[int, str]] = None
        for fname in names:
            m = _CHUNK_RE.match(fname)
            if m is None:
                continue
            gen = int(m.group(1))
            if gen < self._next_gen:
                continue
            if best is None or gen < best[0]:
                best = (gen, fname)
        if best is None:
            return None
        gen, fname = best
        path = os.path.join(self.dir, fname)
        t_arrival = time.monotonic()
        self._next_gen = gen + 1
        from ..reliability import faults
        if faults.active():
            faults.maybe_online_chunk_corrupt(gen, path)
        try:
            X, y = _read_chunk(path)
        except Exception as e:  # noqa: BLE001 - damage takes many shapes (BadZipFile, OSError, ValueError); all mean "skip this generation"
            return Chunk(gen, None, None, t_arrival, path=path,
                         error=f"{type(e).__name__}: {e}")
        return Chunk(gen, X, y, t_arrival, path=path)
