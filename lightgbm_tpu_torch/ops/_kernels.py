"""Build and bind the port's CUDA kernels (plain C interface, ctypes).

The sources live in `ops/csrc/`.  At first use on a CUDA host each
source is compiled with `nvcc -gencode arch=compute_90a,code=sm_90a` into
a shared library under `build/kernels/` at the root of the checkout
(named by a hash of the source, the shared headers `csrc/*.cuh` and the
flags, so an edited source or header rebuilds), and loaded with ctypes.
`ptxas -v`'s report of each build (registers, shared memory, spills per
kernel) is kept beside the library and read by `resource_usage`; `sass_atomics` lists the atomic instructions each
kernel compiled to.  Nothing here runs at import time: the CPU tests
import every module of the package on a host with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("wave_hist.cu", "rows_hist.cu")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: (argtypes, restype) per exported function
_SIGNATURES = {
    "wave_hist_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _P, _L, _P, _P, _P, _P, _P], _I),
    "wave_hist_i32": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _P, _L, _P, _P, _P, _P, _P], _I),
    "wave_hist_hl_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P, _P, _P, _P, _P], _I),
    "rows_hist_f32": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P], _I),
}


def _cuda_tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (CUDA_HOME or PATH): the "
                           "port's CUDA kernels cannot be built on this host")
    return found


def _lib_path(source: str) -> Path:
    text = (_CSRC / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    key = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{key[:16]}.so"


def build(source: str) -> Path:
    """Compile one source into its shared library (no-op when built)."""
    out = _lib_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, str(_CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all() -> Dict[str, Path]:
    """Build every source at once, one nvcc process each."""
    outs = {s: _lib_path(s) for s in SOURCES}
    todo = [s for s, p in outs.items() if not p.exists()]
    if todo:
        threads = [threading.Thread(target=build, args=(s,))
                   for s in todo]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        missing = [s for s in todo if not outs[s].exists()]
        if missing:
            # rebuild in this thread to surface the compiler's error
            for s in missing:
                build(s)
    return outs


def lib(source: str = "wave_hist.cu") -> ctypes.CDLL:
    """The loaded library of one source, built at first use."""
    with _lock:
        handle = _libs.get(source)
        if handle is None:
            handle = ctypes.CDLL(str(build(source)))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name, None)
                if fn is not None:
                    fn.argtypes = args
                    fn.restype = res
            _libs[source] = handle
        return handle


def resource_usage(source: str) -> Dict[str, dict]:
    """Per kernel of a built source (mangled name): registers, static
    shared memory bytes, stack frame and spill stores/loads, from
    `ptxas -v`."""
    report = _lib_path(source).with_suffix(".ptxas.txt").read_text()
    out: Dict[str, dict] = {}
    fn = None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["stack_frame"] = int(m.group(1))
            out[fn]["spill_stores"] = int(m.group(2))
            out[fn]["spill_loads"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["static_smem"] = int(m.group(1)) if m else 0
    return out


def sass_atomics(source: str) -> Dict[str, List[str]]:
    """Per kernel of a built source (mangled name): the distinct atomic
    and reduction opcodes of its SASS (`cuobjdump -sass`), e.g.
    `ATOMS.ADD` (a native shared-memory add) or `ATOMS.CAST.SPIN.64` (a
    compare-and-swap loop)."""
    proc = subprocess.run([_cuda_tool("cuobjdump"), "-sass",
                           str(build(source))], capture_output=True,
                          text=True, check=True)
    out: Dict[str, List[str]] = {}
    fn = None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        if fn is None:
            continue
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG)\.[\w.]+)",
                             line):
            if op not in out[fn]:
                out[fn].append(op)
    return out


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
