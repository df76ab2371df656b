"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
of its own with a plain C interface and loaded with ``ctypes``.  A library
is built on first use (``load``), or all of them in parallel (``build``),
into ``_build/<hash>/`` inside the package directory, keyed by a hash of
all sources and flags, so an edited source rebuilds and an unchanged tree
is reused.  Nothing here runs at import time: importing the package never
needs ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(_PKG_DIR, "_build")
# No --use_fast_math: the kernels test isfinite() for the solve_ok gate and
# need IEEE NaN/Inf semantics.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# One shared library per source, so that the sources compile in parallel.
SOURCES = ("enhance1d", "enhance2d", "enhance2d_varcoeff")
_HEADERS = ("enhance_common.cuh",)

_libs = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [f"{s}.cu" for s in SOURCES] + list(_HEADERS):
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def lib_path(source: str) -> str:
    return os.path.join(build_dir(), f"lib{source}.so")


def build(sources=SOURCES) -> dict:
    """Compile each of ``sources`` that has no library yet, all ``nvcc``
    processes started together.  Returns {source: library path}.  Each
    compiler's output (``-Xptxas -v`` register and spill counts) is kept in
    ``<source>.log`` beside the libraries."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for source in sources:
        out = lib_path(source)
        if os.path.exists(out):
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{source}.cu")]
        procs[source] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for source, (cmd, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        with open(os.path.join(out_dir, f"{source}.log"), "w") as fh:
            fh.write(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failed.append(f"{source}.cu: nvcc failed ({proc.returncode}):\n"
                          f"{log[-4000:]}")
            if os.path.exists(tmp):
                os.unlink(tmp)
        else:
            # atomic: a concurrent build never sees a partial library
            os.replace(tmp, lib_path(source))
    if failed:
        raise RuntimeError("\n".join(failed))
    return {source: lib_path(source) for source in sources}


def build_log() -> str:
    """The compilers' output for every source built so far."""
    logs = []
    for source in SOURCES:
        path = os.path.join(build_dir(), f"{source}.log")
        if os.path.exists(path):
            with open(path) as fh:
                logs.append(fh.read())
    return "\n".join(logs)


def _demangle(names):
    """The C++ names of mangled entry points, by the toolkit's ``cu++filt``
    (it sits beside ``nvcc``); the names as they are where it is missing."""
    filt = os.path.join(os.path.dirname(_nvcc()), "cu++filt")
    if not names or not os.path.exists(filt):
        return list(names)
    out = subprocess.run([filt, *names], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_summary(log: str):
    """[{kernel, M, C, params, registers, spill_stores, spill_loads}] parsed
    from ``-Xptxas -v`` output.  ``params`` lists every integer or boolean
    template argument of the kernel; M and C are the first two."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    for row, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        # e.g. "void <unnamed>::stacked2d_kernel<(int)6, (int)6, (bool)1>(...)"
        m = re.search(r"(\w+_kernel)<([^>]*)>", name)
        params = []
        if m:
            row["kernel"] = m.group(1)
            params = [int(v) if v.isdigit() else int(v == "true") for v in
                      re.findall(r"\d+|true|false", m.group(2))]
        row.update(M=params[0] if params else None,
                   C=params[1] if len(params) > 1 else None, params=params)
    return rows


def _bind(source, lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if source == "enhance1d":
        launchers = {
            "enhance1d_separable_f32": [i, p, p, p, p, p, p, p, p,
                                        i, i, i, i, i, i],
            "enhance1d_shared_f32": [i, p, p, p, p, p, p, p, i, i, i, i],
            "enhance1d_varcoeff_f32": [i, p, p, p, p, p, p, p, p, p,
                                       i, i, i, f, f, f, i],
        }
    elif source == "enhance2d":
        args = [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i]
        launchers = {"enhance2d_stacked_f32": args,
                     "enhance2d_shared_f32": args}
    else:
        launchers = {"enhance2d_varcoeff_f32": [i, p, p, p, p, p, p, p, p,
                                                p, i, i, i, i, i, f, f,
                                                i, i, i]}
    for name, argtypes in launchers.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    supported = getattr(lib, f"{source}_supported")
    supported.argtypes = [i, i]
    supported.restype = i
    err = getattr(lib, f"{source}_error_string")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p


def load(source: str = "enhance1d") -> ctypes.CDLL:
    """Build the library of ``source`` if it is not built yet and load it
    (once per process)."""
    if source not in SOURCES:
        raise ValueError(f"unknown kernel source {source!r}; have {SOURCES}")
    if source not in _libs:
        lib = ctypes.CDLL(build((source,))[source])
        _bind(source, lib)
        _libs[source] = lib
    return _libs[source]
