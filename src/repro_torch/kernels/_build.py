"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process (all started
together) into ``build/repro_torch_kernels/<hash>/lib<name>.so`` at the root
of the checkout, and loaded with :mod:`ctypes`.  The hash covers the
sources, the headers and the compiler flags, so an edited source builds
anew and an unchanged one is reused.  The build happens at first use, never
at import: the CPU tests import every module without ``nvcc``.

Each ``nvcc`` runs with ``-Xptxas -v``; its output is kept beside the library
as ``lib<source>.log``, and :func:`ptxas_usage` reads each kernel's
registers, shared memory and spills from it.

Each kernel function ``<name>`` is exported as ``<name>_f32`` and
``<name>_f64`` (plain C functions that take device pointers and the stream
as ``void*``, launch, and return ``cudaGetLastError()``) by the library of
its source, ``SOURCES[name]``, which also exports
``<source>_error_string``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
#: argument types of ``<name>_f32`` / ``<name>_f64``: pointers and the stream
#: as c_void_p, so ctypes never cuts a 64-bit address to an int
SIGNATURES = {
    "bsr_spmbv": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _L, _L, _I, _I, _P],
    "fused_gram": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P],
    "ecg_tail": [_P] * 11 + [_L, _I, _P],
    "halo_pack": [_P, _P, _P, _I, _L, _I, _I, _P],
    "halo_unpack": [_P, _P, _P, _I, _L, _I, _I, _P],
    "block_trisolve": [_P, _P, _P, _L, _I, _I, _L, _L, _P],
    "chol_apply": [_P] * 5 + [_L, _I, _P],
    "rank_apply": [_P] * 5 + [_L, _I, _D, _P, _P, _P],
    "drop_mask": [_P, _L, _I, _P, _P, _D, _D, _I, _I, _P, _P, _P],
    "block_update": [_P] * 7 + [_L, _I, _P],
}
#: the source, ``csrc/<source>.cu``, that exports each kernel function
SOURCES = {name: name for name in SIGNATURES} | {
    "halo_unpack": "halo_pack", "block_update": "ecg_tail",
    "rank_apply": "chol_apply", "drop_mask": "chol_apply",
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # by source
_fns: dict[tuple[str, str], object] = {}  # (name, "f32" | "f64") -> C function


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME/bin); the CUDA "
        "kernels are built from source at first use"
    )


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all at once.  Returns {source: path of the shared library}."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {src: out / f"lib{src}.so" for src in sorted(set(SOURCES.values()))}
    todo = {name: path for name, path in libs.items() if not path.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".so.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            libs[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, libs[name])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


_PTXAS = re.compile(
    r"Compiling entry function '(?P<fn>[^']+)'"
    r"|(?P<stores>\d+) bytes spill stores, (?P<loads>\d+) bytes spill loads"
    r"|Used (?P<regs>\d+) registers(?:, used \d+ barriers)?(?:, (?P<smem>\d+) bytes smem)?"
)


def parse_ptxas(log: str, source: str) -> list[dict]:
    """One row per kernel of an ``nvcc -Xptxas -v`` log: its mangled name,
    registers, static shared memory and spill bytes."""
    rows, row = [], None
    for m in _PTXAS.finditer(log):
        if m["fn"]:
            row = {"source": source, "kernel": m["fn"]}
            rows.append(row)
        elif row is not None and m["stores"]:
            row.update(spill_stores=int(m["stores"]), spill_loads=int(m["loads"]))
        elif row is not None and m["regs"]:
            row.update(registers=int(m["regs"]), smem_bytes=int(m["smem"] or 0))
    return rows


def ptxas_usage() -> list[dict]:
    """:func:`parse_ptxas` of every source's log in the current build."""
    return [row for log in sorted(build_dir().glob("lib*.log"))
            for row in parse_ptxas(log.read_text(), log.stem.removeprefix("lib"))]


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu`` (built at first use)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[source]))
            err = getattr(lib, f"{source}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def _function(name: str, suffix: str):
    fn = _fns.get((name, suffix))
    if fn is None:
        fn = getattr(load(SOURCES[name]), f"{name}_{suffix}")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[(name, suffix)] = fn
    return fn


def launch(name: str, dtype, *args) -> None:
    """Call ``<name>_<f32|f64>`` and raise if the launch was refused."""
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    code = _function(name, suffix)(*args)
    if code != 0:
        msg = getattr(load(SOURCES[name]), f"{SOURCES[name]}_error_string")(code).decode()
        raise RuntimeError(f"{name}_{suffix}: CUDA error {code}: {msg}")
