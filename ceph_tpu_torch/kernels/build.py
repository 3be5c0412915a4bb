"""Build, load and count the port's CUDA kernels.

The sources are ``ceph_tpu_torch/csrc/*.cu``, each with a plain C
interface.  At first use every source compiles with its own ``nvcc``
(all started together) for ``sm_90a``, and the objects link into
``build/ceph_tpu_torch/libceph_tpu_torch_kernels.so`` at the root of the
checkout, which is then loaded with ``ctypes``.  A stamp file holds the
sources' hash; a changed source rebuilds.  Nothing builds at import:
the CPU tests import every module and never reach :func:`library`.

Every kernel has a :class:`Kernel` record whose ``launches`` counter
its wrapper bumps once per launch, and nowhere else, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ceph_tpu_torch"
LIB_NAME = "libceph_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# C entry name -> argtypes; every entry returns cudaGetLastError()
_SIGNATURES = {
    # in, out, tables, batch, k, rows, rows per block, nw, stream
    "ctt_gf_words": [_P, _P, _P, _I, _I, _I, _I, _L, _P],
    # in, planes, batch, k, nw, stream
    "ctt_gf_expand": [_P, _P, _I, _I, _L, _P],
    # planes, out, B fragments, batch, k, rows, rows per block, nw,
    # stream
    "ctt_gf_planes": [_P, _P, _P, _I, _I, _I, _I, _L, _P],
    # set a, set b, rows of a, rows, seeds, out, granules per row, tiles
    # per segment, segments per row, tables, segment ops, seed op,
    # combine words, grid, stream
    "ctt_crc32c_batch": [_P, _P, _I, _I, _P, _P, _L, _I, _I, _P, _P, _P,
                         _P, _I, _P],
    # in, out, tables, batch, k, rows, rows per block, bytes per row
    # (a multiple of 4), stream
    "ctt_gf_bytes": [_P, _P, _P, _I, _I, _I, _I, _L, _P],
    # in, out, schedule, schedule length, batch, rows, n, packets per
    # pass, packet words, stream
    "ctt_gf2_packets": [_P, _P, _P, _I, _I, _I, _I, _I, _L, _P],
    # rows, x, r, pos, out, items, hash ids, weights, sizes, ln table,
    # lanes, buckets, columns, weight sets, stream
    "ctt_crush_straw2": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _P],
    # in, out, gear table, rows, row length, vector path, stream
    "ctt_gear_hash": [_P, _P, _P, _I, _L, _I, _P],
    # in, out, rows, row length, vector path, stream
    "ctt_run_starts": [_P, _P, _I, _L, _I, _P],
    # sid, stamp, now, objects, missing, backfill remaining, scrub
    # errors, rows, histogram length, out, blocks, stream
    "ctt_pgmap_fold": [_P, _P, _D, _P, _P, _P, _P, _L, _I, _P, _I, _P],
}


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and
    how many times its wrapper launched it."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces    # file:line of the TPU program
        self.launches = 0
        self._lock = threading.Lock()

    def count(self):
        with self._lock:
            self.launches += 1


KERNELS: dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    return KERNELS.setdefault(name, Kernel(name, source, replaces))


def reset_counts():
    for kern in KERNELS.values():
        with kern._lock:
            kern.launches = 0


def counts() -> dict[str, int]:
    return {name: kern.launches for name, kern in KERNELS.items()}


class KernelError(RuntimeError):
    pass


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(paths: list[Path]) -> str:
    h = hashlib.sha256()
    for p in paths + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _short_name(mangled: str) -> str:
    """``<name>_kernel<args>`` from a mangled template kernel name, or
    ``<name>_kernel`` from a plain one in a namespace (each identifier
    is prefixed by its length), else the name unchanged."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):        # the length may follow a hash
            name = mangled[m.end():m.end() + int(m.group()[i:])]
            rest = mangled[m.end() + len(name):]
            if name.endswith("_kernel") and rest.startswith("I"):
                args = re.findall(r"L[a-z](\d+)E", rest.split("EEv")[0])
                return f"{name}<{', '.join(args)}>"
            if name.endswith("_kernel") and rest.startswith("E"):
                return name
    return mangled


def ptxas_report(stem: str) -> list[str]:
    """``-Xptxas -v`` lines of one source's last build, one per kernel
    variant: ``<entry>: <registers, barriers>; <stack, spills>``."""
    path = BUILD_DIR / (stem + ".log")
    if not path.exists():
        return []
    out, entry, props = [], None, ""
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = _short_name(line.split("'")[1])
        elif "bytes stack frame" in line:
            props = line.strip()
        elif "Used" in line and "registers" in line and entry:
            out.append(f"{entry}: {line.split(':', 1)[1].strip()}; {props}")
            entry = None
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise KernelError("nvcc not found: the CUDA kernels build only on a "
                      "machine with the CUDA toolkit")


def build(verbose: bool = False) -> Path:
    """Compile the sources if their hash changed; return the library
    path.  Concurrent processes serialise on a lock file."""
    srcs = _sources()
    digest = _digest(srcs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (lib.exists() and stamp.exists()
                and stamp.read_text().strip() == digest):
            return lib
        nvcc = _nvcc()
        objs = [BUILD_DIR / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, log in zip(srcs, logs):
            (BUILD_DIR / (s.stem + ".log")).write_text(log)
        for s, p, log in zip(srcs, procs, logs):
            if verbose or p.returncode:
                print(f"[nvcc {s.name}]\n{log}", flush=True)
        bad = [s.name for s, p in zip(srcs, procs) if p.returncode]
        if bad:
            raise KernelError(f"nvcc failed for {bad}")
        tmp = lib.with_suffix(".so.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode:
            raise KernelError(f"link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp, lib)
        stamp.write_text(digest + "\n")
        return lib


_LIB = None
_LIB_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(rc: int, name: str):
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry."""
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def device_table(cache: dict, key, make, device) -> torch.Tensor:
    """A host-built numpy table (``make()``) on ``device``, cached in
    ``cache``; uint32 tables travel as int32 of the same bits."""
    ck = (key, str(device))
    t = cache.get(ck)
    if t is None:
        arr = np.ascontiguousarray(make())
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        t = cache[ck] = torch.from_numpy(arr.copy()).to(device)
    return t
