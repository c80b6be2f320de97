"""Build kernel units with nvcc and load them with ctypes.

A unit is one ``.cu`` text: the csrc headers, the wrapper's prologue, the
fragment's generated body and a skeleton, in that order.  It compiles to
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), named by a hash of its full text and the compiler flags,
in ``build/kernels/`` at the root of the checkout.  A unit is built once;
every later request, in this process or another, loads the cached
library.  :func:`build_all` runs one nvcc per distinct unit concurrently.

A fixed unit (:func:`fixed_unit`) is one csrc file on its own, with no
generated body: the attention kernels.  It builds with the same flags;
its inner products call ``fmaf`` by name, which ``--fmad=false`` leaves
fused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List

import torch

from repro_torch.kernels import KernelBudgetError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
# --fmad=false: the plain PyTorch version rounds a*b+c twice; a fused
# multiply-add would round once and could flip a predicate at its edge.

#: nvcc invocations made by this process (a cached library costs none).
builds = 0

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, ctypes._CFuncPtr] = {}


@functools.lru_cache(maxsize=None)
def header(name: str) -> str:
    return (CSRC / name).read_text()


def unit_source(prologue: str, body_src: str, skeleton: str) -> str:
    """The full text of one kernel unit."""
    return "\n".join([header("flare_common.cuh"), prologue,
                      header("flare_grouped.cuh"), body_src,
                      header(skeleton)])


def fixed_unit(name: str) -> str:
    """The full text of a fixed unit: ``csrc/<name>`` alone."""
    return header(name)


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit at first use")
    return found


def library_path(src: str) -> Path:
    h = hashlib.sha256(src.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"flare_{h.hexdigest()[:24]}.so"


def build(src: str) -> Path:
    """Compile ``src`` unless its library is already built; returns it."""
    global builds
    path = library_path(src)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    cu = path.with_suffix(f".{tag}.cu")
    tmp = path.with_suffix(f".{tag}.tmp")
    cu.write_text(src)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                               str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu.name}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, path)
        with _lock:
            builds += 1
    finally:
        if tmp.exists():
            tmp.unlink()
    cu.unlink()
    return path


def build_all(sources: Iterable[str]) -> List[Path]:
    """Build every distinct unit, one nvcc process each, concurrently."""
    todo = sorted(set(sources))
    if not todo:
        return []
    workers = min(len(todo), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(build, todo))


def load(src: str) -> ctypes.CDLL:
    """The loaded library of unit ``src`` (built on first use)."""
    lib = _libs.get(src)
    if lib is None:
        lib = ctypes.CDLL(str(build(src)))
        with _lock:
            _libs[src] = lib
    return lib


def entry(src: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``name`` of unit ``src``, loaded and typed once."""
    key = (src, name)
    fn = _entries.get(key)
    if fn is None:
        fn = getattr(load(src), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        with _lock:
            _entries[key] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _device_facts(index: int):
    props = torch.cuda.get_device_properties(index)
    return (props.major, props.minor), props.multi_processor_count


def check_device(t: torch.Tensor) -> None:
    """The units are built for sm_90a only."""
    cap, _ = _device_facts(t.device.index or 0)
    if cap < (9, 0):
        raise KernelBudgetError(
            f"the CUDA kernels are built for sm_90a (Hopper); device "
            f"{t.device} has compute capability {cap[0]}.{cap[1]}")


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of ``t``'s device."""
    return _device_facts(t.device.index or 0)[1]


def n_blocks(t: torch.Tensor, n: int, threads: int = 256,
             per_sm: int = 4) -> int:
    """Grid of a grid-stride kernel: about ``per_sm`` blocks per SM,
    fewer when ``n`` rows need fewer."""
    _, sms = _device_facts(t.device.index or 0)
    return max(1, min(per_sm * sms, -(-n // threads)))


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def ptr_array(ts) -> ctypes.Array:
    return (ctypes.c_void_p * max(1, len(ts)))(*[t.data_ptr() for t in ts])


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
