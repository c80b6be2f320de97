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

A unit may also come from the persistent artifact store
(``repro_torch.persist``): :func:`load_library` takes its library's
bytes, writes them once to a file named by their own hash (``ctypes``
loads files) and registers the loaded library for the unit's source, so
neither :func:`build` nor nvcc runs for it in this process.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

from repro_torch.kernels import UnsupportedDeviceError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
# --fmad=false: the plain PyTorch version rounds a*b+c twice; a fused
# multiply-add would round once and could flip a predicate at its edge.

#: nvcc invocations made by this process (a cached library costs none).
builds = 0

#: Libraries this process loaded from store bytes (:func:`load_library`).
store_loads = 0

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# unit source -> the file its loaded library came from
_lib_files: Dict[str, Path] = {}
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


class UnitBuildError(RuntimeError):
    """nvcc refused a kernel unit.  A real build failure: the degradation
    ladder never absorbs it (``repro_torch.resilience.degrade``)."""


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit at first use")
    return found


@functools.lru_cache(maxsize=None)
def nvcc_release() -> Optional[str]:
    """The CUDA toolkit release nvcc builds with (``version.json`` beside
    the toolkit's ``bin/``, else ``nvcc --version``); None without one."""
    try:
        nvcc = nvcc_path()
    except RuntimeError:
        return None
    meta = Path(nvcc).resolve().parents[1] / "version.json"
    try:
        return json.loads(meta.read_text())["cuda_nvcc"]["version"]
    except (OSError, KeyError, TypeError, ValueError):
        pass
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else None


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
            raise UnitBuildError(f"nvcc failed on {cu.name}:\n"
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
    """Build every distinct unit, one nvcc process each, concurrently.
    A unit whose library is already loaded (from the store) is skipped."""
    todo = sorted(set(sources) - set(_libs))
    if not todo:
        return []
    workers = min(len(todo), os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(build, todo))


def load(src: str) -> ctypes.CDLL:
    """The loaded library of unit ``src`` (built on first use)."""
    lib = _libs.get(src)
    if lib is None:
        path = build(src)
        lib = ctypes.CDLL(str(path))
        with _lock:
            _libs[src] = lib
            _lib_files[src] = path
    return lib


def library_bytes(src: str) -> Optional[bytes]:
    """The library of unit ``src`` as bytes: the file it was loaded from,
    else its build output; None when neither exists."""
    path = _lib_files.get(src, library_path(src))
    try:
        return path.read_bytes()
    except OSError:
        return None


def load_library(src: str, data: bytes) -> ctypes.CDLL:
    """Load unit ``src`` from its library's bytes (a store artifact).

    The bytes go to a file named by their own sha256, written once and
    atomically, never by the artifact's digest: a replaced artifact has
    other bytes, hence another file, so ``ctypes`` can never hand back
    its handle of the old one.  Runs no nvcc (``builds`` is unchanged);
    counts ``store_loads``.  A unit already loaded keeps its library."""
    global store_loads
    lib = _libs.get(src)
    if lib is not None:
        return lib
    path = BUILD_DIR / "store" / (
        f"flare_lib_{hashlib.sha256(data).hexdigest()[:32]}.so")
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}_{threading.get_ident()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    with _lock:
        _libs[src] = lib
        _lib_files[src] = path
        store_loads += 1
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
        raise UnsupportedDeviceError(
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
