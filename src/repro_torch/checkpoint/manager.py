"""Atomic, hashed, resumable checkpoints in the JAX package's format.

The on-disk layout is the JAX package's (``repro/checkpoint/manager.py``),
so a checkpoint written by either package restores in the other:

* **atomic**: writes go to ``<dir>/tmp.<step>`` and are renamed to
  ``<dir>/step_%010d`` only after every file is flushed and the manifest
  is written -- a crash mid-save never corrupts the latest checkpoint;
* **verified**: each leaf is one raw little-endian file whose SHA-256 is
  in ``manifest.json`` with its name, shape and dtype string; a partial or
  bit-rotted checkpoint is detected at restore and skipped (restore falls
  back to the previous step);
* **complete**: the caller's ``extra`` (the data-pipeline cursor, ...)
  rides in the manifest;
* **retained**: the last ``keep`` checkpoints stay.

Leaves are written and read by a pool of threads, one file each.

A leaf's name is its ``"/"``-joined dict path (``params/layers/attn/wq``,
``opt/step``; :func:`repro_torch.models.param.flatten_with_paths`).
Tensors go to the host once each (``.cpu().numpy()``); a bf16 tensor is
written as its raw bits under the dtype string ``bfloat16``, as the JAX
package writes one.  :meth:`CheckpointManager.restore` gives numpy arrays,
as the reference does (a ``bfloat16`` leaf comes back as the exact f32
widening: numpy has no bf16), and the trainer puts them on its device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.param import flatten_with_paths, tree_items, \
    tree_unflatten

BF16 = "bfloat16"


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a C-contiguous host array, its dtype string)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:     # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    return arr, str(arr.dtype)


def _from_buffer(buf: bytearray, dtype: str, shape) -> np.ndarray:
    """The array over ``buf`` (writable, so no copy is needed)."""
    if dtype == BF16:
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _pool() -> ThreadPoolExecutor:
    """Threads for the leaves' files: the device-to-host copies, file I/O
    and sha256 of large buffers release the GIL, so leaves overlap."""
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -------------------------------------------------------------------

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> str:
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def write(item):
            name, leaf = item
            arr, dtype = _host(leaf)
            fname = name.replace("/", "__") + ".bin"
            buf = memoryview(arr.reshape(-1)).cast("B")   # no copy
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(buf)
                f.flush()
                os.fsync(f.fileno())
            return {"name": name, "file": fname, "shape": list(arr.shape),
                    "dtype": dtype,
                    "sha256": hashlib.sha256(buf).hexdigest()}

        with _pool() as pool:
            arrays = list(pool.map(write, flatten_with_paths(state)))
        manifest = {"step": step, "extra": extra or {}, "arrays": arrays}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory,
                                       f"step_{s:010d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def list_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[int, Any, Dict]:
        """Restore into the structure of ``template`` (a nested dict of
        anything: tensors, ``meta`` tensors, arrays, specs); verifies
        hashes and returns ``(step, state of numpy arrays, extra)``.

        Falls back to earlier checkpoints if the newest is corrupt."""
        candidates = self.list_steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        for s in reversed(candidates):
            try:
                return self._restore_one(template, s)
            except (IOError, ValueError, KeyError) as e:
                print(f"[ckpt] step {s} unusable ({e}); trying earlier")
        raise FileNotFoundError(
            f"no usable checkpoint in {self.directory}")

    def _restore_one(self, template, step: int):
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {a["name"]: a for a in manifest["arrays"]}

        def read(name):
            meta = by_name[name]
            fpath = os.path.join(d, meta["file"])
            buf = bytearray(os.path.getsize(fpath))  # writable: no copy
            with open(fpath, "rb") as f:
                f.readinto(buf)
            if hashlib.sha256(buf).hexdigest() != meta["sha256"]:
                raise ValueError(f"hash mismatch for {name}")
            return _from_buffer(buf, meta["dtype"], meta["shape"])

        paths = [p for p, _ in tree_items(template)]
        names = [n for n, _ in flatten_with_paths(template)]
        with _pool() as pool:
            leaves = list(zip(paths, pool.map(read, names)))
        return manifest["step"], tree_unflatten(leaves), \
            manifest.get("extra", {})
