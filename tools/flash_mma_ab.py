"""A/B builds of the tensor-core flash unit on one card.

    python3 tools/flash_mma_ab.py OTHER.cuh [OTHER.cuh ...]

Build A is this checkout's ``src/repro_torch/kernels/csrc/
flash_attention_mma.cuh``; each argument is another full text of that unit
(for example the parent commit's, from ``git show``).  For each build it
prints what ``nvcc -Xptxas -v`` reports (registers and spill bytes by head
width); then, on seeded bf16 inputs at every width of ``MMA_D``, whether
each build's output equals A's bit for bit and how far A lies from the
plain version (one bf16 rounding is 1.0); then the CUDA-event median ms of
each build at recurrentgemma-2b's layer shape (B 8 x H 10 (Hkv 1) x S 2048
x D 256, causal) and pixtral-12b's (B 8 x H 32 (Hkv 8) x S 2304 x D 160),
in turns (A B .. B A), beside the card's name and power limit.  Needs a
CUDA card and nvcc; exits 1 if a build fails, differs from A at a width
both take, or A misses the limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import cuda_build as CB  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FL  # noqa: E402

SHAPES = [(1, 2, 1, 1), (2, 4, 1, 97), (2, 8, 2, 300), (1, 8, 2, 1000)]
TIMED = {"recurrentgemma-2b D 256": (8, 10, 1, 2048, 256),
         "pixtral-12b D 160": (8, 32, 8, 2304, 160)}


def ptxas(src: str) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "unit.cu")
        with open(cu, "w") as f:
            f.write(src)
        p = subprocess.run([CB.nvcc_path(), *CB.NVCC_FLAGS, "-Xptxas", "-v",
                            "-o", os.path.join(tmp, "unit.so"), cu],
                           capture_output=True, text=True)
    if p.returncode:
        sys.exit(f"nvcc failed:\n{p.stderr[-3000:]}")
    return [ln.strip() for ln in p.stderr.splitlines()
            if "Compiling entry" in ln or "spill" in ln or "Used" in ln]


def caller(src: str):
    fn = CB.entry(src, "flare_flash_attention_mma", FL._MMA_ARGS)

    def call(q, k, v, causal=True):
        b, h, s, d = q.shape
        out = torch.empty_like(q)
        err = fn(CB.ptr(q), CB.ptr(k), CB.ptr(v), CB.ptr(out), b * h,
                 b * k.shape[1], s, d, int(causal), float(d ** -0.5),
                 CB.stream(q))
        return out if err == 0 else None     # a width the build lacks
    return call


def excess(got, want) -> float:
    got, want = got.double(), want.double()
    limit = 2.0 ** -7 * want.abs() + 1e-3 * float(want.abs().max())
    return float(((got - want).abs() / limit).max())


def median_ms(fn, runs: int = 30) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return sorted(times)[runs // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_mma_ab: needs a CUDA card", file=sys.stderr)
        return 1
    srcs = {"A": CB.fixed_unit("flash_attention_mma.cuh")}
    for i, path in enumerate(sys.argv[1:]):
        with open(path) as f:
            srcs[chr(ord("B") + i)] = f.read()
    for name, src in srcs.items():
        print(f"[ptxas] {name}:\n  " + "\n  ".join(ptxas(src)))
    calls = {name: caller(src) for name, src in srcs.items()}
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for d in FL.MMA_D:
        for b, h, hkv, s in SHAPES:
            for causal in (True, False):
                q, k, v = (torch.randn(b, n, s, d, generator=g,
                                       device="cuda").bfloat16()
                           for n in (h, hkv, hkv))
                outs = {n: c(q, k, v, causal) for n, c in calls.items()}
                torch.cuda.synchronize()
                if outs["A"] is None:
                    print(f"flash_mma_ab: A refused D {d}", file=sys.stderr)
                    return 1
                e = excess(outs["A"], FL.flash_attention_plain(
                    q, k, v, causal=causal))
                same = {n: (None if o is None else torch.equal(o, outs["A"]))
                        for n, o in outs.items() if n != "A"}
                ok &= e <= 1.0 and all(x is not False for x in same.values())
                print(f"[check] D {d} B {b} H {h} (Hkv {hkv}) S {s} "
                      f"causal={causal}: A err/limit {e:.4f}, equal to A "
                      f"{json.dumps(same)}")
    for label, (b, h, hkv, s, d) in TIMED.items():
        q, k, v = (torch.randn(b, n, s, d, generator=g,
                               device="cuda").bfloat16()
                   for n in (h, hkv, hkv))
        order = list(calls) + list(calls)[::-1]
        ms = {n: [] for n in calls}
        for n in order:
            if calls[n](q, k, v) is not None:
                ms[n].append(median_ms(lambda: calls[n](q, k, v)))
        print(f"[time] {label}, causal, ms in turns: {json.dumps(ms)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
