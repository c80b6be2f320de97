"""Training CLI: the whole train step with full fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt  # reduced
    PYTHONPATH=src python -m repro_torch.launch.train --full \
        --steps 20 --batch 4 --seq 4096 --n-docs 400          # on the card

The JAX package's ``launch/train.py``: checkpoint/restart with exact
data-stream resume, fault injection + supervisor restarts, the straggler
watchdog, the same checkpoint cadence.  It runs on the card unless
``--device cpu`` is given.  One device: ``--model-parallel`` above 1
raises.  Unlike the reference's ``--reduced``, which cannot be turned
off, ``--full`` trains the full-width config.  ``train_loop`` also
returns each step's seconds and the checkpoints' save and restore ms,
and, for an MoE config, each step's load-balancing aux loss (``aux``,
also in the log lines).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get
from repro_torch.data.pipeline import LMDataPipeline
from repro_torch.distributed.shardings import null_ctx
from repro_torch.launch.steps import (abstract_train_state, init_train_state,
                                      make_train_step)
from repro_torch.launch.supervisor import (FaultInjected, StepWatchdog,
                                           run_supervised)
from repro_torch.models import param as PM
from repro_torch.models.modeling import Model
from repro_torch.optim import AdamWConfig, warmup_cosine


@dataclasses.dataclass
class TrainRun:
    arch: str = "qwen3-0.6b"
    reduced: bool = True
    steps: int = 50
    batch: int = 8
    seq: int = 128
    lr: float = 3e-3
    warmup: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    seed: int = 0
    fault_prob: float = 0.0          # injected failure rate per step
    model_parallel: int = 1
    log_every: int = 10
    n_docs: int = 200
    device: str = "cuda"

    # populated during run
    losses: list = dataclasses.field(default_factory=list)
    restarts_seen: int = 0


def train_state_from_numpy(model: Model, host_state: Dict) -> Dict:
    """A train state of numpy arrays -- the JAX package's, or what
    ``CheckpointManager.restore`` gives -- on the model's device: the
    parameters through ``params_from_numpy`` (checked leaf by leaf against
    the spec), ``m`` and ``v`` in f32 with the parameters' leaves, the
    step as a 0-d int32."""
    params = model.params_from_numpy(host_state["params"])
    opt = host_state["opt"]

    def moments(tree):
        got = dict(PM.tree_items(tree))
        if got.keys() != dict(PM.tree_items(params)).keys():
            raise ValueError("train_state_from_numpy: the moments' leaves "
                             "differ from the parameters'")
        return PM.tree_unflatten(
            (path, torch.tensor(np.asarray(got[path], np.float32),
                                device=model.device))
            for path, _ in PM.tree_items(params))

    step = torch.tensor(np.asarray(opt["step"], np.int32),
                        device=model.device).reshape(())
    return {"params": params,
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "step": step}}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_loop(run: TrainRun) -> Dict:
    if run.model_parallel != 1:
        raise ValueError(f"model_parallel={run.model_parallel}: the port "
                         f"trains on one device")
    cfg = get(run.arch)
    if run.reduced:
        cfg = cfg.reduced(remat="none")
    model = Model(cfg, run.device)
    dev = model.device
    opt = AdamWConfig(lr=warmup_cosine(run.lr, run.warmup, run.steps))
    step_fn = make_train_step(model, opt, null_ctx())

    pipe = LMDataPipeline.synthetic(run.seq, run.batch, n_docs=run.n_docs,
                                    seed=run.seed, device=dev)
    mgr = (CheckpointManager(run.ckpt_dir) if run.ckpt_dir else None)
    ckpt = {"save_ms": [], "restore_ms": None,
            "bytes": PM.tree_bytes(abstract_train_state(model))}

    # resume if possible ------------------------------------------------------
    start_step = 0
    state = None
    if mgr is not None and mgr.latest_step() is not None:
        t0 = time.perf_counter()
        start_step, host_state, extra = mgr.restore(
            abstract_train_state(model))
        pipe.load_state(extra["pipeline"])
        state = train_state_from_numpy(model, host_state)
        del host_state
        _sync(dev)
        ckpt["restore_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"[train] resumed from step {start_step}")
    if state is None:
        state = init_train_state(model, run.seed)

    # fault-injection rng must differ across restart attempts, or the
    # same fault replays forever from the same resume point
    rng = np.random.default_rng(
        run.seed + start_step + 7919 * run.restarts_seen)
    watchdog = StepWatchdog()
    moe = cfg.family == "moe"
    auxes = []
    for step in range(start_step, run.steps):
        batch = pipe.next_batch()
        if rng.random() < run.fault_prob:
            raise FaultInjected(f"injected fault at step {step}")
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        watchdog.observe(step, time.perf_counter() - t0)
        run.losses.append(loss)
        if moe:
            auxes.append(float(metrics["aux"]))
        if step % run.log_every == 0 or step == run.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  + (f"aux {auxes[-1]:.4f} " if moe else "")
                  + f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}",
                  flush=True)
        if mgr is not None and ((step + 1) % run.ckpt_every == 0
                                or step == run.steps - 1):
            t0 = time.perf_counter()
            mgr.save(step + 1, state,
                     extra={"pipeline": pipe.state_dict(),
                            "losses_tail": run.losses[-5:]})
            ckpt["save_ms"].append((time.perf_counter() - t0) * 1e3)
    return {"final_loss": run.losses[-1] if run.losses else float("nan"),
            "losses": run.losses, "straggler_events": watchdog.events,
            "step_s": watchdog.times, "start_step": start_step,
            "checkpoint": ckpt, **({"aux": auxes} if moe else {})}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainRun):
        if f.name in ("losses", "restarts_seen"):
            continue
        flag = "--" + f.name.replace("_", "-")
        if f.name == "reduced":
            ap.add_argument(flag, action="store_true", default=True,
                            help="the reduced smoke config (the default)")
            ap.add_argument("--full", dest="reduced", action="store_false",
                            help="the full-width config")
        elif f.name == "ckpt_dir":
            ap.add_argument(flag, type=str, default=None)
        else:
            ap.add_argument(flag, type=type(f.default), default=f.default)
    args = ap.parse_args(argv)
    run = TrainRun(**{f.name: getattr(args, f.name)
                      for f in dataclasses.fields(TrainRun)
                      if f.name not in ("losses", "restarts_seen")})

    def once():
        out = train_loop(run)
        print(f"[train] done: final loss {out['final_loss']:.4f}; "
              f"stragglers {len(out['straggler_events'])}")

    def on_restart(n, e):
        run.restarts_seen = n

    restarts = run_supervised(once, max_restarts=10 if run.fault_prob
                              else 0, on_restart=on_restart)
    print(f"[train] supervisor restarts: {restarts}")


if __name__ == "__main__":
    main()
