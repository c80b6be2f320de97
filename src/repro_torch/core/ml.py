"""OptiML-analogue ML kernels (Flare Level 3, paper sections 5.2 / 6.2).

The paper compiles heterogeneous pipelines -- relational ETL feeding
iterative ML kernels -- into one program via Delite/DMLL.  Here the
kernels are plain functions over torch tensors that the plan language
embeds as :class:`repro_torch.core.plan.IterativeKernel` nodes
(``df.train(...)``): under the ``compiled`` engine the relational
operators and the training loop run in ONE function on the device, the
relational columns never leaving it.

Kernels reproduced from the paper's evaluation: k-means (Fig. 8), logistic
regression, Gaussian Discriminant Analysis (Fig. 13), plus the
``untilconverged`` / ``dist`` / ``group_by_reduce`` OptiML building blocks.

Two differences from the JAX package, both deliberate:

* :func:`group_by_reduce` accumulates in float64 and returns float32
  (the port's rule for grouped sums: a float32 accumulator far larger
  than its addends stops growing at 10 M rows);
* unweighted :func:`kmeans` draws its seeds from a ``torch.Generator``,
  so its initial centroids differ from the JAX package's threefry draw.
  The pipeline path always passes weights and starts from the first
  valid rows, which match bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# OptiML building blocks
# ---------------------------------------------------------------------------


def dist(x: torch.Tensor, y: torch.Tensor, kind: str = "SQUARE"
         ) -> torch.Tensor:
    """Pairwise distance of rows of x [n,d] against rows of y [k,d]."""
    if kind != "SQUARE":
        raise ValueError(kind)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)          # [n,1]
    y2 = torch.sum(y * y, dim=-1)[None, :]                # [1,k]
    return x2 + y2 - 2.0 * (x @ y.T)


def _f32(v) -> float:
    """``v`` (a Python number or a 0-d tensor) rounded to float32, as a
    Python float: the loop compares in float32, as XLA does."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    return float(np.float32(v))


def until_converged(init, body: Callable, tol, max_iter,
                    diff: Callable = None):
    """``untilconverged_withdiff`` analogue as a host loop.

    ``body(state) -> state``; ``diff(old, new) -> scalar``.  The diff
    starts at +inf; the loop continues while ``iters < max_iter`` and
    ``diff >= tol`` (a NaN diff stops it).  Each iteration reads the
    diff back to the host once (one 4-byte copy).  ``tol`` and
    ``max_iter`` may be 0-d tensors (``param()`` bindings): they are read
    once, before the loop.  Returns (state, iters) with ``iters`` an
    int32 0-d tensor.
    """
    if diff is None:
        diff = lambda a, b: torch.max(torch.abs(a - b))
    tol = _f32(tol)
    max_iter = int(max_iter)
    state, iters, d = init, 0, math.inf
    while iters < max_iter and d >= tol:
        new = body(state)
        d = _f32(diff(state, new))
        state, iters = new, iters + 1
    dev = state.device if isinstance(state, torch.Tensor) else None
    return state, torch.tensor(iters, dtype=torch.int32, device=dev)


def _onehot_sums(keys: torch.Tensor, values: torch.Tensor, w: torch.Tensor,
                 num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group sums and counts as one [k, n] @ [n(, d)] product in float64;
    keys outside the groups meet an all-zero column.  A non-finite value
    poisons every group's sum (it meets 0 in the other rows)."""
    groups = torch.arange(num_groups, dtype=keys.dtype, device=keys.device)
    onehot = (keys[None, :] == groups[:, None]).double() * w.double()
    return onehot @ values.double(), onehot.sum(dim=1)


def _index_add_sums(keys: torch.Tensor, values: torch.Tensor,
                    w: torch.Tensor, num_groups: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group sums and counts by ``index_add_`` onto float64 rows."""
    ok = (keys >= 0) & (keys < num_groups)
    idx = torch.where(ok, keys, 0).long()
    w = torch.where(ok, w, 0).double()
    vals = values.double() * (w[:, None] if values.ndim > 1 else w)
    dev = values.device
    sums = torch.zeros((num_groups,) + tuple(values.shape[1:]),
                       dtype=torch.float64, device=dev)
    counts = torch.zeros(num_groups, dtype=torch.float64, device=dev)
    return sums.index_add_(0, idx, vals), counts.index_add_(0, idx, w)


#: the two routes of :func:`group_by_reduce`
GROUP_ROUTES = {"onehot": _onehot_sums, "index_add": _index_add_sums}
#: the most groups the one-hot route takes: its [k, n] float64 matrix
#: grows with k while ``index_add_``'s atomics spread over more rows.
#: ``chip_smoke.py`` phase 9 times both at 10 M x 8 on an H100: one-hot
#: faster up to k 32 (7.1 against 13.2 ms), ``index_add_`` at k 64 (7.6
#: against 13.3)
ONEHOT_MAX_GROUPS = 32


def group_route(num_groups: int) -> str:
    """The route :func:`group_by_reduce` takes for ``num_groups``: the
    one-hot product for few groups (every ``index_add_`` atomic would
    land on k x d addresses), ``index_add_`` for many."""
    return "onehot" if num_groups <= ONEHOT_MAX_GROUPS else "index_add"


def group_by_reduce(keys: torch.Tensor, values: torch.Tensor,
                    num_groups: int,
                    weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DMLL GroupByReduce: per-group sums and counts over dense int keys.

    With ``weights`` (0/1 validity weights from a relational mask, or
    fractional sample weights), sums and counts are weighted -- padded
    invalid rows contribute nothing, so the padded computation matches
    the compacted one exactly.  Keys outside ``[0, num_groups)``
    contribute nothing, as ``jax.ops.segment_sum`` drops them.  Sums
    accumulate in float64 (:func:`group_route` picks how) and return in
    ``values``' dtype.
    """
    w = (torch.ones(keys.shape[0], dtype=values.dtype, device=values.device)
         if weights is None else weights.to(values.dtype))
    sums, counts = GROUP_ROUTES[group_route(num_groups)](keys, values, w,
                                                         num_groups)
    return sums.to(values.dtype), counts.to(values.dtype)


def _first_valid_rows(x: torch.Tensor, w: torch.Tensor, k: int
                      ) -> torch.Tensor:
    """The first ``k`` rows with nonzero weight -- a deterministic,
    mask-invariant initialisation: padded-and-masked inputs pick the same
    rows as their compacted counterparts (differential testability).
    With fewer than ``k`` valid rows, surplus seeds duplicate the LAST
    valid row on both paths (never a padded invalid row)."""
    if x.shape[0] == 0:  # degenerate empty input: origin seeds
        return torch.zeros((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device)
    cw = torch.cumsum((w > 0).to(torch.int32), 0, dtype=torch.int32)
    n_valid = torch.clamp(cw[-1], min=1)
    targets = torch.minimum(
        torch.arange(1, k + 1, dtype=torch.int32, device=x.device), n_valid)
    idx = torch.searchsorted(cw, targets)  # left side, as jnp's default
    return x[torch.clamp(idx, 0, x.shape[0] - 1)]


# ---------------------------------------------------------------------------
# kernels from the paper's evaluation
# ---------------------------------------------------------------------------


class KMeansResult(NamedTuple):
    centroids: torch.Tensor
    assignments: torch.Tensor
    iters: torch.Tensor


def kmeans(x: torch.Tensor, k: int, tol: float = 1e-3,
           max_iter: int = 100, seed: int = 0,
           weights: Optional[torch.Tensor] = None) -> KMeansResult:
    """Paper Fig. 8: findNearestCluster + untilconverged + groupByReduce.

    ``weights`` (relational validity mask or sample weights) makes the
    update weighted and switches initialisation to the first k valid
    rows, so padded (compiled-engine) and compacted (volcano oracle)
    executions converge identically.  Without weights the k seeds are
    rows drawn by a ``torch.Generator`` seeded with ``seed`` on ``x``'s
    device: they differ from the JAX package's seeds.
    """
    m = x.shape[0]
    if weights is None:
        gen = torch.Generator(device=x.device).manual_seed(int(seed))
        mu0 = x[torch.randint(0, m, (k,), generator=gen, device=x.device)]
    else:
        mu0 = _first_valid_rows(x, weights, k)

    def assign(mu):
        return torch.argmin(dist(x, mu), dim=1).to(torch.int32)

    def body(mu):
        c = assign(mu)
        sums, counts = group_by_reduce(c, x, k, weights)   # [k,d], [k]
        return sums / torch.clamp(counts[:, None], min=1.0)

    def mu_diff(a, b):
        return torch.sum(dist(a, b).diagonal())

    mu, iters = until_converged(mu0, body, tol, max_iter, mu_diff)
    return KMeansResult(mu, assign(mu), iters)


class LogRegResult(NamedTuple):
    weights: torch.Tensor
    iters: torch.Tensor


def logreg(x: torch.Tensor, y: torch.Tensor, lr: float = 0.1,
           tol: float = 1e-4, max_iter: int = 200,
           weights: Optional[torch.Tensor] = None) -> LogRegResult:
    """Batch-gradient logistic regression (paper Fig. 13 'LogReg').

    With ``weights``, the gradient is the weighted mean: zero-weight
    (masked) rows drop out exactly, so padded execution matches
    compacted execution.
    """
    n, d = x.shape
    sw = (torch.ones((n,), dtype=x.dtype, device=x.device)
          if weights is None else weights.to(x.dtype))
    n_eff = torch.clamp(torch.sum(sw), min=1.0)

    def body(w):
        p = torch.sigmoid(x @ w)
        grad = x.T @ ((p - y) * sw) / n_eff
        return w - lr * grad

    w, iters = until_converged(
        torch.zeros((d,), dtype=x.dtype, device=x.device), body, tol,
        max_iter)
    return LogRegResult(w, iters)


class GDAResult(NamedTuple):
    phi: torch.Tensor
    mu0: torch.Tensor
    mu1: torch.Tensor
    sigma: torch.Tensor


def gda(x: torch.Tensor, y: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> GDAResult:
    """Gaussian Discriminant Analysis (paper Fig. 13 'GDA'); closed form."""
    n = x.shape[0]
    y1 = y.to(x.dtype)
    sw = (torch.ones((n,), dtype=x.dtype, device=x.device)
          if weights is None else weights.to(x.dtype))
    n_eff = torch.clamp(torch.sum(sw), min=1.0)
    n1 = torch.sum(y1 * sw)
    n0 = n_eff - n1
    phi = n1 / n_eff
    mu0 = torch.sum(x * ((1 - y1) * sw)[:, None], dim=0) / torch.clamp(
        n0, min=1)
    mu1 = torch.sum(x * (y1 * sw)[:, None], dim=0) / torch.clamp(n1, min=1)
    centered = x - torch.where(y1[:, None] > 0, mu1[None], mu0[None])
    sigma = centered.T @ (centered * sw[:, None]) / n_eff
    return GDAResult(phi, mu0, mu1, sigma)


def gene_barcode(counts: torch.Tensor, barcodes: torch.Tensor,
                 num_genes: int) -> torch.Tensor:
    """Stand-in for the paper's 'Gene' app: per-gene barcode histogram via
    GroupByReduce (a pure data-parallel aggregation workload)."""
    sums, _ = group_by_reduce(barcodes, counts, num_genes)
    return sums


# ---------------------------------------------------------------------------
# the kernel registry behind df.train(...) / plan.IterativeKernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrainKernel:
    """A named, plan-embeddable training kernel.

    ``fn(x, weights=..., **hyper)`` for unsupervised kernels,
    ``fn(x, y, weights=..., **hyper)`` when ``needs_labels``.  ``weights``
    carries the relational validity mask, so the same function runs
    padded (fused whole-query function) or compacted (interpreters) with
    identical results.  The name keys compile-cache fingerprints
    (``plan.IterativeKernel.fingerprint``), so register distinct logic
    under distinct names.
    """

    name: str
    fn: Callable[..., Any]
    needs_labels: bool = False

    def __call__(self, x, y=None, weights=None, **hyper):
        if self.needs_labels:
            if y is None:
                raise TypeError(f"kernel {self.name!r} needs labels; "
                                "pass label=... to df.train()")
            return self.fn(x, y, weights=weights, **hyper)
        return self.fn(x, weights=weights, **hyper)


TRAIN_KERNELS: Dict[str, TrainKernel] = {}


def register_kernel(name: str, fn: Callable[..., Any],
                    needs_labels: bool = False) -> TrainKernel:
    k = TrainKernel(name, fn, needs_labels)
    TRAIN_KERNELS[name] = k
    return k


def train_kernel(kernel) -> TrainKernel:
    """Resolve a kernel spec: a TrainKernel, a registered name, or a
    bare callable (registered ad hoc under its ``__name__``)."""
    if isinstance(kernel, TrainKernel):
        return kernel
    if isinstance(kernel, str):
        try:
            return TRAIN_KERNELS[kernel]
        except KeyError:
            raise ValueError(
                f"unknown training kernel {kernel!r}; registered: "
                f"{sorted(TRAIN_KERNELS)}") from None
    if callable(kernel):
        name = getattr(kernel, "__name__", None)
        if name in TRAIN_KERNELS and TRAIN_KERNELS[name].fn is kernel:
            return TRAIN_KERNELS[name]
        return TrainKernel(name or f"kernel@{id(kernel):x}", kernel)
    raise TypeError(f"cannot resolve training kernel from {kernel!r}")


def to_host(value):
    """A kernel's result with every tensor as a host numpy array
    (NamedTuples, dicts, lists and tuples keep their shape)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_host(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(to_host(v) for v in value)
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    return np.asarray(value)


register_kernel("kmeans", kmeans)
register_kernel("logreg", logreg, needs_labels=True)
register_kernel("gda", gda, needs_labels=True)
