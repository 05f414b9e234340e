"""Batched scenario engine: many independent small LPs per launch, sharded
across devices.

Two device routes solve a batch (`routes.batched_route` picks one):

* ``"triton"`` — the one-LP-per-program Pallas kernel
  (`ops/kernels/batched_simplex.py`), on the GPU inside its envelope;
* ``"xla"`` — the general simplex engine `vmap`ped over the batch
  (`solve_batch`), run in f32 with `Precision.HIGHEST` products.

Both iterate in f32 and return only combinatorial outputs (basis, vstat,
status); every lane is then certified exactly in host f64 (`verify_f64`),
and the rare lane that fails is re-solved by scipy-HiGHS
(`resolve_unverified_host`), so callers always get exact answers.

`solve_batch` itself (f64, vmapped) is also the data-parallel building block
of `solve_batch_sharded`: the batch axis sharded over the mesh's 'data' axis,
no cross-LP communication.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import routes
from ..engine.primal import solve_canonical
from ..engine.state import SimplexState
from ..options import SolverOptions, f32_iterate_options
from ..status import Status, VarStat
from .mesh import batch_sharding


class BatchResult(NamedTuple):
    basis: np.ndarray     # (B, m) int — final basis
    vstat: np.ndarray     # (B, n) int — final variable statuses
    status: np.ndarray    # (B,) int32
    niter: np.ndarray     # (B,) int32
    obj: np.ndarray       # (B,) f64 — exact objective (f64 recompute)
    verified: np.ndarray  # (B,) bool — f64 optimality certificate held
    x: np.ndarray         # (B, n) f64 — exact vertex (f64 recompute)
    #: (B,) bool — lanes the f32 iterate did not certify, re-solved by HiGHS
    host_resolved: np.ndarray | None = None


@partial(jax.jit, static_argnames=("opts",))
def solve_batch(
    A: jnp.ndarray,      # (B, M, N)
    b: jnp.ndarray,      # (B, M)
    c: jnp.ndarray,      # (B, N)
    lo: jnp.ndarray,     # (B, N)
    hi: jnp.ndarray,     # (B, N)
    vstat0: jnp.ndarray,  # (B, N) int8
    basis0: jnp.ndarray,  # (B, M) int32
    opts: SolverOptions,
) -> SimplexState:
    """Solve B independent canonical LPs; returns a batched SimplexState."""
    return jax.vmap(
        lambda *args: solve_canonical(*args, opts)
    )(A, b, c, lo, hi, vstat0, basis0)


def solve_batch_sharded(mesh, A, b, c, lo, hi, vstat0, basis0, opts) -> SimplexState:
    """Same, with the batch axis sharded over the mesh's 'data' axis (pure DP).

    XLA inserts no collectives at all here — each device solves its slice of
    the batch; only the caller's reductions communicate.
    """
    sh = batch_sharding(mesh)
    args = [jax.device_put(x, sh) for x in (A, b, c, lo, hi, vstat0, basis0)]
    return solve_batch(*args, opts=opts)


def verify_f64(A, b, c, lo, hi, basis, vstat, status):
    """Exact f64 vertex + optimality certificate from f32-iterated bases.

    Host numpy: the basis is combinatorial, so the exact vertex is one
    batched f64 LU solve — a few ms for thousands of small LPs.  Returns
    (obj, verified, x).
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    basis = np.asarray(basis)
    vstat = np.asarray(vstat)
    status = np.asarray(status)
    B, m, n = A.shape

    Bmat = np.take_along_axis(A, basis[:, None, :].repeat(m, axis=1), axis=2)
    xN = np.where(vstat == int(VarStat.AT_LOWER), lo, 0.0)
    xN = np.where(vstat == int(VarStat.AT_UPPER), hi, xN)
    xN = np.where(vstat == int(VarStat.FIXED), lo, xN)
    xN = np.where(vstat == int(VarStat.BASIC), 0.0, xN)
    rhs = b - np.einsum("bmn,bn->bm", A, xN)
    try:
        xB = np.linalg.solve(Bmat, rhs[..., None])[..., 0]
        yT = np.linalg.solve(
            np.swapaxes(Bmat, 1, 2),
            np.take_along_axis(c, basis, axis=1)[..., None],
        )[..., 0]
        singular = np.zeros(B, dtype=bool)
    except np.linalg.LinAlgError:
        xB = np.zeros((B, m))
        yT = np.zeros((B, m))
        singular = np.ones(B, dtype=bool)
    d = c - np.einsum("bm,bmn->bn", yT, A)
    loB = np.take_along_axis(lo, basis, axis=1)
    hiB = np.take_along_axis(hi, basis, axis=1)
    pfeas = ((xB >= loB - 1e-7) & (xB <= hiB + 1e-7)).all(axis=1)
    at_lo = vstat == int(VarStat.AT_LOWER)
    at_hi = vstat == int(VarStat.AT_UPPER)
    free = vstat == int(VarStat.FREE)
    dfeas = (
        np.where(at_lo, d >= -1e-7, True)
        & np.where(at_hi, d <= 1e-7, True)
        & np.where(free, np.abs(d) <= 1e-7, True)
    ).all(axis=1)
    obj = (np.take_along_axis(c, basis, axis=1) * xB).sum(axis=1) + (c * xN).sum(axis=1)
    ok = pfeas & dfeas & (status == int(Status.OPTIMAL)) & ~singular
    x = xN.copy()
    np.put_along_axis(x, basis, xB, axis=1)
    return obj, ok, x


def resolve_unverified_host(res, A, b, c, lo, hi):
    """Exact scipy-HiGHS host re-solve of every lane whose f32 basis failed
    f64 certification — the shared tail of all certified batched entry points.

    Returns `res` with the uncertified lanes replaced by the oracle's exact
    answers, so the `verified` mask is all-True unless a lane is genuinely
    pathological for HiGHS too.
    """
    from scipy.optimize import linprog

    verified = np.asarray(res.verified).copy()
    res = res._replace(host_resolved=~verified)
    if verified.all():
        return res
    obj = np.array(res.obj)
    x = np.array(res.x)
    status = np.array(res.status)
    An, bn, cn, lon, hin = [np.asarray(v, dtype=np.float64) for v in (A, b, c, lo, hi)]
    for i in np.flatnonzero(~verified):
        bounds = [
            (lon[i, j] if np.isfinite(lon[i, j]) else None,
             hin[i, j] if np.isfinite(hin[i, j]) else None)
            for j in range(cn.shape[1])
        ]
        r = linprog(cn[i], A_eq=An[i], b_eq=bn[i], bounds=bounds, method="highs")
        if r.status == 0:
            obj[i], x[i] = r.fun, r.x
            status[i], verified[i] = int(Status.OPTIMAL), True
        elif r.status == 2:
            status[i], verified[i] = int(Status.INFEASIBLE), True
        elif r.status == 3:
            status[i], verified[i] = int(Status.UNBOUNDED), True
    return res._replace(obj=obj, x=x, status=status, verified=verified)


@partial(jax.jit, static_argnames=("slack0", "opts"))
def _solve_batch_f32(A, b, c, lo, hi, *, slack0: int, opts: SolverOptions):
    """The plain route: vmapped engine in f32 from the slack basis (initial
    statuses built on device, `canonical.initial_vstat`'s rule)."""
    B, m, n = A.shape
    col = jnp.arange(n)
    vstat0 = jnp.where(
        jnp.isfinite(lo), int(VarStat.AT_LOWER),
        jnp.where(jnp.isfinite(hi), int(VarStat.AT_UPPER), int(VarStat.FREE)),
    )
    vstat0 = jnp.where(lo == hi, int(VarStat.FIXED), vstat0)
    vstat0 = jnp.where((col >= slack0) & (col < slack0 + m),
                       int(VarStat.BASIC), vstat0).astype(jnp.int8)
    basis0 = jnp.broadcast_to(jnp.arange(slack0, slack0 + m, dtype=jnp.int32),
                              (B, m))
    st = solve_batch(A, b, c, lo, hi, vstat0, basis0, opts=opts)
    return st.basis, st.vstat, st.status, st.niter


def _prepare(batch, route: str, slack0: int):
    """Host f32 cast (+ kernel padding) and upload of one batch."""
    A, b, c, lo, hi = batch
    if route == "triton":
        from ..ops.kernels.batched_simplex import pad_batch

        host = pad_batch(np.asarray(A), np.asarray(b), np.asarray(c),
                         np.asarray(lo), np.asarray(hi), slack0)
    else:
        host = [np.ascontiguousarray(v, dtype=np.float32)
                for v in (A, b, c, lo, hi)]
    with jax.enable_x64(False):
        return [jnp.asarray(v) for v in host]


def _launch(dev_args, route: str, slack0: int, max_iter: int, interpret: bool):
    """Asynchronous device solve of one prepared batch."""
    if route == "triton":
        from ..ops.kernels.batched_simplex import simplex_kernel_call

        with jax.enable_x64(False):
            return simplex_kernel_call(*dev_args, slack0=slack0,
                                       max_iter=max_iter, interpret=interpret)
    opts = f32_iterate_options(SolverOptions(max_iter=max_iter))
    with jax.default_matmul_precision("highest"):
        return _solve_batch_f32(*dev_args, slack0=slack0, opts=opts)


def _finalize(batch, out, route: str, slack0: int) -> BatchResult:
    """Fetch one batch's combinatorial outputs, certify every lane in host
    f64 and re-solve the rare uncertified lane exactly."""
    A, b, c, lo, hi = batch
    _, m, n = np.shape(A)
    if route == "triton":
        from ..ops.kernels.batched_simplex import unpad_result

        basis, vstat, info = jax.device_get(out)
        basis, vstat = unpad_result(basis, vstat, m, n, slack0)
        status, niter = info[:, 0], info[:, 1]
    else:
        basis, vstat, status, niter = jax.device_get(out)
    status = np.array(status, dtype=np.int32)
    obj, verified, x = verify_f64(A, b, c, lo, hi, basis, vstat, status)
    res = BatchResult(basis=basis, vstat=vstat, status=status,
                      niter=np.asarray(niter), obj=obj, verified=verified, x=x)
    return resolve_unverified_host(res, A, b, c, lo, hi)


def _resolve_route(shape, slack0, route):
    _, m, n = shape
    s0 = (n - m) if slack0 is None else int(slack0)
    return s0, (routes.batched_route(m, n) if route is None else route)


def solve_batch_certified(A, b, c, lo, hi, *, slack0=None, max_iter: int = 2000,
                          route: str | None = None, interpret: bool = False):
    """Batched solve where EVERY lane's answer is exact and certified.

    Inputs: A (B, m, n), b (B, m), c/lo/hi (B, n), equality form with the
    identity slack block at columns [slack0, slack0 + m) (`slack0=None`: the
    last m columns, the `make_random_batch` layout; canonicalized problems
    pass `slack0=can.nv`).  `route` overrides `routes.batched_route`;
    `interpret=True` runs the Triton route in the Pallas interpreter (tests).
    """
    s0, route = _resolve_route(np.shape(A), slack0, route)
    batch = (A, b, c, lo, hi)
    out = _launch(_prepare(batch, route, s0), route, s0, max_iter, interpret)
    return _finalize(batch, out, route, s0)


def solve_batches_pipelined(
    batches,
    *,
    slack0=None,
    max_iter: int = 2000,
    route: str | None = None,
    interpret: bool = False,
):
    """Solve a sequence of host-resident LP batches, overlapping the device
    solve of batch k+1 with host f64 certification of batch k.

    `batches` is a list of (A, b, c, lo, hi) numpy tuples of one shape.  The
    device sees only f32 copies and returns only the combinatorial outputs;
    the f64 data stays on the host, where certification runs.  The upload of
    batch k+1 runs on a prefetch thread while batch k solves, so the steady
    state costs max(upload, solve, certify) per batch instead of their sum.
    """
    from concurrent.futures import ThreadPoolExecutor

    s0, route = _resolve_route(np.shape(batches[0][0]), slack0, route)
    results = []
    prev = None
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_prepare, batches[0], route, s0)
        for k, batch in enumerate(batches):
            dev_args = fut.result()
            if k + 1 < len(batches):
                fut = pool.submit(_prepare, batches[k + 1], route, s0)
            out = _launch(dev_args, route, s0, max_iter, interpret)
            if prev is not None:
                results.append(_finalize(*prev, route, s0))
            prev = (batch, out)
        results.append(_finalize(*prev, route, s0))
    return results


def make_random_batch_host(
    seed: int, batch: int, m: int, nv: int
) -> Tuple[np.ndarray, ...]:
    """Host (numpy, f64) twin of `make_random_batch` — same LP structure.

    Generating on the host keeps the f64 problem data host-resident for the
    exact certification step: the device only receives the f32 copies.
    """
    rng = np.random.default_rng(seed)
    n = nv + m
    A_s = rng.normal(size=(batch, m, nv))
    c_s = rng.normal(size=(batch, nv))
    x0 = rng.uniform(0.2, 0.8, size=(batch, nv))
    u = rng.uniform(0.1, 1.0, size=(batch, m))
    b = np.einsum("bmn,bn->bm", A_s, x0) + u

    eye = np.broadcast_to(np.eye(m), (batch, m, m))
    A = np.concatenate([A_s, eye], axis=2)
    c = np.concatenate([c_s, np.zeros((batch, m))], axis=1)
    lo = np.zeros((batch, n))
    hi = np.concatenate([np.ones((batch, nv)), np.full((batch, m), np.inf)], axis=1)
    return A, b, c, lo, hi


def make_random_batch(
    key: jax.Array, batch: int, m: int, nv: int, dtype=jnp.float64
) -> Tuple[jnp.ndarray, ...]:
    """A batch of random dense canonical LPs, guaranteed feasible and bounded.

    Structure: minimize c·x s.t. A_s·x + s = b, 0 ≤ x ≤ 1 (boxed structural
    vars ⇒ bounded), s ≥ 0 with b = A_s·x₀ + u for an interior x₀ and u > 0
    (⇒ x₀ strictly feasible).  Matches BASELINE config 3's "independent random
    dense LPs (m, n ≤ 256)".
    """
    kA, kc, kx, ku = jax.random.split(key, 4)
    n = nv + m
    A_s = jax.random.normal(kA, (batch, m, nv), dtype=dtype)
    c_s = jax.random.normal(kc, (batch, nv), dtype=dtype)
    x0 = jax.random.uniform(kx, (batch, nv), dtype=dtype, minval=0.2, maxval=0.8)
    u = jax.random.uniform(ku, (batch, m), dtype=dtype, minval=0.1, maxval=1.0)
    b = jnp.einsum("bmn,bn->bm", A_s, x0) + u

    eye = jnp.broadcast_to(jnp.eye(m, dtype=dtype), (batch, m, m))
    A = jnp.concatenate([A_s, eye], axis=2)          # (B, m, n)
    c = jnp.concatenate([c_s, jnp.zeros((batch, m), dtype=dtype)], axis=1)
    lo = jnp.zeros((batch, n), dtype=dtype)
    hi = jnp.concatenate(
        [jnp.ones((batch, nv), dtype=dtype),
         jnp.full((batch, m), jnp.inf, dtype=dtype)],
        axis=1,
    )
    vstat0 = jnp.concatenate(
        [jnp.full((batch, nv), int(VarStat.AT_LOWER), dtype=jnp.int8),
         jnp.full((batch, m), int(VarStat.BASIC), dtype=jnp.int8)],
        axis=1,
    )
    basis0 = jnp.broadcast_to(
        jnp.arange(nv, nv + m, dtype=jnp.int32), (batch, m)
    )
    return A, b, c, lo, hi, vstat0, basis0
