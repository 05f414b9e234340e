"""PDHG → simplex crossover: cold solves beyond the kernel envelope.

The reference solves its whole suite with one sparse simplex on one CPU
thread (`src/solver.rs` hot loop [CODE]).  This framework's exact host
engine (engine/hostlp.py) matches it per pivot, but a *cold* start at
maros-r7 scale prices ~88k pivots — the missing piece is a way to START
NEAR THE OPTIMUM.  That is exactly what the first-order engine provides:
PDHG reaches KKT ~1e-4 at maros shape in tens of thousands of cheap
matvec iterations, and the optimal basis is readable off the converged
iterate.  The crossover (PDLP-style basis identification;
PAPERS.md "GPU-based First-Order Methods for LP" discusses the same
two-stage design) replaces tens of thousands of cold pivots with a few
hundred exact warm ones:

1. classify every column of the canonical LP from (x, y): strictly
   interior ⇒ basic candidate (ranked by relative interior depth),
   at-bound ⇒ AT_LOWER/AT_UPPER by the nearer bound;
2. repair the candidate set to a NONSINGULAR basis with a slack-seeded
   eta crash: starting from the (always nonsingular) slack basis, FTRAN
   each candidate in rank order and pivot it onto the still-slack row with
   the largest pivot element, skipping candidates whose best pivot is
   numerically degenerate — one sparse solve per accepted column,
   periodically refactorized;
3. warm-start the exact host simplex from that basis (it tolerates the
   residual primal/dual infeasibility; its Harris/Devex/long-step loop
   finishes and certifies in f64).

No reference analog — upstream never needed one — but this is the route
to its "solves the suite anywhere" property, CPU-only machines included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from .. import routes
from ..options import SolverOptions
from ..status import Status, VarStat
from . import hostlp

_BASIC = int(VarStat.BASIC)
_AT_LOWER = int(VarStat.AT_LOWER)
_AT_UPPER = int(VarStat.AT_UPPER)
_FREE = int(VarStat.FREE)
_FIXED = int(VarStat.FIXED)


def identify_basis(
    A: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x: np.ndarray,
    d: np.ndarray,
    basis0: np.ndarray,
    *,
    interior_tol: float = 1e-7,
    pivot_rel: float = 1e-4,
    refactor_every: int = 128,
    cand_cap_factor: float = 1.5,
    A_csc=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Active-set basis from a near-optimal primal iterate x (+ reduced
    costs d, used only to rank ties).

    Returns (basis (M,), vstat (N,)).  `basis0` must be the canonical slack
    basis (row i ↔ its slack column) — the crash's nonsingular seed.
    Deterministic: candidate order is (score desc, index asc); row choice is
    largest |pivot| (lowest index on ties via argmax-first-max).
    """
    M, N = A.shape
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)

    dist_lo = np.where(np.isfinite(lo), x - lo, np.inf)
    dist_hi = np.where(np.isfinite(hi), hi - x, np.inf)
    interior = np.minimum(dist_lo, dist_hi)
    rel = interior / (1.0 + np.abs(x))
    fixed = lo == hi

    # candidates: strictly interior columns, best (deepest, smallest |d|)
    # first.  |d| only tie-breaks — at convergence an interior column has
    # d ≈ 0, so the ranking is dominated by interior depth.
    cand_mask = (rel > interior_tol) & ~fixed
    cand = np.nonzero(cand_mask)[0]
    score = rel[cand] / (1.0 + np.abs(d[cand]))
    order = np.lexsort((cand, -score))  # score desc, index asc
    cand = cand[order]
    cap = int(cand_cap_factor * M)
    if cand.size > cap:
        cand = cand[:cap]

    if A_csc is None:
        A_csc = sp.csc_matrix(np.asarray(A, dtype=np.float64))
    basis = np.array(basis0, dtype=np.int64, copy=True)
    slack_row = {int(basis[i]): i for i in range(M)}
    free_row = np.ones(M, dtype=bool)

    # pass 1: candidates that ARE a row's seed slack stay basic in place
    pending = []
    for q in cand:
        r = slack_row.get(int(q))
        if r is not None:
            free_row[r] = False
        else:
            pending.append(int(q))

    lu = hostlp.BasisLU(A_csc, basis)  # slack basis: never singular
    since_refactor = 0
    n_free = int(free_row.sum())
    for q in pending:
        if n_free == 0:
            break
        s0, s1 = A_csc.indptr[q], A_csc.indptr[q + 1]
        aq = np.zeros(M)
        aq[A_csc.indices[s0:s1]] = A_csc.data[s0:s1]
        w = lu.ftran(aq)
        wmax = np.abs(w).max()
        wfree = np.where(free_row, np.abs(w), -1.0)
        r = int(np.argmax(wfree))
        if wfree[r] < max(1e-8, pivot_rel * wmax):
            continue  # numerically dependent on the accepted set: skip
        lu.update(w, r)
        basis[r] = q
        free_row[r] = False
        n_free -= 1
        since_refactor += 1
        if since_refactor >= refactor_every:
            lu = hostlp.BasisLU(A_csc, basis)
            since_refactor = 0

    vstat = np.empty(N, dtype=np.int8)
    vstat[:] = np.where(
        fixed, _FIXED,
        np.where(
            dist_lo <= dist_hi,
            np.where(np.isfinite(lo), _AT_LOWER, _FREE),
            np.where(np.isfinite(hi), _AT_UPPER, _FREE),
        ),
    )
    vstat[basis] = _BASIC
    return basis.astype(np.int32), vstat


def kkt_error_f64(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    feas_tol: float,
) -> float:
    """Exact host-f64 relative KKT error of (x, y) — the original-space
    mirror of engine/pdhg.py::_kkt_error (dr = dc = 1), used to monitor a
    DEVICE f32 PDHG stage from the host: the f32 in-graph error is noisy
    near its resolution floor, so every stop/continue decision is taken on
    this number instead.  `A` may be dense or scipy-sparse — the per-chunk
    monitor passes the canonical form's cached CSC so each check costs two
    O(nnz) matvecs instead of two full dense streams (~0.5 s/check saved at
    maros shape)."""
    if not sp.issparse(A):
        A = np.asarray(A, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    scale_b = 1.0 + np.linalg.norm(b)
    scale_c = 1.0 + np.linalg.norm(c)
    r_p = np.linalg.norm(A @ x - b) / scale_b
    red = c - y @ A
    at_lo = x <= lo + feas_tol
    at_hi = x >= hi - feas_tol
    viol = np.where(at_lo, np.minimum(red, 0.0), red)
    viol = np.where(at_hi & ~at_lo, np.maximum(red, 0.0), viol)
    viol = np.where(at_lo & at_hi, 0.0, viol)
    r_d = np.linalg.norm(viol) / scale_c
    lo_f = np.where(np.isfinite(lo), lo, 0.0)
    hi_f = np.where(np.isfinite(hi), hi, 0.0)
    contrib = np.where(red > 0, red * lo_f, red * hi_f)
    dobj = b @ y + contrib.sum()
    pobj = c @ x
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return float(max(r_p, r_d, gap))


def _device_pdhg_stage(can, opts: SolverOptions, tol: float, progress: bool,
                       budget_s: float | None = None, force: bool = False):
    """Dense f32 PDHG on the device for the crossover.

    Dense f32 matvecs at maros shape stream ~160 MB of A per iteration pair
    from device memory, where the host's sparse f64 stage would leave the
    device idle.  The stage runs in chunks of launches (adaptive, ~10 s
    each); after every chunk the host computes the EXACT f64 KKT error of
    the pulled iterate and decides: stop at `tol`, stop at the f32
    resolution floor (3 consecutive chunks with <3% relative improvement),
    or continue.  Returns (x, y, niter, f64_err, omega) — possibly above
    `tol` when the floor was hit — or None when `routes.device_pdhg` says
    this backend runs no device stage (`force=True` runs it anyway, on the
    default device) or the run produced no finite iterate.  A lowering or
    runtime failure raises.
    """
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp

    from ..status import Status as _S
    from .pdhg import solve_pdhg

    if not (force or routes.device_pdhg()):
        return None
    f32 = lambda v: jnp.asarray(np.asarray(v, np.float32))
    A64 = can.csc()  # sparse KKT monitor (kkt_error_f64 accepts sparse A)
    b64 = np.asarray(can.b, np.float64)
    c64 = np.asarray(can.c, np.float64)
    lo64 = np.asarray(can.lo, np.float64)
    hi64 = np.asarray(can.hi, np.float64)
    vecs = (f32(can.b), f32(can.c), f32(can.lo), f32(can.hi))
    A_f32 = f32(can.A)
    # in-graph tolerance slightly below the target: the f32 error estimate is
    # noisy, and the HOST f64 check is the decider either way.  The stage
    # pins the HALPERN variant (31.5k iterations to the 1e-4 neighborhood vs
    # 52.4k for vanilla at maros shape — ~40% fewer): its frozen-ω weakness
    # on badly-scaled instances is exactly what this stage's f64-monitored
    # fallback chain absorbs (floor-stall → host warm continuation; garbage
    # → host cold stage), so the accelerated scheme is safe HERE even though
    # the user-facing engine default stays vanilla.
    p_opts = dataclasses.replace(
        opts, dtype="float32", feas_tol=max(0.5 * tol, 1e-6),
        pdhg_matrix="dense", pdhg_variant="halpern",
    )
    # PHASE SCHEDULE: the matvecs are bound by the bytes of A, so the early
    # decades run with A stored in BFLOAT16 (half the bytes; its entries
    # rounded to bf16, the vectors and every accumulation in f32) down to a
    # coarse target, then the f32 matrix finishes to `tol`.  Each phase
    # hands its (original-space, f32-vector) state to the next warm; the
    # bf16 phase is skipped for small A where the matvec is not the cost.
    # Every product runs at "highest" precision: a TF32 matvec would move
    # the f32 floor at which the stage hands off.
    phases = []
    if can.A.size >= (1 << 22):  # ≥ ~16 MB f32: HBM-bound regime
        phases.append((jnp.asarray(A_f32, jnp.bfloat16),
                       max(40.0 * tol, 4e-3), "bf16"))
    phases.append((A_f32, tol, "f32"))
    st = None
    done = 0
    best_err = np.inf
    stalled = 0
    x = y = None
    err = np.inf
    t_start = time.perf_counter()
    out_of_budget = False
    for A_phase, phase_tol, phase_name in phases:
        if out_of_budget:
            break
        chunk = 2_000
        n_launches = 0
        stalled = 0
        best_err = err if np.isfinite(err) else np.inf
        if st is not None:
            # fresh averaging window for the new operator precision
            st = st._replace(
                x_sum=jnp.zeros_like(st.x), y_sum=jnp.zeros_like(st.y),
                x_rst=st.x, y_rst=st.y,
                inner=jnp.asarray(0.0, st.x.dtype),
                status=jnp.int32(int(_S.MAX_ITER)),  # re-entry → RUNNING
            )
        while True:
            if (budget_s is not None
                    and time.perf_counter() - t_start > budget_s):
                out_of_budget = True
                break  # caller-imposed wall budget (bench lines)
            cap = min(done + chunk, opts.pdhg_max_iter)
            t0 = time.perf_counter()
            with jax.default_matmul_precision("highest"):
                st = solve_pdhg(A_phase, *vecs, opts=p_opts, state0=st,
                                stop_at=jnp.int32(cap))
            x = np.asarray(st.x, np.float64)
            y = np.asarray(st.y, np.float64)  # forces completion too
            dt = time.perf_counter() - t0
            prev_done, done = done, int(st.niter)
            err = kkt_error_f64(A64, b64, c64, lo64, hi64, x, y, tol)
            n_launches += 1
            if progress:
                print(f"[crossover/device:{phase_name}] iters={done} "
                      f"f64_kkt={err:.3e} chunk_wall={dt:.1f}s", flush=True)
            if err <= phase_tol:
                break
            if (int(st.status) != int(_S.MAX_ITER)
                    or done >= opts.pdhg_max_iter):
                # in-graph terminal (f32 claims done/INFEASIBLE/UNBOUNDED):
                # the host f64 error is what we have; certificates from a
                # low-precision iterate are not trusted here — the caller's
                # exact machinery decides
                break
            if err >= best_err * 0.97:
                stalled += 1
                if stalled >= 3:
                    break  # precision floor of this phase's operator
            else:
                stalled = 0
            best_err = min(best_err, err)
            if n_launches > 2:  # first two launches include jit compiles
                rate = max(done - prev_done, 1) / max(dt, 1e-3)
                chunk = int(min(max(rate * 10.0, 500), 100_000))
                if budget_s is not None:
                    # never let one launch overshoot the caller's soft
                    # budget by more than ~a chunk (bench lines)
                    left = budget_s - (time.perf_counter() - t_start)
                    chunk = int(max(min(chunk, rate * max(left, 0.5)), 500))
        if err <= tol or done >= opts.pdhg_max_iter:
            break
    if x is None or not np.isfinite(err):
        return None
    return x, y, done, err, float(st.omega)


def solve_cold_crossover(
    can,
    opts: SolverOptions,
    *,
    progress: bool = False,
) -> Optional[hostlp.HostResult]:
    """Cold solve via PDHG + crossover + exact host polish.  Returns a
    terminal HostResult or None (caller falls back to the plain cold host
    solve).

    The PDHG stage prefers the device (dense f32 iterate, chunk-launched,
    HOST f64 KKT monitoring — `_device_pdhg_stage`); when the f32 floor
    stops above `crossover_tol` the host sparse-f64 loop continues WARM from
    the device iterate, so the device still banks the bulk of the decades.
    On the CPU backend the host sparse stage runs alone.  The host stage is
    pinned to the CPU device.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    from ..utils import profiling
    from .pdhg import PdhgState, solve_pdhg_sparse

    if opts.dtype != "float64":
        return None
    cpu = routes.cpu_device()

    # moderate-accuracy PDHG: the basis is combinatorial — identifying it
    # does not need 1e-8 residuals, and the last decades of KKT decay are
    # the slow ones
    tol = max(float(opts.crossover_tol), float(opts.feas_tol))
    p_opts = dataclasses.replace(
        opts,
        feas_tol=tol,
        pdhg_matrix="sparse",
    )
    dev_result = None
    with profiling.stage("crossover_pdhg_device_s"):
        dev = _device_pdhg_stage(can, opts, tol, progress)
    if dev is not None:
        x_d, y_d, dev_iters, err_d, _omega_d = dev
        profiling.bump_stage("crossover_pdhg_device_iters", dev_iters)
        if err_d <= 10.0 * tol:
            # good enough to identify from directly: the exact polish
            # absorbs looser identification far cheaper than the PDHG tail
            # costs (the crossover_tol note in options.py)
            dev_result = (x_d, y_d, dev_iters, err_d)
        elif err_d > 1e-2:
            dev = None  # device run went nowhere — full host stage below
        # else: f32 floor above the target — host continues WARM below
    if dev_result is not None:
        import types

        pstate = types.SimpleNamespace(
            x=dev_result[0], y=dev_result[1], niter=dev_result[2],
            err=dev_result[3], status=int(Status.OPTIMAL),
        )
    else:
        with profiling.stage("crossover_pdhg_s"), jax.default_device(cpu):
            Ab = jsparse.BCOO.fromdense(
                jnp.asarray(np.asarray(can.A, dtype=np.float64))
            )
            state0 = None
            if dev is not None:
                # warm re-entry from the device f32 iterate: averages reset,
                # restart point = the iterate, MAX_ITER → RUNNING on entry
                x_d64 = jnp.asarray(np.asarray(dev[0], np.float64))
                y_d64 = jnp.asarray(np.asarray(dev[1], np.float64))
                state0 = PdhgState(
                    x=x_d64, y=y_d64,
                    x_sum=jnp.zeros_like(x_d64),
                    y_sum=jnp.zeros_like(y_d64),
                    x_rst=x_d64, y_rst=y_d64,
                    omega=jnp.asarray(max(min(dev[4], 1e6), 1e-6),
                                      jnp.float64),
                    inner=jnp.asarray(0.0, jnp.float64),
                    last_err=jnp.asarray(dev[3], jnp.float64),
                    niter=jnp.int32(dev[2]),
                    status=jnp.int32(Status.MAX_ITER),
                    err=jnp.asarray(dev[3], jnp.float64),
                )
            pstate = solve_pdhg_sparse(
                Ab,
                jnp.asarray(np.asarray(can.b, np.float64)),
                jnp.asarray(np.asarray(can.c, np.float64)),
                jnp.asarray(np.asarray(can.lo, np.float64)),
                jnp.asarray(np.asarray(can.hi, np.float64)),
                opts=p_opts,
                state0=state0,
            )
            np.asarray(pstate.err)  # force completion inside the stage timer
    status = int(pstate.status)
    if status in (int(Status.INFEASIBLE), int(Status.UNBOUNDED)):
        # a first-order certificate is not an exact claim to surface from a
        # cold solve; let the exact engine derive its own (fall back)
        return None
    if status == int(Status.MAX_ITER) and float(pstate.err) > 1e-2:
        return None  # nowhere near the optimum: identification would be noise

    x = np.asarray(pstate.x, dtype=np.float64)
    y = np.asarray(pstate.y, dtype=np.float64)
    A = np.asarray(can.A, dtype=np.float64)
    d = np.asarray(can.c, dtype=np.float64) - y @ A
    if progress:
        print(f"[crossover] pdhg iters={int(pstate.niter)} "
              f"err={float(pstate.err):.2e}", flush=True)
    with profiling.stage("crossover_identify_s"):
        basis, vstat = identify_basis(
            A, can.lo, can.hi, x, d, np.asarray(can.basis0),
            A_csc=can.csc(),
        )
    with profiling.stage("crossover_polish_s"):
        res = hostlp.solve_host_sparse(
            can.A, can.b, can.c, can.lo, can.hi, basis, vstat, opts=opts,
            progress_every=10_000 if progress else 0,
            A_csc=can.csc(),
        )
    if res is None:
        return None
    if progress:
        print(f"[crossover] polish status={res.status} pivots={res.niter}",
              flush=True)
    if int(res.status) not in (
        int(Status.OPTIMAL), int(Status.INFEASIBLE), int(Status.UNBOUNDED)
    ):
        return None
    # niter stays a PIVOT count (ADVICE r4: mixing in PDHG iterations skewed
    # Solution.iterations() and any difficulty scores derived from it); the
    # first-order iteration count is reported through the stage counters that
    # feed the bench breakdowns.
    profiling.bump_stage("crossover_pdhg_iters", int(pstate.niter))
    return res
