"""Host-side driver: canonicalize → device solve → Solution wrapper.

This is the seam between the Python API layer (C1) and the device-resident
engine (C2–C4).  The only host↔device traffic is the canonical arrays going down
once and the final state pytree coming back (SURVEY.md §4.1 ◆ marks) — the solve
itself is a single compiled computation.  Compilation is cached by padded shape
bucket + options (shape bucketing per SURVEY.md §8 "Hard parts" #5).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import api
from ..canonical import CanonicalLP, canonicalize
from .. import routes
from ..options import SolverOptions, f32_iterate_options
from ..status import Status, VarStat
from ..utils import records
from . import incremental
from .primal import solve_canonical
from .state import SimplexState

_solve_jit = jax.jit(solve_canonical, static_argnames=("opts",))

#: padded-row threshold above which host-side exact linear algebra goes
#: through the sparse LU (engine/hostlp.py) instead of dense LAPACK —
#: Netlib-scale canonical forms are ≲1% dense, so sparse wins decisively
#: there while small/dense forms keep the (faster for them) dense path.
_SPARSE_HOST_M = 1024


def _np_dtype(opts: SolverOptions):
    return np.float64 if opts.dtype == "float64" else np.float32


def _raise_for_status(status: int) -> None:
    if status == Status.OPTIMAL:
        return
    if status == Status.INFEASIBLE:
        raise api.Infeasible()
    if status == Status.UNBOUNDED:
        raise api.Unbounded()
    raise api.SolverFailure(f"solver terminated with status {Status(status).name}")


class EngineHandle:
    """Owns the canonical form + warm-started device state for one Problem.

    The reference's `Solution` owns its `Solver` (`src/lib.rs` [API]); here the
    `Solution` facade owns this handle, which carries everything needed for the
    incremental re-solve API: the (host) canonical arrays, the (device) state
    pytree, and the stack of original bounds for `unfix_var`.

    Every reported solution is *certified* when possible: the simplex basis
    is combinatorial, so the exact vertex is recomputed from (basis, vstat)
    in host f64 (one LU solve) and checked primal + dual feasible
    (`certify`).  An f32 device iterate therefore still serves exact answers.
    """

    def __init__(
        self,
        can: CanonicalLP,
        state: SimplexState,
        problem: "api.Problem",
        opts: SolverOptions,
        fixed_bounds: Dict[int, Tuple[float, float]] | None = None,
    ):
        self.can = can
        self.state = state  # setter detects a lazy (0, 0) Binv placeholder
        self.problem = problem
        self.opts = opts
        #: var idx -> original (lo, hi) saved by fix_var (for unfix_var)
        self.fixed_bounds: Dict[int, Tuple[float, float]] = dict(fixed_bounds or {})
        self._x_cache: np.ndarray | None = None
        self._exact_obj: float | None = None
        #: populated by `certify()`: True/False after a certification attempt
        self.certified: bool | None = None

    # -- lazy basis inverse ------------------------------------------------------
    # At Netlib scale the dense B⁻¹ costs O(m) sparse solves to materialize
    # and is only needed by the device warm re-solve path — the host-first
    # incremental routing never reads it.  Cold solves therefore build the
    # state with a (0, 0) placeholder (`_state_from_certified_basis`) and
    # this handle materializes it on first external access.
    @property
    def state(self) -> SimplexState:
        if self.binv_stale:
            self.ensure_binv()
        return self._state

    @state.setter
    def state(self, value: SimplexState) -> None:
        self._state = value
        self.binv_stale = tuple(value.Binv.shape) != (self.can.M, self.can.M)

    def ensure_binv(self) -> None:
        """Materialize the dense basis inverse into the state (no-op when
        already present).  One sparse LU + M triangular-solve pairs."""
        if not self.binv_stale:
            return
        from ..utils import profiling

        can = self.can
        basis = np.asarray(self._state.basis)
        A = can.A.astype(np.float64)
        t0 = time.perf_counter()
        if can.M >= _SPARSE_HOST_M:
            from . import hostlp

            lu = hostlp.factorize_basis(A, basis, A_csc=can.csc())
            Binv = None if lu is None else lu.lu.solve(np.eye(can.M))
        else:
            try:
                Binv = np.linalg.inv(A[:, basis])
            except np.linalg.LinAlgError:
                Binv = None
        if Binv is None:
            # certified bases are nonsingular; if this ever fires, hand the
            # resolver an identity seed — its Newton telltale detects the
            # mismatch and falls back to the exact host inverse path
            Binv = np.eye(can.M)
        # host-resident, like the rest of a rebuilt state (a device warm path
        # that wants it passes it into jit, which uploads it then)
        dtype = np.float64 if self.opts.dtype == "float64" else np.float32
        self._state = self._state._replace(Binv=np.asarray(Binv, dtype=dtype))
        self.binv_stale = False
        profiling.record_stage("state_rebuild_s", time.perf_counter() - t0)

    # -- accessors ---------------------------------------------------------------
    def _x_full(self) -> np.ndarray:
        if self._x_cache is None:
            vstat = np.asarray(self._state.vstat)
            lo = self.can.lo.astype(np.float64)
            hi = self.can.hi.astype(np.float64)
            x = np.where(vstat == int(VarStat.AT_LOWER), lo, 0.0)
            x = np.where(vstat == int(VarStat.AT_UPPER), hi, x)
            x = np.where(vstat == int(VarStat.FIXED), lo, x)
            x[np.asarray(self._state.basis)] = np.asarray(self._state.xB)
            self._x_cache = x
        return self._x_cache

    def certify(self, tol: float = 1e-7) -> bool:
        """Recompute the vertex exactly in f64 from (basis, vstat) and check
        primal + dual feasibility; on success the handle serves exact values."""
        from ..utils import profiling

        with profiling.stage("certify_s"):
            return self._certify_timed(tol)

    def _certify_timed(self, tol: float = 1e-7) -> bool:
        can = self.can
        basis = np.asarray(self._state.basis)
        vstat = np.asarray(self._state.vstat)
        A = can.A.astype(np.float64)
        lo = can.lo.astype(np.float64)
        hi = can.hi.astype(np.float64)
        c = can.c.astype(np.float64)
        xN = np.where(vstat == int(VarStat.AT_LOWER), lo, 0.0)
        xN = np.where(vstat == int(VarStat.AT_UPPER), hi, xN)
        xN = np.where(vstat == int(VarStat.FIXED), lo, xN)
        xN = np.where(vstat == int(VarStat.BASIC), 0.0, xN)
        if can.M >= _SPARSE_HOST_M:
            # Netlib scale: one sparse LU (hostlp) instead of two dense
            # O(m³) solves — the reference's `src/lu.rs` role at certify time
            from . import hostlp

            lu = hostlp.factorize_basis(A, basis, A_csc=can.csc())
            if lu is None:
                self.certified = False
                return False
            xB = lu.lu.solve(can.b.astype(np.float64) - A @ xN)
            y = lu.lu.solve(c[basis], trans="T")
        else:
            Bmat = A[:, basis]
            try:
                xB = np.linalg.solve(Bmat, can.b.astype(np.float64) - A @ xN)
                y = np.linalg.solve(Bmat.T, c[basis])
            except np.linalg.LinAlgError:
                self.certified = False
                return False
        d = c - y @ A
        loB, hiB = lo[basis], hi[basis]
        pfeas = bool(((xB >= loB - tol) & (xB <= hiB + tol)).all())
        at_lo = vstat == int(VarStat.AT_LOWER)
        at_hi = vstat == int(VarStat.AT_UPPER)
        free = vstat == int(VarStat.FREE)
        dfeas = bool(
            (np.where(at_lo, d >= -tol, True)
             & np.where(at_hi, d <= tol, True)
             & np.where(free, np.abs(d) <= tol, True)).all()
        )
        if not (pfeas and dfeas):
            self.certified = False
            return False
        x = xN.copy()
        x[basis] = xB
        self._x_cache = x
        self._exact_obj = float(c @ x)
        self.certified = True
        return True

    def user_objective(self) -> float:
        obj = self._exact_obj if self._exact_obj is not None else float(self._state.obj)
        return float(self.can.obj_sign * obj)

    def var_value(self, idx: int) -> float:
        if not (0 <= idx < self.can.nv):
            raise IndexError(f"variable index {idx} out of range")
        return float(self._x_full()[idx])

    def iterations(self) -> int:
        return int(self._state.niter)

    # -- incremental API (SURVEY.md §4.2/§4.3 call stacks) -----------------------
    def add_constraint(self, solution, terms, op, rhs) -> "api.Solution":
        return incremental.add_constraint(self, terms, op, rhs)

    def fix_var(self, solution, idx: int, val: float) -> "api.Solution":
        return incremental.fix_var(self, idx, val)

    def unfix_var(self, solution, idx: int) -> Tuple[bool, "api.Solution"]:
        return incremental.unfix_var(self, idx)

    def add_gomory_cut(self, solution, idx: int) -> "api.Solution":
        return incremental.add_gomory_cut(self, idx)


class PdhgHandle:
    """Solution handle for the first-order engine (no basis, no incremental API).

    The PDHG engine returns primal/dual iterates rather than a simplex basis;
    the incremental warm-start surface is simplex-specific (as in the
    reference), so those methods direct the user back to `engine="simplex"`.
    """

    def __init__(self, can: CanonicalLP, pstate, problem, opts):
        self.can = can
        self.pstate = pstate
        self.problem = problem
        self.opts = opts

    def user_objective(self) -> float:
        x = np.asarray(self.pstate.x)
        return float(self.can.obj_sign * (self.can.c @ x))

    def var_value(self, idx: int) -> float:
        if not (0 <= idx < self.can.nv):
            raise IndexError(f"variable index {idx} out of range")
        return float(self.pstate.x[idx])

    def iterations(self) -> int:
        return int(self.pstate.niter)

    def _no_incremental(self, *_args, **_kw):
        raise api.SolverFailure(
            "incremental re-solve requires the simplex engine "
            '(SolverOptions(engine="simplex"))'
        )

    add_constraint = fix_var = unfix_var = add_gomory_cut = _no_incremental


def _maybe_presolve(problem: "api.Problem") -> "api.Problem":
    """Apply host presolve when enabled; may raise Infeasible/Unbounded."""
    if not problem.options.presolve:
        return problem
    from ..presolve import presolve_problem
    from ..utils import profiling

    with profiling.stage("presolve_s"):
        reduced, _stats = presolve_problem(problem)
    return reduced


def _use_sparse_pdhg(A: np.ndarray, opts: SolverOptions) -> bool:
    if opts.pdhg_matrix == "sparse":
        return True
    if opts.pdhg_matrix == "dense":
        return False
    if opts.pdhg_matrix != "auto":
        raise ValueError(f"unknown pdhg_matrix {opts.pdhg_matrix!r}")
    # auto: sparse pays off when the densified matvec would waste HBM
    # bandwidth on zeros — large instance, low density.
    return A.size >= (1 << 16) and np.count_nonzero(A) <= 0.1 * A.size


def _solve_problem_pdhg(problem: "api.Problem") -> "api.Solution":
    from .pdhg import solve_pdhg, solve_pdhg_sparse

    opts = problem.options
    problem = _maybe_presolve(problem)
    can = canonicalize(problem, dtype=_np_dtype(opts))
    args = (
        jnp.asarray(can.b), jnp.asarray(can.c),
        jnp.asarray(can.lo), jnp.asarray(can.hi),
    )
    with records.timed() as t:
        if _use_sparse_pdhg(can.A, opts):
            from jax.experimental import sparse as jsparse

            Ab = jsparse.BCOO.fromdense(jnp.asarray(can.A))
            solver, amat = solve_pdhg_sparse, Ab
        else:
            solver, amat = solve_pdhg, jnp.asarray(can.A)
        pstate = solver(amat, *args, opts=opts)
        status = int(pstate.status)
    if records.enabled():
        records.emit(records.SolveRecord(
            event="pdhg_solve", engine="pdhg", status=Status(status).name,
            rows=can.m, cols=can.nv, padded_rows=can.M, padded_cols=can.N,
            iterations=int(pstate.niter),
            objective=(
                float(can.obj_sign * float(can.c @ np.asarray(pstate.x)))
                if status == Status.OPTIMAL else None
            ),
            wall_s=t.wall_s, backend=routes.backend(), dtype=opts.dtype,
        ))
    if status == Status.MAX_ITER:
        raise api.SolverFailure(
            f"PDHG did not converge in {opts.pdhg_max_iter} iterations "
            f"(KKT error {float(pstate.err):.2e})"
        )
    _raise_for_status(status)
    return api.Solution(PdhgHandle(can, pstate, problem, opts), problem)


def _state_from_certified_basis(
    can: CanonicalLP, basis: np.ndarray, vstat: np.ndarray, niter: int,
    opts: SolverOptions,
    lu=None,
) -> SimplexState | None:
    """Exact f64 SimplexState rebuilt from a certified (basis, vstat).

    One host LU: the handle's incremental API needs (xB, d, obj) consistent
    with the basis; everything follows from the combinatorial state.  At
    Netlib scale (M ≥ _SPARSE_HOST_M) the dense B⁻¹ is NOT materialized here
    — it costs O(m) triangular-solve pairs and only the device warm re-solve
    path reads it, so the state
    carries a (0, 0) placeholder that `EngineHandle.ensure_binv` fills on
    first access.  Returns None on a singular basis (caller falls back)."""
    from ..utils import profiling

    t_rebuild = time.perf_counter()
    A = can.A.astype(np.float64)
    from ..canonical import nonbasic_values as np_nonbasic

    xN = np_nonbasic(vstat, can.lo, can.hi)
    if can.M >= _SPARSE_HOST_M:
        from . import hostlp

        if lu is None:
            lu = hostlp.factorize_basis(A, basis, A_csc=can.csc())
        if lu is None:
            return None
        xB = lu.lu.solve(can.b.astype(np.float64) - A @ xN)
        y = lu.lu.solve(can.c[basis].astype(np.float64), trans="T")
    else:
        # dense path: solve for (xB, y) directly — the dense B⁻¹ is a handle
        # field the cold-solve caller may never read; the (0, 0) placeholder
        # below defers it to `EngineHandle.ensure_binv` (np.linalg.inv on
        # demand), same as the sparse-host path above
        Bmat = A[:, basis]
        try:
            xB = np.linalg.solve(Bmat, can.b.astype(np.float64) - A @ xN)
            y = np.linalg.solve(Bmat.T, can.c[basis].astype(np.float64))
        except np.linalg.LinAlgError:
            return None
    Binv = np.zeros((0, 0))  # lazy placeholder (handle materializes)
    d = can.c - y @ A
    d[vstat == int(VarStat.BASIC)] = 0.0
    obj = float(can.c[basis] @ xB + can.c @ xN)
    dtype = np.float64 if opts.dtype == "float64" else np.float32
    # HOST-resident numpy fields, deliberately: this state is the warm-start
    # handle of a finished cold solve, and every default consumer reads it
    # back on the host (`certify`, `var_value`, the host-first incremental
    # paths all `np.asarray` each field).  Uploading here would buy nothing
    # — a device warm path that does want the state passes it into jit,
    # which uploads it then (numpy pytree leaves are valid jit arguments)
    state = SimplexState(
        basis=np.asarray(basis, dtype=np.int32),
        vstat=np.asarray(vstat, dtype=np.int8),
        xB=np.asarray(xB, dtype=dtype),
        d=np.asarray(d, dtype=dtype),
        Binv=np.asarray(Binv, dtype=dtype),
        obj=np.asarray(obj, dtype=dtype),
        niter=np.int32(int(niter)),
        status=np.int32(int(Status.OPTIMAL)),
        noimprove=np.int32(0),
        best=np.asarray(np.inf, dtype=dtype),
        weights=np.ones_like(d.astype(dtype)),
        phase=np.int32(2),
    )
    profiling.record_stage("state_rebuild_s", time.perf_counter() - t_rebuild)
    return state


def _host_polish_from_basis(
    can: CanonicalLP, basis: np.ndarray, vstat: np.ndarray, opts: SolverOptions,
    niter0: int = 0,
    accept_any_terminal: bool = False,
) -> SimplexState | None:
    """Finish an uncertified near-optimal f32 basis exactly: warm-start the
    exact f64 XLA engine ON THE HOST CPU BACKEND from that basis.

    Long f32 runs (padded M ≳ 400, ≳10k pivots) can terminate at a basis
    that is near-optimal but fails exact certification — the drifted f32
    reduced costs price no column as attractive a few pivots early.  The
    basis is combinatorially a few exact pivots from the true optimum, so
    polishing is cheap and latency-bound: it runs on the host (the sparse
    engine first, the dense XLA engine on the CPU backend as its fallback).
    Returns the exact f64 OPTIMAL state placed on the default backend, or
    None (singular basis or a non-OPTIMAL polish outcome — the caller falls
    back to the full exact engines).

    `niter0` is the pivot count of the f32 run that produced (basis, vstat);
    it is added to the polished state's niter so `Solution.iterations()` and
    SolveRecords report the full work, not just the few exact polish pivots.
    """
    import dataclasses

    if opts.dtype != "float64":
        return None
    terminal_ok = (
        (int(Status.OPTIMAL), int(Status.INFEASIBLE), int(Status.UNBOUNDED))
        if accept_any_terminal else (int(Status.OPTIMAL),)
    )
    # Sparse host engine first (engine/hostlp.py: splu + eta file — the
    # reference's `src/lu.rs` linear algebra at the polish seam); the dense
    # XLA CPU path below remains the fallback for singular/odd cases.
    from . import hostlp
    from ..utils import profiling

    with profiling.stage("host_polish_s"):
        res = hostlp.solve_host_sparse(
            can.A, can.b, can.c, can.lo, can.hi, basis, vstat, opts=opts,
            A_csc=can.csc() if can.M >= _SPARSE_HOST_M else None,
        )
    if res is not None and int(res.status) in terminal_ok:
        state = _state_from_certified_basis(
            can, res.basis, res.vstat, niter0 + res.niter, opts,
            lu=res.lu,
        )
        if state is not None:
            if int(res.status) != int(Status.OPTIMAL):
                state = state._replace(status=jnp.int32(int(res.status)))
            return state

    Bmat = can.A[:, basis].astype(np.float64)
    try:
        Binv0 = np.linalg.inv(Bmat)
    except np.linalg.LinAlgError:
        return None
    cpu = routes.cpu_device()
    f64 = dataclasses.replace(opts, dtype="float64")
    put = lambda v, dt: jax.device_put(jnp.asarray(np.asarray(v), dtype=dt), cpu)
    with jax.default_device(cpu):
        state = _solve_jit(
            put(can.A, jnp.float64), put(can.b, jnp.float64),
            put(can.c, jnp.float64), put(can.lo, jnp.float64),
            put(can.hi, jnp.float64),
            put(vstat, jnp.int8), put(basis, jnp.int32),
            opts=f64, Binv0=put(Binv0, jnp.float64),
        )
    if int(state.status) not in terminal_ok:
        return None
    state = state._replace(niter=state.niter + jnp.int32(niter0))
    # re-home the polished state on the default backend for the handle
    return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), state)


def _f32_midsize_eligible(opts: SolverOptions) -> bool:
    if opts.f32_midsize not in ("auto", "always", "never"):
        raise ValueError(f"unknown f32_midsize {opts.f32_midsize!r}")
    return opts.f32_midsize == "always"


def _try_f32_certified_solve(
    can: CanonicalLP, opts: SolverOptions
) -> SimplexState | None:
    """Run the XLA engine in f32, adopt the basis only if it passes exact f64
    certification (primal + dual feasible).

    Only an OPTIMAL f32 status is ever adopted: f32 INFEASIBLE/UNBOUNDED
    claims are not certifiable from the basis alone, so they fall back to
    the exact f64 engine.  f32 products are pinned to full precision (no
    TF32).  Returns the exact f64 state or None (caller falls back).
    """
    f32 = f32_iterate_options(opts)
    args = (
        jnp.asarray(can.A, dtype=jnp.float32),
        jnp.asarray(can.b, dtype=jnp.float32),
        jnp.asarray(can.c, dtype=jnp.float32),
        jnp.asarray(can.lo, dtype=jnp.float32),
        jnp.asarray(can.hi, dtype=jnp.float32),
    )
    with jax.default_matmul_precision("highest"):
        state = _solve_jit(*args, jnp.asarray(can.vstat0),
                           jnp.asarray(can.basis0), opts=f32)
        if int(state.status) == int(Status.NUMERICAL):
            B = can.A[:, np.asarray(state.basis)].astype(np.float64)
            state = _solve_jit(
                *args, state.vstat, state.basis, opts=f32,
                Binv0=jnp.asarray(np.linalg.inv(B), dtype=jnp.float32),
            )
    if int(state.status) == int(Status.NUMERICAL):
        # Conditioning beyond f32: the basis's cond·eps_f32 overwhelms even
        # an exact host inverse cast down.  The f32 pass still did the cheap
        # early pivots — hand the basis to the exact host engine to finish.
        return _host_polish_from_basis(
            can, np.asarray(state.basis),
            np.asarray(state.vstat).astype(np.int8), opts,
            niter0=int(state.niter),
        )
    if int(state.status) != int(Status.OPTIMAL):
        return None
    basis = np.asarray(state.basis)
    vstat = np.asarray(state.vstat).astype(np.int8)
    state64 = _state_from_certified_basis(
        can, basis, vstat, int(state.niter), opts
    )
    if state64 is None:
        return None
    # exact feasibility check of the rebuilt vertex (same test certify() runs)
    probe = EngineHandle(can, state64, None, opts)
    if not probe.certify():
        # near-optimal but not optimal: finish exactly on the host
        return _host_polish_from_basis(
            can, basis, vstat, opts, niter0=int(state.niter)
        )
    return state64


def solve_problem(problem: "api.Problem") -> "api.Solution":
    """Cold solve: `Problem::solve` equivalent (SURVEY.md §4.1)."""
    opts = problem.options
    if opts.engine == "pdhg":
        return _solve_problem_pdhg(problem)
    if opts.engine != "simplex":
        raise ValueError(f"unknown engine {opts.engine!r}")
    user_problem = problem
    problem = _maybe_presolve(problem)
    from ..utils import profiling

    with profiling.stage("canonicalize_s"):
        can = canonicalize(
            problem,
            extra_row_capacity=opts.row_capacity_slack,
            dtype=_np_dtype(opts),
        )
    route = routes.cold_route(can.M, opts.dtype, opts.crossover)
    if route == "crossover":
        # PDHG → basis identification → exact host polish: replaces ~10⁵
        # cold pivots with a few hundred warm exact ones at maros scale
        from .crossover import solve_cold_crossover

        with records.timed() as t:
            res = solve_cold_crossover(can, opts)
        if res is not None:
            status = int(res.status)
            state = _state_from_certified_basis(
                can, res.basis, res.vstat, res.niter, opts, lu=res.lu,
            )
            if state is not None and status != int(Status.OPTIMAL):
                state = state._replace(status=jnp.int32(status))
            if state is not None:
                _emit_record("cold_solve_crossover", can, state, status,
                             t.wall_s, opts)
                _raise_for_status(status)
                handle = EngineHandle(can, state, problem, opts)
                handle.certify()
                return api.Solution(handle, user_problem)
        # crossover declined (PDHG far from optimum / singular crash) → the
        # host sparse engine from the slack basis
        route = "host_sparse"
    if route == "device_xla" and _f32_midsize_eligible(opts):
        with records.timed() as t:
            state = _try_f32_certified_solve(can, opts)
        if state is not None:
            _emit_record("cold_solve_f32", can, state,
                         int(Status.OPTIMAL), t.wall_s, opts)
            handle = EngineHandle(can, state, problem, opts)
            handle.certify()
            return api.Solution(handle, user_problem)
        # f32 pass uncertified or claimed non-OPTIMAL → exact f64 engine below
    if route == "host_sparse":
        # the dense f64 XLA engine is O(m·n) dense per pivot at these sizes;
        # the host sparse engine's FTRAN/BTRAN are O(nnz)
        with records.timed() as t:
            state = _host_polish_from_basis(
                can, np.asarray(can.basis0), np.asarray(can.vstat0), opts,
                niter0=0, accept_any_terminal=True,
            )
        if state is not None:
            status = int(state.status)
            _emit_record("cold_solve_host", can, state, status, t.wall_s,
                         opts)
            _raise_for_status(status)
            handle = EngineHandle(can, state, problem, opts)
            handle.certify()
            return api.Solution(handle, user_problem)
    args = (
        jnp.asarray(can.A),
        jnp.asarray(can.b),
        jnp.asarray(can.c),
        jnp.asarray(can.lo),
        jnp.asarray(can.hi),
    )
    with records.timed() as t:
        state = _solve_jit(*args, jnp.asarray(can.vstat0),
                           jnp.asarray(can.basis0), opts=opts)
        if int(state.status) == int(Status.NUMERICAL):
            # Rare: the in-graph Newton refresh diverged.  Rebuild the inverse
            # exactly on the host and resume from the failed state's basis
            # through the same compiled function (no extra compilation).
            B = can.A[:, np.asarray(state.basis)]
            state = _solve_jit(
                *args, state.vstat, state.basis, opts=opts,
                Binv0=jnp.asarray(np.linalg.inv(B)),
            )
        status = int(state.status)
    _emit_record("cold_solve", can, state, status, t.wall_s, opts)
    _raise_for_status(status)
    handle = EngineHandle(can, state, problem, opts)
    # Opportunistic certification for every dtype: one host f64 solve against
    # the final basis; when it passes, exact values are served.
    if not handle.certify() and status == int(Status.OPTIMAL):
        # An OPTIMAL claim that fails exact certification is a drifted
        # stop (on ill-conditioned instances cond(B) ~ 1e12 defeats the
        # Newton-maintained inverse and the engine prices no column a few
        # exact pivots early — the adversarial gate caught a 1e-2 relative
        # objective error returned uncertified).  Repair with
        # exact host pivots from the claimed basis instead of serving the
        # drifted vertex.  accept_any_terminal: if the exact polish discovers
        # INFEASIBLE/UNBOUNDED, that finding must terminate the solve — the
        # drifted OPTIMAL claim was wrong.
        polished = _host_polish_from_basis(
            can, np.asarray(state.basis), np.asarray(state.vstat), opts,
            niter0=int(state.niter), accept_any_terminal=True,
        )
        if polished is not None:
            _raise_for_status(int(polished.status))
            handle = EngineHandle(can, polished, problem, opts)
            handle.certify()
    return api.Solution(handle, user_problem)


def _emit_record(event, can, state, status, wall_s, opts, engine="simplex"):
    if not records.enabled():
        return
    records.emit(records.SolveRecord(
        event=event,
        engine=engine,
        status=Status(status).name,
        rows=can.m,
        cols=can.nv,
        padded_rows=can.M,
        padded_cols=can.N,
        iterations=int(state.niter),
        objective=(
            float(can.obj_sign * float(state.obj))
            if status == Status.OPTIMAL and hasattr(state, "obj")
            else None
        ),
        wall_s=wall_s,
        backend=routes.backend(),
        dtype=opts.dtype,
    ))
