"""Incremental re-solve API: add_constraint / fix_var / unfix_var / add_gomory_cut.

Reference analogs: `Solver::add_constraint`, `fix_var`, `unfix_var`,
`add_gomory_cut` (`src/solver.rs` [CODE][API]; SURVEY.md §4.2/§4.3 call stacks).

Fixed-shape design (SURVEY.md §8 Phase 3): the canonical form pre-allocates inert
padding rows whose fixed slacks are already basic, so *adding a constraint is a
masked in-place write* — fill the row's coefficients, set the slack bounds for
the op, set b, and the shapes (and hence the compiled resolvers) are unchanged.
Capacity exhaustion triggers grow-by-recompile: the canonical form is re-padded
with more rows and the (basis, vstat) warm state carries over index-for-index
(slack columns keep the layout `nv + row`).

Every edit below keeps the basis *dual feasible*:
  * a new row's slack enters the basis with zero cost, leaving all existing
    reduced costs unchanged (block-triangular basis extension);
  * bound edits (`fix_var`) don't touch reduced costs at all;
so re-optimization is a warm `resolve_dual` (refactorize + dual simplex).  The
exception is `unfix_var`: re-widening the bounds can leave the variable's
reduced cost on the wrong side, so it re-optimizes with the primal engine
(phase 1 is a no-op when the warm basis is still feasible).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import api
from ..canonical import CanonicalLP, canonicalize, slack_bounds
from ..status import Status, VarStat
from ..utils import records
from . import driver as _driver
from .dual import resolve_dual
from .primal import solve_canonical

_resolve_dual_jit = jax.jit(resolve_dual, static_argnames=("opts",))
_resolve_primal_jit = jax.jit(solve_canonical, static_argnames=("opts",))


def _ensure_row_capacity(handle) -> None:
    """Grow the canonical form (and carry the warm state over) when all padding
    rows are consumed — SURVEY.md §8 'grow-by-recompile'."""
    can = handle.can
    if can.m < can.M:
        return
    grown = canonicalize(
        handle.problem,
        extra_row_capacity=max(8, can.M // 2) + (can.M - handle.problem.num_constraints),
        dtype=can.A.dtype,
    )
    # `grown` reflects the *original* problem; replay the edits recorded in the
    # current canonical arrays (cut/constraint rows beyond the problem's own,
    # and any bound overrides from fix_var).
    M_old, nv = can.M, can.nv
    assert grown.nv == nv and grown.M > M_old
    grown.A[: can.m, :nv] = can.A[: can.m, :nv]
    grown.b[: can.m] = can.b[: can.m]
    grown.c[:nv] = can.c[:nv]
    grown.lo[:nv] = can.lo[:nv]
    grown.hi[:nv] = can.hi[:nv]
    # slack bounds of active rows (encode each row's op, incl. added cuts)
    for i in range(can.m):
        grown.lo[grown.slack_col(i)] = can.lo[can.slack_col(i)]
        grown.hi[grown.slack_col(i)] = can.hi[can.slack_col(i)]
    grown.m = can.m
    grown.row_ops = list(can.row_ops)

    # Carry the warm state: structural columns keep indices; slack of row i maps
    # old nv+i -> new nv+i (same expression, larger M just appends rows).
    vstat_old = np.asarray(handle._state.vstat)
    basis_old = np.asarray(handle._state.basis)
    vstat_new = grown.vstat0.copy()
    vstat_new[:nv] = vstat_old[:nv]
    vstat_new[nv : nv + M_old] = vstat_old[nv : nv + M_old]
    basis_new = grown.basis0.copy()
    basis_new[:M_old] = basis_old  # slack indices unchanged by the layout
    grown.vstat0 = vstat_new
    grown.basis0 = basis_new
    was_stale = handle.binv_stale
    if was_stale:
        # lazy placeholder stays lazy: ensure_binv rebuilds from the GROWN
        # canonical form exactly when a device path first needs it
        Binv_new = np.asarray(handle._state.Binv)
    else:
        # Extend the maintained inverse: new padded rows/cols are an exact
        # identity block (their fixed slacks are basic in all-zero rows).
        Binv_old = np.asarray(handle._state.Binv)
        Binv_new = np.eye(grown.M, dtype=Binv_old.dtype)
        Binv_new[:M_old, :M_old] = Binv_old
    handle.can = grown
    handle.state = handle._state._replace(
        basis=jnp.asarray(basis_new.astype(np.int32)),
        vstat=jnp.asarray(vstat_new.astype(np.int8)),
        Binv=jnp.asarray(Binv_new),
    )


def _exact_host_inverse(can, basis) -> jnp.ndarray:
    """Host-side exact inverse of the current basis (numpy f64 LU) — the
    fallback seed when the device-side Newton refresh reports divergence."""
    B = can.A[:, np.asarray(basis)]
    return jnp.asarray(np.linalg.inv(B))


def _try_host_resolve(handle, event: str, prefer_dual: bool = False) -> bool:
    """Warm re-solve on the HOST sparse engine (engine/hostlp.py) — the
    default incremental path.

    After an edit the warm basis is a handful of pivots from optimal;
    re-optimizing is latency-bound, not throughput-bound, so the exact-f64
    sparse simplex on the host (splu + eta file, ~ms per pivot) beats any
    device round-trip — the reference's `Solution::add_constraint` re-solve
    cost is milliseconds for the same reason [API].  Exact f64 terminal
    claims (INFEASIBLE/UNBOUNDED included) are trusted directly; None or a
    non-terminal outcome falls through to the device/XLA paths.

    With `prefer_dual` (the add_constraint/fix_var/Gomory events), the host
    DUAL simplex runs first — the reference's `restore_feasibility` re-solve
    semantics (`src/solver.rs` [CODE]): the freshly-cut basis is dual
    feasible and primal infeasible, the exact state the dual method repairs
    without phase-1 composite pricing.  A None (singular or dual-infeasible
    start) or non-terminal outcome falls back to the primal two-phase loop.
    """
    can = handle.can
    opts = handle.opts
    if opts.dtype != "float64":
        return False
    from . import hostlp

    terminal = (int(Status.OPTIMAL), int(Status.INFEASIBLE),
                int(Status.UNBOUNDED))
    with records.timed() as t:
        csc = can.csc() if can.M >= _driver._SPARSE_HOST_M else None
        res = None
        if prefer_dual:
            res = hostlp.solve_host_dual(
                can.A, can.b, can.c, can.lo, can.hi,
                np.asarray(handle._state.basis),
                np.asarray(handle._state.vstat),
                opts=opts,
                A_csc=csc,
                # a warm repair is a handful of pivots; a run past this cap
                # is the degenerate-cycling regime (hostlp stall exit) and
                # the primal loop below handles it in single digits
                max_iter=max(256, can.M // 4),
            )
            if res is not None and int(res.status) not in terminal:
                res = None
        if res is None:
            res = hostlp.solve_host_sparse(
                can.A, can.b, can.c, can.lo, can.hi,
                np.asarray(handle._state.basis),
                np.asarray(handle._state.vstat),
                opts=opts,
                A_csc=csc,
            )
        if res is None or int(res.status) not in terminal:
            return False
        state = (
            _driver._state_from_certified_basis(
                can, res.basis, res.vstat, res.niter, handle.opts,
                lu=res.lu,
            )
            if int(res.status) == int(Status.OPTIMAL) else None
        )
        if int(res.status) == int(Status.OPTIMAL) and state is None:
            return False
    if records.enabled():
        import types

        shim = types.SimpleNamespace(niter=res.niter, obj=res.obj)
        _driver._emit_record(event + "_host", can, shim, int(res.status),
                             t.wall_s, opts)
    _driver._raise_for_status(int(res.status))
    handle.state = state
    handle._x_cache = None
    handle._exact_obj = None
    handle.certified = None
    handle.certify()
    return True


def _run_dual_resolve(handle) -> None:
    if _try_host_resolve(handle, "dual_resolve", prefer_dual=True):
        return
    can = handle.can

    def run(Binv0):
        return _resolve_dual_jit(
            jnp.asarray(can.A), jnp.asarray(can.b), jnp.asarray(can.c),
            jnp.asarray(can.lo), jnp.asarray(can.hi),
            handle.state.basis, handle.state.vstat, Binv0,
            opts=handle.opts,
        )

    with records.timed() as t:
        state = run(handle.state.Binv)
        if int(state.status) == int(Status.NUMERICAL):
            state = run(_exact_host_inverse(can, handle.state.basis))
        status = int(state.status)
    _driver._emit_record("dual_resolve", can, state, status, t.wall_s, handle.opts)
    _driver._raise_for_status(status)
    handle.state = state
    handle._x_cache = None
    handle._exact_obj = None
    handle.certified = None
    handle.certify()


def _run_primal_resolve(handle) -> None:
    if _try_host_resolve(handle, "primal_resolve"):
        return
    can = handle.can

    def run(Binv0):
        return _resolve_primal_jit(
            jnp.asarray(can.A), jnp.asarray(can.b), jnp.asarray(can.c),
            jnp.asarray(can.lo), jnp.asarray(can.hi),
            handle.state.vstat, handle.state.basis,
            opts=handle.opts, Binv0=Binv0,
        )

    with records.timed() as t:
        state = run(handle.state.Binv)
        if int(state.status) == int(Status.NUMERICAL):
            state = run(_exact_host_inverse(can, handle.state.basis))
        status = int(state.status)
    _driver._emit_record("primal_resolve", can, state, status, t.wall_s, handle.opts)
    _driver._raise_for_status(status)
    handle.state = state
    handle._x_cache = None
    handle._exact_obj = None
    handle.certified = None
    handle.certify()


def _append_row(handle, coeffs_structural: np.ndarray, op, rhs: float) -> None:
    """Activate one padding row in place (no reshape, no recompile)."""
    _ensure_row_capacity(handle)
    can = handle.can
    i = can.m
    sc = can.slack_col(i)
    can.A[i, : can.nv] = coeffs_structural
    can._csc_cache = None  # A mutated: invalidate the cached CSC view
    can.b[i] = rhs
    slo, shi = slack_bounds(op)
    can.lo[sc] = slo
    can.hi[sc] = shi
    can.row_ops.append(op)
    can.m = i + 1
    # The row's slack is already basic (vstat BASIC, basis[i] == sc) from the
    # padding construction.  The basis matrix gains the new row's coefficients
    # on the existing basic columns; its inverse extends analytically:
    #   [[B, 0], [vᵀ, 1]]⁻¹ = [[B⁻¹, 0], [−vᵀB⁻¹, 1]]
    # i.e. row i of the maintained inverse becomes e_i − vᵀ·Binv with v the new
    # row's coefficients on the current basic variables (own slack excluded).
    # This keeps the warm inverse exact so the device-side Newton refresh
    # starts inside its basin (SURVEY.md §4.2 basis patch).  A lazy (stale)
    # inverse stays lazy: ensure_binv rebuilds from the edited canonical
    # form when a device path first needs it, so patching the placeholder
    # would be wasted work.
    if handle.binv_stale:
        return
    basis = np.asarray(handle._state.basis)
    v = can.A[i][basis].copy()
    v[i] = 0.0  # basis[i] is the row's own slack (coefficient 1 handled by e_i)
    Binv = np.asarray(handle._state.Binv).copy()
    row = -(v @ Binv)
    row[i] += 1.0
    Binv[i, :] = row
    handle.state = handle._state._replace(Binv=jnp.asarray(Binv))


def add_constraint(handle, terms: List[Tuple[int, float]], op, rhs: float):
    """`Solution::add_constraint` (SURVEY.md §4.2): append row, dual re-solve."""
    coeffs = np.zeros((handle.can.nv,), dtype=handle.can.A.dtype)
    for j, coeff in terms:
        if not (0 <= j < handle.can.nv):
            raise ValueError(f"constraint references unknown variable index {j}")
        coeffs[j] += coeff
    _append_row(handle, coeffs, op, float(rhs))
    _run_dual_resolve(handle)
    return api.Solution(handle, handle.problem)


def fix_var(handle, idx: int, val: float):
    """`Solution::fix_var` [API]: clamp bounds to [val, val], dual re-solve."""
    can = handle.can
    if not (0 <= idx < can.nv):
        raise IndexError(f"variable index {idx} out of range")
    if math.isnan(val):
        raise ValueError("fix_var value must not be NaN")
    if idx not in handle.fixed_bounds:
        handle.fixed_bounds[idx] = (float(can.lo[idx]), float(can.hi[idx]))
    can.lo[idx] = val
    can.hi[idx] = val
    # A non-basic variable becomes FIXED (its value moves to `val` on the next
    # exact refactorization); a basic one keeps its row and gets pivoted out by
    # the dual simplex if `val` disagrees with its current value.
    vstat = np.asarray(handle._state.vstat).copy()
    if vstat[idx] != int(VarStat.BASIC):
        vstat[idx] = int(VarStat.FIXED)
        handle.state = handle._state._replace(vstat=jnp.asarray(vstat))
    _run_dual_resolve(handle)
    return api.Solution(handle, handle.problem)


def unfix_var(handle, idx: int):
    """`Solution::unfix_var` [API]: restore original bounds; returns
    (objective_changed, Solution)."""
    can = handle.can
    if idx not in handle.fixed_bounds:
        raise ValueError(f"variable {idx} was not fixed")
    obj_before = handle.user_objective()
    lo0, hi0 = handle.fixed_bounds.pop(idx)
    fixed_val = float(can.lo[idx])
    can.lo[idx] = lo0
    can.hi[idx] = hi0
    vstat = np.asarray(handle._state.vstat).copy()
    if vstat[idx] != int(VarStat.BASIC):
        # Re-home the variable at a bound (non-basic variables must rest at a
        # bound or at zero if free — SURVEY.md §3.2).
        if fixed_val == lo0:
            vstat[idx] = int(VarStat.AT_LOWER)
        elif fixed_val == hi0:
            vstat[idx] = int(VarStat.AT_UPPER)
        elif math.isfinite(lo0):
            vstat[idx] = int(VarStat.AT_LOWER)
        elif math.isfinite(hi0):
            vstat[idx] = int(VarStat.AT_UPPER)
        else:
            vstat[idx] = int(VarStat.FREE)
        handle.state = handle._state._replace(vstat=jnp.asarray(vstat))
    # Widening bounds can flip the variable's reduced-cost eligibility, so this
    # needs the primal engine (dual feasibility may be lost); the warm basis
    # makes phase 1 a (near-)no-op.
    _run_primal_resolve(handle)
    sol = api.Solution(handle, handle.problem)
    changed = abs(handle.user_objective() - obj_before) > 1e-9 * (
        1.0 + abs(obj_before)
    )
    return changed, sol


def add_gomory_cut(handle, idx: int):
    """`Solution::add_gomory_cut` [API]: derive a Gomory mixed-integer cut from
    the basic row of variable `idx` and append it (SURVEY.md §3.2).

    Validity convention: *structural* variables are treated as
    integer-constrained, slack variables as continuous — the use case is the
    reference's branch-and-cut driver where all structural variables are
    integers (SURVEY.md §4.3).  The cut is expressed over structural variables
    only by substituting each slack's defining row.
    """
    can = handle.can
    state = handle._state
    if not (0 <= idx < can.nv):
        raise IndexError(f"variable index {idx} out of range")
    basis = np.asarray(state.basis)
    pos = np.nonzero(basis == idx)[0]
    if pos.size == 0:
        raise ValueError("add_gomory_cut requires a basic variable")
    pos = int(pos[0])
    xB = np.asarray(state.xB)
    beta = float(xB[pos])
    f0 = beta - math.floor(beta)
    if f0 < 1e-6 or f0 > 1.0 - 1e-6:
        raise ValueError("add_gomory_cut requires a fractional basic variable")

    # Tableau row of the basic variable: α = (B⁻¹)_pos · A  (BTRAN row read).
    if handle.binv_stale:
        # lazy inverse: one sparse BTRAN (B⁻ᵀ e_pos) instead of
        # materializing the full dense B⁻¹ for a single row
        from . import hostlp

        lu = hostlp.factorize_basis(
            can.A.astype(np.float64), basis, A_csc=can.csc()
        )
        if lu is None:
            handle.ensure_binv()  # identity fallback path
            Binv_row = np.asarray(handle._state.Binv[pos])
        else:
            e = np.zeros(can.M)
            e[pos] = 1.0
            Binv_row = lu.lu.solve(e, trans="T")
    else:
        Binv_row = np.asarray(state.Binv[pos])
    alpha = Binv_row @ can.A  # (N,)
    vstat = np.asarray(state.vstat)

    # Gomory mixed-integer cut over the *shifted* non-basic variables
    # x'_j = x_j - lo_j (at lower) or hi_j - x_j (at upper):  Σ γ_j x'_j ≥ 1.
    # Fully vectorized — no per-nonzero Python (SURVEY.md §3's intent holds
    # on the cut path too, which matters when cuts are derived at Netlib
    # scale where n_active is thousands).
    n_active = can.nv + can.M
    vs = vstat[:n_active]
    at_upper = vs == int(VarStat.AT_UPPER)
    inactive = (vs == int(VarStat.BASIC)) | (vs == int(VarStat.FIXED))
    a = np.where(at_upper, -alpha[:n_active], alpha[:n_active]).astype(
        np.float64
    )
    support = ~inactive & (np.abs(a) >= 1e-12)
    if bool(np.any(support & (vs == int(VarStat.FREE)))):
        # The GMI derivation needs non-negative shifted variables; a free
        # non-basic with support in the row would make the cut invalid.
        raise ValueError(
            "add_gomory_cut: row involves a free non-basic variable"
        )
    is_int = np.arange(n_active) < can.nv
    fj = a - np.floor(a)
    with np.errstate(divide="ignore", invalid="ignore"):
        g_int = np.minimum(fj / f0, (1.0 - fj) / (1.0 - f0))
        g_cont = np.where(a > 0, a / f0, -a / (1.0 - f0))
    gamma = np.where(support, np.where(is_int, g_int, g_cont), 0.0)

    # Un-shift into original variables: Σ c_j x_j ≥ rhs.
    coeffs = np.where(at_upper, -gamma, gamma)
    lo_fin = np.where(np.isfinite(can.lo[:n_active]), can.lo[:n_active], 0.0)
    # hi is finite wherever at_upper holds; masking the off-branch ±inf keeps
    # the eager `-gamma * hi` from manufacturing 0·inf NaNs (discarded by the
    # where, but they would trip a warnings-as-errors CI run).
    hi_fin = np.where(np.isfinite(can.hi[:n_active]), can.hi[:n_active], 0.0)
    rhs = 1.0 + float(
        np.sum(np.where(at_upper, -gamma * hi_fin, gamma * lo_fin))
    )

    # Substitute slacks:  s_i = b_i - Σ_k A[i,k] x_k (structural support only).
    gs = coeffs[can.nv : can.nv + can.m]
    cut = coeffs[: can.nv] - gs @ can.A[: can.m, : can.nv]
    cut_rhs = rhs - float(gs @ can.b[: can.m])

    _append_row(handle, cut, api.ComparisonOp.Ge, cut_rhs)
    _run_dual_resolve(handle)
    return api.Solution(handle, handle.problem)
