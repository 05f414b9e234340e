"""Dual simplex: warm-restart reoptimization after problem edits.

Reference analog: `Solver::restore_feasibility` (`src/solver.rs` [CODE]; SURVEY.md
§4.2): after `Solution::add_constraint` / `fix_var` / `add_gomory_cut`, the basis
is dual feasible but primal infeasible; the dual simplex pivots the violated
basic variables out until primal feasibility is restored, at which point the
state is optimal again.

Per iteration (all dense, fixed-shape):
  1. leaving row r: the basic variable with the largest bound violation;
  2. pivot row α = Binv[r]·A (BTRAN is a row read of the explicit inverse);
  3. dual ratio test over non-basic columns: θ_j = |d_j|/|α̃_j| among columns
     whose movement shrinks the violation (α̃ = e·α with e = ±1 the needed
     direction of x_{B_r}); the minimizer keeps every reduced cost on its
     feasible side.  Harris-style two-pass relaxation (mirrors the primal
     `ops/ratio.py`): pass 1 relaxes every reduced cost by the dual
     feasibility tolerance to get a maximal admissible step, pass 2 picks the
     largest |α| among candidates under it — a numerically strong pivot under
     dual degeneracy at the price of ≤opt_tol transient dual infeasibility,
     absorbed by the periodic exact refactorization;
  4. *bound flip*: when the entering variable's unclamped step would overshoot
     its own opposite bound (|Δq| > hi_q − lo_q), it flips there instead —
     basic values update by the traversed range, the basis, inverse and
     reduced costs stay put, the violation at row r strictly shrinks, and the
     next iteration continues with the remaining candidates (the reference's
     bounded-variable dual does the same, `src/solver.rs
     (restore_feasibility)` [CODE]; the primal side's flip is in
     `ops/ratio.py`).  Without this, a boxed entering variable lands in the
     basis outside its own bounds and must be pivoted back out later — extra
     pivots and thrash on box-heavy instances;
  5. otherwise FTRAN of the entering column, PFI inverse update, incremental
     d/x updates.

No eligible entering column means the dual is unbounded ⇒ the primal is
INFEASIBLE (exactly how the reference reports an infeasible cut/fix [CODE]).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..options import SolverOptions
from ..status import Status, VarStat
from .basis import ftran, pfi_update, refactorize
from .primal import _entering_value
from .state import SimplexState


def make_dual_step(A, b, c, lo, hi, opts: SolverOptions):
    """One dual simplex iteration; returns SimplexState -> SimplexState."""

    def step(state: SimplexState) -> SimplexState:
        (basis, vstat, xB, d, Binv, obj, niter, status, noimprove, best,
         _weights, _phase) = state
        loB = jnp.take(lo, basis)
        hiB = jnp.take(hi, basis)
        bland = noimprove >= opts.bland_after

        # -- leaving row: exact dual steepest edge -------------------------------
        # (±inf bounds give -inf differences which max(·,0) absorbs, so no
        # isfinite mask is needed.)
        # With the explicit inverse, the true DSE reference weights are just the
        # squared row norms ‖B⁻ᵀe_r‖² = ‖Binv[r,:]‖² — no incremental weight
        # maintenance needed (the reference approximates this; SURVEY.md §3.2).
        viol_lo = jnp.maximum(loB - xB, 0.0)
        viol_hi = jnp.maximum(xB - hiB, 0.0)
        viol = viol_lo + viol_hi
        row_norm2 = jnp.maximum(jnp.sum(Binv * Binv, axis=1), 1e-12)
        score = (viol * viol) / row_norm2
        r = jnp.argmax(score).astype(jnp.int32)
        max_viol = jnp.max(viol)
        # e = +1: x_{B_r} must increase to its lower bound; e = -1: decrease.
        e = jnp.where(viol_lo[r] > 0, 1.0, -1.0).astype(xB.dtype)
        target = jnp.where(e > 0, loB[r], hiB[r])

        def feasible_case(st: SimplexState) -> SimplexState:
            return st._replace(status=jnp.int32(Status.OPTIMAL))

        def do_iteration(st: SimplexState) -> SimplexState:
            # -- pivot row (BTRAN row read × A) ---------------------------------
            alpha = Binv[r] @ A
            at = e * alpha
            nonbasic_lo = vstat == VarStat.AT_LOWER
            nonbasic_hi = vstat == VarStat.AT_UPPER
            free = vstat == VarStat.FREE
            elig = (
                (nonbasic_lo & (at < -opts.pivot_tol))
                | (nonbasic_hi & (at > opts.pivot_tol))
                | (free & (jnp.abs(at) > opts.pivot_tol))
            )
            theta = jnp.where(elig, jnp.abs(d) / jnp.abs(alpha), jnp.inf)

            def no_entering(s2: SimplexState) -> SimplexState:
                # Dual unbounded ⇒ primal infeasible.
                return s2._replace(status=jnp.int32(Status.INFEASIBLE))

            def pivot(s2: SimplexState) -> SimplexState:
                theta_min = jnp.min(theta)
                # Harris two-pass (mirrors ops/ratio.py): pass 1 relaxes each
                # reduced cost by the dual feasibility tolerance; pass 2 picks
                # the largest |α| among candidates admissible under the
                # relaxed step, widened by the legacy tie window.
                relaxed = jnp.where(
                    elig, (jnp.abs(d) + opts.opt_tol) / jnp.abs(alpha), jnp.inf
                )
                t_relaxed = jnp.min(relaxed)
                tie = (theta <= t_relaxed) | (
                    theta <= theta_min * (1.0 + opts.ratio_tie_rel) + opts.ratio_tie_abs
                )
                tie = tie & elig
                neg_inf = jnp.array(-jnp.inf, dtype=xB.dtype)
                q_stab = jnp.argmax(jnp.where(tie, jnp.abs(alpha), neg_inf))
                n = d.shape[0]
                idx = jnp.arange(n, dtype=jnp.int32)
                q_bland = jnp.argmin(jnp.where(tie, idx, n))
                q = jnp.where(bland, q_bland, q_stab).astype(jnp.int32)

                # primal step of the entering variable
                dq_step = (xB[r] - target) / alpha[q]
                w = ftran(Binv, A[:, q])

                # -- bound flip: entering step clamped at its own range -------
                # AT_LOWER always steps up, AT_UPPER always steps down (the
                # eligibility signs guarantee it), so |dq_step| > hi_q − lo_q
                # means the opposite bound blocks first.  FREE vars have an
                # infinite range and never flip; ties prefer the cheaper flip
                # (no basis change), as in the primal test.
                rng_q = hi[q] - lo[q]
                flip = rng_q <= jnp.abs(dq_step)
                step_f = jnp.sign(dq_step) * rng_q
                xB_f = xB - step_f * w
                vstat_f = vstat.at[q].set(
                    jnp.where(
                        vstat[q] == VarStat.AT_LOWER,
                        jnp.int8(VarStat.AT_UPPER),
                        jnp.int8(VarStat.AT_LOWER),
                    )
                )
                obj_f = obj + d[q] * step_f

                # -- basis exchange -------------------------------------------
                enter_val = _entering_value(vstat[q], lo[q], hi[q]) + dq_step
                xB2 = (xB - dq_step * w).at[r].set(enter_val)

                lv = basis[r]
                lstat = jnp.where(
                    loB[r] == hiB[r],
                    jnp.int8(VarStat.FIXED),
                    jnp.where(e > 0, jnp.int8(VarStat.AT_LOWER), jnp.int8(VarStat.AT_UPPER)),
                )
                vstat2 = vstat.at[lv].set(lstat).at[q].set(jnp.int8(VarStat.BASIC))
                basis2 = basis.at[r].set(q)
                Binv2 = pfi_update(Binv, w, r)

                delta_dual = d[q] / alpha[q]
                d2 = d - delta_dual * alpha
                d2 = d2.at[q].set(0.0).at[lv].set(-delta_dual)
                d2 = jnp.where(vstat2 == VarStat.BASIC, 0.0, d2)
                obj2 = obj + d[q] * dq_step
                return s2._replace(
                    basis=jnp.where(flip, basis, basis2),
                    vstat=jnp.where(flip, vstat_f, vstat2),
                    xB=jnp.where(flip, xB_f, xB2),
                    d=jnp.where(flip, d, d2),
                    Binv=jnp.where(flip, Binv, Binv2),
                    obj=jnp.where(flip, obj_f, obj2),
                )

            return lax.cond(jnp.any(elig), pivot, no_entering, st)

        took_step = max_viol > opts.feas_tol
        s2 = lax.cond(took_step, do_iteration, feasible_case, state)

        # -- progress / periodic refactorization (hoisted out of the branches) --
        eps = 1e-10 * (1.0 + jnp.where(jnp.isfinite(best), jnp.abs(best), 0.0))
        improved = max_viol < best - eps
        noimp2 = jnp.where(improved, 0, noimprove + 1).astype(jnp.int32)
        best2 = jnp.minimum(best, max_viol)
        niter2 = niter + jnp.where(took_step, 1, 0).astype(jnp.int32)
        do_refac = (
            took_step
            & (niter2 % opts.effective_refactor_period() == 0)
            & (s2.status == Status.RUNNING)
        )

        def refac(s3: SimplexState) -> SimplexState:
            Binv3, xB3, d3, obj3, ok = refactorize(
                A, b, c, lo, hi, s3.basis, s3.vstat, s3.Binv,
                newton_iters=opts.newton_refine_iters,
            )
            status3 = jnp.where(ok, s3.status, jnp.int32(Status.NUMERICAL))
            return s3._replace(Binv=Binv3, xB=xB3, d=d3, obj=obj3, status=status3)

        s2 = lax.cond(do_refac, refac, lambda s3: s3, s2)
        return s2._replace(niter=niter2, noimprove=noimp2, best=best2)

    return step


def run_dual(A, b, c, lo, hi, opts: SolverOptions, state: SimplexState, max_iter: int):
    """Dual simplex until primal feasible (OPTIMAL), INFEASIBLE, or MAX_ITER."""
    step = make_dual_step(A, b, c, lo, hi, opts)

    def cond(st: SimplexState):
        return (st.status == Status.RUNNING) & (st.niter < max_iter)

    state = lax.while_loop(cond, step, state)
    return state._replace(
        status=jnp.where(
            state.status == Status.RUNNING, jnp.int32(Status.MAX_ITER), state.status
        )
    )


def resolve_dual(
    A, b, c, lo, hi, basis, vstat, Binv0, opts: SolverOptions
) -> SimplexState:
    """Warm restart: refresh from (basis, vstat, maintained inverse), then dual
    simplex.

    The entry point for `add_constraint` / `fix_var` / `add_gomory_cut`
    (SURVEY.md §4.2): those edits keep the basis dual feasible (slack of a new
    row enters basic with zero cost; bound changes don't touch reduced costs),
    so the dual simplex restores optimality in a few pivots.  `Binv0` is the
    inverse carried in the warm state (row activation updates it analytically
    on the host — see engine/incremental.py).
    """
    M, N = A.shape
    dtype = A.dtype
    max_iter = opts.effective_max_iter(M, N)
    Binv, xB, d, obj, ok = refactorize(
        A, b, c, lo, hi, basis, vstat, Binv0,
        newton_iters=opts.newton_refine_iters,
    )
    state = SimplexState(
        basis=basis.astype(jnp.int32),
        vstat=vstat.astype(jnp.int8),
        xB=xB,
        d=d,
        Binv=Binv,
        obj=obj,
        niter=jnp.int32(0),
        status=jnp.where(ok, jnp.int32(Status.RUNNING), jnp.int32(Status.NUMERICAL)),
        noimprove=jnp.int32(0),
        best=jnp.array(jnp.inf, dtype=dtype),
        weights=jnp.ones_like(d),
        phase=jnp.int32(2),
    )
    return run_dual(A, b, c, lo, hi, opts, state, max_iter)
