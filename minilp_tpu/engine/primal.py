"""Two-phase bounded-variable primal revised simplex as ONE jitted
`lax.while_loop`.

Reference analog: `Solver::optimize` / `find_initial_bfs` and the pivot
machinery (`src/solver.rs` [CODE]; SURVEY.md §4.1 call stack).  Accelerator
redesign decisions (SURVEY.md §8 Phase 1, plus compile-cost pragmatics):

* **One loop, phase in the carry.**  Phase 1 (minimize total bound
  infeasibility with composite costs σ) and phase 2 (optimize c·x with
  maintained reduced costs + Devex weights) share a single loop body; the
  phase-1→2 transition is a flag flip plus an exact refactorization inside the
  body.  This compiles one body instead of two (the XLA graph — and its
  (re)factorization subgraphs — dominates compile time), and under `vmap` it
  removes the cross-lane phase barrier: each batched LP transitions
  independently.
* **One ratio test.**  The phase-1 bounded ratio test (infeasible basics block
  at the bound they are moving *toward*, rows moving away from a violated
  bound never block) reduces exactly to the textbook phase-2 rule when all
  basics are feasible, so it is used unconditionally — and degrades gracefully
  under phase-2 drift.
* **Phase-specific work behind `lax.cond`.**  The O(M·N) phase-1 reduced-cost
  recomputation and the O(M·N) phase-2 pivot-row/Devex update each run only in
  their phase (XLA conditionals execute the taken branch only).
* Unknown iteration count lives in the while loop; terminal conditions are
  status flags (no exceptions); every shape is static (padding is inert by
  construction — see `minilp_tpu.canonical`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.pricing import choose_entering, phase1_reduced_costs, phase1_sigma
from ..ops.ratio import ratio_test
from ..options import SolverOptions
from ..status import Status, VarStat
from .basis import ftran, pfi_update, refactorize
from .state import SimplexState


def _entering_value(vstat_q, lo_q, hi_q):
    """Current value of the (non-basic) entering variable."""
    return jnp.where(
        (vstat_q == VarStat.AT_LOWER) | (vstat_q == VarStat.FIXED), lo_q,
        jnp.where(vstat_q == VarStat.AT_UPPER, hi_q, 0.0),
    )


def make_step(A, b, c, lo, hi, opts: SolverOptions):
    """Build the unified simplex iteration body: SimplexState -> SimplexState."""
    dtype = A.dtype
    use_devex = opts.pricing == "devex"

    def refresh(st: SimplexState) -> SimplexState:
        Binv2, xB2, d2, obj2, ok = refactorize(
            A, b, c, lo, hi, st.basis, st.vstat, st.Binv,
            newton_iters=opts.newton_refine_iters,
        )
        # Newton seed outside its basin → hand the rare hard case to the host
        # (exact rebuild + resume, see engine/driver.py).
        status2 = jnp.where(ok, st.status, jnp.int32(Status.NUMERICAL))
        return st._replace(Binv=Binv2, xB=xB2, d=d2, obj=obj2, status=status2)

    def step(state: SimplexState) -> SimplexState:
        loB0 = jnp.take(lo, state.basis)
        hiB0 = jnp.take(hi, state.basis)
        sigma0, _ = phase1_sigma(state.xB, loB0, hiB0, opts.feas_tol)
        feasible = ~jnp.any(sigma0 != 0)

        # -- phase transition: feasibility reached → exact refresh, phase = 2 --
        transition = (state.phase == 1) & feasible
        state = lax.cond(transition, refresh, lambda s: s, state)
        state = state._replace(
            phase=jnp.where(transition, 2, state.phase).astype(jnp.int32),
            noimprove=jnp.where(transition, 0, state.noimprove).astype(jnp.int32),
            best=jnp.where(transition, jnp.array(jnp.inf, dtype=dtype), state.best),
        )

        (basis, vstat, xB, d, Binv, obj, niter, status, noimprove, best,
         weights, phase) = state
        p1 = phase == 1
        loB = jnp.take(lo, basis)
        hiB = jnp.take(hi, basis)
        bland = noimprove >= opts.bland_after

        sigma, infeas = phase1_sigma(xB, loB, hiB, opts.feas_tol)
        # Phase-1 composite reduced costs are recomputed each iteration (σ is
        # state-dependent); phase 2 prices the maintained d.  Taken-branch-only
        # execution keeps the O(M·N) recompute out of phase 2.
        dcur = lax.cond(
            p1,
            lambda: phase1_reduced_costs(A, Binv, sigma, vstat),
            lambda: d,
        )
        metric = jnp.where(p1, infeas, obj)
        w_pricing = (
            jnp.where(p1, jnp.ones_like(weights), weights) if use_devex else None
        )

        ch = choose_entering(dcur, vstat, opts.opt_tol, bland, weights=w_pricing)
        # no entering: phase-1 ⇒ infeasibility is minimal and positive ⇒
        # INFEASIBLE; phase-2 ⇒ OPTIMAL.
        finished_status = jnp.where(
            p1, jnp.int32(Status.INFEASIBLE), jnp.int32(Status.OPTIMAL)
        )

        def no_entering(st: SimplexState) -> SimplexState:
            return st._replace(status=finished_status)

        def do_iteration(st: SimplexState) -> SimplexState:
            q, s = ch.q, ch.direction
            w = ftran(Binv, A[:, q])  # FTRAN: entering column in basis coords
            rng_q = hi[q] - lo[q]
            rt = ratio_test(
                w, s, xB, loB, hiB, rng_q, basis, bland,
                phase1=True,  # the unified rule; reduces to phase-2 when feasible
                pivot_tol=opts.pivot_tol,
                feas_tol=opts.feas_tol,
                tie_rel=opts.ratio_tie_rel,
                tie_abs=opts.ratio_tie_abs,
            )
            # An unblocked ray is UNBOUNDED in phase 2; in phase 1 it cannot
            # happen with exact arithmetic (see ops/ratio.py) ⇒ NUMERICAL.
            ub_status = jnp.where(
                p1, jnp.int32(Status.NUMERICAL), jnp.int32(Status.UNBOUNDED)
            )

            def unbounded_case(s2: SimplexState) -> SimplexState:
                return s2._replace(status=ub_status)

            def flip_case(s2: SimplexState) -> SimplexState:
                # Bound flip: entering variable traverses to its opposite bound,
                # basis unchanged (`PivotInfo` with no pivot element [CODE]).
                t = rt.t
                xB2 = xB + t * (-s * w)
                new_stat = jnp.where(
                    vstat[q] == VarStat.AT_LOWER,
                    jnp.int8(VarStat.AT_UPPER),
                    jnp.int8(VarStat.AT_LOWER),
                )
                obj2 = jnp.where(p1, obj, obj + dcur[q] * s * t)
                return s2._replace(
                    vstat=vstat.at[q].set(new_stat), xB=xB2, obj=obj2
                )

            def pivot_case(s2: SimplexState) -> SimplexState:
                r, t = rt.r, rt.t
                lv = basis[r]
                enter_val = _entering_value(vstat[q], lo[q], hi[q]) + s * t
                xB2 = (xB + t * (-s * w)).at[r].set(enter_val)
                lstat = jnp.where(
                    loB[r] == hiB[r],
                    jnp.int8(VarStat.FIXED),
                    jnp.where(
                        rt.tgt_r == hiB[r],
                        jnp.int8(VarStat.AT_UPPER),
                        jnp.int8(VarStat.AT_LOWER),
                    ),
                )
                vstat2 = vstat.at[lv].set(lstat).at[q].set(jnp.int8(VarStat.BASIC))
                basis2 = basis.at[r].set(q)
                Binv2 = pfi_update(Binv, w, r)

                def phase2_updates():
                    # Pivot row α = (old B⁻¹)_r · A — BTRAN row read × A
                    # (`calc_row_coeffs` [CODE]); feeds both the reduced-cost
                    # update and the Devex weight maintenance.
                    alpha = Binv[r] @ A
                    rd = dcur[q] / w[r]
                    d2 = dcur - rd * alpha
                    d2 = d2.at[q].set(0.0).at[lv].set(-rd)
                    d2 = jnp.where(vstat2 == VarStat.BASIC, 0.0, d2)
                    obj2 = obj + dcur[q] * s * t
                    if use_devex:
                        gq = jnp.maximum(weights[q], 1.0)
                        tcol = alpha / w[r]
                        cand = (tcol * tcol) * gq
                        w_new = jnp.maximum(weights, cand)
                        w_new = w_new.at[lv].set(
                            jnp.maximum(gq / (w[r] * w[r]), 1.0)
                        )
                        w_new = w_new.at[q].set(1.0)
                        weights2 = jnp.where(
                            gq > opts.devex_reset, jnp.ones_like(w_new), w_new
                        )
                    else:
                        weights2 = weights
                    return d2, obj2, weights2

                d2, obj2, weights2 = lax.cond(
                    p1, lambda: (d, obj, weights), phase2_updates
                )
                return s2._replace(
                    basis=basis2, vstat=vstat2, xB=xB2, d=d2, Binv=Binv2,
                    obj=obj2, weights=weights2,
                )

            return lax.cond(
                rt.unbounded,
                unbounded_case,
                lambda st2: lax.cond(rt.flip, flip_case, pivot_case, st2),
                st,
            )

        s2 = lax.cond(ch.found, do_iteration, no_entering, state)

        # -- progress accounting (anti-cycling trigger) ------------------------
        eps = 1e-10 * (1.0 + jnp.where(jnp.isfinite(best), jnp.abs(best), 0.0))
        improved = metric < best - eps
        noimp2 = jnp.where(improved, 0, noimprove + 1).astype(jnp.int32)
        best2 = jnp.minimum(best, metric)
        niter2 = niter + jnp.where(ch.found, 1, 0).astype(jnp.int32)

        # -- periodic refactorization (drift cleanup; same graph as the
        #    transition refresh above) -----------------------------------------
        do_refac = (
            ch.found
            & (niter2 % opts.effective_refactor_period() == 0)
            & (s2.status == Status.RUNNING)
        )
        s2 = lax.cond(do_refac, refresh, lambda s3: s3, s2)
        return s2._replace(niter=niter2, noimprove=noimp2, best=best2)

    return step


def run_simplex(A, b, c, lo, hi, opts: SolverOptions, state: SimplexState, max_iter: int):
    """Drive the unified loop until a terminal status (or MAX_ITER)."""
    step = make_step(A, b, c, lo, hi, opts)

    def cond(st: SimplexState):
        return (st.status == Status.RUNNING) & (st.niter < max_iter)

    state = lax.while_loop(cond, step, state)
    return state._replace(
        status=jnp.where(
            state.status == Status.RUNNING, jnp.int32(Status.MAX_ITER), state.status
        )
    )


def solve_canonical(
    A, b, c, lo, hi, vstat0, basis0, opts: SolverOptions, Binv0=None
) -> SimplexState:
    """Cold solve of a canonical LP (device-side `Problem::solve`, SURVEY.md
    §4.1).  Jittable, vmappable; `opts` must be static under jit.  Also the
    warm primal re-solver: pass a previous solve's (vstat, basis) plus its
    maintained inverse as `Binv0` (cold solves start from the slack basis,
    whose inverse is exactly the identity — no factorization needed)."""
    M, N = A.shape
    dtype = A.dtype
    max_iter = opts.effective_max_iter(M, N)

    if Binv0 is None:
        Binv0 = jnp.eye(M, dtype=dtype)
    Binv, xB, d, obj, ok = refactorize(
        A, b, c, lo, hi, basis0, vstat0, Binv0,
        newton_iters=opts.newton_refine_iters,
    )
    state = SimplexState(
        basis=basis0.astype(jnp.int32),
        vstat=vstat0.astype(jnp.int8),
        xB=xB,
        d=d,
        Binv=Binv,
        obj=obj,
        niter=jnp.int32(0),
        status=jnp.where(ok, jnp.int32(Status.RUNNING), jnp.int32(Status.NUMERICAL)),
        noimprove=jnp.int32(0),
        best=jnp.array(jnp.inf, dtype=dtype),
        weights=jnp.ones_like(d),
        phase=jnp.int32(1),
    )
    return run_simplex(A, b, c, lo, hi, opts, state, max_iter)
