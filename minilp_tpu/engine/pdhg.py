"""PDHG (PDLP-style) first-order engine for large sparse instances.

No reference counterpart — this is the build-only engine mandated by BASELINE
(SURVEY.md §3.3: "restarted average-iterate primal-dual hybrid gradient …
residual-norm convergence checks"; PAPERS.md: "GPU-based First-Order Methods
for LP", "Batched First-Order Methods for Parallel LP Solving in MIP").

Operates directly on the canonical equality form  min c·x  s.t.  Ax = b,
lo ≤ x ≤ hi  (free equality duals y):

    x⁺ = Π_[lo,hi](x − τ (c − Aᵀy))
    y⁺ = y + σ (b − A(2x⁺ − x))

with τ = ω/‖A‖₂, σ = 1/(ω‖A‖₂) (‖A‖₂ from power iteration).  Every operation
is a matvec or elementwise pass — dense work that XLA fuses; the same
code vmaps over scenario batches and row-shards over a mesh with a psum on the
matvec partials (SURVEY.md §6.7) — the distributed form lives in
parallel/pdhg_sharded.py, which re-enters `_run_pdhg` with row-block operator
wrappers and a psum/pmax `RowReduce`.

PDLP-grade machinery (all in-graph, fixed-shape):

* **Ruiz equilibration.**  A is rescaled to A' = D_r·A·D_c by iterated
  row/column max-norm balancing before iterating; termination and all reported
  quantities are evaluated in the ORIGINAL space by elementwise unscaling, so
  tolerances keep their user-facing meaning.
* **Adaptive primal weight ω.**  At every adopted restart, ω is re-fit to the
  observed primal/dual movement ratio ‖Δy‖/‖Δx‖ through a geometric smoothing
  (θ = 1/2), the PDLP rule: it balances the two residuals' decay rates.
* **Averaging + restarts.**  Running ergodic averages (x̄, ȳ) since the last
  restart; every `check_every` iterations the KKT error of the current and the
  averaged iterate is measured and the better one becomes the restart point
  when it improved enough (β-factor rule).
* **Infeasibility certificates.**  The normalized average displacement since
  the last restart approximates the infimal displacement vector; its dual part
  is tested as a Farkas ray (primal infeasibility: bᵀy exceeds the box support
  of Aᵀy) and its primal part as a recession ray (unboundedness: A·dx ≈ 0,
  dx in the box's recession cone, c·dx < 0).  Statuses INFEASIBLE/UNBOUNDED
  are exact claims, so both tests are tolerance-guarded and scale-free.

A sparse companion entry point `solve_pdhg_sparse` runs the same loop over a
BCOO matrix (host chooses by density — engine/driver.py): matvecs become
gather/segment-sum kernels, which is the memory-feasible path for very large
sparse instances where densified A would not fit HBM.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import sparse as jsparse

from ..options import SolverOptions
from ..status import Status


class RowReduce(NamedTuple):
    """Reductions over the row (constraint) dimension of the problem.

    Single-device, every row-space vector is whole and the reductions are
    identities.  Under a row-sharded mesh (parallel/pdhg_sharded.py, SURVEY.md
    §6.7 SP/CP analog) each device holds a block of rows and these become
    `lax.psum` / `lax.pmax` over the mesh axis — the ONLY two collectives the
    distributed loop needs.  Both are deterministic for a fixed compilation,
    which keeps the residual reductions (and hence restart/termination
    decisions) bit-identical run to run.
    """

    sum: Callable  # scalar partial-sum combiner (psum over the row axis)
    max: Callable  # elementwise max combiner (pmax; used for column maxima)


#: identity reducer — the single-device / fully-replicated case
LOCAL_ROWS = RowReduce(sum=lambda s: s, max=lambda v: v)


def _ynorm(v, rr: RowReduce):
    """‖v‖₂ of a (possibly row-sharded) row-space vector."""
    return jnp.sqrt(rr.sum(jnp.sum(v * v)))


def _ydot(u, v, rr: RowReduce):
    """u·v for (possibly row-sharded) row-space vectors."""
    return rr.sum(jnp.sum(u * v))


class PdhgState(NamedTuple):
    x: jnp.ndarray        # (N,) primal iterate (scaled space during the loop)
    y: jnp.ndarray        # (M,) dual iterate (equality rows, free)
    x_sum: jnp.ndarray    # (N,) running sum since last restart
    y_sum: jnp.ndarray    # (M,)
    x_rst: jnp.ndarray    # (N,) iterate adopted at the last restart
    y_rst: jnp.ndarray    # (M,)
    omega: jnp.ndarray    # () f — primal weight
    inner: jnp.ndarray    # () f  — iterations since last restart
    last_err: jnp.ndarray  # () f — KKT error at last restart
    niter: jnp.ndarray    # () int32
    status: jnp.ndarray   # () int32
    err: jnp.ndarray      # () f — latest KKT error (of the returned iterate)


def _spectral_norm(A, AT, n, dtype, iters: int = 30) -> jnp.ndarray:
    """‖A‖₂ by power iteration on AᵀA (deterministic start)."""
    v = jnp.ones((n,), dtype=dtype) / jnp.sqrt(jnp.asarray(n, dtype=dtype))

    def body(_, v):
        w = AT @ (A @ v)
        return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

    v = lax.fori_loop(0, iters, body, v)
    return jnp.sqrt(jnp.maximum(jnp.linalg.norm(AT @ (A @ v)), 1e-30))


def _ruiz_dense(A: jnp.ndarray, iters: int, rr: RowReduce = LOCAL_ROWS):
    """Ruiz row/column equilibration scalings (d_r, d_c) for dense A.

    Returns positive vectors such that diag(d_r)·A·diag(d_c) has row and
    column max-norms ≈ 1.  Zero rows/columns (padding) keep scale 1.  When A
    is a row block of a sharded matrix, `rr.max` combines the per-shard column
    maxima (d_r stays block-local, d_c is replicated).
    """
    M, N = A.shape
    dtype = A.dtype
    dr = jnp.ones((M,), dtype=dtype)
    dc = jnp.ones((N,), dtype=dtype)

    def body(_, carry):
        dr, dc = carry
        As = jnp.abs(A) * dr[:, None] * dc[None, :]
        rmax = jnp.max(As, axis=1)
        cmax = rr.max(jnp.max(As, axis=0))
        dr2 = dr / jnp.sqrt(jnp.where(rmax > 0, rmax, 1.0))
        dc2 = dc / jnp.sqrt(jnp.where(cmax > 0, cmax, 1.0))
        return dr2, dc2

    dr, dc = lax.fori_loop(0, iters, body, (dr, dc))
    return dr, dc


def _ruiz_bcoo(A: jsparse.BCOO, iters: int):
    """Ruiz scalings for a BCOO matrix via segment-max over its nonzeros."""
    M, N = A.shape
    dtype = A.data.dtype
    rows = A.indices[:, 0]
    cols = A.indices[:, 1]
    absdata = jnp.abs(A.data)
    dr = jnp.ones((M,), dtype=dtype)
    dc = jnp.ones((N,), dtype=dtype)

    def body(_, carry):
        dr, dc = carry
        scaled = absdata * dr[rows] * dc[cols]
        rmax = jax.ops.segment_max(scaled, rows, num_segments=M)
        cmax = jax.ops.segment_max(scaled, cols, num_segments=N)
        dr2 = dr / jnp.sqrt(jnp.where(rmax > 0, rmax, 1.0))
        dc2 = dc / jnp.sqrt(jnp.where(cmax > 0, cmax, 1.0))
        return dr2, dc2

    dr, dc = lax.fori_loop(0, iters, body, (dr, dc))
    return dr, dc


def _kkt_error(Axs, ATys, xs, ys, b, c, lo, hi, dr, dc, scale_b, scale_c,
               feas_tol, rr: RowReduce = LOCAL_ROWS):
    """Relative KKT error in the ORIGINAL space from scaled-space quantities.

    Args are the scaled matvec results (A'x', A'ᵀy') and scaled iterates; the
    elementwise unscalings x = d_c⊙x', y = d_r⊙y', residual/d_r, reduced/d_c
    recover original-space values exactly (diag scalings commute with norms
    only through these weights — doing it this way keeps one copy of A).
    """
    x = dc * xs
    r_vec = (Axs - b) / dr          # original A x − b   (b here is scaled b')
    r_p = _ynorm(r_vec, rr) / scale_b
    red = (c - ATys) / dc           # original c − Aᵀy   (c here is scaled c')
    lo_o = lo * dc                  # original bounds (lo/hi args are scaled)
    hi_o = hi * dc
    at_lo = x <= lo_o + feas_tol
    at_hi = x >= hi_o - feas_tol
    viol = jnp.where(at_lo, jnp.minimum(red, 0.0), red)
    viol = jnp.where(at_hi & ~at_lo, jnp.maximum(red, 0.0), viol)
    viol = jnp.where(at_lo & at_hi, 0.0, viol)  # fixed vars: any sign ok
    r_d = jnp.linalg.norm(viol) / scale_c
    # duality gap: dual objective b·y + Σ_j inf over box of red_j·x_j, taking
    # the attained bound per reduced-cost sign (0 contribution when the sign
    # disagrees with an infinite bound — that part is already in r_d).
    lo_f = jnp.where(jnp.isfinite(lo_o), lo_o, 0.0)
    hi_f = jnp.where(jnp.isfinite(hi_o), hi_o, 0.0)
    contrib = jnp.where(red > 0, red * lo_f, red * hi_f)
    dobj = _ydot(b, ys, rr) + jnp.sum(contrib)  # bᵀy = b'ᵀy' (scaled pairing)
    pobj = c @ xs                             # cᵀx = c'ᵀx'
    gap = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj) + jnp.abs(dobj))
    return jnp.maximum(jnp.maximum(r_p, r_d), gap)


def _certificates(A, AT, dx_s, dy_s, b, c, lo, hi, dr, dc, tol,
                  rr: RowReduce = LOCAL_ROWS):
    """Farkas / recession-ray tests on the (scaled-space) displacement.

    Returns (primal_infeasible, unbounded) booleans.  All quantities are
    mapped to the original space and the candidate rays are unit-normalized,
    making every threshold scale-free:

    * dual ray y = d_r⊙dy': primal INFEASIBLE when q = Aᵀy lies in the box's
      polar directions (q_j ≤ 0 where hi_j = ∞, q_j ≥ 0 where lo_j = −∞, up
      to `tol`) and bᵀy − Σ_j max(q_j·lo_j, q_j·hi_j) > tol.
    * primal ray dx = d_c⊙dx': UNBOUNDED when ‖A·dx‖ ≤ tol, dx is in the
      box's recession cone (zero where both bounds finite, signed where
      one-sided) and c·dx < −tol.
    """
    # --- dual (Farkas) ray → primal infeasibility -----------------------------
    y_norm = _ynorm(dy_s * dr, rr)  # ‖y‖ in original space
    y_unit = jnp.where(y_norm > 0, dy_s / jnp.maximum(y_norm, 1e-30), 0.0)
    q = (AT @ y_unit) / dc               # original Aᵀŷ
    lo_o = lo * dc
    hi_o = hi * dc
    fin_lo = jnp.isfinite(lo_o)
    fin_hi = jnp.isfinite(hi_o)
    # cone violation: components pointing at an infinite side of the box
    cone = jnp.where(~fin_hi, jnp.maximum(q, 0.0), 0.0) + jnp.where(
        ~fin_lo, jnp.maximum(-q, 0.0), 0.0
    )
    cone_ok = jnp.max(cone) <= tol
    # box support function sup_{lo≤x≤hi} qᵀx after clamping q into the cone
    # (the clamped part is exactly what `cone` measures): per component the
    # sup is attained at the finite bound matching sign(q).
    qt = jnp.where(~fin_hi, jnp.minimum(q, 0.0), q)
    qt = jnp.where(~fin_lo, jnp.maximum(qt, 0.0), qt)
    lo_f = jnp.where(fin_lo, lo_o, 0.0)
    hi_f = jnp.where(fin_hi, hi_o, 0.0)
    s = jnp.where(
        fin_lo & fin_hi,
        jnp.maximum(qt * lo_f, qt * hi_f),
        jnp.where(fin_lo, qt * lo_f, jnp.where(fin_hi, qt * hi_f, 0.0)),
    )
    support = jnp.sum(s)
    by = _ydot(b / dr, y_unit, rr)       # original bᵀŷ (b arg is scaled b')
    # strict, scale-free margin requirement (a wrong INFEASIBLE is a lie —
    # the margin must clear a much higher bar than the cone residual)
    margin_ok = (by - support) > 1e2 * tol * (1.0 + jnp.abs(by) + jnp.abs(support))
    primal_infeas = cone_ok & margin_ok & (y_norm > 0)

    # --- primal recession ray → unboundedness ---------------------------------
    dx_norm = jnp.linalg.norm(dx_s * dc)  # x-space: replicated, local norm ok
    dx_unit = jnp.where(dx_norm > 0, dx_s / jnp.maximum(dx_norm, 1e-30), 0.0)
    Adx = (A @ dx_unit) / dr             # original A·d̂x
    dxo = dx_unit * dc
    # recession cone of [lo, hi]
    rec_viol = jnp.where(fin_lo & fin_hi, jnp.abs(dxo), 0.0)
    rec_viol = rec_viol + jnp.where(
        fin_lo & ~fin_hi, jnp.maximum(-dxo, 0.0), 0.0
    )
    rec_viol = rec_viol + jnp.where(
        ~fin_lo & fin_hi, jnp.maximum(dxo, 0.0), 0.0
    )
    ray_ok = (_ynorm(Adx, rr) <= tol) & (jnp.max(rec_viol) <= tol)
    descent = (c / dc) @ dx_unit < -1e2 * tol * (1.0 + jnp.linalg.norm(c / dc))
    unbounded = ray_ok & descent & (dx_norm > 0)
    return primal_infeas, unbounded


def _run_pdhg(A, AT, b, c, lo, hi, dr, dc, opts: SolverOptions, omega0,
              rr: RowReduce = LOCAL_ROWS, state0: "PdhgState | None" = None,
              stop_at=None):
    """The restarted-average adaptive-weight PDHG loop (scaled space).

    `A`/`AT` may be dense arrays, BCOO matrices, or row-sharded operator
    wrappers (parallel/pdhg_sharded.py) — only `@` is used.  Under sharding,
    all row-space args (A's rows, b, dr) are local blocks and `rr` carries the
    psum/pmax collectives; every scalar this loop branches on is reduced
    through `rr`, so all shards take identical restart/termination decisions.
    Returns a PdhgState whose x, y are in the ORIGINAL space.
    """
    M, N = b.shape[0], c.shape[0]
    dtype = b.dtype
    norm_a = _spectral_norm(A, AT, N, dtype)
    scale_b = 1.0 + _ynorm(b / dr, rr)
    scale_c = 1.0 + jnp.linalg.norm(c / dc)
    tol = opts.feas_tol
    cert_tol = opts.pdhg_infeas_tol

    lo_c = jnp.where(jnp.isfinite(lo), lo, -1e30)
    hi_c = jnp.where(jnp.isfinite(hi), hi, 1e30)
    x0 = jnp.clip(jnp.zeros((N,), dtype=dtype), lo_c, hi_c)
    y0 = jnp.zeros((M,), dtype=dtype)

    halpern = opts.pdhg_variant == "halpern"
    if opts.pdhg_variant not in ("halpern", "vanilla"):
        raise ValueError(f"unknown pdhg_variant {opts.pdhg_variant!r}")

    def body(st: PdhgState) -> PdhgState:
        tau = st.omega / norm_a
        sig = 1.0 / (st.omega * norm_a)

        if halpern:
            # -- reflected PDHG + Halpern anchoring (cuPDLP-class scheme) ----
            # One window of check_every steps:  z̃ = T(z) (the plain PDHG
            # operator), reflect 2z̃ − z, then pull toward the ANCHOR (the
            # last restart point) with weight 1/(k+2).  The anchored
            # combination converges O(1/k) on the fixed-point residual —
            # in practice several× fewer iterations than ergodic averaging
            # — and restarts simply move the anchor.
            def inner(carry, _):
                x, y, k = carry
                x_t = jnp.clip(x - tau * (c - AT @ y), lo_c, hi_c)
                y_t = y + sig * (b - A @ (2.0 * x_t - x))
                lam = 1.0 / (k + 2.0)
                x_n = lam * st.x_rst + (1.0 - lam) * (2.0 * x_t - x)
                y_n = lam * st.y_rst + (1.0 - lam) * (2.0 * y_t - y)
                return (x_n, y_n, k + 1.0), None

            (x, y, _k), _ = lax.scan(
                inner, (st.x, st.y, st.inner), None,
                length=opts.pdhg_check_every,
            )
            xs, ys = st.x_sum, st.y_sum  # unused by this variant (stay zero)
        else:
            # -- PDLP restarted-average scheme -------------------------------
            def inner(carry, _):
                x, y, xs, ys = carry
                x_new = jnp.clip(x - tau * (c - AT @ y), lo_c, hi_c)
                y_new = y + sig * (b - A @ (2.0 * x_new - x))
                return (x_new, y_new, xs + x_new, ys + y_new), None

            (x, y, xs, ys), _ = lax.scan(
                inner, (st.x, st.y, st.x_sum, st.y_sum), None,
                length=opts.pdhg_check_every,
            )
        inner_cnt = st.inner + opts.pdhg_check_every
        niter = st.niter + opts.pdhg_check_every

        # -- candidate iterates ----------------------------------------------
        if halpern:
            # candidates are the current iterate; the "average displacement"
            # certificate below uses (current − anchor) instead
            x_avg, y_avg = x, y
            err_cur = _kkt_error(A @ x, AT @ y, x, y, b, c, lo, hi, dr, dc,
                                 scale_b, scale_c, tol, rr)
            err_best = err_cur
            x_best, y_best = x, y
        else:
            x_avg = xs / inner_cnt
            y_avg = ys / inner_cnt
            err_cur = _kkt_error(A @ x, AT @ y, x, y, b, c, lo, hi, dr, dc,
                                 scale_b, scale_c, tol, rr)
            err_avg = _kkt_error(A @ x_avg, AT @ y_avg, x_avg, y_avg, b, c,
                                 lo, hi, dr, dc, scale_b, scale_c, tol, rr)
            use_avg = err_avg < err_cur
            err_best = jnp.minimum(err_avg, err_cur)
            x_best = jnp.where(use_avg, x_avg, x)
            y_best = jnp.where(use_avg, y_avg, y)

        done = err_best <= tol

        # -- infeasibility / unboundedness certificates ------------------------
        # Two candidate rays for the infimal displacement vector (Applegate et
        # al., "Infeasibility detection with PDHG"): the one-step iterate
        # difference (converges geometrically on infeasible instances — the
        # primary detector) and the average displacement since the last
        # restart (robust when the one-step difference oscillates).
        x_one = jnp.clip(x - tau * (c - AT @ y), lo_c, hi_c)
        y_one = y + sig * (b - A @ (2.0 * x_one - x))
        p_inf1, unb1 = _certificates(
            A, AT, x_one - x, y_one - y, b, c, lo, hi, dr, dc, cert_tol, rr
        )
        p_inf2, unb2 = _certificates(
            A, AT, x_avg - st.x_rst, y_avg - st.y_rst, b, c, lo, hi, dr, dc,
            cert_tol, rr
        )
        p_inf = p_inf1 | p_inf2
        unb = unb1 | unb2
        # only trust a ray once the window is long enough to average out the
        # transient, and never after convergence
        settled = (inner_cnt >= 4.0 * opts.pdhg_check_every) & ~done

        # -- β-factor restart: adopt the best candidate when the restart
        # METRIC improved enough.  Vanilla keys on the KKT error (PDLP);
        # Halpern keys on the FIXED-POINT residual ‖T(z)−z‖ (r2HPDHG) —
        # the KKT error has a bound-activity cliff (the O(1/k) anchored
        # tail leaves variables ~1/k off their bounds, so the at-bound
        # classification never fires and the error plateaus while the
        # iterate is still converging), which would deadlock
        # sufficient-decay restarts.  The ARTIFICIAL rule (restart whenever
        # the window exceeds ~36% of all iterations so far — PDLP's bound)
        # backstops both.
        if halpern:
            metric = jnp.sqrt(
                jnp.sum((x_one - x) ** 2)
                + rr.sum(jnp.sum((y_one - y) ** 2))
            )
        else:
            metric = err_best
        artificial = inner_cnt >= 0.36 * niter.astype(dtype)
        decay_restart = done | (metric <= opts.pdhg_restart_beta * st.last_err)
        restart = decay_restart | artificial
        # adaptive primal weight at adopted restarts (PDLP θ-smoothing).
        # HALPERN RUNS WITH A FROZEN ω: both PDLP's window-displacement
        # ratio and a one-step-displacement variant were measured to
        # ratchet ω to the clip under anchored dynamics (the anchor pull
        # biases the displacement geometry), so the anchored variant keeps
        # the initial ‖c‖/‖b‖-scaled weight — the documented trade-off in
        # options.py.
        d_x = jnp.linalg.norm((x_best - st.x_rst) * dc)
        d_y = _ynorm((y_best - st.y_rst) * dr, rr)
        can_fit = (d_x > 1e-12) & (d_y > 1e-12)
        th = 0.0 if halpern else opts.pdhg_weight_theta
        om_fit = jnp.exp(
            th * jnp.log(jnp.maximum(d_y, 1e-30) / jnp.maximum(d_x, 1e-30))
            + (1.0 - th) * jnp.log(st.omega)
        )
        # refit only on SUFFICIENT-DECAY restarts: artificial restarts come
        # from short, noisy windows whose displacement ratio is not a signal
        # — refitting on them ratchets ω to the clip and diverges (measured
        # on random instances when the artificial rule landed, round 5)
        om_new = jnp.where(decay_restart & can_fit, om_fit, st.omega)
        om_new = jnp.clip(om_new, 1e-6, 1e6)

        x_n = jnp.where(restart, x_best, x)
        y_n = jnp.where(restart, y_best, y)
        xs_n = jnp.where(restart, jnp.zeros_like(xs), xs)
        ys_n = jnp.where(restart, jnp.zeros_like(ys), ys)
        xr_n = jnp.where(restart, x_best, st.x_rst)
        yr_n = jnp.where(restart, y_best, st.y_rst)
        inner_n = jnp.where(restart, 0.0, inner_cnt)
        last_n = jnp.where(restart, metric, st.last_err)

        status = jnp.where(done, jnp.int32(Status.OPTIMAL), st.status)
        status = jnp.where(settled & p_inf, jnp.int32(Status.INFEASIBLE), status)
        status = jnp.where(
            settled & unb & ~p_inf, jnp.int32(Status.UNBOUNDED), status
        )
        return PdhgState(
            x=x_n, y=y_n, x_sum=xs_n, y_sum=ys_n, x_rst=xr_n, y_rst=yr_n,
            omega=om_new, inner=inner_n.astype(dtype), last_err=last_n,
            niter=niter, status=status, err=err_best,
        )

    if state0 is None:
        st0 = PdhgState(
            x=x0, y=y0, x_sum=jnp.zeros_like(x0), y_sum=jnp.zeros_like(y0),
            x_rst=x0, y_rst=y0,
            omega=jnp.asarray(omega0, dtype=dtype),
            inner=jnp.array(0.0, dtype=dtype),
            last_err=jnp.array(jnp.inf, dtype=dtype),
            niter=jnp.int32(0), status=jnp.int32(Status.RUNNING),
            err=jnp.array(jnp.inf, dtype=dtype),
        )
    else:
        # warm re-entry (chunked execution): the handed-in state is in the
        # ORIGINAL space — rescale the iterates; x_sum/y_sum stayed scaled.
        # A chunk-capped launch exits MAX_ITER; that is not terminal here.
        st0 = state0._replace(
            x=state0.x / dc, y=state0.y / dr,
            x_rst=state0.x_rst / dc, y_rst=state0.y_rst / dr,
            status=jnp.where(
                state0.status == Status.MAX_ITER,
                jnp.int32(Status.RUNNING), state0.status,
            ),
        )
    hard_stop = (jnp.int32(opts.pdhg_max_iter) if stop_at is None
                 else jnp.minimum(jnp.int32(stop_at),
                                  jnp.int32(opts.pdhg_max_iter)))

    def cond(st: PdhgState):
        return (st.status == Status.RUNNING) & (st.niter < hard_stop)

    st = lax.while_loop(cond, body, st0)
    st = st._replace(
        status=jnp.where(
            st.status == Status.RUNNING, jnp.int32(Status.MAX_ITER), st.status
        )
    )
    # unscale the reported iterates back to the original space
    return st._replace(x=st.x * dc, y=st.y * dr, x_rst=st.x_rst * dc,
                       y_rst=st.y_rst * dr)


def _omega0(b, c, dr, dc, opts: SolverOptions, rr: RowReduce = LOCAL_ROWS):
    if opts.pdhg_omega is not None:
        return jnp.asarray(opts.pdhg_omega, dtype=b.dtype)
    nb = _ynorm(b / dr, rr)
    nc = jnp.linalg.norm(c / dc)
    ok = (nb > 1e-12) & (nc > 1e-12)
    return jnp.where(ok, nc / jnp.maximum(nb, 1e-30), 1.0)


@partial(jax.jit, static_argnames=("opts",))
def solve_pdhg(
    A: jnp.ndarray,
    b: jnp.ndarray,
    c: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    opts: SolverOptions,
    state0: "PdhgState | None" = None,
    stop_at=None,
) -> PdhgState:
    """Dense-path PDHG: Ruiz-equilibrate, then run to relative KKT ≤ feas_tol.

    Jittable and vmappable; x/y in the returned state are original-space.

    When `A` arrives in a NARROWER dtype than the vectors (bfloat16 A with
    f32 b/c — the device head-start path), the scaled matrix keeps that
    dtype so the iterate matvecs read half the bytes of device memory: its
    entries are bf16-rounded, and the bf16×f32 contractions promote to f32
    and accumulate in f32.  All vector math stays in the vectors' dtype.
    """
    vdtype = b.dtype
    mat_dtype = A.dtype
    Af = A.astype(vdtype)
    dr, dc = _ruiz_dense(Af, opts.pdhg_ruiz_iters)
    As = (Af * dr[:, None] * dc[None, :]).astype(mat_dtype)
    bs = b * dr
    cs = c * dc
    los = lo / dc
    his = hi / dc
    om0 = _omega0(bs, cs, dr, dc, opts)
    return _run_pdhg(As, As.T, bs, cs, los, his, dr, dc, opts, om0,
                     state0=state0, stop_at=stop_at)


@partial(jax.jit, static_argnames=("opts",))
def solve_pdhg_sparse(
    A: jsparse.BCOO,
    b: jnp.ndarray,
    c: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    opts: SolverOptions,
    state0: "PdhgState | None" = None,
    stop_at=None,
) -> PdhgState:
    """Sparse-path PDHG over a BCOO constraint matrix.

    The loop only needs `A @ x` and `Aᵀ @ y`; with BCOO these lower to
    gather + segment-sum, so HBM holds O(nnz) instead of O(M·N) — the
    pressure valve for very large sparse instances (SURVEY.md §8 "Hard
    parts" #4).  The host driver picks this path by density.
    """
    dr, dc = _ruiz_bcoo(A, opts.pdhg_ruiz_iters)
    rows = A.indices[:, 0]
    cols = A.indices[:, 1]
    data_s = A.data * dr[rows] * dc[cols]
    As = jsparse.BCOO((data_s, A.indices), shape=A.shape)
    ATs = jsparse.BCOO(
        (data_s, jnp.stack([cols, rows], axis=1)),
        shape=(A.shape[1], A.shape[0]),
    )
    bs = b * dr
    cs = c * dc
    los = lo / dc
    his = hi / dc
    om0 = _omega0(bs, cs, dr, dc, opts)
    return _run_pdhg(As, ATs, bs, cs, los, his, dr, dc, opts, om0,
                     state0=state0, stop_at=stop_at)
