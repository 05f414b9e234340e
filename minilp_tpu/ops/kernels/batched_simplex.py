"""Batched small-LP simplex kernel for the GPU: one Pallas program per LP,
compiled through Triton.

This is the one-block-per-problem design of PAPERS.md "Simultaneous Solving
of Batched Linear Programs on a GPU" (Gurung & Ray, 1802.08557): for a batch
of small LPs, each program owns one LP and runs its *entire* bounded-variable
two-phase simplex loop, so a pivot costs no kernel launch and no host sync.
The vmapped XLA engine (`parallel.batched.solve_batch`) pays several launches
and a predicate read-back per pivot for the whole batch instead.

Design for Triton:

* **Loop-carried state.**  The Triton route has no scratch memory, so the
  basis inverse B⁻¹ (m×m), the basic values, reduced costs, gathered basic
  bounds/costs and the Devex weights are carries of one `lax.while_loop`.
  A (m×n) is read from the program's input block.
* **Gather-free.**  Every gather of a basic quantity is a one-hot masked
  reduction, and the basis-matrix assembly of the periodic Newton refresh is
  a one-hot matrix product — no dynamic indexing inside the kernel.
* **Powers of two.**  Triton blocks are powers of two, so `pad_batch` pads
  m and n with inert rows and columns (the `canonical.py` rules: a padding
  row is a zero row whose own slack is fixed [0, 0] and basic at 0; a
  padding column is fixed [0, 0] and can never enter) and `unpad_result`
  strips them from the results.
* **IEEE f32 products.**  Every `pl.dot` is pinned to `Precision.HIGHEST`,
  which the Triton route lowers to IEEE f32.  TF32 (the default) keeps ~10
  mantissa bits and drifts the maintained inverse until the final bases miss
  f64 certification.

Envelope: padded m ≤ 64 and padded m·n ≤ 16384 (64×256, e.g. the 32×128
scenario LPs).  A (m·n f32) and B⁻¹ live in registers; beyond the envelope
they would spill, and `routes.batched_route` sends such batches to the plain
vmapped engine.

Precision: the kernel iterates in f32.  The simplex basis is combinatorial,
so the exact vertex is one f64 recompute from (basis, vstat): callers certify
every lane on the host (`parallel.batched.verify_f64`).

Simplifications vs the general engine (valid for the scenario workload, which
is generated feasible with finite lower bounds): Devex pricing in phase 2 /
Dantzig in phase 1, stall-based Bland fallback only in phase 1.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from ...status import Status, VarStat

F32 = jnp.float32
I32 = jnp.int32
HIGHEST = lax.Precision.HIGHEST

#: largest padded row count / padded m·n the kernel is built for
MAX_ROWS = 64
MAX_CELLS = 64 * 256
#: smallest padded dimension (Triton's dot needs every dimension ≥ 16)
MIN_DIM = 16


def padded_dims(m: int, n: int) -> tuple[int, int]:
    """Power-of-two (rows, cols) the kernel runs at for an (m, n) LP: rows
    gain one inert slack column each, so the columns grow with them."""
    mp = max(MIN_DIM, 1 << (m - 1).bit_length())
    np_ = max(MIN_DIM, 1 << (n + mp - m - 1).bit_length())
    return mp, np_


def fits(m: int, n: int) -> bool:
    """True when an (m, n) LP is inside the kernel's envelope."""
    mp, np_ = padded_dims(m, n)
    return mp <= MAX_ROWS and mp * np_ <= MAX_CELLS


def _simplex_kernel(
    A_ref, b_ref, c_ref, lo_ref, hi_ref,
    basis_out, vstat_out, info_out,
    *, m: int, n: int, slack0: int, max_iter: int, refactor_period: int,
    feas_tol: float, opt_tol: float, pivot_tol: float, bland_after: int,
):
    """One LP per program.  A (m, n); b (m,); c/lo/hi (n,).  The identity
    slack block occupies columns [slack0, slack0 + m) and is the initial
    basis.  Writes basis (m,), vstat (n,) and info (2,) = (status, niter)."""
    A = A_ref[...]
    b = b_ref[...]
    c = c_ref[...]
    lo = lo_ref[...]
    hi = hi_ref[...]

    ZERO = F32(0.0)
    ONE = F32(1.0)
    NEG_INF = F32(-jnp.inf)
    col_ids = lax.broadcasted_iota(I32, (n,), 0)
    row_ids = lax.broadcasted_iota(I32, (m,), 0)
    eye_m = (lax.broadcasted_iota(I32, (m, m), 0)
             == lax.broadcasted_iota(I32, (m, m), 1)).astype(F32)

    def sel(vec, ids, k):
        """vec[k] without dynamic indexing: masked sum."""
        return jnp.sum(jnp.where(ids == k, vec, jnp.zeros_like(vec)))

    def matvec(M, v):      # M @ v
        return jnp.sum(M * v[None, :], axis=1)

    def vecmat(v, M):      # v @ M
        return jnp.sum(v[:, None] * M, axis=0)

    def nonbasic_x(vstat):
        x = jnp.where(vstat == VarStat.AT_LOWER, lo, ZERO)
        x = jnp.where(vstat == VarStat.AT_UPPER, hi, x)
        return jnp.where(vstat == VarStat.FIXED, lo, x)

    def recompute(Binv, vstat, cB):
        """f32 basic values and reduced costs from B⁻¹ and the statuses."""
        xB = matvec(Binv, b - matvec(A, nonbasic_x(vstat)))
        d = c - vecmat(vecmat(cB, Binv), A)
        return xB, jnp.where(vstat == VarStat.BASIC, ZERO, d)

    # ---- cold start: slack basis, B⁻¹ = I ----------------------------------
    # initial statuses (canonical.initial_vstat): fixed ⇒ FIXED, finite lower
    # ⇒ AT_LOWER, else finite upper ⇒ AT_UPPER, else FREE; slacks BASIC
    is_slack = (col_ids >= slack0) & (col_ids < slack0 + m)
    vstat = jnp.where(
        jnp.isfinite(lo), I32(VarStat.AT_LOWER),
        jnp.where(jnp.isfinite(hi), I32(VarStat.AT_UPPER), I32(VarStat.FREE)),
    )
    vstat = jnp.where(lo == hi, I32(VarStat.FIXED), vstat)
    vstat = jnp.where(is_slack, I32(VarStat.BASIC), vstat)
    basis = row_ids + slack0
    # gathered basic bounds/costs (masked selects: a one-hot product would
    # turn unselected ±inf bounds into 0·inf = NaN)
    sel_b = col_ids[None, :] == basis[:, None]                  # (m, n)
    gather = lambda v: jnp.sum(
        jnp.where(sel_b, v[None, :], jnp.zeros((m, n), F32)), axis=1)
    loB, hiB, cB = gather(lo), gather(hi), gather(c)
    Binv = eye_m
    xB, d = recompute(Binv, vstat, cB)

    # `fresh` = 1 ⇔ (B⁻¹, xB, d) were recomputed since the last pivot:
    # terminal claims (OPTIMAL/INFEASIBLE/UNBOUNDED) are believed only from a
    # fresh state — otherwise a refresh is forced and pricing re-runs.  This
    # is what makes the f32 kernel's final bases pass f64 certification.
    def refresh(Binv, basis, vstat, cB):
        onehots = (col_ids[None, :] == basis[:, None]).astype(F32)  # (m, n)
        Bmat = pl.dot(A, onehots, trans_b=True, precision=HIGHEST)  # (m, m)
        X = Binv
        for _ in range(2):  # Newton–Schulz: X ← X + X(I − B·X)
            R = eye_m - pl.dot(Bmat, X, precision=HIGHEST)
            X = X + pl.dot(X, R, precision=HIGHEST)
        xB, d = recompute(X, vstat, cB)
        return X, xB, d

    def cond(carry):
        status, niter = carry[0], carry[1]
        return (status == Status.RUNNING) & (niter < max_iter)

    def body(carry):
        (status, niter, phase, noimp, best, fresh, force,
         Binv, xB, d, loB, hiB, cB, wts, basis, vstat) = carry

        # ---- refresh decision (phase transition, periodic, or exit check) ---
        bad = (xB < loB - feas_tol) | (xB > hiB + feas_tol)
        feasible = jnp.sum(bad.astype(I32)) == 0
        transition = (phase == 1) & feasible
        phase = jnp.where(transition, I32(2), phase)
        do_refresh = (
            transition | (force == 1)
            | ((niter > 0) & (niter % refactor_period == 0))
        )
        Binv, xB, d = lax.cond(
            do_refresh,
            lambda: refresh(Binv, basis, vstat, cB),
            lambda: (Binv, xB, d),
        )

        below = xB < loB - feas_tol
        above = xB > hiB + feas_tol
        sigma = jnp.where(below, -ONE, jnp.where(above, ONE, ZERO))
        infeas = jnp.sum(jnp.maximum(loB - xB, ZERO)
                         + jnp.maximum(xB - hiB, ZERO))
        p1 = phase == 1

        # phase-1 composite reduced costs (branchless select)
        d1 = -vecmat(vecmat(sigma, Binv), A)
        d1 = jnp.where(vstat == VarStat.BASIC, ZERO, d1)
        dcur = jnp.where(p1, d1, d)

        # ---- pricing (Devex in phase 2, Dantzig in phase 1; Bland by stall) -
        bland = noimp >= bland_after
        can_up = (vstat == VarStat.AT_LOWER) | (vstat == VarStat.FREE)
        can_dn = (vstat == VarStat.AT_UPPER) | (vstat == VarStat.FREE)
        elig = (can_up & (dcur < -opt_tol)) | (can_dn & (dcur > opt_tol))
        gam = jnp.where(p1, jnp.ones_like(wts), wts)
        score = jnp.where(elig, dcur * dcur / jnp.maximum(gam, F32(1e-3)),
                          NEG_INF)
        q_d = lax.argmax(score, 0, I32)
        q_b = jnp.min(jnp.where(elig, col_ids, I32(n)))
        q = jnp.where(bland, q_b, q_d)
        found = jnp.sum(elig.astype(I32)) > 0
        dq = sel(dcur, col_ids, q)
        s = jnp.where(dq < ZERO, ONE, -ONE)

        # ---- FTRAN: w = B⁻¹ A[:, q] (one-hot column read) -------------------
        Acol = jnp.sum(jnp.where(col_ids[None, :] == q, A,
                                 jnp.zeros_like(A)), axis=1)       # (m,)
        w = matvec(Binv, Acol)

        # ---- ratio test (unified phase rule) -------------------------------
        delta = -s * w
        up = delta > pivot_tol
        dn = delta < -pivot_tol
        tgt = jnp.where(up, jnp.where(below, loB, hiB),
                        jnp.where(dn, jnp.where(above, hiB, loB), ZERO))
        blockable = ((up & ~above) | (dn & ~below)) & jnp.isfinite(tgt)
        ratio = jnp.where(
            blockable, (tgt - xB) / jnp.where(up | dn, delta, ONE),
            F32(jnp.inf),
        )
        ratio = jnp.maximum(ratio, ZERO)
        t_rows = jnp.min(ratio)
        tie = ratio <= t_rows * F32(1.0001) + F32(1e-6)
        r = lax.argmax(jnp.where(tie, jnp.abs(w), NEG_INF), 0, I32)
        lo_q = sel(lo, col_ids, q)
        hi_q = sel(hi, col_ids, q)
        rng_q = hi_q - lo_q
        flip = rng_q <= t_rows
        unbounded = ~jnp.isfinite(jnp.minimum(t_rows, rng_q))
        t = jnp.where(flip, rng_q, sel(ratio, row_ids, r))

        do_pivot = found & ~flip & ~unbounded
        do_flip = found & flip & ~unbounded

        # ---- entering/leaving bookkeeping ------------------------------------
        vq = sel(vstat, col_ids, q)
        enter_base = jnp.where(
            (vq == VarStat.AT_LOWER) | (vq == VarStat.FIXED), lo_q,
            jnp.where(vq == VarStat.AT_UPPER, hi_q, ZERO),
        )
        lv = sel(basis, row_ids, r)
        loB_r = sel(loB, row_ids, r)
        hiB_r = sel(hiB, row_ids, r)
        tgt_r = sel(tgt, row_ids, r)
        lstat = jnp.where(
            loB_r == hiB_r, I32(VarStat.FIXED),
            jnp.where(tgt_r == hiB_r, I32(VarStat.AT_UPPER),
                      I32(VarStat.AT_LOWER)),
        )

        # bound flip
        xB_flip = xB + t * delta
        vstat_flip = jnp.where(
            col_ids == q,
            jnp.where(vstat == VarStat.AT_LOWER, I32(VarStat.AT_UPPER),
                      I32(VarStat.AT_LOWER)),
            vstat,
        )

        # pivot: PFI rank-1 update of B⁻¹ + one-hot updates of gathered state
        is_r = row_ids == r
        wr = sel(w, row_ids, r)
        pr = jnp.sum(jnp.where(is_r[:, None], Binv, jnp.zeros_like(Binv)),
                     axis=0) / wr                                  # row r / wr
        onehot_r = is_r.astype(F32)
        Binv_piv = Binv - (w - onehot_r)[:, None] * pr[None, :]
        xB_piv = jnp.where(is_r, enter_base + s * t, xB + t * delta)
        basis_piv = jnp.where(is_r, q, basis)
        vstat_piv = jnp.where(col_ids == lv, lstat, vstat)
        vstat_piv = jnp.where(col_ids == q, I32(VarStat.BASIC), vstat_piv)
        loB_piv = jnp.where(is_r, lo_q, loB)
        hiB_piv = jnp.where(is_r, hi_q, hiB)
        cB_piv = jnp.where(is_r, sel(c, col_ids, q), cB)
        # phase-2 incremental reduced costs (pivot row α = B⁻¹[r]·A)
        alpha = vecmat(pr, A) * wr
        rd = dq / wr
        d_piv = d - rd * alpha
        d_piv = jnp.where(col_ids == q, ZERO, d_piv)
        d_piv = jnp.where(col_ids == lv, -rd, d_piv)
        d_piv = jnp.where(vstat_piv == VarStat.BASIC, ZERO, d_piv)

        # Devex reference-weight update (reuses the pivot row)
        gq = jnp.maximum(sel(wts, col_ids, q), ONE)
        tcol = alpha / wr
        w_cand = jnp.maximum(wts, (tcol * tcol) * gq)
        w_cand = jnp.where(col_ids == lv, jnp.maximum(gq / (wr * wr), ONE),
                           w_cand)
        w_cand = jnp.where(col_ids == q, ONE, w_cand)
        w_cand = jnp.where(gq > F32(1e6), jnp.ones_like(w_cand), w_cand)

        # ---- select ---------------------------------------------------------
        wts = jnp.where(do_pivot & ~p1, w_cand, wts)
        Binv = jnp.where(do_pivot, Binv_piv, Binv)
        xB = jnp.where(do_pivot, xB_piv, jnp.where(do_flip, xB_flip, xB))
        basis = jnp.where(do_pivot, basis_piv, basis)
        vstat = jnp.where(do_pivot, vstat_piv,
                          jnp.where(do_flip, vstat_flip, vstat))
        loB = jnp.where(do_pivot, loB_piv, loB)
        hiB = jnp.where(do_pivot, hiB_piv, hiB)
        cB = jnp.where(do_pivot, cB_piv, cB)
        d = jnp.where(do_pivot & ~p1, d_piv, d)

        # ---- status transitions (terminal only from a fresh state) ---------
        fresh_now = jnp.where(do_refresh, I32(1), fresh)
        wants_exit = (~found) | unbounded
        believe = fresh_now == 1
        status = jnp.where(
            found,
            jnp.where(
                unbounded & believe,
                jnp.where(p1, I32(Status.NUMERICAL), I32(Status.UNBOUNDED)),
                status,
            ),
            jnp.where(
                believe,
                jnp.where(p1, I32(Status.INFEASIBLE), I32(Status.OPTIMAL)),
                status,
            ),
        )
        force = jnp.where(wants_exit & ~believe & (status == Status.RUNNING),
                          I32(1), I32(0))
        applied = found & ~unbounded
        fresh = jnp.where(applied, I32(0), fresh_now)
        niter = niter + applied.astype(I32)

        # ---- phase-1 stall counter -----------------------------------------
        improved = infeas < best - F32(1e-6)
        noimp = jnp.where(p1, jnp.where(improved, I32(0), noimp + 1), I32(0))
        best = jnp.where(p1, jnp.minimum(best, infeas), best)

        return (status, niter, phase, noimp, best, fresh, force,
                Binv, xB, d, loB, hiB, cB, wts, basis, vstat)

    init = (
        I32(Status.RUNNING), I32(0), I32(1), I32(0), F32(jnp.inf), I32(1),
        I32(0), Binv, xB, d, loB, hiB, cB, jnp.ones((n,), F32), basis, vstat,
    )
    out = lax.while_loop(cond, body, init)
    status, niter = out[0], out[1]
    status = jnp.where(status == Status.RUNNING, I32(Status.MAX_ITER), status)
    basis_out[...] = out[14]
    vstat_out[...] = out[15]
    info_out[...] = jnp.where(lax.broadcasted_iota(I32, (2,), 0) == 0,
                              status, niter)


@functools.partial(
    jax.jit,
    static_argnames=(
        "slack0", "max_iter", "refactor_period", "feas_tol", "opt_tol",
        "pivot_tol", "bland_after", "interpret",
    ),
)
def simplex_kernel_call(
    A32, b32, c32, lo32, hi32, *,
    slack0, max_iter, refactor_period=32, feas_tol=1e-5, opt_tol=1e-6,
    pivot_tol=1e-6, bland_after=200, interpret=False,
):
    """The raw kernel launch on power-of-two shapes: A (B, m, n) f32,
    b (B, m), c/lo/hi (B, n).  Returns device arrays basis (B, m) i32,
    vstat (B, n) i32, info (B, 2) i32 = (status, niter).  Call it with x64
    off (`jax.enable_x64(False)`), so every literal stays 32-bit."""
    B, m, n = A32.shape
    kern = functools.partial(
        _simplex_kernel, m=m, n=n, slack0=slack0, max_iter=max_iter,
        refactor_period=refactor_period, feas_tol=feas_tol, opt_tol=opt_tol,
        pivot_tol=pivot_tol, bland_after=bland_after,
    )
    row = lambda k: pl.BlockSpec((None, k), lambda i: (i, 0))
    return pl.pallas_call(
        kern,
        grid=(B,),
        in_specs=[
            pl.BlockSpec((None, m, n), lambda i: (i, 0, 0)),
            row(m), row(n), row(n), row(n),
        ],
        out_specs=[row(m), row(n), row(2)],
        out_shape=[
            jax.ShapeDtypeStruct((B, m), I32),
            jax.ShapeDtypeStruct((B, n), I32),
            jax.ShapeDtypeStruct((B, 2), I32),
        ],
        compiler_params=plgpu_triton.CompilerParams(
            num_warps=4 if m * n <= 4096 else 8, num_stages=1,
        ),
        interpret=interpret,
        name="batched_simplex",
    )(A32, b32, c32, lo32, hi32)


def pad_batch(A, b, c, lo, hi, slack0: int):
    """Pad a host batch to the kernel's power-of-two shape (inert padding).

    Column layout out: [structural | m real slacks | mp − m padding-row
    slacks | the input's remaining columns | padding columns], so the
    identity slack block stays contiguous at [slack0, slack0 + mp).  Padding
    rows are zero rows with b = 0 whose slack is fixed [0, 0] (basic at 0,
    never leaves); padding columns are fixed [0, 0] (never enter)."""
    Bn, m, n = A.shape
    mp, np_ = padded_dims(m, n)
    s1 = slack0 + m                      # first column after the real slacks
    extra = mp - m
    out_A = np.zeros((Bn, mp, np_), np.float32)
    out_A[:, :m, :s1] = A[:, :, :s1]
    out_A[:, :m, s1 + extra:n + extra] = A[:, :, s1:]
    out_A[:, np.arange(m, mp), s1 + np.arange(extra)] = 1.0
    out_b = np.zeros((Bn, mp), np.float32)
    out_b[:, :m] = b

    def vec(v):
        o = np.zeros((Bn, np_), np.float32)
        o[:, :s1] = v[:, :s1]
        o[:, s1 + extra:n + extra] = v[:, s1:]
        return o

    return out_A, out_b, vec(c), vec(lo), vec(hi)


def unpad_result(basis, vstat, m: int, n: int, slack0: int):
    """Map padded (basis, vstat) back to the caller's (m, n) layout.  The
    padding-row slacks never leave the basis, so real rows hold real
    columns only."""
    mp = basis.shape[1]
    s1, extra = slack0 + m, mp - m
    basis = basis[:, :m]
    basis = np.where(basis >= s1 + extra, basis - extra, basis)
    keep = np.r_[0:s1, s1 + extra:n + extra]
    return basis, vstat[:, keep]

