"""Basis maintenance: inverse representation, product-form update, refactorization.

Reference counterpart: `BasisSolver` + `src/lu.rs` (C3/C4 in SURVEY.md §3.1):
sparse LU with Markowitz/threshold pivoting, Gilbert–Peierls solves, product-form
eta file, COLAMD-style ordering (C5).  The device engine trades all of that for
dense, fixed-shape linear algebra that one compiled loop can carry:

* The basis is **dense** in HBM (an m×m matrix is at most a few hundred MB for the
  largest Netlib instances — SURVEY.md §8 "Hard parts" #4), so fill-reducing
  ordering (C5) is unnecessary by design and intentionally has no equivalent here.
* FTRAN/BTRAN become dense mat-vecs against a maintained explicit inverse.  A
  product-form (PFI) pivot update of the *inverse* is a rank-1 outer-product —
  dense O(m²) work with perfect vectorization — rather than an eta-file
  sweep of sequential O(m) steps.  BTRAN of a unit vector (the pivot-row solve,
  `calc_row_coeffs` [CODE]) is then *free*: it is a row read of `Binv`.
* Refactorization refreshes the maintained inverse in graph with Newton–Schulz
  sweeps (X ← X + X(I − BX)) — quadratically convergent and matmul-only; a
  divergence exits with NUMERICAL and the host rebuilds the inverse exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..status import VarStat


def nonbasic_values(vstat: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Per-variable value implied by non-basic status; BASIC/FREE entries → 0.

    Mirrors the reference's convention that non-basic variables rest at a bound
    (SURVEY.md §3.2); FIXED uses the (equal) lower bound.
    """
    x = jnp.where(vstat == VarStat.AT_LOWER, lo, 0.0)
    x = jnp.where(vstat == VarStat.AT_UPPER, hi, x)
    x = jnp.where(vstat == VarStat.FIXED, lo, x)
    return x


def basis_matrix(A: jnp.ndarray, basis: jnp.ndarray) -> jnp.ndarray:
    """Gather the basic columns: B = A[:, basis] (shape (M, M))."""
    return jnp.take(A, basis, axis=1)


def newton_refresh(B: jnp.ndarray, X: jnp.ndarray, iters: int):
    """Newton–Schulz refinement X ← X + X(I − BX) of an approximate inverse.

    Matmul-only, quadratically convergent while ‖I − BX‖ < 1.  The
    PFI-maintained inverse accumulates only roundoff between refactorizations,
    so it is deep inside the basin; this replaces an in-graph LU with a few
    fused matrix products.

    Returns (X_refined, resid) with resid = max|I − BX| *before* the last
    correction — a divergence telltale for the caller.
    """
    eye = jnp.eye(B.shape[0], dtype=B.dtype)
    R = eye - B @ X
    resid = jnp.max(jnp.abs(R))
    for _ in range(max(iters, 1)):
        X = X + X @ R
        R = eye - B @ X
    return X, jnp.minimum(resid, jnp.max(jnp.abs(R)))


@partial(jax.jit, static_argnames=("newton_iters",))
def refactorize(
    A: jnp.ndarray,
    b: jnp.ndarray,
    c: jnp.ndarray,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    basis: jnp.ndarray,
    vstat: jnp.ndarray,
    seed_Binv: jnp.ndarray,
    newton_iters: int = 3,
):
    """Rebuild (Binv, xB, d, obj, ok) from (basis, vstat) and an inverse seed.

    Equivalent of `BasisSolver::reset` (SURVEY.md §4.4) minus the ordering
    stage: refreshes the basis inverse (Newton–Schulz from `seed_Binv` — the
    maintained inverse, or the exact identity for a cold slack basis), then
    recomputes basic values, reduced costs and the objective exactly.

    `ok=False` signals the seed was outside Newton's basin (‖I − B·seed‖ ≥ 1);
    the engine then exits with Status.NUMERICAL and the host driver rebuilds
    the inverse exactly (numpy f64 LU) and resumes — keeping the rare hard
    case off the compiled hot path.
    """
    B = basis_matrix(A, basis)
    Binv, resid = newton_refresh(B, seed_Binv, newton_iters)
    ok = resid < 0.5
    xN = nonbasic_values(vstat, lo, hi)
    rhs_eff = b - A @ xN
    xB = Binv @ rhs_eff
    y = c[basis] @ Binv
    d = c - y @ A
    d = jnp.where(vstat == VarStat.BASIC, 0.0, d)
    obj = c[basis] @ xB + c @ xN
    return Binv, xB, d, obj, ok


def ftran(Binv: jnp.ndarray, col: jnp.ndarray) -> jnp.ndarray:
    """FTRAN: solve B·w = col — the entering-column transform
    (`calc_col_coeffs` [CODE]).  With an explicit inverse this is one mat-vec."""
    return Binv @ col


def btran_unit(Binv: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """BTRAN of a unit vector: solve Bᵀ·ρ = e_r (`calc_row_coeffs` [CODE]).
    With an explicit inverse this is a row read."""
    return Binv[r]


def pfi_update(Binv: jnp.ndarray, w: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Product-form pivot update of the inverse.

    Given the FTRAN'd entering column w = B⁻¹ A_q and the leaving row r, the new
    inverse is E·Binv with E the eta matrix of (w, r).  Applied densely:
    row r is scaled by 1/w_r and every other row i subtracts w_i times it —
    a rank-1 outer product (reference: eta-file append, `push_eta_matrix` [CODE];
    SURVEY.md §3.2 "product-form eta updates" [BASELINE]).
    """
    pr = Binv[r] / w[r]
    Binv = Binv - jnp.outer(w, pr)
    return Binv.at[r].set(pr)
