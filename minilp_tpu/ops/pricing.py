"""Pricing: choose the entering variable.

Reference analog: `choose_entering_col` (`src/solver.rs` [CODE]; SURVEY.md §3.2
"Pricing": full pricing over all non-basic columns, Dantzig + steepest-edge).
This module implements full vectorized pricing as masked argmax reductions —
the shape XLA lowers to fused vector scans, vmap batches over, and
`shard_map` partitions across devices with a single argmax reduction
(SURVEY.md §3.3 "column-partitioned pricing").

Determinism: all argmax/argmin reductions break ties toward the *lowest index*
(`jnp.argmax` picks the first maximum), which is the contract the multi-device
pricing reduction must preserve (SURVEY.md §5 (e)).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from ..status import VarStat


class EnteringChoice(NamedTuple):
    q: jnp.ndarray         # () int32 — entering column (undefined if not found)
    direction: jnp.ndarray  # () f — +1 if entering increases, -1 if it decreases
    found: jnp.ndarray     # () bool — any eligible column exists


def eligibility(d: jnp.ndarray, vstat: jnp.ndarray, opt_tol: float):
    """Masks of columns eligible to enter moving up / down.

    A non-basic variable may increase from its lower bound (or from 0 if free)
    when its reduced cost is < -tol, and decrease from its upper bound (or free)
    when > +tol.  BASIC and FIXED variables are never eligible — this is what
    keeps padding columns inert.
    """
    can_incr = (vstat == VarStat.AT_LOWER) | (vstat == VarStat.FREE)
    can_decr = (vstat == VarStat.AT_UPPER) | (vstat == VarStat.FREE)
    elig_up = can_incr & (d < -opt_tol)
    elig_dn = can_decr & (d > opt_tol)
    return elig_up, elig_dn


def choose_entering(
    d: jnp.ndarray,
    vstat: jnp.ndarray,
    opt_tol: float,
    bland: jnp.ndarray,
    weights: Optional[jnp.ndarray] = None,
) -> EnteringChoice:
    """Pick the entering column from reduced costs `d`.

    * Default rule: largest |d_j| (Dantzig) or largest d_j²/γ_j when steepest-edge
      /Devex `weights` γ are provided (SURVEY.md §3.2 "Pricing").
    * `bland` (traced bool): lowest eligible index — anti-cycling fallback.
    """
    n = d.shape[0]
    elig_up, elig_dn = eligibility(d, vstat, opt_tol)
    elig = elig_up | elig_dn

    score = d * d
    if weights is not None:
        score = score / jnp.maximum(weights, 1e-12)
    neg_inf = jnp.array(-jnp.inf, dtype=d.dtype)
    q_dantzig = jnp.argmax(jnp.where(elig, score, neg_inf)).astype(jnp.int32)

    idx = jnp.arange(n, dtype=jnp.int32)
    q_bland = jnp.argmin(jnp.where(elig, idx, n)).astype(jnp.int32)

    q = jnp.where(bland, q_bland, q_dantzig)
    direction = jnp.where(d[q] < 0, 1.0, -1.0).astype(d.dtype)
    return EnteringChoice(q=q, direction=direction, found=jnp.any(elig))


def phase1_sigma(
    xB: jnp.ndarray, loB: jnp.ndarray, hiB: jnp.ndarray, feas_tol: float
):
    """Phase-1 infeasibility costs σ per basic row and the total infeasibility.

    σ_i = −1 if x_i < l_i (infeasibility falls as x_i rises), +1 if x_i > u_i,
    else 0 (SURVEY.md §3.2 "Canonicalization"/Phase 1; `find_initial_bfs` [CODE]).
    """
    below = xB < loB - feas_tol
    above = xB > hiB + feas_tol
    sigma = jnp.where(below, -1.0, jnp.where(above, 1.0, 0.0)).astype(xB.dtype)
    # lo=-inf / hi=+inf give -inf in the difference; max(·, 0) absorbs them, so
    # no isfinite mask is needed.
    viol = jnp.maximum(loB - xB, 0.0) + jnp.maximum(xB - hiB, 0.0)
    infeas = jnp.sum(viol)
    return sigma, infeas


def phase1_reduced_costs(
    A: jnp.ndarray, Binv: jnp.ndarray, sigma: jnp.ndarray, vstat: jnp.ndarray
) -> jnp.ndarray:
    """Phase-1 reduced costs d¹ = −(σᵀB⁻¹)A, zeroed on basic columns.

    The phase-1 objective (total infeasibility) has per-iteration costs σ on the
    *basic* variables only, so d¹ must be recomputed each iteration — one
    vec-mat against Binv plus one against A (both dense).
    """
    y = sigma @ Binv
    d1 = -(y @ A)
    return jnp.where(vstat == VarStat.BASIC, 0.0, d1)
