"""Solver options — the single frozen configuration object.

The reference has *no* runtime configuration: all numerics are hardcoded consts
(feasibility/pricing epsilon ~1e-8, LU stability coefficient ~0.1, refactorization
threshold) per SURVEY.md §6.6 (`src/solver.rs`, `src/lu.rs` consts [CODE]).  We keep
that spirit: one frozen dataclass whose defaults mirror the reference's constants,
no global flag system.  The dataclass is hashable so it can be a static argument to
`jax.jit`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Numeric and engine options for the LP solver.

    Defaults follow the reference's hardcoded constants where known
    (SURVEY.md §6.6: pricing/feasibility epsilon ~1e-8) and standard
    revised-simplex practice elsewhere.
    """

    # --- tolerances -----------------------------------------------------------
    #: Primal feasibility tolerance: a basic value within this of its bound is
    #: considered feasible (reference: ~1e-8, src/solver.rs consts [CODE]).
    feas_tol: float = 1e-8
    #: Dual feasibility / optimality tolerance on reduced costs.
    opt_tol: float = 1e-8
    #: Minimum acceptable pivot magnitude in the ratio test / basis update.
    pivot_tol: float = 1e-8
    #: Relative window for the ratio-test tie set (stability tie-break picks the
    #: largest |pivot| among ratios within this window of the minimum).
    ratio_tie_rel: float = 1e-7
    #: Absolute slack added to the ratio tie window.
    ratio_tie_abs: float = 1e-9

    # --- iteration control ----------------------------------------------------
    #: Hard cap on simplex iterations per phase; None → 32 * (m + n) + 1000.
    max_iter: Optional[int] = None
    #: Refactorize (rebuild the basis inverse from scratch) every this many pivots.
    #: The reference refactorizes on eta-file blowup (SURVEY.md §3.2 [BASELINE]);
    #: a fixed period is the fixed-shape XLA-friendly equivalent.  None = auto
    #: (64; 128 at M ≥ 1024 where the host SuperLU refactorization dominates).
    #: An explicit value — including 64 — is always respected verbatim, so a
    #: user fighting an ill-conditioned instance can tighten the eta-file
    #: window (ADVICE r4: the old sentinel-by-default-comparison made an
    #: explicit 64 indistinguishable from unset).
    refactor_period: Optional[int] = None
    #: Switch to Bland's anti-cycling rule after this many iterations without
    #: objective (or phase-1 infeasibility) improvement.
    bland_after: int = 50

    # --- numerics -------------------------------------------------------------
    #: Working dtype: "float64" (default) or "float32".
    dtype: str = "float64"
    #: Newton–Schulz sweeps of the in-graph basis-inverse refresh
    #: (engine/basis.py `refactorize`).
    newton_refine_iters: int = 3
    #: Engine: "simplex" (revised primal/dual simplex) or "pdhg" (first-order).
    engine: str = "simplex"
    #: Host-side presolve before canonicalization (singleton/empty/redundant row
    #: elimination + bound tightening; build-only — the reference has none).
    presolve: bool = True
    #: f32-iterate + exact-f64-certify first pass for cold float64 solves:
    #: "always" first runs the XLA engine in float32 (loosened tolerances)
    #: and adopts the answer only after exact f64 host certification of the
    #: discovered basis; "auto" and "never" go straight to the f64 engine.
    #: ("auto" turns it on nowhere until a GPU measurement shows f32 pays.)
    f32_midsize: str = "auto"
    #: Phase-2 pricing rule: "devex" (approximate steepest-edge reference
    #: weights, the reference's "Dantzig + steepest-edge" scheme — fresh
    #: weights make early iterations Dantzig-like) or "dantzig".
    pricing: str = "devex"
    #: Reset Devex weights to 1 when the entering weight exceeds this.
    devex_reset: float = 1e8

    # --- shape padding (XLA static-shape friendliness) ------------------------
    #: Round padded row count up to a multiple of this.  The extra rows are
    #: inert capacity that `add_constraint` fills without a recompile.
    row_align: int = 8
    #: Round padded column count up to a multiple of this, so each row of
    #: the dense A starts 512-byte aligned and is read in coalesced segments.
    col_align: int = 128
    #: Extra row capacity for incremental `add_constraint` without recompiling.
    row_capacity_slack: int = 0

    # --- PDHG engine ----------------------------------------------------------
    pdhg_max_iter: int = 200_000
    pdhg_check_every: int = 64
    pdhg_restart_beta: float = 0.9
    #: Initial primal weight ω (τ = ω/‖A‖, σ = 1/(ω‖A‖)); None → ‖c‖/‖b‖.
    pdhg_omega: Optional[float] = None
    #: Geometric smoothing exponent for the adaptive primal-weight update at
    #: restarts (PDLP's θ; 0 disables adaptation).
    pdhg_weight_theta: float = 0.5
    #: Ruiz row/column equilibration sweeps applied before iterating.
    pdhg_ruiz_iters: int = 10
    #: Tolerance for the Farkas/recession-ray infeasibility certificates
    #: (cone residuals; the certificate margin must clear 100× this).
    pdhg_infeas_tol: float = 1e-9
    #: Constraint-matrix storage for the PDHG path: "auto" picks sparse BCOO
    #: matvecs when the instance is large and sparse, "dense"/"sparse" force.
    pdhg_matrix: str = "auto"
    #: Iteration scheme: "vanilla" (the PDLP restarted-average scheme —
    #: the default: robust ω adaptation across scalings) or "halpern"
    #: (reflected PDHG + Halpern anchoring, the cuPDLP-class accelerated
    #: variant with fixed-point-residual restarts; measured up to ~1.6×
    #: fewer iterations on well-conditioned instances, but it runs with a
    #: FROZEN primal weight — PDLP's displacement-ratio ω heuristics
    #: measurably diverge under anchored dynamics — so badly-scaled
    #: instances can stall where vanilla adapts through).
    pdhg_variant: str = "vanilla"

    # --- PDHG → simplex crossover (large cold solves) -------------------------
    #: "auto": cold f64 simplex solves above 2048 padded rows start
    #: from a PDHG-identified basis instead of the slack basis (replaces
    #: ~10⁵ cold pivots with a few hundred warm exact ones at maros scale);
    #: "never" disables.
    crossover: str = "auto"
    #: KKT tolerance the PDHG stage runs to before basis identification —
    #: the basis is combinatorial; moderate accuracy identifies it and the
    #: exact polish absorbs the residual.  Counted at the maros shape:
    #: 1e-4 → 42k PDHG iterations + 710 exact pivots; 1e-5 → 96k + 61 — the
    #: polish absorbs looser identification far cheaper than the PDHG tail.
    crossover_tol: float = 1e-4

    def effective_max_iter(self, m: int, n: int) -> int:
        if self.max_iter is not None:
            return int(self.max_iter)
        return 32 * (m + n) + 1000

    def effective_refactor_period(self, m: int = 0) -> int:
        """Resolved refactorization period (None → size-scaled auto default)."""
        if self.refactor_period is not None:
            return max(int(self.refactor_period), 1)
        # SuperLU refactorization dominates at scale (measured ~115 ms at
        # m=1600 on a filled basis vs ~0.5 ms per eta-file solve): amortize
        # over a longer eta file — 128 f64 etas are numerically benign (the
        # reference's eta-file threshold is of the same order).
        return 128 if m >= 1024 else 64


def f32_iterate_options(opts: SolverOptions) -> SolverOptions:
    """f32 working copy of `opts` with tolerances loosened to what single
    precision can resolve (exact f64 certification restores full accuracy;
    these only steer the iterate)."""
    return dataclasses.replace(
        opts,
        dtype="float32",
        feas_tol=max(opts.feas_tol, 1e-5),
        opt_tol=max(opts.opt_tol, 1e-6),
        pivot_tol=max(opts.pivot_tol, 1e-6),
    )


DEFAULT_OPTIONS = SolverOptions()
