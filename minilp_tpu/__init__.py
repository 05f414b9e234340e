"""minilp_tpu — a linear programming framework for NVIDIA GPUs on JAX.

A from-scratch rebuild of the capabilities of the `minilp` crate (ztlpn/minilp):
standard-form LPs with bounded variables, ≤/≥/= constraints, and an incremental
warm-started re-solve API (add constraints, fix/unfix variables, Gomory cuts) —
designed for the accelerator on JAX/XLA/Pallas rather than ported.
Blueprint: SURVEY.md.

Public surface mirrors the reference's `src/lib.rs` [API]::

    from minilp_tpu import Problem, OptimizationDirection, ComparisonOp

    prob = Problem(OptimizationDirection.Maximize)
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    sol = prob.solve()
    assert abs(sol.objective() - 7.0) < 1e-6
"""

import os

# LP solving to 1e-6 relative gap genuinely needs f64 working precision
# (SURVEY.md §8 "Hard parts" #1).  Enable x64 before any array is created; opt
# out with MINILP_TPU_NO_X64=1 (the engine then runs in f32 with its tolerances
# loosened by the caller).
if not os.environ.get("MINILP_TPU_NO_X64"):
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)

from .api import (  # noqa: E402
    ComparisonOp,
    Error,
    Infeasible,
    LinearExpr,
    OptimizationDirection,
    Problem,
    Solution,
    SolverFailure,
    Unbounded,
    Variable,
)
from .options import DEFAULT_OPTIONS, SolverOptions  # noqa: E402
from .status import Status, VarStat  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "ComparisonOp",
    "DEFAULT_OPTIONS",
    "Error",
    "Infeasible",
    "LinearExpr",
    "OptimizationDirection",
    "Problem",
    "Solution",
    "SolverFailure",
    "SolverOptions",
    "Status",
    "Unbounded",
    "VarStat",
    "Variable",
    "__version__",
]
