"""Options surface: dtype modes, engine selection, pricing rules, max_iter."""

import numpy as np
import pytest

from minilp_tpu import ComparisonOp, OptimizationDirection, Problem, SolverFailure
from minilp_tpu.options import SolverOptions

from .oracle import random_problem, solve_with_oracle


def _doc_problem(opts):
    prob = Problem(OptimizationDirection.Maximize, options=opts)
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    return prob


def test_float32_mode():
    # f32 working precision: looser tolerances, same answer on small LPs.
    opts = SolverOptions(dtype="float32", feas_tol=1e-5, opt_tol=1e-5, pivot_tol=1e-6)
    sol = _doc_problem(opts).solve()
    assert abs(sol.objective() - 7.0) <= 1e-4

    rng = np.random.default_rng(11)
    prob = random_problem(rng, 10, 8)
    prob.options = opts
    outcome, obj, _ = solve_with_oracle(prob)
    if outcome == "optimal":
        sol = prob.solve()
        assert abs(sol.objective() - obj) <= 1e-3 * (1 + abs(obj))


def test_max_iter_failure():
    opts = SolverOptions(max_iter=1)
    rng = np.random.default_rng(3)
    prob = random_problem(rng, 12, 10)
    prob.options = opts
    outcome, _, _ = solve_with_oracle(prob)
    if outcome != "optimal":
        pytest.skip("needs an optimal instance")
    with pytest.raises(SolverFailure, match="MAX_ITER"):
        prob.solve()


def test_unknown_engine_rejected():
    prob = _doc_problem(SolverOptions(engine="quantum"))
    with pytest.raises(ValueError, match="unknown engine"):
        prob.solve()


def test_options_hashable_for_jit():
    assert hash(SolverOptions()) == hash(SolverOptions())
    assert SolverOptions() == SolverOptions()
    assert hash(SolverOptions(max_iter=7)) != hash(SolverOptions())


def test_f32_midsize_path():
    # f32_midsize="always": default-f64 options, but the cold solve runs the
    # XLA engine in f32 first and adopts only an exactly-certified basis.
    # Certified answers are exact, so the gate is tight.
    opts = SolverOptions(f32_midsize="always")
    rng = np.random.default_rng(31)
    f32_hits = 0
    for _ in range(6):
        prob = random_problem(rng, 14, 12)
        prob.options = opts
        outcome, obj, _ = solve_with_oracle(prob)
        if outcome != "optimal":
            continue
        sol = prob.solve()
        assert abs(sol.objective() - obj) <= 1e-7 * (1 + abs(obj))
        if sol._engine.certified:
            f32_hits += 1
    assert f32_hits >= 2

    # incremental API still works off the rebuilt exact f64 state
    prob = Problem(OptimizationDirection.Maximize, options=opts)
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    sol = prob.solve()
    assert abs(sol.objective() - 7.0) <= 1e-9
    sol2 = sol.fix_var(x, 0.5)
    assert abs(sol2.objective() - (0.5 + 2 * 3.0)) <= 1e-7


def test_f32_midsize_falls_back_on_nonoptimal():
    # An infeasible LP: the f32 first pass may claim INFEASIBLE but that claim
    # is never adopted — the exact f64 engine must deliver the final status.
    import minilp_tpu as mt

    opts = SolverOptions(f32_midsize="always")
    prob = Problem(OptimizationDirection.Minimize, options=opts)
    x = prob.add_var(1.0, (0.0, 1.0))
    prob.add_constraint(1.0 * x, ComparisonOp.Ge, 2.0)
    with pytest.raises(mt.Infeasible):
        prob.solve()


def test_float32_certified_mode():
    # f32 on-device iteration + host f64 certification → 1e-9-grade answers.
    opts = SolverOptions(dtype="float32", feas_tol=1e-5, opt_tol=1e-5, pivot_tol=1e-6)
    rng = np.random.default_rng(21)
    hits = 0
    for _ in range(6):
        prob = random_problem(rng, 12, 10)
        prob.options = opts
        outcome, obj, _ = solve_with_oracle(prob)
        if outcome != "optimal":
            continue
        sol = prob.solve()
        if sol._engine.certified:
            hits += 1
            # the certificate guarantees ε-optimality at the certification
            # tolerance (reduced costs within 1e-7 of feasible), i.e. 1e-6-grade
            # objectives — the north-star gate — not bit-exactness.
            assert abs(sol.objective() - obj) <= 1e-6 * (1 + abs(obj))
    assert hits >= 2  # certification should succeed on most instances
