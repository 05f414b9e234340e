"""Randomized incremental stress gate: arbitrary interleavings of
add_constraint / fix_var / unfix_var cross-checked against the oracle after
every edit (SURVEY.md §5 #2's "incremental sequences", scaled up)."""

import copy

import numpy as np
import pytest

import minilp_tpu
from minilp_tpu.api import ComparisonOp, LinearExpr, Variable

from .oracle import random_problem, solve_with_oracle


@pytest.mark.parametrize("seed,trials,steps,f32_cold", [
    pytest.param(0, 12, 8, False, id="0"),
    pytest.param(1, 12, 8, False, id="1"),
    # cold solves through the f32-iterate + f64-certify route, so every
    # warm re-solve starts from a state rebuilt off a certified f32 basis
    pytest.param(7, 4, 5, True, id="7-f32-cold"),
])
def test_incremental_stress(seed, trials, steps, f32_cold):
    from minilp_tpu.options import SolverOptions

    options = SolverOptions(f32_midsize="always") if f32_cold else None
    _run_incremental_stress(seed, trials=trials, steps=steps, options=options)


def _run_incremental_stress(seed, trials, steps, options):
    rng = np.random.default_rng(seed)
    fails = []
    for trial in range(trials):
        prob = random_problem(rng, int(rng.integers(4, 14)), int(rng.integers(3, 12)))
        if options is not None:
            prob.options = options
        shadow = copy.deepcopy(prob)  # oracle-side model; prob stays frozen
        if solve_with_oracle(shadow)[0] != "optimal":
            continue
        sol = prob.solve()
        fixed = {}
        for step in range(steps):
            op = int(rng.integers(0, 3))
            # mutate the shadow FIRST so the oracle sees the attempted edit
            # whether or not our solver raises
            if op == 0:
                coeffs = rng.normal(size=prob.num_vars)
                x = np.array([v for _, v in sol.iter()])
                rhs = float(coeffs @ x + rng.normal() * 0.5)
                sense = [ComparisonOp.Le, ComparisonOp.Ge][int(rng.integers(0, 2))]
                expr = LinearExpr(
                    [(float(coeffs[j]), Variable(j)) for j in range(prob.num_vars)]
                )
                shadow.add_constraint(expr, sense, rhs)
                action = lambda: sol.add_constraint(expr, sense, rhs)
            elif op == 1:
                j = int(rng.integers(0, prob.num_vars))
                if j in fixed:
                    continue
                xj = sol.var_value(Variable(j))
                val = float(np.clip(xj + rng.normal() * 0.1,
                                    shadow._lo[j], shadow._hi[j]))
                fixed[j] = (shadow._lo[j], shadow._hi[j])
                shadow._lo[j] = shadow._hi[j] = val
                action = lambda: sol.fix_var(Variable(j), val)
            else:
                if not fixed:
                    continue
                j = next(iter(fixed))
                lo0, hi0 = fixed.pop(j)
                shadow._lo[j], shadow._hi[j] = lo0, hi0
                action = lambda: sol.unfix_var(Variable(j))[1]

            try:
                sol = action()
            except minilp_tpu.Infeasible:
                if solve_with_oracle(shadow)[0] != "infeasible":
                    fails.append((trial, step, op, "false infeasible"))
                break
            except minilp_tpu.SolverFailure as e:
                fails.append((trial, step, op, f"failure {e}"))
                break
            outcome, obj, _ = solve_with_oracle(shadow)
            if outcome == "optimal":
                gap = abs(sol.objective() - obj) / (1 + abs(obj))
                if gap > 1e-6:
                    fails.append((trial, step, op, f"gap {gap:.2e}"))
                    break
            elif outcome == "infeasible":
                fails.append((trial, step, op, "missed infeasible"))
                break
    assert not fails, fails
