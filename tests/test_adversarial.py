"""Adversarial synthetic gates (VERDICT r3 #5 / weak #4).

The plain Netlib-shaped generator plants boxed, interior-feasible,
non-degenerate instances — structurally kinder than real Netlib, so the
anti-cycling and drift machinery (Bland, Harris ties, phase regression)
is rarely exercised by the default suite.  These gates
solve instances from utils/synth.py's adversarial generators — planted
degeneracy (zero slackness, duplicate rows/columns, zero costs),
ill-conditioning (column scales 10^±6, near-parallel rows), and free/fixed
bound mixes — against the scipy-HiGHS oracle, on the host sparse engine
and the XLA driver path.

The reference's equivalent stress comes from the real Netlib degenerate
instances (degen2/degen3, maros-grade conditioning) in its vendored suite
(`tests/` + `*.mps.gz` [CODE]); until that data lands these are the stand-in.
"""

import numpy as np
import pytest

from minilp_tpu import api
from minilp_tpu.canonical import canonicalize
from minilp_tpu.engine import hostlp
from minilp_tpu.options import SolverOptions
from minilp_tpu.status import Status
from minilp_tpu.utils.synth import (
    degenerate_problem,
    ill_conditioned_problem,
    mixed_bounds_problem,
    network_flow_problem,
    staircase_problem,
)

from .oracle import solve_with_oracle


def _oracle(prob):
    """Oracle outcome, or skip when HiGHS itself fails on the instance (the
    ill-conditioned generator can exceed even the oracle's tolerance)."""
    try:
        return solve_with_oracle(prob)
    except RuntimeError as e:
        pytest.skip(f"oracle failed on this instance: {e}")


def _staircase(m, nv, _density, seed=0):
    """Adapter: 5-stage staircase at roughly (m, nv) total size."""
    return staircase_problem(5, max(m // 5, 2), max(nv // 5, 4), seed=seed)


def _network(m, nv, _density, seed=0):
    """Adapter: min-cost flow with m nodes / nv arcs (totally unimodular,
    massively degenerate — VERDICT r4 weak #7's missing structure class)."""
    return network_flow_problem(m, nv, seed=seed)


GENS = {
    "degenerate": degenerate_problem,
    "ill_conditioned": ill_conditioned_problem,
    "mixed_bounds": mixed_bounds_problem,
    "staircase": _staircase,
    "network_flow": _network,
}

_STATUS_NAME = {
    int(Status.OPTIMAL): "optimal",
    int(Status.INFEASIBLE): "infeasible",
    int(Status.UNBOUNDED): "unbounded",
}


def _solve_api(prob):
    """(outcome, objective) through the public driver path."""
    try:
        sol = prob.solve()
        return "optimal", sol.objective()
    except api.Infeasible:
        return "infeasible", None
    except api.Unbounded:
        return "unbounded", None


@pytest.mark.parametrize("gen", list(GENS))
@pytest.mark.parametrize("seed", range(4))
def test_adversarial_hostlp_matches_oracle(gen, seed):
    prob = GENS[gen](40, 90, 0.15, seed=seed)
    outcome, obj, _ = _oracle(prob)
    can = canonicalize(prob, dtype=np.float64)
    res = hostlp.solve_host_sparse(
        can.A, can.b, can.c, can.lo, can.hi, can.basis0, can.vstat0,
        opts=SolverOptions(),
    )
    assert res is not None
    assert _STATUS_NAME.get(res.status) == outcome
    if outcome == "optimal":
        got = can.obj_sign * res.obj
        assert abs(got - obj) <= 1e-7 * (1 + abs(obj))


@pytest.mark.parametrize("gen", list(GENS))
@pytest.mark.parametrize("seed", range(3))
def test_adversarial_driver_matches_oracle(gen, seed):
    """Full public path (canonicalize → presolve → engine routing) on the
    adversarial classes."""
    prob = GENS[gen](30, 70, 0.18, seed=10 + seed)
    outcome, obj, _ = _oracle(prob)
    got_outcome, got_obj = _solve_api(prob)
    assert got_outcome == outcome
    if outcome == "optimal":
        assert abs(got_obj - obj) <= 1e-7 * (1 + abs(obj))


@pytest.mark.parametrize("seed", range(3))
def test_degenerate_xla_f32_certified(seed):
    """The f32-iterate + f64-certify mid-size route survives planted
    degeneracy (ratio-test ties everywhere) and still adopts an exact
    vertex."""
    prob = degenerate_problem(48, 120, 0.12, seed=20 + seed)
    outcome, obj, _ = _oracle(prob)
    if outcome != "optimal":
        pytest.skip("instance not optimal")
    prob.options = SolverOptions(f32_midsize="always")
    sol = prob.solve()
    assert sol._engine.certified is True
    assert abs(sol.objective() - obj) <= 1e-9 * (1 + abs(obj))


@pytest.mark.parametrize("seed", range(2))
def test_ill_conditioned_exact_path(seed):
    """Column scales spanning 1e±6: the exact-f64 host engine must stay
    numerically sound (terminal status matches oracle; objective to 1e-6
    relative — the instance itself is genuinely harder to certify
    tightly)."""
    prob = ill_conditioned_problem(36, 80, 0.18, seed=30 + seed,
                                   scale_span=6.0)
    outcome, obj, _ = _oracle(prob)
    can = canonicalize(prob, dtype=np.float64)
    res = hostlp.solve_host_sparse(
        can.A, can.b, can.c, can.lo, can.hi, can.basis0, can.vstat0,
        opts=SolverOptions(),
    )
    assert res is not None
    assert _STATUS_NAME.get(res.status) == outcome
    if outcome == "optimal":
        got = can.obj_sign * res.obj
        assert abs(got - obj) <= 1e-6 * (1 + abs(obj))


def test_bland_path_fires_on_degenerate():
    """The Bland anti-cycling fallback must actually engage on planted
    degeneracy (VERDICT r3: 'assert the Bland path actually fires in at
    least one') — and the result must still match the oracle."""
    fired = 0
    for seed in range(6):
        # OVERDETERMINED (m > nv) with every rhs tight at the planted point:
        # more active rows than dimensions forces degenerate vertices and
        # zero-progress pivots — measured: the square-ish variant never
        # stalls (Devex+Harris make progress every pivot)
        prob = degenerate_problem(100, 40, 0.3, seed=seed,
                                  frac_eq=0.5, frac_zero_obj=0.5)
        outcome, obj, _ = _oracle(prob)
        can = canonicalize(prob, dtype=np.float64)
        # tiny patience forces the stall counter over the Bland threshold
        # as soon as degenerate (zero-step) pivots appear
        res = hostlp.solve_host_sparse(
            can.A, can.b, can.c, can.lo, can.hi, can.basis0, can.vstat0,
            opts=SolverOptions(bland_after=3),
        )
        assert res is not None
        assert _STATUS_NAME.get(res.status) == outcome
        if outcome == "optimal":
            got = can.obj_sign * res.obj
            assert abs(got - obj) <= 1e-7 * (1 + abs(obj))
        fired += res.bland_iters > 0
    assert fired > 0, "no instance engaged the Bland rule — generator too kind"


@pytest.mark.parametrize("seed", range(2))
def test_degenerate_device_engine(seed):
    """The dense f64 XLA engine (the device route of a cold solve) on a small
    planted-degenerate instance: certified, and equal to the oracle."""
    prob = degenerate_problem(24, 56, 0.25, seed=50 + seed)
    outcome, obj, _ = _oracle(prob)
    if outcome != "optimal":
        pytest.skip("instance not optimal")
    sol = prob.solve()
    assert sol._engine.certified is True
    assert abs(sol.objective() - obj) <= 1e-9 * (1 + abs(obj))
