"""Netlib-shape validation gate (C8 analog, SURVEY.md §5 #3).

The reference gates on the real Netlib suite (`tests/` + vendored `*.mps.gz`
[CODE]); that data is not on this machine, so this gate solves synthetic
instances at the SAME shapes and sparsities as the headline Netlib problems
(utils/synth.py) against the scipy-HiGHS oracle — in the DEFAULT suite, both
engines:

* simplex, f32-iterate + f64-certify (forced with f32_midsize="always"):
  certified exact optimum, ≤1e-9 relative;
* PDHG to KKT 1e-6: ≤1e-5 relative objective agreement.

maros-r7 scale (3136×9408) stays behind --run-slow (minutes on CPU); on the
GPU it is covered by chip_smoke.py's crossover phase.
"""

import numpy as np
import pytest

from minilp_tpu.options import SolverOptions
from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem

from .oracle import random_problem, solve_with_oracle

F32_CERT = SolverOptions(f32_midsize="always")
PDHG = SolverOptions(engine="pdhg", feas_tol=1e-6, pdhg_max_iter=600_000)


def _instance(name: str, seed: int):
    m, nv, d = NETLIB_SHAPES[name]
    prob = netlib_shaped_problem(m, nv, d, seed=seed)
    outcome, obj, _x = solve_with_oracle(prob)
    assert outcome == "optimal"  # generator plants a feasible bounded LP
    return prob, obj


@pytest.mark.parametrize("name", ["25fv47", "fit1p"])
def test_netlib_shape_f32_certified(name):
    prob, obj = _instance(name, seed=1)
    prob.options = F32_CERT
    sol = prob.solve()
    handle = sol._engine
    assert handle.certified is True  # exact f64 vertex adopted, not f32 claim
    assert abs(sol.objective() - obj) <= 1e-9 * (1 + abs(obj))
    assert handle.iterations() > 0


@pytest.mark.parametrize("name", ["25fv47", "fit1p"])
def test_netlib_shape_pdhg(name):
    prob, obj = _instance(name, seed=2)
    prob.options = PDHG
    sol = prob.solve()
    assert abs(sol.objective() - obj) <= 1e-5 * (1 + abs(obj))


@pytest.mark.slow
@pytest.mark.gpu
@pytest.mark.skipif("not config.getoption('--run-slow', default=False)")
def test_maros_r7_shape_certified():
    # 3136×9408 @ ~0.5% — the reference's biggest headline instance
    prob, obj = _instance("maros-r7", seed=1)
    sol = prob.solve()   # auto: device PDHG → crossover → exact polish
    assert sol._engine.certified is True
    assert abs(sol.objective() - obj) <= 1e-9 * (1 + abs(obj))


@pytest.mark.slow
@pytest.mark.skipif("not config.getoption('--run-slow', default=False)")
def test_maros_r7_shape_pdhg_sparse():
    """PDHG sparse-BCOO path at the reference's biggest headline shape
    (SURVEY §8 Phase 5's pds-class pressure valve): 3136×9408 @ ~0.5%,
    capped iterations, ≤1e-5 relative objective agreement vs the oracle."""
    import jax

    prob, obj = _instance("maros-r7", seed=3)
    prob.options = SolverOptions(
        engine="pdhg", feas_tol=1e-6, pdhg_matrix="sparse",
        pdhg_max_iter=400_000,
    )
    # CPU-pinned: this is a CPU-scale correctness gate of the sparse path.
    with jax.default_device(jax.devices("cpu")[0]):
        sol = prob.solve()
    assert abs(sol.objective() - obj) <= 1e-5 * (1 + abs(obj))


@pytest.mark.slow
@pytest.mark.skipif("not config.getoption('--run-slow', default=False)")
def test_maros_shape_cold_cpu_crossover():
    """FULL maros-r7-shape (3136×9408) COLD solve on the CPU-only backend,
    through the public driver route: PDHG (sparse) → basis identification →
    exact host polish (engine/crossover.py): PDHG ~95k iterations + 61
    exact pivots, certified, where the cold slack-basis host solve needs
    ~88k pivots."""
    prob, obj = _instance("maros-r7", seed=1)
    prob.options = SolverOptions(f32_midsize="never")
    sol = prob.solve()
    assert sol._engine.certified is True
    assert abs(sol.objective() - obj) <= 1e-9 * (1 + abs(obj))


def test_crossover_25fv47_shape():
    """PDHG → basis identification → host polish at the 25fv47 shape
    (DEFAULT suite).  The polish pivot count is the point:
    basis identification must land within a few dozen exact pivots of the
    optimum (measured 18 at this shape vs 11.8k for the cold host solve)."""
    import numpy as np

    from minilp_tpu.canonical import canonicalize
    from minilp_tpu.engine import crossover
    from minilp_tpu.status import Status

    prob, obj = _instance("25fv47", seed=1)
    can = canonicalize(prob, dtype=np.float64)
    res = crossover.solve_cold_crossover(can, SolverOptions())
    assert res is not None and res.status == int(Status.OPTIMAL)
    got = can.obj_sign * res.obj
    assert abs(got - obj) <= 1e-7 * (1 + abs(obj))


@pytest.mark.slow
@pytest.mark.skipif("not config.getoption('--run-slow', default=False)")
def test_800x1500_sparse_boxed():
    # legacy round-1 gate: mixed-sense random sparse instance through the
    # default engine selection (f64 XLA engine on CPU)
    rng = np.random.default_rng(777)
    prob = random_problem(
        rng, nv=1500, m=800, density=0.01,
        frac_free=0.0, frac_boxed=1.0, frac_fixed=0.0,
    )
    outcome, obj, _ = solve_with_oracle(prob)
    assert outcome == "optimal"
    sol = prob.solve()
    assert abs(sol.objective() - obj) <= 1e-6 * (1 + abs(obj))
