"""Device-PDHG crossover stage gates — CPU-side logic.

The card path is exercised by tests/test_gpu.py and chip_smoke.py; here the
stage itself runs forced onto the CPU, and the handoff LOGIC is gated by
monkeypatching `_device_pdhg_stage` outcomes:
a good device iterate short-circuits the host PDHG stage entirely, a
floor-stalled iterate warm-starts the host sparse loop (which must still
converge and certify), and a garbage outcome falls back to the cold host
stage.  All three must end in the same certified objective.
"""

import numpy as np
import pytest

from minilp_tpu.canonical import canonicalize
from minilp_tpu.engine import crossover
from minilp_tpu.options import SolverOptions
from minilp_tpu.status import Status
from minilp_tpu.utils.synth import netlib_shaped_problem

from .oracle import solve_with_oracle


@pytest.fixture(scope="module")
def inst():
    prob = netlib_shaped_problem(60, 150, 0.08, seed=4)
    outcome, obj, _ = solve_with_oracle(prob)
    assert outcome == "optimal"
    can = canonicalize(prob, dtype=np.float64)
    opts = SolverOptions()
    # reference PDHG iterate to synthesize "device" results from
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    from minilp_tpu.engine.pdhg import solve_pdhg_sparse

    p_opts = dataclasses.replace(opts, feas_tol=1e-6, pdhg_matrix="sparse")
    with jax.default_device(jax.devices("cpu")[0]):
        Ab = jsparse.BCOO.fromdense(jnp.asarray(can.A))
        st = solve_pdhg_sparse(
            Ab, jnp.asarray(can.b), jnp.asarray(can.c),
            jnp.asarray(can.lo), jnp.asarray(can.hi), opts=p_opts,
        )
    assert int(st.status) == int(Status.OPTIMAL)
    return can, opts, obj, np.asarray(st.x), np.asarray(st.y)


def _check(res, can, obj):
    assert res is not None
    assert int(res.status) == int(Status.OPTIMAL)
    got = can.obj_sign * res.obj
    assert abs(got - obj) <= 1e-7 * (1 + abs(obj))


def test_device_stage_short_circuits_host_pdhg(inst, monkeypatch):
    can, opts, obj, x, y = inst
    tol = max(opts.crossover_tol, opts.feas_tol)
    err = crossover.kkt_error_f64(can.A, can.b, can.c, can.lo, can.hi,
                                  x, y, tol)
    assert err <= 10.0 * tol

    calls = {"host": 0}
    monkeypatch.setattr(crossover, "_device_pdhg_stage",
                        lambda *a, **k: (x, y, 1234, err, 1.0))
    import minilp_tpu.engine.pdhg as pdhg_mod

    orig = pdhg_mod.solve_pdhg_sparse

    def spy(*a, **k):
        calls["host"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(crossover, "solve_cold_crossover",
                        crossover.solve_cold_crossover)  # no-op, clarity
    monkeypatch.setattr(pdhg_mod, "solve_pdhg_sparse", spy)
    res = crossover.solve_cold_crossover(can, opts)
    _check(res, can, obj)
    assert calls["host"] == 0  # the chip iterate made the host stage moot


def test_device_floor_warm_starts_host_pdhg(inst, monkeypatch):
    """An iterate stalled ABOVE 10×tol but below 1e-2 must be continued by
    the host sparse loop warm — and still certify."""
    can, opts, obj, x, y = inst
    rng = np.random.default_rng(0)
    tol = max(opts.crossover_tol, opts.feas_tol)
    # degrade the DUAL iterate until the error lands in the floor window
    # (f32-resolution-floor stand-in); x stays on its bounds so the error is
    # a clean dual-residual term
    x2, y2, err = None, None, None
    for scale in (6e-4, 1e-3, 2e-3, 3e-3, 4e-4):
        yt = y + rng.normal(scale=scale * (1 + np.abs(y)))
        e = crossover.kkt_error_f64(can.A, can.b, can.c, can.lo, can.hi,
                                    x, yt, tol)
        if 10.0 * tol < e <= 1e-2:
            x2, y2, err = x, yt, e
            break
    if err is None:
        pytest.skip("no perturbation scale landed in the floor window")
    monkeypatch.setattr(crossover, "_device_pdhg_stage",
                        lambda *a, **k: (x2, y2, 777, err, 1.0))
    res = crossover.solve_cold_crossover(can, opts)
    _check(res, can, obj)
    from minilp_tpu.utils import profiling

    # the host sparse stage must have run (warm continuation), visible as
    # its stage timer alongside the device stage's
    assert "crossover_pdhg_s" in profiling.stages()


def test_device_garbage_falls_back_to_cold_host(inst, monkeypatch):
    can, opts, obj, x, y = inst
    xg = np.zeros_like(x)
    yg = np.zeros_like(y)
    err = crossover.kkt_error_f64(can.A, can.b, can.c, can.lo, can.hi,
                                  xg, yg, opts.crossover_tol)
    assert err > 1e-2
    monkeypatch.setattr(crossover, "_device_pdhg_stage",
                        lambda *a, **k: (xg, yg, 5, err, 1.0))
    res = crossover.solve_cold_crossover(can, opts)
    _check(res, can, obj)


def test_device_stage_declines_on_cpu(inst):
    can, opts, *_ = inst
    assert crossover._device_pdhg_stage(can, opts, 1e-4, False) is None


def test_device_stage_forced_on_cpu(inst):
    """The stage's own loop (f32 chunks, host f64 KKT monitor) run on the
    CPU: the returned error IS the exact f64 KKT of the returned iterate,
    and it reaches the identification neighbourhood."""
    can, opts, *_ = inst
    tol = max(opts.crossover_tol, opts.feas_tol)
    out = crossover._device_pdhg_stage(can, opts, tol, False, force=True)
    assert out is not None
    x, y, niter, err, omega = out
    assert niter > 0 and omega > 0
    err2 = crossover.kkt_error_f64(can.A, can.b, can.c, can.lo, can.hi,
                                   x, y, tol)
    assert abs(err - err2) <= 1e-12 * (1 + err2)
    assert err <= 10.0 * tol


def test_crossover_with_forced_device_stage(inst, monkeypatch):
    """The whole crossover with the device stage forced on: the device
    iterate feeds identification directly and the answer certifies."""
    can, opts, obj, *_ = inst
    stage = crossover._device_pdhg_stage
    monkeypatch.setattr(
        crossover, "_device_pdhg_stage",
        lambda *a, **k: stage(*a, **{**k, "force": True}),
    )
    from minilp_tpu.utils import profiling

    profiling.reset_stages()
    res = crossover.solve_cold_crossover(can, opts)
    _check(res, can, obj)
    assert profiling.stages()["crossover_pdhg_device_iters"] > 0
