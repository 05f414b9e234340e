#!/usr/bin/env python
"""Headline benchmark: batched scenario-LP throughput on one GPU.

BASELINE config 3 ("1k–64k independent random dense LPs (m,n ≤ 256)") — how
many LPs per second one device solves to verified optimality, versus a
state-of-the-art CPU solver (scipy/HiGHS) solving the same instances
sequentially on the host.

The device path is the route `routes.batched_route` picks (on the GPU, the
one-LP-per-program Triton kernel, ops/kernels/batched_simplex.py; elsewhere
the vmapped f32 engine); every returned objective is re-derived exactly in
f64 on the host from the discovered basis and certified primal+dual
feasible, so the reported throughput is for *certified* 1e-7-grade
solutions.  Problem data is host-resident f64; the device sees only f32
copies, and host certification of batch k overlaps the device solve of
batch k+1 (parallel/batched.py::solve_batches_pipelined).

Run: python bench.py   (on the GPU machine; prints exactly ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras})
"""

from __future__ import annotations

import json
import time

import numpy as np


def _single_lp_and_incremental_metrics() -> dict:
    """Single-LP cold/warm wall-clock + incremental branch-and-cut loop
    (BASELINE configs 1 and 4): one cold `Problem.solve()` per size bucket,
    then a chain of `Solution.add_constraint` re-solves (each cuts off the
    current optimum by a small margin — the branch-and-cut node pattern),
    reporting mean wall and re-solve pivot counts per node."""
    from minilp_tpu.api import ComparisonOp, LinearExpr, Variable
    from minilp_tpu.utils.synth import netlib_shaped_problem

    out = {}
    for tag, (m, nv, dens) in {
        "256x1024": (250, 760, 0.05),
        "512x2048": (500, 1530, 0.03),
    }.items():
        prob = netlib_shaped_problem(m, nv, dens, seed=11)
        t0 = time.perf_counter()
        sol = prob.solve()
        cold_s = time.perf_counter() - t0
        cold_iters = sol._engine.iterations()

        rng = np.random.default_rng(5)
        walls, pivots = [], []
        cur = sol
        for _k in range(6):
            js = rng.choice(nv, size=8, replace=False)
            coeffs = rng.normal(size=8)
            val = sum(
                float(cf) * cur[Variable(int(j))]
                for cf, j in zip(coeffs, js)
            )
            expr = LinearExpr(
                (float(cf), Variable(int(j))) for cf, j in zip(coeffs, js)
            )
            t0 = time.perf_counter()
            try:
                cur = cur.add_constraint(expr, ComparisonOp.Le, val - 0.05)
            except Exception:  # cut made the node infeasible — stop the chain
                break
            walls.append(time.perf_counter() - t0)
            pivots.append(cur._engine.iterations())
        out[tag] = {
            "cold_s": round(cold_s, 3),
            "cold_iters": int(cold_iters),
            "certified": bool(sol._engine.certified),
            "resolve_nodes": len(walls),
            "mean_resolve_s": round(float(np.mean(walls)), 3) if walls else None,
            "mean_resolve_pivots": (
                round(float(np.mean(pivots)), 1) if pivots else None
            ),
        }
    return out


def _netlib_shape_metric() -> dict:
    """25fv47-shape certified single solve (the reference's bread-and-butter
    instance class; BASELINE §1) through the default route, with the stage
    breakdown and a warm repeat: the first wall includes compilation; the
    warm number is what a session pays per solve afterwards."""
    from minilp_tpu.utils import profiling
    from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem

    m, nv, dens = NETLIB_SHAPES["25fv47"]
    prob = netlib_shaped_problem(m, nv, dens, seed=1)
    profiling.reset_stages()
    t0 = time.perf_counter()
    sol = prob.solve()
    wall = time.perf_counter() - t0
    stages = profiling.stages()
    accounted = sum(v for k, v in stages.items() if k.endswith("_s"))
    stages["unattributed_s"] = round(wall - accounted, 3)
    prob2 = netlib_shaped_problem(m, nv, dens, seed=1)
    t0 = time.perf_counter()
    sol2 = prob2.solve()
    warm_wall = time.perf_counter() - t0
    return {
        "shape": f"{m}x{nv}",
        "wall_s": round(wall, 2),
        "warm_wall_s": round(warm_wall, 2),
        "iters": int(sol._engine.iterations()),
        "certified": bool(sol._engine.certified and sol2._engine.certified),
        "breakdown": stages,
    }


def _maros_shape_metric() -> dict:
    """maros-r7-shape certified single solve — the reference's biggest
    headline instance (BASELINE §1), through the default route: device PDHG
    → basis identification → exact host polish (the crossover).

    Reports a stage breakdown measured inside the real solve via
    utils/profiling stage timers."""
    from minilp_tpu.utils import profiling
    from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem

    m, nv, dens = NETLIB_SHAPES["maros-r7"]
    prob = netlib_shaped_problem(m, nv, dens, seed=1)
    profiling.reset_stages()
    t0 = time.perf_counter()
    sol = prob.solve()
    wall = time.perf_counter() - t0
    stages = profiling.stages()
    accounted = sum(v for k, v in stages.items() if k.endswith("_s"))
    stages["unattributed_s"] = round(wall - accounted, 3)
    return {
        "shape": f"{m}x{nv}",
        "wall_s": round(wall, 2),
        "iters": int(sol._engine.iterations()),
        "certified": bool(sol._engine.certified),
        "objective": float(sol.objective()),
        "breakdown": stages,
    }


def _pdhg_maros_metric(ref_obj: float | None) -> dict | None:
    """PDHG at the maros shape on the device — the first-order engine's
    performance line: a dense-f32 head start (`_device_pdhg_stage`), then
    the sparse-f64 loop continues warm in chunks.

    WALL-BOUNDED: the line reports the KKT error and relative objective gap
    REACHED within a 90 s budget.  rel_gap is against the certified simplex
    objective of the SAME instance from the maros line."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    from minilp_tpu.canonical import canonicalize
    from minilp_tpu.engine.pdhg import solve_pdhg_sparse
    from minilp_tpu.options import SolverOptions
    from minilp_tpu.status import Status
    from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem

    from minilp_tpu.engine.crossover import _device_pdhg_stage, kkt_error_f64
    from minilp_tpu.engine.pdhg import PdhgState

    m, nv, dens = NETLIB_SHAPES["maros-r7"]
    prob = netlib_shaped_problem(m, nv, dens, seed=1)
    can = canonicalize(prob, dtype=np.float64)
    opts = SolverOptions(engine="pdhg", feas_tol=1e-6, pdhg_matrix="sparse",
                         pdhg_max_iter=400_000)
    budget_s = 90.0
    try:
        t0 = time.perf_counter()
        # dense-f32 head start on the device, then the exact sparse-f64
        # device loop continues warm for the remaining budget.
        f32_iters = 0
        st0 = None
        # head gets HALF the budget: the f64 sparse tail below must always
        # get a turn — the halpern head's O(1/k) tail leaves variables ~1/k
        # off their bounds, so its iterate evaluated at the tighter
        # feas_tol shows a complementarity cliff (measured: f32 head KKT
        # 3.5e-5 at tol=1e-5 → 0.167 at 1e-6) until a few exact-f64
        # iterations snap the actives
        dev = _device_pdhg_stage(can, opts, max(opts.feas_tol, 1e-5),
                                 False, budget_s=0.5 * budget_s)
        f32_err = None
        if dev is not None:
            x_d = jnp.asarray(np.asarray(dev[0], np.float64))
            y_d = jnp.asarray(np.asarray(dev[1], np.float64))
            f32_iters, f32_err = int(dev[2]), float(dev[3])
            st0 = PdhgState(
                x=x_d, y=y_d,
                x_sum=jnp.zeros_like(x_d), y_sum=jnp.zeros_like(y_d),
                x_rst=x_d, y_rst=y_d,
                omega=jnp.asarray(max(min(dev[4], 1e6), 1e-6), jnp.float64),
                inner=jnp.asarray(0.0, jnp.float64),
                last_err=jnp.asarray(dev[3], jnp.float64),
                niter=jnp.int32(dev[2]),
                status=jnp.int32(int(Status.MAX_ITER)),
                err=jnp.asarray(dev[3], jnp.float64),
            )
        Ab = jsparse.BCOO.fromdense(jnp.asarray(can.A))
        args = (jnp.asarray(can.b), jnp.asarray(can.c),
                jnp.asarray(can.lo), jnp.asarray(can.hi))
        st = st0
        done = f32_iters
        # chunked launches bound the total wall; the first (short) tail chunk
        # runs even if the head overshot the budget, so the line always
        # reports a measured f64 iterate
        chunk = 1000
        first_tail = True
        while True:
            wall = time.perf_counter() - t0
            if done >= opts.pdhg_max_iter:
                break
            if wall > budget_s and not first_tail:
                break
            cap = min(done + (256 if first_tail else chunk),
                      opts.pdhg_max_iter)
            first_tail = False
            st = solve_pdhg_sparse(Ab, *args, opts=opts, state0=st,
                                   stop_at=jnp.int32(cap))
            jax.block_until_ready(st)
            done = int(st.niter)
            wall = time.perf_counter() - t0
            if int(st.status) != int(Status.MAX_ITER):
                break
        if st is None:
            return {"shape": f"{m}x{nv}",
                    "error": "f32 stage returned nothing and budget elapsed"}
        x_fin = np.asarray(st.x)
        y_fin = np.asarray(st.y)
        kkt = kkt_error_f64(can.A, can.b, can.c, can.lo, can.hi,
                            x_fin, y_fin, float(opts.feas_tol))
    except Exception as e:  # surfaced in the artifact, not hidden
        return {"shape": f"{m}x{nv}", "error": f"{type(e).__name__}: {e}"}
    obj = float(can.obj_sign * (can.c @ x_fin))
    out = {
        "shape": f"{m}x{nv}",
        "wall_s": round(wall, 2),
        "iters": done,
        "iters_per_sec": round(done / wall, 1),
        "f32_head_iters": f32_iters,
        "f32_head_kkt": (float(f"{f32_err:.3g}")
                         if f32_err is not None else None),
        "kkt_err": float(f"{kkt:.3g}"),
        "status": Status(int(st.status)).name,
        "objective": obj,
        "wall_bounded_s": budget_s,
    }
    if ref_obj is not None:
        out["rel_gap_vs_certified"] = float(
            f"{abs(obj - ref_obj) / (1 + abs(ref_obj)):.3g}"
        )
    return out


def _incremental_routing_metric() -> dict:
    """Warm re-solve latency of the default (host-first) incremental route
    at (256, 1024): a cut chain from one warm state."""
    from minilp_tpu.api import ComparisonOp, LinearExpr, Variable
    from minilp_tpu.utils.synth import netlib_shaped_problem

    cur = netlib_shaped_problem(250, 760, 0.05, seed=11).solve()
    rng = np.random.default_rng(5)
    walls = []
    for _k in range(4):
        js = rng.choice(760, size=8, replace=False)
        coeffs = rng.normal(size=8)
        val = sum(float(cf) * cur[Variable(int(j))]
                  for cf, j in zip(coeffs, js))
        expr = LinearExpr(
            (float(cf), Variable(int(j))) for cf, j in zip(coeffs, js)
        )
        t0 = time.perf_counter()
        try:
            cur = cur.add_constraint(expr, ComparisonOp.Le, val - 0.05)
        except Exception:  # cut made the node infeasible — stop the chain
            break
        walls.append(time.perf_counter() - t0)
    return {"host": {
        "nodes": len(walls),
        "mean_resolve_s": round(float(np.mean(walls)), 3) if walls else None,
    }}


def main() -> None:
    import jax

    from chip_smoke import card_info

    import minilp_tpu  # noqa: F401  (enables x64)
    from minilp_tpu import routes
    from minilp_tpu.parallel import batched
    from minilp_tpu.utils import compile_cache

    from minilp_tpu.parallel.batched import (
        make_random_batch_host, solve_batches_pipelined,
    )
    from minilp_tpu.status import Status

    compile_cache.configure(__file__)

    BATCH, M, NV = 1024, 32, 96
    N_BATCHES = 4
    route = routes.batched_route(M, M + NV)

    # warmup/compile on one batch, then time on FRESH batches.
    warm = [make_random_batch_host(0, batch=BATCH, m=M, nv=NV)]
    solve_batches_pipelined(warm, max_iter=2000)

    batches = [make_random_batch_host(1 + k, batch=BATCH, m=M, nv=NV)
               for k in range(N_BATCHES)]
    # median of 3, with the spread in the artifact
    rep_walls = []
    for _rep in range(3):
        t0 = time.perf_counter()
        results = solve_batches_pipelined(batches, max_iter=2000)
        rep_walls.append(time.perf_counter() - t0)
    dt = float(np.median(rep_walls))
    lps_per_sec = (N_BATCHES * BATCH) / dt
    lps_reps = sorted(round((N_BATCHES * BATCH) / w, 1) for w in rep_walls)

    statuses = np.concatenate([np.asarray(r.status) for r in results])
    verified = np.concatenate([np.asarray(r.verified) for r in results])
    niters = np.concatenate([np.asarray(r.niter) for r in results])
    n_optimal = int((statuses == int(Status.OPTIMAL)).sum())
    n_verified = int(verified.sum())

    # Device-only solve rate (data already device-resident, f32): isolates
    # the device route from upload and host certification.
    s0 = NV
    dev_args = batched._prepare(batches[0], route, s0)
    kernel_ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(batched._launch(dev_args, route, s0, 2000, False))
        kernel_ts.append(time.perf_counter() - t0)
    device_lps = BATCH / min(kernel_ts)

    # CPU baseline + independent correctness guard on a sample of batch 0.
    from scipy.optimize import linprog

    A, b, c, lo, hi = batches[0]
    res0 = results[0]
    sample = min(64, BATCH)
    t0 = time.perf_counter()
    max_gap = 0.0
    for i in range(sample):
        bounds = [
            (lo[i, j] if np.isfinite(lo[i, j]) else None,
             hi[i, j] if np.isfinite(hi[i, j]) else None)
            for j in range(c.shape[1])
        ]
        r = linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=bounds, method="highs")
        if r.status == 0 and bool(res0.verified[i]):
            gap = abs(float(res0.obj[i]) - r.fun) / (1.0 + abs(r.fun))
            max_gap = max(max_gap, gap)
    cpu_dt = time.perf_counter() - t0
    cpu_lps_per_sec = sample / cpu_dt

    single_lp = _single_lp_and_incremental_metrics()
    netlib_shape = _netlib_shape_metric()
    inc_routing = _incremental_routing_metric()
    maros_shape = _maros_shape_metric()
    pdhg_maros = _pdhg_maros_metric(
        maros_shape.get("objective") if maros_shape else None
    )

    print(json.dumps({
        "metric": "batched_lp_throughput",
        "value": round(lps_per_sec, 2),
        "unit": f"certified LPs/s (1024-LP batches of dense 32x128, {route} route, pipelined f64 certification; median of 3 reps)",
        "reps_lps_per_sec": lps_reps,
        "vs_baseline": round(lps_per_sec / cpu_lps_per_sec, 3),
        "baseline": "scipy-HiGHS sequential on host CPU (LPs/s)",
        "baseline_value": round(cpu_lps_per_sec, 2),
        "n_optimal": n_optimal,
        "n_verified": n_verified,
        "batch": BATCH,
        "n_batches": N_BATCHES,
        "max_rel_gap_vs_highs": float(f"{max_gap:.3g}"),
        "mean_simplex_iters": round(float(niters.mean()), 1),
        "simplex_iters_per_sec": round(float(niters.sum() / dt), 1),
        "wall_s": round(dt, 4),
        "device_only_lps_per_sec": round(device_lps, 2),
        # BASELINE configs 1/4: single-LP cold + incremental loop per size
        "single_lp": single_lp,
        # BASELINE §1: certified Netlib-shape (25fv47) single solve
        "netlib_shape_25fv47": netlib_shape,
        # BASELINE §1: the biggest headline instance, certified end-to-end
        "netlib_shape_maros_r7": maros_shape,
        # first-order engine at the biggest headline shape
        "pdhg_maros_shape": pdhg_maros,
        # warm re-solve latency of the default incremental route
        "incremental_routing": inc_routing,
        "backend": jax.default_backend(),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "card": card_info() if jax.default_backend() == "gpu" else None,
    }))


if __name__ == "__main__":
    main()
