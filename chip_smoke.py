#!/usr/bin/env python
"""Smoke run of the solver's main path on NVIDIA GPUs.

    python chip_smoke.py             # one GPU: phases 1-5
    python chip_smoke.py --chips 4   # four GPUs: the sharded paths only

One GPU, five phases through the public entry points, each run once to
compile and once timed:

1. cold single LP at the 25fv47 shape (`Problem.solve()`): certified,
   within 1e-9 of scipy-HiGHS, through the device XLA engine on the GPU;
2. a warm branch-and-cut chain at the 512×2048 bucket: one cold solve and
   six `add_constraint` re-solves, each certified and within 1e-9 of a HiGHS
   solve of the same cut problem;
3. the batched scenario pipeline (`solve_batches_pipelined`, 4 batches of
   1024 LPs of 32×128): every lane certified, ≥ 99% by the device route
   before the host fallback, a 64-lane sample within 1e-7 of HiGHS, and
   objectives within 1e-9 of the plain reference (the vmapped f64 engine);
4. a cold LP at the maros-r7 shape through the crossover, its PDHG stage on
   the GPU: certified (an exact f64 primal + dual optimality proof);
5. the `gpu`-marked tests (tests/test_gpu.py), in this process.

Four GPUs: the data-parallel scenario batch (4×1 mesh), row-sharded PDHG at
the maros shape (1×4 mesh) and the column-sharded simplex at the 25fv47
shape (1×4 mesh), each against its one-device result, with each shard shown
on its own card.

Every phase prints its route, wall time and check.  A line before the last
gives the card's name and power limit (nvidia-smi); the last line is one
JSON object, {"ok": true, "device": {"platform", "kind", "count"}}.  The
script exits non-zero, with no result line, when JAX finds no GPU, when it
is not run from a checkout of the repository, or when any phase fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


class PhaseFailed(AssertionError):
    """A phase's correctness check did not hold."""


def _check(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / (1.0 + abs(b))


def _require_checkout() -> None:
    if not ((ROOT / "minilp_tpu" / "__init__.py").is_file()
            and (ROOT / "tests" / "oracle.py").is_file()):
        sys.exit("chip_smoke.py: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))


def _require_gpus(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        sys.exit(f"chip_smoke.py: needs {count} GPU(s); JAX sees "
                 f"{len(devs)} {devs[0].platform} device(s)")
    return devs[:count]


def card_info() -> str:
    """The cards' names and power limits as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    _check(out, "nvidia-smi reported no card")
    return out


def _timed(fn):
    """Run `fn` once to compile, then once timed: (result, warm s, first s)."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, first


# ---------------------------------------------------------------------------
# One GPU
# ---------------------------------------------------------------------------

def phase_cold_single(shape=None, seed: int = 1, backend: str = "gpu") -> dict:
    """Cold `Problem.solve()` at the 25fv47 shape through the device engine."""
    from minilp_tpu.utils import records
    from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem
    from tests.oracle import solve_with_oracle

    m, nv, dens = shape or NETLIB_SHAPES["25fv47"]

    def run():
        prob = netlib_shaped_problem(m, nv, dens, seed=seed)
        with records.capture() as recs:
            sol = prob.solve()
        return prob, sol, recs

    (prob, sol, recs), wall, first = _timed(run)
    outcome, ref, _ = solve_with_oracle(prob)
    _check(outcome == "optimal", f"HiGHS says {outcome}")
    gap = _rel(sol.objective(), ref)
    _check(sol._engine.certified is True, "not certified")
    _check(gap <= 1e-9, f"rel gap vs HiGHS {gap:.2e} > 1e-9")
    route = [(r.event, r.backend) for r in recs]
    _check(route == [("cold_solve", backend)],
           f"route {route}, expected cold_solve on {backend}")
    return {"shape": f"{m}x{nv}", "route": f"cold_solve@{recs[0].backend}",
            "wall_s": wall, "first_run_s": first,
            "pivots": sol._engine.iterations(),
            "check": f"certified, rel gap vs HiGHS {gap:.1e} <= 1e-9"}


def phase_warm_chain(shape=(500, 1530, 0.03), seed: int = 11,
                     nodes: int = 6) -> dict:
    """Cold solve + `add_constraint` re-solves (the branch-and-cut node
    pattern): each cut removes the current optimum by a small margin."""
    from minilp_tpu import Infeasible
    from minilp_tpu.api import ComparisonOp, LinearExpr, Variable
    from minilp_tpu.utils import records
    from minilp_tpu.utils.synth import netlib_shaped_problem
    from tests.oracle import solve_with_oracle

    m, nv, dens = shape

    def run():
        prob = netlib_shaped_problem(m, nv, dens, seed=seed)
        shadow = copy.deepcopy(prob)
        t0 = time.perf_counter()
        with records.capture() as recs:
            sol = prob.solve()
        cold_s = time.perf_counter() - t0
        # the incremental API re-solves in place: read each node's answer now
        node = lambda name, event, dt: (
            name, event, dt, sol.objective(), sol._engine.certified,
            copy.deepcopy(shadow))
        chain = [node("cold", recs[-1].event, cold_s)]
        rng = np.random.default_rng(5)
        for k in range(nodes):
            js = rng.choice(nv, size=8, replace=False)
            coeffs = rng.normal(size=8)
            val = sum(float(cf) * sol[Variable(int(j))]
                      for cf, j in zip(coeffs, js))
            expr = LinearExpr((float(cf), Variable(int(j)))
                              for cf, j in zip(coeffs, js))
            shadow.add_constraint(expr, ComparisonOp.Le, val - 0.05)
            t0 = time.perf_counter()
            with records.capture() as recs:
                try:
                    sol = sol.add_constraint(expr, ComparisonOp.Le, val - 0.05)
                except Infeasible:
                    chain.append((f"node {k + 1}", "infeasible", 0.0, None,
                                  None, copy.deepcopy(shadow)))
                    break
            chain.append(node(f"node {k + 1}", recs[-1].event,
                              time.perf_counter() - t0))
        return chain

    chain, wall, first = _timed(run)
    routes, worst = [], 0.0
    for name, event, _dt, obj, certified, shadow in chain:
        outcome, ref, _ = solve_with_oracle(shadow)
        routes.append(f"{name}:{event}")
        if obj is None:
            _check(outcome == "infeasible", f"{name}: infeasible, HiGHS "
                   f"says {outcome}")
            continue
        _check(outcome == "optimal", f"{name}: HiGHS says {outcome}")
        _check(certified is True, f"{name}: not certified")
        gap = _rel(obj, ref)
        _check(gap <= 1e-9, f"{name}: rel gap vs HiGHS {gap:.2e} > 1e-9")
        worst = max(worst, gap)
    node_s = [row[2] for row in chain[1:] if row[3] is not None]
    return {"shape": f"{m}x{nv}", "route": " ".join(routes),
            "wall_s": wall, "first_run_s": first, "cold_s": chain[0][2],
            "mean_node_s": float(np.mean(node_s)) if node_s else None,
            "check": f"{len(chain)} solves certified, worst rel gap vs "
                     f"HiGHS {worst:.1e} <= 1e-9"}


def _reference_batch(batch):
    """Plain reference: the vmapped f64 engine from the slack basis, with
    each lane's basis certified in host f64."""
    import jax.numpy as jnp

    from minilp_tpu.options import SolverOptions
    from minilp_tpu.parallel.batched import solve_batch, verify_f64
    from minilp_tpu.status import VarStat

    A, b, c, lo, hi = batch
    B, m, n = A.shape
    nv = n - m
    vstat0 = np.concatenate([np.full((B, nv), int(VarStat.AT_LOWER), np.int8),
                             np.full((B, m), int(VarStat.BASIC), np.int8)], 1)
    basis0 = np.broadcast_to(np.arange(nv, n, dtype=np.int32), (B, m))
    st = solve_batch(*map(jnp.asarray, (A, b, c, lo, hi, vstat0, basis0)),
                     opts=SolverOptions(max_iter=2000))
    obj, ok, _x = verify_f64(A, b, c, lo, hi, np.asarray(st.basis),
                             np.asarray(st.vstat), np.asarray(st.status))
    return obj, ok


def phase_batched(batch: int = 1024, m: int = 32, nv: int = 96,
                  n_batches: int = 4, sample: int = 64,
                  route: str | None = None) -> dict:
    """`solve_batches_pipelined` on scenario batches, against HiGHS and the
    plain vmapped f64 reference."""
    from scipy.optimize import linprog

    from minilp_tpu import routes
    from minilp_tpu.parallel.batched import (
        make_random_batch_host, solve_batches_pipelined,
    )

    taken = route or routes.batched_route(m, m + nv)
    solve_batches_pipelined([make_random_batch_host(0, batch, m, nv)],
                            route=taken)                      # compile
    batches = [make_random_batch_host(1 + k, batch, m, nv)
               for k in range(n_batches)]
    t0 = time.perf_counter()
    results = solve_batches_pipelined(batches, route=taken)
    wall = time.perf_counter() - t0

    total = n_batches * batch
    verified = np.concatenate([r.verified for r in results])
    device_ok = ~np.concatenate([r.host_resolved for r in results])
    _check(verified.all(), f"{int((~verified).sum())} lanes uncertified")
    share = float(device_ok.mean())
    _check(share >= 0.99, f"device route certified {share:.4f} < 0.99")

    A, b, c, lo, hi = batches[0]
    worst_highs = 0.0
    for i in range(min(sample, batch)):
        bounds = [(lo[i, j], hi[i, j] if np.isfinite(hi[i, j]) else None)
                  for j in range(c.shape[1])]
        r = linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=bounds,
                    method="highs")
        _check(r.status == 0, f"HiGHS status {r.status} on lane {i}")
        worst_highs = max(worst_highs, _rel(float(results[0].obj[i]), r.fun))
    _check(worst_highs <= 1e-7, f"rel gap vs HiGHS {worst_highs:.2e} > 1e-7")

    worst_ref, n_both = 0.0, 0
    for res, bt in zip(results, batches):
        ref_obj, ref_ok = _reference_batch(bt)
        both = ref_ok & ~res.host_resolved
        n_both += int(both.sum())
        if both.any():
            gaps = np.abs(res.obj[both] - ref_obj[both]) / (
                1.0 + np.abs(ref_obj[both]))
            worst_ref = max(worst_ref, float(gaps.max()))
    _check(n_both > 0, "no lane certified by both routes")
    _check(worst_ref <= 1e-9, f"rel gap vs f64 reference {worst_ref:.2e}")
    niter = np.concatenate([r.niter for r in results])
    return {"shape": f"{n_batches}x{batch} LPs of {m}x{m + nv}",
            "route": taken, "wall_s": wall, "lps_per_s": total / wall,
            "mean_pivots": float(niter.mean()),
            "check": f"{total}/{total} certified, {share:.4f} by the device "
                     f"route, sample gap vs HiGHS {worst_highs:.1e} <= 1e-7, "
                     f"{n_both} lanes vs f64 reference {worst_ref:.1e} <= "
                     f"1e-9"}


def phase_crossover(shape=None, seed: int = 1, backend: str = "gpu") -> dict:
    """Cold solve at the maros-r7 shape: PDHG (on the card) → basis
    identification → exact host polish."""
    from minilp_tpu.utils import profiling, records
    from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem

    m, nv, dens = shape or NETLIB_SHAPES["maros-r7"]

    def run():
        prob = netlib_shaped_problem(m, nv, dens, seed=seed)
        profiling.reset_stages()
        with records.capture() as recs:
            sol = prob.solve()
        return sol, recs, profiling.stages()

    (sol, recs, stages), wall, first = _timed(run)
    _check(sol._engine.certified is True, "not certified")
    events = [r.event for r in recs]
    _check(events == ["cold_solve_crossover"], f"route {events}")
    if backend == "gpu":
        _check(stages.get("crossover_pdhg_device_iters", 0) > 0,
               "the PDHG stage did not run on the card")
    return {"shape": f"{m}x{nv}", "route": f"{events[0]}@{recs[0].backend}",
            "wall_s": wall, "first_run_s": first, "stages": stages,
            "check": "certified (exact f64 primal + dual optimality)"}


def phase_gpu_tests() -> dict:
    """The `gpu`-marked tests, run by pytest inside this process."""
    import pytest

    os.environ["MINILP_TEST_DEVICE"] = "gpu"

    class Tally:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed += 1
            if report.failed:
                self.failed += 1

    tally = Tally()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests" / "test_gpu.py")], plugins=[tally])
    wall = time.perf_counter() - t0
    _check(rc == 0 and tally.failed == 0, f"pytest exit {rc}, "
           f"{tally.failed} failed")
    _check(tally.passed > 0, "no gpu test ran")
    return {"route": "pytest -m gpu tests/test_gpu.py", "wall_s": wall,
            "check": f"{tally.passed} passed, 0 failed"}


# ---------------------------------------------------------------------------
# Four GPUs
# ---------------------------------------------------------------------------

def _placement(arr, devices) -> str:
    """Check that `arr`'s shards sit one on each device; describe them."""
    on = arr.sharding.device_set
    _check(on == set(devices), f"shards on {sorted(d.id for d in on)}")
    # (the CPU backend of a virtual-device rehearsal reports no stats)
    used = [(d.memory_stats() or {"bytes_in_use": 1})["bytes_in_use"]
            for d in devices]
    _check(all(u > 0 for u in used), f"bytes in use per card {used}")
    return "shards on cards " + ",".join(str(d.id) for d in devices) + \
        " (MB in use " + ",".join(f"{u / 2**20:.0f}" for u in used) + ")"


def multi_batched(devices, batch: int = 4096, m: int = 32,
                  nv: int = 96) -> dict:
    """Data-parallel scenario batch over a 4×1 mesh vs one device."""
    import jax

    from minilp_tpu.options import SolverOptions
    from minilp_tpu.parallel.batched import (
        make_random_batch, solve_batch, solve_batch_sharded,
    )
    from minilp_tpu.parallel.mesh import make_mesh

    opts = SolverOptions(max_iter=2000)
    args = make_random_batch(jax.random.PRNGKey(5), batch, m, nv)
    one = solve_batch(*args, opts=opts)
    mesh = make_mesh(n_data=len(devices), n_model=1, devices=devices)
    (sh, wall, _first) = _timed(
        lambda: jax.block_until_ready(
            solve_batch_sharded(mesh, *args, opts=opts)))
    placed = _placement(sh.obj, devices)
    o1, o4 = np.asarray(one.obj), np.asarray(sh.obj)
    _check((np.asarray(one.status) == np.asarray(sh.status)).all(),
           "statuses differ")
    # each lane runs the same f64 program; the per-device executable may
    # pick other kernels for its smaller batch, so equal means to 1e-12
    diff = float(np.max(np.abs(o1 - o4) / (1.0 + np.abs(o1))))
    _check(diff <= 1e-12, f"per-lane objectives differ by up to {diff:.2e}")
    return {"route": "solve_batch_sharded 4x1", "wall_s": wall,
            "check": f"{batch} lane objectives equal to one device (max rel "
                     f"diff {diff:.1e} <= 1e-12); {placed}"}


def multi_pdhg(devices, shape=None, seed: int = 1) -> dict:
    """Row-sharded PDHG over a 1×4 mesh vs `solve_pdhg` on one device."""
    import jax
    import jax.numpy as jnp

    from minilp_tpu.canonical import canonicalize
    from minilp_tpu.engine.pdhg import solve_pdhg
    from minilp_tpu.options import SolverOptions
    from minilp_tpu.parallel.mesh import make_mesh
    from minilp_tpu.parallel.pdhg_sharded import solve_pdhg_sharded
    from minilp_tpu.status import Status
    from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem

    m, nv, dens = shape or NETLIB_SHAPES["maros-r7"]
    can = canonicalize(netlib_shaped_problem(m, nv, dens, seed=seed))
    opts = SolverOptions(engine="pdhg", feas_tol=1e-4, pdhg_max_iter=200_000)
    args = [jnp.asarray(v) for v in (can.A, can.b, can.c, can.lo, can.hi)]
    one = jax.block_until_ready(solve_pdhg(*args, opts=opts))
    mesh = make_mesh(n_data=1, n_model=len(devices), devices=devices)
    A4 = jax.device_put(args[0], jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("model", None)))
    (four, wall, _first) = _timed(lambda: jax.block_until_ready(
        solve_pdhg_sharded(A4, *args[1:], opts, mesh)))
    placed = _placement(A4, devices)
    n1, n4 = int(one.niter), int(four.niter)
    e1, e4 = float(one.err), float(four.err)
    obj1 = float(can.c @ np.asarray(one.x))
    obj4 = float(can.c @ np.asarray(four.x))
    # row-sharded partial sums change the summation order, so iterates agree
    # to rounding, not bitwise: a restart or the stop, decided by comparing
    # KKT errors, can move by a few check intervals
    tol_iters = max(2 * opts.pdhg_check_every, n1 // 20)
    _check(int(one.status) == int(four.status) == int(Status.OPTIMAL),
           f"status {int(one.status)} / {int(four.status)}")
    _check(abs(n1 - n4) <= tol_iters, f"iterations {n1} vs {n4}")
    _check(max(e1, e4) <= opts.feas_tol, f"KKT {e1:.2e} / {e4:.2e}")
    _check(_rel(obj4, obj1) <= 1e-4, f"objective {obj4} vs {obj1}")
    return {"route": "solve_pdhg_sharded 1x4", "shape": f"{m}x{nv}",
            "wall_s": wall,
            "check": f"iterations {n4} vs {n1} (within {tol_iters}), KKT "
                     f"{e4:.2e} vs {e1:.2e} <= {opts.feas_tol}; {placed}"}


def multi_simplex(devices, shape=None, seed: int = 1) -> dict:
    """Column-sharded simplex over a 1×4 mesh vs the one-device engine: the
    same pivot count and final basis (the determinism contract)."""
    import jax
    import jax.numpy as jnp

    from minilp_tpu.canonical import canonicalize
    from minilp_tpu.engine.driver import _solve_jit
    from minilp_tpu.options import SolverOptions
    from minilp_tpu.parallel.mesh import make_mesh
    from minilp_tpu.parallel.sharded_engine import solve_canonical_sharded
    from minilp_tpu.status import Status
    from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem

    m, nv, dens = shape or NETLIB_SHAPES["25fv47"]
    can = canonicalize(netlib_shaped_problem(m, nv, dens, seed=seed))
    opts = SolverOptions()
    args = [jnp.asarray(v) for v in (can.A, can.b, can.c, can.lo, can.hi,
                                     can.vstat0, can.basis0)]
    one = _solve_jit(*args, opts=opts)
    mesh = make_mesh(n_data=1, n_model=len(devices), devices=devices)
    (four, wall, _first) = _timed(lambda: jax.block_until_ready(
        solve_canonical_sharded(mesh, *args, opts)))
    placed = _placement(four["vstat"], devices)
    n1, n4 = int(one.niter), int(four["niter"])
    _check(int(one.status) == int(four["status"]) == int(Status.OPTIMAL),
           f"status {int(one.status)} / {int(four['status'])}")
    # The two programs agree pivot for pivot until a near-tie meets a
    # last-ulp difference (other fusions, a psum's summation order); at
    # this shape that happens after ~1.8k of ~7.7k pivots.  What must agree
    # is the optimal vertex: the same basic set, statuses and objective.
    same_pivots = (n1 == n4 and (np.asarray(one.basis)
                                 == np.asarray(four["basis"])).all())
    _check(set(np.asarray(one.basis).tolist())
           == set(np.asarray(four["basis"]).tolist()), "basic sets differ")
    _check((np.asarray(one.vstat) == np.asarray(four["vstat"])).all(),
           "final statuses differ")
    gap = _rel(float(four["obj"]), float(one.obj))
    _check(gap <= 1e-12, f"objective rel diff {gap:.1e}")
    return {"route": "solve_canonical_sharded 1x4", "shape": f"{m}x{nv}",
            "wall_s": wall,
            "check": f"same optimal basis set, statuses and objective (rel "
                     f"diff {gap:.1e}) as one device; pivots {n4} vs {n1} "
                     f"({'same sequence' if same_pivots else 'paths differ'})"
                     f"; {placed}"}


# ---------------------------------------------------------------------------

def _report(n, name: str, fn, *args) -> dict:
    out = fn(*args)
    extras = {k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in out.items() if k not in ("route", "check")}
    print(f"phase {n} {name}: route={out['route']} | "
          + " ".join(f"{k}={v}" for k, v in extras.items())
          + f" | check: {out['check']} -> PASS", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    chips = ap.parse_args(argv).chips

    _require_checkout()
    devices = _require_gpus(chips)

    import jax

    import minilp_tpu  # noqa: F401  (enables x64)
    from minilp_tpu.utils import compile_cache

    cache = compile_cache.configure(__file__)
    dev = devices[0]
    print(f"devices: {len(devices)} x {dev.platform} {dev.device_kind}; "
          f"compile cache {cache}", flush=True)
    if chips == 1:
        _report(1, "cold single LP (25fv47 shape)", phase_cold_single)
        _report(2, "warm branch-and-cut chain (512x2048 bucket)",
                phase_warm_chain)
        _report(3, "batched scenario pipeline", phase_batched)
        _report(4, "cold LP through the crossover (maros-r7 shape)",
                phase_crossover)
        _report(5, "gpu-marked tests", phase_gpu_tests)
    else:
        _report(1, "data-parallel scenario batch", multi_batched, devices)
        _report(2, "row-sharded PDHG (maros-r7 shape)", multi_pdhg, devices)
        _report(3, "column-sharded simplex (25fv47 shape)", multi_simplex,
                devices)
    print(f"card: {card_info()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
