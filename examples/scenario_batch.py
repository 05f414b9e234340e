#!/usr/bin/env python
"""Batched scenario solving — thousands of independent LPs per launch.

Demonstrates the certified batched entry point (BASELINE config 3):
`solve_batch_certified` runs the route `routes.batched_route` picks (on an
NVIDIA GPU the one-LP-per-program Triton kernel, elsewhere the vmapped f32
engine), certifies every lane's basis exactly in host f64, and re-solves
the rare uncertified lane with scipy-HiGHS.

Run: python examples/scenario_batch.py [batch] [m] [nv]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from minilp_tpu import routes
from minilp_tpu.parallel.batched import (
    make_random_batch_host, solve_batch_certified,
)
from minilp_tpu.status import Status


def main(batch: int = 512, m: int = 16, nv: int = 24) -> None:
    A, b, c, lo, hi = make_random_batch_host(0, batch, m, nv)
    route = routes.batched_route(m, m + nv)

    t0 = time.time()
    res = solve_batch_certified(A, b, c, lo, hi)
    dt = time.time() - t0
    print(
        f"{route} route: {batch} LPs in {dt:.3f}s "
        f"({batch / dt:.0f} LPs/s incl. compile), "
        f"{int((~res.host_resolved).sum())}/{batch} certified by the device "
        f"route, mean iters {float(np.asarray(res.niter).mean()):.1f}"
    )
    n_opt = int((np.asarray(res.status) == int(Status.OPTIMAL)).sum())
    print(f"{n_opt}/{batch} optimal; example objectives: "
          f"{np.asarray(res.obj)[:4].round(6).tolist()}")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    main(*args)
