"""Structured per-solve records (SURVEY.md §6.5).

The reference's observability is `log` crate debug lines in the solver loop
(iteration counts, objective progress, refactorization events — SURVEY.md
§6.1).  This build's equivalent is a structured record per solve — engine,
route (`event`), shapes, status, iterations, wall-clock, backend — emitted as
one JSON line to the file named by `MINILP_TPU_LOG` (or stderr with
`MINILP_TPU_LOG=-`), and to every active `capture()` list.  Disabled (zero
overhead beyond a getenv) when neither is on.  These records are exactly the
rows the BASELINE.md measurement protocol consumes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Optional


@dataclasses.dataclass
class SolveRecord:
    event: str            # "cold_solve" | "dual_resolve" | "primal_resolve" | "pdhg_solve"
    engine: str
    status: str
    rows: int             # active constraints m
    cols: int             # structural variables nv
    padded_rows: int
    padded_cols: int
    iterations: int
    objective: Optional[float]
    wall_s: float
    backend: str
    dtype: str
    #: free-form event payload (e.g. the scaling-harness numbers)
    extra: Optional[dict] = None

    def iters_per_sec(self) -> float:
        return self.iterations / self.wall_s if self.wall_s > 0 else 0.0


_captures: list[list] = []


def enabled() -> bool:
    return bool(_captures) or bool(os.environ.get("MINILP_TPU_LOG"))


@contextlib.contextmanager
def capture():
    """Collect the records emitted inside the block into a list:

        with records.capture() as recs:
            prob.solve()
        recs[-1].event, recs[-1].backend
    """
    recs: list = []
    _captures.append(recs)
    try:
        yield recs
    finally:
        _captures.remove(recs)


def emit(record: SolveRecord) -> None:
    for recs in _captures:
        recs.append(record)
    if not os.environ.get("MINILP_TPU_LOG"):
        return
    payload = dataclasses.asdict(record)
    payload["iters_per_sec"] = round(record.iters_per_sec(), 2)
    line = json.dumps(payload)
    target = os.environ["MINILP_TPU_LOG"]
    if target == "-":
        print(line, file=sys.stderr)
    else:
        with open(target, "a") as f:
            f.write(line + "\n")


class timed:
    """Context manager measuring wall-clock for a solve event."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self.t0
        return False
