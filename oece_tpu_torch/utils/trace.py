"""Structured tracing / observability for circuit evaluation.

Role parity+: the reference instruments ``Clock`` with wall-clock macros and
prints manager/execution time and an efficiency percentage
(src/circuit.cpp:533-570), plus live ``\\r`` progress lines (815-816).  This
module keeps those human-readable outputs (runtime/evaluator.py) and adds
what the reference lacks: machine-readable per-level records with gate
counts and bootstraps/sec, dumpable as JSON for regression tracking.

The port's own copy of ``oece_tpu.utils.trace``, kept in step with it
(tests/test_torch_copies.py): the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional


@dataclasses.dataclass
class LevelRecord:
    level: int
    boot_gates: int      # bootstrap gates in the level (pre-batch)
    linear_gates: int
    batch: int           # test-case batch T
    wall_s: float
    bootstraps: int      # actual bootstraps run (incl. compound-XOR rewrites)

    @property
    def boots_per_sec(self) -> float:
        return self.bootstraps / self.wall_s if self.wall_s > 0 else 0.0


@dataclasses.dataclass
class Trace:
    """One Clock() invocation's trace."""

    circuit: str
    mode: str            # 'plaintext' | 'encrypted' | 'verify'
    records: List[LevelRecord] = dataclasses.field(default_factory=list)
    t_start: float = 0.0
    total_s: float = 0.0

    def begin(self) -> None:
        self.t_start = time.time()

    def end(self) -> None:
        self.total_s = time.time() - self.t_start

    def add(self, rec: LevelRecord) -> None:
        self.records.append(rec)

    @property
    def total_bootstraps(self) -> int:
        return sum(r.bootstraps for r in self.records)

    @property
    def boots_per_sec(self) -> float:
        return self.total_bootstraps / self.total_s if self.total_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "circuit": self.circuit,
            "mode": self.mode,
            "levels": len(self.records),
            "total_s": round(self.total_s, 4),
            "total_bootstraps": self.total_bootstraps,
            "bootstraps_per_sec": round(self.boots_per_sec, 1),
            "max_level_wall_s": round(
                max((r.wall_s for r in self.records), default=0.0), 4
            ),
        }

    def dump_json(self, path: Optional[str] = None) -> str:
        doc = {
            "summary": self.summary(),
            "levels": [dataclasses.asdict(r) for r in self.records],
        }
        s = json.dumps(doc, indent=1)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s
