"""A cell of BENCHMARK.json: its configuration file, traffic mix and
check limits, found by name."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    meta: Dict[str, Any]          # the configuration file
    traffic_spec: Dict[str, Any]  # the traffic mix's file
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def train_config(self) -> Dict[str, Any]:
        return self.meta["train_config"]

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        """The metrics this cell reports in a run with or without trace."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool if self.name in m.get("workloads",
                                                      [self.name])]


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    with open(benchmark) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark}")
    w = cells[name]
    with open(PACKAGE / "configs" / f"{w['config']}.json") as f:
        meta = json.load(f)
    with open(PACKAGE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), meta,
                traffic, bench["end_to_end"], bench["per_layer"])
