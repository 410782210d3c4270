"""A cell of BENCHMARK.json: its configuration file, traffic mix and check
limits, found by name, and the modules that its configuration file names.

A configuration file (`configs/<config>.json`) names under "reference"
its plain reference, `reference/<name>.py`, and under "counts" its shape
counts, `counts/<name>.py`; `PARTS` lists what each module defines. A
piece that is not there, or a configuration or traffic mix that the
reference refuses, raises `Missing`, whose message is one line that
names it.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
CONFIGS = PACKAGE / "configs"
TRAFFIC = PACKAGE / "traffic"

# the keys of a configuration file that name a module of the harness (the
# module lies in the package of the key's name), and what it defines
PARTS = {"reference": ("ReferenceTrainer", "check_config",
                       "check_traffic"),
         "counts": ("step_flops", "b2_calls")}


class Missing(LookupError):
    """A piece that a cell needs and the tree does not hold, or a
    configuration that the cell's reference refuses."""


def shown(path: Path) -> str:
    """`path` as a message gives it: from the checkout's root if inside."""
    return str(path.relative_to(ROOT)) if path.is_relative_to(ROOT) \
        else str(path)


def _read(path: Path, what: str, cell: str) -> Dict[str, Any]:
    if not path.is_file():
        raise Missing(f"{cell}: no {what} {shown(path)}")
    with open(path) as f:
        return json.load(f)


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

    @property
    def config_file(self) -> Path:
        return CONFIGS / f"{self.config_name}.json"

    def part(self, key: str) -> ModuleType:
        """The module that the configuration file names under `key` (a
        key of PARTS): s2t_bench/<key>/<name>.py, imported."""
        config = shown(self.config_file)
        name = self.meta.get(key)
        if not isinstance(name, str) or not name.isidentifier():
            raise Missing(f"{self.name}: {config} names no {key} module "
                          f"(key {key!r})")
        spec = importlib.util.find_spec(f"{__package__}.{key}.{name}")
        if spec is None or spec.origin is None:
            raise Missing(f"{self.name}: no {key} module "
                          f"{shown(PACKAGE / key / f'{name}.py')}, "
                          f"which {config} names")
        path = Path(spec.origin)
        mod = importlib.import_module(spec.name)
        lacks = [a for a in PARTS[key] if not hasattr(mod, a)]
        if lacks:
            raise Missing(f"{self.name}: {shown(path)} defines no "
                          f"{', '.join(lacks)}")
        return mod

    def reference(self) -> ModuleType:
        """The reference module, once its `check_config` has taken this
        cell's training config and its `check_traffic` the cell's
        traffic mix: before any work on the card."""
        mod = self.part("reference")
        path = shown(Path(mod.__file__).resolve())
        for check, args, what in (
                (mod.check_config, (self.train_config,),
                 shown(self.config_file)),
                (mod.check_traffic, (self.train_config, self.traffic_spec),
                 shown(TRAFFIC / f"{self.traffic}.json"))):
            try:
                check(*args)
            except (ValueError, KeyError, TypeError) as e:
                raise Missing(f"{self.name}: {path} refuses {what}: "
                              f"{type(e).__name__}: {e}") from e
        return mod


def load_cell(name: str, benchmark: Optional[Path] = None) -> Cell:
    benchmark = benchmark or BENCHMARK
    with open(benchmark) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Missing(f"no workload {name!r} in {shown(benchmark)}")
    w = cells[name]
    meta = _read(CONFIGS / f"{w['config']}.json", "configuration file",
                 name)
    traffic = _read(TRAFFIC / f"{w['traffic']}.json", "traffic mix", name)
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), meta,
                traffic, bench["end_to_end"], bench["per_layer"])
