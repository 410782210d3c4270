"""No module of the harness loads JAX, and the reference loads nothing of
the program; the guard compares whole top-level names."""

import subprocess
import sys
import types

from s2t_bench.cell import ROOT
from s2t_bench.guard import jax_modules

IMPORT_ALL = """
import importlib, json, pkgutil, sys
import s2t_bench
names = [m.name for m in pkgutil.walk_packages(s2t_bench.__path__,
                                                "s2t_bench.")
         if ".tests" not in m.name and m.name != "s2t_bench.run"]
import s2t_bench.run
for n in names:
    importlib.import_module(n)
from s2t_bench.guard import jax_modules
print(json.dumps({"n": len(names), "jax": jax_modules()}))
"""

REFERENCE_ONLY = """
import json, sys
import s2t_bench.reference.step
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    import json
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    got = _run(IMPORT_ALL)
    assert got["n"] > 20 and got["jax"] == []


def test_reference_loads_nothing_of_the_program():
    top = _run(REFERENCE_ONLY)
    assert "speech2text_torch" not in top
    assert not set(top) & {"jax", "jaxlib", "flax", "speech2text_tpu"}


def test_guard_compares_whole_names(monkeypatch):
    fake = types.ModuleType("x")
    for name in ("speech2text_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert jax_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    monkeypatch.setitem(sys.modules, "speech2text_tpu.models", fake)
    assert jax_modules() == ["jax", "speech2text_tpu"]
