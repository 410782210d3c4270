"""The task types of a training config's `task.type` that the port
trains and decodes (port of speech2text_tpu/tasks/__init__.py:
TaskFactory): `Pruned_Rnnt` and `CTC`. The JAX package's other types
(Rnnt, CTC_Hybrid_Rnnt, CIF, SSL, NNLM) raise NotImplementedError."""

from __future__ import annotations

from .ctc import CtcTask
from .rnnt import PrunedRnntTask

TASKS = {"Pruned_Rnnt": PrunedRnntTask, "CTC": CtcTask}


def TaskFactory(task_type: str):
    if task_type not in TASKS:
        raise NotImplementedError(f"task {task_type!r} is not ported "
                                  f"({', '.join(TASKS)})")
    return TASKS[task_type]
