"""The task types of a training config's `task.type` that the port
trains and decodes (port of speech2text_tpu/tasks/__init__.py:
TaskFactory): `Pruned_Rnnt`, `Rnnt`, `CTC_Hybrid_Rnnt` and `CTC`. The
JAX package's other types (CIF, SSL, NNLM) raise NotImplementedError."""

from __future__ import annotations

from .ctc import CtcTask
from .rnnt import CtcHybridRnntTask, PrunedRnntTask, RnntTask

TASKS = {"Pruned_Rnnt": PrunedRnntTask, "Rnnt": RnntTask,
         "CTC_Hybrid_Rnnt": CtcHybridRnntTask, "CTC": CtcTask}


def TaskFactory(task_type: str):
    if task_type not in TASKS:
        raise NotImplementedError(f"task {task_type!r} is not ported "
                                  f"({', '.join(TASKS)})")
    return TASKS[task_type]
