"""The task types of a training config's `task.type` that the port
trains and decodes (port of speech2text_tpu/tasks/__init__.py:
TaskFactory): all seven of the JAX package's, `Pruned_Rnnt`, `Rnnt`,
`CTC_Hybrid_Rnnt`, `CTC`, `CIF`, `SSL` and `NNLM`; any other raises
ValueError."""

from __future__ import annotations

from .cif import CifTask
from .ctc import CtcTask
from .nnlm import NnLmTask
from .rnnt import CtcHybridRnntTask, PrunedRnntTask, RnntTask
from .ssl import SslTask

TASKS = {"Pruned_Rnnt": PrunedRnntTask, "Rnnt": RnntTask,
         "CTC_Hybrid_Rnnt": CtcHybridRnntTask, "CTC": CtcTask,
         "CIF": CifTask, "SSL": SslTask, "NNLM": NnLmTask}


def TaskFactory(task_type: str):
    if task_type not in TASKS:
        raise ValueError(f"unknown task {task_type!r} ({', '.join(TASKS)})")
    return TASKS[task_type]
