"""ONNX deployment export of the port (port of speech2text_tpu/onnx/),
with no `onnx`, `onnxruntime` or `protobuf` dependency:

- proto.py    — the ONNX protobuf writer and reader
- convert.py  — `torch.export` program → ONNX graph (opset 17)
- run.py      — numpy evaluator of the emitted graphs
- quantize.py — the dynamic-int8 MatMul/Gather rewrite

`speech2text_torch.export.export_onnx_modules` writes a transducer's
encoder / predictor / joiner trio (and the streaming encoder graph) with
them.
"""

from .convert import convert
from .quantize import quantize_dynamic
from .run import OnnxRunner

__all__ = ["convert", "quantize_dynamic", "OnnxRunner"]
