"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under speech2text_torch/csrc/ with a plain C
interface. At first use, `nvcc -gencode arch=compute_90a,code=sm_90a`
compiles every source into its own shared library under `build/kernels/`
at the repo root (listed in .gitignore), one `nvcc` process per source,
all started together. The library's file name carries a hash of its
source, so an edited source is rebuilt. Libraries are loaded with ctypes.

Dispatch rule for every wrapper (`use_kernel`): a CPU tensor takes the
kernel's plain PyTorch version; a CUDA tensor launches the kernel or
raises. Nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]


def use_kernel(device: torch.device) -> bool:
    """True where a wrapper must launch its CUDA kernel, False where it
    takes the plain version; raises for any other device."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {device}")


DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


def find_nvcc() -> str:
    """$NVCC, else $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the CUDA
    toolkit's default location."""
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (os.environ.get("NVCC"),
                 os.path.join(cuda_home, "bin", "nvcc") if cuda_home
                 else None,
                 shutil.which("nvcc"), DEFAULT_NVCC):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or CUDA_HOME)")


class CudaKernel:
    """One kernel source, its built library, and its launch count.

    `entries` maps each exported C function to its ctypes argument types;
    they are bound once, when the library is loaded, and every such
    function returns an int (a cudaError_t). `launches` is a plain integer
    that the kernel's wrapper increments once per successful launch and
    nowhere else."""

    def __init__(self, name: str, source: str,
                 entries: Optional[Dict[str, Sequence]] = None):
        self.name = name
        self.source = PACKAGE_DIR / "csrc" / source
        self.entries = dict(entries or {})
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def library_path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
            self._lib = ctypes.CDLL(str(self.library_path))
            err = self._lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            for fname, argtypes in self.entries.items():
                fn = getattr(self._lib, fname)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
        return self._lib

    def entry(self, fname: str):
        """The bound C function `fname` (argument types set at load)."""
        return getattr(self.lib(), fname)

    def check(self, rc: int) -> None:
        """Raise on a non-zero cudaError_t returned by a launch; count the
        launch otherwise."""
        if rc != 0:
            msg = self.lib().kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"CUDA error {rc} ({msg})")
        self.launches += 1


def build(kernels: List[CudaKernel]) -> None:
    """Compile every kernel whose library is missing, one nvcc process per
    source, all in parallel."""
    todo = [k for k in kernels if not k.library_path.exists()]
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in todo:
        tmp = k.library_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        procs.append((k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for k, tmp, proc in procs:
        out, _ = proc.communicate()
        k.build_log = out
        if proc.returncode != 0:
            failed.append(f"{k.name} ({k.source}):\n{out}")
        else:
            os.replace(tmp, k.library_path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def on_device(device: torch.device):
    """A context that makes `device` current, entered only where it is not
    current already (the entry points pass tensors of one card)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def ready(t: torch.Tensor, device: torch.device,
          dtype: torch.dtype) -> torch.Tensor:
    """`t` as the kernels take it: on `device`, in `dtype`, contiguous and
    16-byte aligned; copied only where it is not so already."""
    if t.device != device or t.dtype != dtype:
        t = t.to(device=device, dtype=dtype)
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()
