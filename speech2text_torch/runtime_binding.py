"""ctypes binding to the repo's C++ lexicon CTC beam decoder (runtime/),
the port's own copy of speech2text_tpu/runtime_binding.py.

The library is built by the port at first use: `g++ -O2 -std=c++17
-fPIC -I runtime -c` over runtime/asr_rt/capi.cc and the three
runtime/asr_rt/decoding/{ngram_lm,lexicon_trie,ctc_beam_decoder}.cc, one
process per source, all started together, then `g++ -shared` links them
into build/runtime/ at the repo root (listed in .gitignore), once per process
and under a file lock, so concurrent processes never load a half-written
file. The library's name carries a hash of its sources, so an edited
source is rebuilt. A missing g++ or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
RUNTIME_DIR = REPO_ROOT / "runtime"
BUILD_DIR = REPO_ROOT / "build" / "runtime"
SOURCES = ("asr_rt/capi.cc", "asr_rt/decoding/ngram_lm.cc",
           "asr_rt/decoding/lexicon_trie.cc",
           "asr_rt/decoding/ctc_beam_decoder.cc")
HEADERS = ("asr_rt/decoding/ngram_lm.h", "asr_rt/decoding/lexicon_trie.h",
           "asr_rt/decoding/ctc_beam_decoder.h")
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC"]
MAX_WORDS = 512

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha1()
    for rel in SOURCES + HEADERS:
        digest.update((RUNTIME_DIR / rel).read_bytes())
    return BUILD_DIR / f"libasr_rt_c-{digest.hexdigest()[:12]}.so"


def build_library() -> Path:
    """The library's path, compiled first where it is missing."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError("g++ not found: the C++ decoding runtime "
                               "cannot be built (set CXX)")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        objs = [tmp.with_suffix(f".{i}.o") for i in range(len(SOURCES))]
        procs = [subprocess.Popen(
            [cxx, *CXX_FLAGS, "-I", str(RUNTIME_DIR), "-c", "-o", str(o),
             str(RUNTIME_DIR / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for src, o in zip(SOURCES, objs)]
        logs = [(p, p.communicate()[0]) for p in procs]
        if all(p.returncode == 0 for p, _ in logs):
            link = subprocess.run([cxx, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True,
                                  text=True)
            logs.append((link, link.stdout + link.stderr))
        for o in objs:
            o.unlink(missing_ok=True)
        failed = [out for p, out in logs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"building {path.name} failed:\n"
                               + "\n".join(failed))
        os.replace(tmp, path)
    return path


def load_library() -> ctypes.CDLL:
    """The built library with its C signatures bound (built at first
    use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.s2t_decoder_create.restype = ctypes.c_void_p
        lib.s2t_decoder_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int]
        lib.s2t_decoder_add_word.restype = ctypes.c_int
        lib.s2t_decoder_add_word.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_float]
        lib.s2t_decoder_finalize.argtypes = [ctypes.c_void_p]
        lib.s2t_decoder_decode.restype = ctypes.c_int
        lib.s2t_decoder_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.s2t_decoder_word.restype = ctypes.c_char_p
        lib.s2t_decoder_word.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.s2t_decoder_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


class CtcLexiconBeamDecoding:
    """Lexicon-constrained CTC beam decoding by the C++ runtime.

    lexicon: {word: [token ids]}, each word spelled in the acoustic
    model's tokens; arpa_path: an optional n-gram LM over the lexicon's
    words. `decode` takes (B, T, V) log-probs (a tensor on any device, or
    an array; copied to the host as contiguous f32) and lengths, and
    returns one text per row."""

    def __init__(self, lexicon: Dict[str, Sequence[int]],
                 arpa_path: Optional[str] = None, beam_size: int = 16,
                 beam_size_token: int = 8, lm_weight: float = 1.0,
                 word_score: float = 0.0, blank: int = 0):
        self._lib = load_library()
        self._h = self._lib.s2t_decoder_create(
            (arpa_path or "").encode(), beam_size, beam_size_token,
            lm_weight, word_score, blank)
        if not self._h:
            raise RuntimeError(f"failed to load the ARPA LM {arpa_path}")
        for word, spelling in lexicon.items():
            arr = (ctypes.c_int * len(spelling))(*spelling)
            self._lib.s2t_decoder_add_word(self._h, word.encode(), arr,
                                           len(spelling), 0.0)
        self._lib.s2t_decoder_finalize(self._h)

    def decode(self, log_probs, lengths) -> List[str]:
        if hasattr(log_probs, "detach"):
            log_probs = log_probs.detach().float().cpu().numpy()
            lengths = lengths.detach().cpu().numpy()
        lp = np.ascontiguousarray(log_probs, np.float32)
        lens = np.asarray(lengths)
        if lp.ndim != 3 or lens.shape != lp.shape[:1] or \
                not ((lens >= 0) & (lens <= lp.shape[1])).all():
            raise ValueError(f"log-probs {lp.shape} and lengths {lens} "
                             f"disagree")
        buf = (ctypes.c_int * MAX_WORDS)()
        out: List[str] = []
        for b in range(lp.shape[0]):
            ptr = lp[b].ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            n = self._lib.s2t_decoder_decode(self._h, ptr, int(lens[b]),
                                             lp.shape[2], buf, MAX_WORDS)
            out.append(" ".join(
                self._lib.s2t_decoder_word(self._h, buf[i]).decode()
                for i in range(max(n, 0))))
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.s2t_decoder_destroy(self._h)
            self._h = None
