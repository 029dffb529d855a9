"""Build the CUDA sources under ``csrc/`` with plain ``nvcc`` and load them.

Every ``csrc/*.cu`` file has a plain C interface (no PyTorch headers), so
each compiles in seconds.  The sources compile in parallel, one ``nvcc`` per
file, and link into one shared library for ``sm_90a``, which ``ctypes``
loads.  The build happens at first use, into ``stylesinger_torch/_build/``
(listed in ``.gitignore``); the file name carries a hash of the sources and
flags, so an edited source is rebuilt and a fresh checkout builds itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, List, Optional

from stylesinger_torch.utils import profiling

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
PTXAS_VERBOSE = ["-Xptxas", "-v"]  # registers, shared memory, spills


class _Library:
    """The loaded shared library and what its build cost."""

    def __init__(self) -> None:
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None  # None: loaded, not built
        self.ptxas_log = ""  # what ``-Xptxas -v`` printed for each kernel


_LIBRARY = _Library()


def find_nvcc() -> str:
    """``nvcc`` from PyTorch's ``CUDA_HOME`` or from ``PATH``; raises if
    neither has one."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (neither under CUDA_HOME nor on "
                       "PATH): the CUDA kernels cannot be built")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Runs the commands in parallel; returns their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failures, outputs = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outputs.append(out)
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{out}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return "".join(outputs)


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    target = BUILD_DIR / f"libstylesinger_kernels_{_digest()}.so"
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{time.monotonic_ns()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources()]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, *PTXAS_VERBOSE, "-c", str(src),
                         "-o", str(obj)]
                        for src, obj in zip(sources(), objs)])
        tmp = BUILD_DIR / f"lib_{tag}.so"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
                   str(tmp)]])
        os.replace(tmp, target)  # atomic: concurrent builders agree
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    _LIBRARY.build_seconds = time.perf_counter() - t0
    _LIBRARY.ptxas_log = log
    return target


def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    if _LIBRARY.lib is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _LIBRARY.lib = lib
    return _LIBRARY.lib


def build_seconds() -> Optional[float]:
    """Seconds the last build in this process took (None: none ran)."""
    return _LIBRARY.build_seconds


def ptxas_report() -> List[str]:
    """One line per compiled kernel from the last build in this process:
    its name, registers, shared memory and spill bytes (empty: none ran)."""
    lines, name = [], None
    for raw in _LIBRARY.ptxas_log.splitlines():
        line = raw.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ss_mel_spectrogram.argtypes = [p, i, p, p, p, p, i, i, i, i, f, p]
    lib.ss_mel_spectrogram.restype = i
    lib.ss_mrf_step.argtypes = [p] * 8 + [i] * 10 + [f, p]
    lib.ss_mrf_step.restype = i
    lib.ss_mrf_step_bf16.argtypes = [p] * 8 + [i] * 11 + [f, p]
    lib.ss_mrf_step_bf16.restype = i
    lib.ss_mrf_occupancy.argtypes = [i, i, i, i, p, p]
    lib.ss_mrf_occupancy.restype = i
    lib.ss_diffnet_layer.argtypes = [p] * 7 + [i] * 5 + [f, p]
    lib.ss_diffnet_layer.restype = i


def check(status: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def refuse_autograd(name: str, tensors: Iterable) -> None:
    """Raise when autograd is recording and one of ``tensors`` requires
    grad: a kernel has no backward, so its output would carry no graph and
    the gradient would be lost without an error."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call "
                           "it under torch.no_grad(), or take the "
                           "differentiable path for a loss")


class LaunchCounter:
    """Counts the launches of one kernel in the counter ``name`` of
    ``utils/profiling.py``'s registry (compare runs are excluded by
    resetting before the run of interest).  A launch that a CUDA graph
    capture records counts once; a replay runs it without the wrapper and
    does not count (``registry()["graphs"]`` holds the replays')."""

    def __init__(self, name: str) -> None:
        self.name = name

    @property
    def count(self) -> int:
        return profiling.counter(self.name)

    def add(self) -> None:
        profiling.count(self.name)

    def reset(self) -> None:
        profiling.set_counter(self.name, 0)
