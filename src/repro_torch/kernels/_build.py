"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Libraries are
named by a hash of their source and flags, so an edited source is never
served from a stale build; they live in ``kernels/.cuda_build/`` (listed
in ``.gitignore``).  Nothing builds at import time: the first wrapper
call of a kernel builds it, or ``build()`` builds them all at once, one
``nvcc`` process per source, started together.

A missing ``nvcc`` or a failed compile raises: there is no fallback to
the plain versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".cuda_build"
SOURCES = ("paged_attention", "rmsnorm", "sedov_stencil")
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# flags of one source only: the stencil rounds every operation once, as
# its plain version's separate PyTorch ops do (no a*b+c contracted to FMA)
SOURCE_FLAGS = {"sedov_stencil": ("-fmad=false",)}
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def flags(name: str) -> tuple[str, ...]:
    """The ``nvcc`` flags source ``name`` is compiled with."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def source_sha256(name: str) -> str:
    return hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(flags(name)).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns ``{name: compiler log}`` for the
    sources compiled now (the ``-Xptxas=-v`` register/shared-memory
    report); raises with the compiler's output if any compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))   # atomic: no torn library
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library of kernel ``name``, built first if it is not yet (each
    wrapper loads its library once and keeps it)."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def stream_of(t: torch.Tensor) -> int:
    """Handle of the stream a kernel on ``t`` launches on: the current
    stream of the current device, which must be ``t``'s."""
    if t.device.index is not None and \
            t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {t.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream
