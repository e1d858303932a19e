"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

Every kernel source (``kernels/<name>/csrc/<name>.cu``) has a plain C
interface and becomes one shared library, compiled for ``sm_90a`` at first
use under ``build/`` beside its kernel module (ignored by git) and cached
there by a hash of the source and the flags. Nothing here runs at import,
so the CPU tests import every kernel module without ``nvcc``. Each ``nvcc``
run is a ``kernels.nvcc`` span (``repro_torch.obs``): its registry count,
``span.kernels.nvcc.count``, is what a lattice run reports as its
``compile_delta``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import subprocess
import tempfile
import time
from pathlib import Path

from repro_torch.obs.spans import span

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path            # the shared library
    seconds: float        # nvcc wall time (0.0 when an earlier build was reused)
    ptxas: tuple          # the "ptxas info" and spill lines nvcc printed


def build_library(source: Path, flags: tuple = NVCC_FLAGS) -> BuildInfo:
    """Compile ``source`` into ``<kernel dir>/build/<hash>/lib<stem>.so``
    (once per source and flags) and return it."""
    from torch.utils.cpp_extension import CUDA_HOME  # needs no card to import

    source = Path(source)
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = source.parent.parent / "build" / tag / f"lib{source.stem}.so"
    if lib.exists():
        return BuildInfo(path=lib, seconds=0.0, ptxas=())
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    t0 = time.perf_counter()
    with span("kernels.nvcc", source=source.name):
        proc = subprocess.run([nvcc, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a torn file
    ptxas = tuple(
        line.strip() for line in (proc.stdout + proc.stderr).splitlines()
        if "ptxas info" in line or "spill" in line
    )
    return BuildInfo(path=lib, seconds=seconds, ptxas=ptxas)


def _demangle(names) -> list:
    """C++ names as ``cu++filt`` prints them, cut before the argument list
    (the mangled names where the toolkit has no ``cu++filt``)."""
    from torch.utils.cpp_extension import CUDA_HOME

    names = list(names)
    tool = os.path.join(CUDA_HOME or "", "bin", "cu++filt")
    if not names or not os.path.exists(tool):
        return names
    out = subprocess.run([tool, *names], capture_output=True, text=True).stdout.splitlines()
    if len(out) != len(names):
        return names
    cut = []
    for name in out:  # the argument list is the first "(" outside a template's <...>
        depth = 0
        for i, ch in enumerate(name):
            depth += {"<": 1, ">": -1}.get(ch, 0)
            if ch == "(" and depth == 0:
                name = name[:i]
                break
        cut.append(name)
    return cut


def ptxas_registers(info: BuildInfo) -> dict:
    """``{kernel: registers a thread}`` of each kernel (each template
    instance) that ptxas compiled, from its ``-v`` lines."""
    names, regs, current = [], [], None
    for line in info.ptxas:
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        used = re.search(r"Used (\d+) registers", line)
        if entry:
            current = entry.group(1)
        elif used and current is not None:
            names.append(current)
            regs.append(int(used.group(1)))
            current = None
    return dict(zip(_demangle(names), regs))


def sass_load_runs(library: Path) -> dict | None:
    """For each kernel of a built library, the most global loads of each
    kind (``LDG.E.64``, ...) that its SASS issues with no ``FFMA`` between
    them: how many loads a thread has in flight before it must consume one.
    None where the toolkit has no ``cuobjdump``."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    runs, name, run = {}, None, {}
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn:
            name, run = fn.group(1), {}
            runs[name] = {}
        elif name is not None and op:
            opcode = op.group(1)
            if opcode.startswith("FFMA"):
                run = {}
            elif opcode.startswith("LDG"):
                run[opcode] = run.get(opcode, 0) + 1
                runs[name][opcode] = max(runs[name].get(opcode, 0), run[opcode])
    return dict(zip(_demangle(runs), runs.values()))


def cp_async_aligned(x) -> bool:
    """Whether a kernel can copy tensor ``x`` 16 bytes at a time
    (``cp.async``): its start on a 16-byte boundary, every stride but the
    last (unit) one a multiple of 8 elements."""
    return x.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in x.stride()[:-1])


def load_library(info: BuildInfo, signatures: dict) -> ctypes.CDLL:
    """Load a built library and declare its C functions:
    ``{name: (argtypes, restype)}``. Pointers and the stream are
    ``ctypes.c_void_p``, so a 64-bit address is never cut to an int."""
    lib = ctypes.CDLL(str(info.path))
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib
