"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. At first use it is compiled
with nvcc for Hopper (sm_90a) into `build/lib<name>-<hash>.so` at the root of
the checkout and loaded with ctypes. The hash is of the source and of the
headers in csrc/ (`*.cuh`), so an edited kernel or header is rebuilt and a
stale library is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[str, object] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, temp output, final path),
    or None when the library and its compiler log are already built."""
    out = library_path(name)
    if out.exists() and out.with_suffix(".log").exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one nvcc each, all
    started together. Returns every named library's compiler log (ptxas
    register, spill and shared-memory report), kept beside the library as
    lib<name>-<hash>.log; raises with the log on a failed build."""
    jobs = {n: _start_build(n) for n in names}
    logs = {}
    for name, job in jobs.items():
        if job is None:
            logs[name] = library_path(name).with_suffix(".log").read_text()
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def function(name: str, entry: str, n_ptr: int, n_int: int, n_float: int, n_int_after: int = 0):
    """The C entry point `entry` of csrc/<name>.cu, typed as n_ptr pointers,
    n_int ints, n_float floats, n_int_after ints and the stream, returning a
    cudaError_t."""
    fn = _functions.get(entry)
    if fn is None:
        fn = getattr(load(name), entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_int] * n_int_after
                       + [ctypes.c_void_p])
        _functions[entry] = fn
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of a CUDA device, read once."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_device(x) -> Tuple[int, int]:
    """(SM count, current stream handle) of CUDA tensor x's card: what a
    launch plans for and launches on. The handle comes from torch's raw
    getter where the build has it (torch.cuda.current_stream() builds a
    Stream object, ~7 µs a call on the card's host), else from that object."""
    import torch

    index = x.get_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    stream = raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream
    return sm_count(index), stream


def sass_op_counts(path) -> Dict[str, Dict[str, int]]:
    """Instruction counts per kernel in the SASS of a built library
    (`cuobjdump -sass`, from nvcc's toolkit): {mangled kernel name: {opcode
    with its modifiers, e.g. "HFMA2.BF16_V2": count}}. Shows what ptxas
    made of the source, such as a product and a sum fused into one fma."""
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], check=True, capture_output=True,
                          text=True).stdout
    counts: Dict[str, Dict[str, int]] = {}
    ops = None
    for line in sass.splitlines():
        if "Function : " in line:
            ops = counts.setdefault(line.split("Function : ", 1)[1].strip(), {})
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and ops is not None:
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return counts


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
