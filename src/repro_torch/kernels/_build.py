"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` becomes its own shared library with a plain C interface,
compiled for ``sm_90a`` at first use. All sources build at once, one ``nvcc``
each, into ``build/`` beside this file (listed in ``.gitignore``). A library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded.

Worker threads may make their first launches at once (the sketch service's
pool): one lock serializes the build and the load, so nvcc runs once per
source, and another guards the wrappers' launch counters.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points, by library
SIGNATURES = {
    "hadamard": {
        "hd_precondition_f32": (_P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P),
        "sketch_fused_f32": (_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P),
        "hd_precondition_chunked_f32": (_P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I, _P),
        "sketch_cluster_f32": (_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P),
        "hadamard_max_cluster": (),
    },
    "sparse_assign": {
        "sparse_assign_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    },
    "spmm": {
        "spmm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "spmm_t_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "transpose_columns_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
# held by build_all() and by library()'s first load (re-entered there)
_BUILD_LOCK = threading.RLock()
# guards every wrapper's ``launches`` count (and K4's ``by_shape``)
COUNT_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every library that is missing, all nvcc processes at once."""
    with _BUILD_LOCK:
        return _build_missing()


def _build_missing() -> dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SIGNATURES}
    todo = {name: path for name, path in targets.items() if not path.exists()}
    if not todo:
        return targets
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{report}")
            Path(tmp).unlink(missing_ok=True)
        else:
            todo[name].with_suffix(".ptxas.txt").write_text(report)
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return targets


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` output (registers, shared memory, spills) for
    library ``name``, saved beside it when it was built."""
    return build_all()[name].with_suffix(".ptxas.txt").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building every missing one first)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to a kernel wrapper's ``launches``, atomically across threads."""
    with COUNT_LOCK:
        wrapper.launches += n


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def require(t, dtype, ndim: int, what: str, device=None) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of this type and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device: read through
    torch's private ``_cuda_getCurrentRawStream`` where the build has it
    (checked on torch 2.11 for CUDA 12.8), which builds no ``torch.cuda.Stream``
    (a few microseconds a launch), else through the public
    ``torch.cuda.current_stream``."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(t.device).cuda_stream
    return raw(t.device.index)


def on_device(t):
    """A context that makes ``t``'s card the current one for a launch: nothing
    when it already is (the usual case, which then costs no device switch)."""
    import torch

    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


@functools.cache
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SMs of the card at ``device``, asked once."""
    import torch

    return _sm_count(torch.device(device).index or 0)
