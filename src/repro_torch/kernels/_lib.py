"""Build, load and launch the CUDA kernels under ``csrc/``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded through ``ctypes``.
Every ``.cu`` file compiles in its own ``nvcc`` process, all started
together, and one more call links them. The library's file name carries
a hash of the sources and flags, so an edited source is rebuilt and
concurrent builds never see a half-written file. Nothing here runs at
import time: this module imports on machines without a compiler or card.

Each launcher takes raw pointers, integers and PyTorch's current stream,
and returns ``cudaGetLastError()``; :func:`launch` raises on a nonzero
code and counts the launch. A library that cannot be built or loaded
raises :class:`LibraryError`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
SOURCES = ("shard_spmm.cu", "fused_gnn.cu", "dense_engine.cu",
           "seg_gather.cu", "flash_attention.cu", "flash_attention_tc.cu",
           "errors.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the launchers (C symbol = name + "_launch") and their argument kinds:
# "p" a pointer (tensor or None), "i" a C int, "f" a C float
KERNELS = {
    "shard_spmm": "ppppppiiiiii",
    "fused_gnn": "ppppppppiiiiiiii",
    "dense_engine": "pppppiiii",
    "seg_gather": "ppppiiiii",
    "flash_attention": "ppppiiiiiifiii",
    "flash_attention_tc": "ppppiiiiiifii",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_launches = dict.fromkeys(KERNELS, 0)


class LibraryError(RuntimeError):
    """The kernel library could not be built or loaded: a fault of the
    installation, not of any one call."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise LibraryError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the library if this source set has not been built yet;
    returns its path. The compiler's ``-Xptxas -v`` report (registers,
    shared memory and spills per kernel) is kept beside it for
    :func:`build_log`."""
    so = _library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (src + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise LibraryError(f"nvcc failed for {failed}:\n" + "".join(logs))
        tmp_so = pathlib.Path(tmp) / "lib.so"
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise LibraryError(f"nvcc link failed:\n{link.stdout}")
        so.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp_so, so)
    return so


def _library_path() -> pathlib.Path:
    return BUILD_DIR / f"libgnnkernels-{_digest()}.so"


def build_log() -> str:
    """The compiler's report for the current sources ('' before a build)."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                handle = ctypes.CDLL(str(build()))
            except OSError as err:
                raise LibraryError(f"cannot load the kernel library: "
                                   f"{err}") from err
            for name, kinds in KERNELS.items():
                fn = getattr(handle, name + "_launch")
                fn.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            handle.gnnk_error_string.argtypes = [ctypes.c_int]
            handle.gnnk_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU (the wrapper then runs the
    plain version); False if every one lies on a CUDA device. Mixed
    devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: "
                     f"{sorted(str(t.device) for t in tensors)}")


def check(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
          ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``ndim``."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {ndim}-d {dtype} "
            f"tensor, got {tuple(t.shape)} {t.dtype} "
            f"(contiguous={t.is_contiguous()})")


def launch(kernel: str, *args, device: torch.device) -> None:
    """Call ``<kernel>_launch`` on ``device``'s current stream; raise if
    the launch was refused, else count it."""
    kinds = KERNELS[kernel]
    if len(args) != len(kinds):
        raise TypeError(f"{kernel}: expected {len(kinds)} arguments")
    c_args = []
    for kind, a in zip(kinds, args):
        if kind == "p":
            c_args.append(None if a is None else a.data_ptr())
        elif kind == "f":
            c_args.append(float(a))
        else:
            c_args.append(int(a))
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(handle, kernel + "_launch")(*c_args, stream)
    if rc != 0:
        msg = handle.gnnk_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: launch failed: CUDA error {rc} ({msg})")
    with _lock:
        _launches[kernel] += 1


def launches() -> dict[str, int]:
    """Kernel launches counted since the last :func:`reset_launches`."""
    with _lock:
        return dict(_launches)


def reset_launches() -> None:
    with _lock:
        for k in _launches:
            _launches[k] = 0
