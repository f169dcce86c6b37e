"""Build the port's CUDA sources into plain-C shared libraries and load them.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` into ``build/<name>-<hash>.so``, where the hash
covers the source, every header in ``csrc`` (``*.cuh``) and the flags; a
library whose file exists is not rebuilt. The libraries are loaded with ``ctypes``: their C
functions take raw device pointers and the CUDA stream and return
``cudaGetLastError()`` after the launch.

Nothing here runs at import time: the first kernel launch on a CUDA tensor
calls :func:`library`, which builds what is missing.

Host code has a second route: :func:`host_library` compiles a ``csrc/*.cc``
file with ``g++ -O3 -shared`` (linking zlib and
pthread) into ``build/<name>-<hash>.so`` at its first use, also to a
temporary name renamed into place, so that processes building it at once
(parallel test workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

__all__ = [
    "BUILD_DIR",
    "KERNEL_DTYPES",
    "SOURCES",
    "build_all",
    "check_cuda_input",
    "compiler_log",
    "cuda_input_ok",
    "host_library",
    "library",
    "nvcc_path",
    "require",
    "require_no_grad",
    "stream_ptr",
]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("psel_conv", "dec_conv1", "phase_pool", "d2s", "histeq", "wconv", "conv_block", "conv3x3")
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signatures: every pointer and the stream are c_void_p (a plain int
# argument would be cut to 32 bits), every size is c_int.
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "psel_conv": {"mgu_psel_conv3x3": [_P, _P, _P, _P] + [_I] * 9 + [_P],
                  "mgu_psel_conv3x3_halo": [_P] * 6 + [_I] * 9 + [_P]},
    "dec_conv1": {"mgu_dec_conv1": [_P] * 6 + [_I] * 15 + [_P],
                  "mgu_dec_conv1_halo": [_P] * 10 + [_I] * 17 + [_P]},
    "phase_pool": {"mgu_phase_max_pool": [_P, _P] + [_I] * 5 + [_P]},
    "d2s": {"mgu_depth_to_space": [_P, _P] + [_I] * 4 + [_P]},
    "histeq": {"mgu_histeq": [_P, _P, _I, _I, _P]},
    "wconv": {"mgu_wconv3x3_wgmma": [_P] * 4 + [_I] * 8 + [_P, _I, _I, _P],
              "mgu_wconv3x3_simt": [_P] * 4 + [_I] * 7 + [_P, _I, _P]},
    "conv_block": {"mgu_conv_block": [_P] * 7 + [_I] * 7 + [_P]},
    "conv3x3": {"mgu_conv3x3": [_P] * 4 + [_I] * 6 + [_P]},
}

# Host libraries (g++): name → C signatures.
_HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_HOST_LIBS = ("-lz", "-lpthread")
_S = ctypes.c_char_p
_HOST_SIGNATURES = {
    "decode": {"mgu_load_image": [_S, _I, _I, _P], "mgu_load_mask": [_S, _I, _I, _P],
               "mgu_load_batch": [_P, _P, _I, _I, _I, _P, _P, _I, _I],
               "mgu_decode": [_S, _I, _P, _P], "mgu_free": [_P],
               "mgu_resize_nearest": [_P, _I, _I, _I, _P, _I, _I],
               "mgu_resize_linear_u8": [_P, _I, _I, _I, _P, _I, _I]},
    "raster": {"mgu_fill_convex_poly": [_P, _I, _I, _I, _P, _I, _S, _I],
               "mgu_fill_poly": [_P, _I, _I, _I, _P, _P, _I, _S, _I],
               "mgu_polylines": [_P, _I, _I, _I, _P, _P, _I, _I, _S, _I]},
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, float]:
    """Compile every missing library, all ``nvcc`` processes at once.
    Returns seconds per library built (empty when all were present); each
    compiler log (register and shared-memory use) is kept beside its .so."""
    with _lock:
        missing = [n for n in SOURCES if not _target(n).exists()]
        if not missing:
            return {}
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        t0 = time.perf_counter()
        for name in missing:
            out = _target(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "w")
            cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
        seconds = {}
        failed = []
        for name, (proc, tmp, out, log) in jobs.items():
            rc = proc.wait()
            log.close()
            seconds[name] = time.perf_counter() - t0
            if rc == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{name} (rc {rc}): {out.with_suffix('.log').read_text()[-2000:]}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (one of :data:`SOURCES`), built if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _target(name)
    if not path.exists():
        build_all()
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def _host_target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cc").read_bytes())
    h.update(" ".join(_HOST_FLAGS + _HOST_LIBS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _build_host(name: str, out: Path) -> None:
    """Compile ``csrc/<name>.cc`` into ``out`` through a file of this
    process's own, renamed into place; raises ``RuntimeError`` with the
    compiler's first error line."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the host library {name!r} cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *_HOST_FLAGS, str(CSRC / f"{name}.cc"), *_HOST_LIBS, "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = (proc.stderr or proc.stdout).splitlines()
        first = next((ln for ln in lines if "error" in ln), lines[0] if lines else f"rc {proc.returncode}")
        raise RuntimeError(f"g++ failed to build {name!r}: {first.strip()}")
    os.replace(tmp, out)


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``csrc/<name>.cc``), compiled at
    its first use; raises ``RuntimeError`` when it cannot be
    built or loaded."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            path = _host_target(name)
            if not path.exists():
                _build_host(name, path)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load the host library {path}: {e}") from e
            for fn_name, argtypes in _HOST_SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def compiler_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` output of the current build of ``name``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


# Launch helpers shared by the kernel wrappers.

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel without a backward must not run where autograd records: its
    output would carry no ``grad_fn`` and every parameter upstream would get
    no gradient, silently."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} has no backward: call it under torch.no_grad() (inference)")


def cuda_input_ok(t: torch.Tensor, dtype: torch.dtype, ndim: int = 4) -> bool:
    """Whether ``t`` is what the kernels take (see :func:`check_cuda_input`),
    without building a message: the launch paths' fast check."""
    return t.is_cuda and t.dtype == dtype and t.dim() == ndim and t.is_contiguous() and t.data_ptr() % 16 == 0


def check_cuda_input(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int = 4) -> None:
    """Raise ``ValueError`` naming what is wrong unless ``t`` is a CUDA
    tensor of ``dtype`` with ``ndim`` dimensions, contiguous and 16-byte
    aligned; the message is built only when it fails."""
    if cuda_input_ok(t, dtype, ndim):
        return
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    require(t.dim() == ndim, f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous (NHWC), got strides {t.stride()}")
    require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


# The current stream's raw handle in one call where this build of PyTorch
# has it (CUDA builds), else through the public Stream object.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_ptr(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream
