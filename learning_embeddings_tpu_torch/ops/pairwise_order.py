"""The all-pairs order energy E[i, j] = Σ_d max(0, u_id − v_jd)²: a
hand-written CUDA kernel for Hopper and its plain PyTorch version.

``pairwise_order`` replaces the Pallas kernel of the JAX package,
``learning_embeddings_tpu/geometry/pairwise.py::_pairwise_order_pallas``
(lines 60-87, body ``_order_kernel`` 46-57). The kernel's source, with the
note on what bounds it and how its design answers that, is
``learning_embeddings_tpu_torch/csrc/pairwise_order.cu``.

* On a CUDA tensor the wrapper launches the kernel, always: there is no
  fallback to the plain version on the card. It adds one to
  ``LAUNCHES`` where it launches, and nowhere else.
* On a CPU tensor it runs ``pairwise_order_plain``, the row-blocked
  broadcast of the JAX package's ``_pairwise_order_xla`` (lines 90-103).

Build: on the first CUDA call, ``nvcc -gencode arch=compute_90a,
code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC`` compiles the source
into ``<checkout>/.torch_kernels/cuda/pairwise_order-<hash>.so`` (the hash
is of the source and the flags; the directory is gitignored), with
``-Xptxas -v``'s report beside it as ``.log``. The library exports a plain
C function and is loaded with ``ctypes``; nothing is compiled or loaded
when the module is imported or on the CPU path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

__all__ = ["pairwise_order", "pairwise_order_plain", "build_library",
           "LAUNCHES"]

#: launches of the pairwise_order kernel since import (or the last reset)
LAUNCHES = 0

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "pairwise_order.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                          ".torch_kernels", "cuda")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: rows of u per broadcast block of the plain version (as in the JAX
#: package's _pairwise_order_xla)
_ROW_BLOCK = 128
#: grid.y (= ceil(M / 64)) is limited to 65535 blocks
_MAX_M = 65535 * 64

_LIB = None


def pairwise_order_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(M, N) f32 order energies of u (M, D) against v (N, D), computed by
    broadcasting blocks of 128 rows of u against all of v: O(128·N·D)
    temporary memory. Runs on any device; the port calls it for CPU
    tensors only."""
    u = u.float()
    v = v.float()
    out = torch.empty((u.shape[0], v.shape[0]), dtype=torch.float32,
                      device=u.device)
    for i in range(0, u.shape[0], _ROW_BLOCK):
        diff = torch.clamp_min(u[i:i + _ROW_BLOCK, None, :] - v[None], 0.0)
        out[i:i + _ROW_BLOCK] = (diff * diff).sum(-1)
    return out


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("pairwise_order: no CUDA toolkit (nvcc) found; "
                           "set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library() -> str:
    """Compile the kernel's source with nvcc if this source and these
    flags have no library yet; returns the library's path."""
    with open(_SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(_BUILD_DIR, f"pairwise_order-{key[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SOURCE],
                          capture_output=True, text=True)
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"pairwise_order: nvcc failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)   # atomic: a concurrent builder sees all or nothing
    return so


def _library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build_library())
        fn = lib.pairwise_order_f32
        # every pointer and the stream as c_void_p: ctypes would cut an
        # undeclared Python int to 32 bits
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(u: torch.Tensor, v: torch.Tensor):
    if u.ndim != 2 or v.ndim != 2 or u.shape[1] != v.shape[1]:
        raise ValueError(f"pairwise_order: expected u (M, D) and v (N, D), "
                         f"got {tuple(u.shape)} and {tuple(v.shape)}")
    if u.device != v.device:
        raise ValueError(f"pairwise_order: u on {u.device}, v on {v.device}")
    if not u.dtype.is_floating_point or not v.dtype.is_floating_point:
        raise ValueError(f"pairwise_order: unsupported dtypes {u.dtype}, "
                         f"{v.dtype}")


def pairwise_order(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(M, N) f32 matrix of E(u_i, v_j) = ‖max(0, u_i − v_j)‖². The inputs
    are cast to contiguous f32 first, as the JAX package does. CUDA
    tensors: the kernel; CPU tensors: the plain version."""
    global LAUNCHES
    _check(u, v)
    if u.device.type == "cpu":
        return pairwise_order_plain(u, v)
    if not u.is_cuda:
        raise ValueError(f"pairwise_order: no path for {u.device}")
    M, D = u.shape
    N = v.shape[0]
    if M > _MAX_M or N >= 2**31 or D >= 2**31:
        raise ValueError(f"pairwise_order: shape {(M, N, D)} exceeds the "
                         f"kernel's grid")
    u = u.to(torch.float32).contiguous()
    v = v.to(torch.float32).contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=u.device)
    if M == 0 or N == 0:
        return out
    lib = _library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.pairwise_order_f32(u.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), M, N, D, D, D, N,
                                     stream)
    if err != 0:
        raise RuntimeError(f"pairwise_order: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
