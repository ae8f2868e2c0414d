"""The all-pairs order energy E[i, j] = Σ_d max(0, u_id − v_jd)²: two
hand-written CUDA kernels for Hopper and their plain PyTorch version.

``pairwise_order`` replaces the Pallas kernel of the JAX package,
``learning_embeddings_tpu/geometry/pairwise.py::_pairwise_order_pallas``
(lines 60-87, body ``_order_kernel`` 46-57). The kernels' source, with the
note on what bounds them and how their design answers that, is
``learning_embeddings_tpu_torch/csrc/pairwise_order.cu``.

* On a CUDA tensor the wrapper launches a kernel, always: there is no
  fallback to the plain version on the card. The route follows from D
  alone (``route_for``):

  - ``"exact_d"`` for 1 ≤ D ≤ ``EXACT_D_MAX``: a kernel templated on D
    (the d-loop unrolled, u and v rows in registers), one warp per
    16 × 128 output tile on a persistent grid of min(tiles, k × SMs)
    blocks, k the blocks an SM holds (``launch_plan``, ``tile_walk``);
  - ``"generic"`` for any other D: a 64 × 64 tile per block with D
    streamed through shared memory; also callable on its own as
    ``pairwise_order_generic``.

  Each route counts its launches (``EXACT_D_LAUNCHES``,
  ``GENERIC_LAUNCHES``) and ``LAUNCHES`` counts both, where a kernel is
  launched and nowhere else.
* On a CPU tensor it runs ``pairwise_order_plain``, the row-blocked
  broadcast of the JAX package's ``_pairwise_order_xla`` (lines 90-103).

Build: on the first CUDA call, ``nvcc -gencode arch=compute_90a,
code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC`` compiles the source
into ``<checkout>/.torch_kernels/cuda/pairwise_order-<hash>.so`` (the hash
is of the source and the flags; the directory is gitignored), with
``-Xptxas -v``'s report beside it as ``.log``. The library exports plain C
functions and is loaded with ``ctypes``; nothing is compiled or loaded
when the module is imported or on the CPU path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import NamedTuple

import torch

__all__ = ["pairwise_order", "pairwise_order_generic",
           "pairwise_order_plain", "route_for", "launch_plan", "tile_walk",
           "device_plan", "exact_blocks_per_sm", "LaunchPlan",
           "build_library", "load_library", "EXACT_D_MAX", "LAUNCHES",
           "EXACT_D_LAUNCHES", "GENERIC_LAUNCHES"]

#: launches of either kernel since import (or the last reset)
LAUNCHES = 0
#: launches of the route "exact_d" kernel
EXACT_D_LAUNCHES = 0
#: launches of the route "generic" kernel
GENERIC_LAUNCHES = 0

#: the largest D with an instance of the "exact_d" kernel (kMaxExactD)
EXACT_D_MAX = 16
#: output tile of the "exact_d" kernel, one warp each (kTileRows, kTileCols)
EXACT_TILE = (16, 128)
#: output tile of the "generic" kernel, one 256-thread block each (kTile)
GENERIC_TILE = (64, 64)
#: CUDA's limit on grid.y, which the generic grid spends on M
_GRID_Y_MAX = 65535
#: M, N and D are passed to the kernels as C ints
_INT_MAX = 2**31 - 1

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "pairwise_order.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                          ".torch_kernels", "cuda")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: rows of u per broadcast block of the plain version (as in the JAX
#: package's _pairwise_order_xla)
_ROW_BLOCK = 128

_LIB = None
#: (library, device index, D) → blocks of the "exact_d" kernel an SM holds
_BLOCKS_PER_SM: dict = {}


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


# --------------------------------------------------------------------------
# the launch plan (pure Python: a CPU test checks it)
# --------------------------------------------------------------------------
class LaunchPlan(NamedTuple):
    route: str            # "exact_d" or "generic"
    tile: tuple           # (rows, columns) of one output tile
    tiles_m: int
    tiles_n: int
    grid: tuple           # (x, y) blocks


def route_for(D: int) -> str:
    """The kernel a CUDA call with this D runs: "exact_d" for
    1 ≤ D ≤ EXACT_D_MAX, "generic" for any other D."""
    return "exact_d" if 1 <= D <= EXACT_D_MAX else "generic"


def launch_plan(M: int, N: int, D: int, sms: int = 132,
                blocks_per_sm: int = 1,
                route: str | None = None) -> LaunchPlan:
    """Tiles and grid of a call on (M, N, D) through `route` (by default
    ``route_for(D)``), with `sms` SMs that hold `blocks_per_sm` blocks of
    the "exact_d" kernel each. Raises ValueError where a kernel cannot
    take the shape: M, N or D past a C int, or, on the generic route, more
    than 65535 row tiles (grid.y). The exact_d grid is at most
    blocks_per_sm × sms, so it sets no limit of its own; its tile index is
    a 64-bit integer."""
    if M < 1 or N < 1:
        raise ValueError(f"pairwise_order: no launch for an empty output "
                         f"{(M, N)}")
    if max(M, N, D) > _INT_MAX:
        raise ValueError(f"pairwise_order: shape {(M, N, D)} exceeds the "
                         f"kernels' int range")
    route = route or route_for(D)
    if route == "exact_d" and route_for(D) != "exact_d":
        raise ValueError(f"pairwise_order: no exact_d instance for D = {D}")
    tile = EXACT_TILE if route == "exact_d" else GENERIC_TILE
    tiles_m, tiles_n = -(-M // tile[0]), -(-N // tile[1])
    if route == "exact_d":
        if blocks_per_sm < 1 or sms < 1:
            raise ValueError(f"pairwise_order: {blocks_per_sm} blocks a SM "
                             f"on {sms} SMs")
        grid = (min(tiles_m * tiles_n, blocks_per_sm * sms), 1)
    else:
        if tiles_m > _GRID_Y_MAX:
            raise ValueError(f"pairwise_order: shape {(M, N, D)} exceeds the "
                             f"generic kernel's grid (M ≤ "
                             f"{_GRID_Y_MAX * tile[0]})")
        grid = (tiles_n, tiles_m)
    return LaunchPlan(route, tile, tiles_m, tiles_n, grid)


def tile_walk(plan: LaunchPlan):
    """Yields (block, rows, columns) for every output tile in the order the
    plan's kernel takes them, rows and columns as the tile's full ranges
    (the kernel masks the part past M and N). The exact_d route's block b
    takes the tiles b, b + grid, … in row-major order; the generic route's
    block (x, y) takes the tile (y, x)."""
    (tr, tc), gx = plan.tile, plan.grid[0]
    if plan.route == "exact_d":
        for b in range(gx):
            for t in range(b, plan.tiles_m * plan.tiles_n, gx):
                i0, j0 = (t // plan.tiles_n) * tr, (t % plan.tiles_n) * tc
                yield b, range(i0, i0 + tr), range(j0, j0 + tc)
    else:
        for y in range(plan.grid[1]):
            for x in range(gx):
                yield ((x, y), range(y * tr, (y + 1) * tr),
                       range(x * tc, (x + 1) * tc))


# --------------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------------
def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("pairwise_order: no CUDA toolkit (nvcc) found; "
                           "set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library(source: str = _SOURCE) -> str:
    """Compile the kernels' source (or another copy of it, such as the
    variants of ``k3_variants.py``) with nvcc if this source and these
    flags have no library yet; returns the library's path."""
    with open(source, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = os.path.join(_BUILD_DIR, f"pairwise_order-{key[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, source],
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
        _LIB = load_library(build_library())
    return _LIB


def load_library(path: str):
    """Loads a library built from the kernels' source and declares its
    functions' arguments."""
    lib = ctypes.CDLL(path)
    # every pointer and the stream as c_void_p: ctypes would cut an
    # undeclared Python int to 32 bits
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pairwise_order_exact_f32.argtypes = [p, p, p, i, i, i, i, ll, i, p]
    lib.pairwise_order_generic_f32.argtypes = [p, p, p, i, i, i, ll, ll, ll,
                                               p]
    lib.pairwise_order_exact_blocks_per_sm.argtypes = [i]
    for fn in (lib.pairwise_order_exact_f32,
               lib.pairwise_order_generic_f32,
               lib.pairwise_order_exact_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


def exact_blocks_per_sm(D: int, device="cuda") -> int:
    """Blocks of the exact_d kernel at this D that one SM of `device`
    holds at once (CUDA's occupancy query, at the instance's register
    count); cached."""
    lib = _library()
    device = torch.device(device)
    key = (lib._handle, device.index, D)
    if key not in _BLOCKS_PER_SM:
        with torch.cuda.device(device):
            n = lib.pairwise_order_exact_blocks_per_sm(D)
        if n < 1:
            raise RuntimeError(f"pairwise_order: occupancy query for D = {D} "
                               f"failed (CUDA error {-n})")
        _BLOCKS_PER_SM[key] = n
    return _BLOCKS_PER_SM[key]


def device_plan(M: int, N: int, D: int, device="cuda",
                route: str | None = None) -> LaunchPlan:
    """The launch plan of a call on a CUDA `device`: ``launch_plan`` with
    the device's SM count and the exact_d kernel's occupancy there."""
    route = route or route_for(D)
    if route == "generic":
        return launch_plan(M, N, D, route="generic")
    device = torch.device(device)
    return launch_plan(M, N, D, torch.cuda.get_device_properties(device)
                       .multi_processor_count,
                       exact_blocks_per_sm(D, device), route)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------
def _check(u: torch.Tensor, v: torch.Tensor):
    if u.ndim != 2 or v.ndim != 2 or u.shape[1] != v.shape[1]:
        raise ValueError(f"pairwise_order: expected u (M, D) and v (N, D), "
                         f"got {tuple(u.shape)} and {tuple(v.shape)}")
    if u.device != v.device:
        raise ValueError(f"pairwise_order: u on {u.device}, v on {v.device}")
    if not u.dtype.is_floating_point or not v.dtype.is_floating_point:
        raise ValueError(f"pairwise_order: unsupported dtypes {u.dtype}, "
                         f"{v.dtype}")


def _f32_aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous f32 with a 16-byte aligned start (the exact_d kernel's
    float4 and float2 loads need it; a fresh allocation has it)."""
    x = x.to(torch.float32).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(u: torch.Tensor, v: torch.Tensor, route: str) -> torch.Tensor:
    """Runs the kernel of `route` on CUDA tensors; (M, N) f32 out."""
    global LAUNCHES, EXACT_D_LAUNCHES, GENERIC_LAUNCHES
    if not u.is_cuda:
        raise ValueError(f"pairwise_order: no path for {u.device}")
    M, D = u.shape
    N = v.shape[0]
    u, v = _f32_aligned(u), _f32_aligned(v)
    out = torch.empty((M, N), dtype=torch.float32, device=u.device)
    if M == 0 or N == 0:
        return out
    lib = _library()
    plan = device_plan(M, N, D, u.device, route)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        if route == "exact_d":
            err = lib.pairwise_order_exact_f32(
                u.data_ptr(), v.data_ptr(), out.data_ptr(), M, N, D,
                plan.tiles_n, plan.tiles_m * plan.tiles_n, plan.grid[0],
                stream)
        else:
            err = lib.pairwise_order_generic_f32(
                u.data_ptr(), v.data_ptr(), out.data_ptr(), M, N, D, D, D,
                N, stream)
    if err != 0:
        raise RuntimeError(f"pairwise_order: {route} kernel launch failed "
                           f"with CUDA error {err}")
    LAUNCHES += 1
    if route == "exact_d":
        EXACT_D_LAUNCHES += 1
    else:
        GENERIC_LAUNCHES += 1
    return out


def pairwise_order(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(M, N) f32 matrix of E(u_i, v_j) = ‖max(0, u_i − v_j)‖². The inputs
    are cast to contiguous f32 first, as the JAX package does. CUDA
    tensors: the kernel of ``route_for(D)``; CPU tensors: the plain
    version."""
    _check(u, v)
    if u.device.type == "cpu":
        return pairwise_order_plain(u, v)
    return _launch(u, v, route_for(u.shape[1]))


def pairwise_order_generic(u: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """``pairwise_order`` through the generic kernel at any D (CUDA
    tensors only): the route for D outside 1..EXACT_D_MAX, callable at a
    small D to time it against the exact_d kernel."""
    _check(u, v)
    return _launch(u, v, "generic")
