"""Weighted Z^2_m harmonic sums: the hand-written CUDA kernel, its build
and binding, and its plain PyTorch version.

    z2_harmonics(phases, weights, m) -> (2, m) tensor [c_1..c_m; s_1..s_m]
    c_k = sum_i w_i cos(2 pi k phi_i),  s_k = sum_i w_i sin(2 pi k phi_i)

The kernel (``pint_tpu_torch/csrc/z2_harmonics.cu``) replaces the Pallas
TPU kernel ``pint_tpu/ops/pallas_kernels.py:z2_harmonics_pallas``. It
takes float32 phases and weights, as the Pallas kernel did; the wrapper
makes that cast and returns float64 sums.

- On a CUDA tensor the wrapper launches the kernel, or raises. It never
  falls back to the plain version.
- On a CPU tensor it calls ``z2_harmonics_plain``, which computes in the
  input's dtype (the counterpart of pint_tpu.eventstats._z2_sums).

The kernel is compiled by ``nvcc`` for sm_90a into ``build/`` beside the
package on first use, keyed on a hash of its source, and loaded with
ctypes. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

__all__ = ["z2_harmonics", "z2_harmonics_plain", "build", "launches"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "z2_harmonics.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_THREADS = 256          # kThreads in the source
_BLOCKS_PER_SM = 4      # grid cap: enough blocks in flight to fill the card

# number of kernel launches made through z2_harmonics (not the plain path)
launches = 0

_lib: Optional[ctypes.CDLL] = None


def z2_harmonics_plain(phases: torch.Tensor, weights: torch.Tensor,
                       m: int) -> torch.Tensor:
    """(2, m) weighted trig sums in the inputs' dtype, on their device:
    the (m, N) angle matrix written out, as pint_tpu.eventstats._z2_sums
    does."""
    two_pi_phi = 2.0 * math.pi * phases
    ks = torch.arange(1, m + 1, dtype=phases.dtype, device=phases.device)
    ang = ks[:, None] * two_pi_phi[None, :]          # (m, N)
    c = torch.sum(weights[None, :] * torch.cos(ang), dim=1)
    s = torch.sum(weights[None, :] * torch.sin(ang), dim=1)
    return torch.stack([c, s])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the z2_harmonics kernel cannot be "
                       "built (put the CUDA toolkit's bin/ on PATH)")


def build() -> Path:
    """Compile the kernel into build/ unless a library built from this
    exact source and these flags is already there. Returns its path."""
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = _BUILD_DIR / f"z2_harmonics-{key[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic against a concurrent build
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.z2_harmonics_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(phases: torch.Tensor, weights: torch.Tensor, m) -> None:
    if not (isinstance(phases, torch.Tensor)
            and isinstance(weights, torch.Tensor)):
        raise TypeError("phases and weights must be torch tensors")
    if phases.device != weights.device:
        raise ValueError(f"phases on {phases.device}, weights on "
                         f"{weights.device}")
    if phases.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {phases.device}")
    if phases.dim() != 1 or weights.shape != phases.shape:
        raise ValueError(f"phases {tuple(phases.shape)} and weights "
                         f"{tuple(weights.shape)} must be equal 1-D shapes")
    for t in (phases, weights):
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"expected float32 or float64, got {t.dtype}")
    if isinstance(m, bool) or not isinstance(m, int) or m < 1:
        raise ValueError(f"m must be an integer >= 1, got {m!r}")


def z2_harmonics(phases: torch.Tensor, weights: torch.Tensor,
                 m: int) -> torch.Tensor:
    """(2, m) sums [c; s]. CUDA tensors: the kernel, in float32 with
    float64 output. CPU tensors: the plain version in the input dtype."""
    global launches
    _check(phases, weights, m)
    if phases.device.type == "cpu":
        return z2_harmonics_plain(phases, weights, m)
    phi = phases.to(torch.float32).contiguous()
    w = weights.to(torch.float32).contiguous()
    n = phi.shape[0]
    dev = phi.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = max(1, min(-(-n // _THREADS), _BLOCKS_PER_SM * sms))
    partials = torch.empty((nblocks, 2, m), dtype=torch.float32, device=dev)
    out = torch.empty((2, m), dtype=torch.float64, device=dev)
    lib = _load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.z2_harmonics_launch(phi.data_ptr(), w.data_ptr(), n, m,
                                  partials.data_ptr(), nblocks,
                                  out.data_ptr(), dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"z2_harmonics kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
