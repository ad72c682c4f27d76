"""Weighted Z^2_m harmonic sums: the hand-written CUDA kernel, its build
and binding, and its plain PyTorch version.

    z2_harmonics(phases, weights, m) -> (2, m) tensor [c_1..c_m; s_1..s_m]
    c_k = sum_i w_i cos(2 pi k phi_i),  s_k = sum_i w_i sin(2 pi k phi_i)

The kernel (``pint_tpu_torch/csrc/z2_harmonics.cu``) replaces the Pallas
TPU kernel ``pint_tpu/ops/pallas_kernels.py:z2_harmonics_pallas``. Like
it, the kernel computes in float32 on float32-rounded inputs; it reads
float32 or float64 phases and weights as they are (rounding in
registers, no cast pass) and returns float64 sums, in one launch. The
result is bitwise the same for either input type and from launch to
launch. Phases are taken in turns and must lie within +-2^20 (beyond
that float32 keeps under 3 bits of a turn's fraction).

- On a CUDA tensor the wrapper launches the kernel, or raises. It never
  falls back to the plain version.
- On a CPU tensor it calls ``z2_harmonics_plain``, which computes in the
  input's dtype (the counterpart of pint_tpu.eventstats._z2_sums).

The kernel is compiled by ``nvcc`` for sm_90a into ``build/`` beside the
package on first use, keyed on a hash of its source, and loaded with
ctypes; ptxas's register and spill report is kept beside the library
(``ptxas_report``). Importing this module builds nothing.

Each launch registers the sums' analytic work (``cost``) with the
compile ledger under the key "z2_harmonics" (``obs.perf``), so
``obs.perf.roofline_block("z2_harmonics", wall)`` reads the work of the
latest launch's shape whatever implements it.
"""

from __future__ import annotations

import ctypes
import math
import re
from pathlib import Path
from typing import Optional

import torch

from pint_tpu_torch.ops import cuda_build

__all__ = ["z2_harmonics", "z2_harmonics_plain", "build", "ptxas_report",
           "launches", "cost"]

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "z2_harmonics.cu"
_BUILD_DIR = cuda_build.BUILD_DIR
_NVCC_FLAGS = cuda_build.FLAGS
_nvcc = cuda_build.nvcc
_THREADS = 256          # kThreads in the source
_PHOTONS_PER_STEP = 4   # kPhotons: photons a thread takes per loop step
_GROUP = 16             # kGroup: blocks whose partials are summed together
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

# ctypes signatures of the source's extern "C" functions
_PLAN_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
_LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

# number of kernel launches made through z2_harmonics (not the plain path)
launches = 0

_lib: Optional[ctypes.CDLL] = None
_sms: dict = {}       # device index -> SM count
_plans: dict = {}     # (device, m) -> (kc, chunks, max blocks)
# (device, stream) -> int32 ticket counters. The kernel's last block
# resets each counter to 0, and launches on one stream run in order, so
# a stream's counters are always 0 when its next launch starts.
_tickets: dict = {}


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


def cost(n: int, m: int, in_bytes: int) -> dict:
    """The sums' analytic work for ``n`` photons of ``in_bytes`` input
    bytes each (8: float32 phase and weight; 16: float64): each input
    read once and the (2, m) float64 result written once; a sine-cosine
    pair and 4 FMAs (8 flops) a harmonic and photon."""
    return {"flops": float(9 * m * n),
            "bytes_accessed": float(in_bytes * n + 16 * m)}


def build() -> Path:
    """Compile the kernel into build/ unless a library built from this
    exact source and these flags is already there. Returns its path."""
    return cuda_build.library(_SRC, "z2_harmonics")


def _by_instantiation(rep: dict) -> dict:
    out = {}
    for name, regs in rep.items():
        mk = re.search(r"z2_kernelI([fd])([fd])Li(\d+)E", name)
        if mk:
            out[(mk.group(1), mk.group(2), int(mk.group(3)))] = regs
    return out


def parse_ptxas(text: str) -> dict:
    """{(phi type, weight type, harmonics per block): {"regs", "spill_stores",
    "spill_loads"}} from ptxas -v output, types as "f" or "d"
    (``cuda_build.parse_ptxas``, keyed by instantiation)."""
    return _by_instantiation(cuda_build.parse_ptxas(text))


def ptxas_report() -> dict:
    """ptxas's registers and spills for every kernel instantiation of the
    current build (see parse_ptxas); builds first if needed."""
    return _by_instantiation(cuda_build.ptxas_report(_SRC, "z2_harmonics"))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.z2_harmonics_plan.restype = ctypes.c_int
        lib.z2_harmonics_plan.argtypes = _PLAN_ARGTYPES
        lib.z2_harmonics_launch.restype = ctypes.c_int
        lib.z2_harmonics_launch.argtypes = _LAUNCH_ARGTYPES
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
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"expected float32 or float64, got {t.dtype}")
    if isinstance(m, bool) or not isinstance(m, int) or m < 1:
        raise ValueError(f"m must be an integer >= 1, got {m!r}")


def _plan(lib, dev: int, m: int) -> tuple:
    """(harmonics per block, chunks, most blocks per chunk for one wave),
    cached per device and m; the same for every input type."""
    key = (dev, m)
    if key not in _plans:
        if dev not in _sms:
            _sms[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        kc, chunks, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        err = lib.z2_harmonics_plan(m, dev, ctypes.byref(kc),
                                    ctypes.byref(chunks),
                                    ctypes.byref(per_sm))
        if err != 0 or per_sm.value < 1:
            raise RuntimeError(f"z2_harmonics kernel cannot run: CUDA error "
                               f"{err}, {per_sm.value} blocks per SM")
        wave = -(-per_sm.value * _sms[dev] // chunks.value)
        _plans[key] = (kc.value, chunks.value, max(1, wave))
    return _plans[key]


def _ticket_counters(dev: torch.device, stream: int,
                     count: int) -> torch.Tensor:
    """At least `count` zeroed int32 ticket counters for launches on
    `stream`, allocated once and then grown as needed."""
    key = (dev.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 64), dtype=torch.int32, device=dev)
        _tickets[key] = t
    return t


def z2_harmonics(phases: torch.Tensor, weights: torch.Tensor,
                 m: int) -> torch.Tensor:
    """(2, m) sums [c; s]. CUDA tensors: the kernel, in float32 with
    float64 output, whichever of float32 and float64 the inputs are.
    CPU tensors: the plain version in the input dtype."""
    global launches
    _check(phases, weights, m)
    if phases.device.type == "cpu":
        return z2_harmonics_plain(phases, weights, m)
    phi = phases.contiguous()
    w = weights.contiguous()
    dev = phi.device  # a tensor's device always carries its index
    pcode, wcode = _DTYPE_CODE[phi.dtype], _DTYPE_CODE[w.dtype]
    lib = _load()
    kc, chunks, wave = _plan(lib, dev.index, m)
    n = phi.shape[0]
    steps = -(-n // _PHOTONS_PER_STEP)
    nblocks = max(1, min(-(-steps // _THREADS), wave))
    partials = torch.empty((chunks, nblocks, 2 * kc), dtype=torch.float64,
                           device=dev)
    out = torch.empty((2, m), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _ticket_counters(dev, stream,
                               chunks * (-(-nblocks // _GROUP) + 1))
    err = lib.z2_harmonics_launch(phi.data_ptr(), pcode, w.data_ptr(), wcode,
                                  n, m, partials.data_ptr(), nblocks,
                                  tickets.data_ptr(), out.data_ptr(),
                                  dev.index, stream)
    if err != 0:
        raise RuntimeError(f"z2_harmonics kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    from pint_tpu_torch.obs import perf

    perf.note_compile("z2_harmonics", backend=f"cuda:{dev.index}",
                      kind="hand_kernel",
                      **cost(n, m, phi.element_size() + w.element_size()))
    return out
