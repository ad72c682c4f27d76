"""Walker log-likelihoods of the unbinned photon-template likelihood over a
template of wrapped Gaussians: the hand-written CUDA kernel, its build and
binding, and its plain PyTorch version of the same algorithm.

    photon_lnlike(Inputs(photons, spin, gauss), tl) -> (W,) float64
    log L_w = sum_i log(w_i f(phi_i(w)) + 1 - w_i)

``Inputs`` checks and packs once what every walker batch shares (the
photons' columns, the spin terms and the template's constants); a call
checks only ``tl``.

For each walker w (a row of ``tl``) and photon i:

1. the spin phase: Horner in double-double over the spin terms
   F_j / (j + 1)! at the photon's delay-corrected time since PEPOCH, the
   walker's F_j being (``spin.hi[j]``, the walker's low word
   ``tl[w, spin.col[j]]``, or ``spin.lo[j]`` for a frozen term), as
   ``ops/taylor.dd_taylor_horner`` evaluates Spindown's phase; plus the
   photon's other phase (``photons.other_*``, the dd sum of the model's
   other phase components, where there is one); less the TZR row's phase
   under the same terms, where ``spin.tzr`` gives that row;
2. the fraction of a turn: ``ops/dd.dd_frac``'s rule, hi + lo, then
   ``torch.remainder(., 1)``;
3. the template f = bg + sum_k amp_k sum_{n=-3..3} exp(c_k (phi - loc_k +
   n)^2) (``Gaussians``, each location in (-1/2, 3/2); ``gaussians`` forms
   them from a template's parameters): every image of
   every Gaussian, from three exps a Gaussian (``_images``: the nearest
   image's, and the ratios out from it, by the exact identity
   exp(c (e + 1)^2) = exp(c e^2) exp(c (2 e + 1)));
4. log(w f + 1 - w), or log f for unweighted photons (``weights`` None);
5. the sum over photons in two stages: a partial a block of
   ``THREADS * PHOTONS`` photons, then a pass over the partials.

- On CUDA tensors the wrapper launches the kernel
  (``pint_tpu_torch/csrc/photon_lnlike.cu``: one pass over the photons
  for the whole batch, then a pass over the partials; deterministic, no
  atomics), or raises. It never falls back to the plain version.
- On CPU tensors it calls ``photon_lnlike_plain``: the same steps with
  ``ops/dd.py``'s functions on (W, N) tensors, each stage's sum in
  torch's own order.

The kernel replaces no Pallas kernel: the JAX package leaves this
likelihood to XLA. It is compiled by ``nvcc`` for sm_90a into ``build/``
beside the package on first use, keyed on a hash of its source, and
loaded with ctypes; ptxas's register and spill report is kept beside the
library (``ptxas_report``). Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import math
from decimal import Decimal, localcontext
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import torch

from pint_tpu_torch.ops import cuda_build
from pint_tpu_torch.ops.dd import DD, dd_add, dd_div_f, dd_frac, dd_mul, \
    dd_sub

__all__ = ["Photons", "Spin", "Gaussians", "gaussians", "Inputs",
           "photon_lnlike", "photon_lnlike_plain", "nblocks", "build",
           "ptxas_report", "launches", "THREADS", "PHOTONS", "MAX_WALKERS",
           "MAX_TERMS", "MAX_PEAKS"]

THREADS = 256           # kThreads in the source
PHOTONS = 2             # kPhotons: photons a thread holds
MAX_WALKERS = 64        # kMaxWalkers: walkers a launch
MAX_TERMS = 16          # kMaxTerms: spin terms F0 .. F15
MAX_PEAKS = 8           # kMaxPeaks: Gaussians of the template
IMAGES = 3              # kImages: images n = -3..3
REACH = IMAGES + 1      # kReach: images j = -4..4 about the nearest
_PI_40 = Decimal("3.141592653589793238462643383279502884197")
_SRC = Path(__file__).resolve().parent.parent / "csrc" / "photon_lnlike.cu"
_NVCC_FLAGS = cuda_build.FLAGS

_PD = ctypes.POINTER(ctypes.c_double)
_PI = ctypes.POINTER(ctypes.c_int)
# ctypes signature of the source's extern "C" function
_LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _PD, _PD,
                    _PI, ctypes.c_int, _PD, _PD, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p]

# number of host calls into the kernel (each launches the pass over the
# photons and the pass over the partials; not the plain path)
launches = 0

_lib: Optional[ctypes.CDLL] = None


class Photons(NamedTuple):
    """The photons' columns, float64 (N,) tensors on one device:
    Spindown's delay-corrected time since PEPOCH [s] as a double-double;
    the dd sum of the model's other phase components [turns], or None
    where they add nothing; the weights, or None for unweighted
    photons."""

    dt_hi: torch.Tensor
    dt_lo: torch.Tensor
    other_hi: Optional[torch.Tensor] = None
    other_lo: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None


class Spin(NamedTuple):
    """The spin terms F0..F_{n-1}: each term's high word, its low word
    where it is frozen (0.0 where free), and its column of ``tl`` (-1
    where frozen); ``tzr``, the TZR row's (dt hi, dt lo, other hi, other
    lo), or None where the phase is not referenced to one."""

    hi: Sequence[float]
    lo: Sequence[float]
    col: Sequence[int]
    tzr: Optional[Sequence[float]] = None


class Gaussians(NamedTuple):
    """The template: the background, and for each Gaussian k its
    amplitude norm_k / (width_k sqrt(2 pi)), location (in (-1/2, 3/2))
    and exponent scale c_k = -1 / (2 width_k^2)."""

    bg: float
    amp: Sequence[float]
    loc: Sequence[float]
    c: Sequence[float]


def gaussians(theta: Sequence[float], m: int) -> Gaussians:
    """The constants of a template of ``m`` Gaussians from ``LCTemplate``'s
    flat parameters (m + 1 logits, m locations, m log widths), as
    ``LCTemplate._pdf_fn`` forms them (the norms the softmax of the
    logits), each evaluated in 40-digit decimal arithmetic and rounded to
    float64 once. Rounding each step in float64 instead shifts every
    photon's density the same way, by ~1e-16 relative: ~1.7e-10 nats over
    2^20 photons."""
    with localcontext() as ctx:
        ctx.prec = 40
        t = [Decimal(float(v)) for v in theta]
        e = [v.exp() for v in t[:m + 1]]
        total = sum(e)
        widths = [v.exp() for v in t[2 * m + 1:3 * m + 1]]
        root = (2 * _PI_40).sqrt()
        return Gaussians(
            float(e[0] / total),
            [float(e[k + 1] / (total * wd * root))
             for k, wd in enumerate(widths)],
            [float(v) for v in t[m + 1:2 * m + 1]],
            [float(-1 / (2 * wd * wd)) for wd in widths])


def nblocks(n: int) -> int:
    """Blocks of the pass over ``n`` photons (one partial a walker each)."""
    return max(1, -(-int(n) // (THREADS * PHOTONS)))


def _check_shared(ph: Photons, spin: Spin, gauss: Gaussians) -> None:
    cols = [c for c in ph if c is not None]
    for t in cols:
        if not isinstance(t, torch.Tensor):
            raise TypeError("the photons' columns must be tensors")
        if t.dtype != torch.float64:
            raise TypeError(f"expected float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the photons' columns must be contiguous")
    dev = ph.dt_hi.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if any(c.device != dev for c in cols):
        raise ValueError("the photons' columns must share a device")
    n = ph.dt_hi.shape[0] if ph.dt_hi.dim() == 1 else -1
    if n < 0 or any(c.shape != (n,) for c in cols):
        raise ValueError("the photons' columns must be equal 1-D shapes")
    if n >= 2 ** 31:
        raise ValueError(f"{n} photons: at most 2^31 - 1")
    if (ph.other_hi is None) != (ph.other_lo is None):
        raise ValueError("other_hi and other_lo go together")
    nt = len(spin.hi)
    if not 1 <= nt <= MAX_TERMS or len(spin.lo) != nt or \
            len(spin.col) != nt:
        raise ValueError(f"1 to {MAX_TERMS} spin terms, each with hi, lo "
                         "and col")
    if any(c < -1 for c in spin.col):
        raise ValueError(f"spin columns {list(spin.col)}: -1 or a column")
    if spin.tzr is not None and len(spin.tzr) != 4:
        raise ValueError("tzr is (dt hi, dt lo, other hi, other lo)")
    k = len(gauss.amp)
    if not 1 <= k <= MAX_PEAKS or len(gauss.loc) != k or len(gauss.c) != k:
        raise ValueError(f"1 to {MAX_PEAKS} Gaussians, each with amp, loc "
                         "and c")
    if not all(-0.5 < loc < 1.5 for loc in gauss.loc):
        raise ValueError(f"locations {list(gauss.loc)} outside (-1/2, 3/2)")


def _check_tl(inputs: "Inputs", tl) -> None:
    if not isinstance(tl, torch.Tensor):
        raise TypeError("tl must be a tensor")
    if tl.dtype != torch.float64:
        raise TypeError(f"expected float64, got {tl.dtype}")
    if not tl.is_contiguous():
        raise ValueError("tl must be contiguous")
    if tl.device != inputs.device:
        raise ValueError(f"tl on {tl.device}, the photons on "
                         f"{inputs.device}")
    if tl.dim() != 2 or not 1 <= tl.shape[0] <= MAX_WALKERS:
        raise ValueError(f"tl must be (W, nfree), 1 <= W <= {MAX_WALKERS}, "
                         f"got {tuple(tl.shape)}")
    if tl.shape[1] <= inputs.max_col:
        raise ValueError(f"spin columns {list(inputs.spin.col)} outside "
                         f"tl's {tl.shape[1]}")


def _steps(c: float) -> list:
    """q_j = exp(2 c j), j = 0..REACH-1: the factors of the steps out
    from the nearest image."""
    return [math.exp(2.0 * c * j) for j in range(REACH)]


def _images(d: torch.Tensor, c: float) -> torch.Tensor:
    """sum_{n=-3..3} exp(c (d + n)^2), as the kernel's images() forms it:
    the nearest image n0 = round(-d) (e0 = d + n0 in [-1/2, 1/2]) by an
    exp, each image further out from its inner neighbour times
    exp(c (2 e0 + 1)) q_j going up, exp(c (1 - 2 e0)) q_j going down,
    then the images n = -3..3 (n0 is -1, 0 or 1) summed in order."""
    q = _steps(c)
    n0 = torch.round(-d)
    e0 = d + n0
    c2e0 = (c + c) * e0
    up = torch.exp(c2e0 + c)
    down = torch.exp(c - c2e0)
    g = {0: torch.exp((e0 * e0) * c)}
    g[1], g[-1] = g[0] * up, g[0] * down
    for j in range(2, REACH + 1):
        g[j] = g[j - 1] * (up * q[j - 1])
        g[-j] = g[-j + 1] * (down * q[j - 1])
    s = torch.zeros_like(d)
    for n in range(-IMAGES, IMAGES + 1):
        s = s + torch.where(n0 < 0, g[n + 1],
                            torch.where(n0 > 0, g[n - 1], g[n]))
    return s


def _coefficients(tl, spin: Spin) -> list:
    """Each walker's Horner coefficients F_j / (j + 1)!, (W, 1) DDs, the
    top one renormalised (dd_taylor_horner adds it to zero first)."""
    W = tl.shape[0]
    out = []
    for j, (hi, lo, col) in enumerate(zip(spin.hi, spin.lo, spin.col)):
        h = torch.full((W, 1), float(hi), dtype=tl.dtype, device=tl.device)
        low = tl[:, col:col + 1] if col >= 0 else torch.full_like(h, lo)
        f = DD(h, low)
        out.append(f if j == 0 else dd_div_f(f, float(math.factorial(j + 1))))
    zero = torch.zeros_like(out[-1].hi)
    out[-1] = dd_add(DD(zero, zero), out[-1])
    return out


def _spin_phase(coef: list, dt: DD) -> DD:
    acc = coef[-1]
    for c in reversed(coef[:-1]):
        acc = dd_add(dd_mul(acc, dt), c)
    return dd_mul(acc, dt)


class Inputs:
    """What every walker batch of one likelihood shares: the photons'
    columns, the spin terms and the template, checked once, and their
    constants packed once for the kernel's call (the Gaussians' amp,
    loc, c and the step factors ``_steps``, in the source's order)."""

    def __init__(self, photons: Photons, spin: Spin, gauss: Gaussians):
        _check_shared(photons, spin, gauss)
        self.photons, self.spin, self.gauss = photons, spin, gauss
        self.device = photons.dt_hi.device
        self.n = photons.dt_hi.shape[0]
        self.nblocks = nblocks(self.n)
        self.max_col = max(spin.col)
        nt = len(spin.hi)
        steps = [_steps(c) for c in gauss.c]
        self._spin_args = (
            _doubles(spin.hi), _doubles(spin.lo),
            (ctypes.c_int * nt)(*(int(c) for c in spin.col)), nt,
            None if spin.tzr is None else _doubles(spin.tzr),
            _doubles([gauss.bg, *gauss.amp, *gauss.loc, *gauss.c,
                      *(q[j] for j in range(REACH) for q in steps)]),
            len(gauss.amp))
        self._column_args = (
            photons.dt_hi.data_ptr(), photons.dt_lo.data_ptr(),
            *(0 if c is None else c.data_ptr() for c in
              (photons.other_hi, photons.other_lo, photons.weights)),
            self.n)


def photon_lnlike_plain(inputs: Inputs, tl: torch.Tensor) -> torch.Tensor:
    """(W,) log-likelihoods on ``tl``'s device: the kernel's steps on (W,
    N) tensors, in float64."""
    _check_tl(inputs, tl)
    ph, spin, gauss = inputs.photons, inputs.spin, inputs.gauss
    coef = _coefficients(tl, spin)
    phase = _spin_phase(coef, DD(ph.dt_hi[None, :], ph.dt_lo[None, :]))
    if ph.other_hi is not None:
        phase = dd_add(phase, DD(ph.other_hi[None, :], ph.other_lo[None, :]))
    if spin.tzr is not None:
        like = coef[0].hi
        t = [torch.full_like(like, float(v)) for v in spin.tzr]
        phase = dd_sub(phase, dd_add(_spin_phase(coef, DD(t[0], t[1])),
                                     DD(t[2], t[3])))
    f = dd_frac(phase)
    x = torch.remainder(f.hi + f.lo, 1.0)
    dens = torch.full_like(x, float(gauss.bg))
    for amp, loc, c in zip(gauss.amp, gauss.loc, gauss.c):
        dens = dens + float(amp) * _images(x - float(loc), float(c))
    w = ph.weights
    lg = torch.log(dens if w is None else w[None, :] * dens + (1.0 - w))
    n, W = lg.shape[1], lg.shape[0]
    tile = THREADS * PHOTONS
    pad = nblocks(n) * tile - n
    partials = torch.nn.functional.pad(lg, (0, pad)).view(
        W, -1, tile).sum(dim=-1)
    return partials.sum(dim=-1)


def build() -> Path:
    """Compile the kernel into build/ unless a library built from this
    exact source and these flags is already there. Returns its path."""
    return cuda_build.library(_SRC, "photon_lnlike")


def ptxas_report() -> dict:
    """ptxas's registers and spills for every kernel of the current build,
    by mangled name (``cuda_build.ptxas_report``); builds first if
    needed."""
    return cuda_build.ptxas_report(_SRC, "photon_lnlike")


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.photon_lnlike_launch.restype = ctypes.c_int
        lib.photon_lnlike_launch.argtypes = _LAUNCH_ARGTYPES
        _lib = lib
    return _lib


def _doubles(vals) -> ctypes.Array:
    return (ctypes.c_double * len(vals))(*(float(v) for v in vals))


def photon_lnlike(inputs: Inputs, tl: torch.Tensor) -> torch.Tensor:
    """(W,) float64 log-likelihoods of the W walkers whose spin terms' low
    words are the rows of ``tl`` (W, nfree). CUDA tensors: the kernel, on
    the current stream. CPU tensors: the plain version."""
    global launches
    _check_tl(inputs, tl)
    if tl.device.type == "cpu":
        return photon_lnlike_plain(inputs, tl)
    dev = tl.device
    W = tl.shape[0]
    partials = torch.empty((W, inputs.nblocks), dtype=torch.float64,
                           device=dev)
    out = torch.empty(W, dtype=torch.float64, device=dev)
    err = _load().photon_lnlike_launch(
        *inputs._column_args, tl.data_ptr(), W, tl.shape[1],
        *inputs._spin_args, partials.data_ptr(), inputs.nblocks,
        out.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"photon_lnlike kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
