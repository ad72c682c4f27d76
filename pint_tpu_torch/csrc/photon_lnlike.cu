// Walker log-likelihoods of the unbinned photon-template likelihood over a
// template of wrapped Gaussians, for Hopper (sm_90a):
//
//   log L_w = sum_i log(w_i f(phi_i(w)) + 1 - w_i),   w = 0..W-1,
//   f(phi) = bg + sum_k a_k sum_{n=-3..3} exp(c_k (phi - loc_k + n)^2),
//
// a_k = norm_k / (width_k sqrt(2 pi)), c_k = -1 / (2 width_k^2), and
// phi_i(w) the photon's spin phase under walker w's spin terms F_j, in
// turns, reduced to [0, 1). One float64 log L a walker.
//
// The phase is that of the port's double-double chain
// (pint_tpu_torch/ops/taylor.py dd_taylor_horner over Spindown's terms,
// ops/dd.py dd_frac): Horner in double-double over F_j / (j + 1)! at the
// photon's delay-corrected time dt since PEPOCH, the walker's F_j being
// (the high word, shared; the low word, the walker's). The wrapper
// (pint_tpu_torch/ops/photon_lnlike.py) hands dt as two float64 columns,
// computed once from the model's delay chain, with the dd sum of the
// model's other phase components where there is one, and the TZR row's
// dt and other phase where the model is referenced to one. The error-free
// transforms are written with _rn intrinsics and __fma_rn, so nvcc's FMA
// contraction cannot fuse a product into a sum and break them.
//
// It replaces no Pallas kernel: the JAX package's likelihood
// (pint_tpu/mcmc_fitter.py PhotonMCMCFitter, lnlike_core under jax.vmap)
// is left to XLA, which fuses it; in the port the vmapped chain ran as
// PyTorch's eager elementwise kernels, each a pass over (W, N) float64
// tensors in device memory.
//
// What bounds it on an H100: float64 operations. A walker and photon take
// ~170 counted operations (portbench/photon_roofline.py: the dd phase,
// the wrap, 21 exps, the log), several hundred float64 instructions as
// the card runs them (an exp alone is ~16), at 34 TFLOP/s outside the
// tensor cores; a batch reads 16 bytes a
// photon once (24 weighted, 16 more with another phase column) and writes
// 8 bytes a walker, so the bytes take ~1 % of the operations' time.
//
// What the design does about that:
// - one pass over the photons for the whole batch: a thread loads its
//   kPhotons photons' columns once into registers and loops over the
//   walkers, so nothing but the photons is read from device memory and
//   nothing but the partial sums is written;
// - each walker's Horner coefficients F_j / (j + 1)! (a dd division each)
//   and TZR phase are formed once a block, in shared memory;
// - every image of every Gaussian is evaluated, no term dropped or
//   approximated, from three exps a Gaussian in place of seven (images():
//   the nearest image's, and the two ratios out from it; the other images
//   by products, each factor <= 1); the template's constants come from
//   the host;
// - a deterministic two-stage sum, no atomics: a thread's photons in
//   order, a warp by a shuffle tree, the warps of a block in order into
//   one partial a walker and block; then finish_kernel, one block a
//   walker, sums the partials in a fixed order. A repeated call is
//   bitwise identical.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;        // threads of a block
constexpr int kWarps = kThreads / 32;
constexpr int kPhotons = 2;          // photons a thread holds in registers
constexpr int kTile = kThreads * kPhotons;
constexpr int kMaxWalkers = 64;      // walkers of a launch
constexpr int kMaxTerms = 16;        // spin terms F0 .. F15 ((j + 1)! exact)
constexpr int kMaxPeaks = 8;         // Gaussians of the template
constexpr int kImages = 3;           // images n = -kImages..kImages
constexpr int kReach = kImages + 1;  // images j = -kReach..kReach about the nearest
constexpr int kFinishThreads = 128;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

struct Spin {
  int nterms;             // F0 .. F_{nterms-1}
  int nfree;              // columns of tl
  int tzr;                // 1: the phase is referenced to the TZR row
  int col[kMaxTerms];     // the term's column in tl, -1 when frozen
  double hi[kMaxTerms];   // the terms' high words
  double lo[kMaxTerms];   // the frozen terms' low words
  double tzr_dt_hi, tzr_dt_lo, tzr_oth_hi, tzr_oth_lo;
};

struct Gauss {
  int npeaks;
  double bg;
  double amp[kMaxPeaks];  // norm_k / (width_k sqrt(2 pi))
  double loc[kMaxPeaks];
  double c[kMaxPeaks];    // -1 / (2 width_k^2)
  double q[kMaxPeaks][kReach];  // exp(2 c_k j), j = 0..kReach-1
};

struct DD {
  double hi, lo;
};

__device__ __forceinline__ DD two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  const double bb = __dsub_rn(s, a);
  return {s, __dadd_rn(__dsub_rn(a, __dsub_rn(s, bb)), __dsub_rn(b, bb))};
}

__device__ __forceinline__ DD quick_two_sum(double a, double b) {
  const double s = __dadd_rn(a, b);
  return {s, __dsub_rn(b, __dsub_rn(s, a))};
}

// the exact error of a product: Dekker's split product in ops/dd.py gives
// the same value without an FMA
__device__ __forceinline__ DD two_prod(double a, double b) {
  const double p = __dmul_rn(a, b);
  return {p, __fma_rn(a, b, -p)};
}

__device__ __forceinline__ DD dd_add(DD a, DD b) {
  const DD s = two_sum(a.hi, b.hi);
  return quick_two_sum(s.hi, __dadd_rn(s.lo, __dadd_rn(a.lo, b.lo)));
}

__device__ __forceinline__ DD dd_sub(DD a, DD b) {
  const DD s = two_sum(a.hi, -b.hi);
  return quick_two_sum(s.hi, __dadd_rn(s.lo, __dsub_rn(a.lo, b.lo)));
}

__device__ __forceinline__ DD dd_mul(DD a, DD b) {
  const DD p = two_prod(a.hi, b.hi);
  const double cross = __dadd_rn(__dmul_rn(a.hi, b.lo), __dmul_rn(a.lo, b.hi));
  return quick_two_sum(p.hi, __dadd_rn(p.lo, cross));
}

// a / b for a number b: ops/dd.py _dd_div(a, (b, 0)), long division with
// one correction
__device__ __forceinline__ DD dd_div_f(DD a, double b) {
  const double q1 = __ddiv_rn(a.hi, b);
  const DD p = two_prod(b, q1);
  const DD r = dd_sub(a, quick_two_sum(p.hi, p.lo));
  return quick_two_sum(q1, __ddiv_rn(__dadd_rn(r.hi, r.lo), b));
}

// sum_j F_j dt^(j+1) / (j + 1)! by Horner; c holds F_j / (j + 1)!, the
// top one renormalised (dd_taylor_horner's first step adds it to zero)
__device__ __forceinline__ DD spin_phase(const DD* c, int nterms, DD dt) {
  DD acc = c[nterms - 1];
  for (int j = nterms - 2; j >= 0; --j) acc = dd_add(dd_mul(acc, dt), c[j]);
  return dd_mul(acc, dt);
}

// ops/dd.py dd_frac, then hi + lo, then torch.remainder(x, 1): |x| <= 1/2
// here, so fmod(x, 1) is x and a negative x takes 1
__device__ __forceinline__ double turn(DD a) {
  const double n1 = rint(a.hi);
  const DD s = two_sum(a.hi, -n1);
  const DD t = two_sum(s.hi, a.lo);
  const double vhi = t.hi, vlo = __dadd_rn(t.lo, s.lo);
  const double n2 = rint(vhi);
  const DD s2 = two_sum(vhi, -n2);
  const DD f0 = two_sum(s2.hi, vlo);
  const DD f = quick_two_sum(f0.hi, __dadd_rn(f0.lo, s2.lo));
  const double shift = (f.hi > 0.5 ? 1.0 : 0.0) - (f.hi < -0.5 ? 1.0 : 0.0);
  const DD s3 = two_sum(f.hi, -shift);
  const DD f1 = two_sum(s3.hi, f.lo);
  const DD r = quick_two_sum(f1.hi, __dadd_rn(f1.lo, s3.lo));
  const double x = __dadd_rn(r.hi, r.lo);
  return x < 0.0 ? __dadd_rn(x, 1.0) : x;
}

// sum_{n=-3..3} exp(c (d + n)^2) from three exps: the nearest image
// n0 = rint(-d), e0 = d + n0 in [-1/2, 1/2], directly, and each image
// further out from its inner neighbour by the exact identity
// exp(c (e + 1)^2) = exp(c e^2) exp(c (2 e + 1)): the step out from
// e0 + j (j >= 0) is up q_j, and from e0 - j down q_j, with
// up = exp(c (2 e0 + 1)), down = exp(c (1 - 2 e0)) and q_j = exp(2 c j),
// each <= 1, so no partial product can overflow, whatever the width. With
// the location in (-1/2, 3/2) and the phase in [0, 1], n0 is -1, 0 or 1,
// so the images n = -3..3 are among e0 + j, j = -4..4; they are summed in
// the order n = -3..3.
__device__ __forceinline__ double images(double d, double c, const double* q) {
  const double n0 = rint(-d);
  const double e0 = __dadd_rn(d, n0);
  const double c2e0 = __dmul_rn(__dadd_rn(c, c), e0);
  const double up = exp(__dadd_rn(c2e0, c));
  const double down = exp(__dsub_rn(c, c2e0));
  double g[2 * kReach + 1];  // g[kReach + j] = exp(c (e0 + j)^2)
  g[kReach] = exp(__dmul_rn(__dmul_rn(e0, e0), c));
  g[kReach + 1] = __dmul_rn(g[kReach], up);
  g[kReach - 1] = __dmul_rn(g[kReach], down);
#pragma unroll
  for (int j = 2; j <= kReach; ++j) {
    g[kReach + j] = __dmul_rn(g[kReach + j - 1], __dmul_rn(up, q[j - 1]));
    g[kReach - j] = __dmul_rn(g[kReach - j + 1], __dmul_rn(down, q[j - 1]));
  }
  double s = 0.0;
#pragma unroll
  for (int n = -kImages; n <= kImages; ++n)
    s = __dadd_rn(s, n0 < 0.0 ? g[kReach + n + 1] : n0 > 0.0 ? g[kReach + n - 1] : g[kReach + n]);
  return s;
}

__device__ __forceinline__ double density(const Gauss& g, double x) {
  double dens = g.bg;
  for (int k = 0; k < g.npeaks; ++k)
    dens = __dadd_rn(dens, __dmul_rn(g.amp[k], images(__dsub_rn(x, g.loc[k]), g.c[k], g.q[k])));
  return dens;
}

// One block: kTile photons, every walker of the batch. partials[w, block]
// is the sum of the block's log terms for walker w.
template <bool kWeighted, bool kOther>
__global__ void __launch_bounds__(kThreads)
lnlike_kernel(const double* __restrict__ dt_hi, const double* __restrict__ dt_lo,
              const double* __restrict__ oth_hi, const double* __restrict__ oth_lo,
              const double* __restrict__ weights, int n, const double* __restrict__ tl,
              int nwalkers, const __grid_constant__ Spin spin,
              const __grid_constant__ Gauss g, double* __restrict__ partials) {
  extern __shared__ double smem[];
  const int nt = spin.nterms;
  DD* coef = reinterpret_cast<DD*>(smem);                    // nwalkers x nt
  DD* tzr = coef + nwalkers * nt;                            // nwalkers
  double* red = reinterpret_cast<double*>(tzr + nwalkers);   // nwalkers x kWarps
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int w = tid; w < nwalkers; w += kThreads) {
    DD* c = coef + w * nt;
    double fct = 1.0;
    for (int j = 0; j < nt; ++j) {
      fct *= static_cast<double>(j + 1);
      const int col = spin.col[j];
      const DD f = {spin.hi[j], col >= 0 ? tl[w * spin.nfree + col] : spin.lo[j]};
      c[j] = j == 0 ? f : dd_div_f(f, fct);
    }
    c[nt - 1] = quick_two_sum(c[nt - 1].hi, c[nt - 1].lo);
    if (spin.tzr)
      tzr[w] = dd_add(spin_phase(c, nt, DD{spin.tzr_dt_hi, spin.tzr_dt_lo}),
                      DD{spin.tzr_oth_hi, spin.tzr_oth_lo});
  }

  DD dt[kPhotons], oth[kPhotons];
  double wt[kPhotons], wc[kPhotons];
  bool live[kPhotons];
  const int first = blockIdx.x * kTile + tid;
#pragma unroll
  for (int j = 0; j < kPhotons; ++j) {
    const int i = first + j * kThreads;
    live[j] = i < n;
    const int k = live[j] ? i : 0;
    dt[j] = DD{__ldg(dt_hi + k), __ldg(dt_lo + k)};
    if (kOther) oth[j] = DD{__ldg(oth_hi + k), __ldg(oth_lo + k)};
    if (kWeighted) {
      wt[j] = __ldg(weights + k);
      wc[j] = __dsub_rn(1.0, wt[j]);
    }
  }
  __syncthreads();

  for (int w = 0; w < nwalkers; ++w) {
    const DD* c = coef + w * nt;
    double t = 0.0;
#pragma unroll
    for (int j = 0; j < kPhotons; ++j) {
      if (!live[j]) continue;
      DD ph = spin_phase(c, nt, dt[j]);
      if (kOther) ph = dd_add(ph, oth[j]);
      if (spin.tzr) ph = dd_sub(ph, tzr[w]);
      const double dens = density(g, turn(ph));
      t = __dadd_rn(t, log(kWeighted ? __dadd_rn(__dmul_rn(wt[j], dens), wc[j]) : dens));
    }
    for (int off = 16; off > 0; off >>= 1) t = __dadd_rn(t, __shfl_down_sync(kFull, t, off));
    if (lane == 0) red[w * kWarps + warp] = t;
  }
  __syncthreads();
  for (int w = tid; w < nwalkers; w += kThreads) {
    double s = 0.0;
    for (int k = 0; k < kWarps; ++k) s = __dadd_rn(s, red[w * kWarps + k]);
    partials[static_cast<long long>(w) * gridDim.x + blockIdx.x] = s;
  }
}

// One block a walker: its nblocks partials, each thread a fixed stride of
// them in order, then a tree in shared memory.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ partials, int nblocks, double* __restrict__ out) {
  __shared__ double s[kFinishThreads];
  const int tid = threadIdx.x;
  const double* row = partials + static_cast<long long>(blockIdx.x) * nblocks;
  double t = 0.0;
  for (int b = tid; b < nblocks; b += kFinishThreads) t = __dadd_rn(t, row[b]);
  s[tid] = t;
  __syncthreads();
  for (int h = kFinishThreads / 2; h > 0; h >>= 1) {
    if (tid < h) s[tid] = __dadd_rn(s[tid], s[tid + h]);
    __syncthreads();
  }
  if (tid == 0) out[blockIdx.x] = s[0];
}

using KernelFn = void (*)(const double*, const double*, const double*, const double*,
                          const double*, int, const double*, int, const Spin, const Gauss,
                          double*);

KernelFn pick(bool weighted, bool other) {
  if (weighted) return other ? lnlike_kernel<true, true> : lnlike_kernel<true, false>;
  return other ? lnlike_kernel<false, true> : lnlike_kernel<false, false>;
}

}  // namespace

// dt_hi, dt_lo: the n photons' delay-corrected time since PEPOCH [s] as a
// double-double; other_hi, other_lo: the dd sum of the other phase
// components [turns], or both null; weights: n float64, or null for
// unweighted photons; tl: the batch's (nwalkers, nfree) low words,
// row-major. spin_hi, spin_lo, spin_col: the nterms spin terms' high
// words, frozen low words and columns in tl (-1: frozen); tzr: the TZR
// row's (dt hi, dt lo, other hi, other lo), or null; gauss: bg, then
// npeaks each of amp, loc (in (-1/2, 3/2)), c and q_j = exp(2 c j) for
// j = 0..kReach-1. partials: nwalkers * nblocks float64
// scratch, nblocks = max(1, ceil(n / (kThreads * kPhotons))); out:
// nwalkers float64. Two launches on `stream`, each followed by
// cudaGetLastError(); returns the first error (0 on success). Does not
// synchronise.
extern "C" int photon_lnlike_launch(const void* dt_hi, const void* dt_lo, const void* other_hi,
                                    const void* other_lo, const void* weights, int n,
                                    const void* tl, int nwalkers, int nfree,
                                    const double* spin_hi, const double* spin_lo,
                                    const int* spin_col, int nterms, const double* tzr,
                                    const double* gauss, int npeaks, void* partials,
                                    int nblocks, void* out, int device, void* stream) {
  const int want_blocks = n > 0 ? (n + kTile - 1) / kTile : 1;
  if (n < 0 || nwalkers < 1 || nwalkers > kMaxWalkers || nfree < 0 || nterms < 1 ||
      nterms > kMaxTerms || npeaks < 1 || npeaks > kMaxPeaks || nblocks != want_blocks ||
      (other_hi == nullptr) != (other_lo == nullptr) || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  Spin s{};
  s.nterms = nterms;
  s.nfree = nfree;
  s.tzr = tzr != nullptr;
  for (int j = 0; j < nterms; ++j) {
    if (spin_col[j] >= nfree) return static_cast<int>(cudaErrorInvalidValue);
    s.col[j] = spin_col[j];
    s.hi[j] = spin_hi[j];
    s.lo[j] = spin_lo[j];
  }
  if (tzr != nullptr) {
    s.tzr_dt_hi = tzr[0];
    s.tzr_dt_lo = tzr[1];
    s.tzr_oth_hi = tzr[2];
    s.tzr_oth_lo = tzr[3];
  }
  Gauss g{};
  g.npeaks = npeaks;
  g.bg = gauss[0];
  for (int k = 0; k < npeaks; ++k) {
    g.amp[k] = gauss[1 + k];
    g.loc[k] = gauss[1 + npeaks + k];
    g.c[k] = gauss[1 + 2 * npeaks + k];
    if (!(g.loc[k] > -0.5 && g.loc[k] < 1.5)) return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < kReach; ++j) g.q[k][j] = gauss[1 + (3 + j) * npeaks + k];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(nwalkers) * (nterms + 1) * sizeof(DD) +
                      static_cast<size_t>(nwalkers) * kWarps * sizeof(double);
  const KernelFn fn = pick(weights != nullptr, other_hi != nullptr);
  fn<<<nblocks, kThreads, smem, st>>>(
      static_cast<const double*>(dt_hi), static_cast<const double*>(dt_lo),
      static_cast<const double*>(other_hi), static_cast<const double*>(other_lo),
      static_cast<const double*>(weights), n, static_cast<const double*>(tl), nwalkers, s, g,
      static_cast<double*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<<<nwalkers, kFinishThreads, 0, st>>>(static_cast<const double*>(partials),
                                                    nblocks, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
