// Weighted Z^2_m harmonic sums of photon phases, for Hopper (sm_90a).
//
//   c_k = sum_i w_i cos(2 pi k phi_i),   s_k = sum_i w_i sin(2 pi k phi_i),
//   k = 1..m,  out = [c_1..c_m ; s_1..s_m]  (2, m) float64.
//
// Replaces the Pallas TPU kernel pint_tpu/ops/pallas_kernels.py
// z2_harmonics_pallas (body _harmonics_kernel), which feeds
// pint_tpu/eventstats.py _z2_terms (the Z^2_m and H-test statistics).
// Arithmetic is float32 on float32-rounded inputs, as on the TPU.
//
// What bounds it on an H100: it reads 8N bytes (float32 inputs) or 16N
// bytes (float64 inputs) and produces 2m trig values per photon. At
// m = 20 the float32 form is bound by operations (11.3 us for 9mN
// operations at 67 TFLOP/s against 10.0 us for the bytes at 3.35 TB/s);
// the float64 form, which the photon path hands it, by bytes (20.0 us).
// So FP32 issue slots and the one streaming read are what matter.
//
// What the design does about that:
// - seed and rotate: one sine-cosine per photon gives z = e^{2 pi i phi};
//   every further harmonic is one complex multiply of the weighted term
//   u_k = w z^k by z (2 FMUL + 2 FFMA) and two FADDs into the sums,
//   about 6 FP32 instructions per photon and harmonic instead of a
//   ~40-instruction sincospif. A block accumulates at most kChunk = 32
//   harmonics; a later chunk (m > 32, gridDim.y) takes one more
//   sine-cosine, of its first harmonic, as its seed, so no term is
//   rotated more than 31 times (error ~k * 2^-24);
// - the seed's sine-cosine is rounded correctly to float32: phi is split
//   exactly into whole quarter turns and |r| <= 1/8 turn with FP32
//   instructions alone, and float64 polynomials (errors < 3.5e-12) take
//   r on the otherwise idle FP64 pipe. CUDA's sincospif is within 1 ulp,
//   but its error is a smooth function of the angle, which the rotation
//   carries k-fold into the k-th term with the same phase for every
//   photon, so over millions of photons it adds up instead of averaging
//   out; it dominated the error of every fourth harmonic;
// - the harmonic count is a template parameter (a multiple of 4, up to
//   32), so the unrolled loop carries no per-harmonic branch and no
//   unused sums; harmonics past m in the last chunk are computed and
//   not written;
// - the input type is a template parameter: float64 phases or weights
//   are read as such and rounded to float32 in registers, which gives
//   the values .to(torch.float32) would, without that extra pass over
//   the data;
// - 16-byte read-only loads (a float4 or two double2 per 4 photons),
//   each thread taking the same kPhotons consecutive photons per step
//   whatever the types, and a grid that does not depend on them (the
//   fewest resident blocks of the four type instantiations), so the
//   summation order, and hence every bit of the result, does not depend
//   on the input types; the next step's loads are issued before this
//   step's arithmetic; a misaligned pointer or the ragged tail takes
//   scalar loads, and rows past N weigh 0;
// - kPhotons independent rotation chains per thread hide the FP32
//   latency; the grid is one wave (occupancy x SMs), so each thread
//   takes many photons and the block reduction is paid once;
// - the block reduction halves the 2 * KC values across lanes (shuffle
//   offsets 16, 8, 4), then sums within groups of 4 lanes and across
//   warps in shared memory: ~2.25 KC shuffles a thread instead of 10 KC;
// - one launch, deterministic, no float atomics: each block writes its
//   partials, fences, and takes an integer ticket of its group of
//   kGroup blocks; the group's last block sums the group's rows in block
//   order in float64, then takes a ticket of the chunk, whose last group
//   sums the group sums in order and writes out. Each ticket is reset to
//   0 by the block that drew the last one, ready for the next launch on
//   the stream. Two levels keep the serial tail after the last block
//   short: one block summing every row alone took longer than the rest
//   of the reduction.
//
// What does not apply:
// - tensor cores: the work is generating trig values and one weighted
//   sum per harmonic, with no operand reuse, so there is no matrix
//   product for wgmma (and TF32 would lose the accuracy the statistic
//   needs);
// - TMA: one streaming read with no reuse, for which 16-byte vector
//   loads issued a step ahead suffice: the kernel is bound by FP32
//   issue, and reading float64 instead of float32 inputs (twice the
//   bytes) adds little to its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;    // most harmonics one block accumulates
constexpr int kPhotons = 4;   // consecutive photons a thread takes a step:
                              // one Quad of each input
constexpr int kGroup = 16;    // blocks whose partials are summed together
constexpr unsigned kFull = 0xffffffffu;

// Coefficients of the polynomials in x^2 of sin(2 pi x) / x and
// cos(2 pi x), Chebyshev fits on |x| <= 1/8 with errors below 3.5e-12
// (constant memory, so each DFMA reads its coefficient directly).
__constant__ double kSinPoly[5] = {
    6.28318530715229340e+00, -4.13417021531023750e+01, 8.16052045952630181e+01,
    -7.66978522262707116e+01, 4.14723087833867652e+01};
__constant__ double kCosPoly[6] = {
    9.99999999999944267e-01, -1.97392088019213041e+01, 6.49393938305821763e+01,
    -8.54567647798184993e+01, 6.02381706564581663e+01, -2.60577562959089626e+01};

// kPhotons = 4 consecutive photons i .. i+3 of one input, as loaded (not
// yet rounded): 16-byte-aligned vector loads when `fast`, else scalar
// loads with the rows past n set to 0.
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* __restrict__ p,
                                       long long i, long long n, bool fast) {
    if (fast) {
      v = __ldg(reinterpret_cast<const float4*>(p + i));
    } else {
      v.x = i < n ? __ldg(p + i) : 0.0f;
      v.y = i + 1 < n ? __ldg(p + i + 1) : 0.0f;
      v.z = i + 2 < n ? __ldg(p + i + 2) : 0.0f;
      v.w = i + 3 < n ? __ldg(p + i + 3) : 0.0f;
    }
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

template <>
struct Quad<double> {
  double2 a, b;
  __device__ __forceinline__ void load(const double* __restrict__ p,
                                       long long i, long long n, bool fast) {
    if (fast) {
      const double2* q = reinterpret_cast<const double2*>(p + i);
      a = __ldg(q);
      b = __ldg(q + 1);
    } else {
      a.x = i < n ? __ldg(p + i) : 0.0;
      a.y = i + 1 < n ? __ldg(p + i + 1) : 0.0;
      b.x = i + 2 < n ? __ldg(p + i + 2) : 0.0;
      b.y = i + 3 < n ? __ldg(p + i + 3) : 0.0;
    }
  }
  __device__ __forceinline__ void get(float* f) const {
    f[0] = __double2float_rn(a.x);
    f[1] = __double2float_rn(a.y);
    f[2] = __double2float_rn(b.x);
    f[3] = __double2float_rn(b.y);
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// p = q/4 + r exactly, q the nearest whole number of quarter turns to p
// (|r| <= 1/8), for |p| < 2^20 turns; returns r and sets quad = q mod 4.
// FP32 and integer instructions only: adding 1.5 * 2^23 rounds 4p to an
// integer that then sits in the low bits of the sum's mantissa.
__device__ __forceinline__ float quarter_turns(float p, int& quad) {
  constexpr float kRound = 12582912.0f;  // 1.5 * 2^23
  const float t = fmaf(4.0f, p, kRound);
  quad = __float_as_int(t) & 3;
  return fmaf(-0.25f, t - kRound, p);
}

// sin and cos of 2 pi (x + quad / 4) for |x| <= 1/8 (turns), rounded
// once to float32 from the float64 polynomials, so correctly rounded but
// for the rare value within 1e-11 of a rounding boundary.
__device__ __forceinline__ void sincos_quadrant(double x, int quad,
                                                float& s, float& c) {
  const double x2 = x * x;
  double sp = kSinPoly[4];
#pragma unroll
  for (int i = 3; i >= 0; --i) sp = fma(sp, x2, kSinPoly[i]);
  double cp = kCosPoly[5];
#pragma unroll
  for (int i = 4; i >= 0; --i) cp = fma(cp, x2, kCosPoly[i]);
  const float sr = __double2float_rn(sp * x);
  const float cr = __double2float_rn(cp);
  const float a = (quad & 1) ? cr : sr;
  const float b = (quad & 1) ? sr : cr;
  s = (quad & 2) ? -a : a;
  c = ((quad + 1) & 2) ? -b : b;
}

// One block: KC harmonics k0+1 .. k0+KC (k0 = blockIdx.y * KC) over a
// grid-stride share of the photons; the last block of the chunk also
// writes out[:, k0 : min(k0 + KC, m)].
template <typename TP, typename TW, int KC>
__global__ void __launch_bounds__(kThreads)
z2_kernel(const void* phi_v, const void* w_v, long long n, int m,
          double* __restrict__ partials, unsigned int* __restrict__ tickets,
          double* __restrict__ out) {
  static_assert(KC % 4 == 0 && KC <= kChunk, "KC: a multiple of 4, <= 32");
  constexpr int V = 2 * KC;  // sums a thread carries: c then s
  const TP* __restrict__ phi = static_cast<const TP*>(phi_v);
  const TW* __restrict__ w = static_cast<const TW*>(w_v);
  const int k0 = blockIdx.y * KC;
  const float kk = static_cast<float>(k0 + 1);
  const bool vec = aligned16(phi) && aligned16(w);

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;

  const long long steps = (n + kPhotons - 1) / kPhotons;
  const long long full = vec ? n / kPhotons : 0;  // steps of vector loads
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Quad<TP> qp;
  Quad<TW> qw;
  if (g < steps) {
    qp.load(phi, g * kPhotons, n, g < full);
    qw.load(w, g * kPhotons, n, g < full);
  }
  for (; g < steps; g += stride) {
    float ph[kPhotons], wt[kPhotons];
    qp.get(ph);
    qw.get(wt);
    const long long gn = g + stride;
    if (gn < steps) {  // next step's loads, in flight meanwhile
      qp.load(phi, gn * kPhotons, n, gn < full);
      qw.load(w, gn * kPhotons, n, gn < full);
    }
    // z = e^{2 pi i phi} and the weighted first term u = w z^{k0+1}
    float c1[kPhotons], s1[kPhotons], ur[kPhotons], ui[kPhotons];
#pragma unroll
    for (int q = 0; q < kPhotons; ++q) {
      int quad;
      float r = quarter_turns(ph[q], quad);
      sincos_quadrant(static_cast<double>(r), quad, s1[q], c1[q]);
      float cr = c1[q], sr = s1[q];
      if (k0 != 0) {
        const float p = kk * ph[q];
        const float e = fmaf(kk, ph[q], -p);  // kk ph = p + e exactly
        r = quarter_turns(p, quad);
        sincos_quadrant(static_cast<double>(r) + static_cast<double>(e), quad,
                        sr, cr);  // r + e exact in float64
      }
      ur[q] = wt[q] * cr;
      ui[q] = wt[q] * sr;
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
#pragma unroll
      for (int q = 0; q < kPhotons; ++q) {
        acc[j] += ur[q];
        acc[KC + j] += ui[q];
      }
      if (j + 1 < KC) {
#pragma unroll
        for (int q = 0; q < kPhotons; ++q) {
          const float rn = fmaf(ur[q], c1[q], -(ui[q] * s1[q]));
          const float in = fmaf(ui[q], c1[q], ur[q] * s1[q]);
          ur[q] = rn;
          ui[q] = in;
        }
      }
    }
  }

  // Warp: halve the V sums over lane bits 16, 8, 4 (a lane keeps the
  // half its bit selects and adds its partner's copy of it), then sum
  // the remaining V/8 over lane bits 2 and 1.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const bool up = lane & 16;
    const float keep = up ? acc[i + V / 2] : acc[i];
    const float send = up ? acc[i] : acc[i + V / 2];
    acc[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const bool up = lane & 8;
    const float keep = up ? acc[i + V / 4] : acc[i];
    const float send = up ? acc[i] : acc[i + V / 4];
    acc[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const bool up = lane & 4;
    const float keep = up ? acc[i + V / 8] : acc[i];
    const float send = up ? acc[i] : acc[i + V / 8];
    acc[i] = keep + __shfl_xor_sync(kFull, send, 4);
  }
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    acc[i] += __shfl_xor_sync(kFull, acc[i], 2);
    acc[i] += __shfl_xor_sync(kFull, acc[i], 1);
  }
  __shared__ float red[kWarps][V];
  __shared__ bool last;
  if ((lane & 3) == 0) {
    const int base = ((lane >> 4) & 1) * (V / 2) + ((lane >> 3) & 1) * (V / 4)
                     + ((lane >> 2) & 1) * (V / 8);
#pragma unroll
    for (int i = 0; i < V / 8; ++i) red[warp][base + i] = acc[i];
  }
  __syncthreads();
  // this chunk's rows of partials, one a block, V values a row
  double* __restrict__ rows =
      partials + static_cast<long long>(blockIdx.y) * gridDim.x * V;
  if (threadIdx.x < V) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[q][threadIdx.x];
    rows[static_cast<long long>(blockIdx.x) * V + threadIdx.x] = s;
  }

  // One launch, in two levels: the last block of each group of kGroup
  // blocks to finish sums the group's rows in order into the group's
  // first row; the last group to finish sums those in order into out.
  const int nb = gridDim.x;
  const int groups = (nb + kGroup - 1) / kGroup;
  const int group = blockIdx.x / kGroup;
  const int first = group * kGroup;
  const int count = min(kGroup, nb - first);
  unsigned int* t = tickets + blockIdx.y * (groups + 1);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&t[group], 1u) == count - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < V) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i < count)
        s += __ldcg(rows + static_cast<long long>(first + i) * V + threadIdx.x);
    rows[static_cast<long long>(first) * V + threadIdx.x] = s;
  }
  if (threadIdx.x == 0) t[group] = 0u;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&t[groups], 1u) == groups - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < V) {
    double s = 0.0;
#pragma unroll 8
    for (int q = 0; q < groups; ++q)
      s += __ldcg(rows + static_cast<long long>(q) * kGroup * V + threadIdx.x);
    const int k = k0 + threadIdx.x % KC;
    if (k < m) out[(threadIdx.x / KC) * m + k] = s;
  }
  if (threadIdx.x == 0) t[groups] = 0u;
}

using KernelFn = void (*)(const void*, const void*, long long, int, double*,
                          unsigned int*, double*);

// Harmonics one block accumulates for m: m rounded up to a multiple of 4,
// at most kChunk.
int chunk_width(int m) { return m > kChunk ? kChunk : 4 * ((m + 3) / 4); }

template <typename TP, typename TW>
KernelFn pick_width(int kc) {
  switch (kc) {
    case 4: return z2_kernel<TP, TW, 4>;
    case 8: return z2_kernel<TP, TW, 8>;
    case 12: return z2_kernel<TP, TW, 12>;
    case 16: return z2_kernel<TP, TW, 16>;
    case 20: return z2_kernel<TP, TW, 20>;
    case 24: return z2_kernel<TP, TW, 24>;
    case 28: return z2_kernel<TP, TW, 28>;
    case 32: return z2_kernel<TP, TW, 32>;
    default: return nullptr;
  }
}

// phi_double / w_double: 0 = float32, 1 = float64.
KernelFn pick(int phi_double, int w_double, int kc) {
  if (phi_double)
    return w_double ? pick_width<double, double>(kc)
                    : pick_width<double, float>(kc);
  return w_double ? pick_width<float, double>(kc)
                  : pick_width<float, float>(kc);
}

}  // namespace

// The launch shape for m harmonics on `device`: *kc harmonics a block,
// *chunks chunks over gridDim.y, and *blocks_per_sm, the fewest resident
// blocks a multiprocessor takes of the four input-type instantiations,
// so that the grid, and with it every bit of the result, is the same
// whichever types the inputs have. Returns a cudaError_t (0 = success).
extern "C" int z2_harmonics_plan(int m, int device, int* kc, int* chunks,
                                 int* blocks_per_sm) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  *kc = chunk_width(m);
  *chunks = (m + *kc - 1) / *kc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks_per_sm = 1 << 30;
  for (int types = 0; types < 4; ++types) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reinterpret_cast<const void*>(pick(types >> 1, types & 1, *kc)),
        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    *blocks_per_sm = blocks < *blocks_per_sm ? blocks : *blocks_per_sm;
  }
  return 0;
}

// phi, w: n contiguous float32 or float64 values on the device
// (phi_double / w_double say which); partials: chunks * nblocks * 2 * kc
// float64 scratch; tickets: chunks * (ceil(nblocks / 16) + 1) zeroed
// unsigned ints, left zeroed again when the launch ends; out: 2 * m
// float64. One launch on `stream`; returns cudaGetLastError() (0 on
// success). Does not synchronise.
extern "C" int z2_harmonics_launch(const void* phi, int phi_double,
                                   const void* w, int w_double, long long n,
                                   int m, void* partials, int nblocks,
                                   void* tickets, void* out, int device,
                                   void* stream) {
  if (m < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int kc = chunk_width(m);
  KernelFn fn = pick(phi_double, w_double, kc);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nblocks, (m + kc - 1) / kc);
  fn<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      phi, w, n, m, static_cast<double*>(partials),
      static_cast<unsigned int*>(tickets), static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
