// Weighted Z^2_m harmonic sums of photon phases, for Hopper (sm_90a).
//
//   c_k = sum_i w_i cos(2 pi k phi_i),   s_k = sum_i w_i sin(2 pi k phi_i),
//   k = 1..m,  out = [c_1..c_m ; s_1..s_m]  (2, m) float64.
//
// Replaces the Pallas TPU kernel pint_tpu/ops/pallas_kernels.py
// z2_harmonics_pallas (body _harmonics_kernel), which feeds
// pint_tpu/eventstats.py _z2_terms (the Z^2_m and H-test statistics).
//
// What bounds it on an H100: it reads 8N bytes (a float32 phase and a
// float32 weight per photon) and does about m*N sincospif plus 4m*N FMAs.
// At m = 20 that is ~180 floating-point operations for every 8 bytes read,
// far above the card's balance point of ~20 float32 operations per byte
// (67 TFLOP/s over 3.35 TB/s), so the trigonometry bounds it, not memory.
//
// What the design does about that:
// - one pass over the photons: each thread keeps the (c, s) sums of up to
//   kChunk harmonics in registers across a grid-stride loop, so no (m, N)
//   angle matrix ever reaches device memory (m > kChunk splits the
//   harmonics over gridDim.y and rereads the photons from L2);
// - one sincospif per photon and harmonic on the exactly scaled argument
//   2*phi (a power-of-two scale), accurate to a few float32 ulps; the
//   cheaper angle-addition recurrence is left for a later change;
// - a deterministic two-pass reduction and no float atomics: warp shuffles
//   and shared memory give per-block partials in a (blocks, 2, m) scratch
//   array that the caller allocates, and a second small launch sums them
//   in float64 in block order, so two runs are bitwise equal;
// - the ragged edge is masked by the loop bound; nothing is padded.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // harmonics one block accumulates

__global__ void __launch_bounds__(kThreads)
z2_partials(const float* __restrict__ phi, const float* __restrict__ w,
            long long n, int m, float* __restrict__ partials) {
  const int k0 = blockIdx.y * kChunk;   // harmonic k0 + 1 is this chunk's first
  const int kc = min(kChunk, m - k0);   // harmonics in this chunk (uniform)
  float c[kChunk];
  float s[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    c[j] = 0.0f;
    s[j] = 0.0f;
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float t = 2.0f * phi[i];  // exact: sincospif(k t) = sincos(2 pi k phi)
    const float wi = w[i];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < kc) {
        float sv, cv;
        sincospif(static_cast<float>(k0 + j + 1) * t, &sv, &cv);
        c[j] = fmaf(wi, cv, c[j]);
        s[j] = fmaf(wi, sv, s[j]);
      }
    }
  }

  __shared__ float red[2][kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    if (j < kc) {
      float cv = c[j];
      float sv = s[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cv += __shfl_down_sync(0xffffffffu, cv, off);
        sv += __shfl_down_sync(0xffffffffu, sv, off);
      }
      if (lane == 0) {
        red[0][warp][j] = cv;
        red[1][warp][j] = sv;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kc) {
    const int r = threadIdx.x / kc;
    const int j = threadIdx.x % kc;
    float acc = 0.0f;
    for (int q = 0; q < kWarps; ++q) acc += red[r][q][j];
    partials[(static_cast<long long>(blockIdx.x) * 2 + r) * m + k0 + j] = acc;
  }
}

// out[o] = sum over blocks b, in order, of partials[b][o] (o = r*m + k).
__global__ void z2_finalize(const float* __restrict__ partials, int nblocks,
                            int m, double* __restrict__ out) {
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < 2 * m;
       o += gridDim.x * blockDim.x) {
    double acc = 0.0;
    for (int b = 0; b < nblocks; ++b)
      acc += static_cast<double>(partials[static_cast<long long>(b) * 2 * m + o]);
    out[o] = acc;
  }
}

}  // namespace

// phi, w: n float32 on the device; partials: nblocks*2*m float32 scratch;
// out: 2*m float64. Launches both passes on `stream` and returns
// cudaGetLastError() (0 on success). Does not synchronise.
extern "C" int z2_harmonics_launch(const void* phi, const void* w,
                                   long long n, int m, void* partials,
                                   int nblocks, void* out, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblocks, (m + kChunk - 1) / kChunk);
  z2_partials<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(phi), static_cast<const float*>(w), n, m,
      static_cast<float*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fin_blocks = (2 * m + kThreads - 1) / kThreads;
  z2_finalize<<<fin_blocks, kThreads, 0, st>>>(
      static_cast<const float*>(partials), nblocks, m,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
