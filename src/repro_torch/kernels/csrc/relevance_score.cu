// Fused chunk relevance scoring on Hopper (sm_90a): masked mean-pool of each
// chunk's token embeddings, dot with the logistic head, sigmoid.
//
// Replaces the Pallas TPU kernel relevance_score_pallas
// (src/repro/kernels/relevance_score.py, body _relevance_kernel).  Per chunk c:
//   n      = clamp(len[c], 0, T)
//   s      = sum_{t < n} sum_d x[c, t, d] * w[d]          (f32)
//   out[c] = 1 / (1 + exp(-(s / max(len[c], 1) + b)))
// The denominator takes the RAW len[c]: a chunk with len > T pools all T
// rows and divides by len, as the TPU kernel and its reference do.
//
// Bound on this card: bytes.  A chunk's valid rows are one contiguous run of
// n * D * 4 bytes, read once (sum_c min(len_c, T) * D * 4 bytes in all, plus
// len, out and w); 2 flops per element read is far under the f32 ridge
// point.  The [C, D] pooled matrix is never written.  Rows t >= n are never
// read: the restructurer's chunks fill ~16% of their T = 64 rows.
//
// What holds such a kernel back is latency, not bandwidth: a chunk is ~10
// rows of 1 KiB on average (64 at most), so a warp that walks its chunk's
// rows one after another waits one memory round trip a row, and a corpus of
// a few hundred chunks gives the card fewer warps than it has schedulers.
// The design therefore spreads each chunk over a block and keeps many rows
// in flight:
//
// - kWarpsPerChunk = 4 warps share a chunk.  Warp k takes the rows
//   t = k, k + 4, k + 8, ... (t < n) in increasing order; lane l takes the
//   16-byte column groups l, l + 32, ... (VPL of them, D <= 1024).  Each
//   lane sums its columns row by row in f32.
// - Merge in a fixed order: warps 1..3 leave their column sums in shared
//   memory, warp 0 adds them to its own as ((s0 + s1) + s2) + s3, dots the
//   result with w by fused multiply-adds in column order (x, y, z, w of
//   each float4), and reduces its lanes by a fixed xor-shuffle tree
//   (16, 8, 4, 2, 1).  Every sum's order is set by the code and by (T, D)
//   alone, never by C, by the grid or by the SM count, and no atomics are
//   used: a chunk scores the same bits whatever else shares the launch and
//   wherever it sits in it, and two calls agree bitwise.  This is what lets
//   the restructurer score a whole corpus in one launch.
// - One block per chunk.  Each warp starts the 16-byte loads of kRows rows
//   (kLoadsInFlight = 8 float4 a lane), each row under its own predicate,
//   before it adds any of them, so a chunk of n rows costs
//   ceil(n / (4 kRows)) round trips to memory (one at D = 256 for n <= 16),
//   not n / 4.  A corpus of 430 chunks is 430 blocks of 4 warps, which
//   fills the card's 132 SMs.  4 row groups with 8 loads in flight a lane
//   beat 2 or 8 groups with 4 or 16 loads, and a persistent grid streaming
//   chunks through a 2-stage TMA bulk-copy ring was slower at every shape
//   the port runs (PERF.md).
// - b is read on the device, so a launch never waits on the host; w and b
//   are read once a block, into warp 0's registers, before any row.  The
//   chunk axis is masked here (no padding of C).
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerChunk = 4;                 // row groups, t mod 4
constexpr int kLoadsInFlight = 8;                 // float4 loads a lane
constexpr int kThreads = kWarpsPerChunk * 32;

// Rows a warp loads before adding them: kLoadsInFlight float4 a lane.
template <int VPL>
constexpr int kRows = VPL >= kLoadsInFlight ? 1 : kLoadsInFlight / VPL;

template <int VPL>
__device__ __forceinline__ void zero(float4 (&acc)[VPL]) {
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void add(float4& a, const float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

// Adds rows t = t0, t0 + 4, ... (t < n) of one chunk, lane's columns, in
// increasing t.  Every batch starts the loads of its R rows, each under its
// own predicate, before it adds any, so a short chunk costs one round trip,
// not one a row.
template <int VPL>
__device__ __forceinline__ void sum_rows(float4 (&acc)[VPL],
                                         const float4* __restrict__ rows,
                                         int t0, int n, int D4, int lane) {
  constexpr int R = kRows<VPL>;
  for (int t = t0; t < n; t += R * kWarpsPerChunk) {
    float4 v[R][VPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int col = lane + 32 * j;
        const float4* p = rows + (long long)(t + r * kWarpsPerChunk) * D4 + col;
        if (t + r * kWarpsPerChunk < n && col < D4)
          v[r][j] = __ldg(p);
      }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        if (t + r * kWarpsPerChunk < n && lane + 32 * j < D4)
          add(acc[j], v[r][j]);
  }
}

// Warp 0's slice of w, loaded once a block before any row (b beside it).
template <int VPL>
__device__ __forceinline__ void load_w(float4 (&wv)[VPL],
                                       const float4* __restrict__ w, int D4,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    wv[j] = col < D4 ? __ldg(w + col) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The fixed-order merge and epilogue.  Every thread of the block calls it
// (it holds a barrier); warp 0's lane 0 writes out[c].
template <int VPL>
__device__ __forceinline__ void finish_chunk(
    float4 (&acc)[VPL], float4 (*part)[32 * VPL], const float4 (&wv)[VPL],
    float bias, float* __restrict__ out, int c, int len, int D4, int warp,
    int lane) {
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) part[warp - 1][lane + 32 * j] = acc[j];
  }
  __syncthreads();
  if (warp == 0) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int col = lane + 32 * j;
      if (col < D4) {
        float4 m = acc[j];
#pragma unroll
        for (int k = 0; k < kWarpsPerChunk - 1; ++k) add(m, part[k][col]);
        s = __fmaf_rn(m.x, wv[j].x, s);
        s = __fmaf_rn(m.y, wv[j].y, s);
        s = __fmaf_rn(m.z, wv[j].z, s);
        s = __fmaf_rn(m.w, wv[j].w, s);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const float logit = __fdiv_rn(s, fmaxf((float)len, 1.f)) + bias;
      out[c] = 1.f / (1.f + expf(-logit));
    }
  }
}

template <int VPL>
__global__ void __launch_bounds__(kThreads) relevance_kernel(
    const float4* __restrict__ x,          // [C, T, D / 4]
    const int* __restrict__ lengths,       // [C]
    const float4* __restrict__ w,          // [D / 4]
    const float* __restrict__ b,           // [1]
    float* __restrict__ out,               // [C]
    int T, int D4) {
  __shared__ float4 part[kWarpsPerChunk - 1][32 * VPL];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x;
  const int len = __ldg(lengths + c);
  const int n = min(max(len, 0), T);
  float4 wv[VPL], acc[VPL];
  const float bias = warp == 0 ? __ldg(b) : 0.f;
  if (warp == 0) load_w(wv, w, D4, lane);
  zero(acc);
  sum_rows<VPL>(acc, x + (long long)c * T * D4, warp, n, D4, lane);
  finish_chunk(acc, part, wv, bias, out, c, len, D4, warp, lane);
}

template <int VPL>
cudaError_t launch(const void* x, const void* lengths, const void* w,
                   const void* b, void* out, int C, int T, int D4,
                   cudaStream_t stream) {
  relevance_kernel<VPL><<<C, kThreads, 0, stream>>>(
      static_cast<const float4*>(x), static_cast<const int*>(lengths),
      static_cast<const float4*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), T, D4);
  return cudaGetLastError();
}

}  // namespace

// x [C, T, D] f32, lengths [C] int32, w [D] f32, b [1] f32 -> out [C] f32.
// D must be a positive multiple of 4 and at most 1024; x and w 16-byte
// aligned (the wrapper checks).  Returns the launch's CUDA error code.
extern "C" int repro_relevance_score(const void* x, const void* lengths,
                                     const void* w, const void* b, void* out,
                                     int C, int T, int D, void* stream) {
  if (C == 0) return cudaSuccess;
  if (C < 0 || T <= 0 || D <= 0 || D % 4 != 0 || D > 1024)
    return cudaErrorInvalidValue;
  const int D4 = D / 4;
  const int vpl = (D4 + 31) / 32;
  auto s = static_cast<cudaStream_t>(stream);
  if (vpl <= 1) return launch<1>(x, lengths, w, b, out, C, T, D4, s);
  if (vpl <= 2) return launch<2>(x, lengths, w, b, out, C, T, D4, s);
  if (vpl <= 4) return launch<4>(x, lengths, w, b, out, C, T, D4, s);
  return launch<8>(x, lengths, w, b, out, C, T, D4, s);
}
