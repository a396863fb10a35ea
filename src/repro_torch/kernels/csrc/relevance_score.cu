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
// Bound on this card: bytes.  The kernel reads each valid token row once
// (sum_c min(len_c, T) * D * 4 bytes) and does 2 flops per element read, far
// under the f32 ridge point.  The [C, D] pooled matrix is never written.
//
// Design: one warp per chunk, kWarps chunks per block.  Each lane owns VPL
// float4 columns (D = 256: two float4 a lane) and sums them over the chunk's
// valid rows only: rows t >= n are never read, which for the restructurer's
// one- or two-line chunks skips most of the T = 64 padded rows (the embedder
// zero-fills padding, so for finite x this equals multiplying by the mask).
// Each lane then dots its column sums with its slice of w and a fixed
// xor-shuffle tree reduces the warp: no atomics, so the result is
// deterministic and identical chunks score identically.  b is read from
// device memory, so a launch never waits on the host.  The chunk axis is
// masked here (no padding of C).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                  // chunks per block
constexpr int kThreads = kWarps * 32;

template <int VPL>
__global__ void __launch_bounds__(kThreads) relevance_score_kernel(
    const float4* __restrict__ x,          // [C, T, D / 4]
    const int* __restrict__ lengths,       // [C]
    const float4* __restrict__ w,          // [D / 4]
    const float* __restrict__ b,           // [1]
    float* __restrict__ out,               // [C]
    int C, int T, int D4) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;                      // whole warp leaves together
  const int len = lengths[c];
  const int n = min(max(len, 0), T);

  float4 acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* row = x + (long long)c * T * D4;
#pragma unroll 4
  for (int t = 0; t < n; ++t) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int col = lane + 32 * j;
      if (col < D4) {
        const float4 v = row[(long long)t * D4 + col];
        acc[j].x += v.x;
        acc[j].y += v.y;
        acc[j].z += v.z;
        acc[j].w += v.w;
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    if (col < D4) {
      const float4 wv = w[col];
      s += acc[j].x * wv.x + acc[j].y * wv.y + acc[j].z * wv.z +
           acc[j].w * wv.w;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const float logit = s / fmaxf((float)len, 1.f) + b[0];
    out[c] = 1.f / (1.f + expf(-logit));
  }
}

template <int VPL>
cudaError_t launch(const void* x, const void* lengths, const void* w,
                   const void* b, void* out, int C, int T, int D4,
                   cudaStream_t stream) {
  const int blocks = (C + kWarps - 1) / kWarps;
  relevance_score_kernel<VPL><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(x), static_cast<const int*>(lengths),
      static_cast<const float4*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), C, T, D4);
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
