// Flash-decoding on Hopper (sm_90a): one new query token per sequence
// attends over a KV cache held in a slot arena.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode_attention.py:
//   paged_decode_attention_pallas (slots / block tables, the paged plane)
//   decode_attention_pallas       (dense cache, the gather plane)
// Both Pallas entry points share one body (_decode_kernel); both ports share
// decode_attention_kernel below.  The dense entry passes rows == nullptr,
// which reads row b for sequence b: the same body, the same tile order and
// the same arithmetic, so paged and dense outputs agree bit for bit.
//
// Bound on this card: KV bytes.  A decode step reads every live key and
// value once (sum_b kv_len[b] * Hkv * Dh * 2 * bytes) and does ~4 flops per
// element read, two orders of magnitude under the bf16 ridge point, so the
// kernel is limited by device-memory bandwidth and by how many bytes it
// keeps in flight.
//
// Design: one block per (kv head, sequence) handles all g = Hq / Hkv query
// heads of the group, so each K/V element is read from device memory once
// and used g times from shared memory.  The block walks 64-key tiles up to
// kv_len[b] (tiles wholly past it are never loaded); bf16 is upcast to f32
// on load, the online softmax runs in f32 (one warp per head, shuffle
// reductions in a fixed order), and the output is written in q's dtype.
// Each key resolves its arena row from slots[b], or from
// block_tables[b, pos / table_block] at any table granularity.  This first
// version keeps one block per (head, sequence) and plain FMA; splitting the
// kv axis across blocks (more bytes in flight) is later work.
#include "common.cuh"

namespace {

constexpr int kTile = 64;       // keys per kv tile
constexpr int kThreads = 128;   // 4 warps

template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const TQ* __restrict__ q,       // [B, Hq, DH], contiguous
    const TKV* __restrict__ k,      // arena rows, strides below, d contiguous
    const TKV* __restrict__ v,
    TQ* __restrict__ o,             // [B, Hq, DH]
    const int* __restrict__ rows,   // nullptr: row b; else [B, rows_stride]
    long long rows_stride, int table_block,
    const int* __restrict__ kv_len, // [B]
    int Hq, int Hkv, int S,
    long long k_sr, long long k_ss, long long k_sh,
    long long v_sr, long long v_ss, long long v_sh, float scale) {
  using repro::kNegInf;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                      // [g][DH] scaled query
  float* ks = qs + g * DH;               // [kTile][DH + 1]
  float* vs = ks + kTile * (DH + 1);     // [kTile][DH]
  float* ps = vs + kTile * DH;           // [g][kTile] scores, then probs
  float* acc = ps + g * kTile;           // [g][DH]
  float* m_s = acc + g * DH;             // [g] running max
  float* l_s = m_s + g;                  // [g] running denominator
  float* a_s = l_s + g;                  // [g] this tile's rescale

  const long long qo = ((long long)b * Hq + (long long)hk * g) * DH;
  for (int i = tid; i < g * DH; i += kThreads) {
    qs[i] = repro::to_f32(q[qo + i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  const int n = min(kv_len[b], S);
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += kTile) {
    // stage the tile; keys at or past n are zero and masked below
    for (int i = tid; i < kTile * DH; i += kThreads) {
      const int j = i / DH;
      const int d = i - j * DH;
      const int pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < n) {
        const long long row =
            rows ? rows[b * rows_stride + pos / table_block] : b;
        kx = repro::to_f32(k[row * k_sr + pos * k_ss + hk * k_sh + d]);
        vx = repro::to_f32(v[row * v_sr + pos * v_ss + hk * v_sh + d]);
      }
      ks[j * (DH + 1) + d] = kx;
      vs[j * DH + d] = vx;
    }
    __syncthreads();

    for (int i = tid; i < g * kTile; i += kThreads) {
      const int h = i / kTile;
      const int j = i - h * kTile;
      float s = kNegInf;
      if (k0 + j < n) {
        s = 0.f;
#pragma unroll 16
        for (int d = 0; d < DH; ++d)
          s = fmaf(qs[h * DH + d], ks[j * (DH + 1) + d], s);
      }
      ps[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per head, two keys per lane
    for (int h = warp; h < g; h += kThreads / 32) {
      const float m_prev = m_s[h];
      const float l_prev = l_s[h];
      const float s0 = ps[h * kTile + lane];
      const float s1 = ps[h * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m_prev, mx);
      const float p0 = (k0 + lane < n) ? expf(s0 - m_cur) : 0.f;
      const float p1 = (k0 + lane + 32 < n) ? expf(s1 - m_cur) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[h * kTile + lane] = p0;
      ps[h * kTile + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[h] = alpha;
        l_s[h] = l_prev * alpha + sum;
        m_s[h] = m_cur;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * DH; i += kThreads) {
      const int h = i / DH;
      const int d = i - h * DH;
      float a = acc[i] * a_s[h];
#pragma unroll 16
      for (int j = 0; j < kTile; ++j)
        a = fmaf(ps[h * kTile + j], vs[j * DH + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < g * DH; i += kThreads) {
    const int h = i / DH;
    repro::store_f32(acc[i] / fmaxf(l_s[h], 1e-30f), &o[qo + i]);
  }
}

template <typename TQ, typename TKV, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* rows, long long rows_stride, int table_block,
                   const void* kv_len, int B, int Hq, int Hkv, int S,
                   long long k_sr, long long k_ss, long long k_sh,
                   long long v_sr, long long v_ss, long long v_sh,
                   float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const size_t smem = sizeof(float) * (2 * g * DH + kTile * (DH + 1) +
                                       kTile * DH + g * kTile + 3 * g);
  auto kernel = decode_attention_kernel<TQ, TKV, DH>;
  cudaError_t err = repro::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o),
      static_cast<const int*>(rows), rows_stride, table_block,
      static_cast<const int*>(kv_len), Hq, Hkv, S, k_sr, k_ss, k_sh, v_sr,
      v_ss, v_sh, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, void* o, const void* rows,
    long long rows_stride, int table_block, const void* kv_len, int B,
    int Hq, int Hkv, int S, int head_dim, long long k_sr, long long k_ss,
    long long k_sh, long long v_sr, long long v_ss, long long v_sh,
    float scale, int dtype_q, int dtype_kv, void* stream) {
  if (B == 0) return cudaSuccess;
#define LAUNCH(TQ, TKV, DH)                                                  \
  launch<TQ, TKV, DH>(q, k, v, o, rows, rows_stride, table_block, kv_len, B, \
                      Hq, Hkv, S, k_sr, k_ss, k_sh, v_sr, v_ss, v_sh, scale, \
                      static_cast<cudaStream_t>(stream))
  REPRO_DISPATCH(dtype_q, dtype_kv, head_dim, LAUNCH);
#undef LAUNCH
}
