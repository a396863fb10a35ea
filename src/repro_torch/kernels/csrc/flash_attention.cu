// Blocked flash attention with prefix-extend semantics on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   paged_flash_attention_pallas (keys from a slot arena, the paged plane)
//   flash_attention_pallas       (dense k/v, the gather plane and prefill)
// Both Pallas entry points share one body (_flash_kernel); both ports share
// flash_attention_kernel below.  The dense entry passes rows == nullptr,
// which reads row b for sequence b: the same body, the same tile order and
// the same arithmetic, so paged and dense outputs agree bit for bit.
//
// Queries are the suffix [q_offset, q_offset + Sq) of each sequence; keys
// are positions [0, kv_valid).  Masks: causal, sliding window, per-row
// kv_len, and the GQA head map h -> h / g.
//
// Bound on this card: operations at large Sq (a 64x64 tile pair does
// 2 * 64 * 64 * Dh multiply-adds on 2 * 64 * Dh loaded elements), bytes at
// small Sq, where each query tile re-reads the whole cached prefix.
//
// Design: one block per (query tile of 64, query head, sequence) walks
// 64-key tiles up to min(kv_valid, causal limit) and skips tiles that the
// rule of flash_attention.py:78-82 proves wholly masked (past kv_len, above
// the causal diagonal, left of the window), so masked work is never loaded.
// Ragged edges (Sq or kv_valid not a tile multiple) are masked in the
// kernel, so every shape runs here.  Tiles are staged in shared memory as
// f32 (bf16 upcast on load); each of the 128 threads owns a 4x8 block of
// the score tile and a 4x(Dh/8) block of the output in registers; the
// online softmax runs in f32 with 8-lane shuffle reductions in a fixed
// order.  This first version uses plain FMA; tensor cores (mma/wgmma) and
// TMA are later work.
#include "common.cuh"

namespace {

constexpr int BQ = 64;          // queries per tile
constexpr int BK = 64;          // keys per tile
constexpr int kThreads = 128;   // 16 row groups x 8 column lanes

template <typename TQ, typename TKV, int DH>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const TQ* __restrict__ q,       // [B, Sq, Hq, DH], strides below
    const TKV* __restrict__ k,      // arena rows, strides below
    const TKV* __restrict__ v,
    TQ* __restrict__ o,             // [B, Sq, Hq, DH], contiguous
    const int* __restrict__ rows,   // nullptr: row b; else [B, rows_stride]
    long long rows_stride, int table_block,
    const int* __restrict__ kv_len, // [B], or nullptr: every key valid
    int Sq, int Hq, int Hkv, int kv_valid,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sr, long long k_ss, long long k_sh,
    long long v_sr, long long v_ss, long long v_sh,
    int causal, int window, int q_offset, float scale) {
  using repro::kNegInf;
  constexpr int DC = DH / 8;           // output columns per thread
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;             // rows ty*4 .. ty*4+3
  const int tx = tid & 7;              // columns tx, tx+8, ...

  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][DH + 1]
  float* ks = qs + BQ * (DH + 1);      // [BK][DH + 1]
  float* vs = ks + BK * (DH + 1);      // [BK][DH]
  float* ps = vs + BK * DH;            // [BQ][BK + 1]

  for (int i = tid; i < BQ * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i - r * DH;
    float x = 0.f;
    if (q0 + r < Sq)
      x = repro::to_f32(q[b * q_sb + (long long)(q0 + r) * q_ss +
                          (long long)h * q_sh + d]) * scale;
    qs[r * (DH + 1) + d] = x;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kvl = kv_len ? min(kv_len[b], kv_valid) : kv_valid;
  const int qa0 = q_offset + q0;       // absolute position of query row 0
  for (int k0 = 0; k0 < kv_valid; k0 += BK) {
    // block-level pruning (uniform across the block)
    bool run = k0 < kvl;
    if (causal) run = run && (k0 <= qa0 + BQ - 1);
    if (window > 0) run = run && (k0 + BK - 1 > qa0 - window);
    if (!run) continue;

    __syncthreads();                   // previous tile fully consumed
    for (int i = tid; i < BK * DH; i += kThreads) {
      const int j = i / DH;
      const int d = i - j * DH;
      const int pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < kv_valid) {
        const long long row =
            rows ? rows[b * rows_stride + pos / table_block] : b;
        kx = repro::to_f32(k[row * k_sr + pos * k_ss + hk * k_sh + d]);
        vx = repro::to_f32(v[row * v_sr + pos * v_ss + hk * v_sh + d]);
      }
      ks[j * (DH + 1) + d] = kx;
      vs[j * DH + d] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * (DH + 1) + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) bk[c] = ks[(tx + 8 * c) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = fmaf(a[i], bk[c], s[i][c]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qa0 + ty * 4 + i;
      bool valid[8];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int kpos = k0 + tx + 8 * c;
        bool ok = kpos < kvl;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        valid[c] = ok;
        if (!ok) s[i][c] = kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      // the 8 lanes holding one row are consecutive lanes of a warp
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = valid[c] ? expf(s[i][c] - m_cur) : 0.f;
        ps[(ty * 4 + i) * (BK + 1) + tx + 8 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_cur;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j * DH + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    TQ* orow = o + (((long long)b * Sq + r) * Hq + h) * DH;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      repro::store_f32(acc[i][c] * inv, &orow[tx + 8 * c]);
  }
}

template <typename TQ, typename TKV, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const void* rows, long long rows_stride, int table_block,
                   const void* kv_len, int B, int Sq, int Hq, int Hkv,
                   int kv_valid, long long q_sb, long long q_ss,
                   long long q_sh, long long k_sr, long long k_ss,
                   long long k_sh, long long v_sr, long long v_ss,
                   long long v_sh, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) +
                                       BK * DH + BQ * (BK + 1));
  auto kernel = flash_attention_kernel<TQ, TKV, DH>;
  cudaError_t err = repro::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o),
      static_cast<const int*>(rows), rows_stride, table_block,
      static_cast<const int*>(kv_len), Sq, Hq, Hkv, kv_valid, q_sb, q_ss,
      q_sh, k_sr, k_ss, k_sh, v_sr, v_ss, v_sh, causal, window, q_offset,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* rows,
    long long rows_stride, int table_block, const void* kv_len, int B,
    int Sq, int Hq, int Hkv, int kv_valid, int head_dim, long long q_sb,
    long long q_ss, long long q_sh, long long k_sr, long long k_ss,
    long long k_sh, long long v_sr, long long v_ss, long long v_sh,
    int causal, int window, int q_offset, float scale, int dtype_q,
    int dtype_kv, void* stream) {
  if (B == 0 || Sq == 0) return cudaSuccess;
#define LAUNCH(TQ, TKV, DH)                                                  \
  launch<TQ, TKV, DH>(q, k, v, o, rows, rows_stride, table_block, kv_len, B, \
                      Sq, Hq, Hkv, kv_valid, q_sb, q_ss, q_sh, k_sr, k_ss,   \
                      k_sh, v_sr, v_ss, v_sh, causal, window, q_offset,      \
                      scale, static_cast<cudaStream_t>(stream))
  REPRO_DISPATCH(dtype_q, dtype_kv, head_dim, LAUNCH);
#undef LAUNCH
}
