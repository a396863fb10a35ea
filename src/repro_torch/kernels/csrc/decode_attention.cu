// Flash-decoding on Hopper (sm_90a): one new query token per sequence
// attends over a KV cache held in a slot arena.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/decode_attention.py:
//   paged_decode_attention_pallas (slots / block tables, the paged plane)
//   decode_attention_pallas       (dense cache, the gather plane)
// Both Pallas entry points share one body (_decode_kernel); both ports share
// the two kernels below.  The dense entry passes rows == nullptr, which reads
// row b for sequence b: the same body, the same chunk schedule and the same
// arithmetic, so paged and dense outputs agree bit for bit.
//
// Bound on this card: KV bytes.  A decode step reads every live key and
// value once (sum_b min(kv_len[b], S) * Hkv * Dh * 2 * bytes) and does ~4
// flops per element read, two orders of magnitude under the bf16 ridge
// point (~295 ops per byte), so tensor cores would not help: the limit is
// device-memory bandwidth, and reaching it takes blocks on every SM and
// enough bytes in flight on each.
//
// Design, and what each choice does about that bound:
// - Split-KV for parallelism.  The key axis is cut into fixed chunks of
//   kKvChunk keys; the grid is (Hkv * head groups, B, ceil(S / kKvChunk))
//   and a block whose chunk starts at or past n = min(kv_len[b], S)
//   returns at once.  At the serving shape (B = 8, 8 KV heads, kv_len up
//   to 1024) that is 264 live blocks for 132 SMs.  A block serves GH of
//   the g = Hq / Hkv query heads of its KV head, GH = 4, 2 or 1 at compile
//   time, the largest that divides g: all of them for llama3.2-1b (g = 4)
//   and qwen3-1.7b (g = 2), so each K/V byte is read from device memory
//   once there.
// - 16-byte loads for bytes in flight.  One key's row of one KV head is
//   Dh * sizeof(T) contiguous bytes; LPK = Dh * sizeof(T) / 16 neighbouring
//   lanes read it, 16 bytes each, so a warp reads 32 / LPK keys per load
//   instruction.  The arena row is resolved once per key, or once per
//   chunk when the chunk lies inside one table block (always for slots).
//   Each thread issues kUnroll K and kUnroll V loads before it uses any:
//   2 * kUnroll 16-byte loads in flight per thread.  bf16 stays bf16 until
//   it is in registers, where it is upcast to f32.
// - f32 registers, no barrier in the key loop.  Each group of LPK lanes
//   keeps its own online-softmax state (m, l, acc) for the block's query
//   heads over a fixed, strided share of the chunk's keys; a dot product is
//   reduced over the group by a fixed xor-shuffle tree.  At the end of the
//   chunk the groups of a warp merge by shuffles and the warps merge
//   through shared memory in warp order (the only barriers): one
//   (acc[Dh], m, l) per (b, query head, chunk) goes to an f32 workspace
//   [B, Hq, ceil(S / kKvChunk), Dh + 2] that the wrapper allocates.
// - A fixed-order merge for determinism.  decode_combine_kernel, a second
//   launch on the same stream (a programmatic dependent launch: its blocks
//   are scheduled as the partial blocks start and wait for their results
//   in griddepcontrol.wait), merges chunks 0 .. ceil(n / kKvChunk) - 1
//   of each (b, query head) in that order with the log-sum-exp rule and
//   writes acc / max(l, 1e-30) in q's dtype.  No atomics: the chunks
//   merged depend on n alone, never on S, the grid or the other sequences,
//   so paged == dense, a sequence's output does not depend on the rest of
//   its batch, kv_len = 0 gives zeros and kv_len > S equals S.
// - Tuning, measured on the H100 (numbers in PERF.md): kKvChunk =
//   128 beats 256 by 4-5% at both models' heads, 8 warps beat 4 by 3-6%,
//   8 loads in flight per lane group gain nothing over 4, and the
//   programmatic combine launch saves ~1 us.  To measure another value,
//   edit the constant and read chip_smoke.py's decode rows.
//   The wrapper's KV_CHUNK must equal kKvChunk and is checked against
//   repro_decode_kv_chunk() when the library loads.
// - The log-sum-exp mode (repro_decode_attention_lse) replaces the local
//   body of _local_decode_lse in src/repro/distributed/collectives.py
//   (sequence-parallel decode, where each rank holds a slice of the keys):
//   the same partial kernel and the same chunk merge, with another
//   epilogue.  The combine writes the merged unnormalized acc[DH], then l
//   and m, as f32 [B, Hq, DH + 2] instead of dividing: natural-log base,
//   scores scaled by sm_scale (the partial kernel's own convention), and
//   m = -inf, l = 0, acc = 0 for a row with no visible key.  The caller
//   merges the ranks' triples with the same rule (collectives.py).  Its
//   bound is the same KV bytes; the f32 output row adds 8 bytes a head.
// - head_dim 256 (recurrentgemma's local layers, 10 query heads over one
//   KV head): a bf16 key's row is 512 bytes, 32 lanes of 16 bytes, so a
//   warp reads one key per load and a lane group is the whole warp.  The
//   per-thread state (GH * 8 f32 each of q and acc) is what it is at 128;
//   only the xor tree is one level deeper.  g = 10 gives GH = 2.
// - An f32 cache at head_dim 256 (recurrentgemma built in f32, or served
//   from an f32 arena): a key's row is 1024 bytes, 64 pieces of 16 bytes,
//   more than a warp has lanes.  Each lane reads PPL = 2 pieces of the key,
//   piece e and piece e + 32 (so each load instruction of the warp still
//   reads 512 contiguous bytes), and the lane group stays the whole warp.
//   This was chosen over two warps a key because it keeps the body's one
//   rule, no barrier in the key loop: two warps would have to merge every
//   dot product through shared memory.  The unroll is halved (U = 2 keys in
//   flight a lane, each two pieces of K and two of V), so the loads in
//   flight, the per-thread elements of q and acc (GH * 8) and so the
//   registers are those of the bf16 case at head_dim 256.  An f32 cache
//   needs no tensor cores (the bound is its bytes, twice bf16's).
#include "common.cuh"

namespace {

constexpr int kKvChunk = 128;   // keys per chunk (one block)
constexpr int kWarps = 8;       // warps per block
constexpr int kUnroll = 4;      // keys per lane group in flight
constexpr int kThreads = kWarps * 32;
constexpr int kCombineThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of the cache's dtype, upcast to f32 in registers.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  // bf16 -> f32 is exact: the bf16 bits become the high half of the f32
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ int load_early(const int* p) {
  int x;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(x) : "l"(p));
  return x;
}

__host__ __device__ constexpr int n_chunks(int S) {
  return (S + kKvChunk - 1) / kKvChunk;
}

// One block per (KV head, group of GH of its query heads, b, chunk).  Two
// blocks per SM in the launch bounds (at most 128 registers a thread at 8
// warps) keep the serving shape's 264 live blocks in one wave; an explicit
// minimum also keeps ptxas from trading a few spilled registers for
// occupancy, which it does at GH = 1 and 2 without one.
template <typename TQ, typename TKV, int DH, int GH>
__global__ void __launch_bounds__(kThreads, 2) decode_partial_kernel(
    const TQ* __restrict__ q,       // [B, Hq, DH], contiguous
    const TKV* __restrict__ k,      // arena rows, strides below, d contiguous
    const TKV* __restrict__ v,
    float* __restrict__ part,       // [B, Hq, n_chunks(S), DH + 2]
    const int* __restrict__ rows,   // nullptr: row b; else [B, rows_stride]
    long long rows_stride, int table_block,
    const int* __restrict__ kv_len, // [B]
    int Hq, int Hkv, int S,
    long long k_sr, long long k_ss, long long k_sh,
    long long v_sr, long long v_ss, long long v_sh, float scale) {
  using repro::kNegInf;
  constexpr int EPL = Vec16<TKV>::kN;              // elements per load
  constexpr int PIECES = DH / EPL;                 // 16-byte pieces a key
  constexpr int PPL = PIECES > 32 ? PIECES / 32 : 1;  // pieces per lane
  constexpr int LPK = PIECES / PPL;                // lanes per key
  constexpr int EL = PPL * EPL;                    // elements per lane
  constexpr int KPW = 32 / LPK;                    // keys per warp per load
  constexpr int kStep = kWarps * KPW;              // keys per block per load
  constexpr int KPG = kKvChunk / kStep;            // keys per lane group
  constexpr int UP = kUnroll / PPL;                // keys in flight a lane
  constexpr int U = KPG < UP ? KPG : UP;
  static_assert(DH % EPL == 0 && LPK >= 1 && LPK <= 32 &&
                    PIECES == PPL * LPK && U >= 1, "head_dim");
  static_assert(kKvChunk % kStep == 0 && KPG % U == 0, "chunk");

  // the combine launch may start its prologue now (programmatic launch)
  asm volatile("griddepcontrol.launch_dependents;");
  const int b = blockIdx.y;
  const int c0 = blockIdx.z * kKvChunk;
  // the arena row of the chunk's first key is loaded beside kv_len[b]
  // (volatile, so it is not sunk below the early exit): K/V addresses are
  // then one memory round trip from the start, not two
  const int* rows_b = rows == nullptr ? nullptr : rows + b * rows_stride;
  const long long row0 =
      rows_b == nullptr ? b : load_early(rows_b + c0 / table_block);
  const int n = min(load_early(kv_len + b), S);
  if (c0 >= n) return;                   // the whole chunk is masked
  // keys of the chunk in another table block resolve their own row
  const bool per_key = rows_b != nullptr &&
      (min(c0 + kKvChunk, n) - 1) / table_block != c0 / table_block;
  const int g = Hq / Hkv;
  const int n_hg = g / GH;
  const int hk = blockIdx.x / n_hg;
  const int hq0 = hk * g + (blockIdx.x - hk * n_hg) * GH;  // first q head
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / LPK;            // the key this lane reads per load
  const int e = lane - grp * LPK;        // its 16-byte piece of that key

  // lane e holds elements [(j * LPK + e) * EPL, + EPL) of piece j < PPL
  float qr[GH][EL];
#pragma unroll
  for (int h = 0; h < GH; ++h) {
    const TQ* qp = q + ((long long)b * Hq + hq0 + h) * DH + e * EPL;
#pragma unroll
    for (int j = 0; j < PPL; ++j)
#pragma unroll
      for (int i = 0; i < EPL; ++i)
        qr[h][j * EPL + i] = repro::to_f32(qp[j * LPK * EPL + i]) * scale;
  }
  const TKV* kb = k + hk * k_sh + e * EPL;
  const TKV* vb = v + hk * v_sh + e * EPL;

  float m[GH], l[GH], acc[GH][EL];
#pragma unroll
  for (int h = 0; h < GH; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < EL; ++i) acc[h][i] = 0.f;
  }

  for (int it = 0; it < KPG; it += U) {
    if (c0 + it * kStep >= n) break;     // the rest of the chunk is masked
    uint4 kr[U][PPL], vr[U][PPL];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = c0 + ((it + u) * kWarps + warp) * KPW + grp;
      valid[u] = pos < n;
      const int p = valid[u] ? pos : n - 1;   // a masked key rereads n - 1
      const long long row = per_key ? rows_b[p / table_block] : row0;
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        kr[u][j] = __ldg(reinterpret_cast<const uint4*>(
            kb + row * k_sr + p * k_ss + j * LPK * EPL));
        vr[u][j] = __ldg(reinterpret_cast<const uint4*>(
            vb + row * v_sr + p * v_ss + j * LPK * EPL));
      }
    }
    float s[U][GH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EL];
#pragma unroll
      for (int j = 0; j < PPL; ++j) Vec16<TKV>::unpack(kr[u][j], kf + j * EPL);
#pragma unroll
      for (int h = 0; h < GH; ++h) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < EL; ++i) d = fmaf(qr[h][i], kf[i], d);
        // every lane of the group ends with the same sum (a + b == b + a)
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFull, d, off);
        s[u][h] = valid[u] ? d : kNegInf;
      }
    }
    float vf[U][EL];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < PPL; ++j)
        Vec16<TKV>::unpack(vr[u][j], vf[u] + j * EPL);
#pragma unroll
    for (int h = 0; h < GH; ++h) {
      float mx = m[h];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][h]);
      const float alpha = expf(m[h] - mx);
      float p[U];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = valid[u] ? expf(s[u][h] - mx) : 0.f;
        sum += p[u];
      }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int i = 0; i < EL; ++i) {
        float a = acc[h][i] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) a = fmaf(p[u], vf[u][i], a);
        acc[h][i] = a;
      }
      m[h] = mx;
    }
  }

  // merge the lane groups of the warp: a fixed xor tree over the groups
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < GH; ++h) {
      const float mo = __shfl_xor_sync(kFull, m[h], off);
      const float lo = __shfl_xor_sync(kFull, l[h], off);
      const float mx = fmaxf(m[h], mo);
      const float a = expf(m[h] - mx);
      const float ao = expf(mo - mx);
      l[h] = l[h] * a + lo * ao;
#pragma unroll
      for (int i = 0; i < EL; ++i) {
        const float xo = __shfl_xor_sync(kFull, acc[h][i], off);
        acc[h][i] = acc[h][i] * a + xo * ao;
      }
      m[h] = mx;
    }
  }

  // merge the warps in warp order through shared memory
  __shared__ float sm_acc[kWarps][GH][DH];
  __shared__ float sm_m[kWarps][GH];
  __shared__ float sm_l[kWarps][GH];
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < GH; ++h) {
#pragma unroll
      for (int j = 0; j < PPL; ++j)
#pragma unroll
        for (int i = 0; i < EPL; ++i)
          sm_acc[warp][h][(j * LPK + e) * EPL + i] = acc[h][j * EPL + i];
      if (e == 0) {
        sm_m[warp][h] = m[h];
        sm_l[warp][h] = l[h];
      }
    }
  }
  __syncthreads();
  float* dst = part + (((long long)b * Hq + hq0) * n_chunks(S) +
                       blockIdx.z) * (DH + 2);
  const long long head_stride = (long long)n_chunks(S) * (DH + 2);
  if (threadIdx.x < GH) {          // per head: the block max, the factors
    const int h = threadIdx.x;
    float mx = sm_m[0][h];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][h]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][h] - mx);
      lsum += sm_l[w][h] * f;
      sm_m[w][h] = f;              // each warp's factor replaces its max
    }
    dst[h * head_stride + DH] = mx;
    dst[h * head_stride + DH + 1] = lsum;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < GH * DH; t += kThreads) {
    const int h = t / DH;
    const int d = t - h * DH;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][h][d] * sm_m[w][h];
    dst[h * head_stride + d] = a;
  }
}

// One thread per (b, query head, d): merge the live chunks in order.  TO is
// q's dtype, or float with kLse: then the thread writes the merged acc[d],
// the d == 0 thread also l and m (-inf where no chunk is live), into an
// f32 row of DH + 2 instead of acc / max(l, 1e-30).
template <typename TO, int DH, bool kLse>
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const float* __restrict__ part, TO* __restrict__ o,
    const int* __restrict__ kv_len, int Hq, int S) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kCombineThreads + threadIdx.x;
  const int h = t / DH;
  const int d = t - h * DH;
  const int n = min(kv_len[b], S);       // not written by the partial kernel
  const int nc = n > 0 ? n_chunks(n) : 0;
  // wait for the partial kernel's writes (a no-op without programmatic
  // launch)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (t >= Hq * DH) return;
  const float* src = part + ((long long)b * Hq + h) * n_chunks(S) * (DH + 2);
  float mx = repro::kNegInf, l = 0.f, a = 0.f;
  // one pass, unrolled so that the loads of several chunks are in flight
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    const float* pc = src + c * (DH + 2);
    const float mc = pc[DH];
    const float m_new = fmaxf(mx, mc);
    const float f = expf(mx - m_new);
    const float fc = expf(mc - m_new);
    l = l * f + pc[DH + 1] * fc;
    a = a * f + pc[d] * fc;
    mx = m_new;
  }
  if constexpr (kLse) {
    float* dst = o + ((long long)b * Hq + h) * (DH + 2);
    dst[d] = a;
    if (d == 0) {
      dst[DH] = l;
      dst[DH + 1] = nc > 0 ? mx : __int_as_float(0xff800000);   // -inf
    }
  } else {
    repro::store_f32(a / fmaxf(l, 1e-30f),
                     &o[((long long)b * Hq + h) * DH + d]);
  }
}

template <typename TQ, typename TKV, int DH, int GH>
cudaError_t launch_heads(bool lse, const TQ* q, const TKV* k, const TKV* v,
                         void* o, float* part, const int* rows,
                         long long rows_stride, int table_block,
                         const int* kv_len, int B, int Hq,
                         int Hkv, int S, long long k_sr, long long k_ss,
                         long long k_sh, long long v_sr, long long v_ss,
                         long long v_sh, float scale, cudaStream_t stream) {
  if (S > 0) {
    const dim3 grid(Hkv * (Hq / Hkv / GH), B, n_chunks(S));
    decode_partial_kernel<TQ, TKV, DH, GH><<<grid, kThreads, 0, stream>>>(
        q, k, v, part, rows, rows_stride, table_block, kv_len, Hq, Hkv, S,
        k_sr, k_ss, k_sh, v_sr, v_ss, v_sh, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // programmatic launch: the combine blocks are scheduled as the partial
  // blocks start, and wait in griddepcontrol.wait for their results
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Hq * DH + kCombineThreads - 1) / kCombineThreads, B);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (lse)
    return cudaLaunchKernelEx(&cfg, decode_combine_kernel<float, DH, true>,
                              static_cast<const float*>(part),
                              static_cast<float*>(o), kv_len, Hq, S);
  return cudaLaunchKernelEx(&cfg, decode_combine_kernel<TQ, DH, false>,
                            static_cast<const float*>(part),
                            static_cast<TQ*>(o), kv_len, Hq, S);
}

// A block takes GH = 4, 2 or 1 query heads of its KV head: the largest
// that divides g, so g = 2 (qwen3) and g = 4 (llama) read each K/V byte once.
template <typename TQ, typename TKV, int DH>
cudaError_t launch(bool lse, const void* q, const void* k, const void* v,
                   void* o, void* part, const void* rows, long long rows_stride,
                   int table_block, const void* kv_len, int B, int Hq,
                   int Hkv, int S, long long k_sr, long long k_ss,
                   long long k_sh, long long v_sr, long long v_ss,
                   long long v_sh, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
#define HEADS(GH)                                                             \
  launch_heads<TQ, TKV, DH, GH>(                                             \
      lse, static_cast<const TQ*>(q), static_cast<const TKV*>(k),            \
      static_cast<const TKV*>(v), o,                                         \
      static_cast<float*>(part), static_cast<const int*>(rows), rows_stride, \
      table_block, static_cast<const int*>(kv_len), B, Hq, Hkv, S, k_sr,     \
      k_ss, k_sh, v_sr, v_ss, v_sh, scale, stream)
  if (g % 4 == 0) return HEADS(4);
  if (g % 2 == 0) return HEADS(2);
  return HEADS(1);
#undef HEADS
}

// The two entries share one argument list: o is q's dtype [B, Hq, DH] for
// repro_decode_attention, f32 [B, Hq, DH + 2] for repro_decode_attention_lse.
int run(bool lse, const void* q, const void* k, const void* v, void* o,
        void* part, const void* rows, long long rows_stride, int table_block,
        const void* kv_len, int B, int Hq, int Hkv, int S, int head_dim,
        long long k_sr, long long k_ss, long long k_sh, long long v_sr,
        long long v_ss, long long v_sh, float scale, int dtype_q,
        int dtype_kv, void* stream) {
  if (B == 0) return cudaSuccess;
#define LAUNCH(TQ, TKV, DH)                                                   \
  launch<TQ, TKV, DH>(lse, q, k, v, o, part, rows, rows_stride, table_block, \
                      kv_len, B, Hq, Hkv, S, k_sr, k_ss, k_sh, v_sr, v_ss,   \
                      v_sh, scale, static_cast<cudaStream_t>(stream))
  REPRO_DISPATCH(dtype_q, dtype_kv, head_dim, LAUNCH);
#undef LAUNCH
}

}  // namespace

extern "C" int repro_decode_kv_chunk() { return kKvChunk; }

#define REPRO_DECODE_ARGS                                                     \
  const void *q, const void *k, const void *v, void *o, void *part,          \
      const void *rows, long long rows_stride, int table_block,              \
      const void *kv_len, int B, int Hq, int Hkv, int S, int head_dim,       \
      long long k_sr, long long k_ss, long long k_sh, long long v_sr,        \
      long long v_ss, long long v_sh, float scale, int dtype_q,              \
      int dtype_kv, void *stream
#define REPRO_DECODE_PASS                                                     \
  q, k, v, o, part, rows, rows_stride, table_block, kv_len, B, Hq, Hkv, S,   \
      head_dim, k_sr, k_ss, k_sh, v_sr, v_ss, v_sh, scale, dtype_q,          \
      dtype_kv, stream

extern "C" int repro_decode_attention(REPRO_DECODE_ARGS) {
  return run(false, REPRO_DECODE_PASS);
}

extern "C" int repro_decode_attention_lse(REPRO_DECODE_ARGS) {
  return run(true, REPRO_DECODE_PASS);
}
