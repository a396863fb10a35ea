// Blocked flash attention with prefix-extend semantics on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   paged_flash_attention_pallas (keys from a slot arena, the paged plane)
//   flash_attention_pallas       (dense k/v, the gather plane and prefill)
// Both Pallas entry points share one body (_flash_kernel); both ports share
// the bodies below.  The dense entry passes rows == nullptr, which reads
// row b for sequence b: the same body, the same tile order and the same
// arithmetic, so paged and dense outputs agree bit for bit.
//
// Queries are the suffix [q_offset, q_offset + Sq) of each sequence; keys
// are positions [0, kv_valid).  Masks: causal, sliding window, per-row
// kv_len, and the GQA head map h -> h / g.
//
// Bound on this card: at the serving shape (B = 8, 384 new queries over
// 512 keys) the call moves ~30 MB and does ~5 GFLOP, so bytes bound it on
// paper (~9-10 us at 3.35 TB/s) and the products take as long at a third of
// the tensor-core rate: both matter, and neither can be left to scalar FMA.
//
// Two bodies, chosen by dtype (dispatch, not fallback: each dtype pair has
// exactly one):
//
// flash_attention_tc_kernel, bf16 q with a bf16 cache (every call of the
// serving path), after FlashAttention-2:
// - Grid (Hq, B, query tiles), the query tiles in reverse order so the
//   causal tiles with the most keys start first; the heads of one KV head
//   are neighbours in the grid, so their K/V tiles come from L2.  One head
//   per block: the K/V bytes a block copies per query row depend only on
//   its row count, whether that is 64 queries of one head or 16 of each of
//   4 heads, so packing the g heads of a KV head into a block would change
//   nothing that more rows of one head do not.
// - Warps of 16 query rows: 4 a block (64 rows) at Dh <= 64, 8 (128 rows)
//   at Dh 128, the faster of the two at each head_dim on the H100
//   (PERF.md); 8 at Dh 256 too, untuned.  The Q tile is copied once with
//   16-byte cp.async and, up to Dh 128, held in registers as mma A
//   fragments (ldmatrix) for the whole key loop; at Dh 256
//   (recurrentgemma) they are reloaded from shared memory at each k-step,
//   so that they do not spill beside the 128 registers of the O
//   accumulator.
// - K/V go through a 3-stage cp.async ring of 64-key tiles (32-key at
//   Dh 256, whose 64-key score tile would spill beside the 128 registers of
//   the O accumulator), 16 bytes a thread, two tiles in flight while one
//   computes; one barrier a tile.
//   With slots (or a table block holding every key) the arena row is read
//   once a block; with block tables once per key row a thread copies, so a
//   tile may cross a table-block boundary anywhere.  Keys at or past
//   kv_len are zero-filled, never read.  Rows are padded by 16 bytes in
//   shared memory, which makes ldmatrix (K) and ldmatrix.trans (V) free of
//   bank conflicts.
// - S = Q K^T and O += P V on tensor cores (mma.sync m16n8k16, bf16 in,
//   f32 accumulators).  The scale (times log2 e) is applied to S in f32,
//   so Q is rounded only once, and the online softmax runs on S in
//   registers with exp2f; a row's max is reduced over the 4 lanes that
//   hold it with a fixed xor order, its sum per lane and over the 4 lanes
//   once at the end.  P is rounded to bf16 in registers and used directly
//   as the A operand of P V (the C fragment of one product is the A
//   fragment of the next): it never touches shared memory.
// - Tiles are pruned by the rule of flash_attention.py:78-82 (past kv_len,
//   above the causal diagonal, left of the window) for the block, and
//   again for each warp's 16 rows; per-element masks run only on tiles
//   that straddle an edge.  Masked scores are the finite kNegInf and a row
//   with no visible key gives 0 (l clamped at 1e-30).  Sq, kv_valid and
//   q_offset need not be tile multiples.
// - Epilogue: acc / max(l, 1e-30) in f32, one rounding to bf16, staged in
//   the warp's own rows of the Q tile and written with 16-byte stores.
// - No cross-block reduction and no atomics, so two calls agree bitwise
//   and a sequence's output does not depend on the rest of its batch.
// Every q/k/v row start must be 16-byte aligned (the wrapper checks).
//
// flash_attention_kernel, f32 q or f32 cache: the first port's FMA body,
// kept for the f32 instantiations, whose tests hold them to f32 accuracy
// (a bf16 or TF32 product cannot meet it).  Tiles are staged in shared
// memory as f32; each of the 128 threads owns a 4x8 block of the score
// tile and a 4x(Dh/8) block of the output in registers; the online softmax
// runs in f32 with 8-lane shuffle reductions in a fixed order.
#include <type_traits>

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

// ---------------------------------------------------------------------------
// Tensor-core body: bf16 q and cache
// ---------------------------------------------------------------------------

template <int DH>
struct TcTile {
  // warps of 16 query rows a block: 8 at Dh >= 128 (one block an SM either
  // way, by registers), 4 below (three blocks an SM at Dh 64)
  static constexpr int kWarps = DH >= 128 ? 8 : 4;
  // keys a K/V tile: 64, or 32 at Dh 256, where a 64-key tile's 32 score
  // registers beside the 128 of the O accumulator spill; three 64-key
  // stages and the 128-row Q tile would also need 270,336 bytes of the
  // 232,448 a block may have (32-key tiles need 168,960)
  static constexpr int kBK = DH >= 256 ? 32 : BK;
  static constexpr int kStages = 3;       // K/V tiles in the cp.async ring
  // Q held in registers as mma A fragments for the whole key loop up to
  // Dh 128; at 256 those 64 registers beside the 128 of the O accumulator
  // would spill, so the fragments are reloaded from the Q tile in shared
  // memory at each k-step (one ldmatrix each)
  static constexpr bool kQInRegs = DH <= 128;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kBQ = kWarps * 16;           // query rows a block
  static constexpr int kChunks = DH / 8;            // 16-byte chunks a row
  static constexpr int kRowBytes = DH * 2 + 16;     // padded shared row
  static constexpr int kTileBytes = kBK * kRowBytes;
  // the Q tile, then kStages stages of (K tile, V tile)
  static constexpr int kSmemBytes =
      kBQ * kRowBytes + 2 * kStages * kTileBytes;
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !pred (the
// source is then not read)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane i addresses row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr,
                                                  unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// One block per (query head, sequence, query tile of 64); warp w owns query
// rows 16w .. 16w + 15 of the tile.  Fragment layouts of m16n8k16 (lane =
// 4 * gr + tq): a C fragment holds rows gr and gr + 8, columns 2tq and
// 2tq + 1 of its 16x8 tile.
template <int DH>
__global__ void __launch_bounds__(TcTile<DH>::kThreads)
    flash_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Sq, Hq, DH], strides below
    const __nv_bfloat16* __restrict__ k,   // arena rows, strides below
    const __nv_bfloat16* __restrict__ v,
    __nv_bfloat16* __restrict__ o,         // [B, Sq, Hq, DH], contiguous
    const int* __restrict__ rows,   // nullptr: row b; else [B, rows_stride]
    long long rows_stride, int table_block,
    const int* __restrict__ kv_len, // [B], or nullptr: every key valid
    int Sq, int Hq, int Hkv, int kv_valid,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sr, long long k_ss, long long k_sh,
    long long v_sr, long long v_ss, long long v_sh,
    int causal, int window, int q_offset, float scale_log2) {
  using repro::kNegInf;
  using T = TcTile<DH>;
  constexpr int kStages = T::kStages;
  constexpr int BK = T::kBK;           // keys a tile (shadows the FMA body's)
  constexpr int KS = DH / 16;          // k-steps of Q K^T
  constexpr int NT = BK / 8;           // key n-tiles of S
  constexpr int DT = DH / 8;           // d n-tiles of O
  // K (V) copies a thread per tile, Q copies a thread
  constexpr int kLoads = BK * T::kChunks / T::kThreads;
  constexpr int kQLoads = T::kBQ * T::kChunks / T::kThreads;
  static_assert(kLoads * T::kThreads == BK * T::kChunks, "tile copy split");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::kBQ;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;            // C fragment row (and row + 8)
  const int tq = lane & 3;             // C fragment column pair

  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* qs = tc_smem;
  unsigned char* kvs = tc_smem + T::kBQ * T::kRowBytes;

  const int kvl = max(kv_len ? min(kv_len[b], kv_valid) : kv_valid, 0);
  // one arena row holds every key of the sequence (dense k/v, slots, or a
  // table block as long as kv_len): read it once here, not per key row
  const bool one_row = rows == nullptr || kvl <= table_block;
  const long long row_b =
      rows == nullptr ? b : (one_row ? rows[b * rows_stride] : 0);
  const int rows_q = min(T::kBQ, Sq - q0);
  const int qa0 = q_offset + q0;       // absolute position of query row 0
  // block-level pruning: key tiles [t_begin, t_end) hold every visible key
  int k_end = kvl;
  if (causal) k_end = min(k_end, qa0 + rows_q);
  const int t_begin = window > 0 ? max(0, qa0 - window + 1) / BK : 0;
  const int t_end = (k_end + BK - 1) / BK;

  // Q tile, rows past Sq zero-filled
  {
    const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int c = tid + i * T::kThreads;
      const int r = c / T::kChunks;
      const int ch = c % T::kChunks;
      const bool ok = r < rows_q;
      cp_async16(smem_addr(qs + r * T::kRowBytes + ch * 16),
                 ok ? qb + (long long)(q0 + r) * q_ss + ch * 8 : qb, ok);
    }
  }
  // K/V tile t into stage st; keys at or past kv_len zero-filled
  auto load_kv = [&](int t, int st) {
    unsigned char* ks = kvs + 2 * st * T::kTileBytes;
    unsigned char* vs = ks + T::kTileBytes;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = tid + i * T::kThreads;
      const int j = c / T::kChunks;
      const int ch = c % T::kChunks;
      const int pos = t * BK + j;
      const bool ok = pos < kvl;
      long long row = row_b;
      if (!one_row && ok) row = rows[b * rows_stride + pos / table_block];
      const __nv_bfloat16* kp = k + row * k_sr + (long long)pos * k_ss +
                                hk * k_sh + ch * 8;
      const __nv_bfloat16* vp = v + row * v_sr + (long long)pos * v_ss +
                                hk * v_sh + ch * 8;
      const int off = j * T::kRowBytes + ch * 16;
      cp_async16(smem_addr(ks + off), ok ? kp : k, ok);
      cp_async16(smem_addr(vs + off), ok ? vp : v, ok);
    }
  };

  // prologue: Q and the first kStages - 1 tiles, one copy group each tile
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_begin + i < t_end) load_kv(t_begin + i, i);
    cp_async_commit();
  }

  unsigned qf[T::kQInRegs ? KS : 1][4];  // Q as A fragments, per k-step
  float m[2] = {kNegInf, kNegInf};     // running max (log2 domain), rows gr, gr+8
  float l[2] = {0.f, 0.f};             // this lane's share of the row sums
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  const int qw0 = qa0 + warp * 16;     // absolute position of the warp's row 0
  const bool warp_rows = warp * 16 < rows_q;
  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) % kStages;
    cp_async_wait<kStages - 2>();      // this thread's copies of tile t done
    __syncthreads();                   // tile t visible; the stage of t - 1 free
    if (t + kStages - 1 < t_end)
      load_kv(t + kStages - 1, (st + kStages - 1) % kStages);
    cp_async_commit();
    if (T::kQInRegs && t == t_begin) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(smem_addr(qs + (warp * 16 + (lane & 15)) * T::kRowBytes +
                              (ks * 16 + (lane >> 4) * 8) * 2),
                    qf[ks]);
    }
    const int k0 = t * BK;
    // warp-level pruning, and whether any key of the tile is masked
    bool live = warp_rows;
    if (causal) live = live && k0 <= qw0 + 15;
    if (window > 0) live = live && k0 + BK - 1 > qw0 - window;
    if (!live) continue;
    const bool edge = k0 + BK > kvl || (causal && k0 + BK - 1 > qw0) ||
                      (window > 0 && k0 <= qw0 + 15 - window);
    const unsigned char* ks = kvs + 2 * st * T::kTileBytes;
    const unsigned char* vs = ks + T::kTileBytes;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int ks_ = 0; ks_ < KS; ++ks_) {
      const int qi = T::kQInRegs ? ks_ : 0;
      if (!T::kQInRegs)
        ldmatrix_x4(smem_addr(qs + (warp * 16 + (lane & 15)) * T::kRowBytes +
                              (ks_ * 16 + (lane >> 4) * 8) * 2),
                    qf[0]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // keys 16np .. 16np+15, d 16ks .. 16ks+15: B fragments of 2 n-tiles
        unsigned bk[4];
        ldmatrix_x4(smem_addr(ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                       T::kRowBytes +
                              (ks_ * 16 + ((lane >> 3) & 1) * 8) * 2),
                    bk);
        mma_bf16(s[2 * np], qf[qi], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[qi], bk[2], bk[3]);
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[nt][i] * scale_log2;
        if (edge) {
          const int kpos = k0 + nt * 8 + 2 * tq + (i & 1);
          const int qpos = qw0 + gr + (i >> 1) * 8;
          bool ok = kpos < kvl;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) x = kNegInf;
        }
        s[nt][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      // a row with no visible key yet: its masked scores give exp2(-1e30)
      msub[r] = mx[r] == kNegInf ? 0.f : mx[r];
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }
    // P in bf16 as the A fragments of P V, built one k-step (n-tiles 2kk
    // and 2kk + 1) at a time, just before that k-step's products
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      unsigned pf[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * kk + j;
        const float p0 = exp2f(s[nt][0] - msub[0]);
        const float p1 = exp2f(s[nt][1] - msub[0]);
        const float p2 = exp2f(s[nt][2] - msub[1]);
        const float p3 = exp2f(s[nt][3] - msub[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pf[2 * j] = pack_bf16(p0, p1);
        pf[2 * j + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        // keys 16kk .. 16kk+15, d 16dp .. 16dp+15, transposed: B fragments
        // of d n-tiles 2dp and 2dp+1
        unsigned bv[4];
        ldmatrix_x4_trans(
            smem_addr(vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               T::kRowBytes +
                      (dp * 16 + (lane >> 4) * 8) * 2),
            bv);
        mma_bf16(acc[2 * dp], pf, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pf, bv[2], bv[3]);
      }
    }
  }
  if (t_begin >= t_end) {              // no key tile: Q copies still pending
    cp_async_wait<0>();
    __syncthreads();
  }

  // epilogue: the warp's rows of the Q tile (read only by this warp, and
  // only at t_begin) stage the output for 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  unsigned char* ow = qs + warp * 16 * T::kRowBytes;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = (dt * 8 + 2 * tq) * 2;
    *reinterpret_cast<unsigned*>(ow + gr * T::kRowBytes + col) =
        pack_bf16(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    *reinterpret_cast<unsigned*>(ow + (gr + 8) * T::kRowBytes + col) =
        pack_bf16(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * T::kChunks; c += 32) {
    const int r = c / T::kChunks;
    const int ch = c % T::kChunks;
    const int qr = q0 + warp * 16 + r;
    if (qr >= Sq) continue;
    *reinterpret_cast<uint4*>(o + (((long long)b * Sq + qr) * Hq + h) * DH +
                              ch * 8) =
        *reinterpret_cast<const uint4*>(ow + r * T::kRowBytes + ch * 16);
  }
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const void* rows, long long rows_stride,
                      int table_block, const void* kv_len, int B, int Sq,
                      int Hq, int Hkv, int kv_valid, long long q_sb,
                      long long q_ss, long long q_sh, long long k_sr,
                      long long k_ss, long long k_sh, long long v_sr,
                      long long v_ss, long long v_sh, int causal, int window,
                      int q_offset, float scale, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  using T = TcTile<DH>;
  auto kernel = flash_attention_tc_kernel<DH>;
  constexpr int smem = T::kSmemBytes;
  cudaError_t err = repro::set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (Sq + T::kBQ - 1) / T::kBQ);
  kernel<<<grid, T::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<const int*>(rows), rows_stride, table_block,
      static_cast<const int*>(kv_len), Sq, Hq, Hkv, kv_valid, q_sb, q_ss,
      q_sh, k_sr, k_ss, k_sh, v_sr, v_ss, v_sh, causal, window, q_offset,
      scale * 1.4426950408889634f);          // log2(e): the kernel uses exp2
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int DH>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       const void* rows, long long rows_stride,
                       int table_block, const void* kv_len, int B, int Sq,
                       int Hq, int Hkv, int kv_valid, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sr,
                       long long k_ss, long long k_sh, long long v_sr,
                       long long v_ss, long long v_sh, int causal, int window,
                       int q_offset, float scale, cudaStream_t stream) {
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

// bf16 q with a bf16 cache takes the tensor-core body, any f32 operand the
// FMA body (which is then never built for bf16 / bf16)
template <typename TQ, typename TKV, int DH, typename... Args>
cudaError_t launch(Args... args) {
  if constexpr (std::is_same_v<TQ, __nv_bfloat16> &&
                std::is_same_v<TKV, __nv_bfloat16>)
    return launch_tc<DH>(args...);
  else
    return launch_fma<TQ, TKV, DH>(args...);
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
