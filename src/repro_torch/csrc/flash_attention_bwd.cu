// Flash attention backward for Hopper (sm_90a).
//
// The backward of flash_attention.cu (K1).  The JAX package has no attention
// backward kernel: its training path differentiates the plain jnp attention
// (src/repro/models/layers.py::blocked_attention) with autodiff.  The port
// runs attention through K1 on the card, so its gradient is a kernel too.
// Same masks as the forward (causal j <= i, window j > i - window, keys past
// Skv), GQA head h on kv head h / (H / KV), q/k of head dim D and v/o of
// their own Dv.  With the forward's log-sum-exp L_i of the scaled scores
// and D_i = sum_d dO_id O_id (over Dv):
//   P_ij  = exp(scale q_i.k_j - L_i)          (0 where masked)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i,  dV_j = sum_i P_ij dO_i
// P is recomputed in fp32 from q, k and L (the bf16 forward rounded P to bf16
// for its P V product; here P and dS are rounded to bf16 only as the A
// operands of the dV, dQ and dK products).
//
// Design.  Three launches on the caller's stream; which three is fixed by
// the dtype and the widths (D, DV) the head dims run at (head_dims.cuh:
// each rounds up to a width the kernels are built for; the extra columns
// are zero-filled in the tiles and never stored):
//   * bf16, D or Dv above 32, for Hopper, at D in {64, 96, 128} and DV in
//     {64, 128}:
//     1. delta: D_i into the fp32 scratch, DV / 8 lanes per row, 16-byte
//        loads, several rows per warp;
//     2. bwd_wgmma: one block per (batch * kv head, 128-row k tile), two
//        consumer warpgroups of 64 k rows and a producer warpgroup.  It
//        loops over the G query heads of the kv head and over the 64-row q
//        tiles that can see the k tile (from k0 under the causal mask, up
//        to k0 + 127 + window under a window); Q, dO, lse and delta come
//        through a three-stage cp.async ring with mbarriers.  Five wgmma
//        products per q tile: S^T = K Q^T and dP^T = V dO^T from shared
//        memory; dV += P^T dO and dK += dS^T Q with P^T, dS^T from
//        registers; dQ = dS K with dS^T staged in shared memory.  dQ is
//        added with float2 atomics into a zeroed fp32 (B, Sq, H, D)
//        accumulator that follows delta in the scratch, so its sum order,
//        and its last bits, change from run to run.  The products of N = D
//        (dK, and dQ split between the two warpgroups) each read whole or
//        leading parts of 64-column blocks: at D 96, dK is one n64 and one
//        n32 product (column blocks 0 and 1) and dQ is n64 on warpgroup 0
//        and n32 on warpgroup 1; S^T and dP^T take 6 and DV / 16 k16 steps;
//     3. bwd_dq_finish: dq = scale * that accumulator, as bf16.
//     dK and dV sum G * Sq terms a key.  From bw::TWO_TERM_GROUP query heads
//     a kv head on, one bf16 term of P and dS, and D_i from the bf16 O, put
//     a few elements past the bound (granite-20b's G 48 at the first keys),
//     so there steps 1 and 2 become: the wgmma kernel's ROW_SUMS pass, which
//     stops after P and adds D_i = sum_j P_ij dP_ij in fp32 with atomics
//     (the S^T and dP^T products again), then its TWO_TERM pass, which feeds
//     P^T and dS^T to the dV and dK products as hi + lo bf16 terms (two
//     products each): nine products a visible pair where five do.
//   * bf16, D and Dv at most 32, and f32: delta (one warp per row for f32), then
//     dQ: one block per (batch * head, 64-row q tile) over the kv tiles the
//     forward visits, recomputing S and dP; then dK/dV: one block per
//     (batch * kv head, 64-row k tile) over the G query heads and the q
//     tiles that can see it.  Each gradient row has one owner, so these
//     need no atomics and are deterministic; they run seven products where
//     five would do.  bf16: 4 warps of 16 rows on mma.sync m16n8k16; f32:
//     8 warps, 4 threads per row, fp32 FMAs (no TF32).
// q/k/v/o/dO are read in their (B, S, H, D or Dv) layout through strides;
// dQ, dK, dV are written contiguous.
//
// What bounds it.  The algorithm needs five products of 2·D flops per
// visible (i, j) pair (S, dP, dV, dQ, dK), 2.5x the forward's two: at the
// training shape (B=4, S=2048, H=32, KV=8, D=64, bf16, causal) 171.8 GFLOP,
// ~0.17 ms at 989 TFLOP/s, against ~0.04 ms for the bytes (q, k, v, o, dO,
// L read once; dQ, dK, dV written once): operations-bound.  The wgmma
// kernel runs those five products on the tensor cores with the copies in
// the background; its dQ atomics (64 x D fp32 per q tile) go to L2.  With
// Dv != D the products take 2·B·H·(3D + 2Dv) flops a visible pair (S, dQ,
// dK over D; dP, dV over Dv): at minicpm3's shape (B 4, S 2048, H = KV =
// 40, D 96, Dv 64, causal) 279 GFLOP, ~0.28 ms.  On an
// H100 at 700 W, taking parts out of it put ~0.2 ms of its ~0.77 ms at that
// shape in the P / dS arithmetic and ~0.17 ms in dQ (product, barrier,
// atomics): the two consumer warpgroups meet at a barrier every q tile, so
// one's arithmetic seldom overlaps the other's products.
//
// Interface: plain C, loaded with ctypes.  Returns cudaGetLastError() after
// the launches (0 on success), or -1 for a head dim / dtype it was not
// built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_dims.cuh"
#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 64;  // rows per tile, q and kv alike
constexpr int BLOCK_N = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq)
  void* dq;          // (B, Sq, H, D) contiguous
  void* dk;          // (B, Skv, KV, D) contiguous
  void* dv;          // (B, Skv, KV, Dv) contiguous
  int B, Sq, Skv, H, KV, G;
  int D, Dv;         // the real head dims of q/k and of v/o (at most the kernel's widths)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  float scale;
  int causal;
  int window;  // 0 = off; otherwise 0 < window < Sq
};

// Key range [lo, hi) that some row of the q tile at q0 can see (as in the forward).
__device__ __forceinline__ void kv_range(const Params& p, int q0, int& lo, int& hi) {
  hi = p.Skv;
  if (p.causal) hi = min(hi, q0 + BLOCK_M);
  lo = p.window ? max(0, q0 - p.window + 1) : 0;
  lo = (lo / BLOCK_N) * BLOCK_N;
}

// Query range [lo, hi) that some row of the k tile at k0 is visible to.
__device__ __forceinline__ void q_range(const Params& p, int k0, int& lo, int& hi) {
  lo = p.causal ? k0 : 0;  // k0 is a multiple of 64, so lo starts a q tile
  hi = p.Sq;
  if (p.window) hi = min(hi, k0 + BLOCK_N - 1 + p.window);
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  bool ok = i < p.Sq && j < p.Skv;
  if (p.causal) ok = ok && j <= i;
  if (p.window) ok = ok && j > i - p.window;
  return ok;
}

// ----------------------------------------------------------------- delta

__global__ void __launch_bounds__(256) bwd_delta(Params p) {
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = static_cast<int>(row % p.H);
  const int i = static_cast<int>((row / p.H) % p.Sq);
  const int b = static_cast<int>(row / (static_cast<long long>(p.H) * p.Sq));
  const float* o = static_cast<const float*>(p.o) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
  const float* d = static_cast<const float*>(p.dout) + b * p.do_sb + i * p.do_ss + h * p.do_sh;
  float acc = 0.f;
  for (int c = lane; c < p.Dv; c += 32) acc += o[c] * d[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.Sq + i] = acc;
}

// ------------------------------------------------------------------- f32

// rows [row0, row0 + 64) of a (S, cols) slice with row stride `rs` into a
// D-wide shared tile with row stride LD, zero past `limit` and from column
// `cols` on
template <int D, int LD>
__device__ __forceinline__ void load_f32(float* dst, const float* src, long long rs,
                                         int row0, int limit, int cols, int tid) {
  for (int idx = tid; idx < 64 * D; idx += 256) {
    const int r = idx / D, d = idx % D, row = row0 + r;
    dst[r * LD + d] = row < limit && d < cols ? src[row * rs + d] : 0.f;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(256) bwd_dq_f32(Params p) {
  constexpr int LD = D + 1, LDV = DV + 1, LP = BLOCK_N + 1;
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;
  float* dOs = Qs + BLOCK_M * LD;    // BLOCK_M x LDV
  float* Ks = dOs + BLOCK_M * LDV;
  float* Vs = Ks + BLOCK_N * LD;     // BLOCK_N x LDV
  float* dSs = Vs + BLOCK_N * LDV;   // BLOCK_M x LP

  const int tid = threadIdx.x, bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;  // long tiles first
  load_f32<D, LD>(Qs, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                  q0, p.Sq, p.D, tid);
  load_f32<DV, LDV>(dOs, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
                    p.do_ss, q0, p.Sq, p.Dv, tid);
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const int r = tid >> 2, qd = tid & 3, i = q0 + r;
  const float lse = i < p.Sq ? p.lse[static_cast<long long>(bh) * p.Sq + i] : INFINITY;
  const float dlt = i < p.Sq ? p.delta[static_cast<long long>(bh) * p.Sq + i] : 0.f;
  float acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) acc[c] = 0.f;

  int lo, hi;
  kv_range(p, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BLOCK_N) {
    __syncthreads();  // Qs/dOs written / previous tile fully read
    load_f32<D, LD>(Ks, k, p.k_ss, k0, p.Skv, p.D, tid);
    load_f32<DV, LDV>(Vs, v, p.v_ss, k0, p.Skv, p.Dv, tid);
    __syncthreads();

    float s[BLOCK_N / 4], dp[BLOCK_N / 4];
#pragma unroll
    for (int c = 0; c < BLOCK_N / 4; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LD + d];
#pragma unroll
      for (int c = 0; c < BLOCK_N / 4; ++c) s[c] += qv * Ks[(qd + 4 * c) * LD + d];
    }
#pragma unroll 4
    for (int d = 0; d < DV; ++d) {
      const float gv = dOs[r * LDV + d];
#pragma unroll
      for (int c = 0; c < BLOCK_N / 4; ++c) dp[c] += gv * Vs[(qd + 4 * c) * LDV + d];
    }
#pragma unroll
    for (int c = 0; c < BLOCK_N / 4; ++c) {
      const float pv = visible(p, i, k0 + qd + 4 * c) ? expf(s[c] * p.scale - lse) : 0.f;
      dSs[r * LP + qd + 4 * c] = pv * (dp[c] - dlt);
    }
    __syncwarp();  // row r of dSs is written and read by the same 4 lanes
#pragma unroll 4
    for (int c = 0; c < BLOCK_N; ++c) {
      const float ds = dSs[r * LP + c];
#pragma unroll
      for (int dd = 0; dd < D / 4; ++dd) acc[dd] += ds * Ks[c * LD + qd + 4 * dd];
    }
  }
  if (i < p.Sq) {
    float* dq = static_cast<float*>(p.dq) + ((static_cast<long long>(b) * p.Sq + i) * p.H + h) * p.D;
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd)
      if (qd + 4 * dd < p.D) dq[qd + 4 * dd] = acc[dd] * p.scale;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(256) bwd_dkdv_f32(Params p) {
  constexpr int LD = D + 1, LDV = DV + 1, LP = BLOCK_M + 1;
  extern __shared__ float smem_f32[];
  float* Ks = smem_f32;
  float* Vs = Ks + BLOCK_N * LD;   // BLOCK_N x LDV
  float* Qs = Vs + BLOCK_N * LDV;
  float* dOs = Qs + BLOCK_M * LD;  // BLOCK_M x LDV
  float* Ps = dOs + BLOCK_M * LDV; // BLOCK_N x LP
  float* dSs = Ps + BLOCK_N * LP;  // BLOCK_N x LP
  float* Ls = dSs + BLOCK_N * LP;  // BLOCK_M
  float* Dl = Ls + BLOCK_M;        // BLOCK_M

  const int tid = threadIdx.x, bk = blockIdx.x;
  const int b = bk / p.KV, hk = bk % p.KV;
  const int k0 = blockIdx.y * BLOCK_N;  // under a causal mask the first tiles are the long ones
  load_f32<D, LD>(Ks, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss,
                  k0, p.Skv, p.D, tid);
  load_f32<DV, LDV>(Vs, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss,
                    k0, p.Skv, p.Dv, tid);

  const int r = tid >> 2, qd = tid & 3, j = k0 + r;
  float dk[D / 4], dv[DV / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) dk[c] = 0.f;
#pragma unroll
  for (int c = 0; c < DV / 4; ++c) dv[c] = 0.f;

  int lo, hi;
  q_range(p, k0, lo, hi);
  for (int g = 0; g < p.G; ++g) {
    const int h = hk * p.G + g;
    const long long bh = static_cast<long long>(b) * p.H + h;
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = lo; q0 < hi; q0 += BLOCK_M) {
      __syncthreads();  // Ks/Vs written / previous tile fully read
      load_f32<D, LD>(Qs, q, p.q_ss, q0, p.Sq, p.D, tid);
      load_f32<DV, LDV>(dOs, dout, p.do_ss, q0, p.Sq, p.Dv, tid);
      if (tid < BLOCK_M) {
        const int i = q0 + tid;
        Ls[tid] = i < p.Sq ? p.lse[bh * p.Sq + i] : INFINITY;
        Dl[tid] = i < p.Sq ? p.delta[bh * p.Sq + i] : 0.f;
      }
      __syncthreads();

      float s[BLOCK_M / 4], dp[BLOCK_M / 4];
#pragma unroll
      for (int c = 0; c < BLOCK_M / 4; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv = Ks[r * LD + d];
#pragma unroll
        for (int c = 0; c < BLOCK_M / 4; ++c) s[c] += kv * Qs[(qd + 4 * c) * LD + d];
      }
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        const float vv = Vs[r * LDV + d];
#pragma unroll
        for (int c = 0; c < BLOCK_M / 4; ++c) dp[c] += vv * dOs[(qd + 4 * c) * LDV + d];
      }
#pragma unroll
      for (int c = 0; c < BLOCK_M / 4; ++c) {
        const int ci = qd + 4 * c;
        const float pv = visible(p, q0 + ci, j) ? expf(s[c] * p.scale - Ls[ci]) : 0.f;
        Ps[r * LP + ci] = pv;
        dSs[r * LP + ci] = pv * (dp[c] - Dl[ci]);
      }
      __syncwarp();  // row r of Ps/dSs is written and read by the same 4 lanes
#pragma unroll 4
      for (int c = 0; c < BLOCK_M; ++c) {
        const float pv = Ps[r * LP + c], ds = dSs[r * LP + c];
#pragma unroll
        for (int dd = 0; dd < DV / 4; ++dd) dv[dd] += pv * dOs[c * LDV + qd + 4 * dd];
#pragma unroll
        for (int dd = 0; dd < D / 4; ++dd) dk[dd] += ds * Qs[c * LD + qd + 4 * dd];
      }
    }
  }
  if (j < p.Skv) {
    const long long row = (static_cast<long long>(b) * p.Skv + j) * p.KV + hk;
    float* dkp = static_cast<float*>(p.dk) + row * p.D;
    float* dvp = static_cast<float*>(p.dv) + row * p.Dv;
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd)
      if (qd + 4 * dd < p.D) dkp[qd + 4 * dd] = dk[dd] * p.scale;
#pragma unroll
    for (int dd = 0; dd < DV / 4; ++dd)
      if (qd + 4 * dd < p.Dv) dvp[qd + 4 * dd] = dv[dd];
  }
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// Two floats as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy 64 rows of D bf16 (16-byte chunks; the wrapper checks the
// alignment) into a shared tile with row stride LD, zero past `limit` and
// in the columns from `cols` (a multiple of 8) to D.
template <int D, int LD>
__device__ __forceinline__ void load_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int row0, int limit, int cols, int tid) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < 64 * CH; idx += 128) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit && c * 8 < cols) val = *reinterpret_cast<const uint4*>(src + row * rs + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// The A fragment (16 rows from `row`, k-slice ks) of a row-major shared tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row,
                                       int ks, int t) {
  a[0] = ld32(tile + row * LD + ks * 16 + 2 * t);
  a[1] = ld32(tile + (row + 8) * LD + ks * 16 + 2 * t);
  a[2] = ld32(tile + row * LD + ks * 16 + 2 * t + 8);
  a[3] = ld32(tile + (row + 8) * LD + ks * 16 + 2 * t + 8);
}

// acc (16 x D) += X (16 x 64, the fp32 accumulators x of 8 n-tiles, rounded
// to bf16) times the 64 x D row-major shared tile Y.
template <int D, int LD>
__device__ __forceinline__ void mma_xy(float (&acc)[D / 8][4], const float (&x)[8][4],
                                       const __nv_bfloat16* Y, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_f32(x[2 * kk][0], x[2 * kk][1]),
                           pack_f32(x[2 * kk][2], x[2 * kk][3]),
                           pack_f32(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_f32(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* yp = Y + (kk * 16 + 2 * t) * LD + dt * 8 + g;
      mma_bf16(acc[dt], a, pack_bf16(yp[0], yp[LD]), pack_bf16(yp[8 * LD], yp[9 * LD]));
    }
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(128) bwd_dq_bf16(Params p) {
  constexpr int LD = D + 8;  // 16-byte pad: rows stay 16-byte aligned, banks spread
  constexpr int LDV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* dOs = Qs + BLOCK_M * LD;   // BLOCK_M x LDV
  __nv_bfloat16* Ks = dOs + BLOCK_M * LDV;
  __nv_bfloat16* Vs = Ks + BLOCK_N * LD;    // BLOCK_N x LDV

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;  // long tiles first
  load_bf16<D, LD>(Qs, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, q0, p.Sq, p.D, tid);
  load_bf16<DV, LDV>(dOs, static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                     p.do_ss, q0, p.Sq, p.Dv, tid);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __syncthreads();

  const int qr = warp * 16 + g;
  uint32_t qf[D / 16][4], df[DV / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) frag_a<LD>(qf[ks], Qs, qr, ks, t);
#pragma unroll
  for (int ks = 0; ks < DV / 16; ++ks) frag_a<LDV>(df[ks], dOs, qr, ks, t);
  const int i_row[2] = {q0 + qr, q0 + qr + 8};
  float lse[2], dlt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const bool in = i_row[rr] < p.Sq;
    lse[rr] = in ? p.lse[static_cast<long long>(bh) * p.Sq + i_row[rr]] : INFINITY;
    dlt[rr] = in ? p.delta[static_cast<long long>(bh) * p.Sq + i_row[rr]] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int lo, hi;
  kv_range(p, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BLOCK_N) {
    __syncthreads();  // previous tile fully read
    load_bf16<D, LD>(Ks, k, p.k_ss, k0, p.Skv, p.D, tid);
    load_bf16<DV, LDV>(Vs, v, p.v_ss, k0, p.Skv, p.Dv, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[BLOCK_N / 8][4], dp[BLOCK_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks) {
        const __nv_bfloat16* vp = Vs + (nt * 8 + g) * LDV + ks * 16 + 2 * t;
        mma_bf16(dp[nt], df[ks], ld32(vp), ld32(vp + 8));
      }
    }
    // element e of an n-tile: row g (e < 2) or g + 8, key nt*8 + 2t + (e & 1);
    // s becomes dS in place
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, j = k0 + nt * 8 + 2 * t + (e & 1);
        const float pv = visible(p, i_row[rr], j) ? __expf(s[nt][e] * p.scale - lse[rr]) : 0.f;
        s[nt][e] = pv * (dp[nt][e] - dlt[rr]);
      }
    mma_xy<D, LD>(acc, s, Ks, g, t);  // dQ += dS K
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (i_row[rr] >= p.Sq) continue;
    __nv_bfloat16* row = dq + ((static_cast<long long>(b) * p.Sq + i_row[rr]) * p.H + h) * p.D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      if (dt * 8 < p.D)
        *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) = __floats2bfloat162_rn(
            acc[dt][2 * rr] * p.scale, acc[dt][2 * rr + 1] * p.scale);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(128) bwd_dkdv_bf16(Params p) {
  constexpr int LD = D + 8, LDV = DV + 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Vs = Ks + BLOCK_N * LD;    // BLOCK_N x LDV
  __nv_bfloat16* Qs = Vs + BLOCK_N * LDV;
  __nv_bfloat16* dOs = Qs + BLOCK_M * LD;   // BLOCK_M x LDV
  float* Ls = reinterpret_cast<float*>(dOs + BLOCK_M * LDV);  // BLOCK_M
  float* Dl = Ls + BLOCK_M;                                   // BLOCK_M

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bk = blockIdx.x;
  const int b = bk / p.KV, hk = bk % p.KV;
  const int k0 = blockIdx.y * BLOCK_N;  // under a causal mask the first tiles are the long ones
  load_bf16<D, LD>(Ks, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh,
                   p.k_ss, k0, p.Skv, p.D, tid);
  load_bf16<DV, LDV>(Vs, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh,
                     p.v_ss, k0, p.Skv, p.Dv, tid);

  const int kr = warp * 16 + g;  // this warp's 16 k rows: kr and kr + 8
  const int j_row[2] = {k0 + kr, k0 + kr + 8};
  float dk[D / 8][4], dv[DV / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = 0.f;
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[dt][e] = 0.f;

  int lo, hi;
  q_range(p, k0, lo, hi);
  for (int hg = 0; hg < p.G; ++hg) {
    const int h = hk * p.G + hg;
    const long long bh = static_cast<long long>(b) * p.H + h;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dout =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = lo; q0 < hi; q0 += BLOCK_M) {
      __syncthreads();  // Ks/Vs written / previous tile fully read
      load_bf16<D, LD>(Qs, q, p.q_ss, q0, p.Sq, p.D, tid);
      load_bf16<DV, LDV>(dOs, dout, p.do_ss, q0, p.Sq, p.Dv, tid);
      if (tid < BLOCK_M) {
        const int i = q0 + tid;
        Ls[tid] = i < p.Sq ? p.lse[bh * p.Sq + i] : INFINITY;
        Dl[tid] = i < p.Sq ? p.delta[bh * p.Sq + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 k rows x 64 queries per warp
      float s[BLOCK_M / 8][4], dp[BLOCK_M / 8][4];
#pragma unroll
      for (int nt = 0; nt < BLOCK_M / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kf[4];
        frag_a<LD>(kf, Ks, kr, ks, t);
#pragma unroll
        for (int nt = 0; nt < BLOCK_M / 8; ++nt) {
          const __nv_bfloat16* qp = Qs + (nt * 8 + g) * LD + ks * 16 + 2 * t;
          mma_bf16(s[nt], kf, ld32(qp), ld32(qp + 8));
        }
      }
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks) {
        uint32_t vf[4];
        frag_a<LDV>(vf, Vs, kr, ks, t);
#pragma unroll
        for (int nt = 0; nt < BLOCK_M / 8; ++nt) {
          const __nv_bfloat16* op = dOs + (nt * 8 + g) * LDV + ks * 16 + 2 * t;
          mma_bf16(dp[nt], vf, ld32(op), ld32(op + 8));
        }
      }
      // element e of an n-tile: k row kr (e < 2) or kr + 8, query nt*8 + 2t + (e & 1);
      // s becomes P^T and dp becomes dS^T in place
#pragma unroll
      for (int nt = 0; nt < BLOCK_M / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + 2 * t + (e & 1);
          const float pv =
              visible(p, q0 + c, j_row[e >> 1]) ? __expf(s[nt][e] * p.scale - Ls[c]) : 0.f;
          s[nt][e] = pv;
          dp[nt][e] = pv * (dp[nt][e] - Dl[c]);
        }
      mma_xy<DV, LDV>(dv, s, dOs, g, t);  // dV += P^T dO
      mma_xy<D, LD>(dk, dp, Qs, g, t);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (j_row[rr] >= p.Skv) continue;
    const long long row = (static_cast<long long>(b) * p.Skv + j_row[rr]) * p.KV + hk;
    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + row * p.D + 2 * t;
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + row * p.Dv + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      if (dt * 8 < p.D)
        *reinterpret_cast<__nv_bfloat162*>(dkp + dt * 8) = __floats2bfloat162_rn(
            dk[dt][2 * rr] * p.scale, dk[dt][2 * rr + 1] * p.scale);
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt)
      if (dt * 8 < p.Dv)
        *reinterpret_cast<__nv_bfloat162*>(dvp + dt * 8) =
            __floats2bfloat162_rn(dv[dt][2 * rr], dv[dt][2 * rr + 1]);
  }
}

// ------------- bf16, D in {64, 96, 128}, DV in {64, 128}: wgmma, five products

namespace bw {

constexpr int BN = 128;       // k rows per block: two consumer warpgroups of 64
constexpr int BM = 64;        // q rows per tile of the ring
constexpr int STAGES = 3;     // Q / dO / lse / delta ring depth
constexpr int THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 produces

// How bwd_wgmma rounds P and dS for the dV and dK products, and what it does.
enum Plan {
  ONE_TERM,  // P and dS as one bf16 term each; D_i = dO_i . O_i from the bf16 O
  ROW_SUMS,  // no gradient: D_i = sum_j P_ij dP_ij in fp32, added with atomics
  TWO_TERM,  // P and dS as hi + lo bf16 terms (two products each), after ROW_SUMS
};

// dK and dV sum G * Sq terms a key.  Below this group size the one-term
// plan keeps within 2e-2 (1 + |ref|) of the fp32 gradient; from it on the
// call first takes the row sums in fp32 and then runs the two-term plan.
// The rounding plans emulated on the CPU at head dim 128 over the first
// 128-key tile of B 2 x 2048 queries (tests/test_torch_flash_attention.py::
// test_wgmma_bwd_rounding_plan_holds_at_large_groups): the one-term plan's
// worst |d| / (1 + |ref|) is 0.48x the bound at G 4, 0.63x at G 7, 0.83x at
// G 8 and 16 and 1.33x at G 48 (granite-20b); the row sums and two terms
// 0.17-0.29x at each of those G.  Two terms alone, with D_i still from the
// bf16 O, stay 2.6x as far off as both at G 48: O's rounding in D_i is the
// other half of the error.
constexpr int TWO_TERM_GROUP = 8;

// Offset of the fp32 dQ accumulator in the `delta` scratch: delta's
// B * H * Sq floats rounded up to 4, so float2 atomics stay aligned.
__host__ __device__ __forceinline__ long long dq_acc_offset(const Params& p) {
  return ((static_cast<long long>(p.B) * p.H * p.Sq + 3) / 4) * 4;
}

}  // namespace bw

// D_i = dO_i . O_i for bf16: DV / 8 lanes per row, one 16-byte load of O
// and of dO each (zero from column Dv on), 32 / (DV / 8) rows per warp.
template <int DV>
__global__ void __launch_bounds__(256) bwd_delta_bf16(Params p) {
  constexpr int TPR = DV / 8, RPW = 32 / TPR;
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  const int lane = threadIdx.x & 31, c = lane % TPR;
  const long long row =
      (static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5)) * RPW + lane / TPR;
  float acc = 0.f;
  int b = 0, i = 0, h = 0;
  if (row < rows) {
    h = static_cast<int>(row % p.H);
    i = static_cast<int>((row / p.H) % p.Sq);
    b = static_cast<int>(row / (static_cast<long long>(p.H) * p.Sq));
  }
  if (row < rows && 8 * c < p.Dv) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.o) + b * p.o_sb + i * p.o_ss + h * p.o_sh + 8 * c);
    const uint4 dv = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p.dout) +
                                                     b * p.do_sb + i * p.do_ss + h * p.do_sh +
                                                     8 * c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(o2[e]), d = __bfloat1622float2(d2[e]);
      acc += a.x * d.x + a.y * d.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.Sq + i] = acc;
}

// One block per (batch * kv head, 128-row k tile): two consumer warpgroups
// of 64 k rows each and one producer warpgroup.  The producer copies K and
// V once, then, for each of the G query heads of the kv head and each
// 64-row q tile that can see the k tile, the Q, dO, lse and delta tiles
// through a three-stage ring (cp.async into swizzled tiles, "full" / "empty"
// mbarriers).  Per q tile each consumer warpgroup runs
//   S^T = K Q^T, dP^T = V dO^T       (wgmma, both from shared memory)
//   P^T, dS^T = P^T (dP^T - delta)   (fp32 registers; the mask only on
//                                     tiles that straddle an edge)
//   dV += P^T dO, dK += dS^T Q       (wgmma, A from registers, B MN-major)
// and stages dS^T (bf16) in shared memory; after a barrier over both
// consumer warpgroups, each computes dQ = dS K for its part of the head
// dim (A = dS^T read MN-major, B = K read MN-major) and adds it with float2
// atomics into the fp32 accumulator.  dS^T is double-buffered, so one
// barrier per q tile suffices.  Q and K are D wide (DB 64-column blocks,
// the last one half used at D 96), V and dO DV wide.  PLAN (bw::Plan):
// ONE_TERM and TWO_TERM as above, P^T and dS^T going in as one or as two
// bf16 terms (hi, then lo: dV and dK take two products each); ROW_SUMS
// stops after P^T and adds each q column's sum of P^T dP^T over the block's
// k rows into `delta` (zeroed by the caller) with atomics: the fp32 D_i the
// TWO_TERM pass that follows reads.
template <int D, int DV, int PLAN>
__global__ void __launch_bounds__(bw::THREADS, 1) bwd_wgmma(Params p) {
  using namespace hopper;
  constexpr int BN = bw::BN, BM = bw::BM, STAGES = bw::STAGES;
  constexpr int DB = (D + 63) / 64, DVB = DV / 64;
  constexpr int K_BYTES = BN * DB * 128, V_BYTES = BN * DVB * 128;
  constexpr int Q_BYTES = BM * DB * 128, DO_BYTES = BM * DVB * 128;
  constexpr int STAGE_BYTES = Q_BYTES + DO_BYTES, DS_BYTES = BN * BM * 2;
  // products of N = D read whole 64-column blocks or the leading half of
  // one: dK as DK0 columns from block 0 (all of D when D is 64 or 128)
  // plus DK1 from block 1; dQ as QW0 columns on warpgroup 0 and QW1 on 1
  constexpr int DK0 = D == 96 ? 64 : D, DK1 = D - DK0;
  constexpr int QW0 = D == 96 ? 64 : D / 2, QW1 = D - QW0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + K_BYTES;
  unsigned char* QdO = Vs + V_BYTES;                   // stage s: Q, then dO, at s STAGE_BYTES
  unsigned char* dSs = QdO + STAGES * STAGE_BYTES;     // two dS^T buffers
  float* LD = reinterpret_cast<float*>(dSs + 2 * DS_BYTES);  // stage s: lse at 2s, delta at 2s + 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(LD + STAGES * 2 * BM);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int tid = threadIdx.x;
  const int bk = blockIdx.x;
  const int b = bk / p.KV, hk = bk % p.KV;
  const int k0 = blockIdx.y * BN;  // under a causal mask the first tiles are the long ones
  const int lo = p.causal ? k0 : 0;
  const int hi = p.window ? min(p.Sq, k0 + BN - 1 + p.window) : p.Sq;
  const int n_q = hi > lo ? (hi - lo + BM - 1) / BM : 0;
  const int n_tiles = p.G * n_q;

  if (tid == 0) {
    mbar_init(kv_full, 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // ---------------------------------------- producer
    setmaxnreg_dec<40>();  // 256 x (232 - 168) consumer registers = 128 x (168 - 40)
    const int pt = tid - 256;
    copy_tile<BN, D>(Ks, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh,
                     p.k_ss, k0, p.Skv, p.D, pt);
    copy_tile<BN, DV>(Vs, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh,
                      p.v_ss, k0, p.Skv, p.Dv, pt);
    cp_async_arrive(kv_full);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES, h = hk * p.G + t / n_q, q0 = lo + (t % n_q) * BM;
      if (t >= STAGES) mbar_wait(&empty[st], (t / STAGES - 1) & 1);
      unsigned char* qd = QdO + st * STAGE_BYTES;
      copy_tile<BM, D>(qd, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh,
                       p.q_ss, q0, p.Sq, p.D, pt);
      copy_tile<BM, DV>(qd + Q_BYTES,
                        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                        p.do_ss, q0, p.Sq, p.Dv, pt);
      const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq + q0;
      const int r = pt & (BM - 1), i = q0 + r;
      const float* src = (pt < BM ? p.lse : p.delta) + row0 + r;
      cp_async4(smem_u32(LD + (2 * st + (pt >= BM)) * BM + r), i < p.Sq ? src : p.lse,
                i < p.Sq ? 4 : 0);
      cp_async_arrive(&full[st]);
    }
    cp_async_wait_all();
  } else {  // ---------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const int kw0 = k0 + 64 * w;  // this warpgroup's first k row
    const int j_row[2] = {kw0 + 16 * warp + g, kw0 + 16 * warp + g + 8};
    const float scale2 = p.scale * LOG2E;
    float* dq_acc = p.delta + bw::dq_acc_offset(p);
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    const uint32_t kw_addr = k_addr + w * 64 * 128, vw_addr = v_addr + w * 64 * 128;
    float dk[DK0 / 2], dk1[DK1 > 0 ? DK1 / 2 : 1], dv[DV / 2];
#pragma unroll
    for (int e = 0; e < DK0 / 2; ++e) dk[e] = 0.f;
#pragma unroll
    for (int e = 0; e < DK1 / 2; ++e) dk1[e] = 0.f;
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) dv[e] = 0.f;

    mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES, h = hk * p.G + t / n_q, q0 = lo + (t % n_q) * BM;
      const uint32_t q_addr = smem_u32(QdO + st * STAGE_BYTES), do_addr = q_addr + Q_BYTES;
      const float* Ls = LD + (2 * st) * BM;
      const float* Dl = Ls + BM;
      mbar_wait(&full[st], (t / STAGES) & 1);
      fence_proxy_async();

      float s[32], dp[32];  // S^T and dP^T: 64 k rows x 64 q columns
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<0, 0>(s, desc_b128(kw_addr + (ks >> 2) * (BN * 128) + (ks & 3) * 32, 16, 1024),
                       desc_b128(q_addr + (ks >> 2) * (BM * 128) + (ks & 3) * 32, 16, 1024),
                       ks > 0);
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks)
        wgmma_ss<0, 0>(dp, desc_b128(vw_addr + (ks >> 2) * (BN * 128) + (ks & 3) * 32, 16, 1024),
                       desc_b128(do_addr + (ks >> 2) * (BM * 128) + (ks & 3) * 32, 16, 1024),
                       ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // element e: k row j_row[(e >> 1) & 1], q column c = 8 (e / 4) + 2 qd + (e & 1)
      const bool masked = kw0 + 63 >= p.Skv || q0 + BM > p.Sq ||
                          (p.causal && kw0 + 63 > q0) ||
                          (p.window && kw0 <= q0 + BM - 1 - p.window);
      if (masked) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (!visible(p, q0 + 8 * (e >> 2) + 2 * qd + (e & 1), j_row[(e >> 1) & 1]))
            s[e] = -INFINITY;  // P = exp2(-inf) = 0
      }
      if constexpr (PLAN == bw::ROW_SUMS) {
        // column c = 8 m/2 + 2 qd + m%2 of this thread: the sum of P^T dP^T
        // over its two k rows, then over the warp's 16 (the 8 lanes of a qd)
        float part[16];
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int c = 8 * (e >> 2) + 2 * qd, m = 2 * (e >> 2);
          const float2 lse2 = *reinterpret_cast<const float2*>(Ls + c);
          const float p0 = exp2_approx(fmaf(s[e], scale2, -lse2.x * LOG2E)) * dp[e];
          const float p1 = exp2_approx(fmaf(s[e + 1], scale2, -lse2.y * LOG2E)) * dp[e + 1];
          part[m] = (e >> 1) & 1 ? part[m] + p0 : p0;
          part[m + 1] = (e >> 1) & 1 ? part[m + 1] + p1 : p1;
        }
#pragma unroll
        for (int m = 0; m < 16; ++m)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            part[m] += __shfl_xor_sync(0xffffffffu, part[m], off);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        if (g == 0) {
          float* dst = p.delta + (static_cast<long long>(b) * p.H + h) * p.Sq + q0;
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            const int c = 8 * (m >> 1) + 2 * qd + (m & 1);
            if (q0 + c < p.Sq) atomicAdd(dst + c, part[m]);
          }
        }
        continue;
      }
      // P^T and dS^T as A fragments: one bf16 term, or hi (pa, da) and lo
      constexpr int LO = PLAN == bw::TWO_TERM ? 4 : 1;
      uint32_t pa[4][4], da[4][4], pa_lo[LO][4], da_lo[LO][4];
      unsigned char* ds_buf = dSs + (t & 1) * DS_BYTES;
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int c = 8 * (e >> 2) + 2 * qd, rr = (e >> 1) & 1;
        const float2 lse2 = *reinterpret_cast<const float2*>(Ls + c);
        const float2 dl2 = *reinterpret_cast<const float2*>(Dl + c);
        const float p0 = exp2_approx(fmaf(s[e], scale2, -lse2.x * LOG2E));
        const float p1 = exp2_approx(fmaf(s[e + 1], scale2, -lse2.y * LOG2E));
        const float ds0 = p0 * (dp[e] - dl2.x), ds1 = p1 * (dp[e + 1] - dl2.y);
        uint32_t& pw = pa[e >> 3][(e >> 1) & 3];
        uint32_t& dsw = da[e >> 3][(e >> 1) & 3];
        if constexpr (PLAN == bw::TWO_TERM) {
          split2(p0, p1, pw, pa_lo[e >> 3][(e >> 1) & 3]);
          split2(ds0, ds1, dsw, da_lo[e >> 3][(e >> 1) & 3]);
        } else {
          pw = pack_bf16x2(p0, p1);
          dsw = pack_bf16x2(ds0, ds1);
        }
        const int r = 64 * w + 16 * warp + g + 8 * rr;  // row of dS^T: k row within the block
        *reinterpret_cast<uint32_t*>(ds_buf + swz(r, c >> 3) + (c & 7) * 2) = dsw;
      }
      fence_proxy_async();

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t b_desc = desc_b128(do_addr + kk * 16 * 128, BM * 128, 1024);
        wgmma_rs<1>(dv, pa[kk], b_desc, 1);
        if constexpr (PLAN == bw::TWO_TERM) wgmma_rs<1>(dv, pa_lo[kk], b_desc, 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t b_desc = desc_b128(q_addr + kk * 16 * 128, BM * 128, 1024);
        wgmma_rs<1>(dk, da[kk], b_desc, 1);
        if constexpr (PLAN == bw::TWO_TERM) wgmma_rs<1>(dk, da_lo[kk], b_desc, 1);
      }
      if constexpr (DK1 > 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t b_desc = desc_b128(q_addr + BM * 128 + kk * 16 * 128, BM * 128, 1024);
          wgmma_rs<1>(dk1, da[kk], b_desc, 1);
          if constexpr (PLAN == bw::TWO_TERM) wgmma_rs<1>(dk1, da_lo[kk], b_desc, 1);
        }
      }
      wgmma_commit();

      named_bar_sync(1, 256);  // both warpgroups' rows of dS^T are in place
      const uint32_t ds_addr = smem_u32(ds_buf);
      // dQ for the columns [c0, c0 + N) of this warpgroup (N = 2 R): wait for
      // every product, release the stage, add into the accumulator
      auto dq_part = [&](auto& dq, int c0) {
        constexpr int R = sizeof(dq) / sizeof(dq[0]);
        const uint32_t kq_addr = k_addr + (c0 >> 6) * (BN * 128) + (c0 & 63) * 2;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_ss<1, 1>(dq, desc_b128(ds_addr + kk * 16 * 128, BN * 128, 1024),
                         desc_b128(kq_addr + kk * 16 * 128, BN * 128, 1024), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(dk1);
        fence_regs(dq);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);

        // dq element e: q row q0 + 16 warp + g + 8 ((e >> 1) & 1), column c0 + 8 (e / 4) + 2 qd
#pragma unroll
        for (int e = 0; e < R; e += 2) {
          const int i = q0 + 16 * warp + g + 8 * ((e >> 1) & 1), col = c0 + 8 * (e >> 2) + 2 * qd;
          if (i < p.Sq && col < p.D)
            atomicAdd(reinterpret_cast<float2*>(
                          dq_acc + ((static_cast<long long>(b) * p.Sq + i) * p.H + h) * p.D + col),
                      make_float2(dq[e], dq[e + 1]));
        }
      };
      if constexpr (QW0 == QW1) {
        float dq[QW0 / 2];
        dq_part(dq, w * QW0);
      } else if (w == 0) {
        float dq[QW0 / 2];
        dq_part(dq, 0);
      } else {
        float dq[QW1 / 2];
        dq_part(dq, QW0);
      }
    }
    if constexpr (PLAN == bw::ROW_SUMS) return;

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (j_row[rr] >= p.Skv) continue;
      const long long row = (static_cast<long long>(b) * p.Skv + j_row[rr]) * p.KV + hk;
      __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + row * p.D + 2 * qd;
      __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + row * p.Dv + 2 * qd;
#pragma unroll
      for (int j = 0; j < DK0 / 8; ++j)
        if (8 * j < p.D)
          *reinterpret_cast<__nv_bfloat162*>(dkp + 8 * j) = __floats2bfloat162_rn(
              dk[4 * j + 2 * rr] * p.scale, dk[4 * j + 2 * rr + 1] * p.scale);
#pragma unroll
      for (int j = 0; j < DK1 / 8; ++j)
        if (DK0 + 8 * j < p.D)
          *reinterpret_cast<__nv_bfloat162*>(dkp + DK0 + 8 * j) = __floats2bfloat162_rn(
              dk1[4 * j + 2 * rr] * p.scale, dk1[4 * j + 2 * rr + 1] * p.scale);
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        if (8 * j < p.Dv)
          *reinterpret_cast<__nv_bfloat162*>(dvp + 8 * j) =
              __floats2bfloat162_rn(dv[4 * j + 2 * rr], dv[4 * j + 2 * rr + 1]);
    }
  }
}

// dq = scale * the fp32 accumulator, as bf16; four values a thread.
__global__ void __launch_bounds__(256) bwd_dq_finish(Params p) {
  const long long n4 = static_cast<long long>(p.B) * p.Sq * p.H * p.D / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= n4) return;
  const float4 a =
      reinterpret_cast<const float4*>(p.delta + bw::dq_acc_offset(p))[idx];
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(p.dq) + 2 * idx;
  out[0] = __floats2bfloat162_rn(a.x * p.scale, a.y * p.scale);
  out[1] = __floats2bfloat162_rn(a.z * p.scale, a.w * p.scale);
}

// ---------------------------------------------------------------- launch

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, int smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_f32(const Params& p, cudaStream_t st) {
  const int tiles = 2 * 64 * (D + 1 + DV + 1) * static_cast<int>(sizeof(float));
  const int lp = 64 * (64 + 1) * static_cast<int>(sizeof(float));
  cudaError_t err = launch(bwd_dq_f32<D, DV>, dim3(p.B * p.H, (p.Sq + BLOCK_M - 1) / BLOCK_M),
                           256, tiles + lp, p, st);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkdv_f32<D, DV>, dim3(p.B * p.KV, (p.Skv + BLOCK_N - 1) / BLOCK_N), 256,
                tiles + 2 * lp + 2 * 64 * static_cast<int>(sizeof(float)), p, st);
}

template <int D, int DV>
cudaError_t launch_bf16(const Params& p, cudaStream_t st) {
  const int tiles = 2 * 64 * (D + 8 + DV + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = launch(bwd_dq_bf16<D, DV>, dim3(p.B * p.H, (p.Sq + BLOCK_M - 1) / BLOCK_M),
                           128, tiles, p, st);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkdv_bf16<D, DV>, dim3(p.B * p.KV, (p.Skv + BLOCK_N - 1) / BLOCK_N), 128,
                tiles + 2 * 64 * static_cast<int>(sizeof(float)), p, st);
}

// The wgmma kernel of `plan` (after the row sums for TWO_TERM), then dq.
template <int D, int DV>
cudaError_t launch_wgmma(const Params& p, bw::Plan plan, cudaStream_t st) {
  constexpr int DB = (D + 63) / 64, DVB = DV / 64;
  constexpr int smem = 1024 + bw::BN * (DB + DVB) * 128 + bw::STAGES * bw::BM * (DB + DVB) * 128 +
                       2 * bw::BN * bw::BM * 2 + bw::STAGES * 2 * bw::BM * 4 + 64;
  static_assert(smem <= 232448, "more shared memory than a block can have");
  const dim3 grid(p.B * p.KV, (p.Skv + bw::BN - 1) / bw::BN);
  cudaError_t err;
  if (plan == bw::TWO_TERM) {
    err = launch(bwd_wgmma<D, DV, bw::ROW_SUMS>, grid, bw::THREADS, smem, p, st);
    if (err != cudaSuccess) return err;
    err = launch(bwd_wgmma<D, DV, bw::TWO_TERM>, grid, bw::THREADS, smem, p, st);
  } else {
    err = launch(bwd_wgmma<D, DV, bw::ONE_TERM>, grid, bw::THREADS, smem, p, st);
  }
  if (err != cudaSuccess) return err;
  const long long n4 = static_cast<long long>(p.B) * p.Sq * p.H * p.D / 4;
  bwd_dq_finish<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, st>>>(p);
  return cudaGetLastError();
}

template <int DV>
cudaError_t launch_delta_bf16(const Params& p, cudaStream_t st) {
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  const long long per_block = 8 * (32 / (DV / 8));
  bwd_delta_bf16<DV><<<static_cast<unsigned>((rows + per_block - 1) / per_block), 256, 0, st>>>(p);
  return cudaGetLastError();
}

// The kernels of a (dtype, widths) pair, after the row sums: f32 FMA; bf16
// mma.sync when both widths are at most 32, else wgmma at D >= 64 and
// DV >= 64.
struct Launch {
  const Params& p;
  int dtype;
  cudaStream_t st;
  template <int D, int DV>
  cudaError_t run() const {
    cudaError_t err;
    if (dtype == 0) {
      const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
      bwd_delta<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(p);
      err = cudaGetLastError();
      return err != cudaSuccess ? err : launch_f32<D, DV>(p, st);
    }
    if constexpr (D <= 32 && DV <= 32) {
      err = launch_delta_bf16<DV>(p, st);
      return err != cudaSuccess ? err : launch_bf16<D, DV>(p, st);
    } else {
      constexpr int DW = D < 64 ? 64 : D, DVW = DV < 64 ? 64 : DV;
      if (p.G >= bw::TWO_TERM_GROUP) return launch_wgmma<DW, DVW>(p, bw::TWO_TERM, st);
      err = launch_delta_bf16<DVW>(p, st);
      return err != cudaSuccess ? err : launch_wgmma<DW, DVW>(p, bw::ONE_TERM, st);
    }
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk, dv alike.
// D is the head dim of q, k, dq, dk; Dv that of v, o, dout, dv; each at
// most 128.  Strides are in elements; the last dim of q, k, v, o and dout
// is contiguous.  lse: B * H * Sq floats.  delta: fp32 scratch of B * H *
// Sq floats; for bf16 with D or Dv above 32 (the wgmma kernels) zeroed
// and followed, from the next multiple of 4 floats, by a zeroed B * Sq * H
// * D accumulator for dQ (from TWO_TERM_GROUP query heads a kv head on,
// the row sums add into the first part too).  dq: (B, Sq, H, D), dk: (B, Skv, KV, D) and dv:
// (B, Skv, KV, Dv), contiguous.  Returns 0 on success.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int Sq, int Skv, int H, int KV, int D, int Dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int window, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.G = H / KV; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.scale = scale; p.causal = causal; p.window = window;
  return head_dims::with_widths(D, Dv, Launch{p, dtype, static_cast<cudaStream_t>(stream)});
}
