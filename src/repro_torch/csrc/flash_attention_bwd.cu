// Flash attention backward for Hopper (sm_90a).
//
// The backward of flash_attention.cu (K1).  The JAX package has no attention
// backward kernel: its training path differentiates the plain jnp attention
// (src/repro/models/layers.py::blocked_attention) with autodiff.  The port
// runs attention through K1 on the card, so its gradient is a kernel too.
// Same masks as the forward (causal j <= i, window j > i - window, keys past
// Skv), GQA head h on kv head h / (H / KV).  With the forward's log-sum-exp
// L_i of the scaled scores and D_i = sum_d dO_id O_id:
//   P_ij  = exp(scale q_i.k_j - L_i)          (0 where masked)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dQ_i  = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i,  dV_j = sum_i P_ij dO_i
// P is recomputed in fp32 from q, k and L (the bf16 forward rounded P to bf16
// for its P V product; here P and dS are rounded to bf16 only as the A
// operands of the dV, dQ and dK products).
//
// Design.  Three launches on the caller's stream:
//   1. delta: one warp per (b, i, h) row, D_i into an fp32 (B, H, Sq) scratch.
//   2. dQ: one block per (batch * head, 64-row q tile), looping over the kv
//      tiles the forward visits (the same kv_range), recomputing S and dP.
//   3. dK/dV: one block per (batch * kv head, 64-row k tile), looping over
//      the G query heads of that kv head and, for each, over the q tiles that
//      can see the k tile (from k0 under the causal mask, up to k0 + 63 +
//      window under a window).
// Each gradient row is owned by one block, so GQA needs no atomics and the
// result does not depend on scheduling.  Tiles of 64 rows are staged in
// shared memory; q/k/v/o/dO are read in their (B, S, H, D) layout through
// strides; dQ, dK, dV are written contiguous.  Templates cover D in
// {16, 32, 64, 128}.
//   * bf16: 4 warps, each owning 16 rows; every product on mma.sync m16n8k16
//     (bf16 in, fp32 accumulate), with the fragment layouts of the forward:
//     X Y^T reads both operands as rows, and a product with P or dS takes the
//     fp32 accumulators re-packed to bf16 as its A operand.
//   * f32: 8 warps, 4 threads per row, fp32 FMAs on the CUDA cores (no TF32).
//
// What bounds it.  The algorithm needs five products of 2·D flops per
// visible (i, j) pair (S, dP, dV, dQ, dK), 2.5x the forward's two: at the
// training shape (B=4, S=2048, H=32, KV=8, D=64, bf16, causal) 171.8 GFLOP,
// ~0.17 ms at 989 TFLOP/s, against ~0.04 ms for the bytes (q, k, v, o, dO,
// L read once; dQ, dK, dV written once): operations-bound.  This first
// version runs seven products (S and dP in both kernels), loads tiles
// synchronously and uses mma.sync, not wgmma/TMA.
//
// Interface: plain C, loaded with ctypes.  Returns cudaGetLastError() after
// the launches (0 on success), or -1 for a head dim / dtype it was not
// built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  void* dv;
  int B, Sq, Skv, H, KV, G, D;
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ----------------------------------------------------------------- delta

template <typename T>
__global__ void __launch_bounds__(256) bwd_delta(Params p) {
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.H;
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = static_cast<int>(row % p.H);
  const int i = static_cast<int>((row / p.H) % p.Sq);
  const int b = static_cast<int>(row / (static_cast<long long>(p.H) * p.Sq));
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + i * p.do_ss + h * p.do_sh;
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc += to_f32(o[c]) * to_f32(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(static_cast<long long>(b) * p.H + h) * p.Sq + i] = acc;
}

// ------------------------------------------------------------------- f32

// rows [row0, row0 + 64) of a (S, D) slice with row stride `rs` into a
// shared tile with row stride LD, zero past `limit`
template <int D, int LD>
__device__ __forceinline__ void load_f32(float* dst, const float* src, long long rs,
                                         int row0, int limit, int tid) {
  for (int idx = tid; idx < 64 * D; idx += 256) {
    const int r = idx / D, d = idx % D, row = row0 + r;
    dst[r * LD + d] = row < limit ? src[row * rs + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(256) bwd_dq_f32(Params p) {
  constexpr int LD = D + 1, LP = BLOCK_N + 1;
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;
  float* dOs = Qs + BLOCK_M * LD;
  float* Ks = dOs + BLOCK_M * LD;
  float* Vs = Ks + BLOCK_N * LD;
  float* dSs = Vs + BLOCK_N * LD;  // BLOCK_M x LP

  const int tid = threadIdx.x, bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;  // long tiles first
  load_f32<D, LD>(Qs, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
                  q0, p.Sq, tid);
  load_f32<D, LD>(dOs, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
                  p.do_ss, q0, p.Sq, tid);
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
    load_f32<D, LD>(Ks, k, p.k_ss, k0, p.Skv, tid);
    load_f32<D, LD>(Vs, v, p.v_ss, k0, p.Skv, tid);
    __syncthreads();

    float s[BLOCK_N / 4], dp[BLOCK_N / 4];
#pragma unroll
    for (int c = 0; c < BLOCK_N / 4; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LD + d], gv = dOs[r * LD + d];
#pragma unroll
      for (int c = 0; c < BLOCK_N / 4; ++c) {
        s[c] += qv * Ks[(qd + 4 * c) * LD + d];
        dp[c] += gv * Vs[(qd + 4 * c) * LD + d];
      }
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
    float* dq = static_cast<float*>(p.dq) + ((static_cast<long long>(b) * p.Sq + i) * p.H + h) * D;
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd) dq[qd + 4 * dd] = acc[dd] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(256) bwd_dkdv_f32(Params p) {
  constexpr int LD = D + 1, LP = BLOCK_M + 1;
  extern __shared__ float smem_f32[];
  float* Ks = smem_f32;
  float* Vs = Ks + BLOCK_N * LD;
  float* Qs = Vs + BLOCK_N * LD;
  float* dOs = Qs + BLOCK_M * LD;
  float* Ps = dOs + BLOCK_M * LD;  // BLOCK_N x LP
  float* dSs = Ps + BLOCK_N * LP;  // BLOCK_N x LP
  float* Ls = dSs + BLOCK_N * LP;  // BLOCK_M
  float* Dl = Ls + BLOCK_M;        // BLOCK_M

  const int tid = threadIdx.x, bk = blockIdx.x;
  const int b = bk / p.KV, hk = bk % p.KV;
  const int k0 = blockIdx.y * BLOCK_N;  // under a causal mask the first tiles are the long ones
  load_f32<D, LD>(Ks, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh, p.k_ss,
                  k0, p.Skv, tid);
  load_f32<D, LD>(Vs, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh, p.v_ss,
                  k0, p.Skv, tid);

  const int r = tid >> 2, qd = tid & 3, j = k0 + r;
  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) dk[c] = dv[c] = 0.f;

  int lo, hi;
  q_range(p, k0, lo, hi);
  for (int g = 0; g < p.G; ++g) {
    const int h = hk * p.G + g;
    const long long bh = static_cast<long long>(b) * p.H + h;
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dout = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    for (int q0 = lo; q0 < hi; q0 += BLOCK_M) {
      __syncthreads();  // Ks/Vs written / previous tile fully read
      load_f32<D, LD>(Qs, q, p.q_ss, q0, p.Sq, tid);
      load_f32<D, LD>(dOs, dout, p.do_ss, q0, p.Sq, tid);
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
        const float kv = Ks[r * LD + d], vv = Vs[r * LD + d];
#pragma unroll
        for (int c = 0; c < BLOCK_M / 4; ++c) {
          s[c] += kv * Qs[(qd + 4 * c) * LD + d];
          dp[c] += vv * dOs[(qd + 4 * c) * LD + d];
        }
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
        for (int dd = 0; dd < D / 4; ++dd) {
          dv[dd] += pv * dOs[c * LD + qd + 4 * dd];
          dk[dd] += ds * Qs[c * LD + qd + 4 * dd];
        }
      }
    }
  }
  if (j < p.Skv) {
    const long long off = ((static_cast<long long>(b) * p.Skv + j) * p.KV + hk) * D;
    float* dkp = static_cast<float*>(p.dk) + off;
    float* dvp = static_cast<float*>(p.dv) + off;
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd) {
      dkp[qd + 4 * dd] = dk[dd] * p.scale;
      dvp[qd + 4 * dd] = dv[dd];
    }
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
// alignment) into a shared tile with row stride LD, zero past `limit`.
template <int D, int LD>
__device__ __forceinline__ void load_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long rs, int row0, int limit, int tid) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < 64 * CH; idx += 128) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit) val = *reinterpret_cast<const uint4*>(src + row * rs + c * 8);
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

template <int D>
__global__ void __launch_bounds__(128) bwd_dq_bf16(Params p) {
  constexpr int LD = D + 8;  // 16-byte pad: rows stay 16-byte aligned, banks spread
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* dOs = Qs + BLOCK_M * LD;
  __nv_bfloat16* Ks = dOs + BLOCK_M * LD;
  __nv_bfloat16* Vs = Ks + BLOCK_N * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;  // long tiles first
  load_bf16<D, LD>(Qs, static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_ss, q0, p.Sq, tid);
  load_bf16<D, LD>(dOs, static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh,
                   p.do_ss, q0, p.Sq, tid);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __syncthreads();

  const int qr = warp * 16 + g;
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    frag_a<LD>(qf[ks], Qs, qr, ks, t);
    frag_a<LD>(df[ks], dOs, qr, ks, t);
  }
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
    load_bf16<D, LD>(Ks, k, p.k_ss, k0, p.Skv, tid);
    load_bf16<D, LD>(Vs, v, p.v_ss, k0, p.Skv, tid);
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
        const __nv_bfloat16* vp = Vs + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
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
    __nv_bfloat16* row = dq + ((static_cast<long long>(b) * p.Sq + i_row[rr]) * p.H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8) = __floats2bfloat162_rn(
          acc[dt][2 * rr] * p.scale, acc[dt][2 * rr + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(128) bwd_dkdv_bf16(Params p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Vs = Ks + BLOCK_N * LD;
  __nv_bfloat16* Qs = Vs + BLOCK_N * LD;
  __nv_bfloat16* dOs = Qs + BLOCK_M * LD;
  float* Ls = reinterpret_cast<float*>(dOs + BLOCK_M * LD);  // BLOCK_M
  float* Dl = Ls + BLOCK_M;                                   // BLOCK_M

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bk = blockIdx.x;
  const int b = bk / p.KV, hk = bk % p.KV;
  const int k0 = blockIdx.y * BLOCK_N;  // under a causal mask the first tiles are the long ones
  load_bf16<D, LD>(Ks, static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh,
                   p.k_ss, k0, p.Skv, tid);
  load_bf16<D, LD>(Vs, static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh,
                   p.v_ss, k0, p.Skv, tid);

  const int kr = warp * 16 + g;  // this warp's 16 k rows: kr and kr + 8
  const int j_row[2] = {k0 + kr, k0 + kr + 8};
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

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
      load_bf16<D, LD>(Qs, q, p.q_ss, q0, p.Sq, tid);
      load_bf16<D, LD>(dOs, dout, p.do_ss, q0, p.Sq, tid);
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
        uint32_t kf[4], vf[4];
        frag_a<LD>(kf, Ks, kr, ks, t);
        frag_a<LD>(vf, Vs, kr, ks, t);
#pragma unroll
        for (int nt = 0; nt < BLOCK_M / 8; ++nt) {
          const __nv_bfloat16* qp = Qs + (nt * 8 + g) * LD + ks * 16 + 2 * t;
          const __nv_bfloat16* op = dOs + (nt * 8 + g) * LD + ks * 16 + 2 * t;
          mma_bf16(s[nt], kf, ld32(qp), ld32(qp + 8));
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
      mma_xy<D, LD>(dv, s, dOs, g, t);  // dV += P^T dO
      mma_xy<D, LD>(dk, dp, Qs, g, t);  // dK += dS^T Q
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (j_row[rr] >= p.Skv) continue;
    const long long off = ((static_cast<long long>(b) * p.Skv + j_row[rr]) * p.KV + hk) * D + 2 * t;
    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + off;
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + off;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + dt * 8) = __floats2bfloat162_rn(
          dk[dt][2 * rr] * p.scale, dk[dt][2 * rr + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + dt * 8) =
          __floats2bfloat162_rn(dv[dt][2 * rr], dv[dt][2 * rr + 1]);
    }
  }
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

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t st) {
  const int tiles = 4 * 64 * (D + 1) * static_cast<int>(sizeof(float));
  const int lp = 64 * (64 + 1) * static_cast<int>(sizeof(float));
  cudaError_t err = launch(bwd_dq_f32<D>, dim3(p.B * p.H, (p.Sq + BLOCK_M - 1) / BLOCK_M),
                           256, tiles + lp, p, st);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkdv_f32<D>, dim3(p.B * p.KV, (p.Skv + BLOCK_N - 1) / BLOCK_N), 256,
                tiles + 2 * lp + 2 * 64 * static_cast<int>(sizeof(float)), p, st);
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t st) {
  const int tiles = 4 * 64 * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = launch(bwd_dq_bf16<D>, dim3(p.B * p.H, (p.Sq + BLOCK_M - 1) / BLOCK_M),
                           128, tiles, p, st);
  if (err != cudaSuccess) return err;
  return launch(bwd_dkdv_bf16<D>, dim3(p.B * p.KV, (p.Skv + BLOCK_N - 1) / BLOCK_N), 128,
                tiles + 2 * 64 * static_cast<int>(sizeof(float)), p, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, o, dout, dq, dk, dv alike.
// Strides are in elements; the last dim of q, k, v, o and dout is
// contiguous.  lse and delta: B * H * Sq floats (delta is scratch); dq:
// (B, Sq, H, D), dk and dv: (B, Skv, KV, D), contiguous.  Returns 0 on
// success.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype,
    int B, int Sq, int Skv, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    float scale, int causal, int window, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (D != 16 && D != 32 && D != 64 && D != 128) return -1;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.G = H / KV; p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.scale = scale; p.causal = causal; p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const long long rows = static_cast<long long>(B) * Sq * H;
  if (dtype == 0)
    bwd_delta<float><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(p);
  else
    bwd_delta<__nv_bfloat16><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (dtype == 0) {
    switch (D) {
      case 16: err = launch_f32<16>(p, st); break;
      case 32: err = launch_f32<32>(p, st); break;
      case 64: err = launch_f32<64>(p, st); break;
      default: err = launch_f32<128>(p, st); break;
    }
  } else {
    switch (D) {
      case 16: err = launch_bf16<16>(p, st); break;
      case 32: err = launch_bf16<32>(p, st); break;
      case 64: err = launch_bf16<64>(p, st); break;
      default: err = launch_bf16<128>(p, st); break;
    }
  }
  return static_cast<int>(err);
}
