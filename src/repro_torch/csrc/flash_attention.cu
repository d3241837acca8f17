// Flash attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the Pallas TPU kernel K1): attention with an online softmax, causal,
// sliding-window (key j visible to query i iff j > i - window) and key-
// padding masks, GQA head h reading kv head h / (H / KV), q and k of head
// dim D and v and the output of their own head dim Dv (MLA: 96 and 64),
// running max, denominator and accumulator in fp32, rows with no visible
// key giving 0.
//
// Design.  On request (a non-null `lse`) the kernels also write each row's
// log-sum-exp of the scaled scores, fp32 (B, H, Sq), for the backward
// kernels in flash_attention_bwd.cu; +inf for a row that sees no key, so
// that exp(s - lse) is 0 there.  q/k/v are read
// in their (B, S, H, D) layout through the strides the wrapper passes;
// nothing is transposed on the host.  The loop over kv tiles inside a
// block takes the place of the Pallas kernel's sequential ("arbitrary") kv
// grid axis; it starts at the window's lower limit and stops at the causal
// limit, so fully masked tiles cost nothing.  Each kernel is built for a
// pair of widths (D, DV) and runs a head dim at the next width up, with
// zero-filled columns (head_dims.cuh); every D, Dv <= 128 runs.  The entry
// point picks the kernel statically by dtype and widths:
//   * bf16, D or Dv above 32: fa_fwd_wgmma, for Hopper, at D in
//     {64, 96, 128} and DV in {64, 128} (a narrower head dim rounds up to
//     64).  One block per
//     (batch * head, q tile): NWG consumer warpgroups of 64 q rows and a
//     producer warpgroup that keeps a ring of 128-row K/V tiles filled
//     with cp.async (128-byte-swizzled shared tiles, mbarrier completion),
//     so copies overlap the products.  S = Q K^T and O += P V run on wgmma
//     m64nNk16 (bf16 in, fp32 accumulate); P is the S accumulator
//     converted to bf16 in registers, the A operand of P V (the JAX kernel
//     keeps P in fp32).  The online softmax runs in fp32 registers on the
//     raw scores' running max with one FFMA and one ex2 an element, its
//     row max and sum in independent chains, and only tiles that straddle
//     the causal diagonal, the window's lower edge or the end of the keys
//     evaluate the mask.  DV 64: three consumer warpgroups (192 q rows, 152
//     registers a thread after setmaxnreg, producer 40) and three stages;
//     DV 128: two (128 q rows, 232 registers) and two stages, whose 64 + 64
//     accumulator registers do not fit 152.  D sets only the number of k16
//     steps of Q K^T.  D 96 keeps Q and K as two 128-byte-swizzled column
//     blocks, the second holding columns 64-95 in its first half: Q K^T
//     issues 6 k16 steps, steps 4 and 5 at +0 and +32 bytes in block 1, and
//     the second half is never read (the same descriptors as at D 128; a
//     64-byte swizzle for the remainder would save 16 KB of Q and 16 KB a
//     K stage, which the 227 KB fit without).  K and V stages differ in
//     size when D != DV.
//   * bf16, D and Dv at most 32: fa_fwd_bf16, 4 warps of 16 q rows each in
//     a 64-row block, mma.sync m16n8k16, synchronous tile loads.
//   * f32: fa_fwd_f32, 8 warps, 4 threads per q row, plain fp32 FMAs on
//     the CUDA cores (full fp32, no TF32).
//
// What bounds it.  At the serving prefill shape (B=4, S=2048, H=32, KV=8,
// D=64, bf16, causal) one call does 4*B*H*D*S*(S+1)/2 = 68.7 GFLOP and
// moves 84 MB (q, k, v read once, o written once): compute-bound, ~69 us at
// the H100's 989 TFLOP/s bf16 peak against ~25 us of memory traffic (at
// minicpm3's prefill, H = KV = 40, D 96, Dv 64: 2·B·H·(D+Dv)·pairs = 107.4
// GFLOP, ~109 us, against ~63 us of bytes).  At
// D=64 the softmax's 16,384 ex2 per 128 x 128 tile take as long on the
// SM's 16 special-function lanes as the tile's two products on the tensor
// cores, so the softmax's instruction count and latency matter as much as
// the products; a warpgroup here waits for its S before the softmax and
// for P V after it, and overlaps only with the other warpgroups.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch (0 on
// success), or -1 for a head dim / dtype it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_dims.cuh"
#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 64;  // q rows per block
constexpr int BLOCK_N = 64;  // kv rows per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) or null
  int Sq, Skv, H, G;
  int D, Dv;  // the real head dims of q/k and of v/o (at most the kernel's widths)
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int window;  // 0 = off; otherwise 0 < window < Sq (the wrapper maps larger values to 0)
};

// Key range [lo, hi) that some row of the q tile starting at q0 can see;
// lo is rounded down to a tile boundary.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int& lo, int& hi) {
  hi = p.Skv;
  if (p.causal) hi = min(hi, q0 + BLOCK_M);
  lo = p.window ? max(0, q0 - p.window + 1) : 0;
  lo = (lo / BLOCK_N) * BLOCK_N;
}

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  bool ok = j < p.Skv;
  if (p.causal) ok = ok && j <= i;
  if (p.window) ok = ok && j > i - p.window;
  return ok;
}

// ------------------------------------------------------------------ f32

template <int D, int DV>
__global__ void __launch_bounds__(256) fa_fwd_f32(Params p) {
  constexpr int LD = D + 1;        // padded row stride: no bank conflicts
  constexpr int LDV = DV + 1;
  constexpr int LP = BLOCK_N + 1;
  constexpr int NT = 256;
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;            // BLOCK_M x LD
  float* Ks = Qs + BLOCK_M * LD;   // BLOCK_N x LD
  float* Vs = Ks + BLOCK_N * LD;   // BLOCK_N x LDV
  float* Ps = Vs + BLOCK_N * LDV;  // BLOCK_M x LP

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;  // long tiles first
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < BLOCK_M * D; idx += NT) {
    const int r = idx / D, d = idx % D, i = q0 + r;
    Qs[r * LD + d] = i < p.Sq && d < p.D ? q[i * p.q_ss + d] : 0.f;
  }

  const int r = tid >> 2;   // the q row this thread owns
  const int qd = tid & 3;   // its quarter: score columns qd + 4c, output columns qd + 4c
  const int i = q0 + r;
  float m = -INFINITY, l = 0.f;
  float acc[DV / 4];
#pragma unroll
  for (int c = 0; c < DV / 4; ++c) acc[c] = 0.f;

  int lo, hi;
  kv_range(p, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BLOCK_N) {
    __syncthreads();  // Qs written / previous tile fully read
    for (int idx = tid; idx < BLOCK_N * D; idx += NT) {
      const int c = idx / D, d = idx % D, j = k0 + c;
      Ks[c * LD + d] = j < p.Skv && d < p.D ? k[j * p.k_ss + d] : 0.f;
    }
    for (int idx = tid; idx < BLOCK_N * DV; idx += NT) {
      const int c = idx / DV, d = idx % DV, j = k0 + c;
      Vs[c * LDV + d] = j < p.Skv && d < p.Dv ? v[j * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[BLOCK_N / 4];
#pragma unroll
    for (int c = 0; c < BLOCK_N / 4; ++c) s[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * LD + d];
#pragma unroll
      for (int c = 0; c < BLOCK_N / 4; ++c) s[c] += qv * Ks[(qd + 4 * c) * LD + d];
    }

    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < BLOCK_N / 4; ++c) {
      s[c] = visible(p, i, k0 + qd + 4 * c) ? s[c] * p.scale : -INFINITY;
      mt = fmaxf(mt, s[c]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
    float ls = 0.f;
#pragma unroll
    for (int c = 0; c < BLOCK_N / 4; ++c) {
      const float pv = s[c] == -INFINITY ? 0.f : expf(s[c] - m_safe);
      Ps[r * LP + qd + 4 * c] = pv;
      ls += pv;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();  // row r of Ps is written and read by the same 4 lanes

#pragma unroll
    for (int c = 0; c < DV / 4; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int c = 0; c < BLOCK_N; ++c) {
      const float pv = Ps[r * LP + c];
#pragma unroll
      for (int dd = 0; dd < DV / 4; ++dd) acc[dd] += pv * Vs[c * LDV + qd + 4 * dd];
    }
  }

  if (i < p.Sq) {
    const float den = fmaxf(l, 1e-30f);
    float* o = static_cast<float*>(p.o) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int dd = 0; dd < DV / 4; ++dd)
      if (qd + 4 * dd < p.Dv) o[qd + 4 * dd] = acc[dd] / den;
    if (p.lse != nullptr && qd == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + i] = m == -INFINITY ? INFINITY : m + logf(l);
  }
}

// ----------------------------------------------------------------- bf16

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
template <int D, int LD, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int limit,
                                          int cols, int tid) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < BLOCK_N * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit && c * 8 < cols) val = *reinterpret_cast<const uint4*>(src + row * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(128) fa_fwd_bf16(Params p) {
  static_assert(BLOCK_M == 64 && BLOCK_N == 64, "4 warps x 16 rows, 8 n-tiles");
  constexpr int LD = D + 8;  // 16-byte pad: rows stay 16-byte aligned, banks spread
  constexpr int LDV = DV + 8;
  constexpr int NT = 128;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Ks = Qs + BLOCK_M * LD;
  __nv_bfloat16* Vs = Ks + BLOCK_N * LD;  // BLOCK_N x LDV

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / thread in group
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;  // long tiles first
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<D, LD, NT>(Qs, q, p.q_ss, q0, p.Sq, p.D, tid);
  __syncthreads();

  // this warp's 16 q rows as mma A fragments, kept in registers
  const int qr = warp * 16 + g;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qf[ks][0] = ld32(Qs + qr * LD + ks * 16 + 2 * t);
    qf[ks][1] = ld32(Qs + (qr + 8) * LD + ks * 16 + 2 * t);
    qf[ks][2] = ld32(Qs + qr * LD + ks * 16 + 2 * t + 8);
    qf[ks][3] = ld32(Qs + (qr + 8) * LD + ks * 16 + 2 * t + 8);
  }

  const int i_row[2] = {q0 + qr, q0 + qr + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int dt = 0; dt < DV / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int lo, hi;
  kv_range(p, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BLOCK_N) {
    __syncthreads();  // previous tile fully read
    load_tile<D, LD, NT>(Ks, k, p.k_ss, k0, p.Skv, p.D, tid);
    load_tile<DV, LDV, NT>(Vs, v, p.v_ss, k0, p.Skv, p.Dv, tid);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LD + ks * 16 + 2 * t;
        mma_bf16(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    // element e of an n-tile: row g (e < 2) or g + 8, key nt*8 + 2t + (e & 1)
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = visible(p, i_row[e >> 1], j) ? s[nt][e] * p.scale : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
      }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
      mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      const float m_new = fmaxf(m[rr], mt[rr]);
      m_safe[rr] = m_new == -INFINITY ? 0.f : m_new;  // fully masked so far
      alpha[rr] = m[rr] == -INFINITY ? 0.f : __expf(m[rr] - m_safe[rr]);
      m[rr] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BLOCK_N / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = s[nt][e] == -INFINITY ? 0.f : __expf(s[nt][e] - m_safe[e >> 1]);
        s[nt][e] = pv;
        ls[e >> 1] += pv;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      ls[rr] += __shfl_xor_sync(0xffffffffu, ls[rr], 1);
      ls[rr] += __shfl_xor_sync(0xffffffffu, ls[rr], 2);
      l[rr] = l[rr] * alpha[rr] + ls[rr];
    }
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are the A
    // fragment of the kk-th 16-key slice
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t a[4] = {pack_f32(s[2 * kk][0], s[2 * kk][1]),
                             pack_f32(s[2 * kk][2], s[2 * kk][3]),
                             pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DV / 8; ++dt) {
        const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LDV + dt * 8 + g;
        mma_bf16(acc[dt], a, pack_bf16(vp[0], vp[LDV]), pack_bf16(vp[8 * LDV], vp[9 * LDV]));
      }
    }
  }

  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (i_row[rr] >= p.Sq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    if (p.lse != nullptr && t == 0)
      p.lse[static_cast<long long>(bh) * p.Sq + i_row[rr]] =
          m[rr] == -INFINITY ? INFINITY : m[rr] + logf(l[rr]);
    __nv_bfloat16* orow = o + i_row[rr] * p.o_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt)
      if (dt * 8 < p.Dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(acc[dt][2 * rr] / den, acc[dt][2 * rr + 1] / den);
  }
}

// --------------------------- bf16, D in {64, 96, 128}, DV in {64, 128}: wgmma

// One block per (batch * head, 64 NWG-row q tile): NWG consumer warpgroups
// of 64 q rows each and one producer warpgroup.  The producer copies Q once
// and the K (D wide) and V (DV wide) tiles of BN rows through a ring of
// STAGES stages in shared memory (cp.async into 128-byte-swizzled tiles, completion
// reported to a "full" mbarrier; the consumers release a stage through an
// "empty" one), so the next tiles' copies overlap this tile's products.
// Per tile each consumer warpgroup runs S = Q K^T (wgmma, both operands
// from shared memory), the online softmax in fp32 registers (the running
// max of the raw scores, one FFMA and one ex2 an element with the scale
// folded with log2 e; the per-element mask only on tiles that straddle the
// causal diagonal, the window's lower edge or the end of the keys), then
// O += P V (wgmma, P from registers as bf16, V read MN-major).  The
// threads start at 65,536 / (128 (NWG + 1)) registers each; setmaxnreg
// moves registers from the producer (PROD) to the consumers (CONS).
template <int D, int DV, int BN, int NWG, int STAGES>
__global__ void __launch_bounds__(128 * (NWG + 1), 1) fa_fwd_wgmma(Params p) {
  using namespace hopper;
  constexpr int BM = 64 * NWG;
  // 64-column blocks of Q/K (D 96 fills half of its second) and of V
  constexpr int DB = (D + 63) / 64, DVB = DV / 64;
  constexpr int Q_BYTES = BM * DB * 128, K_BYTES = BN * DB * 128, V_BYTES = BN * DVB * 128;
  constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // setmaxnreg.inc waits until the registers it asks for are free: NWG 128
  // (CONS - start) must fit in 128 (start - PROD) plus the SM's spare
  // (start 168 for NWG 2, 128 for NWG 3); 40 / 240 hung the card
  constexpr int PROD = 40, CONS = NWG == 2 ? 232 : 152;
  constexpr int CH = 4;  // independent chains of the row max / sum
  static_assert(NWG == 2 || NWG == 3, "two or three consumer warpgroups");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* KVs = Qs + Q_BYTES;  // stage s: K at s STAGE_BYTES, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(KVs + STAGES * STAGE_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // long tiles first
  const int hi = p.causal ? min(p.Skv, q0 + BM) : p.Skv;
  const int lo = p.window ? (max(0, q0 - p.window + 1) / BN) * BN : 0;
  const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

  if (tid == 0) {
    mbar_init(q_full, 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128);       // one cp.async arrival per producer thread
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * NWG) {  // ---------------------------------- producer
    setmaxnreg_dec<PROD>();
    const int pt = tid - 128 * NWG;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
    copy_tile<BM, D>(Qs, q, p.q_ss, q0, p.Sq, p.D, pt);
    cp_async_arrive(q_full);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      if (t >= STAGES) mbar_wait(&empty[st], (t / STAGES - 1) & 1);
      unsigned char* kd = KVs + st * STAGE_BYTES;
      copy_tile<BN, D>(kd, k, p.k_ss, lo + t * BN, p.Skv, p.D, pt);
      copy_tile<BN, DV>(kd + K_BYTES, v, p.v_ss, lo + t * BN, p.Skv, p.Dv, pt);
      cp_async_arrive(&full[st]);
    }
    cp_async_wait_all();
  } else {  // ---------------------------------------------- consumers
    setmaxnreg_inc<CONS>();
    const int w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, qd = lane & 3;
    const int r0 = q0 + 64 * w;                          // this warpgroup's first row
    const int i_row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    const float scale2 = p.scale * LOG2E;
    float o[DV / 2];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m of the raw scores; l per thread
    const uint32_t q_addr = smem_u32(Qs) + w * 64 * 128;

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES, k0 = lo + t * BN;
      const uint32_t k_addr = smem_u32(KVs + st * STAGE_BYTES);
      const uint32_t v_addr = k_addr + K_BYTES;
      mbar_wait(&full[st], (t / STAGES) & 1);
      fence_proxy_async();

      float s[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<0, 0>(s, desc_b128(q_addr + (ks >> 2) * (BM * 128) + (ks & 3) * 32, 16, 1024),
                       desc_b128(k_addr + (ks >> 2) * (BN * 128) + (ks & 3) * 32, 16, 1024),
                       ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // element e: row i_row[(e >> 1) & 1], key k0 + 8 (e / 4) + 2 qd + (e & 1)
      const bool masked = k0 + BN > p.Skv || (p.causal && k0 + BN - 1 > r0) ||
                          (p.window && k0 <= r0 + 63 - p.window);
      if (masked) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) {
          const int i = i_row[(e >> 1) & 1], j = k0 + 8 * (e >> 2) + 2 * qd + (e & 1);
          if (!visible(p, i, j)) s[e] = -INFINITY;
        }
      }
      // Row maxima and sums over this thread's BN / 4 scores of each row, in
      // CH independent chains: one serial chain of fmaxf / adds is latency-
      // bound (it made the whole kernel 1.5x slower on the H100).
      float mx[2][CH];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int u = 0; u < CH; ++u) mx[rr][u] = -INFINITY;
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        mx[(e >> 1) & 1][(e >> 2) % CH] = fmaxf(mx[(e >> 1) & 1][(e >> 2) % CH], s[e]);
      float m_scaled[2], alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int u = CH / 2; u > 0; u /= 2)
#pragma unroll
          for (int x = 0; x < u; ++x) mx[rr][x] = fmaxf(mx[rr][x], mx[rr][x + u]);
        float mt = mx[rr][0];
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[rr], mt);
        m_scaled[rr] = m_new == -INFINITY ? 0.f : m_new * scale2;  // fully masked so far
        alpha[rr] = m[rr] == -INFINITY ? 0.f : exp2_approx(m[rr] * scale2 - m_scaled[rr]);
        m[rr] = m_new;
      }
      uint32_t pa[BN / 16][4];
      float ls[2][CH] = {};
#pragma unroll
      for (int e = 0; e < BN / 2; e += 2) {
        const int rr = (e >> 1) & 1;  // masked: exp2(-inf) = 0
        const float p0 = exp2_approx(fmaf(s[e], scale2, -m_scaled[rr]));
        const float p1 = exp2_approx(fmaf(s[e + 1], scale2, -m_scaled[rr]));
        ls[rr][(e >> 2) % CH] += p0 + p1;
        pa[e >> 3][(e >> 1) & 3] = pack_bf16x2(p0, p1);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int u = CH / 2; u > 0; u /= 2)
#pragma unroll
          for (int x = 0; x < u; ++x) ls[rr][x] += ls[rr][x + u];
        l[rr] = l[rr] * alpha[rr] + ls[rr][0];
      }
#pragma unroll
      for (int e = 0; e < DV / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<1>(o, pa[kk], desc_b128(v_addr + kk * 16 * 128, BN * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      const int i = i_row[rr];
      if (i >= p.Sq) continue;
      const float inv = 1.f / fmaxf(l[rr], 1e-30f);
      if (p.lse != nullptr && qd == 0)
        p.lse[static_cast<long long>(bh) * p.Sq + i] =
            m[rr] == -INFINITY ? INFINITY : m[rr] * p.scale + logf(l[rr]);
      __nv_bfloat16* orow = out + i * p.o_ss + 2 * qd;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        if (8 * j < p.Dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- launch

template <int D, int DV>
cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = (64 * (2 * (D + 1) + DV + 1) + 64 * (BLOCK_N + 1)) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_f32<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fa_fwd_f32<D, DV><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = 64 * (2 * (D + 8) + DV + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_bf16<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fa_fwd_bf16<D, DV><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int DV, int BN, int NWG, int STAGES>
cudaError_t launch_wgmma(const Params& p, int bh, cudaStream_t stream) {
  // Q, the K/V ring, the mbarriers, and 1024 bytes to align the start
  constexpr int DB = (D + 63) / 64, DVB = DV / 64;
  constexpr int smem = 1024 + 64 * NWG * DB * 128 + STAGES * BN * (DB + DVB) * 128 + 8 * (1 + 2 * STAGES);
  static_assert(smem <= 232448, "more shared memory than a block can have");
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_wgmma<D, DV, BN, NWG, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.Sq + 64 * NWG - 1) / (64 * NWG));
  fa_fwd_wgmma<D, DV, BN, NWG, STAGES><<<grid, 128 * (NWG + 1), smem, stream>>>(p);
  return cudaGetLastError();
}

// The kernel of a (dtype, widths) pair: f32 FMA; bf16 mma.sync when both
// widths are at most 32, else wgmma at D >= 64 and DV >= 64 (three consumer
// warpgroups and stages at DV 64, two at DV 128).
struct Launch {
  const Params& p;
  int dtype, bh;
  dim3 grid;
  cudaStream_t stream;
  template <int D, int DV>
  cudaError_t run() const {
    if (dtype == 0) return launch_f32<D, DV>(p, grid, stream);
    if constexpr (D <= 32 && DV <= 32) {
      return launch_bf16<D, DV>(p, grid, stream);
    } else {
      constexpr int DW = D < 64 ? 64 : D;
      if constexpr (DV <= 64) return launch_wgmma<DW, 64, 128, 3, 3>(p, bh, stream);
      else return launch_wgmma<DW, 128, 128, 2, 2>(p, bh, stream);
    }
  }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D is the head dim of q and k, Dv that
// of v and o, each at most 128.  Strides are in elements; the last dim of
// q, k, v and o is contiguous.  lse: null, or B * H * Sq floats.  Returns 0
// on success.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
    int B, int Sq, int Skv, int H, int KV, int D, int Dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.Sq = Sq; p.Skv = Skv; p.H = H; p.G = H / KV; p.D = D; p.Dv = Dv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale; p.causal = causal; p.window = window;
  const Launch launch{p, dtype, B * H, dim3(B * H, (Sq + BLOCK_M - 1) / BLOCK_M),
                      static_cast<cudaStream_t>(stream)};
  return head_dims::with_widths(D, Dv, launch);
}
