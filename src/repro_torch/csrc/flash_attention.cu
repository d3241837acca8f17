// Flash attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (the Pallas TPU kernel K1): attention with an online softmax, causal,
// sliding-window (key j visible to query i iff j > i - window) and key-
// padding masks, GQA head h reading kv head h / (H / KV), running max,
// denominator and accumulator in fp32, rows with no visible key giving 0.
//
// Design.  One block per (batch * head, 64-row q tile).  The loop over kv
// tiles inside the block takes the place of the Pallas kernel's sequential
// ("arbitrary") kv grid axis; it starts at the window's lower limit and
// stops at the causal limit, so fully masked tiles cost nothing.  On
// request (a non-null `lse`) it also writes each row's log-sum-exp of the
// scaled scores, fp32 (B, H, Sq), for the backward kernels in
// flash_attention_bwd.cu; +inf for a row that sees no key, so that
// exp(s - lse) is 0 there.  K and V tiles of 64 rows are staged in shared
// memory.  q/k/v are read in their
// (B, S, H, D) layout through the strides the wrapper passes; nothing is
// transposed on the host.  Templates cover D in {16, 32, 64, 128}.
//   * bf16: 4 warps, each owning 16 q rows.  S = Q K^T and O += P V run on
//     the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate);
//     the S accumulator is re-packed in registers as the A operand of P V,
//     so P is rounded to bf16 there (the JAX kernel keeps P in fp32).
//   * f32: 8 warps, 4 threads per q row, plain fp32 FMAs on the CUDA cores
//     (full fp32, no TF32).
//
// What bounds it.  At the serving prefill shape (B=4, S=2048, H=32, KV=8,
// D=64, bf16, causal) one call does 4*B*H*D*S*(S+1)/2 = 68.7 GFLOP and
// moves 84 MB (q, k, v read once, o written once): compute-bound, ~69 us at
// the H100's 989 TFLOP/s bf16 peak against ~25 us of memory traffic.  This
// first version uses mma.sync with synchronous tile loads and no
// load/compute overlap; wgmma, TMA and a producer warp are later work.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch (0 on
// success), or -1 for a head dim / dtype it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int D>
__global__ void __launch_bounds__(256) fa_fwd_f32(Params p) {
  constexpr int LD = D + 1;        // padded row stride: no bank conflicts
  constexpr int LP = BLOCK_N + 1;
  constexpr int NT = 256;
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;            // BLOCK_M x LD
  float* Ks = Qs + BLOCK_M * LD;   // BLOCK_N x LD
  float* Vs = Ks + BLOCK_N * LD;   // BLOCK_N x LD
  float* Ps = Vs + BLOCK_N * LD;   // BLOCK_M x LP

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;  // long tiles first
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < BLOCK_M * D; idx += NT) {
    const int r = idx / D, d = idx % D, i = q0 + r;
    Qs[r * LD + d] = i < p.Sq ? q[i * p.q_ss + d] : 0.f;
  }

  const int r = tid >> 2;   // the q row this thread owns
  const int qd = tid & 3;   // its quarter: score columns qd + 4c, output columns qd + 4c
  const int i = q0 + r;
  float m = -INFINITY, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) acc[c] = 0.f;

  int lo, hi;
  kv_range(p, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BLOCK_N) {
    __syncthreads();  // Qs written / previous tile fully read
    for (int idx = tid; idx < BLOCK_N * D; idx += NT) {
      const int c = idx / D, d = idx % D, j = k0 + c;
      const bool ok = j < p.Skv;
      Ks[c * LD + d] = ok ? k[j * p.k_ss + d] : 0.f;
      Vs[c * LD + d] = ok ? v[j * p.v_ss + d] : 0.f;
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
    for (int c = 0; c < D / 4; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int c = 0; c < BLOCK_N; ++c) {
      const float pv = Ps[r * LP + c];
#pragma unroll
      for (int dd = 0; dd < D / 4; ++dd) acc[dd] += pv * Vs[c * LD + qd + 4 * dd];
    }
  }

  if (i < p.Sq) {
    const float den = fmaxf(l, 1e-30f);
    float* o = static_cast<float*>(p.o) + b * p.o_sb + i * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int dd = 0; dd < D / 4; ++dd) o[qd + 4 * dd] = acc[dd] / den;
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

// Copy `rows` rows of D bf16 (16-byte chunks; the wrapper checks the
// alignment) into a shared tile with row stride LD, zero past `limit`.
template <int D, int LD, int NT>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int limit,
                                          int tid) {
  constexpr int CH = D / 8;
  for (int idx = tid; idx < BLOCK_N * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit) val = *reinterpret_cast<const uint4*>(src + row * row_stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128) fa_fwd_bf16(Params p) {
  static_assert(BLOCK_M == 64 && BLOCK_N == 64, "4 warps x 16 rows, 8 n-tiles");
  constexpr int LD = D + 8;  // 16-byte pad: rows stay 16-byte aligned, banks spread
  constexpr int NT = 128;
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Ks = Qs + BLOCK_M * LD;
  __nv_bfloat16* Vs = Ks + BLOCK_N * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / thread in group
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / p.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK_M;  // long tiles first
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<D, LD, NT>(Qs, q, p.q_ss, q0, p.Sq, tid);
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
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  int lo, hi;
  kv_range(p, q0, lo, hi);
  for (int k0 = lo; k0 < hi; k0 += BLOCK_N) {
    __syncthreads();  // previous tile fully read
    load_tile<D, LD, NT>(Ks, k, p.k_ss, k0, p.Skv, tid);
    load_tile<D, LD, NT>(Vs, v, p.v_ss, k0, p.Skv, tid);
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
    for (int dt = 0; dt < D / 8; ++dt) {
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
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LD + dt * 8 + g;
        mma_bf16(acc[dt], a, pack_bf16(vp[0], vp[LD]), pack_bf16(vp[8 * LD], vp[9 * LD]));
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
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * rr] / den, acc[dt][2 * rr + 1] / den);
  }
}

// ---------------------------------------------------------------- launch

template <int D>
cudaError_t launch_f32(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = (3 * 64 * (D + 1) + 64 * (BLOCK_N + 1)) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fa_fwd_f32<D><<<grid, 256, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t stream) {
  const int smem = 3 * 64 * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(fa_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fa_fwd_bf16<D><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of q, k, v and o is contiguous.  lse: null, or B * H * Sq floats.
// Returns 0 on success.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
    int B, int Sq, int Skv, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.Sq = Sq; p.Skv = Skv; p.H = H; p.G = H / KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale; p.causal = causal; p.window = window;
  const dim3 grid(B * H, (Sq + BLOCK_M - 1) / BLOCK_M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    switch (D) {
      case 16: err = launch_f32<16>(p, grid, st); break;
      case 32: err = launch_f32<32>(p, grid, st); break;
      case 64: err = launch_f32<64>(p, grid, st); break;
      case 128: err = launch_f32<128>(p, grid, st); break;
      default: return -1;
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: err = launch_bf16<16>(p, grid, st); break;
      case 32: err = launch_bf16<32>(p, grid, st); break;
      case 64: err = launch_bf16<64>(p, grid, st); break;
      case 128: err = launch_bf16<128>(p, grid, st); break;
      default: return -1;
    }
  } else {
    return -1;
  }
  return static_cast<int>(err);
}
