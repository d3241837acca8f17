// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's ssd_pallas
// (src/repro/kernels/ssd_scan.py) has no VJP, and off the TPU its kops.ssd
// runs ref.ssd_ref, which jax.grad differentiates
// (src/repro/kernels/ops.py:43-47).  This is the backward of the port's
// forward (ssd_scan.cu): the gradients of (y, final state) = SSD(x, dt, A,
// B, C) with the state starting at 0, given dy and, when the final state is
// used, d(final state).
//
// Per (batch, head) and chunk of Q steps, with c the cumsum of a = dt A over
// the chunk (fp64, as the forward), xd_j = x_j dt_j (fp32, as JAX promotes),
// S0 the state before the chunk and dS1 the gradient of the state after it,
// G[i,j] = C_i.B_j, L[i,j] = exp(c_i - c_j) for i >= j (0 above, masked
// before the exp), M[i,j] = dy_i.xd_j and W = G L M:
//   d xd_j = sum_i (G L)[i,j] dy_i + exp(c_Q - c_j) dS1 B_j
//   dC_i   = sum_j (L M)[i,j] B_j  + exp(c_i) S0^T dy_i
//   dB_j   = sum_i (L M)[i,j] C_i  + exp(c_Q - c_j) dS1^T xd_j
//   dc_i   = sum_j W[i,j] - sum_k W[k,i] + exp(c_i) dy_i.(S0 C_i)
//            - exp(c_Q - c_i) xd_i.(dS1 B_i)
//   dc_Q  += sum_j exp(c_Q - c_j) xd_j.(dS1 B_j) + exp(c_Q) <S0, dS1>
//   da_t   = sum_{i >= t} dc_i;  dx = d xd dt;  ddt = x.d xd + da A;
//   dA_h   = sum over (batch, step) of da dt
// and across chunks S1 = exp(c_Q) S0 + U (U the chunk's own state) and
// dS0 = exp(c_Q) dS1 + V, V = sum_i exp(c_i) dy_i C_i^T.
//
// Three kernels on the caller's stream, then a cast:
//   ssd_bwd_states  one block per (batch, head, chunk) and side: U (x dt
//                   exp(c_Q - c_j) against B) or V (dy exp(c_i) against C)
//                   into scratch, and exp(c_Q);
//   ssd_bwd_carry   one thread per state element of a (batch, head): walks
//                   the chunks forward, leaving S0 in U's slot, then back,
//                   leaving dS1 in V's slot (from d(final state), or 0);
//   ssd_bwd_chunk   one block per (batch, head, chunk): the chunk's S0 and
//                   dS1 in shared memory; for each 64-row key tile j, its
//                   dS1 terms, then per query tile i >= j the tile pair's G,
//                   M, G L and L M (W's row and column sums into dc), d xd_j
//                   and dB_j; then for each query tile i its S0 terms and,
//                   per key tile j <= i, M again and dC_i; then the reverse
//                   cumsum of dc, ddt and the chunk's share of dA.
// dB and dC sum over the H / G heads of a group (all 48 or 50 at G 1) and dA
// over every (batch, step): fp32 atomics into zeroed fp32 accumulators, so
// they vary from run to run in the last bits; then dB and dC are cast to the
// inputs' type (bf16).  dx is rounded to x's type once.  Every product is a
// scalar fp32 FMA (no TF32), each thread owning a 4 x 4 or 4 x (16 NC)
// block strided by 16 of a 64-row tile, from shared tiles with odd row
// strides.  P <= 64, N <= 128, Q <= 1024, any strides.
//
// What bounds it.  At mamba2-780m's train shape (b 4, s 2048, h 48, p 64,
// g 1, n 128, chunk 256, bf16) the work it needs (launch/roofline.py's
// ssd_bwd_work: C B^T per group and chunk, then per head M, the two
// products with dy and with C and B over the causal triangle, and five
// (Q, P, N) products for S0, V and the state terms) is ~71 GFLOP, 0.072 ms
// at the bf16 tensor-core peak, against ~163 MB of inputs and outputs,
// 0.049 ms: operations bound.  This first kernel runs them as fp32 FMAs,
// a 67 TFLOP/s peak (1.06 ms), and executes about 1.5x of them (M twice,
// full diagonal tiles); one 203 KB block an SM, 8 warps.  On an H100
// (PERF.md) it takes ~9.1 ms there, ~87% of it in ssd_bwd_chunk.  The
// tensor cores (the forward's hi/lo bf16 wgmma plan) are the way down to
// the bound.

// Interface: plain C, loaded with ctypes.  The launches go on the caller's
// stream; the function returns cudaGetLastError() after them (0 on
// success), or -1 for a dtype, size or layout it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block, 16 x 16
constexpr int TILE = 64;         // chunk rows a tile
constexpr int LDT = TILE + 1;    // row stride of the 64 x 64 pair tiles
constexpr int MAX_P = 64;        // 4 x 16 columns per thread row
constexpr int MAX_N = 128;       // 8 x 16
constexpr int MAX_CHUNK = 1024;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  const float* dfinal;  // (batch, H, P, N) contiguous, or null: 0
  void* dx;             // (batch, S, H, P) contiguous, x's type
  float* ddt;           // (batch, S, H) contiguous
  float* dA;            // (H,), zeroed
  float* dB;            // (batch, S, G, N) contiguous fp32, zeroed
  float* dC;
  float* S0;            // per (batch * H, chunk) P x N: U, then S0
  float* dS1;           // per (batch * H, chunk) P x N: V, then dS1
  float* decay;         // per (batch * H, chunk): exp(c_Q)
  int S, H, P, N, G, rep, chunk, nc;
  long long x_sb, x_ss, x_sh, x_sp;
  long long dt_sb, dt_ss, dt_sh;
  long long A_s;
  long long B_sb, B_ss, B_sg, B_sn;
  long long C_sb, C_ss, C_sg, C_sn;
  long long dy_sb, dy_ss, dy_sh, dy_sp;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Sum over the 16 lanes of a half-warp (the threads of one tile row).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return half_warp_sum(v);
}

// cums[0, Q) = inclusive cumsum of dts[i] * A, the product in fp32 and the
// sum in fp64 (as the forward); run by the 32 lanes of one warp.
__device__ __forceinline__ void scan_cums(const float* dts, float A, double* cums, int Q,
                                          int lane) {
  const int per = (Q + 31) / 32, beg = lane * per, end = min(Q, beg + per);
  double run = 0.0;
  for (int i = beg; i < end; ++i) {
    run += dts[i] * A;
    cums[i] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  for (int i = beg; i < end; ++i) cums[i] += excl;
}

// v[t] <- sum_{i >= t} v[i] over [0, Q), summed in fp64; run by the 32
// lanes of one warp, lane l taking the (31 - l)-th run of rows so that the
// suffix over later runs is a prefix over earlier lanes.
__device__ __forceinline__ void suffix_sums(float* v, int Q, int lane) {
  const int per = (Q + 31) / 32, beg = (31 - lane) * per, end = min(Q, beg + per);
  double run = 0.0;
  for (int i = beg; i < end; ++i) run += v[i];
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  run = excl;
  for (int i = end - 1; i >= beg; --i) {
    run += v[i];
    v[i] = static_cast<float>(run);
  }
}

// Rows [row0, row0 + TILE) of a (rows x cols) operand as fp32 into a shared
// tile with row stride `lds`, each row times w[row] when w is given; rows
// at or past `rows` are 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int lds, const T* src, long long row_stride,
                                          long long col_stride, int row0, int rows, int cols,
                                          const float* w, int tid) {
  for (int idx = tid; idx < TILE * cols; idx += NT) {
    const int r = idx / cols, c = idx % cols, row = row0 + r;
    float v = 0.f;
    if (row < rows) {
      v = to_f32(src[row * row_stride + c * col_stride]);
      if (w != nullptr) v *= w[row];
    }
    dst[r * lds + c] = v;
  }
}

// U = sum_j (x_j dt_j exp(c_Q - c_j))^T B_j (blockIdx.y 0) or V = sum_i
// (dy_i exp(c_i))^T C_i (blockIdx.y 1) of one (batch, head, chunk), P x N
// fp32 into its scratch slot; block y 0 also writes exp(c_Q).  Each thread
// owns a 4 x NC block (p, n) strided by 16.
template <typename T, int NC>
__global__ void __launch_bounds__(NT) ssd_bwd_states(Params p) {
  const int P = p.P, N = p.N, Q = p.chunk, QP = round_up(Q, TILE);
  const int LDN = N | 1, LDP = P | 1;
  extern __shared__ double smem[];
  double* cums = smem;                                 // QP
  float* w = reinterpret_cast<float*>(cums + QP);      // QP: dt, then the row weights
  float* Rs = w + QP;                                  // TILE x LDN  B or C rows
  float* Ls = Rs + TILE * LDN;                         // TILE x LDP  weighted x or dy rows

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c = blockIdx.x % p.nc, bh = blockIdx.x / p.nc;
  const int b = bh / p.H, h = bh % p.H, grp = h / p.rep, c0 = c * Q;
  const bool own = blockIdx.y == 0;
  const float* dth = p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss;
  for (int i = tid; i < QP; i += NT) w[i] = i < Q ? dth[i * p.dt_ss] : 0.f;
  __syncthreads();
  if (tid < 32) scan_cums(w, p.A[h * p.A_s], cums, Q, tid);
  __syncthreads();
  const double total = cums[Q - 1];
  for (int i = tid; i < Q; i += NT)
    w[i] = own ? w[i] * expf(static_cast<float>(total - cums[i])) : expf(static_cast<float>(cums[i]));
  const T* L = static_cast<const T*>(own ? p.x : p.dy) +
               (own ? b * p.x_sb + h * p.x_sh + c0 * p.x_ss : b * p.dy_sb + h * p.dy_sh + c0 * p.dy_ss);
  const long long l_ss = own ? p.x_ss : p.dy_ss, l_sp = own ? p.x_sp : p.dy_sp;
  const T* R = static_cast<const T*>(own ? p.B : p.C) +
               (own ? b * p.B_sb + grp * p.B_sg + c0 * p.B_ss : b * p.C_sb + grp * p.C_sg + c0 * p.C_ss);
  const long long r_ss = own ? p.B_ss : p.C_ss, r_sn = own ? p.B_sn : p.C_sn;

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[a][k] = 0.f;
  for (int j0 = 0; j0 < Q; j0 += TILE) {
    __syncthreads();  // w is written; the previous tile is done with Rs, Ls
    load_rows(Rs, LDN, R, r_ss, r_sn, j0, Q, N, static_cast<const float*>(nullptr), tid);
    load_rows(Ls, LDP, L, l_ss, l_sp, j0, Q, P, w, tid);
    __syncthreads();
    for (int r = 0; r < TILE; ++r) {
      float lv[4], rv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) lv[a] = ty + 16 * a < P ? Ls[r * LDP + ty + 16 * a] : 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) rv[k] = tx + 16 * k < N ? Rs[r * LDN + tx + 16 * k] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < NC; ++k) acc[a][k] += lv[a] * rv[k];
    }
  }
  float* slot = (own ? p.S0 : p.dS1) + (static_cast<long long>(bh) * p.nc + c) * (P * N);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int pp = ty + 16 * a, n = tx + 16 * k;
      if (pp < P && n < N) slot[pp * N + n] = acc[a][k];
    }
  if (own && tid == 0) p.decay[static_cast<long long>(bh) * p.nc + c] = expf(static_cast<float>(total));
}

// One thread per state element of a (batch, head): forward over the chunks,
// S0_c into U's slot (S0_0 = 0, S0_{c+1} = exp(c_Q) S0_c + U_c); then back,
// dS1_c into V's slot (dS1 of the last chunk d(final state) or 0, dS1_{c-1}
// = exp(c_Q) dS1_c + V_c).  The slots are read AHEAD chunks at a time, so
// their loads are in flight together (a load after a store to the slots
// would wait for it).  grid (batch * H, P N / 256 rounded up).
__global__ void __launch_bounds__(NT) ssd_bwd_carry(Params p) {
  constexpr int AHEAD = 8;
  const int bh = blockIdx.x, PN = p.P * p.N, e = blockIdx.y * NT + threadIdx.x;
  if (e >= PN) return;
  float* u = p.S0 + static_cast<long long>(bh) * p.nc * PN + e;
  float* v = p.dS1 + static_cast<long long>(bh) * p.nc * PN + e;
  const float* dec = p.decay + static_cast<long long>(bh) * p.nc;
  float s = 0.f;
  for (int c0 = 0; c0 < p.nc; c0 += AHEAD) {
    float uc[AHEAD], d[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < p.nc) {
        uc[k] = __ldcg(u + static_cast<long long>(c0 + k) * PN);
        d[k] = __ldcg(dec + c0 + k);
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k >= p.nc) break;
      u[static_cast<long long>(c0 + k) * PN] = s;
      s = s * d[k] + uc[k];
    }
  }
  float ds = p.dfinal != nullptr ? p.dfinal[static_cast<long long>(bh) * PN + e] : 0.f;
  for (int c1 = p.nc - 1; c1 >= 0; c1 -= AHEAD) {   // chunks c1, c1 - 1, ... down
    float vc[AHEAD], d[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c1 - k >= 0) {
        vc[k] = __ldcg(v + static_cast<long long>(c1 - k) * PN);
        d[k] = __ldcg(dec + c1 - k);
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c1 - k < 0) break;
      v[static_cast<long long>(c1 - k) * PN] = ds;
      ds = ds * d[k] + vc[k];
    }
  }
}

// The gradients of one (batch, head, chunk); see the header.  Shared
// memory: cums (fp64), dt, dc and x.d xd per row; S0 and dS1 (P x N); a
// query tile's C and dy rows, a key tile's B and x dt rows; the pair
// tiles G L and L M.  Thread (tx, ty) owns rows ty + 16 a and columns
// tx + 16 k of each 64-row output tile.
template <typename T, int NC>
__global__ void __launch_bounds__(NT) ssd_bwd_chunk(Params p) {
  const int P = p.P, N = p.N, Q = p.chunk, QP = round_up(Q, TILE);
  const int LDN = N | 1, LDP = P | 1;
  extern __shared__ double smem[];
  double* cums = smem;                                 // QP
  float* dts = reinterpret_cast<float*>(cums + QP);    // QP
  float* dcs = dts + QP;                               // QP  dc, then da
  float* xdot = dcs + QP;                              // QP  x . d xd
  float* S0s = xdot + QP;                              // P x LDN
  float* dS1s = S0s + P * LDN;                         // P x LDN
  float* Cs = dS1s + P * LDN;                          // TILE x LDN  query rows
  float* Bs = Cs + TILE * LDN;                         // TILE x LDN  key rows
  float* Ds = Bs + TILE * LDN;                         // TILE x LDP  dy, query rows
  float* Xs = Ds + TILE * LDP;                         // TILE x LDP  x dt, key rows
  float* GLs = Xs + TILE * LDP;                        // TILE x LDT  (G L)[i, j]
  float* LMs = GLs + TILE * LDT;                       // TILE x LDT  (L M)[i, j]
  float* red = LMs + TILE * LDT;                       // 2: sum of the r_j, <S0, dS1>

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31;
  const int c = blockIdx.x % p.nc, bh = blockIdx.x / p.nc;
  const int b = bh / p.H, h = bh % p.H, grp = h / p.rep, c0 = c * Q;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh + c0 * p.x_ss;
  const T* dy = static_cast<const T*>(p.dy) + b * p.dy_sb + h * p.dy_sh + c0 * p.dy_ss;
  const T* Bc = static_cast<const T*>(p.B) + b * p.B_sb + grp * p.B_sg + c0 * p.B_ss;
  const T* Cc = static_cast<const T*>(p.C) + b * p.C_sb + grp * p.C_sg + c0 * p.C_ss;
  const float* dth = p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss;
  const long long row0 = static_cast<long long>(b) * p.S + c0;   // (batch, step) row of the chunk
  T* dx = static_cast<T*>(p.dx) + (row0 * p.H + h) * P;          // rows H P apart
  float* ddt = p.ddt + row0 * p.H + h;                           // rows H apart
  float* dBg = p.dB + (row0 * p.G + grp) * N;                    // rows G N apart
  float* dCg = p.dC + (row0 * p.G + grp) * N;
  const long long bc_rs = static_cast<long long>(p.G) * N;
  const float A = p.A[h * p.A_s];

  for (int i = tid; i < QP; i += NT) {
    dts[i] = i < Q ? dth[i * p.dt_ss] : 0.f;
    dcs[i] = 0.f;
    xdot[i] = 0.f;
  }
  if (tid < 2) red[tid] = 0.f;
  const long long slot = (static_cast<long long>(bh) * p.nc + c) * (P * N);
  for (int idx = tid; idx < P * N; idx += NT) {
    S0s[(idx / N) * LDN + idx % N] = p.S0[slot + idx];
    dS1s[(idx / N) * LDN + idx % N] = p.dS1[slot + idx];
  }
  __syncthreads();
  if (tid < 32) scan_cums(dts, A, cums, Q, tid);
  float dot = 0.f;
  for (int idx = tid; idx < P * N; idx += NT) dot += p.S0[slot + idx] * p.dS1[slot + idx];
  dot = warp_sum(dot);
  if (lane == 0) atomicAdd(&red[1], dot);
  __syncthreads();
  const double total = cums[Q - 1];

  // ---- key tiles: d xd_j, dB_j, and W's row and column sums
  for (int j0 = 0; j0 < Q; j0 += TILE) {
    __syncthreads();  // the previous tile is done with Bs and Xs
    load_rows(Bs, LDN, Bc, p.B_ss, p.B_sn, j0, Q, N, static_cast<const float*>(nullptr), tid);
    load_rows(Xs, LDP, x, p.x_ss, p.x_sp, j0, Q, P, dts, tid);
    __syncthreads();

    // dS1 terms: dxd[a][k] = (dS1 B_j)[p], dBa[a][k] = (dS1^T xd_j)[n]
    float dxd[4][4], dBa[4][NC];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int k = 0; k < 4; ++k) dxd[a][k] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) dBa[a][k] = 0.f;
    }
    for (int n = 0; n < N; ++n) {
      float bv[4], sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = Bs[(ty + 16 * a) * LDN + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = tx + 16 * k < P ? dS1s[(tx + 16 * k) * LDN + n] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) dxd[a][k] += bv[a] * sv[k];
    }
    for (int pp = 0; pp < P; ++pp) {
      float xv[4], sv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) xv[a] = Xs[(ty + 16 * a) * LDP + pp];
#pragma unroll
      for (int k = 0; k < NC; ++k) sv[k] = tx + 16 * k < N ? dS1s[pp * LDN + tx + 16 * k] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < NC; ++k) dBa[a][k] += xv[a] * sv[k];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      const float e = j < Q ? expf(static_cast<float>(total - cums[j])) : 0.f;
      float r = 0.f;   // xd_j . (dS1 B_j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (tx + 16 * k < P) r += Xs[(ty + 16 * a) * LDP + tx + 16 * k] * dxd[a][k];
      r = half_warp_sum(r) * e;
      if (tx == 0 && j < Q) {   // one half-warp a row: no other thread writes dcs[j] now
        dcs[j] -= r;
        atomicAdd(&red[0], r);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) dxd[a][k] *= e;
#pragma unroll
      for (int k = 0; k < NC; ++k) dBa[a][k] *= e;
    }

    for (int i0 = j0; i0 < Q; i0 += TILE) {
      __syncthreads();  // Cs, Ds, GLs, LMs free; dcs[j] written
      load_rows(Cs, LDN, Cc, p.C_ss, p.C_sn, i0, Q, N, static_cast<const float*>(nullptr), tid);
      load_rows(Ds, LDP, dy, p.dy_ss, p.dy_sp, i0, Q, P, static_cast<const float*>(nullptr), tid);
      __syncthreads();
      // G and M of the pair: rows i = i0 + ty + 16 a, columns j = j0 + tx + 16 k
      float gm[4][4], mm[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) gm[a][k] = mm[a][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
        for (int k = 0; k < 4; ++k) bv[k] = Bs[(tx + 16 * k) * LDN + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) gm[a][k] += cv[a] * bv[k];
      }
      for (int pp = 0; pp < P; ++pp) {
        float dv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = Ds[(ty + 16 * a) * LDP + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = Xs[(tx + 16 * k) * LDP + pp];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) mm[a][k] += dv[a] * xv[k];
      }
      float col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        float row = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + tx + 16 * k;
          // a select, not a product: above the diagonal the exp may be inf
          const float l = i < Q && j <= i ? expf(static_cast<float>(cums[i] - cums[j])) : 0.f;
          const float gl = gm[a][k] * l, lm = mm[a][k] * l, wv = gl * mm[a][k];
          GLs[(ty + 16 * a) * LDT + tx + 16 * k] = gl;
          LMs[(ty + 16 * a) * LDT + tx + 16 * k] = lm;
          row += wv;
          col[k] += wv;
        }
        row = half_warp_sum(row);
        if (tx == 0 && i < Q) atomicAdd(&dcs[i], row);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = col[k] + __shfl_xor_sync(0xffffffffu, col[k], 16);   // the warp's two rows
        if (lane < 16 && j0 + tx + 16 * k < Q) atomicAdd(&dcs[j0 + tx + 16 * k], -v);
      }
      __syncthreads();
      // d xd_j += (G L)^T dy, dB_j += (L M)^T C: rows j = j0 + ty + 16 a
      for (int ii = 0; ii < TILE; ++ii) {
        float gv[4], lv[4], dv[4], cv[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          gv[a] = GLs[ii * LDT + ty + 16 * a];
          lv[a] = LMs[ii * LDT + ty + 16 * a];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) dv[k] = tx + 16 * k < P ? Ds[ii * LDP + tx + 16 * k] : 0.f;
#pragma unroll
        for (int k = 0; k < NC; ++k) cv[k] = tx + 16 * k < N ? Cs[ii * LDN + tx + 16 * k] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int k = 0; k < 4; ++k) dxd[a][k] += gv[a] * dv[k];
#pragma unroll
          for (int k = 0; k < NC; ++k) dBa[a][k] += lv[a] * cv[k];
        }
      }
    }

    // dx = d xd dt; x . d xd for ddt; dB into the group's accumulator
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + ty + 16 * a;
      float xs = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pp = tx + 16 * k;
        if (j < Q && pp < P) {
          store(dx + j * static_cast<long long>(p.H) * P + pp, dxd[a][k] * dts[j]);
          xs += to_f32(x[j * p.x_ss + pp * p.x_sp]) * dxd[a][k];
        }
      }
      xs = half_warp_sum(xs);
      if (tx == 0 && j < Q) xdot[j] = xs;
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (j < Q && tx + 16 * k < N) atomicAdd(dBg + j * bc_rs + tx + 16 * k, dBa[a][k]);
    }
  }

  // ---- query tiles: dC_i and the S0 term of dc_i
  for (int i0 = 0; i0 < Q; i0 += TILE) {
    __syncthreads();  // every atomic into dcs has landed; Cs, Ds free
    load_rows(Cs, LDN, Cc, p.C_ss, p.C_sn, i0, Q, N, static_cast<const float*>(nullptr), tid);
    load_rows(Ds, LDP, dy, p.dy_ss, p.dy_sp, i0, Q, P, static_cast<const float*>(nullptr), tid);
    __syncthreads();
    float dCa[4][NC];   // rows i = i0 + ty + 16 a, columns n = tx + 16 k
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < NC; ++k) dCa[a][k] = 0.f;
    for (int pp = 0; pp < P; ++pp) {   // (S0^T dy_i)[n]
      float dv[4], sv[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = Ds[(ty + 16 * a) * LDP + pp];
#pragma unroll
      for (int k = 0; k < NC; ++k) sv[k] = tx + 16 * k < N ? S0s[pp * LDN + tx + 16 * k] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < NC; ++k) dCa[a][k] += dv[a] * sv[k];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      const float e = i < Q ? expf(static_cast<float>(cums[i])) : 0.f;
      float r = 0.f;   // C_i . (S0^T dy_i) = dy_i . (S0 C_i)
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (tx + 16 * k < N) r += Cs[(ty + 16 * a) * LDN + tx + 16 * k] * dCa[a][k];
      r = half_warp_sum(r);
      if (tx == 0 && i < Q) dcs[i] += e * r;   // one half-warp a row
#pragma unroll
      for (int k = 0; k < NC; ++k) dCa[a][k] *= e;
    }
    for (int j0 = 0; j0 <= i0; j0 += TILE) {
      __syncthreads();  // Bs, Xs, LMs free
      load_rows(Bs, LDN, Bc, p.B_ss, p.B_sn, j0, Q, N, static_cast<const float*>(nullptr), tid);
      load_rows(Xs, LDP, x, p.x_ss, p.x_sp, j0, Q, P, dts, tid);
      __syncthreads();
      float mm[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) mm[a][k] = 0.f;
      for (int pp = 0; pp < P; ++pp) {
        float dv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = Ds[(ty + 16 * a) * LDP + pp];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] = Xs[(tx + 16 * k) * LDP + pp];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) mm[a][k] += dv[a] * xv[k];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + tx + 16 * k;
          const float l = i < Q && j <= i ? expf(static_cast<float>(cums[i] - cums[j])) : 0.f;
          LMs[(ty + 16 * a) * LDT + tx + 16 * k] = mm[a][k] * l;
        }
      }
      __syncthreads();
      for (int jj = 0; jj < TILE; ++jj) {
        float lv[4], bv[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) lv[a] = LMs[(ty + 16 * a) * LDT + jj];
#pragma unroll
        for (int k = 0; k < NC; ++k) bv[k] = tx + 16 * k < N ? Bs[jj * LDN + tx + 16 * k] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int k = 0; k < NC; ++k) dCa[a][k] += lv[a] * bv[k];
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
#pragma unroll
      for (int k = 0; k < NC; ++k)
        if (i < Q && tx + 16 * k < N) atomicAdd(dCg + i * bc_rs + tx + 16 * k, dCa[a][k]);
    }
  }

  // ---- da = suffix sums of dc; ddt; the chunk's share of dA
  __syncthreads();
  if (tid == 0) dcs[Q - 1] += red[0] + expf(static_cast<float>(total)) * red[1];
  __syncthreads();
  if (tid < 32) suffix_sums(dcs, Q, tid);
  __syncthreads();
  float part = 0.f;
  for (int t = tid; t < Q; t += NT) {
    ddt[t * static_cast<long long>(p.H)] = xdot[t] + dcs[t] * A;
    part += dcs[t] * dts[t];
  }
  part = warp_sum(part);
  if (lane == 0) atomicAdd(p.dA + h, part);
}

template <typename T>
__global__ void __launch_bounds__(NT) cast_rows(const float* src, T* dst, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * NT)
    store(dst + i, src[i]);
}

template <typename T, int NC>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const int QP = round_up(p.chunk, TILE), LDN = p.N | 1, LDP = p.P | 1;
  const int smem_states = QP * 12 + 4 * (TILE * LDN + TILE * LDP);
  const int smem_chunk =
      QP * 20 + 4 * (2 * p.P * LDN + 2 * TILE * LDN + 2 * TILE * LDP + 2 * TILE * LDT + 2);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_states);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_chunk);
  if (err != cudaSuccess) return err;
  ssd_bwd_states<T, NC><<<dim3(bh * p.nc, 2), NT, smem_states, stream>>>(p);
  ssd_bwd_carry<<<dim3(bh, (p.P * p.N + NT - 1) / NT), NT, 0, stream>>>(p);
  ssd_bwd_chunk<T, NC><<<bh * p.nc, NT, smem_chunk, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const Params& p, int bh, cudaStream_t stream) {
  if (p.N <= 16) return launch<T, 1>(p, bh, stream);
  if (p.N <= 32) return launch<T, 2>(p, bh, stream);
  if (p.N <= 64) return launch<T, 4>(p, bh, stream);
  return launch<T, 8>(p, bh, stream);
}

}  // namespace

// dtype (of x, B, C, dy, dx, dB and dC): 0 = float32, 1 = bfloat16; dt, A,
// d(final state) (null: 0), ddt and dA are float32.  dx (batch, S, H, P),
// ddt (batch, S, H) and dA (H,) are contiguous, dA zeroed; dB_acc and
// dC_acc are zeroed contiguous (batch, S, G, N) float32 accumulators, and
// for bfloat16 dB and dC the contiguous outputs they are cast into (for
// float32 the accumulators are the outputs: dB and dC are not read).
// scratch: batch * H * ((S / chunk) * (2 P N + 1)) floats.  Strides are in
// elements.  Returns 0 on success.
extern "C" int ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* dy, const void* dfinal, void* dx, void* ddt, void* dA, void* dB_acc,
    void* dC_acc, void* dB, void* dC, void* scratch, int dtype,
    int batch, int S, int H, int P, int G, int N, int chunk,
    long long x_sb, long long x_ss, long long x_sh, long long x_sp,
    long long dt_sb, long long dt_ss, long long dt_sh, long long A_s,
    long long B_sb, long long B_ss, long long B_sg, long long B_sn,
    long long C_sb, long long C_ss, long long C_sg, long long C_sn,
    long long dy_sb, long long dy_ss, long long dy_sh, long long dy_sp, void* stream) {
  if (P < 1 || P > MAX_P || N < 1 || N > MAX_N || chunk < 1 || chunk > MAX_CHUNK ||
      G < 1 || H % G != 0 || S % chunk != 0 || (dtype != 0 && dtype != 1) || scratch == nullptr)
    return -1;
  if (batch == 0 || H == 0 || S == 0) return 0;
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt); p.A = static_cast<const float*>(A);
  p.B = B; p.C = C; p.dy = dy; p.dfinal = static_cast<const float*>(dfinal);
  p.dx = dx; p.ddt = static_cast<float*>(ddt); p.dA = static_cast<float*>(dA);
  p.dB = static_cast<float*>(dB_acc); p.dC = static_cast<float*>(dC_acc);
  p.S = S; p.H = H; p.P = P; p.N = N; p.G = G; p.rep = H / G; p.chunk = chunk; p.nc = S / chunk;
  const long long bhs = static_cast<long long>(batch) * H, slots = bhs * p.nc * P * N;
  p.S0 = static_cast<float*>(scratch);
  p.dS1 = p.S0 + slots;
  p.decay = p.dS1 + slots;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh; p.x_sp = x_sp;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh; p.A_s = A_s;
  p.B_sb = B_sb; p.B_ss = B_ss; p.B_sg = B_sg; p.B_sn = B_sn;
  p.C_sb = C_sb; p.C_ss = C_ss; p.C_sg = C_sg; p.C_sn = C_sn;
  p.dy_sb = dy_sb; p.dy_ss = dy_ss; p.dy_sh = dy_sh; p.dy_sp = dy_sp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = static_cast<int>(bhs);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_n<float>(p, bh, st);
  } else {
    err = launch_n<__nv_bfloat16>(p, bh, st);
    const long long n = static_cast<long long>(batch) * S * G * N;
    const int blocks = static_cast<int>((n + NT - 1) / NT < 4096 ? (n + NT - 1) / NT : 4096);
    if (err == cudaSuccess) {
      cast_rows<<<blocks, NT, 0, st>>>(p.dB, static_cast<__nv_bfloat16*>(dB), n);
      cast_rows<<<blocks, NT, 0, st>>>(p.dC, static_cast<__nv_bfloat16*>(dC), n);
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}
