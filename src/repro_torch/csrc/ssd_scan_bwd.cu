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
// The entry point picks one of two routes before launch, from dtype, shape
// and layout alone (kernels/ssd_scan.py::ssd_bwd_route makes the same
// choice):
//
// * wgmma: bf16 x/B/C/dy, P = 64, N a multiple of 16 up to 128, Q a
//   multiple of 64, the last dim of x, B, C and dy contiguous and their
//   base pointers and other strides 16-byte aligned (the forward's wgmma
//   conditions, dy held to them as x is).  Four kernels on the caller's
//   stream, then the two casts:
//     ssd_bwd_state        one block per (batch, head, chunk) and side: U =
//                          (x w)^T B, w_j = dt_j exp(c_Q - c_j), or V = (dy
//                          e)^T C, e_i = exp(c_i) (the forward's
//                          ssd_chunk_state), and exp(c_Q); zeroes dc;
//     ssd_bwd_split_carry  8 state elements a thread, forward over the chunks
//                          (S0) and, in other blocks, back (dS1), leaving
//                          each chunk's S0 and dS1 in its slot as bf16 hi + lo;
//     ssd_bwd_tiles        one block per (64-row tile, role, batch, chunk,
//                          group, slice of up to HEADS of the group's heads),
//                          the blocks with the most pairs first.  A key tile
//                          j: per head its dS1 terms, then per query tile i >=
//                          j G^T = B_j C_i^T, M^T = x_j dy_i^T (exact bf16,
//                          then times dt_j), L, W's row sums (into dc_i) and
//                          column sums (out of dc_j), d xd_j += (G L)^T dy_i
//                          and dB_j += (L M)^T C_i; dx_j and x_j . d xd_j.
//                          A query tile i: per head S0's terms (dC_i += e_i
//                          S0^T dy_i, dc_i), then per key tile j <= i M
//                          again and dC_i += (L M) B_j;
//     ssd_bwd_dc           one block per (batch, head, chunk): dc_Q += exp(c_Q)
//                          <S0, dS1>, the suffix sums (fp64), ddt, dA.
//   Every product is a wgmma m64nNk16 (bf16 in, fp32 accumulate) of one
//   warpgroup.  G and M take the bf16 inputs as given; an fp32 operand goes
//   in as two bf16 terms, hi = bf16(v), lo = bf16(v - hi), against an exact
//   bf16 one, as two products: the chunk states' weighted rows, S0 and dS1,
//   and G L and L M as register A operands.  Key rows are the M dimension
//   of a key tile's products (G^T, M^T), so dy, C and B serve as MN-major B
//   operands and nothing is transposed through shared memory.  L is one ex2
//   per element of the fp64 difference of cums, masked by a select.  Tiles
//   arrive with cp.async into 128-byte-swizzled tiles one item ahead (two
//   stages).  dB_j and dC_i sum over the slice's heads in registers, then
//   one fp32 atomic a value a block; dc gathers with atomics; dx has none,
//   so two runs give bit-equal dx.
// * fma: everything else (f32, other P and N, chunks that are not a
//   multiple of 64).  Three kernels, then the casts: ssd_bwd_states (U, V),
//   ssd_bwd_carry (S0, dS1 in fp32), ssd_bwd_chunk (one block of 256 per
//   (batch, head, chunk): per 64-row key tile its dS1 terms and per query
//   tile at or below the pair's G, M, G L and L M, d xd_j and dB_j; per
//   query tile S0's terms and, per key tile at or above, M again and dC_i;
//   then dc's suffix sums, ddt and dA).  dB, dC (per head), dc and dA sum
//   with fp32 atomics.  Every product is a scalar fp32 FMA (no TF32), each
//   thread owning a 4 x 4 or 4 x (16 NC) block strided by 16 of a 64-row
//   tile, from shared tiles with odd row strides.  P <= 64, N <= 128, Q <=
//   1024, any strides.
// dB and dC are cast to the inputs' type (bf16) once, from fp32
// accumulators; dx is rounded to x's type once.  dB, dC, dA and ddt vary
// from run to run in their last bits (atomics).
//
// What bounds it.  At mamba2-780m's train shape (b 4, s 2048, h 48, p 64,
// g 1, n 128, chunk 256, bf16) the work it needs (launch/roofline.py's
// ssd_bwd_work: C B^T per group and chunk, then per head M, the two
// products with dy and with C and B over the causal triangle, and five
// (Q, P, N) products for S0, V and the state terms) is ~71 GFLOP, 0.072 ms
// at the bf16 tensor-core peak, against ~163 MB of inputs and outputs,
// 0.049 ms: operations bound.  The fma route runs them as fp32 FMAs, a 67
// TFLOP/s peak (1.06 ms), executes about 1.5x of them (M twice, full
// diagonal tiles), one 203 KB block an SM, 8 warps: ~9 ms on an H100
// (PERF.md).  The wgmma route executes ~180 GFLOP (G per head, M twice,
// each fp32 operand's second term, full diagonal tiles) and ~126 M exps,
// and moves ~400 MB of scratch (the states written, carried and read);
// its tile blocks (248 registers and ~102 KB of shared memory at n 128:
// two an SM) wait on each product in turn.
//
// Interface: plain C, loaded with ctypes.  The launches go on the caller's
// stream; the function returns cudaGetLastError() after them (0 on
// success), or -1 for a route, dtype, size or layout it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
  float* S0;            // per (batch * H, chunk) P x N: U, then S0 (wgmma route: as bf16 hi + lo)
  float* dS1;           // per (batch * H, chunk) P x N: V, then dS1 (wgmma route: as bf16 hi + lo)
  float* decay;         // per (batch * H, chunk): exp(c_Q)
  float* dc;            // wgmma route: per (batch * H, step) dc, summed with atomics
  int S, H, P, N, G, rep, chunk, nc;
  int hpb, nslice;      // wgmma route: heads a tile block walks, slices a group
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
cudaError_t launch_fma(const Params& p, int bh, cudaStream_t stream) {
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
cudaError_t launch_fma_n(const Params& p, int bh, cudaStream_t stream) {
  if (p.N <= 16) return launch_fma<T, 1>(p, bh, stream);
  if (p.N <= 32) return launch_fma<T, 2>(p, bh, stream);
  if (p.N <= 64) return launch_fma<T, 4>(p, bh, stream);
  return launch_fma<T, 8>(p, bh, stream);
}

// ------------------------------------------------ wgmma route (bf16, P 64)

using bf16 = __nv_bfloat16;
constexpr int WG = 128;                  // one warpgroup a block
constexpr int TILE_W = TILE * 256;       // bytes of a swizzled 64 x 128 bf16 tile (two column blocks)
constexpr int TILE_X = TILE * 128;       // bytes of a swizzled 64 x 64 one
constexpr int COLS = TILE * 128;         // bytes between the column blocks of a 64-row tile
constexpr int STAGE = 2 * TILE_W;        // a tile block's stage: a pair's two tiles, or a state's hi + lo
constexpr int HEADS = 4;                 // heads of one group a tile block walks

// Rows [0, 64) of a (rows, cols) bf16 operand, row stride rs (elements),
// last dim contiguous, into a swizzled 64-row tile with cp.async; cols a
// multiple of 8, thread t of 128.  Columns at or past cols are not written.
__device__ __forceinline__ void copy_rows(unsigned char* dst, const bf16* src, long long rs,
                                          int cols, int t) {
  const int ch = cols / 8;  // 16-byte chunks a row
  const uint32_t base = hopper::smem_u32(dst);
  for (int idx = t; idx < TILE * ch; idx += WG) {
    const int r = idx / ch, c = idx % ch;
    hopper::cp_async16(base + (c >> 3) * COLS + hopper::swz(r, c & 7), src + r * rs + c * 8, 16);
  }
}

// A (64, N) state left by ssd_bwd_split_carry (8-value groups of 16 bytes of
// hi, then 16 of lo) into swizzled hi and lo tiles of 64 rows (p) with
// cp.async.
__device__ __forceinline__ void copy_state(unsigned char* hi, unsigned char* lo,
                                           const float* slot, int N, int t) {
  const int ch = N / 8;
  const uint32_t h = hopper::smem_u32(hi), l = hopper::smem_u32(lo);
  for (int idx = t; idx < TILE * ch; idx += WG) {
    const int r = idx / ch, k = idx % ch;
    const uint32_t off = (k >> 3) * COLS + hopper::swz(r, k & 7);
    const float* src = slot + r * N + 8 * k;
    hopper::cp_async16(h + off, src, 16);
    hopper::cp_async16(l + off, src + 4, 16);
  }
}

// Two neighbouring bf16 of a swizzled tile (row r, columns n and n + 1, n
// even) as floats.
__device__ __forceinline__ float2 tile_pair(const unsigned char* tile, int r, int n) {
  const unsigned char* at = tile + (n >> 6) * COLS + hopper::swz(r, (n & 63) >> 3) + (n & 7) * 2;
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
}

// The sum over the four lanes of a quad (the threads of one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dt of the chunk's rows of head h into dts, and their cums; zeroes dcs when
// given.  Every thread of the block calls it.
__device__ __forceinline__ void head_cums(const Params& p, int b, int h, int c0, float* dts,
                                          double* cums, float* dcs, int tid) {
  const float* dth = p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss;
  for (int i = tid; i < p.chunk; i += WG) {
    dts[i] = dth[i * p.dt_ss];
    if (dcs != nullptr) dcs[i] = 0.f;
  }
  __syncthreads();
  if (tid < 32) scan_cums(dts, p.A[h * p.A_s], cums, p.chunk, tid);
  __syncthreads();
}

// U = (x w)^T B over the chunk, w_j = dt_j exp(c_Q - c_j), into the S0 slot
// and exp(c_Q) into decay (blockIdx.y 0); or V = (dy e)^T C, e_i = exp(c_i),
// into the dS1 slot, zeroing the chunk's dc (blockIdx.y 1).  The forward's
// ssd_chunk_state: the right operand (B or C, MN-major) and the left rows
// arrive with cp.async one tile ahead; the weighted left rows go in as hi +
// lo bf16 tiles written by the threads (the A operand, read MN-major).
// Columns of the state at or past N are computed from stale shared memory
// and dropped.
__global__ void __launch_bounds__(WG) ssd_bwd_state(Params p) {
  using namespace hopper;
  constexpr int STG = TILE_W + TILE_X;          // right rows, then left rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* st0 = align1024(smem_raw);     // two stages
  unsigned char* Lhi = st0 + 2 * STG;           // 64 x 64 weighted left rows, hi
  unsigned char* Llo = Lhi + TILE_X;            // and lo
  double* cums = reinterpret_cast<double*>(Llo + TILE_X);
  float* w = reinterpret_cast<float*>(cums + p.chunk);  // dt, then the row weights

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int c = blockIdx.x % p.nc, bh = blockIdx.x / p.nc;
  const int b = bh / p.H, h = bh % p.H, grp = h / p.rep;
  const int Q = p.chunk, nt = Q / TILE, c0 = c * Q;
  const bool own = blockIdx.y == 0;
  const bf16* L = static_cast<const bf16*>(own ? p.x : p.dy) +
                  (own ? b * p.x_sb + h * p.x_sh + c0 * p.x_ss
                       : b * p.dy_sb + h * p.dy_sh + c0 * p.dy_ss);
  const long long l_ss = own ? p.x_ss : p.dy_ss;
  const bf16* R = static_cast<const bf16*>(own ? p.B : p.C) +
                  (own ? b * p.B_sb + grp * p.B_sg + c0 * p.B_ss
                       : b * p.C_sb + grp * p.C_sg + c0 * p.C_ss);
  const long long r_ss = own ? p.B_ss : p.C_ss;

  copy_rows(st0, R, r_ss, p.N, tid);
  copy_rows(st0 + TILE_W, L, l_ss, TILE, tid);
  cp_async_commit();
  head_cums(p, b, h, c0, w, cums, nullptr, tid);
  const double total = cums[Q - 1];
  for (int i = tid; i < Q; i += WG)
    w[i] = own ? w[i] * expf(static_cast<float>(total - cums[i])) : expf(static_cast<float>(cums[i]));
  if (!own)
    for (int i = tid; i < Q; i += WG) p.dc[static_cast<long long>(bh) * p.S + c0 + i] = 0.f;

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  const uint32_t hi_addr = smem_u32(Lhi), lo_addr = smem_u32(Llo);
  for (int t = 0; t < nt; ++t) {
    unsigned char* cur = st0 + (t & 1) * STG;
    if (t + 1 < nt) {
      unsigned char* nxt = st0 + ((t + 1) & 1) * STG;
      copy_rows(nxt, R + (t + 1) * TILE * r_ss, r_ss, p.N, tid);
      copy_rows(nxt + TILE_W, L + (t + 1) * TILE * l_ss, l_ss, TILE, tid);
    }
    cp_async_commit();          // empty on the last tile
    cp_async_wait_group<1>();   // this tile's rows have landed ...
    __syncthreads();            // ... for every thread (and w is written)
    for (int idx = tid; idx < TILE * 8; idx += WG) {
      const int r = idx >> 3, ch = idx & 7;
      const uint4 raw = *reinterpret_cast<const uint4*>(cur + TILE_W + swz(r, ch));
      const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float wj = w[t * TILE + r];
      uint4 hi, lo;
      uint32_t* hp = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* lp = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(v[k]);
        split2(f.x * wj, f.y * wj, hp[k], lp[k]);
      }
      *reinterpret_cast<uint4*>(Lhi + swz(r, ch)) = hi;
      *reinterpret_cast<uint4*>(Llo + swz(r, ch)) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t r_addr = smem_u32(cur);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {  // 16 chunk rows a step: 2048 bytes
      const uint64_t rd = desc_b128(r_addr + kk * 2048, COLS, 1024);
      wgmma_ss<1, 1>(acc, desc_b128(hi_addr + kk * 2048, COLS, 1024), rd, 1);
      wgmma_ss<1, 1>(acc, desc_b128(lo_addr + kk * 2048, COLS, 1024), rd, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // Lhi, Llo and this stage are free
  }

  // acc element e: row p = 16 warp + g + 8 ((e >> 1) & 1), column n = 8 (e >> 2) + 2 qd + (e & 1)
  float* slot = (own ? p.S0 : p.dS1) + (static_cast<long long>(bh) * p.nc + c) * (TILE * p.N);
#pragma unroll
  for (int jb = 0; jb < 16; ++jb) {
    const int n = 8 * jb + 2 * qd;
    if (n >= p.N) continue;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(slot + (16 * warp + g + 8 * rr) * p.N + n) =
          make_float2(acc[4 * jb + 2 * rr], acc[4 * jb + 2 * rr + 1]);
  }
  if (own && tid == 0) p.decay[static_cast<long long>(bh) * p.nc + c] = expf(static_cast<float>(total));
}

// Per (batch * H), 8 consecutive state elements a thread: blockIdx.z 0 walks
// the chunks forward, S0_{c+1} = exp(c_Q) S0_c + U_c from S0_0 = 0;
// blockIdx.z 1 walks them back, dS1_{c-1} = exp(c_Q) dS1_c + V_c from
// d(final state) (or 0).  Each chunk's slot is left holding its S0 (or
// dS1) as bf16 hi + lo, as the forward's ssd_carry leaves S: the 32 bytes of
// 8 fp32 values become 16 bytes of hi, then 16 of lo.  The slots are read
// AHEAD chunks at a time, so their loads are in flight together.  grid
// (batch * H, 64 N / 1024, 2).
__global__ void __launch_bounds__(WG) ssd_bwd_split_carry(Params p) {
  constexpr int AHEAD = 8;
  const int bh = blockIdx.x, PN = TILE * p.N, nc = p.nc;
  const int e = (blockIdx.y * WG + threadIdx.x) * 8;
  const bool back = blockIdx.z == 1;
  float* slot = (back ? p.dS1 : p.S0) + static_cast<long long>(bh) * nc * PN + e;
  const float* dec = p.decay + static_cast<long long>(bh) * nc;
  float s[8] = {};
  if (back && p.dfinal != nullptr) {
    const float4* at = reinterpret_cast<const float4*>(p.dfinal + static_cast<long long>(bh) * PN + e);
    const float4 a = at[0], b = at[1];
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w; s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  }
  for (int k0 = 0; k0 < nc; k0 += AHEAD) {
    float4 u[AHEAD][2];
    float d[AHEAD];  // loaded with the slots: a load after a store to the slots waits for it
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (k0 + k < nc) {
        const int c = back ? nc - 1 - (k0 + k) : k0 + k;
        const float4* at = reinterpret_cast<const float4*>(slot + static_cast<long long>(c) * PN);
        u[k][0] = __ldcg(at);
        u[k][1] = __ldcg(at + 1);
        d[k] = __ldcg(dec + c);
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (k0 + k >= nc) break;
      const int c = back ? nc - 1 - (k0 + k) : k0 + k;
      uint4 hl[2];  // hi, lo
      hopper::split2(s[0], s[1], hl[0].x, hl[1].x);
      hopper::split2(s[2], s[3], hl[0].y, hl[1].y);
      hopper::split2(s[4], s[5], hl[0].z, hl[1].z);
      hopper::split2(s[6], s[7], hl[0].w, hl[1].w);
      uint4* at = reinterpret_cast<uint4*>(slot + static_cast<long long>(c) * PN);
      at[0] = hl[0];
      at[1] = hl[1];
      const float* uk = reinterpret_cast<const float*>(u[k]);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = s[i] * d[k] + uk[i];
    }
  }
}

// What a tile block reads and where: one (batch, chunk, group, slice of
// the group's heads) and one 64-row tile of the chunk.
struct TileJob {
  int b, c, grp, h0, h1, tile;
};

// The key tile j of a job: per head of the slice, first the dS1 terms
// (d xd_j = e_j dS1 B_j, dB_j += e_j dt_j dS1^T x_j, dc's r_j terms), then
// per query tile i >= j the pair: G^T = B_j C_i^T, M^T = x_j dy_i^T (times
// dt_j), L masked before its ex2, W = G L M's row sums (into dc_i) and
// column sums (out of dc_j), d xd_j += (G L)^T dy_i and dB_j += (L M)^T C_i
// with G L and L M as hi + lo register A operands; at the head's end dx_j =
// d xd_j dt_j, x_j . d xd_j into ddt, and the head's dc into the chunk's.
// dB_j sums over the slice's heads in registers: one atomic a value a block.
// Items (a head's dS1 terms, or one pair) run in order; each item's tiles
// arrive with cp.async while the item before runs.
template <int NW>
__device__ __forceinline__ void key_tiles(const Params& p, const TileJob& job, unsigned char* T0,
                                          unsigned char* X2, unsigned char* st, double* cums,
                                          float* dts, float* dcs) {
  using namespace hopper;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int Q = p.chunk, nq = Q / TILE, N = p.N, b = job.b, c0 = job.c * Q;
  const int jt = job.tile, j0 = jt * TILE, per_head = 1 + nq - jt;
  const int items = (job.h1 - job.h0) * per_head;
  const int r0 = 16 * warp + g;  // this thread's rows r0, r0 + 8 of the key tile
  const bf16* Cc = static_cast<const bf16*>(p.C) + b * p.C_sb + job.grp * p.C_sg + c0 * p.C_ss;

  auto issue = [&](int k) {   // the tiles of item k
    const int hh = k / per_head, s = k % per_head, h = job.h0 + hh;
    unsigned char* stage = st + (k & 1) * STAGE;
    if (s == 0) {
      copy_rows(X2 + (hh & 1) * TILE_X,
                static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + (c0 + j0) * p.x_ss,
                p.x_ss, TILE, tid);
      copy_state(stage, stage + TILE_W,
                 p.dS1 + ((static_cast<long long>(b) * p.H + h) * p.nc + job.c) * (TILE * N), N, tid);
    } else {
      const int i0 = j0 + (s - 1) * TILE;
      copy_rows(stage, Cc + i0 * p.C_ss, p.C_ss, N, tid);
      copy_rows(stage + TILE_W,
                static_cast<const bf16*>(p.dy) + b * p.dy_sb + h * p.dy_sh + (c0 + i0) * p.dy_ss,
                p.dy_ss, TILE, tid);
    }
  };

  copy_rows(T0, static_cast<const bf16*>(p.B) + b * p.B_sb + job.grp * p.B_sg + (c0 + j0) * p.B_ss,
            p.B_ss, N, tid);
  issue(0);
  cp_async_commit();

  float dB[NW / 2], dxd[32], colsum[2] = {0.f, 0.f}, dtj[2] = {0.f, 0.f};
  double cj[2] = {0.0, 0.0};
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) dB[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) dxd[e] = 0.f;
  const uint32_t b_addr = smem_u32(T0);

  for (int k = 0; k < items; ++k) {
    const int hh = k / per_head, s = k % per_head, h = job.h0 + hh;
    cp_async_wait_group<0>();   // item k's tiles have landed ...
    fence_proxy_async();
    __syncthreads();            // ... for every thread, and item k - 1 is done
    if (k + 1 < items) {
      issue(k + 1);
      cp_async_commit();
    }
    const unsigned char* stage = st + (k & 1) * STAGE;
    const unsigned char* xs = X2 + (hh & 1) * TILE_X;
    const uint32_t s_addr = smem_u32(stage), x_addr = smem_u32(xs);

    if (s == 0) {   // ---- the head's dS1 terms
      head_cums(p, b, h, c0, dts, cums, dcs, tid);
      const double total = cums[Q - 1];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        cj[rr] = cums[j0 + r0 + 8 * rr];
        dtj[rr] = dts[j0 + r0 + 8 * rr];
        colsum[rr] = 0.f;
      }
      float tmp[NW / 2];
      const uint32_t lo_addr = s_addr + TILE_W;
      wgmma_fence();
      for (int ks = 0; ks < N / 16; ++ks) {   // B_j dS1^T: both K-major over n
        const uint32_t off = (ks >> 2) * COLS + (ks & 3) * 32;
        const uint64_t a = desc_b128(b_addr + off, 16, 1024);
        wgmma_ss<0, 0>(dxd, a, desc_b128(s_addr + off, 16, 1024), ks > 0);
        wgmma_ss<0, 0>(dxd, a, desc_b128(lo_addr + off, 16, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {   // x_j dS1: dS1 MN-major, 16 p rows a step
        const uint64_t a = desc_b128(x_addr + kk * 32, 16, 1024);
        wgmma_ss<0, 1>(tmp, a, desc_b128(s_addr + kk * 2048, COLS, 1024), kk > 0);
        wgmma_ss<0, 1>(tmp, a, desc_b128(lo_addr + kk * 2048, COLS, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxd);
      fence_regs(tmp);
      // element e: row j0 + r0 + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 qd + (e & 1)
      float r[2] = {0.f, 0.f};   // x_j . (dS1 B_j)
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = (e >> 1) & 1;
        const float2 xv = tile_pair(xs, r0 + 8 * rr, 8 * (e >> 2) + 2 * qd);
        r[rr] += xv.x * dxd[e] + xv.y * dxd[e + 1];
      }
      float ej[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        ej[rr] = expf(static_cast<float>(total - cj[rr]));
        const float v = quad_sum(r[rr]) * dtj[rr] * ej[rr];
        if (qd == 0) {
          atomicAdd(&dcs[j0 + r0 + 8 * rr], -v);
          atomicAdd(&dcs[Q - 1], v);
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) dxd[e] *= ej[(e >> 1) & 1];
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) {
        const int rr = (e >> 1) & 1;
        dB[e] += tmp[e] * (dtj[rr] * ej[rr]);
      }
    } else {   // ---- the pair (key tile jt, query tile it)
      const int it = jt + s - 1, i0 = it * TILE;
      const bool diag = it == jt;
      const uint32_t dy_addr = s_addr + TILE_W;
      float gt[32], mt[32];
      wgmma_fence();
      for (int ks = 0; ks < N / 16; ++ks) {   // G^T = B_j C_i^T, K-major over n
        const uint32_t off = (ks >> 2) * COLS + (ks & 3) * 32;
        wgmma_ss<0, 0>(gt, desc_b128(b_addr + off, 16, 1024), desc_b128(s_addr + off, 16, 1024),
                       ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < TILE / 16; ++ks)   // M^T = x_j dy_i^T, K-major over p
        wgmma_ss<0, 0>(mt, desc_b128(x_addr + ks * 32, 16, 1024),
                       desc_b128(dy_addr + ks * 32, 16, 1024), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(gt);
      fence_regs(mt);
      // element e: key row j = r0 + 8 ((e >> 1) & 1), query column i = 8 (e >> 2) + 2 qd + (e & 1)
      uint32_t gh[4][4], gl[4][4], lh[4][4], ll[4][4];
      float rows[16];   // W's sums over this thread's two key rows, by query column
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = (e >> 1) & 1, jr = r0 + 8 * rr;
        float vg[2], vl[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ic = 8 * (e >> 2) + 2 * qd + u;
          float l = exp2_approx(static_cast<float>(cums[i0 + ic] - cj[rr]) * LOG2E);
          if (diag && ic < jr) l = 0.f;   // a select: above the diagonal the exp may be inf
          const float m = mt[e + u] * dtj[rr], gv = gt[e + u] * l, w = gv * m;
          vg[u] = gv;
          vl[u] = m * l;
          colsum[rr] += w;
          if (rr == 0) rows[2 * (e >> 2) + u] = w;
          else rows[2 * (e >> 2) + u] += w;
        }
        split2(vg[0], vg[1], gh[e >> 3][(e >> 1) & 3], gl[e >> 3][(e >> 1) & 3]);
        split2(vl[0], vl[1], lh[e >> 3][(e >> 1) & 3], ll[e >> 3][(e >> 1) & 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {   // dy_i and C_i MN-major: 16 query rows a step
        const uint64_t dyd = desc_b128(dy_addr + kk * 2048, COLS, 1024);
        wgmma_rs<1>(dxd, gh[kk], dyd, 1);
        wgmma_rs<1>(dxd, gl[kk], dyd, 1);
        const uint64_t cd = desc_b128(s_addr + kk * 2048, COLS, 1024);
        wgmma_rs<1>(dB, lh[kk], cd, 1);
        wgmma_rs<1>(dB, ll[kk], cd, 1);
      }
      wgmma_commit();
      // W's row sums: over the 8 row groups of the warp, then the warps in shared memory
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float v = rows[k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) atomicAdd(&dcs[i0 + 8 * (k >> 1) + 2 * qd + (k & 1)], v);
      }
      wgmma_wait<0>();
      fence_regs(dxd);
      fence_regs(dB);
    }

    if (s == per_head - 1) {   // ---- the head's end: dx, x . d xd, its dc
      bf16* dxh = static_cast<bf16*>(p.dx) +
                  ((static_cast<long long>(b) * p.S + c0 + j0) * p.H + h) * TILE;
      float* ddt = p.ddt + (static_cast<long long>(b) * p.S + c0 + j0) * p.H + h;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r0 + 8 * rr;
        float xs_sum = 0.f;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int pp = 8 * jb + 2 * qd;
          const float v0 = dxd[4 * jb + 2 * rr], v1 = dxd[4 * jb + 2 * rr + 1];
          *reinterpret_cast<__nv_bfloat162*>(dxh + static_cast<long long>(row) * p.H * TILE + pp) =
              __floats2bfloat162_rn(v0 * dtj[rr], v1 * dtj[rr]);
          const float2 xv = tile_pair(xs, row, pp);
          xs_sum += xv.x * v0 + xv.y * v1;
        }
        xs_sum = quad_sum(xs_sum);
        const float col = quad_sum(colsum[rr]);
        if (qd == 0) {
          ddt[static_cast<long long>(row) * p.H] = xs_sum;
          atomicAdd(&dcs[j0 + row], -col);
        }
      }
      __syncthreads();   // every contribution to dcs has landed
      float* dcg = p.dc + (static_cast<long long>(b) * p.H + h) * p.S + c0;
      for (int t = j0 + tid; t < Q; t += WG) atomicAdd(dcg + t, dcs[t]);
    }
  }

  // dB_j summed over the slice's heads: one float2 atomic a value pair
  float* dBg = p.dB + ((static_cast<long long>(b) * p.S + c0 + j0) * p.G + job.grp) * N;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float* row = dBg + static_cast<long long>(r0 + 8 * rr) * p.G * N;
#pragma unroll
    for (int jb = 0; jb < NW / 8; ++jb) {
      const int n = 8 * jb + 2 * qd;
      if (n < N)
        atomicAdd(reinterpret_cast<float2*>(row + n),
                  make_float2(dB[4 * jb + 2 * rr], dB[4 * jb + 2 * rr + 1]));
    }
  }
}

// The query tile i of a job: per head of the slice, first (after the first
// chunk) the S0 terms, t = dy_i S0 (dC_i += e_i t, dc_i += e_i C_i . t, e_i =
// exp(c_i)), then per key tile j <= i the pair: M = dy_i x_j^T (times dt_j)
// recomputed, L M as hi + lo register A operands, dC_i += (L M) B_j.  dC_i
// sums over the slice's heads in registers: one atomic a value a block.
template <int NW>
__device__ __forceinline__ void query_tiles(const Params& p, const TileJob& job, unsigned char* T0,
                                            unsigned char* X2, unsigned char* st, double* cums,
                                            float* dts) {
  using namespace hopper;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int Q = p.chunk, N = p.N, b = job.b, c0 = job.c * Q;
  const int it = job.tile, i0 = it * TILE, has_s = job.c > 0, per_head = has_s + it + 1;
  const int items = (job.h1 - job.h0) * per_head;
  const int r0 = 16 * warp + g;  // this thread's rows r0, r0 + 8 of the query tile
  const bf16* Bc = static_cast<const bf16*>(p.B) + b * p.B_sb + job.grp * p.B_sg + c0 * p.B_ss;

  auto issue = [&](int k) {   // the tiles of item k
    const int hh = k / per_head, s = k % per_head, h = job.h0 + hh;
    unsigned char* stage = st + (k & 1) * STAGE;
    if (s == 0)
      copy_rows(X2 + (hh & 1) * TILE_X,
                static_cast<const bf16*>(p.dy) + b * p.dy_sb + h * p.dy_sh + (c0 + i0) * p.dy_ss,
                p.dy_ss, TILE, tid);
    if (s < has_s) {
      copy_state(stage, stage + TILE_W,
                 p.S0 + ((static_cast<long long>(b) * p.H + h) * p.nc + job.c) * (TILE * N), N, tid);
    } else {
      const int j0 = (s - has_s) * TILE;
      copy_rows(stage, Bc + j0 * p.B_ss, p.B_ss, N, tid);
      copy_rows(stage + TILE_W,
                static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + (c0 + j0) * p.x_ss,
                p.x_ss, TILE, tid);
    }
  };

  copy_rows(T0, static_cast<const bf16*>(p.C) + b * p.C_sb + job.grp * p.C_sg + (c0 + i0) * p.C_ss,
            p.C_ss, N, tid);
  issue(0);
  cp_async_commit();

  float dC[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) dC[e] = 0.f;
  double ci[2] = {0.0, 0.0};

  for (int k = 0; k < items; ++k) {
    const int hh = k / per_head, s = k % per_head, h = job.h0 + hh;
    cp_async_wait_group<0>();
    fence_proxy_async();
    __syncthreads();
    if (k + 1 < items) {
      issue(k + 1);
      cp_async_commit();
    }
    const unsigned char* stage = st + (k & 1) * STAGE;
    const uint32_t s_addr = smem_u32(stage), dy_addr = smem_u32(X2 + (hh & 1) * TILE_X);
    if (s == 0) {
      head_cums(p, b, h, c0, dts, cums, nullptr, tid);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) ci[rr] = cums[i0 + r0 + 8 * rr];
    }

    if (s < has_s) {   // ---- the head's S0 terms
      float t[NW / 2];
      const uint32_t lo_addr = s_addr + TILE_W;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {   // dy_i K-major over p, S0 MN-major
        const uint64_t a = desc_b128(dy_addr + kk * 32, 16, 1024);
        wgmma_ss<0, 1>(t, a, desc_b128(s_addr + kk * 2048, COLS, 1024), kk > 0);
        wgmma_ss<0, 1>(t, a, desc_b128(lo_addr + kk * 2048, COLS, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t);
      // element e: row i0 + r0 + 8 ((e >> 1) & 1), column n = 8 (e >> 2) + 2 qd + (e & 1)
      float r[2] = {0.f, 0.f};   // C_i . (S0^T dy_i)
#pragma unroll
      for (int e = 0; e < NW / 2; e += 2) {
        const int rr = (e >> 1) & 1, n = 8 * (e >> 2) + 2 * qd;
        if (n < N) {
          const float2 cv = tile_pair(T0, r0 + 8 * rr, n);
          r[rr] += cv.x * t[e] + cv.y * t[e + 1];
        }
      }
      float ei[2];
      float* dcg = p.dc + (static_cast<long long>(b) * p.H + h) * p.S + c0 + i0;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        ei[rr] = expf(static_cast<float>(ci[rr]));
        const float v = quad_sum(r[rr]);
        if (qd == 0) atomicAdd(dcg + r0 + 8 * rr, ei[rr] * v);
      }
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) dC[e] += t[e] * ei[(e >> 1) & 1];
    } else {   // ---- the pair (query tile it, key tile jt)
      const int jt = s - has_s, j0 = jt * TILE;
      const bool diag = jt == it;
      const uint32_t x_addr = s_addr + TILE_W;
      float m[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TILE / 16; ++ks)   // M = dy_i x_j^T, K-major over p
        wgmma_ss<0, 0>(m, desc_b128(dy_addr + ks * 32, 16, 1024),
                       desc_b128(x_addr + ks * 32, 16, 1024), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(m);
      // element e: query row i = r0 + 8 ((e >> 1) & 1), key column j = 8 (e >> 2) + 2 qd + (e & 1)
      uint32_t lh[4][4], ll[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int rr = (e >> 1) & 1, ir = r0 + 8 * rr;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jc = 8 * (e >> 2) + 2 * qd + u, j = j0 + jc;
          float l = exp2_approx(static_cast<float>(ci[rr] - cums[j]) * LOG2E);
          if (diag && jc > ir) l = 0.f;   // a select: above the diagonal the exp may be inf
          v[u] = m[e + u] * dts[j] * l;
        }
        split2(v[0], v[1], lh[e >> 3][(e >> 1) & 3], ll[e >> 3][(e >> 1) & 3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {   // B_j MN-major: 16 key rows a step
        const uint64_t bd = desc_b128(s_addr + kk * 2048, COLS, 1024);
        wgmma_rs<1>(dC, lh[kk], bd, 1);
        wgmma_rs<1>(dC, ll[kk], bd, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dC);
    }
  }

  // dC_i summed over the slice's heads: one float2 atomic a value pair
  float* dCg = p.dC + ((static_cast<long long>(b) * p.S + c0 + i0) * p.G + job.grp) * N;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float* row = dCg + static_cast<long long>(r0 + 8 * rr) * p.G * N;
#pragma unroll
    for (int jb = 0; jb < NW / 8; ++jb) {
      const int n = 8 * jb + 2 * qd;
      if (n < N)
        atomicAdd(reinterpret_cast<float2*>(row + n),
                  make_float2(dC[4 * jb + 2 * rr], dC[4 * jb + 2 * rr + 1]));
    }
  }
}

// One block per (64-row tile, role, batch, chunk, group, slice of the
// group's heads): role 0 the key tile's work (key_tiles), role 1 the query
// tile's (query_tiles).  Blocks are ordered by their number of pairs, the
// most first: key tile 0 and query tile Q / 64 - 1 lead.
template <int NW>
__global__ void __launch_bounds__(WG) ssd_bwd_tiles(Params p) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* T0 = align1024(smem_raw);      // 64 x N: B_j (keys) or C_i (queries)
  unsigned char* X2 = T0 + TILE_W;              // two 64 x 64: x_j or dy_i, by head parity
  unsigned char* st = X2 + 2 * TILE_X;          // two stages
  double* cums = reinterpret_cast<double*>(st + 2 * STAGE);
  float* dts = reinterpret_cast<float*>(cums + p.chunk);
  float* dcs = dts + p.chunk;                   // keys: the head's dc contributions

  const int nq = p.chunk / TILE, per = gridDim.x / (2 * nq);
  const int lvl = blockIdx.x / (2 * per), keys = (blockIdx.x / per) % 2 == 0;
  int unit = blockIdx.x % per;
  TileJob job;
  const int slice = unit % p.nslice;
  unit /= p.nslice;
  job.grp = unit % p.G;
  unit /= p.G;
  job.c = unit % p.nc;
  job.b = unit / p.nc;
  job.h0 = job.grp * p.rep + slice * p.hpb;
  job.h1 = min(job.h0 + p.hpb, (job.grp + 1) * p.rep);
  job.tile = keys ? lvl : nq - 1 - lvl;
  if (keys)
    key_tiles<NW>(p, job, T0, X2, st, cums, dts, dcs);
  else
    query_tiles<NW>(p, job, T0, X2, st, cums, dts);
}

// Two values of a state as bf16 hi + lo pairs (one register each) dotted
// with two of another.
__device__ __forceinline__ float dot_hilo(uint32_t ah, uint32_t al, uint32_t bh, uint32_t bl) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ah));
  const float2 a2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&al));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bh));
  const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bl));
  return (a.x + a2.x) * (b.x + b2.x) + (a.y + a2.y) * (b.y + b2.y);
}

// Per (batch * H, chunk): dc_Q += exp(c_Q) <S0, dS1> (from the hi + lo
// slots), da = the suffix sums of dc (fp64), ddt = x . d xd (left in ddt by
// the key tiles) + da A, and the chunk's share of dA, sum of da dt.
__global__ void __launch_bounds__(WG) ssd_bwd_dc(Params p) {
  extern __shared__ float dc_smem[];
  const int Q = p.chunk;
  float* v = dc_smem;          // Q: dc, then da
  float* dtv = v + Q;          // Q
  float* red = dtv + Q;        // 4
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x % p.nc, bh = blockIdx.x / p.nc, b = bh / p.H, h = bh % p.H;
  const int c0 = c * Q, PN = TILE * p.N;
  float dot = 0.f;
  if (c > 0) {   // S0 = 0 before the first chunk
    const long long slot = (static_cast<long long>(bh) * p.nc + c) * PN;
    const uint4* s0 = reinterpret_cast<const uint4*>(p.S0 + slot);
    const uint4* s1 = reinterpret_cast<const uint4*>(p.dS1 + slot);
    for (int k = tid; k < PN / 8; k += WG) {
      const uint4 sh = s0[2 * k], sl = s0[2 * k + 1], dh = s1[2 * k], dl = s1[2 * k + 1];
      dot += dot_hilo(sh.x, sl.x, dh.x, dl.x) + dot_hilo(sh.y, sl.y, dh.y, dl.y) +
             dot_hilo(sh.z, sl.z, dh.z, dl.z) + dot_hilo(sh.w, sl.w, dh.w, dl.w);
    }
  }
  dot = warp_sum(dot);
  if (lane == 0) red[warp] = dot;
  const float* dth = p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss;
  const float* dcg = p.dc + static_cast<long long>(bh) * p.S + c0;
  for (int i = tid; i < Q; i += WG) {
    v[i] = dcg[i];
    dtv[i] = dth[i * p.dt_ss];
  }
  __syncthreads();
  if (tid == 0)
    v[Q - 1] += p.decay[static_cast<long long>(bh) * p.nc + c] * (red[0] + red[1] + red[2] + red[3]);
  __syncthreads();
  if (tid < 32) suffix_sums(v, Q, tid);
  __syncthreads();
  const float A = p.A[h * p.A_s];
  float* ddt = p.ddt + (static_cast<long long>(b) * p.S + c0) * p.H + h;
  float part = 0.f;
  for (int t = tid; t < Q; t += WG) {
    ddt[static_cast<long long>(t) * p.H] += v[t] * A;
    part += v[t] * dtv[t];
  }
  part = warp_sum(part);
  if (lane == 0) atomicAdd(p.dA + h, part);
}

template <int NW>
cudaError_t launch_wgmma(const Params& p0, int batch, cudaStream_t stream) {
  Params p = p0;
  p.hpb = min(HEADS, p.rep);
  p.nslice = (p.rep + p.hpb - 1) / p.hpb;
  const int Q = p.chunk, nq = Q / TILE, bh = batch * p.H;
  const int smem_state = 1024 + 2 * (TILE_W + TILE_X) + 2 * TILE_X + 12 * Q;
  const int smem_tiles = 1024 + TILE_W + 2 * TILE_X + 2 * STAGE + 16 * Q;
  const int smem_dc = 8 * Q + 16;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_state,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_state);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_tiles<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_tiles);
  if (err != cudaSuccess) return err;
  const int tiles = 2 * nq * batch * p.nc * p.G * p.nslice;
  ssd_bwd_state<<<dim3(bh * p.nc, 2), WG, smem_state, stream>>>(p);
  ssd_bwd_split_carry<<<dim3(bh, TILE * p.N / (8 * WG), 2), WG, 0, stream>>>(p);
  ssd_bwd_tiles<NW><<<tiles, WG, smem_tiles, stream>>>(p);
  ssd_bwd_dc<<<bh * p.nc, WG, smem_dc, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr, long long s0, long long s1, long long s2, long long s3) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 8 == 0 && s1 % 8 == 0 &&
         s2 % 8 == 0 && s3 == 1;
}

}  // namespace

// route: 0 = fma, 1 = wgmma (bf16, P 64, N a multiple of 16, chunk a
// multiple of 64; x, B, C and dy with a contiguous last dim and 16-byte
// aligned base pointers and other strides).  dtype (of x, B, C, dy, dx, dB
// and dC): 0 = float32, 1 = bfloat16; dt, A, d(final state) (null: 0), ddt
// and dA are float32.  dx (batch, S, H, P), ddt (batch, S, H) and dA (H,)
// are contiguous, dA zeroed; dB_acc and dC_acc are zeroed contiguous
// (batch, S, G, N) float32 accumulators, and for bfloat16 dB and dC the
// contiguous outputs they are cast into (for float32 the accumulators are
// the outputs: dB and dC are not read).  scratch: batch * H * ((S / chunk)
// * (2 P N + 1)) floats on the fma route, batch * H * ((S / chunk) * (2 P N
// + 1) + S) floats, 16-byte aligned, on the wgmma route.  Strides are in
// elements.  Returns 0 on success.
extern "C" int ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    const void* dy, const void* dfinal, void* dx, void* ddt, void* dA, void* dB_acc,
    void* dC_acc, void* dB, void* dC, void* scratch, int route, int dtype,
    int batch, int S, int H, int P, int G, int N, int chunk,
    long long x_sb, long long x_ss, long long x_sh, long long x_sp,
    long long dt_sb, long long dt_ss, long long dt_sh, long long A_s,
    long long B_sb, long long B_ss, long long B_sg, long long B_sn,
    long long C_sb, long long C_ss, long long C_sg, long long C_sn,
    long long dy_sb, long long dy_ss, long long dy_sh, long long dy_sp, void* stream) {
  if (P < 1 || P > MAX_P || N < 1 || N > MAX_N || chunk < 1 || chunk > MAX_CHUNK ||
      G < 1 || H % G != 0 || S % chunk != 0 || (dtype != 0 && dtype != 1) || scratch == nullptr ||
      (route != 0 && route != 1))
    return -1;
  if (route == 1 &&
      (dtype != 1 || P != TILE || N % 16 != 0 || chunk % TILE != 0 ||
       reinterpret_cast<uintptr_t>(scratch) % 16 != 0 || !aligned16(x, x_sb, x_ss, x_sh, x_sp) ||
       !aligned16(B, B_sb, B_ss, B_sg, B_sn) || !aligned16(C, C_sb, C_ss, C_sg, C_sn) ||
       !aligned16(dy, dy_sb, dy_ss, dy_sh, dy_sp)))
    return -1;
  if (batch == 0 || H == 0 || S == 0) return 0;
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt); p.A = static_cast<const float*>(A);
  p.B = B; p.C = C; p.dy = dy; p.dfinal = static_cast<const float*>(dfinal);
  p.dx = dx; p.ddt = static_cast<float*>(ddt); p.dA = static_cast<float*>(dA);
  p.dB = static_cast<float*>(dB_acc); p.dC = static_cast<float*>(dC_acc);
  p.S = S; p.H = H; p.P = P; p.N = N; p.G = G; p.rep = H / G; p.chunk = chunk; p.nc = S / chunk;
  p.hpb = p.nslice = 1;
  const long long bhs = static_cast<long long>(batch) * H, slots = bhs * p.nc * P * N;
  p.S0 = static_cast<float*>(scratch);
  p.dS1 = p.S0 + slots;
  p.decay = p.dS1 + slots;
  p.dc = p.decay + bhs * p.nc;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh; p.x_sp = x_sp;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh; p.A_s = A_s;
  p.B_sb = B_sb; p.B_ss = B_ss; p.B_sg = B_sg; p.B_sn = B_sn;
  p.C_sb = C_sb; p.C_ss = C_ss; p.C_sg = C_sg; p.C_sn = C_sn;
  p.dy_sb = dy_sb; p.dy_ss = dy_ss; p.dy_sh = dy_sh; p.dy_sp = dy_sp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bh = static_cast<int>(bhs);
  cudaError_t err;
  if (route == 1) {
    err = N <= 16   ? launch_wgmma<16>(p, batch, st)
          : N <= 32 ? launch_wgmma<32>(p, batch, st)
          : N <= 64 ? launch_wgmma<64>(p, batch, st)
                    : launch_wgmma<128>(p, batch, st);
  } else if (dtype == 0) {
    err = launch_fma_n<float>(p, bh, st);
  } else {
    err = launch_fma_n<__nv_bfloat16>(p, bh, st);
  }
  if (err == cudaSuccess && dtype == 1) {
    const long long n = static_cast<long long>(batch) * S * G * N;
    const int blocks = static_cast<int>((n + NT - 1) / NT < 4096 ? (n + NT - 1) / NT : 4096);
    cast_rows<<<blocks, NT, 0, st>>>(p.dB, static_cast<__nv_bfloat16*>(dB), n);
    cast_rows<<<blocks, NT, 0, st>>>(p.dC, static_cast<__nv_bfloat16*>(dC), n);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
