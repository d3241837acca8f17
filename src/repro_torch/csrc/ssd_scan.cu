// Mamba-2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_pallas (the Pallas TPU kernel
// K3).  Per (batch, head), over chunks of Q steps, with a (P, N) fp32 state S
// that starts at 0:
//   cums = cumsum(dt * A) over the chunk
//   L[i,j] = exp(cums_i - cums_j) for i >= j, 0 above the diagonal (the mask
//            is applied before the exp: above it the difference is large and
//            positive, and inf * 0 is NaN)
//   y  = ((C B^T) . L) (x dt) + exp(cums) . (C S^T)      (S from before the chunk)
//   S <- exp(cums_Q) S + sum_i exp(cums_Q - cums_i) (x_i dt_i)^T B_i
// Head h reads B/C group h / (H / G).  y is rounded to x's type once, at the
// end; everything else is fp32 (x * dt is promoted to fp32 as JAX does),
// except the running sum cums: it is accumulated and differenced in fp64.
// For the fast-decaying heads |cums| reaches several hundred within a
// chunk, where fp32's spacing (6e-5 at 700) would enter every
// exp(cums_i - cums_j) near the diagonal as a relative error of that size,
// and exp(cums_i) exp(-cums_j) would overflow.
//
// The entry point picks one of two routes before launch, from dtype, shape
// and layout alone (kernels/ssd_scan.py::ssd_route makes the same choice):
//
// * wgmma: bf16 x/B/C, P = 64, N a multiple of 16 up to 128, Q a multiple
//   of 64, the last dim of x, B and C contiguous and their base pointers and
//   other strides 16-byte aligned (the main path's views of one projection
//   row, 3328 elements apart, are).  Chunk-parallel, three kernels on the
//   caller's stream:
//     ssd_chunk_state  one block per (batch, head, chunk): the chunk's own
//                      state U_c = x^T (w . B), w_j = dt_j exp(total - cums_j),
//                      its decay exp(total), and its cums and dt, into
//                      scratch;
//     ssd_carry        8 state elements of one (batch, head) a thread: walks
//                      the chunks, S_c = exp(total_c) S_{c-1} + U_c, leaving
//                      the state before each chunk over U_c as bf16 hi + lo
//                      (50 MB at the serving shape), and writes the final
//                      state;
//     ssd_chunk_out    one block per (batch, head, chunk, 64-row query tile),
//                      a chunk's four tiles adjacent in launch order, the
//                      longest first: y = exp(cums) . (C S^T) and, per key
//                      tile at or below it, (C B^T . L . dt_j) x.
//   Every product is a wgmma m64nNk16 (bf16 in, fp32 accumulate) of one
//   warpgroup.  C B^T takes the bf16 inputs as given (exact products).  An
//   fp32 operand goes in as two bf16 terms, hi = bf16(v), lo = bf16(v - hi)
//   (about 16 bits of mantissa) against an exact bf16 operand, as two
//   products: x w for the state (A read MN-major from shared memory), S for
//   C S^T, and the score (C B^T . L . dt_j) as the register A operand of
//   the product with x, so x stays exact.  L is one ex2 per element of the
//   fp64 difference, with log2(e) folded in.  Tiles arrive with cp.async
//   into 128-byte-swizzled shared tiles, one key tile ahead (two stages);
//   S's hi/lo tiles, in two halves of 64 columns, borrow the second stage
//   before the first key tile.  No atomics: two runs give the same bits.
// * fma: everything else (f32, other P and N, chunks that are not a
//   multiple of 64, the one-token prefill's chunk of 1).  One block of 256
//   threads per (batch * head) loops over the chunks itself and keeps S in
//   shared memory; a chunk is staged in synchronous tiles of 64 rows, every
//   product a scalar fp32 FMA (no TF32).  P <= 64, N <= 128, Q <= 1024.
//
// What bounds it.  At the serving prefill shape (b=4, s=2048, h=48, p=64,
// g=1, n=128, chunk 256, bf16 x/B/C) the scan moves ~113 MB (x, dt, B, C
// read once, y and the final state written once): 0.0337 ms at 3.35 TB/s,
// against ~19.6 GFLOP of needed operations (C B^T once per group and
// chunk, then per head the score product, C S^T and the state update),
// 0.0198 ms at the 989 TFLOP/s bf16 tensor-core peak: bytes-bound.  The
// wgmma route executes ~58 GFLOP (C B^T per head, each fp32 operand's
// second term, full diagonal tiles) and ~63 M exps, and its scratch adds
// ~250 MB of traffic (the chunk states written, carried, and read by the
// four query tiles of each chunk).  What the first kernel (now the fma route)
// lost and what the wgmma route does about it: its products were scalar
// fp32 FMAs from shared memory (now wgmma); it recomputed C B^T per head on
// the CUDA cores (now on the tensor cores, ~16 GFLOP); it ran 192 blocks,
// 1.45 waves on 132 SMs, each walking its chunks in order (now 1536 state
// blocks and 6144 output blocks, the chunk order only in the carry pass);
// it loaded synchronously with scalar converts (now cp.async of 16 bytes,
// one tile ahead).  On an H100 (PERF.md) the route takes ~0.33 ms there,
// two thirds of it in ssd_chunk_out, whose warpgroups (three an SM, by
// shared memory and registers) wait on each product in turn.

// Interface: plain C, loaded with ctypes.  The launches go on the caller's
// stream; the function returns cudaGetLastError() after them (0 on
// success), or -1 for a route, dtype, size or layout it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;          // fma route: threads per block, 16 x 16
constexpr int TILE = 64;         // chunk rows staged at a time (both routes)
constexpr int LDG = TILE + 1;    // row stride of the score tile
constexpr int MAX_P = 64;        // 4 x 16 state rows per thread column
constexpr int MAX_N = 128;       // 8 x 16 state columns per thread row
constexpr int MAX_CHUNK = 1024;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;
  // wgmma route scratch, per batch * H: the chunks' (P, N) states (U_c,
  // then S_{c-1} as hi/lo), cums and dt of every step, exp(total_c)
  float* states;
  double* cums;
  float* dts;
  float* decay;
  int S, H, P, N, rep, chunk, nc;
  long long x_sb, x_ss, x_sh, x_sp;
  long long dt_sb, dt_ss, dt_sh;
  long long A_s;
  long long B_sb, B_ss, B_sg, B_sn;
  long long C_sb, C_ss, C_sg, C_sn;
  long long y_sb, y_ss, y_sh;  // y's last dim is contiguous (the wrapper allocates it)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

// cums[0, Q) = inclusive cumsum of dts[i] * A, the product in fp32 (as JAX
// forms dt * A) and the sum in fp64; run by the 32 lanes of one warp, one
// run of Q / 32 rows each.
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

// ------------------------------------------------------ fma route (any T)

// Rows [row0, row0 + TILE) of a (rows x cols) operand as fp32 into a shared
// tile with row stride `lds`; rows at or past `rows` are 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int lds, const T* src, long long row_stride,
                                          long long col_stride, int row0, int rows, int cols,
                                          int tid) {
  for (int idx = tid; idx < TILE * cols; idx += NT) {
    const int r = idx / cols, c = idx % cols, row = row0 + r;
    dst[r * lds + c] = row < rows ? to_f32(src[row * row_stride + c * col_stride]) : 0.f;
  }
}

// x rows [row0, row0 + TILE) times dt (times `decay` when the chunk's total
// is given), as fp32 into a shared tile with row stride `lds`; 0 past Q.
template <typename T>
__device__ __forceinline__ void load_xdt(float* dst, int lds, const T* x, const Params& p,
                                         const float* dts, const double* cums, bool decay,
                                         double total, int row0, int Q, int tid) {
  for (int idx = tid; idx < TILE * p.P; idx += NT) {
    const int r = idx / p.P, c = idx % p.P, j = row0 + r;
    float v = 0.f;
    if (j < Q) {
      v = to_f32(x[j * p.x_ss + c * p.x_sp]) * dts[j];
      if (decay) v *= expf(static_cast<float>(total - cums[j]));
    }
    dst[r * lds + c] = v;
  }
}

// One block per (batch * head) loops over the chunks and keeps S in shared
// memory.  For each query tile of 64 rows, its C rows are loaded once, the
// inter-chunk term C S^T is computed from the old state, then the key tiles
// at or below it add (C B^T . L)(x dt); only after every query tile has
// read S does the state update run, over the key tiles again.  Each thread
// owns a 4 x 4 (rows i, p) block of the output tile and a 4 x 8 (p, n)
// block of the state, strided by 16 so that neighbouring threads read
// neighbouring banks (rows are padded to an odd stride).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_fwd(Params p) {
  const int P = p.P, N = p.N, Q = p.chunk;
  const int LDN = N | 1, LDP = P | 1;  // odd strides: no bank conflicts
  extern __shared__ double smem[];
  double* cums = smem;               // round_up(Q, TILE)  cumsum of dt * A
  float* Ss = reinterpret_cast<float*>(cums + round_up(Q, TILE));  // P x LDN  the running state
  float* Cs = Ss + P * LDN;          // TILE x LDN   C rows of the query tile
  float* Bs = Cs + TILE * LDN;       // TILE x LDN   B rows of the key tile
  float* Xs = Bs + TILE * LDN;       // TILE x LDP   x * dt rows of the key tile
  float* Gs = Xs + TILE * LDP;       // TILE x LDG   (C B^T . L) of the tile pair
  float* dts = Gs + TILE * LDG;      // round_up(Q, TILE)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, grp = h / p.rep;
  const T* xh = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dth = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* Bh = static_cast<const T*>(p.B) + b * p.B_sb + grp * p.B_sg;
  const T* Ch = static_cast<const T*>(p.C) + b * p.C_sb + grp * p.C_sg;
  T* yh = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;
  const float A = p.A[h * p.A_s];

  for (int idx = tid; idx < P * LDN; idx += NT) Ss[idx] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += Q) {
    const T* x = xh + c0 * p.x_ss;
    const T* Bc = Bh + c0 * p.B_ss;
    const T* Cc = Ch + c0 * p.C_ss;
    T* y = yh + c0 * p.y_ss;

    __syncthreads();  // the previous chunk is done with dts, cums and Ss
    for (int i = tid; i < round_up(Q, TILE); i += NT) {
      dts[i] = i < Q ? dth[(c0 + i) * p.dt_ss] : 0.f;
      cums[i] = 0.0;
    }
    __syncthreads();
    if (tid < 32) scan_cums(dts, A, cums, Q, tid);
    __syncthreads();
    const double total = cums[Q - 1];

    // ---- y, one query tile of 64 rows at a time (S is the old state)
    for (int i0 = 0; i0 < Q; i0 += TILE) {
      __syncthreads();  // the previous tile is done with Cs, Bs, Xs and Gs
      load_rows(Cs, LDN, Cc, p.C_ss, p.C_sn, i0, Q, N, tid);
      __syncthreads();

      // inter-chunk: acc[a][c] = exp(cums_i) * sum_n C[i,n] S[p,n]
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = tx + 16 * c < P ? Ss[(tx + 16 * c) * LDN + n] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] += cv[a] * sv[c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float e = i < Q ? expf(static_cast<float>(cums[i])) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] *= e;
      }

      // intra-chunk: key tiles at or below the query tile
      for (int j0 = 0; j0 <= i0; j0 += TILE) {
        __syncthreads();  // Bs, Xs, Gs free
        load_rows(Bs, LDN, Bc, p.B_ss, p.B_sn, j0, Q, N, tid);
        load_xdt(Xs, LDP, x, p, dts, cums, false, 0.0, j0, Q, tid);
        __syncthreads();

        float g[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[a][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * LDN + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * LDN + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[a][c] += cv[a] * bv[c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + ty + 16 * a, j = j0 + tx + 16 * c;
            float v = 0.f;
            if (i < Q && j <= i) v = g[a][c] * expf(static_cast<float>(cums[i] - cums[j]));  // mask, then exp
            Gs[(ty + 16 * a) * LDG + tx + 16 * c] = v;
          }
        __syncthreads();

        for (int jj = 0; jj < TILE; ++jj) {
          float gv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) gv[a] = Gs[(ty + 16 * a) * LDG + jj];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = tx + 16 * c < P ? Xs[jj * LDP + tx + 16 * c] : 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] += gv[a] * xv[c];
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (tx + 16 * c < P) store(y + i * p.y_ss + tx + 16 * c, acc[a][c]);
      }
    }

    // ---- state update, after every query tile has read the old S
    __syncthreads();
    const float et = expf(static_cast<float>(total));
    float sacc[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int pp = ty + 16 * a, n = tx + 16 * c;
        sacc[a][c] = pp < P && n < N ? et * Ss[pp * LDN + n] : 0.f;
      }
    for (int j0 = 0; j0 < Q; j0 += TILE) {
      __syncthreads();  // Bs, Xs free
      load_rows(Bs, LDN, Bc, p.B_ss, p.B_sn, j0, Q, N, tid);
      load_xdt(Xs, LDP, x, p, dts, cums, true, total, j0, Q, tid);
      __syncthreads();
      for (int r = 0; r < TILE; ++r) {
        float xv[4], bv[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = ty + 16 * a < P ? Xs[r * LDP + ty + 16 * a] : 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = tx + 16 * c < N ? Bs[r * LDN + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 8; ++c) sacc[a][c] += xv[a] * bv[c];
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int pp = ty + 16 * a, n = tx + 16 * c;
        if (pp < P && n < N) Ss[pp * LDN + n] = sacc[a][c];  // only this thread touches it
      }
  }

  __syncthreads();
  float* st = p.state + static_cast<long long>(bh) * P * N;
  for (int idx = tid; idx < P * N; idx += NT) st[idx] = Ss[(idx / N) * LDN + idx % N];
}

// ------------------------------------------------ wgmma route (bf16, P 64)

using bf16 = __nv_bfloat16;
constexpr int WG = 128;                  // one warpgroup a block
constexpr int TILE_W = TILE * 256;       // bytes of a swizzled 64 x 128 bf16 tile (two column blocks)
constexpr int TILE_X = TILE * 128;       // bytes of a swizzled 64 x 64 one
constexpr int COLS = TILE * 128;         // bytes between the column blocks of a 64-row tile

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

// a, b as hi + lo bf16 pairs: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(hv);
  hi = *reinterpret_cast<const uint32_t*>(&hv);
  lo = hopper::pack_bf16x2(a - hf.x, b - hf.y);
}

// dt of rows [0, rows) of the chunk into dts, and their cums; every thread
// of the block calls it.
__device__ __forceinline__ void chunk_cums(const float* dth, long long dt_ss, int rows, float A,
                                           float* dts, double* cums, int tid) {
  for (int i = tid; i < rows; i += WG) dts[i] = dth[i * dt_ss];
  __syncthreads();
  if (tid < 32) scan_cums(dts, A, cums, rows, tid);
  __syncthreads();
}

// U_c = (x w)^T B over the chunk, w_j = dt_j exp(total - cums_j), and
// exp(total); the chunk's cums and dt go to scratch for ssd_chunk_out.  B
// (MN-major, n along the row) and x arrive with cp.async one tile ahead;
// (x w) goes in as hi + lo bf16 tiles written by the threads (the A
// operand, read MN-major: p along the row).  Columns of U at or past N are
// computed from stale shared memory and dropped.
__global__ void __launch_bounds__(WG) ssd_chunk_state(Params p) {
  using namespace hopper;
  constexpr int STAGE = TILE_W + TILE_X;        // B rows, then x rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* st0 = align1024(smem_raw);     // two stages
  unsigned char* Xhi = st0 + 2 * STAGE;         // 64 x 64 (x w) hi
  unsigned char* Xlo = Xhi + TILE_X;            // and lo
  double* cums = reinterpret_cast<double*>(Xlo + TILE_X);
  float* w = reinterpret_cast<float*>(cums + p.chunk);  // dt, then w

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int c = blockIdx.x % p.nc, bh = blockIdx.x / p.nc;
  const int b = bh / p.H, h = bh % p.H, grp = h / p.rep;
  const int Q = p.chunk, nt = Q / TILE, c0 = c * Q;
  const bf16* x = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + c0 * p.x_ss;
  const bf16* Bc = static_cast<const bf16*>(p.B) + b * p.B_sb + grp * p.B_sg + c0 * p.B_ss;

  copy_rows(st0, Bc, p.B_ss, p.N, tid);
  copy_rows(st0 + TILE_W, x, p.x_ss, TILE, tid);
  cp_async_commit();
  chunk_cums(p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss, p.dt_ss, Q, p.A[h * p.A_s], w,
             cums, tid);
  const double total = cums[Q - 1];
  double* cums_out = p.cums + static_cast<long long>(bh) * p.S + c0;
  float* dt_out = p.dts + static_cast<long long>(bh) * p.S + c0;
  for (int i = tid; i < Q; i += WG) {
    cums_out[i] = cums[i];
    dt_out[i] = w[i];
    w[i] *= expf(static_cast<float>(total - cums[i]));
  }

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  const uint32_t hi_addr = smem_u32(Xhi), lo_addr = smem_u32(Xlo);
  for (int t = 0; t < nt; ++t) {
    unsigned char* cur = st0 + (t & 1) * STAGE;
    if (t + 1 < nt) {
      unsigned char* nxt = st0 + ((t + 1) & 1) * STAGE;
      copy_rows(nxt, Bc + (t + 1) * TILE * p.B_ss, p.B_ss, p.N, tid);
      copy_rows(nxt + TILE_W, x + (t + 1) * TILE * p.x_ss, p.x_ss, TILE, tid);
    }
    cp_async_commit();  // empty on the last tile
    cp_async_wait_group<1>();  // this tile's B and x have landed ...
    __syncthreads();           // ... for every thread (and w is written)
    // this tile's x rows times w: 64 rows x 8 chunks of 8 values, 4 a thread
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
      *reinterpret_cast<uint4*>(Xhi + swz(r, ch)) = hi;
      *reinterpret_cast<uint4*>(Xlo + swz(r, ch)) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t b_addr = smem_u32(cur);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {  // 16 chunk rows a step: 2048 bytes
      const uint64_t bd = desc_b128(b_addr + kk * 2048, COLS, 1024);
      wgmma_ss<1, 1>(acc, desc_b128(hi_addr + kk * 2048, COLS, 1024), bd, 1);
      wgmma_ss<1, 1>(acc, desc_b128(lo_addr + kk * 2048, COLS, 1024), bd, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // Xhi, Xlo and this stage are free
  }

  // acc element e: row p = 16 warp + g + 8 ((e >> 1) & 1), column n = 8 (e >> 2) + 2 qd + (e & 1)
  float* U = p.states + (static_cast<long long>(bh) * p.nc + c) * (TILE * p.N);
#pragma unroll
  for (int jb = 0; jb < 16; ++jb) {
    const int n = 8 * jb + 2 * qd;
    if (n >= p.N) continue;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<float2*>(U + (16 * warp + g + 8 * rr) * p.N + n) =
          make_float2(acc[4 * jb + 2 * rr], acc[4 * jb + 2 * rr + 1]);
  }
  if (tid == 0) p.decay[bh * p.nc + c] = expf(static_cast<float>(total));
}

// Per (batch * head), 8 consecutive state elements a thread: walks the
// chunks in order, S_c = exp(total_c) S_{c-1} + U_c, leaving in each
// chunk's slot the state before it as bf16 hi + lo (the 32 bytes of the 8
// fp32 values of U_c become 16 bytes of hi, then 16 of lo), and writes the
// final state in fp32.  The slots are read AHEAD chunks at a time, so their
// loads are in flight together.  grid (batch * H, 64 N / 1024).
__global__ void __launch_bounds__(WG) ssd_carry(Params p) {
  constexpr int AHEAD = 8;
  const int bh = blockIdx.x, PN = TILE * p.N;
  const int e = (blockIdx.y * WG + threadIdx.x) * 8;
  float* slot = p.states + static_cast<long long>(bh) * p.nc * PN + e;
  const float* dec = p.decay + bh * p.nc;
  float s[8] = {};
  for (int c0 = 0; c0 < p.nc; c0 += AHEAD) {
    float4 u[AHEAD][2];
    float d[AHEAD];  // loaded with the slots: a load after a store to the slots waits for it
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < p.nc) {
        const float4* at = reinterpret_cast<const float4*>(slot + static_cast<long long>(c0 + k) * PN);
        u[k][0] = __ldcg(at);
        u[k][1] = __ldcg(at + 1);
        d[k] = __ldcg(dec + c0 + k);
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k) {
      if (c0 + k >= p.nc) break;
      uint4 hl[2];  // hi, lo
      split2(s[0], s[1], hl[0].x, hl[1].x);
      split2(s[2], s[3], hl[0].y, hl[1].y);
      split2(s[4], s[5], hl[0].z, hl[1].z);
      split2(s[6], s[7], hl[0].w, hl[1].w);
      uint4* at = reinterpret_cast<uint4*>(slot + static_cast<long long>(c0 + k) * PN);
      at[0] = hl[0];
      at[1] = hl[1];
      const float* uk = reinterpret_cast<const float*>(u[k]);
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = s[i] * d[k] + uk[i];
    }
  }
  float4* out = reinterpret_cast<float4*>(p.state + static_cast<long long>(bh) * PN + e);
  out[0] = make_float4(s[0], s[1], s[2], s[3]);
  out[1] = make_float4(s[4], s[5], s[6], s[7]);
}

// Columns [64 half, 64 half + 64) of the state before the chunk, left by
// ssd_carry as 8-value groups of 16 bytes of hi then 16 of lo, into two
// swizzled 64 x 64 bf16 tiles with cp.async.
__device__ __forceinline__ void copy_state_half(unsigned char* Shi, unsigned char* Slo,
                                                const float* slot, int N, int half, int tid) {
  const int ch = min(64, N - 64 * half) / 8;
  const uint32_t hi = hopper::smem_u32(Shi), lo = hopper::smem_u32(Slo);
  for (int idx = tid; idx < TILE * ch; idx += WG) {
    const int r = idx / ch, k = idx % ch;
    const float* src = slot + r * N + 64 * half + 8 * k;
    hopper::cp_async16(hi + hopper::swz(r, k), src, 16);
    hopper::cp_async16(lo + hopper::swz(r, k), src + 4, 16);
  }
}

// y of one 64-row query tile of one (batch, head, chunk): o = exp(cums_i)
// C S^T (S the state before the chunk, as hi + lo tiles in two halves of
// 64 columns, in the second stage's space), then per key tile at or below
// the query tile G = C B^T, the score G . L . dt_j split into hi + lo
// registers, o += score x.  cums and dt come from ssd_chunk_state.  One
// block per (batch * H * nc) x (Q / 64) query tiles, a chunk's tiles
// adjacent (they share its state and key tiles in L2), the last (the most
// key tiles) first.
__global__ void __launch_bounds__(WG) ssd_chunk_out(Params p) {
  using namespace hopper;
  constexpr int STAGE = TILE_W + TILE_X;        // B rows, then x rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Cs = align1024(smem_raw);      // 64 x 128 C rows of the query tile
  unsigned char* st0 = Cs + TILE_W;             // two key stages
  unsigned char* Shi = st0 + STAGE;             // S halves: in stage 1 until tile 1 loads
  unsigned char* Slo = Shi + TILE_X;
  double* cums = reinterpret_cast<double*>(st0 + 2 * STAGE);
  float* dts = reinterpret_cast<float*>(cums + p.chunk);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, qd = lane & 3;
  const int nq = p.chunk / TILE, bhc = blockIdx.x / nq;
  const int c = bhc % p.nc, bh = bhc / p.nc;
  const int qt = nq - 1 - blockIdx.x % nq;
  const int b = bh / p.H, h = bh % p.H, grp = h / p.rep;
  const int N = p.N, c0 = c * p.chunk, rows = (qt + 1) * TILE;
  const bf16* x = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh + c0 * p.x_ss;
  const bf16* Bc = static_cast<const bf16*>(p.B) + b * p.B_sb + grp * p.B_sg + c0 * p.B_ss;
  const bf16* Cc = static_cast<const bf16*>(p.C) + b * p.C_sb + grp * p.C_sg + c0 * p.C_ss;
  const float* slot = p.states + (static_cast<long long>(bh) * p.nc + c) * (TILE * N);

  copy_rows(Cs, Cc + qt * TILE * p.C_ss, p.C_ss, N, tid);
  copy_rows(st0, Bc, p.B_ss, N, tid);
  copy_rows(st0 + TILE_W, x, p.x_ss, TILE, tid);
  {  // the chunk's cums (2 a copy) and dt (4 a copy) of the rows this tile sees
    const double* cg = p.cums + static_cast<long long>(bh) * p.S + c0;
    const float* dg = p.dts + static_cast<long long>(bh) * p.S + c0;
    for (int i = tid; i < rows / 2; i += WG) cp_async16(smem_u32(cums + 2 * i), cg + 2 * i, 16);
    for (int i = tid; i < rows / 4; i += WG) cp_async16(smem_u32(dts + 4 * i), dg + 4 * i, 16);
  }
  if (c > 0) copy_state_half(Shi, Slo, slot, N, 0, tid);
  cp_async_commit();
  cp_async_wait_group<0>();
  fence_proxy_async();
  __syncthreads();

  // this thread's rows of the tile (within the chunk) and their cums
  const int i_row[2] = {qt * TILE + 16 * warp + g, qt * TILE + 16 * warp + g + 8};
  const double ci[2] = {cums[i_row[0]], cums[i_row[1]]};
  const uint32_t c_addr = smem_u32(Cs);
  float o[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) o[e] = 0.f;

  if (c > 0) {  // S = 0 before the first chunk
    const uint32_t shi = smem_u32(Shi), slo = smem_u32(Slo);
    for (int half = 0; 64 * half < N; ++half) {
      if (half > 0) {
        copy_state_half(Shi, Slo, slot, N, half, tid);
        cp_async_commit();
        cp_async_wait_group<0>();
        fence_proxy_async();
        __syncthreads();
      }
      wgmma_fence();
      for (int ks = 0; ks < min(64, N - 64 * half) / 16; ++ks) {  // C (K-major) x S^T (K-major)
        const uint64_t a = desc_b128(c_addr + half * COLS + ks * 32, 16, 1024);
        wgmma_ss<0, 0>(o, a, desc_b128(shi + ks * 32, 16, 1024), 1);
        wgmma_ss<0, 0>(o, a, desc_b128(slo + ks * 32, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncthreads();  // the S tiles are free
    }
    float ec[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) ec[rr] = exp2_approx(static_cast<float>(ci[rr]) * LOG2E);
#pragma unroll
    for (int e = 0; e < 32; ++e) o[e] *= ec[(e >> 1) & 1];
  }

  for (int t = 0; t <= qt; ++t) {
    if (t > 0) {  // tile t has landed, and every thread is done with tile t - 1
      cp_async_wait_group<0>();
      fence_proxy_async();
      __syncthreads();
    }
    if (t < qt) {
      unsigned char* nxt = st0 + ((t + 1) & 1) * STAGE;
      copy_rows(nxt, Bc + (t + 1) * TILE * p.B_ss, p.B_ss, N, tid);
      copy_rows(nxt + TILE_W, x + (t + 1) * TILE * p.x_ss, p.x_ss, TILE, tid);
      cp_async_commit();
    }
    const uint32_t b_addr = smem_u32(st0 + (t & 1) * STAGE), x_addr = b_addr + TILE_W;

    float gs[32];
    wgmma_fence();
    for (int ks = 0; ks < N / 16; ++ks)
      wgmma_ss<0, 0>(gs, desc_b128(c_addr + (ks >> 2) * COLS + (ks & 3) * 32, 16, 1024),
                     desc_b128(b_addr + (ks >> 2) * COLS + (ks & 3) * 32, 16, 1024), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gs);

    // element e: row i_row[(e >> 1) & 1], key j = 64 t + 8 (e >> 2) + 2 qd + (e & 1)
    uint32_t ph[4][4], pl[4][4];
    const bool diag = t == qt;
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int rr = (e >> 1) & 1, j = TILE * t + 8 * (e >> 2) + 2 * qd;
      float v0 = gs[e] * dts[j] * exp2_approx(static_cast<float>(ci[rr] - cums[j]) * LOG2E);
      float v1 = gs[e + 1] * dts[j + 1] *
                 exp2_approx(static_cast<float>(ci[rr] - cums[j + 1]) * LOG2E);
      if (diag) {  // a select: above the diagonal the exp may be inf
        if (j > i_row[rr]) v0 = 0.f;
        if (j + 1 > i_row[rr]) v1 = 0.f;
      }
      split2(v0, v1, ph[e >> 3][(e >> 1) & 3], pl[e >> 3][(e >> 1) & 3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {  // x read MN-major: 16 key rows a step
      const uint64_t xd = desc_b128(x_addr + kk * 2048, COLS, 1024);
      wgmma_rs<1>(o, ph[kk], xd, 1);
      wgmma_rs<1>(o, pl[kk], xd, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

  bf16* y = static_cast<bf16*>(p.y) + b * p.y_sb + h * p.y_sh + c0 * p.y_ss;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    bf16* row = y + i_row[rr] * p.y_ss + 2 * qd;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * jb) =
          __floats2bfloat162_rn(o[4 * jb + 2 * rr], o[4 * jb + 2 * rr + 1]);
  }
}

// ---------------------------------------------------------------- launch

template <typename T>
cudaError_t launch_fma(const Params& p, int blocks, cudaStream_t stream) {
  const int LDN = p.N | 1, LDP = p.P | 1, QP = round_up(p.chunk, TILE);
  const int floats = p.P * LDN + 2 * TILE * LDN + TILE * LDP + TILE * LDG + QP;
  const int smem = QP * static_cast<int>(sizeof(double)) + floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_fwd<T><<<blocks, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const Params& p, int bh, cudaStream_t stream) {
  const int Q = p.chunk, rows = 12 * Q;  // cums (double) and dt / w (float) per chunk row
  const int smem_state = 1024 + 2 * (TILE_W + TILE_X) + 2 * TILE_X + rows;
  const int smem_out = 1024 + TILE_W + 2 * (TILE_W + TILE_X) + rows;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_state);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_out);
  if (err != cudaSuccess) return err;
  ssd_chunk_state<<<bh * p.nc, WG, smem_state, stream>>>(p);
  ssd_carry<<<dim3(bh, TILE * p.N / (8 * WG)), WG, 0, stream>>>(p);
  ssd_chunk_out<<<bh * p.nc * (Q / TILE), WG, smem_out, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr, long long s0, long long s1, long long s2, long long s3) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 8 == 0 && s1 % 8 == 0 &&
         s2 % 8 == 0 && s3 == 1;
}

}  // namespace

// route: 0 = fma, 1 = wgmma (bf16 x/B/C, P 64, N % 16 == 0, chunk % 64 ==
// 0, 16-byte-aligned rows with a contiguous last dim; scratch then points
// at batch * H * ((S / chunk) * (P * N + 1) + 3 S) floats, 16-byte aligned).
// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt, A and the state
// are float32.  Strides are in elements; y and the state are contiguous.
// Returns 0 on success.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    void* y, void* state, void* scratch, int route, int dtype,
    int batch, int S, int H, int P, int G, int N, int chunk,
    long long x_sb, long long x_ss, long long x_sh, long long x_sp,
    long long dt_sb, long long dt_ss, long long dt_sh, long long A_s,
    long long B_sb, long long B_ss, long long B_sg, long long B_sn,
    long long C_sb, long long C_ss, long long C_sg, long long C_sn,
    long long y_sb, long long y_ss, long long y_sh, void* stream) {
  if (P < 1 || P > MAX_P || N < 1 || N > MAX_N || chunk < 1 || chunk > MAX_CHUNK ||
      G < 1 || H % G != 0 || S % chunk != 0)
    return -1;
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt); p.A = static_cast<const float*>(A);
  p.B = B; p.C = C; p.y = y; p.state = static_cast<float*>(state);
  p.S = S; p.H = H; p.P = P; p.N = N; p.rep = H / G; p.chunk = chunk; p.nc = S / chunk;
  const long long bhs = static_cast<long long>(batch) * H;
  p.states = static_cast<float*>(scratch);
  p.cums = reinterpret_cast<double*>(p.states + bhs * p.nc * P * N);
  p.dts = reinterpret_cast<float*>(p.cums + bhs * S);
  p.decay = p.dts + bhs * S;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh; p.x_sp = x_sp;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh; p.A_s = A_s;
  p.B_sb = B_sb; p.B_ss = B_ss; p.B_sg = B_sg; p.B_sn = B_sn;
  p.C_sb = C_sb; p.C_ss = C_ss; p.C_sg = C_sg; p.C_sn = C_sn;
  p.y_sb = y_sb; p.y_ss = y_ss; p.y_sh = y_sh;
  const int blocks = batch * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1) {
    if (dtype != 1 || P != 64 || N % 16 != 0 || chunk % TILE != 0 || S == 0 ||
        scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
        !aligned16(x, x_sb, x_ss, x_sh, x_sp) ||
        !aligned16(B, B_sb, B_ss, B_sg, B_sn) || !aligned16(C, C_sb, C_ss, C_sg, C_sn) ||
        y_ss % 2 != 0)
      return -1;
    err = launch_wgmma(p, blocks, st);
  } else if (route != 0) {
    return -1;
  } else if (dtype == 0) {
    err = launch_fma<float>(p, blocks, st);
  } else if (dtype == 1) {
    err = launch_fma<__nv_bfloat16>(p, blocks, st);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}
