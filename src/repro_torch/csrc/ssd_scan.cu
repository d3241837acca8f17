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
// exp(cums_i - cums_j) near the diagonal as a relative error of that size.
//
// Design.  One block of 256 threads per (batch * head); the block loops over
// the chunks itself, which takes the place of the Pallas kernel's sequential
// ("arbitrary") chunk axis, and keeps S in shared memory across chunks, never
// in device memory.  A chunk is staged in tiles of 64 rows: for each query
// tile, its C rows are loaded once, the inter-chunk term C S^T is computed
// from the old state, then the key tiles at or below it add (C B^T . L)(x dt).
// Only after every query tile has read S does the state update run, over
// the key tiles again.  Each thread owns a 4 x 4 (rows i, p) block of the
// output tile and a 4 x 8 (p, n) block of the state, strided by 16 so that
// neighbouring threads read neighbouring shared-memory banks (rows are padded
// to an odd stride).  x, dt, B and C are read in their (b, s, h, p) /
// (b, s, g, n) layout through the strides the wrapper passes; nothing is
// transposed or cast on the host.  All products are fp32 FMAs on the CUDA
// cores (no TF32).  P <= 64, N <= 128, any chunk length from 1 to 1024.
//
// What bounds it.  At the serving prefill shape (b=4, s=2048, h=48, p=64,
// g=1, n=128, chunk 256, bf16 x/B/C) the scan needs ~19.6 GFLOP (C B^T once
// per group and chunk over the causal triangle, then per head (C B^T . L)
// (x dt), C S^T and the state update) and moves ~113 MB: operations-bound,
// ~0.29 ms at the H100's 67 TFLOP/s fp32 peak against ~0.034 ms of memory
// traffic.  This first version recomputes C B^T for every head, reads its
// operands from shared memory with scalar loads, loads tiles synchronously,
// and runs b * h = 192 blocks, one per SM (1.45 waves on 132 SMs).
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch (0 on
// success), or -1 for a dtype or size it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block: 16 x 16
constexpr int TILE = 64;         // chunk rows staged at a time
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
  int S, H, P, N, rep, chunk;
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
    if (tid < 32) {  // cums = inclusive cumsum of dt * A: 32 lanes, one run each
      const int per = (Q + 31) / 32, beg = tid * per, end = min(Q, beg + per);
      double run = 0.0;
      for (int i = beg; i < end; ++i) {
        run += dts[i] * A;  // the product in fp32, as JAX forms dt * A
        cums[i] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      double excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0;
      for (int i = beg; i < end; ++i) cums[i] += excl;
    }
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

template <typename T>
cudaError_t launch(const Params& p, int blocks, cudaStream_t stream) {
  const int LDN = p.N | 1, LDP = p.P | 1, QP = round_up(p.chunk, TILE);
  const int floats = p.P * LDN + 2 * TILE * LDN + TILE * LDP + TILE * LDG + QP;
  const int smem = QP * static_cast<int>(sizeof(double)) + floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_fwd<T><<<blocks, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt, A and the state
// are float32.  Strides are in elements; y and the state are contiguous.
// Returns 0 on success.
extern "C" int ssd_scan_fwd(
    const void* x, const void* dt, const void* A, const void* B, const void* C,
    void* y, void* state, int dtype,
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
  p.S = S; p.H = H; p.P = P; p.N = N; p.rep = H / G; p.chunk = chunk;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh; p.x_sp = x_sp;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh; p.A_s = A_s;
  p.B_sb = B_sb; p.B_ss = B_ss; p.B_sg = B_sg; p.B_sn = B_sn;
  p.C_sb = C_sb; p.C_ss = C_ss; p.C_sg = C_sg; p.C_sn = C_sn;
  p.y_sb = y_sb; p.y_ss = y_ss; p.y_sh = y_sh;
  const int blocks = batch * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(p, blocks, st);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(p, blocks, st);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}
