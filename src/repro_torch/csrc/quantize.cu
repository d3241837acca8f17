// Symmetric int8 group quantization for Hopper (sm_90a).
//
// Replaces src/repro/kernels/quantize.py::quantize_pallas (the Pallas TPU
// kernel K2).  Along the contiguous last axis, in groups of `group` values:
//   scale = amax / 127 (1.0 when amax == 0),   amax = max |x| over the group
//   q     = clip(round_half_even(x / scale), -127, 127)      (int8)
// with x widened to fp32 first (f32 or bf16 input).  The division is IEEE
// (this file is built without --use_fast_math) and rintf rounds half to
// even, so q and the scales equal the plain version bit for bit.
//
// Design.  One warp per group, 8 warps per block.  Each lane reads its
// values with vector loads (16 bytes of f32, 8 of bf16) when the group is
// a multiple of 4 values and the base is aligned, scalar loads otherwise;
// the group's amax is a butterfly of shuffles; then the lanes read the same
// values again (the group is 1 KB at group 256, still in L1) and write q,
// and lane 0 writes the scale.
//
// What bounds it.  Memory: each value is read once (4 bytes, or 2) and
// written once as int8, plus 4 bytes of scale per group: 5.02 bytes per f32
// value at group 256.  At the largest gradient leaf of llama3.2-1b (the
// embedding, 128256 x 2048 f32 = 262.67 M values) that is 1.317 GB, ~0.39 ms
// at 3.35 TB/s.  There are ~3 operations per byte: no compute bound.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the caller's
// stream; the function returns cudaGetLastError() after the launch (0 on
// success), or -1 for a dtype it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC values starting at p (aligned to VEC elements) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (VEC == 4 && sizeof(T) == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    out[0] = __low2float(a); out[1] = __high2float(a);
    out[2] = __low2float(b); out[3] = __high2float(b);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_f32(p[e]);
  }
}

__device__ __forceinline__ int8_t quant(float x, float scale) {
  const float r = rintf(x / scale);  // IEEE division, round half to even
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32) quantize_kernel(
    const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
    long long n_groups, int group) {
  const int lane = threadIdx.x & 31;
  const long long gi = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (gi >= n_groups) return;  // whole warps leave together
  const T* xg = x + gi * group;
  int8_t* qg = q + gi * group;

  float amax = 0.f;
  for (int i = lane * VEC; i < group; i += 32 * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xg + i, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.f ? amax / 127.0f : 1.0f;

  for (int i = lane * VEC; i < group; i += 32 * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xg + i, v);
    if constexpr (VEC == 4) {
      char4 o;
      o.x = quant(v[0], scale); o.y = quant(v[1], scale);
      o.z = quant(v[2], scale); o.w = quant(v[3], scale);
      *reinterpret_cast<char4*>(qg + i) = o;
    } else {
      qg[i] = quant(v[0], scale);
    }
  }
  if (lane == 0) scales[gi] = scale;
}

template <typename T>
cudaError_t launch(const void* x, void* q, void* scales, long long n_groups, int group,
                   int vec, cudaStream_t stream) {
  const long long blocks = (n_groups + WARPS - 1) / WARPS;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  if (vec == 4)
    quantize_kernel<T, 4><<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
        xt, qt, st, n_groups, group);
  else
    quantize_kernel<T, 1><<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
        xt, qt, st, n_groups, group);
  return cudaGetLastError();
}

}  // namespace

// x: n_groups * group contiguous values (dtype 0 = float32, 1 = bfloat16);
// q: as many int8; scales: n_groups float32.  vec 4 asks for vector loads:
// the caller guarantees group % 4 == 0 and x aligned to 4 values.  Returns
// 0 on success.
extern "C" int quantize_int8(const void* x, void* q, void* scales, int dtype,
                             long long n_groups, int group, int vec, void* stream) {
  if (n_groups <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = launch<float>(x, q, scales, n_groups, group, vec, st);
  else if (dtype == 1) err = launch<__nv_bfloat16>(x, q, scales, n_groups, group, vec, st);
  else return -1;
  return static_cast<int>(err);
}
