// CPU emulation of the CUDA runtime and device pieces that
// src/repro_torch/csrc/ssd_scan.cu uses, so that g++ can build and run the
// kernel on CPU tensors (tests/test_torch_ssd_shim.py rewrites the source
// for it: includes, `extern __shared__`, `<<<...>>>` launches).  One
// std::thread per CUDA thread, the blocks of a grid one after another,
// std::barrier for __syncthreads and for shuffles, the dynamic shared memory
// in one 1024-aligned 256 KiB buffer filled with 0xFF (NaN in bf16 and fp32)
// before each block, so a read of a tile nobody wrote shows.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int smem) {
  if (smem > 232448) { fprintf(stderr, "smem %d too large\n", smem); return 1; }
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
using std::min; using std::max;

struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = uint32_t(b.v) << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)}; }
inline float2 __bfloat1622float2(__nv_bfloat162 v) { return {__bfloat162float(v.x), __bfloat162float(v.y)}; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;

namespace shim {
inline unsigned char* buffer = nullptr;   // 1024-aligned base of shared memory
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bar, wg_bar;
inline double warp_buf[64][32];
inline float wg_a[8][64][16];             // wgmma_rs A gather, per warpgroup
inline int tid() { return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z); }
inline void wg_sync() { wg_bar[tid() / 128]->arrive_and_wait(); }
}
inline unsigned char* shim_smem() { return shim::buffer + 16; }
inline void __syncthreads() { shim::block_bar->arrive_and_wait(); }

template <class T> T __shfl_up_sync(unsigned, T v, int off) {
  const int t = shim::tid(), w = t / 32, l = t % 32;
  static_assert(sizeof(T) <= 8);
  memcpy(&shim::warp_buf[w][l], &v, sizeof(T));
  shim::warp_bar[w]->arrive_and_wait();
  T r = v;
  if (l >= off) memcpy(&r, &shim::warp_buf[w][l - off], sizeof(T));
  shim::warp_bar[w]->arrive_and_wait();
  return r;
}

template <class F> void shim_launch(dim3 grid, dim3 block, int smem, cudaStream_t, F fn) {
  static std::vector<unsigned char> raw(256 * 1024 + 2048);
  shim::buffer = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw.data()) + 1023) & ~uintptr_t(1023));
  if (smem + 16 > 256 * 1024) { fprintf(stderr, "shim: smem %d\n", smem); abort(); }
  gridDim = grid; blockDim = block;
  const int n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        memset(shim::buffer, 0xFF, 256 * 1024);   // garbage: NaN in bf16 and fp32
        shim::block_bar = std::make_unique<std::barrier<>>(n);
        shim::warp_bar.clear(); shim::wg_bar.clear();
        for (int w = 0; w < (n + 31) / 32; ++w) shim::warp_bar.push_back(std::make_unique<std::barrier<>>(32));
        for (int w = 0; w < (n + 127) / 128; ++w) shim::wg_bar.push_back(std::make_unique<std::barrier<>>(128));
        std::vector<std::thread> ts;
        for (int t = 0; t < n; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            fn();
          });
        for (auto& th : ts) th.join();
      }
}
template <class T> inline T __ldcg(const T* p) { return *p; }
