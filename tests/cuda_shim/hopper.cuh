// CPU emulation of src/repro_torch/csrc/hopper.cuh: the same names.
// Shared addresses are offsets into the shim's buffer, so the 128-byte
// swizzle sees real address bits; cp.async is an immediate copy with zero
// fill; wgmma is computed per thread for the accumulator elements it owns,
// reading A and B through their descriptors (start, LBO, SBO, B128
// swizzle; K-major or MN-major), and wgmma_rs first gathers the
// warpgroup's A fragments (mma.sync's m16n8k16 A layout per warp) through
// a buffer between two warpgroup barriers; wgmma_wait is a warpgroup
// barrier, since the emulated product reads shared memory synchronously.
// An mbarrier is a 64-bit word updated atomically: pending arrivals (bits
// 0-30), the expected count (31-61) and the phase's parity (63), flipped
// when the last arrival comes; a wait for parity P spins while the phase
// bit is still P.  cp.async copies at once, so its arrival is a plain
// arrive; setmaxnreg does nothing; bar.sync id, n is a std::barrier(n)
// made at first use in the block.  copy_tile is not here: emulate.py
// takes it from the real header.
#pragma once
#include <atomic>
#include "cuda_shim.h"

namespace hopper {
inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) - shim::buffer);
}
constexpr float LOG2E = 1.4426950408889634f;
inline uint32_t swz(int r, int c) { return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4)); }
inline unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}
inline void cp_async16(uint32_t dst, const void* src, int bytes) {
  memset(shim::buffer + dst, 0, 16);
  memcpy(shim::buffer + dst, src, bytes);
}
inline void cp_async4(uint32_t dst, const void* src, int bytes) {
  memset(shim::buffer + dst, 0, 4);
  memcpy(shim::buffer + dst, src, bytes);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}

inline void mbar_init(uint64_t* bar, int count) {
  std::atomic_ref<uint64_t>(*bar).store(uint64_t(count) | (uint64_t(count) << 31));
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) {
  std::atomic_ref<uint64_t> word(*bar);
  uint64_t old = word.load(), next;
  do {
    const uint64_t pending = old & 0x7fffffff, expected = (old >> 31) & 0x7fffffff;
    if (pending == 0) { fprintf(stderr, "shim: arrival on a completed mbarrier\n"); abort(); }
    next = pending > 1 ? old - 1 : (expected | (expected << 31) | ((~old) & (1ull << 63)));
  } while (!word.compare_exchange_weak(old, next));
}
inline void mbar_wait(uint64_t* bar, int parity) {
  std::atomic_ref<uint64_t> word(*bar);
  while (int(word.load() >> 63) == parity) std::this_thread::yield();
}
inline void cp_async_arrive(uint64_t* bar) { mbar_arrive(bar); }

template <int N> inline void setmaxnreg_inc() {}
template <int N> inline void setmaxnreg_dec() {}
inline void named_bar_sync(int id, int threads) {
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(shim::mu);
    auto& slot = shim::named_bar[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(threads);
    bar = slot.get();
  }
  bar->arrive_and_wait();
}
template <int N> inline void cp_async_wait_group() {}
inline void fence_proxy_async() {}
inline uint64_t desc_b128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() { shim::wg_sync(); }
template <int R> inline void fence_regs(float (&)[R]) {}
inline float exp2_approx(float x) { float y = exp2f(x); return std::fabs(y) < 1.17549435e-38f ? 0.f : y; }
inline uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u; memcpy(&u, &v, 4); return u;
}
inline void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(hv);
  memcpy(&hi, &hv, 4);
  lo = pack_bf16x2(a - hf.x, b - hf.y);
}

// element (mn, k) of a B128-swizzled operand
inline float desc_elem(uint64_t d, int mn, int k, int trans) {
  const uint32_t start = (d & 0x3FFF) << 4, lbo = ((d >> 16) & 0x3FFF) << 4, sbo = ((d >> 32) & 0x3FFF) << 4;
  if (((d >> 62) & 3) != 1) { fprintf(stderr, "shim: not a B128 descriptor\n"); abort(); }
  uint32_t a = trans ? start + (mn / 64) * lbo + (k / 8) * sbo + (k % 8) * 128 + 2 * (mn % 64)
                     : start + (mn / 8) * sbo + (mn % 8) * 128 + 2 * k;
  a ^= ((a >> 7) & 7) << 4;
  if (a + 2 > 256 * 1024) { fprintf(stderr, "shim: descriptor read out of range\n"); abort(); }
  __nv_bfloat16 b; memcpy(&b, shim::buffer + a, 2);
  return __bfloat162float(b);
}

template <int R> inline void wgmma_core(float (&d)[R], int ta, uint64_t a, int tb, uint64_t b, int scale_d, bool regs) {
  const int t = shim::tid() % 128, warp = t / 32, lane = t % 32, wg = shim::tid() / 128;
  for (int e = 0; e < R; ++e) {
    const int row = 16 * warp + lane / 4 + 8 * ((e >> 1) & 1), col = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
    float s = scale_d ? d[e] : 0.f;
    for (int k = 0; k < 16; ++k) {
      const float av = regs ? shim::wg_a[wg][row][k] : desc_elem(a, row, k, ta);
      s += av * desc_elem(b, col, k, tb);
    }
    d[e] = s;
  }
}
template <int TA, int TB, int R> inline void wgmma_ss(float (&d)[R], uint64_t a, uint64_t b, int scale_d) {
  wgmma_core(d, TA, a, TB, b, scale_d, false);
}
template <int TB, int R> inline void wgmma_rs(float (&d)[R], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  const int t = shim::tid() % 128, warp = t / 32, lane = t % 32, wg = shim::tid() / 128;
  const int g = lane / 4, q = lane % 4;
  auto put = [&](int r, int c, uint32_t v) {
    __nv_bfloat162 p; memcpy(&p, &v, 4);
    shim::wg_a[wg][16 * warp + r][c] = __bfloat162float(p.x);
    shim::wg_a[wg][16 * warp + r][c + 1] = __bfloat162float(p.y);
  };
  put(g, 2 * q, a[0]); put(g + 8, 2 * q, a[1]); put(g, 2 * q + 8, a[2]); put(g + 8, 2 * q + 8, a[3]);
  shim::wg_sync();
  wgmma_core(d, 0, 0, TB, b, scale_d, true);
  shim::wg_sync();
}
}  // namespace hopper
