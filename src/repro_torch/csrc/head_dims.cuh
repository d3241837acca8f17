// Head dims of the attention kernels (flash_attention.cu and its backward).
//
// Each kernel is compiled for a pair of widths: D for q and k, one of
// {16, 32, 64, 96, 128}, and DV for v and o, one of {16, 32, 64, 128}.  A
// head dim that is not one of them runs on the next width up: the kernels
// zero-fill the extra columns of their tiles (zero columns add nothing to
// q.k, and give output columns that are never stored) and store only the
// real ones, reading every operand through its strides, so nothing is
// padded or copied on the host.  Above 128 the entry points return -1.
#pragma once

namespace head_dims {

// The width a head dim of q/k (d) or of v (dv) runs at, or -1 past 128.
inline int width_qk(int d) {
  return d < 1 ? -1 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128 : -1;
}
inline int width_v(int dv) {
  return dv < 1 ? -1 : dv <= 16 ? 16 : dv <= 32 ? 32 : dv <= 64 ? 64 : dv <= 128 ? 128 : -1;
}

template <int D, typename F>
int with_v(int dv, const F& f) {
  switch (width_v(dv)) {
    case 16: return static_cast<int>(f.template run<D, 16>());
    case 32: return static_cast<int>(f.template run<D, 32>());
    case 64: return static_cast<int>(f.template run<D, 64>());
    case 128: return static_cast<int>(f.template run<D, 128>());
    default: return -1;
  }
}

// f.run<D, DV>() at the widths of (d, dv), as an int (a cudaError_t), or -1
// when either is out of range.
template <typename F>
int with_widths(int d, int dv, const F& f) {
  switch (width_qk(d)) {
    case 16: return with_v<16>(dv, f);
    case 32: return with_v<32>(dv, f);
    case 64: return with_v<64>(dv, f);
    case 96: return with_v<96>(dv, f);
    case 128: return with_v<128>(dv, f);
    default: return -1;
  }
}

}  // namespace head_dims
