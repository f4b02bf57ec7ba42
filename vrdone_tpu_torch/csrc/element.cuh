// The element types of the attention kernels' streams (float or
// __nv_bfloat16) and their conversions, shared by band_attention.cu (K1) and
// masked_attention.cu (K7). A bf16 stream is read into fp32 registers (the
// conversion is exact), every sum is taken in fp32, and only the values the
// Pallas kernels round to the input dtype are rounded here: P before P.V
// (round_to) and the output (from_f32, round to nearest even, as torch's
// .to(torch.bfloat16)).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace element {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to E and widened back.
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<E>(x));
}

// The two bf16 values of a 32-bit word (element 0 in the low half).
__device__ __forceinline__ float lo_f32(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// N = 1, 2 or 4 consecutive elements at p (aligned to N elements) into x.
template <int N>
__device__ __forceinline__ void load(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void load(const bf16* p, float* x) {
  if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    x[0] = lo_f32(t.x);
    x[1] = hi_f32(t.x);
    x[2] = lo_f32(t.y);
    x[3] = hi_f32(t.y);
  } else if constexpr (N == 2) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(p);
    x[0] = lo_f32(t);
    x[1] = hi_f32(t);
  } else {
    x[0] = to_f32(*p);
  }
}

// N = 1, 2 or 4 values of x to consecutive elements at p (aligned to N
// elements), rounded to the element type.
template <int N>
__device__ __forceinline__ void store(float* p, const float* x) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

template <int N>
__device__ __forceinline__ void store(bf16* p, const float* x) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(x[0], x[1]),
                                              pack2(x[2], x[3]));
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint32_t*>(p) = pack2(x[0], x[1]);
  } else {
    *p = from_f32<bf16>(x[0]);
  }
}

}  // namespace element
