// 16-byte vectors of fp32, bf16, fp16 or int8 elements, unpacked to (and,
// for the float types, packed from) fp32 registers by bit arithmetic (no
// type punning through pointers).
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the high half of an fp32
  static __device__ __forceinline__ void unpack2(unsigned w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  // round to nearest even, as __float2bfloat16 does
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

template <> struct Vec16<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack2(unsigned w, float* f) {
    f[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
    f[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  // round to nearest even, as __float2half does
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    return (unsigned)__half_as_ushort(__float2half(lo)) |
           ((unsigned)__half_as_ushort(__float2half(hi)) << 16);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

// int8 storage (a quantized KV cache): 16 elements, each converted exactly
// to fp32; there is no pack, nothing is written back as int8
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  // the four signed bytes of w, low byte first
  static __device__ __forceinline__ void unpack4(unsigned w, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = (float)(int)(signed char)((w >> (8 * i)) & 0xffu);
  }
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    unpack4(u.x, f);
    unpack4(u.y, f + 4);
    unpack4(u.z, f + 8);
    unpack4(u.w, f + 12);
  }
};
