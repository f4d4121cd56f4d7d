// 16-byte vector loads and stores for the row kernels (K1 in layer_norm.cu,
// B8's forward in softmax.cu).
//
// A vector is 16 bytes of one element type T: 8 bf16 or fp16 values, or 4
// fp32.  `load_vec` brings one into registers as fp32 (bf16 -> fp32 is a
// shift, exact), `store_vec` rounds N fp32 values once to T and writes them
// with one 16-byte store.  The caller guarantees the 16-byte alignment.
#pragma once

#include <cstdint>

#include "common.cuh"

// The 32-bit words of one vector of N values of type T, loaded with 16-byte
// (or 8-byte) loads; and the values of a word.
template <typename T, int N>
struct Words {
  static constexpr int W = (int)sizeof(T) * N / 4;
  uint32_t w[W];
};

template <typename T, int N>
__device__ __forceinline__ Words<T, N> load_words(const T* __restrict__ p) {
  Words<T, N> v;
  if constexpr (Words<T, N>::W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < Words<T, N>::W / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      v.w[4 * i] = u.x; v.w[4 * i + 1] = u.y; v.w[4 * i + 2] = u.z; v.w[4 * i + 3] = u.w;
    }
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    v.w[0] = u.x; v.w[1] = u.y;
  }
  return v;
}

__device__ __forceinline__ void unpack(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out, __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);            // bf16 -> fp32 is a shift: exact
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack(uint32_t w, float* out, __half) {
  out[0] = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  out[1] = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// N values of type T at p (16-byte aligned) into out as fp32.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  const Words<T, N> v = load_words<T, N>(p);
  constexpr int PER = 4 / (int)sizeof(T);
#pragma unroll
  for (int i = 0; i < Words<T, N>::W; ++i) unpack(v.w[i], out + PER * i, T());
}

__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// N fp32 values into one 16-byte store of type T at p.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1], T()), pack2(v[2], v[3], T()),
                                              pack2(v[4], v[5], T()), pack2(v[6], v[7], T()));
  }
}

// True when p is null or 16-byte aligned.
__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
