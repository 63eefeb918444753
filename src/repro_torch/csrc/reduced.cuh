// Storage and compute types of the kernels' instances, shared by the
// sources that have fp32 and bf16 instances beside their fp64 one.
//
// An instance is named by its storage type S; it computes in Acc<S>:
// fp64 in fp64, fp32 in fp32, bf16 in fp32 (as the TPU kernels' bf16 paths
// compute in their fp32 accumulator). ``rnd<S>`` rounds a compute-type
// value to S's precision and back (round to nearest even,
// __float2bfloat16_rn), which is what a store to S and a reload do; for
// fp64 and fp32 it is the identity, so their instances run the arithmetic
// of the compute type untouched.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

template <typename S>
struct Acc {
  using type = S;
};
template <>
struct Acc<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename S>
__device__ __forceinline__ S from_acc(typename Acc<S>::type x) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

template <typename S>
__device__ __forceinline__ typename Acc<S>::type rnd(
    typename Acc<S>::type x) {
  return to_acc(from_acc<S>(x));
}

// streaming and read-only loads, converted to the compute type (bf16 goes
// through its 16-bit pattern: the cache-hinted loads take integer types)
template <typename S>
__device__ __forceinline__ typename Acc<S>::type load_cs(const S* p) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldcs((const unsigned short*)p)));
  } else {
    return __ldcs(p);
  }
}

template <typename S>
__device__ __forceinline__ typename Acc<S>::type load_ro(const S* p) {
  if constexpr (std::is_same_v<S, __nv_bfloat16>) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg((const unsigned short*)p)));
  } else {
    return __ldg(p);
  }
}

// a fused multiply-add and a product rounded once each, in either type
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
