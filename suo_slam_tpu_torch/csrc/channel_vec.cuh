// Shared by the per-channel reductions over NHWC activations: K16 / K17
// (`bn_train.cu`) and K20 / K21 (`group_norm.cu`). A thread owns one 16-byte
// vector of channels (4 f32 or 8 bf16; one value where C or the pointers do
// not allow it) and, in a partial pass, walks kIters pixels of its block's
// span with f64 accumulators.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kIters = 16;  // pixels each thread walks in a partial pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V values of T as one load / store (16 bytes when V * sizeof(T) == 16)
template <typename T, int V>
struct alignas(V * sizeof(T) >= 16 ? 16 : alignof(T)) Vec { T v[V]; };
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    return *reinterpret_cast<const Vec<T, V>*>(&u);
  } else {
    Vec<T, V> r;
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = p[k];
    return r;
  }
}
template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& r) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = r.v[k];
  }
}

// a partial pass's thread layout for C channels in vectors of V
struct Layout {
  int cv, lanes_c, lanes_p;  // vectors per pixel, channel-vector lanes, pixel lanes
  __host__ __device__ Layout(int C, int V) {
    cv = C / V;
    lanes_c = cv < kThreads ? cv : kThreads;
    lanes_p = kThreads / lanes_c;
  }
  __host__ __device__ long long pixels_per_block() const {
    return (long long)lanes_p * kIters;
  }
};

// blocks of an element-wise pass over n items (a grid-stride loop beyond)
inline long long grid_of(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return b > 65535LL * 8 ? 65535LL * 8 : b;
}

// 16-byte vectors when C and every pointer allow them, else one value
template <typename T>
bool vectorizable(int C, std::initializer_list<const void*> ptrs) {
  constexpr int V = 16 / sizeof(T);
  if (C % V) return false;
  for (const void* p : ptrs)
    if (p != nullptr && (uintptr_t)p % 16) return false;
  return true;
}

}  // namespace
