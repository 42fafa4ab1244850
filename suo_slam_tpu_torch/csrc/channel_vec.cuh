// Shared by the per-channel reductions over NHWC activations: K16 / K17
// (`bn_train.cu`) and K20 / K21 (`group_norm.cu`). A thread owns one 16-byte
// vector of channels (4 f32 or 8 bf16; one value where C or the pointers do
// not allow it) and, in a partial pass, walks kIters pixels of its block's
// span with f64 accumulators. Also: thread 0's SM clocks per phase (`Clk`,
// the kernels' `cycles=` rows) and the vector loads and streaming stores of
// both files' one-launch designs.

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

// ---------------------------------------------------------------- clocks --
constexpr int kMaxPhases = 8;  // the most phases a kernel's `cycles` row has

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// Thread 0's SM cycles per phase, kept in registers until `flush(n)` adds
// the first n to its row; `mark(ph, dep)` first stores dep to shared memory
// (volatile), so the clock is read after the value behind dep arrived.
template <bool kOn>
struct Clk {
  long long* out = nullptr;
  long long last = 0;
  long long acc[kMaxPhases] = {};
  __device__ explicit Clk(long long* row) {
    if constexpr (kOn) {
      if (threadIdx.x == 0 && row != nullptr) {
        out = row;
        last = clock_now();
      }
    }
  }
  __device__ __forceinline__ void mark(int ph, unsigned dep = 0u) {
    if constexpr (kOn) {
      if (out != nullptr) {
        __shared__ volatile unsigned sink;
        sink = dep;
        const long long now = clock_now();
        acc[ph] += now - last;
        last = now;
      }
    }
  }
  __device__ __forceinline__ void flush(int n) {
    if constexpr (kOn) {
      if (out != nullptr) {
#pragma unroll
        for (int i = 0; i < kMaxPhases; ++i)
          if (i < n) out[i] += acc[i];
      }
    }
  }
};

template <typename T, int V>
__device__ __forceinline__ unsigned first_word(const Vec<T, V>& v) {
  if constexpr (sizeof(T) == 4) return __float_as_uint(to_f(v.v[0]));
  return (unsigned)__bfloat16_as_ushort(v.v[0]);
}

__device__ __forceinline__ unsigned low_word(double d) {
  return (unsigned)__double2loint(d);
}

// --------------------------------------------------------- vector memory --
// V values of T: 16-byte loads and stores where V * sizeof(T) == 16, else
// element by element. kNc: read-only path (phase one); kCs: streaming
// (evict-first: the last use of x and dy, and dx, which nothing here reads)
template <typename T>
__device__ __forceinline__ T ld_elem(const T* p, bool stream) {
  if constexpr (sizeof(T) == 4) {
    return stream ? __ldcs(p) : __ldg(p);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    return __ushort_as_bfloat16(stream ? __ldcs(q) : __ldg(q));
  }
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> ldv(const T* p, bool stream) {
  Vec<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 u = stream ? __ldcs(q) : __ldg(q);
    *reinterpret_cast<uint4*>(&r) = u;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = ld_elem(p + k, stream);
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void stv_cs(T* p, const Vec<T, V>& r) {
  if constexpr (V * sizeof(T) == 16) {
    __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&r));
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (sizeof(T) == 4)
        __stcs(reinterpret_cast<float*>(p + k), to_f(r.v[k]));
      else
        __stcs(reinterpret_cast<unsigned short*>(p + k), __bfloat16_as_ushort(r.v[k]));
    }
  }
}

}  // namespace
