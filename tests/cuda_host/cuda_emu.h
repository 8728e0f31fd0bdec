// Host emulation of the CUDA features that kernels A, B, C, E, F, G, H and I
// (csrc/arith_encode.cu, csrc/arith_prepad.cu, csrc/arith_decode.cu,
// csrc/lzss_commit.cu, csrc/lzss_decode.cu, csrc/huffman_encode.cu,
// csrc/huffman_decode.cu, csrc/arith_events.cu) use, so
// that their sources compile with g++ and run on the CPU in the tests: each
// thread of a CTA runs as a thread of its own, all of a CTA's threads at
// once; the warp intrinsics (shuffles, reductions, __syncwarp) exchange
// values through a barrier of the warp's 32 lanes (__ballot_sync and __any_sync
// vote through one), and __syncthreads is a
// barrier of the CTA's threads (__syncthreads_or also ORs a predicate over
// them). Only warp-uniform control flow around a warp
// intrinsic, and CTA-uniform control flow around __syncthreads, is
// supported, which is all the kernels have. Shared memory is a static
// variable: the grid's CTAs run one after another, row by row of a 2D grid
// (dim3), so a CTA that waits on flags an earlier CTA set (kernel G's
// look-back) finds them set. Dynamic shared memory
// (`extern __shared__ T name[];`) takes EMU_DYNAMIC_SHARED_BYTES, the most a
// CTA of an H100 may ask for: the tests rewrite the declaration to
// `__shared__ T name[EMU_DYNAMIC_SHARED_BYTES];`, as they rewrite launches
// to emu_launch, and cudaFuncSetAttribute accepts any size up to it.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
#define __shared__ static

struct dim3e { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3e threadIdx, blockIdx;
inline dim3e blockDim, gridDim;
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
inline int cudaGetLastError() { return 0; }
constexpr int EMU_DYNAMIC_SHARED_BYTES = 232448;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
    return bytes <= EMU_DYNAMIC_SHARED_BYTES ? cudaSuccess : 1;
}
inline const char* cudaGetErrorString(cudaError_t) { return "no error (host emulation)"; }
using std::max;
using std::min;

struct WarpExchange {
    std::barrier<> bar{32};
    unsigned slot[32];
    unsigned long long slot64[32];
};
inline thread_local WarpExchange* g_warp = nullptr;
inline thread_local std::barrier<>* g_cta = nullptr;

inline void __syncwarp(unsigned = 0xFFFFFFFFu) { g_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { g_cta->arrive_and_wait(); }
inline int g_cta_or = 0;  // the CTA's predicate of __syncthreads_or
inline int __syncthreads_or(int pred) {
    if (pred) __atomic_store_n(&g_cta_or, 1, __ATOMIC_RELAXED);
    g_cta->arrive_and_wait();
    const int r = __atomic_load_n(&g_cta_or, __ATOMIC_RELAXED);
    g_cta->arrive_and_wait();
    if (threadIdx.x == 0) __atomic_store_n(&g_cta_or, 0, __ATOMIC_RELAXED);
    g_cta->arrive_and_wait();
    return r;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
inline unsigned atomicOr(unsigned* p, unsigned v) { return __atomic_fetch_or(p, v, __ATOMIC_RELAXED); }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {  // byte k of the result: byte (s >> 4k) & 7 of y:x
    const unsigned long long v = ((unsigned long long)y << 32) | x;
    unsigned r = 0;
    for (int k = 0; k < 4; ++k) r |= (unsigned)((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k);
    return r;
}

inline unsigned lane_id() { return threadIdx.x & 31; }
template <class F>
inline unsigned exchange(unsigned v, F f) {
    g_warp->slot[lane_id()] = v;
    g_warp->bar.arrive_and_wait();
    unsigned r = f(g_warp->slot);
    g_warp->bar.arrive_and_wait();
    return r;
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
    return exchange(v, [&](unsigned* s) { return s[src & 31]; });
}
inline unsigned __shfl_up_sync(unsigned, unsigned v, unsigned delta) {
    const unsigned lane = lane_id();
    return exchange(v, [&](unsigned* s) { return lane >= delta ? s[lane - delta] : s[lane]; });
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {  // 32- or 64-bit values
    static_assert(sizeof(T) <= 8);
    const unsigned lane = lane_id();
    g_warp->slot64[lane] = (unsigned long long)v;
    g_warp->bar.arrive_and_wait();
    const T r = (T)g_warp->slot64[(lane ^ (unsigned)mask) & 31];
    g_warp->bar.arrive_and_wait();
    return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
    const unsigned lane = lane_id();
    return exchange(pred ? 1u << lane : 0u, [](unsigned* s) {
        unsigned r = 0;
        for (int k = 0; k < 32; ++k) r |= s[k];
        return r;
    });
}
inline int __any_sync(unsigned, int pred) {
    return (int)exchange(pred ? 1u : 0u, [](unsigned* s) { return (unsigned)std::any_of(s, s + 32, [](unsigned v) { return v != 0; }); });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
    return exchange(v, [](unsigned* s) { return *std::max_element(s, s + 32); });
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
    return exchange(v, [](unsigned* s) {
        unsigned r = 0;
        for (int k = 0; k < 32; ++k) r += s[k];
        return r;
    });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
    return exchange(v, [](unsigned* s) { return *std::min_element(s, s + 32); });
}
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned sh) {
    sh = sh > 32 ? 32 : sh;
    unsigned long long v = ((unsigned long long)hi << 32) | lo;
    return sh == 32 ? lo : (unsigned)((v << sh) >> 32);
}
template <class T>
inline T __ldg(const T* p) { return *p; }

// Run a kernel: the CTAs of the grid one after another (x fastest), all threads
// of a CTA at once. The threads are made once a launch and run every CTA,
// meeting at a barrier between two CTAs.
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, unsigned block, A... args) {
    gridDim.x = grid.x;
    gridDim.y = grid.y;
    blockDim.x = block;
    const auto warps = std::make_unique<WarpExchange[]>((block + 31) / 32);
    std::barrier<> cta((std::ptrdiff_t)block);
    std::vector<std::thread> threads;
    for (unsigned l = 0; l < block; ++l) {
        threads.emplace_back([&, l] {
            threadIdx.x = l;
            g_warp = &warps[l / 32];
            g_cta = &cta;
            for (unsigned y = 0; y < grid.y; ++y) {
                for (unsigned b = 0; b < grid.x; ++b) {
                    blockIdx.x = b;
                    blockIdx.y = y;
                    kernel(args...);
                    cta.arrive_and_wait();
                }
            }
        });
    }
    for (auto& t : threads) t.join();
}
