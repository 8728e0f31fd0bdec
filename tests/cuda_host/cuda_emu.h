// Host emulation of the CUDA features that kernel C (csrc/arith_decode.cu)
// uses, so that its source compiles with g++ and runs on the CPU in the
// tests: each warp's 32 lanes run as 32 threads, and the warp intrinsics
// (shuffles and reductions) exchange values through a barrier. Only
// warp-uniform control flow around an intrinsic is supported, which is all
// the kernel has. Launches run the grid's warps one after another.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct dim3e { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3e threadIdx, blockIdx;
inline dim3e blockDim, gridDim;
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
using std::max;
using std::min;
inline void __syncwarp() {}

struct WarpExchange {
    std::barrier<> bar{32};
    unsigned slot[32];
};
inline thread_local WarpExchange* g_warp = nullptr;

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
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
    return exchange(v, [](unsigned* s) { return *std::max_element(s, s + 32); });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
    return exchange(v, [](unsigned* s) { return *std::min_element(s, s + 32); });
}
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned sh) {
    sh = sh > 32 ? 32 : sh;
    unsigned long long v = ((unsigned long long)hi << 32) | lo;
    return sh == 32 ? lo : (unsigned)((v << sh) >> 32);
}
template <class T>
inline T __ldg(const T* p) { return *p; }

// Run a kernel: every block of the grid, one warp at a time, its 32 lanes as threads.
template <class K, class... A>
void emu_launch(K kernel, unsigned grid, unsigned block, A... args) {
    gridDim.x = grid;
    blockDim.x = block;
    for (unsigned b = 0; b < grid; ++b) {
        for (unsigned w = 0; w < (block + 31) / 32; ++w) {
            WarpExchange ex;
            std::vector<std::thread> lanes;
            for (unsigned l = 0; l < 32; ++l) {
                lanes.emplace_back([&, l] {
                    threadIdx.x = w * 32 + l;
                    blockIdx.x = b;
                    g_warp = &ex;
                    kernel(args...);
                });
            }
            for (auto& t : lanes) t.join();
        }
    }
}
