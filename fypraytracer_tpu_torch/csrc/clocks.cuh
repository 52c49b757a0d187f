// Section clocks and block spans of K3 and K4 (restir_di.cu,
// -DFYP_DI_CLOCKS), K7 (restir_gi.cu, -DFYP_GI_CLOCKS) and K8
// (megakernel_diff.cu, -DFYP_DIFF_CLOCKS), for chip_smoke.py's
// di_attribution, k7_attribution and k8_attribution.
//
//   * SectionClocks<N>: each thread counts the cycles (clock64) it spends in
//     each of N sections; at its end every warp adds its threads' sums into
//     the kernel's N unsigned 64-bit sums, one atomic a section a warp;
//   * BlockSpans: each block's start and end on the card's clock in
//     nanoseconds (%globaltimer), the start the earliest of its warps' and
//     the end the latest (atomicMin and atomicMax a warp), for the first
//     kSpanBlocks blocks of a launch.  From them the reader tells how much
//     of a launch runs after its median block has ended (its tail).
//
// read_clocks hands both over, on the stream, and clears them for the next
// launch: the sums to 0, the starts to all ones and the ends to 0, so a
// kernel's first launch after loading reads wrong spans: read once before
// the launch to be measured.  Without the kernel's macro nothing here is
// used, and the kernels keep no clocks (NoClocks).
#pragma once

#include <cuda_runtime.h>

namespace fyp {

constexpr int kSpanBlocks = 1 << 15;  // 1920x1088 in blocks of 128 is 16,320

struct BlockSpans {
  unsigned long long start[kSpanBlocks];
  unsigned long long end[kSpanBlocks];
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int N>
struct SectionClocks {
  long long c[N] = {};
  __device__ __forceinline__ long long now() const { return clock64(); }
  // adds the cycles since t0 to section s and returns them
  __device__ __forceinline__ long long add(int s, long long t0) {
    const long long dt = clock64() - t0;
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] += k == s ? dt : 0;  // s need not be a constant: c stays in registers
    return dt;
  }
  __device__ __forceinline__ void sub(int s, long long dt) {
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] -= k == s ? dt : 0;
  }
  // every thread of the warp calls both
  __device__ __forceinline__ void begin(BlockSpans& spans) const {
    if ((threadIdx.x & 31) == 0 && blockIdx.x < kSpanBlocks) atomicMin(spans.start + blockIdx.x, global_ns());
  }
  __device__ void flush(unsigned long long* sums, BlockSpans& spans) const {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      long long v = c[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if ((threadIdx.x & 31) == 0) atomicAdd(sums + s, static_cast<unsigned long long>(v));
    }
    if ((threadIdx.x & 31) == 0 && blockIdx.x < kSpanBlocks) atomicMax(spans.end + blockIdx.x, global_ns());
  }
};

struct NoClocks {
  __device__ __forceinline__ long long now() const { return 0; }
  __device__ __forceinline__ long long add(int, long long) { return 0; }
  __device__ __forceinline__ void sub(int, long long) {}
  __device__ __forceinline__ void begin() const {}
  __device__ __forceinline__ void flush() const {}
};

// Copies the n_sections sums to sums_out and the first n_blocks (at most
// kSpanBlocks) starts and ends to spans_out, as (2, n_blocks) unsigned
// 64-bit ints on the card, and clears them, on the stream.
inline cudaError_t read_clocks(unsigned long long* sums, int n_sections, BlockSpans* spans, void* sums_out,
                               void* spans_out, int n_blocks, cudaStream_t st) {
  if (n_blocks < 0 || n_blocks > kSpanBlocks) return cudaErrorInvalidValue;
  const size_t nb = sizeof(unsigned long long) * static_cast<size_t>(n_blocks);
  auto* out = static_cast<unsigned long long*>(spans_out);
  cudaError_t e = cudaMemcpyAsync(sums_out, sums, sizeof(unsigned long long) * n_sections, cudaMemcpyDeviceToDevice,
                                  st);
  if (e == cudaSuccess && nb > 0) e = cudaMemcpyAsync(out, spans->start, nb, cudaMemcpyDeviceToDevice, st);
  if (e == cudaSuccess && nb > 0) e = cudaMemcpyAsync(out + n_blocks, spans->end, nb, cudaMemcpyDeviceToDevice, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(sums, 0, sizeof(unsigned long long) * n_sections, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(spans->start, 0xff, sizeof(spans->start), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(spans->end, 0, sizeof(spans->end), st);
  return e;
}

}  // namespace fyp
