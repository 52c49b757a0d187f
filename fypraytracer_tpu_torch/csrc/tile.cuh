// The tiles of the ReSTIR frame kernels, and a tile launched as a thread-block
// cluster.
//
// A tile is C consecutive pixels (render/restir_common.py::pick_ray_lanes: 512,
// or 256 or 128 where 512 does not divide the frame), the JAX megakernels' unit
// (fypraytracer_tpu/render/megakernel.py:2550-2554): it reads the previous
// frame's buffers at ONE offset, rint of the mean reprojection offset of its
// shading pixels, summed as integers, and its spatial reads are clamped to
// [0, B - C] as one row.  Pixel pix lies in tile pix / C at lane pix % C,
// whatever the launch.
//
// K4 and K7 run a tile as C / kTileBlock blocks of kTileBlock threads,
// which need no cluster: they sum nothing over a tile.
// K3, K5 and K6 are launched as clusters (ClusterTile, launch_tiles) in one
// of two shapes, which the host picks by frame
// (render/restir_common.py::tile_clustered):
//   * a tile split over a cluster of C / kTileBlock blocks of kTileBlock
//     threads: each block adds its pixels' offsets in its own shared memory,
//     the cluster meets at its barrier, every block reads the blocks' parts
//     through distributed shared memory in rank order, and the cluster meets
//     again, so that no block exits while another still reads its shared
//     memory;
//   * a tile one block of C threads (a cluster of one block).
// Integer sums do not depend on their order, so the offset is the one-block
// tile's, bit for bit.
//
// Why two: a frame is B / C tiles, so one block a tile gives a 128² frame 32
// blocks for the H100's 132 multiprocessors; split, the same frame is 128
// blocks of 128 on 128 multiprocessors, and K5 runs it 1.23x faster, K3
// 1.09x.  Where the tiles, one block each, fill most of the card (256²: 128
// tiles), one block a tile is faster (K5 1.35x, K3 1.08x, K6 1.34x): the
// card holds 124 clusters of four blocks at once, so 128 tiles split take two
// waves, and the cluster barriers cost (on an H100, PERF.md Findings).
// Between the two the crossover follows the tree: 32-50 tiles on the Cornell
// box, 72-98 on the stress scene, for K5 and K6 alike; the host splits up to
// half the multiprocessors.  A
// cluster runs within one GPC, and B / threads blocks are whole clusters
// since C divides B.
//
// What the sum costs K5 and K6, and what was tried against it (section clocks,
// restir_gi.cu; PERF.md Findings): the barrier waits for the tile's slowest
// path, 17-20% of K5's threads' cycles at Cornell and 30-36% of K5's and
// K6's on the stress scene.  Summed just after the primary hit, the wait fell
// to 4-14% but K5 and K6 ran up to 1.15x slower; summed by a pass of its own
// before them, which let them run blocks of 128 without a cluster (20 warps
// a multiprocessor), the pass cost 0.047 ms at 256² and K5 lost 1.27x at
// 1920x1088.  The sum stays in the frame kernel, after the path sample.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "wide.cuh"

namespace fyp {

constexpr int kTileBlock = 128;  // threads a block of a split tile (K3-K6)
constexpr int kTileMax = 512;    // the largest tile, and the block of a tile run as one block

// The threads of a block of K3-K6 for tiles of C pixels, split or not
inline int tile_threads(int C, bool clustered) { return clustered ? kTileBlock : C; }

// The static shared memory of a tile kernel: ClusterTile's part, beside the
// walks' stacks in dynamic shared memory (together at most the 232,448 bytes
// a block may hold)
constexpr size_t kTileStaticSmem = sizeof(int2);

// Whether K3-K6 can launch tiles of C pixels, split or not: C a tile size
// whose blocks are whole, and a stack of depth entries for every thread of a
// block in its shared memory; *smem gets the stacks' bytes
inline bool tile_fits(int C, bool clustered, int depth, size_t* smem) {
  const int threads = tile_threads(C, clustered);
  *smem = wide_stack_bytes(threads, depth > 0 ? depth : 0);
  return C > 0 && C <= kTileMax && C % threads == 0 && depth >= 1 && *smem + kTileStaticSmem <= 232448u;
}

// The sum of v over the tile's threads that add, and their count (x, y): every
// thread of the tile calls it and gets the tile's totals.  The block's part
// in its shared memory, the cluster's barrier, every block's part read in
// rank order, the barrier again (a tile one block is a cluster of one).
struct ClusterTile {
  __device__ static int2 sum(bool add, int v) {
    namespace cg = cooperative_groups;
    __shared__ int2 part;
    const cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) part = make_int2(0, 0);
    __syncthreads();
    if (add) {
      atomicAdd(&part.x, v);
      atomicAdd(&part.y, 1);
    }
    cluster.sync();
    int2 tot = make_int2(0, 0);
    for (unsigned int r = 0; r < cluster.num_blocks(); ++r) {
      const int2 p = *cluster.map_shared_rank(&part, r);
      tot.x += p.x;
      tot.y += p.y;
    }
    cluster.sync();
    return tot;
  }
};

// The launch of n_pix pixels in tiles of C: blocks of threads threads with
// smem bytes of dynamic shared memory each, grouped in clusters of C / threads
// blocks.
inline cudaLaunchConfig_t tile_config(int n_pix, int C, int threads, size_t smem, cudaStream_t stream,
                                      cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = C / threads;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_pix / threads);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

template <class... Ks, class... Args>
cudaError_t launch_tiles(void (*kernel)(Ks...), int n_pix, int C, int threads, size_t smem, cudaStream_t stream,
                         Args... args) {
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = tile_config(n_pix, C, threads, smem, stream, &cluster);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The blocks of a tile kernel one multiprocessor holds at once, and the
// clusters the card holds at once, by the CUDA runtime.
template <class Kernel>
cudaError_t tile_occupancy(Kernel kernel, int C, int threads, size_t smem, int* blocks_per_sm, int* clusters) {
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = tile_config(C, C, threads, smem, nullptr, &cluster);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, cfg.blockDim.x, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return e;
}

}  // namespace fyp
