// K-slot neighbour tables over candidate windows (the BAD/CN table pass),
// for Hopper.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * amof_tpu/ops/pallas_neighbors.py pallas_window_table_slab
//     (_kernel_slab): 2-level (x-slab, y) windows, three candidate runs per
//     chunk of centers, per-run key-range masks, self excluded by global
//     index (window_table_slab_launch);
//   * amof_tpu/ops/pallas_neighbors.py pallas_window_table (_kernel): the
//     1-level circular window ext[c0, c0 + chunk + 2W) over atoms sorted by
//     fractional x, self excluded by column (window_table_launch).
//
// One warp per center. The lanes test 32 consecutive candidate columns at
// a time; a ballot orders the valid ones, so slots fill in ascending column
// order (run-major for the slab variant) -- the same slots, in the same
// order, as the Pallas kernels' repeated masked-min picks. Every valid
// candidate is counted; the first K are written (x, y, z, species); empty
// slots get position 0 and species -1. A block holds up to 32 centers of
// one chunk (so they share the chunk's window) and stages the window's
// candidates in shared memory, SEG columns at a time.
//
// What bounds it on the card: ~35 f32 operations per candidate test and
// the staging loads (16-24 B per candidate per block, from L2); the output
// is K * 16 B per center. The TPU's lane-block packing limit
// (1 + 4K <= 128) does not exist here: any K works.
//
// Bit-exactness: same expression order as the Pallas kernels, built with
// --fmad=false, so cutoff tests equal the plain PyTorch version's.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CPW = 4;  // centers per warp (<= 32 centers per block)
constexpr int SEG = 1024;   // candidate columns staged per pass
constexpr float HALF_EPS = (float)(0.5 + 1e-7);

__device__ __forceinline__ float dist2(float dx, float dy, float dz,
                                       const float* c, const float* v) {
  float fx = dx * v[0] + dy * v[3] + dz * v[6];
  float fy = dx * v[1] + dy * v[4] + dz * v[7];
  float fz = dx * v[2] + dy * v[5] + dz * v[8];
  fx = fx - floorf(fx + HALF_EPS);
  fy = fy - floorf(fy + HALF_EPS);
  fz = fz - floorf(fz + HALF_EPS);
  const float wx = fx * c[0] + fy * c[3] + fz * c[6];
  const float wy = fx * c[1] + fy * c[4] + fz * c[7];
  const float wz = fx * c[2] + fy * c[5] + fz * c[8];
  return wx * wx + wy * wy + wz * wz;
}

struct Center {
  float x, y, z, g;  // g: global index (slab variant) or self column
  int sp;
  int count;
};

// Tests one staged segment for every center this warp owns; appends valid
// candidates (in column order) to the centers' slot lists.
__device__ __forceinline__ void scan_segment(
    const float4* cand, const float* cand_g, int segw, int col0,
    Center* cen, const int* idx, int ncen, bool by_gidx, const float* c,
    const float* v, const float* __restrict__ cut2, int n_species, int k_cap,
    float* __restrict__ nbr_pos, int* __restrict__ nbr_sp) {
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int q = 0; q < ncen; ++q) {
    Center& ce = cen[q];
    for (int base = 0; base < segw; base += 32) {
      const int k = base + lane;
      bool valid = false;
      float4 cd = make_float4(0.f, 0.f, 0.f, 0.f);
      int sj = -1;
      if (k < segw && ce.sp >= 0) {
        cd = cand[k];
        sj = __float_as_int(cd.w);
        if (sj >= 0) {
          const bool not_self = by_gidx ? (cand_g[k] != ce.g)
                                        : ((float)(col0 + k) != ce.g);
          const float d2 = dist2(cd.x - ce.x, cd.y - ce.y, cd.z - ce.z, c, v);
          valid = not_self && d2 < cut2[ce.sp * n_species + sj];
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        const int rank = ce.count + __popc(ballot & lt_mask);
        if (rank < k_cap) {
          const long long o = (long long)idx[q] * k_cap + rank;
          nbr_pos[3 * o] = cd.x;
          nbr_pos[3 * o + 1] = cd.y;
          nbr_pos[3 * o + 2] = cd.z;
          nbr_sp[o] = sj;
        }
      }
      ce.count += __popc(ballot);
    }
  }
}

__device__ __forceinline__ void finish(const Center* cen, const int* idx,
                                       int ncen, int k_cap,
                                       float* __restrict__ nbr_pos,
                                       int* __restrict__ nbr_sp,
                                       int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  for (int q = 0; q < ncen; ++q) {
    const long long row = idx[q];
    if (lane == 0) cnt[row] = cen[q].count;
    for (int s = cen[q].count + lane; s < k_cap; s += 32) {
      const long long o = row * k_cap + s;
      nbr_pos[3 * o] = 0.f;
      nbr_pos[3 * o + 1] = 0.f;
      nbr_pos[3 * o + 2] = 0.f;
      nbr_sp[o] = -1;
    }
  }
}

__device__ __forceinline__ void load_cell(const float* cell, const float* inv,
                                          float* c, float* v) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    c[k] = cell[k];
    v[k] = inv[k];
  }
}

// 1-level window (pallas_window_table). pos [n,3] and sp [n] are sorted by
// wrapped fractional x; center i's window is ext[c0, c0 + width) with
// c0 = (i / chunk) * chunk and ext[k] = sorted[(k - window) mod n].
__global__ void __launch_bounds__(THREADS)
window_table_kernel(const float* __restrict__ pos, const int* __restrict__ sp,
                    const float* __restrict__ cell,
                    const float* __restrict__ inv,
                    const float* __restrict__ cut2, int n, int n_species,
                    int k_cap, int chunk, int window, int cpb,
                    float* __restrict__ nbr_pos, int* __restrict__ nbr_sp,
                    int* __restrict__ cnt) {
  __shared__ float4 cand[SEG];
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * cpb;
  const int c0 = (first / chunk) * chunk;
  const int width = chunk + 2 * window;
  float c[9], v[9];
  load_cell(cell, inv, c, v);

  Center cen[MAX_CPW];
  int idx[MAX_CPW];
  int ncen = 0;
  for (int q = 0; q < MAX_CPW; ++q) {
    const int ci = warp + WARPS * q;
    const int i = first + ci;
    if (ci >= cpb || i >= n) break;
    cen[q].x = pos[3 * i];
    cen[q].y = pos[3 * i + 1];
    cen[q].z = pos[3 * i + 2];
    cen[q].sp = sp[i];
    cen[q].g = (float)(window + (i - c0));  // self column
    cen[q].count = 0;
    idx[q] = i;
    ++ncen;
  }
  for (int col0 = 0; col0 < width; col0 += SEG) {
    const int segw = min(SEG, width - col0);
    __syncthreads();
    for (int k = threadIdx.x; k < segw; k += THREADS) {
      int j = (c0 + col0 + k - window) % n;
      if (j < 0) j += n;
      cand[k] = make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                            __int_as_float(sp[j]));
    }
    __syncthreads();
    scan_segment(cand, nullptr, segw, col0, cen, idx, ncen, false, c, v,
                 cut2, n_species, k_cap, nbr_pos, nbr_sp);
  }
  finish(cen, idx, ncen, k_cap, nbr_pos, nbr_sp, cnt);
}

// 2-level slab windows (pallas_window_table_slab). centers [M,8] rows
// (x, y, z, sp, gidx, fy, 0, 0); cand [8,M2] rows (x, y, z, sp, gidx, key,
// 0, 0); chunk ch's candidates are the runs cand[:, starts[ch,r] + [0, w)),
// r = 0..2, each masked to keys in [qb[ch,r,0], qb[ch,r,1]).
__global__ void __launch_bounds__(THREADS)
window_table_slab_kernel(const float* __restrict__ centers,
                         const float* __restrict__ cand_g,
                         const int* __restrict__ starts,
                         const float* __restrict__ qb,
                         const float* __restrict__ cell,
                         const float* __restrict__ inv,
                         const float* __restrict__ cut2, int m, int m2,
                         int n_species, int k_cap, int chunk, int w, int cpb,
                         float* __restrict__ nbr_pos, int* __restrict__ nbr_sp,
                         int* __restrict__ cnt) {
  __shared__ float4 cand[SEG];
  __shared__ float gid[SEG];
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * cpb;
  const int ch = first / chunk;
  float c[9], v[9];
  load_cell(cell, inv, c, v);

  Center cen[MAX_CPW];
  int idx[MAX_CPW];
  int ncen = 0;
  for (int q = 0; q < MAX_CPW; ++q) {
    const int ci = warp + WARPS * q;
    const int i = first + ci;
    if (ci >= cpb || i >= m) break;
    const float* row = centers + 8LL * i;
    cen[q].x = row[0];
    cen[q].y = row[1];
    cen[q].z = row[2];
    cen[q].sp = (int)row[3];
    cen[q].g = row[4];
    cen[q].count = 0;
    idx[q] = i;
    ++ncen;
  }
  const int width = 3 * w;
  for (int col0 = 0; col0 < width; col0 += SEG) {
    const int segw = min(SEG, width - col0);
    __syncthreads();
    for (int k = threadIdx.x; k < segw; k += THREADS) {
      const int col = col0 + k;
      const int r = col / w;
      const int j = starts[3 * ch + r] + (col - r * w);
      const float key = cand_g[5LL * m2 + j];
      const float qlo = qb[6 * ch + 2 * r];
      const float qhi = qb[6 * ch + 2 * r + 1];
      const int s = (key >= qlo && key < qhi) ? (int)cand_g[3LL * m2 + j] : -1;
      cand[k] = make_float4(cand_g[j], cand_g[(long long)m2 + j],
                            cand_g[2LL * m2 + j], __int_as_float(s));
      gid[k] = cand_g[4LL * m2 + j];
    }
    __syncthreads();
    scan_segment(cand, gid, segw, col0, cen, idx, ncen, true, c, v, cut2,
                 n_species, k_cap, nbr_pos, nbr_sp);
  }
  finish(cen, idx, ncen, k_cap, nbr_pos, nbr_sp, cnt);
}

}  // namespace

extern "C" int window_table_launch(const void* pos, const void* sp,
                                   const void* cell, const void* inv_cell,
                                   const void* cut2, int n, int n_species,
                                   int k_cap, int chunk, int window, void* nbr_pos,
                                   void* nbr_sp, void* cnt, void* stream) {
  if (n <= 0) return 0;
  int cpb = 1;
  for (int d = 32; d >= 1; --d) {
    if (chunk % d == 0) {
      cpb = d;
      break;
    }
  }
  const int blocks = (n + cpb - 1) / cpb;
  window_table_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const int*)sp, (const float*)cell,
      (const float*)inv_cell, (const float*)cut2, n, n_species, k_cap, chunk,
      window, cpb, (float*)nbr_pos, (int*)nbr_sp, (int*)cnt);
  return (int)cudaGetLastError();
}

extern "C" int window_table_slab_launch(
    const void* centers, const void* cand, const void* starts,
    const void* qbounds, const void* cell, const void* inv_cell,
    const void* cut2, int m, int m2, int n_species, int k_cap, int chunk,
    int w, void* nbr_pos, void* nbr_sp, void* cnt, void* stream) {
  if (m <= 0) return 0;
  int cpb = 1;
  for (int d = 32; d >= 1; --d) {
    if (chunk % d == 0) {
      cpb = d;
      break;
    }
  }
  const int blocks = (m + cpb - 1) / cpb;
  window_table_slab_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)centers, (const float*)cand, (const int*)starts,
      (const float*)qbounds, (const float*)cell, (const float*)inv_cell,
      (const float*)cut2, m, m2, n_species, k_cap, chunk, w, cpb,
      (float*)nbr_pos, (int*)nbr_sp, (int*)cnt);
  return (int)cudaGetLastError();
}
