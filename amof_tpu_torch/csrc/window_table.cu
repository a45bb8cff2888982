// K-slot neighbour tables over candidate windows (the BAD/CN table pass),
// for Hopper.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * amof_tpu/ops/pallas_neighbors.py pallas_window_table_slab
//     (_kernel_slab; kernel #3): 2-level (x-slab, y) windows, three
//     candidate runs per chunk of centers, per-run key-range masks, self
//     excluded by global index (window_table_slab_launch);
//   * amof_tpu/ops/pallas_neighbors.py pallas_window_table (_kernel;
//     kernel #4): the 1-level circular window ext[c0, c0 + chunk + 2W)
//     over atoms sorted by fractional x, self excluded by column
//     (window_table_launch).
//
// Both fill slots in ascending column order (run-major for #3) -- the
// same slots, in the same order, as the Pallas kernels' repeated
// masked-min picks. Every valid candidate is counted (cnt > K flags an
// overflow); the first K are written (x, y, z, species); empty slots get
// position 0 and species -1. The TPU's lane-block packing limit
// (1 + 4K <= 128) does not exist here: any K works.
//
// Kernel #3 (window_table_slab_kernel). At the bench shapes (10240 atoms,
// chunk 16, W 256) a chunk's three runs hold 3W = 768 columns, of which
// ~90 on average lie in the runs' key ranges, and ~30% of the chunks hold
// only filler centers: the inputs need ~1.3e6 (live center, kept column)
// tests, well under a microsecond of the card's f32 rate, and ~2.5 MB of
// traffic (1.9 MB of it the output rows). What bounds the kernel is
// latency: a block's dependent rounds (the runs' starts, then their keys,
// then the kept columns' gather, then the tests' ballot rounds), each a
// round trip to L2 or shared memory.
// The call as a whole is bound by its host launch path, which the wrapper
// keeps short (one allocation, no device work besides the launch).
// A block of 128 threads (four warps) takes cpb consecutive centers of
// one chunk: the largest divisor of the chunk up to 16 whose cpb * K slots
// fit a 16 KB output tile (one center when K alone needs more); at the
// bench, one chunk a block, 945 blocks. It:
//   1. loads its warps' centers into registers: warp w owns centers w,
//      w + 4, ... (cpw = 1, 2 or 4 of them, a template parameter, so every
//      loop over them unrolls and their state -- position, global index,
//      cutoff row, running count -- stays in registers); the chunk's runs,
//      the cell and the squared cutoff matrix go to shared memory (squared
//      in the kernel: an f32 product is correctly rounded, so it equals the
//      plain version's cut * cut). A block without a live center
//      (__syncthreads_or) goes straight to step 4: it never touches a
//      candidate;
//   2. compacts the in-range columns: in passes of SLAB_PASS columns (8 a
//      thread, each step of 128 coalesced; a column's run is two compares,
//      r = (c >= W) + (c >= 2W), and its row starts[r] + c - rW, so no
//      column pays a division), each thread tests its columns' keys
//      against their run's [qlo, qhi); a ballot per step, and a scan of
//      the 32 (step, warp) counts that every warp makes itself, give each
//      kept column its place in column order. Only kept columns are
//      gathered (x, y, z, species, global index) into the shared staging
//      (20 B a column, min(3W, SLAB_PASS) columns); a pass that would
//      overflow it first flushes what is staged (step 3). Keys need not be
//      sorted, and a range may be empty or cover its whole window: the
//      mask alone decides, as in the Pallas kernel;
//   3. tests the staged columns, 32 a round: each lane reads its column
//      once and tests it against each of its warp's centers, branch-free
//      (independent chains, so a warp's centers overlap); one ballot a
//      center orders that center's valid columns, so slot = count + rank,
//      and the slot (x, y, z, species) goes to the center's row of the
//      block's output tile in shared memory;
//   4. writes its cpb rows of nbr_pos, nbr_sp and cnt once: each output's
//      rows are one contiguous range, written coalesced, slots past the
//      count as 0 and -1. No separate pass clears the outputs.
// 78 registers (four centers a warp), so six blocks an SM: the ~30% of
// blocks of fillers only finish within ~1 us and free their places for
// the rest. Tensor cores and TMA do not apply: the work is exact f32
// compares after floor wraps, not a product, and the kept columns are a
// data-dependent gather of a couple of kilobytes a block.
//
// Kernel #4 (window_table_kernel): one warp per center. The lanes test 32
// consecutive candidate columns at a time; a ballot orders the valid ones.
// A block holds up to 32 centers of one chunk (so they share the chunk's
// window) and stages the window's candidates in shared memory, SEG columns
// at a time. What bounds it on the card: ~35 f32 operations per candidate
// test and the staging loads (16 B per candidate per block, from L2); the
// output is K * 16 B per center.
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
constexpr int SLAB_THREADS = 128;
constexpr int SLAB_WARPS = SLAB_THREADS / 32;
constexpr int SLAB_STEPS = 8;  // 128-column steps a pass
constexpr int SLAB_PASS = SLAB_THREADS * SLAB_STEPS;  // columns a pass
constexpr int SLAB_MAX_CPB = 16;       // centers a block, 4 a warp
constexpr int SLAB_TILE_SLOTS = 1024;  // cpb * K, unless K alone is more
static_assert(SLAB_STEPS * SLAB_WARPS == 32, "one warp scans the counts");

// The launch's arguments. out: one allocation of M * (4K + 1) 32-bit
// words, nbr_pos f32[M, K, 3], then nbr_sp i32[M, K], then cnt i32[M].
struct SlabArgs {
  const float* centers;
  const float* cand;
  const int* starts;
  const float* qb;
  const float* cell;
  const float* inv;
  const float* cutoff;
  float* out;
  int m, m2, n_species, k_cap, chunk, w;
};

struct SlabShape {
  int cpb;      // centers a block (divides the chunk)
  int cpw;      // centers a warp: 1, 2 or 4
  int cap;      // staged columns
  size_t smem;  // dynamic shared bytes: staging, tile, gidx, cut^2
};

SlabShape slab_shape(int chunk, int k_cap, int w, int n_species) {
  SlabShape s;
  s.cpb = 1;
  for (int d = chunk < SLAB_MAX_CPB ? chunk : SLAB_MAX_CPB; d > 1; --d) {
    if (chunk % d == 0 && (long long)d * k_cap <= SLAB_TILE_SLOTS) {
      s.cpb = d;
      break;
    }
  }
  s.cpw = s.cpb <= SLAB_WARPS ? 1 : s.cpb <= 2 * SLAB_WARPS ? 2 : 4;
  s.cap = 3 * w < SLAB_PASS ? 3 * w : SLAB_PASS;
  s.smem = (size_t)s.cap * 20 + (size_t)s.cpb * k_cap * 16 +
           (size_t)n_species * n_species * 4;
  return s;
}

// Step 3: the warp's CPW centers (center i is the block's warp + 4i) against
// staged columns [0, staged), 32 a round: each lane reads its column once
// and tests it against every center (independent chains), then one ballot
// a center orders that center's valid columns; the valid ones go to the
// center's tile row. cv holds the cell, then its inverse.
template <int CPW>
__device__ __forceinline__ void slab_tests(
    const float4* stage, const float* gid, int staged, const float4 (&ce)[CPW],
    const int (&crow)[CPW], int (&count)[CPW], const float* cut2, int k_cap,
    float4* tile, const float* cv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  float c[9], v[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    c[e] = cv[e];
    v[e] = cv[9 + e];
  }
  for (int base = 0; base < staged; base += 32) {
    const int k = base + lane;
    const int kk = k < staged ? k : staged - 1;
    const float4 cd = stage[kk];
    const float g = gid[kk];
    const int sj = __float_as_int(cd.w);
    const bool real = k < staged && sj >= 0;
    const int sjc = sj < 0 ? 0 : sj;
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const float dx = cd.x - ce[i].x, dy = cd.y - ce[i].y,
                  dz = cd.z - ce[i].z;
      const float d2 = dist2(dx, dy, dz, c, v);
      const bool valid = real && crow[i] >= 0 && g != ce[i].w &&
                         d2 < cut2[(crow[i] < 0 ? 0 : crow[i]) + sjc];
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        const int rank = count[i] + __popc(ballot & lt_mask);
        if (rank < k_cap)
          tile[(long long)(warp + SLAB_WARPS * i) * k_cap + rank] = cd;
      }
      count[i] += __popc(ballot);
    }
  }
}

// Step 2's key test: bit i of the result is column p0 + 128 i + tid of the
// chunk's 3W, kept. A column's run is two compares; its row is
// col + delta[run].
__device__ __forceinline__ unsigned slab_keep_mask(
    const float* keys, int p0, int width, int w, const int* delta,
    const float* qlo, const float* qhi) {
  unsigned mine = 0;
#pragma unroll
  for (int i = 0; i < SLAB_STEPS; ++i) {
    const int col = p0 + i * SLAB_THREADS + threadIdx.x;
    if (col < width) {
      const int r = (col >= w) + (col >= 2 * w);
      const float key = keys[col + delta[r]];
      if (key >= qlo[r] && key < qhi[r]) mine |= 1u << i;
    }
  }
  return mine;
}

template <int CPW>
__global__ void __launch_bounds__(SLAB_THREADS, 6)
window_table_slab_kernel(const SlabArgs a, int cpb, int cap) {
  extern __shared__ float4 smem[];
  const int w = a.w, k_cap = a.k_cap, n_species = a.n_species;
  float4* stage = smem;                           // [cap] x, y, z, species
  float4* tile = stage + cap;                     // [cpb * K] slots
  float* gid = (float*)(tile + (long long)cpb * k_cap);  // [cap]
  float* cut2 = gid + cap;                        // [S * S]
  __shared__ int ccount[SLAB_MAX_CPB];
  __shared__ int counts[32];  // kept columns of each (step, warp)
  __shared__ float cv[18];    // cell, then inverse
  __shared__ int delta[3];    // row of column c of run r: c + delta[r]
  __shared__ float qlo[3], qhi[3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long first = (long long)blockIdx.x * cpb;
  const int ch = (int)(first / a.chunk);

  // 1. the warp's centers into registers (crow: the center's row of the
  // squared cutoffs, -1 for a filler), the chunk's runs, the cell and the
  // squared cutoffs into shared memory; a block of fillers only skips to
  // step 4
  float4 ce[CPW];
  int crow[CPW], count[CPW];
  bool live = false;
#pragma unroll
  for (int i = 0; i < CPW; ++i) {
    const int q = warp + SLAB_WARPS * i;
    ce[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    crow[i] = -1;
    count[i] = 0;
    if (q < cpb) {
      const float* row = a.centers + 8 * (first + q);
      const int sp = (int)row[3];
      ce[i] = make_float4(row[0], row[1], row[2], row[4]);
      crow[i] = sp >= 0 ? sp * n_species : -1;
      live = live || sp >= 0;
    }
  }
  if (tid < 3) {
    delta[tid] = a.starts[3 * ch + tid] - tid * w;
    qlo[tid] = a.qb[6 * ch + 2 * tid];
    qhi[tid] = a.qb[6 * ch + 2 * tid + 1];
  } else if (tid >= 32 && tid < 50) {
    const int e = tid - 32;
    cv[e] = e < 9 ? a.cell[e] : a.inv[e - 9];
  }
  for (int e = tid; e < n_species * n_species; e += SLAB_THREADS) {
    const float cf = a.cutoff[e];
    cut2[e] = cf * cf;
  }

  if (__syncthreads_or(live)) {
    const float* keys = a.cand + 5LL * a.m2;
    const int width = 3 * w;
    const unsigned lt_mask = (1u << lane) - 1u;
    int staged = 0;
    for (int p0 = 0; p0 < width; p0 += SLAB_PASS) {
      // 2. compaction: a ballot per step, then every warp scans the 32
      // (step, warp) counts itself
      const unsigned mine =
          slab_keep_mask(keys, p0, width, w, delta, qlo, qhi);
#pragma unroll
      for (int i = 0; i < SLAB_STEPS; ++i) {
        const unsigned b = __ballot_sync(0xffffffffu, (mine >> i) & 1u);
        if (lane == 0) counts[i * SLAB_WARPS + warp] = __popc(b);
      }
      __syncthreads();
      const int x = counts[lane];
      int incl = x;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      const int kept = __shfl_sync(0xffffffffu, incl, 31);
      if (staged + kept > cap) {  // block-uniform
        slab_tests<CPW>(stage, gid, staged, ce, crow, count, cut2, k_cap,
                        tile, cv);
        staged = 0;
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < SLAB_STEPS; ++i) {
        const bool keep = (mine >> i) & 1u;
        const unsigned b = __ballot_sync(0xffffffffu, keep);
        const int at = __shfl_sync(0xffffffffu, incl - x,
                                   i * SLAB_WARPS + warp);
        if (keep) {
          const int k = staged + at + __popc(b & lt_mask);
          const int col = p0 + i * SLAB_THREADS + tid;
          const long long j = col + delta[(col >= w) + (col >= 2 * w)];
          stage[k] = make_float4(a.cand[j], a.cand[(long long)a.m2 + j],
                                 a.cand[2LL * a.m2 + j],
                                 __int_as_float((int)a.cand[3LL * a.m2 + j]));
          gid[k] = a.cand[4LL * a.m2 + j];
        }
      }
      __syncthreads();
      staged += kept;
    }
    // 3. what is left staged
    if (staged > 0)
      slab_tests<CPW>(stage, gid, staged, ce, crow, count, cut2, k_cap, tile,
                      cv);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int q = warp + SLAB_WARPS * i;
      if (q < cpb) ccount[q] = count[i];
    }
  }
  __syncthreads();

  // 4. the block's rows, each output one contiguous range
  const int slots = cpb * k_cap;
  float* pos_out = a.out + first * k_cap * 3;
  const float* tile_f = (const float*)tile;
  for (int e = tid; e < 3 * slots; e += SLAB_THREADS) {
    const int slot = e / 3;
    const int q = slot / k_cap;
    pos_out[e] = slot - q * k_cap < ccount[q]
                     ? tile_f[4 * slot + (e - 3 * slot)] : 0.f;
  }
  int* sp_out = (int*)(a.out + 3LL * a.m * k_cap) + first * k_cap;
  for (int e = tid; e < slots; e += SLAB_THREADS) {
    const int q = e / k_cap;
    sp_out[e] = e - q * k_cap < ccount[q] ? __float_as_int(tile[e].w) : -1;
  }
  if (tid < cpb)
    ((int*)(a.out + 3LL * a.m * k_cap))[(long long)a.m * k_cap + first + tid] =
        ccount[tid];
}

template <int CPW>
cudaError_t slab_run(const SlabArgs& a, const SlabShape& s,
                     cudaStream_t stream) {
  if (s.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        window_table_slab_kernel<CPW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s.smem);
    if (e != cudaSuccess) return e;
  }
  window_table_slab_kernel<CPW>
      <<<a.m / s.cpb, SLAB_THREADS, s.smem, stream>>>(a, s.cpb, s.cap);
  return cudaGetLastError();
}

// the kernel's attributes at shape s: registers, static shared bytes,
// resident blocks per SM
template <int CPW>
cudaError_t slab_attributes(const SlabShape& s, int* out) {
  cudaError_t e = cudaSuccess;
  if (s.smem > 48 * 1024)
    e = cudaFuncSetAttribute(window_table_slab_kernel<CPW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s.smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, window_table_slab_kernel<CPW>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], window_table_slab_kernel<CPW>, SLAB_THREADS, s.smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  return cudaSuccess;
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

// Kernel #3. out: M * (4K + 1) 32-bit words (see SlabArgs).
extern "C" int window_table_slab_launch(
    const void* centers, const void* cand, const void* starts, const void* qb,
    const void* cell, const void* inv_cell, const void* cutoff, void* out,
    int m, int m2, int n_species, int k_cap, int chunk, int w, void* stream) {
  if (m <= 0) return 0;
  const SlabArgs a = {(const float*)centers, (const float*)cand,
                      (const int*)starts,    (const float*)qb,
                      (const float*)cell,    (const float*)inv_cell,
                      (const float*)cutoff,  (float*)out,
                      m, m2, n_species, k_cap, chunk, w};
  const SlabShape s = slab_shape(a.chunk, a.k_cap, a.w, a.n_species);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(s.cpw == 1   ? slab_run<1>(a, s, st)
               : s.cpw == 2 ? slab_run<2>(a, s, st)
                            : slab_run<4>(a, s, st));
}

// Kernel #3's launch for (M, chunk, K, W, species) on the current card,
// ten ints: blocks, threads a block, centers a block, centers a warp,
// staged columns, columns a pass, dynamic shared bytes, registers a
// thread, static shared bytes, resident blocks per SM
extern "C" int window_table_slab_geometry(int m, int chunk, int k_cap, int w,
                                          int n_species, void* out) {
  int* o = (int*)out;
  const SlabShape s = slab_shape(chunk, k_cap, w, n_species);
  o[0] = m / s.cpb;
  o[1] = SLAB_THREADS;
  o[2] = s.cpb;
  o[3] = s.cpw;
  o[4] = s.cap;
  o[5] = SLAB_PASS;
  o[6] = (int)s.smem;
  return (int)(s.cpw == 1   ? slab_attributes<1>(s, o + 7)
               : s.cpw == 2 ? slab_attributes<2>(s, o + 7)
                            : slab_attributes<4>(s, o + 7));
}
