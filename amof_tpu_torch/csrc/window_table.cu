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
// Kernel #4 (window_table_kernel<CPW>). At the bench's rerun case (10240
// atoms sorted by fractional x, chunk 256, W 1408, K 16) every chunk's
// window holds chunk + 2W = 3072 columns, but a center reaches only the
// atoms within max cutoff / w0x of it in fractional x (w0x: the cell's
// width across the b x c plane), about +-373 sorted positions at 2.0 A in
// the 54.87 A box: a block of 16 consecutive centers needs ~780 of the
// 3072. The in-reach (live center, real column) tests are ~8e6, 2.8e8 f32
// operations (~0.004 ms of the card's f32 rate); the output rows are
// (16K + 4) B a center. It shares #3's blocks, compaction, test rounds and
// row writes (slab_scan, slab_stage, test_rounds, write_rows): a block of
// 128 threads takes cpb consecutive centers of one chunk (cpb = min(16, chunk,
// 1024 / K), at least 1; a chunk is ceil(chunk / cpb) blocks, its last one
// short when cpb does not divide it, and so is the last chunk's last block
// when chunk does not divide n). It:
//   1. loads its warps' centers into registers, the cell, its inverse and
//      the squared cutoffs into shared memory; warp 0 computes the arc of
//      fractional x that the block's live centers span (below), warp 1 the
//      reach. A block without a live center goes straight to step 4;
//   2. compacts, in passes of SLAB_PASS columns, the columns that are real
//      (species >= 0) and within reach of the arc: ballots and a scan keep
//      them in column order. A column's row is c0 - W + col, brought into
//      [0, n) by one compare and one add (no division). A pass issues all
//      its loads before any test (no branch guards them: a guarded load
//      cost one L2 round trip a column, ~40% of the kernel's time). Only
//      kept columns are gathered into the staging (x, y, z, species) with
//      their prefilter values (fractional y and z in f32, 2^-20 max(s_y,
//      s_z), column);
//   3. tests them in #3's rounds (test_rounds), with its own pair test:
//      the pair prefilter, then self excluded by column (the center's own
//      column is W + its place in the chunk); a center runs the exact test
//      on a round only if some lane of its warp holds a column near it in
//      both fractional y and z (at the bench ~0.5% of the pairs; without
//      it the tests took ~30% more);
//   4. writes its rows once, coalesced, slots past the count as 0 / -1.
// What bounds it on the H100: issue (the double-precision cut over every
// window column, the prefilter over every kept pair) and the L2 latency of
// a pass's loads; 128 registers at four centers a warp leave 4 blocks an
// SM, 1.3 waves at the bench (capping registers for 5 or 6 spilled and lost
// at K 32). Tensor cores and TMA do not apply: the work is exact f32
// compares after floor wraps, and the kept columns are a data-dependent
// gather.
//
// The fractional-x cut. With v the inverse cell as given and a row's
// coordinates x_k, the cut takes u = x_0 v_0 + x_1 v_3 + x_2 v_6 and s =
// |x_0 v_0| + |x_1 v_3| + |x_2 v_6| in double (the products are exact). For
// the block's live centers, anchor a = u of the first, d_i = (u_i - a) -
// rint(u_i - a), mid = a + (min d + max d) / 2, half = (max d - min d) / 2,
// smax = max s_i. Column j is dropped when it is a pad, or when
//   |t - rint(t)| - half > R + 2^-20 (s_j + smax),  t = u_j - mid,
//   R = (rc + 2^-20 (rc + L)) / w0x,
// rc = sqrt(max of the squared cutoff matrix), L = |a| + |b| + |c| over the
// cell's rows, w0x = |det cell| / |b x c|, all in double. No dropped column
// passes d2 < cut^2 for any center of the block, under the kernel's own f32
// arithmetic (round to nearest, no FMA), whatever the positions or cell
// (u the unit roundoff 2^-24; g3 = 3u / (1 - 3u); cd(x) = |x - rint(x)|, the
// distance to the nearest integer, a metric on the circle):
//   * every center i has cd(u_i - mid) <= half, so by the triangle
//     inequality cd(u_j - u_i) >= cd(u_j - mid) - half: more than R +
//     2^-20 (s_j + s_i), less the double roundings (< 2^-50 (s_i + s_j +
//     1) each);
//   * the kernel's fx = fl(fl(fl(dx v0) + fl(dy v3)) + fl(dz v6)), dx =
//     fl(x_j - x_i), differs from the exact u_j - u_i by at most (u + g3 +
//     u g3) sum_k |x_jk - x_ik| |v| <= 4.01u (s_i + s_j), under the
//     2^-20 = 16u (s_i + s_j) above: cd(fx) > R;
//   * the wrap n = floor(fl(fx + 0.5 + 1e-7)) is an integer, so |fx - n| >=
//     cd(fx), and fx' = fl(fx - n) keeps that within a factor (1 - u); each
//     wrapped component is at most 1 in magnitude (a huge component is an
//     integer, whose wrap gives 0 or -1);
//   * w* = fx' a + fy' b + fz' c, exactly, lies |fx'| w0x from the b x c
//     plane, so |w*| >= |fx'| w0x; the f32 w differs from w* by at most g3
//     L; the f32 sum of squares is at least |w|^2 (1 - 3u);
//   * so d2 >= ((|fx'| w0x - g3 L)^2) (1 - 3u) >= rc^2 >= every cut^2 once
//     |fx'| w0x >= rc (1 + 2u) + g3 L, which R's 2^-20 = 16u terms cover
//     with room for the (1 - u) factors.
// The pair prefilter is the same argument along y and z, in f32 and per
// pair: with u_y, s_y, R_y (w0y = |det| / |c x a|, the distance of w* from
// the c x a plane being |fy'| w0y) and likewise z, a center keeps a_y =
// f32(R_y + 2^-20 s_iy) and f32 u_iy, a column f32 u_jy and b = f32(2^-20
// max(s_jy, s_jz)); the pair is skipped when cd(fl(u_jy - u_iy)) > fl(a_y
// + b) (or the same in z). The f32 roundings of the u's and of their
// difference add at most 3u (s_i + s_j), so cd(fy) > R_y (1 - 3u) + (16 -
// 7.1)u (s_i + s_j), and R_y's 2^-20 (rc + L) term covers the rest as
// above: a skipped pair fails d2 < cut^2 too.
// The cut reads only pos, sp, the cell and the cutoffs: no key or sort
// order of the caller's enters it, so a caller that breaks the sort
// contract gets fewer dropped columns, never a wrong slot. A degenerate or
// non-finite cell makes R infinite or NaN, and a NaN never drops (the test
// is !(gap > bound)). Slots stay in ascending column order, cnt counts every
// valid column, as before the cut. The CPU twin (neighbor_kernel
// window_table_compact) runs the cut and the prefilter as written here.
//
// Bit-exactness: same expression order as the Pallas kernels, built with
// --fmad=false, so cutoff tests equal the plain PyTorch version's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// Step 3 for one center and this lane's column cd (x, y, z, species):
// the exact test (cand: the column may pair with the center at all), then
// one ballot orders the center's valid columns of the round; a valid one
// goes to the center's tile row at count + rank.
__device__ __forceinline__ void test_slot(const float4& cd, bool cand,
                                          const float4& ce, int crow,
                                          int sjc, int& count,
                                          const float* cut2, int k_cap,
                                          float4* row, const float* c,
                                          const float* v) {
  const float d2 = dist2(cd.x - ce.x, cd.y - ce.y, cd.z - ce.z, c, v);
  const bool valid = cand && d2 < cut2[(crow < 0 ? 0 : crow) + sjc];
  const unsigned ballot = __ballot_sync(0xffffffffu, valid);
  if (valid) {
    const int rank =
        count + __popc(ballot & ((1u << (threadIdx.x & 31)) - 1u));
    if (rank < k_cap) row[rank] = cd;
  }
  count += __popc(ballot);
}

// Step 3: the warp's CPW centers (center i is the block's warp + 4i) against
// staged columns [0, staged), 32 a round: each lane reads its column once
// and tests it against every center (independent chains). pair_of(k) gives
// staged column k's own pair test, a functor of the center i (#3: not the
// center itself; #4: the prefilter, then not the center's own column). With
// SKIP (#4, whose prefilter leaves few candidates), a center for which no
// lane of the warp holds one skips the exact test, whose ballot would be
// empty; without it (#3) the rounds stay branch-free. cv holds the cell,
// then its inverse.
template <int CPW, bool SKIP, class PairOf>
__device__ __forceinline__ void test_rounds(
    const float4* stage, int staged, const float4 (&ce)[CPW],
    const int (&crow)[CPW], int (&count)[CPW], const float* cut2, int k_cap,
    float4* tile, const float* cv, const PairOf& pair_of) {
  const int warp = threadIdx.x >> 5;
  float c[9], v[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    c[e] = cv[e];
    v[e] = cv[9 + e];
  }
  for (int base = 0; base < staged; base += 32) {
    const int k = base + (threadIdx.x & 31);
    const int kk = k < staged ? k : staged - 1;
    const float4 cd = stage[kk];
    const auto pair = pair_of(kk);
    const int sj = __float_as_int(cd.w);
    const bool real = k < staged && sj >= 0;
    const int sjc = sj < 0 ? 0 : sj;
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const bool ok = pair(i);  // every lane: no branch around the test
      const bool cand = real && crow[i] >= 0 && ok;
      if (!SKIP || __any_sync(0xffffffffu, cand))
        test_slot(cd, cand, ce[i], crow[i], sjc, count[i], cut2, k_cap,
                  tile + (long long)(warp + SLAB_WARPS * i) * k_cap, c, v);
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

// Step 2's scan: bit i of `mine` keeps this thread's column of step i.
// Returns the block's kept columns of the pass; `excl` is, in lane l, the
// kept columns of the (step, warp) pairs before pair l (pair = step *
// SLAB_WARPS + warp), which every warp scans itself. Ends with every thread
// past a barrier, the counts read.
__device__ __forceinline__ int slab_scan(unsigned mine, int* counts,
                                         int& excl) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
  excl = incl - x;
  return __shfl_sync(0xffffffffu, incl, 31);
}

// Step 2's gather: each kept column of the pass at p0 goes to staging
// place staged + its rank in column order, through gather(place, column).
template <class Gather>
__device__ __forceinline__ void slab_stage(unsigned mine, int excl,
                                           int staged, int p0,
                                           const Gather& gather) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < SLAB_STEPS; ++i) {
    const bool keep = (mine >> i) & 1u;
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    const int at = __shfl_sync(0xffffffffu, excl, i * SLAB_WARPS + warp);
    if (keep)
      gather(staged + at + __popc(b & lt_mask),
             p0 + i * SLAB_THREADS + (int)threadIdx.x);
  }
}

// Step 4: the block's `rows` rows from the tile, each output one contiguous
// range written coalesced, slots past a row's count as 0 and -1.
__device__ __forceinline__ void write_rows(const float4* tile,
                                           const int* ccount, int rows,
                                           int k_cap, float* pos_out,
                                           int* sp_out, int* cnt_out) {
  const int tid = threadIdx.x;
  const int slots = rows * k_cap;
  const float* tile_f = (const float*)tile;
  for (int e = tid; e < 3 * slots; e += SLAB_THREADS) {
    const int slot = e / 3;
    const int q = slot / k_cap;
    pos_out[e] = slot - q * k_cap < ccount[q]
                     ? tile_f[4 * slot + (e - 3 * slot)] : 0.f;
  }
  for (int e = tid; e < slots; e += SLAB_THREADS) {
    const int q = e / k_cap;
    sp_out[e] = e - q * k_cap < ccount[q] ? __float_as_int(tile[e].w) : -1;
  }
  if (tid < rows) cnt_out[tid] = ccount[tid];
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
    // the pair test: not the center itself, by global index
    const auto not_self = [&](int k) {
      const float g = gid[k];
      return [&, g](int i) { return g != ce[i].w; };
    };
    int staged = 0;
    for (int p0 = 0; p0 < width; p0 += SLAB_PASS) {
      // 2. compaction
      const unsigned mine =
          slab_keep_mask(keys, p0, width, w, delta, qlo, qhi);
      int excl;
      const int kept = slab_scan(mine, counts, excl);
      if (staged + kept > cap) {  // block-uniform
        test_rounds<CPW, false>(stage, staged, ce, crow, count, cut2, k_cap,
                                tile, cv, not_self);
        staged = 0;
        __syncthreads();
      }
      slab_stage(mine, excl, staged, p0, [&](int k, int col) {
        const long long j = col + delta[(col >= w) + (col >= 2 * w)];
        stage[k] = make_float4(a.cand[j], a.cand[(long long)a.m2 + j],
                               a.cand[2LL * a.m2 + j],
                               __int_as_float((int)a.cand[3LL * a.m2 + j]));
        gid[k] = a.cand[4LL * a.m2 + j];
      });
      __syncthreads();
      staged += kept;
    }
    // 3. what is left staged
    if (staged > 0)
      test_rounds<CPW, false>(stage, staged, ce, crow, count, cut2, k_cap,
                              tile, cv, not_self);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int q = warp + SLAB_WARPS * i;
      if (q < cpb) ccount[q] = count[i];
    }
  }
  __syncthreads();

  // 4. the block's rows
  int* sp_all = (int*)(a.out + 3LL * a.m * k_cap);
  write_rows(tile, ccount, cpb, k_cap, a.out + first * k_cap * 3,
             sp_all + first * k_cap, sp_all + (long long)a.m * k_cap + first);
}

// Kernel #4's launch arguments. out: one allocation of n * (4K + 1) 32-bit
// words, nbr_pos f32[n, K, 3], then nbr_sp i32[n, K], then cnt i32[n].
struct WindowArgs {
  const float* pos;
  const int* sp;
  const float* cell;
  const float* inv;
  const float* cutoff;
  float* out;
  int n, n_species, k_cap, chunk, window;
};

struct WindowShape {
  int cpb;      // centers a block
  int cpw;      // centers a warp: 1, 2 or 4
  int bpc;      // blocks a chunk
  int blocks;   // blocks of the grid
  int cap;      // staged columns
  size_t smem;  // dynamic shared bytes: staging, prefilter, tile, cut^2
};

WindowShape window_shape(int n, int chunk, int k_cap, int window,
                         int n_species) {
  WindowShape s;
  int cpb = k_cap > 0 ? SLAB_TILE_SLOTS / k_cap : SLAB_MAX_CPB;
  cpb = cpb < SLAB_MAX_CPB ? cpb : SLAB_MAX_CPB;
  cpb = cpb < chunk ? cpb : chunk;
  s.cpb = cpb > 1 ? cpb : 1;
  s.cpw = s.cpb <= SLAB_WARPS ? 1 : s.cpb <= 2 * SLAB_WARPS ? 2 : 4;
  s.bpc = (chunk + s.cpb - 1) / s.cpb;
  s.blocks = (n / chunk) * s.bpc + (n % chunk + s.cpb - 1) / s.cpb;
  const int width = chunk + 2 * window;
  s.cap = width < SLAB_PASS ? width : SLAB_PASS;
  s.smem = (size_t)s.cap * 32 + (size_t)s.cpb * k_cap * 16 +
           (size_t)n_species * n_species * 4;
  return s;
}

constexpr double CUT_SLACK = 1.0 / (1 << 20);  // 2^-20 = 16u (header)

// u and s of the cuts (header) for the row at p along the axis whose
// column of the inverse cell is (v0, v1, v2)
__device__ __forceinline__ void frac(const float* p, double v0, double v1,
                                     double v2, double& u, double& s) {
  const double x0 = (double)p[0] * v0;
  const double x1 = (double)p[1] * v1;
  const double x2 = (double)p[2] * v2;
  u = (x0 + x1) + x2;
  s = (fabs(x0) + fabs(x1)) + fabs(x2);
}

__device__ __forceinline__ double norm3(double x, double y, double z) {
  return sqrt((x * x + y * y) + z * z);
}

// Kernel #4 (header): block b takes rows [first, first + rows) of chunk
// b / bpc, whose window is columns [0, chunk + 2W), column col being sorted
// row c0 - W + col brought into [0, n).
template <int CPW>
__global__ void __launch_bounds__(SLAB_THREADS, 4)
window_table_kernel(const WindowArgs a, int cpb, int bpc, int cap) {
  extern __shared__ float4 smem[];
  const int k_cap = a.k_cap, n_species = a.n_species, n = a.n;
  float4* stage = smem;                           // [cap] x, y, z, species
  float4* fr = stage + cap;                       // [cap] prefilter, column
  float4* tile = fr + cap;                        // [cpb * K] slots
  float* cut2 = (float*)(tile + (long long)cpb * k_cap);  // [S * S]
  __shared__ int ccount[SLAB_MAX_CPB];
  __shared__ int counts[32];  // kept columns of each (step, warp)
  __shared__ float cv[18];    // cell, then inverse
  __shared__ double arc[3];   // mid, half, smax of the live centers
  __shared__ double reach[3];  // R of the header along x, y, z

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ch = blockIdx.x / bpc;
  const int q0 = (blockIdx.x - ch * bpc) * cpb;
  const int c0 = ch * a.chunk;
  const long long first = (long long)c0 + q0;
  int rows = a.chunk - q0 < cpb ? a.chunk - q0 : cpb;
  rows = n - (int)first < rows ? n - (int)first : rows;

  // 1. centers (w: the center's own column), cell, squared cutoffs
  float4 ce[CPW];
  int crow[CPW], count[CPW];
  bool live = false;
#pragma unroll
  for (int i = 0; i < CPW; ++i) {
    const int q = warp + SLAB_WARPS * i;
    ce[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    crow[i] = -1;
    count[i] = 0;
    if (q < rows) {
      const long long r = first + q;
      const int sp = a.sp[r];
      ce[i] = make_float4(a.pos[3 * r], a.pos[3 * r + 1], a.pos[3 * r + 2],
                          (float)(a.window + q0 + q));
      crow[i] = sp >= 0 ? sp * n_species : -1;
      live = live || sp >= 0;
    }
  }
  if (tid >= 64 && tid < 82) {
    const int e = tid - 64;
    cv[e] = e < 9 ? a.cell[e] : a.inv[e - 9];
  }
  for (int e = tid; e < n_species * n_species; e += SLAB_THREADS) {
    const float cf = a.cutoff[e];
    cut2[e] = cf * cf;
  }
  if (warp == 0) {  // the arc of the live centers' fractional x
    double u = 0.0, s = 0.0;
    bool on = false;
    if (lane < rows) {
      const long long r = first + lane;
      on = a.sp[r] >= 0;
      if (on) frac(a.pos + 3 * r, a.inv[0], a.inv[3], a.inv[6], u, s);
    }
    const unsigned on_mask = __ballot_sync(0xffffffffu, on);
    if (on_mask) {  // warp-uniform
      const double anchor = __shfl_sync(0xffffffffu, u, __ffs(on_mask) - 1);
      double d = u - anchor;
      d = d - rint(d);
      double lo = on ? d : INFINITY, hi = on ? d : -INFINITY;
      s = on ? s : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo = fmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = fmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        s = fmax(s, __shfl_xor_sync(0xffffffffu, s, o));
      }
      if (lane == 0) {
        arc[0] = anchor + 0.5 * (lo + hi);
        arc[1] = 0.5 * (hi - lo);
        arc[2] = s;
      }
    }
  } else if (warp == 1) {  // the reach R
    float m2 = 0.f;
    for (int e = lane; e < n_species * n_species; e += 32) {
      const float cf = a.cutoff[e];
      m2 = fmaxf(m2, cf * cf);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m2 = fmaxf(m2, __shfl_xor_sync(0xffffffffu, m2, o));
    if (lane == 0) {
      double c[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) c[e] = a.cell[e];
      // rows' cross products: b x c, c x a, a x b
      const double x[3][3] = {
          {c[4] * c[8] - c[5] * c[7], c[5] * c[6] - c[3] * c[8],
           c[3] * c[7] - c[4] * c[6]},
          {c[7] * c[2] - c[8] * c[1], c[8] * c[0] - c[6] * c[2],
           c[6] * c[1] - c[7] * c[0]},
          {c[1] * c[5] - c[2] * c[4], c[2] * c[3] - c[0] * c[5],
           c[0] * c[4] - c[1] * c[3]}};
      const double det =
          fabs((c[0] * x[0][0] + c[1] * x[0][1]) + c[2] * x[0][2]);
      const double l = (norm3(c[0], c[1], c[2]) + norm3(c[3], c[4], c[5])) +
                       norm3(c[6], c[7], c[8]);
      const double rc = sqrt((double)m2);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        reach[k] = (rc + CUT_SLACK * (rc + l)) /
                   (det / norm3(x[k][0], x[k][1], x[k][2]));
    }
  }

  if (__syncthreads_or(live)) {
    const double v0 = cv[9], v3 = cv[12], v6 = cv[15];
    const double mid = arc[0], half = arc[1], smax = arc[2], r0 = reach[0];
    // the centers' prefilter values: fractional y and z, thresholds
    float4 cf[CPW];
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const float p[3] = {ce[i].x, ce[i].y, ce[i].z};
      double uy, sy, uz, sz;
      frac(p, cv[10], cv[13], cv[16], uy, sy);
      frac(p, cv[11], cv[14], cv[17], uz, sz);
      cf[i] = make_float4((float)uy, (float)uz,
                          (float)(reach[1] + CUT_SLACK * sy),
                          (float)(reach[2] + CUT_SLACK * sz));
    }
    // the pair test (header): a staged column's fr holds its fractional y
    // and z (f32), 2^-20 times the larger of its s_y, s_z, and its column;
    // the pair is near when within the center's y and z thresholds, and a
    // candidate when near and not the center's own column
    const auto near = [&](int k) {
      const float4 f = fr[k];
      return [&, f](int i) {
        float ty = f.x - cf[i].x;
        ty = fabsf(ty - rintf(ty));
        float tz = f.y - cf[i].y;
        tz = fabsf(tz - rintf(tz));
        return !(ty > cf[i].z + f.z) && !(tz > cf[i].w + f.z) &&
               f.w != ce[i].w;
      };
    };
    const int width = a.chunk + 2 * a.window;
    const int row0 = c0 - a.window;  // row of column 0, before the wrap
    auto row_of = [&](int col) {
      const int r = row0 + col;
      return r < 0 ? r + n : r >= n ? r - n : r;
    };
    int staged = 0;
    for (int p0 = 0; p0 < width; p0 += SLAB_PASS) {
      // 2. compaction: real columns within reach of the arc; every load
      // of the pass is issued before any test (no branch guards them)
      unsigned mine = 0;
#pragma unroll
      for (int i = 0; i < SLAB_STEPS; ++i) {
        const int col = p0 + i * SLAB_THREADS + tid;
        const int r = row_of(col < width ? col : width - 1);
        const int sj = a.sp[r];
        double u, s;
        frac(a.pos + 3LL * r, v0, v3, v6, u, s);
        const double t = u - mid;
        const double gap = fabs(t - rint(t)) - half;
        if (col < width && sj >= 0 && !(gap > r0 + CUT_SLACK * (s + smax)))
          mine |= 1u << i;
      }
      int excl;
      const int kept = slab_scan(mine, counts, excl);
      if (staged + kept > cap) {  // block-uniform
        test_rounds<CPW, true>(stage, staged, ce, crow, count, cut2, k_cap,
                               tile, cv, near);
        staged = 0;
        __syncthreads();
      }
      slab_stage(mine, excl, staged, p0, [&](int k, int col) {
        const long long r = row_of(col);
        const float* p = a.pos + 3 * r;
        stage[k] = make_float4(p[0], p[1], p[2], __int_as_float(a.sp[r]));
        double uy, sy, uz, sz;
        frac(p, cv[10], cv[13], cv[16], uy, sy);
        frac(p, cv[11], cv[14], cv[17], uz, sz);
        fr[k] = make_float4((float)uy, (float)uz,
                            (float)(CUT_SLACK * fmax(sy, sz)), (float)col);
      });
      __syncthreads();
      staged += kept;
    }
    // 3. what is left staged
    if (staged > 0)
      test_rounds<CPW, true>(stage, staged, ce, crow, count, cut2, k_cap,
                             tile, cv, near);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int q = warp + SLAB_WARPS * i;
      if (q < rows) ccount[q] = count[i];
    }
  }
  __syncthreads();

  // 4. the block's rows
  int* sp_all = (int*)(a.out + 3LL * n * k_cap);
  write_rows(tile, ccount, rows, k_cap, a.out + first * k_cap * 3,
             sp_all + first * k_cap, sp_all + (long long)n * k_cap + first);
}

// Launches `kernel` on `blocks` blocks (dynamic shared bytes past 48 KB
// allowed first).
template <class Kern, class... Args>
cudaError_t run(Kern kernel, int blocks, size_t smem, cudaStream_t stream,
                Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (blocks > 0)
    kernel<<<blocks, SLAB_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// a kernel's attributes at `smem` dynamic bytes: registers, static shared
// bytes, resident blocks per SM
template <class Kern>
cudaError_t attributes(Kern kernel, size_t smem, int* out) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      SLAB_THREADS, smem);
  if (e != cudaSuccess) return e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

}  // namespace

// Kernel #4. out: n * (4K + 1) 32-bit words (see WindowArgs).
extern "C" int window_table_launch(const void* pos, const void* sp,
                                   const void* cell, const void* inv_cell,
                                   const void* cutoff, void* out, int n,
                                   int n_species, int k_cap, int chunk,
                                   int window, void* stream) {
  if (n <= 0) return 0;
  const WindowArgs a = {(const float*)pos,    (const int*)sp,
                        (const float*)cell,   (const float*)inv_cell,
                        (const float*)cutoff, (float*)out,
                        n, n_species, k_cap, chunk, window};
  const WindowShape s = window_shape(n, chunk, k_cap, window, n_species);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(s.cpw == 1 ? run(window_table_kernel<1>, s.blocks, s.smem, st,
                                a, s.cpb, s.bpc, s.cap)
               : s.cpw == 2 ? run(window_table_kernel<2>, s.blocks, s.smem,
                                  st, a, s.cpb, s.bpc, s.cap)
                            : run(window_table_kernel<4>, s.blocks, s.smem,
                                  st, a, s.cpb, s.bpc, s.cap));
}

// Kernel #4's launch for (n, chunk, K, W, species) on the current card,
// eleven ints: blocks, threads a block, centers a block, centers a warp,
// blocks a chunk, staged columns, columns a pass, dynamic shared bytes,
// registers a thread, static shared bytes, resident blocks per SM
extern "C" int window_table_geometry(int n, int chunk, int k_cap, int window,
                                     int n_species, void* out) {
  int* o = (int*)out;
  const WindowShape s = window_shape(n, chunk, k_cap, window, n_species);
  o[0] = s.blocks;
  o[1] = SLAB_THREADS;
  o[2] = s.cpb;
  o[3] = s.cpw;
  o[4] = s.bpc;
  o[5] = s.cap;
  o[6] = SLAB_PASS;
  o[7] = (int)s.smem;
  return (int)(s.cpw == 1   ? attributes(window_table_kernel<1>, s.smem, o + 8)
               : s.cpw == 2 ? attributes(window_table_kernel<2>, s.smem, o + 8)
                            : attributes(window_table_kernel<4>, s.smem, o + 8));
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
  const int blocks = m / s.cpb;
  return (int)(s.cpw == 1 ? run(window_table_slab_kernel<1>, blocks, s.smem,
                                st, a, s.cpb, s.cap)
               : s.cpw == 2 ? run(window_table_slab_kernel<2>, blocks,
                                  s.smem, st, a, s.cpb, s.cap)
                            : run(window_table_slab_kernel<4>, blocks,
                                  s.smem, st, a, s.cpb, s.cap));
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
  return (int)(s.cpw == 1 ? attributes(window_table_slab_kernel<1>, s.smem,
                                       o + 7)
               : s.cpw == 2 ? attributes(window_table_slab_kernel<2>, s.smem,
                                         o + 7)
                            : attributes(window_table_slab_kernel<4>, s.smem,
                                         o + 7));
}
