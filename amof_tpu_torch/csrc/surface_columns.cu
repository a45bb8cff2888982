// Surface-point blocker test of the batched pore step (-sa), for Hopper.
//
// Replaces the Pallas TPU kernel amof_tpu/pore/surface_kernel.py
// surface_valid_columns_pallas (kernel #6). Atoms are sorted by coarse xy
// column (width >= the blocker reach R_i + R_j + 2 probe), candidate atoms
// first within each column, each part sorted by fz; a slot is `chunk`
// consecutive centers of one column and is active when it holds a
// candidate. For every center i of an active slot and every direction k:
// the point p = c_i + (R_i + probe) dir_k, the linear voxel index of p and
// of its outward nudge, and valid = d2(p, j) > (R_j + probe - 1e-4)^2 for
// every blocker j of the column's three runs except i itself
// (self-exclusion by original atom index). Blockers are unwrapped to the
// slot's column frame in x/y; z is minimum-imaged per pair from the
// point's fractional z. Every other row (inactive slots, rows past
// n_z * chunk of a column over col_cap, rows outside every column) is
// written False / 0 here, so the wrapper's outputs need no clearing.
//
// Design. Work comes in groups of consecutive centers of one active slot:
// its nc candidates in min(nc, P) groups of near-equal size (P = chunk /
// G), then its other centers in groups of G (G = 32 / K, 1 to 32: 4 at
// K = 8), so each group is sorted in z and few candidates spread over z go
// one or two a group. A persistent grid of 128-thread blocks (7 an SM, 64
// registers; 924 on an H100) counts the groups column by column in its
// prologue (a prefix in shared memory) and strides over them, so every
// block gets one or two groups whatever the slots hold. For a group the
// block scans its column's runs, 768 rows a round (fz and radius first,
// the other fields only for the rows it keeps), keeps the rows within z
// reach (below), and stages them unwrapped to Cartesian with their
// squared thresholds, 1024 at most (24 KB); wider reaches flush the
// staged rows first, and a later flush reads back what the first wrote.
// (A scan, not kernel #5's binary search on the sort keys: a search
// needs the runs' largest radius first, and took no fewer load rounds.)
// Each (center, direction) item gets as many lanes of the block as its
// items allow (4 at K = 8, up to a warp); they stride over the staged
// rows, four independent tests a step (padded with rows
// that never block, so no test branches), and a warp leaves once each of
// its items has a blocker or has run out of rows (ballot a step). The AND
// over rows is order-free, so neither the staging order nor the exit
// changes a result.
//
// The z cut. With [a, b] the group's fractional z range (its centers' fz),
// P the largest |R_i + probe| |dir_k| of its points, t_j = |R_j + probe -
// 1e-4|, h_z = |c.(a x b)| / |a x b| the spacing of the z lattice planes
// and mu = 0.05 A + 1e-3 L (L = |a| + |b| + |c|), as kernel #5 takes them,
// a row is dropped only when its periodic fractional distance to [a, b]
// is at least (t_j + P + mu) / h_z + SIGMA (SIGMA = 2^-20). Why no dropped
// row can block a point: let n be the unit normal of the a-b plane. The
// difference the kernel forms is D = p - w_j - s c (w_j the xy-unwrapped
// blocker, s = rint(fpz - fz_j) any integer), and n.D = h_z (fz_i - fz_j -
// s) + (R_i + probe) n.dir_k up to rounding: the xy unwrap moves w_j along
// a and b only, which n does not see. So |D| >= |n.D| >= h_z dist(fz_i,
// fz_j) - P - e >= t_j + mu - e', where dist is the periodic distance
// (fz_i lies in [a, b]) and e, e' collect the rounding of the f32 point,
// center, blocker and cut arithmetic: a few eps L (eps = 2^-24; SIGMA
// absorbs the rounding of the fractional compare). The compare is on
// those Cartesian differences, rounded component by component and
// squared: its error is ~20 eps L^2 at most, below mu^2 >= 1e-6 L^2, and
// the threshold (R_j + probe - 1e-4)^2 = t_j^2 rounds by 2 eps. So the
// computed d2 exceeds the threshold for every dropped row, and validity
// equals that over all rows (the atom itself never blocks: its threshold
// is -1). A reach of half the cell or more in z keeps every row; a
// degenerate cell (h_z = 0) keeps every row.
//
// What bounds it on the card: f32 operations, ~19 per (point, blocker)
// test (one rintf on the conversion pipe) plus two shared loads (float4,
// float2), over the rows kept by the z cut (~250 of ~1140 at bench shapes)
// and up to each item's first blocker; outputs are 9 B per row and
// direction. No tensor cores: the work is exact f32 compares, with no
// product that wgmma could take. What bounds it in fact is latency: a
// group's set-up (the scan's load rounds, the staging) takes longer than
// its tests, and registers (64 a thread) and shared memory (28 KB a
// block) cap an SM at 7 blocks, so each block runs its groups in turn.
//
// Bit-exactness: the reference's expression order (the XLA column path
// grid_kernel.surface_valid_columns), rintf, built with --fmad=false, so
// validity and indices equal the plain PyTorch version
// (grid_kernel.surface_valid_tiles_plain); grid_kernel.surface_z_window is
// the plain twin of the cut and grid_kernel.surface_groups of the groups.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 8;  // caps registers at 64 a thread
constexpr int U = 4;           // rows a lane tests per ballot
constexpr int R = 6;           // rows a thread scans per load round
constexpr int CHUNK = THREADS * R;  // rows a block scans per round
constexpr int CAP = 1024;      // staged rows (24 KB of shared memory)
constexpr int PAD = 32 * U;    // rows that round a flush up to whole steps
constexpr int MAX_GROUP = 32;
constexpr int MAX_COLS = 8192;  // columns (dynamic shared memory, 32 KB)
constexpr float SIGMA = 9.5367431640625e-07f;  // 2^-20

__device__ __forceinline__ int axis_idx(float f, int g) {
  f = f - floorf(f);
  return min((int)(f * (float)g), g - 1);
}

__device__ __forceinline__ int lin_idx(float fx, float fy, float fz, int gx,
                                       int gy, int gz) {
  return (axis_idx(fx, gx) * gy + axis_idx(fy, gy)) * gz + axis_idx(fz, gz);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const float* centers;
  int n;
  const int* c_bounds;
  const int* cand_end;
  int n_cols, n_z, chunk, group;
  const float* blockers;
  int m_rows;
  const int* b_start;
  const int* b_count;
  int nbx, nby;
  const float* cell;
  const float* inv;
  const float* dirs;
  const float* nudge;
  int k_dirs;
  float rp, peps;
  int gx, gy, gz;
  uint8_t* valid;
  int* ipt;
  int* inu;
};

// Rows outside every active slot: False and index 0. That includes rows
// outside every column, before c_bounds[0] or from c_bounds[n_cols] on
// (no layout the wrapper builds has them; cand_end has no entry there).
__device__ void clear_inactive(const Args& p, int a) {
  int lo = 0, hi = p.n_cols + 1;  // last column start <= a
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.c_bounds[mid] <= a) lo = mid + 1; else hi = mid;
  }
  const int col = lo - 1;
  if (col >= 0 && col < p.n_cols) {
    const int zs = (a - p.c_bounds[col]) / p.chunk;
    if (zs < p.n_z && p.c_bounds[col] + zs * p.chunk < p.cand_end[col])
      return;
  }
  const long long o = (long long)a * p.k_dirs;
  for (int k = 0; k < p.k_dirs; ++k) {
    p.valid[o + k] = 0;
    p.ipt[o + k] = 0;
    p.inu[o + k] = 0;
  }
}

// Groups of column `col`: each active slot's nc candidates in
// min(nc, places) groups of near-equal size (few candidates spread over z
// go one or two a group), then its other centers in groups of `group`.
// With r >= 0, also the bounds [g0, g1) of the column's group r.
__device__ int column_groups(const Args& p, int places, int col, int r,
                             int* g0, int* g1) {
  const int cb = p.c_bounds[col], cb1 = p.c_bounds[col + 1];
  const int ce = p.cand_end[col];
  int count = 0;
  for (int zs = 0; zs < p.n_z; ++zs) {
    const int lo = cb + zs * p.chunk;
    const int hi = min(lo + p.chunk, cb1);
    if (lo >= hi || lo >= ce) break;  // so is every later slot
    const int nc = min(hi, ce) - lo;
    const int ncg = min(nc, places);
    const int ng = ncg + (hi - lo - nc + p.group - 1) / p.group;
    if (r >= count && r < count + ng) {
      const int gi = r - count;
      if (gi < ncg) {
        *g0 = lo + gi * nc / ncg;
        *g1 = lo + (gi + 1) * nc / ncg;
      } else {
        *g0 = lo + nc + (gi - ncg) * p.group;
        *g1 = min(*g0 + p.group, hi);
      }
    }
    count += ng;
  }
  return count;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    surface_columns_kernel(Args p) {
  __shared__ float4 s_pos[CAP + PAD];    // staged rows: wx, wy, wz, th
  __shared__ float2 s_aux[CAP + PAD];    // fz, atom index
  extern __shared__ int s_pre[];         // groups before each column
  __shared__ float s_cen[5][MAX_GROUP];  // the group's centers
  __shared__ float s_grp[3];             // za, zb, reach_add
  __shared__ int s_n;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = p.n, m = p.m_rows;

  // z-plane spacing h_z and margin mu, in double from the f32 cell
  const float* c = p.cell;
  const double n0 = (double)c[1] * c[5] - (double)c[2] * c[4];
  const double n1 = (double)c[2] * c[3] - (double)c[0] * c[5];
  const double n2 = (double)c[0] * c[4] - (double)c[1] * c[3];
  const double hz = fabs(n0 * c[6] + n1 * c[7] + n2 * c[8]) /
                    sqrt(n0 * n0 + n1 * n1 + n2 * n2);
  const double len =
      sqrt((double)c[0] * c[0] + (double)c[1] * c[1] + (double)c[2] * c[2]) +
      sqrt((double)c[3] * c[3] + (double)c[4] * c[4] + (double)c[5] * c[5]) +
      sqrt((double)c[6] * c[6] + (double)c[7] * c[7] + (double)c[8] * c[8]);
  const double mu = 0.05 + 1e-3 * len;
  const bool cut = hz > 0.0;
  const float inv_hz = cut ? (float)(1.0 / hz) : INFINITY;
  double dn = 0.0;  // largest |dir_k|
  for (int k = lane; k < p.k_dirs; k += 32) {
    const double x = p.dirs[3 * k], y = p.dirs[3 * k + 1],
                 z = p.dirs[3 * k + 2];
    dn = fmax(dn, sqrt(x * x + y * y + z * z));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    dn = fmax(dn, __shfl_xor_sync(0xffffffffu, dn, o));

  // every group of the frame, numbered column by column; the grid
  // strides over them
  const int places = (p.chunk + p.group - 1) / p.group;
  for (int col = tid; col < p.n_cols; col += THREADS)
    s_pre[col + 1] = column_groups(p, places, col, -1, nullptr, nullptr);
  __syncthreads();
  if (tid < 32) {  // inclusive scan of s_pre[1..n_cols]
    int carry = 0;
    for (int b = 0; b < p.n_cols; b += 32) {
      int v = b + lane < p.n_cols ? s_pre[b + lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      if (b + lane < p.n_cols) s_pre[b + lane + 1] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) s_pre[0] = 0;
  }
  __syncthreads();
  const int n_groups = s_pre[p.n_cols];
  for (int w = blockIdx.x; w < n_groups; w += gridDim.x) {
    int lo_c = 0, hi_c = p.n_cols;  // the column: s_pre[col] <= w
    while (lo_c < hi_c) {
      const int mid = (lo_c + hi_c + 1) >> 1;
      if (s_pre[mid] <= w) lo_c = mid; else hi_c = mid - 1;
    }
    const int col = lo_c;
    int g0 = 0, g1 = 0;
    column_groups(p, places, col, w - s_pre[col], &g0, &g1);
    const int ng = g1 - g0;
    const int ci = col / p.nby, cj = col % p.nby;
    const float ucx = ((float)ci + 0.5f) / (float)p.nbx;
    const float ucy = ((float)cj + 0.5f) / (float)p.nby;

    // warp 0: the group's centers, z range [za, zb] and point reach
    if (tid < 32) {
      float za = INFINITY, zb = -INFINITY, rxm = 0.0f;
      if (lane < ng) {
#pragma unroll
        for (int i = 0; i < 5; ++i)
          s_cen[i][lane] = p.centers[i * n + g0 + lane];
        za = zb = s_cen[2][lane];
        rxm = fabsf(s_cen[3][lane] + p.rp);
      }
      za = warp_min(za);
      zb = warp_max(zb);
      rxm = warp_max(rxm);
      if (lane == 0) {
        s_grp[0] = za;
        s_grp[1] = zb;
        s_grp[2] = (float)((double)rxm * dn + mu);
        s_n = 0;
      }
    }
    // the column's three runs [st, st + cnt)
    const int st0 = p.b_start[3 * col], st1 = p.b_start[3 * col + 1],
              st2 = p.b_start[3 * col + 2];
    const int n0r = p.b_count[3 * col], n1r = p.b_count[3 * col + 1];
    const int total = n0r + n1r + p.b_count[3 * col + 2];
    __syncthreads();
    const float za = s_grp[0], zb = s_grp[1], reach_add = s_grp[2];

    const int n_items = ng * p.k_dirs;
    // lanes per item: as many as the block's threads allow, up to a warp
    int lanes = 32;
    while (lanes > 1 && lanes * n_items > THREADS) lanes >>= 1;
    const int items = THREADS / lanes;  // a round of items
    const int li = tid & (lanes - 1);
    const int gsh = lane & ~(lanes - 1);
    const unsigned gmask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;

    // the items against the rows staged so far; a later flush ANDs into
    // what the first wrote
    auto flush = [&](int rows, bool first) {
      // rows that never block (threshold -1, no atom) round the staged
      // rows up to whole steps of the items' lanes
      const int step = lanes * U;
      const int padded = (rows + step - 1) / step * step;
      for (int j = rows + tid; j < padded; j += THREADS) {
        s_pos[j] = make_float4(0.0f, 0.0f, 0.0f, -1.0f);
        s_aux[j] = make_float2(0.0f, -2.0f);
      }
      __syncthreads();
      for (int ib = 0; ib < n_items; ib += items) {
        const int it = ib + tid / lanes;
        const bool live = it < n_items;
        float px = 0.0f, py = 0.0f, pz = 0.0f, fpz = 0.0f, cg = -1.0f;
        long long o = 0;
        bool ok = true;
        if (live) {
          const int al = it / p.k_dirs;
          const int k = it % p.k_dirs;
          const float fx = s_cen[0][al], fy = s_cen[1][al];
          const float fz = s_cen[2][al], ra = s_cen[3][al];
          cg = s_cen[4][al];
          const float fxu = fx - rintf(fx - ucx);
          const float fyu = fy - rintf(fy - ucy);
          const float ccx = fxu * c[0] + fyu * c[3] + fz * c[6];
          const float ccy = fxu * c[1] + fyu * c[4] + fz * c[7];
          const float ccz = fxu * c[2] + fyu * c[5] + fz * c[8];
          const float rx = ra + p.rp;
          px = ccx + rx * p.dirs[3 * k];
          py = ccy + rx * p.dirs[3 * k + 1];
          pz = ccz + rx * p.dirs[3 * k + 2];
          const float* ic = p.inv;
          const float fpx = px * ic[0] + py * ic[3] + pz * ic[6];
          const float fpy = px * ic[1] + py * ic[4] + pz * ic[7];
          fpz = px * ic[2] + py * ic[5] + pz * ic[8];
          o = (long long)(g0 + al) * p.k_dirs + k;
          if (first) {
            if (li == 0) {
              p.ipt[o] = lin_idx(fpx, fpy, fpz, p.gx, p.gy, p.gz);
              p.inu[o] = lin_idx(fpx + p.nudge[3 * k],
                                 fpy + p.nudge[3 * k + 1],
                                 fpz + p.nudge[3 * k + 2], p.gx, p.gy, p.gz);
            }
          } else {
            ok = p.valid[o] != 0;
          }
        }
        // rows strided over the item's lanes; stop at the first blocker
        const float c6 = c[6], c7 = c[7], c8 = c[8];
        bool done = !(live && ok);
        for (int j0 = 0; j0 < padded; j0 += step) {
          if (!done) {
            bool pass = true;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int j = j0 + u * lanes + li;
              const float4 w4 = s_pos[j];
              const float2 x2 = s_aux[j];
              const float zsh = rintf(fpz - x2.x);
              const float dx = px - w4.x - zsh * c6;
              const float dy = py - w4.y - zsh * c7;
              const float dz = pz - w4.z - zsh * c8;
              const float d2 = dx * dx + dy * dy + dz * dz;
              const float te = x2.y == cg ? -1.0f : w4.w;
              pass = pass & (d2 > te);
            }
            ok = ok && pass;
          }
          const unsigned blocked = __ballot_sync(0xffffffffu, !ok);
          done = done || ((blocked >> gsh) & gmask) != 0u;
          if (__all_sync(0xffffffffu, done)) break;
        }
        const unsigned blocked = __ballot_sync(0xffffffffu, !ok);
        if (live && li == 0)
          p.valid[o] = (uint8_t)(((blocked >> gsh) & gmask) == 0u);
      }
    };

    // stage the rows within z reach of the group, CHUNK scanned a round
    // (all five fields in one load round); flush before the staged rows
    // could overflow
    bool first = true;
    int bound = 0;  // rows staged at most
    for (int q0 = 0; q0 < total; q0 += CHUNK) {
      if (bound + CHUNK > CAP) {
        __syncthreads();
        bound = s_n;
        if (bound + CHUNK > CAP) {
          flush(bound, first);
          first = false;
          __syncthreads();  // every item read the rows and wrote valid
          if (tid == 0) s_n = 0;
          __syncthreads();
          bound = 0;
        }
      }
      int row[R];
      float bz[R], t[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {  // fz and radius of every row
        const int q = q0 + r * THREADS + tid;
        row[r] = -1;
        if (q < total) {
          row[r] = q < n0r ? st0 + q
                   : q < n0r + n1r ? st1 + (q - n0r)
                                   : st2 + (q - n0r - n1r);
          bz[r] = p.blockers[2 * m + row[r]];
          t[r] = p.blockers[3 * m + row[r]] + p.peps;
        }
      }
      bool keep[R];
      unsigned kept[R];
      int n_kept = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        keep[r] = row[r] >= 0;
        if (keep[r] && cut) {
          float d = 0.0f;
          if (bz[r] < za) d = za - bz[r]; else if (bz[r] > zb) d = bz[r] - zb;
          d = fminf(d, fminf(bz[r] + 1.0f - zb, za + 1.0f - bz[r]));
          keep[r] = !(d >= (fabsf(t[r]) + reach_add) * inv_hz + SIGMA);
        }
        kept[r] = __ballot_sync(0xffffffffu, keep[r]);
        n_kept += __popc(kept[r]);
      }
      int at = 0;
      if (lane == 0 && n_kept > 0) at = atomicAdd(&s_n, n_kept);
      at = __shfl_sync(0xffffffffu, at, 0);
      const float* cl = p.cell;
#pragma unroll
      for (int r = 0; r < R; ++r) {  // the rest of the kept rows
        if (keep[r]) {
          const int j = at + __popc(kept[r] & ((1u << lane) - 1u));
          const float bx = p.blockers[row[r]];
          const float by = p.blockers[m + row[r]];
          const float wx = bx - rintf(bx - ucx);
          const float wy = by - rintf(by - ucy);
          s_pos[j] = make_float4(wx * cl[0] + wy * cl[3] + bz[r] * cl[6],
                                 wx * cl[1] + wy * cl[4] + bz[r] * cl[7],
                                 wx * cl[2] + wy * cl[5] + bz[r] * cl[8],
                                 t[r] * t[r]);
          s_aux[j] = make_float2(bz[r], p.blockers[4 * m + row[r]]);
        }
        at += __popc(kept[r]);
      }
      bound += CHUNK;
    }
    __syncthreads();
    flush(s_n, first);
    __syncthreads();  // the next group rewrites the centers and rows
  }
  // the rows outside active slots, last blocks first: they hold fewer
  // groups
  const int rb = (int)gridDim.x - 1 - (int)blockIdx.x;
  for (int a = rb * THREADS + tid; a < n; a += gridDim.x * THREADS)
    clear_inactive(p, a);
}

// Resident blocks of the kernel on the current device with `smem` bytes
// of dynamic shared memory, times its SMs: the persistent grid. Cached by
// device and size (the query is not free on the launch path).
cudaError_t resident_blocks(size_t smem, int* out) {
  static int dev_c = -1, blocks_c = 0;
  static size_t smem_c = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != dev_c || smem != smem_c) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, surface_columns_kernel, THREADS, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    blocks_c = per_sm * sms;
    dev_c = dev;
    smem_c = smem;
  }
  *out = blocks_c;
  return cudaSuccess;
}

// dynamic shared bytes: the groups before each column
size_t smem_of(int n_cols) { return (size_t)(n_cols + 1) * sizeof(int); }

}  // namespace

extern "C" int surface_columns_launch(
    const void* centers, int n, const void* c_bounds, const void* cand_end,
    int n_cols, int n_z, int chunk, int group, const void* blockers,
    int m_rows, const void* b_start, const void* b_count, int nbx, int nby,
    const void* cell, const void* inv, const void* dirs, const void* nudge,
    int k_dirs, float rp, float peps, int gx, int gy, int gz, void* valid,
    void* ipt, void* inu, void* stream) {
  if (n <= 0 || k_dirs <= 0) return 0;
  if (n_cols <= 0 || n_z <= 0 || chunk <= 0 || group < 1 ||
      group > MAX_GROUP || n_cols > MAX_COLS)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t e = resident_blocks(smem_of(n_cols), &blocks);
  if (e != cudaSuccess) return (int)e;
  Args a{(const float*)centers, n, (const int*)c_bounds,
         (const int*)cand_end, n_cols, n_z, chunk, group,
         (const float*)blockers, m_rows, (const int*)b_start,
         (const int*)b_count, nbx, nby, (const float*)cell,
         (const float*)inv, (const float*)dirs, (const float*)nudge, k_dirs,
         rp, peps, gx, gy, gz, (uint8_t*)valid, (int*)ipt, (int*)inu};
  surface_columns_kernel<<<(unsigned)blocks, THREADS, smem_of(n_cols),
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// what the launch gets for `n_cols` columns, six ints: blocks (the
// persistent grid), threads a block, shared bytes (static + dynamic),
// registers a thread, resident blocks per SM, rows a flush of the
// staging holds
extern "C" int surface_columns_geometry(int n_cols, void* out) {
  int* o = (int*)out;
  if (n_cols <= 0 || n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t e = resident_blocks(smem_of(n_cols), &blocks);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, surface_columns_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o[4], surface_columns_kernel, THREADS, smem_of(n_cols));
  if (e != cudaSuccess) return (int)e;
  o[0] = blocks;
  o[1] = THREADS;
  o[2] = (int)(attr.sharedSizeBytes + smem_of(n_cols));
  o[3] = attr.numRegs;
  o[5] = CAP;
  return 0;
}
