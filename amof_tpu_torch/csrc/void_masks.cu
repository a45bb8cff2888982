// Probe/channel void masks and Monte Carlo point fits of the batched pore
// step, for Hopper.
//
// Replaces the Pallas TPU kernel amof_tpu/pore/surface_kernel.py
// void_masks_points_pallas (kernel #5). For every xy tile the candidates
// are the rows of three runs of the column-sorted atom table (the 3x3
// column neighbourhood, y edges duplicated; a run is cut at ``window``
// rows). A voxel is in the probe mask iff d2 >= (R_j + probe)^2 for every
// candidate j (likewise the channel mask), with d2 the factorized
// quadratic of the reference:
//   q  = dfx * a + dfy * b,  QQ = |q|^2,  QZ2 = 2 q.c,  A = |c|^2,
//   u  = dz - rint(dz)  (z minimum image),  d2 = (QQ + A u^2) + u QZ2.
// MC sample points of the tile test d2 >= (R_j + probe)^2 against the same
// candidates, unwrapped to Cartesian positions.
//
// Design: one block per (xy tile, z slab of ZG voxels), so a 16 x 16 tile
// grid of 112 z voxels is 3584 blocks (27 per SM on 132 SMs). The block
// stages in shared memory only the candidate rows within z reach of its
// slab (the "z cut" below), CAP at a time. Each item thread owns items:
// one sub-column of the tile over the slab's ZG voxels, whose QQ and QZ2
// are computed once per candidate and whose ZG results are bits in a
// register, written straight into [gx, gy, gz] order. With MC points the
// block has one more warp, which scans the tile's points, compacts those
// in its slab by ballot into a shared queue and fits them 32 at a time,
// beside the item warps (no lane of an item warp waits on a point). A
// second staging pass, where more than CAP rows are in range, ANDs into
// what the same thread wrote in the first. The second (channel) mask is
// behind a runtime flag, the same for the whole grid; with probe ==
// channel the kernel keeps one mask.
//
// The z cut. Each column's rows are sorted by key = fl(column + fz), so
// rows near the slab in z are a contiguous key range of each of the nine
// column segments of the tile's runs (two subranges where the window wraps
// the periodic z boundary), found by binary search on the keys with the
// run's largest radius; each row in range is then kept or dropped by its
// own radius. A row j is dropped for the slab [za, zb] (fractional z) only
// when its periodic fractional distance to the slab is at least
//   (R_j + thr_hi + mu) / h_z + SIGMA,
// where h_z = |c.(a x b)| / |a x b| is the spacing of the z lattice planes
// and mu = 0.05 A + 1e-3 L (L = |a| + |b| + |c|). Why this drops no row
// that could flip a compare: every voxel center and every MC point the
// block handles lies in [za, zb] (up to ~1e-7 of rounding, which SIGMA =
// 2^-20 absorbs with the rounding of dz), so its minimum-image offset
// obeys |u| >= (R_j + thr_hi + mu) / h_z. The component of q + u c along
// the unit normal of the a-b plane is u h_z, so the exact squared distance
// of the f32 operands is at least (R_j + thr + mu)^2 >= (R_j + thr)^2 +
// mu^2 for each threshold thr <= thr_hi (channel, probe, MC fit). The
// computed d2 is off the exact value by at most ~12 eps (QQ + A u^2) <=
// 4.6e-7 L^2 (eps = 2^-24; |dfx|, |dfy| <= 0.625 bound QQ by (0.625 (|a| +
// |b|))^2 and A u^2 <= |c|^2 / 4), the Cartesian point test by less, and
// the squared thresholds by ~3 eps; mu^2 >= 1e-6 L^2 is twice that bound
// (at the bench cell, L = 164.6 A: mu = 0.215 A, mu^2 = 0.046 A^2 against
// ~1e-3 A^2 of actual rounding). So d2 >= threshold holds for every
// dropped row: the masks and fits equal those over all candidates. The
// key ranges are supersets: a key differs from column + fz by at most half
// an ulp of the largest key (a row whose fz rounds up to the next column
// sits there at key offset 0, within that half ulp of its fz - 1), and the
// search window adds two such ulps to the largest reach. A degenerate cell
// (h_z = 0) keeps every row.
//
// What bounds it on the card: f32 operations, 22 per (sub-column,
// candidate) and 9 per (voxel, candidate) with one mask (10 with two),
// one of them the rounding rintf on the slower conversion pipe; the
// output is one byte per voxel. No tensor cores: the work is exact f32
// compares, with no product that wgmma could take. The z cut removes ~82%
// of the (voxel, candidate) tests at bench shapes (a slab keeps ~63 of a
// tile's ~360 rows); only ~1 in 13 of the tests left has a compare that
// fails (a row within reach in 3-D), the work that bounds it. What is
// left of the time is the per-block set-up (radius max, nine binary
// searches, staging: dependent loads at L2 latency) and the item warps'
// idle lanes (7 x 7 sub-columns fill 49 of 64). Rows past a run's end are
// never read, so the TPU kernel's dead pad rows and their
// negative-threshold guard have no counterpart.
//
// Bit-exactness: the reference's expression order, rintf (round half to
// even, as jnp.round), IEEE division, built with --fmad=false, so masks
// equal the plain PyTorch version (grid_kernel.void_masks_tiles_plain);
// grid_kernel.void_masks_z_window is the plain twin of the cut.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ZG = 8;            // z voxels per item = the slab height
constexpr int CAP = 192;         // candidate rows staged per pass
constexpr int MAX_ITEM_THREADS = 256;
constexpr int MAX_THREADS = MAX_ITEM_THREADS + 32;  // + the point warp
// caps registers at 65536 / (4 * 288) = 56 a thread, so more of the
// small (96-thread at bench shapes) blocks stay resident per SM
constexpr int MIN_BLOCKS = 4;
constexpr int N_RANGES = 18;     // 9 column segments x 2 periodic subranges
constexpr float SIGMA = 9.5367431640625e-07f;  // 2^-20

__device__ int lower_bound(const float* __restrict__ keys, int lo, int hi,
                           float v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ int upper_bound(const float* __restrict__ keys, int lo, int hi,
                           float v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS) void_masks_kernel(
    const float* __restrict__ payload, int m_rows,
    const float* __restrict__ keys, const long long* __restrict__ cstarts,
    int window, const float* __restrict__ cell, int gx, int gy, int gz,
    int nbx, int nby, float thr_hi, float thr_lo, float thr_fit,
    int two_masks, const float* __restrict__ pts, int n_pts,
    uint8_t* __restrict__ m_hi, uint8_t* __restrict__ m_lo,
    uint8_t* __restrict__ fit) {
  __shared__ float4 s_row[CAP];  // fxc, fyc, fz, (R + thr_hi)^2
  __shared__ float s_lo[CAP];    // (R + thr_lo)^2
  __shared__ float4 s_pt[CAP];   // unwrapped Cartesian row, (R + thr_fit)^2
  __shared__ int s_beg[N_RANGES], s_len[N_RANGES], s_off[N_RANGES + 1];
  __shared__ float s_red[MAX_THREADS / 32];
  __shared__ int s_n;
  __shared__ int s_q[64];  // queue of the point warp

  const int n_slabs = (gz + ZG - 1) / ZG;
  const int t = blockIdx.x / n_slabs, slab = blockIdx.x % n_slabs;
  const int ti = t / nby, tj = t % nby;
  const int tvx = gx / nbx, tvy = gy / nby;
  const int stride = nby + 2;
  float c[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) c[i] = cell[i];
  const float azz = c[6] * c[6] + c[7] * c[7] + c[8] * c[8];
  const float cx = ((float)ti + 0.5f) / (float)nbx;
  const float cy = ((float)tj + 0.5f) / (float)nby;
  const int z0 = slab * ZG;
  const int nz = min(ZG, gz - z0);
  const float za = (float)z0 / (float)gz;
  const float zb = (float)(z0 + nz) / (float)gz;
  const bool with_pts = pts != nullptr && n_pts > 0;

  // z-plane spacing h_z and margin mu, in double from the f32 cell
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
  const float reach_add = (float)((double)thr_hi + mu);

  // the three runs [st, st + cnt) of the tile
  int c0[3], st[3], cnt[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c0[k] = ((ti + k - 1 + nbx) % nbx) * stride + tj;
    const long long s0 = cstarts[c0[k]];
    st[k] = (int)s0;
    cnt[k] = (int)min((long long)window, cstarts[c0[k] + 3] - s0);
  }

  // largest radius of the tile's candidates: the search window's reach
  float rmax = 0.0f;
  for (int k = 0; k < 3; ++k)
    for (int q = threadIdx.x; q < cnt[k]; q += blockDim.x)
      rmax = fmaxf(rmax, payload[3 * m_rows + st[k] + q]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = rmax;
  __syncthreads();

  // key subranges of the nine column segments within the search window
  if (threadIdx.x < 9) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w)
      rmax = fmaxf(rmax, s_red[w]);
    const int k = threadIdx.x / 3, col = c0[k] + threadIdx.x % 3;
    const int a = (int)cstarts[col];
    const int b = max(a, (int)min(cstarts[col + 1],
                                  (long long)(st[k] + cnt[k])));
    const float kmax = (float)(nbx * stride);
    const double ulp2 = 2.0 * (double)(nextafterf(kmax, INFINITY) - kmax);
    double lo[2] = {0.0, 1.0}, hi[2] = {1.0, 0.0};  // second: empty
    if (cut) {
      const double w = ((double)rmax + (double)thr_hi + mu) / hz +
                       (double)SIGMA + ulp2;
      const double lo_z = (double)za - w, hi_z = (double)zb + w;
      if (hi_z - lo_z < 1.0) {
        lo[0] = fmax(lo_z, 0.0);
        hi[0] = fmin(hi_z, 1.0);
        if (lo_z < 0.0) {
          lo[1] = lo_z + 1.0;
          hi[1] = 1.0;
        } else if (hi_z > 1.0) {
          lo[1] = 0.0;
          hi[1] = hi_z - 1.0;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int beg = a, end = a;
      if (lo[i] <= hi[i]) {
        beg = lower_bound(keys, a, b, (float)((double)col + lo[i]));
        end = upper_bound(keys, beg, b, (float)((double)col + hi[i]));
      }
      s_beg[2 * threadIdx.x + i] = beg;
      s_len[2 * threadIdx.x + i] = end - beg;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s_off[0] = 0;
    for (int r = 0; r < N_RANGES; ++r) s_off[r + 1] = s_off[r] + s_len[r];
  }
  __syncthreads();
  const int total = s_off[N_RANGES];

  const int n_sub = tvx * tvy;
  // the last warp takes the MC points, the others the items
  const int n_item_threads = (int)blockDim.x - (with_pts ? 32 : 0);
  const bool point_warp = (int)threadIdx.x >= n_item_threads;
  const int lane = threadIdx.x & 31;
  float vz[ZG];
#pragma unroll
  for (int k = 0; k < ZG; ++k)
    vz[k] = ((float)(z0 + k) + 0.5f) / (float)gz;

  for (int base = 0;; base += CAP) {
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
    const int rows = min(CAP, total - base);
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      const int q = base + j;
      int r = 0;
      while (q >= s_off[r + 1]) ++r;
      const int row = s_beg[r] + (q - s_off[r]);
      const float fz = payload[2 * m_rows + row];
      const float rad = payload[3 * m_rows + row];
      float d = 0.0f;
      if (fz < za) d = za - fz; else if (fz > zb) d = fz - zb;
      d = fminf(d, fminf(fz + 1.0f - zb, za + 1.0f - fz));
      if (d >= (rad + reach_add) * inv_hz + SIGMA) continue;  // dropped
      const int slot = atomicAdd(&s_n, 1);
      const float fx = payload[row];
      const float fy = payload[m_rows + row];
      const float fxc = fx - rintf(fx - cx);
      const float fyc = fy - rintf(fy - cy);
      const float th = rad + thr_hi;
      s_row[slot] = make_float4(fxc, fyc, fz, th * th);
      if (two_masks) {
        const float tl = rad + thr_lo;
        s_lo[slot] = tl * tl;
      }
      if (with_pts) {
        const float tf = rad + thr_fit;
        s_pt[slot] = make_float4(fxc * c[0] + fyc * c[3] + fz * c[6],
                                 fxc * c[1] + fyc * c[4] + fz * c[7],
                                 fxc * c[2] + fyc * c[5] + fz * c[8],
                                 tf * tf);
      }
    }
    __syncthreads();
    const int n = s_n;

    if (!point_warp) {
      for (int it = threadIdx.x; it < n_sub; it += n_item_threads) {
        // item: one sub-column over the slab's voxels
        const int lx = it / tvy, ly = it % tvy;
        const float sfx = ((float)(ti * tvx) + (float)lx + 0.5f) / (float)gx;
        const float sfy = ((float)(tj * tvy) + (float)ly + 0.5f) / (float)gy;
        const long long vox0 =
            ((long long)(ti * tvx + lx) * gy + (tj * tvy + ly)) * gz + z0;
        unsigned hb = 0, lb = 0;
        if (base == 0) {
          hb = lb = (1u << nz) - 1u;
        } else {
          for (int k = 0; k < nz; ++k) {
            hb |= (unsigned)(m_hi[vox0 + k] != 0) << k;
            if (two_masks) lb |= (unsigned)(m_lo[vox0 + k] != 0) << k;
          }
        }
        for (int j = 0; j < n; ++j) {
          const float4 rw = s_row[j];
          const float dfx = sfx - rw.x;
          const float dfy = sfy - rw.y;
          const float qx = dfx * c[0] + dfy * c[3];
          const float qy = dfx * c[1] + dfy * c[4];
          const float qz = dfx * c[2] + dfy * c[5];
          const float qq = qx * qx + qy * qy + qz * qz;
          const float qdz = (qx * c[6] + qy * c[7] + qz * c[8]) * 2.0f;
          const float tl = two_masks ? s_lo[j] : 0.0f;
#pragma unroll
          for (int k = 0; k < ZG; ++k) {
            const float dz = vz[k] - rw.z;
            const float u = dz - rintf(dz);
            const float uu = azz * (u * u);
            const float d2 = (qq + uu) + u * qdz;
            if (!(d2 >= rw.w)) hb &= ~(1u << k);
            if (two_masks && !(d2 >= tl)) lb &= ~(1u << k);
          }
        }
        for (int k = 0; k < nz; ++k) {
          m_hi[vox0 + k] = (uint8_t)((hb >> k) & 1u);
          if (two_masks) m_lo[vox0 + k] = (uint8_t)((lb >> k) & 1u);
        }
      }
    } else {
      // MC points of the tile in this slab: a ballot compacts them, 32 at a
      // time, into a queue that the warp's lanes then take one each
      auto fit_point = [&](int p) {
        const long long o = (long long)t * n_pts + p;
        const float vx = pts[3 * o], vy = pts[3 * o + 1], vzp = pts[3 * o + 2];
        const float px = vx * c[0] + vy * c[3] + vzp * c[6];
        const float py = vx * c[1] + vy * c[4] + vzp * c[7];
        const float pz = vx * c[2] + vy * c[5] + vzp * c[8];
        bool ok = base == 0 ? true : fit[o] != 0;
        for (int j = 0; j < n; ++j) {
          const float4 w = s_pt[j];
          const float s = rintf(vzp - s_row[j].z);
          const float dx = px - w.x - s * c[6];
          const float dy = py - w.y - s * c[7];
          const float dz = pz - w.z - s * c[8];
          const float d2 = dx * dx + dy * dy + dz * dz;
          ok = ok && (d2 >= w.w);
        }
        fit[o] = (uint8_t)ok;
      };
      int qn = 0;
      for (int p0 = 0; p0 < n_pts; p0 += 32) {
        const int p = p0 + lane;
        bool in = false;
        if (p < n_pts) {
          const float vzp = pts[3 * ((long long)t * n_pts + p) + 2];
          const int kz =
              min(max((int)((vzp - floorf(vzp)) * (float)gz), 0), gz - 1);
          in = kz / ZG == slab;
        }
        const unsigned m = __ballot_sync(0xffffffffu, in);
        if (in) s_q[qn + __popc(m & ((1u << lane) - 1u))] = p;
        qn += __popc(m);
        __syncwarp();
        if (qn >= 32) {
          fit_point(s_q[lane]);
          __syncwarp();
          if (lane < qn - 32) s_q[lane] = s_q[lane + 32];
          qn -= 32;
          __syncwarp();
        }
      }
      if (lane < qn) fit_point(s_q[lane]);
    }
    if (base + CAP >= total) break;
    __syncthreads();  // staged rows are rewritten by the next pass
  }
}

}  // namespace

extern "C" int void_masks_launch(const void* payload, int m_rows,
                                 const void* keys, const void* cstarts,
                                 int window, const void* cell, int gx, int gy,
                                 int gz, int nbx, int nby, float thr_hi,
                                 float thr_lo, float thr_fit, int two_masks,
                                 const void* pts, int n_pts, void* m_hi,
                                 void* m_lo, void* fit, void* stream) {
  const int n_tiles = nbx * nby;
  if (n_tiles <= 0 || gz <= 0) return 0;
  if (gx % nbx || gy % nby) return (int)cudaErrorInvalidValue;
  // a thread per sub-column item, in whole warps up to 256; one more warp
  // for the MC points
  const int n_sub = (gx / nbx) * (gy / nby);
  int threads = (n_sub + 31) / 32 * 32;
  threads = threads > MAX_ITEM_THREADS ? MAX_ITEM_THREADS : threads;
  if (pts != nullptr && n_pts > 0) threads += 32;
  const int n_slabs = (gz + ZG - 1) / ZG;
  void_masks_kernel<<<n_tiles * n_slabs, threads, 0, (cudaStream_t)stream>>>(
      (const float*)payload, m_rows, (const float*)keys,
      (const long long*)cstarts, window, (const float*)cell, gx, gy, gz, nbx,
      nby, thr_hi, thr_lo, thr_fit, two_masks, (const float*)pts, n_pts,
      (uint8_t*)m_hi, (uint8_t*)m_lo, (uint8_t*)fit);
  return (int)cudaGetLastError();
}
