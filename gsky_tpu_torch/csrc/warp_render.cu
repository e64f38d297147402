// Fused warp-render kernels of the GetMap path, for Hopper (sm_90a).
//
// B1 `paged_render`  replaces gsky_tpu/ops/paged.py::_paged_render_kernel
// B2 `warp_render`   replaces gsky_tpu/ops/pallas_tpu.py::_warp_render_kernel
//
// Both compute, per output pixel of a tile and per granule t: the affine
// map (params slots 0-5), NaN poisoning outside the granule's true extent
// (6/7), the window rebase (11/12), nearest / bilinear / Catmull-Rom taps
// valid where finite and != nodata (8), then a strictly-greater priority
// mosaic per namespace (9 priority, 10 namespace id) into canv/best
// (-inf = invalid).  The per-pixel body is one __device__ function
// (`granule_sample`, its coordinates from `granule_coords`) with three
// fetch front ends: B1 reads a block's staged footprint in shared memory
// (`StagedFetch`) or, for a footprint over the budget, walks the page
// table into the pool (`PageWalk`); B2 reads each granule's cached scene
// where it lies (`SceneFetch`).  The plain PyTorch versions
// (gsky_tpu_torch/ops/warp.py::granule_sample and its callers) are the
// same arithmetic, op for op.
//
// Bound: memory.  Each pixel reads sx/sy (8 B) and its taps (1, 4 or 16
// f32 per granule) and writes canv+best (8 B per namespace); no
// tensor-core work exists.  The least bytes a call must move, for B1 and
// B2 alike, are the distinct source pixels its taps need (about one per
// output pixel and granule at native resolution), read once, plus sx/sy,
// params (and B1's tables) and canv/best: ~2.1 MB, 0.00063 ms at
// 3.35 TB/s, for the GetMap path's 256 x 256 tile over 4 granules.
//
// B1 design.  The Pallas kernel DMAs each granule's whole page block
// into VMEM; a block of 8 x 128 x 512 f32 pages (2 MB) cannot fit in a
// Hopper block's 227 KB, so each block stages its own tap FOOTPRINT:
// - 2-D blocks of output pixels (8 x 32 unless the launch names another
//   tile), a warp on 32 consecutive columns of one row, so a block's taps
//   fall in one compact source box whatever the projection's rotation;
// - per granule, every thread computes its coordinates with the same
//   helper the taps use (`granule_coords`) and the clipped box of its
//   in-bounds taps (`tap_box`); warp reductions, then shared memory,
//   give the block's box.  Out-of-bounds, non-finite and padding-row
//   taps are masked and add nothing;
// - per round of up to kPlan granules, the params rows and page tables
//   are copied into shared memory first, all loads in flight at once,
//   so no later step waits on a dependent global load;
// - warp 0 plans the round: the longest run of granules (the chunk)
//   whose boxes, widened to whole 16-byte column quads, fit the dynamic
//   shared-memory budget together (STAGE_BUDGET in ops/paged.py, passed
//   by the wrapper), laid out back to back;
// - the chunk's boxes are copied in with 16-byte cp.async, one quad a
//   work item over all the block's threads, ALL granules' loads in flight
//   together, then one barrier; consecutive threads take consecutive
//   quads of a row, so the loads coalesce.  The page-table walk is
//   32-bit and never per tap: the page coordinates of a box's corner
//   are found once per granule and block, then stepped, and the table
//   entry is read from shared memory; only slot * page stays 64-bit
//   (the pool can exceed 2^31 floats).  A page is a whole number of
//   quads, so no quad straddles two pages.  The [0, S * page - 1] clamp
//   of the page walk is kept;
// - taps read shared memory at (ri - r_lo) * box_w + (ci - c_lo), in
//   32-bit index arithmetic, four granules' samples interleaved (two
//   for cubic) and mosaicked in granule order;
// - a granule box larger than the whole budget (zoomed-out tiles, wide
//   page windows) is read from the pool directly, tap by tap, with the
//   same 32-bit walk; each block that does so adds 1 to a device counter
//   (0 on the GetMap main path).
// Against the first, per-pixel design: per-tap 64-bit floor divisions
// and table->pool dependent load chains are gone (the table is read
// once per staged quad, from shared memory); the loads of all a block's
// granules overlap in one round trip instead of one dependent chain per
// tap.  The block count (256 blocks of 256 threads for a 256 x 256 tile
// at 8 x 32) and so the warps per SM are as before.  Timestamps taken
// inside the blocks (clock64, one block's thread 0) showed its 16 warps
// an SM are bound by instruction issue and by dependent chains, not by
// memory, once the loads overlap:
// so the work per pixel is kept small and independent — 32-bit
// indices, no integer division after the plan (`div_small`), one plan
// per block, four columns per cp.async, granules interleaved.
//
// B2 design.  The Pallas kernel indexes one dense (B, WR, WC) stack,
// because a BlockSpec cuts one array; its first port read such a stack,
// which the executor built by copying the group's cached scenes (4 x
// 7936 x 7936 f32, 1 GB, for four Landsat scenes).  Here:
// - each granule is read from its own cached scene through a base
//   pointer; the group's scenes share one (WR, WC) bucket, so WC is the
//   row stride of every one.  Up to kInline pointers travel by value in
//   the launch's parameters (a __grid_constant__ struct, no upload); a
//   call over more granules passes a device table of them, which the
//   wrapper builds once per pointer list;
// - the executor drops the group's padding rows (namespace -1: they
//   never win the mosaic) before the launch;
// - 2-D blocks of output pixels (8 x 32 unless the launch names another
//   tile), a warp on 32 consecutive columns, so a block's taps fall on
//   few source rows;
// - per round of up to kB2Round granules, the params rows and scene
//   pointers go to shared memory once per block;
// - the granules are sampled one after another, each mosaicked as it
//   comes.  Sampling them four at a time (two for cubic), all their taps
//   issued before any is used, as B1 does, measured slower on an H100
//   at zoomed-out bilinear tiles (kernel_pair.py; PERF.md, B2's
//   design), so the simpler loop is kept;
// - 32-bit in-scene indices (the wrapper checks WR * WC < 2^31: a stack
//   of scenes can exceed 2^31 floats, one scene cannot);
// - no shared-memory staging: at the zoomed-out tiles that reach this
//   leg a tap lands 2-8 source pixels from its neighbour's, so a block
//   has nothing to reuse, and at native resolution L1 catches the reuse.
//
// Bit parity with the reference needs its op order everywhere, IEEE
// division for acc / wacc, and multiply-adds fused exactly where XLA's
// lowering of the reference fuses them and nowhere else: the build uses
// -fmad=false and the code calls __fmaf_rn at those places — the affine,
// w1 of the cubic weights, and the tap sum (whose second add fuses the
// FIRST product into the rounded second one).  B2's index arithmetic is
// clipped to the scene before any load, so a granule of zero extent still
// reads a valid address; B1 reads only in-bounds taps.  A
// masked tap contributes 0 whatever it would have read, so neither
// choice changes a result.
//
// The output tile.  Both kernels take it at launch as their block shape
// (blockDim.x columns, blockDim.y rows): the columns a multiple of 32, so
// a warp is 32 consecutive columns of one row, and at most kMaxThreads
// threads.  The wave planner's cost model (pipeline/autoplan.py
// `plan_block`) picks it; 8 x 32 is the default.  No value depends on the
// tile: each pixel's taps and mosaic are its own, and B1's staged boxes
// only decide where a tap is read from (stage or pool), not what it
// reads.  B2 has one instance a (method, namespaces) pair for every tile.
// B1 has two: the default tile's, whose shape is a compile-time constant
// (ROWS = 8: its loops and strides are constants, as before tiles were
// planned), and one that reads its tile from blockDim (ROWS = 0), whose
// near and bilinear launches at 8 x 32 ran 2-4% slower than before on an
// H100 (tools/tile_sweep.py; PERF.md).
//
// Launch floor: `empty_kernel` does nothing; its device time is what a
// launch of any kernel here costs at least.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int NEAR = 0, BILINEAR = 1, CUBIC = 2;

#ifndef GSKY_TILE_THREADS_MAX
#define GSKY_TILE_THREADS_MAX 256
#endif
// The largest tile in threads (ops/warp_render.py MAX_TILE_THREADS), and
// so the kernels' launch bound.  256, the default tile's size: a bound of
// 1024 caps a thread at 64 registers, and B1 then spills (cubic at 8
// namespaces) and its default tile ran 4-12% slower on an H100, while no
// tile over 256 threads ran faster than 8 x 32 at any point measured
// (tools/tile_sweep.py; PERF.md).
constexpr int kMaxThreads = GSKY_TILE_THREADS_MAX;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPlan = 8;  // granules whose boxes are planned per round
constexpr int kMaxSlots = 64;  // page-table slots a granule may list

// Page-table walk of one window-relative element (r, c >= 0) in 32-bit:
// the pool offset of its value, with the [0, S * page - 1] clamp of the
// flat index (an index past the table lands on the last slot's last
// element).  `lp` is the page-grid slot, `rr`/`cc` the in-page row and
// column.
__device__ __forceinline__ long long pool_offset(const int* table, int S,
                                                 int page, int pc, int lp,
                                                 int rr, int cc) {
  return lp < S ? (long long)table[lp] * page + rr * pc + cc
                : (long long)table[S - 1] * page + page - 1;
}

// B1 fast front end: the block's staged box of this granule.  Called
// for in-bounds taps only.
struct StagedFetch {
  static constexpr bool kGuarded = true;
  const float* box;  // shared memory, box_w floats a row
  int r_lo, c_lo, box_w;
  __device__ __forceinline__ float operator()(int ri, int ci) const {
    return box[(ri - r_lo) * box_w + (ci - c_lo)];
  }
};

// B1 front end for a box over the budget: each in-bounds tap walks the
// table into the pool itself, in 32-bit.
struct PageWalk {
  static constexpr bool kGuarded = true;
  const float* pool;
  const int* table;  // S slots of this tile and granule (shared memory)
  int S, pr, pc, ppc;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const int pi = r / pr, pj = c / pc;
    return pool[pool_offset(table, S, pr * pc, pc, pi * ppc + pj,
                            r - pi * pr, c - pj * pc)];
  }
};

// B2 front end: this granule's cached (WR, WC) scene, read at clipped
// 32-bit indices for every tap.
struct SceneFetch {
  static constexpr bool kGuarded = false;
  const float* scene;
  int wc;
  __device__ __forceinline__ float operator()(int ri, int ci) const {
    return __ldg(scene + ri * wc + ci);
  }
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  // jnp.clip / torch.clamp order: max with lo first, then min with hi
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

template <class Fetch>
__device__ __forceinline__ float tap(const Fetch& fetch, int ri, int ci,
                                     bool inb, int wr, int wc, float nd,
                                     bool& ok) {
  float v;
  if constexpr (Fetch::kGuarded) {
    v = inb ? fetch(ri, ci) : 0.0f;
  } else {
    v = fetch(clampi(ri, 0, wr - 1), clampi(ci, 0, wc - 1));
  }
  ok = inb && isfinite(v) && (v != nd);
  return ok ? v : 0.0f;
}

__device__ __forceinline__ void cubic_weights(float f, float w[4]) {
  const float a = -0.5f;
  float f2 = f * f;
  float f3 = f2 * f;
  w[0] = a * ((f3 - 2.0f * f2) + f);
  w[1] = __fmaf_rn(-2.5f, f2, 1.5f * f3) + 1.0f;
  w[2] = (-1.5f * f3 + 2.0f * f2) - a * f;
  w[3] = a * (f2 - f3);
}

// One granule's window-relative source coordinates at one dst pixel:
// the affine, NaN rows outside the true extent, the window rebase.  The
// taps (`granule_sample`) and B1's staged boxes (`tap_box`) both start
// here, so they cannot disagree.
__device__ __forceinline__ void granule_coords(float sx, float sy,
                                               const float* p, float& rows,
                                               float& cols) {
  cols = __fmaf_rn(p[2], sy, __fmaf_rn(p[1], sx, p[0])) - 0.5f;
  rows = __fmaf_rn(p[5], sy, __fmaf_rn(p[4], sx, p[3])) - 0.5f;
  bool oob = (rows < -0.5f) || (rows > p[6] - 0.5f) || (cols < -0.5f) ||
             (cols > p[7] - 0.5f);
  rows = oob ? NAN : rows;
  rows = rows - p[11];
  cols = cols - p[12];
}

// The box of one pixel's in-bounds taps in a (wr, wc) window: false when
// it has none.  The taps form a full 1x1, 2x2 or 4x4 grid, so the taps
// that land in bounds are exactly its rectangle clipped to the window.
template <int METHOD>
__device__ __forceinline__ bool tap_box(float rows, float cols, int wr,
                                        int wc, int& r_lo, int& r_hi,
                                        int& c_lo, int& c_hi) {
  const bool finite = isfinite(rows) && isfinite(cols);
  int r0, c0;
  if (METHOD == NEAR) {
    r0 = (int)floorf((finite ? rows : 0.0f) + 0.5f);
    c0 = (int)floorf((finite ? cols : 0.0f) + 0.5f);
  } else {
    r0 = (int)floorf(finite ? rows : -10.0f);
    c0 = (int)floorf(finite ? cols : -10.0f);
  }
  const int lo = METHOD == CUBIC ? -1 : 0;
  const int span = METHOD == NEAR ? 0 : (METHOD == BILINEAR ? 1 : 3);
  r_lo = max(r0 + lo, 0);
  r_hi = min(r0 + lo + span, wr - 1);
  c_lo = max(c0 + lo, 0);
  c_hi = min(c0 + lo + span, wc - 1);
  return (METHOD != NEAR || finite) && r_lo <= r_hi && c_lo <= c_hi;
}

// One granule's resample at one dst pixel: returns the value, sets ok.
// Tap indices are 32-bit: window- or scene-relative, below 2^31.
template <int METHOD, class Fetch>
__device__ __forceinline__ float granule_sample(float sx, float sy,
                                                const float* p,
                                                const Fetch& fetch, int wr,
                                                int wc, bool& ok) {
  float rows, cols;
  granule_coords(sx, sy, p, rows, cols);
  const float nd = p[8];
  const bool finite = isfinite(rows) && isfinite(cols);
  if (METHOD == NEAR) {
    int ri = finite ? (int)floorf(rows + 0.5f) : 0;
    int ci = finite ? (int)floorf(cols + 0.5f) : 0;
    bool inb = ri >= 0 && ri < wr && ci >= 0 && ci < wc && finite;
    return tap(fetch, ri, ci, inb, wr, wc, nd, ok);
  }
  rows = finite ? rows : -10.0f;
  cols = finite ? cols : -10.0f;
  const float r0f = floorf(rows);
  const float c0f = floorf(cols);
  const float fr = rows - r0f;
  const float fc = cols - c0f;
  const int r0 = (int)r0f;
  const int c0 = (int)c0f;
  // tap sum: acc = fma(w0, v0, w1 * v1), then acc = fma(wk, vk, acc)
  float acc = 0.0f, wacc = 0.0f, w_first = 0.0f, v_first = 0.0f;
  int k = 0;
  float thresh;
  if (METHOD == BILINEAR) {
    thresh = 1e-6f;
    for (int dr = 0; dr < 2; ++dr) {
      for (int dc = 0; dc < 2; ++dc) {
        float wt = (dr ? fr : 1.0f - fr) * (dc ? fc : 1.0f - fc);
        int ri = r0 + dr, ci = c0 + dc;
        bool inb = ri >= 0 && ri < wr && ci >= 0 && ci < wc;
        bool okt;
        float v = tap(fetch, ri, ci, inb, wr, wc, nd, okt);
        float wo = wt * (okt ? 1.0f : 0.0f);
        if (k == 0) {
          w_first = wo;
          v_first = v;
        } else if (k == 1) {
          acc = __fmaf_rn(w_first, v_first, wo * v);
        } else {
          acc = __fmaf_rn(wo, v, acc);
        }
        ++k;
        wacc = wacc + wo;
      }
    }
  } else {
    thresh = 0.05f;
    float wrr[4], wcc[4];
    cubic_weights(fr, wrr);
    cubic_weights(fc, wcc);
    for (int dr = 0; dr < 4; ++dr) {
      for (int dc = 0; dc < 4; ++dc) {
        float wt = wrr[dr] * wcc[dc];
        int ri = r0 + dr - 1, ci = c0 + dc - 1;
        bool inb = ri >= 0 && ri < wr && ci >= 0 && ci < wc;
        bool okt;
        float v = tap(fetch, ri, ci, inb, wr, wc, nd, okt);
        float wo = wt * (okt ? 1.0f : 0.0f);
        if (k == 0) {
          w_first = wo;
          v_first = v;
        } else if (k == 1) {
          acc = __fmaf_rn(w_first, v_first, wo * v);
        } else {
          acc = __fmaf_rn(wo, v, acc);
        }
        ++k;
        wacc = wacc + wo;
      }
    }
  }
  ok = finite && (wacc > thresh);
  return acc / (wacc > thresh ? wacc : 1.0f);
}

template <int NS>
__device__ __forceinline__ void mosaic(float* canv, float* best, float val,
                                       bool ok, float prio, float ns) {
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    float s = (ns == (float)m && ok) ? prio : -INFINITY;
    if (s > best[m]) {
      canv[m] = val;
      best[m] = s;
    }
  }
}

template <int NS>
__device__ __forceinline__ void store(float* canv_out, float* best_out,
                                      long long base, long long hw,
                                      const float* canv, const float* best) {
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    canv_out[base + m * hw] = canv[m];
    best_out[base + m * hw] = best[m];
  }
}

// x / d for 0 <= x < 2^22 and d >= 1, given inv_d = 1/d rounded: the
// float quotient is within one of the true one and is corrected, so no
// integer division (a long instruction sequence) is needed.
__device__ __forceinline__ int div_small(int x, int d, float inv_d) {
  int q = (int)((float)x * inv_d);
  q -= q * d > x;
  q += (q + 1) * d <= x;
  return q;
}

// Asynchronous copies into the stage.  No memory clobber: nothing reads
// the stage before cp_async_wait_all (which has one) and a barrier, so
// the compiler may move other loads across the copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One granule's plan in a block: its tap box, its staged box (the
// columns widened to whole 16-byte quads), where that sits in the stage,
// and what its staging needs: the page coordinates of the box's corner
// and 1 / QUADS.
enum PlanField {
  R_LO, R_HI, C_LO, C_HI,  // the tap box
  Q_LO,    // first staged column: C_LO rounded down to a quad
  QUADS,   // staged quads a row
  START,   // first quad in the stage (the chunk's boxes are contiguous)
  OFFSET,  // 4 * START where staged; kNone: no tap, kDirect: from the pool
  PI0, RR0,  // page row of R_LO and R_LO's row in it
  PJ0, CC0,  // page column of Q_LO and Q_LO's column in it
  PPC,       // page columns a page row of the window (the table's stride)
  INV_QUADS,  // 1.0f / QUADS, as its bits
  kPlanFields
};
constexpr int kNone = -1, kDirect = -2;
// granules whose boxes, and whose taps, are computed together (so their
// independent work interleaves); cubic's 16 taps a granule leave less
// room for that
constexpr int kBoxGroup = 4;
constexpr int kStageUnroll = 2;  // quads a thread stages together
template <int METHOD>
constexpr int kTapGroup = METHOD == CUBIC ? 2 : 4;

// B1: grid (ceil(w / cols), ceil(h / rows), N), blocks of (cols, rows)
// threads, `budget` floats of dynamic shared memory.  pool (cap, pr,
// pc), pc a multiple of 4; tables (N, T, S), S <= kMaxSlots, or, with
// `sb_of`, (G, T, S): a wave's superblock tables, lane n reading row
// sb_of[n] (the wave planner's union windows: lane n's params slots
// 11-15 already carry its row's window, so the boxes, the staging and
// the taps are as without it); params (N*T, 16); sx/sy (N, h, w);
// canv/best (N, NS, h, w); `direct` counts the blocks that read a
// granule from the pool directly.  Per round of up to kPlan granules:
// 0. params and tables to shared memory; 1. the boxes; 2. the plan (warp
// 0); 3. the staging; 4. the taps; a barrier after each of 0-3.
template <int METHOD, int NS, int ROWS>
__global__ void __launch_bounds__(kMaxThreads)
paged_render(const float* __restrict__ pool, const int* __restrict__ tables,
             const float* __restrict__ params,
             const float* __restrict__ sxs, const float* __restrict__ sys,
             float* __restrict__ canv_out, float* __restrict__ best_out,
             int T, int S, int pr, int pc, int h, int w, int budget,
             unsigned int* __restrict__ direct,
             const int* __restrict__ sb_of) {
  extern __shared__ __align__(16) float stage[];
  __shared__ float prm[kPlan * 16];       // the round's params rows
  __shared__ int tab[kPlan * kMaxSlots];  // and page tables, S apart
  __shared__ int red[kMaxWarps][kPlan][4];  // a warp's r_lo, r_hi, c_lo, c_hi
  __shared__ int plan[kPlan][kPlanFields];
  __shared__ int chunk, chunk_quads, took_direct;
  static_assert(kPlan % kBoxGroup == 0 && kPlan % kTapGroup<METHOD> == 0,
                "groups tile the round");
  // ROWS > 0: a 1-D block of ROWS warps, one a row of 32 columns
  const int nthreads = ROWS ? ROWS * 32 : blockDim.x * blockDim.y;
  const int tid =
      ROWS ? threadIdx.x : threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = ROWS ? blockIdx.x * 32 + lane
                     : blockIdx.x * blockDim.x + threadIdx.x;
  const int y = ROWS ? blockIdx.y * ROWS + warp
                     : blockIdx.y * blockDim.y + threadIdx.y;
  const bool live = x < w && y < h;
  const long long n = blockIdx.z;
  const long long hw = (long long)h * w;
  const long long pix = (long long)y * w + x;
  const float* pn = params + n * T * 16;
  const int* tn = tables + (sb_of != nullptr ? sb_of[n] : n) * T * S;
  const int page = pr * pc;
  const float inv_pr = __frcp_rn((float)pr), inv_pc = __frcp_rn((float)pc);
  float sx = 0.0f, sy = 0.0f;
  if (live) {
    sx = sxs[n * hw + pix];
    sy = sys[n * hw + pix];
  }
  float canv[NS], best[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    canv[m] = 0.0f;
    best[m] = -INFINITY;
  }
  if (tid == 0) took_direct = 0;
  for (int t0 = 0; t0 < T;) {
    const int ng = min(kPlan, T - t0);
    // 0. the round's params (rows past ng zero: empty windows) and tables
    // to shared memory, all loads in flight at once
    for (int i = tid; i < kPlan * 16; i += nthreads) {
      prm[i] = i < ng * 16 ? pn[t0 * 16 + i] : 0.0f;
    }
    for (int i = tid; i < ng * S; i += nthreads) tab[i] = tn[t0 * S + i];
    __syncthreads();
    // 1. each thread's tap box per granule, min/max over each warp
    for (int g0 = 0; g0 < ng; g0 += kBoxGroup) {
      int b[kBoxGroup][4];
#pragma unroll
      for (int k = 0; k < kBoxGroup; ++k) {
        const float* p = prm + (g0 + k) * 16;
        float rows, cols;
        granule_coords(sx, sy, p, rows, cols);
        int a0, a1, a2, a3;
        const bool has = tap_box<METHOD>(rows, cols, (int)p[13], (int)p[14],
                                         a0, a1, a2, a3) &&
                         live && p[10] >= 0.0f;
        b[k][0] = has ? a0 : INT_MAX;
        b[k][1] = has ? a1 : INT_MIN;
        b[k][2] = has ? a2 : INT_MAX;
        b[k][3] = has ? a3 : INT_MIN;
      }
#pragma unroll
      for (int k = 0; k < kBoxGroup; ++k) {
        b[k][0] = __reduce_min_sync(0xffffffffu, b[k][0]);
        b[k][1] = __reduce_max_sync(0xffffffffu, b[k][1]);
        b[k][2] = __reduce_min_sync(0xffffffffu, b[k][2]);
        b[k][3] = __reduce_max_sync(0xffffffffu, b[k][3]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kBoxGroup; ++k) {
#pragma unroll
          for (int f = 0; f < 4; ++f) red[warp][g0 + k][f] = b[k][f];
        }
      }
    }
    __syncthreads();
    // 2. warp 0, lane g: granule g's block box and plan; the chunk is
    // the longest run of granules whose staged boxes fit the budget
    // together
    if (warp == 0) {
      int b[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
      if (lane < ng) {
#pragma unroll
        for (int k = 0; k < (nthreads >> 5); ++k) {
          b[0] = min(b[0], red[k][lane][0]);
          b[1] = max(b[1], red[k][lane][1]);
          b[2] = min(b[2], red[k][lane][2]);
          b[3] = max(b[3], red[k][lane][3]);
        }
      }
      const bool any = b[0] <= b[1] && b[2] <= b[3];
      const int q_lo = b[2] & ~3;
      const int quads = (((b[3] + 4) & ~3) - q_lo) >> 2;
      const long long elems =
          any ? (long long)(b[1] - b[0] + 1) * quads * 4 : 0;
      const bool over = elems > budget;
      const int size = over ? 0 : (int)elems;
      int scan = size;  // inclusive prefix sum over the lanes
#pragma unroll
      for (int o = 1; o < kPlan; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, scan, o);
        if (lane >= o) scan += v;
      }
      const bool in = lane < ng && scan <= budget;
      const unsigned in_mask = __ballot_sync(0xffffffffu, in);
      const int nc = __popc(in_mask);
      if (in) {
        int* q = plan[lane];
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = b[k];
        q[Q_LO] = q_lo;
        q[QUADS] = quads;
        q[START] = (scan - size) >> 2;
        q[OFFSET] = !any ? kNone : (over ? kDirect : scan - size);
        if (size) {
          const int pi0 = div_small(b[0], pr, inv_pr);
          const int pj0 = div_small(q_lo, pc, inv_pc);
          q[PI0] = pi0;
          q[RR0] = b[0] - pi0 * pr;
          q[PJ0] = pj0;
          q[CC0] = q_lo - pj0 * pc;
          q[PPC] = (int)prm[lane * 16 + 15];
          q[INV_QUADS] = __float_as_int(__frcp_rn((float)quads));
        }
      }
      const int total = __shfl_sync(0xffffffffu, scan, nc - 1);
      if (__any_sync(0xffffffffu, in && over) && lane == 0) took_direct = 1;
      if (lane == 0) {
        chunk = nc;
        chunk_quads = total >> 2;
      }
    }
    __syncthreads();
    const int nc = chunk;
    // 3. the chunk's staged boxes, one 16-byte quad a work item, all in
    // flight at once: quad e lands at stage + 4 e
    const int nq = chunk_quads;
    for (int e0 = tid; e0 < nq; e0 += kStageUnroll * nthreads) {
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int e = e0 + u * nthreads;
        if (e >= nq) break;
        int g = 0;  // the last staged granule whose quads start at or before e
#pragma unroll
        for (int k = 1; k < kPlan; ++k) {
          g = k < nc && plan[k][OFFSET] >= 0 && e >= plan[k][START] ? k : g;
        }
        const int* q = plan[g];
        // row j and quad of e in the box (l < 2^22: the stage is small)
        const int l = e - q[START];
        const int j = div_small(l, q[QUADS], __int_as_float(q[INV_QUADS]));
        int pi = q[PI0], rr = q[RR0] + j;
        while (rr >= pr) {
          rr -= pr;
          ++pi;
        }
        int pj = q[PJ0], cc = q[CC0] + 4 * (l - j * q[QUADS]);
        while (cc >= pc) {
          cc -= pc;
          ++pj;
        }
        const int lp = pi * q[PPC] + pj;
        const int* table = tab + g * S;
        float* dst = stage + 4 * e;
        if (lp < S) {
          cp_async16(dst, pool + (long long)table[lp] * page + rr * pc + cc);
        } else {  // past the table: the clamp repeats its last element
          const float* last =
              pool + (long long)table[S - 1] * page + page - 1;
#pragma unroll
          for (int k = 0; k < 4; ++k) cp_async4(dst + k, last);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // 4. taps, kTapGroup granules at a time, their mosaic in granule
    // order.  A granule with no tap in the block (or past the chunk)
    // samples an empty window, reads nothing and mosaics nothing.
    constexpr int kG = kTapGroup<METHOD>;
    for (int g0 = 0; g0 < nc; g0 += kG) {
      bool from_pool = false;
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        from_pool |= g0 + k < nc && plan[g0 + k][OFFSET] == kDirect;
      }
      if (!live) continue;
      if (!from_pool) {
        float val[kG];
        bool ok[kG];
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const int g = g0 + k;
          const int* q = plan[g];
          const bool real = g < nc && q[OFFSET] >= 0;
          const float* p = prm + g * 16;
          StagedFetch f{stage + (real ? q[OFFSET] : 0), q[R_LO], q[Q_LO],
                        4 * q[QUADS]};
          val[k] = granule_sample<METHOD>(sx, sy, p, f,
                                          real ? (int)p[13] : 0,
                                          real ? (int)p[14] : 0, ok[k]);
        }
#pragma unroll
        for (int k = 0; k < kG; ++k) {
          const float* p = prm + (g0 + k) * 16;
          mosaic<NS>(canv, best, val[k], ok[k], p[9], p[10]);
        }
      } else {
        for (int g = g0; g < min(g0 + kG, nc); ++g) {
          const int off = plan[g][OFFSET];
          if (off == kNone) continue;
          const float* p = prm + g * 16;
          const int wr = (int)p[13], wc = (int)p[14];
          bool ok;
          float val;
          if (off >= 0) {
            StagedFetch f{stage + off, plan[g][R_LO], plan[g][Q_LO],
                          4 * plan[g][QUADS]};
            val = granule_sample<METHOD>(sx, sy, p, f, wr, wc, ok);
          } else {
            PageWalk f{pool, tab + g * S, S, pr, pc, (int)p[15]};
            val = granule_sample<METHOD>(sx, sy, p, f, wr, wc, ok);
          }
          mosaic<NS>(canv, best, val, ok, p[9], p[10]);
        }
      }
    }
    t0 += nc;
    if (t0 < T) __syncthreads();  // the next round reuses shared memory
  }
  if (live) store<NS>(canv_out, best_out, n * NS * hw + pix, hw, canv, best);
  if (tid == 0 && took_direct) atomicAdd(direct, 1u);
}

constexpr int kB2Round = 32;  // granules whose params go to shared memory
constexpr int kInline = 32;   // scene pointers passed by value (wrapper:
                              // ops/warp_render.py INLINE_SCENES)
struct ScenePtrs {
  const float* p[kInline];
};

// B2: grid (ceil(w / cols), ceil(h / rows)), blocks of (cols, rows)
// threads.
// Granule t's scene is ptrs.p[t] (B <= kInline) or table[t], each
// (WR, WC) f32 row-major; params (B, 16); sx/sy (h, w); canv/best
// (NS, h, w).
template <int METHOD, int NS>
__global__ void __launch_bounds__(kMaxThreads)
warp_render(const __grid_constant__ ScenePtrs ptrs,
            const float* const* __restrict__ table,
            const float* __restrict__ params, const float* __restrict__ sxs,
            const float* __restrict__ sys, float* __restrict__ canv_out,
            float* __restrict__ best_out, int B, int WR, int WC, int h,
            int w) {
  __shared__ float prm[kB2Round * 16];
  __shared__ const float* scn[kB2Round];
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const bool live = x < w && y < h;
  const int hw = h * w;
  const int pix = y * w + x;
  float sx = 0.0f, sy = 0.0f;
  if (live) {
    sx = sxs[pix];
    sy = sys[pix];
  }
  float canv[NS], best[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    canv[m] = 0.0f;
    best[m] = -INFINITY;
  }
  for (int t0 = 0; t0 < B; t0 += kB2Round) {
    const int nr = min(kB2Round, B - t0);
    for (int i = tid; i < nr * 16; i += nthreads) {
      prm[i] = params[t0 * 16 + i];
    }
    for (int g = tid; g < nr; g += nthreads) {
      scn[g] = table != nullptr ? table[t0 + g] : ptrs.p[t0 + g];
    }
    __syncthreads();
    if (live) {
      for (int g = 0; g < nr; ++g) {
        const float* p = prm + g * 16;
        SceneFetch f{scn[g], WC};
        bool ok;
        const float val = granule_sample<METHOD>(sx, sy, p, f, WR, WC, ok);
        mosaic<NS>(canv, best, val, ok, p[9], p[10]);
      }
    }
    if (t0 + kB2Round < B) __syncthreads();  // the next round reuses prm
  }
  if (live) store<NS>(canv_out, best_out, pix, hw, canv, best);
}

__global__ void empty_kernel() {}

template <int METHOD, int NS, int ROWS>
void paged_launch_at(dim3 grid, dim3 block, const float* pool,
                     const int* tables, const float* params, const float* sx,
                     const float* sy, float* canv, float* best, int T, int S,
                     int pr, int pc, int h, int w, int stage_bytes,
                     unsigned int* direct, const int* sb_of, cudaStream_t st) {
  if (stage_bytes > 48 * 1024) {
    cudaFuncSetAttribute(paged_render<METHOD, NS, ROWS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         stage_bytes);
  }
  paged_render<METHOD, NS, ROWS><<<grid, block, stage_bytes, st>>>(
      pool, tables, params, sx, sy, canv, best, T, S, pr, pc, h, w,
      stage_bytes / (int)sizeof(float), direct, sb_of);
}

// The default tile, 8 x 32, through its own instance; any other through
// the instance that reads its tile from blockDim.
template <int METHOD, int NS>
void paged_launch(const float* pool, const int* tables, const float* params,
                  const float* sx, const float* sy, float* canv, float* best,
                  int N, int T, int S, int pr, int pc, int h, int w,
                  int stage_bytes, unsigned int* direct, const int* sb_of,
                  int rows, int cols, cudaStream_t st) {
  dim3 grid((w + cols - 1) / cols, (h + rows - 1) / rows, N);
  if (rows == 8 && cols == 32) {
    paged_launch_at<METHOD, NS, 8>(grid, dim3(256), pool, tables, params, sx,
                                   sy, canv, best, T, S, pr, pc, h, w,
                                   stage_bytes, direct, sb_of, st);
  } else {
    paged_launch_at<METHOD, NS, 0>(grid, dim3(cols, rows), pool, tables,
                                   params, sx, sy, canv, best, T, S, pr, pc,
                                   h, w, stage_bytes, direct, sb_of, st);
  }
}

template <int METHOD, int NS>
void warp_launch(ScenePtrs ptrs, const float* const* table,
                 const float* params, const float* sx, const float* sy,
                 float* canv, float* best, int B, int WR, int WC, int h,
                 int w, int rows, int cols, cudaStream_t st) {
  dim3 grid((w + cols - 1) / cols, (h + rows - 1) / rows, 1);
  warp_render<METHOD, NS><<<grid, dim3(cols, rows), 0, st>>>(
      ptrs, table, params, sx, sy, canv, best, B, WR, WC, h, w);
}

template <template <int, int> class F, class... A>
int dispatch(int method, int ns, A... args) {
#define GSKY_CASE(M, N) \
  if (method == M && ns == N) return F<M, N>::run(args...), 0;
  GSKY_CASE(NEAR, 1) GSKY_CASE(NEAR, 2) GSKY_CASE(NEAR, 4) GSKY_CASE(NEAR, 8)
  GSKY_CASE(BILINEAR, 1) GSKY_CASE(BILINEAR, 2) GSKY_CASE(BILINEAR, 4)
  GSKY_CASE(BILINEAR, 8)
  GSKY_CASE(CUBIC, 1) GSKY_CASE(CUBIC, 2) GSKY_CASE(CUBIC, 4)
  GSKY_CASE(CUBIC, 8)
#undef GSKY_CASE
  return -1;
}

template <int M, int N>
struct PagedRun {
  template <class... A>
  static void run(A... args) { paged_launch<M, N>(args...); }
};

template <int M, int N>
struct WarpRun {
  template <class... A>
  static void run(A... args) { warp_launch<M, N>(args...); }
};

// An output tile both kernels take: (rows, cols) threads, the columns
// whole warps, at most kMaxThreads, and a grid within the card's limits.
bool tile_ok(int rows, int cols, int h, int depth) {
  return rows >= 1 && cols >= 32 && cols % 32 == 0 &&
         rows * cols <= kMaxThreads && (h + rows - 1) / rows <= 65535 &&
         depth <= 65535;
}

}  // namespace

// Plain C interface (ctypes): returns cudaGetLastError() after the launch,
// or -1 for a (method, ns) pair that is not instantiated, or
// cudaErrorInvalidValue for operands or a tile the kernel does not take.
// B1 takes the output as (h, w), its staging budget in bytes (the dynamic
// shared memory of a block), the device counter of blocks that read the
// pool directly, `sb_of`: null, or N int32 rows of `tables` (then (G, T,
// S)), one a lane, and the output tile (rows, cols).
extern "C" int launch_paged_render(int method, int ns, const void* pool,
                                   const void* tables, const void* params,
                                   const void* sx, const void* sy,
                                   void* canv, void* best, int N, int T,
                                   int S, int pr, int pc, int h, int w,
                                   int stage_bytes, void* direct,
                                   const void* sb_of, int rows, int cols,
                                   void* stream) {
  if (N == 0 || h == 0 || w == 0) return 0;
  if (S < 1 || S > kMaxSlots || pc % 4 || stage_bytes % 16 ||
      !tile_ok(rows, cols, h, N)) {
    return (int)cudaErrorInvalidValue;
  }
  int rc = dispatch<PagedRun>(
      method, ns, (const float*)pool, (const int*)tables,
      (const float*)params, (const float*)sx, (const float*)sy,
      (float*)canv, (float*)best, N, T, S, pr, pc, h, w, stage_bytes,
      (unsigned int*)direct, (const int*)sb_of, rows, cols,
      (cudaStream_t)stream);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// B2 takes its B granules' scene pointers as a host array `scenes` when
// B <= kInline (copied into the launch's parameters), else as a device
// array `table` of B pointers; each scene is (WR, WC) f32, WR * WC <
// 2^31; and the output tile (rows, cols).
extern "C" int launch_warp_render(int method, int ns,
                                  const void* const* scenes,
                                  const void* table, const void* params,
                                  const void* sx, const void* sy, void* canv,
                                  void* best, int B, int WR, int WC, int h,
                                  int w, int rows, int cols, void* stream) {
  if (h == 0 || w == 0) return 0;
  if (!tile_ok(rows, cols, h, 1)) return (int)cudaErrorInvalidValue;
  ScenePtrs ptrs{};
  if (B <= kInline) {
    for (int t = 0; t < B; ++t) ptrs.p[t] = (const float*)scenes[t];
    table = nullptr;
  } else if (table == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  int rc = dispatch<WarpRun>(
      method, ns, ptrs, (const float* const*)table, (const float*)params,
      (const float*)sx, (const float*)sy, (float*)canv, (float*)best, B, WR,
      WC, h, w, rows, cols, (cudaStream_t)stream);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// The launch floor: one launch of a kernel that does nothing.
extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
