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
// (-inf = invalid).  The per-pixel body is one __device__ function with
// two addressing front ends: B1 walks the page table into the page pool,
// B2 reads a dense (B, WR, WC) scene stack.  The plain PyTorch versions
// (gsky_tpu_torch/ops/warp.py::granule_sample and its callers) are the
// same arithmetic, op for op.
//
// Design: one thread per output pixel, blockIdx.z the tile; the granule
// loop runs inside the thread with the per-namespace canv/best in
// registers (templated on the namespace count) and one write at the end.
// The Pallas kernels double-buffer each granule's page block through
// VMEM; here taps read device memory (through L1/L2) directly.
//
// Bound: memory.  Each pixel reads sx/sy (8 B) and its taps (1, 4 or 16
// f32 per granule, mostly L1/L2 hits between neighbouring pixels) and
// writes canv+best (8 B per namespace); no tensor-core work exists.  The
// least bytes a call must move, for B1 and B2 alike, are the distinct
// source pixels its taps need (about one per output pixel and granule at
// native resolution), read once, plus sx/sy, params (and B1's tables) and
// canv/best.
//
// Bit parity with the reference needs its op order everywhere, IEEE
// division for acc / wacc, and multiply-adds fused exactly where XLA's
// lowering of the reference fuses them and nowhere else: the build uses
// -fmad=false and the code calls __fmaf_rn at those places — the affine,
// w1 of the cubic weights, and the tap sum (whose second add fuses the
// FIRST product into the rounded second one).  Index arithmetic
// is clipped before any load, so a padding granule (zero extent, clip
// bound -1) still reads a valid address; its taps are masked.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NEAR = 0, BILINEAR = 1, CUBIC = 2;

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// B1 front end: window-relative (ri, ci) -> page-table slot -> pool.
struct PageFetch {
  const float* pool;
  const int* table;  // S slots of this tile and granule
  long long S, pr, pc, ppc;
  __device__ __forceinline__ float operator()(long long ri, long long ci) const {
    const long long page = pr * pc;
    long long lp = floordiv(ri, pr) * ppc + floordiv(ci, pc);
    long long idx = lp * page + (ri - floordiv(ri, pr) * pr) * pc +
                    (ci - floordiv(ci, pc) * pc);
    idx = idx < 0 ? 0 : (idx > S * page - 1 ? S * page - 1 : idx);
    return pool[(long long)table[idx / page] * page + idx % page];
  }
};

// B2 front end: dense (WR, WC) scene of this granule.
struct DenseFetch {
  const float* scene;
  long long wc;
  __device__ __forceinline__ float operator()(long long ri, long long ci) const {
    return scene[ri * wc + ci];
  }
};

__device__ __forceinline__ long long clampi(long long v, long long lo,
                                            long long hi) {
  // jnp.clip / torch.clamp order: max with lo first, then min with hi
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

template <class Fetch>
__device__ __forceinline__ float tap(const Fetch& fetch, long long ri,
                                     long long ci, bool inb, long long wr,
                                     long long wc, float nd, bool& ok) {
  float v = fetch(clampi(ri, 0, wr - 1), clampi(ci, 0, wc - 1));
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

// One granule's resample at one dst pixel: returns the value, sets ok.
template <int METHOD, class Fetch>
__device__ __forceinline__ float granule_sample(float sx, float sy,
                                                const float* p,
                                                const Fetch& fetch,
                                                long long wr, long long wc,
                                                bool& ok) {
  float cols = __fmaf_rn(p[2], sy, __fmaf_rn(p[1], sx, p[0])) - 0.5f;
  float rows = __fmaf_rn(p[5], sy, __fmaf_rn(p[4], sx, p[3])) - 0.5f;
  bool oob = (rows < -0.5f) || (rows > p[6] - 0.5f) || (cols < -0.5f) ||
             (cols > p[7] - 0.5f);
  rows = oob ? NAN : rows;
  rows = rows - p[11];
  cols = cols - p[12];
  const float nd = p[8];
  const bool finite = isfinite(rows) && isfinite(cols);
  if (METHOD == NEAR) {
    long long ri = finite ? (long long)(int)floorf(rows + 0.5f) : 0;
    long long ci = finite ? (long long)(int)floorf(cols + 0.5f) : 0;
    bool inb = ri >= 0 && ri < wr && ci >= 0 && ci < wc && finite;
    return tap(fetch, ri, ci, inb, wr, wc, nd, ok);
  }
  rows = finite ? rows : -10.0f;
  cols = finite ? cols : -10.0f;
  const float r0f = floorf(rows);
  const float c0f = floorf(cols);
  const float fr = rows - r0f;
  const float fc = cols - c0f;
  const long long r0 = (int)r0f;
  const long long c0 = (int)c0f;
  // tap sum: acc = fma(w0, v0, w1 * v1), then acc = fma(wk, vk, acc)
  float acc = 0.0f, wacc = 0.0f, w_first = 0.0f, v_first = 0.0f;
  int k = 0;
  float thresh;
  if (METHOD == BILINEAR) {
    thresh = 1e-6f;
    for (int dr = 0; dr < 2; ++dr) {
      for (int dc = 0; dc < 2; ++dc) {
        float wt = (dr ? fr : 1.0f - fr) * (dc ? fc : 1.0f - fc);
        long long ri = r0 + dr, ci = c0 + dc;
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
        long long ri = r0 + dr - 1, ci = c0 + dc - 1;
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

// B1: grid (ceil(hw / block), 1, N).  pool (cap, pr, pc); tables (N, T, S);
// params (N*T, 16); sx/sy (N, hw); canv/best (N, NS, hw).
template <int METHOD, int NS>
__global__ void paged_render(const float* __restrict__ pool,
                             const int* __restrict__ tables,
                             const float* __restrict__ params,
                             const float* __restrict__ sxs,
                             const float* __restrict__ sys,
                             float* __restrict__ canv_out,
                             float* __restrict__ best_out, int T, int S,
                             int pr, int pc, int hw) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const long long n = blockIdx.z;
  const float sx = sxs[n * hw + pix];
  const float sy = sys[n * hw + pix];
  float canv[NS], best[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    canv[m] = 0.0f;
    best[m] = -INFINITY;
  }
  for (int t = 0; t < T; ++t) {
    const float* p = params + (n * T + t) * 16;
    PageFetch fetch{pool, tables + (n * T + t) * S, S, pr, pc,
                    (long long)(int)p[15]};
    bool ok;
    float val = granule_sample<METHOD>(sx, sy, p, fetch, (int)p[13],
                                       (int)p[14], ok);
    mosaic<NS>(canv, best, val, ok, p[9], p[10]);
  }
  store<NS>(canv_out, best_out, n * NS * hw + pix, hw, canv, best);
}

// B2: grid (ceil(hw / block), 1, 1).  stack (B, WR, WC); params (B, 16);
// sx/sy (hw); canv/best (NS, hw).
template <int METHOD, int NS>
__global__ void warp_render(const float* __restrict__ stack,
                            const float* __restrict__ params,
                            const float* __restrict__ sxs,
                            const float* __restrict__ sys,
                            float* __restrict__ canv_out,
                            float* __restrict__ best_out, int B, int WR,
                            int WC, int hw) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const float sx = sxs[pix];
  const float sy = sys[pix];
  float canv[NS], best[NS];
#pragma unroll
  for (int m = 0; m < NS; ++m) {
    canv[m] = 0.0f;
    best[m] = -INFINITY;
  }
  for (int t = 0; t < B; ++t) {
    const float* p = params + t * 16;
    DenseFetch fetch{stack + (long long)t * WR * WC, WC};
    bool ok;
    float val = granule_sample<METHOD>(sx, sy, p, fetch, WR, WC, ok);
    mosaic<NS>(canv, best, val, ok, p[9], p[10]);
  }
  store<NS>(canv_out, best_out, pix, hw, canv, best);
}

constexpr int kBlock = 256;

template <int METHOD, int NS>
void paged_launch(const float* pool, const int* tables, const float* params,
                  const float* sx, const float* sy, float* canv, float* best,
                  int N, int T, int S, int pr, int pc, int hw,
                  cudaStream_t st) {
  dim3 grid((hw + kBlock - 1) / kBlock, 1, N);
  paged_render<METHOD, NS><<<grid, kBlock, 0, st>>>(
      pool, tables, params, sx, sy, canv, best, T, S, pr, pc, hw);
}

template <int METHOD, int NS>
void warp_launch(const float* stack, const float* params, const float* sx,
                 const float* sy, float* canv, float* best, int B, int WR,
                 int WC, int hw, cudaStream_t st) {
  dim3 grid((hw + kBlock - 1) / kBlock, 1, 1);
  warp_render<METHOD, NS><<<grid, kBlock, 0, st>>>(
      stack, params, sx, sy, canv, best, B, WR, WC, hw);
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

}  // namespace

// Plain C interface (ctypes): returns cudaGetLastError() after the launch,
// or -1 for a (method, ns) pair that is not instantiated.
extern "C" int launch_paged_render(int method, int ns, const void* pool,
                                   const void* tables, const void* params,
                                   const void* sx, const void* sy,
                                   void* canv, void* best, int N, int T,
                                   int S, int pr, int pc, int hw,
                                   void* stream) {
  if (N == 0 || hw == 0) return 0;
  int rc = dispatch<PagedRun>(
      method, ns, (const float*)pool, (const int*)tables,
      (const float*)params, (const float*)sx, (const float*)sy,
      (float*)canv, (float*)best, N, T, S, pr, pc, hw,
      (cudaStream_t)stream);
  return rc != 0 ? rc : (int)cudaGetLastError();
}

extern "C" int launch_warp_render(int method, int ns, const void* stack,
                                  const void* params, const void* sx,
                                  const void* sy, void* canv, void* best,
                                  int B, int WR, int WC, int h, int w,
                                  void* stream) {
  const int hw = h * w;
  if (hw == 0) return 0;
  int rc = dispatch<WarpRun>(
      method, ns, (const float*)stack, (const float*)params,
      (const float*)sx, (const float*)sy, (float*)canv, (float*)best, B, WR,
      WC, hw, (cudaStream_t)stream);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
