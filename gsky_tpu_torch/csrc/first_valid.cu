// Kernel B4: first-valid temporal mosaic for the masked GetMap path.
//
// Replaces gsky_tpu/ops/pallas_tpu.py::_mosaic_kernel
// (mosaic_first_valid_pallas). For a priority-ordered stack (T, H, W) f32
// and valid (T, H, W) bytes (0 = invalid), per pixel p:
//   out[p] = stack[t, p] for the first t with valid[t, p] != 0, else +0.0
//   ok[p]  = 1 if any layer is valid, else 0
// (any T, H, W >= 1; the Pallas version pads H and W to 128).
//
// Bound on this card: bytes; there are no arithmetic operations at all.
// The bound counts what the function needs on its inputs: per pixel the
// valid bytes up to its first valid layer (all T where none is), the
// 4-byte value it copies, and 5 bytes out (about 0.66 MB, 0.0002 ms, at
// the GetMap path's (8, 256, 256); the full read, 5 bytes a pixel a
// layer, is 2.95 MB). The kernel reads up to G - 1 valid bytes past a
// pixel's first valid layer (the rest of its group); the bound does not
// count them. At the GetMap path's size a launch is bound by its own
// latency: the time is the launch and the slowest warp's chain of loads.
//
// Design: one thread per output pixel, consecutive threads on consecutive
// pixels of the flattened (H, W) plane, so every layer's loads coalesce.
// The scan is batched: a thread loads the valid bytes of G layers at once
// (G independent loads in flight; T = 8 is one round), resolves the first
// valid layer in registers, and only then loads that layer's value, so
// the latency chain is ceil(T / G) + 1 loads instead of T dependent ones.
// Groups after the one that holds a pixel's first valid layer are never
// read. The value is moved as its 32-bit pattern, never through a float
// register op, so NaN payloads and -0.0 pass unchanged. A grid-stride
// loop covers planes larger than the grid.
//
// Why this design: on the masked mosaic's own inputs (160 calls at
// (8, 256, 256), cloud and shadow blobs, nodata edges) a serial scan,
// one dependent load a layer, is fast on tiles whose warps all resolve
// at layer 0 and slow on tiles where one pixel of a warp scans deep; the
// batched scan takes one round on every tile. A 4-pixel-a-thread variant
// with 16-byte loads was 4% faster still on those inputs for twice the
// code, and was not kept (kernel_pair.py times such variants; PERF.md
// has the times).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // G: valid layers loaded at once
constexpr long long kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
first_valid_kernel(const uint32_t* __restrict__ stack,
                   const uint8_t* __restrict__ valid, int t_len,
                   long long hw, uint32_t* __restrict__ out,
                   uint8_t* __restrict__ ok) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < hw;
       p += step) {
    int hit = -1;
    for (int t0 = 0; t0 < t_len && hit < 0; t0 += kGroup) {
      uint8_t m[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        m[k] = t0 + k < t_len ? valid[(long long)(t0 + k) * hw + p] : 0;
      }
#pragma unroll
      for (int k = kGroup - 1; k >= 0; --k) {
        if (m[k]) hit = t0 + k;
      }
    }
    out[p] = hit >= 0 ? stack[(long long)hit * hw + p] : 0u;  // +0.0f
    ok[p] = hit >= 0 ? 1 : 0;
  }
}

}  // namespace

extern "C" int launch_first_valid(const void* stack, const void* valid,
                                  int t_len, long long hw, void* out,
                                  void* ok, void* stream) {
  if (t_len < 1 || hw < 1) {
    return (int)cudaErrorInvalidValue;
  }
  long long blocks = (hw + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  first_valid_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)stack, (const uint8_t*)valid, t_len, hw,
      (uint32_t*)out, (uint8_t*)ok);
  return (int)cudaGetLastError();
}
