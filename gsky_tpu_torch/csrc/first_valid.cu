// Kernel B4: first-valid temporal mosaic for the masked GetMap path.
//
// Replaces gsky_tpu/ops/pallas_tpu.py::_mosaic_kernel
// (mosaic_first_valid_pallas). For a priority-ordered stack (T, H, W) f32
// and valid (T, H, W) bytes (0 = invalid), per pixel p:
//   out[p] = stack[t, p] for the first t with valid[t, p] != 0, else +0.0
//   ok[p]  = 1 if any layer is valid, else 0
// (any T, H, W >= 1; the Pallas version pads H and W to 128).
//
// Bound on this card: bytes. The least it must move is every input byte
// once and every output byte once: 5 bytes a pixel a layer in, 5 bytes a
// pixel out, about 2.95 MB at the GetMap path's (8, 256, 256); there are
// no arithmetic operations at all. At that size a launch is bound by its
// own latency, not by the 3.35 TB/s rate.
//
// Design: one thread per output pixel, consecutive threads on consecutive
// pixels of the flattened (H, W) plane, so every layer's loads coalesce.
// The Pallas grid holds a whole (T, 128, 128) block in VMEM and scans it
// unrolled; here each thread walks t in order and stops at the first
// valid layer, so layers behind it are never read (that changes which
// bytes are read, not the result). The value is moved as its 32-bit
// pattern, never through a float register op, so NaN payloads and -0.0
// pass unchanged. A grid-stride loop covers planes larger than the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
first_valid_kernel(const uint32_t* __restrict__ stack,
                   const uint8_t* __restrict__ valid, int t_len,
                   long long hw, uint32_t* __restrict__ out,
                   uint8_t* __restrict__ ok) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x; p < hw;
       p += step) {
    uint32_t bits = 0u;  // +0.0f
    uint8_t hit = 0;
    for (int t = 0; t < t_len; ++t) {
      const long long i = (long long)t * hw + p;
      if (valid[i] != 0) {
        bits = stack[i];
        hit = 1;
        break;
      }
    }
    out[p] = bits;
    ok[p] = hit;
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
