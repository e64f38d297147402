"""First-valid temporal mosaic: kernel B4.

Counterpart of the mosaic half of `gsky_tpu/ops/pallas_tpu.py`
(`mosaic_first_valid_pallas` over `_mosaic_kernel`): per pixel, the
value of the first valid layer along a priority-ordered (T, H, W) stack,
+0.0 where no layer is valid, and the ok mask.  `mosaic_first_valid_kernel`
launches the hand kernel in `csrc/first_valid.cu` for CUDA tensors and
counts the launch; for CPU tensors it runs `mosaic_first_valid_plain`.
There is no fallback: a CUDA launch that fails raises.

The value is copied as bits: a NaN or -0.0 in a valid layer passes
through unchanged, and nothing of an invalid layer reaches the output.
The Pallas version pads H and W to 128; the kernel and the plain
version take any T, H, W >= 1.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLibrary, Kernel, check_cuda

_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("first_valid.cu", {
    "launch_first_valid": [_VP, _VP, _CI, _CLL, _VP, _VP],
})
first_valid_kernel = Kernel(LIBRARY, "launch_first_valid")


def mosaic_first_valid_plain(stack, valid):
    """Plain PyTorch version of kernel B4 (the Pallas kernel's scan):
    stack (T, H, W) f32, valid (T, H, W) bool or int8/uint8 (nonzero =
    valid) -> (out (H, W) f32, ok (H, W) bool)."""
    v = valid != 0
    out = torch.zeros(stack.shape[1:], dtype=torch.float32,
                      device=stack.device)
    done = torch.zeros(stack.shape[1:], dtype=torch.bool,
                       device=stack.device)
    for t in range(stack.shape[0]):
        out = torch.where(v[t] & ~done, stack[t], out)
        done = done | v[t]
    return out, done


def mosaic_first_valid_kernel(stack, valid):
    """Kernel B4 on CUDA tensors, its plain version on CPU tensors.
    stack (T, H, W) f32 and valid (T, H, W) bool/int8/uint8, both
    contiguous."""
    if stack.device.type == "cpu":
        return mosaic_first_valid_plain(stack, valid)
    if stack.device.type != "cuda":
        raise ValueError(f"unsupported device {stack.device}")
    if valid.dtype in (torch.bool, torch.int8):
        valid = valid.view(torch.uint8)
    check_cuda(stack, valid, dtypes=[torch.float32, torch.uint8])
    if stack.dim() != 3 or valid.shape != stack.shape \
            or stack.numel() == 0:
        raise ValueError(f"bad B4 operand shapes {tuple(stack.shape)} "
                         f"{tuple(valid.shape)}")
    T, H, W = stack.shape
    out = torch.empty((H, W), dtype=torch.float32, device=stack.device)
    ok = torch.empty((H, W), dtype=torch.bool, device=stack.device)
    first_valid_kernel(stack.device, stack.data_ptr(), valid.data_ptr(), T,
                       H * W, out.data_ptr(), ok.data_ptr())
    return out, ok
