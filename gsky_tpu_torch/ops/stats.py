"""Masked per-row statistics for the drill: kernel B3.

Counterpart of the stats half of `gsky_tpu/ops/pallas_tpu.py`
(`masked_stats_pallas` over `_stats_kernel`).  `masked_stats` launches
the hand kernel in `csrc/masked_stats.cu` for CUDA tensors and counts
the launch; for CPU tensors it runs `masked_stats_plain`.  There is no
fallback: a CUDA launch that fails raises.

Summation order is part of the contract.  Both versions accumulate each
of 2048 lanes over the row's 2048-wide chunks in chunk order (the
per-lane partial sums of the Pallas kernel, whose grid carries them
from chunk to chunk), then reduce the lanes by one fixed pairwise tree.
So kernel and plain version agree to the bit; against the Pallas
kernel, whose final lane sum is XLA's `jnp.sum`, sums agree within
float32 reassociation and counts exactly.

`masked_stats_many` is the K-block form the drill's wave lane takes:
K drills' (B, N) blocks in one launch, each read where it lies (the
kernel takes their base pointers, so no (K, B, N) stack is copied),
every row through the same body; its plain version stacks them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_lib import CudaLibrary, Kernel, check_cuda

CHUNK = 2048          # lanes per row: the Pallas kernel's pixel chunk

MAX_BLOCKS = 64       # blocks one K-block launch takes (kMaxBlocks)

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("masked_stats.cu", {
    "launch_masked_stats": [_VP, _VP, _CF, _CF, _CI, _CI, _VP, _VP],
    "launch_masked_stats_many": [_VP, _VP, _CF, _CF, _CI, _CI, _CI, _VP,
                                 _VP],
})
masked_stats_kernel = Kernel(LIBRARY, "launch_masked_stats")
masked_stats_many_kernel = Kernel(LIBRARY, "launch_masked_stats_many")


def clip_f32(clip_lower, clip_upper):
    """The clip bounds as float32, as the Pallas kernel holds them."""
    return float(np.float32(clip_lower)), float(np.float32(clip_upper))


def masked_stats_plain(data, valid, clip_lower=-3.0e38, clip_upper=3.0e38):
    """Plain PyTorch version of kernel B3: data (B, N) f32, valid (B, N)
    bool or uint8 -> (sums (B,) f32, counts (B,) int32) over the valid
    pixels within [clip_lower, clip_upper], in the kernel's order."""
    B, N = data.shape
    lo, hi = clip_f32(clip_lower, clip_upper)
    inclip = (valid != 0) & (data >= lo) & (data <= hi)
    counts = inclip.sum(dim=-1, dtype=torch.int32)
    vals = torch.where(inclip, data, torch.zeros((), dtype=data.dtype,
                                                 device=data.device))
    full, rem = divmod(N, CHUNK)
    acc = torch.zeros((B, CHUNK), dtype=torch.float32, device=data.device)
    for c in range(full):
        acc = acc + vals[:, c * CHUNK:(c + 1) * CHUNK]
    if rem:
        tail = torch.zeros_like(acc)     # masked tail lanes add 0.0
        tail[:, :rem] = vals[:, full * CHUNK:]
        acc = acc + tail
    s = CHUNK
    while s > 1:
        s //= 2
        acc = acc[:, :s] + acc[:, s:2 * s]
    return acc[:, 0].contiguous(), counts


def masked_stats(data, valid, clip_lower=-3.0e38, clip_upper=3.0e38):
    """Kernel B3 on CUDA tensors, its plain version on CPU tensors.
    data (B, N) f32, valid (B, N) bool/uint8, both contiguous."""
    if data.device.type == "cpu":
        return masked_stats_plain(data, valid, clip_lower, clip_upper)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    if valid.dtype == torch.bool:
        valid = valid.view(torch.uint8)
    check_cuda(data, valid, dtypes=[torch.float32, torch.uint8])
    if data.dim() != 2 or valid.shape != data.shape or data.numel() == 0:
        raise ValueError(f"bad B3 operand shapes {tuple(data.shape)} "
                         f"{tuple(valid.shape)}")
    B, N = data.shape
    lo, hi = clip_f32(clip_lower, clip_upper)
    sums = torch.empty((B,), dtype=torch.float32, device=data.device)
    counts = torch.empty((B,), dtype=torch.int32, device=data.device)
    masked_stats_kernel(data.device, data.data_ptr(), valid.data_ptr(), lo,
                        hi, B, N, sums.data_ptr(), counts.data_ptr())
    return sums, counts


def masked_stats_many_plain(datas, valids, clip_lower=-3.0e38,
                            clip_upper=3.0e38):
    """Plain version of B3's K-block form: K (B, N) data and valid
    blocks -> (sums (K, B) f32, counts (K, B) int32), stacked and
    reduced row by row as `masked_stats_plain` reduces them."""
    K = len(datas)
    B, N = datas[0].shape
    s, c = masked_stats_plain(torch.stack(list(datas)).reshape(K * B, N),
                              torch.stack(list(valids)).reshape(K * B, N),
                              clip_lower, clip_upper)
    return s.reshape(K, B), c.reshape(K, B)


def masked_stats_many(datas, valids, clip_lower=-3.0e38, clip_upper=3.0e38):
    """Kernel B3's K-block form on CUDA tensors, its plain version on
    CPU tensors: K <= `MAX_BLOCKS` blocks of one (B, N) shape, data f32
    and valid bool/uint8, each contiguous where it lies ->
    (sums (K, B) f32, counts (K, B) int32)."""
    datas, valids = list(datas), list(valids)
    if datas[0].device.type == "cpu":
        return masked_stats_many_plain(datas, valids, clip_lower,
                                       clip_upper)
    if datas[0].device.type != "cuda":
        raise ValueError(f"unsupported device {datas[0].device}")
    K = len(datas)
    if not 1 <= K <= MAX_BLOCKS or len(valids) != K:
        raise ValueError(f"B3 takes 1 to {MAX_BLOCKS} blocks, got {K}")
    valids = [v.view(torch.uint8) if v.dtype == torch.bool else v
              for v in valids]
    shape = tuple(datas[0].shape)
    for d, v in zip(datas, valids):
        check_cuda(datas[0], d, v,
                   dtypes=[torch.float32, torch.float32, torch.uint8])
        if tuple(d.shape) != shape or tuple(v.shape) != shape:
            raise ValueError("B3 blocks must share one (B, N) shape")
    if len(shape) != 2 or datas[0].numel() == 0:
        raise ValueError(f"bad B3 block shape {shape}")
    B, N = shape
    lo, hi = clip_f32(clip_lower, clip_upper)
    dev = datas[0].device
    sums = torch.empty((K, B), dtype=torch.float32, device=dev)
    counts = torch.empty((K, B), dtype=torch.int32, device=dev)
    dptr = (ctypes.c_void_p * K)(*[d.data_ptr() for d in datas])
    vptr = (ctypes.c_void_p * K)(*[v.data_ptr() for v in valids])
    masked_stats_many_kernel(dev, dptr, vptr, lo, hi, K, B, N,
                             sums.data_ptr(), counts.data_ptr())
    return sums, counts
