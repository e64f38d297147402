"""ops: device compute — warp, scaling and the hand-written kernels."""
