"""gsky_tpu_torch: the PyTorch/CUDA port of gsky_tpu.

A second package beside the JAX reference.  It imports torch and never
jax, and nothing of gsky_tpu.  Entry points (`pipeline.tile.TilePipeline`,
`pipeline.executor.WarpExecutor`, `pipeline.scene_cache.SceneCache`,
`pipeline.pages.PagePool`, `pipeline.drill.DrillPipeline`,
`pipeline.drill_cache.DrillStackCache`) run on the CUDA card unless the
caller passes ``device="cpu"``; the hand-written kernels live in `csrc/`
and are compiled with nvcc on first use (`ops.cuda_lib`).
"""
