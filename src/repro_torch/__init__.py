"""repro_torch — the PyTorch/CUDA port of the ``repro`` GEMM autotuner,
for NVIDIA Hopper.  It imports neither JAX nor the ``repro`` package;
``repro`` stays the reference it is tested against."""
