"""kernels of the PyTorch/CUDA port (mirrors genrec_tpu/kernels)."""
