"""Tensor parallelism of the PyTorch/CUDA port (mirrors genrec_tpu/parallel)."""
