"""Train state, step and logging of the PyTorch/CUDA port (mirrors genrec_tpu/core)."""
