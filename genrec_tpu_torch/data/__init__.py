"""Data pipelines of the PyTorch/CUDA port (mirrors genrec_tpu/data)."""
