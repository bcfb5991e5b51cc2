"""catalog of the PyTorch/CUDA port (mirrors genrec_tpu/catalog)."""
