"""Backbones of the PyTorch/CUDA port (mirrors genrec_tpu/models/backbones)."""
