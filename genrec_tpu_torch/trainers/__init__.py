"""Trainers of the PyTorch/CUDA port (mirrors genrec_tpu/trainers)."""
