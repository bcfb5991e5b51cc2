"""genrec_tpu_torch: the PyTorch/CUDA port of genrec_tpu for NVIDIA Hopper.

Module paths mirror the JAX package (``genrec_tpu_torch/models/tiger.py``
pairs with ``genrec_tpu/models/tiger.py``), so each parity test names its
pair. The port imports torch, numpy and the standard library only: never
``jax`` and never ``genrec_tpu``.

Slices ported so far, each down to hand-written CUDA kernels in
``csrc/``: TIGER paged serving, fp32 or int8 pages
(``serving.engine.ServingEngine`` -> ``models.tiger`` paged decode ->
``ops.paged.paged_attention`` -> ``csrc/paged_attention.cu``); HSTU
training (``trainers.hstu_trainer`` -> ``models.hstu`` ->
``csrc/hstu_attention.cu``, ``csrc/fused_ce.cu``); RQ-VAE semantic ids
(``trainers.rqvae_trainer`` -> ``models.rqvae`` and the sem-id export
through ``csrc/rq_cascade.cu``).

Entry points run on the card: their ``device`` defaults to ``"cuda"`` and
they raise when no CUDA device is present. A caller that wants the CPU
passes ``device="cpu"`` (the CPU tests do).
"""
