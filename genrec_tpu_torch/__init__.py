"""genrec_tpu_torch: the PyTorch/CUDA port of genrec_tpu for NVIDIA Hopper.

Module paths mirror the JAX package (``genrec_tpu_torch/models/tiger.py``
pairs with ``genrec_tpu/models/tiger.py``), so each parity test names its
pair. The port imports torch, numpy and the standard library only: never
``jax`` and never ``genrec_tpu``.

Slice ported so far: TIGER paged serving. The request path is
``serving.engine.ServingEngine`` -> ``serving.heads.TigerGenerativeHead``
-> ``models.tiger`` paged prefill/decode -> ``ops.paged.paged_attention``
-> the hand-written CUDA kernel in ``csrc/paged_attention.cu``
(``kernels.paged_attention.paged_attention_stats_cuda``).

Entry points run on the card: their ``device`` defaults to ``"cuda"`` and
they raise when no CUDA device is present. A caller that wants the CPU
passes ``device="cpu"`` (the CPU tests do).
"""
