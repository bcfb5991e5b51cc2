"""Native (C++) host components (a port of genrec_tpu/native).

A zlib streaming field extractor for the Amazon review dumps
(``amazon_parser.cpp``, the JAX package's source byte for byte), compiled
on demand with g++ into ``build/`` and bound with ctypes. Host code, not a
device kernel: ``data/amazon.load_sequences`` parses in Python, with the
same output, when it cannot be built.
"""

from genrec_tpu_torch.native.loader import build_error, native_available, parse_reviews_native

__all__ = ["build_error", "native_available", "parse_reviews_native"]
