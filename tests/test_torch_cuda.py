"""The hand-written CUDA kernels on the card, held to their plain versions.

Needs an NVIDIA card of compute capability 9.0 (the kernels are built for
sm_90a) and the CUDA toolkit's nvcc; every test here is marked ``cuda``
and skips without them. This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX for the rest of the
suite.) Tolerance: rtol 1e-5, atol 1e-5. Kernel and plain version both
sum in fp32 and differ only in order: the kernel runs an online softmax
over 32-position chunks, the plain version one max and one sum.
"""

import numpy as np
import pytest
import torch

from genrec_tpu_torch.kernels.paged_attention import (
    paged_attention_stats_cuda,
    paged_attention_stats_ref,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


def _inputs(dev, S, K, H, hd, page, Pm, seq_lens, null_tail=False, seed=0):
    rng = np.random.default_rng(seed)
    P = 1 + S * Pm
    bt = (1 + np.arange(S * Pm)).reshape(S, Pm).astype(np.int32)
    if null_tail:  # unused entries point at the null page, as the pool pads
        used = -(-np.maximum(np.asarray(seq_lens), 1) // page)
        bt[np.arange(Pm)[None, :] >= used[:, None]] = 0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dict(
        q=t(rng.normal(size=(S, K, H, hd)).astype(np.float32)),
        k_pool=t(rng.normal(size=(P, page, H, hd)).astype(np.float32)),
        v_pool=t(rng.normal(size=(P, page, H, hd)).astype(np.float32)),
        block_tables=t(bt),
        seq_lens=t(np.asarray(seq_lens, np.int32)),
    )


@pytest.mark.parametrize("shape,lens,null_tail", [
    # TIGER Amazon serving shapes: 64 slots, 10 beams, 6 heads of 64, 4 pages of 16.
    ((64, 10, 6, 64, 16, 4), "random", False),
    ((64, 10, 6, 64, 16, 4), "random", True),
    ((5, 3, 2, 8, 8, 3), [24, 0, 9, 1, 17], True),  # a fully masked slot
    ((3, 32, 1, 128, 40, 2), [80, 41, 0], False),  # K and hd at their limits
])
def test_kernel_matches_plain_version(card, shape, lens, null_tail):
    S, K, H, hd, page, Pm = shape
    if lens == "random":
        lens = np.random.default_rng(1).integers(4, Pm * page + 1, S)
    x = _inputs(card, S, K, H, hd, page, Pm, lens, null_tail)
    before = paged_attention_stats_cuda.launches
    got = paged_attention_stats_cuda(**x)
    torch.cuda.synchronize()
    assert paged_attention_stats_cuda.launches == before + 1
    want = paged_attention_stats_ref(**x)
    for name, g, w in zip(("acc", "m", "l"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5, msg=name)


def test_kernel_wrapper_refuses_what_it_does_not_take(card):
    x = _inputs(card, 2, 3, 2, 8, 8, 2, [5, 9])
    before = paged_attention_stats_cuda.launches
    bad = [
        dict(x, q=x["q"].double()),
        dict(x, block_tables=x["block_tables"].long()),
        dict(x, k_pool=x["k_pool"].transpose(0, 1).contiguous().transpose(0, 1)),
        dict(x, k_pool=x["k_pool"].cpu()),
        dict(x, q=torch.zeros((2, 33, 2, 8), device=card)),  # K > 32
    ]
    for kwargs in bad:
        with pytest.raises(ValueError):
            paged_attention_stats_cuda(**kwargs)
    assert paged_attention_stats_cuda.launches == before
