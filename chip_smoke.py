#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (genrec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--requests 384] [--out FILE] [--profile]
                          [--phases a,b,...]

Needs a CUDA device, nvcc (PATH or /usr/local/cuda/bin) and the repo
checkout beside this script; it imports nothing of JAX. Phases, one JSON
line each; any failure ends the run with a traceback and a non-zero exit:

1. env      the card, its power limit (nvidia-smi), torch and CUDA versions;
2. build    nvcc builds every kernel library of the port from
            genrec_tpu_torch/csrc/ into build/, for sm_90a, one nvcc per
            source, all started together;
3. kernel   each kernel against its plain PyTorch version on the card, in
            its edge cases and at the shapes its main path gives it (B1 and
            B2 at the TIGER serving shapes and at COBRA's (K 20, H 6, hd
            128, page 16, Pm 5: the `_cobra` rows, each with free slots
            at seq_len 0 beside full ones), and over the speculative
            tree's node axis (the `_tree` rows: B1 and B2 at TIGER's 730
            nodes, hd 64, B1 at COBRA's 180 nodes, hd 128), and a bf16
            model's variants (B1 over bf16 pages with a bf16 q at TIGER's
            and COBRA's shapes and over TIGER's tree: the `_bf16`,
            `_bf16_cobra` and `_bf16_tree` rows; B2 with a bf16 q at
            both shapes: the `_quantized_bf16q` and
            `_quantized_bf16q_cobra` rows, each held at the fp32 rows'
            1e-5; their bf16-q kernel spills nothing at hd 32, 64 and
            128, and COBRA's bf16 block fits three times or more an SM);
            B3-B6 at the HSTU training
            shapes, B5 also at the retrieval serving buckets with
            right-aligned rows, all-padding rows exactly 0; B7 at the
            RQ-VAE export's; table_grad, the port-only kernel of TIGER's
            bias-grid gradient, at the TIGER step's 5.7 M reads against
            fp64 sums), then timed by device time
            (CUDA-graph replay of calls on inputs cold in L2): the kernel,
            the plain version, one PyTorch library call computing the same
            function where there is one (a yardstick only), and the least
            time the card could take (bytes over 3.35 TB/s, or operations
            over the data-sheet peak of the inputs' type: 67 TFLOP/s fp32,
            989 TFLOP/s bf16); the bf16 B3 and B4 rows (forward, dx, dW)
            also give their TFLOP/s, share of the bound, workspace bytes,
            the registers, spills and shared memory of their kernels
            (ptxas -v), and a check that two calls give the same bits; B1
            and B2 also run their edge cases (scores within 128 of -1e9,
            seq_len past Pm * page with block-table entries outside [0, P),
            S = 1 and 16, a shape that streams through the ring), each
            launching exactly once, give equal bits over two calls, are
            timed at S = 16 beside S = 64, and report the K/V bytes the
            call needs against those of every position, the share of the
            bound, and the ptxas numbers and launch shape of a block
            (threads, nodes, blocks along z, shared memory, blocks an
            SM); the
            bf16 B6 and B7 give equal bits over two calls and report their
            ptxas numbers, B6's time is also split by kernel (its own, the
            table sums), and the time-bucket sweep runs through B5 and the
            bf16 B6;
4. train    HSTU at the widths of config/hstu/amazon.gin through the port's
            trainer (hstu_trainer.train, 2 epochs with eval, synthetic data
            with Amazon-Beauty's 12,101 items), then a fixed number of steps
            through make_train_step + PackedTrainLoop on SyntheticSeqDataset
            with Amazon-Beauty's item and user counts: steps/s, tokens/s,
            p50 step time, first and last loss, valid Recall@10/NDCG@10, and
            the kernels' launches per step, which must be exactly 2 (B5),
            2 (B6), 1 (B3), 1 (B4 dx), 1 (B4 dW); with --profile, more steps
            under torch.profiler (device idle share, top kernels);
5. parity   20 steps from one init on the same batches, dropout 0 and fp32,
            through the kernels (use_pallas=use_fused_ce=True) and through
            the plain path (both False): the loss trajectories must agree;
6. sasrec   SASRec at the widths of config/sasrec/amazon.gin:
            sasrec_trainer.train through that file (2 epochs with eval,
            synthetic data with Amazon-Beauty's 12,101 items; its loss must
            fall), fixed steps on the train phase's data (steps/s, tokens/s,
            p50 step, losses, valid Recall@10/NDCG@10 of right-aligned rows)
            launching B3, B4 dx and B4 dW exactly once a step and no other
            kernel, 20 fp32 steps through the kernels against the plain path
            (losses within 1e-4 relative), and B3/B4 on the step's own
            operands (the tied item table; the `_sasrec` rows);
7. rqvae    the RQ-VAE at the widths of config/tiger/amazon/rqvae.gin:
            rqvae_trainer.train through that file (synthetic item
            embeddings at Amazon-Beauty's 12,101 items x 768, epochs cut to
            RQVAE_EPOCHS), whose loss must fall; fixed steps (steps/s, p50
            step); the sem-id export over the 12,101 items, which must launch
            B7 exactly ceil(12,101 / 4096) = 3 times and equal the model
            path's get_semantic_ids outside near ties (counted);
8. serve    TIGER at the Amazon widths of config/tiger/amazon/tiger.gin,
            random weights from --seed, answering --requests requests through
            ServingEngine + TigerGenerativeHead, with float32 pages (B1, 4
            launches a decode step) and then the same requests with int8
            pages (B2, 4 launches a decode step, B1 none); every answer must
            be a catalog item, and a sample must equal offline
            tiger_generate_paged of the same page type on the card (fp32:
            also on the CPU). With --profile the traffic is served once
            more under torch.profiler, and the RQ-VAE runs one more epoch
            under it. Then serve_bf16: the same seeded weights computing in
            bf16, the same requests with bf16 pages (B1 over bf16 pages, 4
            launches a decode step, no fp32 B1) then int8 pages (B2 with a
            bf16 q), each burst's top-10 agreement with the fp32 burst,
            its pool bytes (bf16 exactly half fp32's), 12 answers matched
            tuple by tuple to offline bf16 tiger_generate_paged on the card
            within 1e-3 (SAMPLE_ATOL);
9. cobra    COBRA at the widths of config/cobra/amazon.gin (tower: 1
            layer, hidden 768, 8 heads, vocab 32,128; 256 x 3 codebooks,
            d_model 768 over 6 heads of 128, 8 decoder layers, FFN 2,048),
            random weights from --seed, 12,101 catalog items with 32 text
            tokens each, the tower encoded once on the card; --requests
            requests (the valid-split histories of the synthetic
            Amazon-Beauty users, newest 20 items) through ServingEngine +
            CobraGenerativeHead, 20 beams, 64 slots of 5 pages of 16,
            float32 pages (B1) then int8 pages (B2): exactly 8 launches of
            the page type's kernel a decode step and none of any other
            kernel, 2 decode steps a request, every answer a catalog item,
            12 answers against offline cobra_generate_paged of the same
            page type on the card, 8 of them rows whose history fills its
            bucket (only those read the decode steps' attention), 4 of
            those also on the CPU (the kernels' plain versions); with
            --profile the traffic once more under torch.profiler. With
            float32 pages a burst of 128 more requests under torch.profiler
            gives the prefill's share of the device's busy time (marker
            kernels around every prefill call). Then cobra_serve_bf16: the
            same for the same weights computing in bf16 (bf16 pages, then
            int8 pages under a bf16 q; 8 launches a decode step; the
            sample on the card only, matched as serve_bf16's);
10. retrieve SASRec (fp32) and HSTU (bf16, B5) retrieval heads at their
            Amazon widths in one ServingEngine, random weights from --seed,
            one engine with the fp32 item table and one with the int8 one,
            answering the valid-split histories of the synthetic
            Amazon-Beauty users: five bursts of RETRIEVE_BURST requests a
            table, interleaved (qps of each), then RETRIEVE_OPEN requests at
            Poisson arrivals of RETRIEVE_RATE a second (p50 and p99 by head,
            bucket hits); B5 launched exactly twice an HSTU micro-batch and
            no other kernel; every item a catalog item; a sample of each
            load against offline last_hidden + item_topk on the card; int8
            recall@10 against fp32 >= 0.8 for every request;
11. lcrec   LCRec SFT at tensor_parallel=2 at Qwen2.5-1.5B widths
            (QwenConfig() with config/lcrec/amazon/lcrec.gin): first B3 and
            B4 at one rank's shard of the head (8 x 511 rows, 76,608 vocab
            rows, d 1,536, bf16; a full and a ragged live-vocab limit) and
            at d = 64, 1,000, 1,536, 2,048 at a small size, held to their
            plain versions and timed, as in phase 3 (part of phase 3);
            then the tp=1 side
            of a parity run and the library yardstick of B8 here, and 2
            ranks through parallel.mesh.spawn (gloo with both ranks on the
            one card, NCCL where each has its own): (a) B8 against its plain
            twin at the full-width head (targets on the other shard, all
            rows ignored, an empty shard); (b) 5 fp32 steps of 2 layers at
            full widths and vocab against the tp=1 run, losses within 1e-4
            relative; (c) all 28 layers, bf16, batch 8 x 512, LCREC["steps"]
            fixed steps with B3, B4 dx and B4 dW launched exactly once a
            step a rank, no non-finite skip and the same loss on both ranks
            (steps/s, tokens/s, p50 step, collectives and bytes a step,
            peak memory a rank; with --profile the device idle share and
            top kernels of 3 more steps); (d) lcrec_trainer.train through
            config/lcrec/synthetic.gin at tensor_parallel=2, whose loss
            must fall.

12. tiger_train TIGER at the widths of config/tiger/amazon/tiger.gin:
            tiger_trainer.train through that file (2 epochs of the trainer's
            own synthetic data, warm-up cut with the epochs; its epoch loss
            must fall), then TIGER_TRAIN["steps"] bf16 steps (dropout 0.1,
            AdamW on the file's schedule, clip 1.0) of the trainer's packed
            step on synthetic_tiger_data at Amazon-Beauty's 12,101 items and
            22,363 users (<= 4 segments a row of 61): p50 step, steps/s, real
            tokens/s, examples/s, packing occupancy, the last 5 losses below
            the first 5, no TPU kernel launched and table_grad (the bias
            grid's gradient) once a self-attention layer a step; 5 more
            steps under torch.profiler give the device time a step (10
            with --profile);
13. tiger_decode the trained weights through the trainer's generate
            (cached, sampled, T 0.2, 10 beams, KK 60) over 2,048 valid
            users at batch 64: Recall/NDCG@10, ms a batch, every tuple a
            catalog item (tuples_are_valid), no row repeating a beam, no
            kernel; on a float32 copy, deterministic cached against uncached
            (one batch) and dense against tiger_generate_paged (4 batches,
            B1 exactly 12 launches a batch and nothing else): sem-ids equal
            outside near ties, log-probs within 1e-4;
14. cobra_train COBRA at the widths of config/cobra/amazon.gin (77.3 M
            parameters), bf16, dropout 0.1: cobra_trainer.train through that
            file with the cobra_serve phase's data fed by the callable
            dataset hook (1 epoch, the final valid and test evals; loss_sparse
            must fall over the epoch, loss_dense, at its chance level, must
            not rise by more than 1%), COBRA_TRAIN["steps"]
            timed steps of the trainer's step (p50, steps/s, finite losses,
            no kernel; with --profile 10 more under torch.profiler), then
            one eval: the tower over the 12,101 items and beam fusion (20
            beams, 10 candidates) on 512 valid users (Recall@10, the seconds
            of each part).
15. tiger_spec_serve TIGER's speculative engine (spec_decode=True, the
            default fanout 8: trees of 730 nodes a slot) at the serve
            phase's widths, catalog and requests plus a quarter of them
            again, beside the plain engine on the same traffic, both
            served in waves of 64 (the slots), fp32 pages then int8
            (tiger_spec_serve_int8), then the serve phase's weights
            computing in bf16 over bf16 pages (tiger_spec_serve_bf16):
            every answer's sem-ids equal the plain engine's and its scores
            within 1e-4 / T (5e-4 at TIGER's T 0.2, 1e-4 for COBRA at T 1);
            every repeat admits warm from the prefix cache and answers as
            its original (bf16: tuple by tuple within BF16_SPEC_ATOL, and
            at most a tenth of the answers beyond 1e-4 / T); B1 (B2) 4
            times a verify call and no other kernel; the pool, the scratch
            pages and the prefix index empty after the drain; verify calls
            a request, mean accept length, prefix hits, qps and p50 beside
            the plain engine's;
16. cobra_spec_serve the same for COBRA (trees of 180 nodes, B1 8 times
            a verify call), fp32 pages; a repeat prefilled at a larger
            bucket than its own is held to offline cobra_generate_paged at
            its own bucket (its warm admit judges `full` there).
17. serve_live the serving engine operated live, TIGER at the serve phase's
            widths, catalog and fp32 pages (B1): an engine whose
            hbm_budget_bytes is below its KV pool is refused at start(),
            naming kv_page_pool; then 3 x --requests requests as one burst
            on an engine with the checkpoint and catalog watchers, an
            enabled SpanTracer and a budget of the ledger's total plus 10%,
            during which step 2 (a second seeded init) is published after a
            third of the answers and a snapshot without 1% of the items
            after two thirds: every response names one params step and one
            catalog version, is legal under that version (no removed item
            after the swap), one swap each, B1 4 times every decode call
            and no other kernel, a complete span tree a request, 2 answers
            (admitted cold) of each (step, catalog) pair against offline
            tiger_generate_paged under that pair's weights and trie; then a
            step 3 damaged before publication is quarantined while step 2
            serves, a pre-swap request admits cold then warm, the ledger's
            operands equal the bytes they name, and the Prometheus text
            parses with the swap counters and the ledger gauges; reported:
            the longest gap between answers at each swap, the ledger's
            total over the allocator's peak, qps with the tracer on and off
            (alternately, twice); then an engine with a p99 target of 1 ms
            sheds (OverloadError) while accepted work completes and un-sheds
            when traffic stops, and one with handle_signals=True drains on
            a SIGTERM sent mid-burst (every accepted request answered, then
            DrainingError, the previous handler restored); last
            (cobra_live) COBRA at the cobra_serve phase's widths and users:
            a text-only snapshot staged on this thread while the engine
            serves (the tower encoded here, its seconds reported), B1 8
            times every decode call before and after the swap, 2 post-swap
            answers against offline cobra_generate_paged.
18. resume   the trainers' fault tolerance: (a) hstu_trainer.train through
            config/hstu/amazon.gin on the Beauty set (bf16, dropout 0.2,
            kernels on, 2 epochs, a resume point an epoch) uninterrupted,
            then killed by SIGTERM (core.chaos) inside epoch 1 and resumed:
            the same steps logged once each, the per-step losses and the
            final resume point (parameters, moments, counters, generator)
            bit for bit, B5, B6, B3, B4 dx, B4 dW 2, 2, 1, 1, 1 times a
            resumed step; (b) SASRec likewise, signalled between the
            epochs (B3/B4 once a step); (c) the killed HSTU run's newest
            resume point garbled: the resume quarantines it, falls back to
            the epoch-0 one and ends bit-equal; (d) lcrec_trainer.train at
            tp=2 (2 layers at the Qwen2.5-1.5B widths and vocab, B8) with
            only rank 1 signalled: both ranks save at the same step, resume
            bit-equal, B8 once a step a rank, and eval_only of the final
            point gives the resumed run's valid metrics; (e) three NaN
            batches in a row through the HSTU loop: the parameters unchanged,
            three dumps, NonFiniteLossError at the third. Reported: the
            resume points' bytes, the seconds of an asynchronous save
            (what the loop waits for), of a wait=True preemption save and
            of a restore, and the goodput buckets of the resumed epoch.
19. amazon   the Amazon data paths over one seeded dump in the SNAP 2014
            layout at Amazon-Beauty 5-core's counts (22,363 users, 12,101
            items, 198,502 reviews; write_amazon_dump), its P5-layout copy
            and 12,101 x 768 clustered item embeddings standing in for
            sentence-T5's: (a) load_sequences through the native parser
            (built from genrec_tpu_torch/native into build/), then through
            Python: the caches equal, each parse's host seconds, which
            parser ran and, if the build failed, why; (b) hstu_trainer and
            sasrec_trainer through config/{hstu,sasrec}/amazon.gin (2
            epochs, eval on): B5 x2, B6 x2, B3, B4 dx, B4 dW an HSTU step
            (B5 also x2 an eval batch), B3, B4 dx, B4 dW a SASRec step and
            nothing else, epoch losses falling, steps/s and p50 step;
            (c) pipelines.run_two_stage TIGER (config/tiger/amazon/{rqvae,
            tiger}.gin; RQ-VAE 20 epochs, TIGER 1 epoch, eval on 512
            seeded users): B7 once a chunk of each collision eval and of
            the export, a 12,101 x 3 artifact, no kernel in a TIGER step,
            the loss falling; (d) the same for LCRec (config/lcrec/amazon/
            {rqvae,lcrec_debug}.gin, 5 levels; random Qwen2.5-1.5B widths
            at 2 layers over the dump's words, tp=1, 2 epochs of 12 steps):
            a 12,101 x 5 artifact, B3, B4 dx, B4 dW once a step, no
            non-finite step, the epoch loss falling; (e) rqvae_trainer
            through config/rqvae/p5_amazon.gin on the P5 copy (200
            iterations), the export through B7; and B7 at LCRec's 5 levels
            against its plain version on one export chunk. The cuts are in
            its `reduced` field; its launches join the kernels line's.
20. notellm  NoteLLM at QwenConfig()'s Qwen2.5-1.5B widths (28 layers, bf16,
            the pair data's vocabulary): (a) the trainer's own model, loss
            and optimizer (notellm_trainer.notellm_model / notellm_loss /
            make_optimizer) on 32 rows of 128 a step, NOTELLM["steps"] timed
            after NOTELLM["warm"] (p50, steps/s), 3 more under torch.profiler
            (the device's busy ms a step), the peak allocated bytes; every
            loss finite, tau moved, the paired top-5 accuracy over the eval
            topics computed, no kernel of the port launched; (b)
            notellm_trainer.train through config/notellm/synthetic.gin at 2
            layers of the same widths, killed by SIGTERM mid-epoch and
            resumed: losses and the final resume point bit for bit, the
            same test metric.
21. qwen_serve one ServingEngine serving LCRecGenerativeHead (5 x 256
            codebooks, 10 beams, 12,101 items with distinct random sem-ids)
            and NoteLLMRetrievalHead (12,101 random unit vectors of 1,536,
            top 10), each model at the Qwen2.5-1.5B widths in bf16, ladder
            (1, 2, 4, 8, 16) x (4, 8, 16): a burst of 256 requests a head
            (qps, p50, p99), every LCRec answer a catalog item, 12 requests
            a head served alone against offline generate_topk_constrained /
            query2embedding_forward + item_topk (sem-ids and items equal,
            scores within 1e-3), then a catalog swap each into the next
            capacity rung (20,000 items): the answers name the new version
            and come from the new catalog; no kernel of the port launched.
22. lcrec_lora the LCRec SFT step under LoRA at tp=1 (rank 8, alpha 16 on
            q_proj and v_proj; the lcrec_tp phase's 28 layers, bf16, batch
            8 x 512): LORA["steps"] steps after LORA["warm"] launching B3
            and B4 dx exactly once a step and B4 dW never (a frozen head),
            the base bit-unchanged, every adapter moved, the loss fallen;
            p50 step, the adapters' parameter count, an adapter resume
            point's bytes; then lcrec_trainer.train with use_lora=True at 2
            layers killed and resumed, held bit for bit. Its launches join
            the kernels line's `_lcrec` rows (B4 dW 0 there).
23. pipeline scripts/check_pipeline.py's continuous loop at TIGER_AMAZON
            widths over the serve phase's catalog: seeded records (the
            trainer's rows: user id, 20 x 3 input and 3 target sem-ids)
            appended to the CRC-framed stream log by a worker process
            (this script with --pipeline-worker) SIGKILL'd mid-stream
            (die_in_append_at_record) and rerun: none lost, none
            duplicated; StreamTrainer over 3 chunks of 4 tiger_train steps
            (unpacked rows), an uninterrupted oracle in this process and a
            worker SIGKILL'd mid-commit (die_in_save_at_step) and rerun:
            per-step losses and every published tree within 1e-5 of the
            oracle's (the largest differences printed); then
            RolloutController over two fp32 paged replicas (replica_id r0,
            r1) under a background prober: the last trained step vetted,
            canaried and promoted, a x60 tree vetoed and quarantined with
            both replicas' weights bit-unchanged, a live chunk appended,
            trained by a worker and promoted (freshness_s); no response on
            an unvetted step, both pools clean after the drain, B1
            launched (added to the kernels line) and no other kernel; last,
            TIGER and COBRA (amazon.gin widths) each served by a paged=False
            engine and a paged one, every request alone: sem-ids equal
            (beams within the bound may trade ranks), scores within 1e-4 / T.
            The two uninterrupted oracle runs must publish bit-equal trees
            (the TIGER step's bias-grid gradient sums in a fixed order:
            table_grad);
24. tiger_tp TIGER at tiger.gin widths under tensor parallelism (tp=2,
            gloo ranks on the one card): 5 fp32 steps at dropout 0 on the
            Beauty set's packed rows against tp=1 (<= 1e-4 relative);
            tiger_trainer.train(tensor_parallel=2) through tiger.gin, bf16,
            dropout 0.1 (batch 128, one epoch: enough steps for a kill),
            the ranks' metrics equal, its p50 step and collectives a step; the same
            run killed on rank 1 and resumed, bit for bit; no TPU kernel,
            table_grad once a layer a step;
25. qwen_tp4 LCRec at the Qwen2.5-1.5B widths (H 12, KV 2) at tp=4, each
            KV head on two ranks, 2 of 28 layers: B8 over four shards
            against its twin (the `sharded_fused_linear_ce_4` row), 5 fp32
            steps against lcrec_tp's tp=1 side (<= 1e-4 relative), the
            replicated k_proj / v_proj rows bit-equal on their holders,
            bf16 steps at batch 8 x 512 with B3', B4' dx, B4' dW and B8
            once a step a rank;
26. moe      LCRec at the same widths with config/lcrec/synthetic_moe.gin's
            MoE (4 experts, top 2, capacity 2.0, aux 0.01), 2 of 28 layers:
            ep=1 here twice (equal bits) against ep=4 on four gloo ranks,
            5 fp32 steps (<= 1e-4 relative); bf16 steps at batch 8 x 512
            with B3, B4 dx, B4 dW once a step a rank, the loss falling,
            the router loss and the dropped share reported; the cached
            decode against the forward at ample capacity.
27. dp       data parallelism and 2-D layouts (A17) over gloo ranks on
            the one card, every layout from one init on the same global
            batches, each rank keeping its rows: on two ranks at dp = 2,
            (a) HSTU (amazon.gin widths, 128 packed rows, 5 fp32 steps,
            dropout 0.2, B5 2, B6 2, B3 1, B4 dx 1, B4 dW 1 a step a
            rank) and (b) SASRec (B3, B4 dx, B4 dW once a step a rank)
            against one rank (<= 1e-4), then hstu_trainer.train for one
            epoch: the loss falls, rank 1 signalled, both ranks stop at
            the next poll, data rank 0 writes the one resume point, the
            resume bit for bit; (c) RQ-VAE (rqvae.gin widths, Sinkhorn
            last layer) 5 steps, its export's ids bit-equal to one rank's
            with B7 once a chunk a rank; (f) COBRA and NoteLLM 3 steps
            each; on four ranks, (d) LCRec at tp = 2 x dp = 2 (Qwen2.5-1.5B
            widths, 2 layers, batch 8 x 512) against tp = 2 x dp = 1 in
            fp32, bf16 steps with B8 once a step a rank, their p50 and
            collectives and bytes a step by mesh axis; the MoE at tp = 2 x
            ep = 2 against ep = 1 (<= 1e-5) and at dp = 2 (the router
            loss within 1e-5, the dropped share equal); (e) TIGER at
            tp = 2 x dp = 2 against tp = 1.

``--phases a,b,...`` runs only the named phases (env and build always
run; the kernels line is printed only by a run of every phase), e.g.
``python3 chip_smoke.py --phases tiger_tp,qwen_tp4,moe``.

Each phase that drives a main path sets every kernel's launch counter to 0
just before and reads it just after. Then the kernels line, the card's
name and power limit as nvidia-smi prints them, and, last,
{"ok": true, "device": {...}}.

TF32 is off for matrix products and convolutions, as the JAX package's
CPU reference computes.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gc
import gzip
import itertools
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
_STARTED = time.perf_counter()

# H100 SXM data-sheet peaks (NVIDIA): HBM bytes/s, float32 FLOP/s outside
# the tensor cores, dense bf16 FLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
L2_BYTES = 50 * 2**20

# TIGER, config/tiger/amazon/tiger.gin (dim_feedforward from
# genrec_tpu/models/tiger.py:119). Depth is not cut.
TIGER_AMAZON = dict(
    embedding_dim=128, attn_dim=384, num_heads=6, n_layers=8,
    num_item_embeddings=256, num_user_embeddings=10000, sem_id_dim=3,
    dim_feedforward=1024,
)
MAX_ITEMS = 20  # train.max_items: histories of <= 20 items, 61 KV tokens
CATALOG_ITEMS = 12101  # items of Amazon-Beauty (the 2014 5-core split)
BEAMS = 10
PAGED = dict(max_slots=64, page_size=16, pages_per_slot=4)
KERNEL_RTOL = KERNEL_ATOL = 1e-5  # fp32 both sides, summation order differs

# COBRA, config/cobra/amazon.gin: the tower (1 layer, hidden 768, 8 heads,
# FFN 2,048, vocab 32,128), 256 x 3 codebooks, d_model 768 over 6 decoder
# heads (head_dim 128), 8 decoder layers, FFN 2,048, max_len 1,024; beams
# = train.n_beam; item text of amazon_cobra_data's max_text_len tokens.
# float32, random weights from --seed; depth not cut. Histories of 1-20
# items (train.max_items) take 4 KV positions an item: 5 pages of 16.
COBRA_AMAZON = dict(encoder_n_layers=1, encoder_hidden_dim=768, encoder_num_heads=8,
                    encoder_vocab_size=32128, id_vocab_size=256, n_codebooks=3,
                    d_model=768, max_len=1024, temperature=0.2, decoder_n_layers=8,
                    decoder_num_heads=6, decoder_dropout=0.1)
COBRA_BEAMS = 20
COBRA_TEXT_LEN = 32
COBRA_PAGED = dict(max_slots=64, page_size=16, pages_per_slot=5)
PREFILL_SHARE_REQUESTS = 128  # the profiled burst that splits COBRA's device time
PROFILE_EDGE_S = 0.05  # idle time between the profiler's window edges and a marked burst
COBRA_SHAPE = (COBRA_BEAMS, COBRA_AMAZON["decoder_num_heads"],
               COBRA_AMAZON["d_model"] // COBRA_AMAZON["decoder_num_heads"],
               COBRA_PAGED["page_size"], COBRA_PAGED["pages_per_slot"])

# Speculative tree decode: the engine's default fanout. TIGER's tree (10
# beams, spec_depth 2) has 10 + 80 + 640 = 730 nodes a slot, COBRA's (20
# beams, spec_depth 1) 20 + 160 = 180; B1/B2 take them where the beams were.
SPEC_FANOUT = 8
# Requests of a spec phase's traffic served at once: the engine's slots, so
# both engines (spec and plain) prefill the same groups of the same requests
# and hold the same pages (int8 rounding included).
SPEC_WAVE = 64
# Spec against plain engine, and a warm answer against its cold one: 1e-4
# at T = 1, scaled by the 1 / T the softmax temperature applies (TIGER
# decodes at T 0.2). The tree pass runs its GEMMs over S x N rows where the
# plain step runs S x K, so cuBLAS sums in other orders (~1e-5 in the
# logits); the sem-ids are held exactly.
SPEC_SCORE_TOL = 1e-4
# A bf16 model's speculative engine against its plain one: the tree pass
# runs its GEMMs over S x N rows where the plain step runs S x K, and an
# fp32 sum in another order can round a bf16 activation one step (2^-8)
# apart; that moved one answer of 64 by 0.312 at T = 0.2 on the H100 (the
# other 63 by 0). So answers are matched tuple by tuple within
# BF16_SPEC_ATOL, and at most BF16_SPEC_MAX_SHARE of them may differ by more
# than SPEC_SCORE_TOL / T: a wrong kernel moves every answer, a rounding
# flip a few. (The burst against offline decoding runs the same tree-free
# step and is held at SAMPLE_ATOL.)
BF16_SPEC_ATOL = 0.5
BF16_SPEC_MAX_SHARE = 0.1
SPEC_MAX_WAIT_MS = 20.0  # coalesces a wave into full prefill groups

# HSTU, config/hstu/amazon.gin; depth not cut. Amazon-Beauty (2014 5-core):
# 12,101 items, 22,363 users.
HSTU_AMAZON = dict(embed_dim=64, num_heads=2, num_blocks=2, max_seq_len=50,
                   num_position_buckets=32, num_time_buckets=64,
                   max_position_distance=128)
HSTU_BATCH = 128
BEAUTY_ITEMS, BEAUTY_USERS = 12101, 22363
# Measured steps of the fixed-step run, after 3 warm-up steps, all inside the
# first epoch (~50 steps of 128 packed rows at Amazon-Beauty's size).
TRAIN_STEPS = 40
PARITY_STEPS = 20
# Kernel against plain version, max |diff| <= tol * max |plain|:
# fp32 on both sides differs only in summation order; with bf16 inputs
# both accumulate in fp32 and round the result to bf16 (2^-8 relative),
# where a different order can flip the rounding by one bf16 step.
FP32_TOL = 1e-5
BF16_TOL = 1e-2
# The bias-table gradients are fp32 sums of ~4e4 terms of ds per head (every
# visible pair of the batch) in other orders (the plain version adds with
# index_add_), so their rounding grows with the count.
TABLE_TOL = 1e-4
# Loss trajectories, kernels vs plain path, fp32: the paths sum in other
# orders (GEMM blocking, online logsumexp), and Adam carries the ~1e-7
# differences of each step's gradients into the next step's weights.
PARITY_RTOL = 1e-4
# Launches of each kernel in one training step of the 2-block model.
LAUNCHES_PER_STEP = {"hstu_attention_fwd": 2, "hstu_attention_bwd": 2,
                     "fused_linear_ce_fwd": 1, "fused_linear_ce_bwd_dx": 1,
                     "fused_linear_ce_bwd_dw": 1}

# SASRec, config/sasrec/amazon.gin (embed 64, 2 heads, 2 blocks, FFN 256,
# L 50, dropout 0.2, bf16, batch 128 packed rows, Adam 1e-3); depth not cut.
# Trained on the HSTU phase's synthetic Amazon-Beauty data.
SASREC_AMAZON = dict(embed_dim=64, num_heads=2, num_blocks=2, ffn_dim=256, max_seq_len=50)
SASREC_BATCH = 128
SASREC_LAUNCHES_PER_STEP = {"fused_linear_ce_fwd": 1, "fused_linear_ce_bwd_dx": 1,
                            "fused_linear_ce_bwd_dw": 1}
# Retrieval serving: SASRec (fp32) and HSTU (bf16) heads at those widths,
# top 10 of Amazon-Beauty's 12,101 items. The traffic is the valid-split
# histories of the synthetic Amazon-Beauty set the trainers use (3 to 28
# items), HSTU's with their timestamps; the history buckets past
# max_seq_len (64) clamp to 50.
RETRIEVE_TOP_K = 10
RETRIEVE_LADDER = ((1, 2, 4, 8, 16), (8, 16, 32, 64))
RETRIEVE_BUCKET = (16, 32, 16)  # B5 timed at the bursts' bucket: B, L, requests in it
RETRIEVE_BURST = 2048  # requests a burst (~0.5 s on the H100)
RETRIEVE_ORDER = (False, True, True, False, False, True, True, False, False, True)  # int8?
RETRIEVE_RATE = 1000.0  # offered load of the open-loop run, requests a second
RETRIEVE_OPEN = 3000  # requests of the open-loop run a table (~3 s)
RETRIEVE_SAMPLE = 12  # burst requests a head held to offline scoring on the card
# Engine answer against offline scoring of the same bucket shape, relative
# to max |score|: fp32 SASRec runs the same GEMMs (1e-5); HSTU's bf16 hidden
# states may round one step apart between batches (1e-2).
SASREC_SCORE_TOL = 1e-5
HSTU_SCORE_TOL = 1e-2
INT8_RECALL_FLOOR = 0.8  # tests/test_quantized.py::test_engine_quantized_retrieval_heads

# The kernels line: name -> (source, the TPU kernel it replaces, its function).
KERNELS = {
    "paged_attention_stats": ("genrec_tpu_torch/csrc/paged_attention.cu",
                              "genrec_tpu/kernels/paged_attention.py:182",
                              "paged_attention_stats_pallas"),
    "hstu_attention_fwd": ("genrec_tpu_torch/csrc/hstu_attention.cu",
                           "genrec_tpu/kernels/hstu_attention.py:148",
                           "hstu_attention_pallas"),
    "hstu_attention_bwd": ("genrec_tpu_torch/csrc/hstu_attention.cu",
                           "genrec_tpu/kernels/hstu_attention.py:294",
                           "hstu_attention_bwd_pallas"),
    "fused_linear_ce_fwd": ("genrec_tpu_torch/csrc/fused_ce.cu",
                            "genrec_tpu/kernels/fused_ce.py:137", "fused_linear_ce_fwd"),
    "fused_linear_ce_bwd_dx": ("genrec_tpu_torch/csrc/fused_ce.cu",
                               "genrec_tpu/kernels/fused_ce.py:180",
                               "fused_linear_ce_bwd (_dx_kernel)"),
    "fused_linear_ce_bwd_dw": ("genrec_tpu_torch/csrc/fused_ce.cu",
                               "genrec_tpu/kernels/fused_ce.py:180",
                               "fused_linear_ce_bwd (_dw_kernel)"),
    "paged_attention_stats_quantized": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                        "genrec_tpu/kernels/paged_attention.py:112",
                                        "paged_attention_stats_pallas_quantized"),
    "rq_cascade": ("genrec_tpu_torch/csrc/rq_cascade.cu",
                   "genrec_tpu/kernels/rq_cascade.py:75", "rq_cascade_pallas"),
    "fused_linear_ce_fwd_lcrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                  "genrec_tpu/kernels/fused_ce.py:137",
                                  "fused_linear_ce_fwd, per shard of sharded_fused_linear_ce"),
    "fused_linear_ce_bwd_dx_lcrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                     "genrec_tpu/kernels/fused_ce.py:180",
                                     "fused_linear_ce_bwd (_dx_kernel), per shard"),
    "fused_linear_ce_bwd_dw_lcrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                     "genrec_tpu/kernels/fused_ce.py:180",
                                     "fused_linear_ce_bwd (_dw_kernel), per shard"),
    "fused_linear_ce_fwd_sasrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                   "genrec_tpu/kernels/fused_ce.py:137",
                                   "fused_linear_ce_fwd, on the SASRec step's operands"),
    "fused_linear_ce_bwd_dx_sasrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                      "genrec_tpu/kernels/fused_ce.py:180",
                                      "fused_linear_ce_bwd (_dx_kernel), SASRec step"),
    "fused_linear_ce_bwd_dw_sasrec": ("genrec_tpu_torch/csrc/fused_ce.cu",
                                      "genrec_tpu/kernels/fused_ce.py:180",
                                      "fused_linear_ce_bwd (_dw_kernel), SASRec step"),
    "hstu_attention_fwd_retrieve": ("genrec_tpu_torch/csrc/hstu_attention.cu",
                                    "genrec_tpu/kernels/hstu_attention.py:148",
                                    "hstu_attention_pallas, at a retrieval serving bucket"),
    "paged_attention_stats_cobra": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                    "genrec_tpu/kernels/paged_attention.py:182",
                                    "paged_attention_stats_pallas, at COBRA's serving shape"),
    "paged_attention_stats_quantized_cobra": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                              "genrec_tpu/kernels/paged_attention.py:112",
                                              "paged_attention_stats_pallas_quantized, at "
                                              "COBRA's serving shape"),
    "paged_attention_stats_tree": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                   "genrec_tpu/kernels/paged_attention.py:182",
                                   "paged_attention_stats_pallas, over TIGER's 730-node "
                                   "speculative tree"),
    "paged_attention_stats_quantized_tree": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                             "genrec_tpu/kernels/paged_attention.py:112",
                                             "paged_attention_stats_pallas_quantized, over "
                                             "TIGER's 730-node speculative tree"),
    "paged_attention_stats_cobra_tree": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                         "genrec_tpu/kernels/paged_attention.py:182",
                                         "paged_attention_stats_pallas, over COBRA's 180-node "
                                         "speculative tree"),
    "paged_attention_stats_bf16": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                   "genrec_tpu/kernels/paged_attention.py:182",
                                   "paged_attention_stats_pallas over bf16 pages with a bf16 q, "
                                   "at TIGER's serving shape"),
    "paged_attention_stats_bf16_cobra": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                         "genrec_tpu/kernels/paged_attention.py:182",
                                         "paged_attention_stats_pallas over bf16 pages, at "
                                         "COBRA's serving shape"),
    "paged_attention_stats_bf16_tree": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                        "genrec_tpu/kernels/paged_attention.py:182",
                                        "paged_attention_stats_pallas over bf16 pages, over "
                                        "TIGER's 730-node speculative tree"),
    "paged_attention_stats_quantized_bf16q": ("genrec_tpu_torch/csrc/paged_attention.cu",
                                              "genrec_tpu/kernels/paged_attention.py:112",
                                              "paged_attention_stats_pallas_quantized with a "
                                              "bf16 q, at TIGER's serving shape"),
    "paged_attention_stats_quantized_bf16q_cobra": (
        "genrec_tpu_torch/csrc/paged_attention.cu", "genrec_tpu/kernels/paged_attention.py:112",
        "paged_attention_stats_pallas_quantized with a bf16 q, at COBRA's serving shape"),
    "sharded_fused_linear_ce": ("genrec_tpu_torch/kernels/fused_ce.py",
                                "genrec_tpu/kernels/fused_ce.py:329",
                                "sharded_fused_linear_ce (_tp_vjp_fwd :350, _tp_vjp_bwd :375, "
                                "B4 at :387)"),
    "sharded_fused_linear_ce_4": ("genrec_tpu_torch/kernels/fused_ce.py",
                                  "genrec_tpu/kernels/fused_ce.py:329",
                                  "sharded_fused_linear_ce over four shards (qwen_tp4)"),
    # A port-only kernel: the TIGER step's deterministic bias-grid gradient.
    "table_grad": ("genrec_tpu_torch/csrc/table_grad.cu", "none (port-only: replaces no TPU "
                   "kernel)", "the backward of models/t5transformer._TableLookup"),
}
LIBRARY_ATOL = 1e-4  # the library call normalises; checked, never used
# SDPA on bf16 operands returns bf16 (2^-9 relative) after rounding its
# weights to bf16 inside the product: 3e-2 on outputs of |v| <~ 4.
LIBRARY_BF16_ATOL = 3e-2
# Scores are sums of 3 log-softmaxes of logits / 0.2. Across batch shapes
# and devices the full-width logits differ by ~1e-5 (GEMM blocking and
# summation order), which moves the scores by up to ~1e-4 (measured on the
# CPU); sem-ids must be equal.
SAMPLE_ATOL = 1e-3
# int8 pages: the same, plus quantisation's rounding edges. A K/V element
# whose x / scale lies within the projections' last-bit noise of a .5
# edge lands one int8 step (its row's amax / 127) apart between batch
# shapes (the engine's prefill batch against offline decoding of one
# request), and moves the beams' scores by up to ~1e-2 at T = 0.2
# (tests/test_torch_quant.py). Two beams whose scores are that close may
# then trade ranks, so int8 answers are matched tuple by tuple
# (int8_answers_agree) instead of rank by rank.
INT8_SAMPLE_ATOL = 2e-2

# RQ-VAE, config/tiger/amazon/rqvae.gin (input 768, hidden 512-256-128-64,
# embed 32, 3 levels x 256, STE + Sinkhorn, AdamW 1e-3 wd 1e-4, batch 1024,
# Gumbel temperature 0.2, 20,000-row k-means warm-up). Only the depth is
# cut: RQVAE_EPOCHS of the file's 5,000 epochs (11 steps each at 12,101
# items; 20 before the TIGER and COBRA training phases came, cut to keep
# the smoke's time), and RQVAE_STEPS fixed steps after RQVAE_WARM.
RQVAE_EPOCHS = 12
RQVAE_WARM, RQVAE_STEPS = 3, 40
SEM_ID_CHUNK = 4096  # compute_sem_ids' batch: one B7 launch a chunk
# Sem-id comparisons: exact outside rows whose two nearest codewords at some
# level are within NEAR_TIE_REL x max |dist| (another summation order may
# pick either); at most NEAR_TIE_MAX_SHARE of the rows may be near ties.
NEAR_TIE_REL = 1e-5
NEAR_TIE_MAX_SHARE = 0.02

# TIGER training, config/tiger/amazon/tiger.gin: batch 256 packed rows of
# 61 (<= 4 segments), AdamW 1e-4 on the cosine warm-up of 100 steps over the
# file's 100 epochs, weight decay 0.035, clip 1.0, dropout 0.1, bf16 (amp).
# Only the depth is cut: TIGER_TRAIN["steps"] timed steps after "warm". The
# trainer run of the file (2 epochs of the trainer's own synthetic data,
# ~10 steps each) cuts the warm-up with the epochs, so its loss can move.
TIGER_TRAIN = dict(batch=256, lr=1e-4, warmup=100, wd=0.035, dropout=0.1, epochs=100,
                   max_segments=4, warm=3, steps=40)
TIGER_TRAINER_EXTRA = ("train.num_warmup_steps = 10",)
# The TIGER step runs no TPU kernel; the table-lookup gradient (C4) sums
# the relative bias grid's gradient once a self-attention layer.
TIGER_LAUNCHES_PER_STEP = {"table_grad": TIGER_AMAZON["n_layers"]}
# TIGER's dense decode on the trained weights: trainer's eval settings
# (sampled, T 0.2, 10 beams, sample_factor 6: KK 60) over a seeded 2,048 of
# the Beauty users' valid rows at eval_batch_size 64; the deterministic
# checks on a float32 copy: cached vs uncached on one batch, dense vs paged
# (B1) on 4 batches. Log-probs 1e-4 apart at most (sums of 3 log-softmaxes
# of logits / 0.2 that differ by ~1e-6).
TIGER_DECODE = dict(users=2048, batch=64, temperature=0.2, paged_users=256)
TIGER_DECODE_TOL = 1e-4
# COBRA training, config/cobra/amazon.gin: batch 64, AdamW 3e-4 on the cosine
# warm-up of 500 steps over 50 epochs, weight decay 0.01, clip 1.0, dropout
# 0.1, bf16; COBRA_TRAIN["steps"] timed steps after "warm". The eval as the
# trainer's (beam fusion, n_beam 20, 10 candidates, alpha 0.5) on a seeded
# 512 of the Beauty users' valid rows; the trainer run's final evals take
# batches of 1,024 (the file's 32 would be ~1,400 beam-fusion calls).
COBRA_TRAIN = dict(batch=64, lr=3e-4, warmup=500, wd=0.01, epochs=50, warm=3, steps=20,
                   eval_users=512, eval_batch=64, n_candidates=10, alpha=0.5,
                   trainer_eval_batch=1024)
# The trainer run's dense InfoNCE stays at chance through its one epoch
# (cobra_trainer_run): its last 20 steps may sit at most 1% above the first
# 20 (+0.23% on an H100: noise around chance, not a divergence).
COBRA_DENSE_RISE_MAX = 0.01

# LCRec SFT at tensor_parallel=2: QwenConfig()'s defaults, Qwen2.5-1.5B
# (genrec_tpu/models/backbones/qwen.py:32-47; config/base.gin:10: hidden
# 1,536, 28 layers, 12 heads of 128, 2 KV heads, FFN 8,960, vocab 151,936,
# tied head, RoPE theta 1e6), trained by config/lcrec/amazon/lcrec.gin: 5
# codebooks x 256 appended (live vocab 153,216, a multiple of 8, so 76,608
# rows a shard), max_text_len 512, bf16, AdamW 2e-5 with weight decay 0.01
# after a 50-step warm-up, clip 1.0; batch 8 (lcrec_debug.gin). Random
# weights from --seed (the HF checkpoint is not in the repository). Cut:
# the fixed steps (LCREC["steps"] after LCREC["warm"]; 10 before the TIGER
# and COBRA training phases came, cut to keep the smoke's time); the parity run's
# depth (2 layers), batch and lr; the trainer run's epochs and eval sets.
LCREC = dict(base_vocab=151936, codebooks=5, codebook_size=256, layers=28, batch=8, seq=512,
             lr=2e-5, warmup=50, wd=0.01, warm=2, steps=6, profile_steps=3,
             parity_layers=2, parity_steps=5, parity_batch=4, parity_seq=128, parity_lr=1e-3,
             trainer_epochs=2, trainer_eval=64)
LCREC_TP = 2
LCREC_LIVE = LCREC["base_vocab"] + LCREC["codebooks"] * LCREC["codebook_size"]
LCREC_SHARD = LCREC_LIVE // LCREC_TP
LCREC_DIMS = (64, 1000, 1536, 2048)  # B3/B4 checked at each d at a small size
LCREC_REPS = 3  # graph replays per timing at the shard shape (each call takes ms)
LCREC_TIMEOUT_S = 900  # the ranks' time limit, spawn included
SPAWN_QUIET_TIMEOUT_S = 900  # a rank's wait for the work run beside its start-up
# tp=1 against tp=2, fp32: the paths sum in other orders (the row-parallel
# all-reduce, the sharded logsumexp merge) and Adam carries the differences.
LCREC_PARITY_RTOL = 1e-4
# Launches of each kernel per train step per rank.
LCREC_LAUNCHES_PER_STEP = {"fused_linear_ce_fwd": 1, "fused_linear_ce_bwd_dx": 1,
                           "fused_linear_ce_bwd_dw": 1}


def check(ok, what) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase: str, **fields) -> dict:
    """Print a phase's line, with the seconds since the script started
    (``at_s``, also in the returned fields, so --out keeps it)."""
    fields = {"at_s": time.perf_counter() - _STARTED, **fields}
    print(json.dumps({"phase": phase, **fields}), flush=True)
    return fields


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, arg_sets, reps: int = 10) -> float:
    """Mean device time of one ``fn(**args)`` in ms: the calls over
    ``arg_sets`` are captured once in a CUDA graph and the graph is
    replayed ``reps`` times between two events, so the host's cost of
    issuing a call is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: allocator, handles
        for args in arg_sets:
            fn(**args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for args in arg_sets:
            fn(**args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def cold_copies(make, per_copy_bytes: int) -> list:
    """Enough input sets ``make(i)`` that together they exceed the L2 cache
    three times, so each call finds its inputs in device memory."""
    return [make(i) for i in range(max(2, -(-3 * L2_BYTES // per_copy_bytes)))]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def assert_near(what, got, want, tol) -> float:
    """max |got - want| <= tol * max |want|, NaN failing, so an output of
    zeros fails wherever the plain version is not all zeros; returns the
    max error."""
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    err = float((got.float() - want.float()).abs().max()) if want.numel() else 0.0
    check(err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}")
    return err


def bound(bytes_, flops, peak) -> tuple[float, str]:
    """(least ms for these bytes and operations, what bounds it)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ptxas_by_kernel(log: str) -> dict:
    """What ``nvcc -Xptxas -v`` printed for each kernel (mangled name):
    registers, spill stores and loads, stack frame (local memory a thread:
    spills, or register arrays indexed at run time), static shared memory."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("stack_frame", r"(\d+) bytes stack frame"),
                             ("static_smem", r"(\d+) bytes smem")):
                m = re.search(pat, ln)
                if m:
                    out[name][key] = int(m.group(1))
    return out


# The bf16 CE kernels (B3, B4): name -> (a fragment of its mangled name,
# the kind of its block's dynamic shared memory for bf16_block_smem, or
# None for a merge without any).
TC_KERNELS = {"ce_fwd_tc_kernel": ("ce_fwd_tc_kernel", "fwd"),
              "ce_fwd_merge_kernel": ("ce_fwd_merge_kernel", None),
              "ce_fused_kernel<dx>": ("ce_fused_kernelILb0E", "coeff"),
              "ce_fused_kernel<dW>": ("ce_fused_kernelILb1E", "coeff"),
              "ce_tc_kernel<kCoeff>": ("ce_tc_kernelILi0E", "coeff"),
              "ce_tc_kernel<kDxProduct>": ("ce_tc_kernelILi1E", "product"),
              "ce_tc_kernel<kDwProduct>": ("ce_tc_kernelILi2E", "product"),
              "ce_merge_bf16_kernel": ("ce_merge_bf16_kernel", None)}


def tc_kernels(key: str, d: int) -> list:
    """The bf16 kernels that the ``key`` ("fwd", "dx" or "dw") wrapper
    launches at width d."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    if key == "fwd":
        return ["ce_fwd_tc_kernel", "ce_fwd_merge_kernel"]
    if d <= fc.FUSED_DIM:
        return ["ce_fused_kernel<dx>" if key == "dx" else "ce_fused_kernel<dW>",
                "ce_merge_bf16_kernel"]
    return ["ce_tc_kernel<kCoeff>",
            "ce_tc_kernel<kDxProduct>" if key == "dx" else "ce_tc_kernel<kDwProduct>"]


def tc_report(key, R, V, d, ms, bound_ms, flops, ptxas) -> dict:
    """A bf16 B3 or B4 row's extras: achieved TFLOP/s (the bound's
    operations over the time), share of the bound, workspace bytes, and
    the ptxas numbers and dynamic shared memory of the kernels that width
    d runs (ptxas prints nothing when the library was built before this
    run)."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    kernels = {}
    for n in tc_kernels(key, d):
        fragment, smem_kind = TC_KERNELS[n]
        found = [v for k, v in ptxas.items() if fragment in k]
        smem = 0 if smem_kind is None else fc.bf16_block_smem(d, smem_kind)
        kernels[n] = dict(*found[:1], dynamic_smem=smem)
    return dict(achieved_tflops=flops / ms / 1e9, share_of_bound=bound_ms / ms,
                workspace_bytes=fc.workspace_bytes(key, R, V, d, torch.bfloat16),
                kernels=kernels)


def bit_equal_twice(fn, args, what) -> None:
    """Two calls on the same inputs give the same bits (every sum has one
    fixed order); ``fn`` returns a tensor or a tuple of them."""
    a, b = fn(**args), fn(**args)
    torch.cuda.synchronize()
    pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
    check(all(torch.equal(x, y) for x, y in pairs), f"{what}: two calls differ")


# ---- phase 3: the paged-attention kernel -----------------------------------


def paged_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail):
    """Pools with 1 + S*Pm pages, slot s owning pages 1 + s*Pm ..; with
    ``null_tail`` a slot's entries past its last used page point at the
    null page 0, as KVPagePool pads them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = 1 + S * Pm
    seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=dev)
    bt = (1 + torch.arange(S * Pm, device=dev, dtype=torch.int32)).reshape(S, Pm)
    if null_tail:
        used = (seq_lens.clamp_min(1) + page - 1) // page
        bt = bt.masked_fill(torch.arange(Pm, device=dev)[None] >= used[:, None], 0)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    return dict(q=randn(S, K, H, hd), k_pool=randn(P, page, H, hd),
                v_pool=randn(P, page, H, hd), block_tables=bt.contiguous(),
                seq_lens=seq_lens)


def to_bf16(x, pools=True):
    """``x`` with q, and (``pools``) the float pools, in bf16: a bf16
    model's operands."""
    x = dict(x, q=x["q"].to(torch.bfloat16))
    if pools:
        x["k_pool"], x["v_pool"] = x["k_pool"].to(torch.bfloat16), x["v_pool"].to(torch.bfloat16)
    return x


def bf16_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail):
    """``paged_inputs`` in bf16: B1 over bf16 pages with a bf16 q."""
    return to_bf16(paged_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail))


def bf16_terms(x, n=4):
    """``n`` bf16-exact float32 arrays summing exactly to ``x`` (multiples
    of 512 below 2^33 in magnitude), greedily, each the nearest bf16 value
    to what is left."""
    terms, rest = [], x.astype(np.float64)
    for _ in range(n):
        t = torch.as_tensor(rest, dtype=torch.float32).to(torch.bfloat16).float().numpy()
        terms.append(t)
        rest = rest - t.astype(np.float64)
    check(bool((rest == 0).all()), "bf16 split of the near -1e9 offset")
    return terms


def to_int8(x):
    """``x`` with its pools as int8 pools (QuantizedKVPool, quantised as the
    serving path's write_pages quantises); every third row of page 1 is all
    zeros, so its scale is 1e-12 / 127."""
    from genrec_tpu_torch.ops.quant import QuantizedKVPool, quantize_symmetric

    x = dict(x)
    for name in ("k_pool", "v_pool"):
        pool = x[name].clone()
        pool[1, ::3] = 0.0
        x[name] = QuantizedKVPool(*quantize_symmetric(pool, (-2, -1)))
    return x


def near_neg_inputs(dev, seed, S, K, H, page, Pm, seq_lens, int8, bf16=False):
    """Inputs whose scores are exact in any summation order (integer K, q a
    multiple of 512, hd 64 so hd^-0.5 = 1/8) and put each beam's max over
    its live positions at -1e9 - 64, -1e9 or -1e9 + 64: every beam is
    within 128 of -1e9, so the kernels must walk the masked positions too,
    and where the max is -1e9 or below those carry real weight. With
    ``bf16`` q (and the float pools) are bf16, every value exact: the
    -8e9 offset is split over q's first 4 dims (K 1 there), and every
    partial sum is a multiple of 512 below 2^33, exact in fp32."""
    from genrec_tpu_torch.ops.quant import QuantizedKVPool

    hd, lead = 64, 4 if bf16 else 1
    x = paged_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, False)
    rng = np.random.default_rng(seed)
    bt = x["block_tables"].cpu().numpy()
    P, cap = x["k_pool"].shape[0], Pm * page
    k = rng.integers(-1, 2, size=(P, page, H, hd)).astype(np.float32)
    k[..., :lead] = 1.0
    qn = rng.integers(-1, 2, size=(S, K, H, hd)).astype(np.float32)
    qn[..., :lead] = 0.0
    sums = np.einsum("skhd,slhd->skhl", qn, k[bt].reshape(S, cap, H, hd))
    lens = np.asarray(seq_lens)
    live = np.arange(cap)[None, :] < np.where(lens > 0, np.minimum(lens, cap), cap)[:, None]
    top = np.where(live[:, None, None, :], sums, -(10**6)).max(-1)
    q = 512.0 * qn
    target = -8e9 - 512.0 * (top - rng.integers(-1, 2, size=top.shape))
    for i, t in enumerate(bf16_terms(target) if bf16 else [target]):
        q[..., i] = t
    x["q"] = torch.as_tensor(q.astype(np.float32), device=dev)
    x["k_pool"] = torch.as_tensor(k, device=dev)
    if bf16:
        x = to_bf16(x, pools=not int8)
        check(bool(torch.equal(x["q"].float(), torch.as_tensor(q, device=dev))), "bf16 q exact")
    if int8:
        x = to_int8(x)
        x["k_pool"] = QuantizedKVPool(torch.as_tensor(k.astype(np.int8), device=dev),
                                      torch.ones((P, page), device=dev))
    return x


def paged_edge_inputs(dev, seed, served_lens, int8, bf16=False) -> dict:
    """The redesigned B1/B2's edges: scores within 128 of -1e9 (the walk
    past the live positions; a partial and a full slot), seq_len above
    Pm * page with block-table entries outside [0, P), S = 1 and S = 16 at
    the serving widths, and a shape that streams 4 stages through the
    ring (bf16: 8, the ring holding 4). ``bf16``: a bf16 q, over bf16
    pages (or int8 ones)."""
    H, hd = TIGER_AMAZON["num_heads"], TIGER_AMAZON["attn_dim"] // TIGER_AMAZON["num_heads"]
    page, Pm = PAGED["page_size"], PAGED["pages_per_slot"]

    def conv(x):
        x = to_int8(x) if int8 else x
        return to_bf16(x, pools=not int8) if bf16 else x

    long_pm, long_lens = (32, [400, 130]) if bf16 else (16, [256, 130])
    outside = paged_inputs(dev, seed + 30, 3, BEAMS, H, hd, page, Pm, [100, 7, Pm * page],
                           False)
    P = outside["k_pool"].shape[0]
    outside["block_tables"][0, -1] = -5
    outside["block_tables"][1, 0] = P + 7
    outside["block_tables"][2, 1] = P
    return {"seq_len_over_cap_bt_outside": conv(outside),
           "near_neg_partial": near_neg_inputs(dev, seed + 31, 3, BEAMS, 2, page, Pm,
                                               [40, 5, 17], int8, bf16),
           "near_neg_full": near_neg_inputs(dev, seed + 32, 2, BEAMS, 2, page, Pm,
                                            [Pm * page, Pm * page + 16], int8, bf16),
           "s1": conv(paged_inputs(dev, seed + 33, 1, BEAMS, H, hd, page, Pm,
                                   served_lens[:1], True)),
           "s16": conv(paged_inputs(dev, seed + 34, 16, BEAMS, H, hd, page, Pm,
                                    served_lens[:16], True)),
           "multi_stage": conv(paged_inputs(dev, seed + 35, 2, BEAMS, 2, 128, 16, long_pm,
                                            long_lens, False))}


def check_paged_edges(dev, seed, served_lens, kernel, plain, int8, bf16=False) -> dict:
    """Each edge case through ``kernel`` (its launch count must rise by
    exactly one) against ``plain``: max |error| <= 1e-5 x max |plain|."""
    errs = {}
    for name, x in paged_edge_inputs(dev, seed, served_lens, int8, bf16).items():
        before = kernel.launches
        got = kernel(**x)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{name}: {kernel.launches - before} launches")
        errs[name] = max(assert_near(f"{name}/{out}", g, w, FP32_TOL)
                         for out, g, w in zip(("acc", "m", "l"), got, plain(**x)))
    return errs


def paged_ptxas(ptxas: dict) -> dict:
    """ptxas -v numbers of every B1 and B2 instantiation by page type and
    head width: the fp32-q kernel's (``fp32_hd64``, ``int8_hd64``) and the
    bf16-q mma kernel's (``bf16_hd64``, ``int8_bf16q_hd64``)."""
    out = {}
    for name, v in ptxas.items():
        m = re.search(r"paged_attention_(stats|mma)_kernelI(f|a|13__nv_bfloat16)Li(\d+)E", name)
        if m:
            pages = {"f": "fp32", "a": "int8", "13__nv_bfloat16": "bf16"}[m.group(2)]
            key = pages + ("_bf16q" if m.group(1) == "mma" and pages == "int8" else "")
            out[f"{key}_hd{m.group(3)}"] = v
    return out


def check_mma_ptxas(ptxas: dict) -> None:
    """The bf16-q kernel spills nothing at hd 32, 64 and 128 (where ptxas
    printed its numbers: a build reused from an earlier run prints none)."""
    for key, v in paged_ptxas(ptxas).items():
        if key.startswith(("bf16_", "int8_bf16q_")):
            check(v.get("spill_stores", 0) == 0 and v.get("spill_loads", 0) == 0
                  and v.get("stack_frame", 0) == 0, f"the bf16-q kernel {key} spills: {v}")


def paged_attention_bound(x) -> tuple[float, str, dict]:
    """Least time for one call on these inputs: each input byte the
    function needs read once, each output written once. A slot needs the
    K/V rows of its first seq_len positions (masked positions weigh
    exactly 0); a fully masked slot needs all Pm*page of them. K/V and q
    bytes at their own types (fp32 or bf16); the outputs are fp32. With
    bf16 q and K, q.k's products are exact in fp32, so its half of the
    operations is priced at the bf16 tensor-core peak (fp32 accumulation);
    p.v multiplies fp32 weights and stays at the fp32 peak."""
    S, K, H, hd = x["q"].shape
    Pm, page = x["block_tables"].shape[1], x["k_pool"].shape[1]
    sl = x["seq_lens"].long()
    tokens = int(torch.where(sl > 0, sl.clamp_max(Pm * page), Pm * page).sum())
    f32 = 4
    bytes_ = (tokens * H * hd * 2 * x["k_pool"].element_size()  # K and V rows
              + S * K * H * hd * x["q"].element_size()          # q
              + S * (Pm + 1) * 4                                # block tables, seq_lens
              + S * K * H * (hd + 2) * f32)                     # acc, m, l
    qk = pv = 2 * K * H * hd * tokens
    bf16 = x["q"].dtype == x["k_pool"].dtype == torch.bfloat16
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_ops = qk / (BF16_FLOPS if bf16 else FP32_FLOPS) + pv / FP32_FLOPS
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, dict(bytes=bytes_, flops=qk + pv,
                                               qk_flops_at="bf16" if bf16 else "fp32",
                                               kv_tokens=tokens)


def library_paged_attention(q, k, v, mask):
    """One PyTorch call computing the normalised paged attention from
    pre-gathered K/V: the yardstick, never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def library_inputs(x):
    """SDPA's operands in q's type: pre-gathered (int8: dequantised) K/V,
    an additive mask of -1e9."""
    from genrec_tpu_torch.ops.paged import NEG, gather_pages

    S, K, H, hd = x["q"].shape
    dt = x["q"].dtype
    k = gather_pages(x["k_pool"], x["block_tables"]).permute(0, 2, 1, 3).to(dt).contiguous()
    v = gather_pages(x["v_pool"], x["block_tables"]).permute(0, 2, 1, 3).to(dt).contiguous()
    tok = torch.arange(k.shape[2], device=k.device)
    mask = torch.zeros((S, 1, 1, k.shape[2]), dtype=dt, device=k.device)
    mask = mask.masked_fill(tok >= x["seq_lens"].long()[:, None, None, None], NEG)
    return dict(q=x["q"].permute(0, 2, 1, 3).contiguous(), k=k, v=v, mask=mask)


def kernel_phase(dev, seed, ptxas, bf16=False) -> dict:
    """B1 at the TIGER serving shape (S 64, K 10, H 6, hd 64, page 16, Pm
    4) against its plain version, its edge cases, equal bits over two
    calls, then timed at S 64 and S 16. ``bf16``: the
    ``paged_attention_stats_bf16`` row, B1 over bf16 pages with a bf16 q
    (``paged_attention_stats_bf16_cuda``)."""
    from genrec_tpu_torch.kernels import paged_attention as pa

    kernel, make = ((pa.paged_attention_stats_bf16_cuda, bf16_inputs) if bf16 else
                    (pa.paged_attention_stats_cuda, paged_inputs))
    plain = pa.paged_attention_stats_ref
    S, K = PAGED["max_slots"], BEAMS
    H = TIGER_AMAZON["num_heads"]
    hd = TIGER_AMAZON["attn_dim"] // H
    page, Pm = PAGED["page_size"], PAGED["pages_per_slot"]
    rng = np.random.default_rng(seed)
    # KV tokens of served requests: the user token + 3 per history item.
    served_lens = 1 + TIGER_AMAZON["sem_id_dim"] * rng.integers(1, MAX_ITEMS + 1, S)
    masked_lens = served_lens.copy()
    masked_lens[::5] = 0  # free slots: every entry the null page
    cases = {
        "serving": (served_lens, True),
        "fully_masked_slots": (masked_lens, True),
        "every_page_full": (np.full(S, Pm * page), False),
    }
    errs = {}
    for i, (name, (lens, null_tail)) in enumerate(cases.items()):
        x = make(dev, seed + i, S, K, H, hd, page, Pm, lens, null_tail)
        got = kernel(**x)
        torch.cuda.synchronize()
        want = plain(**x)
        for out, g, w in zip(("acc", "m", "l"), got, want):
            torch.testing.assert_close(g, w, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                       msg=lambda m, c=name, o=out: f"{c}/{o}: {m}")
        errs[name] = max(float((g - w).abs().max()) for g, w in zip(got, want))

    errs.update(check_paged_edges(dev, seed, served_lens, kernel, plain, False, bf16))
    if bf16:
        check_mma_ptxas(ptxas)

    # Timing at the serving case, each call on inputs cold in L2; S = 16
    # beside S = 64 (the engine steps any slot prefix).
    base = make(dev, seed, S, K, H, hd, page, Pm, served_lens, True)
    bit_equal_twice(kernel, base, f"B1{' bf16' if bf16 else ''} at the serving shape")
    t64 = paged_times(dev, seed, S, served_lens, make, kernel, plain, paged_attention_bound)
    ms_again = device_ms(kernel, t64.pop("copies"))
    t16 = paged_times(dev, seed, 16, served_lens, make, kernel, plain, paged_attention_bound)
    t16.pop("copies")
    clocks = nvidia_smi_line("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    return emit(
        "kernel", name="paged_attention_stats_bf16" if bf16 else "paged_attention_stats",
        shape=dict(S=S, K=K, H=H, hd=hd, page=page, Pm=Pm,
                   pools="bf16, bf16 q" if bf16 else "fp32"),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance=dict(rtol=KERNEL_RTOL, atol=KERNEL_ATOL, edge_cases="1e-5 of max|plain|"),
        **t64, ms_repeat=ms_again, s16=t16, bit_equal_twice=True,
        timed_by="cuda_graph",
        library="torch.nn.functional.scaled_dot_product_attention on pre-gathered K/V",
        ptxas=paged_ptxas(ptxas),
        block=pa.block_shape(K, hd, page, Pm, "bfloat16" if bf16 else "float32",
                             "bfloat16" if bf16 else "float32"),
        clocks_after_timing=clocks,
    )


def paged_times(dev, seed, S, served_lens, make, kernel, plain, bound_fn,
                shape=None) -> dict:
    """B1 or B2 at a serving shape with the first S slots: device time of
    the kernel, its plain version and the library call, each on input
    copies cold in L2; the bound, its share, and the K/V bytes the call
    needs (live positions) against those of every position. ``shape`` is
    (K, H, hd, page, Pm), TIGER's by default."""
    K, H, hd, page, Pm = shape or (BEAMS, TIGER_AMAZON["num_heads"],
                                   TIGER_AMAZON["attn_dim"] // TIGER_AMAZON["num_heads"],
                                   PAGED["page_size"], PAGED["pages_per_slot"])
    lens = served_lens[:S]
    base = make(dev, seed, S, K, H, hd, page, Pm, lens, True)
    per_copy = nbytes(*(t for v in base.values()
                        for t in ((v.data, v.scale) if hasattr(v, "scale") else (v,))))
    copies = [base] + cold_copies(
        lambda c: make(dev, seed + 100 + c, S, K, H, hd, page, Pm, lens, True), per_copy)[1:]
    lib = [library_inputs(x) for x in copies]  # gather_pages dequantises int8
    acc, _, l = kernel(**base)
    bf16 = base["q"].dtype == torch.bfloat16
    torch.testing.assert_close(library_paged_attention(**lib[0]).float(),
                               (acc / l[..., None]).permute(0, 2, 1, 3),
                               rtol=0, atol=LIBRARY_BF16_ATOL if bf16 else LIBRARY_ATOL)
    ms = device_ms(kernel, copies)
    plain_ms = device_ms(plain, copies)
    library_ms = device_ms(library_paged_attention, lib)
    bound_ms, bound_by, work = bound_fn(base)
    # K or V bytes of one position, all heads: int8 rows carry a 4-byte scale.
    pool = base["k_pool"]
    row = H * hd + 4 if hasattr(pool, "scale") else H * hd * pool.element_size()
    return dict(S=S, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms, work=work,
                kv_bytes_live=2 * row * work["kv_tokens"],
                kv_bytes_all_positions=2 * row * S * Pm * page, cold_copies=len(copies),
                copies=copies)


def quantized_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail):
    """``paged_inputs`` with int8 pools (QuantizedKVPool, quantised as the
    serving path's write_pages quantises); every third row of page 1 is all
    zeros, so its scale is 1e-12 / 127."""
    return to_int8(paged_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail))


def quantized_bf16q_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail):
    """``quantized_inputs`` with a bf16 q: a bf16 model over int8 pages."""
    return to_bf16(quantized_inputs(dev, seed, S, K, H, hd, page, Pm, seq_lens, null_tail),
                   pools=False)


def quantized_bound(x) -> tuple[float, str, dict]:
    """``paged_attention_bound`` for int8 pools: a K or V row is H*hd bytes
    plus its 4-byte scale, and each element is dequantised (one convert and
    one multiply) before the fp32 dot products."""
    S, K, H, hd = x["q"].shape
    Pm, page = x["block_tables"].shape[1], x["k_pool"].data.shape[1]
    sl = x["seq_lens"].long()
    tokens = int(torch.where(sl > 0, sl.clamp_max(Pm * page), Pm * page).sum())
    bytes_ = (tokens * (H * hd + 4) * 2 + S * K * H * hd * x["q"].element_size()
              + S * (Pm + 1) * 4 + S * K * H * (hd + 2) * 4)
    flops = 4 * K * H * hd * tokens + 2 * 2 * H * hd * tokens
    ms, by = bound(bytes_, flops, FP32_FLOPS)
    return ms, by, dict(bytes=bytes_, flops=flops, kv_tokens=tokens)


def quantized_kernel_phase(dev, seed, ptxas, bf16q=False) -> dict:
    """B2 against its plain version (dequantise after the gather) and timed.
    ``bf16q``: the ``paged_attention_stats_quantized_bf16q`` row, a bf16 q
    (``paged_attention_stats_quantized_bf16q_cuda``)."""
    from genrec_tpu_torch.kernels import paged_attention as pa

    plain = pa.paged_attention_stats_quantized_ref
    kernel, make = (
        (pa.paged_attention_stats_quantized_bf16q_cuda, quantized_bf16q_inputs) if bf16q else
        (pa.paged_attention_stats_quantized_cuda, quantized_inputs))

    S, K = PAGED["max_slots"], BEAMS
    H = TIGER_AMAZON["num_heads"]
    hd = TIGER_AMAZON["attn_dim"] // H
    page, Pm = PAGED["page_size"], PAGED["pages_per_slot"]
    rng = np.random.default_rng(seed + 1)
    served_lens = 1 + TIGER_AMAZON["sem_id_dim"] * rng.integers(1, MAX_ITEMS + 1, S)
    masked_lens = served_lens.copy()
    masked_lens[::5] = 0  # free slots: seq_len 0, every entry the null page
    cases = {  # name: (K, seq_lens, null tail); served lens end in partial pages
        "serving_k10": (K, served_lens, True),
        "seq_len_0_slots_k10": (K, masked_lens, True),
        "k1": (1, served_lens, True),
        "every_page_full_k10": (K, np.full(S, Pm * page), False),
    }
    errs = {}
    for i, (name, (k, lens, null_tail)) in enumerate(cases.items()):
        x = make(dev, seed + 10 + i, S, k, H, hd, page, Pm, lens, null_tail)
        got = kernel(**x)
        torch.cuda.synchronize()
        want = plain(**x)
        errs[name] = max(assert_near(f"B2 {name}/{out}", g, w, FP32_TOL)
                         for out, g, w in zip(("acc", "m", "l"), got, want))

    errs.update(check_paged_edges(dev, seed, served_lens, kernel, plain, True, bf16q))
    if bf16q:
        check_mma_ptxas(ptxas)

    base = make(dev, seed, S, K, H, hd, page, Pm, served_lens, True)
    bit_equal_twice(kernel, base, f"B2{' bf16 q' if bf16q else ''} at the serving shape")
    t64 = paged_times(dev, seed, S, served_lens, make, kernel, plain, quantized_bound)
    t16 = paged_times(dev, seed, 16, served_lens, make, kernel, plain, quantized_bound)
    t64.pop("copies")
    t16.pop("copies")
    return emit(
        "kernel", name="paged_attention_stats_quantized_bf16q" if bf16q
        else "paged_attention_stats_quantized",
        shape=dict(S=S, K=K, H=H, hd=hd, page=page, Pm=Pm,
                   pools="int8 + fp32 row scales" + (", bf16 q" if bf16q else "")),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance=dict(rel=FP32_TOL, relative_to="max|plain|"),
        **t64, s16=t16, bit_equal_twice=True, timed_by="cuda_graph",
        library="torch.nn.functional.scaled_dot_product_attention on pre-gathered, "
                "dequantised K/V",
        ptxas=paged_ptxas(ptxas),
        block=pa.block_shape(K, hd, page, Pm, "int8", "bfloat16" if bf16q else "float32"),
    )


def cobra_served_lens(seed, S):
    """KV positions of ``S`` served COBRA requests, the cobra_serve phase's
    traffic (``cobra_requests``): 4 an item (3 codes and the dense vector)."""
    reqs = cobra_requests(beauty_dataset(seed), np.random.default_rng(seed + 2), S)
    return np.asarray([4 * len(r.history) for r in reqs])


def cobra_kernel_phase(dev, seed, ptxas, int8, bf16=False) -> dict:
    """B1 (``int8`` False) or B2 at COBRA's serving shape (K 20, H 6, hd
    128, page 16, Pm 5) against its plain version: the served lengths,
    free slots at seq_len 0 beside full slots, equal bits over two calls;
    then timed at S 64 and S 16 with its bound and the SDPA yardstick.
    ``bf16``: a bf16 model's q, the ``paged_attention_stats_bf16_cobra``
    row (B1 over bf16 pages) or, with ``int8``, the
    ``paged_attention_stats_quantized_bf16q_cobra`` row (B2 with a bf16 q)."""
    from genrec_tpu_torch.kernels import paged_attention as pa

    kernel, plain, make, bound_fn = (
        (pa.paged_attention_stats_quantized_bf16q_cuda, pa.paged_attention_stats_quantized_ref,
         quantized_bf16q_inputs, quantized_bound) if int8 and bf16 else
        (pa.paged_attention_stats_quantized_cuda, pa.paged_attention_stats_quantized_ref,
         quantized_inputs, quantized_bound) if int8 else
        (pa.paged_attention_stats_bf16_cuda, pa.paged_attention_stats_ref, bf16_inputs,
         paged_attention_bound) if bf16 else
        (pa.paged_attention_stats_cuda, pa.paged_attention_stats_ref, paged_inputs,
         paged_attention_bound))
    pages = "int8" if int8 else "bfloat16" if bf16 else "float32"
    K, H, hd, page, Pm = COBRA_SHAPE
    block = pa.block_shape(K, hd, page, Pm, pages, "bfloat16" if bf16 else "float32")
    if bf16:  # the bf16-q kernel's block fits three times an SM: one wave of 384
        check(block["blocks_per_sm"] >= 3, f"COBRA bf16 block: {block}")
    S = COBRA_PAGED["max_slots"]
    served_lens = cobra_served_lens(seed, S)
    edges = served_lens.copy()
    edges[::5], edges[1::5] = 0, Pm * page  # free slots and full slots
    errs = {}
    for i, (name, lens) in enumerate((("serving", served_lens),
                                      ("seq_len_0_and_full_slots", edges))):
        x = make(dev, seed + 40 + i, S, K, H, hd, page, Pm, lens, True)
        before = kernel.launches
        got = kernel(**x)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{name}: {kernel.launches - before} launches")
        errs[name] = max(assert_near(f"cobra {name}/{out}", g, w, FP32_TOL)
                         for out, g, w in zip(("acc", "m", "l"), got, plain(**x)))
    base = make(dev, seed, S, K, H, hd, page, Pm, served_lens, True)
    bit_equal_twice(kernel, base, f"{'B2' if int8 else 'B1'} {pages}{' bf16 q' if bf16 else ''} "
                                  "at COBRA's serving shape")
    t64 = paged_times(dev, seed, S, served_lens, make, kernel, plain, bound_fn, COBRA_SHAPE)
    t16 = paged_times(dev, seed, 16, served_lens, make, kernel, plain, bound_fn, COBRA_SHAPE)
    t64.pop("copies")
    t16.pop("copies")
    return emit(
        "kernel", name=("paged_attention_stats_quantized_bf16q_cobra" if int8 and bf16
                        else "paged_attention_stats_quantized_cobra" if int8
                        else "paged_attention_stats_bf16_cobra" if bf16
                        else "paged_attention_stats_cobra"),
        shape=dict(S=S, K=K, H=H, hd=hd, page=page, Pm=Pm,
                   pools=("int8 + fp32 row scales" + (", bf16 q" if bf16 else "")) if int8
                   else "bf16, bf16 q" if bf16 else "fp32"),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance=dict(rel=FP32_TOL, relative_to="max|plain|"),
        **t64, s16=t16, bit_equal_twice=True, timed_by="cuda_graph",
        library="torch.nn.functional.scaled_dot_product_attention on pre-gathered"
                + (", dequantised" if int8 else "") + " K/V",
        ptxas=paged_ptxas(ptxas), block=block,
    )


def tree_nodes(head: str) -> int:
    """Nodes a slot of the speculative tree at the engine's default fanout:
    TIGER's (10 beams, depth sem_id_dim - 1) or COBRA's (20 beams, depth
    n_codebooks - 2)."""
    from genrec_tpu_torch.ops.spec_tree import TreeTopology

    if head == "cobra":
        return TreeTopology(COBRA_BEAMS, SPEC_FANOUT, COBRA_AMAZON["n_codebooks"] - 2).n_nodes
    return TreeTopology(BEAMS, SPEC_FANOUT, TIGER_AMAZON["sem_id_dim"] - 1).n_nodes


def tree_kernel_phase(dev, seed, ptxas, name) -> dict:
    """B1 or B2 over a speculative tree's node axis, as the spec engines
    run it: ``paged_attention_stats_tree`` (B1, TIGER: N 730 at S 64, H 6,
    hd 64, page 16, Pm 4, the serve phase's served lengths),
    ``paged_attention_stats_quantized_tree`` (B2, the same shape) and
    ``paged_attention_stats_cobra_tree`` (B1, COBRA: N 180, hd 128, Pm 5,
    ``cobra_served_lens``) and ``paged_attention_stats_bf16_tree`` (B1 over
    bf16 pages with a bf16 q, TIGER's tree). Held to the twin on the served lengths and on
    free slots beside full ones, equal bits over two calls, then timed at S
    64 with its bound and SDPA on pre-gathered K/V."""
    from genrec_tpu_torch.kernels import paged_attention as pa

    int8, bf16 = "quantized" in name, "bf16" in name
    kernel, plain, make, bound_fn = (
        (pa.paged_attention_stats_quantized_cuda, pa.paged_attention_stats_quantized_ref,
         quantized_inputs, quantized_bound) if int8 else
        (pa.paged_attention_stats_bf16_cuda, pa.paged_attention_stats_ref, bf16_inputs,
         paged_attention_bound) if bf16 else
        (pa.paged_attention_stats_cuda, pa.paged_attention_stats_ref, paged_inputs,
         paged_attention_bound))
    pages = "int8" if int8 else "bfloat16" if bf16 else "float32"
    S = PAGED["max_slots"]
    if name.endswith("cobra_tree"):
        N = tree_nodes("cobra")
        _, H, hd, page, Pm = COBRA_SHAPE
        served_lens = cobra_served_lens(seed, S)
    else:
        N = tree_nodes("tiger")
        H = TIGER_AMAZON["num_heads"]
        hd = TIGER_AMAZON["attn_dim"] // H
        page, Pm = PAGED["page_size"], PAGED["pages_per_slot"]
        served_lens = (1 + TIGER_AMAZON["sem_id_dim"]
                       * np.random.default_rng(seed).integers(1, MAX_ITEMS + 1, S))
    edges = served_lens.copy()
    edges[::5], edges[1::5] = 0, Pm * page  # free slots and full slots
    errs = {}
    for i, (case, lens) in enumerate((("serving", served_lens),
                                      ("seq_len_0_and_full_slots", edges))):
        x = make(dev, seed + 60 + i, S, N, H, hd, page, Pm, lens, True)
        before = kernel.launches
        got = kernel(**x)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{case}: {kernel.launches - before} launches")
        errs[case] = max(assert_near(f"{name} {case}/{out}", g, w, FP32_TOL)
                         for out, g, w in zip(("acc", "m", "l"), got, plain(**x)))
        del x, got
    base = make(dev, seed, S, N, H, hd, page, Pm, served_lens, True)
    bit_equal_twice(kernel, base, f"{name} at the tree's node axis")
    del base
    t64 = paged_times(dev, seed, S, served_lens, make, kernel, plain, bound_fn,
                      (N, H, hd, page, Pm))
    t64.pop("copies")
    return emit(
        "kernel", name=name,
        shape=dict(S=S, K=N, H=H, hd=hd, page=page, Pm=Pm, tree_nodes=N,
                   pools="int8 + fp32 row scales" if int8 else "bf16, bf16 q" if bf16
                   else "fp32"),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance=dict(rel=FP32_TOL, relative_to="max|plain|"),
        **t64, bit_equal_twice=True, timed_by="cuda_graph",
        library="torch.nn.functional.scaled_dot_product_attention on pre-gathered"
                + (", dequantised" if int8 else "") + " K/V",
        ptxas=paged_ptxas(ptxas),
        block=pa.block_shape(N, hd, page, Pm, pages, "bfloat16" if bf16 else "float32"),
    )


# ---- phase 3: the residual-quantisation cascade (B7) ------------------------


def rq_inputs(dev, seed, B, L, K, D, duplicate=False):
    """x ~ N(0, 0.3^2) (an encoder output's scale) and codebooks (L, K, D)
    ~ N(0, 0.2^2); with ``duplicate`` the second half of every level
    repeats the first, so every argmin ties exactly."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.3 * torch.randn((B, D), generator=gen, device=dev)
    cb = 0.2 * torch.randn((L, K, D), generator=gen, device=dev)
    if duplicate:
        cb[:, K // 2:] = cb[:, :K - K // 2].clone()
    return dict(x=x, codebooks=cb.contiguous())


def check_sem_ids(what, x, codebooks, got, want) -> dict:
    """Sem-ids equal to ``want`` on every row outside the near ties (the
    rows are counted, and their share bounded)."""
    from genrec_tpu_torch.kernels.rq_cascade import near_tie_rows

    near = near_tie_rows(x, codebooks, want, NEAR_TIE_REL)
    differ = (got != want).any(dim=1)
    outside = int((differ & ~near).sum())
    share = float(near.float().mean())
    check(outside == 0, f"{what}: {outside} rows differ outside the near ties")
    check(share <= NEAR_TIE_MAX_SHARE, f"{what}: near-tie share {share}")
    return dict(rows=len(got), near_tie_rows=int(near.sum()), differing_rows=int(differ.sum()),
                differing_outside_near_ties=outside)


def rq_kernel_phase(dev, seed, ptxas) -> dict:
    """B7 against its plain version (TF32 off), equal bits over two calls,
    timed; with its ptxas numbers."""
    from genrec_tpu_torch.kernels.rq_cascade import rq_cascade_cuda, rq_cascade_ref

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for the plain cascade")
    cases = {  # name: (B, L, K, D, duplicated codewords)
        "export_chunk": (SEM_ID_CHUNK, 3, 256, 32, False),
        "ragged_B": (1000, 3, 256, 32, False),
        "L1_K45": (777, 1, 45, 32, False),
        "K300_D40": (300, 3, 300, 40, False),
        "K512_D64_a_level_at_a_time": (517, 3, 512, 64, False),
        "duplicated_codewords": (512, 3, 256, 32, True),
    }
    errs, ties = {}, {}
    for i, (name, (B, L, K, D, dup)) in enumerate(cases.items()):
        x = rq_inputs(dev, seed + 20 + i, B, L, K, D, dup)
        ids, qsum = rq_cascade_cuda(**x)
        torch.cuda.synchronize()
        want_ids, want_q = rq_cascade_ref(**x)
        if dup:  # every row ties exactly: ids must be equal everywhere
            check(torch.equal(ids, want_ids) and int(ids.max()) < K - K // 2,
                  "duplicated codewords: the lower index must win on every row")
            ties[name] = dict(rows=B, differing_rows=0)
        else:
            ties[name] = check_sem_ids(f"B7 {name}", x["x"], x["codebooks"], ids, want_ids)
        same = ~(ids != want_ids).any(dim=1)
        errs[name] = assert_near(f"B7 {name}/qsum", qsum[same], want_q[same], FP32_TOL)

    B, L, K, D = cases["export_chunk"][:4]
    base = rq_inputs(dev, seed, B, L, K, D)
    bit_equal_twice(rq_cascade_cuda, base, "B7 at the export chunk")
    copies = [base] + cold_copies(lambda c: rq_inputs(dev, seed + 100 + c, B, L, K, D),
                                  nbytes(*base.values()))[1:]
    ms = device_ms(rq_cascade_cuda, copies)
    plain_ms = device_ms(rq_cascade_ref, copies)
    bytes_ = nbytes(*base.values()) + B * L * 4 + B * D * 4
    flops = 2 * B * K * D * L
    bound_ms, bound_by = bound(bytes_, flops, FP32_FLOPS)
    return emit(
        "kernel", name="rq_cascade", shape=dict(B=B, L=L, K=K, D=D, dtype="fp32"),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs, sem_ids_by_case=ties,
        tolerance=dict(qsum_rel=FP32_TOL, relative_to="max|plain|", ids="exact outside "
                       f"near ties ({NEAR_TIE_REL} x max|dist|)"),
        ms=ms, plain_ms=plain_ms, library_ms=None, library="none (no single call)",
        timed_by="cuda_graph", bound_ms=bound_ms, bound_by=bound_by,
        work=dict(bytes=bytes_, flops=flops), cold_copies=len(copies), bit_equal_twice=True,
        ptxas={k: v for k, v in ptxas.items() if "rq_cascade_kernel" in k},
    )


# ---- phase 3: the HSTU training kernels (B3-B6) -----------------------------


def hstu_inputs(dev, seed, dtype, *, timestamps=True, packed=True, B=HSTU_BATCH, L=None,
                hd=None):
    """Inputs of one HSTU attention call at the trainer's shapes (L and hd
    may be set): q, k, v and a cotangent g (B, H, L, hd); packed rows (segments
    of 2-28 tokens from slot 0, pad at the tail, as pack_examples lays
    them out) or left-padded rows (as eval rows); row 0 all padding;
    synthetic timestamps (~1 event a day from 1.5e9 s, int32)."""
    rng = np.random.default_rng(seed)
    H = HSTU_AMAZON["num_heads"]
    L = L or HSTU_AMAZON["max_seq_len"]
    hd = hd or HSTU_AMAZON["embed_dim"] // H
    seg = np.zeros((B, L), np.int32)
    pad = np.zeros((B, L), bool)
    for b in range(B):
        if packed:
            at, s = 0, 1
            while at < L:
                n = int(rng.integers(2, 29))
                if at + n > L and s > 1:
                    break
                seg[b, at:at + n] = s
                at, s = at + n, s + 1
            pad[b] = seg[b] == 0
        else:
            pad[b, :L - int(rng.integers(1, L + 1))] = True
    pad[0] = True
    seg[0] = 0
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    normal = lambda *shape: t(rng.normal(size=shape).astype(np.float32)).to(dtype)  # noqa: E731
    ts = np.cumsum(rng.integers(3600, 172800, size=(B, L)), axis=1) + 1_500_000_000
    return dict(
        q=normal(B, H, L, hd), k=normal(B, H, L, hd), v=normal(B, H, L, hd),
        timestamps=t(ts, torch.int32) if timestamps else None, padding_mask=t(pad),
        pos_table=t(rng.normal(size=(H, 32)).astype(np.float32) * 0.1),
        time_table=(t(rng.normal(size=(H, 64)).astype(np.float32) * 0.1)
                    if timestamps else None),
        segment_ids=t(seg) if packed else None, g=normal(B, H, L, hd),
    )


def _fwd(x):
    return {k: v for k, v in x.items() if k != "g"}


def visible_pairs(x) -> int:
    """(query, key) pairs the attention does not mask, over all heads."""
    pad = x["padding_mask"]
    L = pad.shape[1]
    vis = torch.tril(torch.ones((L, L), dtype=torch.bool, device=pad.device))[None]
    vis = vis & ~pad[:, None, :]
    if x["segment_ids"] is not None:
        vis = vis & (x["segment_ids"][:, :, None] == x["segment_ids"][:, None, :])
    return int(vis.sum()) * x["q"].shape[1]


def hstu_bounds(x) -> dict:
    """Least time for one forward and one backward call on these inputs:
    every input byte read once and every output written once; operations
    over the visible pairs (q.k and p.v forward: 4*hd each; backward also
    g.v, dq, dk, dv: 10*hd each) at the inputs' type's peak."""
    q = x["q"]
    hd = q.shape[-1]
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    side = nbytes(x["timestamps"], x["padding_mask"], x["segment_ids"], x["pos_table"],
                  x["time_table"])
    pairs = visible_pairs(x)
    fwd_bytes = 4 * nbytes(q) + side
    bwd_bytes = 7 * nbytes(q) + side + nbytes(x["pos_table"], x["time_table"])
    f_ms, f_by = bound(fwd_bytes, 4 * hd * pairs, peak)
    b_ms, b_by = bound(bwd_bytes, 10 * hd * pairs, peak)
    work = dict(visible_pairs=pairs, fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes,
                fwd_flops=4 * hd * pairs, bwd_flops=10 * hd * pairs)
    return dict(fwd=(f_ms, f_by), bwd=(b_ms, b_by), work=work)


def time_bucket_sweep(dev) -> dict:
    """The forward kernel's time buckets against the CPU's hstu_log_bucket
    (the JAX function's port, equal to it on every value of this sweep in
    tests/test_torch_hstu_attention.py): every |dt| within 300 of each
    bucket edge exp(0.693 n) and of each 2^k, and 0..70000, of both signs,
    and int32's extremes (t_q - t_k wraps). Each dt is a row of two
    positions, t = (0, dt), with q = k = 0, v = (1, 0), no position bias
    and time_table[n] = n, so the output of position 1 is
    silu(time_table[bucket(dt)]) and names the bucket, through the fp32
    and the bf16 forward (silu(n) rounded to bf16 stays nearest its own
    n); the same rows through the bf16 backward name it by their dtime
    partials."""
    from genrec_tpu_torch.kernels.hstu_attention import (
        hstu_attention_bwd_partials_cuda,
        hstu_attention_fwd_cuda,
    )
    from genrec_tpu_torch.ops.buckets import hstu_log_bucket

    edges = {int(np.exp(0.693 * n)) for n in range(32)} | {2**k for k in range(31)}
    dts = sorted({e + d for e in edges for d in range(-300, 301)
                  if 0 <= e + d < 2**31} | set(range(70000)))
    dts = dts + [-v for v in dts] + [2**31 - 1, -(2**31)]
    dt = torch.tensor(dts, dtype=torch.int32)
    B = len(dts)
    ts = torch.stack([torch.zeros_like(dt), dt], dim=1).to(dev)
    nb = torch.arange(64, dtype=torch.float32, device=dev)[None]
    want = hstu_log_bucket(dt, 64).long()
    mismatched = {}
    for dtype, hd in ((torch.float32, 1), (torch.bfloat16, 8)):
        zeros = torch.zeros((B, 1, 2, hd), dtype=dtype, device=dev)
        v = zeros.clone()
        v[:, :, 0, 0] = 1.0
        out = hstu_attention_fwd_cuda(zeros, zeros.clone(), v, ts,
                                      torch.zeros((B, 2), dtype=torch.bool, device=dev),
                                      torch.zeros((1, 32), device=dev), nb.contiguous())
        silu = (nb * torch.sigmoid(nb)).to(dtype).float()
        got = (out[:, 0, 1, 0].float()[:, None] - silu).abs().argmin(dim=1).cpu()
        mismatched[str(dtype)[6:]] = n = int((got != want).sum())
        check(n == 0, f"{dtype} forward time buckets: {n} of {B} differ from the CPU's")
    # The bf16 backward: key 1 padded and g_0 = 0, so pair (1, 0) is the one
    # that carries a gradient, and its row's dtime partials are nonzero in
    # its bucket only.
    zb = torch.zeros((B, 1, 2, 8), dtype=torch.bfloat16, device=dev)
    vb, gb = zb.clone(), zb.clone()
    vb[:, :, 0, 0] = 1.0
    gb[:, :, 1, 0] = 1.0
    pad = torch.zeros((B, 2), dtype=torch.bool, device=dev)
    pad[:, 1] = True
    dtt = hstu_attention_bwd_partials_cuda(zb, zb.clone(), vb, ts, pad,
                                           torch.zeros((1, 32), device=dev),
                                           torch.ones((1, 64), device=dev), gb)[4]
    got_b = torch.where((dtt != 0).sum(1) == 1, dtt.abs().argmax(1), -1).cpu()
    mismatched_bwd = int((got_b != want).sum())
    check(mismatched_bwd == 0,
          f"backward time buckets: {mismatched_bwd} of {B} differ from the CPU's")
    return dict(values=B, mismatched_fwd=mismatched, mismatched_bwd=mismatched_bwd,
                top_bucket_reached=int(want.max()))


def hstu_ptxas(ptxas: dict) -> dict:
    """ptxas -v numbers of the HSTU kernels, by kernel and instantiation
    (the bf16 backward by its padded head width)."""
    out = {}
    for name, v in ptxas.items():
        m = re.search(r"(hstu_\w+?_kernel)I(Li(\d+)E|f|13__nv_bfloat16)", name)
        if m:
            arg = m.group(3) or ("float" if m.group(2) == "f" else "bf16")
            out[f"{m.group(1)}<{arg}>"] = v
    return out


def device_ms_by_kernel(fn, arg_sets, reps: int = 3) -> dict:
    """Device time of one ``fn(**args)`` by CUDA kernel (torch.profiler over
    eager calls on ``arg_sets``), in ms a call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for args in arg_sets:
                fn(**args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"::(\w+)[<(]", e.key)
            key = m.group(1) if m else e.key[:60]
            out[key] = out.get(key, 0.0) + e.self_device_time_total / 1e3 / (reps * len(arg_sets))
    return out


def hstu_kernel_phase(dev, seed, ptxas) -> dict:
    """B5 and B6 against their plain versions (bf16 cases: the trainer's,
    left padding, L beyond one tile, odd hd), the bf16 kernels giving equal
    bits over two calls, and timed (also split by kernel: B6's own and its
    table sums); with their ptxas numbers, none spilling."""
    from genrec_tpu_torch.kernels.hstu_attention import (
        hstu_attention_bwd_cuda,
        hstu_attention_bwd_ref,
        hstu_attention_fwd_cuda,
        hstu_attention_ref,
    )

    cases = {  # name: (dtype, timestamps, packed, other shapes)
        "packed_time_bf16": (torch.bfloat16, True, True, {}),
        "left_padded_time_bf16": (torch.bfloat16, True, False, {}),
        "packed_time_L200_bf16": (torch.bfloat16, True, True, dict(B=16, L=200)),
        "packed_time_hd13_bf16": (torch.bfloat16, True, True, dict(B=16, hd=13)),
        "packed_time_fp32": (torch.float32, True, True, {}),
        "packed_no_time_fp32": (torch.float32, False, True, {}),
        "left_padded_time_fp32": (torch.float32, True, False, {}),
    }
    errs_f, errs_b = {}, {}
    for i, (name, (dtype, with_time, packed, shape)) in enumerate(cases.items()):
        x = hstu_inputs(dev, seed + i, dtype, timestamps=with_time, packed=packed, **shape)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        got = hstu_attention_fwd_cuda(**_fwd(x))
        torch.cuda.synchronize()
        check(got.dtype == dtype and float(got[0].float().abs().max()) == 0.0,
              f"{name}: the all-pad row must be 0 in {dtype}")
        errs_f[name] = assert_near(f"hstu fwd {name}", got, hstu_attention_ref(**_fwd(x)), tol)
        got_b = hstu_attention_bwd_cuda(**x)
        torch.cuda.synchronize()
        for out, g, w in zip(("dq", "dk", "dv", "dpos", "dtime"), got_b,
                             hstu_attention_bwd_ref(**x)):
            if w is None:
                check(g is None, f"{name}/{out}: expected None")
                continue
            errs_b[f"{name}/{out}"] = assert_near(f"hstu bwd {name}/{out}", g, w,
                                                  TABLE_TOL if out in ("dpos", "dtime") else tol)
    sweep = time_bucket_sweep(dev)

    # Timing at the trainer's type and layout: bf16, packed, timestamps.
    base = hstu_inputs(dev, seed, torch.bfloat16)
    copies = cold_copies(lambda c: hstu_inputs(dev, seed + 100 + c, torch.bfloat16),
                         nbytes(*(v for v in base.values() if v is not None)))
    fwd_copies = [_fwd(x) for x in copies]
    bounds = hstu_bounds(base)
    bit_equal_twice(hstu_attention_fwd_cuda, _fwd(base), "B5 bf16 at the trainer's shape")
    bit_equal_twice(hstu_attention_bwd_cuda, base, "B6 bf16 at the trainer's shape")
    ptx = hstu_ptxas(ptxas)
    spilled = {k: v for k, v in ptx.items() if v.get("spill_stores") or v.get("spill_loads")}
    check(not spilled, f"HSTU kernels spill: {spilled}")
    out = {}
    for name, fn, ref, sets, errs in (
        ("hstu_attention_fwd", hstu_attention_fwd_cuda, hstu_attention_ref, fwd_copies, errs_f),
        ("hstu_attention_bwd", hstu_attention_bwd_cuda, hstu_attention_bwd_ref, copies, errs_b),
    ):
        ms, plain_ms = device_ms(fn, sets), device_ms(ref, sets)
        bound_ms, bound_by = bounds["fwd" if name.endswith("fwd") else "bwd"]
        out[name] = emit(
            "kernel", name=name, shape=dict(B=HSTU_BATCH, H=2, L=50, hd=32, dtype="bf16"),
            max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
            tolerance=dict(fp32=FP32_TOL, bf16=BF16_TOL, bias_tables=TABLE_TOL,
                           relative_to="max|plain|"),
            ms=ms, plain_ms=plain_ms, library_ms=None,
            library="none: no single PyTorch call computes biased SiLU attention",
            timed_by="cuda_graph", bound_ms=bound_ms,
            bound_by=bound_by, work=bounds["work"], cold_copies=len(sets),
            time_bucket_sweep=sweep, ptxas=ptx, ms_by_kernel=device_ms_by_kernel(fn, sets),
            bit_equal_twice=True,
        )
    return out


def ce_inputs(dev, seed, dtype, *, all_ignored=False, mean_g=False, R=HSTU_BATCH * 50,
              V=BEAUTY_ITEMS + 1, d=64):
    """Inputs of the fused CE at the trainer's shapes: x (R, d) ~ N(0, 1)
    (a LayerNorm output), w (V, d) ~ N(0, 0.1), targets in [1, V) with 3%
    at the ignored id 0 (the pad slots of packed rows), and a cotangent g
    (R,): ~ N(0, 1) per row, so that dx and dW are of order 1 and each
    row's share is checked, or with ``mean_g`` the mean loss's 1 / valid
    rows (the trainer's; the timing sets)."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    tgt = rng.integers(1, V, R).astype(np.int32)
    tgt[rng.random(R) < 0.03] = 0
    if all_ignored:
        tgt[:] = 0
    valid = max(int((tgt != 0).sum()), 1)
    return dict(x=t(rng.normal(size=(R, d)).astype(np.float32)).to(dtype),
                w=t((rng.normal(size=(V, d)) * 0.1).astype(np.float32)).to(dtype),
                targets=t(tgt),
                g=t(np.full(R, 1.0 / valid, np.float32) if mean_g
                    else rng.normal(size=R).astype(np.float32)))


def library_ce(x, w, targets):
    return torch.nn.functional.cross_entropy(
        torch.nn.functional.linear(x, w), targets.long(), ignore_index=0, reduction="none")


def library_ce_dx(x, w, targets, g):
    x = x.detach().requires_grad_()
    return torch.autograd.grad(library_ce(x, w, targets), x, g)


def library_ce_dw(x, w, targets, g):
    w = w.detach().requires_grad_()
    return torch.autograd.grad(library_ce(x, w, targets), w, g)


def ce_kernel_phase(dev, seed, ptxas) -> dict:
    """B3 and B4 (dx, dW) against their plain versions and timed; the bf16
    rows also give their TFLOP/s, share of the bound, workspace, ptxas
    numbers and a check that two calls give the same bits."""
    from genrec_tpu_torch.kernels.fused_ce import (
        fused_linear_ce_dw_cuda,
        fused_linear_ce_dw_ref,
        fused_linear_ce_dx_cuda,
        fused_linear_ce_dx_ref,
        fused_linear_ce_fwd_cuda,
        fused_linear_ce_ref,
    )

    cases = {  # V = 12,102 is a multiple neither of the 64-column tile nor of 512
        "train_bf16": (torch.bfloat16, False),
        "train_fp32": (torch.float32, False),
        "all_ignored_fp32": (torch.float32, True),
    }
    errs = {"fwd": {}, "dx": {}, "dw": {}}
    for i, (name, (dtype, all_ignored)) in enumerate(cases.items()):
        x = ce_inputs(dev, seed + i, dtype, all_ignored=all_ignored)
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        fwd = dict(x=x["x"], w=x["w"], targets=x["targets"])
        loss, lse = fused_linear_ce_fwd_cuda(**fwd)
        torch.cuda.synchronize()
        want_loss, want_lse = fused_linear_ce_ref(**fwd)
        errs["fwd"][name] = max(assert_near(f"ce loss {name}", loss, want_loss, FP32_TOL),
                                assert_near(f"ce lse {name}", lse, want_lse, FP32_TOL))
        bwd = dict(fwd, lse=want_lse, g=x["g"])
        dx, dw = fused_linear_ce_dx_cuda(**bwd), fused_linear_ce_dw_cuda(**bwd)
        torch.cuda.synchronize()
        errs["dx"][name] = assert_near(f"ce dx {name}", dx, fused_linear_ce_dx_ref(**bwd), tol)
        errs["dw"][name] = assert_near(f"ce dW {name}", dw, fused_linear_ce_dw_ref(**bwd), tol)
        if dtype == torch.bfloat16:
            bit_equal_twice(fused_linear_ce_fwd_cuda, fwd, f"ce fwd {name}")
            bit_equal_twice(fused_linear_ce_dx_cuda, bwd, f"ce dx {name}")
            bit_equal_twice(fused_linear_ce_dw_cuda, bwd, f"ce dW {name}")
        if all_ignored:
            check(float(loss.abs().max()) == 0.0 and float(dx.float().abs().max()) == 0.0
                  and float(dw.float().abs().max()) == 0.0,
                  "all rows ignored: loss, dx and dW must be exactly 0")

    base = ce_inputs(dev, seed, torch.bfloat16, mean_g=True)
    copies = cold_copies(
        lambda c: ce_inputs(dev, seed + 100 + c, torch.bfloat16, mean_g=True),
        nbytes(*base.values()))
    return ce_rows(copies, errs, ptxas,
                   bit_equal_twice_cases=[n for n, (dt, _) in cases.items()
                                          if dt == torch.bfloat16])


def ce_rows(copies, errs, ptxas, suffix="", **extra_fields) -> dict:
    """B3, B4 dx and B4 dW timed over ``copies`` (dicts of bf16 x, w, int32
    targets and an fp32 cotangent g, the mean loss's 1 / valid rows), with
    their plain versions and the library call; one kernel row each, named
    with ``suffix``, carrying ``errs`` (by direction, then case)."""
    from genrec_tpu_torch.kernels.fused_ce import (
        fused_linear_ce_dw_cuda,
        fused_linear_ce_dw_ref,
        fused_linear_ce_dx_cuda,
        fused_linear_ce_dx_ref,
        fused_linear_ce_fwd_cuda,
        fused_linear_ce_ref,
    )

    fwd_sets = [dict(x=c["x"], w=c["w"], targets=c["targets"]) for c in copies]
    bwd_sets = [dict(f, lse=fused_linear_ce_ref(**f)[1], g=c["g"])
                for f, c in zip(fwd_sets, copies)]
    lib_bwd_sets = [dict(f, g=c["g"]) for f, c in zip(fwd_sets, copies)]
    got_loss, _ = fused_linear_ce_fwd_cuda(**fwd_sets[0])
    # A sanity check of the yardstick only: its logits and loss are bf16.
    library_err = assert_near("library CE vs kernel", library_ce(**fwd_sets[0]), got_loss,
                              2 * BF16_TOL)

    base = copies[0]
    R, d = base["x"].shape
    V = base["w"].shape[0]
    x_bytes, w_bytes = nbytes(base["x"]), nbytes(base["w"])
    rows = nbytes(base["targets"])  # one int32 / fp32 per row
    logits = 2 * R * V * d
    lib_fwd_ms = device_ms(library_ce, fwd_sets)
    # name: (kernel, its sets, plain version, library call and its sets,
    #        bytes each input read and output written once, operations)
    specs = {
        "fused_linear_ce_fwd": (fused_linear_ce_fwd_cuda, fwd_sets, fused_linear_ce_ref,
                                library_ce, fwd_sets, x_bytes + w_bytes + 3 * rows, logits),
        "fused_linear_ce_bwd_dx": (fused_linear_ce_dx_cuda, bwd_sets, fused_linear_ce_dx_ref,
                                   library_ce_dx, lib_bwd_sets,
                                   2 * x_bytes + w_bytes + 3 * rows, 2 * logits),
        "fused_linear_ce_bwd_dw": (fused_linear_ce_dw_cuda, bwd_sets, fused_linear_ce_dw_ref,
                                   library_ce_dw, lib_bwd_sets,
                                   x_bytes + 2 * w_bytes + 3 * rows, 2 * logits),
    }
    out = {}
    for name, (fn, sets, plain, lib, lib_sets, bytes_, ops) in specs.items():
        key = name.rsplit("_", 1)[-1]
        ms, plain_ms = device_ms(fn, sets), device_ms(plain, sets)
        if key == "fwd":
            library_ms = lib_fwd_ms
            library = "F.cross_entropy(F.linear(x, w), t, ignore_index=0, reduction='none')"
        else:
            library_ms = device_ms(lib, lib_sets) - lib_fwd_ms
            library = (f"autograd of the same call for {key} alone: its forward+backward "
                       "time less its forward time")
        bound_ms, bound_by = bound(bytes_, ops, BF16_FLOPS)
        out[name + suffix] = emit(
            "kernel", name=name + suffix, kernel=name, shape=dict(R=R, V=V, d=d, dtype="bf16"),
            **tc_report(key, R, V, d, ms, bound_ms, ops, ptxas), **extra_fields,
            max_abs_err=max(errs[key].values()), max_abs_err_by_case=errs[key],
            tolerance=dict(fp32=FP32_TOL, bf16=BF16_TOL, loss_lse=FP32_TOL,
                           relative_to="max|plain|"),
            ms=ms, plain_ms=plain_ms, plain=plain.__name__,
            library_ms=library_ms, library=library, library_vs_kernel_loss_err=library_err,
            timed_by="cuda_graph", bound_ms=bound_ms, bound_by=bound_by,
            cold_copies=len(sets),
            work=dict(bytes=bytes_, flops=ops, exps=R * V),
        )
    return out


# ---- phases 4 and 5: HSTU training ------------------------------------------


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by its name in the kernels line."""
    from genrec_tpu_torch.kernels import (
        fused_ce,
        hstu_attention,
        paged_attention,
        rq_cascade,
        table_grad,
    )

    return {
        "paged_attention_stats": paged_attention.paged_attention_stats_cuda,
        "paged_attention_stats_quantized": paged_attention.paged_attention_stats_quantized_cuda,
        "paged_attention_stats_bf16": paged_attention.paged_attention_stats_bf16_cuda,
        "paged_attention_stats_quantized_bf16q":
            paged_attention.paged_attention_stats_quantized_bf16q_cuda,
        "rq_cascade": rq_cascade.rq_cascade_cuda,
        "hstu_attention_fwd": hstu_attention.hstu_attention_fwd_cuda,
        "hstu_attention_bwd": hstu_attention.hstu_attention_bwd_cuda,
        "fused_linear_ce_fwd": fused_ce.fused_linear_ce_fwd_cuda,
        "fused_linear_ce_bwd_dx": fused_ce.fused_linear_ce_dx_cuda,
        "fused_linear_ce_bwd_dw": fused_ce.fused_linear_ce_dw_cuda,
        "sharded_fused_linear_ce": fused_ce.sharded_fused_linear_ce,
        "table_grad": table_grad.table_grad_cuda,
    }


def reset_counters() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def trainer_run(dev, seed, gin="config/hstu/amazon.gin", trainer="hstu_trainer",
                per_step=LAUNCHES_PER_STEP,
                extra=(f"train.num_items = {BEAUTY_ITEMS}",)) -> dict:
    """``trainers.<trainer>.train`` through ``gin`` on synthetic data (at
    Amazon-Beauty's item count, or as ``extra`` bindings say), 2 epochs,
    eval on: the user's entry point. Each kernel of ``per_step`` must have
    launched and no other; the epoch losses (from the run's metrics.jsonl)
    must fall."""
    import importlib

    from genrec_tpu_torch import configlib

    train = importlib.import_module(f"genrec_tpu_torch.trainers.{trainer}").train
    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / gin), substitutions={"split": "beauty"})
    with tempfile.TemporaryDirectory() as tmp:
        for binding in ('train.dataset = "synthetic"', *extra,
                        "train.wandb_logging = False", f'train.save_dir_root = "{tmp}"',
                        "train.do_eval = True", "train.epochs = 2", f"train.seed = {seed}",
                        f'train.device = "{dev}"'):
            configlib.parse_binding(binding)
        reset_counters()
        t0 = time.perf_counter()
        valid, test = train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()
        logged = [json.loads(line) for line in open(f"{tmp}/metrics.jsonl")]
    configlib.clear_bindings()
    configlib.clear_macros()
    for name, count in launches.items():
        check((count > 0) == (name in per_step),
              f"{trainer}.train(): {name} launched {count} times")
    epoch_loss = [m["train/loss"] for m in logged if "epoch" in m and "train/loss" in m]
    check(len(epoch_loss) == 2 and np.isfinite(epoch_loss).all(), epoch_loss)
    check(epoch_loss[-1] < epoch_loss[0], (f"{trainer}: loss did not fall", epoch_loss))
    check(all(np.isfinite(v) for v in (*valid.values(), *test.values())), (valid, test))
    return dict(wall_s=wall_s, epoch_loss=epoch_loss, valid=valid, test=test,
                launches=launches)


def train_setup(dev, seed, *, dtype, dropout, use_kernels):
    """A model at the amazon.gin widths, its step function and state, and
    the packing closure over SyntheticSeqDataset with Amazon-Beauty's item
    and user counts (the trainer's own recipe)."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.hstu import HSTU
    from genrec_tpu_torch.trainers.hstu_trainer import make_loss_fn

    model = HSTU(num_items=BEAUTY_ITEMS, dropout=dropout, use_pallas=use_kernels,
                 fused_ce=use_kernels, dtype=dtype, device=dev, seed=seed, **HSTU_AMAZON)
    optimizer = Adam(1e-3, b2=0.98)
    step_fn = make_train_step(make_loss_fn(), optimizer, clip_norm=None)
    return model, step_fn, TrainState.create(model, optimizer, seed)


@functools.cache
def beauty_dataset(seed):
    """SyntheticSeqDataset with Amazon-Beauty's item and user counts, built
    once (~20 s on the host) for the HSTU and SASRec phases."""
    from genrec_tpu_torch.data.synthetic import SyntheticSeqDataset

    return SyntheticSeqDataset(num_items=BEAUTY_ITEMS, num_users=BEAUTY_USERS,
                               max_seq_len=HSTU_AMAZON["max_seq_len"], seed=seed)


@functools.cache
def beauty_data(seed):
    from genrec_tpu_torch.data.batching import pack_examples

    ds = beauty_dataset(seed)
    examples = ds.train_examples(with_time=True)

    def repack(epoch):
        arrays, rep = pack_examples(examples, row_len=HSTU_AMAZON["max_seq_len"],
                                    seed=(seed, epoch))
        arrays.pop("positions")
        arrays.pop("segment_valid")
        return arrays, rep

    return ds, repack


def timed_steps(dev, seed, state, step_fn, repack, rows, warm=3, n=TRAIN_STEPS,
                row_len=HSTU_AMAZON["max_seq_len"]):
    """A PackedTrainLoop over ``repack``'s packed rows of ``row_len``:
    ``warm`` steps (the first calls: kernel libraries, cuBLAS handles,
    allocator), then ``n`` steps of the same epoch timed by a CUDA event a
    step, with every kernel's launches counted over them (the counters set
    to 0 just before). Returns (the loop, the numbers)."""
    from genrec_tpu_torch.core.logging import Tracker, setup_logger
    from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

    events, losses, tokens = [], [], []

    def hook(state, m, global_step, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(m["loss"])
        tokens.append(m["real_tokens"])

    loop = PackedTrainLoop(logger=setup_logger(None), tracker=Tracker(), device=dev,
                           rows_per_step=rows, row_len=row_len, seed=seed,
                           pack_sequences=True, repack=repack, step_hook=hook)
    loop.run_epoch(state, step_fn, 0, 0, max_steps=warm)
    steps_per_epoch = loop.pack_report.n_rows // rows
    check(steps_per_epoch >= warm + n, (steps_per_epoch, warm + n))
    events.clear()
    losses.clear()
    tokens.clear()
    torch.cuda.synchronize()
    first = torch.cuda.Event(enable_timing=True)
    reset_counters()
    t0 = time.perf_counter()
    first.record()
    loop.run_epoch(state, step_fn, 0, warm, start_batch=warm, max_steps=warm + n)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    check(len(events) == n, (len(events), n))
    step_ms = [a.elapsed_time(b) for a, b in zip([first] + events[:-1], events)]
    loss = [float(v) for v in losses]
    real_tokens = float(sum(float(v) for v in tokens))
    check(all(np.isfinite(loss)), loss)
    check(np.mean(loss[-5:]) < np.mean(loss[:5]), ("loss did not fall", loss))
    return loop, dict(
        rows_per_step=rows, packing=loop.pack_report.as_dict(), steps=n,
        steps_per_s=n / wall_s, real_tokens_per_s=real_tokens / wall_s,
        examples_per_s=n * loop.examples_per_step / wall_s,
        real_tokens_per_step=real_tokens / n, wall_s=wall_s,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p90=float(np.percentile(step_ms, 90)),
        first_loss=loss[0], last_loss=loss[-1], losses=loss, launches=launches,
    )


def check_launches_per_step(what, launches, per_step, n) -> dict:
    """Each kernel of ``per_step`` launched exactly that many times a step
    over ``n`` steps, and every other kernel of the port not at all."""
    for name, count in launches.items():
        want = per_step.get(name, 0) * n
        check(count == want, f"{what}: {name} launched {count} times in {n} steps, "
                             f"want {per_step.get(name, 0)} a step")
    return {k: launches[k] / n for k in per_step}


def train_phase(dev, seed, profile) -> dict:
    from genrec_tpu_torch.trainers.evaluation import evaluate
    from genrec_tpu_torch.trainers.hstu_trainer import make_eval_step

    trainer = trainer_run(dev, seed)
    t0 = time.perf_counter()
    ds, repack = beauty_data(seed)
    data_s = time.perf_counter() - t0
    model, step_fn, state = train_setup(dev, seed, dtype=torch.bfloat16, dropout=0.2,
                                        use_kernels=True)
    warm = 3
    loop, steps = timed_steps(dev, seed, state, step_fn, repack, HSTU_BATCH, warm=warm)
    n = steps["steps"]
    per_step = check_launches_per_step("HSTU step", steps["launches"], LAUNCHES_PER_STEP, n)
    metrics = evaluate(make_eval_step(model), ds.eval_arrays_with_time("valid"), 256, dev)
    out = emit(
        "train", card=torch.cuda.get_device_name(dev), trainer=trainer,
        config="config/hstu/amazon.gin widths, synthetic data", data_build_s=data_s,
        **steps, valid_recall_at_10=metrics["Recall@10"], valid_ndcg_at_10=metrics["NDCG@10"],
        launches_per_step=per_step,
    )
    if not profile:
        return out
    return {**out, "profile": profiled_steps("train_profile", loop, state, step_fn, warm + n)}


def profiled_steps(phase, loop, state, step_fn, done, more=20) -> dict:
    """``more`` steps of the second epoch under torch.profiler, after its
    repack and one step outside the window (``done`` steps ran before)."""
    step = done + 1
    loop.run_epoch(state, step_fn, 1, done, max_steps=step)

    def run_more():
        t = time.perf_counter()
        loop.run_epoch(state, step_fn, 1, step, start_batch=1, max_steps=step + more)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    return emit(phase, steps=more, **device_profile(run_more))


def parity_phase(dev, seed, setup=train_setup, data=beauty_data, phase="parity") -> dict:
    """The kernels' path against the plain path end to end: same init,
    same batches, dropout 0, fp32 (HSTU, or SASRec with its setup and
    data)."""
    from genrec_tpu_torch.data.batching import batch_iterator

    _, repack = data(seed)
    arrays, _ = repack(0)
    batches = []
    for batch, _ in batch_iterator(arrays, HSTU_BATCH, drop_last=True):
        batches.append({k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        if len(batches) == PARITY_STEPS:
            break
    traj = {}
    init = None
    for use_kernels in (True, False):
        model, step_fn, state = setup(dev, seed, dtype=torch.float32, dropout=0.0,
                                      use_kernels=use_kernels)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        traj[use_kernels] = [float(step_fn(state, b)[1]["loss"]) for b in batches]
    k, p = np.asarray(traj[True]), np.asarray(traj[False])
    rel = float(np.max(np.abs(k - p) / np.abs(p)))
    check(np.isfinite(k).all() and rel <= PARITY_RTOL,
          f"kernel vs plain loss trajectories: max relative diff {rel} > {PARITY_RTOL}")
    return emit(phase, steps=len(batches), dtype="fp32", dropout=0.0,
                max_rel_diff=rel, rtol=PARITY_RTOL, kernel_losses=traj[True],
                plain_losses=traj[False])


# ---- phases 6 and 10: SASRec training, retrieval serving ---------------------


def sasrec_setup(dev, seed, *, dtype, dropout, use_kernels):
    """SASRec at the amazon.gin widths, its step function and state (the
    trainer's recipe: Adam 1e-3, b2 0.98, no clipping)."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.sasrec import SASRec
    from genrec_tpu_torch.trainers.sasrec_trainer import make_loss_fn

    model = SASRec(num_items=BEAUTY_ITEMS, dropout=dropout, fused_ce=use_kernels, dtype=dtype,
                   device=dev, seed=seed, **SASREC_AMAZON)
    optimizer = Adam(1e-3, b2=0.98)
    step_fn = make_train_step(make_loss_fn(), optimizer, clip_norm=None)
    return model, step_fn, TrainState.create(model, optimizer, seed)


@functools.cache
def sasrec_data(seed):
    """The HSTU phase's synthetic Amazon-Beauty data, packed as the SASRec
    trainer packs it: positions kept, no timestamps."""
    from genrec_tpu_torch.data.batching import pack_examples

    ds = beauty_dataset(seed)
    examples = ds.train_examples()

    def repack(epoch):
        arrays, rep = pack_examples(examples, row_len=SASREC_AMAZON["max_seq_len"],
                                    seed=(seed, epoch))
        arrays.pop("segment_valid")
        return arrays, rep

    return ds, repack


def ce_sasrec_rows(dev, seed, model, ptxas) -> dict:
    """B3 and B4 (dx, dW) on the SASRec step's own operands: x the final
    hidden states of packed batches of the train data, w the tied item
    table, both bf16, targets of the batch (pad slots ignored), g the mean
    loss's 1 / valid rows. Held to their plain versions on the first
    batch, bit-equal over two calls, then timed over copies cold in L2."""
    from genrec_tpu_torch.data.batching import batch_iterator
    from genrec_tpu_torch.kernels import fused_ce as fc

    _, repack = sasrec_data(seed)
    arrays, _ = repack(0)
    per_copy = SASREC_BATCH * SASREC_AMAZON["max_seq_len"] * SASREC_AMAZON["embed_dim"] * 2 * 2
    need = max(2, -(-3 * L2_BYTES // per_copy))
    w = model.item_embedding.detach().to(torch.bfloat16)
    copies = []
    with torch.no_grad():
        for batch, _ in batch_iterator(arrays, SASREC_BATCH, drop_last=True):
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            x = model._encode(b["input_ids"], segment_ids=b["segment_ids"],
                              positions=b["positions"]).to(torch.bfloat16)
            t = b["targets"].reshape(-1).to(torch.int32)
            valid = max(int((t != 0).sum()), 1)
            copies.append(dict(x=x.reshape(-1, x.shape[-1]).contiguous(), w=w.clone(),
                               targets=t, g=torch.full(t.shape, 1.0 / valid, device=dev)))
            if len(copies) == need:
                break
    distinct = len(copies)
    while len(copies) < need:  # fresh memory for each set; the values repeat
        copies.append({k: v.clone() for k, v in copies[len(copies) % distinct].items()})
    first = copies[0]
    fwd = dict(x=first["x"], w=first["w"], targets=first["targets"])
    loss, lse = fc.fused_linear_ce_fwd_cuda(**fwd)
    want_loss, want_lse = fc.fused_linear_ce_ref(**fwd)
    errs = {"fwd": {"sasrec_step": max(
        assert_near("sasrec ce loss", loss, want_loss, FP32_TOL),
        assert_near("sasrec ce lse", lse, want_lse, FP32_TOL))}}
    bwd = dict(fwd, lse=want_lse, g=first["g"])
    errs["dx"] = {"sasrec_step": assert_near("sasrec ce dx", fc.fused_linear_ce_dx_cuda(**bwd),
                                             fc.fused_linear_ce_dx_ref(**bwd), BF16_TOL)}
    errs["dw"] = {"sasrec_step": assert_near("sasrec ce dW", fc.fused_linear_ce_dw_cuda(**bwd),
                                             fc.fused_linear_ce_dw_ref(**bwd), BF16_TOL)}
    bit_equal_twice(fc.fused_linear_ce_fwd_cuda, fwd, "sasrec ce fwd")
    bit_equal_twice(fc.fused_linear_ce_dx_cuda, bwd, "sasrec ce dx")
    bit_equal_twice(fc.fused_linear_ce_dw_cuda, bwd, "sasrec ce dW")
    return ce_rows(copies, errs, ptxas, suffix="_sasrec", bit_equal_twice_cases=["sasrec_step"],
                   operands="the SASRec step's: final hidden states of packed train "
                            "batches, the tied item table")


def sasrec_phase(dev, seed, ptxas, profile) -> dict:
    """SASRec at the widths of config/sasrec/amazon.gin: the trainer run,
    fixed steps (B3, B4 dx and B4 dW exactly once a step, no other kernel),
    valid Recall@10 / NDCG@10 of right-aligned rows, 20 fp32 steps through
    the kernels against the plain path, and B3/B4 on the step's own
    operands. With ``profile``, more steps under torch.profiler."""
    from genrec_tpu_torch.data.batching import right_align
    from genrec_tpu_torch.trainers.sasrec_trainer import evaluate, make_eval_step

    trainer = trainer_run(dev, seed, "config/sasrec/amazon.gin", "sasrec_trainer",
                          SASREC_LAUNCHES_PER_STEP)
    ds, repack = sasrec_data(seed)
    model, step_fn, state = sasrec_setup(dev, seed, dtype=torch.bfloat16, dropout=0.2,
                                         use_kernels=True)
    warm = 3
    loop, steps = timed_steps(dev, seed, state, step_fn, repack, SASREC_BATCH, warm=warm)
    n = steps["steps"]
    per_step = check_launches_per_step("SASRec step", steps["launches"],
                                       SASREC_LAUNCHES_PER_STEP, n)
    metrics = evaluate(make_eval_step(model, last_from_length=True),
                       right_align(ds.eval_arrays("valid")), 256, dev)
    out = emit(
        "sasrec", card=torch.cuda.get_device_name(dev), trainer=trainer,
        config="config/sasrec/amazon.gin widths, synthetic data", **steps,
        valid_recall_at_10=metrics["Recall@10"], valid_ndcg_at_10=metrics["NDCG@10"],
        launches_per_step=per_step,
    )
    out["parity"] = parity_phase(dev, seed, setup=sasrec_setup, data=sasrec_data,
                                 phase="sasrec_parity")
    out["kernels"] = ce_sasrec_rows(dev, seed, model.eval(), ptxas)
    if profile:
        out["profile"] = profiled_steps("sasrec_profile", loop, state, step_fn, warm + n)
    return out


def hstu_serving_inputs(dev, seed, dtype, B, L, n_real):
    """B5's inputs as the retrieval head gives them at the amazon.gin widths
    (H 2, hd 32): histories right-aligned (padding in front) of 1 to L
    items, rows past the ``n_real`` requests all padding, timestamps ~1
    event a day and 0 on padding; row 0 holds one item."""
    rng = np.random.default_rng(seed)
    H = HSTU_AMAZON["num_heads"]
    hd = HSTU_AMAZON["embed_dim"] // H
    pad = np.ones((B, L), bool)
    for b in range(n_real):
        pad[b, L - int(rng.integers(1, L + 1)):] = False
    pad[0, :L - 1] = True
    ts = np.cumsum(rng.integers(3600, 172800, size=(B, L)), axis=1) + 1_500_000_000
    ts[pad] = 0
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    normal = lambda *shape: t(rng.normal(size=shape).astype(np.float32)).to(dtype)  # noqa: E731
    return dict(q=normal(B, H, L, hd), k=normal(B, H, L, hd), v=normal(B, H, L, hd),
                timestamps=t(ts, torch.int32), padding_mask=t(pad),
                pos_table=t(rng.normal(size=(H, 32)).astype(np.float32) * 0.1),
                time_table=t(rng.normal(size=(H, 64)).astype(np.float32) * 0.1),
                segment_ids=None)


def hstu_serving_kernel_phase(dev, seed) -> dict:
    """B5 at the retrieval serving shapes against its plain version: the
    largest bucket (B 16, L 50, 12 requests and 4 all-padding rows), the
    smallest (B 1, L 8), L 16 and 32, and the bucket every burst of the
    retrieve phase's traffic lands in (RETRIEVE_BUCKET), bf16 and fp32;
    every padded query row, the all-padding rows among them, exactly 0.
    Timed at the bursts' bucket in bf16 (the HSTU head's type)."""
    from genrec_tpu_torch.kernels.hstu_attention import hstu_attention_fwd_cuda, hstu_attention_ref

    errs = {}
    for i, (B, L, n_real) in enumerate(((16, 50, 12), (1, 8, 1), (8, 16, 5), (4, 32, 4),
                                        RETRIEVE_BUCKET)):
        for dtype in (torch.bfloat16, torch.float32):
            name = f"B{B}_L{L}_{str(dtype)[6:]}"
            x = hstu_serving_inputs(dev, seed + i, dtype, B, L, n_real)
            got = hstu_attention_fwd_cuda(**x)
            torch.cuda.synchronize()
            pad = x["padding_mask"]
            check(float(got.float().transpose(1, 2)[pad].abs().max()) == 0.0,
                  f"B5 {name}: padded query rows must be exactly 0")
            errs[name] = assert_near(f"B5 {name}", got, hstu_attention_ref(**x),
                                     BF16_TOL if dtype == torch.bfloat16 else FP32_TOL)
    B, L, n_real = RETRIEVE_BUCKET
    base = hstu_serving_inputs(dev, seed, torch.bfloat16, B, L, n_real)
    copies = cold_copies(lambda c: hstu_serving_inputs(dev, seed + 100 + c, torch.bfloat16,
                                                       B, L, n_real),
                         nbytes(*(v for v in base.values() if v is not None)))
    bit_equal_twice(hstu_attention_fwd_cuda, base, "B5 bf16 at the serving bucket")
    bounds = hstu_bounds(base)
    bound_ms, bound_by = bounds["fwd"]
    return emit(
        "kernel", name="hstu_attention_fwd_retrieve", kernel="hstu_attention_fwd",
        shape=dict(B=B, H=2, L=L, hd=32, dtype="bf16", requests=n_real,
                   layout="right-aligned, rows past the requests all padding"),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        tolerance=dict(fp32=FP32_TOL, bf16=BF16_TOL, relative_to="max|plain|"),
        ms=device_ms(hstu_attention_fwd_cuda, copies),
        plain_ms=device_ms(hstu_attention_ref, copies), library_ms=None,
        library="none: no single PyTorch call computes biased SiLU attention",
        timed_by="cuda_graph", bound_ms=bound_ms, bound_by=bound_by,
        work=dict(visible_pairs=bounds["work"]["visible_pairs"],
                  bytes=bounds["work"]["fwd_bytes"], flops=bounds["work"]["fwd_flops"]),
        cold_copies=len(copies), bit_equal_twice=True,
    )


def retrieval_requests(ds, rng, n):
    """``n`` requests alternating between the heads, each the valid-split
    history (``seq[:-2]``, as ``ds.eval_arrays("valid")`` holds it) of a
    user of ``ds`` drawn at random, HSTU's with that user's timestamps."""
    from genrec_tpu_torch.serving.types import Request

    users = rng.integers(0, len(ds.sequences), n)
    return [Request(head=("sasrec", "hstu")[i % 2], history=ds.sequences[u][:-2],
                    user_id=int(u), timestamps=ds.timestamps[u][:-2] if i % 2 else None)
            for i, u in enumerate(users)]


class GcPauses:
    """The process's generation-2 garbage collections while the block runs,
    in ms (``.ms``). Entering collects and freezes every object alive (the
    phase's requests and the answers it keeps for its checks, which a
    server would not hold), so a collection inside scans only what was
    made since."""

    def __enter__(self):
        gc.collect()
        gc.freeze()
        self.ms, self._t0 = [], 0.0
        gc.callbacks.append(self._timed)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._timed)

    def _timed(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif info["generation"] == 2:
            self.ms.append(1e3 * (time.perf_counter() - self._t0))


def serve_open_loop(engine, reqs, rate, seed):
    """Submit ``reqs`` at Poisson arrivals of ``rate`` a second (the
    schedule drawn from ``seed``), then wait for every answer. Returns
    (responses, seconds from the first arrival to the last answer, the
    latest a submission fell behind its schedule in seconds)."""
    gaps = np.random.default_rng(seed).exponential(1.0 / rate, len(reqs))
    due = np.cumsum(gaps) - gaps[0]
    futures, late = [], 0.0
    t0 = time.perf_counter()
    for req, at in zip(reqs, due):
        wait = at - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - t0 - at)
        futures.append(engine.submit(req))
    responses = [f.result(timeout=300) for f in futures]
    return responses, time.perf_counter() - t0, late


def offline_topk(head, req, bucket):
    """``last_hidden`` + ``item_topk`` of one request laid out alone in its
    bucket's (B, L) batch on the card: (scores, ids) of the top k + 1."""
    from genrec_tpu_torch.parallel.shardings import item_topk

    batch = head.make_batch([req], *bucket)
    table = head.table
    h = head.model.last_hidden(*batch)
    scores, ids = item_topk(h.float(), table, head.top_k + 1)
    return scores[0].cpu().numpy(), ids[0].cpu().numpy()


def check_answer(what, resp, want_scores, want_ids, tol) -> bool:
    """The engine's answer against offline scoring: scores within ``tol`` x
    max |score| rank by rank; items equal, except at ranks whose offline
    score is within that of a neighbour's (k + 1 scored), where the two may
    trade places. Returns whether such a near tie moved an item."""
    k = len(resp.items)
    scale = float(np.abs(want_scores[:k]).max())
    err = float(np.abs(resp.scores - want_scores[:k]).max())
    check(err <= tol * scale, (what, "scores", err, tol * scale))
    moved = np.nonzero(resp.items != want_ids[:k])[0]
    for j in moved:
        near = [abs(want_scores[j] - want_scores[i]) <= tol * scale
                for i in (j - 1, j + 1) if 0 <= i <= k]
        check(any(near) and resp.items[j] in want_ids,
              (what, "items differ outside a near tie", resp.items, want_ids))
    return bool(len(moved))


def retrieve_phase(dev, seed, profile=False) -> dict:
    """One ServingEngine a scoring table, each with RetrievalHead("sasrec")
    (fp32) and RetrievalHead("hstu", use_timestamps=True) (bf16, B5) at
    their Amazon widths, random weights from ``seed``. The traffic is
    ``retrieval_requests`` over the synthetic Amazon-Beauty set. Two loads:
    bursts of RETRIEVE_BURST requests submitted at once, the fp32 and int8
    tables interleaved (RETRIEVE_ORDER), whose qps is each burst's
    requests over its wall time (and the median micro-batch's compute time
    beside it, which host stalls move less); then RETRIEVE_OPEN requests
    at Poisson arrivals of RETRIEVE_RATE a second, whose per-head p50 / p99
    latency and bucket hits are reported. Each load runs under
    ``GcPauses``, whose pauses are reported too. B5 must launch exactly
    num_blocks times an HSTU micro-batch and no other kernel at all; every
    item must be in the catalog; the first RETRIEVE_SAMPLE burst answers a
    head and the first open-loop answer of every (head, bucket) must equal
    offline scoring on the card; int8 answers keep a per-request recall of
    INT8_RECALL_FLOOR against fp32 in the same bucket."""

    from genrec_tpu_torch.models.hstu import HSTU
    from genrec_tpu_torch.models.sasrec import SASRec
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import RetrievalHead

    sasrec = SASRec(num_items=BEAUTY_ITEMS, device=dev, seed=seed, **SASREC_AMAZON).eval()
    hstu = HSTU(num_items=BEAUTY_ITEMS, use_pallas=True, dtype=torch.bfloat16, device=dev,
                seed=seed + 1, **HSTU_AMAZON).eval()
    ladder = BucketLadder(*RETRIEVE_LADDER)
    ds = beauty_dataset(seed)
    rng = np.random.default_rng(seed)
    tols = {"sasrec": SASREC_SCORE_TOL, "hstu": HSTU_SCORE_TOL}

    def engine(quantized):
        heads = [RetrievalHead("sasrec", sasrec, top_k=RETRIEVE_TOP_K, quantized=quantized),
                 RetrievalHead("hstu", hstu, top_k=RETRIEVE_TOP_K, use_timestamps=True,
                               quantized=quantized)]
        return ServingEngine(heads, device=dev, ladder=ladder, max_batch=16,
                             max_wait_ms=2.0).start(), {h.name: h for h in heads}

    def hits(eng):
        return collections.Counter(eng.stats()["bucket_hits"])

    engines = {q: engine(q) for q in (False, True)}
    for eng, _ in engines.values():  # first calls: cuBLAS handles, allocator, kernel library
        serve(eng, retrieval_requests(ds, rng, 64))
    burst = retrieval_requests(ds, rng, RETRIEVE_BURST)
    steady = retrieval_requests(ds, rng, RETRIEVE_OPEN)
    lengths = np.asarray([len(r.history) for r in burst + steady])
    before = {q: hits(eng) for q, (eng, _) in engines.items()}
    reset_counters()
    bursts, gc_ms = {False: [], True: []}, {False: [], True: []}
    for q in RETRIEVE_ORDER:
        with GcPauses() as pauses:
            bursts[q].append(serve(engines[q][0], burst))
        gc_ms[q].append(pauses.ms)
    burst_hits = {q: hits(eng) - before[q] for q, (eng, _) in engines.items()}
    opened = {}
    for q in (False, True):
        with GcPauses() as pauses:
            opened[q] = serve_open_loop(engines[q][0], steady, RETRIEVE_RATE, seed + 1)
        gc_ms[q].append(pauses.ms)
    gc.unfreeze()
    launches = read_counters()
    total_hits = {q: collections.Counter(eng.stop()["bucket_hits"]) - before[q]
                  for q, (eng, _) in engines.items()}
    hstu_batches = sum(n for q in total_hits for k, n in total_hits[q].items()
                       if k.startswith("hstu/"))
    check_launches_per_step("retrieval", launches,
                            {"hstu_attention_fwd": HSTU_AMAZON["num_blocks"]}, hstu_batches)

    runs, checked, near_ties = {}, {}, 0
    for q, (_, heads) in engines.items():
        table = "int8" if q else "fp32"
        first = bursts[q][0][0]
        answers = [(req, resp) for responses, _ in bursts[q] for req, resp in zip(burst, responses)]
        answers += list(zip(steady, opened[q][0]))
        for req, resp in answers:
            check(resp.head == req.head and resp.items.shape == (RETRIEVE_TOP_K,), resp)
            check(bool(((resp.items >= 1) & (resp.items <= BEAUTY_ITEMS)).all()),
                  ("items outside the catalog", resp.items))
            check(bool(np.isfinite(resp.scores).all() and (np.diff(resp.scores) <= 0).all()),
                  resp.scores)
        sample, seen = [], set()
        for name in heads:
            sample += [(r, a) for r, a in zip(burst, first) if r.head == name][:RETRIEVE_SAMPLE]
        for req, resp in zip(steady, opened[q][0]):
            if (req.head, resp.bucket) not in seen:
                seen.add((req.head, resp.bucket))
                sample.append((req, resp))
        for req, resp in sample:
            with torch.no_grad():
                want = offline_topk(heads[req.head], req, resp.bucket)
            near_ties += check_answer(f"{table} {req.head}", resp, *want, tols[req.head])
        checked[table] = dict(burst=RETRIEVE_SAMPLE * len(heads),
                              open_loop_buckets=len(sample) - RETRIEVE_SAMPLE * len(heads))
        qps = [len(burst) / wall for _, wall in bursts[q]]
        responses, wall, late = opened[q]
        by_head = {}
        for name in heads:
            ms = np.asarray([r.total_s for r in responses if r.head == name]) * 1e3
            n_batches = sum(n for k, n in (total_hits[q] - burst_hits[q]).items()
                            if k.startswith(name + "/"))
            by_head[name] = dict(requests=len(ms), batches=n_batches,
                                 mean_batch=len(ms) / n_batches,
                                 p50_ms=float(np.percentile(ms, 50)),
                                 p99_ms=float(np.percentile(ms, 99)))
        runs[q] = dict(
            table=table,
            burst=dict(requests=len(burst), qps=qps, qps_median=float(np.median(qps)),
                       qps_spread=float((max(qps) - min(qps)) / np.median(qps)),
                       wall_s=[wall for _, wall in bursts[q]],
                       batch_ms_p50=[1e3 * float(np.median([r.compute_s for r in responses]))
                                     for responses, _ in bursts[q]],
                       gc_gen2_ms=gc_ms[q][:-1],
                       bucket_hits=dict(sorted(burst_hits[q].items()))),
            open_loop=dict(requests=len(responses), offered_qps=RETRIEVE_RATE,
                           achieved_qps=len(responses) / wall, wall_s=wall,
                           max_late_ms=1e3 * late, gc_gen2_ms=gc_ms[q][-1], by_head=by_head,
                           bucket_hits=dict(sorted((total_hits[q] - burst_hits[q]).items()))),
            table_bytes={name: (h.table.nbytes if q else nbytes(h.table))
                         for name, h in heads.items()})
    pairs = [(a, b) for a, b in zip(bursts[False][0][0] + opened[False][0],
                                    bursts[True][0][0] + opened[True][0])
             if a.bucket == b.bucket]
    recall = [len(set(a.items.tolist()) & set(b.items.tolist())) / RETRIEVE_TOP_K
              for a, b in pairs]
    check(min(recall) >= INT8_RECALL_FLOOR,
          f"int8 recall@{RETRIEVE_TOP_K} against fp32: min {min(recall)} < {INT8_RECALL_FLOOR}")
    out = emit("retrieve", card=torch.cuda.get_device_name(dev),
               config="SASRec at config/sasrec/amazon.gin widths (fp32), HSTU at "
                      "config/hstu/amazon.gin widths (bf16, use_pallas=True), random weights, "
                      f"{BEAUTY_ITEMS} items",
               traffic=dict(source="valid-split histories of SyntheticSeqDataset("
                                   f"num_items={BEAUTY_ITEMS}, num_users={BEAUTY_USERS})",
                            history_min=int(lengths.min()), history_max=int(lengths.max()),
                            history_mean=float(lengths.mean())),
               order=["int8" if q else "fp32" for q in RETRIEVE_ORDER],
               fp32=runs[False], int8=runs[True], launches=launches,
               hstu_batches=hstu_batches,
               b5_launches_per_hstu_batch=launches["hstu_attention_fwd"] / hstu_batches,
               sample_checked=checked, sample_near_ties=near_ties,
               int8_recall_pairs=len(pairs), int8_recall_mean=float(np.mean(recall)),
               int8_recall_min=float(min(recall)), int8_recall_floor=INT8_RECALL_FLOOR,
               score_tolerance=dict(sasrec=SASREC_SCORE_TOL, hstu=HSTU_SCORE_TOL,
                                    relative_to="max|score|"))
    if profile:
        out["profile"] = {}
        for q in (False, True):
            eng, _ = engine(q)
            serve(eng, burst)
            table = "int8" if q else "fp32"
            out["profile"][table] = emit("retrieve_profile", table=table, requests=len(burst),
                                         **device_profile(lambda: serve(eng, burst)[1]))
            eng.stop()
    return out


# ---- phase 7: RQ-VAE semantic ids -------------------------------------------


def rqvae_trainer_run(dev, seed) -> dict:
    """rqvae_trainer.train through config/tiger/amazon/rqvae.gin with
    synthetic item embeddings at Amazon-Beauty's size, RQVAE_EPOCHS epochs:
    the user's entry point. Its epoch losses and collision rate come back
    from the run's metrics.jsonl."""
    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.models.rqvae import count_distinct
    from genrec_tpu_torch.trainers import rqvae_trainer

    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / "config/tiger/amazon/rqvae.gin"),
                         substitutions={"split": "beauty"})
    with tempfile.TemporaryDirectory() as tmp:
        for binding in ('train.dataset = "synthetic"', f"train.num_items = {CATALOG_ITEMS}",
                        "train.wandb_logging = False", f'train.save_dir_root = "{tmp}"',
                        f'train.sem_ids_path = "{tmp}/sem_ids.npz"',
                        f"train.epochs = {RQVAE_EPOCHS}", f"train.seed = {seed}",
                        f'train.device = "{dev}"'):
            configlib.parse_binding(binding)
        reset_counters()
        t0 = time.perf_counter()
        model, sem_ids = rqvae_trainer.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()["rq_cascade"]
        logged = [json.loads(line) for line in open(f"{tmp}/metrics.jsonl")]
    configlib.clear_bindings()
    configlib.clear_macros()
    epoch_loss = [m["train/loss"] for m in logged if "epoch" in m and "train/loss" in m]
    collision = [m["collision_rate"] for m in logged if "collision_rate" in m]
    check(len(epoch_loss) == RQVAE_EPOCHS and np.isfinite(epoch_loss).all(), epoch_loss)
    check(np.mean(epoch_loss[-3:]) < np.mean(epoch_loss[:3]), ("loss did not fall", epoch_loss))
    check(sem_ids.shape == (CATALOG_ITEMS, 3) and collision, (sem_ids.shape, collision))
    # The collision eval and the export each run B7 once a 4096-item chunk.
    chunks = -(-CATALOG_ITEMS // SEM_ID_CHUNK)
    check(launches == chunks * (1 + len(collision)), (launches, chunks, len(collision)))
    distinct = int(count_distinct(torch.as_tensor(sem_ids)))
    return dict(wall_s=wall_s, epochs=RQVAE_EPOCHS, epoch_loss=epoch_loss,
                collision_rate=collision[-1], export_collision_rate=1 - distinct / len(sem_ids),
                rq_cascade_launches=launches)


def rqvae_phase(dev, seed, profile=False) -> dict:
    """The trainer run, fixed steps at the file's widths, and the sem-id
    export over Amazon-Beauty's 12,101 items through B7. With ``profile``,
    one more epoch of steps under torch.profiler."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.logging import Tracker, setup_logger
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.data.items import SyntheticItemEmbeddings
    from genrec_tpu_torch.models.rqvae import QuantizeForwardMode, RqVae, kmeans_init_params
    from genrec_tpu_torch.ops.schedules import linear_schedule_with_warmup
    from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop
    from genrec_tpu_torch.trainers.rqvae_trainer import compute_sem_ids, make_loss_fn

    trainer = rqvae_trainer_run(dev, seed)
    src = SyntheticItemEmbeddings(num_items=CATALOG_ITEMS, dim=768, seed=seed)
    train_x, _ = src.arrays()
    model = RqVae(input_dim=768, embed_dim=32, hidden_dims=(512, 256, 128, 64),
                  codebook_size=256, codebook_mode=QuantizeForwardMode.STE,
                  codebook_last_layer_mode=QuantizeForwardMode.SINKHORN, n_layers=3,
                  commitment_weight=0.25, n_cat_features=0, device=dev, seed=seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kmeans_init_params(model, torch.as_tensor(train_x[:20000], device=dev),
                       torch.Generator(device=dev).manual_seed(seed + 1))
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    steps_per_epoch = len(train_x) // 1024
    optimizer = Adam(linear_schedule_with_warmup(1e-3, 50 * steps_per_epoch,
                                                 5000 * steps_per_epoch), weight_decay=1e-4)
    step_fn = make_train_step(make_loss_fn(0.2), optimizer, clip_norm=1.0)
    state = TrainState.create(model, optimizer, seed)
    events, losses = [], []

    def hook(state, m, global_step, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(m["loss"])

    loop = PackedTrainLoop(logger=setup_logger(None), tracker=Tracker(), device=dev,
                           rows_per_step=1024, row_len=1, seed=seed, pack_sequences=False,
                           train_arrays={"x": train_x}, step_hook=hook)
    loop.run_epoch(state, step_fn, 0, 0, max_steps=RQVAE_WARM)
    events.clear()
    losses.clear()
    torch.cuda.synchronize()
    first = torch.cuda.Event(enable_timing=True)
    first.record()
    t0 = time.perf_counter()
    step, epoch = RQVAE_WARM, 0
    while step < RQVAE_WARM + RQVAE_STEPS:  # across epochs: 11 steps an epoch
        start = RQVAE_WARM if epoch == 0 else 0
        res = loop.run_epoch(state, step_fn, epoch, step, start_batch=start,
                             max_steps=RQVAE_WARM + RQVAE_STEPS)
        step, epoch = res.global_step, epoch + 1
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip([first] + events[:-1], events)]
    loss = [float(v) for v in losses]
    check(len(loss) == RQVAE_STEPS and np.isfinite(loss).all(), loss)
    check(np.mean(loss[-5:]) < np.mean(loss[:5]), ("loss did not fall", loss))

    # The export: B7 through compute_sem_ids, against the model path.
    reset_counters()
    t0 = time.perf_counter()
    sem_ids = compute_sem_ids(model, src.embeddings, batch_size=SEM_ID_CHUNK, use_pallas=True)
    export_s = time.perf_counter() - t0
    launches = read_counters()["rq_cascade"]
    chunks = -(-CATALOG_ITEMS // SEM_ID_CHUNK)
    check(launches == chunks, f"export: {launches} B7 launches, want {chunks}")
    model_ids = compute_sem_ids(model, src.embeddings, batch_size=SEM_ID_CHUNK,
                                use_pallas=False)
    with torch.no_grad():
        enc = model.encode(torch.as_tensor(src.embeddings, device=dev))
    ties = check_sem_ids("export vs get_semantic_ids", enc, model.codebooks().detach(),
                         torch.as_tensor(sem_ids, device=dev),
                         torch.as_tensor(model_ids, device=dev))
    distinct = len({tuple(r) for r in sem_ids.tolist()})
    prof = None
    if profile:
        def run_more():
            t = time.perf_counter()
            loop.run_epoch(state, step_fn, epoch, step, max_steps=step + steps_per_epoch)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        prof = emit("rqvae_profile", steps=steps_per_epoch, **device_profile(run_more))
    return emit(
        "rqvae", card=torch.cuda.get_device_name(dev), trainer=trainer, profile=prof,
        config="config/tiger/amazon/rqvae.gin widths, synthetic item embeddings "
               f"({CATALOG_ITEMS} x 768)", kmeans_init_s=kmeans_s, rows_per_step=1024,
        steps=len(loss), steps_per_s=len(loss) / wall_s, wall_s=wall_s,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p90=float(np.percentile(step_ms, 90)),
        first_loss=loss[0], last_loss=loss[-1], losses=loss,
        export=dict(items=CATALOG_ITEMS, chunk=SEM_ID_CHUNK, rq_cascade_launches=launches,
                    wall_s=export_s, collision_rate=1 - distinct / CATALOG_ITEMS,
                    vs_model_path=ties),
    )


# ---- phase 8: the serving slice --------------------------------------------


def make_requests(rng, n, n_items):
    from genrec_tpu_torch.serving.types import Request

    return [
        Request(head="tiger", history=rng.integers(0, n_items, int(k)),
                user_id=int(rng.integers(0, 2**31 - 1)))
        for k in rng.integers(1, MAX_ITEMS + 1, n)
    ]


def serve(engine, reqs):
    t0 = time.perf_counter()
    futures = [engine.submit(r) for r in reqs]
    responses = [f.result(timeout=300) for f in futures]
    return responses, time.perf_counter() - t0


def offline_answer(model, head, trie, req, L, kv_dtype="float32"):
    from genrec_tpu_torch.models.tiger import tiger_generate_paged

    user, ids, types, mask = (t.to(model.device) for t in head.make_batch([req], 1, L))
    out = tiger_generate_paged(model, trie, user, ids, types, mask,
                               n_top_k_candidates=BEAMS,
                               page_size=PAGED["page_size"], kv_dtype=kv_dtype)
    return out.sem_ids[0].cpu().numpy(), out.log_probas[0].cpu().numpy()


def int8_answers_agree(sem, logp, got_sem, got_scores, atol,
                       beams=BEAMS) -> tuple[float, int]:
    """Offline (sem, logp) against an engine answer, both (beams, D) tuples
    with descending scores: every tuple in both has scores within
    ``atol``; a tuple in one only scores within ``atol`` of the other's
    last (it sat at the cut-off); every answer's scores sort descending.
    Returns (max score difference of the shared tuples, beams whose rank
    differs)."""
    want = {tuple(t): float(v) for t, v in zip(sem.tolist(), logp)}
    got = {tuple(t): float(v) for t, v in zip(got_sem.tolist(), got_scores)}
    check(len(want) == len(got) == beams, (want, got))
    err = max([abs(want[t] - got[t]) for t in want.keys() & got.keys()] or [0.0])
    check(err <= atol, ("int8 scores of the same tuples", err, want, got))
    for a, b in ((want, got), (got, want)):
        floor = min(b.values())
        check(all(a[t] <= floor + atol for t in a.keys() - b.keys()),
              ("a tuple of one answer only, above the other's cut-off", want, got))
    check(bool((np.diff(got_scores) <= 0).all()), got_scores)
    moved = int(sum(tuple(x) != tuple(y) for x, y in zip(sem.tolist(), got_sem.tolist())))
    return err, moved


@functools.cache
def port_kernel_names() -> frozenset:
    """The names of the ``__global__`` functions in the port's sources."""
    from genrec_tpu_torch.kernels.build import CSRC

    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)")
    return frozenset(n for src in CSRC.glob("*.cu") for n in pattern.findall(src.read_text()))


def device_profile(serve_once) -> dict:
    """Device time by CUDA kernel over one ``serve_once()`` under
    torch.profiler: the top 12, and every kernel of the port's own with its
    share of the device's busy time. The
    profiler slows the host, so the idle share it shows is an upper bound
    on the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = serve_once()
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(ms for _, ms, _ in kernels)
    return dict(
        wall_ms=1e3 * wall_s, device_busy_ms=busy_ms,
        device_idle_share=1 - busy_ms / (1e3 * wall_s),
        kernel_launches=sum(n for _, _, n in kernels),
        top_kernels=[dict(name=k[:90], ms=ms, launches=n) for k, ms, n in kernels[:12]],
        port_kernels=[dict(name=k[:90], ms=ms, launches=n, share_of_device_time=ms / busy_ms)
                      for k, ms, n in kernels
                      if (m := re.search(r"::(\w+)[<(]", k))
                      and m.group(1) in port_kernel_names()],
    )


def burst_kernel(kv_dtype, bf16=False) -> str:
    """The paged-attention kernel a burst with ``kv_dtype`` pages runs, of
    a bf16 model where ``bf16``."""
    if kv_dtype == "int8":
        return "paged_attention_stats_quantized" + ("_bf16q" if bf16 else "")
    return "paged_attention_stats" + ("_bf16" if bf16 else "")


def check_burst(eng, head, reqs, responses, stats, counts, kernel, layers, shape) -> int:
    """What every generative burst must show: each request answered and
    the pool empty again; ``kernel`` launched exactly once a decoder layer
    a decode step and no other kernel; each answer ``shape`` (beams,
    depth) with finite scores naming catalog items. Returns the launches."""
    others = {k: v for k, v in counts.items() if k != kernel and v}
    check(not others, f"{head.name} burst launched other kernels: {others}")
    pool = eng.runner(head.name).pool
    pool.check_invariants()
    check(pool.allocator.pages_in_use == 0 and pool.active_slot_count == 0, pool.stats())
    check(stats["completed"] == len(reqs) and stats["failed"] == 0, stats)
    launches, steps = counts[kernel], stats["decode_steps"]
    check(launches > 0 and launches == layers * steps, (launches, steps))
    index = head.catalog.item_index()
    for resp in responses:
        check(resp.sem_ids.shape == shape, resp.sem_ids.shape)
        check(np.isfinite(resp.scores).all() and (resp.scores > -1e30).all(), resp.scores)
        check(all(tuple(int(c) for c in t) in index for t in resp.sem_ids)
              and (resp.items >= 0).all(), ("not catalog items", resp.sem_ids))
    return launches


def check_sample(rng, reqs, responses, kv_dtype, refs, answer, beams, full=None,
                 bf16=False) -> dict:
    """12 sampled answers against offline decoding of the same page type,
    ``answer(model, trie, req, L) -> (sem, scores)``: with ``refs[0]``
    (the card: the same kernel, one request a batch) and, for the first
    4, every other ref (the CPU: the plain version, CPU GEMMs). fp32: equal
    sem-ids, scores within SAMPLE_ATOL; int8: tuples matched within
    INT8_SAMPLE_ATOL; a bf16 model (``bf16``) over bf16 pages: tuples
    matched within SAMPLE_ATOL (two beams nearer than that may trade
    ranks). With ``full`` (the indices of the requests whose
    history fills their bucket), the first 8 are drawn from those and the
    other 4 from the rest. Returns the line's sample fields."""
    on_cpu = 4 if len(refs) > 1 else 0
    atol = SAMPLE_ATOL if kv_dtype == "float32" else INT8_SAMPLE_ATOL
    if full is None:
        sample = rng.choice(len(reqs), 12, replace=False)
    else:
        rest = np.setdiff1d(np.arange(len(reqs)), full)
        check(len(full) >= 8 and len(rest) >= 4, ("full rows", len(full), len(rest)))
        sample = np.concatenate([rng.choice(full, 8, replace=False),
                                 rng.choice(rest, 4, replace=False)])
    errs, moved = [], 0
    for i, j in enumerate(sample):
        req, resp = reqs[j], responses[j]
        for where, m, trie in refs if i < on_cpu else refs[:1]:
            sem, scores = answer(m, trie, req, resp.bucket[1])
            if kv_dtype == "int8" or bf16:
                err, n = int8_answers_agree(sem, scores, resp.sem_ids, resp.scores, atol, beams)
                moved += n
            else:
                check((sem == resp.sem_ids).all(), (where, j, sem, resp.sem_ids))
                err = float(np.abs(scores - resp.scores).max())
                check(err <= atol, (where, j, scores, resp.scores))
            errs.append(err)
    return dict(sample_checked=len(sample), sample_checked_on_cpu=on_cpu,
                sample_full_rows=0 if full is None else 8,
                sample_max_abs_score_err=max(errs),
                sample_median_request_err=float(np.median(errs)),
                sample_atol=atol, sample_beams_in_another_rank=moved)


def burst_fields(reqs, responses, wall_s, stats, fp32_answers, beams) -> dict:
    """qps, latency percentiles, engine counts, and (given the fp32
    burst's answers) the top-``beams`` agreement of these with them."""
    total_ms = np.asarray([r.total_s for r in responses]) * 1e3
    compute_ms = np.asarray([r.compute_s for r in responses]) * 1e3
    agreement = None
    if fp32_answers is not None:
        agreement = float(np.mean([
            len({tuple(t) for t in a.sem_ids.tolist()} & {tuple(t) for t in b.sem_ids.tolist()})
            / beams for a, b in zip(responses, fp32_answers)]))
    return {"requests": len(reqs), "qps": len(reqs) / wall_s, "wall_s": wall_s,
            "p50_ms": float(np.percentile(total_ms, 50)),
            "p99_ms": float(np.percentile(total_ms, 99)),
            "compute_p50_ms": float(np.percentile(compute_ms, 50)),
            "compute_p99_ms": float(np.percentile(compute_ms, 99)),
            "decode_steps": stats["decode_steps"], "prefill_batches": stats["batches"],
            "bucket_hits": stats["bucket_hits"],
            f"top{beams}_agreement_with_fp32": agreement}


def tiger_catalog(rng):
    """CATALOG_ITEMS unique sem-id tuples, 3 codes of 256, drawn from ``rng``."""
    codes = rng.integers(0, TIGER_AMAZON["num_item_embeddings"],
                         (2 * CATALOG_ITEMS, TIGER_AMAZON["sem_id_dim"]))
    catalog = np.unique(codes, axis=0)
    catalog = catalog[rng.permutation(len(catalog))[:CATALOG_ITEMS]]
    check(len(catalog) == CATALOG_ITEMS, len(catalog))
    return catalog


def compute_in(model, cls, config, dev, dtype):
    """``model`` itself, or (``dtype`` bf16) a copy computing in bf16 with
    the same parameters: Flax-style, parameters stay float32 and are cast
    where used."""
    if dtype == torch.float32:
        return model
    copy = cls(**config, device=dev, dtype=dtype).eval()
    copy.load_state_dict(model.state_dict())
    return copy


def serve_phase(dev, seed, n_requests, profile=False, kv_dtype="float32",
                fp32_answers=None, dtype=torch.float32) -> tuple[dict, dict | None, list]:
    """The serving burst with ``kv_dtype`` pages. The same seed gives the
    same catalog, weights and requests for both page types; with
    ``fp32_answers`` (the float32 burst's responses) the int8 answers'
    top-10 agreement with them is reported. ``dtype`` bf16: the same
    seeded weights computing in bf16 (pages of the model's dtype, or int8),
    the ``serve_bf16`` lines. Returns (the phase's line,
    the profile's line or None, the responses)."""
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.obs.memory import tree_nbytes
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import TigerGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig

    bf16 = dtype == torch.bfloat16
    rng = np.random.default_rng(seed)
    catalog = tiger_catalog(rng)
    model = compute_in(Tiger(**TIGER_AMAZON, device=dev, seed=seed).eval(), Tiger,
                       TIGER_AMAZON, dev, dtype)
    head = TigerGenerativeHead(model, item_sem_ids=catalog, top_k=BEAMS)
    ladder = BucketLadder((1, 2, 4, 8, 16), (4, 8, 16, MAX_ITEMS))

    cfg = PagedConfig(**PAGED, kv_dtype=kv_dtype)

    def engine():
        # The prefix cache off: the sample is held to offline decoding at each
        # answer's prefill bucket (the spec phases serve with the cache on).
        return ServingEngine([head], device=dev, ladder=ladder, max_batch=16,
                             max_wait_ms=2.0, paged_config=cfg, kv_dtype=kv_dtype,
                             prefix_cache=False).start()

    warm = engine()  # first calls: cuBLAS handles, allocator, kernel library
    serve(warm, make_requests(rng, 32, CATALOG_ITEMS))
    warm.stop()

    reqs = make_requests(rng, n_requests, CATALOG_ITEMS)
    eng = engine()
    reset_counters()
    responses, wall_s = serve(eng, reqs)
    counts = read_counters()
    stats = eng.stop()
    kernel = burst_kernel(kv_dtype, bf16)
    decode_layers = TIGER_AMAZON["n_layers"] // 2
    launches = check_burst(eng, head, reqs, responses, stats, counts, kernel, decode_layers,
                           (BEAMS, TIGER_AMAZON["sem_id_dim"]))
    pools = eng.runner(head.name).pool
    pool_bytes = tree_nbytes((pools.k_pools, pools.v_pools))

    refs = [("cuda", model, head.trie)]
    if kv_dtype == "float32" and not bf16:
        cpu_model = Tiger(**TIGER_AMAZON, device="cpu").eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        refs.append(("cpu", cpu_model, head.catalog.device_trie("cpu")))
    sampled = check_sample(
        rng, reqs, responses, kv_dtype, refs,
        lambda m, trie, req, L: offline_answer(m, head, trie, req, L, kv_dtype), BEAMS,
        bf16=bf16)

    geometry = (decode_layers, TIGER_AMAZON["num_heads"],
                TIGER_AMAZON["attn_dim"] // TIGER_AMAZON["num_heads"])
    pool_bytes_fp32 = PagedConfig(**PAGED).hbm_bytes(*geometry)
    # The pools as allocated: bf16 pages exactly half fp32's; int8 the
    # geometry's int8 bytes whatever the model's dtype.
    check(pool_bytes == (pool_bytes_fp32 // 2 if bf16 and kv_dtype == "float32"
                         else cfg.hbm_bytes(*geometry)), (pool_bytes, pool_bytes_fp32))
    served = emit(
        ("serve_bf16" if bf16 else "serve") + ("_int8" if kv_dtype == "int8" else ""),
        kv_dtype=kv_dtype, dtype=str(dtype).replace("torch.", ""),
        card=torch.cuda.get_device_name(dev),
        **burst_fields(reqs, responses, wall_s, stats, fp32_answers, BEAMS),
        kernel=kernel, paged_attention_launches=launches,
        launches_per_decode_step=launches / stats["decode_steps"],
        catalog_items=CATALOG_ITEMS, catalog_version=head.catalog_version, **sampled,
        pool_bytes=pool_bytes, pool_bytes_fp32=pool_bytes_fp32,
    )
    if not profile or bf16:
        return served, None, responses
    # The same traffic again, a fresh request set, under the profiler.
    again = make_requests(rng, n_requests, CATALOG_ITEMS)
    eng = engine()
    prof = emit("profile" if kv_dtype == "float32" else "profile_int8", requests=n_requests,
                **device_profile(lambda: serve(eng, again)[1]))
    eng.stop()
    return served, prof, responses


# ---- phase 9: COBRA serving ---------------------------------------------------


def cobra_catalog(seed):
    """CATALOG_ITEMS unique sem-id tuples (3 codes of 256), built as the
    TIGER serve phase builds its catalog, and each item's text: 32 token
    ids in [1, 32,128) (0 is the tower's padding)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, COBRA_AMAZON["id_vocab_size"],
                         (2 * CATALOG_ITEMS, COBRA_AMAZON["n_codebooks"]))
    catalog = np.unique(codes, axis=0)
    catalog = catalog[rng.permutation(len(catalog))[:CATALOG_ITEMS]]
    check(len(catalog) == CATALOG_ITEMS, len(catalog))
    text = rng.integers(1, COBRA_AMAZON["encoder_vocab_size"], (CATALOG_ITEMS, COBRA_TEXT_LEN))
    return catalog, text


def cobra_offline_answer(model, head, trie, req, L, kv_dtype="float32"):
    from genrec_tpu_torch.models.cobra import cobra_generate_paged

    ids, vecs = (t.to(model.device) for t in head.make_batch([req], 1, L))
    out = cobra_generate_paged(model, ids, None, n_candidates=COBRA_BEAMS, temperature=1.0,
                               item_vecs=vecs, trie=trie, page_size=COBRA_PAGED["page_size"],
                               kv_dtype=kv_dtype)
    return out.sem_ids[0].cpu().numpy(), out.scores[0].cpu().numpy()


def cobra_requests(ds, rng, n):
    """``n`` COBRA requests, each the valid-split history (``seq[:-2]``, as
    ``ds.eval_arrays("valid")`` holds it) of a user of ``ds`` drawn at
    random, its newest MAX_ITEMS items (train.max_items), as catalog
    indices (``ds`` counts items from 1)."""
    from genrec_tpu_torch.serving.types import Request

    return [Request(head="cobra", history=ds.sequences[u][:-2][-MAX_ITEMS:] - 1,
                    user_id=int(u))
            for u in rng.integers(0, len(ds.sequences), n)]


class CountingDecode:
    """Wraps a paged runner's decode call: counts the calls and the active
    slots each advanced (from the runner's host state, so no sync)."""

    def __init__(self, runner):
        self.runner, self.fn = runner, runner._decode
        self.calls = self.slot_steps = 0
        runner._decode = self

    def __call__(self, *args):
        self.calls += 1
        self.slot_steps += int(self.runner.active.sum())
        return self.fn(*args)


def prefill_device_share(head, make_engine, reqs) -> dict:
    """The prefill's share of the device's busy time in a burst of
    ``reqs``, under torch.profiler: a marker kernel (``torch.cuda._sleep``,
    ATen's ``spin_kernel``) just before and just after every prefill call,
    all on one stream, so the kernels that ran between a pair, in device
    order, are the prefill's; and the paged attention kernels' share (B1
    or B2, by name). The profiler slows the host; the shares of the
    device's busy time are what it measures. The profiler keeps only the
    kernels that lie inside its capture window, whose edges it takes from
    the host's clock: the burst starts and ends ``PROFILE_EDGE_S`` away
    from them, on an idle card, so no marker falls on an edge, and every
    prefill call made inside the window must show both its markers."""
    from torch.profiler import ProfilerActivity, profile

    make_prefill = head.make_prefill_paged_fn
    calls = [0]

    def marked(B, L):
        fn = make_prefill(B, L)

        def call(*args):
            calls[0] += 1
            torch.cuda._sleep(1)
            out = fn(*args)
            torch.cuda._sleep(1)
            return out

        return call

    head.make_prefill_paged_fn = marked
    try:
        eng = make_engine()  # start() runs a prefill of its own, outside the profile
        torch.cuda.synchronize()
        calls[0] = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_EDGE_S)
            serve(eng, reqs)
            torch.cuda.synchronize()
            time.sleep(PROFILE_EDGE_S)
        eng.stop()
    finally:
        del head.make_prefill_paged_fn
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    inside, total, prefill, paged, markers = False, 0.0, 0.0, 0.0, 0
    for e in kernels:
        if "spin_kernel" in e.name:
            inside, markers = not inside, markers + 1
            continue
        us = e.time_range.elapsed_us()
        total += us
        prefill += us if inside else 0.0
        paged += us if "paged_attention" in e.name else 0.0
    check(calls[0] > 0 and markers == 2 * calls[0] and not inside and total > 0,
          ("prefill markers", markers, "calls", calls[0], "device us", total))
    return dict(prefill_share_of_device_time=prefill / total, prefill_device_ms=prefill / 1e3,
                burst_device_ms=total / 1e3, prefill_calls=calls[0],
                paged_attention_share_of_device_time=paged / total,
                paged_attention_device_ms=paged / 1e3, prefill_share_requests=len(reqs))


def cobra_serve_phase(dev, seed, n_requests, profile=False, kv_dtype="float32",
                      fp32_answers=None, dtype=torch.float32) -> tuple[dict, dict | None, list]:
    """COBRA at config/cobra/amazon.gin widths behind ServingEngine +
    CobraGenerativeHead: the tower encoded once on the card from the
    catalog's item text, then ``n_requests`` requests (``cobra_requests``)
    at once with ``kv_dtype`` pages. Every answer a catalog item; B1 (fp32)
    or B2 (int8) exactly once a decoder layer a decode step and no other
    kernel; 2 decode steps a request (codebook 0 resolves at prefill); a
    sample, mostly of rows whose history fills its bucket, against offline
    cobra_generate_paged of the same page type on the card and on the CPU.
    ``dtype`` bf16: the same seeded weights computing in bf16 (the tower
    too), the ``cobra_serve_bf16`` lines, the sample on the card only. With
    float32 pages (either dtype) a further burst under torch.profiler
    gives the prefill's and the paged attention kernel's shares of the
    device time (``prefill_device_share``). Returns (line, profile line or None,
    responses)."""
    from genrec_tpu_torch.models.cobra import Cobra
    from genrec_tpu_torch.obs.memory import tree_nbytes
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import CobraGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig

    bf16 = dtype == torch.bfloat16
    catalog, text = cobra_catalog(seed)
    rng = np.random.default_rng(seed + 1)
    ds = beauty_dataset(seed)
    model = compute_in(Cobra(**COBRA_AMAZON, device=dev, seed=seed).eval(), Cobra,
                       COBRA_AMAZON, dev, dtype)
    t0 = time.perf_counter()
    head = CobraGenerativeHead(model, item_sem_ids=catalog, item_text_tokens=text,
                               top_k=COBRA_BEAMS)
    torch.cuda.synchronize()
    tower_s = time.perf_counter() - t0
    check(head.tower_encodes == 1 and tuple(head.item_vecs.shape) == (
        CATALOG_ITEMS, COBRA_AMAZON["d_model"]), (head.tower_encodes, head.item_vecs.shape))
    check(bool(torch.isfinite(head.item_vecs).all()), "tower not finite")
    ladder = BucketLadder((1, 2, 4, 8, 16), (4, 8, 16, MAX_ITEMS))
    cfg = PagedConfig(**COBRA_PAGED, kv_dtype=kv_dtype)

    def engine():
        # The prefix cache off: the sample is held to offline decoding at each
        # answer's prefill bucket (the spec phases serve with the cache on).
        return ServingEngine([head], device=dev, ladder=ladder, max_batch=16,
                             max_wait_ms=2.0, paged_config=cfg, kv_dtype=kv_dtype,
                             prefix_cache=False).start()

    warm = engine()
    serve(warm, cobra_requests(ds, rng, 32))
    warm.stop()
    check(head.tower_encodes == 1, "the engine re-encoded the tower")

    reqs = cobra_requests(ds, rng, n_requests)
    eng = engine()
    decode = CountingDecode(eng.runner(head.name))
    reset_counters()
    responses, wall_s = serve(eng, reqs)
    counts = read_counters()
    stats = eng.stop()
    kernel = burst_kernel(kv_dtype, bf16)
    layers, C = COBRA_AMAZON["decoder_n_layers"], COBRA_AMAZON["n_codebooks"]
    launches = check_burst(eng, head, reqs, responses, stats, counts, kernel, layers,
                           (COBRA_BEAMS, C))
    check(decode.calls == stats["decode_steps"], (decode.calls, stats["decode_steps"]))
    check(decode.slot_steps == (C - 1) * len(reqs), (decode.slot_steps, len(reqs)))

    # Only a row whose history fills its bucket reads the decode steps'
    # attention (the others take the prefill's hidden state, as JAX does):
    # most of the sample, and every CPU check, is drawn from those.
    items = np.asarray([len(r.history) for r in reqs])
    full = np.flatnonzero(items == np.asarray([r.bucket[1] for r in responses]))
    refs = [("cuda", model, head.trie)]
    if not bf16:
        cpu_model = Cobra(**COBRA_AMAZON, device="cpu").eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        refs.append(("cpu", cpu_model, head.catalog.device_trie("cpu")))
    sampled = check_sample(
        rng, reqs, responses, kv_dtype, refs,
        lambda m, trie, req, L: cobra_offline_answer(m, head, trie, req, L, kv_dtype),
        COBRA_BEAMS, full, bf16=bf16)
    refs.clear()

    geometry = (layers, COBRA_AMAZON["decoder_num_heads"], COBRA_SHAPE[2])
    pools = eng.runner(head.name).pool
    pool_bytes = tree_nbytes((pools.k_pools, pools.v_pools))
    pool_bytes_fp32 = PagedConfig(**COBRA_PAGED).hbm_bytes(*geometry)
    check(pool_bytes == (pool_bytes_fp32 // 2 if bf16 and kv_dtype == "float32"
                         else cfg.hbm_bytes(*geometry)), (pool_bytes, pool_bytes_fp32))
    share = {}
    if kv_dtype == "float32":
        share = prefill_device_share(head, engine, cobra_requests(ds, rng, PREFILL_SHARE_REQUESTS))
    served = emit(
        ("cobra_serve_bf16" if bf16 else "cobra_serve") + ("_int8" if kv_dtype == "int8" else ""),
        kv_dtype=kv_dtype, dtype=str(dtype).replace("torch.", ""),
        card=torch.cuda.get_device_name(dev),
        **burst_fields(reqs, responses, wall_s, stats, fp32_answers, COBRA_BEAMS),
        traffic="valid-split histories of the synthetic Amazon-Beauty users, newest "
                f"{MAX_ITEMS} items", history_items=dict(
                    min=int(items.min()), mean=float(items.mean()), max=int(items.max())),
        full_rows=len(full), full_row_share=len(full) / len(reqs),
        slot_decode_steps=decode.slot_steps,
        decode_steps_per_request=decode.slot_steps / len(reqs),
        kernel=kernel, paged_attention_launches=launches,
        launches_per_decode_step=launches / stats["decode_steps"],
        params=sum(p.numel() for p in model.parameters()),
        tower_encodes=head.tower_encodes, tower_encode_s=tower_s,
        catalog_items=CATALOG_ITEMS, catalog_version=head.catalog_version, **sampled,
        pool_bytes=pool_bytes, pool_bytes_fp32=pool_bytes_fp32,
        suffix_cache_bytes=2 * nbytes(eng.runner(head.name).state["cache_k"]), **share,
    )
    if not profile or bf16:
        return served, None, responses
    again = cobra_requests(ds, rng, n_requests)
    eng = engine()
    prof = emit("cobra_profile" if kv_dtype == "float32" else "cobra_profile_int8",
                requests=n_requests, **device_profile(lambda: serve(eng, again)[1]))
    eng.stop()
    return served, prof, responses


# ---- phases 15-16: speculative tree decode with the prefix cache --------------


def serve_waves(engine, reqs, wave=SPEC_WAVE):
    """Serve ``reqs`` in waves of ``wave`` requests, each submitted at once
    and answered before the next: a wave fills the engine's slots in full
    prefill groups, so two engines given the same traffic prefill the same
    groups of the same requests. Returns (responses, seconds)."""
    t0 = time.perf_counter()
    responses = []
    for i in range(0, len(reqs), wave):
        futures = [engine.submit(r) for r in reqs[i:i + wave]]
        responses.extend(f.result(timeout=300) for f in futures)
    return responses, time.perf_counter() - t0


def spec_traffic(seed, reqs):
    """The burst's requests, then a quarter of them again in a seeded
    order: the repeats are answered warm from the prefix cache. Returns
    (traffic, index of each repeat's original)."""
    rng = np.random.default_rng(seed + 7)
    again = rng.choice(len(reqs), len(reqs) // 4, replace=False)
    return list(reqs) + [reqs[i] for i in again], again


def bf16_answers_agree(what, want, got, tol) -> tuple[float, int]:
    """A bf16 model's engine answers ``got`` against ``want`` (responses,
    one for one): each pair matched tuple by tuple within BF16_SPEC_ATOL
    (``int8_answers_agree``), and at most BF16_SPEC_MAX_SHARE of the pairs
    further apart than ``tol``. Returns (the largest error, the pairs
    beyond ``tol``)."""
    errs = [int8_answers_agree(b.sem_ids, b.scores, a.sem_ids, a.scores, BF16_SPEC_ATOL)[0]
            for a, b in zip(got, want)]
    beyond = sum(e > tol for e in errs)
    check(beyond <= BF16_SPEC_MAX_SHARE * len(errs), (what, "answers beyond", tol, errs))
    return max(errs, default=0.0), beyond


def spec_burst(phase, head, make_engine, warm_reqs, reqs, seed, kernel, layers, shape,
               temperature, solo=None, ladder=None, bf16=False) -> dict:
    """One speculative engine (``make_engine(True)``) against one plain
    engine (``make_engine(False)``) on the same traffic (``spec_traffic``
    of ``reqs``, served in waves). For every request: sem-ids equal the
    plain engine's, scores within SPEC_SCORE_TOL / ``temperature``; every
    repeat admits warm
    and answers as its original did cold. Where the original was prefilled
    at a larger history bucket than its own and ``solo(req, L) -> (sem,
    scores)`` is given (COBRA, whose ``full`` flag depends on the bucket),
    the warm answer is held instead to the request served alone at its own
    bucket ``L``, as a cold engine serving it alone answers (offline on the
    card, within SAMPLE_ATOL). A bf16 model (``bf16``) is held by
    ``bf16_answers_agree`` in place of equal sem-ids and the score
    tolerance. ``kernel`` launched
    exactly ``layers`` times a verify call and no other kernel; pools
    clean, scratch released and the prefix index empty after the drain.
    Reports verify calls a request, the mean accept length, prefix hits,
    and qps / p50 beside the plain engine's."""
    traffic, again = spec_traffic(seed, reqs)
    n = len(reqs)
    tol = SPEC_SCORE_TOL / temperature
    for spec in (False, True):  # first calls of each path: allocator, cuBLAS
        eng = make_engine(spec)
        serve_waves(eng, warm_reqs)
        eng.stop()
    eng = make_engine(False)
    plain, plain_wall = serve_waves(eng, traffic)
    plain_stats = eng.stop()
    check(plain_stats["completed"] == len(traffic) and plain_stats["failed"] == 0, plain_stats)

    eng = make_engine(True)
    runner = eng.runner(head.name)
    decode = CountingDecode(runner)
    reset_counters()
    responses, wall = serve_waves(eng, traffic)
    counts = read_counters()
    stats = eng.stop()
    check(stats["completed"] == len(traffic) and stats["failed"] == 0, stats)
    others = {k: v for k, v in counts.items() if k != kernel and v}
    check(not others, f"{phase} launched other kernels: {others}")
    check(decode.calls == stats["decode_steps"] > 0, (decode.calls, stats["decode_steps"]))
    check(counts[kernel] == layers * decode.calls, (counts[kernel], layers, decode.calls))
    pool = runner.pool
    pool.check_invariants()
    check(pool.allocator.pages_in_use == 0 and pool.active_slot_count == 0
          and pool.scratch_page_count == 0 and stats["kv_pool"][head.name]["scratch_pages"] == 0,
          pool.stats())
    check(stats["prefix_cache"][head.name]["entries"] == 0, stats["prefix_cache"])

    index = head.catalog.item_index()
    score_err = 0.0
    for i, (a, b) in enumerate(zip(responses, plain)):
        check(a.sem_ids.shape == shape, (phase, a.sem_ids.shape))
        check(all(tuple(int(c) for c in t) in index for t in a.sem_ids), a.sem_ids)
        if not bf16:
            check((a.sem_ids == b.sem_ids).all(),
                  (phase, "spec != plain sem-ids", i, a.sem_ids, b.sem_ids))
            score_err = max(score_err, float(np.abs(a.scores - b.scores).max()))
    if bf16:
        score_err, beyond = bf16_answers_agree(phase + " spec vs plain", plain, responses, tol)
    else:
        check(score_err <= tol, (phase, "spec vs plain scores", score_err))
    warm_err, solo_err, n_solo = 0.0, 0.0, 0
    warm, cold = [], []  # bf16: the repeats held to their originals
    for k, i in enumerate(again):
        a, b = responses[n + k], responses[i]
        own_L = ladder.history_bucket(max(len(reqs[i].history), 1)) if solo else None
        if solo is not None and b.bucket[1] != own_L:
            sem, scores = solo(reqs[i], own_L)
            check((a.sem_ids == sem).all(), (phase, "warm != solo cold sem-ids", i))
            solo_err = max(solo_err, float(np.abs(a.scores - scores).max()))
            n_solo += 1
            continue
        if bf16:
            warm.append(a)
            cold.append(b)
            continue
        check((a.sem_ids == b.sem_ids).all(), (phase, "warm != cold sem-ids", i))
        warm_err = max(warm_err, float(np.abs(a.scores - b.scores).max()))
    if bf16:
        warm_err, warm_beyond = bf16_answers_agree(phase + " warm vs cold", cold, warm, tol)
    else:
        check(warm_err <= tol, (phase, "warm vs cold scores", warm_err))
    check(solo_err <= SAMPLE_ATOL, (phase, "warm vs solo cold scores", solo_err))
    pc, spec = stats["prefix_cache"][head.name], stats["spec"][head.name]
    check(pc["hits"] >= len(again), (phase, "repeats admitted cold", pc))
    check(spec["slot_steps"] == decode.slot_steps
          and spec["accepted"] >= spec["slot_steps"], spec)

    def lat(resps):
        ms = np.asarray([r.total_s for r in resps]) * 1e3
        return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))

    p50, p99 = lat(responses)
    plain_p50, plain_p99 = lat(plain)
    return dict(
        requests=len(traffic), repeated=len(again), wave=SPEC_WAVE,
        spec_fanout=SPEC_FANOUT, tree_nodes=runner.spec_topology.n_nodes,
        spec_depth=head.spec_depth, kernel=kernel, paged_attention_launches=counts[kernel],
        launches_per_verify_call=counts[kernel] / decode.calls,
        verify_calls=decode.calls, plain_decode_calls=plain_stats["decode_steps"],
        verify_calls_per_request=decode.slot_steps / len(traffic),
        plain_decode_calls_per_request=(head.paged_total_steps - head.paged_init_step),
        mean_accept_len=spec["codes_per_invocation"], accept_len_hist=spec["accept_len_hist"],
        drafted=spec["drafted"], prefix_hits=pc["hits"], prefix_lookups=pc["lookups"],
        prefix_warm_tokens=pc["warm_tokens"], plain_prefix_hits=plain_stats["prefix_cache"][
            head.name]["hits"],
        qps=len(traffic) / wall, wall_s=wall, p50_ms=p50, p99_ms=p99,
        plain_qps=len(traffic) / plain_wall, plain_wall_s=plain_wall, plain_p50_ms=plain_p50,
        plain_p99_ms=plain_p99, max_abs_score_err_vs_plain=score_err,
        max_abs_score_err_warm_vs_cold=warm_err, score_tol=tol, temperature=temperature,
        repeats_held_to_solo_cold=n_solo, max_abs_score_err_warm_vs_solo_cold=solo_err,
        solo_tol=SAMPLE_ATOL,
        **(dict(bf16_atol=BF16_SPEC_ATOL, bf16_max_share_beyond_score_tol=BF16_SPEC_MAX_SHARE,
                answers_beyond_score_tol_vs_plain=beyond,
                repeats_beyond_score_tol_warm_vs_cold=warm_beyond) if bf16 else {}),
        pool_pages=runner.cfg.num_pages, scratch_pages_reserved=runner._scratch_demand,
        card=torch.cuda.get_device_name(0),
    )


def tiger_spec_serve_phase(dev, seed, n_requests, kv_dtype="float32",
                           dtype=torch.float32) -> dict:
    """TIGER's speculative engine at the serve phase's widths, catalog and
    requests (the same seed), pages of ``kv_dtype``: ``spec_burst``
    against the plain engine. The page budget retains every run of the
    traffic (the full budget plus pages_per_slot a request), so no repeat
    is reclaimed before it arrives; the engine adds the tree's scratch.
    ``dtype`` bf16: the same seeded weights computing in bf16 over pages of
    the model's dtype (``tiger_spec_serve_bf16``, B1 over bf16 pages)."""
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import TigerGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig

    bf16 = dtype == torch.bfloat16
    rng = np.random.default_rng(seed)
    catalog = tiger_catalog(rng)
    model = compute_in(Tiger(**TIGER_AMAZON, device=dev, seed=seed).eval(), Tiger,
                       TIGER_AMAZON, dev, dtype)
    head = TigerGenerativeHead(model, item_sem_ids=catalog, top_k=BEAMS)
    warm_reqs = make_requests(rng, 32, CATALOG_ITEMS)
    reqs = make_requests(rng, n_requests, CATALOG_ITEMS)  # the serve phase's burst
    ladder = BucketLadder((1, 2, 4, 8, 16), (4, 8, 16, MAX_ITEMS))
    budget = 1 + (PAGED["max_slots"] + n_requests) * PAGED["pages_per_slot"]
    cfg = PagedConfig(**PAGED, num_pages=budget, kv_dtype=kv_dtype)

    def make_engine(spec):
        # A head of its own an engine: a speculative runner adds the step-0
        # draft window to its head's prefill, which a plain engine skips.
        return ServingEngine([TigerGenerativeHead(model, catalog=head.catalog, top_k=BEAMS)],
                             device=dev, ladder=ladder, max_batch=16,
                             max_wait_ms=SPEC_MAX_WAIT_MS, paged_config=cfg,
                             spec_decode=spec).start()

    name = ("tiger_spec_serve" + ("_bf16" if bf16 else "")
            + ("_int8" if kv_dtype == "int8" else ""))
    fields = spec_burst(name, head, make_engine, warm_reqs, reqs, seed,
                        burst_kernel(kv_dtype, bf16), TIGER_AMAZON["n_layers"] // 2,
                        (BEAMS, TIGER_AMAZON["sem_id_dim"]), temperature=0.2, bf16=bf16)
    return emit(name, kv_dtype=kv_dtype, dtype=str(dtype).replace("torch.", ""), **fields)


def cobra_spec_serve_phase(dev, seed, n_requests) -> dict:
    """COBRA's speculative engine at the cobra_serve phase's widths,
    catalog, tower and requests (the same seed), float32 pages:
    ``spec_burst`` against the plain engine, the page budget as in
    ``tiger_spec_serve_phase``."""
    from genrec_tpu_torch.models.cobra import Cobra
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import CobraGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig

    catalog, text = cobra_catalog(seed)
    rng = np.random.default_rng(seed + 1)
    ds = beauty_dataset(seed)
    model = Cobra(**COBRA_AMAZON, device=dev, seed=seed).eval()
    head = CobraGenerativeHead(model, item_sem_ids=catalog, item_text_tokens=text,
                               top_k=COBRA_BEAMS)
    warm_reqs = cobra_requests(ds, rng, 32)
    reqs = cobra_requests(ds, rng, n_requests)  # the cobra_serve phase's burst
    ladder = BucketLadder((1, 2, 4, 8, 16), (4, 8, 16, MAX_ITEMS))
    budget = 1 + (COBRA_PAGED["max_slots"] + n_requests) * COBRA_PAGED["pages_per_slot"]
    cfg = PagedConfig(**COBRA_PAGED, num_pages=budget)

    def make_engine(spec):
        return ServingEngine([head], device=dev, ladder=ladder, max_batch=16,
                             max_wait_ms=SPEC_MAX_WAIT_MS, paged_config=cfg,
                             spec_decode=spec).start()

    fields = spec_burst("cobra_spec_serve", head, make_engine, warm_reqs, reqs, seed,
                        burst_kernel("float32"), COBRA_AMAZON["decoder_n_layers"],
                        (COBRA_BEAMS, COBRA_AMAZON["n_codebooks"]), temperature=1.0,
                        solo=lambda req, L: cobra_offline_answer(model, head, head.trie, req, L),
                        ladder=ladder)
    return emit("cobra_spec_serve", kv_dtype="float32", **fields)


# ---- phase 17: the serving engine's live planes -------------------------------

LIVE_BURST_FACTOR = 3  # the live burst is 3 x --requests, so both swaps land mid-burst
LIVE_POLL_S = 0.01  # the checkpoint and catalog watchers' poll
LIVE_DROP_SHARE = 0.01  # items snapshot b removes
LIVE_TRACE_CAPACITY = 1 << 17
LIVE_SPANS = ("request", "queue_wait", "admission", "finalize")


def live_reference(tiger_cls, dev, state):
    """A second TIGER on the card holding ``state`` (offline references)."""
    ref = tiger_cls(**TIGER_AMAZON, device=dev).eval()
    ref.load_state_dict(state)
    return ref


class LaunchesPerCall:
    """Wraps a paged runner's decode call: the kernel wrapper's launch count
    over every call must be ``per_call`` (the count read on the batcher
    thread, which alone launches)."""

    def __init__(self, runner, fn, per_call):
        self.runner, self.fn, self.decode, self.per_call = runner, fn, runner._decode, per_call
        self.calls, self.bad = 0, []
        runner._decode = self

    def __call__(self, *args):
        before = self.fn.launches
        out = self.decode(*args)
        if self.fn.launches - before != self.per_call:
            self.bad.append(self.fn.launches - before)
        self.calls += 1
        return out


def span_names(tracer, request_id) -> list:
    return [s.name for s in tracer.spans(request_id)]


def check_span_tree(tracer, resp, steps) -> str:
    """One request's tree: one `request` root, its children `queue_wait`,
    `admission`, `prefill` or `warm_admit`, ``steps`` `decode_step`s and
    `finalize`, each inside the root. Returns "prefill" or "warm_admit"."""
    spans = tracer.spans(resp.request_id)
    roots = [s for s in spans if s.name == "request"]
    check(len(roots) == 1 and roots[0].parent_id is None, (resp.request_id, "root"))
    root = roots[0]
    names = [s.name for s in spans]
    check(all(n in names for n in LIVE_SPANS) and names.count("decode_step") == steps
          and ("prefill" in names) != ("warm_admit" in names), (resp.request_id, names))
    check(all(s.parent_id == root.span_id and root.t0 - 1e-6 <= s.t0 <= s.t1 <= root.t1 + 1e-6
              for s in spans if s is not root), (resp.request_id, "nesting"))
    return "prefill" if "prefill" in names else "warm_admit"


def swap_gap_ms(done, key) -> dict:
    """The longest gap between consecutive answers around the change of
    ``key(response)`` (the drain barrier's cost: the last answer of the
    old version to the first of the new), beside the median gap."""
    done = sorted(done, key=lambda x: x[0])
    gaps = np.diff([t for t, _ in done]) * 1e3
    at = [i for i in range(1, len(done)) if key(done[i][1]) != key(done[i - 1][1])]
    check(len(at) == 1, ("one version change in answer order", len(at)))
    i = at[0]
    return dict(gap_ms=float(gaps[i - 1]), median_gap_ms=float(np.median(gaps)),
                answers_before=i, answers_after=len(done) - i)


def prometheus_metrics(path) -> dict:
    """Parse the exposition text: '# TYPE name kind' / 'name value' pairs."""
    lines = Path(path).read_text().splitlines()
    check(len(lines) % 2 == 0 and lines, "prometheus text")
    out = {}
    for i in range(0, len(lines), 2):
        _, typ, name, kind = lines[i].split()
        val_name, val = lines[i + 1].split()
        check(typ == "TYPE" and val_name == name and kind in ("counter", "gauge"), lines[i])
        out[name] = float(val)
    return out


def serve_live_phase(dev, seed, n_requests) -> dict:
    """TIGER at the serve phase's widths, catalog and page type (fp32, B1)
    served live: the budget refusal, a burst through a params swap (step 2
    from the checkpoint watcher), a catalog swap (snapshot b, about 1% of
    the items removed, from the catalog watcher) and a damaged step 3, with
    spans traced; then the tracer's cost, SLO shedding, the SIGTERM drain,
    and COBRA's tower-encoding catalog swap (``cobra_live``)."""
    import os
    import signal

    from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
    from genrec_tpu_torch.core.checkpoint import TENSORS, CheckpointManager
    from genrec_tpu_torch.kernels.paged_attention import paged_attention_stats_cuda
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.obs import SLOTarget, SpanTracer, get_flight_recorder, write_prometheus
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import TigerGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig
    from genrec_tpu_torch.serving.types import DrainingError, HBMBudgetError, OverloadError

    rng = np.random.default_rng(seed)
    catalog = tiger_catalog(rng)  # the serve phase's
    K, D = TIGER_AMAZON["num_item_embeddings"], TIGER_AMAZON["sem_id_dim"]
    layers = TIGER_AMAZON["n_layers"] // 2
    snap_a = CatalogSnapshot.build(catalog, K)
    keep = np.sort(rng.permutation(CATALOG_ITEMS)[: CATALOG_ITEMS - int(
        LIVE_DROP_SHARE * CATALOG_ITEMS)])
    snap_b = CatalogSnapshot.build(catalog[keep], K, capacity=snap_a.capacity)
    removed = {tuple(t) for t in catalog.tolist()} - {tuple(t) for t in snap_b.item_sem_ids.tolist()}
    legal = {snap_a.version: snap_a.item_index(), snap_b.version: snap_b.item_index()}
    ladder = BucketLadder((1, 2, 4, 8, 16), (4, 8, 16, MAX_ITEMS))
    cfg = PagedConfig(**PAGED)
    flight = get_flight_recorder()
    flight.clear()
    work = Path(tempfile.mkdtemp(prefix="serve_live."))
    ckpt, cat_dir = work / "ckpt", work / "catalogs"

    gc.collect()
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated(dev)
    model = Tiger(**TIGER_AMAZON, device=dev, seed=seed).eval()
    states = {1: {k: v.cpu().clone() for k, v in model.state_dict().items()},
              2: Tiger(**TIGER_AMAZON, device="cpu", seed=seed + 1).state_dict()}
    head = TigerGenerativeHead(model, catalog=snap_a, top_k=BEAMS)
    mgr = CheckpointManager(str(ckpt))
    mgr.save(1, states[1])
    snap_a.save(str(cat_dir))

    def engine(**kw):
        kw.setdefault("handle_signals", False)
        return ServingEngine([head], device=dev, ladder=ladder, max_batch=16, max_wait_ms=2.0,
                             paged_config=cfg, **kw).start()

    # Start: the first calls (cuBLAS, allocator) on an engine that also
    # gives the ledger's total; one with a budget below its pool is refused.
    probe = engine()
    serve(probe, make_requests(rng, 32, CATALOG_ITEMS))
    ledger_total = probe.stats()["hbm"]["total_bytes"]
    pool_bytes = probe.stats()["hbm"]["heads"]["tiger"]["operands"]["kv_page_pool"]
    probe.stop()
    del probe
    try:
        engine(hbm_budget_bytes=pool_bytes - 1)
        check(False, "an engine under its KV pool's bytes started")
    except HBMBudgetError as e:
        refusal = str(e)
    check("kv_page_pool" in refusal and "budget" in refusal, refusal)
    gc.collect()
    torch.cuda.empty_cache()

    tracer = SpanTracer(capacity=LIVE_TRACE_CAPACITY)
    budget = int(1.1 * ledger_total)
    eng = engine(ckpt_dir=str(ckpt), ckpt_poll_secs=LIVE_POLL_S, params_step=1,
                 catalog_dirs={"tiger": str(cat_dir)}, catalog_poll_secs=LIVE_POLL_S,
                 tracer=tracer, hbm_budget_bytes=budget)
    runner = eng.runner(head.name)
    per_call = LaunchesPerCall(runner, paged_attention_stats_cuda, layers)
    reqs = make_requests(rng, LIVE_BURST_FACTOR * n_requests, CATALOG_ITEMS)
    done = []
    reset_counters()
    t0 = time.perf_counter()
    futures = []
    for r in reqs:
        f = eng.submit(r)
        f.add_done_callback(lambda f: done.append((time.perf_counter(), f.result())))
        futures.append(f)
    published = {}
    while len(done) < len(reqs):
        if "step2" not in published and len(done) >= len(reqs) // 3:
            mgr.save(2, states[2])
            published["step2"] = len(done)
        if "b" not in published and len(done) >= 2 * len(reqs) // 3:
            snap_b.save(str(cat_dir))
            published["b"] = len(done)
        time.sleep(0.001)
    responses = [f.result(timeout=300) for f in futures]
    wall_s = time.perf_counter() - t0
    counts = read_counters()
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    stats = eng.stats()

    check(stats["failed"] == 0 and stats["completed"] == len(reqs), stats)
    check(stats["params_swaps"] == 1 and stats["catalog_swaps"] == 1, stats)
    others = {k: v for k, v in counts.items() if k != "paged_attention_stats" and v}
    check(not others, f"serve_live launched other kernels: {others}")
    check(not per_call.bad and counts["paged_attention_stats"] == layers * per_call.calls
          == layers * stats["decode_steps"], (per_call.bad, counts, stats["decode_steps"]))
    pairs = collections.Counter((r.params_step, r.catalog_version) for r in responses)
    check(set(pairs) <= {(s, v) for s in (1, 2) for v in legal}, pairs)
    check({s for s, _ in pairs} == {1, 2} and {v for _, v in pairs} == set(legal),
          ("both swaps landed mid-burst", pairs))
    for resp in responses:
        index = legal[resp.catalog_version]
        tuples = [tuple(int(c) for c in t) for t in resp.sem_ids]
        check(resp.sem_ids.shape == (BEAMS, D) and np.isfinite(resp.scores).all()
              and all(t in index for t in tuples), ("illegal under its version", tuples))
        check(resp.catalog_version == snap_a.version or not removed & set(tuples),
              "a removed item served after the swap")
    admitted = {r.request_id: check_span_tree(tracer, r, D) for r in responses}
    gaps = {"params": swap_gap_ms(done, lambda r: r.params_step),
            "catalog": swap_gap_ms(done, lambda r: r.catalog_version)}

    # Two sampled answers of each (params, catalog) pair seen, admitted cold,
    # against offline decoding under that pair's weights and trie.
    sample_err = 0.0
    for (step, version), _n in sorted(pairs.items()):
        ref = live_reference(Tiger, dev, states[step])
        snap = snap_a if version == snap_a.version else snap_b
        ref_head = TigerGenerativeHead(ref, catalog=snap, top_k=BEAMS)
        cold = [i for i, r in enumerate(responses) if (r.params_step, r.catalog_version)
                == (step, version) and admitted[r.request_id] == "prefill"]
        check(len(cold) >= 2, ("cold answers of", step, version))
        for i in rng.choice(cold, 2, replace=False):
            resp = responses[i]
            sem, scores = offline_answer(ref, ref_head, ref_head.trie, reqs[i], resp.bucket[1])
            check((sem == resp.sem_ids).all(), (step, version, i, sem, resp.sem_ids))
            sample_err = max(sample_err, float(np.abs(scores - resp.scores).max()))
        del ref, ref_head
    check(sample_err <= SAMPLE_ATOL, ("live sample", sample_err))

    # A damaged step 3 (one tensor's bytes flipped before it is published,
    # so the watcher never sees it whole): quarantined, step 2 keeps serving.
    step3 = {k: v * 0.5 for k, v in states[2].items()}
    CheckpointManager(str(work / "unpublished")).save(3, step3)
    raw = bytearray((work / "unpublished" / "3" / TENSORS).read_bytes())
    at = raw.find(step3["bos_embedding"].numpy().tobytes())
    check(at >= 0, "step 3's tensor bytes")
    raw[at + 7] ^= 0x20
    (work / "unpublished" / "3" / TENSORS).write_bytes(bytes(raw))
    os.replace(work / "unpublished" / "3", ckpt / "3")
    def verdicts():
        return [(e["step"], e["verdict"]) for e in flight.events("integrity_ladder")]

    deadline = time.monotonic() + 60
    while verdicts()[-2:] != [(3, "corrupt"), (2, "valid")]:  # the ladder walked past it
        check(time.monotonic() < deadline, ("step 3's ladder", verdicts()))
        time.sleep(0.01)
    check((ckpt / "quarantine" / "p0" / "3").is_dir(), "step 3 was not quarantined")
    # Each swap emptied the prefix index: a pre-swap request admits cold,
    # then a repeat of it admits warm.
    first = next(i for i, r in enumerate(responses)
                 if r.params_step == 1 and reqs[i].history.max() < snap_b.n_items)
    again = [eng.serve(reqs[first], timeout=60) for _ in range(2)]
    check([check_span_tree(tracer, r, D) for r in again] == ["prefill", "warm_admit"],
          "a pre-swap request after the swaps")
    check(all(r.params_step == 2 and r.catalog_version == snap_b.version for r in again),
          [(r.params_step, r.catalog_version) for r in again])
    invalidated = [e["reason"] for e in flight.events("prefix_cache_invalidated")
                   if e["reason"] != "drain"]
    check(invalidated[:2] == ["params_swap", "catalog_swap"], invalidated)

    # The ledger: each resident operand equals the bytes of what it names.
    st = eng.stats()
    h = st["hbm"]["heads"]["tiger"]
    want = {"params": nbytes(*model.state_dict().values()),
            "catalog_operands": nbytes(head.trie.keys, head.trie.offsets, head.trie.weights,
                                       head._item_sem_ids_dev),
            "kv_page_pool": nbytes(*runner.pool.k_pools, *runner.pool.v_pools),
            "paged_slot_state": nbytes(*runner.state.values())}
    check(h["operands"] == want, (h["operands"], want))
    check(dev.type != "cuda" or h["transient_peak_executable"] in (  # measured on the card
        f"prefill/B16/L{MAX_ITEMS}", f"decode/S{PAGED['max_slots']}"), h)
    prom = prometheus_metrics(write_prometheus(str(work / "serve_live.prom"), st))
    check(prom["genrec_params_swaps"] == 1 and prom["genrec_catalog_swaps"] == 1
          and prom["genrec_hbm_total_bytes"] == st["hbm"]["total_bytes"]
          and prom["genrec_hbm_heads_tiger_operands_kv_page_pool"] == want["kv_page_pool"]
          and prom["genrec_params_step"] == 2, prom)
    check(st["params_step"] == 2 and st["failed"] == 0 and st["watcher_errors"] == 0, st)

    # The tracer's cost: bursts with it on and off, alternately, twice.
    qps = {True: [], False: []}
    for on in (True, False, True, False):
        eng.set_tracer(tracer if on else None)
        burst = make_requests(rng, n_requests, snap_b.n_items)
        _, wall = serve(eng, burst)
        qps[on].append(len(burst) / wall)
    eng.stop()
    del eng
    live = emit(
        "serve_live", card=torch.cuda.get_device_name(dev), requests=len(reqs), wall_s=wall_s,
        qps=len(reqs) / wall_s, published_after_answers=published, pairs={
            f"step{s}/{v}": n for (s, v), n in sorted(pairs.items())},
        catalog_items={"a": snap_a.n_items, "b": snap_b.n_items}, removed_items=len(removed),
        params_swaps=stats["params_swaps"], catalog_swaps=stats["catalog_swaps"],
        swap_gap_ms=gaps, decode_steps=stats["decode_steps"],
        paged_attention_launches=counts["paged_attention_stats"],
        launches_per_decode_step=counts["paged_attention_stats"] / stats["decode_steps"],
        cold_admits=sum(a == "prefill" for a in admitted.values()),
        warm_admits=sum(a == "warm_admit" for a in admitted.values()),
        sample_checked=2 * len(pairs), sample_max_abs_score_err=sample_err,
        sample_atol=SAMPLE_ATOL, quarantined=[3], refusal_names_kv_page_pool=True,
        hbm_budget_bytes=budget, ledger=h, ledger_total_bytes=st["hbm"]["total_bytes"],
        peak_allocated_bytes=peak_bytes - base_bytes,
        ledger_over_peak=st["hbm"]["total_bytes"] / (peak_bytes - base_bytes),
        qps_traced=qps[True], qps_untraced=qps[False],
        tracer_cost=1 - float(np.mean(qps[True])) / float(np.mean(qps[False])),
        spans_recorded=tracer.stats()["spans_recorded"],
    )

    # SLO: a p99 target below the burst's sheds; in-flight work completes;
    # it un-sheds once traffic stops.
    target = SLOTarget(p99_ms=1.0, window_s=1.0, breach_s=0.0, recover_s=0.2)
    eng = engine(slo_targets=target, slo_poll_secs=0.005)
    accepted, shed_at = [], None
    deadline = time.monotonic() + 60
    while shed_at is None:
        check(time.monotonic() < deadline, "the SLO guard never shed")
        try:
            accepted.append(eng.submit(make_requests(rng, 1, snap_b.n_items)[0]))
        except OverloadError as e:
            shed_at = len(accepted)
            check("p99_ms" in str(e), str(e))
        time.sleep(0.0005)
    check(all(f.result(timeout=120).sem_ids.shape == (BEAMS, D) for f in accepted), "in flight")
    t_idle = time.monotonic()
    recovered_s = None
    while recovered_s is None:
        check(time.monotonic() - t_idle < 60, "the SLO guard never un-shed")
        try:
            eng.serve(make_requests(rng, 1, snap_b.n_items)[0], timeout=60)
            recovered_s = time.monotonic() - t_idle
        except OverloadError:
            time.sleep(0.05)
    slo_stats = eng.stop()
    check(slo_stats["overload_rejected"] >= 1 and slo_stats["failed"] == 0
          and slo_stats["rejected"] == 0 and slo_stats["slo"]["heads"]["tiger"]["breaches"] >= 1,
          slo_stats)

    # SIGTERM mid-burst: every accepted request answered, later submissions
    # refused, the previous handler restored, and this script goes on.
    prev = signal.getsignal(signal.SIGTERM)
    eng = engine(handle_signals=True)
    drain_reqs = make_requests(rng, n_requests, snap_b.n_items)
    drain_futures = [eng.submit(r) for r in drain_reqs]
    os.kill(os.getpid(), signal.SIGTERM)
    check(eng.join(120), "the engine did not drain on SIGTERM")
    drained = [f.result(timeout=60) for f in drain_futures]
    try:
        eng.submit(drain_reqs[0])
        check(False, "a submission after SIGTERM was accepted")
    except DrainingError:
        pass
    drain_stats = eng.stop()
    check(signal.getsignal(signal.SIGTERM) == prev, "the guard kept its handler")
    check(len(drained) == len(drain_reqs) and drain_stats["failed"] == 0
          and drain_stats["rejected"] == 1, drain_stats)
    live.update(emit(
        "serve_live_guards", slo_target_p99_ms=target.p99_ms, shed_after_submissions=shed_at,
        overload_rejected=slo_stats["overload_rejected"], unshed_after_idle_s=recovered_s,
        slo_breaches=slo_stats["slo"]["heads"]["tiger"]["breaches"],
        drained_on_sigterm=len(drained), rejected_after_sigterm=drain_stats["rejected"]))
    del model, head, runner
    gc.collect()
    torch.cuda.empty_cache()
    live["cobra"] = cobra_live_phase(dev, seed, n_requests)
    live["paged_attention_launches_cobra"] = live["cobra"]["paged_attention_launches"]
    return live


def cobra_live_phase(dev, seed, n_requests) -> dict:
    """COBRA at the cobra_serve phase's widths, tower, users and fp32 pages:
    a text-only snapshot (new item text, no vectors) staged through
    ``stage_catalog`` on this thread while the engine serves, its tower
    encoded here; B1 8 times every decode call before and after the swap;
    two post-swap answers against offline cobra_generate_paged under the
    new catalog."""
    from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
    from genrec_tpu_torch.kernels.paged_attention import paged_attention_stats_cuda
    from genrec_tpu_torch.models.cobra import Cobra
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import CobraGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig

    catalog, text = cobra_catalog(seed)
    rng = np.random.default_rng(seed + 2)
    ds = beauty_dataset(seed)
    model = Cobra(**COBRA_AMAZON, device=dev, seed=seed).eval()
    head = CobraGenerativeHead(model, item_sem_ids=catalog, item_text_tokens=text,
                               top_k=COBRA_BEAMS)
    text_b = rng.integers(1, COBRA_AMAZON["encoder_vocab_size"], text.shape)
    snap_b = CatalogSnapshot.build(catalog, COBRA_AMAZON["id_vocab_size"],
                                   item_text_tokens=text_b)
    layers = COBRA_AMAZON["decoder_n_layers"]
    eng = ServingEngine([head], device=dev, ladder=BucketLadder((1, 2, 4, 8, 16),
                                                                (4, 8, 16, MAX_ITEMS)),
                        max_batch=16, max_wait_ms=2.0, paged_config=PagedConfig(**COBRA_PAGED),
                        prefix_cache=False, handle_signals=False).start()
    serve(eng, cobra_requests(ds, rng, 32))  # first calls
    per_call = LaunchesPerCall(eng.runner(head.name), paged_attention_stats_cuda, layers)
    reqs = cobra_requests(ds, rng, n_requests)
    reset_counters()
    futures = [eng.submit(r) for r in reqs]
    encodes = head.tower_encodes
    t0 = time.perf_counter()
    check(eng.stage_catalog(head.name, snap_b), "the snapshot was not staged")
    torch.cuda.synchronize(dev)
    stage_s = time.perf_counter() - t0
    check(head.tower_encodes == encodes + 1, "the staging thread did not encode the tower")
    pre = [f.result(timeout=300) for f in futures]
    deadline = time.monotonic() + 60
    while eng.catalog_version(head.name) != snap_b.version:
        check(time.monotonic() < deadline, "the COBRA catalog swap never applied")
        time.sleep(0.005)
    post_reqs = cobra_requests(ds, rng, n_requests // 4)
    post, _ = serve(eng, post_reqs)
    counts = read_counters()
    stats = eng.stop()
    versions = collections.Counter(r.catalog_version for r in pre + post)
    check(all(r.catalog_version == snap_b.version for r in post), versions)
    check(stats["catalog_swaps"] == 1 and stats["failed"] == 0 and head.tower_encodes == encodes + 1,
          stats)
    others = {k: v for k, v in counts.items() if k != "paged_attention_stats" and v}
    check(not others and not per_call.bad
          and counts["paged_attention_stats"] == layers * per_call.calls, (others, per_call.bad))
    sample_err = 0.0
    for i in rng.choice(len(post), 2, replace=False):
        sem, scores = cobra_offline_answer(model, head, head.trie, post_reqs[i], post[i].bucket[1])
        check((sem == post[i].sem_ids).all(), ("cobra post-swap", i, sem, post[i].sem_ids))
        sample_err = max(sample_err, float(np.abs(scores - post[i].scores).max()))
    check(sample_err <= SAMPLE_ATOL, ("cobra live sample", sample_err))
    return emit("cobra_live", card=torch.cuda.get_device_name(dev), requests=len(pre + post),
                versions=dict(versions), stage_catalog_s=stage_s, tower_encodes=head.tower_encodes,
                catalog_swaps=stats["catalog_swaps"], decode_steps=stats["decode_steps"],
                decode_calls_checked=per_call.calls,
                paged_attention_launches=counts["paged_attention_stats"],
                launches_per_decode_step=counts["paged_attention_stats"] / per_call.calls,
                sample_checked=2, sample_max_abs_score_err=sample_err)


# ---- phases 12-14: TIGER and COBRA training, TIGER's dense decode ------------


@functools.cache
def tiger_beauty_data(seed):
    """``synthetic_tiger_data(num_items=12,101, codebook_size=256,
    sem_id_dim=3, max_items=20, seed, num_users=22,363)``: its
    SyntheticSeqDataset is ``beauty_dataset(seed)`` (the same arguments),
    so it is taken from there instead of being drawn again (~20 s on the
    host), with the recipe's random unique sem-ids."""
    from genrec_tpu_torch.data.sem_ids import random_unique_sem_ids
    from genrec_tpu_torch.data.tiger_seq import TigerSeqData

    sem_ids = random_unique_sem_ids(BEAUTY_ITEMS, TIGER_AMAZON["num_item_embeddings"],
                                    TIGER_AMAZON["sem_id_dim"], np.random.default_rng(seed + 1))
    return TigerSeqData(beauty_dataset(seed).sequences, sem_ids, max_items=MAX_ITEMS)


def tiger_train_setup(dev, seed, n_rows, *, dtype, dropout):
    """A TIGER at tiger.gin widths, AdamW on the file's schedule (cosine
    warm-up of 100 steps over 100 epochs of ``n_rows`` packed rows), clip
    1.0, and the trainer's packed loss: (model, step_fn, state)."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
    from genrec_tpu_torch.trainers.tiger_trainer import make_loss_fn

    t = TIGER_TRAIN
    model = Tiger(**TIGER_AMAZON, dropout=dropout, dtype=dtype, device=dev, seed=seed)
    optimizer = Adam(cosine_schedule_with_warmup(
        t["lr"], t["warmup"], t["epochs"] * (n_rows // t["batch"])), weight_decay=t["wd"])
    step_fn = make_train_step(make_loss_fn(TIGER_AMAZON["sem_id_dim"], True), optimizer,
                              clip_norm=1.0)
    return model, step_fn, TrainState.create(model, optimizer, seed)


# Of max |fp64 sums|: the kernel's fixed-order fp32 sums of ~3e4 terms a
# bin against fp64 (one order, the same every run), and against the plain
# version's fp32 atomics, whose order changes run to run (each side within
# ~1e-6 of fp64; one plain run measured 1.03e-6).
TABLE_GRAD_TOL = 1e-6
TABLE_GRAD_PLAIN_TOL = 4e-6


def table_grad_inputs(dev, seed, rows=256, segments=4):
    """The TIGER train step's bias-grid gather at tiger.gin widths, as one
    encoder layer of ``forward_packed`` builds it: ``rows`` packed rows of
    61 positions, ``segments`` segments a row with positions restarting in
    each, buckets of mem - ctx (32, max distance 128) plus the head offset:
    idx (rows * 61 * 6 * 61,) int64 into 6 x 32 bins, and fp32 gradients."""
    from genrec_tpu_torch.ops.buckets import t5_relative_position_bucket

    L = 1 + MAX_ITEMS * TIGER_AMAZON["sem_id_dim"]
    H = TIGER_AMAZON["num_heads"]
    g = torch.Generator(device="cpu").manual_seed(seed)
    cuts = torch.sort(torch.randint(1, L, (rows, segments - 1), generator=g), dim=1).values
    starts = torch.zeros((rows, L), dtype=torch.int64)
    starts.scatter_(1, cuts, 1)
    seg = torch.cumsum(starts, dim=1)
    first = torch.zeros((rows, L), dtype=torch.int64)
    for r in range(rows):
        b = torch.unique_consecutive(seg[r], return_counts=True)[1]
        first[r] = torch.repeat_interleave(torch.cumsum(b, 0) - b, b)
    positions = (torch.arange(L)[None, :] - first).to(dev)
    rel = positions[:, None, :] - positions[:, :, None]
    buckets = t5_relative_position_bucket(rel, 32, 128, bidirectional=True)
    idx = (buckets[..., None, :] + (torch.arange(H, device=dev) * 32)[:, None]).reshape(-1)
    grad = torch.randn(idx.shape, generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev)
    return dict(idx=idx.to(torch.int64).contiguous(), grad=grad, bins=H * 32)


def event_ms(fn, arg_sets, reps: int = 10) -> float:
    """Mean time of one ``fn(**args)`` in ms between two CUDA events, no
    graph (for calls that wait on the host, as ``torch.bincount`` does)."""
    for args in arg_sets:
        fn(**args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in arg_sets:
            fn(**args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets))


def library_table_grad(idx, grad, bins):
    return torch.zeros(bins, dtype=torch.float32, device=grad.device).index_add_(0, idx, grad)


def table_grad_kernel_phase(dev, seed, ptxas) -> dict:
    """The deterministic table-lookup gradient (TIGER's bias grid, C4)
    against fp64 sums and against ``torch.bincount`` (its plain version,
    on the card by atomics) at the TIGER step's operands and in edge
    cases, equal bits over two calls, timed beside ``bincount`` (events:
    it waits on the host) and ``index_add_`` (the library row)."""
    from genrec_tpu_torch.kernels.table_grad import table_grad_cuda, table_grad_ref

    cases = {"tiger_step": table_grad_inputs(dev, seed),
             "one_row": table_grad_inputs(dev, seed + 1, rows=1, segments=1),
             "n_below_a_block": dict(idx=torch.arange(100, device=dev) % 7,
                                     grad=torch.randn(100, device=dev), bins=7),
             "bins_1000": dict(idx=torch.randint(0, 1000, (300_001,), device=dev),
                               grad=torch.randn(300_001, device=dev), bins=1000)}
    errs, fp64_errs = {}, {}
    for name, x in cases.items():
        got = table_grad_cuda(**x)
        torch.cuda.synchronize()
        want = torch.bincount(x["idx"], weights=x["grad"].double(), minlength=x["bins"])
        fp64_errs[name] = assert_near(f"table_grad {name} vs fp64", got, want, TABLE_GRAD_TOL)
        errs[name] = assert_near(f"table_grad {name} vs plain", got, table_grad_ref(**x),
                                 TABLE_GRAD_PLAIN_TOL)
    base = cases["tiger_step"]
    bit_equal_twice(table_grad_cuda, base, "table_grad at the TIGER step")
    n = base["idx"].numel()
    copies = [base] + cold_copies(lambda c: table_grad_inputs(dev, seed + 100 + c),
                                  nbytes(base["idx"], base["grad"]))[1:]
    ms = device_ms(table_grad_cuda, copies)
    plain_ms = event_ms(table_grad_ref, copies)
    library_ms = device_ms(library_table_grad, copies)
    bytes_ = n * 12 + base["bins"] * 4
    bound_ms, bound_by = bound(bytes_, n, FP32_FLOPS)
    return emit(
        "kernel", name="table_grad", shape=dict(n=n, bins=base["bins"], dtype="fp32"),
        max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
        fp64_max_abs_err_by_case=fp64_errs,
        tolerance=dict(plain_rel=TABLE_GRAD_PLAIN_TOL, fp64_rel=TABLE_GRAD_TOL,
                       relative_to="max|sums|"),
        ms=ms, plain_ms=plain_ms, plain_timed_by="cuda_events (bincount syncs)",
        library_ms=library_ms, library="index_add_ (atomics)", timed_by="cuda_graph",
        bound_ms=bound_ms, bound_by=bound_by, work=dict(bytes=bytes_, adds=n),
        cold_copies=len(copies), bit_equal_twice=True,
        ptxas={k: v for k, v in ptxas.items() if "table_grad" in k},
    )


def tiger_train_phase(dev, seed, profile) -> tuple[dict, object]:
    """TIGER at config/tiger/amazon/tiger.gin widths: ``tiger_trainer.train``
    through that file (synthetic data of the trainer's own size, 2
    epochs), then TIGER_TRAIN["steps"] timed bf16 steps on
    ``tiger_beauty_data``'s packed rows (<= 4 segments). No kernel may
    launch. Returns (the line, the trained model)."""
    from genrec_tpu_torch.data.batching import pack_examples

    trainer = trainer_run(dev, seed, "config/tiger/amazon/tiger.gin", "tiger_trainer",
                          per_step=TIGER_LAUNCHES_PER_STEP, extra=TIGER_TRAINER_EXTRA)
    t0 = time.perf_counter()
    data = tiger_beauty_data(seed)
    examples = data.train_examples()
    data_s = time.perf_counter() - t0
    row_len = 1 + MAX_ITEMS * TIGER_AMAZON["sem_id_dim"]

    def pack(epoch):
        return pack_examples(examples, row_len=row_len, segment_keys=("target_ids",),
                             max_segments=TIGER_TRAIN["max_segments"], seed=(seed, epoch))

    t0 = time.perf_counter()
    first = pack(0)
    pack_s = time.perf_counter() - t0
    model, step_fn, state = tiger_train_setup(dev, seed, first[1].n_rows, dtype=torch.bfloat16,
                                              dropout=TIGER_TRAIN["dropout"])
    warm, n = TIGER_TRAIN["warm"], TIGER_TRAIN["steps"]
    loop, steps = timed_steps(dev, seed, state, step_fn,
                              lambda epoch: first if epoch == 0 else pack(epoch),
                              TIGER_TRAIN["batch"], warm=warm, n=n, row_len=row_len)
    check_launches_per_step("TIGER step", steps["launches"], TIGER_LAUNCHES_PER_STEP, n)
    out = emit(
        "tiger_train", card=torch.cuda.get_device_name(dev), trainer=trainer,
        config=("config/tiger/amazon/tiger.gin widths, bf16, dropout 0.1, AdamW 1e-4 (cosine "
                "warm-up 100) wd 0.035, clip 1.0; synthetic_tiger_data at Amazon-Beauty's "
                "12,101 items and 22,363 users, packed <= 4 segments a row"),
        params=sum(p.numel() for p in model.parameters()), data_build_s=data_s, pack_s=pack_s,
        **steps, launches_per_step={k: v / n for k, v in steps["launches"].items()},
    )
    # Device time a step (PERF.md's TIGER row): a few steps under the
    # profiler, every run (more with --profile).
    more = 10 if profile else 5
    prof = profiled_steps("tiger_train_profile", loop, state, step_fn, warm + n, more=more)
    out = {**out, "profile": prof, "device_ms_per_step": prof["device_busy_ms"] / more}
    return out, model


def beams_agree(what, sem_a, lp_a, sem_b, lp_b, tol) -> dict:
    """Two deterministic decodes of the same rows: log-probs rank by rank
    within ``tol``, sem-ids equal except in rows where each differing rank
    scores within ``tol`` of a neighbouring rank, or is the last (a near
    tie, which two summation orders may break either way); such rows are
    at most NEAR_TIE_MAX_SHARE of all."""
    err = float((lp_a - lp_b).abs().max())
    check(err <= tol, f"{what}: log-probs {err} apart > {tol}")
    lp = lp_a.cpu().numpy()
    K = lp.shape[1]
    near = 0
    for r in torch.nonzero((sem_a != sem_b).any(-1).any(-1)).flatten().tolist():
        ranks = torch.nonzero((sem_a[r] != sem_b[r]).any(-1)).flatten().tolist()
        tied = [k == K - 1 or (k > 0 and lp[r, k - 1] - lp[r, k] <= tol)
                or lp[r, k] - lp[r, k + 1] <= tol for k in ranks]
        check(all(tied), f"{what}: row {r} differs at ranks {ranks} without a near tie")
        near += 1
    check(near <= NEAR_TIE_MAX_SHARE * len(lp), f"{what}: {near} near-tie rows of {len(lp)}")
    return dict(rows=len(lp), max_abs_logp_diff=err, tol=tol, near_tie_rows=near)


def tiger_decode_phase(dev, seed, model, profile=False) -> dict:
    """TIGER's dense trie-constrained decode on the trained weights:
    ``tiger_trainer.make_generate_fn`` (cached, sampled, T 0.2, 10 beams,
    KK 60) over TIGER_DECODE["users"] valid users (every tuple a catalog
    item, beams unique, Recall/NDCG@10); then, on a float32 copy of the
    weights, the deterministic cached decode against the uncached one and
    against ``tiger_generate_paged`` (B1, counted). With ``profile`` one
    more sampled batch under torch.profiler."""
    from genrec_tpu_torch.data.batching import batch_iterator, prefetch_to_device
    from genrec_tpu_torch.models.tiger import Tiger, tiger_generate, tiger_generate_paged
    from genrec_tpu_torch.ops.metrics import TopKAccumulator
    from genrec_tpu_torch.ops.trie import DenseTrie, build_trie, tuples_are_valid
    from genrec_tpu_torch.trainers.tiger_trainer import make_generate_fn

    c = TIGER_DECODE
    data = tiger_beauty_data(seed)
    K_cb, D = TIGER_AMAZON["num_item_embeddings"], TIGER_AMAZON["sem_id_dim"]
    arrays = data.eval_arrays("valid")
    users = np.sort(np.random.default_rng(seed + 2).choice(
        len(arrays["user_ids"]), c["users"], replace=False))
    arrays = {k: v[users] for k, v in arrays.items()}
    trie = build_trie(data.valid_item_sem_ids(), K_cb, device=dev)
    check(isinstance(trie, DenseTrie), type(trie))
    gen = make_generate_fn(model, trie, c["temperature"], BEAMS)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    acc = TopKAccumulator(ks=(5, 10))
    tops, batch_ms = [], []
    reset_counters()
    for batch, valid in prefetch_to_device(batch_iterator(arrays, c["batch"]), dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        top = gen(batch, generator)
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        n = int(valid.sum())
        acc.accumulate(batch["target_ids"][:n], top[:n])
        tops.append(top[:n])
    sampled_launches = read_counters()
    check(not any(sampled_launches.values()), ("dense decode launched", sampled_launches))
    sem = torch.cat(tops)
    check(sem.shape == (c["users"], BEAMS, D), sem.shape)
    valid_share = float(tuples_are_valid(trie, sem).float().mean())
    check(valid_share == 1.0, f"{valid_share} of the sampled tuples are catalog items")
    key = (sem[..., 0] * K_cb + sem[..., 1]) * K_cb + sem[..., 2]
    key = key.sort(dim=1).values
    check(bool((key[:, 1:] != key[:, :-1]).all()), "a row repeats a beam")
    metrics = acc.reduce()
    prof = None
    if profile:
        def one_batch():
            t = time.perf_counter()
            gen(batch, generator)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        prof = emit("tiger_decode_profile", batch=c["batch"], **device_profile(one_batch))

    f32 = Tiger(**TIGER_AMAZON, device=dev, seed=seed).eval()
    f32.load_state_dict(model.state_dict())
    batches = [{k: v for k, v in b.items()} for b, _ in
               prefetch_to_device(batch_iterator({k: v[:c["paged_users"]] for k, v in
                                                  arrays.items()}, c["batch"]), dev)]
    cols = ("user_ids", "item_input_ids", "token_type_ids", "seq_mask")
    kw = dict(temperature=c["temperature"], n_top_k_candidates=BEAMS)
    cached = tiger_generate(f32, trie, *(batches[0][k] for k in cols), deterministic=True, **kw)
    uncached = tiger_generate(f32, trie, *(batches[0][k] for k in cols), deterministic=True,
                              use_cache=False, **kw)
    cache_check = beams_agree("cached vs uncached", cached.sem_ids, cached.log_probas,
                              uncached.sem_ids, uncached.log_probas, TIGER_DECODE_TOL)
    dense, paged = [], []
    reset_counters()
    for b in batches:
        paged.append(tiger_generate_paged(f32, trie, *(b[k] for k in cols),
                                          page_size=PAGED["page_size"], **kw))
    b1 = read_counters()
    want = len(batches) * D * (TIGER_AMAZON["n_layers"] // 2)
    check(b1["paged_attention_stats"] == want and sum(b1.values()) == want,
          ("paged decode launches", b1, want))
    for b in batches:
        dense.append(tiger_generate(f32, trie, *(b[k] for k in cols), deterministic=True, **kw))
    paged_check = beams_agree(
        "dense vs paged", torch.cat([o.sem_ids for o in dense]),
        torch.cat([o.log_probas for o in dense]), torch.cat([o.sem_ids for o in paged]),
        torch.cat([o.log_probas for o in paged]), TIGER_DECODE_TOL)
    return emit(
        "tiger_decode", card=torch.cuda.get_device_name(dev), users=c["users"],
        batch=c["batch"], beams=BEAMS, temperature=c["temperature"],
        candidates_per_beam=min(BEAMS * 6, K_cb), trie="DenseTrie",
        trie_bytes=sum(nbytes(t) for t in trie.tables),
        recall_at_10=metrics["Recall@10"], ndcg_at_10=metrics["NDCG@10"],
        recall_at_5=metrics["Recall@5"], ndcg_at_5=metrics["NDCG@5"],
        batch_ms_p50=float(np.percentile(batch_ms, 50)), batch_ms_mean=float(np.mean(batch_ms)),
        first_batch_ms=batch_ms[0], valid_tuple_share=valid_share,
        cached_vs_uncached=dict(cache_check, dtype="fp32 copy"),
        dense_vs_paged=dict(paged_check, dtype="fp32 copy", batches=len(batches)),
        paged_attention_launches=b1["paged_attention_stats"], profile=prof,
    )


def cobra_beauty_data(seed):
    """A ``CobraSeqData`` over the cobra_serve phase's data: the synthetic
    Amazon-Beauty users' sequences (train rows are their valid-split
    histories with the target appended), ``cobra_catalog``'s 12,101
    tuples and 32 text tokens an item, newest 20 items."""
    from genrec_tpu_torch.data.cobra_seq import CobraSeqData

    catalog, text = cobra_catalog(seed)
    return CobraSeqData(beauty_dataset(seed).sequences, catalog, text,
                        id_vocab_size=COBRA_AMAZON["id_vocab_size"], max_items=MAX_ITEMS)


def cobra_trainer_run(dev, seed) -> dict:
    """``cobra_trainer.train`` through config/cobra/amazon.gin with the
    data fed by the callable ``dataset`` hook, 1 epoch, the final valid and
    test eval: no kernel launched; the step log's loss_sparse and
    loss_dense finite, loss_sparse falling (the last 20 steps' mean below
    the first 20's) and loss_dense not rising (COBRA_DENSE_RISE_MAX).

    The dense loss is an in-batch InfoNCE that sits at its chance level,
    log of the ~840 valid columns a batch, through this epoch: the tower's
    vectors of different items start ~0.81 cosine-similar (the shared
    position embeddings dominate their mean-pool), the loss is blind to
    what they share, and one epoch at the file's warm-up does not learn
    the rest (flat, 6.731 -> 6.747, on an H100; PERF.md)."""
    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.trainers.cobra_trainer import train

    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / "config/cobra/amazon.gin"), substitutions={"split": "beauty"})
    with tempfile.TemporaryDirectory() as tmp:
        for binding in ("train.wandb_logging = False", f'train.save_dir_root = "{tmp}"',
                        "train.epochs = 1", "train.wandb_log_interval = 1",
                        f"train.eval_batch_size = {COBRA_TRAIN['trainer_eval_batch']}",
                        f"train.seed = {seed}", f'train.device = "{dev}"'):
            configlib.parse_binding(binding)
        reset_counters()
        t0 = time.perf_counter()
        valid, test = train(dataset=functools.partial(cobra_beauty_data, seed))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()
        logged = [json.loads(line) for line in open(f"{tmp}/metrics.jsonl")]
    configlib.clear_bindings()
    configlib.clear_macros()
    check(not any(launches.values()), ("cobra_trainer.train() launched", launches))
    steps = [m for m in logged if "train/loss_sparse" in m]
    out = dict(wall_s=wall_s, steps=len(steps), valid=valid, test=test)
    for part in ("loss_sparse", "loss_dense"):
        v = np.asarray([m[f"train/{part}"] for m in steps])
        check(len(v) >= 40 and np.isfinite(v).all(), (part, v))
        first, last = float(v[:20].mean()), float(v[-20:].mean())
        out[part] = dict(first_20_mean=first, last_20_mean=last)
        if part == "loss_sparse":
            check(last < first, ("cobra_trainer.train(): loss_sparse did not fall", first, last))
        else:
            check(last <= first * (1 + COBRA_DENSE_RISE_MAX),
                  ("cobra_trainer.train(): loss_dense rose", first, last))
    check(all(np.isfinite(x) and 0 <= x <= 1 for x in (*valid.values(), *test.values())),
          (valid, test))
    return out


def cobra_train_phase(dev, seed, profile) -> dict:
    """COBRA at config/cobra/amazon.gin widths, bf16, dropout 0.1:
    ``cobra_trainer_run``, then COBRA_TRAIN["steps"] timed steps of the
    trainer's step on ``cobra_beauty_data`` (no kernel launched, losses
    finite; with ``profile`` 10 more under torch.profiler), then one eval:
    the tower over every catalog item, beam fusion (20 beams, 10
    candidates) on COBRA_TRAIN["eval_users"] valid users."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.logging import Tracker, setup_logger
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.cobra import Cobra
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
    from genrec_tpu_torch.trainers.cobra_trainer import (
        compute_item_dense_vecs,
        evaluate,
        make_fusion_fn,
        make_loss_fn,
    )
    from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

    c = COBRA_TRAIN
    trainer = cobra_trainer_run(dev, seed)
    data = cobra_beauty_data(seed)
    train_arrays = data.train_arrays()
    model = Cobra(**COBRA_AMAZON, dtype=torch.bfloat16, device=dev, seed=seed)
    optimizer = Adam(cosine_schedule_with_warmup(
        c["lr"], c["warmup"], c["epochs"] * (len(train_arrays["input_ids"]) // c["batch"])),
        weight_decay=c["wd"])
    step_fn = make_train_step(make_loss_fn(), optimizer, clip_norm=1.0)
    state = TrainState.create(model, optimizer, seed)
    events, parts = [], []

    def hook(state, m, global_step, *_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        parts.append((m["loss"], m["loss_sparse"], m["loss_dense"]))

    C = COBRA_AMAZON["n_codebooks"]
    loop = PackedTrainLoop(logger=setup_logger(None), tracker=Tracker(), device=dev,
                           rows_per_step=c["batch"], row_len=(MAX_ITEMS + 1) * C, seed=seed,
                           pack_sequences=False, train_arrays=train_arrays, step_hook=hook)
    warm, n = c["warm"], c["steps"]
    loop.run_epoch(state, step_fn, 0, 0, max_steps=warm)
    events.clear()
    parts.clear()
    torch.cuda.synchronize()
    first = torch.cuda.Event(enable_timing=True)
    reset_counters()
    t0 = time.perf_counter()
    first.record()
    loop.run_epoch(state, step_fn, 0, warm, start_batch=warm, max_steps=warm + n)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    check(len(events) == n and not any(launches.values()), (len(events), launches))
    step_ms = [a.elapsed_time(b) for a, b in zip([first] + events[:-1], events)]
    loss, sparse, dense = (np.asarray([float(p[i]) for p in parts]) for i in range(3))
    check(np.isfinite(loss).all() and np.isfinite(sparse).all() and np.isfinite(dense).all(),
          (sparse, dense))
    prof = None
    if profile:
        done = warm + n

        def run_more(more=10):
            t = time.perf_counter()
            loop.run_epoch(state, step_fn, 0, done, start_batch=done, max_steps=done + more)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        prof = emit("cobra_train_profile", steps=10, **device_profile(run_more))

    reset_counters()
    t0 = time.perf_counter()
    vecs = compute_item_dense_vecs(model, data.item_texts)
    torch.cuda.synchronize()
    tower_s = time.perf_counter() - t0
    check(tuple(vecs.shape) == (CATALOG_ITEMS, COBRA_AMAZON["d_model"])
          and bool(torch.isfinite(vecs).all()), vecs.shape)
    arrays = data.eval_arrays("valid")
    users = np.sort(np.random.default_rng(seed + 3).choice(
        len(arrays["input_ids"]), c["eval_users"], replace=False))
    item_sem_ids = torch.as_tensor(data.sem_ids, dtype=torch.int64, device=dev)
    fuse = make_fusion_fn(model, item_sem_ids, c["n_candidates"], COBRA_BEAMS, c["alpha"])
    t0 = time.perf_counter()
    metrics = evaluate(fuse, {k: v[users] for k, v in arrays.items()}, vecs,
                       c["eval_batch"], dev, C)
    torch.cuda.synchronize()
    fusion_s = time.perf_counter() - t0
    eval_launches = read_counters()
    check(not any(eval_launches.values()), ("COBRA eval launched", eval_launches))
    check(all(np.isfinite(v) and 0 <= v <= 1 for v in metrics.values()), metrics)
    return emit(
        "cobra_train", card=torch.cuda.get_device_name(dev), trainer=trainer,
        config=("config/cobra/amazon.gin widths, bf16, dropout 0.1, AdamW 3e-4 (cosine "
                "warm-up 500) wd 0.01, clip 1.0, batch 64; the cobra_serve phase's data "
                "(synthetic Amazon-Beauty users, 12,101 catalog tuples, 32 text tokens an item)"),
        params=sum(p.numel() for p in model.parameters()), steps=n,
        steps_per_s=n / wall_s, examples_per_s=n * c["batch"] / wall_s,
        step_ms_p50=float(np.percentile(step_ms, 50)),
        step_ms_p90=float(np.percentile(step_ms, 90)), wall_s=wall_s,
        losses=loss.tolist(), loss_sparse=sparse.tolist(), loss_dense=dense.tolist(),
        launches_per_step={k: v / n for k, v in launches.items()},
        eval=dict(users=c["eval_users"], n_beam=COBRA_BEAMS, n_candidates=c["n_candidates"],
                  tower_items=CATALOG_ITEMS, tower_s=tower_s, fusion_s=fusion_s, **metrics),
        profile=prof,
    )


# ---- phase 11: LCRec SFT at tensor_parallel=2 ---------------------------------


def lcrec_cfg(layers: int):
    """QwenConfig()'s Qwen2.5-1.5B widths at ``layers`` layers (tied head)."""
    from genrec_tpu_torch.models.backbones.qwen import QwenConfig

    return QwenConfig(vocab_size=LCREC["base_vocab"], num_hidden_layers=layers)


def lcrec_shard_inputs(dev, seed, *, R, V, d, vlim, ignore=-2, dtype=torch.bfloat16):
    """One rank's per-shard inputs of B3/B4 under B8: x (R, d) ~ N(0, 1)
    (the final RMSNorm's output), the shard's rows w (V, d) ~ N(0, 0.02)
    (the embedding's init), local targets below vlim or -1 (held on the
    other shard, half the rows), and g: the mean loss's 1 / valid, 0 on
    the 20% of rows whose label is -100 (B8 zeroes their cotangent).
    With ``ignore`` -100 and no ``vlim``, the inputs of the whole head at
    tensor_parallel=1 (``sft_loss``'s fused CE): targets over all V rows,
    -100 on half the rows (the prompts), and g the mean's 1 / valid on
    every row (the kernels zero the ignored ones). x and w are drawn on
    ``dev`` (a host draw of a 118 M-element shard took seconds)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    if ignore == -100:
        tgt = rng.integers(0, V, R).astype(np.int32)
        tgt[rng.random(R) < 0.5] = ignore
        g = np.full(R, 1.0 / max(int((tgt != ignore).sum()), 1), np.float32)
    else:
        tgt = rng.integers(0, max(vlim, 1), R).astype(np.int32)
        tgt[rng.random(R) < 0.5] = -1
        if vlim == 0:
            tgt[:] = -1
        g = np.full(R, 1.0 / R, np.float32)
        g[rng.random(R) < 0.2] = 0.0
    return dict(x=torch.randn((R, d), generator=gen, device=dev).to(dtype),
                w=(torch.randn((V, d), generator=gen, device=dev) * 0.02).to(dtype),
                targets=t(tgt), g=t(g), vlim=vlim, ignore=ignore)


def lcrec_library_ce(x, w, targets):
    """The yardstick of the per-shard forward: the same logits and
    logsumexp by one PyTorch call (targets of the other shard read
    column 0)."""
    return torch.nn.functional.cross_entropy(
        torch.nn.functional.linear(x, w), targets.long().clamp_min(0), reduction="none")


def ce_lcrec_kernel_phase(dev, seed, ptxas) -> dict:
    """B3 and B4 (dx, dW) at an LCRec shard (R = 8 x 511 rows, 76,608
    vocab rows, d 1,536, bf16) with the full shard live and with a ragged
    live-vocab limit, over the whole head at tensor_parallel=1 (the LoRA
    step's shape: all LCREC_LIVE rows, ignore_index -100, no vlim), and at
    d in LCREC_DIMS at a small size, each against its plain version and
    twice for equal bits; then timed at the shard shape, with TFLOP/s,
    share of the bound, workspace and ptxas numbers."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    R, V, d = LCREC["batch"] * (LCREC["seq"] - 1), LCREC_SHARD, lcrec_cfg(1).hidden_size
    cases = {"shard_full": dict(R=R, V=V, d=d, vlim=V),
             "shard_ragged": dict(R=R, V=V, d=d, vlim=V * 63 // 64)}
    cases.update({f"small_d{dd}": dict(R=300, V=2000, d=dd, vlim=1900) for dd in LCREC_DIMS})
    cases["tp1_whole_head"] = dict(R=R, V=LCREC_LIVE, d=d, vlim=None, ignore=-100)
    errs = {"fwd": {}, "dx": {}, "dw": {}}
    for i, (name, shape) in enumerate(cases.items()):
        x = lcrec_shard_inputs(dev, seed + i, **shape)
        fwd = dict(x=x["x"], w=x["w"], targets=x["targets"], ignore_index=x["ignore"],
                   vlim=x["vlim"])
        loss, lse = fc.fused_linear_ce_fwd_cuda(**fwd)
        torch.cuda.synchronize()
        want_loss, want_lse = fc.fused_linear_ce_ref(**fwd)
        errs["fwd"][name] = max(assert_near(f"ce loss {name}", loss, want_loss, FP32_TOL),
                                assert_near(f"ce lse {name}", lse, want_lse, FP32_TOL))
        bit_equal_twice(fc.fused_linear_ce_fwd_cuda, fwd, f"ce fwd {name}")
        bwd = dict(fwd, lse=want_lse, g=x["g"])
        dx = fc.fused_linear_ce_dx_cuda(**bwd)
        torch.cuda.synchronize()
        errs["dx"][name] = assert_near(f"ce dx {name}", dx, fc.fused_linear_ce_dx_ref(**bwd),
                                       BF16_TOL)
        bit_equal_twice(fc.fused_linear_ce_dx_cuda, bwd, f"ce dx {name}")
        del dx
        dw = fc.fused_linear_ce_dw_cuda(**bwd)
        torch.cuda.synchronize()
        errs["dw"][name] = assert_near(f"ce dW {name}", dw, fc.fused_linear_ce_dw_ref(**bwd),
                                       BF16_TOL)
        bit_equal_twice(fc.fused_linear_ce_dw_cuda, bwd, f"ce dW {name}")
        check(zero_tail(dw, shape["V"] if x["vlim"] is None else x["vlim"]),
              f"{name}: pad rows past vlim must get exactly zero dW")
        del dw, x, fwd, bwd
        torch.cuda.empty_cache()

    base = lcrec_shard_inputs(dev, seed, **cases["shard_full"])
    copies = cold_copies(lambda c: lcrec_shard_inputs(dev, seed + 100 + c,
                                                      **cases["shard_full"]),
                         nbytes(base["x"], base["w"], base["targets"], base["g"]))
    fwd_sets = [dict(x=c["x"], w=c["w"], targets=c["targets"], ignore_index=-2,
                     vlim=c["vlim"]) for c in copies]
    bwd_sets = [dict(f, lse=fc.fused_linear_ce_ref(**f)[1], g=c["g"])
                for f, c in zip(fwd_sets, copies)]
    lib_sets = [dict(x=c["x"], w=c["w"], targets=c["targets"]) for c in copies]
    lib_fwd_ms = device_ms(lcrec_library_ce, lib_sets, reps=LCREC_REPS)
    x_bytes, w_bytes, rows = nbytes(base["x"]), nbytes(base["w"]), nbytes(base["targets"])
    logits = 2 * R * V * d
    specs = {
        "fused_linear_ce_fwd": (fc.fused_linear_ce_fwd_cuda, fwd_sets, fc.fused_linear_ce_ref,
                                x_bytes + w_bytes + 3 * rows, logits),
        "fused_linear_ce_bwd_dx": (fc.fused_linear_ce_dx_cuda, bwd_sets,
                                   fc.fused_linear_ce_dx_ref,
                                   2 * x_bytes + w_bytes + 3 * rows, 2 * logits),
        "fused_linear_ce_bwd_dw": (fc.fused_linear_ce_dw_cuda, bwd_sets,
                                   fc.fused_linear_ce_dw_ref,
                                   x_bytes + 2 * w_bytes + 3 * rows, 2 * logits),
    }
    out = {}
    for name, (fn, sets, plain, bytes_, ops) in specs.items():
        key = name.rsplit("_", 1)[-1]
        ms = device_ms(fn, sets, reps=LCREC_REPS)
        plain_ms = device_ms(plain, sets, reps=LCREC_REPS)
        if key == "fwd":
            library_ms = lib_fwd_ms
            library = "F.cross_entropy(F.linear(x, w_shard), reduction='none')"
        else:
            wrt = "x" if key == "dx" else "w"
            library_ms = device_ms(functools.partial(library_grad, wrt=wrt), [
                dict(s, g=c["g"]) for s, c in zip(lib_sets, copies)],
                reps=LCREC_REPS) - lib_fwd_ms
            library = (f"autograd of the same call for {key} alone: its forward+backward "
                       "time less its forward time")
        bound_ms, bound_by = bound(bytes_, ops, BF16_FLOPS)
        extra = dict(tc_report(key, R, V, d, ms, bound_ms, ops, ptxas),
                     bit_equal_twice_cases=list(cases))
        out[name + "_lcrec"] = emit(
            "kernel", name=name + "_lcrec", kernel=name, **extra,
            shape=dict(R=R, V=V, d=d, dtype="bf16", vlim=V,
                       what="one rank's shard of the LCRec head at tensor_parallel=2"),
            max_abs_err=max(errs[key].values()), max_abs_err_by_case=errs[key],
            tolerance=dict(bf16=BF16_TOL, loss_lse=FP32_TOL, relative_to="max|plain|"),
            ms=ms, plain_ms=plain_ms, plain=plain.__name__, library_ms=library_ms,
            library=library, timed_by="cuda_graph", bound_ms=bound_ms, bound_by=bound_by,
            cold_copies=len(sets), reps=LCREC_REPS, work=dict(bytes=bytes_, flops=ops),
        )
    del copies, fwd_sets, bwd_sets, lib_sets, base
    torch.cuda.empty_cache()
    return out


def zero_tail(t, start: int) -> bool:
    """Rows start.. of t are exactly zero (true when there are none)."""
    tail = t[start:]
    return tail.numel() == 0 or float(tail.float().abs().max()) == 0.0


def library_grad(x, w, targets, g, wrt):
    """The gradient of sum(g * the library CE) in x or w (autograd)."""
    x = x.detach().requires_grad_(wrt == "x")
    w = w.detach().requires_grad_(wrt == "w")
    return torch.autograd.grad(lcrec_library_ce(x, w, targets), x if wrt == "x" else w, g)


def lcrec_tokens(seed, B, L, live_vocab):
    """Seeded SFT batches over the whole live vocab: each row's first 25-75%
    are prompt (label -100), every position valid."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, live_vocab, (B, L)).astype(np.int32)
    labels = ids.copy()
    for b, p in enumerate(rng.integers(L // 4, 3 * L // 4, B)):
        labels[b, :p] = -100
    return {"input_ids": ids, "attention_mask": np.ones((B, L), np.int32), "labels": labels}


def lcrec_model(cfg, dev, seed, dtype, group):
    """The rank's shard of the full parameters made from ``seed`` (every
    rank builds the same full tensors on its card), the codebook tokens
    appended and the vocab padded to lcm(8, tp), as the trainer does."""
    from genrec_tpu_torch.models.backbones.qwen import QwenLM, qwen_init_params
    from genrec_tpu_torch.models.lcrec import extend_vocab
    from genrec_tpu_torch.parallel.shardings import shard_qwen_params

    tp = 1 if group is None else group.size
    full = qwen_init_params(cfg, seed, dev)
    cfg, full, base = extend_vocab(cfg, full, LCREC["codebooks"], LCREC["codebook_size"],
                                   torch.Generator(device=dev).manual_seed(seed + 1),
                                   pad_to=math.lcm(8, tp))
    model = QwenLM(cfg, dtype=dtype, group=group, device=dev)
    model.load_state_dict(shard_qwen_params(full, 0 if group is None else group.rank, tp, cfg))
    del full
    torch.cuda.empty_cache()
    return model, base + LCREC["codebooks"] * LCREC["codebook_size"]


def lcrec_stepper(model, live, group, lr, warmup, total, wd, expert_group=None):
    """``run(batches, hook=None) -> metrics per step``: train steps through
    the trainer's recipe, one optimizer state across calls: AdamW after a
    cosine warm-up, clip 1.0 (its norm over the tensor or expert group),
    the SFT loss through B8 (a tensor-parallel group) or the fused CE
    (none: the whole head on every rank)."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.lcrec import make_tp_sharded_fused_sft_loss, sft_loss
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup

    if group is None:
        def loss(b):
            return sft_loss(model, b["input_ids"], b["attention_mask"], b["labels"],
                            valid_vocab=live, use_fused_ce=True)
    else:
        loss = make_tp_sharded_fused_sft_loss(model, live)
    opt = Adam(cosine_schedule_with_warmup(lr, warmup, total), weight_decay=wd)
    step = make_train_step(lambda m, b, g: (loss(b), {}), opt, clip_norm=1.0,
                           group=group or expert_group)
    state = TrainState.create(model, opt, 0)
    dev = model.norm.weight.device

    def run(batches, hook=None):
        out = []
        for b in batches:
            _, m = step(state, {k: torch.as_tensor(v, device=dev) for k, v in b.items()})
            out.append({k: float(v) for k, v in m.items()})
            if hook is not None:
                hook()
        return out

    return run


def lcrec_parity_batches(seed):
    return [lcrec_tokens(seed + 10 + i, LCREC["parity_batch"], LCREC["parity_seq"],
                         LCREC_LIVE) for i in range(LCREC["parity_steps"])]


def lcrec_parity_tp1(dev, seed) -> list:
    """tensor_parallel=1 side of the parity run: fp32, the fused CE (B3/B4)."""
    model, live = lcrec_model(lcrec_cfg(LCREC["parity_layers"]), dev, seed, torch.float32,
                              None)
    run = lcrec_stepper(model, live, None, LCREC["parity_lr"], 1, LCREC["parity_steps"],
                        LCREC["wd"])
    losses = [m["loss"] for m in run(lcrec_parity_batches(seed))]
    del model, run
    torch.cuda.empty_cache()
    return losses


def lcrec_b8_inputs(dev, seed):
    """B8 at the full-width head, bf16: x (8 x 511 rows, 1,536), the whole
    padded head (153,216 rows) and, per case, (global targets, valid
    vocab); -100 is ignored. x and w are drawn on ``dev`` (every rank draws
    the same tensors from the seed)."""
    R, d = LCREC["batch"] * (LCREC["seq"] - 1), lcrec_cfg(1).hidden_size
    rng = np.random.default_rng(seed + 7)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    x = torch.randn((R, d), generator=gen, device=dev)
    w = torch.randn((LCREC_LIVE, d), generator=gen, device=dev) * 0.02
    t = rng.integers(0, LCREC_LIVE, R).astype(np.int32)
    t[rng.random(R) < 0.2] = -100
    cases = {"mixed": (t, LCREC_LIVE),
             "other_shard": (rng.integers(LCREC_SHARD, LCREC_LIVE, R).astype(np.int32),
                             LCREC_LIVE),
             "all_ignored": (np.full(R, -100, np.int32), LCREC_LIVE),
             "empty_shard": (rng.integers(0, LCREC_SHARD, R).astype(np.int32), LCREC_SHARD)}
    return x.to(torch.bfloat16), w.to(torch.bfloat16), cases


def lcrec_b8(group, seed) -> dict:
    """(a) B8 against its plain twin on this rank, every case, over the
    group's shards of the head (2 in lcrec_tp, 4 in qwen_tp4); B8 and the
    twin timed (forward and backward, every rank running) on "mixed"."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    dev = group.device
    Vs = LCREC_LIVE // group.size
    errs, times = {}, {}
    x, w, cases = lcrec_b8_inputs(dev, seed)
    w_shard = w[group.rank * Vs:(group.rank + 1) * Vs].contiguous()
    del w
    for name, (t, vv) in cases.items():
        outs = {}
        for fn in (fc.sharded_fused_linear_ce, fc.sharded_fused_linear_ce_ref):
            reps = []
            for _ in range(LCREC_REPS if name == "mixed" else 1):
                xx = x.detach().clone().requires_grad_()
                ww = w_shard.detach().clone().requires_grad_()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = fn(xx, ww, torch.as_tensor(t, device=dev), group, -100, vv)
                (loss.sum() / max(int((t != -100).sum()), 1)).backward()
                torch.cuda.synchronize()
                reps.append(1e3 * (time.perf_counter() - t0))
            outs[fn.__name__] = (loss.detach(), xx.grad, ww.grad)
            times.setdefault(name, {})[fn.__name__] = float(np.median(reps))
        (k_loss, k_dx, k_dw), (p_loss, p_dx, p_dw) = outs.values()
        errs[name] = max(assert_near(f"B8 loss {name}", k_loss, p_loss, FP32_TOL),
                         assert_near(f"B8 dx {name}", k_dx, p_dx, BF16_TOL),
                         assert_near(f"B8 dW {name}", k_dw, p_dw, BF16_TOL))
        check(zero_tail(k_dw, min(max(vv - group.rank * Vs, 0), Vs)),
              f"B8 {name}: pad rows must get exactly zero dW")
        if name == "all_ignored":
            check(float(k_loss.abs().max()) == 0.0 and float(k_dx.float().abs().max()) == 0.0,
                  "B8 all rows ignored: loss and dx must be exactly 0")
        del outs
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(errs.values()), max_abs_err_by_case=errs,
                ms=times["mixed"]["sharded_fused_linear_ce"],
                plain_ms=times["mixed"]["sharded_fused_linear_ce_ref"], ms_by_case=times)


def lcrec_fixed_steps(group, seed, profile) -> dict:
    """(c) All layers at full width, bf16, batch 8 x 512: LCREC["warm"]
    steps, then LCREC["steps"] measured with every launch counter at 0
    before and read after."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    dev = group.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, live = lcrec_model(lcrec_cfg(LCREC["layers"]), dev, seed, torch.bfloat16, group)
    init_s = time.perf_counter() - t0
    n, warm = LCREC["steps"], LCREC["warm"]
    batches = [lcrec_tokens(seed + 100 + i, LCREC["batch"], LCREC["seq"], live)
               for i in range(warm + n + (LCREC["profile_steps"] if profile else 0))]
    stamps = []

    def hook():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    run = lcrec_stepper(model, live, group, LCREC["lr"], LCREC["warmup"], len(batches),
                        LCREC["wd"])
    run(batches[:warm])
    torch.cuda.synchronize()
    reset_counters()
    calls0, bytes0 = group.calls, group.bytes
    t_start = time.perf_counter()
    metrics = run(batches[warm:warm + n], hook)
    wall_s = time.perf_counter() - t_start
    launches = read_counters()
    calls, nbytes_ = group.calls - calls0, group.bytes - bytes0
    step_ms = 1e3 * np.diff([t_start] + stamps)
    tokens = LCREC["batch"] * LCREC["seq"]
    out = dict(init_s=init_s, steps=n, wall_s=wall_s, steps_per_s=n / wall_s,
               tokens_per_s=n * tokens / wall_s,
               label_tokens_per_step=float(np.mean(
                   [(b["labels"][:, 1:] != -100).sum() for b in batches[warm:warm + n]])),
               step_ms_p50=float(np.percentile(step_ms, 50)),
               step_ms_p90=float(np.percentile(step_ms, 90)),
               losses=[m["loss"] for m in metrics], grad_norms=[m["grad_norm"] for m in metrics],
               nonfinite=sum(m["nonfinite"] for m in metrics),
               collectives_per_step=calls / n, collective_bytes_per_step=nbytes_ / n,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
               launches=launches, b8_calls=fc.sharded_fused_linear_ce.launches)
    if profile:
        def more():
            t = time.perf_counter()
            run(batches[warm + n:])
            torch.cuda.synchronize()
            return time.perf_counter() - t

        out["profile"] = dict(steps=LCREC["profile_steps"], **device_profile(more))
    del model, run
    torch.cuda.empty_cache()
    return out


def lcrec_trainer_run(group, seed) -> dict:
    """(d) lcrec_trainer.train at tensor_parallel=2 through
    config/lcrec/synthetic.gin, epochs and eval sets cut; the per-step
    losses come back from rank 0's metrics.jsonl."""
    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.trainers import lcrec_trainer

    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / "config/lcrec/synthetic.gin"))
    with tempfile.TemporaryDirectory() as tmp:
        for binding in ("train.tensor_parallel = 2", f'train.device = "{group.device}"',
                        f'train.save_dir_root = "{tmp}"', "train.wandb_log_interval = 1",
                        f"train.epochs = {LCREC['trainer_epochs']}",
                        f"train.max_eval_samples = {LCREC['trainer_eval']}",
                        f"train.eval_items_limit = {LCREC['trainer_eval']}",
                        f"train.seed = {seed}"):
            configlib.parse_binding(binding)
        reset_counters()
        t0 = time.perf_counter()
        valid, test = lcrec_trainer.train()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_counters()
        logged = ([json.loads(line) for line in open(f"{tmp}/metrics.jsonl")]
                  if group.rank == 0 else [])
    configlib.clear_bindings()
    configlib.clear_macros()
    losses = [m["train/loss"] for m in logged if "global_step" in m]
    return dict(wall_s=wall_s, valid=valid, test=test, launches=launches, losses=losses)


def gloo_takes_cuda(group) -> str:
    """Whether gloo all-reduces a CUDA tensor by itself: recorded only, the
    group stages every gloo collective through host memory either way."""
    import torch.distributed as dist

    if group.backend != "gloo" or group.device.type != "cuda":
        return "not asked"
    t = torch.ones(4, device=group.device)
    try:
        dist.all_reduce(t, group=group.pg)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - the answer is the exception
        return f"no: {type(e).__name__}: {str(e)[:160]}"
    return "yes" if t.tolist() == [float(group.size)] * 4 else f"wrong sum {t.tolist()}"


def lcrec_rank(group, seed, profile) -> dict:
    """One tensor-parallel rank of the lcrec_tp phase: (a) B8 against its
    twin, (b) the tp=2 side of the parity run, (c) the fixed steps at full
    width, (d) the trainer."""
    torch.backends.cuda.matmul.allow_tf32 = False  # as in main(): a fresh process
    out = {"backend": group.backend, "device": str(group.device),
           "gloo_takes_cuda_tensors": gloo_takes_cuda(group), "b8": lcrec_b8(group, seed)}
    model, live = lcrec_model(lcrec_cfg(LCREC["parity_layers"]), group.device, seed,
                              torch.float32, group)
    run = lcrec_stepper(model, live, group, LCREC["parity_lr"], 1, LCREC["parity_steps"],
                        LCREC["wd"])
    out["parity_losses"] = [m["loss"] for m in run(lcrec_parity_batches(seed))]
    del model, run
    torch.cuda.empty_cache()
    out["steps"] = lcrec_fixed_steps(group, seed, profile)
    out["trainer"] = lcrec_trainer_run(group, seed)
    return out


def lcrec_library_b8(x, w, targets):
    """The yardstick of B8: the same loss and gradients by one PyTorch call
    over the whole head on one card."""
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    loss = torch.nn.functional.cross_entropy(torch.nn.functional.linear(x, w),
                                             targets.long(), ignore_index=-100)
    return torch.autograd.grad(loss, (x, w))


def wait_quiet(flag) -> float:
    """Wait until this script's process writes ``flag`` (the work it runs
    beside the ranks is done: they have the card to themselves). Returns
    the seconds waited."""
    t0 = time.perf_counter()
    while not os.path.exists(flag):
        check(time.perf_counter() - t0 < SPAWN_QUIET_TIMEOUT_S, f"{flag} never written")
        time.sleep(0.05)
    return time.perf_counter() - t0


def after_quiet(group, flag, fn, *args):
    """A rank of ``spawn_beside``: ``fn(group, *args)`` once ``flag`` is
    written."""
    wait_quiet(flag)
    return fn(group, *args)


def spawn_beside(fn, world, args, reference, *, device, timeout_s) -> tuple:
    """``spawn(fn, world, args)`` with ``reference()`` computed here while
    the ranks start (a rank spends ~10 s importing torch): each rank runs
    ``fn`` only once a flag says that the reference is done, so nothing of
    this process shares the card with the ranks' work. Returns (the
    reference's result, the ranks' results, the spawn's seconds)."""
    from genrec_tpu_torch.parallel.mesh import spawn

    flag = HERE / "build" / f"quiet_{fn.__name__}"
    flag.parent.mkdir(parents=True, exist_ok=True)
    flag.unlink(missing_ok=True)
    with ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        ranks = pool.submit(spawn, after_quiet, world, (str(flag), fn, *args), device=device,
                            timeout_s=timeout_s)
        try:
            ref = reference()
        finally:
            flag.touch()  # a failed reference still releases the ranks
        return ref, ranks.result(), time.perf_counter() - t0


def lcrec_tp_phase(dev, seed, profile, rank_fn=None) -> dict:
    """LCRec SFT at tensor_parallel=2: the tp=1 side of the parity run and
    the library yardstick of B8 here while 2 ranks start through
    parallel.spawn (gloo on one card, NCCL where each rank has its own). ``rank_fn``
    stands in for ``lcrec_rank`` in a rehearsal on the CPU, which must
    patch each fresh rank process itself."""
    from genrec_tpu_torch.parallel.mesh import choose_backend, rank_device

    backend = choose_backend(rank_device(0, LCREC_TP, dev.type), LCREC_TP)

    def reference():  # while the ranks start
        t0 = time.perf_counter()
        tp1 = lcrec_parity_tp1(dev, seed)
        parity_tp1_s = time.perf_counter() - t0
        x, w, cases = lcrec_b8_inputs(dev, seed)
        lib_sets = [dict(x=x, w=w, targets=torch.as_tensor(cases["mixed"][0], device=dev))]
        library_ms = device_ms(lcrec_library_b8, lib_sets, reps=LCREC_REPS)
        del x, w, lib_sets
        gc.collect()
        torch.cuda.empty_cache()  # the ranks share this card: hand back the cache
        emit("lcrec_tp_start", backend=backend, ranks=LCREC_TP,
             device_count=torch.cuda.device_count(),
             parent_allocated_gb=torch.cuda.memory_allocated(dev) / 1e9,
             parent_reserved_gb=torch.cuda.memory_reserved(dev) / 1e9,
             free_gb=torch.cuda.mem_get_info(dev)[0] / 1e9)
        return tp1, parity_tp1_s, library_ms

    (tp1, parity_tp1_s, library_ms), ranks, spawn_s = spawn_beside(
        rank_fn or lcrec_rank, LCREC_TP, (seed, profile), reference, device=dev.type,
        timeout_s=LCREC_TIMEOUT_S)
    r0, r1 = ranks
    tp2 = r0["parity_losses"]
    check(r1["parity_losses"] == tp2, ("ranks disagree on the parity losses", tp2,
                                       r1["parity_losses"]))
    rel = float(np.max(np.abs(np.asarray(tp2) - tp1) / np.abs(tp1)))
    check(np.isfinite(tp2).all() and rel <= LCREC_PARITY_RTOL,
          f"tp=1 vs tp=2 losses: max relative diff {rel} > {LCREC_PARITY_RTOL}")
    steps = r0["steps"]
    for r in ranks:
        s = r["steps"]
        check(s["nonfinite"] == 0, f"non-finite steps: {s['nonfinite']}")
        check(all(np.isfinite(s["losses"])), s["losses"])
        for name in LCREC_LAUNCHES_PER_STEP:
            check(s["launches"][name] == LCREC["steps"],
                  f"{name}: {s['launches'][name]} launches in {LCREC['steps']} steps, want 1 "
                  "per step per rank")
        check(s["b8_calls"] == LCREC["steps"], ("B8 calls", s["b8_calls"]))
    check(r1["steps"]["losses"] == steps["losses"], "the ranks' losses differ")
    trainer = r0["trainer"]
    losses = trainer["losses"]
    check(len(losses) >= 10 and np.isfinite(losses).all(), losses)
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), ("trainer loss did not fall", losses))
    for name in LCREC_LAUNCHES_PER_STEP:
        check(trainer["launches"][name] > 0, f"train(): {name} was never launched")
    check(all(np.isfinite(v) for v in (*trainer["valid"].values(), *trainer["test"].values())),
          trainer)
    b8 = r0["b8"]
    R, d, V = LCREC["batch"] * (LCREC["seq"] - 1), lcrec_cfg(1).hidden_size, LCREC_LIVE
    # Both ranks' B3 + B4 dx + B4 dW over the whole head, on the one card.
    b8_bound_ms, b8_bound_by = bound(2 * R * d * 2 + V * d * 2 * 2, 5 * 2 * R * V * d,
                                     BF16_FLOPS)
    return emit(
        "lcrec_tp", backend=r0["backend"], devices=[r["device"] for r in ranks],
        gloo_takes_cuda_tensors=r0["gloo_takes_cuda_tensors"],
        config=("QwenConfig() (Qwen2.5-1.5B widths), config/lcrec/amazon/lcrec.gin: "
                f"{LCREC['codebooks']} x {LCREC['codebook_size']} codebook tokens, "
                f"max_text_len {LCREC['seq']}, bf16, AdamW {LCREC['lr']} wd {LCREC['wd']}, "
                f"clip 1.0; batch {LCREC['batch']}; random weights from --seed"),
        live_vocab=LCREC_LIVE, shard_rows=LCREC_SHARD,
        b8=dict(b8, library_ms=library_ms, bound_ms=b8_bound_ms, bound_by=b8_bound_by,
                rank1=r1["b8"]),
        parity=dict(layers=LCREC["parity_layers"], steps=LCREC["parity_steps"], dtype="fp32",
                    batch=[LCREC["parity_batch"], LCREC["parity_seq"]], tp1_losses=tp1,
                    tp2_losses=tp2, max_rel_diff=rel, rtol=LCREC_PARITY_RTOL,
                    tp1_s=parity_tp1_s),
        steps=steps, steps_rank1={k: r1["steps"][k] for k in
                                  ("step_ms_p50", "peak_memory_gb", "peak_reserved_gb",
                                   "losses")},
        trainer=dict(trainer, rank1_valid=r1["trainer"]["valid"]), spawn_s=spawn_s,
    )


# ---- phase 18: resume (the trainers' fault tolerance) -------------------------

# (a)-(c): each trainer through its own amazon.gin on the Beauty set, 2 epochs,
# a resume point after each epoch and the loss logged every step.
RESUME_BINDINGS = ('train.dataset = "synthetic"', "train.wandb_logging = False",
                   "train.do_eval = False", "train.epochs = 2", "train.save_every_epoch = 1",
                   "train.wandb_log_interval = 1")
# A resumed run is held bit for bit. The ops of a train step known to give
# other bits run to run on the card go here, by name (none: every resumed
# run was bit-equal); a run that is not bit-equal fails unless one is named,
# and is then held at the JAX tests' _assert_parity tolerance on its losses,
# parameters and Adam moments, with the ops and tensors named in its line.
RESUME_NONDETERMINISTIC_OPS: tuple = ()
RESUME_FALLBACK_TOL = 1e-5
# (d): lcrec_trainer.train at tp=2 through config/lcrec/synthetic.gin, 2
# layers at the Qwen2.5-1.5B widths, amazon lcrec.gin's 5 x 256 codebooks,
# bf16, batch 4 x 128, one epoch of 12 steps (two epochs before the dp
# phase was added: cut to make room for it), no periodic save (the final point only); only
# rank 1 is signalled, at step 5, and the trainer's loop ORs the guards
# every 8 steps, so both save at 8.
RESUME_LCREC = dict(layers=2, batch=4, seq=128, steps_per_epoch=12, epochs=1, kill=5, poll=8,
                    eval_samples=16)
RESUME_NAN_STEPS = frozenset({4, 5, 6})  # (e): three poisoned HSTU steps in a row


@contextlib.contextmanager
def timed_saves(log: list):
    """Time every CheckpointManager.save of the block, ``{step, wait, s}``
    (an asynchronous save returns once the state is in host memory), and
    every restore through the ladder's consensus, ``{restore, s}``."""
    from genrec_tpu_torch.core.checkpoint import CheckpointManager

    save_, restore_ = CheckpointManager.save, CheckpointManager.restore_latest_valid_consensus

    def save(self, step, state, *, wait=True):
        t0 = time.perf_counter()
        save_(self, step, state, wait=wait)
        log.append(dict(step=int(step), wait=wait, s=time.perf_counter() - t0))

    def restore(self, *args, **kw):
        t0 = time.perf_counter()
        out = restore_(self, *args, **kw)
        log.append(dict(restore=out[1], s=time.perf_counter() - t0))
        return out

    CheckpointManager.save = save
    CheckpointManager.restore_latest_valid_consensus = restore
    try:
        yield log
    finally:
        CheckpointManager.save = save_
        CheckpointManager.restore_latest_valid_consensus = restore_


def resume_train(dev, seed, trainer, gin, save_dir, plan=None, **kw):
    """One ``trainers.<trainer>.train`` run through ``gin`` on the Beauty set
    (the trainer's synthetic dataset swapped for `beauty_dataset`), under
    the chaos ``plan``. Returns (what train returned, wall seconds)."""
    import importlib

    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.core import chaos

    mod = importlib.import_module(f"genrec_tpu_torch.trainers.{trainer}")
    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / gin), substitutions={"split": "beauty"})
    for binding in (*RESUME_BINDINGS, f"train.num_items = {BEAUTY_ITEMS}",
                    f"train.seed = {seed}", f'train.device = "{dev}"',
                    f'train.save_dir_root = "{save_dir}"'):
        configlib.parse_binding(binding)
    synthetic = mod.SyntheticSeqDataset
    mod.SyntheticSeqDataset = lambda max_seq_len, seed: beauty_dataset(seed)
    try:
        with chaos.inject(plan):
            t0 = time.perf_counter()
            out = mod.train(**kw)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
    finally:
        mod.SyntheticSeqDataset = synthetic
        configlib.clear_bindings()
        configlib.clear_macros()


def run_log(save_dir) -> tuple[dict, list, list]:
    """A run directory's metrics.jsonl: the loss by global step (a later
    run's line wins), the steps logged more than once, the goodput reports."""
    losses, twice, goodput = {}, [], []
    for line in open(f"{save_dir}/metrics.jsonl"):
        rec = json.loads(line)
        if "train/loss" in rec and "global_step" in rec:
            g = int(rec["global_step"])
            if g in losses:
                twice.append(g)
            losses[g] = rec["train/loss"]
        if "goodput/pct" in rec:
            goodput.append({k.removeprefix("goodput/"): v for k, v in rec.items()
                            if k.startswith("goodput/")})
    return losses, twice, goodput


def ckpt_dir(save_dir, rank=None) -> Path:
    """A trainer's resume points: ``checkpoints/`` or a rank's ``p<rank>``."""
    return Path(save_dir, "checkpoints", *(() if rank is None else (f"p{rank}",)))


def ckpt_steps(save_dir, rank=None) -> list:
    return sorted(int(p.name) for p in ckpt_dir(save_dir, rank).iterdir() if p.name.isdigit())


def final_point(save_dir, rank=None) -> tuple[int, dict, int]:
    """(step, the state's tensors, tensor file bytes) of the newest resume
    point (of ``rank``'s shard in a per-rank tree)."""
    from genrec_tpu_torch.core.checkpoint import TENSORS, read_record

    step = ckpt_steps(save_dir, rank)[-1]
    path = ckpt_dir(save_dir, rank) / str(step)
    flat = read_record(str(path))
    return step, {k: v for k, v in flat.items() if k.startswith("state/")}, \
        (path / TENSORS).stat().st_size


def held_equal(what, losses_a: dict, losses_b: dict, state_a: dict, state_b: dict) -> dict:
    """Losses and final state of run b against run a: bit for bit, else,
    where RESUME_NONDETERMINISTIC_OPS names the ops at fault, every float
    tensor within RESUME_FALLBACK_TOL; the generator state and the step
    counters always exactly."""
    check(sorted(losses_a) == sorted(losses_b),
          (what, "replayed or skipped steps", sorted(set(losses_a) ^ set(losses_b))))
    check(state_a.keys() == state_b.keys(), (what, "resume point layouts differ"))
    loss_diff = max(abs(losses_a[g] - losses_b[g]) for g in losses_a)
    differ = sorted(k for k in state_a if not torch.equal(state_a[k], state_b[k]))
    out = dict(steps=len(losses_a), bit_equal=loss_diff == 0 and not differ,
               max_loss_diff=loss_diff, tensors=len(state_a), tensors_differ=differ[:20])
    if out["bit_equal"]:
        return out
    check(RESUME_NONDETERMINISTIC_OPS, (what, "not bit for bit and no op is named in "
                                              "RESUME_NONDETERMINISTIC_OPS", out))
    exact = [k for k in differ if not state_a[k].is_floating_point()
             or k.endswith(("/step", "/nonfinite_count", "/count"))]
    check(not exact, (what, "generator or counters differ", exact))
    diffs = {k: float((state_a[k].double() - state_b[k].double()).abs().max()) for k in differ}
    check(loss_diff <= RESUME_FALLBACK_TOL and max(diffs.values(), default=0.0)
          <= RESUME_FALLBACK_TOL,
          (what, "resumed run diverged", loss_diff, sorted(diffs.items(), key=lambda x: -x[1])[:5]))
    return {**out, "max_param_diff": max((v for k, v in diffs.items()
                                          if k.startswith("state/model/")), default=0.0),
            "max_opt_diff": max((v for k, v in diffs.items() if k.startswith("state/opt/")),
                                default=0.0),
            "nondeterministic_ops": list(RESUME_NONDETERMINISTIC_OPS),
            "held_at": RESUME_FALLBACK_TOL}


def resume_parity(what, dir_a, dir_b, replayed=(), rank=None) -> tuple[dict, int, int]:
    """run b (killed, then resumed) against run a (uninterrupted): the logged
    step set, the per-step losses and the final resume point (``rank``'s
    shard in a per-rank tree; the losses are rank 0's log). ``replayed``:
    the steps b may log twice (a fall back to an older resume point)."""
    losses_a, twice_a, _ = run_log(dir_a)
    losses_b, twice_b, _ = run_log(dir_b)
    check(not twice_a and sorted(twice_b) == sorted(replayed),
          (what, "steps logged twice", twice_b, "allowed", list(replayed)))
    step_a, state_a, _ = final_point(dir_a, rank)
    step_b, state_b, nbytes = final_point(dir_b, rank)
    check(step_a == step_b, (what, "final resume points at", step_a, step_b))
    return held_equal(what, losses_a, losses_b, state_a, state_b), step_a, nbytes


def hstu_resume(dev, seed, work) -> dict:
    """(a) HSTU through hstu_trainer.train killed inside epoch 1 and resumed
    (the resume crosses a repack), and (c) the ladder: the killed run's
    newest resume point garbled, the resume falls back to the epoch-0 one."""
    from genrec_tpu_torch.core import chaos

    gin = "config/hstu/amazon.gin"
    a, b, c = (str(work / f"hstu_{x}") for x in "abc")
    saves: list = []
    with timed_saves(saves):
        _, a_s = resume_train(dev, seed, "hstu_trainer", gin, a)
        n = max(run_log(a)[0])
        per_epoch = n // 2
        kill = per_epoch + per_epoch // 2
        out, b_s = resume_train(dev, seed, "hstu_trainer", gin, b,
                                chaos.ChaosPlan(kill_at_step=kill))
        check(out == ({}, {}), ("preempted HSTU run returned", out))
        check(ckpt_steps(b) == [per_epoch, kill], ("HSTU resume points", ckpt_steps(b)))
        shutil.copytree(b, c)
        killed_saves = list(saves)
        reset_counters()
        _, resumed_s = resume_train(dev, seed, "hstu_trainer", gin, b,
                                    resume_from_checkpoint=True)
        launches = read_counters()
    parity, final_step, nbytes = resume_parity("HSTU", a, b)
    steps = n - kill
    ds = beauty_dataset(seed)
    eval_batches = sum(-(-len(ds.eval_arrays_with_time(split)["input_ids"]) // 256)
                       for split in ("valid", "test"))
    want = {"hstu_attention_fwd": 2 * steps + 2 * eval_batches,
            "hstu_attention_bwd": 2 * steps, "fused_linear_ce_fwd": steps,
            "fused_linear_ce_bwd_dx": steps, "fused_linear_ce_bwd_dw": steps}
    for name, count in launches.items():
        check(count == want.get(name, 0), f"resumed HSTU run: {name} launched {count} times, "
                                          f"want {want.get(name, 0)}")
    goodput = run_log(b)[2][-1]  # the resumed run's epoch (1)

    chaos.garble_checkpoint(f"{c}/checkpoints", kill)
    _, ladder_s = resume_train(dev, seed, "hstu_trainer", gin, c, resume_from_checkpoint=True)
    check(kill not in ckpt_steps(c) and Path(c, "checkpoints", "quarantine", "p0",
                                             str(kill)).is_dir(),
          ("the garbled step is not quarantined", ckpt_steps(c)))
    ladder, _, _ = resume_parity("HSTU ladder", a, c, replayed=range(per_epoch + 1, kill + 1))
    return dict(
        steps_per_epoch=per_epoch, kill_at_step=kill, final_step=final_step,
        resumed_steps=steps, parity=parity, launches=launches,
        launches_per_step={k: (v - (2 * eval_batches if k == "hstu_attention_fwd" else 0))
                           / steps for k, v in launches.items() if v},
        eval_batches=eval_batches, resume_point_bytes=nbytes,
        async_save_s=[x["s"] for x in killed_saves if not x["wait"]],
        preemption_save_s=[x["s"] for x in killed_saves if x["wait"]],
        restore_s=goodput["restore_s"], goodput_epoch1=goodput,
        run_s=dict(uninterrupted=a_s, killed=b_s, resumed=resumed_s),
        ladder=dict(garbled_step=kill, fell_back_to=per_epoch, parity=ladder, run_s=ladder_s),
    )


def sasrec_resume(dev, seed, work) -> dict:
    """(b) SASRec through sasrec_trainer.train signalled between the epochs
    (kill_at_epoch=0): the next epoch's first poll writes (1, 0)."""
    from genrec_tpu_torch.core import chaos

    gin = "config/sasrec/amazon.gin"
    a, b = (str(work / f"sasrec_{x}") for x in "ab")
    resume_train(dev, seed, "sasrec_trainer", gin, a)
    per_epoch = max(run_log(a)[0]) // 2
    out, _ = resume_train(dev, seed, "sasrec_trainer", gin, b, chaos.ChaosPlan(kill_at_epoch=0))
    check(out == ({}, {}), ("preempted SASRec run returned", out))
    check(ckpt_steps(b) == [per_epoch], ("SASRec resume points", ckpt_steps(b)))
    reset_counters()
    _, resumed_s = resume_train(dev, seed, "sasrec_trainer", gin, b,
                                resume_from_checkpoint=True)
    launches = read_counters()
    for name, count in launches.items():
        want = per_epoch if name in SASREC_LAUNCHES_PER_STEP else 0
        check(count == want, f"resumed SASRec run: {name} launched {count} times, want {want}")
    parity, final_step, nbytes = resume_parity("SASRec", a, b)
    return dict(steps_per_epoch=per_epoch, final_step=final_step, parity=parity,
                launches=launches, resume_point_bytes=nbytes, resumed_s=resumed_s)


@contextlib.contextmanager
def qwen_vocab():
    """The synthetic LCRec tokenizer's words padded with unused ones to
    Qwen2.5's LCREC["base_vocab"] ids: lcrec_trainer.train sizes the
    backbone's vocabulary by its tokenizer, and the synthetic data names a
    few hundred words."""
    from genrec_tpu_torch.data import lcrec_tasks

    base = lcrec_tasks.WordTokenizer

    class QwenSizedTokenizer(base):
        def __init__(self, words, num_codebooks, codebook_size):
            unused = [f"unused{i}" for i in range(LCREC["base_vocab"] - 3 - len(words))]
            super().__init__([*words, *unused], num_codebooks, codebook_size)

    lcrec_tasks.WordTokenizer = QwenSizedTokenizer
    try:
        yield
    finally:
        lcrec_tasks.WordTokenizer = base


def lcrec_resume_bindings(device, seed, extra=()) -> tuple:
    """The gin bindings of lcrec_trainer.train in the resume runs: 2 layers
    at the Qwen2.5-1.5B widths and vocab, RESUME_LCREC's batches and
    epochs, no eval and no epoch-boundary save; ``extra`` after them."""
    c = RESUME_LCREC
    cfg = lcrec_cfg(c["layers"])
    return (
        f'train.device = "{device}"', f"train.seed = {seed}", f"train.n_layers = {c['layers']}",
        f"train.hidden_size = {cfg.hidden_size}",
        f"train.intermediate_size = {cfg.intermediate_size}",
        f"train.num_heads = {cfg.num_attention_heads}",
        f"train.num_kv_heads = {cfg.num_key_value_heads}",
        f"train.num_codebooks = {LCREC['codebooks']}",
        f"train.codebook_size = {LCREC['codebook_size']}",
        f"train.batch_size = {c['batch']}", f"train.max_text_len = {c['seq']}",
        f"train.max_train_samples = {c['batch'] * c['steps_per_epoch']}",
        f"train.epochs = {c['epochs']}", f"train.save_every_epoch = {c['epochs'] + 1}",
        "train.do_eval = False", "train.eval_item_tasks = False",
        f"train.max_eval_samples = {c['eval_samples']}", "train.wandb_log_interval = 1", *extra)


def gin_train_run(gin, bindings, work, train_fn, ctx=contextlib.nullcontext, rank=None):
    """``run(name, plan=None, **kw)``: ``train_fn(**kw)`` through ``gin`` and
    ``bindings``, saving under work / name, inside ``ctx()`` and the chaos
    ``plan``; the counters set to 0 before and read after, every save and
    restore timed, the resume points (``rank``'s in a per-rank tree) listed."""
    from genrec_tpu_torch import configlib
    from genrec_tpu_torch.core import chaos

    def run(name, plan=None, **kw):
        configlib.clear_bindings()
        configlib.clear_macros()
        configlib.parse_file(str(HERE / gin))
        for binding in (*bindings, f'train.save_dir_root = "{work / name}"'):
            configlib.parse_binding(binding)
        log: list = []
        reset_counters()
        try:
            with ctx(), timed_saves(log), chaos.inject(plan):
                t0 = time.perf_counter()
                out = train_fn(**kw)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
        finally:
            configlib.clear_bindings()
            configlib.clear_macros()
        launches = read_counters()
        gc.collect()
        torch.cuda.empty_cache()
        return dict(out=out, wall_s=wall_s, launches=launches,
                    saves=[x for x in log if "step" in x],
                    restores=[x for x in log if "restore" in x],
                    steps=ckpt_steps(work / name, rank))

    return run


def lcrec_resume_rank(group, seed) -> dict:
    """(d) one rank: lcrec_trainer.train at tensor_parallel=2, 2 layers at
    the Qwen2.5-1.5B widths and vocab: uninterrupted (a), with only rank 1
    signalled (b), b resumed, then b's final point evaluated (eval_only)."""
    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.trainers import lcrec_trainer

    torch.backends.cuda.matmul.allow_tf32 = False  # as in main(): a fresh process
    work = HERE / "build" / "resume" / "lcrec"
    run_ = gin_train_run("config/lcrec/synthetic.gin",
                         lcrec_resume_bindings(group.device, seed,
                                               ("train.tensor_parallel = 2",)),
                         work, lcrec_trainer.train, qwen_vocab, group.rank)

    def run(name, plan=None, **kw):
        r = run_(name, plan, **kw)
        return dict(r, final_model=(work / name / f"final_model.rank{group.rank}").exists())

    return dict(a=run("a"), b=run("b", chaos.ChaosPlan(kill_at_step=RESUME_LCREC["kill"],
                                                       only_process=1)),
                resumed=run("b", resume_from_checkpoint=True),
                eval_only=run("b", eval_only=True))


def lcrec_resume(dev, seed, rank_fn=None) -> dict:
    """(d) two ranks through parallel.mesh.spawn on the card; ``rank_fn``
    stands in for ``lcrec_resume_rank`` in a rehearsal on the CPU. The
    losses are rank 0's log; each rank's final point is held apart."""
    from genrec_tpu_torch.parallel.mesh import spawn

    c = RESUME_LCREC
    work = HERE / "build" / "resume" / "lcrec"
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share this card
    ranks = spawn(rank_fn or lcrec_resume_rank, LCREC_TP, (seed,), device=dev.type,
                  timeout_s=LCREC_TIMEOUT_S)
    save_at = -(-c["kill"] // c["poll"]) * c["poll"]
    total = c["epochs"] * c["steps_per_epoch"]
    parity, nbytes = [], []
    for rank, r in enumerate(ranks):
        a, b, b2, ev = r["a"], r["b"], r["resumed"], r["eval_only"]
        check(b["out"] == ({}, {}), (f"rank {rank}: the preempted run returned", b["out"]))
        check(b["steps"] == [save_at] and [x["step"] for x in b["saves"] if x["wait"]]
              == [save_at], (f"rank {rank} preempted at", b["steps"], b["saves"], "want",
                             save_at))
        check([x["restore"] for x in b2["restores"]] == [save_at]
              and [x["restore"] for x in ev["restores"]] == [total],
              (f"rank {rank} restored", b2["restores"], ev["restores"]))
        check(a["steps"] == b2["steps"][-1:] == [total] and a["final_model"]
              and b2["final_model"], (f"rank {rank}: final points", a["steps"], b2["steps"]))
        n = total - save_at
        for name, count in b2["launches"].items():
            want = n if name in LCREC_LAUNCHES_PER_STEP or name == "sharded_fused_linear_ce" \
                else 0
            check(count == want, f"resumed LCRec rank {rank}: {name} {count}, want {want}")
        valid, test = b2["out"]
        check(all(np.isfinite(v) for v in (*valid.values(), *test.values())), b2["out"])
        check(ev["out"] == (valid, valid), (f"rank {rank}: eval_only of the final point",
                                            ev["out"][0], "resumed run's valid", valid))
        p, _, size = resume_parity(f"LCRec rank {rank}", work / "a", work / "b", rank=rank)
        parity.append(p)
        nbytes.append(size)
    losses = run_log(work / "b")[0]
    check(sorted(losses) == list(range(1, total + 1)), ("LCRec logged steps", sorted(losses)))
    r0, r1 = ranks
    return dict(config=RESUME_LCREC, saved_at=save_at, parity=parity,
                launches_resumed=[r["resumed"]["launches"] for r in ranks],
                resume_point_bytes=nbytes,
                async_save_s=[[x["s"] for x in r[k]["saves"] if not x["wait"]]
                              for r in ranks for k in ("a", "resumed")],
                preemption_save_s=[[x["s"] for x in r["b"]["saves"] if x["wait"]]
                                   for r in ranks],
                restore_s=[r["resumed"]["restores"][0]["s"] for r in ranks],
                eval_only_restore_s=[r["eval_only"]["restores"][0]["s"] for r in ranks],
                eval_only_valid=r0["eval_only"]["out"][0],
                run_s={k: [r[k]["wall_s"] for r in ranks]
                       for k in ("a", "b", "resumed", "eval_only")},
                rank1_valid=r1["resumed"]["out"][0])


def nonfinite_resume(dev, seed, work) -> dict:
    """(e) three poisoned HSTU steps in a row through PackedTrainLoop (a
    float per-row weight on the batch carries the NaN into the loss): the
    parameters stay as they were across the skipped steps, three batches
    are dumped, and NonFiniteLossError is raised at the third."""
    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.core.fault_tolerance import NonFiniteLossError
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.logging import Tracker, setup_logger
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.hstu import HSTU
    from genrec_tpu_torch.trainers.hstu_trainer import make_loss_fn
    from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

    model = HSTU(num_items=BEAUTY_ITEMS, dropout=0.2, use_pallas=True, fused_ce=True,
                 dtype=torch.bfloat16, device=dev, seed=seed, **HSTU_AMAZON)
    optimizer = Adam(1e-3, b2=0.98)
    hstu_loss = make_loss_fn()

    def loss_fn(m, batch, gen):
        loss, aux = hstu_loss(m, batch, gen)
        return loss * batch["weight"].mean(), aux

    step_fn = make_train_step(loss_fn, optimizer, clip_norm=None)
    state = TrainState.create(model, optimizer, seed)
    _, repack = beauty_data(seed)

    def weighted(epoch):
        arrays, rep = repack(epoch)
        return {**arrays, "weight": np.ones(len(arrays["input_ids"]), np.float32)}, rep

    first, last = min(RESUME_NAN_STEPS), max(RESUME_NAN_STEPS)
    snaps = {}

    def hook(st, m, g, *_):
        if g in (first - 1, last):
            snaps[g] = [p.detach().clone() for p in st.params]

    out = str(work / "nonfinite")
    loop = PackedTrainLoop(logger=setup_logger(None), tracker=Tracker(), device=dev,
                           rows_per_step=HSTU_BATCH, row_len=HSTU_AMAZON["max_seq_len"],
                           seed=seed, pack_sequences=True, repack=weighted,
                           save_dir_root=out, step_hook=hook)
    raised = None
    with chaos.inject(chaos.ChaosPlan(nan_at_steps=RESUME_NAN_STEPS)):
        try:
            loop.run_epoch(state, step_fn, 0, 0)
        except NonFiniteLossError as e:
            raised = str(e)
    check(raised is not None and f"step {last}" in raised, ("no abort at the third", raised))
    check(all(torch.equal(x, y) for x, y in zip(snaps[first - 1], snaps[last])),
          "parameters moved across the skipped steps")
    dumps = sorted(p.name for p in Path(out, "nonfinite").iterdir())
    want = sorted(f"nonfinite_step{g}.npz" for g in RESUME_NAN_STEPS)
    check(dumps == want, ("dumps", dumps))
    # The check is one step late: the step after the third ran (and applied)
    # where the epoch has one.
    applied = first - 1 + (loop.pack_report.n_rows // HSTU_BATCH > last)
    check(int(state.step) == applied, ("applied updates", int(state.step), applied))
    return dict(poisoned_steps=sorted(RESUME_NAN_STEPS), dumps=dumps, error=raised,
                skipped=loop.monitor.skipped_steps, applied_updates=int(state.step))


def resume_phase(dev, seed, rank_fn=None) -> dict:
    """(a)-(e) of the trainers' fault tolerance on the card: exact resume
    of HSTU and SASRec through their trainers, the integrity ladder
    through a trainer, LCRec at tp=2 with one rank signalled, non-finite
    batches; the resume points' bytes, save and restore seconds, goodput."""
    work = HERE / "build" / "resume"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        out = dict(hstu=hstu_resume(dev, seed, work))
        out["sasrec"] = sasrec_resume(dev, seed, work)
        out["nonfinite"] = nonfinite_resume(dev, seed, work)
        out["lcrec_tp2"] = lcrec_resume(dev, seed, rank_fn)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return emit("resume", card=torch.cuda.get_device_name(dev), wall_s=time.perf_counter() - t0,
                config=("HSTU and SASRec at config/{hstu,sasrec}/amazon.gin widths (bf16, "
                        "dropout 0.2, kernels on) on the synthetic Amazon-Beauty set, 2 "
                        "epochs, a resume point an epoch; LCRec tp=2: "
                        f"{RESUME_LCREC}"), **out)


# ---- phase 19: the Amazon data paths ---------------------------------------

BEAUTY_REVIEWS = 198502  # reviews of Amazon-Beauty's 2014 5-core dump
# Cuts of the amazon phase (each in its `reduced` field): the trainers'
# epochs, RQ-VAE's epochs and iterations (warm-ups cut in proportion where
# the file's would outlast the run), TIGER's eval users, LCRec's depth (2 of
# the 28 layers, as lcrec_tp's parity run and resume (d) cut it), its train
# and eval samples.
AMAZON = dict(epochs=2, rqvae_epochs=20, tiger_epochs=1, tiger_eval_users=512,
              lcrec_layers=2, lcrec_epochs=2, lcrec_train_samples=96, lcrec_eval_samples=16,
              p5_iterations=200, p5_warmup_iters=7, emb_dim=768, loss_window=20,
              lcrec_widths=dict(hidden_size=1536, intermediate_size=8960, num_heads=12,
                                num_kv_heads=2))
AMAZON_TITLE_WORDS = ("hydrating", "matte", "gentle", "daily", "organic", "vitamin",
                      "rose", "argan", "charcoal", "silk", "volume", "repair", "tinted",
                      "mineral", "coconut", "lavender")
AMAZON_NOUNS = ("cream", "serum", "shampoo", "lipstick", "mascara", "cleanser", "toner",
                "mask", "lotion", "polish", "brush", "oil", "balm", "conditioner")
AMAZON_CATEGORIES = (("Skin Care", "Face", "Creams & Moisturizers"), ("Hair Care", "Shampoos"),
                     ("Makeup", "Lips", "Lipstick"), ("Makeup", "Eyes", "Mascara"),
                     ("Skin Care", "Body", "Cleansers"), ("Fragrance", "Women"),
                     ("Tools & Accessories", "Makeup Brushes & Tools"),
                     ("Skin Care", "Face", "Treatments & Masks"))


def _base36(values, width) -> list:
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    out = []
    for v in values.tolist():
        s = []
        for _ in range(width):
            v, r = divmod(v, 36)
            s.append(digits[r])
        out.append("".join(reversed(s)))
    return out


def write_amazon_dump(root, *, users=BEAUTY_USERS, items=BEAUTY_ITEMS, reviews=BEAUTY_REVIEWS,
                      seed=0, split="beauty", emb_dim=AMAZON["emb_dim"]) -> dict:
    """A seeded dump in the SNAP 2014 layout under ``<root>/raw/<split>/``:
    ``reviews_*_5.json.gz`` (JSON lines grouped by asin, as the 5-core files
    are; every user and every item reviewed 5 times or more, item popularity
    Zipf-like, a user's reviews daily over up to 14 years with gaps of ~40
    days, some on the same day; 1% of the texts quote the timestamp key) and
    ``meta_*.json.gz`` (one python-repr line an item, the 2014 meta's
    literal style, with title, brand, categories, price and description),
    plus ``<root>/processed/<split>_item_emb.npy``: clustered unit-norm
    embeddings (`SyntheticItemEmbeddings`) standing in for sentence-T5's.
    Returns the counts, bytes and host seconds."""
    from genrec_tpu_torch.data.amazon import DATASET_FILES
    from genrec_tpu_torch.data.items import SyntheticItemEmbeddings

    t0 = time.perf_counter()
    check(reviews >= 5 * max(users, items), ("a 5-core dump needs 5 reviews a user and item",
                                             users, items, reviews))
    rng = np.random.default_rng(seed)
    raw = Path(root, "raw", split)
    raw.mkdir(parents=True, exist_ok=True)
    lens = 5 + rng.multinomial(reviews - 5 * users, (w := rng.lognormal(0.0, 1.0, users)) / w.sum())
    pop = (np.arange(items) + 10.0) ** -0.9
    pop = pop[rng.permutation(items)]
    occ = np.concatenate([np.repeat(np.arange(items), 5),
                          rng.choice(items, reviews - 5 * items, p=pop / pop.sum())])
    rng.shuffle(occ)
    user_of = np.repeat(np.arange(users), lens)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    gaps = rng.geometric(1 / 40, reviews) - 1
    gaps[offsets] = 0
    run = np.cumsum(gaps)
    run = run - run[offsets][user_of]  # days since the user's first review
    span = np.maximum.reduceat(run, offsets)
    day = (rng.random(users) * np.maximum(14 * 365 - span, 1)).astype(np.int64)[user_of] + run
    ts = 946684800 + 86400 * day  # from 2000-01-01, whole days as the dumps have
    dates = np.datetime_as_string(ts.astype("datetime64[s]"), unit="D")
    # asins ascending with the item index, so grouping by item is asin order.
    asins = ["B" + a for a in _base36(np.sort(rng.choice(36 ** 9, items, replace=False)), 9)]
    uids = ["A" + u for u in _base36(rng.choice(36 ** 12, users, replace=False), 12)]
    order = np.lexsort((rng.random(reviews), occ))
    helpful = rng.integers(0, 5, (reviews, 2))
    stars = rng.integers(1, 6, reviews)
    quote = rng.random(reviews) < 0.01
    words = rng.integers(0, len(AMAZON_TITLE_WORDS), (reviews, 3))
    lines = []
    for r in order.tolist():
        y, m, d = dates[r].split("-")
        w0, w1, w2 = (AMAZON_TITLE_WORDS[i] for i in words[r])
        text = (f'it said \\"unixReviewTime\\": {r % 997} on the box' if quote[r]
                else f"{w0} and {w1}, {w2} enough")
        lines.append(
            f'{{"reviewerID": "{uids[user_of[r]]}", "asin": "{asins[occ[r]]}", '
            f'"reviewerName": "buyer {user_of[r]}", "helpful": [{helpful[r, 0]}, '
            f'{helpful[r, 0] + helpful[r, 1]}], "reviewText": "{text}", "overall": '
            f'{stars[r]}.0, "summary": "{w1} {w2}", "unixReviewTime": {ts[r]}, '
            f'"reviewTime": "{m} {int(d)}, {y}"}}\n')
    reviews_path = raw / DATASET_FILES[split]["reviews"]
    with gzip.open(reviews_path, "wt", encoding="utf-8", compresslevel=1) as f:
        f.writelines(lines)
    meta_path = raw / DATASET_FILES[split]["meta"]
    with gzip.open(meta_path, "wt", encoding="utf-8", compresslevel=1) as f:
        for i, asin in enumerate(asins):
            cats = AMAZON_CATEGORIES[i % len(AMAZON_CATEGORIES)]
            adj = AMAZON_TITLE_WORDS[int(rng.integers(len(AMAZON_TITLE_WORDS)))]
            noun = AMAZON_NOUNS[i % len(AMAZON_NOUNS)]
            meta = {"asin": asin, "description": f"A {adj} {noun} for every day.",
                    "title": f"{adj.title()} {noun.title()} No. {i}",
                    "imUrl": f"http://ecx.images-amazon.com/images/I/{asin}.jpg",
                    "salesRank": {"Beauty": int(rng.integers(1, 300000))},
                    "categories": [["Beauty", *cats]],
                    "price": round(float(rng.uniform(1, 80)), 2),
                    "brand": f"Brand{i % 97}"}
            f.write(repr(meta) + "\n")
    emb_path = Path(root, "processed", f"{split}_item_emb.npy")
    emb_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(emb_path, SyntheticItemEmbeddings(num_items=items, dim=emb_dim,
                                              seed=seed).embeddings)
    return dict(users=users, items=items, reviews=reviews, seconds=time.perf_counter() - t0,
                reviews_bytes=reviews_path.stat().st_size, meta_bytes=meta_path.stat().st_size,
                embeddings=[items, emb_dim])


def write_p5_copy(amazon_root, p5_root, split="beauty") -> dict:
    """The P5 layout of an Amazon root whose sequences are parsed:
    ``sequential_data.txt`` (one line a user, "uid item ...", 1-based ids in
    time order), ``datamaps.json`` (``item2id``), ``meta.json.gz`` (the meta
    dump) and ``processed/<split>_item_emb.npy`` (row i = item id i + 1)."""
    from genrec_tpu_torch.data.amazon import DATASET_FILES, load_item_asins, load_sequences

    seqs, _, _ = load_sequences(str(amazon_root), split, download=False)
    asins = load_item_asins(str(amazon_root), split)
    raw = Path(p5_root, "raw", split)
    raw.mkdir(parents=True, exist_ok=True)
    with open(raw / "sequential_data.txt", "w") as f:
        f.writelines(f"{u + 1} {' '.join(map(str, s.tolist()))}\n" for u, s in enumerate(seqs))
    (raw / "datamaps.json").write_text(
        json.dumps({"item2id": {a: str(i + 1) for i, a in enumerate(asins)}}))
    shutil.copyfile(Path(amazon_root, "raw", split, DATASET_FILES[split]["meta"]),
                    raw / "meta.json.gz")
    emb = Path(p5_root, "processed", f"{split}_item_emb.npy")
    emb.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(Path(amazon_root, "processed", f"{split}_item_emb.npy"), emb)
    return dict(users=len(seqs), items=len(asins))


def amazon_parse(root, split="beauty") -> dict:
    """(a) ``load_sequences(download=False)`` through the native parser,
    then through the Python path: the caches' arrays equal (asins too), the
    cache read back equal to the parse; host seconds of each, and of the
    parser's build (0 when this checkout had built it)."""
    from genrec_tpu_torch import native
    from genrec_tpu_torch.data.amazon import load_sequences

    cache = Path(root, "processed", f"{split}_seqs_min5.npz")
    t0 = time.perf_counter()
    ran = native.native_available()  # builds the parser at first use
    out, caches = {"native_build_s": time.perf_counter() - t0}, {}
    parse = native.parse_reviews_native
    for use_native in (True, False):
        cache.unlink(missing_ok=True)
        # Without the native parser load_sequences reads the file in Python.
        native.parse_reviews_native = parse if use_native else (lambda *a, **k: None)
        try:
            t0 = time.perf_counter()
            seqs, tss, n_items = load_sequences(str(root), split, download=False)
            out[f"{'native' if use_native else 'python'}_s"] = time.perf_counter() - t0
        finally:
            native.parse_reviews_native = parse
        caches[use_native] = dict(np.load(cache))
        again, tss2, n2 = load_sequences(str(root), split, download=False)
        check(n2 == n_items and len(again) == len(seqs)
              and all(np.array_equal(a, b) for a, b in zip(again, seqs))
              and all(np.array_equal(a, b) for a, b in zip(tss2, tss)),
              "the cache read back differs from the parse")
    for key in caches[False]:
        check(np.array_equal(caches[True][key], caches[False][key]),
              f"native and Python parses differ in {key}")
    check(set(caches[True]) == set(caches[False]) == {"items", "timestamps", "lengths",
                                                      "num_items", "asins"}, sorted(caches[True]))
    z = caches[False]
    return dict(out, parser="native" if ran else "python (native build failed)",
                native_build_error=native.build_error(), users=len(z["lengths"]),
                items=int(z["num_items"]), reviews=int(z["lengths"].sum()),
                min_user_reviews=int(z["lengths"].min()),
                timestamp_years=float((z["timestamps"].max() - z["timestamps"].min())
                                      / (365.25 * 86400)))


@contextlib.contextmanager
def step_events():
    """Every PackedTrainLoop built inside the block records a CUDA event
    after each step (beside any hook of its own); yields the list of
    (epoch, event, the step's loss on the device)."""
    from genrec_tpu_torch.trainers.packed_loop import PackedTrainLoop

    init, events = PackedTrainLoop.__init__, []

    def hooked(self, *args, **kw):
        init(self, *args, **kw)
        own = self.step_hook

        def hook(state, m, global_step, epoch, consumed):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((epoch, ev, m["loss"].detach()))
            if own is not None:
                own(state, m, global_step, epoch, consumed)

        self.step_hook = hook

    PackedTrainLoop.__init__ = hooked
    try:
        yield events
    finally:
        PackedTrainLoop.__init__ = init


def step_stats(events) -> dict:
    """Steps; steps/s, p50 / p90 step ms over the intervals between
    consecutive steps of one epoch (evals and repacks between epochs left
    out)."""
    torch.cuda.synchronize()
    ms = [a[1].elapsed_time(b[1]) for a, b in zip(events, events[1:]) if a[0] == b[0]]
    return dict(steps=len(events), steps_per_s=1e3 * len(ms) / sum(ms),
                step_ms_p50=float(np.percentile(ms, 50)),
                step_ms_p90=float(np.percentile(ms, 90)))


def logged(save_dir) -> list:
    return [json.loads(line) for line in open(Path(save_dir, "metrics.jsonl"))]


def epoch_losses(records, what) -> list:
    out = [m["train/loss"] for m in records if "epoch" in m and "train/loss" in m]
    check(len(out) >= 2 and np.isfinite(out).all(), (what, out))
    check(out[-1] < out[0], (f"{what}: the epoch loss did not fall", out))
    return out


def step_losses_fall(records, what) -> list:
    """Per-step losses (logged every step): finite, the last
    AMAZON["loss_window"] below the first on average."""
    n = AMAZON["loss_window"]
    out = [m["train/loss"] for m in records if "global_step" in m and "train/loss" in m]
    check(len(out) >= 2 * n and np.isfinite(out).all(), (what, len(out)))
    check(np.mean(out[-n:]) < np.mean(out[:n]), (f"{what}: loss did not fall", out[:n], out[-n:]))
    return out


def check_exact_launches(what, launches, want) -> dict:
    for name, count in launches.items():
        check(count == want.get(name, 0),
              f"{what}: {name} launched {count} times, want {want.get(name, 0)}")
    return {k: v for k, v in launches.items() if v}


def amazon_trainer(dev, seed, trainer, gin, bindings, save_dir) -> tuple:
    """``trainers.<trainer>.train`` through ``gin`` and ``bindings``: (what
    it returned, wall seconds, launches, step stats, the run's records)."""
    import importlib

    from genrec_tpu_torch import configlib

    train = importlib.import_module(f"genrec_tpu_torch.trainers.{trainer}").train
    configlib.clear_bindings()
    configlib.clear_macros()
    configlib.parse_file(str(HERE / gin), substitutions={"split": "beauty"})
    try:
        for binding in ("train.wandb_logging = False", f'train.save_dir_root = "{save_dir}"',
                        f"train.seed = {seed}", f'train.device = "{dev}"', *bindings):
            configlib.parse_binding(binding)
        with step_events() as events:
            reset_counters()
            t0 = time.perf_counter()
            out = train()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = read_counters()
    finally:
        configlib.clear_bindings()
        configlib.clear_macros()
    return out, wall_s, launches, step_stats(events), logged(save_dir)


def amazon_seq_trainers(dev, seed, root, work) -> dict:
    """(b) HSTU and SASRec through their amazon.gin (dataset_folder the
    dump's, epochs cut to AMAZON["epochs"], eval on): B5 x2, B6 x2, B3, B4
    dx, B4 dW an HSTU step (B5 also x2 an eval batch), B3, B4 dx, B4 dW a
    SASRec step, no other kernel; epoch losses fall; metrics finite."""
    from genrec_tpu_torch.data.amazon import AmazonSASRecData

    ds = AmazonSASRecData(root=str(root), split="beauty", download=False)
    n_eval = len(ds.eval_arrays("valid")["targets"])
    out = {}
    for trainer, per_step, per_eval_batch in (
            ("hstu_trainer", LAUNCHES_PER_STEP, {"hstu_attention_fwd": 2}),
            ("sasrec_trainer", SASREC_LAUNCHES_PER_STEP, {})):
        gin = f"config/{trainer.split('_')[0]}/amazon.gin"
        (valid, test), wall_s, launches, stats, records = amazon_trainer(
            dev, seed, trainer, gin, (f'train.dataset_folder = "{root}"',
                                      f"train.epochs = {AMAZON['epochs']}"),
            work / trainer)
        # The evals: one a epoch (valid), then the best parameters' valid and test.
        eval_batches = (AMAZON["epochs"] + 2) * -(-n_eval // 256)
        n = stats["steps"]
        want = {k: v * n + per_eval_batch.get(k, 0) * eval_batches for k, v in per_step.items()}
        check_exact_launches(f"{trainer} (amazon)", launches, want)
        check(all(np.isfinite(v) for v in (*valid.values(), *test.values())), (valid, test))
        perf = [m["perf/steps_per_sec"] for m in records if "perf/steps_per_sec" in m]
        out[trainer.split("_")[0]] = dict(
            config=gin, wall_s=wall_s, **stats, steps_per_s_by_epoch=perf,
            epoch_loss=epoch_losses(records, trainer), eval_batches=eval_batches,
            launches=launches, launches_per_step={k: (launches[k] - per_eval_batch.get(k, 0)
                                                      * eval_batches) / n for k in per_step},
            valid=valid, test=test)
    return out


def rqvae_export_launches(what, records, items, launches) -> int:
    """B7 once a 4,096-item chunk in every collision eval and in the export;
    no other kernel. Returns the evals."""
    evals = sum("collision_rate" in m for m in records)
    chunks = -(-items // SEM_ID_CHUNK)
    check_exact_launches(what, launches, {"rq_cascade": chunks * (1 + evals)})
    return evals


def amazon_pipelines(dev, seed, root, work) -> dict:
    """(c) and (d): pipelines.run_two_stage for TIGER (config/tiger/amazon/
    {rqvae,tiger}.gin) and LCRec (config/lcrec/amazon/{rqvae,lcrec_debug}.gin)
    on the dump, epochs, eval sets and LCRec's depth cut (AMAZON)."""
    from genrec_tpu_torch import pipelines
    from genrec_tpu_torch.data.sem_ids import load_sem_ids
    from genrec_tpu_torch.trainers import tiger_trainer

    base = (f'train.dataset_folder = "{root}"', "train.wandb_logging = False",
            f"train.seed = {seed}")
    rq_bindings = (f"train.epochs = {AMAZON['rqvae_epochs']}", "train.wandb_log_interval = 1")
    out = {}
    # (c) TIGER: the eval sets cut to a seeded AMAZON["tiger_eval_users"] rows.
    full = tiger_trainer.TigerSeqData

    class EvalCut(full):
        def eval_arrays(self, split="valid"):
            arrays = super().eval_arrays(split)
            n = len(arrays["user_ids"])
            keep = np.sort(np.random.default_rng(seed).permutation(n)[:AMAZON["tiger_eval_users"]])
            return {k: v[keep] for k, v in arrays.items()}

    runs = {
        "tiger": ("tiger_trainer", "config/tiger/amazon/rqvae.gin",
                  "config/tiger/amazon/tiger.gin", 3,
                  (f"train.epochs = {AMAZON['tiger_epochs']}",), TIGER_LAUNCHES_PER_STEP),
        # LCRec writes no checkpoint here (the file's one an epoch, and the
        # final point: resume is the resume phase's); its losses come from
        # the steps.
        "lcrec": ("lcrec_trainer", "config/lcrec/amazon/rqvae.gin",
                  "config/lcrec/amazon/lcrec_debug.gin", 5,
                  ("train.pretrained_path = None", "train.tensor_parallel = 1",
                   *(f"train.{k} = {v}" for k, v in AMAZON["lcrec_widths"].items()),
                   f"train.n_layers = {AMAZON['lcrec_layers']}",
                   f"train.epochs = {AMAZON['lcrec_epochs']}",
                   f"train.max_train_samples = {AMAZON['lcrec_train_samples']}",
                   f"train.max_eval_samples = {AMAZON['lcrec_eval_samples']}"),
                  LCREC_LAUNCHES_PER_STEP),
    }
    for name, (trainer, rq_gin, model_gin, levels, model_bindings, per_step) in runs.items():
        wd, rq_dir, model_dir = work / f"{name}_wd", work / f"{name}_rq", work / name
        with step_events() as events, contextlib.ExitStack() as stack:
            if name == "tiger":
                tiger_trainer.TigerSeqData = EvalCut
                stack.callback(setattr, tiger_trainer, "TigerSeqData", full)
            reset_counters()
            t0 = time.perf_counter()
            valid, test = pipelines.run_two_stage(
                trainer, str(HERE / rq_gin), str(HERE / model_gin), "beauty", list(base),
                [*rq_bindings, f'train.save_dir_root = "{rq_dir}"'],
                [*model_bindings, 'train.save_dir_root = "{}"'.format(
                    model_dir if name == "tiger" else "")],
                workdir=str(wd), device=str(dev))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = read_counters()
        sem_ids, K = load_sem_ids(str(wd / "beauty" / "sem_ids.npz"))
        check(sem_ids.shape == (BEAUTY_ITEMS, levels) and K == 256, (name, sem_ids.shape, K))
        rq_records = logged(rq_dir)
        # Stage 2's steps: the events after stage 1's (every step of both is one).
        rq_steps = len([m for m in rq_records if "global_step" in m])
        steps = len(events) - rq_steps
        evals = sum("collision_rate" in m for m in rq_records)
        want = {"rq_cascade": -(-BEAUTY_ITEMS // SEM_ID_CHUNK) * (1 + evals),
                **{k: v * steps for k, v in per_step.items()}}
        check_exact_launches(f"{name} pipeline", launches, want)
        check(all(np.isfinite(v) for v in (*valid.values(), *test.values())), (valid, test))
        step_loss = [float(x[2]) for x in events[rq_steps:]]
        # A skipped (non-finite) step shows its loss.
        check(np.isfinite(step_loss).all(), f"{name}: a non-finite step")
        if name == "tiger":
            model_losses = step_losses_fall(logged(model_dir), name)
        else:
            by_epoch = [float(np.mean([float(x[2]) for x in events[rq_steps:] if x[0] == e]))
                        for e in range(AMAZON["lcrec_epochs"])]
            check(by_epoch[-1] < by_epoch[0], ("lcrec: the epoch loss did not fall", by_epoch))
            model_losses = step_loss
        out[name] = dict(
            config=f"{rq_gin} then {model_gin}", wall_s=wall_s, sem_ids=list(sem_ids.shape),
            codebook_size=K, collision_rate=1 - len({tuple(r) for r in sem_ids.tolist()})
            / len(sem_ids), rqvae=dict(steps=rq_steps, collision_evals=evals,
                                       epoch_loss=epoch_losses(rq_records, f"{name} RQ-VAE")),
            **step_stats(events[rq_steps:]),
            loss_first=model_losses[0], loss_last=model_losses[-1], launches=launches,
            valid=valid, test=test)
    return out


def amazon_p5(dev, seed, p5_root, work) -> dict:
    """(e) rqvae_trainer.train through config/rqvae/p5_amazon.gin on the P5
    copy, iterations cut: per-step losses fall; the export runs B7."""
    save = work / "p5"
    (model, sem_ids), wall_s, launches, stats, records = amazon_trainer(
        dev, seed, "rqvae_trainer", "config/rqvae/p5_amazon.gin",
        (f'train.dataset_folder = "{p5_root}"', f'train.sem_ids_path = "{save}/sem_ids.npz"',
         f"train.iterations = {AMAZON['p5_iterations']}",
         f"train.warmup_iters = {AMAZON['p5_warmup_iters']}", "train.wandb_log_interval = 1"),
        save)
    check(sem_ids.shape == (BEAUTY_ITEMS, 3), sem_ids.shape)
    evals = rqvae_export_launches("p5 RQ-VAE", records, BEAUTY_ITEMS, launches)
    losses = step_losses_fall(records, "p5 RQ-VAE")
    return dict(config="config/rqvae/p5_amazon.gin", wall_s=wall_s, **stats,
                loss_first=losses[0], loss_last=losses[-1], collision_evals=evals,
                launches=launches)


def amazon_phase(dev, seed) -> dict:
    """Phase 19: the Amazon data paths over a seeded dump at Amazon-Beauty's
    counts: (a) the parse, native and Python; (b) HSTU and SASRec; (c) the
    TIGER pipeline; (d) the LCRec pipeline; (e) RQ-VAE on the P5 copy; B7 at
    LCRec's 5 levels against its plain version."""
    from genrec_tpu_torch.kernels import rq_cascade as rq

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root, p5_root, work = Path(tmp, "amazon"), Path(tmp, "p5_amazon"), Path(tmp, "runs")
        dump = write_amazon_dump(root, seed=seed)
        parse = amazon_parse(root)
        check((parse["users"], parse["items"], parse["reviews"])
              == (BEAUTY_USERS, BEAUTY_ITEMS, BEAUTY_REVIEWS), parse)
        emit("amazon_parse", dump=dump, **parse)
        t0 = time.perf_counter()
        p5 = write_p5_copy(root, p5_root)
        p5["seconds"] = time.perf_counter() - t0
        seq = amazon_seq_trainers(dev, seed, root, work)
        emit("amazon_train", **seq)
        pipes = amazon_pipelines(dev, seed, root, work)
        emit("amazon_pipelines", **pipes)
        p5_run = amazon_p5(dev, seed, p5_root, work)
    # B7 at LCRec's levels (5 x 256, D 64), one export chunk, on the card.
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((SEM_ID_CHUNK, 64), device=dev, generator=g)
    cb = 0.7 * torch.randn((5, 256, 64), device=dev, generator=g)
    ids, _ = rq.rq_cascade_cuda(x, cb)
    ties = check_sem_ids("B7 at 5 levels", x, cb, ids, rq.rq_cascade_ref(x, cb)[0])
    return emit(
        "amazon", card=torch.cuda.get_device_name(dev), wall_s=time.perf_counter() - t_phase,
        parse=parse, p5_copy=p5, p5=p5_run, b7_five_levels=ties,
        launches={**{k: v["launches"] for k, v in (*seq.items(), *pipes.items())},
                  "p5": p5_run["launches"]},
        reduced=dict(epochs=f"hstu, sasrec 10 -> {AMAZON['epochs']}",
                     rqvae=f"tiger and lcrec rqvae.gin 5,000 -> {AMAZON['rqvae_epochs']} epochs",
                     tiger=f"100 -> {AMAZON['tiger_epochs']} epoch; eval "
                           f"{AMAZON['tiger_eval_users']} seeded users of {BEAUTY_USERS}",
                     lcrec=f"Qwen2.5-1.5B widths at {AMAZON['lcrec_layers']} of 28 layers, "
                           "random init over the dump's words (no checkpoint, no resume "
                           f"points); epochs 5 -> {AMAZON['lcrec_epochs']}, "
                           f"max_train_samples 500 -> {AMAZON['lcrec_train_samples']}, "
                           f"max_eval_samples 100 -> {AMAZON['lcrec_eval_samples']}",
                     p5=f"iterations 300,000 -> {AMAZON['p5_iterations']}, warmup_iters 10,000 "
                        f"-> {AMAZON['p5_warmup_iters']}"),
        config=f"a seeded SNAP-layout dump at Amazon-Beauty's {BEAUTY_USERS} users, "
               f"{BEAUTY_ITEMS} items, {BEAUTY_REVIEWS} reviews; item embeddings "
               f"{BEAUTY_ITEMS} x {AMAZON['emb_dim']} (SyntheticItemEmbeddings)",
    )


# ---- phases 20-22: the Qwen families' rest (NoteLLM, LCRec serving, LoRA) ----

# NoteLLM at QwenConfig()'s Qwen2.5-1.5B widths (hidden 1,536, FFN 8,960, 28
# layers, 12 heads, 2 KV heads), bf16, random weights from --seed, over the
# pair data's own vocabulary (config/notellm/synthetic.gin's 64 train and 16
# eval topics), untied head, max_text_len 128 (125 words + [EMB] a row),
# batch_pairs 16 (32 rows), AdamW (only 2-D tensors decayed, wd 0.01) on
# the cosine warm-up, clip 1.0, tau from 3.0. Cut: the steps ("warm" +
# "steps", then "profile_steps" under torch.profiler), lr 1e-4 (the file's
# 1e-3 trains its 64-wide model); the trainer run at 2 layers, 2 of the
# file's 6 epochs (16 steps each), killed at step "kill".
NOTELLM = dict(layers=28, seq=128, batch_pairs=16, lr=1e-4, warmup=5, wd=0.01, tau=3.0,
               warm=3, steps=20, profile_steps=1, topics=64, eval_topics=16,
               pairs_per_topic=7, topk=5, trainer_layers=2, trainer_epochs=2, kill=20)
# Both Qwen heads in one engine, each model at the Qwen2.5-1.5B widths in
# bf16: LCRec with config/lcrec/amazon/lcrec.gin's 5 x 256 codebooks and
# beam_width 10 as top_k, over Beauty's 12,101 items (distinct random
# 5-level sem-ids); NoteLLM over 12,101 random unit vectors of 1,536, top
# 10. The swaps go to 20,000 items: the trie's and the bank's next
# capacity_for rung (16,384 -> 65,536).
QWEN_SERVE = dict(layers=28, top_k=10, burst=256, sample=12, swap_items=20000,
                  after_swap=32, batches=(1, 2, 4, 8, 16), histories=(4, 8, 16),
                  max_wait_ms=2.0)
# LoRA on the LCRec SFT step at tp=1: the lcrec_tp phase's model (all 28
# layers, bf16, 5 x 256 codebook tokens) and batch (8 x 512), rank 8, alpha
# 16 on q_proj and v_proj (lcrec_trainer's defaults), AdamW 1e-3 (a LoRA
# rate) after a 1-step warm-up, wd 0.01, clip 1.0, one fixed batch (so the
# loss can fall in 8 steps); the trainer run as the resume phase's (d) at
# tp=1 (2 layers, batch 4 x 128, one epoch of 12 steps, killed at 5).
LORA = dict(rank=8, alpha=16.0, targets=("q_proj", "v_proj"), lr=1e-3, warmup=1, wd=0.01,
            warm=2, steps=6)
LORA_LAUNCHES_PER_STEP = {"fused_linear_ce_fwd": 1, "fused_linear_ce_bwd_dx": 1,
                          "fused_linear_ce_bwd_dw": 0}


def qwen_widths(layers: int, **overrides):
    """QwenConfig()'s Qwen2.5-1.5B widths at ``layers`` layers."""
    from genrec_tpu_torch.models.backbones.qwen import QwenConfig

    return QwenConfig(**{"num_hidden_layers": layers, **overrides})


def notellm_cfg(layers: int, vocab: int):
    """The NoteLLM trainer's QwenConfig at the Qwen2.5-1.5B widths."""
    return qwen_widths(layers, vocab_size=vocab, max_position_embeddings=NOTELLM["seq"],
                       rope_theta=10000.0, tie_word_embeddings=False)


def notellm_steps(dev, seed) -> dict:
    """(a) The trainer's own model, loss and optimizer at full width: warm
    steps, then NOTELLM["steps"] timed (each synchronised), one more under
    torch.profiler for the device's busy time, then the paired top-k
    accuracy over the eval topics."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.data.batching import batch_iterator
    from genrec_tpu_torch.data.notellm_pairs import NoteLLMPairData
    from genrec_tpu_torch.trainers import notellm_trainer as nt

    c = NOTELLM
    data = NoteLLMPairData(num_topics=c["topics"], eval_topics=c["eval_topics"],
                           max_len=c["seq"], seed=seed)
    n = c["warm"] + c["steps"] + c["profile_steps"]
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
               for b, _ in batch_iterator(data.train_arrays(c["pairs_per_topic"]),
                                          c["batch_pairs"], shuffle=True, seed=seed,
                                          drop_last=True)][:n]
    check(len(batches) == n, ("NoteLLM batches", len(batches), n))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = nt.notellm_model(notellm_cfg(c["layers"], data.tokenizer.vocab_size),
                             torch.bfloat16, seed, c["tau"], dev)
    opt = nt.make_optimizer(c["lr"], c["warmup"], n, c["wd"])
    step = make_train_step(nt.notellm_loss, opt, clip_norm=1.0)
    state = TrainState.create(model, opt, seed)
    init_s = time.perf_counter() - t0
    losses, stamps = [], []
    reset_counters()
    for b in batches[:c["warm"]]:
        _, m = step(state, b)
        losses.append(float(m["loss"]))
    tau0 = model.tau.item()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    for b in batches[c["warm"]:c["warm"] + c["steps"]]:
        _, m = step(state, b)
        losses.append(float(m["loss"]))  # waits for the step
        stamps.append(time.perf_counter())
    wall_s = time.perf_counter() - t_start

    def more():
        t = time.perf_counter()
        for b in batches[c["warm"] + c["steps"]:]:
            step(state, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    prof = device_profile(more)
    profile_s = time.perf_counter() - t0
    launches = read_counters()
    check(all(np.isfinite(losses)), ("NoteLLM losses", losses))
    check(model.tau.item() != tau0, "tau did not move")
    check(not any(launches.values()), ("NoteLLM runs no kernel of the port", launches))
    t0 = time.perf_counter()
    acc = nt.evaluate_retrieval(model, data.eval_arrays(), c["batch_pairs"], dev, topk=c["topk"])
    eval_s = time.perf_counter() - t0
    check(0.0 <= acc[f"top{c['topk']}_acc"] <= 1.0, acc)
    step_ms = 1e3 * np.diff([t_start] + stamps)
    out = dict(init_s=init_s, steps=c["steps"], rows_per_step=2 * c["batch_pairs"],
               tokens_per_step=2 * c["batch_pairs"] * c["seq"], wall_s=wall_s,
               steps_per_s=c["steps"] / wall_s, step_ms_p50=float(np.percentile(step_ms, 50)),
               step_ms_p90=float(np.percentile(step_ms, 90)),
               device_busy_ms_per_step=prof["device_busy_ms"] / c["profile_steps"],
               device_idle_share=prof["device_idle_share"],
               kernel_launches_per_step=prof["kernel_launches"] / c["profile_steps"],
               top_kernels=prof["top_kernels"][:6], profile_s=profile_s,
               peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
               losses=losses, tau_first=tau0, tau_last=model.tau.item(), eval=acc,
               eval_s=eval_s, eval_pairs=c["eval_topics"], launches=launches,
               parameters=sum(p.numel() for p in model.parameters()))
    del model, state, opt, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def notellm_resume(dev, seed) -> dict:
    """(b) notellm_trainer.train through config/notellm/synthetic.gin at the
    Qwen2.5-1.5B widths and 2 layers: uninterrupted, then killed by SIGTERM
    mid-epoch 1 and resumed: held bit for bit (losses and the final resume
    point), and the same test metric."""
    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.trainers import notellm_trainer as nt

    c = NOTELLM
    cfg = qwen_widths(c["trainer_layers"])
    work = HERE / "build" / "notellm_resume"
    shutil.rmtree(work, ignore_errors=True)
    run = gin_train_run(
        "config/notellm/synthetic.gin",
        (f'train.device = "{dev}"', f"train.seed = {seed}",
         f"train.n_layers = {c['trainer_layers']}", f"train.hidden_size = {cfg.hidden_size}",
         f"train.intermediate_size = {cfg.intermediate_size}",
         f"train.num_heads = {cfg.num_attention_heads}",
         f"train.num_kv_heads = {cfg.num_key_value_heads}",
         f"train.max_text_len = {c['seq']}", f"train.batch_pairs = {c['batch_pairs']}",
         f"train.learning_rate = {c['lr']}", f"train.epochs = {c['trainer_epochs']}",
         "train.wandb_log_interval = 1"),
        work, nt.train)

    a = run("a")
    b = run("b", chaos.ChaosPlan(kill_at_step=c["kill"]))
    check(b["out"] == {} and b["steps"] == [c["kill"]],
          ("the preempted NoteLLM run", b["out"], b["steps"]))
    resumed = run("b", resume_from_checkpoint=True)
    parity, final_step, nbytes = resume_parity("NoteLLM", work / "a", work / "b")
    total = max(run_log(work / "a")[0])
    # The file's 4 pairs a topic, in full batches.
    want = c["trainer_epochs"] * (c["topics"] * 4 // c["batch_pairs"])
    check(final_step == total == want, ("NoteLLM steps", final_step, total, want))
    check(resumed["out"] == a["out"] and set(a["out"]) == {f"top{c['topk']}_acc"},
          ("the resumed run's test metric", resumed["out"], a["out"]))
    for r in (a, b, resumed):
        check(not any(r["launches"].values()), ("NoteLLM runs no kernel", r["launches"]))
    losses = run_log(work / "a")[0]
    out = dict(config="config/notellm/synthetic.gin at the Qwen2.5-1.5B widths, "
                      f"{c['trainer_layers']} layers, max_text_len {c['seq']}, "
                      f"{c['trainer_epochs']} epochs", steps=total, kill_at_step=c["kill"],
               parity=parity, resume_point_bytes=nbytes, test=a["out"],
               loss_first=losses[1], loss_last=losses[total],
               preemption_save_s=[x["s"] for x in b["saves"] if x["wait"]],
               run_s={k: r["wall_s"] for k, r in (("a", a), ("b", b), ("resumed", resumed))})
    shutil.rmtree(work, ignore_errors=True)
    return out


def notellm_phase(dev, seed) -> dict:
    """Phase 20: NoteLLM trained at the Qwen2.5-1.5B widths: (a) the
    trainer's step at full width, no saves; (b) the entry point killed and
    resumed at 2 layers."""
    t0 = time.perf_counter()
    steps = notellm_steps(dev, seed)
    resume = notellm_resume(dev, seed)
    return emit("notellm", card=torch.cuda.get_device_name(dev), wall_s=time.perf_counter() - t0,
                config=("QwenConfig() widths (hidden 1,536, FFN 8,960, 12 heads, 2 KV heads), "
                        f"{NOTELLM['layers']} layers, bf16, untied head, the pair data's "
                        f"vocabulary; max_text_len {NOTELLM['seq']}, batch_pairs "
                        f"{NOTELLM['batch_pairs']}; random weights from --seed"),
                reduced=dict(steps=f"{NOTELLM['warm']} warm + {NOTELLM['steps']} timed + "
                                   f"{NOTELLM['profile_steps']} profiled",
                             lr="1e-3 -> 1e-4 (the file's rate is its 64-wide model's)",
                             trainer=f"{NOTELLM['trainer_layers']} of 28 layers, 6 -> "
                                     f"{NOTELLM['trainer_epochs']} epochs"),
                steps=steps, resume=resume)


def qwen_catalog(rng, n):
    """``n`` distinct 5-level sem-ids over 256 codes, drawn from ``rng``."""
    codes = np.unique(rng.integers(0, LCREC["codebook_size"], (2 * n, LCREC["codebooks"])),
                      axis=0)
    out = codes[rng.permutation(len(codes))[:n]]
    check(len(out) == n, len(out))
    return out


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def qwen_heads(dev, seed, lc_catalog, nl_catalog):
    """The LCRec and NoteLLM heads at full width, bf16, random weights."""
    from genrec_tpu_torch.models.backbones.qwen import QwenLM, qwen_init_params
    from genrec_tpu_torch.models.notellm import add_emb_token
    from genrec_tpu_torch.serving.heads import LCRecGenerativeHead, NoteLLMRetrievalHead

    c = QWEN_SERVE
    lc_model, _ = lcrec_model(lcrec_cfg(c["layers"]), dev, seed, torch.bfloat16, None)
    lc = LCRecGenerativeHead(lc_model.eval(), LCREC["base_vocab"], LCREC["codebooks"],
                             LCREC["codebook_size"], catalog=lc_catalog, top_k=c["top_k"],
                             name="lcrec")
    cfg = lcrec_cfg(c["layers"])
    full = qwen_init_params(cfg, seed + 2, dev)
    cfg, full, emb_id = add_emb_token(cfg, full, torch.Generator(device=dev).manual_seed(seed + 3))
    nl_model = QwenLM(cfg, dtype=torch.bfloat16, device=dev)
    nl_model.load_state_dict(full)
    del full
    torch.cuda.empty_cache()
    nl = NoteLLMRetrievalHead(nl_model.eval(), emb_id, catalog=nl_catalog, top_k=c["top_k"],
                              name="notellm")
    return lc, nl


def qwen_requests(rng, n, head, lc_items, emb_id):
    """Histories of 1 to 16 catalog items (LCRec) or query tokens (NoteLLM)."""
    from genrec_tpu_torch.serving.types import Request

    hi = max(QWEN_SERVE["histories"])
    return [Request(head=head, history=(rng.integers(0, lc_items, int(L)) if head == "lcrec"
                                        else rng.integers(3, emb_id, int(L))))
            for L in rng.integers(1, hi + 1, n)]


def qwen_offline(head, req, L):
    """The offline answer of one request at bucket (1, L): LCRec's
    constrained beam over the head's trie, NoteLLM's embedding -> top-k."""
    from genrec_tpu_torch.models.lcrec import generate_topk_constrained
    from genrec_tpu_torch.models.notellm import query2embedding_forward
    from genrec_tpu_torch.parallel.shardings import item_topk

    with torch.no_grad():
        if head.name == "lcrec":
            ids, mask = head.make_batch([req], 1, L)
            Lc = head._clamp(L)
            out = generate_topk_constrained(
                head.model, ids, mask, head.base_vocab, head.num_codebooks, head.codebook_size,
                beam_width=head.top_k, max_cache=Lc * head.num_codebooks + head.num_codebooks,
                trie=head.trie)
            sem = out.sem_ids[0].cpu().numpy()
            return head.lookup(sem), out.log_probas[0].cpu().numpy(), sem
        ids, mask, emb_idx = head.make_batch([req], 1, L)
        emb = query2embedding_forward(head.model, ids, mask, emb_idx,
                                      torch.zeros((), device=ids.device),
                                      return_loss=False).sentence_embedding
        scores, rows = item_topk(torch.cat([emb, torch.ones_like(emb[:, :1])], 1),
                                 head._bank, head.top_k)
        return rows[0].cpu().numpy() - 1, scores[0].cpu().numpy(), None


def qwen_check_sample(name, eng, head, ladder, reqs) -> dict:
    """Requests served alone (bucket (1, L)) against their offline answers."""
    errs = []
    for req in reqs:
        resp = eng.serve(req, timeout=120)
        L = ladder.history_bucket(max(len(req.history), 1))
        check(resp.bucket == (1, L), (name, "served at", resp.bucket, "want", (1, L)))
        items, scores, sem = qwen_offline(head, req, L)
        check(np.array_equal(resp.items, items), (name, "items", resp.items, items))
        if sem is not None:
            check(np.array_equal(resp.sem_ids, sem), (name, "sem-ids", resp.sem_ids, sem))
        errs.append(assert_near(f"{name} scores", torch.as_tensor(resp.scores),
                                torch.as_tensor(scores), SAMPLE_ATOL))
    return dict(requests=len(reqs), max_abs_score_diff=max(errs), tol=SAMPLE_ATOL)


def qwen_burst(eng, reqs_by_head) -> dict:
    """Every head's requests submitted at once (interleaved); qps, p50 and
    p99 of each head's answers."""
    futs = {h: [] for h in reqs_by_head}
    done = {h: [] for h in reqs_by_head}
    t0 = time.perf_counter()
    for group in zip(*reqs_by_head.values()):
        for h, req in zip(reqs_by_head, group):
            futs[h].append(eng.submit(req))
            futs[h][-1].add_done_callback(lambda _, h=h: done[h].append(time.perf_counter()))
    out, responses = {}, {}
    for h, fs in futs.items():
        responses[h] = [f.result(timeout=300) for f in fs]
    for h, fs in futs.items():
        total = np.array([r.total_s for r in responses[h]])
        out[h] = dict(requests=len(fs), qps=len(fs) / (max(done[h]) - t0),
                      p50_ms=1e3 * float(np.percentile(total, 50)),
                      p99_ms=1e3 * float(np.percentile(total, 99)),
                      buckets=dict(collections.Counter(f"{r.bucket[0]}x{r.bucket[1]}"
                                                       for r in responses[h])))
    out["wall_s"] = time.perf_counter() - t0
    return out, responses


def check_lcrec_answers(what, responses, catalog) -> None:
    """Every answer a catalog item: no -1, each tuple the item's sem-ids."""
    for r in responses:
        check((r.items >= 0).all(), (what, "an answer off the catalog", r.items))
        check(np.array_equal(catalog.item_sem_ids[r.items], r.sem_ids),
              (what, "items and tuples disagree", r.items, r.sem_ids))


def qwen_serve_phase(dev, seed) -> dict:
    """Phase 21: one ServingEngine on the card serving the LCRec head
    (trie-constrained beams over 12,101 items) and the NoteLLM head (the
    [EMB] embedding against a 12,101-row bank), both at the Qwen2.5-1.5B
    widths in bf16: a burst of QWEN_SERVE["burst"] requests a head, 12
    requests a head alone against their offline answers, then a catalog
    swap each into the next capacity rung."""
    from genrec_tpu_torch.catalog.snapshot import CatalogSnapshot
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine

    c = QWEN_SERVE
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 19)
    d = lcrec_cfg(1).hidden_size
    sem = qwen_catalog(rng, CATALOG_ITEMS)
    lc_cat = CatalogSnapshot.build(sem, LCREC["codebook_size"])
    nl_cat = CatalogSnapshot.build(sem, LCREC["codebook_size"],
                                   item_vecs=unit_rows(rng, CATALOG_ITEMS, d))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lc, nl = qwen_heads(dev, seed, lc_cat, nl_cat)
    init_s = time.perf_counter() - t0
    ladder = BucketLadder(c["batches"], c["histories"])
    eng = ServingEngine([lc, nl], device=dev, ladder=ladder, max_batch=max(c["batches"]),
                        max_wait_ms=c["max_wait_ms"], handle_signals=False).start()
    try:
        reqs = {"lcrec": qwen_requests(rng, c["burst"], "lcrec", CATALOG_ITEMS, nl.emb_token_id),
                "notellm": qwen_requests(rng, c["burst"], "notellm", CATALOG_ITEMS,
                                         nl.emb_token_id)}
        qwen_burst(eng, {h: r[:16] for h, r in reqs.items()})  # warm: cuBLAS, the allocator
        reset_counters()
        burst, responses = qwen_burst(eng, reqs)
        launches = read_counters()
        check(not any(launches.values()), ("the Qwen heads run no kernel of the port",
                                           launches))
        check_lcrec_answers("lcrec burst", responses["lcrec"], lc_cat)
        # Where a micro-batch's time goes: one full batch a head alone.
        profile = {h: device_profile(lambda h=h: qwen_burst(eng, {h: reqs[h][-16:]})[0]["wall_s"])
                   for h in reqs}
        profile = {h: {k: p[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                          "kernel_launches", "top_kernels")}
                   for h, p in profile.items()}
        for r in responses["notellm"]:
            check(((r.items >= 0) & (r.items < CATALOG_ITEMS)).all(), ("notellm", r.items))
        pick = rng.choice(c["burst"], c["sample"], replace=False)
        sample = {h: qwen_check_sample(h, eng, head, ladder, [reqs[h][i] for i in pick])
                  for h, head in (("lcrec", lc), ("notellm", nl))}
        # The swaps, each into the next capacity rung.
        n2 = c["swap_items"]
        sem2 = qwen_catalog(rng, n2)
        lc2 = CatalogSnapshot.build(sem2, LCREC["codebook_size"])
        nl2 = CatalogSnapshot.build(sem2, LCREC["codebook_size"], item_vecs=unit_rows(rng, n2, d))
        rungs = {"lcrec": [lc.trie.capacity], "notellm": [nl._bank.shape[0]]}
        t0 = time.perf_counter()
        check(eng.stage_catalog("lcrec", lc2) and eng.stage_catalog("notellm", nl2),
              "both swaps staged")
        stage_s = time.perf_counter() - t0
        deadline = time.monotonic() + 60
        while (eng.catalog_version("lcrec"), eng.catalog_version("notellm")) != (lc2.version,
                                                                                 nl2.version):
            check(time.monotonic() < deadline, "the catalog swaps never landed")
            time.sleep(0.01)
        rungs["lcrec"].append(lc.trie.capacity)
        rungs["notellm"].append(nl._bank.shape[0])
        check(all(new > old for old, new in rungs.values()), ("the swaps' rungs", rungs))
        after = {"lcrec": qwen_requests(rng, c["after_swap"], "lcrec", n2, nl.emb_token_id),
                 "notellm": qwen_requests(rng, c["after_swap"], "notellm", n2, nl.emb_token_id)}
        _, responses2 = qwen_burst(eng, after)
        for h, snap in (("lcrec", lc2), ("notellm", nl2)):
            check(all(r.catalog_version == snap.version for r in responses2[h]),
                  (h, "an answer after the swap names another version"))
        check_lcrec_answers("lcrec after the swap", responses2["lcrec"], lc2)
        check(any((r.items >= CATALOG_ITEMS).any() for r in responses2["notellm"]),
              "no NoteLLM answer reached the new items")
        swapped = {h: qwen_check_sample(h + " after the swap", eng, head, ladder, after[h][:2])
                   for h, head in (("lcrec", lc), ("notellm", nl))}
        stats = eng.stats()
    finally:
        eng.stop()
    peak = torch.cuda.max_memory_allocated(dev)
    del lc, nl, eng
    gc.collect()
    torch.cuda.empty_cache()
    return emit(
        "qwen_serve", card=torch.cuda.get_device_name(dev), wall_s=time.perf_counter() - t_phase,
        config=("LCRecGenerativeHead + NoteLLMRetrievalHead in one ServingEngine, each model "
                f"QwenConfig() widths, {c['layers']} layers, bf16, random weights from --seed; "
                f"LCRec {LCREC['codebooks']} x {LCREC['codebook_size']} codebooks, "
                f"{c['top_k']} beams; NoteLLM {CATALOG_ITEMS} x {d} unit vectors, top "
                f"{c['top_k']}; {CATALOG_ITEMS} items; ladder {list(c['batches'])} x "
                f"{list(c['histories'])}"),
        init_s=init_s, burst=burst, sample=sample, launches=launches, profile=profile,
        swap=dict(items=n2, rungs=rungs, stage_s=stage_s, after=swapped,
                  catalog_swaps=stats.get("catalog_swaps")),
        peak_allocated_bytes=peak,
        reduced=dict(weights="random (no Qwen2.5-1.5B checkpoint or note corpus in the "
                             "repository)"))


def lcrec_lora_steps(dev, seed) -> dict:
    """(a) The LoRA SFT step at full width: warm steps, then LORA["steps"]
    with the launch counters at 0 before and read after; the base checked
    bit for bit, the adapters moved, the loss fallen; an adapter resume
    point written and measured."""
    from genrec_tpu_torch.core.checkpoint import CheckpointManager, read_record
    from genrec_tpu_torch.core.fault_tolerance import save_resume_point
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.lora import LoraAdapters, lora_init, lora_param_count
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.lcrec import sft_loss
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
    from genrec_tpu_torch.trainers.lcrec_trainer import lora_loss_fn

    c = LORA
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model, live = lcrec_model(lcrec_cfg(LCREC["layers"]), dev, seed, torch.bfloat16, None)
    for p in model.parameters():
        p.requires_grad_(False)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    adapters = LoraAdapters(lora_init(dict(model.named_parameters()),
                                      torch.Generator(device=dev).manual_seed(seed + 7),
                                      c["rank"], c["targets"]))
    start = {k: v.clone() for k, v in adapters.state_dict().items()}

    def base_loss(m, b):
        return sft_loss(m, b["input_ids"], b["attention_mask"], b["labels"], valid_vocab=live,
                        use_fused_ce=True)

    n = c["warm"] + c["steps"]
    opt = Adam(cosine_schedule_with_warmup(c["lr"], c["warmup"], n), weight_decay=c["wd"])
    step = make_train_step(lora_loss_fn(model, base_loss, c["alpha"], c["rank"]), opt,
                           clip_norm=1.0)
    state = TrainState.create(adapters, opt, seed)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in lcrec_tokens(seed + 300, LCREC["batch"], LCREC["seq"], live).items()}
    init_s = time.perf_counter() - t0
    losses = []
    for _ in range(c["warm"]):
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    reset_counters()
    stamps, t_start = [], time.perf_counter()
    for _ in range(c["steps"]):
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
        check(float(m["nonfinite"]) == 0.0, "a non-finite LoRA step")
        stamps.append(time.perf_counter())
    wall_s = time.perf_counter() - t_start
    launches = read_counters()
    for name, count in launches.items():
        want = c["steps"] * LORA_LAUNCHES_PER_STEP.get(name, 0)
        check(count == want, f"LoRA step: {name} launched {count} times in {c['steps']} "
                             f"steps, want {want}")
    differ = [k for k, v in model.state_dict().items() if not torch.equal(v, base[k])]
    check(not differ, ("the frozen base changed", differ[:5]))
    moved = [k for k, v in adapters.state_dict().items() if not torch.equal(v, start[k])]
    check(len(moved) == len(start), ("adapters that did not move",
                                     sorted(set(start) - set(moved))[:5]))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], ("LoRA loss", losses))
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        mgr = CheckpointManager(tmp)
        t0 = time.perf_counter()
        save_resume_point(mgr, state, epoch=0, next_batch=n, global_step=n, data_seed=seed,
                          wait=True)
        save_s = time.perf_counter() - t0
        mgr.close()
        point = Path(tmp, str(n))
        point_bytes = sum(f.stat().st_size for f in point.rglob("*") if f.is_file())
        keys = [k for k in read_record(str(point)) if k.startswith("state/model/")]
    check(keys and all(k.startswith(("state/model/a.", "state/model/b.")) for k in keys),
          ("an adapter resume point holds", keys[:5]))
    step_ms = 1e3 * np.diff([t_start] + stamps)
    out = dict(init_s=init_s, steps=c["steps"], wall_s=wall_s, steps_per_s=c["steps"] / wall_s,
               step_ms_p50=float(np.percentile(step_ms, 50)),
               tokens_per_s=c["steps"] * LCREC["batch"] * LCREC["seq"] / wall_s,
               losses=losses, launches=launches,
               adapter_parameters=lora_param_count(adapters.tree()),
               base_parameters=sum(v.numel() for v in base.values()),
               resume_point_bytes=point_bytes, resume_point_tensors=len(keys),
               resume_point_save_s=save_s, base_bit_equal=True,
               peak_allocated_bytes=torch.cuda.max_memory_allocated(dev))
    del model, base, adapters, state, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lcrec_lora_resume(dev, seed) -> dict:
    """(b) lcrec_trainer.train with use_lora=True at tp=1 through
    config/lcrec/synthetic.gin, 2 layers at the Qwen2.5-1.5B widths and
    vocab: uninterrupted, killed by SIGTERM mid-epoch and resumed: held bit
    for bit; B3 and B4 dx once a resumed step, B4 dW never."""
    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.trainers import lcrec_trainer

    c = RESUME_LCREC
    work = HERE / "build" / "lora_resume"
    shutil.rmtree(work, ignore_errors=True)
    run = gin_train_run("config/lcrec/synthetic.gin", lcrec_resume_bindings(dev, seed, (
        "train.use_lora = True", f"train.lora_rank = {LORA['rank']}",
        f"train.lora_alpha = {LORA['alpha']}")), work, lcrec_trainer.train, qwen_vocab)

    total = c["epochs"] * c["steps_per_epoch"]
    a = run("a")
    b = run("b", chaos.ChaosPlan(kill_at_step=c["kill"]))
    check(b["out"] == ({}, {}) and b["steps"] == [c["kill"]],
          ("the preempted LoRA run", b["out"], b["steps"]))
    resumed = run("b", resume_from_checkpoint=True)
    check(a["steps"] == resumed["steps"][-1:] == [total], ("final points", a["steps"],
                                                           resumed["steps"]))
    n = total - c["kill"]
    for name, count in resumed["launches"].items():
        want = n * LORA_LAUNCHES_PER_STEP.get(name, 0)
        check(count == want, f"resumed LoRA run: {name} {count}, want {want}")
    check(resumed["out"] == a["out"], ("the resumed run's metrics", resumed["out"], a["out"]))
    parity, _, nbytes = resume_parity("LCRec LoRA", work / "a", work / "b")
    _, point, _ = final_point(work / "a")
    model_keys = [k for k in point if k.startswith("state/model/")]
    check(all(k.startswith(("state/model/a.", "state/model/b.")) for k in model_keys),
          ("the LoRA resume point holds", model_keys[:5]))
    check((work / "a" / "final_model").exists(), "no final_model")
    losses = run_log(work / "a")[0]
    out = dict(steps=total, kill_at_step=c["kill"], parity=parity, resume_point_bytes=nbytes,
               launches_resumed=resumed["launches"], loss_first=losses[1],
               loss_last=losses[total], valid=a["out"][0],
               run_s={k: r["wall_s"] for k, r in (("a", a), ("b", b), ("resumed", resumed))})
    shutil.rmtree(work, ignore_errors=True)
    return out


def lcrec_lora_phase(dev, seed) -> dict:
    """Phase 22: LoRA SFT of LCRec at tp=1: (a) the step at full width (B3 and
    B4 dx once a step, B4 dW never; the base bit-unchanged); (b) the
    trainer's entry point killed and resumed at 2 layers."""
    t0 = time.perf_counter()
    steps = lcrec_lora_steps(dev, seed)
    resume = lcrec_lora_resume(dev, seed)
    return emit("lcrec_lora", card=torch.cuda.get_device_name(dev),
                wall_s=time.perf_counter() - t0,
                config=(f"QwenConfig() widths, {LCREC['layers']} layers, bf16, tied head, "
                        f"{LCREC['codebooks']} x {LCREC['codebook_size']} codebook tokens, "
                        f"batch {LCREC['batch']} x {LCREC['seq']}; LoRA rank {LORA['rank']}, "
                        f"alpha {LORA['alpha']} on {', '.join(LORA['targets'])}; AdamW "
                        f"{LORA['lr']}, random weights from --seed"),
                reduced=dict(steps=f"{LORA['warm']} warm + {LORA['steps']} timed on one batch",
                             trainer=f"{RESUME_LCREC['layers']} of 28 layers, batch "
                                     f"{RESUME_LCREC['batch']} x {RESUME_LCREC['seq']}, "
                                     f"{RESUME_LCREC['epochs']} epochs of "
                                     f"{RESUME_LCREC['steps_per_epoch']} steps"),
                steps=steps, resume=resume, launches=steps["launches"])


# ---- phase 23: the continuous pipeline ------------------------------------------

# scripts/check_pipeline.py's scenario at TIGER_AMAZON widths over the serve
# phase's catalog. A record is one of the trainer's unpacked rows, int32: the
# user id, MAX_ITEMS catalog items' sem-ids (the history) and one more item's
# (the target), items drawn from ``(seed, records_seed)``. A chunk is
# ``chunk_steps`` steps of TIGER_TRAIN["batch"] rows; the step is the
# tiger_train phase's (bf16, dropout 0.1, AdamW 1e-4 on the cosine warm-up of
# 100 steps over TIGER_TRAIN["epochs"] chunks, weight decay 0.035, clip 1.0)
# on those rows. A resume point every ``commit_every`` steps (the script's 1,
# cut to halve the resume-point writes: 200 MB each at these widths); the
# kill lands on one. The rollout as the script's: two fp32 paged replicas at
# the serve phase's pools, a prober, the drift bound 1e6 (a trained step
# moves the vet scores by far less; a x60 tree by orders more).
PIPELINE = dict(chunk_steps=4, chunks=3, commit_every=2, records_seed=7,
                garbage_scale=60.0, vet_requests=8, dense_requests=32,
                worker_timeout_s=300, wait_s=120.0)
PIPELINE_CHUNK = PIPELINE["chunk_steps"] * TIGER_TRAIN["batch"]
#: Dense against paged answers: sem-ids equal (beams within the bound of
#: each other may trade ranks: the tuple rule of int8_answers_agree), scores
#: within 1e-4 / T (TIGER decodes at T 0.2, COBRA at 1).
DENSE_SCORE_TOL = 1e-4
#: The resumed trainer against the uninterrupted one, as check_pipeline.py
#: holds them: losses and published parameters.
PIPELINE_PARITY_TOL = 1e-5


def pipeline_records(seed, n) -> list:
    D = TIGER_AMAZON["sem_id_dim"]
    catalog = tiger_catalog(np.random.default_rng(seed))  # the serve phase's
    rng = np.random.default_rng((seed, PIPELINE["records_seed"]))
    users = rng.integers(0, TIGER_AMAZON["num_user_embeddings"], n)
    items = rng.integers(0, CATALOG_ITEMS, (n, MAX_ITEMS + 1))
    rows = np.concatenate([users[:, None], catalog[items].reshape(n, (MAX_ITEMS + 1) * D)],
                          axis=1).astype(np.int32)
    return [r.tobytes() for r in rows]


def pipeline_arrays(payloads, epoch) -> dict:
    """A chunk's records as the TIGER loss's unpacked rows."""
    del epoch  # the loop shuffles by (seed, epoch)
    D = TIGER_AMAZON["sem_id_dim"]
    L = MAX_ITEMS * D
    rows = np.stack([np.frombuffer(p, np.int32) for p in payloads])
    B = len(rows)
    return {"user_ids": rows[:, 0].copy(), "item_input_ids": rows[:, 1:1 + L].copy(),
            "token_type_ids": np.tile(np.arange(D, dtype=np.int32), (B, MAX_ITEMS)),
            "target_ids": rows[:, 1 + L:].copy(), "seq_mask": np.ones((B, L), np.int32)}


def pipeline_trainer(dev, seed, work, name, handle_signals=True):
    """The StreamTrainer every stage builds (the oracle in this process,
    the killed and resumed ones in workers): one definition, or the parity
    means nothing. Trains into ``work/name``, publishes into
    ``work/name_publish``."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
    from genrec_tpu_torch.trainers.stream_trainer import StreamTrainer
    from genrec_tpu_torch.trainers.tiger_trainer import make_loss_fn

    t = TIGER_TRAIN
    model = Tiger(**TIGER_AMAZON, dropout=t["dropout"], dtype=torch.bfloat16, device=dev,
                  seed=seed)
    optimizer = Adam(cosine_schedule_with_warmup(t["lr"], t["warmup"],
                                                 t["epochs"] * PIPELINE["chunk_steps"]),
                     weight_decay=t["wd"])
    step_fn = make_train_step(make_loss_fn(TIGER_AMAZON["sem_id_dim"], False), optimizer,
                              clip_norm=1.0)
    return StreamTrainer(
        log_dir=str(work / "log"), save_dir_root=str(work / name),
        state=TrainState.create(model, optimizer, seed), step_fn=step_fn,
        make_arrays=pipeline_arrays, chunk_records=PIPELINE_CHUNK, rows_per_step=t["batch"],
        row_len=1 + MAX_ITEMS * TIGER_AMAZON["sem_id_dim"], seed=seed,
        publish_dir=str(work / f"{name}_publish"), commit_every_steps=PIPELINE["commit_every"],
        handle_signals=handle_signals, logger=logging.getLogger(f"pipeline.{name}"))


def pipeline_worker(mode, cfg_json) -> int:
    """``chip_smoke.py --pipeline-worker append|train CFG``: a stage of the
    pipeline phase in a process of its own, so a chaos plan can SIGKILL it.
    Prints ``WORKER {json}`` on stderr when it returns."""
    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.data.stream_log import StreamLogWriter

    cfg = json.loads(cfg_json)
    work = Path(cfg["work"])
    if mode == "append":
        records = pipeline_records(cfg["seed"], cfg["n"])[:cfg["upto"]]
        plan = (chaos.ChaosPlan(die_in_append_at_record=cfg["die_at"])
                if cfg.get("die_at") is not None else None)
        with StreamLogWriter(str(work / "log")) as w:
            start = w.records_committed
            with chaos.inject(plan) if plan else contextlib.nullcontext():
                w.append_many(records[start:])
            out = {"resumed_from": start, "committed": w.records_committed}
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        plan = (chaos.ChaosPlan(die_in_save_at_step=cfg["die_in_save"])
                if cfg.get("die_in_save") is not None else None)
        trainer = pipeline_trainer(torch.device(cfg["device"]), cfg["seed"], work, "train")
        with chaos.inject(plan) if plan else contextlib.nullcontext():
            out = trainer.run(max_chunks=cfg["max_chunks"], idle_timeout_s=5.0)
    print("WORKER " + json.dumps(out), file=sys.stderr, flush=True)
    return 0


def pipeline_worker_cmd(mode, cfg) -> list:
    return [sys.executable, str(HERE / "chip_smoke.py"), "--pipeline-worker", mode,
            json.dumps(cfg)]


def pipeline_run_worker(mode, cfg, expect_sigkill=False):
    """Run one worker stage to its end; returns (its summary or None, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(pipeline_worker_cmd(mode, cfg), capture_output=True, text=True,
                          timeout=PIPELINE["worker_timeout_s"], cwd=HERE)
    seconds = time.perf_counter() - t0
    if expect_sigkill:
        check(proc.returncode == -9, (f"{mode} worker survived its chaos kill", proc.returncode,
                                      proc.stderr[-3000:]))
        return None, seconds
    check(proc.returncode == 0, (f"{mode} worker failed", proc.returncode, proc.stderr[-3000:]))
    line = [l for l in proc.stderr.splitlines() if l.startswith("WORKER ")][-1]
    return json.loads(line[len("WORKER "):]), seconds


def pipeline_losses(save_dir, allow_replay=False) -> tuple[dict, float]:
    """Step -> loss from metrics.jsonl, and the largest difference of a
    replayed step (a SIGKILL'd run replays the steps after its last commit)."""
    out, replay_err = {}, 0.0
    with open(Path(save_dir) / "metrics.jsonl") as fh:
        for line in fh:
            rec = json.loads(line)
            if "train/loss" in rec and "global_step" in rec:
                step = int(rec["global_step"])
                if step in out:
                    check(allow_replay, f"step {step} logged twice")
                    replay_err = max(replay_err, abs(out[step] - rec["train/loss"]))
                out[step] = rec["train/loss"]
    return out, replay_err


def dense_paged_agree(what, dense, paged, tol) -> dict:
    """Each request's dense answer against its paged one (both served
    alone, at the same bucket): sem-ids and items equal and scores within
    ``tol``; where two beams within ``tol`` of each other trade ranks, the
    tuple rule of `int8_answers_agree` holds them instead (counted)."""
    errs, swapped = [], 0
    for i, (a, b) in enumerate(zip(dense, paged)):
        check(a.bucket == b.bucket, (what, i, a.bucket, b.bucket))
        if (a.sem_ids == b.sem_ids).all():
            check((a.items == b.items).all(), (what, i, a.items, b.items))
            errs.append(float(np.abs(a.scores - b.scores).max()))
        else:
            err, moved = int8_answers_agree(b.sem_ids, b.scores, a.sem_ids, a.scores, tol,
                                            beams=len(b.sem_ids))
            errs.append(err)
            swapped += moved > 0
        check(errs[-1] <= tol, (what, i, errs[-1], tol))
        check(bool((a.items >= 0).all()), (what, i, "an answer outside the catalog"))
    return dict(requests=len(dense), max_abs_score_diff=max(errs), tol=tol,
                requests_with_rank_swaps=swapped)


def dense_route_check(dev, seed) -> dict:
    """TIGER and COBRA, each served by a paged engine and a ``paged=False``
    one, every request alone: the dense answers equal the paged ones."""
    from genrec_tpu_torch.models.cobra import Cobra
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import CobraGenerativeHead, TigerGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig
    from genrec_tpu_torch.serving.types import Request

    rng = np.random.default_rng(seed + 3)
    ladder = BucketLadder((1, 2, 4, 8, 16), (4, 8, 16, MAX_ITEMS))
    n = PIPELINE["dense_requests"]

    def both_routes(head, cfg, reqs):
        out = {}
        for paged in (True, False):
            eng = ServingEngine([head], device=dev, ladder=ladder, max_batch=16,
                                max_wait_ms=2.0, paged=paged, paged_config=cfg,
                                prefix_cache=False, handle_signals=False).start()
            t0 = time.perf_counter()
            out[paged] = [eng.serve(r, timeout=300) for r in reqs]
            out[f"s_{paged}"] = time.perf_counter() - t0
            stats = eng.stop()
            check(stats["completed"] == len(reqs), stats["completed"])
            check((stats["decode_steps"] > 0) == paged, ("decode steps", paged, stats))
        return out

    tiger = Tiger(**TIGER_AMAZON, device=dev, seed=seed).eval()
    head = TigerGenerativeHead(tiger, item_sem_ids=tiger_catalog(np.random.default_rng(seed)),
                               top_k=BEAMS)
    got = both_routes(head, PagedConfig(**PAGED), make_requests(rng, n, CATALOG_ITEMS))
    tiger_line = dense_paged_agree("TIGER dense vs paged", got[False], got[True],
                                   DENSE_SCORE_TOL / TIGER_DECODE["temperature"])
    tiger_line.update(dense_s=got["s_False"], paged_s=got["s_True"])
    del tiger, head
    catalog, text = cobra_catalog(seed)
    cobra = Cobra(**COBRA_AMAZON, device=dev, seed=seed).eval()
    head = CobraGenerativeHead(cobra, item_sem_ids=catalog, item_text_tokens=text,
                               top_k=COBRA_BEAMS)
    reqs = [Request(head="cobra", history=rng.integers(0, CATALOG_ITEMS, int(k)))
            for k in rng.integers(1, MAX_ITEMS + 1, n)]
    got = both_routes(head, PagedConfig(**COBRA_PAGED), reqs)
    cobra_line = dense_paged_agree("COBRA dense vs paged", got[False], got[True],
                                   DENSE_SCORE_TOL)
    cobra_line.update(dense_s=got["s_False"], paged_s=got["s_True"])
    return {"tiger": tiger_line, "cobra": cobra_line}


class _Replicas:
    """check_pipeline.py's MiniRouter: replica ids -> engines."""

    def __init__(self, engines):
        self._eng = engines

    def replica_ids(self):
        return list(self._eng)

    def engine(self, rid):
        return self._eng[rid]


def pipeline_phase(dev, seed) -> dict:
    """scripts/check_pipeline.py's scenario at TIGER_AMAZON widths on the
    card: append (SIGKILL'd mid-stream, rerun), stream-train (an oracle in
    this process; a worker SIGKILL'd mid-commit, rerun), guarded rollout
    onto two paged replicas (promote the last step, veto a x60 tree, a live
    chunk appended, trained and promoted) under a prober; then the dense
    route against the paged one for TIGER and COBRA. B1 launches counted
    over the rollout."""
    import threading

    from genrec_tpu_torch.core.checkpoint import COMMIT_MARKER, CheckpointManager
    from genrec_tpu_torch.data.stream_log import StreamLogReader, StreamLogWriter
    from genrec_tpu_torch.kernels.paged_attention import paged_attention_stats_cuda
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.obs.flight_recorder import get_flight_recorder
    from genrec_tpu_torch.serving.buckets import BucketLadder
    from genrec_tpu_torch.serving.engine import ServingEngine
    from genrec_tpu_torch.serving.heads import TigerGenerativeHead
    from genrec_tpu_torch.serving.kv_pool import PagedConfig
    from genrec_tpu_torch.serving.rollout import RolloutConfig, RolloutController
    from genrec_tpu_torch.serving.types import Request

    t_phase = time.perf_counter()
    work = HERE / "build" / "pipeline"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    steps_per_chunk, n_chunks = PIPELINE["chunk_steps"], PIPELINE["chunks"]
    n_records = n_chunks * PIPELINE_CHUNK
    final_step = n_chunks * steps_per_chunk
    cfg = {"work": str(work), "seed": seed, "device": str(dev)}
    seconds = {}

    # -- append, SIGKILL'd mid-stream, rerun --------------------------------------
    reference = pipeline_records(seed, n_records + PIPELINE_CHUNK)  # the live chunk's too
    die_at = n_records // 2
    append = {**cfg, "n": len(reference), "upto": n_records}
    _, seconds["append_killed"] = pipeline_run_worker("append", {**append, "die_at": die_at},
                                                      expect_sigkill=True)
    ap, seconds["append_rerun"] = pipeline_run_worker("append", append)
    got = StreamLogReader(str(work / "log")).read()
    lost = len(set(reference[:n_records]) - set(got))
    dup = len(got) - len(set(got))
    check(ap["resumed_from"] == die_at, ("appender resumed at", ap, die_at))
    check(got == reference[:n_records] and lost == 0 and dup == 0,
          ("recovered log != seeded reference", len(got), lost, dup))

    # -- the oracle: uninterrupted, in this process, twice -----------------------
    # (the second run measures what the card's own run-to-run order of
    # summation moves, which a kill and resume cannot be held below)
    for name in ("oracle", "oracle_again"):
        t0 = time.perf_counter()
        osum = pipeline_trainer(dev, seed, work, name, handle_signals=False).run(
            max_chunks=n_chunks, idle_timeout_s=5.0)
        seconds[name + "_train"] = time.perf_counter() - t0
        check(osum["global_step"] == final_step, (name, "steps", osum))
    oracle_losses, _ = pipeline_losses(work / "oracle")
    init_sd = Tiger(**TIGER_AMAZON, device="cpu", seed=seed).state_dict()

    # -- the trainer, SIGKILL'd mid-commit, rerun -------------------------------
    die_in_save = final_step // 2
    check(die_in_save % PIPELINE["commit_every"] == 0, "the kill must land on a commit")
    _, seconds["train_killed"] = pipeline_run_worker(
        "train", {**cfg, "max_chunks": n_chunks, "die_in_save": die_in_save},
        expect_sigkill=True)
    tsum, seconds["train_rerun"] = pipeline_run_worker("train", {**cfg, "max_chunks": n_chunks})
    check(tsum["global_step"] == final_step, ("resumed trainer steps", tsum))
    losses, replay_err = pipeline_losses(work / "train", allow_replay=True)
    check(sorted(losses) == sorted(oracle_losses) == list(range(1, final_step + 1)),
          ("trained step sets differ", sorted(losses), sorted(oracle_losses)))
    loss_err = max(replay_err, max(abs(oracle_losses[s] - losses[s]) for s in oracle_losses))
    published = [c * steps_per_chunk for c in range(1, n_chunks + 1)]
    pub, opub = CheckpointManager(str(work / "train_publish")), CheckpointManager(
        str(work / "oracle_publish"))
    check(pub.all_steps() == opub.all_steps() == published, (pub.all_steps(), opub.all_steps()))
    again = CheckpointManager(str(work / "oracle_again_publish"))
    again_losses, _ = pipeline_losses(work / "oracle_again")

    def tree_diff(mgr_a, mgr_b):
        """Largest difference over the published trees, and the parameters
        that differ at all."""
        err, differ = 0.0, set()
        for step in published:
            a = mgr_a.validate_and_restore(init_sd, step)
            b = mgr_b.validate_and_restore(init_sd, step)
            for k in init_sd:
                err = max(err, float((a[k].double() - b[k].double()).abs().max()))
                if not torch.equal(a[k], b[k]):
                    differ.add(k)
        return err, sorted(differ)

    param_err, resumed_differ = tree_diff(pub, opub)
    rerun_err, rerun_differ = tree_diff(again, opub)
    rerun_loss_err = max(abs(oracle_losses[s] - again_losses[s]) for s in oracle_losses)
    check(loss_err <= PIPELINE_PARITY_TOL and param_err <= PIPELINE_PARITY_TOL,
          ("resume drifted", loss_err, param_err))
    # The TIGER step sums the bias grid's gradient in a fixed order
    # (table_grad): two uninterrupted runs publish the same bits.
    check(not rerun_differ and rerun_loss_err == 0.0,
          ("the two oracle runs published different trees", rerun_err, rerun_differ,
           rerun_loss_err))

    # -- guarded rollout onto two paged replicas ---------------------------------
    catalog = tiger_catalog(np.random.default_rng(seed))
    ladder = BucketLadder((1, 2, 4, 8, 16), (4, 8, 16, MAX_ITEMS))

    def replica(rid):
        model = Tiger(**TIGER_AMAZON, device=dev, seed=seed).eval()
        return ServingEngine([TigerGenerativeHead(model, item_sem_ids=catalog, top_k=BEAMS)],
                             device=dev, ladder=ladder, max_batch=16, max_wait_ms=2.0,
                             paged_config=PagedConfig(**PAGED), handle_signals=False,
                             replica_id=rid).start()

    rids = ("r0", "r1")
    router = _Replicas({rid: replica(rid) for rid in rids})
    rng = np.random.default_rng(seed + 2)
    for rid in rids:  # first calls: cuBLAS handles, allocator
        serve(router.engine(rid), make_requests(rng, 16, CATALOG_ITEMS))
    probe_reqs = make_requests(rng, 4, CATALOG_ITEMS)
    served, probe_errors = [], []
    stop_probe = threading.Event()

    def probe_loop():
        i = 0
        while not stop_probe.is_set():
            for rid in rids:
                try:
                    r = router.engine(rid).submit(probe_reqs[i % len(probe_reqs)]).result(60)
                    served.append((rid, r.params_step, r.replica_id))
                except Exception as e:  # noqa: BLE001 — counted, and checked below
                    probe_errors.append(f"{rid}: {type(e).__name__}: {e}")
            i += 1
            stop_probe.wait(0.02)

    flight = get_flight_recorder()
    t_events = time.time()  # the rollout's flight events are those recorded from here on
    reset_counters()
    t_rollout = time.perf_counter()
    prober = threading.Thread(target=probe_loop, daemon=True)
    prober.start()
    vet_head = TigerGenerativeHead(Tiger(**TIGER_AMAZON, device=dev, seed=seed).eval(),
                                   item_sem_ids=catalog, top_k=BEAMS)
    ctrl = RolloutController(
        router, vet_head, str(work / "train_publish"), params_like=router.engine("r0").params(),
        vet_requests=make_requests(rng, PIPELINE["vet_requests"], CATALOG_ITEMS),
        state_path=str(work / "rollout_state.json"), initial_step=0,
        config=RolloutConfig(poll_secs=0.1, canary_window_s=0.3, canary_min_responses=2,
                             vet_max_score_drift=1e6)).start()

    def wait_for(pred, what):
        deadline = time.monotonic() + PIPELINE["wait_s"]
        while not pred():
            check(ctrl.alive and time.monotonic() < deadline,
                  (f"waiting for {what}", ctrl.stats(), probe_errors[-3:]))
            time.sleep(0.05)

    wait_for(lambda: ctrl.stats()["last_good_step"] == final_step, f"promote of {final_step}")
    seconds["first_promote"] = time.perf_counter() - t_rollout
    check(all(router.engine(r).params_step == final_step for r in rids),
          "fleet not on the promoted step")
    final_tree = pub.validate_and_restore(init_sd, final_step)
    weights = {rid: {k: v.detach().clone() for k, v in router.engine(rid).params().items()}
               for rid in rids}
    for rid in rids:
        check(all(torch.equal(weights[rid][k].cpu(), final_tree[k]) for k in init_sd),
              (rid, "serves other weights than the promoted step's"))
    # A x60 tree: finite, but its vet scores drift far past the bound.
    garbage_step = final_step + 1
    pub.save(garbage_step, {k: v * PIPELINE["garbage_scale"] if v.is_floating_point() else v
                            for k, v in init_sd.items()})
    wait_for(lambda: ctrl.stats()["vetoes"] >= 1, "the garbage veto")
    s = ctrl.stats()
    check(s["last_good_step"] == final_step and s["quarantined_steps"] == 1,
          ("garbage moved the controller", s))
    unchanged = all(router.engine(rid).params_step == final_step and all(
        torch.equal(v, weights[rid][k]) for k, v in router.engine(rid).params().items())
        for rid in rids)
    check(unchanged, "a replica's weights moved on the garbage publish")
    veto = flight.events("rollout_vetoed")[-1:]
    # Live round: one more chunk appended, trained in a worker, promoted.
    with StreamLogWriter(str(work / "log")) as w:
        w.append_many(reference[n_records:])
    live, seconds["train_live"] = pipeline_run_worker("train", {**cfg, "max_chunks": n_chunks + 1})
    live_step = final_step + steps_per_chunk
    check(live["global_step"] == live_step and live["published_steps"] == [live_step],
          ("live round", live))
    t_pub = time.monotonic()
    wait_for(lambda: ctrl.stats()["last_good_step"] == live_step, f"live promote of {live_step}")
    first_serve_s = None
    while first_serve_s is None and time.monotonic() - t_pub < PIPELINE["wait_s"]:
        r = router.engine("r0").serve(Request(head="tiger", history=np.array([6, 7])),
                                      timeout=60)
        if r.params_step == live_step:
            first_serve_s = time.monotonic() - t_pub
    check(first_serve_s is not None, "the live step never reached r0's answers")
    stop_probe.set()
    prober.join(timeout=120)
    stats = ctrl.stop()
    pages = slots = 0
    for rid in rids:
        eng = router.engine(rid)
        st = eng.stop()
        pool = eng.runner("tiger").pool
        pages += pool.allocator.pages_in_use
        slots += sum(g.get("slots_active", 0) for g in (st.get("kv_pool") or {}).values())
    counts = read_counters()
    seconds["rollout"] = time.perf_counter() - t_rollout
    allowed = {None, 0, live_step, *published}
    unvetted = [st for _, st, _ in served if st not in allowed]
    check(not probe_errors, ("prober errors", probe_errors[:3]))
    check(len(served) > 0 and not unvetted, ("unvetted params served", unvetted[:5]))
    check(all(r == rid for rid, _, r in served), "a response named another replica")
    check(stats["promotions"] == 2 and stats["vetoes"] == 1 and stats["rollbacks"] == 0
          and stats["last_good_step"] == live_step, ("rollout stats", stats))
    check(0.0 < stats["freshness_s"] < PIPELINE["wait_s"], ("freshness", stats))
    check(pages == 0 and slots == 0, ("pools not clean", pages, slots))
    b1 = counts["paged_attention_stats"]
    check(b1 > 0 and b1 == paged_attention_stats_cuda.launches, ("B1 launches", counts))
    check(all(v == 0 for k, v in counts.items()
              if k not in ("paged_attention_stats", "table_grad")),
          ("another kernel launched", counts))
    events = [e for e in flight.events() if e["t"] >= t_events]
    engine_events = [e for e in events if e.get("component") == "engine"]

    def event_t(kind, **match):
        ts = [e["t"] for e in events
              if e["kind"] == kind and all(e.get(k) == v for k, v in match.items())]
        check(ts, (kind, match, "not in the flight recorder"))
        return ts[0]

    # Where the live step's freshness went, from the commit marker's mtime
    # and the flight events of the controller and the replicas.
    marks = [(work / "train_publish" / str(live_step) / COMMIT_MARKER).stat().st_mtime,
             event_t("integrity_ladder", step=live_step, verdict="valid"),
             event_t("rollout_staged", step=live_step),
             event_t("hot_reload_swapped", step=live_step, replica_id=rids[-1]),
             event_t("hot_reload_swapped", step=live_step, replica_id=rids[0]),
             event_t("rollout_promoted", step=live_step)]
    freshness_split = dict(zip(("poll_and_restore", "vet", "canary_swap", "canary_window",
                                "promote"), np.diff(marks).tolist()))
    check(engine_events and all(e.get("replica_id") in rids for e in engine_events),
          "an engine flight event without its replica")
    del router, ctrl, vet_head
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dense = dense_route_check(dev, seed)
    seconds["dense_route"] = time.perf_counter() - t0
    return emit(
        "pipeline", card=torch.cuda.get_device_name(dev), wall_s=time.perf_counter() - t_phase,
        config=(f"scripts/check_pipeline.py's scenario at config/tiger/amazon/tiger.gin widths "
                f"over the serve phase's {CATALOG_ITEMS:,}-item catalog: records of "
                f"{MAX_ITEMS} x 3 input and 3 target sem-ids, chunks of {steps_per_chunk} steps "
                f"of {TIGER_TRAIN['batch']} rows, the tiger_train step (bf16, dropout 0.1) on "
                f"unpacked rows; two fp32 paged replicas ({PAGED})"),
        reduced=dict(chunks=f"{n_chunks} + 1 live", commit_every=PIPELINE["commit_every"]),
        records_appended=len(got), records_lost=lost, records_duplicated=dup,
        appender_resumed_from=ap["resumed_from"], sigkills=2,
        steps_trained=tsum["global_step"], published_steps=published + [live_step],
        loss_parity_max_err=loss_err, param_parity_max_err=param_err,
        published_trees_bit_equal=not resumed_differ, params_differing=resumed_differ,
        oracle_rerun=dict(loss_max_err=rerun_loss_err, param_max_err=rerun_err,
                          params_differing=rerun_differ),
        losses={s: oracle_losses[s] for s in (1, final_step)},
        promotions=stats["promotions"], vetoes=stats["vetoes"], rollbacks=stats["rollbacks"],
        quarantined_steps=stats["quarantined_steps"], last_good_step=stats["last_good_step"],
        garbage_vet=({k: veto[0].get(k) for k in ("finite", "trie_valid", "drift")}
                     if veto else None),
        replicas_bit_unchanged=bool(unchanged), responses_served=len(served),
        unvetted_serves=len(unvetted), freshness_s=stats["freshness_s"],
        freshness_split_s=freshness_split,
        first_serve_s=first_serve_s, pages_in_use_final=pages, slots_active_final=slots,
        paged_attention_launches=b1, dense_route=dense, seconds=seconds,
    )


# ---- model parallelism on one axis: TIGER tp=2, Qwen tp=4, MoE ep=4 ----------

# tiger_tp: tiger.gin widths at tp=2, gloo ranks on the one card.
# (a) 5 fp32 steps at dropout 0 on the Beauty set's packed rows against
# tp=1; (b) tiger_trainer.train(tensor_parallel=2) through tiger.gin, bf16,
# dropout 0.1; (c) the same run killed on rank 1 and resumed, bit for bit.
# The trainer runs use batch 128 and one epoch (the file's 256 gives too few
# steps on the synthetic set for a kill between two of the loop's polls;
# two epochs took the phase to 117 s; batch 64 gave way to 128 to make room
# for the dp phase).
TIGER_TP = dict(tp=2, parity_steps=5, parity_lr=1e-3, batch=128, epochs=1, poll=8)
TIGER_TP_TIMEOUT_S = 600


@functools.cache
def tiger_tp_batches(seed) -> list:
    """(a)'s batches: the first TIGER_TP["parity_steps"] packed batches of
    the Beauty set at TIGER_TRAIN["batch"] rows (numpy, shipped to the
    ranks)."""
    from genrec_tpu_torch.data.batching import batch_iterator, pack_examples

    arrays, _ = pack_examples(tiger_beauty_data(seed).train_examples(),
                              row_len=1 + MAX_ITEMS * TIGER_AMAZON["sem_id_dim"],
                              segment_keys=("target_ids",),
                              max_segments=TIGER_TRAIN["max_segments"], seed=(seed, 0))
    it = batch_iterator(arrays, TIGER_TRAIN["batch"], drop_last=True)
    return [b for b, _ in itertools.islice(it, TIGER_TP["parity_steps"])]


def tiger_tp_parity(dev, seed, batches, group=None, data_group=None) -> list:
    """fp32 steps at dropout 0 (the trainer's packed loss, AdamW, clip 1.0,
    the norm over the group): the losses. Every tp starts from tp = 1's
    weights (Tiger draws the full model and keeps its slice). Under a
    ``data_group`` each rank steps on its rows of every batch."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.tiger import Tiger
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
    from genrec_tpu_torch.parallel.mesh import shard_batch
    from genrec_tpu_torch.trainers.tiger_trainer import make_loss_fn

    tp = 1 if group is None else group.size
    model = Tiger(**TIGER_AMAZON, dropout=0.0, dtype=torch.float32, device=dev, seed=seed,
                  pad_vocab_to=tp, group=group)
    opt = Adam(cosine_schedule_with_warmup(TIGER_TP["parity_lr"], 1, len(batches)),
               weight_decay=TIGER_TRAIN["wd"])
    step = make_train_step(make_loss_fn(TIGER_AMAZON["sem_id_dim"], True), opt, clip_norm=1.0,
                           group=group, data_group=data_group)
    state = TrainState.create(model, opt, seed)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in shard_batch(b, data_group).items()})
        losses.append(float(m["loss"]))
    del model, state
    torch.cuda.empty_cache()
    return losses


def tiger_tp_rank(group, seed, batches) -> dict:
    """One rank of tiger_tp: (a) the parity steps, (b) the trainer run a
    with its step times and collectives, (c) run b killed on rank 1 and
    resumed, held to a bit for bit."""
    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.trainers import tiger_trainer

    torch.backends.cuda.matmul.allow_tf32 = False  # as in main(): a fresh process
    out = {"parity_losses": tiger_tp_parity(group.device, seed, batches, group)}
    work = HERE / "build" / "tiger_tp"
    if group.rank == 0:
        shutil.rmtree(work, ignore_errors=True)
    from genrec_tpu_torch.parallel.mesh import barrier

    barrier("tiger_tp work", group)
    bindings = ('train.dataset = "synthetic"', "train.wandb_logging = False",
                "train.do_eval = True", f"train.epochs = {TIGER_TP['epochs']}",
                f"train.batch_size = {TIGER_TP['batch']}", "train.save_every_epoch = 1",
                "train.wandb_log_interval = 1", f"train.seed = {seed}",
                f'train.device = "{group.device}"', "train.tensor_parallel = 2",
                *TIGER_TRAINER_EXTRA)
    run = gin_train_run("config/tiger/amazon/tiger.gin", bindings, work, tiger_trainer.train,
                        rank=group.rank)
    per_step = []  # (collectives, bytes) of each train step of run a
    make_step = tiger_trainer.make_train_step

    def counting(*args, **kw):
        step = make_step(*args, **kw)

        def counted(state, batch):
            c0, b0 = group.calls, group.bytes
            out = step(state, batch)
            per_step.append((group.calls - c0, group.bytes - b0))
            return out

        return counted

    tiger_trainer.make_train_step = counting
    try:
        with step_events() as events:
            out["a"] = run("a")
            stats = step_stats(events)
    finally:
        tiger_trainer.make_train_step = make_step
    out["a"]["collectives_per_step"] = float(np.median([c for c, _ in per_step]))
    out["a"]["collective_bytes_per_step"] = float(np.median([b for _, b in per_step]))
    out["a"]["step_stats"] = stats
    n = stats["steps"]
    kill = n // 2 + 1
    out["kill"] = kill
    out["b"] = run("b", chaos.ChaosPlan(kill_at_step=kill, only_process=1))
    out["resumed"] = run("b", resume_from_checkpoint=True)
    out["parity"], out["final_step"], _ = resume_parity(f"TIGER tp=2 rank {group.rank}",
                                                        work / "a", work / "b",
                                                        rank=group.rank)
    if group.rank == 0:
        out["losses"] = run_log(work / "a")[0]
    return out


def tiger_tp_phase(dev, seed, rank_fn=None) -> dict:
    """TIGER at tiger.gin widths under tensor parallelism (A29), tp=2 over
    gloo on the one card: (a) parity with tp = 1 here, (b) the trainer, (c)
    its resume. No TPU kernel launches; the table-lookup gradient
    (table_grad) launches once a layer a step."""
    batches = tiger_tp_batches(seed)

    def reference():  # while the ranks start
        t0 = time.perf_counter()
        tp1 = tiger_tp_parity(dev, seed, batches)
        tp1_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return tp1, tp1_s

    (tp1, tp1_s), ranks, spawn_s = spawn_beside(
        rank_fn or tiger_tp_rank, TIGER_TP["tp"], (seed, batches), reference, device=dev.type,
        timeout_s=TIGER_TP_TIMEOUT_S)
    r0, r1 = ranks
    tp2 = r0["parity_losses"]
    check(r1["parity_losses"] == tp2, ("TIGER ranks disagree on the parity losses", tp2,
                                       r1["parity_losses"]))
    rel = float(np.max(np.abs(np.asarray(tp2) - tp1) / np.abs(tp1)))
    check(np.isfinite(tp2).all() and rel <= LCREC_PARITY_RTOL,
          f"TIGER tp=1 vs tp=2 losses: max relative diff {rel} > {LCREC_PARITY_RTOL}")
    layers = TIGER_AMAZON["n_layers"]  # every encoder and decoder self-attention's bias
    for rank, r in enumerate(ranks):
        a, b, b2 = r["a"], r["b"], r["resumed"]
        check(a["out"] == r0["a"]["out"], ("TIGER ranks report other metrics", a["out"],
                                           r0["a"]["out"]))
        valid, test = a["out"]
        check(all(np.isfinite(v) for v in (*valid.values(), *test.values())), a["out"])
        check(b["out"] == ({}, {}), (f"rank {rank}: the preempted run returned", b["out"]))
        save_at = -(-r["kill"] // TIGER_TP["poll"]) * TIGER_TP["poll"]
        check(save_at < a["steps"][-1] and b["steps"][-1:] == [save_at],
              (f"TIGER rank {rank} preempted at", b["steps"], "want", save_at))
        check(r["parity"]["bit_equal"], (f"TIGER tp=2 rank {rank} resume", r["parity"]))
        for run in (a, b2):
            for name, count in run["launches"].items():
                check((count > 0) == (name == "table_grad"),
                      f"TIGER tp=2 rank {rank}: {name} launched {count} times")
        steps = a["step_stats"]["steps"]
        check(a["launches"]["table_grad"] >= steps * layers,
              ("table_grad launches", a["launches"]["table_grad"], steps))
    losses = [r0["losses"][g] for g in sorted(r0["losses"])]
    check(np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3]),
          ("TIGER tp=2 trainer loss did not fall", losses))
    a = r0["a"]
    return emit(
        "tiger_tp", tp=TIGER_TP["tp"], backend="gloo (two ranks on one card)",
        config=("config/tiger/amazon/tiger.gin widths (attn 384, 6 x 64 heads, 4 + 4 layers, "
                "256 x 3 codes, FFN 1,024), vocab padded to 770 (pad_vocab_to=tp)"),
        reduced=("none in depth or width; (b)/(c) at batch "
                 f"{TIGER_TP['batch']} over the trainer's synthetic "
                 f"set, {TIGER_TP['epochs']} epoch (tiger.gin: 256 over Amazon-Beauty)"),
        parity=dict(steps=TIGER_TP["parity_steps"], dtype="fp32", dropout=0.0,
                    rows=TIGER_TRAIN["batch"], tp1_losses=tp1, tp2_losses=tp2,
                    max_rel_diff=rel, rtol=LCREC_PARITY_RTOL, tp1_s=tp1_s),
        trainer=dict(dtype="bf16", dropout=TIGER_TRAIN["dropout"], valid=a["out"][0],
                     test=a["out"][1], losses=losses, wall_s=a["wall_s"], **a["step_stats"],
                     collectives_per_step=a["collectives_per_step"],
                     collective_bytes_per_step=a["collective_bytes_per_step"],
                     launches=a["launches"]),
        resume=dict(kill=r0["kill"], only_process=1, saved_at=r0["b"]["steps"],
                    final_step=r0["final_step"], parity=[r["parity"] for r in ranks],
                    nondeterministic_ops=list(RESUME_NONDETERMINISTIC_OPS),
                    run_s={k: [r[k]["wall_s"] for r in ranks] for k in ("a", "b", "resumed")}),
        spawn_s=spawn_s,
    )


# qwen_tp4: LCRec at Qwen2.5-1.5B widths (H 12, KV 2) at tp=4, so that each
# KV head sits on two ranks; 2 of 28 layers.
QWEN_TP4 = dict(tp=4, layers=2, warm=1, steps=4)


def qwen_tp4_rank(group, seed) -> dict:
    """One rank of qwen_tp4: B8 at 4 shards against its twin, the parity
    steps (fp32) and the replicated KV rows after them, then bf16 steps
    at batch 8 x 512 with every counter at 0 before them."""
    from genrec_tpu_torch.kernels import fused_ce as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"b8": lcrec_b8(group, seed)}
    model, live = lcrec_model(lcrec_cfg(LCREC["parity_layers"]), group.device, seed,
                              torch.float32, group)
    run = lcrec_stepper(model, live, group, LCREC["parity_lr"], 1, LCREC["parity_steps"],
                        LCREC["wd"])
    out["parity_losses"] = [m["loss"] for m in run(lcrec_parity_batches(seed))]
    out["kv"] = {n: p.detach().cpu() for n, p in model.named_parameters()
                 if n.split(".")[-2:-1] in (["k_proj"], ["v_proj"])}
    del model, run
    torch.cuda.empty_cache()
    model, live = lcrec_model(lcrec_cfg(QWEN_TP4["layers"]), group.device, seed,
                              torch.bfloat16, group)
    n, warm = QWEN_TP4["steps"], QWEN_TP4["warm"]
    batches = [lcrec_tokens(seed + 100 + i, LCREC["batch"], LCREC["seq"], live)
               for i in range(warm + n)]
    run = lcrec_stepper(model, live, group, LCREC["lr"], 1, warm + n, LCREC["wd"])
    run(batches[:warm])
    torch.cuda.synchronize()
    stamps = []

    def hook():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    reset_counters()
    calls0, bytes0 = group.calls, group.bytes
    t0 = time.perf_counter()
    metrics = run(batches[warm:], hook)
    out["steps"] = dict(
        steps=n, losses=[m["loss"] for m in metrics], nonfinite=sum(m["nonfinite"]
                                                                   for m in metrics),
        step_ms_p50=float(np.percentile(1e3 * np.diff([t0] + stamps), 50)),
        launches=read_counters(), b8_calls=fc.sharded_fused_linear_ce.launches,
        collectives_per_step=(group.calls - calls0) / n,
        collective_bytes_per_step=(group.bytes - bytes0) / n,
        peak_memory_gb=torch.cuda.max_memory_allocated(group.device) / 1e9)
    del model, run
    torch.cuda.empty_cache()
    return out


def qwen_tp4_phase(dev, seed, tp1_losses=None, library_ms=None, rank_fn=None) -> dict:
    """Qwen KV heads that tp does not divide (A20): tp=4 over gloo on the one
    card, held to tp = 1 (lcrec_tp's parity side, computed here when that
    phase did not run); B8 over four shards, its row of the kernels line."""
    from genrec_tpu_torch.parallel.mesh import spawn
    from genrec_tpu_torch.parallel.shardings import kv_range

    if tp1_losses is None:
        tp1_losses = lcrec_parity_tp1(dev, seed)
    if library_ms is None:
        x, w, cases = lcrec_b8_inputs(dev, seed)
        library_ms = device_ms(lcrec_library_b8, [dict(x=x, w=w, targets=torch.as_tensor(
            cases["mixed"][0], device=dev))], reps=LCREC_REPS)
        del x, w
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(rank_fn or qwen_tp4_rank, QWEN_TP4["tp"], (seed,), device=dev.type,
                  timeout_s=LCREC_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    tp4 = r0["parity_losses"]
    check(all(r["parity_losses"] == tp4 for r in ranks), "tp=4 ranks disagree on the losses")
    rel = float(np.max(np.abs(np.asarray(tp4) - tp1_losses) / np.abs(tp1_losses)))
    check(np.isfinite(tp4).all() and rel <= LCREC_PARITY_RTOL,
          f"tp=1 vs tp=4 losses: max relative diff {rel} > {LCREC_PARITY_RTOL}")
    cfg = lcrec_cfg(LCREC["parity_layers"])
    H, KV, hd, tp = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, len(ranks)
    replicas = 0
    for h in range(KV):
        holders = [r for r in range(tp) if kv_range(H, KV, r, tp)[0] <= h < kv_range(
            H, KV, r, tp)[1]]
        for key in r0["kv"]:
            rows = [ranks[r]["kv"][key][(h - kv_range(H, KV, r, tp)[0]) * hd:
                                        (h - kv_range(H, KV, r, tp)[0] + 1) * hd]
                    for r in holders]
            check(all(torch.equal(rows[0], x) for x in rows[1:]),
                  f"KV head {h} of {key} differs between its holders {holders}")
            replicas += len(holders) - 1
    check(replicas > 0, "no KV head is replicated at tp=4")
    for rank, r in enumerate(ranks):
        s = r["steps"]
        check(s["nonfinite"] == 0 and all(np.isfinite(s["losses"])), s)
        for name, count in s["launches"].items():
            want = s["steps"] if name in LCREC_LAUNCHES_PER_STEP else 0
            if name == "sharded_fused_linear_ce":
                want = s["steps"]
            check(count == want, f"qwen_tp4 rank {rank}: {name} launched {count}, want {want}")
        check(s["b8_calls"] == s["steps"], ("B8 calls", s["b8_calls"]))
        check(s["losses"] == r0["steps"]["losses"], "the tp=4 ranks' losses differ")
    R, d, V = LCREC["batch"] * (LCREC["seq"] - 1), cfg.hidden_size, LCREC_LIVE
    b8_bound_ms, b8_bound_by = bound(2 * R * d * 2 + V * d * 2 * 2, 5 * 2 * R * V * d,
                                     BF16_FLOPS)
    b8 = dict(r0["b8"], library_ms=library_ms, bound_ms=b8_bound_ms, bound_by=b8_bound_by,
              shards=tp, launches=r0["steps"]["b8_calls"],
              ms_by_rank=[r["b8"]["ms"] for r in ranks])
    return emit(
        "qwen_tp4", tp=tp, backend="gloo (four ranks on one card)",
        config=(f"QwenConfig() (Qwen2.5-1.5B widths: H {H}, KV {KV}, hd {hd}), LCRec vocab "
                f"{LCREC_LIVE} with {LCREC['codebooks']} x {LCREC['codebook_size']} codebook "
                "tokens; each KV head on two ranks"),
        reduced=f"{QWEN_TP4['layers']} of 28 layers (parity: {LCREC['parity_layers']})",
        kv_replicas_checked=replicas, b8=b8,
        parity=dict(steps=LCREC["parity_steps"], dtype="fp32",
                    batch=[LCREC["parity_batch"], LCREC["parity_seq"]], tp1_losses=tp1_losses,
                    tp4_losses=tp4, max_rel_diff=rel, rtol=LCREC_PARITY_RTOL),
        steps=dict(r0["steps"], batch=[LCREC["batch"], LCREC["seq"]], dtype="bf16"),
        spawn_s=spawn_s,
    )


# moe: LCRec at Qwen2.5-1.5B widths with config/lcrec/synthetic_moe.gin's
# mixture of experts, 2 of 28 layers; ep=1 here, ep=4 on four gloo ranks.
MOE = dict(experts=4, top_k=2, capacity=2.0, aux_coef=0.01, ep=4, layers=2, warm=1, steps=6,
           lr=1e-4, decode_tokens=16)
MOE_DECODE_TOL = 2e-4  # cached decode against the forward, fp32 (test_moe.py's)


def moe_cfg(layers, capacity=None):
    import dataclasses

    return dataclasses.replace(lcrec_cfg(layers), num_experts=MOE["experts"],
                               num_experts_per_tok=MOE["top_k"],
                               moe_capacity_factor=capacity or MOE["capacity"],
                               router_aux_coef=MOE["aux_coef"])


def moe_model(dev, seed, dtype, group, layers, capacity=None):
    """The MoE LCRec model (codebook tokens appended), this rank's experts."""
    from genrec_tpu_torch.models.backbones.qwen import QwenLM, qwen_init_params
    from genrec_tpu_torch.models.lcrec import extend_vocab
    from genrec_tpu_torch.parallel.shardings import shard_expert_params

    cfg = moe_cfg(layers, capacity)
    full = qwen_init_params(cfg, seed, dev)
    cfg, full, base = extend_vocab(cfg, full, LCREC["codebooks"],
                                   LCREC["codebook_size"],
                                   torch.Generator(device=dev).manual_seed(seed + 1), pad_to=8)
    model = QwenLM(cfg, dtype=dtype, device=dev, expert_group=group)
    model.load_state_dict(shard_expert_params(full, 0 if group is None else group.rank,
                                              1 if group is None else group.size))
    del full
    torch.cuda.empty_cache()
    return model, base + LCREC["codebooks"] * LCREC["codebook_size"]


def moe_parity(dev, seed, group=None) -> tuple[list, dict]:
    """The fp32 parity steps (lcrec_parity_batches, the fused CE whole on
    every rank): losses and the final parameters (on the host)."""
    model, live = moe_model(dev, seed, torch.float32, group, MOE["layers"])
    run = lcrec_stepper(model, live, None, LCREC["parity_lr"], 1, LCREC["parity_steps"],
                        LCREC["wd"], expert_group=group)
    losses = [m["loss"] for m in run(lcrec_parity_batches(seed))]
    params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, run
    torch.cuda.empty_cache()
    return losses, params


def moe_rank(group, seed) -> dict:
    """One rank of the moe phase: the parity steps at ep=4, then bf16 steps
    at batch 8 x 512 with every counter at 0 before them, the router loss
    and the dropped share after them."""
    from genrec_tpu_torch.models.backbones.qwen import collect_moe_aux

    torch.backends.cuda.matmul.allow_tf32 = False
    losses, params = moe_parity(group.device, seed, group)
    out = {"parity_losses": losses,
           "router": {n: p for n, p in params.items() if "router" in n}}
    del params
    model, live = moe_model(group.device, seed, torch.bfloat16, group, MOE["layers"])
    n, warm = MOE["steps"], MOE["warm"]
    batches = [lcrec_tokens(seed + 200 + i % 2, LCREC["batch"], LCREC["seq"], live)
               for i in range(warm + n)]
    run = lcrec_stepper(model, live, None, MOE["lr"], 1, warm + n, LCREC["wd"],
                        expert_group=group)
    run(batches[:warm])
    torch.cuda.synchronize()
    stamps = []

    def hook():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    reset_counters()
    calls0, bytes0 = group.calls, group.bytes
    t0 = time.perf_counter()
    metrics = run(batches[warm:], hook)
    launches = read_counters()
    b = {k: torch.as_tensor(v, device=group.device) for k, v in batches[0].items()}
    aux: list = []
    with torch.no_grad():
        model(b["input_ids"], attention_mask=b["attention_mask"], compute_logits=False,
              moe_aux=aux)
    out["steps"] = dict(
        steps=n, losses=[m["loss"] for m in metrics],
        nonfinite=sum(m["nonfinite"] for m in metrics),
        step_ms_p50=float(np.percentile(1e3 * np.diff([t0] + stamps), 50)),
        launches=launches, router_aux=float(collect_moe_aux(aux)),
        dropped_share=[float(layer.moe.dropped) for layer in model.layers],
        collectives_per_step=(group.calls - calls0) / n,
        collective_bytes_per_step=(group.bytes - bytes0) / n,
        peak_memory_gb=torch.cuda.max_memory_allocated(group.device) / 1e9)
    del model, run
    torch.cuda.empty_cache()
    return out


def moe_decode_check(dev, seed) -> float:
    """decode_step against the forward on one batch (fp32, ep=1): the
    logits at every position of a cached, token-by-token decode. The
    capacity is ample (E, so C >= the tokens): the routed MLP is per token
    only where nothing is dropped, as in tests/test_moe.py."""
    model, live = moe_model(dev, seed, torch.float32, None, MOE["layers"],
                            capacity=float(MOE["experts"]))
    T = MOE["decode_tokens"]
    ids = torch.as_tensor(lcrec_tokens(seed + 300, 2, T, live)["input_ids"],
                          device=dev).long()
    with torch.no_grad():
        full = model(ids)
        caches = model.init_cache(2, T)
        pad = torch.zeros((2, T), dtype=torch.long, device=dev)
        worst = 0.0
        for t in range(T):
            pad[:, t] = 1
            logits, caches = model.decode_step(ids[:, t:t + 1], torch.full((2, 1), t, device=dev),
                                               caches, pad)
            worst = max(worst, assert_near(f"MoE decode step {t}", logits, full[:, t],
                                           MOE_DECODE_TOL))
    del model
    torch.cuda.empty_cache()
    return worst


def moe_phase(dev, seed, rank_fn=None) -> dict:
    """Mixture of experts (A14) at the Qwen2.5-1.5B widths: ep = 1 here
    (twice: equal bits), ep = 4 over gloo on the one card (parity within
    LCREC_PARITY_RTOL, the replicated router equal on every rank), bf16
    steps with B3, B4 dx and B4 dW once a step a rank, and the cached
    decode against the forward."""
    def reference():  # while the ranks start
        t0 = time.perf_counter()
        ep1, params1 = moe_parity(dev, seed)
        ep1b, params1b = moe_parity(dev, seed)
        differ = sorted(k for k in params1 if not torch.equal(params1[k], params1b[k]))
        check(ep1 == ep1b and not differ, ("two ep=1 MoE runs differ", ep1, ep1b, differ[:5]))
        decode_err = moe_decode_check(dev, seed)
        ep1_s = time.perf_counter() - t0
        del params1b
        gc.collect()
        torch.cuda.empty_cache()
        return ep1, params1, decode_err, ep1_s

    (ep1, params1, decode_err, ep1_s), ranks, spawn_s = spawn_beside(
        rank_fn or moe_rank, MOE["ep"], (seed,), reference, device=dev.type,
        timeout_s=LCREC_TIMEOUT_S)
    r0 = ranks[0]
    ep4 = r0["parity_losses"]
    check(all(r["parity_losses"] == ep4 for r in ranks), "ep=4 ranks disagree on the losses")
    rel = float(np.max(np.abs(np.asarray(ep4) - ep1) / np.abs(ep1)))
    check(np.isfinite(ep4).all() and rel <= LCREC_PARITY_RTOL,
          f"ep=1 vs ep=4 MoE losses: max relative diff {rel} > {LCREC_PARITY_RTOL}")
    router_rel = 0.0
    for name, w in r0["router"].items():
        check(all(torch.equal(r["router"][name], w) for r in ranks), f"{name} differs by rank")
        router_rel = max(router_rel, float((w - params1[name]).abs().max()
                                           / params1[name].abs().max()))
    for rank, r in enumerate(ranks):
        s = r["steps"]
        check(s["nonfinite"] == 0 and all(np.isfinite(s["losses"])), s)
        check(np.isfinite(s["router_aux"]) and s["router_aux"] > 0, s["router_aux"])
        check(s["losses"][-1] < s["losses"][0], ("MoE loss did not fall", s["losses"]))
        for name, count in s["launches"].items():
            want = s["steps"] if name in LCREC_LAUNCHES_PER_STEP else 0
            check(count == want, f"moe rank {rank}: {name} launched {count}, want {want}")
        check(s["losses"] == r0["steps"]["losses"], "the ep=4 ranks' losses differ")
    return emit(
        "moe", ep=MOE["ep"], backend="gloo (four ranks on one card)",
        config=(f"QwenConfig() (Qwen2.5-1.5B widths) with config/lcrec/synthetic_moe.gin's MoE: "
                f"{MOE['experts']} experts, top {MOE['top_k']}, capacity {MOE['capacity']}, "
                f"aux {MOE['aux_coef']}; LCRec vocab {LCREC_LIVE}"),
        reduced=f"{MOE['layers']} of 28 layers",
        parity=dict(steps=LCREC["parity_steps"], dtype="fp32",
                    batch=[LCREC["parity_batch"], LCREC["parity_seq"]], ep1_losses=ep1,
                    ep4_losses=ep4, max_rel_diff=rel, rtol=LCREC_PARITY_RTOL,
                    ep1_twice_bit_equal=True, router_max_rel_diff=router_rel, ep1_s=ep1_s),
        decode=dict(tokens=MOE["decode_tokens"], max_abs_err=decode_err, tol=MOE_DECODE_TOL),
        steps=dict(r0["steps"], batch=[LCREC["batch"], LCREC["seq"]], dtype="bf16",
                   lr=MOE["lr"]),
        spawn_s=spawn_s,
    )


# ---- phase 27: data parallelism and 2-D layouts (A17) ------------------------
# Gloo ranks on the one card (NCCL refuses two ranks on one device): two
# ranks at dp = 2 for (a)-(c) and (f), four at tp = 2 x dp = 2 (and tp = 2 x
# ep = 2) for (d) and (e). Each layout is held to one rank (or tp = 2 x dp
# = 1) in fp32 from the same init on the same global batches, every rank
# keeping its contiguous rows (parallel.mesh.shard_batch). Cuts (the
# phase's `reduced`): steps (LCRec's fp32 parity 3 steps at the global
# batch 8 x 512), the trainer run's data (the trainer's own synthetic set,
# 8 rows a step), COBRA's and NoteLLM's depth and widths as below, LCRec's
# depth (2 of 28 layers).
DP = dict(steps=5, ce_steps=3, hstu_trainer_batch=8, kill=5, poll=8, lcrec_parity_steps=3,
          lcrec_warm=1, lcrec_timed=4, notellm_layers=2, notellm_batch_pairs=16,
          notellm_seq=128, cobra_batch=64, rq_rows=1024, rq_lr=1e-3, ce_lr=1e-4)
DP_RTOL = 1e-4  # 5 fp32 steps at dp = 2 against one rank (as the tp parity checks)
DP_MOE_RTOL = 1e-5  # tp = 2 x ep = 2 against ep = 1; the MoE router loss at dp = 2
DP_TIMEOUT_S = 900


def dp_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape and np.isfinite(got).all(), (got, want))
    return float(np.max(np.abs(got - want) / np.abs(want)))


def dp_seq_batches(seed, rows, n) -> list:
    """The first ``n`` global batches of ``rows`` packed rows of the Beauty
    set's epoch 0 (numpy, shipped to the ranks): HSTU's keys (timestamps)
    and SASRec's (positions) both."""
    from genrec_tpu_torch.data.batching import batch_iterator, pack_examples

    arrays, _ = pack_examples(beauty_dataset(seed).train_examples(with_time=True),
                              row_len=HSTU_AMAZON["max_seq_len"], seed=(seed, 0))
    arrays.pop("segment_valid")
    it = batch_iterator(arrays, rows, shuffle=True, seed=seed, drop_last=True)
    return [b for b, _ in itertools.islice(it, n)]


def dp_keys(batches, keys) -> list:
    return [{k: b[k] for k in keys} for b in batches]


def dp_steps(dev, model, loss_fn, opt, batches, group, clip=None):
    """fp32 steps of the trainer's step over ``batches`` (this rank's rows
    of each under ``group``): the losses, the counters set to 0 before."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.parallel.mesh import shard_batch

    step = make_train_step(loss_fn, opt, clip_norm=clip, data_group=group)
    state = TrainState.create(model, opt, 0)
    losses = []
    reset_counters()
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in shard_batch(b, group).items()})
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    return losses, read_counters()


def dp_hstu(dev, seed, batches, group=None):
    """(a) HSTU at amazon.gin widths, fp32, dropout 0.2, the kernel path."""
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.models.hstu import HSTU
    from genrec_tpu_torch.trainers.hstu_trainer import make_loss_fn

    model = HSTU(num_items=BEAUTY_ITEMS, dropout=0.2, use_pallas=True, fused_ce=True,
                 dtype=torch.float32, device=dev, seed=seed, **HSTU_AMAZON)
    return dp_steps(dev, model, make_loss_fn(), Adam(1e-3, b2=0.98), batches, group)


def dp_sasrec(dev, seed, batches, group=None):
    """(b) SASRec at amazon.gin widths, fp32, dropout 0.2, the fused CE."""
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.models.sasrec import SASRec
    from genrec_tpu_torch.trainers.sasrec_trainer import make_loss_fn

    model = SASRec(num_items=BEAUTY_ITEMS, dropout=0.2, fused_ce=True, dtype=torch.float32,
                   device=dev, seed=seed, **SASREC_AMAZON)
    return dp_steps(dev, model, make_loss_fn(), Adam(1e-3, b2=0.98), batches, group)


def dp_rqvae_model(dev, seed):
    """(c)'s RQ-VAE at rqvae.gin widths (STE, the Sinkhorn last layer) and
    its item embeddings."""
    from genrec_tpu_torch.data.items import SyntheticItemEmbeddings
    from genrec_tpu_torch.models.rqvae import QuantizeForwardMode, RqVae

    src = SyntheticItemEmbeddings(num_items=CATALOG_ITEMS, dim=768, seed=seed)
    model = RqVae(input_dim=768, embed_dim=32, hidden_dims=(512, 256, 128, 64),
                  codebook_size=256, codebook_mode=QuantizeForwardMode.STE,
                  codebook_last_layer_mode=QuantizeForwardMode.SINKHORN, n_layers=3,
                  commitment_weight=0.25, n_cat_features=0, device=dev, seed=seed)
    return model, src


def dp_rqvae_init(dev, seed) -> dict:
    """(c)'s parameters after the k-means init, as numpy: made once here and
    shipped to the ranks, so that one rank and dp = 2 start from one init
    (k-means sums its clusters with index_add_, by atomics on CUDA: each
    process would start from its own rounding of the codebooks)."""
    from genrec_tpu_torch.models.rqvae import kmeans_init_params

    model, src = dp_rqvae_model(dev, seed)
    kmeans_init_params(model, torch.as_tensor(src.arrays()[0][:20000], device=dev),
                       torch.Generator(device=dev).manual_seed(seed + 1))
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def dp_rqvae(dev, seed, init, group=None):
    """(c) RQ-VAE from the k-means init ``init`` (dp_rqvae_init), 5 fp32
    steps of DP["rq_rows"] rows, then the export through B7 over ``group``
    (its launches counted alone) and, of the same weights, on this rank
    alone."""
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.trainers.rqvae_trainer import compute_sem_ids, make_loss_fn

    model, src = dp_rqvae_model(dev, seed)
    model.load_state_dict({k: torch.as_tensor(v, device=dev) for k, v in init.items()})
    train_x, _ = src.arrays()
    rows = DP["rq_rows"]
    batches = [{"x": train_x[i * rows:(i + 1) * rows]} for i in range(DP["steps"])]
    losses, _ = dp_steps(dev, model, make_loss_fn(0.2), Adam(DP["rq_lr"], weight_decay=1e-4),
                         batches, group, clip=1.0)
    reset_counters()
    ids = compute_sem_ids(model, src.embeddings, batch_size=SEM_ID_CHUNK, use_pallas=True,
                          data_group=group)
    launches = read_counters()["rq_cascade"]
    alone = compute_sem_ids(model, src.embeddings, batch_size=SEM_ID_CHUNK, use_pallas=True)
    return losses, ids, launches, alone


def dp_cobra(dev, seed, batches, group=None):
    """(f) COBRA at amazon.gin widths, fp32, its dropout, 3 steps."""
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.models.cobra import Cobra
    from genrec_tpu_torch.trainers.cobra_trainer import make_loss_fn

    model = Cobra(**COBRA_AMAZON, dtype=torch.float32, device=dev, seed=seed)
    return dp_steps(dev, model, make_loss_fn(), Adam(DP["ce_lr"], weight_decay=0.01),
                    batches, group, clip=1.0)[0]


def dp_notellm_data(seed):
    from genrec_tpu_torch.data.notellm_pairs import NoteLLMPairData

    data = NoteLLMPairData(num_topics=NOTELLM["topics"], eval_topics=NOTELLM["eval_topics"],
                           max_len=DP["notellm_seq"], seed=seed)
    arrays = data.train_arrays(NOTELLM["pairs_per_topic"])
    n = DP["notellm_batch_pairs"]
    return data.tokenizer.vocab_size, [{k: v[i * n:(i + 1) * n] for k, v in arrays.items()}
                                       for i in range(DP["ce_steps"])]


def dp_notellm(dev, seed, vocab, batches, group=None):
    """(f) NoteLLM at the Qwen2.5-1.5B widths, 2 layers, fp32, 3 steps."""
    from genrec_tpu_torch.trainers import notellm_trainer as nt

    model = nt.notellm_model(notellm_cfg(DP["notellm_layers"], vocab), torch.float32, seed,
                             NOTELLM["tau"], dev)
    opt = nt.make_optimizer(DP["ce_lr"], 1, DP["ce_steps"], NOTELLM["wd"])
    return dp_steps(dev, model, nt.notellm_loss, opt, batches, group, clip=1.0)[0]


def dp_hstu_trainer(group, seed) -> dict:
    """(a) hstu_trainer.train at dp = 2 through amazon.gin, one epoch of
    the trainer's synthetic set: uninterrupted, killed by a signal on rank
    1 only, resumed; the shared resume points (data rank 0 writes them)."""
    from genrec_tpu_torch.core import chaos
    from genrec_tpu_torch.parallel.mesh import barrier
    from genrec_tpu_torch.trainers import hstu_trainer

    work = HERE / "build" / "dp_hstu"
    if group.rank == 0:
        shutil.rmtree(work, ignore_errors=True)
    barrier("dp_hstu work", group)
    bindings = ('train.dataset = "synthetic"', "train.wandb_logging = False",
                "train.do_eval = True", "train.epochs = 1", "train.save_every_epoch = 1",
                f"train.batch_size = {DP['hstu_trainer_batch']}", "train.eval_batch_size = 256",
                "train.wandb_log_interval = 1", f"train.seed = {seed}",
                f'train.device = "{group.device}"')
    run = gin_train_run("config/hstu/amazon.gin", bindings, work, hstu_trainer.train)
    out = {"a": run("a")}
    out["b"] = run("b", chaos.ChaosPlan(kill_at_step=DP["kill"], only_process=1))
    barrier("dp_hstu saved", group)  # rank 1 returns while rank 0 writes the point
    out["b"]["steps"] = ckpt_steps(work / "b")
    out["resumed"] = run("b", resume_from_checkpoint=True)
    barrier("dp_hstu logged", group)
    out["parity"], out["final_step"], out["point_bytes"] = resume_parity(
        f"HSTU dp=2 rank {group.rank}", work / "a", work / "b")
    out["losses"] = run_log(work / "a")[0]
    barrier("dp_hstu read", group)
    return out


def dp_rank(group, seed, batches) -> dict:
    """One rank of dp's two-rank half: (a), (b), (c) and (f) at dp = 2."""
    from genrec_tpu_torch.parallel.mesh import make_mesh

    entered = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = group.device
    data = make_mesh({"data": -1}, group, device="cuda").data
    runs = dict(hstu=lambda: dp_hstu(dev, seed, batches["hstu"], data),
                hstu_trainer=lambda: dp_hstu_trainer(group, seed),
                sasrec=lambda: dp_sasrec(dev, seed, batches["sasrec"], data),
                rqvae=lambda: dp_rqvae(dev, seed, batches["rqvae_init"], data),
                cobra=lambda: dp_cobra(dev, seed, batches["cobra"], data),
                notellm=lambda: dp_notellm(dev, seed, batches["notellm_vocab"],
                                           batches["notellm"], data))
    out = {"s": {}, "entered": entered}
    for name, run in runs.items():
        t0 = time.perf_counter()
        out[name] = run()
        out["s"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["left"] = time.time()
    return out


def dp_lcrec_model(dev, seed, dtype, tp, ep=None, moe=False):
    """LCRec at the Qwen2.5-1.5B widths (2 layers, or the moe phase's MoE):
    this rank's shard over the model group ``tp`` and expert group ``ep``."""
    from genrec_tpu_torch.models.backbones.qwen import QwenLM, qwen_init_params
    from genrec_tpu_torch.models.lcrec import extend_vocab
    from genrec_tpu_torch.parallel.shardings import shard_expert_params, shard_qwen_params

    cfg = moe_cfg(MOE["layers"]) if moe else lcrec_cfg(LCREC["parity_layers"])
    full = qwen_init_params(cfg, seed, dev)
    cfg, full, base = extend_vocab(cfg, full, LCREC["codebooks"], LCREC["codebook_size"],
                                   torch.Generator(device=dev).manual_seed(seed + 1),
                                   pad_to=math.lcm(8, 1 if tp is None else tp.size))
    model = QwenLM(cfg, dtype=dtype, group=tp, expert_group=ep, device=dev)
    model.load_state_dict(shard_expert_params(
        shard_qwen_params(full, 0 if tp is None else tp.rank, 1 if tp is None else tp.size, cfg),
        0 if ep is None else ep.rank, 1 if ep is None else ep.size))
    del full
    torch.cuda.empty_cache()
    return model, base + LCREC["codebooks"] * LCREC["codebook_size"]


def dp_lcrec_steps(model, live, tp, data, batches, lr, hook=None):
    """The trainer's SFT step (AdamW after a 1-step warm-up, clip 1.0, B8
    over ``tp``, or the fused CE whole) over this rank's rows of each
    global batch under ``data``: metrics a step."""
    from genrec_tpu_torch.core.harness import make_train_step
    from genrec_tpu_torch.core.optim import Adam
    from genrec_tpu_torch.core.state import TrainState
    from genrec_tpu_torch.models.lcrec import make_tp_sharded_fused_sft_loss, sft_loss
    from genrec_tpu_torch.ops.schedules import cosine_schedule_with_warmup
    from genrec_tpu_torch.parallel.mesh import shard_batch

    if tp is None:
        def loss(b):
            return sft_loss(model, b["input_ids"], b["attention_mask"], b["labels"],
                            valid_vocab=live, use_fused_ce=True)
    else:
        loss = make_tp_sharded_fused_sft_loss(model, live)
    opt = Adam(cosine_schedule_with_warmup(lr, 1, len(batches)), weight_decay=LCREC["wd"])
    step = make_train_step(lambda m, b, g: (loss(b), {}), opt, clip_norm=1.0,
                           group=tp or model.expert_group, data_group=data)
    state = TrainState.create(model, opt, 0)
    dev = model.norm.weight.device
    out = []
    for b in batches:
        _, m = step(state, {k: torch.as_tensor(v, device=dev)
                            for k, v in shard_batch(b, data).items()})
        out.append({k: float(v) for k, v in m.items()})
        if hook is not None:
            hook()
    return out


def dp_moe_router(model, batch, data=None) -> tuple[float, list]:
    """The router loss (summed over the layers) and each layer's dropped
    share of one forward over the global batch (this rank's rows of it)."""
    from genrec_tpu_torch.models.backbones.qwen import collect_moe_aux
    from genrec_tpu_torch.parallel.mesh import data_parallel, shard_batch

    dev = model.norm.weight.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in shard_batch(batch, data).items()}
    aux: list = []
    with torch.no_grad(), data_parallel(data, b["input_ids"].shape[0]):
        model(b["input_ids"], attention_mask=b["attention_mask"], compute_logits=False,
              moe_aux=aux)
        total = collect_moe_aux(aux)
    if data is not None:  # each rank holds its share (data_share): the sum is the loss
        total = data.all_reduce(total)
    return float(total), [float(layer.moe.dropped) for layer in model.layers]


def dp_rank4(group, seed, tiger_batches, quiet) -> dict:
    """One rank of dp's four-rank half: (d) LCRec at tp = 2 x dp = 2 in
    fp32 against tp = 2 x dp = 1 (each model group alone on the global
    batch), B8 counted; the MoE at tp = 2 x ep = 2 (fp32 parity steps) and
    at dp = 2 (router loss, dropped share); (e) TIGER at tp = 2 x dp = 2;
    then, once the ``quiet`` flag says that nothing else runs on the card,
    LCRec's bf16 steps timed, collectives a step by axis."""
    from genrec_tpu_torch.kernels import fused_ce as fc
    from genrec_tpu_torch.parallel.mesh import make_mesh

    entered = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = group.device
    mesh = make_mesh({"data": -1, "model": 2}, group, device="cuda")
    tp, data = mesh.group("model"), mesh.data
    out = {"coords": mesh.coords, "s": {}, "entered": entered}
    t0 = time.perf_counter()
    model, live = dp_lcrec_model(dev, seed, torch.float32, tp)
    batches = [lcrec_tokens(seed + 10 + i, LCREC["batch"], LCREC["seq"], live)
               for i in range(DP["lcrec_parity_steps"])]
    reset_counters()
    fc.sharded_fused_linear_ce.launches = 0
    out["tp_dp_losses"] = [m["loss"] for m in dp_lcrec_steps(
        model, live, tp, data, batches, LCREC["parity_lr"])]
    out["tp_dp_launches"] = read_counters()
    del model
    torch.cuda.empty_cache()
    model, _ = dp_lcrec_model(dev, seed, torch.float32, tp)
    out["tp_losses"] = [m["loss"] for m in dp_lcrec_steps(
        model, live, tp, None, batches, LCREC["parity_lr"])]
    del model
    torch.cuda.empty_cache()
    out["s"]["lcrec_fp32"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # The MoE: tp = 2 x ep = 2 (fp32 parity steps), then dp = 2 (router).
    tp_ep = make_mesh({"data": -1, "model": 2, "expert": 2}, group, device="cuda")
    model, live_moe = dp_lcrec_model(dev, seed, torch.float32, tp_ep.group("model"),
                                     tp_ep.group("expert"), moe=True)
    out["tp_ep_losses"] = [m["loss"] for m in dp_lcrec_steps(
        model, live_moe, tp_ep.group("model"), None, lcrec_parity_batches(seed),
        LCREC["parity_lr"])]
    del model
    torch.cuda.empty_cache()
    model, _ = dp_lcrec_model(dev, seed, torch.float32, None, moe=True)
    out["moe_dp"] = dp_moe_router(model, lcrec_tokens(seed + 200, LCREC["batch"], LCREC["seq"],
                                                      live_moe), data)
    del model
    torch.cuda.empty_cache()
    out["s"]["moe"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (e) TIGER at tp = 2 x dp = 2.
    reset_counters()
    out["tiger_losses"] = tiger_tp_parity(dev, seed, tiger_batches, tp, data)
    out["tiger_launches"] = read_counters()
    out["s"]["tiger"] = time.perf_counter() - t0

    # bf16 steps at batch 8 x 512 with the card to these ranks alone, every
    # counter at 0 before the timed ones.
    out["s"]["quiet_wait"] = wait_quiet(quiet)
    t0 = time.perf_counter()
    model, _ = dp_lcrec_model(dev, seed, torch.bfloat16, tp)
    warm, n = DP["lcrec_warm"], DP["lcrec_timed"]
    batches = [lcrec_tokens(seed + 100 + i, LCREC["batch"], LCREC["seq"], live)
               for i in range(warm + n)]
    stamps: list = []

    def hook():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    dp_lcrec_steps(model, live, tp, data, batches[:warm], LCREC["lr"])
    torch.cuda.synchronize()
    reset_counters()
    fc.sharded_fused_linear_ce.launches = 0
    before = mesh.counters()
    t1 = time.perf_counter()
    metrics = dp_lcrec_steps(model, live, tp, data, batches[warm:], LCREC["lr"], hook)
    after = mesh.counters()
    out["bf16"] = dict(
        steps=n, losses=[m["loss"] for m in metrics],
        nonfinite=sum(m["nonfinite"] for m in metrics),
        step_ms=[1e3 * d for d in np.diff([t1] + stamps)],
        step_ms_p50=float(np.percentile(1e3 * np.diff([t1] + stamps), 50)),
        launches=read_counters(), b8_calls=fc.sharded_fused_linear_ce.launches,
        collectives_per_step={a: (after[a][0] - before[a][0]) / n for a in after},
        collective_bytes_per_step={a: (after[a][1] - before[a][1]) / n for a in after},
        peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del model
    torch.cuda.empty_cache()
    out["s"]["lcrec_bf16"] = time.perf_counter() - t0
    out["left"] = time.time()
    return out


def dp_phase(dev, seed, tiger_tp1=None, moe_ep1=None, rank_fn=None, rank4_fn=None) -> dict:
    """Data parallelism and 2-D layouts (A17) on the card over gloo ranks:
    (a)-(c), (f) on two ranks, (d) and (e) on four, the two spawns at
    once, each held to one rank computed here meanwhile (TIGER's tp = 1
    and the MoE's ep = 1 losses taken from the tiger_tp and moe phases
    when they ran)."""
    from genrec_tpu_torch.data.batching import batch_iterator
    from genrec_tpu_torch.parallel.mesh import spawn

    def timed_spawn(fn, world, args):
        t0, t0_wall = time.perf_counter(), time.time()
        ranks = spawn(fn, world, args, device=dev.type, timeout_s=DP_TIMEOUT_S)
        end = time.time()
        # (start to fn, fn's end to join) of the spawn
        edges = (min(r["entered"] for r in ranks) - t0_wall, end - max(r["left"] for r in ranks))
        return ranks, time.perf_counter() - t0, edges

    # The two halves run at once (six rank processes on the card), the four
    # ranks' first; this process builds the two ranks' batches and then
    # computes the one-rank references while they run (a rank spends most
    # of its start-up importing torch). The four ranks time their bf16
    # steps only after the quiet flag: the two ranks and the references done.
    quiet = HERE / "build" / "dp_quiet"
    quiet.parent.mkdir(parents=True, exist_ok=True)
    quiet.unlink(missing_ok=True)
    with ThreadPoolExecutor(2) as pool:
        t0 = time.perf_counter()
        tiger_batches = tiger_tp_batches(seed)  # the tiger_tp phase's, when it ran
        four_f = pool.submit(timed_spawn, rank4_fn or dp_rank4, 4,
                             (seed, tiger_batches, str(quiet)))
        check(HSTU_BATCH == SASREC_BATCH, (HSTU_BATCH, SASREC_BATCH))  # one packing for both
        seq = dp_seq_batches(seed, HSTU_BATCH, DP["steps"])
        batches = dict(hstu=dp_keys(seq, ("input_ids", "timestamps", "targets", "segment_ids")),
                       sasrec=dp_keys(seq, ("input_ids", "targets", "segment_ids", "positions")),
                       cobra=[b for b, _ in itertools.islice(batch_iterator(
                           cobra_beauty_data(seed).train_arrays(), DP["cobra_batch"],
                           shuffle=True, seed=seed, drop_last=True), DP["ce_steps"])])
        batches["notellm_vocab"], batches["notellm"] = dp_notellm_data(seed)
        batches["rqvae_init"] = dp_rqvae_init(dev, seed)
        two_f = pool.submit(timed_spawn, rank_fn or dp_rank, 2, (seed, batches))
        batch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            one = dict(hstu=dp_hstu(dev, seed, batches["hstu"]),
                       sasrec=dp_sasrec(dev, seed, batches["sasrec"]),
                       rqvae=dp_rqvae(dev, seed, batches["rqvae_init"]),
                       cobra=dp_cobra(dev, seed, batches["cobra"]),
                       notellm=dp_notellm(dev, seed, batches["notellm_vocab"],
                                          batches["notellm"]))
            if tiger_tp1 is None:
                tiger_tp1 = tiger_tp_parity(dev, seed, tiger_batches)
            if moe_ep1 is None:
                moe_ep1 = moe_parity(dev, seed)[0]
            model, live = dp_lcrec_model(dev, seed, torch.float32, None, moe=True)
            moe_dp1 = dp_moe_router(model, lcrec_tokens(seed + 200, LCREC["batch"],
                                                        LCREC["seq"], live))
            del model
            gc.collect()
            torch.cuda.empty_cache()
            one_s = time.perf_counter() - t0
            two, two_s, two_edges = two_f.result()
        finally:
            quiet.touch()  # a failed half still releases the four ranks
        four, four_s, four_edges = four_f.result()

    n = DP["steps"]
    rel = {}
    for name in ("hstu", "sasrec"):
        got = two[0][name][0]
        check(two[1][name][0] == got, (f"dp {name}: the ranks' losses differ", two[1][name][0]))
        rel[name] = dp_rel(got, one[name][0])
        check(rel[name] <= DP_RTOL, f"dp {name}: dp=2 vs 1 losses {rel[name]} > {DP_RTOL}")
    for r, rank in enumerate(two):
        check_launches_per_step(f"dp HSTU rank {r}", rank["hstu"][1], LAUNCHES_PER_STEP, n)
        check_launches_per_step(f"dp SASRec rank {r}", rank["sasrec"][1],
                                SASREC_LAUNCHES_PER_STEP, n)
    rq_losses, rq_ids, rq_b7, _ = two[0]["rqvae"]
    rel["rqvae"] = dp_rel(rq_losses, one["rqvae"][0])
    check(rel["rqvae"] <= DP_RTOL, f"dp RQ-VAE: dp=2 vs 1 losses {rel['rqvae']} > {DP_RTOL}")
    chunks = -(-CATALOG_ITEMS // SEM_ID_CHUNK)
    for r, rank in enumerate(two):
        # B7 is row-wise: the gathered ids are one rank's ids of the same weights.
        check(np.array_equal(rank["rqvae"][1], rank["rqvae"][3])
              and np.array_equal(rank["rqvae"][1], rq_ids),
              f"dp RQ-VAE rank {r}: the export's ids differ from one rank's")
        check(rank["rqvae"][2] == chunks, (f"dp RQ-VAE rank {r}: B7 launches", rank["rqvae"][2],
                                           "want", chunks))
    for name in ("cobra", "notellm"):
        check(two[1][name] == two[0][name], f"dp {name}: the ranks' losses differ")
        rel[name] = dp_rel(two[0][name], one[name])
        check(rel[name] <= DP_RTOL, f"dp {name}: dp=2 vs 1 losses {rel[name]} > {DP_RTOL}")
    trainer = []
    for r, rank in enumerate(two):
        t = rank["hstu_trainer"]
        check(t["b"]["out"] == ({}, {}), (f"dp HSTU trainer rank {r}: the preempted run "
                                          "returned", t["b"]["out"]))
        save_at = -(-DP["kill"] // DP["poll"]) * DP["poll"]
        check(t["b"]["steps"][-1:] == [save_at], (f"dp HSTU trainer rank {r} saved at",
                                                  t["b"]["steps"], "want", save_at))
        check(t["parity"]["bit_equal"], (f"dp HSTU trainer rank {r} resume", t["parity"]))
        check(t["a"]["out"] == two[0]["hstu_trainer"]["a"]["out"],
              "dp HSTU trainer: the ranks report other metrics")
        trainer.append(dict(parity=t["parity"], saved_at=t["b"]["steps"],
                            run_s={k: t[k]["wall_s"] for k in ("a", "b", "resumed")},
                            launches=t["a"]["launches"]))
    losses = [two[0]["hstu_trainer"]["losses"][g]
              for g in sorted(two[0]["hstu_trainer"]["losses"])]
    check(np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3]),
          ("dp HSTU trainer: the loss did not fall", losses))

    r0 = four[0]
    for r, rank in enumerate(four):
        check(rank["tp_dp_losses"] == r0["tp_dp_losses"], f"dp LCRec rank {r}: losses differ")
        check(rank["tp_ep_losses"] == r0["tp_ep_losses"], f"dp MoE rank {r}: losses differ")
        check(rank["tiger_losses"] == r0["tiger_losses"], f"dp TIGER rank {r}: losses differ")
        check(rank["moe_dp"] == r0["moe_dp"], f"dp MoE router rank {r} differs")
        s = rank["bf16"]
        check(s["nonfinite"] == 0 and all(np.isfinite(s["losses"])), s)
        for name, count in s["launches"].items():
            want = s["steps"] if name in LCREC_LAUNCHES_PER_STEP else 0
            if name == "sharded_fused_linear_ce":
                want = s["steps"]
            check(count == want, f"dp LCRec rank {r}: {name} launched {count}, want {want}")
        check(s["b8_calls"] == s["steps"], ("dp B8 calls", s["b8_calls"]))
        check(rank["tp_dp_launches"]["sharded_fused_linear_ce"] == DP["lcrec_parity_steps"],
              rank["tp_dp_launches"])
    rel["lcrec_tp_dp"] = dp_rel(r0["tp_dp_losses"], r0["tp_losses"])
    check(rel["lcrec_tp_dp"] <= DP_RTOL,
          f"dp LCRec: tp=2 x dp=2 vs tp=2 losses {rel['lcrec_tp_dp']} > {DP_RTOL}")
    rel["moe_tp_ep"] = dp_rel(r0["tp_ep_losses"], moe_ep1)
    check(rel["moe_tp_ep"] <= DP_MOE_RTOL,
          f"dp MoE: tp=2 x ep=2 vs ep=1 losses {rel['moe_tp_ep']} > {DP_MOE_RTOL}")
    (aux2, dropped2), (aux1, dropped1) = r0["moe_dp"], moe_dp1
    check(dropped2 == dropped1, ("dp MoE: dropped shares at dp=2 and 1", dropped2, dropped1))
    rel["moe_router"] = dp_rel([aux2], [aux1])
    check(rel["moe_router"] <= DP_MOE_RTOL, ("dp MoE router loss", aux2, aux1))
    rel["tiger_tp_dp"] = dp_rel(r0["tiger_losses"], tiger_tp1)
    check(rel["tiger_tp_dp"] <= DP_RTOL,
          f"dp TIGER: tp=2 x dp=2 vs tp=1 losses {rel['tiger_tp_dp']} > {DP_RTOL}")
    layers = TIGER_AMAZON["n_layers"]
    for r, rank in enumerate(four):
        for name, count in rank["tiger_launches"].items():
            want = layers * len(tiger_batches) if name == "table_grad" else 0
            check(count == want, f"dp TIGER rank {r}: {name} launched {count}, want {want}")
    a = two[0]["hstu_trainer"]["a"]
    return emit(
        "dp", backend="gloo (two and four ranks on one card)",
        config=("HSTU / SASRec at config/{hstu,sasrec}/amazon.gin widths on the Beauty set, "
                "RQ-VAE at rqvae.gin widths (Sinkhorn last layer), COBRA at "
                "config/cobra/amazon.gin widths, NoteLLM and LCRec at the Qwen2.5-1.5B widths, "
                "TIGER at tiger.gin widths; fp32 parity steps from one init"),
        reduced=dict(steps=f"{n} fp32 steps ({DP['ce_steps']} for COBRA / NoteLLM)",
                     hstu_trainer=(f"1 epoch of the trainer's synthetic set at batch "
                                   f"{DP['hstu_trainer_batch']} (amazon.gin: 128 over Beauty)"),
                     notellm=f"{DP['notellm_layers']} of 28 layers, batch "
                             f"{DP['notellm_batch_pairs']} pairs",
                     lcrec=(f"{LCREC['parity_layers']} of 28 layers ({MOE['layers']} for the "
                            f"MoE); the fp32 tp x dp parity {DP['lcrec_parity_steps']} steps "
                            f"(of 5) at {LCREC['batch']} x {LCREC['seq']}; the MoE's at the "
                            f"moe phase's {LCREC['parity_batch']} x {LCREC['parity_seq']}")),
        max_rel_diff=rel, rtol=DP_RTOL, moe_rtol=DP_MOE_RTOL,
        launches_per_rank=dict(hstu=two[0]["hstu"][1], sasrec=two[0]["sasrec"][1],
                               rq_cascade_export=rq_b7,
                               lcrec_bf16=r0["bf16"]["launches"],
                               tiger=r0["tiger_launches"]),
        hstu_trainer=dict(ranks=trainer, losses=losses, valid=a["out"][0], test=a["out"][1]),
        lcrec_bf16=dict(r0["bf16"], batch=[LCREC["batch"], LCREC["seq"]], layout="tp=2 x dp=2",
                        timed="the four ranks alone on the card"),
        moe=dict(router_loss=[aux2, aux1], dropped_share=[dropped2, dropped1],
                 tp_ep_losses=r0["tp_ep_losses"], ep1_losses=moe_ep1),
        coords=[r["coords"] for r in four], batch_s=batch_s, one_rank_s=one_s, spawn2_s=two_s,
        spawn4_s=four_s,
        rank_s=dict(two=two[0]["s"], four=four[0]["s"]),
        spawn_edges_s=dict(two=two_edges, four=four_edges),  # (start to fn, fn's end to join)
    )


def build_all() -> dict:
    """Every kernel library, one nvcc per source, all started together."""
    from genrec_tpu_torch.kernels.build import LIBRARIES, NVCC_FLAGS, build_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = dict(zip(LIBRARIES, pool.map(lambda n: build_library(n, verbose=True),
                                             LIBRARIES)))
    return dict(
        wall_s=time.perf_counter() - t0, flags=list(NVCC_FLAGS),
        libraries={n: dict(path=str(path.relative_to(HERE)), seconds=sec,
                           ptxas=ptxas_by_kernel(log))
                   for n, (path, sec, log) in built.items()},
    )


PHASES = ("kernels", "train", "parity", "sasrec", "rqvae", "serve", "cobra_serve",
          "tiger_spec_serve", "cobra_spec_serve", "serve_live", "tiger_train", "cobra_train",
          "retrieve", "lcrec_tp", "resume", "amazon", "notellm", "qwen_serve", "lcrec_lora",
          "pipeline", "tiger_tp", "qwen_tp4", "moe", "dp")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=384)
    ap.add_argument("--out", type=Path, help="also write every phase's JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="run more HSTU, TIGER, RQ-VAE and LCRec train steps and serve the TIGER "
                         "and COBRA traffic once more (fp32 and int8) under torch.profiler, "
                         "and report device time by kernel")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="run only these phases, comma-separated, in the script's order "
                         f"(default: all of {','.join(PHASES)}); env and build always run, "
                         "and the kernels line comes only from a run of all of them")
    worker = argv[1:3] if argv[:1] == ["--pipeline-worker"] else None
    args = ap.parse_args([] if worker else argv)
    chosen = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(chosen) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {', '.join(PHASES)}")
    full_run = set(chosen) == set(PHASES)

    def want(name) -> bool:
        return name in chosen

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    import genrec_tpu_torch

    if Path(genrec_tpu_torch.__file__).resolve().parents[1] != HERE:
        print(f"chip_smoke: genrec_tpu_torch imported from {genrec_tpu_torch.__file__}, "
              f"not from the checkout beside this script", file=sys.stderr)
        return 2
    if worker:
        return pipeline_worker(*worker)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    t_start = time.perf_counter()
    phases = {"env": emit(
        "env", nvidia_smi=smi, device=torch.cuda.get_device_name(dev),
        capability=list(torch.cuda.get_device_capability(dev)),
        device_count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0], phases=chosen,
    )}
    # The synthetic Beauty set (~20 s on the host, read by most phases) is
    # drawn while nvcc builds the kernels.
    with ThreadPoolExecutor(1) as pool:
        beauty = pool.submit(tiger_beauty_data, args.seed)
        phases["build"] = emit("build", **build_all())
        t0 = time.perf_counter()
        beauty.result()
        phases["build"]["beauty_wait_s"] = time.perf_counter() - t0
    libraries = phases["build"]["libraries"]
    paged_ptx = libraries["paged_attention"]["ptxas"]
    ptxas = libraries["fused_ce"]["ptxas"]
    kernels = {}
    if want("kernels"):
        kernels.update({
            "paged_attention_stats": kernel_phase(dev, args.seed, paged_ptx),
            "paged_attention_stats_quantized": quantized_kernel_phase(dev, args.seed, paged_ptx),
            "rq_cascade": rq_kernel_phase(dev, args.seed, libraries["rq_cascade"]["ptxas"]),
            "table_grad": table_grad_kernel_phase(dev, args.seed,
                                                  libraries["table_grad"]["ptxas"])})
        kernels.update(hstu_kernel_phase(dev, args.seed, libraries["hstu_attention"]["ptxas"]))
        for int8 in (False, True):
            row = cobra_kernel_phase(dev, args.seed, paged_ptx, int8)
            kernels[f"paged_attention_stats{'_quantized' if int8 else ''}_cobra"] = row
        for name in ("paged_attention_stats_tree", "paged_attention_stats_quantized_tree",
                     "paged_attention_stats_cobra_tree"):
            kernels[name] = tree_kernel_phase(dev, args.seed, paged_ptx, name)
        # The bf16 variants (a bf16 model's serving): B1 over bf16 pages at
        # TIGER's and COBRA's shapes and over TIGER's tree, B2 with a bf16 q.
        kernels["paged_attention_stats_bf16"] = kernel_phase(dev, args.seed, paged_ptx,
                                                             bf16=True)
        kernels["paged_attention_stats_quantized_bf16q"] = quantized_kernel_phase(
            dev, args.seed, paged_ptx, bf16q=True)
        kernels["paged_attention_stats_bf16_cobra"] = cobra_kernel_phase(
            dev, args.seed, paged_ptx, False, bf16=True)
        kernels["paged_attention_stats_quantized_bf16q_cobra"] = cobra_kernel_phase(
            dev, args.seed, paged_ptx, True, bf16=True)
        kernels["paged_attention_stats_bf16_tree"] = tree_kernel_phase(
            dev, args.seed, paged_ptx, "paged_attention_stats_bf16_tree")
        kernels["hstu_attention_fwd_retrieve"] = hstu_serving_kernel_phase(dev, args.seed)
        kernels.update(ce_kernel_phase(dev, args.seed, ptxas))
        kernels.update(ce_lcrec_kernel_phase(dev, args.seed, ptxas))
        phases["kernel_phases"] = kernels
    if want("train"):
        phases["train"] = train_phase(dev, args.seed, args.profile)
    if want("parity"):
        phases["parity"] = parity_phase(dev, args.seed)
    if want("sasrec"):
        phases["sasrec"] = sasrec_phase(dev, args.seed, ptxas, args.profile)
        kernels.update(phases["sasrec"]["kernels"])
    if want("rqvae"):
        phases["rqvae"] = rqvae_phase(dev, args.seed, args.profile)
    if want("serve"):
        phases["serve"], profiled, fp32_answers = serve_phase(dev, args.seed, args.requests,
                                                              args.profile)
        if profiled:
            phases["serve_profile"] = profiled
        phases["serve_int8"], profiled, _ = serve_phase(dev, args.seed, args.requests,
                                                        args.profile, kv_dtype="int8",
                                                        fp32_answers=fp32_answers)
        if profiled:
            phases["serve_int8_profile"] = profiled
        for kv_dtype in ("float32", "int8"):  # serve_bf16: the same weights computing in bf16
            phases["serve_bf16" + ("_int8" if kv_dtype == "int8" else "")] = serve_phase(
                dev, args.seed, args.requests, kv_dtype=kv_dtype, fp32_answers=fp32_answers,
                dtype=torch.bfloat16)[0]
    if want("cobra_serve"):
        phases["cobra_serve"], profiled, fp32_answers = cobra_serve_phase(
            dev, args.seed, args.requests, args.profile)
        if profiled:
            phases["cobra_serve_profile"] = profiled
        phases["cobra_serve_int8"], profiled, _ = cobra_serve_phase(
            dev, args.seed, args.requests, args.profile, kv_dtype="int8",
            fp32_answers=fp32_answers)
        if profiled:
            phases["cobra_serve_int8_profile"] = profiled
        for kv_dtype in ("float32", "int8"):  # cobra_serve_bf16
            phases["cobra_serve_bf16" + ("_int8" if kv_dtype == "int8" else "")] = \
                cobra_serve_phase(dev, args.seed, args.requests, kv_dtype=kv_dtype,
                                  fp32_answers=fp32_answers, dtype=torch.bfloat16)[0]
    if want("tiger_spec_serve"):
        phases["tiger_spec_serve"] = tiger_spec_serve_phase(dev, args.seed, args.requests)
        phases["tiger_spec_serve_int8"] = tiger_spec_serve_phase(dev, args.seed, args.requests,
                                                                 kv_dtype="int8")
        phases["tiger_spec_serve_bf16"] = tiger_spec_serve_phase(dev, args.seed, args.requests,
                                                                 dtype=torch.bfloat16)
    if want("cobra_spec_serve"):
        phases["cobra_spec_serve"] = cobra_spec_serve_phase(dev, args.seed, args.requests)
    if want("serve_live"):
        phases["serve_live"] = serve_live_phase(dev, args.seed, args.requests)
    if want("tiger_train"):
        phases["tiger_train"], tiger = tiger_train_phase(dev, args.seed, args.profile)
        phases["tiger_decode"] = tiger_decode_phase(dev, args.seed, tiger, args.profile)
        del tiger
    if want("cobra_train"):
        phases["cobra_train"] = cobra_train_phase(dev, args.seed, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    if want("retrieve"):
        phases["retrieve"] = retrieve_phase(dev, args.seed, args.profile)
    if want("lcrec_tp"):
        phases["lcrec_tp"] = lcrec_tp_phase(dev, args.seed, args.profile)
        kernels["sharded_fused_linear_ce"] = phases["lcrec_tp"]["b8"]
    if want("resume"):
        phases["resume"] = resume_phase(dev, args.seed)
    for name, phase in (("amazon", amazon_phase), ("notellm", notellm_phase),
                        ("qwen_serve", qwen_serve_phase), ("lcrec_lora", lcrec_lora_phase),
                        ("pipeline", pipeline_phase), ("tiger_tp", tiger_tp_phase)):
        if want(name):
            gc.collect()
            torch.cuda.empty_cache()
            phases[name] = phase(dev, args.seed)
    if want("qwen_tp4"):
        gc.collect()
        torch.cuda.empty_cache()
        lcrec = phases.get("lcrec_tp")
        phases["qwen_tp4"] = qwen_tp4_phase(
            dev, args.seed, tp1_losses=lcrec["parity"]["tp1_losses"] if lcrec else None,
            library_ms=lcrec["b8"]["library_ms"] if lcrec else None)
        kernels["sharded_fused_linear_ce_4"] = phases["qwen_tp4"]["b8"]
    if want("moe"):
        gc.collect()
        torch.cuda.empty_cache()
        phases["moe"] = moe_phase(dev, args.seed)
    if want("dp"):
        gc.collect()
        torch.cuda.empty_cache()
        tiger, moe = phases.get("tiger_tp"), phases.get("moe")
        phases["dp"] = dp_phase(dev, args.seed,
                                tiger_tp1=tiger["parity"]["tp1_losses"] if tiger else None,
                                moe_ep1=moe["parity"]["ep1_losses"] if moe else None)
    phases["wall_s"] = time.perf_counter() - t_start

    line = kernels_line(phases, kernels) if full_run else None
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({**phases, **(line or {})}, indent=1))
    if line is not None:
        print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def kernels_line(phases, kernels) -> dict:
    """The kernels line of a full run: every kernel's row, its launches on
    the main paths that ran it (each read just after that path)."""
    amazon = phases["amazon"]["launches"]
    dp = phases["dp"]["launches_per_rank"]  # rank 0's counts of the dp phase's paths
    tiger_steps = (phases["tiger_train"]["trainer"]["launches"]["table_grad"]
                   + phases["tiger_train"]["launches"]["table_grad"]
                   + amazon["tiger"]["table_grad"]
                   + sum(r["launches"]["table_grad"] for r in (phases["tiger_tp"]["trainer"],))
                   + dp["tiger"]["table_grad"])
    launches = {"paged_attention_stats": (phases["serve"]["paged_attention_launches"]
                                          + phases["tiger_decode"]["paged_attention_launches"]
                                          + phases["serve_live"]["paged_attention_launches"]
                                          + phases["pipeline"]["paged_attention_launches"]),
                "paged_attention_stats_quantized":
                    phases["serve_int8"]["paged_attention_launches"],
                # The amazon phase's launches join those of each kernel's
                # synthetic main path: HSTU's rows, SASRec's, LCRec's, B7's.
                "rq_cascade": (phases["rqvae"]["export"]["rq_cascade_launches"]
                               + sum(amazon[k]["rq_cascade"] for k in ("tiger", "lcrec", "p5"))
                               + dp["rq_cascade_export"]),
                **{k: phases["train"]["launches"][k] + amazon["hstu"][k] + dp["hstu"][k]
                   for k in LAUNCHES_PER_STEP},
                # The LoRA phase's: B3 and B4 dx once a step, B4 dW never.
                # qwen_tp4's and moe's: B3, B4 dx, B4 dW once a step a rank
                # (rank 0's counts).
                **{k + "_lcrec": (phases["lcrec_tp"]["steps"]["launches"][k] + amazon["lcrec"][k]
                                  + phases["lcrec_lora"]["launches"][k]
                                  + phases["qwen_tp4"]["steps"]["launches"][k]
                                  + phases["moe"]["steps"]["launches"][k]
                                  + dp["lcrec_bf16"][k])
                   for k in LCREC_LAUNCHES_PER_STEP},
                **{k + "_sasrec": (phases["sasrec"]["launches"][k] + amazon["sasrec"][k]
                                   + dp["sasrec"][k])
                   for k in SASREC_LAUNCHES_PER_STEP},
                "paged_attention_stats_cobra": (
                    phases["cobra_serve"]["paged_attention_launches"]
                    + phases["serve_live"]["paged_attention_launches_cobra"]),
                "paged_attention_stats_quantized_cobra":
                    phases["cobra_serve_int8"]["paged_attention_launches"],
                "hstu_attention_fwd_retrieve": phases["retrieve"]["launches"]["hstu_attention_fwd"],
                "paged_attention_stats_tree":
                    phases["tiger_spec_serve"]["paged_attention_launches"],
                "paged_attention_stats_quantized_tree":
                    phases["tiger_spec_serve_int8"]["paged_attention_launches"],
                "paged_attention_stats_cobra_tree":
                    phases["cobra_spec_serve"]["paged_attention_launches"],
                "paged_attention_stats_bf16": phases["serve_bf16"]["paged_attention_launches"],
                "paged_attention_stats_bf16_cobra":
                    phases["cobra_serve_bf16"]["paged_attention_launches"],
                "paged_attention_stats_bf16_tree":
                    phases["tiger_spec_serve_bf16"]["paged_attention_launches"],
                "paged_attention_stats_quantized_bf16q":
                    phases["serve_bf16_int8"]["paged_attention_launches"],
                "paged_attention_stats_quantized_bf16q_cobra":
                    phases["cobra_serve_bf16_int8"]["paged_attention_launches"],
                "sharded_fused_linear_ce": (phases["lcrec_tp"]["steps"]["b8_calls"]
                                            + dp["lcrec_bf16"]["sharded_fused_linear_ce"]),
                "sharded_fused_linear_ce_4": phases["qwen_tp4"]["b8"]["launches"],
                "table_grad": tiger_steps}
    return {"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "replaces_function": function, "launches": launches[name],
        "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
        "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
        "bound_by": kernels[name]["bound_by"], "library_ms": kernels[name]["library_ms"],
    } for name, (source, replaces, function) in KERNELS.items()]}


if __name__ == "__main__":
    sys.exit(main())
