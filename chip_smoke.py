#!/usr/bin/env python3
"""Drive the PyTorch port (m3p_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each of which fails the run if it fails:
  1. build every CUDA kernel of the port from m3p_tpu_torch/csrc/ (one
     nvcc per source, all started together);
  2. hold each kernel against its plain PyTorch version on the card, at
     small odd shapes and at the shapes the two paths give it: the packed
     attention forward at dropout rates 0 and 0.1, the backward at 0 and
     0.1, fp32 (CUDA cores) and bf16 in both designs (tensor cores, and
     forced to CUDA cores), with a batch row that has no valid key, at
     the decoder shapes (B = 4, H = 12, Dh = 64: causal (63, 63) and
     (100, 100), cross-attention (63, 100), (63, 164) and (100, 64)), and
     at phase 11's source encodings (the batch buckets of its calls over
     100 regions and over the 32-token text bucket), at phase 13's
     (`eval_shapes`: the grid's 512-pair chunks at joint widths 100, 116,
     132 and 164, the eval losses at B = 24 and 80, the generation
     sources at B = 64), and at phase 12's
     batch (B = 24: MASS's decoder, causal (64, 64) and cross (64, 128);
     BART's and AE's, causal (127, 127) and cross (127, 128); the stream
     encoder (128, 128); the PC pair (127, 127)); then
     the V = identity check (fp32, and bf16 through the tensor cores, also
     causal at the decoder's S = 63) that the forward, the backward and the
     plain version draw one Philox dropout mask;
  3. time each kernel, its plain version and the one-call PyTorch
     yardstick (SDPA, the autograd backward of SDPA replayed from a CUDA
     graph) at the paths' shapes, beside the least time the card needs;
     the packed forward's and backward's two designs in turns on the same
     tensors, at the caption decoder's two shapes (B = 24: causal
     (63, 63), cross (63, 100)) beside SDPA with ``is_causal``; at small
     shapes, where a call as issued reads the host's pace, the kernels and
     SDPA also replayed from CUDA graphs;
  4. serve the flagship width (12 blocks, 768d, 12 heads, 3 AoA refiner
     layers, 100 regions, 250002-word vocab, bf16 compute, random weights
     from the seed) over HTTP: /health, /v1/score with one and with 64
     pairs, a 1000-image gallery and /v1/retrieve; check the answers and
     that every attention call went through the kernel, on its tensor-core
     design; compare 4 pairs in fp32 on the card with the CPU;
  5. measure score pairs/s and retrieve latency, then trace score and
     retrieve with torch.profiler: the device's idle share and its time by
     kernel (the profiler's own host cost inflates the idle share);
  6. train: the ITM retrieval fine-tune step at the flagship width (dropout
     and attention dropout 0.1, BN = 80 = 20 groups x 4 candidates, fp32
     parameters, clip 5.0 + adam_inverse_sqrt), 2 warm-up and 8 timed
     steps: samples/s, step ms, peak memory, kernel launches per step
     (every forward and backward launch on the tensor-core design);
     fp32 gradients on the card against the CPU at depth 2 (rate 0); a
     learning check at depth 2 (50 steps on one batch); a profile of one
     training step;
  7. the long-context xMLM step (tools/bench_longseq.py's setup: B = 8
     streams of S = 2048 tokens, 12 blocks, 768d, 12 heads, 250002 words,
     dropout 0.1, attention dropout 0, FusedAdam with bf16 moments and an
     fp32 master, clip 5.0), 1 warm-up and 5 timed steps through the
     flash kernels: samples/s, tokens/s, step ms, peak memory, launches per
     step (12 flash forward, 24 flash backward, all on the tensor-core
     design, no packed), a profile of
     one step and an MFU reading; fp32 gradients on the card against the
     CPU at depth 2 and S = 640; a learning check at depth 2;
  8. the MCT pre-training step (m3p_tpu_torch.bench's setup, bench.py's:
     BN = 80 joint sequences of 100 regions + 64 tokens, 12 blocks, 768d,
     250002 words, dropout and attention dropout 0.1, ITM + MC-MLM + MC-MRM
     + MRFR, FusedAdam with bf16 moments and an fp32 master, clip 5.0),
     2 warm-up and 8 timed steps in two configurations: A, bench.py's
     (use_fused_dropout off), and B, every residual dropout through the
     fused dropout kernels: samples/s, step ms, peak memory, launches per
     step (15 packed forward and 30 packed backward, all on the tensor
     cores, 24 + 24 fused dropout in B, all "wide", none in A), a profile
     of one step and an
     MFU reading; one step of B
     with CLCM (launches doubled); fp32 gradients of the whole loss on the
     card against the CPU at depth 2 with CLCM and fused dropout at 0.1
     (the same seeds and masks on both sides); a learning check at depth 2;
  9. the head-major attention entry and the fused FFN tool path: #3/#4
     (csrc/small_attention.cu) against their plain versions (fp32 and
     bf16, rates 0 and 0.1, causal, Sq != Sk, a row with no valid key, odd
     shapes, the single-tile edge S = 512 at Dh 64 and 128, the flagship
     joint shape; #3 and #4 in bf16 in both designs), the V = identity
     check,
     `attention_bhsd` against the
     packed path on the same tensors and seed; the main path counted
     (`attention_bhsd` forward and backward with dropout at (80, 12, 164,
     64) bf16, three times, then S = 640 through the flash kernels and rate
     0 through `mha_reference`; every #3/#4 launch on the tensor cores);
     #3/#4 timed with CUDA events beside #1/#2 on packed copies (in turns),
     #3's and #4's two designs in turns, their
     plain versions, SDPA and its backward; #9 (csrc/fused_ffn.cu) against
     its plain version in every design each case reaches (fp32 and bf16,
     M in {1, 70, 13120, 13121}, (D, H) in {(64, 256), (768, 3072)},
     ragged widths, the "cluster" rule's edges M = 1, 63, 64, 65, 13121
     and D = 128, 256), against a flagship bf16 EncoderBlock's
     ln2(x + ffn(x)), and its main path counted: `python -m
     m3p_tpu_torch.bench_fused_ffn` at M = 13120, D = 768, H = 3072 in
     this process (kernel, plain version and the cuBLAS yardstick with
     CUDA events; all 34 launches "cluster"), then "cluster" and "tile32"
     in turns;
 10. decoder training at the flagship width (dropout and attention dropout
     0.1, bf16, fp32 parameters, clip 5.0 + adam_inverse_sqrt): the caption
     step (`caption_loss`, 24 images of 100 regions, captions of 64 tokens,
     T = 63 decoder positions, the refiner on), 2 warm-up and 8 timed
     steps: samples/s, target tokens/s, step ms, peak memory, an MFU
     reading, a profile of one step, launches per step (39 #1 and 78 #2,
     all on the tensor cores, no flash launch); one step each of
     `caption_loss(refine_encoder=True)`, `mt_loss`, `mt_caption_loss`,
     `tifg_loss`, `slide_loss` and, on its own model, `clm_loss` at B = 2
     streams of 2048 tokens (12 #5 and 24 #6, no packed launch), each
     step's launches checked; one caption step with `use_fused_dropout`
     (60 #7 and 60 #8, all "wide"); fp32 gradients of `caption_loss` on
     the card against the CPU at depth 2; a learning check at depth 2;
 11. generation at the flagship width, bf16 (random weights, a generated
     vocab of 250002 ids): `InferenceEngine.caption` (16 images of 10-100
     regions, the refiner on) and `.translate` (16 sentences of the
     32-token bucket), greedy and beam 5 at max_gen_len 20, and
     /v1/caption (through the batcher and the custom path) and
     /v1/translate over HTTP, each call's launches checked (15 #1 a
     caption call, 12 a translation, no kernel in the decode steps, whose
     attention takes `mha_reference` below 512 keys); the EOS rule of
     greedy lengths; caption and translate throughput (CUDA events over
     5 calls after 2, and 5 after 1), one call at the 64-image bucket with its
     peak memory, /v1/caption p50 / p99 over 12 requests, a profile of a
     beam-5 call, the decode step's parts (blocks, word head, stable
     top-k, self-cache gather); a beam-5 call at max_len 514 on a depth-2
     model, whose self-attention over the 514-position cache takes #5 in
     every step (2 x 513 launches, all on the tensor cores); #5 at that
     decode shape timed as issued and from a CUDA graph beside SDPA and
     the bound; fp32 greedy on the card, its tokens teacher-forced through
     the cached decoder on the card and the CPU, the logits compared;
 12. the denoising and adversarial objectives at the flagship width, FreeLB
     at the trainer's settings (K = 3 passes, adv_lr 1e-3, l2, no
     projection, text and image deltas): the FreeLB MCT step
     (`train/freelb.py::make_freelb_pretrain_step` over phase 8's model,
     batch and optimizer) in configurations A and B, 1 warm-up and 4
     timed steps: samples/s, step ms, peak memory, an MFU reading over K x
     the MCT step's FLOPs, launches per step (K x phase 8's), a profile of
     one step with the deltas' ascent as its own span; the trainer's
     is_freelb pair (the plain MCT step, then FreeLB) on B's model,
     counted; one step with adv_max_norm 1e-2 (every delta finite and
     inside the ball, which it reaches); the FreeLB ITM step over phase
     6's batch and the FreeLB caption step over phase 10's (deterministic,
     as in the JAX package; 1 warm-up and 2 timed steps each; the ITM
     step leaves the word table unmoved); one counted step each of MASS,
     BART (with --use_noise) and AE over one stream batch of 24 x 128
     through `data/loader.py`'s transforms, IDA (`caption_loss` over
     Poisson-noised regions) and PC (`concat_batches` pairs, width 127);
     fp32 gradients after the K passes on the card against the CPU at
     depth 2 (rate 0, one coin, masking and pair of initial deltas fed to
     both); a learning check at depth 2 (30 steps, one generator seed);
 13. evaluation at the flagship width, bf16 (random weights, phase 11's
     vocab): the full-grid retrieval test at tools/bench_eval_grid.py's
     shape (100 images of 100 regions x 500 captions of 8-20 tokens,
     chunk 512: 98 chunks, 15 #1 launches each, all on the tensor cores)
     through `Evaluator.run_all_evals` (R@k, the score matrix and
     inference.log), then once with and once without length buckets
     (pairs/s, MFU over `bench.joint_forward_flops`, the bucketed scores'
     largest difference and R@k), a profile of 3 chunks; the loss families
     (retrieval valid as (t2i, i2t) tuples of phase 6's grid, captioning,
     MT, NTG, multimodal MT, slide at B = 24, MLM and MASS over 24 streams
     of 128) through `run_all_evals`, counted, then again, bitwise equal;
     caption, MT and multimodal-MT generation evals at EvalConfig's
     defaults (beam 4, max_gen_len 40) over 64-row batches, MT and
     multimodal MT again greedy, the caption JSON artifact and the four
     caption metrics' host time; every #1 launch of the phase at a shape
     phase 2 held (`eval_shapes`); fp32 at depth 1 with a 32,002-word
     vocabulary on the card against the CPU (one batch of 2 a loss family and a small grid within rtol 1e-4,
     the grid within 1e-4, beam and greedy hypotheses of one row a family
     at max_gen_len 16 equal);
 14. the trainer (`python -m m3p_tpu_torch.cli.train_x`'s path: Trainer,
     the steps, Evaluator, checkpoints): (a) the reference MSCOCO
     fine-tune recipe (bf16, dropout 0.1, accumulation 4, refine_image
     off) with captioning beside retrieval through `train_x.main(argv,
     data=...)` at the flagship width, one epoch of 20 steps over
     in-memory batches (24 groups x 4 candidates, 24 captions), reloading
     a reference .pth written at one language more (the language table
     keeps its initial value): each step's #1/#2 launches (rel 24/48 a
     (t2i, i2t) pair, ic 36/72, all on the tensor cores), one update per
     4 micro-steps (parameters bitwise still in between), the logged lr at
     the applied update, ms a micro-step and samples/s beside phase 6's
     bare step, eval seconds an epoch, each checkpoint's bytes and save
     seconds, the final checkpoint restored bit for bit and timed, peak
     memory, the dump directory; (b) at depth 2: SIGTERM between
     micro-steps, the checkpoint at the next step boundary, a fresh
     Trainer reloading every tensor bit for bit, 8 micro-steps from it and
     from the uninterrupted run (losses within TOL_BF16, bitwise or not),
     SIGTERM's disposition restored; a FusedAdam state (bf16 moments, fp32
     master) bit for bit; (c) fp32 at depth 2: 4 micro-steps with
     accumulation 2 and weight decay on the card and on the CPU, the
     parameters' change per leaf within TOL_TRAINER_FP32;
 15. the datasets and the input pipeline: (a) `train_x.main(argv)` with no
     ``data=`` over a data directory the phase writes (phase 11's vocab,
     an English token stream, en-de parallel text): xMLM at bptt 256 and
     MT at 64 tokens, B = 24, the flagship width at depth 2, bf16, through
     the row loader (`data/row_pipeline.py`, 2 read threads); one epoch
     uninterrupted, the same run with SIGTERM after step 4 whose
     checkpoint ends the process, and a fresh `main` resuming it
     mid-epoch: each task's batches and the losses bitwise the
     uninterrupted run's, the loader positions in the checkpoint those of
     the batches the steps took, "resumed MID-EPOCH" in the log, each
     step's #1/#2 launches (xMLM 2/4, MT 6/12, all tensor cores); (b)
     phase 14's recipe with its batches from the ported `RetrievalDataset`
     and `CaptionDataset` over an in-memory store (400 images of 100
     regions x 2048) through the row loader: ms a micro-step over one
     epoch each with the recipe's 4 read threads, with 1, and with the
     datasets' ready-made batches in memory (phase 14's way), beside phase
     14's figure, the loader's records/s alone beside the records/s the
     steps consumed,
     the process's RSS, each step's launches; at depth 2, a checkpoint
     mid-epoch and a fresh Trainer taking the next batches bitwise.  Every
     #1/#2 launch of phases 14 and 15 at a shape phase 2 held;
 16. the rest of serving, flagship width, bf16: (a) the native tokenizer
     (built from the checkout by the host compiler in phase 1) against
     the pure-Python model over sentences of phase 15's generator, ids
     equal, encode_batch sentences/s in turns; phase 15(b)'s recipe with
     its datasets tokenizing natively and in Python, one epoch each in
     turns, and the loader alone; (b) `cli.preprocess` train-vocab native
     == python, spm-to-tsv and binarize round-tripping a write_spm file;
     (c) `cli.serve --quant int8 --load_gallery` through its own parser
     over an in-memory feature store and a saved checkpoint: /v1/score of
     1, 16 and 32 pairs (under and over the 2048-row int8 gate, each
     call's gate decisions and int8 GEMM routes checked), /v1/retrieve and
     a beam-5 /v1/caption over HTTP, 15 #1 launches per encode, every one
     at a held shape; the q8 capture's seconds and bytes; (d) the same
     checkpoint without --quant: retrieval top-1 and score differences
     (at the engine's chunk, above the gate, and at 16, int8), the share
     of caption tokens that agree, ms per score and caption call in
     turns, a decode step's device ms from a profile; (e) the int8 model
     in fp32 at depth 2, card vs CPU, each CPU GEMM handed the card's
     quantized activations: the int32 accumulators equal, the outputs
     within TOL_INT8_FP32 (and, running free, the share of activations
     quantized alike); (f) a caption eval with ``eval.quant="int8"``;
 17. the int8 training modes and the single-card model variants: (a)
     `int8_matmul_qbwd`, `int8_matmul` and `int8_matmul_nt` forward and
     backward in bf16 on the card and the CPU at the MCT FFN's shapes
     (13120 x 768 x 3072 and back), 16 rows, 1001 tokens (a wgrad
     contraction off the multiple of 8) and the tied 250,002-word head at
     320 rows: each CPU GEMM's quantized operands equal the card's, a share
     of its int32 accumulator recomputed from them equal, the outputs and
     int8 gradients bit for bit, the straight-through ones within
     TOL_BF16; (b) `m3p_tpu_torch.bench`'s MCT step under bench.py's
     ``int8_bwd`` and with the float FFN in turns on one model (none,
     int8, int8, none; 1 + 2 steps each), configurations A and B:
     samples/s, step ms, MFU, peak memory, launches and int8 GEMMs by
     route a step (24 forward and 48 backward an encode), a profile of a
     step of each; a learning check at depth 2 (30 steps); (c) one step
     each under ``ffn_quant`` "int8" and "int8_all" (the fused int8 QKV
     feeding #1/#2 on the tensor cores) and ``head_quant="int8_bwd"``;
     (d) the MCT step with 4 experts on every 2nd block (step ms, peak
     memory), a causal call refused, fp32 card vs CPU at depth 2 with the
     card's expert choices handed to the CPU; (e) the MCT step with the
     adaptive softmax head, a greedy caption call through it, its
     logsumexp about 0, fp32 card vs CPU at depth 2; (f) ``encode_text``
     with ``image_enc`` forward and backward, `CrossAlignMatrix`,
     `VaeEncoder` and `LatentDecoder` in fp32 card vs CPU; (g)
     `bench_eval_grid` bf16 and ``--int8`` in turns on 16 x 64 pairs.
 18. several processes, each phase's ranks launched with `python -m
     torch.distributed.run --standalone --nproc_per_node N chip_smoke.py
     --p18 <config>`, sharing this card over gloo (the backend rule of
     `parallel.mesh.choose_backend`; gloo takes the collectives' CUDA
     tensors, and the ring's point-to-point stages through pinned host
     memory): (a) data parallelism, phase 14's recipe through
     `train_x.main` on 2 ranks with ``--mesh_data 2`` (phase 15(b)'s
     datasets over InMemoryStore, dropout 0): the loss and Adam's first
     moment in bf16 at the flagship width and the losses and parameters
     in fp32 at depth 2 (32,002 words) against one process on the same
     global batches,
     SIGTERM on both ranks of the fp32 run after a micro-step and the
     resume bitwise the uninterrupted run (batches, losses, parameters),
     the gradient bytes
     all-reduced, #1/#2 launches and ms a micro-step per rank; (b)
     sequence parallelism, the long_context_config model over 4 ranks of
     a ``seq`` axis, the xMLM step at B = 4, S = 4096 through `SPModel`
     and ring attention (no #5/#6 inside), its ring bytes and ms a step;
     the fp32 depth-2 loss and every gradient against one process, whose
     attention takes #5/#6.  Times of ranks sharing one card are the cost
     of the path, not a parallel speed.
 19. parameter sharding, one launch of 4 ranks over gloo as in 18: (a) the
     scale-up preset (24 x 768, 12 heads, 250,002 words, 101 languages,
     bf16, remat) through `train_x.main` with ``--mesh_fsdp 2
     --mesh_tensor 2``, the MCT step, one warm-up and one timed
     micro-step: ms a step per rank, bytes all-gathered, reduce-scattered
     and all-reduced a step, each rank's bytes of parameters, gradients
     and optimizer state against one process's, peak memory, #1/#2
     launches per rank at 6 local heads; (b) at fp32 and depth 2 the MCT
     step on fsdp 2 x tensor 2 against one process (loss and parameters
     within 1e-5), a planted fault (the row-parallel all-reduce skipped)
     seen, tensor 2 alone at dropout and attention dropout 0.1 against one
     process; (c) MoE on data 2 x expert 2 against one process; (d) the
     checkpoint round trip sharded -> one process -> sharded, bitwise.  In
     this process: kernels #1-#6 over heads 6-11, 9-11 and 10-11 of 12
     (the Philox head offset of a rank of tensor 2, 5 and 8) against the
     slice of the call over all 12, and the preset's step peak memory with
     remat against without.
 22. heads that do not divide by ``tensor``, experts that do not divide
     by ``expert``: (a) one launch of 8 ranks over gloo as in 18, the
     scale-up preset through `train_x.main` with ``--mesh_tensor 8``
     (12 heads: 2 on ranks 0-5, none on ranks 6-7, the attention
     resharded between a rank's padded columns and its heads), one
     warm-up and one timed MCT step: ms a step per rank, the reshard's
     bytes beside the collectives', peak memory, #1/#2 launches per rank
     held to the count from the code; at fp32 and depth 2 the MCT step on
     tensor 8 against one process at rate 0 and at dropout and attention
     dropout 0.1 (within 1e-5), every rank calling the kernels at
     head_base 0 (a planted fault) seen; (b) on phase 19's launch, MoE
     with 6 experts over expert 4 (none on rank 3) against one process.
Phases 2 and 3 hold and time the flash kernels too, in both designs (bf16
on the tensor cores, fp32 and a bf16 Dh of 24 on CUDA cores; rates 0 and
0.1, causal, Sq != Sk, ragged tiles, a row with no valid key, the xMLM
shape, V = identity in fp32 and bf16; each call's design read from the
per-design launch counts; at the xMLM shape the two designs in turns on
the same tensors; #5 at phase 11's decode shape, one query over 514 keys
at B = 80, the mask filled to 1, 64, 513 and 514 keys, also through
`attention_bhsd`), and the fused dropout kernels (bit for bit against
their plain versions in fp32 and bf16 at rates 0.1 and 0.5, odd sizes,
unaligned views, the MCT shape, in the "wide" and the "narrow" design;
x = 1 mask identity; the two designs timed in turns).

The last line is {"ok": true, "device": {...}}; the line before it the
card's name and power limit; before that one JSON line with the kernels.
Exits non-zero without a CUDA device or outside a checkout of the repo.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
KERNELS = ["packed_attention", "packed_attention_bwd", "flash_attention",
           "flash_attention_bwd", "fused_dropout", "small_attention",
           "fused_ffn"]

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# kernel vs plain version: fp32 differs only in summation order; in bf16 the
# kernel and the plain version each round p and o (p, ds and the gradients
# in the backward) to bf16 once
TOL_FP32 = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=1.6e-2, atol=1e-2)
# gradients in fp32: sums over up to 512 rows or keys in another order
TOL_BWD_FP32 = dict(rtol=1e-4, atol=1e-5)
# fp32 gradients of the whole step on the card against the CPU, per leaf
# relative to the leaf's largest entry: 5 layers of fp32 GEMMs, attention
# kernels and reductions summed in another order
TOL_GRAD_FP32 = 1e-3
RATE = 0.1
SEED = 0x1234_5678_9ABC_DEF0
# the training slice (bench.py's spec without fused=1 and bf16 moments,
# which wait for the MCT pre-training slice)
OPTIM_SPEC = "adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.00005"
CLIP = 5.0
GROUPS, SAMPLE_N, TEXT_LEN, REGIONS = 20, 4, 64, 100
WARMUP_STEPS, TIMED_STEPS = 2, 8
# the long-context slice (tools/bench_longseq.py)
LONG_SPEC = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.00005,fused=1,"
             "mu_dtype=bfloat16,nu_dtype=bfloat16,master=1")
LONG_B, LONG_S, LONG_MAX_PRED = 8, 2048, 256
LONG_WARMUP, LONG_STEPS = 1, 5
# the fp32 comparison and the learning check: S above the packed 512
LONG_CHECK_S = 640
# a served score against the same pair scored in another batch (bf16 GEMMs
# may pick other kernels for another batch size)
TOL_SCORE_BF16 = 5e-2
# the fp32 model on the card against the CPU: 15 layers of fp32 GEMMs summed
# in another order
TOL_SCORE_FP32 = 1e-3

WORDS = ("a dog cat man woman child runs sits on the beach street sofa red "
         "blue green small large old young two three bicycle car bus train "
         "with near under over in at of and holding looking playing "
         "standing grass water snow field table kitchen room window").split()


def log(msg: str) -> None:
    print(msg, flush=True)


# seconds of each part of the run, from the end of the part before it;
# the parts of a phase ("sub") from the end of the sub-part before it; the
# seconds inside `profile_window` (sessions and their tables)
CLOCK = {"t": None, "sub": None, "laps": {}, "profile_s": 0.0,
         "profiles": 0}


def lap(name: str) -> None:
    """Log the seconds since the last lap (or the run's start) as
    ``name``'s, and keep them for the run's closing [clock] line."""
    now = time.time()
    CLOCK["laps"][name] = round(now - CLOCK["t"], 1)
    CLOCK["t"] = CLOCK["sub"] = now
    log(f"[clock] {name}: {CLOCK['laps'][name]} s")


def sublap(name: str) -> None:
    """Log the seconds since the last lap or sub-lap as ``name``'s, a part
    of the phase that the next `lap` closes."""
    now = time.time()
    log(f"[clock]   {name}: {now - CLOCK['sub']:.1f} s")
    CLOCK["sub"] = now


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def build_kernels():
    """Every CUDA source with nvcc and the native tokenizer with the host
    compiler, all started together."""
    from m3p_tpu_torch.ops import _build
    from m3p_tpu_torch.tokenization import native

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 1) as pool:
        host = pool.submit(_build.build_host, "m3ptok", native.SOURCES)
        paths = list(pool.map(_build.build, KERNELS))
        host_path = host.result()
    for name in KERNELS:
        _build.load(name)
    native.load_library()
    log(f"[build] {len(paths)} kernel(s) and the native tokenizer "
        f"({host_path.name}, {_build.cxx_path()}) built and loaded in "
        f"{time.time() - t0:.2f} s: {[p.name for p in paths]}")


# ---------------------------------------------------------------------------
# phase 2/3: kernel against plain version, and times
# ---------------------------------------------------------------------------


def attn_inputs(b, s_q, s_k, h, dh, dtype, gen, empty_row=True):
    import torch

    q = torch.randn(b, s_q, h * dh, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, s_k, h * dh, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, s_k, h * dh, device="cuda", generator=gen).to(dtype)
    lens = torch.randint(1, s_k + 1, (b,), device="cuda", generator=gen)
    if empty_row and b > 1:
        lens[1] = 0       # an engine padding row: no valid key at all
    mask = torch.arange(s_k, device="cuda")[None, :] < lens[:, None]
    return q, k, v, mask


# (B, Sq, Sk, causal, dtype) of every #1 case phase 2 held
# (kernel "fwd" / "bwd", B, Sq, Sk, causal, dtype, dropout on) of every
# case phase 2 holds against the plain version
HELD_SHAPES = set()


def check_kernels(gen):
    """#1 at rate 0 against its plain version: fp32 (CUDA cores) and bf16 in
    both designs (the one the rule names, the tensor cores at these
    shapes, and forced to CUDA cores), each call's design read from the
    per-design launch counts."""
    import torch

    from m3p_tpu_torch.ops import attention as ops
    from m3p_tpu_torch.ops.attention import (
        attention_packed, attention_packed_reference)

    flash_design = kernel_tests().flash_design
    counts = attention_packed.launches_by_design
    cases = [  # (B, Sq, Sk, H, Dh, dtype, causal, tolerance)
        (2, 40, 40, 3, 16, torch.float32, False, TOL_FP32),
        (2, 40, 40, 3, 16, torch.float32, True, TOL_FP32),
        (2, 10, 37, 3, 16, torch.float32, True, TOL_FP32),
        (3, 24, 24, 2, 8, torch.float32, False, TOL_FP32),
        (2, 512, 512, 2, 128, torch.float32, True, TOL_FP32),
    ]
    # the shapes the serving path gives the kernel: encoder blocks at
    # S = 100 regions + text bucket 64/16, refiner at S = 100, batch
    # buckets 64, 8 and 1
    for s in (164, 116, 100):
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16,
                                                    TOL_BF16)):
            cases.append((64, s, s, 12, 64, dt, False, tol))
    cases += [(8, 164, 164, 12, 64, torch.bfloat16, False, TOL_BF16),
              (1, 100, 100, 12, 64, torch.bfloat16, False, TOL_BF16)]
    # the decoder shapes (phase 10's): causal self-attention over T = 63
    # and TIFG's 100 regions, cross-attention over 100 regions, the
    # 164-token joint encoding and a 64-token caption
    for sq, sk, causal in decoder_shapes():
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16,
                                                    TOL_BF16)):
            cases.append((4, sq, sk, 12, 64, dt, causal, tol))
    # the caption step's two decoder shapes at its B = 24, as phase 3 times
    # them and phase 10 runs them
    for sk, causal in caption_kv_shapes():
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16,
                                                    TOL_BF16)):
            cases.append((CAPTION_B, CAPTION_LEN - 1, sk, 12, 64, dt,
                          causal, tol))
    # phase 11's source encoder (image regions, text bucket) at the batch
    # buckets of its calls, keys padded as the engine pads them
    for b, s in generation_source_shapes():
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16,
                                                    TOL_BF16)):
            cases.append((b, s, s, 12, 64, dt, False, tol))
    # phase 12's MASS, BART / AE, stream encoder and PC shapes at its batch
    for sq, sk, causal in checked_denoising_shapes():
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16,
                                                    TOL_BF16)):
            cases.append((STREAM_B, sq, sk, 12, 64, dt, causal, tol))
    # phase 13's shapes (`eval_shapes`): the grid's chunks, the loss
    # families and the generation source encoders
    for b, sq, sk, causal in eval_shapes():
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16,
                                                    TOL_BF16)):
            if (b, sq, sk, 12, 64, dt, causal, tol) not in cases:
                cases.append((b, sq, sk, 12, 64, dt, causal, tol))
    # phase 14's (`trainer_shapes`): the trainer's steps and its evals;
    # phase 15's (`dataset_shapes`); phase 16's (`quant_shapes`)
    for b, sq, sk, causal in trainer_shapes()["fwd"] + \
            dataset_shapes()["fwd"] + quant_shapes():
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16,
                                                    TOL_BF16)):
            if (b, sq, sk, 12, 64, dt, causal, tol) not in cases:
                cases.append((b, sq, sk, 12, 64, dt, causal, tol))
    worst = {}
    for b, sq, sk, h, dh, dt, causal, tol in cases:
        HELD_SHAPES.add(("fwd", b, sq, sk, causal,
                         str(dt).replace("torch.", ""), False))
        q, k, v, mask = attn_inputs(b, sq, sk, h, dh, dt, gen)
        want = attention_packed_reference(q, k, v, mask, h, causal=causal)
        rule = flash_design(dt, dh)
        name = str(dt).replace("torch.", "")
        for design in [None] + (["cuda_cores"] if rule == "tensor_cores"
                                else []):
            before = dict(counts)
            if design is None:
                got = attention_packed(q, k, v, mask, h, causal=causal)
            else:
                got = ops._launch_fwd(q, k, v, mask, h, causal, dh ** -0.5,
                                      0.0, None, design)
            torch.cuda.synchronize()
            took = launched_design(counts, before, 1)
            if took != (design or rule):
                fail(f"packed forward {(b, sq, sk, h, dh)} {dt}: took "
                     f"{took}, expected {design or rule}")
            shape = (b, sq, sk, h, dh)
            err = _compare(got, want, tol,
                           f"packed forward {shape} {dt} {took}")
            log(f"[check] packed_attention B={b} Sq={sq} Sk={sk} H={h} "
                f"Dh={dh} {name} causal={causal} {took}: max|kernel-plain| "
                f"= {err:.3e} (rtol {tol['rtol']}, atol {tol['atol']})")
            key = name if dt == torch.float32 else f"{name}_{took}"
            worst[key] = max(worst.get(key, 0.0), err)
    # the comparison has teeth: the causal kernel is far from a full one,
    # every key valid (a draw of one valid key in the first row and none
    # in the second would make the two agree)
    q, k, v, mask = attn_inputs(2, 40, 40, 3, 16, torch.float32, gen)
    mask = torch.ones_like(mask)
    off = (attention_packed(q, k, v, mask, 3, causal=True)
           - attention_packed_reference(q, k, v, mask, 3)).abs().max().item()
    if off < 0.1:
        fail(f"causal and full attention agree ({off}); check is vacuous")
    return worst


def _compare(got, want, tol, what):
    """max |got - want| after checking finiteness and the tolerance."""
    import torch

    if not torch.isfinite(got).all():
        fail(f"{what}: the kernel gave non-finite values")
    err = (got.float() - want.float()).abs().max().item()
    try:
        torch.testing.assert_close(got, want, **tol)
    except AssertionError as exc:
        fail(f"{what}: kernel and plain version disagree: {exc}")
    return err


def check_dropout_and_backward(gen):
    """#1 at rate 0.1 and #2 at rates 0 and 0.1 against their plain
    versions: small odd shapes (causal, Sq != Sk both ways), the largest
    shape the kernels take at Dh 64 and 128, the decoder shapes at B = 4,
    and the training shapes (B = 80; encoder blocks at S = 164, the refiner
    at S = 100; the caption step's B = 24, causal (63, 63) and cross
    (63, 100); phase 12's `denoising_shapes` at B = 24; phase 14's
    `trainer_shapes`), each with a batch row that has no valid key.  #2 in fp32 (CUDA cores) and bf16 in both
    designs: the one the rule names (the tensor cores at these shapes,
    CUDA cores at Dh 8) and forced to CUDA cores, each call's design read
    from the per-design launch counts."""
    import torch

    from m3p_tpu_torch.ops import attention as ops
    from m3p_tpu_torch.ops.attention import (
        attention_packed, attention_packed_bwd,
        attention_packed_bwd_reference, attention_packed_reference)

    f32, bf16 = torch.float32, torch.bfloat16
    flash_design = kernel_tests().flash_design
    odd = [  # (B, Sq, Sk, H, Dh, causal)
        (2, 40, 40, 3, 16, False),
        (2, 40, 40, 3, 16, True),
        (2, 10, 37, 3, 16, True),
        (2, 37, 10, 2, 32, True),
        (3, 24, 24, 2, 8, False),
        (2, 512, 512, 2, 128, True),
        (2, 512, 512, 4, 64, False),
    ] + [(4, sq, sk, 12, 64, causal) for sq, sk, causal in decoder_shapes()]
    cases = [(b, sq, sk, h, dh, dt, causal) for dt in (f32, bf16)
             for b, sq, sk, h, dh, causal in odd]
    for s_ in (164, 100):
        cases += [(80, s_, s_, 12, 64, f32, False),
                  (80, s_, s_, 12, 64, bf16, False)]
    for sk, causal in caption_kv_shapes():   # the caption step's, B = 24
        cases += [(CAPTION_B, CAPTION_LEN - 1, sk, 12, 64, dt, causal)
                  for dt in (f32, bf16)]
    for sq, sk, causal in checked_denoising_shapes():   # phase 12's
        cases += [(STREAM_B, sq, sk, 12, 64, dt, causal)
                  for dt in (f32, bf16)]
    for b, sq, sk, causal in trainer_shapes()["bwd"] + \
            dataset_shapes()["bwd"]:                    # phases 14, 15
        cases += [(b, sq, sk, 12, 64, dt, causal) for dt in (f32, bf16)
                  if (b, sq, sk, 12, 64, dt, causal) not in cases]
    worst = {"fwd": {}, "bwd": {}}

    def note(kind, name, err):
        worst[kind][name] = max(worst[kind].get(name, 0.0), err)

    for b, sq, sk, h, dh, dt, causal in cases:
        tol_f = TOL_FP32 if dt == f32 else TOL_BF16
        tol_b = TOL_BWD_FP32 if dt == f32 else TOL_BF16
        q, k, v, mask = attn_inputs(b, sq, sk, h, dh, dt, gen)
        do = torch.randn(b, sq, h * dh, device="cuda", generator=gen).to(dt)
        shape = f"B={b} Sq={sq} Sk={sk} H={h} Dh={dh} {dt} causal={causal}"
        want = attention_packed_reference(q, k, v, mask, h, causal=causal,
                                          dropout_rate=RATE,
                                          dropout_seed=SEED)
        name = str(dt).replace("torch.", "")
        HELD_SHAPES.update([("fwd", b, sq, sk, causal, name, True),
                            ("bwd", b, sq, sk, causal, name, False),
                            ("bwd", b, sq, sk, causal, name, True)])
        rule = flash_design(dt, dh)
        msg = []
        for design in ([None] if dt == f32 else [None, "cuda_cores"]):
            before = dict(attention_packed.launches_by_design)
            if design is None:
                got = attention_packed(q, k, v, mask, h, causal=causal,
                                       dropout_rate=RATE, dropout_seed=SEED)
            else:
                got = ops._launch_fwd(q, k, v, mask, h, causal, dh ** -0.5,
                                      RATE, SEED, design)
            torch.cuda.synchronize()
            took = launched_design(attention_packed.launches_by_design,
                                   before, 1)
            if took != (design or rule):
                fail(f"packed forward {shape}: took {took}, expected "
                     f"{design or rule}")
            err = _compare(got, want, tol_f,
                           f"forward rate {RATE} {took} {shape}")
            note("fwd", name if dt == f32 else f"{name}_{took}", err)
            msg.append(f"fwd rate {RATE} {took} {err:.3e}")
        for rate in (0.0, RATE):
            seed = SEED if rate else None
            want = attention_packed_bwd_reference(q, k, v, mask, do, h,
                                                  causal, None, rate, seed)
            for design in ([None] if dt == f32 else [None, "cuda_cores"]):
                before = dict(attention_packed.bwd_launches_by_design)
                if design is None:
                    got = attention_packed_bwd(q, k, v, mask, do, h, causal,
                                               None, rate, seed)
                else:
                    got = ops._launch_bwd(q, k, v, mask, do, h, causal,
                                          dh ** -0.5, rate, seed, design)
                torch.cuda.synchronize()
                took = launched_design(attention_packed.bwd_launches_by_design,
                                       before, 2)
                if took != (design or rule):
                    fail(f"packed backward {shape}: took {took}, expected "
                         f"{design or rule}")
                errs = [_compare(g, w, tol_b, f"backward d{n} rate {rate} "
                                              f"{took} {shape}")
                        for n, g, w in zip("qkv", got, want)]
                note("bwd", name if dt == f32 else f"{name}_{took}",
                     max(errs))
                msg.append(f"bwd rate {rate} {took} dq/dk/dv " + "/".join(
                    f"{e:.3e}" for e in errs))
        log(f"[check] {shape}: max|kernel-plain| " + "; ".join(msg)
            + f" (tolerance fwd {tol_f}, bwd {tol_b})")
    # the comparison has teeth: dropout changes the output
    q, k, v, mask = attn_inputs(2, 40, 40, 3, 16, f32, gen)
    off = (attention_packed(q, k, v, mask, 3, dropout_rate=RATE,
                            dropout_seed=SEED)
           - attention_packed(q, k, v, mask, 3)).abs().max().item()
    if off < 0.1:
        fail(f"dropout does not change the output ({off}); check is vacuous")
    return worst


def kernel_tests():
    """tests/test_torch_kernels.py (it imports no JAX), loaded by path."""
    import importlib.util

    path = REPO / "tests" / "test_torch_kernels.py"
    spec = importlib.util.spec_from_file_location("test_torch_kernels", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def decoder_shapes():
    """(Sq, Sk, causal) of the decoder paths' attention, as the `gpu` tests
    hold them (`DECODER_CASES`)."""
    return [(sq, sk, causal)
            for _, _, _, sq, sk, _, causal in kernel_tests().DECODER_CASES]


def checked_denoising_shapes():
    """`denoising_shapes`, after checking that the `gpu` tests hold the
    same ones (`DENOISING_CASES`, at B = STREAM_B, 12 heads of 64)."""
    shapes = denoising_shapes()
    cases = kernel_tests().DENOISING_CASES
    held = [(sq, sk, causal) for _, _, _, sq, sk, _, causal in cases]
    if held != shapes or {c[:3] for c in cases} != {(STREAM_B, 12, 64)}:
        fail(f"DENOISING_CASES {held} are not phase 12's shapes {shapes}")
    return shapes


def caption_kv_shapes():
    """(Sk, causal) of the caption step's decoder attention over its
    T = 63 positions: causal self-attention, cross-attention over the 100
    regions."""
    return [(CAPTION_LEN - 1, True), (REGIONS, False)]


def check_mask_identity(flash=False, dtype=None, causal_t63=False):
    """V = identity on the card: the forward kernel's zeros are the plain
    version's Philox mask, and the backward kernel's dv^T (dO = identity)
    is the forward's output; the packed kernels at S = 64 (with
    ``causal_t63`` causal at the decoder's S = 63, 64-wide heads), or the
    flash kernels at S = 96 (two key tiles, the second ragged), in fp32 or
    in bf16 through the tensor-core design.  The check is the one the `gpu`
    tests run (tests/test_torch_kernels.py, which imports no JAX)."""
    import torch

    from m3p_tpu_torch.ops.attention import attention_flash, attention_packed

    module = kernel_tests()
    rate = 0.25
    dtype = dtype or torch.float32
    kw = dict(attn=attention_flash, s=96) if flash else {}
    if causal_t63:
        kw = dict(s=63, dh=64, causal=True)
    name = ("flash" if flash else "packed") + " " + str(dtype)[6:] + (
        " causal S=63" if causal_t63 else "")
    before = [dict(attention_flash.launches_by_design),
              dict(attention_flash.bwd_launches_by_design),
              dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design)]
    try:
        share = module.check_mask_identity("cuda", rate=rate, dtype=dtype,
                                           **kw)
    except AssertionError as exc:
        fail(f"V=I mask identity ({name}): {exc!r}")
    design = module.flash_design(dtype, 96 if flash else 64)
    if flash:   # two forward launches (with dropout, plain), one backward
        took = (launched_design(attention_flash.launches_by_design,
                                before[0], 2),
                launched_design(attention_flash.bwd_launches_by_design,
                                before[1], 2))
    else:       # the same with the packed kernels
        took = (launched_design(attention_packed.launches_by_design,
                                before[2], 2),
                launched_design(attention_packed.bwd_launches_by_design,
                                before[3], 2))
    if took != (design, design):
        fail(f"V=I mask identity ({name}): took {took}, expected {design}")
    name += f", {design}"
    log(f"[check] V=I mask identity of the {name} kernels at rate {rate}: "
        f"forward == plain Philox mask, backward dv^T == forward output, "
        f"keep share {share:.4f}")
    return share


# cuda_ms's window without an explicit count: back-to-back calls for about
# CUDA_MS_WINDOW ms, at least CUDA_MS_MIN_ITERS and at most 50 of them (a
# call of 2 ms or less gets 50, as every timing once had; a 10-20 ms
# CUDA-core or plain-version call reads the same mean from 10)
CUDA_MS_WINDOW, CUDA_MS_MIN_ITERS = 100.0, 10


def cuda_ms(fn, iters=None, warmup=5):
    """ms a call of ``fn``, CUDA events around ``iters`` back-to-back
    calls after ``warmup``; ``iters`` None sizes the window from the last
    warm-up call's host time (`CUDA_MS_WINDOW`)."""
    import torch

    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    if warmup:
        fn()
        torch.cuda.synchronize()
    if iters is None:
        once = (time.perf_counter() - t) * 1e3
        iters = int(min(50, max(CUDA_MS_MIN_ITERS,
                                CUDA_MS_WINDOW / max(once, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, flops):
    """(least ms, "bytes" or "operations") on the H100 SXM peaks."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def time_kernels(gen):
    """#1 at the serving shapes (B = 64, S = 164 and 100, bf16, rate 0):
    the tensor-core design (the path's) and the CUDA-core design on the
    same tensors in turns, the plain version, SDPA with the same boolean
    mask."""
    import torch
    import torch.nn.functional as F

    from m3p_tpu_torch.ops import attention as ops
    from m3p_tpu_torch.ops.attention import attention_packed_reference

    out = {}
    for label, s in (("blocks", 164), ("refiner", 100)):
        b, h, dh = 64, 12, 64
        q, k, v, mask = attn_inputs(b, s, s, h, dh, torch.bfloat16, gen,
                                    empty_row=False)
        qh, kh, vh = (t.view(b, s, h, dh).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        sdpa_mask = mask[:, None, None, :]

        def fwd(design=None):
            return lambda: ops._launch_fwd(q, k, v, mask, h, False,
                                           dh ** -0.5, 0.0, None, design)

        before = dict(ops.attention_packed.launches_by_design)
        fwd()()
        torch.cuda.synchronize()
        if launched_design(ops.attention_packed.launches_by_design, before,
                           1) != "tensor_cores":
            fail(f"packed forward {label}: the serving shape does not take "
                 f"the tensor-core design")
        ms, ms_cc = in_turns(fwd(), fwd("cuda_cores"))
        plain_ms = cuda_ms(lambda: attention_packed_reference(q, k, v, mask,
                                                              h))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=sdpa_mask))
        n_bytes = (3 * b * s * h * dh + b * s * h * dh) * 2 + b * s
        flops = 4 * b * h * s * s * dh
        bound_ms, bound_by = bound(n_bytes, flops)
        out[label] = {
            "shape": {"B": b, "Sq": s, "Sk": s, "H": h, "Dh": dh,
                      "dtype": "bfloat16"},
            "design": "tensor_cores", "ms": ms, "ms_cuda_cores": ms_cc,
            "speedup_over_cuda_cores": ms_cc / ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "flops": flops,
        }
        log(f"[time] packed_attention {label} B={b} S={s} bf16, in turns "
            f"(CUDA events): tensor cores {ms:.4f} ms, CUDA cores "
            f"{ms_cc:.4f} ms ({ms_cc / ms:.2f}x); plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return out


def device_ms(fn, iters=50, warmup=5, launches=None, attempts=3):
    """Device time per call of ``fn``: the summed device time of every
    kernel it launches, from torch.profiler over ``iters`` calls.  Unlike
    `cuda_ms` it does not read the host's pace, which sets the time of
    back-to-back calls to kernels shorter than their launch cost.

    Late in a long process the profiler has recorded no kernel at all, or
    a third of them (#3 read 0.43 ms against 1.25 ms from CUDA events and
    from the trace of a fresh process).  So with ``launches``
    (kernels per call) the profile must hold iters x launches kernel
    records; one that does not is taken again, up to ``attempts`` times,
    and then fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in kernels)
        records = sum(e.count for e in kernels)
        if total_us > 0 and (launches is None
                             or records == iters * launches):
            return total_us / 1e3 / iters
        log(f"[profile] attempt {attempt + 1}: {records} kernel records "
            f"for {iters} calls, {total_us:.1f} us; taken again")
    fail("torch.profiler recorded an incomplete profile")


def host_us(fn, calls=200):
    """Host microseconds per call of ``fn`` over ``calls`` calls queued
    without a synchronize in between."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def in_turns(fn_a, fn_b):
    """cuda_ms of two functions timed in the order a, b, b, a: the mean of
    each one's two readings, so neither gains from going second."""
    a1, b1, b2, a2 = (cuda_ms(f) for f in (fn_a, fn_b, fn_b, fn_a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def sdpa_bwd_ms(q, k, v, mask, do, causal=False):
    """SDPA's autograd backward on head-major (B, H, S, D) q, k, v with the
    boolean key mask (None: every key valid) and output gradient ``do``,
    rate 0, ``causal`` as SDPA's ``is_causal``: its ms replayed
    from a CUDA graph, so that autograd's host cost per call (0.2-0.4 ms,
    as long as the kernels at these shapes) does not pace the reading; the
    same call timed with CUDA events as it is issued (host-paced where the
    host is slower); and the backend PyTorch dispatches these inputs to (a
    boolean mask rules out the flash one).  #2 and #4 are held to the
    graph's reading.  Called after `time_fused_dropout`: in a run where an
    earlier version of this helper (a CUDA graph and a CUDA-only
    torch.profiler session) ran first, the profiler then lost one kernel
    record of the 50 that `device_ms` demands there, in every attempt."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    attn_mask = None if mask is None else mask[:, None, None, :]
    backend = SDPBackend(torch._fused_sdp_choice(
        q, k, v, attn_mask, is_causal=causal)).name
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                             is_causal=causal)

        def call():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)

        for _ in range(3):
            call()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return {"library_ms": cuda_ms(graph.replay),
            "library_ms_issued": cuda_ms(call), "backend": backend}


def graph_ms(fn):
    """ms a call of ``fn`` (stream work only, no autograd) takes replayed
    from a CUDA graph after three calls on a side stream: the device's
    pace, where issuing the call from Python takes longer than its
    kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return cuda_ms(graph.replay)


def attended_pairs(b, sq, sk, causal):
    """The (query, key) pairs the products cover for every head: all of
    them, or under an end-aligned causal diagonal those with key <= query +
    Sk - Sq."""
    if not causal:
        return b * sq * sk
    return b * sum(min(sk, i + sk - sq + 1) for i in range(sq))


def time_packed_pair(label, b, sq, sk, causal, gen, full_mask=False):
    """#1 and #2 on one bf16 shape (H = 12, Dh = 64): each one's
    tensor-core design (the path's) and CUDA-core design on the same
    tensors in turns, #1 at rate 0.1 (and the path's design at rate 0), #2
    at rates 0 and 0.1; the plain versions; SDPA on the same inputs at rate
    0 (the same function; SDPA's own dropout draws other bits) with the
    boolean key mask, or with ``full_mask`` every key valid and no mask
    (``is_causal`` for a causal shape), for #2 its autograd backward
    replayed from a CUDA graph (`sdpa_bwd_ms`); the kernels' calls and
    SDPA's forward replayed from CUDA graphs too (`graph_ms`): where a call
    as issued takes longer than its kernels, the times as issued read the
    host's pace.  Bounds from the pairs the products cover
    (`attended_pairs`)."""
    import torch
    import torch.nn.functional as F

    from m3p_tpu_torch.ops import attention as ops
    from m3p_tpu_torch.ops.attention import (
        attention_packed, attention_packed_bwd_reference,
        attention_packed_reference)

    h, dh = 12, 64
    q, k, v, mask = attn_inputs(b, sq, sk, h, dh, torch.bfloat16, gen,
                                empty_row=False)
    if full_mask:
        mask = torch.ones_like(mask)
    do = torch.randn(b, sq, h * dh, device="cuda",
                     generator=gen).to(torch.bfloat16)
    heads = [t.view(b, t.shape[1], h, dh).transpose(1, 2).contiguous()
             for t in (q, k, v, do)]
    lib_mask = None if full_mask else mask
    lib_causal = causal and full_mask

    def fwd(rate, design=None):
        seed = SEED if rate else None
        return lambda: ops._launch_fwd(q, k, v, mask, h, causal,
                                       dh ** -0.5, rate, seed, design)

    def bwd(rate, design=None):
        seed = SEED if rate else None
        return lambda: ops._launch_bwd(q, k, v, mask, do, h, causal,
                                       dh ** -0.5, rate, seed, design)

    before = (dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design))
    fwd(RATE)()
    bwd(0.0)()
    torch.cuda.synchronize()
    if (launched_design(attention_packed.launches_by_design, before[0], 1),
            launched_design(attention_packed.bwd_launches_by_design,
                            before[1], 2)) != ("tensor_cores",) * 2:
        fail(f"packed kernels {label}: the shape does not take the "
             f"tensor-core design")
    fwd_ms, fwd_cc = in_turns(fwd(RATE), fwd(RATE, "cuda_cores"))
    fwd0_ms = cuda_ms(fwd(0.0))
    fwd_plain_ms = cuda_ms(lambda: attention_packed_reference(
        q, k, v, mask, h, causal, dropout_rate=RATE, dropout_seed=SEED))
    fwd_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *(t.view(b, t.shape[1], h, dh).transpose(1, 2) for t in (q, k, v)),
        attn_mask=None if lib_mask is None else lib_mask[:, None, None, :],
        is_causal=lib_causal))
    ms, ms_cc = in_turns(bwd(0.0), bwd(0.0, "cuda_cores"))
    drop_ms, drop_cc = in_turns(bwd(RATE), bwd(RATE, "cuda_cores"))
    plain_ms = cuda_ms(lambda: attention_packed_bwd_reference(
        q, k, v, mask, do, h, causal))
    plain_drop_ms = cuda_ms(lambda: attention_packed_bwd_reference(
        q, k, v, mask, do, h, causal, None, RATE, SEED))
    lib = sdpa_bwd_ms(*heads[:3], lib_mask, heads[3], lib_causal)
    library_ms = lib["library_ms"]
    fwd_graph = {"ms_graph": graph_ms(fwd(RATE)),
                 "ms_rate_0_graph": graph_ms(fwd(0.0)),
                 "library_ms_graph": graph_ms(
                     lambda: F.scaled_dot_product_attention(
                         *heads[:3], attn_mask=None if lib_mask is None
                         else lib_mask[:, None, None, :],
                         is_causal=lib_causal))}
    bwd_graph = {"ms_graph": graph_ms(bwd(0.0)),
                 "ms_rate_0.1_graph": graph_ms(bwd(RATE)),
                 "ms_cuda_cores_graph": graph_ms(bwd(0.0, "cuda_cores"))}
    q_elems, k_elems = b * sq * h * dh, b * sk * h * dh
    pairs = attended_pairs(b, sq, sk, causal) * h
    # q, k, v, dO in; dq, dk, dv out; the mask
    bwd_bytes = (3 * q_elems + 4 * k_elems) * 2 + b * sk
    bwd_flops = 10 * pairs * dh   # QK^T, dO V^T, P^T dO, dS^T Q, dS K
    fwd_bytes = (2 * q_elems + 2 * k_elems) * 2 + b * sk
    fwd_flops = 4 * pairs * dh
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_flops)
    fwd_bound, fwd_by = bound(fwd_bytes, fwd_flops)
    out = {
        "shape": {"B": b, "Sq": sq, "Sk": sk, "H": h, "Dh": dh,
                  "causal": causal, "dtype": "bfloat16",
                  "every_key_valid": full_mask},
        "bwd": {"ms": ms, "ms_rate_0.1": drop_ms, "plain_ms": plain_ms,
                "plain_ms_rate_0.1": plain_drop_ms,
                "design": "tensor_cores", "ms_cuda_cores": ms_cc,
                "ms_cuda_cores_rate_0.1": drop_cc,
                "speedup_over_cuda_cores": ms_cc / ms,
                "speedup_over_cuda_cores_rate_0.1": drop_cc / drop_ms,
                "tflops_per_s": bwd_flops / ms / 1e9,
                "library_ms": library_ms,
                "library_ms_issued": lib["library_ms_issued"],
                "library_backend": lib["backend"],
                "bound_ms": bwd_bound,
                "bound_by": bwd_by, "bytes": bwd_bytes,
                "flops": bwd_flops, **bwd_graph},
        "fwd_rate_0.1": {"ms": fwd_ms, "ms_rate_0": fwd0_ms,
                         "design": "tensor_cores",
                         "ms_cuda_cores": fwd_cc,
                         "speedup_over_cuda_cores": fwd_cc / fwd_ms,
                         "plain_ms": fwd_plain_ms,
                         "library_ms": fwd_lib_ms,
                         "bound_ms": fwd_bound, "bound_by": fwd_by,
                         "bytes": fwd_bytes, "flops": fwd_flops,
                         **fwd_graph},
    }
    shape = f"B={b} Sq={sq} Sk={sk} causal={causal} bf16"
    log(f"[time] packed_attention_bwd {label} {shape}, in turns "
        f"(CUDA events): tensor cores {ms:.4f} ms (rate 0.1: "
        f"{drop_ms:.4f}), CUDA cores {ms_cc:.4f} (rate 0.1: "
        f"{drop_cc:.4f}), {ms_cc / ms:.2f}x / {drop_cc / drop_ms:.2f}x; "
        f"plain {plain_ms:.4f} (rate 0.1: {plain_drop_ms:.4f}), sdpa "
        f"backward {library_ms:.4f} ({lib['backend']}, CUDA graph; "
        f"{lib['library_ms_issued']:.4f} as issued), bound "
        f"{bwd_bound:.4f} ms ({bwd_by})")
    log(f"[time] packed_attention_fwd rate 0.1 {label} {shape}, in turns "
        f"(CUDA events): tensor cores {fwd_ms:.4f} ms, "
        f"CUDA cores {fwd_cc:.4f} ({fwd_cc / fwd_ms:.2f}x); rate 0 "
        f"{fwd0_ms:.4f}; plain {fwd_plain_ms:.4f}, sdpa (rate 0) "
        f"{fwd_lib_ms:.4f}, bound {fwd_bound:.4f} ms ({fwd_by})")
    log(f"[time] packed_attention {label} {shape}, replayed from CUDA "
        f"graphs: fwd rate 0.1 {json.dumps(fwd_graph)}, bwd "
        f"{json.dumps(bwd_graph)}")
    return out


def time_training_kernels(gen):
    """#1 and #2 at the ITM and MCT steps' shapes (B = 80, bf16; the 12
    encoder blocks at S = 164, the refiner at S = 100), random key
    lengths (`time_packed_pair`)."""
    b = GROUPS * SAMPLE_N
    return {label: time_packed_pair(label, b, s, s, False, gen)
            for label, s in (("blocks", 164), ("refiner", 100))}


def time_decoder_kernels(gen):
    """#1 and #2 at the caption step's two decoder shapes (B = 24, T = 63
    positions): causal self-attention (63, 63) and cross-attention over the
    100 regions (63, 100), every key valid as in the timed step's batch
    (all 100 regions; the self shape beside SDPA's ``is_causal``)
    (`time_packed_pair`)."""
    return {label: time_packed_pair(f"decoder {label}", CAPTION_B,
                                    CAPTION_LEN - 1, sk, causal, gen,
                                    full_mask=True)
            for label, (sk, causal) in zip(("self", "cross"),
                                           caption_kv_shapes())}


# ---------------------------------------------------------------------------
# phase 4/5: the serving slice at full width
# ---------------------------------------------------------------------------


def write_vocab(path: str, n_pieces: int = 0) -> None:
    """A small unigram TSV vocab: one piece per word, then letters; with
    ``n_pieces``, numbered pieces up to that many (no text of `WORDS`
    contains a digit, so the words encode as before)."""
    pieces = [("▁" + w, -4.0) for w in WORDS]
    pieces += [(c, -9.0) for c in "abcdefghijklmnopqrstuvwxyz"]
    pieces += [("▁", -8.0)]
    pieces += [(f"▁{i}", -20.0) for i in range(n_pieces - len(pieces))]
    with open(path, "w", encoding="utf-8") as f:
        for piece, score in pieces:
            f.write(f"{piece}\t{score}\n")


def sentence(rng, n_words):
    return " ".join(rng.choice(WORDS, size=n_words))


def image(rng, n_boxes=None):
    import numpy as np

    n = int(rng.randint(10, 101)) if n_boxes is None else n_boxes
    feats = np.maximum(rng.randn(n, 2048), 0).astype(np.float32)
    boxes = np.sort(rng.rand(n, 2, 2) * 600, axis=1).reshape(n, 4)
    return {"features": feats, "boxes": boxes, "wh": [600.0, 600.0]}


def as_json(img):
    return {"features": img["features"].round(4).tolist(),
            "boxes": img["boxes"].round(2).tolist(), "wh": img["wh"]}


def post(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            fail(f"{path} answered {resp.status}")
        return json.loads(resp.read())


def full_width_config(dtype):
    from m3p_tpu_torch.config import ModelConfig

    return ModelConfig(n_words=250002, mask_index=250001, n_langs=2,
                       emb_dim=768, n_layers=12, n_heads=12, hidden_dim=3072,
                       refine_layers=3, max_region_num=100, dropout=0.0,
                       attention_dropout=0.0, dtype=dtype)


def cpu_model_from_card(cfg, seed):
    """``build_model(cfg, seed)`` drawn on the card and moved to the CPU:
    the CPU's truncated normal over a 250,002 x 768 word table takes
    seconds, the card's no time.  A card-vs-CPU check holds both sides on
    the same weights, whichever device drew them."""
    from m3p_tpu_torch.model import build_model

    return build_model(cfg, seed, "cuda").to("cpu")


def serve_slice(seed, tokenizer):
    import numpy as np
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.ops.attention import attention_packed
    from m3p_tpu_torch.serve.engine import InferenceEngine
    from m3p_tpu_torch.serve.server import make_server

    rng = np.random.RandomState(seed)
    cfg = full_width_config("bfloat16")
    t0 = time.time()
    model = build_model(cfg, seed, "cuda")
    engine = InferenceEngine(model, tokenizer, device="cuda",
                             max_regions=cfg.max_region_num)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[serve] model built on the card: {n_params} parameters, "
        f"{time.time() - t0:.2f} s")
    gallery = [image(rng) for _ in range(1000)]
    t0 = time.time()
    engine.load_gallery(gallery, [f"img{i}" for i in range(1000)])
    log(f"[serve] gallery of 1000 images staged in {time.time() - t0:.2f} s")
    per_pass = cfg.n_layers + cfg.refine_layers
    layers = {"blocks": cfg.n_layers, "refiner": cfg.refine_layers}

    server, app = make_server(engine, host="127.0.0.1", port=0,
                              max_body_bytes=512 * 1024 * 1024)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    passes = 0
    try:
        # ---- the main path, counted ----
        zero_launch_counts()
        health = post(base, "/health")
        if health.get("status") != "ok" or health["devices"] != ["cuda"]:
            fail(f"/health: {health}")
        one_text, one_img = sentence(rng, 8), image(rng)
        single = post(base, "/v1/score", {"pairs": [
            dict(text=one_text, **as_json(one_img))]})["scores"]
        passes += 1
        texts = [sentence(rng, int(rng.randint(36, 60))) for _ in range(64)]
        imgs = [image(rng) for _ in range(64)]
        t0 = time.time()
        multi = post(base, "/v1/score", {"pairs": [
            dict(text=t, **as_json(i)) for t, i in zip(texts, imgs)]})[
            "scores"]
        passes += 1
        log(f"[serve] /v1/score 64 pairs over HTTP: "
            f"{(time.time() - t0) * 1e3:.1f} ms (JSON included)")
        queries = [sentence(rng, int(rng.randint(4, 12))) for _ in range(5)]
        results = []
        for qtext in queries:
            res = post(base, "/v1/retrieve", {"text": qtext,
                                              "top_k": 5})["results"]
            passes += -(-1000 // engine.batch_buckets[-1])
            results.append(res)
        # the top-5 of each query scored pairwise through /v1/score
        pairwise = []
        for qtext, res in zip(queries, results):
            idx = [int(r["id"][3:]) for r in res]
            pairwise.append(post(base, "/v1/score", {"pairs": [
                dict(text=qtext, **as_json(gallery[i])) for i in idx]})[
                "scores"])
            passes += 1
        launches = attention_packed.launches
        by_design = dict(attention_packed.launches_by_design)
        # ---- checks ----
        if len(single) != 1 or len(multi) != 64:
            fail("wrong number of scores")
        if not np.isfinite(single + multi).all():
            fail("non-finite scores")
        if launches != per_pass * passes:
            fail(f"{launches} kernel launches for {passes} forward passes; "
                 f"expected {per_pass} per pass")
        if by_design["tensor_cores"] != launches:
            fail(f"forward launches by design {by_design}: not every bf16 "
                 f"#1 launch took the tensor cores")
        log(f"[serve] kernel launches {launches} = {per_pass} x {passes} "
            f"forward passes, by design {by_design}")
        worst = 0.0
        for res, pw in zip(results, pairwise):
            vals = [r["score"] for r in res]
            if len(res) != 5 or vals != sorted(vals, reverse=True):
                fail(f"retrieve results not best-first: {vals}")
            if not np.isfinite(vals).all():
                fail("non-finite retrieve scores")
            diff = float(np.max(np.abs(np.array(vals) - np.array(pw))))
            worst = max(worst, diff)
        if worst > TOL_SCORE_BF16:
            fail(f"retrieve vs /v1/score differ by {worst}")
        log(f"[serve] retrieve top-5 vs pairwise /v1/score: max |diff| = "
            f"{worst:.3e} (tolerance {TOL_SCORE_BF16})")
        solo = engine.score([texts[0]], [imgs[0]])[0]
        log(f"[serve] a pair alone vs in the 64-pair batch: |diff| = "
            f"{abs(solo - multi[0]):.3e}")
        if abs(solo - multi[0]) > TOL_SCORE_BF16:
            fail("score depends on the batch it rides in")

        # ---- serving numbers ----
        numbers = measure_serving(engine, base, texts, imgs, queries, rng)
        profile_window("score 64 pairs x bucket 64",
                       lambda: engine.score(texts, imgs))
        profile_window("retrieve over 1000 images",
                       lambda: engine.retrieve(queries[0], top_k=5))
    finally:
        server.shutdown()
        server.server_close()
        app.close()
        thread.join(timeout=30)
    if thread.is_alive():
        fail("server thread did not stop")
    numbers["launches"] = launches
    numbers["launches_by_design"] = by_design
    numbers["launches_per_forward"] = per_pass
    numbers["layers"] = layers
    return engine, numbers


# /v1/retrieve requests timed one after another
SERVE_RETRIEVES = 12


def measure_serving(engine, base, texts, imgs, queries, rng):
    import numpy as np
    import torch

    ids = engine.tokenizer.encode_batch(texts, max_ids=62)
    if min(len(s) for s in ids) + 2 <= 32:
        fail("the throughput texts do not fill the 64-token bucket")
    engine.score(texts, imgs)
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.score(texts, imgs)
    pairs_per_s = 64 * reps / (time.perf_counter() - t0)

    # the device part of one 64-pair pass at S = 164
    from m3p_tpu_torch.tokenization.tokenizer import batch_sentences

    toks, lens, _ = batch_sentences(ids, max_len=64)
    res = [engine.resolve_image(i) for i in imgs]
    dev = engine.device
    args = (torch.from_numpy(toks).long().to(dev),
            torch.from_numpy(lens).long().to(dev),
            torch.from_numpy(np.stack([r[0] for r in res])).to(dev),
            torch.from_numpy(np.stack([r[1] for r in res])).to(dev),
            torch.tensor([r[2] for r in res], device=dev))
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: engine._forward(*args), iters=20,
                             warmup=3)

    post(base, "/v1/retrieve", {"text": queries[0], "top_k": 5})
    lat = []
    for i in range(SERVE_RETRIEVES):
        qtext = queries[i % len(queries)]
        t0 = time.perf_counter()
        post(base, "/v1/retrieve", {"text": qtext, "top_k": 5})
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p99 = (float(x) for x in np.percentile(lat, [50, 99]))
    log(f"[perf] score: {pairs_per_s:.1f} pairs/s at 64 pairs x text "
        f"bucket 64 (engine.score, host prep included); one 64 x 164 "
        f"forward on the device: {forward_ms:.3f} ms")
    log(f"[perf] retrieve over 1000 images (HTTP, {SERVE_RETRIEVES} "
        f"queries): p50 "
        f"{p50:.1f} ms, p99 {p99:.1f} ms")
    return {"score_pairs_per_s": pairs_per_s, "forward_ms_64x164": forward_ms,
            "retrieve_p50_ms": p50, "retrieve_p99_ms": p99}


def kernel_group(name: str) -> str:
    low = name.lower()
    if "fused_dropout" in low:
        return "fused dropout"
    if "flash_attention_bwd" in low:
        return "flash_attention_bwd"
    if "flash_attention" in low:
        return "flash_attention"
    if "packed_attention_bwd" in low:
        return "packed_attention_bwd"
    if "packed_attention" in low:
        return "packed_attention"
    if "bernoulli" in low:
        return "dropout masks"
    if "sort" in low:
        return "sort"
    if "indexselect" in low.replace("_", ""):
        return "index_select"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                              "cublas")):
        if any(s in low for s in ("_s8", "i8", "imma", "int8")):
            return "gemm (int8)"
        return "gemm"
    if "layer_norm" in low:
        return "layer_norm"
    if "bfloat16_copy" in low:
        return "casts to bf16"
    return "other"


def profile_window(label, fn, reps=1, spans=()) -> dict:
    """torch.profiler over ``reps`` calls of ``fn`` (after one untraced
    call): wall and device-busy ms per call, the device's idle share, and
    device time by kernel group and by kernel, logged on one line.  Each
    name in ``spans``, a `torch.profiler.record_function` range of the
    path, reports the device time of the kernels launched inside it (its
    kernels stay in their groups too)."""
    entered = time.time()
    try:
        return _profile_window(label, fn, reps, spans)
    finally:
        CLOCK["profile_s"] += time.time() - entered
        CLOCK["profiles"] += 1


def _profile_window(label, fn, reps, spans):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the device's activity alone unless a span needs the host's ranges: a
    # host-paced call traced op by op runs slower and its trace takes
    # seconds to read
    activities = ([ProfilerActivity.CPU] if spans else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in spans]
    if not events:
        log(f"[profile] {label}: the profiler recorded no device time; "
            f"not measured")
        return {}
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / reps
    groups = {}
    for e in events:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / reps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / wall_ms,
           "traced": [a.name for a in activities],
           "groups_ms": {g: groups[g] for g in sorted(groups,
                                                      key=groups.get,
                                                      reverse=True)},
           "top_kernels": [{"name": e.key[:90], "calls": e.count // reps,
                            "ms": e.self_device_time_total / 1e3 / reps}
                           for e in top]}
    if spans:
        spent = {name: span_device_ms(averages, name) for name in spans}
        out["spans_ms"] = {name: None if ms is None else ms / reps
                           for name, ms in spent.items()}
    log(f"[profile] {label} (per call, {reps} calls): {json.dumps(out)}")
    return out


def span_device_ms(averages, name):
    """Device ms of the kernels launched inside the record_function range
    ``name``: the range's own device-side record where the profiler makes
    one, else the device time its host-side record collects from the
    operators inside it; None when neither holds any."""
    from torch.autograd import DeviceType

    for e in averages:
        if e.key == name and e.device_type == DeviceType.CUDA:
            return e.self_device_time_total / 1e3
    for e in averages:
        if e.key == name and e.device_type == DeviceType.CPU:
            total = getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0))
            return total / 1e3 if total else None
    return None


def compare_fp32_with_cpu(seed, tokenizer):
    import numpy as np

    from m3p_tpu_torch.serve.engine import InferenceEngine

    rng = np.random.RandomState(seed + 1)
    cfg = full_width_config("float32")
    cpu_model = cpu_model_from_card(cfg, seed)
    gpu_model = copy.deepcopy(cpu_model)
    texts = [sentence(rng, n) for n in (3, 9, 20, 40)]
    imgs = [image(rng, n) for n in (100, 36, 10, 64)]
    on_gpu = InferenceEngine(gpu_model, tokenizer, device="cuda").score(
        texts, imgs)
    on_cpu = InferenceEngine(cpu_model, tokenizer, device="cpu").score(
        texts, imgs)
    diff = float(np.max(np.abs(np.array(on_gpu) - np.array(on_cpu))))
    log(f"[fp32] 4 pairs, card vs CPU (plain attention): max |diff| = "
        f"{diff:.3e} (tolerance {TOL_SCORE_FP32}); scores {on_gpu}")
    if not np.isfinite(on_gpu).all() or diff > TOL_SCORE_FP32:
        fail("fp32 scores on the card disagree with the CPU")
    return diff


# ---------------------------------------------------------------------------
# phase 6: the training slice
# ---------------------------------------------------------------------------


def train_config(n_layers=12, dtype="bfloat16", rate=RATE):
    return dataclasses.replace(full_width_config(dtype), n_layers=n_layers,
                               dropout=rate, attention_dropout=rate)


def train_batch(seed, device, groups=GROUPS):
    import numpy as np
    import torch

    from m3p_tpu_torch.data.synthetic import make_retrieval_batch

    batch = make_retrieval_batch(np.random.RandomState(seed), groups,
                                 SAMPLE_N, TEXT_LEN, REGIONS, 250002)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def itm_step(deterministic=False, with_grad_norm=False):
    from m3p_tpu_torch.train.steps import itm_finetune_loss, make_train_step

    return make_train_step(functools.partial(
        itm_finetune_loss, sample_n=SAMPLE_N, deterministic=deterministic),
        with_grad_norm=with_grad_norm)


def train_slice(seed):
    """The ITM fine-tune step at the flagship width: 2 warm-up and 8 timed
    steps, every attention call through the kernels in both directions."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.ops.attention import attention_packed
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    cfg = train_config()
    t0 = time.time()
    model = build_model(cfg, seed, "cuda")
    tx, schedule = build_optimizer(OPTIM_SPEC, clip_grad_norm=CLIP)
    state = create_train_state(model, tx)
    step = itm_step(with_grad_norm=True)
    gens = Generators.from_seed(seed, "cuda")
    batch = train_batch(seed, "cuda")
    bn = batch["tokens"].shape[0]
    watched = {n: p.detach().clone() for n, p in model.named_parameters()
               if n in ("block_0.attn.q_lin.weight", "itm_pooler.score.weight",
                        "refiner.layer_0.aoa_attn.aoa.weight")}
    log(f"[train] model, optimizer state and batch (BN={bn}) on the card in "
        f"{time.time() - t0:.2f} s")
    per_step = (cfg.n_layers + cfg.refine_layers, 2 * (cfg.n_layers
                                                       + cfg.refine_layers))
    n_steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    # ---- the main path, counted ----
    zero_launch_counts()
    for i in range(n_steps):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            wall0 = time.perf_counter()
            start.record()
        state, m = step(state, batch, gens)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall0
    launches = (attention_packed.launches, attention_packed.bwd_launches)
    fwd_by_design = dict(attention_packed.launches_by_design)
    by_design = dict(attention_packed.bwd_launches_by_design)
    # ---- checks ----
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    norms = torch.stack([m["grad_norm"] for m in metrics]).float().cpu()
    if not torch.isfinite(losses).all() or not torch.isfinite(norms).all():
        fail(f"non-finite training loss or gradient norm: {losses.tolist()}")
    if launches != (per_step[0] * n_steps, per_step[1] * n_steps):
        fail(f"{launches} forward/backward kernel launches in {n_steps} "
             f"steps; expected {per_step} per step")
    if by_design["tensor_cores"] != launches[1]:
        fail(f"backward launches by design {by_design}: not every bf16 #2 "
             f"launch took the tensor cores")
    if fwd_by_design["tensor_cores"] != launches[0]:
        fail(f"forward launches by design {fwd_by_design}: not every bf16 "
             f"#1 launch took the tensor cores")
    moved = {n: (p.detach() - watched[n]).abs().max().item()
             for n, p in model.named_parameters() if n in watched}
    if state.step != n_steps or not all(v > 0 for v in moved.values()):
        fail(f"the parameters did not change: {moved}")
    numbers = {
        "samples_per_s": bn * TIMED_STEPS / (step_ms * TIMED_STEPS / 1e3),
        "step_ms": step_ms, "wall_step_ms": wall_s * 1e3 / TIMED_STEPS,
        "peak_memory_gb": peak_gb, "bn": bn,
        "launches": {"fwd": launches[0], "bwd": launches[1]},
        "launches_per_step": {"fwd": per_step[0], "bwd": per_step[1]},
        "fwd_launches_by_design": fwd_by_design,
        "bwd_launches_by_design": by_design,
        "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
        "lr_last": schedule(state.step - 1),
    }
    log(f"[train] {n_steps} steps at BN={bn}, 12 blocks + 3 refiner layers, "
        f"dropout {RATE}, attention dropout {RATE}: {step_ms:.2f} ms a step "
        f"(CUDA events, {TIMED_STEPS} steps), {numbers['samples_per_s']:.1f} "
        f"samples/s, host wall {numbers['wall_step_ms']:.2f} ms a step, peak "
        f"memory {peak_gb:.2f} GB; kernel launches fwd {launches[0]} = "
        f"{per_step[0]} x {n_steps}, bwd {launches[1]} = {per_step[1]} x "
        f"{n_steps} (by design: fwd {fwd_by_design}, bwd {by_design}); loss "
        f"{losses[0].item():.4f} -> "
        f"{losses[-1].item():.4f}; "
        f"max |param change| {moved}")
    numbers["profile"] = profile_window(
        f"one training step BN={bn}", lambda: step(state, batch, gens),
        reps=1)
    return numbers


def worst_grad_diff(gpu_model, cpu_model):
    """(worst relative |card - CPU| over the gradient leaves, its leaf,
    leaves compared): each leaf against its largest entry; a key bias,
    whose gradient is zero up to rounding (the softmax ignores a per-row
    shift), against the model's largest gradient."""
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    largest = max(g.abs().max().item() for g in cpu_grads.values()
                  if g is not None)
    worst, worst_name, leaves = 0.0, "", 0
    for name, p in gpu_model.named_parameters():
        want = cpu_grads[name]
        if (p.grad is None) != (want is None):
            fail(f"gradient of {name} on one side only")
        if want is None:
            continue
        leaves += 1
        diff = (p.grad.cpu() - want).abs().max().item()
        scale = largest if name.endswith("k_lin.bias") else \
            want.abs().max().item()
        err = diff / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name, leaves


def compare_grads_with_cpu(seed):
    """fp32 gradients of the whole loss at depth 2 and full width, on the
    card (kernels) and on the CPU (plain versions), at rate 0."""
    import torch

    from m3p_tpu_torch.train.steps import itm_finetune_loss

    from m3p_tpu_torch.ops.attention import attention_packed

    cfg = train_config(n_layers=2, dtype="float32", rate=0.0)
    cpu_model = cpu_model_from_card(cfg, seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    losses = {}
    before = (dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design))
    for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
        batch = train_batch(seed + 2, dev, groups=2)
        loss, _ = itm_finetune_loss(model, batch, None, SAMPLE_N,
                                    deterministic=True)
        loss.backward()
        losses[dev] = loss.item()
    # fp32 exercises the CUDA-core designs: 5 attention layers, one forward
    # and two backward launches each
    if (launched_design(attention_packed.launches_by_design, before[0], 5),
            launched_design(attention_packed.bwd_launches_by_design,
                            before[1], 10)) != ("cuda_cores",) * 2:
        fail("the fp32 gradient check did not take the CUDA-core design")
    worst, worst_name, leaves = worst_grad_diff(gpu_model, cpu_model)
    log(f"[fp32 grads] depth 2, BN={2 * SAMPLE_N}, rate 0: loss card "
        f"{losses['cuda']:.6f} vs CPU {losses['cpu']:.6f}; {leaves} leaves, "
        f"max relative |card - CPU| = {worst:.3e} ({worst_name}; tolerance "
        f"{TOL_GRAD_FP32})")
    if worst > TOL_GRAD_FP32 or abs(losses["cuda"] - losses["cpu"]) > 1e-4:
        fail("fp32 gradients on the card disagree with the CPU")
    return worst


def learning_check(seed, steps=50):
    """Depth 2 at full width, one fixed batch, "adam,lr=0.0001", dropout on:
    the mean loss of the last 5 steps must be below that of the first 5."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    model = build_model(train_config(n_layers=2), seed + 3, "cuda")
    tx, _ = build_optimizer("adam,lr=0.0001")
    state = create_train_state(model, tx)
    step = itm_step()
    gens = Generators.from_seed(seed + 3, "cuda")
    batch = train_batch(seed + 3, "cuda")
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, gens)
        losses.append(m["loss"])
    losses = torch.stack(losses).float().cpu()
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    log(f"[learn] depth 2, BN={batch['tokens'].shape[0]}, {steps} steps of "
        f"adam lr 1e-4 on one batch: mean loss of the first 5 steps "
        f"{first:.4f}, of the last 5 {last:.4f}")
    if not torch.isfinite(losses).all() or not last < first:
        fail(f"the model did not learn: {losses.tolist()}")
    return {"first5": first, "last5": last}


# ---------------------------------------------------------------------------
# phases 2/3 for the flash kernels (#5, #6)
# ---------------------------------------------------------------------------


def flash_inputs(b, s_q, s_k, h, dh, dtype, gen, full=False):
    """q, k, v, dO and a key mask: random lengths with batch row 1 empty,
    or every key valid (``full``, the xMLM path's mask)."""
    import torch

    q, k, v, mask = attn_inputs(b, s_q, s_k, h, dh, dtype, gen,
                                empty_row=not full)
    if full:
        mask = torch.ones_like(mask)
    do = torch.randn(b, s_q, h * dh, device="cuda", generator=gen).to(dtype)
    return q, k, v, mask, do


def flash_grads_pair(q, k, v, mask, do, h, causal, rate, seed):
    """(kernel dq/dk/dv, plain dq/dk/dv, the design the backward took): the
    plain backward reads the kernel forward's output, and the plain
    forward's statistics."""
    import torch

    from m3p_tpu_torch.ops.attention import (
        attention_flash, attention_flash_bwd_reference,
        attention_flash_reference)

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = attention_flash(*leaves, mask, h, causal, None, rate, seed)
    before = dict(attention_flash.bwd_launches_by_design)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    design = launched_design(attention_flash.bwd_launches_by_design, before,
                             2)
    _, stats = attention_flash_reference(q, k, v, mask, h, causal, None,
                                         rate, seed, return_stats=True)
    want = attention_flash_bwd_reference(q, k, v, mask, out.detach(), stats,
                                         do, h, causal, None, rate, seed)
    return got, want, design


def launched_design(counts, before, n):
    """The one design whose count rose, by ``n``, since ``before``."""
    rose = {d: counts[d] - before[d] for d in counts if counts[d] != before[d]}
    if len(rose) != 1 or list(rose.values()) != [n]:
        fail(f"launches by design rose by {rose}; expected {n} launches of "
             f"one design")
    return next(iter(rose))


def check_flash_kernels(gen):
    """#5 and #6 against their plain versions at rates 0 and 0.1, in both
    designs: small odd shapes (several tiles, ragged last tiles, Sq != Sk
    both ways with the causal offset, a row with no valid key, Dh 16, 64,
    128) in fp32 (CUDA cores) and bf16 (tensor cores), one bf16 shape the
    CUDA-core design takes (Dh 24), the long-context shape B = 8,
    S = 2048 in fp32 and bf16, and phase 10's causal CLM shape B = 2,
    S = 2047 in fp32 and bf16.  Each call's design is read from the
    per-design launch counts and held to the rule."""
    import torch

    from m3p_tpu_torch.ops.attention import (
        attention_flash, attention_flash_reference)

    f32, bf16 = torch.float32, torch.bfloat16
    flash_design = kernel_tests().flash_design
    odd = [  # (B, Sq, Sk, H, Dh, causal, every key valid)
        (2, 200, 200, 2, 16, False, False),
        (2, 200, 200, 2, 16, True, False),
        (2, 70, 300, 2, 16, True, False),
        (2, 300, 70, 2, 16, True, False),
        (2, 130, 577, 3, 64, False, False),
        (1, 96, 160, 2, 128, True, False),
    ]
    cases = [(b, sq, sk, h, dh, dt, causal, full)
             for dt in (f32, bf16)
             for b, sq, sk, h, dh, causal, full in odd]
    cases += [
        (2, 150, 260, 2, 24, bf16, True, False),     # CUDA cores in bf16
        (2, 1030, 1030, 12, 64, bf16, False, False),
        (LONG_B, LONG_S, LONG_S, 12, 64, f32, False, True),
        (LONG_B, LONG_S, LONG_S, 12, 64, bf16, False, True),
        # phase 10's CLM: S - 1 = 2047 causal positions, the last key
        # tile ragged and crossed by the diagonal; every key valid as on
        # the path, and in bf16 random lengths with an empty row too
        (CLM_B, LONG_S - 1, LONG_S - 1, 12, 64, f32, True, True),
        (CLM_B, LONG_S - 1, LONG_S - 1, 12, 64, bf16, True, True),
        (CLM_B, LONG_S - 1, LONG_S - 1, 12, 64, bf16, True, False),
    ]
    worst = {"fwd": {}, "bwd": {}}
    for b, sq, sk, h, dh, dt, causal, full in cases:
        tol_f = TOL_FP32 if dt == f32 else TOL_BF16
        tol_b = TOL_BWD_FP32 if dt == f32 else TOL_BF16
        q, k, v, mask, do = flash_inputs(b, sq, sk, h, dh, dt, gen, full)
        design = flash_design(dt, dh)
        name = str(dt).replace("torch.", "")
        key = name if dt == f32 else f"{name}_{design}"
        shape = (f"B={b} Sq={sq} Sk={sk} H={h} Dh={dh} {name} "
                 f"causal={causal}")
        msg = []
        for rate in (0.0, RATE):
            seed = SEED if rate else None
            before = dict(attention_flash.launches_by_design)
            got = attention_flash(q, k, v, mask, h, causal, None, rate, seed)
            torch.cuda.synchronize()
            took = launched_design(attention_flash.launches_by_design,
                                   before, 1)
            want = attention_flash_reference(q, k, v, mask, h, causal, None,
                                             rate, seed)
            err = _compare(got, want, tol_f, f"flash forward rate {rate} "
                                             f"{shape}")
            worst["fwd"][key] = max(worst["fwd"].get(key, 0.0), err)
            got, want, took_bwd = flash_grads_pair(q, k, v, mask, do, h,
                                                   causal, rate, seed)
            if (took, took_bwd) != (design, design):
                fail(f"flash {shape}: the forward took {took} and the "
                     f"backward {took_bwd}; the rule names {design}")
            errs = [_compare(g, w, tol_b, f"flash backward d{n} rate {rate} "
                                          f"{shape}")
                    for n, g, w in zip("qkv", got, want)]
            worst["bwd"][key] = max(worst["bwd"].get(key, 0.0), max(errs))
            msg.append(f"rate {rate}: fwd {err:.3e}, dq/dk/dv "
                       + "/".join(f"{e:.3e}" for e in errs))
            del got, want
        log(f"[check] flash {shape} ({design}): max|kernel-plain| "
            + "; ".join(msg) + f" (tolerance fwd {tol_f}, bwd {tol_b})")
        del q, k, v, mask, do
        torch.cuda.empty_cache()
    worst["decode"] = check_flash_decode_shape(gen)
    # the comparison has teeth: causal and dropout change the output
    for dt in (f32, bf16):
        q, k, v, mask, _ = flash_inputs(2, 200, 200, 2, 16, dt, gen)
        full_out = attention_flash(q, k, v, mask, 2)
        off = min((attention_flash(q, k, v, mask, 2, True) - full_out)
                  .abs().max().item(),
                  (attention_flash(q, k, v, mask, 2, False, None, RATE, SEED)
                   - full_out).abs().max().item())
        if off < 0.1:
            fail(f"flash {dt}: causal or dropout leaves the output "
                 f"unchanged ({off}); check is vacuous")
    return worst


# a beam-5 decode step of 16 images over a cache of 514 positions: one
# query against S_max keys (two past the last full 64-key tile); the key
# mask ends after the filled positions pos + 1
DECODE_SHAPE = (80, 1, 514, 12, 64)
DECODE_FILLED = (1, 64, 513, 514)


def decode_inputs(filled, dtype, gen):
    """q (B, 1, H*Dh), k/v (B, S_max, H*Dh) and the cache's key mask, the
    first ``filled`` positions valid in every row."""
    import torch

    b, sq, sk, h, dh = DECODE_SHAPE
    q, k, v, _ = attn_inputs(b, sq, sk, h, dh, dtype, gen)
    mask = (torch.arange(sk, device="cuda") < filled).expand(b, sk)
    return q, k, v, mask


def check_flash_decode_shape(gen):
    """#5 at the decode shape against its plain version at rate 0 (decoding
    is deterministic): fp32 (CUDA cores) and bf16 (tensor cores), the mask
    filled to 1, 64, 513 and 514 positions, in the packed layout and
    through `attention_bhsd`, the head-major entry the decode cache branch
    calls, which takes #5 from 512 keys."""
    import torch

    from m3p_tpu_torch.ops.attention import (
        attention_bhsd, attention_flash, attention_flash_reference)

    b, sq, sk, h, dh = DECODE_SHAPE
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        tol = TOL_FP32 if dt == torch.float32 else TOL_BF16
        design = kernel_tests().flash_design(dt, dh)
        errs = []
        for filled in DECODE_FILLED:
            q, k, v, mask = decode_inputs(filled, dt, gen)
            want = attention_flash_reference(q, k, v, mask, h)
            before = dict(attention_flash.launches_by_design)
            got = attention_flash(q, k, v, mask, h)
            torch.cuda.synchronize()
            took = launched_design(attention_flash.launches_by_design,
                                   before, 1)
            what = f"flash decode shape {name} filled {filled}"
            errs.append(_compare(got, want, tol, what))
            qh, kh, vh = (t.view(b, t.shape[1], h, dh).transpose(1, 2)
                          for t in (q, k, v))
            before = dict(attention_flash.launches_by_design)
            got = attention_bhsd(qh, kh.contiguous(), vh.contiguous(), mask)
            torch.cuda.synchronize()
            took_h = launched_design(attention_flash.launches_by_design,
                                     before, 1)
            if (took, took_h) != (design, design):
                fail(f"{what}: the launches took {took} / {took_h}; the "
                     f"rule names {design}")
            errs.append(_compare(got.transpose(1, 2).reshape(b, sq, h * dh),
                                 want, tol, f"{what} (attention_bhsd)"))
        worst[f"{name}_{design}"] = max(errs)
        log(f"[check] flash decode shape B={b} Sq={sq} Sk={sk} H={h} "
            f"Dh={dh} {name} ({design}), mask filled to {DECODE_FILLED}, "
            f"packed and head-major: max|kernel-plain| {max(errs):.3e} "
            f"(tolerance {tol})")
    return worst


def time_flash_kernels(gen):
    """#5 and #6 at the long-context shape (B = 8, S = 2048, H = 12,
    Dh = 64, bf16, every key valid): the tensor-core design (the path's)
    and the CUDA-core design on the same tensors in turns, at rates 0 (the
    path's) and 0.1; the plain versions; SDPA's forward and its autograd
    backward on the same inputs and mask."""
    import torch
    import torch.nn.functional as F

    from m3p_tpu_torch.ops import attention as ops
    from m3p_tpu_torch.ops.attention import (
        attention_flash_bwd_reference, attention_flash_reference)

    b, s, h, dh = LONG_B, LONG_S, 12, 64
    q, k, v, mask, do = flash_inputs(b, s, s, h, dh, torch.bfloat16, gen,
                                     full=True)
    scale = dh ** -0.5
    out, stats = attention_flash_reference(q, k, v, mask, h,
                                           return_stats=True)

    def fwd(rate, design=None):
        seed = SEED if rate else None
        return lambda: ops._launch_flash_fwd(q, k, v, mask, h, False, scale,
                                             rate, seed, design)

    def bwd(rate, design=None):
        seed = SEED if rate else None
        return lambda: ops._launch_flash_bwd(q, k, v, mask, out, stats, do,
                                             h, False, scale, rate, seed,
                                             design)

    for fn, counts, n in ((fwd(0.0), ops.attention_flash.launches_by_design,
                           1),
                          (bwd(0.0),
                           ops.attention_flash.bwd_launches_by_design, 2)):
        before = dict(counts)
        fn()
        torch.cuda.synchronize()
        if launched_design(counts, before, n) != "tensor_cores":
            fail("the xMLM shape does not take the tensor-core design")
    ms, ms_cc = in_turns(fwd(0.0), fwd(0.0, "cuda_cores"))
    ms_drop, ms_cc_drop = in_turns(fwd(RATE), fwd(RATE, "cuda_cores"))
    plain_ms = cuda_ms(lambda: attention_flash_reference(q, k, v, mask, h),
                       iters=3, warmup=1)
    bwd_ms, bwd_cc = in_turns(bwd(0.0), bwd(0.0, "cuda_cores"))
    bwd_drop_ms, bwd_cc_drop = in_turns(bwd(RATE), bwd(RATE, "cuda_cores"))
    bwd_plain_ms = cuda_ms(lambda: attention_flash_bwd_reference(
        q, k, v, mask, out, stats, do, h), iters=3, warmup=1)
    qh, kh, vh, doh = (t.view(b, s, h, dh).transpose(1, 2).contiguous()
                       for t in (q, k, v, do))
    sdpa_mask = mask[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=sdpa_mask))
    for t in (qh, kh, vh):
        t.requires_grad_(True)
    sdpa = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=sdpa_mask)
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa, (qh, kh, vh), doh, retain_graph=True))
    elems = b * s * h * dh
    stat_bytes = b * h * s * 2 * 4
    # forward: q, k, v, mask in; o, (m, l) out; QK^T and PV
    fwd_bytes = 4 * elems * 2 + b * s + stat_bytes
    fwd_flops = 4 * b * h * s * s * dh
    # backward: q, k, v, o, dO, mask, (m, l) in; dq, dk, dv out; QK^T,
    # dO V^T, P^T dO, dS^T Q, dS K (the design does seven: QK^T and dO V^T
    # again in the dq pass)
    bwd_bytes = 8 * elems * 2 + b * s + stat_bytes
    bwd_flops = 10 * b * h * s * s * dh
    fwd_bound, fwd_by = bound(fwd_bytes, fwd_flops)
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_flops)
    shape = {"B": b, "Sq": s, "Sk": s, "H": h, "Dh": dh, "dtype": "bfloat16"}
    res = {}
    for name, t in (("flash_attention_fwd", {
            "ms": ms, "ms_rate_0.1": ms_drop, "ms_cuda_cores": ms_cc,
            "ms_cuda_cores_rate_0.1": ms_cc_drop, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
            "bytes": fwd_bytes, "flops": fwd_flops}),
            ("flash_attention_bwd", {
            "ms": bwd_ms, "ms_rate_0.1": bwd_drop_ms,
            "ms_cuda_cores": bwd_cc, "ms_cuda_cores_rate_0.1": bwd_cc_drop,
            "plain_ms": bwd_plain_ms, "library_ms": lib_bwd_ms,
            "bound_ms": bwd_bound, "bound_by": bwd_by, "bytes": bwd_bytes,
            "flops": bwd_flops})):
        t.update(shape=shape, design="tensor_cores",
                 tflops_per_s=t["flops"] / t["ms"] / 1e9,
                 tflops_per_s_cuda_cores=t["flops"] / t["ms_cuda_cores"]
                 / 1e9,
                 speedup_over_cuda_cores=t["ms_cuda_cores"] / t["ms"])
        res[name] = t
        log(f"[time] {name} B={b} S={s} bf16, in turns (CUDA events): "
            f"tensor cores {t['ms']:.4f} ms ({t['tflops_per_s']:.2f} "
            f"TFLOP/s; rate 0.1: {t['ms_rate_0.1']:.4f}), CUDA cores "
            f"{t['ms_cuda_cores']:.4f} ms ({t['tflops_per_s_cuda_cores']:.2f}"
            f" TFLOP/s; rate 0.1: {t['ms_cuda_cores_rate_0.1']:.4f}), "
            f"{t['speedup_over_cuda_cores']:.2f}x; plain "
            f"{t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return res["flash_attention_fwd"], res["flash_attention_bwd"]


# ---------------------------------------------------------------------------
# phase 7: the long-context xMLM step
# ---------------------------------------------------------------------------


def long_config(n_layers=12, dtype="bfloat16", rate=0.1):
    """tools/bench_longseq.py's ModelConfig: the ModelConfig defaults (768d,
    12 heads, FFN 3072, 5 languages) with max_positions S + 2 and attention
    dropout 0."""
    from m3p_tpu_torch.config import ModelConfig

    return ModelConfig(n_words=250002, mask_index=250001, n_layers=n_layers,
                       emb_dim=768, n_heads=12, dropout=rate,
                       attention_dropout=0.0, max_positions=LONG_S + 2,
                       dtype=dtype)


def long_mask_cfg():
    from m3p_tpu_torch.data.masking import MaskingConfig

    return MaskingConfig(max_pred=LONG_MAX_PRED, n_words=250002,
                         mask_index=250001)


def stream_batch(seed, b, s, device):
    import numpy as np
    import torch

    from m3p_tpu_torch.data.synthetic import make_stream_batch

    batch = make_stream_batch(np.random.RandomState(seed), b, s, 250002)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def mlm_step(**kw):
    from m3p_tpu_torch.train.steps import make_train_step, mlm_loss

    return make_train_step(functools.partial(mlm_loss,
                                             mask_cfg=long_mask_cfg(), **kw))


def step_flops(cfg, b, s, n_slots):
    """Model FLOPs of one training step, 3 x the forward's: per block the
    Q/K/V/out and FFN GEMMs (2 (4 d^2 + 2 d f) per token) and the two
    attention products (4 B H S^2 Dh); the tied head at the masked slots
    (2 slots d V).  Embeddings, LayerNorm and softmax are left out."""
    d, f = cfg.emb_dim, cfg.ffn_dim
    per_block = 2 * (4 * d * d + 2 * d * f) * b * s + 4 * b * s * s * d
    head = 2 * n_slots * d * cfg.n_words
    return 3 * (cfg.n_layers * per_block + head)


def long_context_slice(seed):
    """The long-context xMLM step of tools/bench_longseq.py at its full
    size: 1 warm-up and 5 timed steps, every self-attention through the
    flash kernels in both directions."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.ops.attention import attention_flash, attention_packed
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    cfg = long_config()
    t0 = time.time()
    model = build_model(cfg, seed, "cuda")
    tx, schedule = build_optimizer(LONG_SPEC, clip_grad_norm=CLIP)
    state = create_train_state(model, tx)
    step = mlm_step()
    gens = Generators.from_seed(seed, "cuda")
    batch = stream_batch(0, LONG_B, LONG_S, "cuda")
    watched = {n: p.detach().clone() for n, p in model.named_parameters()
               if n in ("block_0.attn.q_lin.weight", "text_emb.word.weight",
                        "pred_layer.bias")}
    log(f"[long] model ({sum(p.numel() for p in model.parameters())} "
        f"parameters, stored in {next(model.parameters()).dtype}), "
        f"FusedAdam state and batch (B={LONG_B}, S={LONG_S}) on the card in "
        f"{time.time() - t0:.2f} s")
    per_step = (cfg.n_layers, 2 * cfg.n_layers)
    n_steps = LONG_WARMUP + LONG_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    # ---- the main path, counted ----
    zero_launch_counts()
    for i in range(n_steps):
        if i == LONG_WARMUP:
            torch.cuda.synchronize()
            wall0 = time.perf_counter()
            start.record()
        state, m = step(state, batch, gens)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall0
    launches = (attention_flash.launches, attention_flash.bwd_launches)
    packed = (attention_packed.launches, attention_packed.bwd_launches)
    by_design = {"fwd": dict(attention_flash.launches_by_design),
                 "bwd": dict(attention_flash.bwd_launches_by_design)}
    # ---- checks ----
    step_ms = start.elapsed_time(end) / LONG_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack([m["mlm"] for m in metrics]).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite xMLM loss: {losses.tolist()}")
    if launches != (per_step[0] * n_steps, per_step[1] * n_steps):
        fail(f"{launches} flash forward/backward launches in {n_steps} "
             f"steps; expected {per_step} per step")
    if packed != (0, 0):
        fail(f"{packed} packed launches on the long-context path")
    if (by_design["fwd"]["tensor_cores"], by_design["bwd"]["tensor_cores"]) \
            != launches:
        fail(f"flash launches by design {by_design}: not every launch of "
             f"the xMLM step took the tensor-core design")
    moved = {n: (p.detach().float() - watched[n].float()).abs().max().item()
             for n, p in model.named_parameters() if n in watched}
    if state.step != n_steps or not all(v > 0 for v in moved.values()):
        fail(f"the parameters did not change: {moved}")
    flops = step_flops(cfg, LONG_B, LONG_S, LONG_B * LONG_MAX_PRED)
    numbers = {
        "samples_per_s": LONG_B / (step_ms / 1e3),
        "tokens_per_s": LONG_B * LONG_S / (step_ms / 1e3),
        "step_ms": step_ms, "wall_step_ms": wall_s * 1e3 / LONG_STEPS,
        "peak_memory_gb": peak_gb, "b": LONG_B, "s": LONG_S,
        "launches": {"fwd": launches[0], "bwd": launches[1],
                     "packed": packed[0] + packed[1]},
        "launches_by_design": by_design,
        "launches_per_step": {"fwd": per_step[0], "bwd": per_step[1]},
        "flops_per_step": flops,
        "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
        "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
        "lr_last": schedule(state.step - 1),
    }
    log(f"[long] {n_steps} xMLM steps at B={LONG_B}, S={LONG_S}, 12 blocks, "
        f"dropout 0.1, FusedAdam bf16 moments + fp32 master: "
        f"{step_ms:.2f} ms a step (CUDA events, {LONG_STEPS} steps), "
        f"{numbers['samples_per_s']:.3f} samples/s, "
        f"{numbers['tokens_per_s']:.1f} tokens/s, host wall "
        f"{numbers['wall_step_ms']:.2f} ms a step, peak memory "
        f"{peak_gb:.2f} GB; launches flash fwd {launches[0]} = "
        f"{per_step[0]} x {n_steps}, bwd {launches[1]} = {per_step[1]} x "
        f"{n_steps}, packed {packed}, by design {by_design}; "
        f"{flops / 1e12:.3f} TFLOP a step, MFU "
        f"{numbers['mfu']:.4f} of 989 TF/s; loss {losses[0].item():.4f} -> "
        f"{losses[-1].item():.4f}; max |param change| {moved}")
    numbers["profile"] = profile_window(
        f"one xMLM step B={LONG_B} S={LONG_S}",
        lambda: step(state, batch, gens), reps=1)
    return numbers


def compare_long_grads_with_cpu(seed):
    """fp32 gradients of mlm_loss at depth 2 and full width, S = 640 (the
    flash path), on the card (kernels) and on the CPU (plain versions), at
    rate 0, with one masking fed to both."""
    import torch

    from m3p_tpu_torch.data.masking import mask_tokens
    from m3p_tpu_torch.model import lengths_to_mask
    from m3p_tpu_torch.train.steps import mlm_loss

    cfg = long_config(n_layers=2, dtype="float32", rate=0.0)
    cpu_model = cpu_model_from_card(cfg, seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = stream_batch(seed + 2, 2, LONG_CHECK_S, "cpu")
    batch["lengths"][1] = LONG_CHECK_S - 100
    tokens = batch["tokens"].long()
    masking = mask_tokens(torch.Generator().manual_seed(seed), tokens,
                          lengths_to_mask(batch["lengths"], tokens.shape[1]),
                          long_mask_cfg())
    losses = {}
    for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
        loss, _ = mlm_loss(model, {k: t.to(dev) for k, t in batch.items()},
                           None, long_mask_cfg(), deterministic=True,
                           masking=[t.to(dev) for t in masking])
        loss.backward()
        losses[dev] = loss.item()
    worst, worst_name, leaves = worst_grad_diff(gpu_model, cpu_model)
    log(f"[fp32 grads long] depth 2, B=2, S={LONG_CHECK_S}, rate 0: loss "
        f"card {losses['cuda']:.6f} vs CPU {losses['cpu']:.6f}; {leaves} "
        f"leaves, max relative |card - CPU| = {worst:.3e} ({worst_name}; "
        f"tolerance {TOL_GRAD_FP32})")
    if worst > TOL_GRAD_FP32 or abs(losses["cuda"] - losses["cpu"]) > 1e-4:
        fail("fp32 xMLM gradients on the card disagree with the CPU")
    return worst


def long_learning_check(seed, steps=30):
    """Depth 2 at full width, B = 2, S = 1024, one fixed batch and masking,
    FusedAdam (bf16 moments, fp32 master) at lr 1e-4, dropout on: the mean
    loss of the last 5 steps must be below that of the first 5."""
    import torch

    from m3p_tpu_torch.data.masking import mask_tokens
    from m3p_tpu_torch.model import build_model, lengths_to_mask
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    model = build_model(long_config(n_layers=2), seed + 3, "cuda")
    tx, _ = build_optimizer("adam,lr=0.0001,fused=1,mu_dtype=bfloat16,"
                            "nu_dtype=bfloat16,master=1")
    state = create_train_state(model, tx)
    gens = Generators.from_seed(seed + 3, "cuda")
    batch = stream_batch(seed + 3, 2, 1024, "cuda")
    tokens = batch["tokens"].long()
    masking = mask_tokens(gens.device, tokens,
                          lengths_to_mask(batch["lengths"], tokens.shape[1]),
                          long_mask_cfg())
    step = mlm_step(masking=masking)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, gens)
        losses.append(m["mlm"])
    losses = torch.stack(losses).float().cpu()
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    log(f"[learn long] depth 2, B=2, S=1024, {steps} steps of FusedAdam lr "
        f"1e-4 on one batch and masking: mean loss of the first 5 steps "
        f"{first:.4f}, of the last 5 {last:.4f}")
    if not torch.isfinite(losses).all() or not last < first:
        fail(f"the xMLM model did not learn: {losses.tolist()}")
    return {"first5": first, "last5": last}


# ---------------------------------------------------------------------------
# phases 2/3 for the fused dropout kernels (#7, #8)
# ---------------------------------------------------------------------------


def check_fused_dropout(gen):
    """#7 and #8 against their plain versions, bit for bit: fp32 and bf16,
    rates 0.1 and 0.5, a non-zero residual, sizes that are not a multiple
    of 4, of 128 or of a block, and the MCT step's residual (80, 164, 768),
    each in the "wide" design (the rule's on these aligned tensors) and in
    "narrow" forced on the same tensors; bf16 views 8 bytes into their
    storage ("narrow" by the rule) and one element in ("scalar")."""
    import torch

    from m3p_tpu_torch.ops import dropout as ops
    from m3p_tpu_torch.ops.dropout import (
        dropout_add, dropout_add_reference, dropout_scale,
        dropout_scale_reference)

    shapes = [(4, 33, 130), (1001,), (3, 7), (77, 131),
              (GROUPS * SAMPLE_N, REGIONS + TEXT_LEN, 768)]
    worst = {}
    for shape in shapes:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            for rate in (RATE, 0.5):
                x, res, g = (torch.randn(shape, device="cuda", generator=gen
                                         ).to(dt) for _ in range(3))
                x.requires_grad_(True)
                out = dropout_add(x, res, SEED, rate)
                (dx,) = torch.autograd.grad(out, (x,), g)
                scaled = dropout_scale(g, SEED + 1, rate)
                torch.cuda.synchronize()
                pairs = (
                    ("forward", out, dropout_add_reference(
                        x.detach(), res, SEED, rate)),
                    ("backward", dx, dropout_scale_reference(g, SEED, rate)),
                    ("dropout_scale", scaled, dropout_scale_reference(
                        g, SEED + 1, rate)))
                before = (dict(dropout_add.launches_by_design),
                          dict(dropout_add.bwd_launches_by_design))
                narrow = (ops._launch(x.detach(), res, SEED, rate, "narrow"),
                          ops._launch(g, None, SEED, rate, "narrow"))
                torch.cuda.synchronize()
                for counts, old in zip((dropout_add.launches_by_design,
                                        dropout_add.bwd_launches_by_design),
                                       before):
                    if launched_design(counts, old, 1) != "narrow":
                        fail("fused dropout: a forced narrow launch took "
                             "another design")
                pairs += (("forward narrow", narrow[0], pairs[0][2]),
                          ("backward narrow", narrow[1], pairs[1][2]))
                for what, got, want in pairs:
                    err = (got.float() - want.float()).abs().max().item()
                    if not torch.equal(got, want):
                        fail(f"fused dropout {what} {shape} {name} rate "
                             f"{rate}: kernel and plain version differ "
                             f"(max |diff| {err})")
                    worst[name] = max(worst.get(name, 0.0), err)
            log(f"[check] fused_dropout {shape} {name}: #7 forward, #8 "
                f"backward and dropout_scale (wide) and #7/#8 narrow equal "
                f"their plain versions bit for bit at rates {RATE} and 0.5")
    base = torch.randn(2, 10_001, device="cuda", generator=gen)
    x, res = base[0, 1:], base[1, 1:]
    if not torch.equal(dropout_add(x, res, SEED, RATE),
                       dropout_add_reference(x, res, SEED, RATE)):
        fail("fused dropout on an unaligned view differs from the plain "
             "version")
    views = torch.randn(2, 40_016, device="cuda", generator=gen).to(
        torch.bfloat16)
    for offset, design in ((4, "narrow"), (1, "scalar")):
        x, res = views[0, offset:offset + 40_003], views[1, offset:offset +
                                                         40_003]
        before = dict(dropout_add.launches_by_design)
        got = dropout_add(x, res, SEED, RATE)
        torch.cuda.synchronize()
        if launched_design(dropout_add.launches_by_design, before,
                           1) != design or not torch.equal(
                got, dropout_add_reference(x, res, SEED, RATE)):
            fail(f"fused dropout on a bf16 view {2 * offset} bytes in: not "
                 f"{design}, or not the plain version's bits")
    # the comparison has teeth: dropout changes the output
    if torch.equal(dropout_add(x, res, SEED, RATE), res + x):
        fail("fused dropout leaves residual + x unchanged; check is vacuous")
    share = kernel_tests().check_fused_dropout_mask_identity("cuda")
    log(f"[check] fused dropout mask identity (x = 1, residual = 0, rate "
        f"0.25): forward and backward == plain Philox mask, keep share "
        f"{share:.4f}")
    return worst, share


def time_fused_dropout(gen):
    """#7 and #8 at the MCT step's residual (80, 164, 768) bf16, rate 0.1:
    the kernels, their plain versions, and one library route each:
    ``residual + F.dropout(x)`` and its autograd backward, each by its
    device time (`device_ms`); the "wide" design (the path's) and "narrow"
    on the same tensors in turns; beside it the time of back-to-back calls
    (`cuda_ms`), which the host's cost per call bounds from below."""
    import torch
    import torch.nn.functional as F

    from m3p_tpu_torch.ops import dropout as ops
    from m3p_tpu_torch.ops.dropout import (
        dropout_add, dropout_add_reference, dropout_scale,
        dropout_scale_reference)

    shape = (GROUPS * SAMPLE_N, REGIONS + TEXT_LEN, 768)
    x, res, g = (torch.randn(shape, device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(3))
    n = x.numel()
    xl = x.detach().clone().requires_grad_(True)
    rl = res.detach().clone().requires_grad_(True)
    lib_out = rl + F.dropout(xl, RATE)
    calls = {
        "fwd": lambda: dropout_add(x, res, SEED, RATE),
        "bwd": lambda: dropout_scale(g, SEED, RATE),
        "fwd_plain": lambda: dropout_add_reference(x, res, SEED, RATE),
        "bwd_plain": lambda: dropout_scale_reference(g, SEED, RATE),
        "fwd_lib": lambda: res + F.dropout(x, RATE),
        "bwd_lib": lambda: torch.autograd.grad(lib_out, (xl, rl), g,
                                               retain_graph=True)}
    dev = {k: device_ms(f, **({"iters": 5, "warmup": 1} if "plain" in k
                              else {"launches": 1} if k in ("fwd", "bwd")
                              else {}))
           for k, f in calls.items()}
    # "wide" (the rule's) and "narrow" on the same tensors, in turns
    turns = {}
    for k, narrow in (("fwd", lambda: ops._launch(x, res, SEED, RATE,
                                                  "narrow")),
                      ("bwd", lambda: ops._launch(g, None, SEED, RATE,
                                                  "narrow"))):
        a1, b1, b2, a2 = (device_ms(f, launches=1) for f in
                          (calls[k], narrow, narrow, calls[k]))
        turns[k] = ((a1 + a2) / 2, (b1 + b2) / 2)
    b2b = {k: cuda_ms(calls[k]) for k in ("fwd", "bwd", "fwd_lib",
                                           "bwd_lib")}
    # bytes: x and the residual read, the output written (#7); g read, dx
    # written (#8); operations: a multiply and an add (#7), a multiply (#8)
    fwd_bound, fwd_by = bound(3 * n * 2, 2 * n)
    bwd_bound, bwd_by = bound(2 * n * 2, n)
    # the host's cost of one wrapper call (the calls return before the
    # kernels run, so this is host time while the host is the slower side)
    fwd_host = host_us(lambda: dropout_add(x, res, SEED, RATE))
    bwd_host = host_us(lambda: dropout_scale(g, SEED, RATE))
    add_host = host_us(lambda: res + x)
    dims = {"shape": list(shape), "dtype": "bfloat16", "rate": RATE}
    fwd = {"ms": dev["fwd"], "plain_ms": dev["fwd_plain"],
           "design": "wide", "ms_turns": turns["fwd"][0],
           "ms_narrow": turns["fwd"][1],
           "speedup_over_narrow": turns["fwd"][1] / turns["fwd"][0],
           "library_ms": dev["fwd_lib"], "bound_ms": fwd_bound,
           "bound_by": fwd_by, "bytes": 3 * n * 2,
           "ms_back_to_back": b2b["fwd"],
           "library_ms_back_to_back": b2b["fwd_lib"],
           "host_us_per_call": fwd_host, "host_us_residual_add": add_host,
           **dims}
    bwd = {"ms": dev["bwd"], "plain_ms": dev["bwd_plain"],
           "design": "wide", "ms_turns": turns["bwd"][0],
           "ms_narrow": turns["bwd"][1],
           "speedup_over_narrow": turns["bwd"][1] / turns["bwd"][0],
           "library_ms": dev["bwd_lib"], "bound_ms": bwd_bound,
           "bound_by": bwd_by, "bytes": 2 * n * 2,
           "ms_back_to_back": b2b["bwd"],
           "library_ms_back_to_back": b2b["bwd_lib"],
           "host_us_per_call": bwd_host, **dims}
    for name, t in (("fused_dropout_fwd (#7)", fwd),
                    ("fused_dropout_bwd (#8)", bwd)):
        log(f"[time] {name} {shape} bf16 rate {RATE}, device time: kernel "
            f"{t['ms']:.4f} ms ({t['bytes'] / t['ms'] / 1e9:.2f} TB/s; in "
            f"turns wide {t['ms_turns']:.4f} vs narrow {t['ms_narrow']:.4f}, "
            f"{t['speedup_over_narrow']:.2f}x), "
            f"plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); back to back "
            f"(CUDA events) kernel {t['ms_back_to_back']:.4f}, library "
            f"{t['library_ms_back_to_back']:.4f}; host "
            f"{t['host_us_per_call']:.1f} us a call (res + x: "
            f"{add_host:.1f})")
    return fwd, bwd


# ---------------------------------------------------------------------------
# phase 8: the MCT pre-training step
# ---------------------------------------------------------------------------


def zero_launch_counts():
    from m3p_tpu_torch.ops.attention import (
        attention_flash, attention_packed, small_attention)
    from m3p_tpu_torch.ops.dropout import dropout_add
    from m3p_tpu_torch.ops.fused_ffn import fused_ffn_ln

    for fn in (attention_packed, attention_flash, dropout_add,
               small_attention):
        fn.launches = 0
        fn.bwd_launches = 0
    for counts in (attention_flash.launches_by_design,
                   attention_flash.bwd_launches_by_design,
                   attention_packed.launches_by_design,
                   attention_packed.bwd_launches_by_design,
                   small_attention.launches_by_design,
                   small_attention.bwd_launches_by_design,
                   dropout_add.launches_by_design,
                   dropout_add.bwd_launches_by_design,
                   fused_ffn_ln.launches_by_design):
        for design in counts:
            counts[design] = 0
    fused_ffn_ln.launches = 0


def launch_counts():
    from m3p_tpu_torch.ops.attention import (
        attention_flash, attention_packed, small_attention)
    from m3p_tpu_torch.ops.dropout import dropout_add
    from m3p_tpu_torch.ops.fused_ffn import fused_ffn_ln

    return {"packed_fwd": attention_packed.launches,
            "packed_fwd_tensor_cores":
                attention_packed.launches_by_design["tensor_cores"],
            "packed_bwd": attention_packed.bwd_launches,
            "packed_bwd_tensor_cores":
                attention_packed.bwd_launches_by_design["tensor_cores"],
            "flash_fwd": attention_flash.launches,
            "flash_bwd": attention_flash.bwd_launches,
            "flash_fwd_tensor_cores":
                attention_flash.launches_by_design["tensor_cores"],
            "flash_bwd_tensor_cores":
                attention_flash.bwd_launches_by_design["tensor_cores"],
            "dropout_fwd": dropout_add.launches,
            "dropout_bwd": dropout_add.bwd_launches,
            "dropout_fwd_wide": dropout_add.launches_by_design["wide"],
            "dropout_bwd_wide": dropout_add.bwd_launches_by_design["wide"],
            "small_fwd": small_attention.launches,
            "small_fwd_tensor_cores":
                small_attention.launches_by_design["tensor_cores"],
            "small_bwd": small_attention.bwd_launches,
            "small_bwd_tensor_cores":
                small_attention.bwd_launches_by_design["tensor_cores"],
            "fused_ffn": fused_ffn_ln.launches,
            "fused_ffn_cluster": fused_ffn_ln.launches_by_design["cluster"]}


def expected_launches(packed=(0, 0), flash=(0, 0), dropout=0):
    """The `launch_counts` dict of a step that makes ``packed`` (forward,
    backward) #1/#2 launches and ``flash`` #5/#6 launches, all on the
    tensor cores, and ``dropout`` #7 and #8 launches each, all "wide"."""
    return {"packed_fwd": packed[0], "packed_fwd_tensor_cores": packed[0],
            "packed_bwd": packed[1], "packed_bwd_tensor_cores": packed[1],
            "flash_fwd": flash[0], "flash_bwd": flash[1],
            "flash_fwd_tensor_cores": flash[0],
            "flash_bwd_tensor_cores": flash[1], "dropout_fwd": dropout,
            "dropout_bwd": dropout, "dropout_fwd_wide": dropout,
            "dropout_bwd_wide": dropout, "small_fwd": 0,
            "small_fwd_tensor_cores": 0, "small_bwd": 0,
            "small_bwd_tensor_cores": 0, "fused_ffn": 0,
            "fused_ffn_cluster": 0}


def float_mct_config(**kw):
    """`bench.bench_config` with the FFNs' float GEMMs: phases 8 and 12
    measure the step as their slices did; phase 17 runs bench.py's
    ``int8_bwd`` beside it."""
    from m3p_tpu_torch import bench

    return bench.bench_config(ffn_quant="none", **kw)


def mct_per_step(cfg, encodes=1):
    """Launches a step makes: per joint encode, one #1 and one #2 backward
    (two launches), all on the tensor cores in bf16, per block and refiner
    layer; with fused dropout one #7 and one #8 per residual (two a
    block), all in the "wide" design."""
    layers = cfg.n_layers + cfg.refine_layers
    fused = 2 * cfg.n_layers if cfg.use_fused_dropout else 0
    return expected_launches((layers * encodes, 2 * layers * encodes),
                             dropout=fused * encodes)


def check_launches(what, counts, per_step, n_steps):
    want = {k: v * n_steps for k, v in per_step.items()}
    if counts != want:
        fail(f"{what}: launches {counts} in {n_steps} step(s); expected "
             f"{per_step} a step")


def mct_slice(seed, fused):
    """The MCT step of m3p_tpu_torch.bench at full size, configuration A
    (``fused`` False, bench.py's) or B: 2 warm-up and 8 timed steps, the
    launches of every kernel counted, a profile of one step; for B then one
    step with CLCM pairs, its launches counted."""
    import numpy as np
    import torch

    from m3p_tpu_torch import bench

    label = "B (use_fused_dropout)" if fused else "A (bench.py's)"
    cfg = float_mct_config(fused_dropout=fused)
    t0 = time.time()
    state, step, gens = bench.setup(cfg, seed, "cuda")
    batch = bench.make_batch(0, "cuda")
    watched = {n: p.detach().clone() for n, p in state.model.named_parameters()
               if n in ("block_0.attn.q_lin.weight", "obj_pred.proj.weight",
                        "mrfr_head.dense.weight", "text_emb.word.weight")}
    log(f"[mct {label}] model, FusedAdam state and batch (BN="
        f"{batch['tokens'].shape[0]}) on the card in {time.time() - t0:.2f} s")
    per_step = mct_per_step(cfg)
    # ---- the main path, counted ----
    zero_launch_counts()
    numbers = bench.run(state, step, batch, gens, WARMUP_STEPS, TIMED_STEPS)
    counts = launch_counts()
    n_steps = numbers["warmup"] + numbers["steps"]
    # ---- checks ----
    if not np.isfinite(numbers["losses"]).all():
        fail(f"MCT {label}: non-finite loss {numbers['losses']}")
    check_launches(f"MCT {label}", counts, per_step, n_steps)
    moved = {n: (p.detach().float() - watched[n].float()).abs().max().item()
             for n, p in state.model.named_parameters() if n in watched}
    if state.step != n_steps or not all(v > 0 for v in moved.values()):
        fail(f"MCT {label}: the parameters did not change: {moved}")
    flops = bench.mct_step_flops(cfg, numbers["bn"])
    numbers.update({
        "launches": counts, "launches_per_step": per_step,
        "flops_per_step": flops, "flops_per_sample": flops / numbers["bn"],
        "mfu": flops / (numbers["step_ms"] / 1e3) / BF16_FLOPS_PER_S,
        "loss_first": numbers["losses"][0],
        "loss_last": numbers["losses"][-1]})
    del numbers["losses"]
    log(f"[mct {label}] {n_steps} steps at BN={numbers['bn']}: "
        f"{numbers['step_ms']:.2f} ms a step (CUDA events, "
        f"{numbers['steps']} steps), {numbers['samples_per_s']:.1f} "
        f"samples/s, host wall {numbers['wall_step_ms']:.2f} ms a step, peak "
        f"memory "
        f"{numbers['peak_memory_gb']:.2f} GB; launches {counts} = "
        f"{per_step} x {n_steps}; {flops / 1e12:.3f} TFLOP a step, MFU "
        f"{numbers['mfu']:.4f} of 989 TF/s; loss "
        f"{numbers['loss_first']:.4f} -> {numbers['loss_last']:.4f}; max "
        f"|param change| {moved}")
    prof = profile_window(f"one MCT step {label}",
                          lambda: step(state, batch, gens), reps=1)
    if prof:
        prof["idle_share_vs_event_step"] = (
            1.0 - prof["device_busy_ms"] / numbers["step_ms"])
    numbers["profile"] = prof
    if fused:
        clcm = bench.make_batch(1, "cuda", with_clcm=True)
        # ---- the CLCM variant, counted ----
        zero_launch_counts()
        state, m = step(state, clcm, gens)
        torch.cuda.synchronize()
        counts = launch_counts()
        per_clcm = mct_per_step(cfg, encodes=2)
        check_launches("MCT B with CLCM", counts, per_clcm, 1)
        if not all(torch.isfinite(v).all() for v in m.values()):
            fail(f"MCT B with CLCM: non-finite metrics {m}")
        numbers["clcm_step"] = {"launches": counts,
                                "metrics": {k: v.item()
                                            for k, v in m.items()}}
        log(f"[mct {label}] one step with CLCM pairs (S = 100 + 128): "
            f"launches {counts} = {per_clcm}; metrics "
            f"{numbers['clcm_step']['metrics']}")
    return numbers


# (warm-up, timed) steps of each window of A and B in turns
MCT_TURN_STEPS = (1, 5)


def mct_in_turns(seed):
    """A against B on one model and state, timed in the order A, B, B, A
    (1 + 5 steps each, `use_fused_dropout` switched on the blocks between
    windows): the mean of each one's two readings."""
    from m3p_tpu_torch import bench

    cfg = float_mct_config(fused_dropout=True)
    state, step, gens = bench.setup(cfg, seed, "cuda")
    batch = bench.make_batch(0, "cuda")
    readings = {"A": [], "B": []}
    for label in ("A", "B", "B", "A"):
        for block in state.model.blocks:
            block.use_fused_dropout = label == "B"
        out = bench.run(state, step, batch, gens, *MCT_TURN_STEPS)
        readings[label].append({k: out[k] for k in ("step_ms",
                                                     "peak_memory_gb")})
    means = {k: sum(r["step_ms"] for r in v) / 2 for k, v in readings.items()}
    log(f"[mct in turns] A, B, B, A on one model: A {means['A']:.2f} ms a "
        f"step, B {means['B']:.2f} ms (B/A {means['B'] / means['A']:.4f}); "
        f"readings {json.dumps(readings)}")
    return {"step_ms": means, "readings": readings}


def compare_mct_grads_with_cpu(seed):
    """fp32 gradients of mct_pretrain_loss at depth 2 and full width, CLCM
    on, use_fused_dropout with dropout and attention dropout 0.1, on the
    card (kernels #1, #2, #7, #8) and on the CPU (plain versions): one coin
    and masking fed to both, the elementwise masks of the embeddings and
    the refiner drawn by CPU generators of one seed on both sides, the
    Philox seeds from host generators of one seed."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.ops.dropout import dropout_add
    from m3p_tpu_torch.train.steps import mct_draws, mct_pretrain_loss

    cfg = float_mct_config(fused_dropout=True, n_layers=2,
                           dtype="float32")
    cpu_model = cpu_model_from_card(cfg, seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    # one group: the CPU's pass at two was most of the phase
    batch = bench.make_batch(seed + 2, "cpu", groups=1, with_clcm=True)
    draws = mct_draws(torch.Generator().manual_seed(seed), batch,
                      bench.mask_config(cfg))
    from m3p_tpu_torch.ops.attention import attention_packed

    losses = []              # the card's, then the CPU's
    dropout_add.launches = dropout_add.bwd_launches = 0
    before = (dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design))
    for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
        gens = Generators(torch.Generator().manual_seed(seed + 5),
                          torch.Generator().manual_seed(seed + 6))
        moved = {k: ([t.to(dev) for t in v] if isinstance(v, (list, tuple))
                     else v.to(dev)) for k, v in draws.items()}
        loss, _ = mct_pretrain_loss(
            model, {k: t.to(dev) for k, t in batch.items()}, gens,
            bench.mask_config(cfg), bench.SAMPLE_N,
            pack_ratio=bench.PACK_RATIO, **moved)
        loss.backward()
        losses.append(loss.item())
    fused = (dropout_add.launches, dropout_add.bwd_launches)
    if fused != (8, 8):
        fail(f"the fp32 MCT check launched {fused} fused dropout kernels; "
             f"expected 8 and 8 (2 blocks x 2 residuals x 2 encodes)")
    # fp32 exercises the CUDA-core designs: 5 layers x 2 encodes, one
    # forward and two backward launches each
    if (launched_design(attention_packed.launches_by_design, before[0], 10),
            launched_design(attention_packed.bwd_launches_by_design,
                            before[1], 20)) != ("cuda_cores",) * 2:
        fail("the fp32 MCT check did not take the CUDA-core design")
    worst, worst_name, leaves = worst_grad_diff(gpu_model, cpu_model)
    log(f"[fp32 grads mct] depth 2, BN={2 * SAMPLE_N}, CLCM on, fused "
        f"dropout and attention dropout {RATE}: loss card "
        f"{losses[0]:.6f} vs CPU {losses[1]:.6f}; {leaves} leaves, "
        f"max relative |card - CPU| = {worst:.3e} ({worst_name}; tolerance "
        f"{TOL_GRAD_FP32}); fused dropout launches on the card {fused}")
    if worst > TOL_GRAD_FP32 or abs(losses[0] - losses[1]) > 1e-4:
        fail("fp32 MCT gradients on the card disagree with the CPU")
    return worst


def mct_learning_check(seed, steps=40):
    """Depth 2 at full width, BN = 80, one fixed batch, coin and masking,
    fused dropout on, FusedAdam (bf16 moments, fp32 master) at lr 1e-4: the
    mean loss of the last 5 steps must be below that of the first 5."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.train.steps import mct_draws

    cfg = float_mct_config(fused_dropout=True, n_layers=2)
    state, _, gens = bench.setup(
        cfg, seed + 3, "cuda", spec="adam,lr=0.0001,fused=1,"
        "mu_dtype=bfloat16,nu_dtype=bfloat16,master=1")
    batch = bench.make_batch(seed + 3, "cuda")
    step = bench.make_step(cfg, **mct_draws(gens.device, batch,
                                            bench.mask_config(cfg)))
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, gens)
        losses.append(m["loss"])
    losses = torch.stack(losses).float().cpu()
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    log(f"[learn mct] depth 2, BN={batch['tokens'].shape[0]}, {steps} steps "
        f"of FusedAdam lr 1e-4 on one batch and masking, fused dropout: mean "
        f"loss of the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
    if not torch.isfinite(losses).all() or not last < first:
        fail(f"the MCT model did not learn: {losses.tolist()}")
    return {"first5": first, "last5": last}


# ---------------------------------------------------------------------------
# phase 9: the head-major attention entry (#3/#4) and the fused FFN tool
# path (#9)
# ---------------------------------------------------------------------------

# the flagship joint shape: BN = 80 sequences of 100 regions + 64 tokens,
# 12 heads of 64
JOINT = (GROUPS * SAMPLE_N, 12, 64, REGIONS + TEXT_LEN)


def check_small_attention():
    """#3 and #4 against their plain versions (tests/test_torch_kernels.py's
    SMALL_GPU_CASES: odd shapes, causal, Sq != Sk both ways, a batch row
    with no valid key, the `_small_fits` edge at Dh 64 and 128, the
    flagship joint shape), fp32 and bf16, rates 0 and 0.1, #4 in bf16 in
    both designs (the rule's and forced to CUDA cores), each call's design
    read from the per-design launch counts; the V = identity check in fp32
    and bf16; and the head-major entry against the packed path on the same
    tensors and seed."""
    import torch

    from m3p_tpu_torch.ops import attention as ops
    from m3p_tpu_torch.ops.attention import (
        attention_bhsd, attention_packed, small_attention,
        small_attention_bwd_reference, small_attention_reference)

    module = kernel_tests()
    worst = {"fwd": {}, "bwd": {}}
    fwd_counts = small_attention.launches_by_design
    counts = small_attention.bwd_launches_by_design

    def note(kind, name, err):
        worst[kind][name] = max(worst[kind].get(name, 0.0), err)

    for case in module.SMALL_GPU_CASES:
        for dt in (torch.float32, torch.bfloat16):
            tol_f = TOL_FP32 if dt == torch.float32 else TOL_BF16
            tol_b = TOL_BWD_FP32 if dt == torch.float32 else TOL_BF16
            msg = []
            for rate in (0.0, RATE):
                seed = SEED if rate else None
                q, k, v, mask, do = module._small_on("cuda", case, dt)
                causal = case[-1]
                leaves = [t.requires_grad_(True) for t in (q, k, v)]
                before = (dict(fwd_counts), dict(counts))
                out = small_attention(*leaves, mask, causal, None, rate, seed)
                grads = torch.autograd.grad(out, leaves, do)
                torch.cuda.synchronize()
                took_fwd = launched_design(fwd_counts, before[0], 1)
                took = launched_design(counts, before[1], 2)
                if (took_fwd, took) != (module.flash_design(dt, case[2]),) * 2:
                    fail(f"small_attention {case} {dt}: the forward took "
                         f"{took_fwd} and the backward {took}")
                q, k, v = (t.detach() for t in leaves)
                what = f"small_attention {case} {dt} rate {rate}"
                name = str(dt).replace("torch.", "")
                want = small_attention_reference(q, k, v, mask, causal, None,
                                                 rate, seed)
                outs = [(took, out.detach())]
                if dt == torch.bfloat16 and took == "tensor_cores":
                    before = dict(fwd_counts)
                    outs.append(("cuda_cores", ops._launch_small_fwd(
                        q, k, v, mask, causal, case[2] ** -0.5, rate, seed,
                        "cuda_cores")))
                    torch.cuda.synchronize()
                    launched_design(fwd_counts, before, 1)
                part = []
                for design, got in outs:
                    err = _compare(got, want, tol_f,
                                   f"{what} forward {design}")
                    note("fwd", name if dt == torch.float32
                         else f"{name}_{design}", err)
                    part.append(f"fwd {design} {err:.3e}")
                want = small_attention_bwd_reference(q, k, v, mask, do,
                                                     causal, None, rate, seed)
                runs = [(took, grads)]
                if dt == torch.bfloat16 and took == "tensor_cores":
                    before = dict(counts)
                    runs.append(("cuda_cores", ops._launch_small_bwd(
                        q, k, v, mask, do, causal, case[2] ** -0.5, rate,
                        seed, "cuda_cores")))
                    torch.cuda.synchronize()
                    launched_design(counts, before, 2)
                part = [f"rate {rate}: " + ", ".join(part)]
                for design, got in runs:
                    errs = [_compare(g, w, tol_b, f"{what} d{n} {design}")
                            for n, g, w in zip("qkv", got, want)]
                    note("bwd", name if dt == torch.float32
                         else f"{name}_{design}", max(errs))
                    part.append(f"{design} dq/dk/dv " +
                                "/".join(f"{e:.3e}" for e in errs))
                msg.append(", ".join(part))
            log(f"[check] small_attention (B, H, Dh, Sq, Sk, lens, causal) = "
                f"{case[:5]} causal={case[-1]} {dt}: max|kernel-plain| "
                + "; ".join(msg))
    shares = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).replace("torch.", "")
        before = (dict(fwd_counts), dict(counts))
        try:
            shares[name] = module.check_mask_identity(
                "cuda", attn=module.small_attention_packed_view, dtype=dt)
        except AssertionError as exc:
            fail(f"V=I mask identity (small_attention {name}): {exc!r}")
        took = (launched_design(fwd_counts, before[0], 2),
                launched_design(counts, before[1], 2))
        if took != (module.flash_design(dt, 64),) * 2:
            fail(f"V=I mask identity (small_attention {name}): the forward "
                 f"and backward took {took}")
        log(f"[check] V=I mask identity of #3/#4 at rate 0.25, {name} (#3 "
            f"and #4 on {took[0]}): forward == plain Philox mask, backward "
            f"dv^T == forward output, keep share {shares[name]:.4f}")
    share = shares
    # the head-major entry and the packed path on one set of tensors
    layout = {}
    for case, dt in ((module.SMALL_CASES[3], torch.float32),
                     (module.SMALL_GPU_CASES[-1], torch.bfloat16)):
        b, h, dh = case[:3]
        q, k, v, mask, do = module._small_on("cuda", case, dt, seed=3)
        causal = case[-1]

        def packed(t):
            return t.transpose(1, 2).reshape(b, t.shape[2], h * dh)

        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attention_bhsd(*leaves, mask, causal, None, RATE, SEED)
        grads = torch.autograd.grad(out, leaves, do)
        pleaves = [packed(t).requires_grad_(True) for t in (q, k, v)]
        pout = attention_packed(*pleaves, mask, h, causal, None, RATE, SEED)
        pgrads = torch.autograd.grad(pout, pleaves, packed(do))
        torch.cuda.synchronize()
        tol_f = TOL_FP32 if dt == torch.float32 else TOL_BF16
        tol_b = TOL_BWD_FP32 if dt == torch.float32 else TOL_BF16
        name = str(dt).replace("torch.", "")
        layout[name] = [_compare(packed(out.detach()), pout.detach(), tol_f,
                                 f"attention_bhsd vs packed {case} {dt}")] + [
            _compare(packed(g), w, tol_b, f"attention_bhsd vs packed d{n}")
            for n, g, w in zip("qkv", grads, pgrads)]
        log(f"[check] attention_bhsd (#3/#4) vs attention_packed (#1/#2) on "
            f"the packed view, {case[:5]} {name} rate {RATE}: max |diff| "
            f"out/dq/dk/dv " + "/".join(f"{e:.3e}" for e in layout[name]))
    # the comparison has teeth: dropout changes the output
    q, k, v, mask, _ = module._small_on("cuda", module.SMALL_CASES[0],
                                        torch.float32)
    off = (small_attention(q, k, v, mask, False, None, RATE, SEED)
           - small_attention(q, k, v, mask)).abs().max().item()
    if off < 0.1:
        fail(f"dropout does not change #3's output ({off}); check is vacuous")
    return worst, share, layout


def head_major_path():
    """The main path of #3/#4, counted: `attention_bhsd` as a training
    call makes it, forward and backward with dropout 0.1 at the flagship
    joint shape in bf16, three times; then one call at S = 640 with
    dropout (the flash kernels, through the packed layout) and one at rate
    0 (`mha_reference`, no kernel)."""
    import torch

    from m3p_tpu_torch.ops.attention import attention_bhsd

    module = kernel_tests()
    b, h, dh, s = JOINT
    case = (b, h, dh, s, s, (s, 0) + (100,) * (b - 2), False)
    q, k, v, mask, do = module._small_on("cuda", case, torch.bfloat16)
    long_case = (2, h, dh, 640, 640, (640, 333), False)
    lq, lk, lv, lmask, ldo = module._small_on("cuda", long_case,
                                              torch.bfloat16)
    zero_launch_counts()
    outs = []
    for step in range(3):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attention_bhsd(*leaves, mask, False, None, RATE, SEED + step)
        outs.append((out, torch.autograd.grad(out, leaves, do)))
    leaves = [t.clone().requires_grad_(True) for t in (lq, lk, lv)]
    lout = attention_bhsd(*leaves, lmask, False, None, RATE, SEED)
    lgrads = torch.autograd.grad(lout, leaves, ldo)
    det = attention_bhsd(q, k, v, mask)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k_: 0 for k_ in counts}
    want.update(small_fwd=3, small_fwd_tensor_cores=3, small_bwd=6,
                small_bwd_tensor_cores=6,
                flash_fwd=1, flash_bwd=2, flash_fwd_tensor_cores=1,
                flash_bwd_tensor_cores=2)
    if counts != want:
        fail(f"attention_bhsd: launches {counts}, expected {want}")
    tensors = [lout, *lgrads, det] + [t for o, g in outs for t in (o, *g)]
    if not all(torch.isfinite(t).all() for t in tensors):
        fail("attention_bhsd gave non-finite values")
    if torch.equal(outs[0][0], outs[1][0]):
        fail("attention_bhsd: two seeds drew one mask")
    log(f"[path] attention_bhsd, (B, H, S, Dh) = ({b}, {h}, {s}, {dh}) bf16 "
        f"rate {RATE}: 3 forward + backward calls, then S = 640 with "
        f"dropout and S = {s} at rate 0: launches {counts}")
    return counts


def time_small_attention():
    """#3 and #4 at the flagship joint shape, bf16, rate 0.1 (and the
    kernels at rate 0), with CUDA events (a call costs the host 0.08 ms,
    the kernels 0.1-0.4 ms): kernel, plain version, SDPA at rate 0 on the
    same (B, H, S, D) tensors and its autograd backward (replayed from a
    CUDA graph, `sdpa_bwd_ms`, as phase 3 times it for #2), #3's and #4's
    tensor-core designs (the path's) and CUDA-core designs on the same
    tensors in turns, and #1/#2 (the same tile code) on packed copies of
    the tensors, in turns with #3/#4."""
    import torch
    import torch.nn.functional as F

    from m3p_tpu_torch.ops import attention as ops
    from m3p_tpu_torch.ops.attention import (
        attention_packed, attention_packed_bwd, small_attention,
        small_attention_bwd, small_attention_bwd_reference,
        small_attention_reference)

    module = kernel_tests()
    b, h, dh, s = JOINT
    case = (b, h, dh, s, s, (s,) * b, False)
    q, k, v, mask, do = module._small_on("cuda", case, torch.bfloat16)
    pq, pk, pv, pdo = (t.transpose(1, 2).reshape(b, s, h * dh)
                       for t in (q, k, v, do))
    before = (dict(ops.small_attention.launches_by_design),
              dict(ops.small_attention.bwd_launches_by_design))
    small_attention(q, k, v, mask, False, None, RATE, SEED)
    small_attention_bwd(q, k, v, mask, do, False, None, RATE, SEED)
    torch.cuda.synchronize()
    if (launched_design(ops.small_attention.launches_by_design, before[0],
                        1),
            launched_design(ops.small_attention.bwd_launches_by_design,
                            before[1], 2)) != ("tensor_cores",) * 2:
        fail("#3/#4 at the flagship joint shape do not take the tensor-core "
             "design")
    dev = {}
    dev["fwd"], dev["fwd_packed"] = in_turns(
        lambda: small_attention(q, k, v, mask, False, None, RATE, SEED),
        lambda: attention_packed(pq, pk, pv, mask, h, False, None, RATE,
                                 SEED))
    dev["bwd"], dev["bwd_packed"] = in_turns(
        lambda: small_attention_bwd(q, k, v, mask, do, False, None, RATE,
                                    SEED),
        lambda: attention_packed_bwd(pq, pk, pv, mask, pdo, h, False, None,
                                     RATE, SEED))

    def fwd(rate, design=None):
        seed = SEED if rate else None
        return lambda: ops._launch_small_fwd(q, k, v, mask, False,
                                             dh ** -0.5, rate, seed, design)

    def bwd(rate, design=None):
        seed = SEED if rate else None
        return lambda: ops._launch_small_bwd(q, k, v, mask, do, False,
                                             dh ** -0.5, rate, seed, design)

    dev["fwd_turns"], dev["fwd_cuda_cores"] = in_turns(
        fwd(RATE), fwd(RATE, "cuda_cores"))

    dev["bwd_turns"], dev["bwd_cuda_cores"] = in_turns(
        bwd(RATE), bwd(RATE, "cuda_cores"))
    dev["bwd_rate_0_turns"], dev["bwd_rate_0_cuda_cores"] = in_turns(
        bwd(0.0), bwd(0.0, "cuda_cores"))
    calls = {
        "fwd_rate_0": lambda: small_attention(q, k, v, mask),
        "fwd_lib": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask[:, None, None, :]),
        "bwd_rate_0": lambda: small_attention_bwd(q, k, v, mask, do)}
    dev.update({k_: cuda_ms(f) for k_, f in calls.items()})
    lib = sdpa_bwd_ms(q, k, v, mask, do)
    dev["bwd_lib"] = lib["library_ms"]
    dev["fwd_plain"] = cuda_ms(lambda: small_attention_reference(
        q, k, v, mask, False, None, RATE, SEED), iters=10, warmup=2)
    dev["bwd_plain"] = cuda_ms(lambda: small_attention_bwd_reference(
        q, k, v, mask, do, False, None, RATE, SEED), iters=10, warmup=2)
    elems = b * h * s * dh
    fwd_bound, fwd_by = bound(4 * elems * 2 + b * s, 4 * b * h * s * s * dh)
    bwd_bound, bwd_by = bound(7 * elems * 2 + b * s, 10 * b * h * s * s * dh)
    dims = {"B": b, "H": h, "Sq": s, "Sk": s, "Dh": dh, "dtype": "bfloat16",
            "rate": RATE}
    out = {}
    for kind, bnd, by in (("fwd", fwd_bound, fwd_by),
                          ("bwd", bwd_bound, bwd_by)):
        out[kind] = {"ms": dev[kind], "ms_rate_0": dev[f"{kind}_rate_0"],
                     "packed_layout_ms": dev[f"{kind}_packed"],
                     "plain_ms": dev[f"{kind}_plain"],
                     "library_ms": dev[f"{kind}_lib"], "bound_ms": bnd,
                     "bound_by": by, "shape": dims}
        log(f"[time] small_attention_{kind} (#{3 if kind == 'fwd' else 4}) "
            f"{dims} CUDA events: kernel {dev[kind]:.4f} ms (rate 0: "
            f"{dev[kind + '_rate_0']:.4f}; #{1 if kind == 'fwd' else 2} on "
            f"packed copies, in turns {dev[kind + '_packed']:.4f}), plain "
            f"{dev[kind + '_plain']:.4f}"
            f", SDPA{' backward' if kind == 'bwd' else ''} "
            f"{dev[kind + '_lib']:.4f}, bound {bnd:.4f} ms ({by})")
    out["fwd"].update(
        design="tensor_cores", ms_turns=dev["fwd_turns"],
        ms_cuda_cores=dev["fwd_cuda_cores"],
        speedup_over_cuda_cores=dev["fwd_cuda_cores"] / dev["fwd_turns"])
    log(f"[time] small_attention_fwd (#3) in turns: tensor cores "
        f"{dev['fwd_turns']:.4f} ms, CUDA cores {dev['fwd_cuda_cores']:.4f} "
        f"({out['fwd']['speedup_over_cuda_cores']:.2f}x) at rate {RATE}")
    out["bwd"].update(
        design="tensor_cores", ms_turns=dev["bwd_turns"],
        ms_cuda_cores=dev["bwd_cuda_cores"],
        speedup_over_cuda_cores=dev["bwd_cuda_cores"] / dev["bwd_turns"],
        ms_rate_0_turns=dev["bwd_rate_0_turns"],
        ms_cuda_cores_rate_0=dev["bwd_rate_0_cuda_cores"],
        library_ms_issued=lib["library_ms_issued"],
        library_backend=lib["backend"])
    log(f"[time] small_attention_bwd (#4) in turns: tensor cores "
        f"{dev['bwd_turns']:.4f} ms, CUDA cores {dev['bwd_cuda_cores']:.4f} "
        f"({out['bwd']['speedup_over_cuda_cores']:.2f}x) at rate {RATE}; "
        f"rate 0 {dev['bwd_rate_0_turns']:.4f} / "
        f"{dev['bwd_rate_0_cuda_cores']:.4f}; SDPA backward "
        f"{lib['library_ms']:.4f} ({lib['backend']}, CUDA graph; "
        f"{lib['library_ms_issued']:.4f} as issued)")
    return out


def ffn_designs_reached(args):
    """The designs a case's tensors reach: the rule's, then each one below
    it (`_design` forced), in the kernel's order cluster, tile32,
    cuda_cores."""
    from m3p_tpu_torch.ops import fused_ffn as ops

    x, w1, _, w2 = args[:4]
    rule = ops._ffn_design(x, w1, w2, x)
    return list(reversed(ops._DESIGNS[:ops._DESIGNS.index(rule) + 1]))


def check_fused_ffn():
    """#9 against its plain version in every design each case reaches:
    fp32 and bf16, M in {1, 70, 13120, 13121}, (D, H) in {(64, 256),
    (768, 3072)}, nonzero biases and beta, gamma away from 1
    (tests/test_torch_kernels.py's inputs and tolerances), ragged widths,
    then the "cluster" rule's edges in bf16 (M = 1, 63, 64, 65, 13121 at
    D = 768, D = 128 and 256 at H = 4D); each call's design read from
    `launches_by_design`.  Returns the worst errors by dtype and design."""
    import torch

    from m3p_tpu_torch.ops import fused_ffn as ops
    from m3p_tpu_torch.ops.fused_ffn import fused_ffn_ln, reference_ffn_ln

    module = kernel_tests()
    worst = {}
    cases = [(m, d, h, dt) for d, h in module.FFN_SHAPES
             for m in module.FFN_ROWS
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(45, d, h, dt) for d, h in ((200, 100), (1000, 70), (1024, 64))
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(m, d, h, torch.bfloat16)
              for m, d, h in module.FFN_CLUSTER_CASES]
    for m, d, h, dt in cases:
        args = module.ffn_inputs("cuda", m, d, h, dt, seed=m)
        want = reference_ffn_ln(*args)
        name = str(dt).replace("torch.", "")
        for design in ffn_designs_reached(args):
            before = dict(fused_ffn_ln.launches_by_design)
            got = ops._launch(*args, 1e-12, _design=design)
            torch.cuda.synchronize()
            took = launched_design(fused_ffn_ln.launches_by_design, before, 1)
            if took != design:
                fail(f"fused_ffn_ln M={m} D={d} H={h} {name}: asked for "
                     f"{design}, launched {took}")
            try:
                err, mean = module.check_fused_ffn(got, want)
            except AssertionError as exc:
                fail(f"fused_ffn_ln M={m} D={d} H={h} {name} {design}: "
                     f"kernel and plain version disagree: {exc}")
            key = f"{name}_{design}"
            old = worst.get(key, (0.0, 0.0))
            worst[key] = (max(old[0], err), max(old[1], mean))
            log(f"[check] fused_ffn_ln M={m} D={d} H={h} {name} {design}: "
                f"max|kernel-plain| {err:.3e}, mean {mean:.3e}")
    # the rule's own pick at the tool's width, and two calls bitwise equal
    args = module.ffn_inputs("cuda", 65, 768, 3072, torch.bfloat16)
    before = dict(fused_ffn_ln.launches_by_design)
    first, second = fused_ffn_ln(*args), fused_ffn_ln(*args)
    torch.cuda.synchronize()
    if launched_design(fused_ffn_ln.launches_by_design, before,
                       2) != "cluster" or not torch.equal(first, second):
        fail("fused_ffn_ln: bf16 at D = 768 did not take the cluster design "
             "twice with bitwise equal results")
    # the comparison has teeth: the FFN moves the output
    args = module.ffn_inputs("cuda", 70, 768, 3072, torch.float32)
    ln = torch.nn.functional.layer_norm(args[0], (768,), args[5], args[6],
                                        1e-12)
    off = (fused_ffn_ln(*args) - ln).abs().max().item()
    if off < 0.05:
        fail(f"fused_ffn_ln equals LN(x) ({off}); check is vacuous")
    return worst


# the block rounds the pre-GELU, the FFN output and the residual sum to
# bf16, which the kernel keeps in fp32: a few bf16 ulps at |out| < 8
TOL_FFN_BLOCK = dict(max_abs=0.125, mean_abs=5e-3)


def ffn_model_check(seed):
    """#9 against one bf16 EncoderBlock of the flagship configuration
    (random weights from the seed, each representable in bf16): the
    block's own ln2(x + ffn(x)) at deterministic=True on (80, 164, 768)."""
    import torch

    from m3p_tpu_torch.model.layers import EncoderBlock
    from m3p_tpu_torch.ops.fused_ffn import fused_ffn_ln

    torch.manual_seed(seed)
    b, _, _, s = JOINT
    blk = EncoderBlock(12, 768, 3072, dtype=torch.bfloat16).to("cuda")
    d = blk.ln2.weight.numel()
    with torch.no_grad():
        blk.ln2.weight.normal_(1.0, 0.1)
        blk.ln2.bias.normal_(0.0, 0.1)
        for p in blk.parameters():
            p.copy_(p.to(torch.bfloat16).float())
        x = torch.randn(b, s, d, device="cuda").to(torch.bfloat16)
        want = blk.ln2(x + blk.ffn(x, deterministic=True))

        def bf16(t):
            return t.detach().to(torch.bfloat16).contiguous()

        got = fused_ffn_ln(x.view(-1, d), bf16(blk.ffn.lin1.weight.t()),
                           bf16(blk.ffn.lin1.bias),
                           bf16(blk.ffn.lin2.weight.t()),
                           bf16(blk.ffn.lin2.bias), bf16(blk.ln2.weight),
                           bf16(blk.ln2.bias)).view(b, s, d)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        off = (blk.ln2(x).float() - want.float()).abs().max().item()
    res = {"max_abs": err.max().item(), "mean_abs": err.mean().item(),
           "ffn_moves_ln_by": off}
    log(f"[check] fused_ffn_ln vs a flagship bf16 EncoderBlock's "
        f"ln2(x + ffn(x)) on ({b}, {s}, {d}): max |diff| "
        f"{res['max_abs']:.3e}, mean {res['mean_abs']:.3e} (tolerance "
        f"{TOL_FFN_BLOCK}); the FFN moves LN(x) by {off:.3f}")
    if not torch.isfinite(got).all() or off < 0.05 \
            or res["max_abs"] > TOL_FFN_BLOCK["max_abs"] \
            or res["mean_abs"] > TOL_FFN_BLOCK["mean_abs"]:
        fail(f"fused_ffn_ln disagrees with the EncoderBlock: {res}")
    return res


def fused_ffn_path():
    """The main path of #9, counted: `python -m m3p_tpu_torch.bench_fused_ffn`
    at the tool's shape, in this process: the kernel, its plain version and
    the cuBLAS yardstick timed with CUDA events (a call costs the host far
    less than the kernel); every one of its 34 launches must take the
    "cluster" design.  Then, outside the counted run, "cluster" and
    "tile32" in turns on the tool's tensors, and the clusters the card
    holds at once."""
    from m3p_tpu_torch import bench_fused_ffn
    from m3p_tpu_torch.ops import fused_ffn as ops

    iters = 30
    zero_launch_counts()
    out = bench_fused_ffn.run(iters=iters)
    counts = launch_counts()
    want = {k_: 0 for k_ in counts}
    want["fused_ffn"] = want["fused_ffn_cluster"] = 1 + 3 + iters
    if counts != want or out["launches"] != want["fused_ffn"] \
            or out["launches_by_design"]["cluster"] != want["fused_ffn"]:
        fail(f"bench_fused_ffn: launches {counts} "
             f"({out['launches_by_design']}), expected {want}")
    if not out["finite"] or out["max_abs_err"] > 0.0625 \
            or out["mean_abs_err"] > kernel_tests().FFN_MEAN_BF16:
        fail(f"bench_fused_ffn: the kernel disagrees with the plain "
             f"version: {out}")
    shape = out["shape"]
    args = bench_fused_ffn.tool_inputs(shape["M"], shape["D"], shape["H"])
    ms, ms_tile32 = in_turns(lambda: ops._launch(*args, 1e-12),
                             lambda: ops._launch(*args, 1e-12,
                                                 _design="tile32"))
    out.update({"design": "cluster", "ms_turns": ms,
                "ms_tile32": ms_tile32,
                "speedup_over_tile32": ms_tile32 / ms,
                "clusters_at_once": ops.cluster_occupancy(shape["D"])})
    log(f"[path] python -m m3p_tpu_torch.bench_fused_ffn: {json.dumps(out)}")
    log(f"[time] fused_ffn_ln (#9) {shape} CUDA events: kernel "
        f"{out['kernel_ms']:.4f} ms ({out['kernel_tflops']:.1f} TF/s), "
        f"in turns cluster {ms:.4f} vs tile32 {ms_tile32:.4f} "
        f"({ms_tile32 / ms:.2f}x), plain {out['plain_ms']:.4f}, cuBLAS "
        f"yardstick {out['library_ms']:.4f}, bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); {out['clusters_at_once']} clusters at once")
    return out


# ---------------------------------------------------------------------------
# phase 10: decoder training
# ---------------------------------------------------------------------------

# the DataConfig defaults (m3p_tpu/config.py): 24 images of 100 regions,
# captions of max_len 64, so T = 63 decoder positions
CAPTION_B, CAPTION_LEN = 24, 64
# CLM at phase 7's stream length; B = 2, since CLM takes full-vocabulary
# logits at every position (at B = 8 4.1e9 of them, 16.4 GB in fp32)
CLM_B = 2
# the losses of the phase: (loss in train/steps.py, batch, loss arguments)
DECODER_PATHS = {
    "caption": ("caption_loss", "caption", {}),
    "caption_refine_encoder": ("caption_loss", "caption",
                               {"refine_encoder": True}),
    "mt": ("mt_loss", "mt", {}),
    "mt_caption": ("mt_caption_loss", "mt_caption", {}),
    "tifg": ("tifg_loss", "caption", {}),
    "slide": ("slide_loss", "slide", {}),
    "clm": ("clm_loss", "clm", {}),
}


def decoder_config(n_layers=12, dtype="bfloat16", rate=RATE, fused=False,
                   max_positions=None):
    """The flagship width (`train_config`), dropout and attention dropout
    ``rate``; ``max_positions`` for CLM's streams."""
    cfg = dataclasses.replace(train_config(n_layers, dtype, rate),
                              use_fused_dropout=fused)
    if max_positions:
        cfg = dataclasses.replace(cfg, max_positions=max_positions)
    return cfg


def decoder_batch(kind, seed, device, b=CAPTION_B):
    """A batch of ``kind`` from `m3p_tpu_torch.data.synthetic` at the
    DataConfig sizes (CLM: ``CLM_B`` streams of phase 7's length)."""
    import numpy as np
    import torch

    from m3p_tpu_torch.data import synthetic

    rng = np.random.RandomState(seed)
    if kind == "caption":
        batch = synthetic.make_caption_batch(rng, b, CAPTION_LEN, REGIONS,
                                             250002)
    elif kind == "mt":
        batch = synthetic.make_mt_batch(rng, b, CAPTION_LEN, 250002)
    elif kind == "mt_caption":
        batch = synthetic.make_mt_batch(rng, b, CAPTION_LEN, 250002)
        images = synthetic.make_caption_batch(rng, b, CAPTION_LEN, REGIONS,
                                              250002)
        batch.update({k: images[k] for k in ("feats", "locs", "img_len")})
    elif kind == "slide":
        batch = synthetic.make_slide_batch(rng, b, CAPTION_LEN, REGIONS,
                                           250002)
    else:
        batch = synthetic.make_stream_batch(rng, CLM_B, LONG_S, 250002)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def decoder_step(path, with_grad_norm=False, **kw):
    from m3p_tpu_torch.train import steps

    name, _, loss_kw = DECODER_PATHS[path]
    return steps.make_train_step(functools.partial(
        getattr(steps, name), **loss_kw, **kw), with_grad_norm=with_grad_norm)


def decoder_per_step(cfg, path):
    """Launches a step of ``path`` makes: one #1 and two #2 per attention
    layer (the refiner's R, the encoder's L, the decoder's 2 L: causal
    self-attention and cross-attention), none in the backward for TIFG's
    detached target (its refiner); CLM's L causal self-attentions through
    #5/#6; with fused dropout one #7 and one #8 per residual of a block
    (two in the encoder, three in the decoder)."""
    L, R = cfg.n_layers, cfg.refine_layers
    encoder_only = path in ("clm", "slide")
    fused = (2 if encoder_only else 5) * L if cfg.use_fused_dropout else 0
    if path == "clm":
        return expected_launches(flash=(L, 2 * L), dropout=fused)
    fwd = {"caption": R + 3 * L, "caption_refine_encoder": 2 * R + 3 * L,
           "mt": 3 * L, "mt_caption": R + 3 * L, "tifg": R + 3 * L,
           "slide": R + L}[path]
    bwd = 2 * (fwd - R) if path == "tifg" else 2 * fwd
    return expected_launches((fwd, bwd), dropout=fused)


def caption_step_flops(cfg, b, t, regions=REGIONS):
    """Model FLOPs of one caption step, 3 x the forward's products (as
    `bench.mct_step_flops` counts them): per image the region projection,
    2 R (2048 + 5) d; each refiner layer, 2 (7 d^2 + 2 d f) R + 4 R^2 d;
    each encoder block, 2 (4 d^2 + 2 d f) R + 4 R^2 d; each decoder block
    over T positions, 2 (4 d^2 + 2 d f) T + 4 T^2 d (the causal products
    counted whole, as the kernels compute them), and its cross-attention,
    2 (2 d^2) (T + R) + 4 T R d; the tied word head at every position,
    2 T d V."""
    d, f = cfg.emb_dim, cfg.ffn_dim
    image = 2 * regions * (cfg.img_feat_dim + cfg.img_loc_dim) * d
    refiner = cfg.refine_layers * (2 * (7 * d * d + 2 * d * f) * regions
                                   + 4 * regions * regions * d)
    encoder = cfg.n_layers * (2 * (4 * d * d + 2 * d * f) * regions
                              + 4 * regions * regions * d)
    decoder = cfg.n_layers * (2 * (4 * d * d + 2 * d * f) * t
                              + 4 * t * t * d + 4 * d * d * (t + regions)
                              + 4 * t * regions * d)
    head = 2 * t * d * cfg.n_words
    return 3 * b * (image + refiner + encoder + decoder + head)


def one_step(what, state, step, batch, gens, per_step):
    """One counted step of the main path: launches checked against
    ``per_step``, every metric finite."""
    import torch

    # ---- the main path, counted ----
    zero_launch_counts()
    state, m = step(state, batch, gens)
    torch.cuda.synchronize()
    counts = launch_counts()
    # ---- checks ----
    check_launches(what, counts, per_step, 1)
    if not all(torch.isfinite(v).all() for v in m.values()):
        fail(f"{what}: non-finite metrics {m}")
    metrics = {k: v.item() for k, v in m.items()}
    log(f"[decoder] one {what} step: launches {counts}; metrics {metrics}")
    return state, {"launches": counts, "metrics": metrics}


def decoder_slice(seed):
    """The caption step at the flagship width (2 warm-up and 8 timed
    steps, a profile of one), then one step of each other loss, one caption
    step with fused dropout, and one CLM step on its own model; the
    launches of each counted and checked."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    t0 = time.time()
    cfg = decoder_config()
    model = build_model(cfg, seed, "cuda")
    tx, schedule = build_optimizer(OPTIM_SPEC, clip_grad_norm=CLIP)
    state = create_train_state(model, tx)
    step = decoder_step("caption", with_grad_norm=True)
    gens = Generators.from_seed(seed, "cuda")
    batch = decoder_batch("caption", seed, "cuda")
    b, t = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
    watched = {n: p.detach().clone() for n, p in model.named_parameters()
               if n in ("block_0.encoder_attn.q_lin.weight",
                        "block_0.attn.q_lin.weight", "text_emb.word.weight",
                        "refiner.layer_0.aoa_attn.aoa.weight")}
    per_step = decoder_per_step(cfg, "caption")
    n_steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    # ---- the main path, counted ----
    zero_launch_counts()
    for i in range(n_steps):
        if i == WARMUP_STEPS:
            torch.cuda.synchronize()
            wall0 = time.perf_counter()
            start.record()
        state, m = step(state, batch, gens)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - wall0
    counts = launch_counts()
    # ---- checks ----
    check_launches("caption", counts, per_step, n_steps)
    step_ms = start.elapsed_time(end) / TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack([m["ce"] for m in metrics]).float().cpu()
    norms = torch.stack([m["grad_norm"] for m in metrics]).float().cpu()
    if not torch.isfinite(losses).all() or not torch.isfinite(norms).all():
        fail(f"caption: non-finite loss or gradient norm {losses.tolist()}")
    moved = {n: (p.detach() - watched[n]).abs().max().item()
             for n, p in model.named_parameters() if n in watched}
    if state.step != n_steps or not all(v > 0 for v in moved.values()):
        fail(f"caption: the parameters did not change: {moved}")
    n_words = metrics[-1]["n_words"].item()
    flops = caption_step_flops(cfg, b, t)
    numbers = {
        "samples_per_s": b / (step_ms / 1e3),
        "target_tokens_per_s": n_words / (step_ms / 1e3),
        "step_ms": step_ms, "wall_step_ms": wall_s * 1e3 / TIMED_STEPS,
        "peak_memory_gb": peak_gb, "b": b, "t": t, "regions": REGIONS,
        "target_tokens_per_step": n_words,
        "launches": counts, "launches_per_step": per_step,
        "flops_per_step": flops,
        "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
        "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
        "lr_last": schedule(state.step - 1),
    }
    log(f"[decoder] {n_steps} caption steps at B={b} images x {REGIONS} "
        f"regions, T={t}, 12 + 12 blocks + 3 refiner layers, dropout {RATE}, "
        f"attention dropout {RATE}: {step_ms:.2f} ms a step (CUDA events, "
        f"{TIMED_STEPS} steps), {numbers['samples_per_s']:.1f} samples/s, "
        f"{numbers['target_tokens_per_s']:.0f} target tokens/s, host wall "
        f"{numbers['wall_step_ms']:.2f} ms a step, peak memory "
        f"{peak_gb:.2f} GB; launches {counts} = {per_step} x {n_steps}; "
        f"{flops / 1e12:.3f} TFLOP a step, MFU {numbers['mfu']:.4f} of 989 "
        f"TF/s; loss {losses[0].item():.4f} -> {losses[-1].item():.4f}; max "
        f"|param change| {moved}")
    prof = profile_window(f"one caption step B={b}",
                          lambda: step(state, batch, gens), reps=1)
    if prof:
        prof["idle_share_vs_event_step"] = 1.0 - prof["device_busy_ms"] / \
            step_ms
    numbers["profile"] = prof

    # ---- one step of each other loss, counted ----
    numbers["paths"] = {}
    for path in ("caption_refine_encoder", "mt", "mt_caption", "tifg",
                 "slide"):
        kind = DECODER_PATHS[path][1]
        state, numbers["paths"][path] = one_step(
            path, state, decoder_step(path), decoder_batch(kind, seed + 1,
                                                           "cuda"),
            gens, decoder_per_step(cfg, path))
    for block in model.blocks:
        block.use_fused_dropout = True
    state, numbers["paths"]["caption_fused"] = one_step(
        "caption with use_fused_dropout", state, decoder_step("caption"),
        batch, gens, decoder_per_step(dataclasses.replace(
            cfg, use_fused_dropout=True), "caption"))
    del state, model, step
    torch.cuda.empty_cache()

    clm_cfg = decoder_config(max_positions=LONG_S + 2)
    model = build_model(clm_cfg, seed, "cuda")
    tx, _ = build_optimizer(OPTIM_SPEC, clip_grad_norm=CLIP)
    _, numbers["paths"]["clm"] = one_step(
        f"CLM (B={CLM_B}, S={LONG_S})", create_train_state(model, tx),
        decoder_step("clm"), decoder_batch("clm", seed, "cuda"), gens,
        decoder_per_step(clm_cfg, "clm"))
    del model
    torch.cuda.empty_cache()
    numbers["phase_s"] = time.time() - t0
    return numbers


def compare_decoder_grads_with_cpu(seed):
    """fp32 gradients of caption_loss at depth 2 and full width, on the
    card (the CUDA-core designs of #1/#2) and on the CPU (plain versions),
    at rate 0, the same weights and batch on both sides."""
    from m3p_tpu_torch.ops.attention import attention_packed
    from m3p_tpu_torch.train.steps import caption_loss

    cfg = decoder_config(n_layers=2, dtype="float32", rate=0.0)
    cpu_model = cpu_model_from_card(cfg, seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    batch = decoder_batch("caption", seed + 2, "cpu", b=2)
    losses = {}
    before = (dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design))
    for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
        loss, _ = caption_loss(model, {k: t.to(dev) for k, t in batch.items()},
                               None, deterministic=True)
        loss.backward()
        losses[dev] = loss.item()
    # 3 refiner + 2 encoder + 4 decoder attention layers
    n = cfg.refine_layers + 3 * cfg.n_layers
    if (launched_design(attention_packed.launches_by_design, before[0], n),
            launched_design(attention_packed.bwd_launches_by_design,
                            before[1], 2 * n)) != ("cuda_cores",) * 2:
        fail("the fp32 caption check did not take the CUDA-core design")
    worst, worst_name, leaves = worst_grad_diff(gpu_model, cpu_model)
    log(f"[fp32 grads decoder] caption_loss, depth 2, B=2, rate 0: loss "
        f"card {losses['cuda']:.6f} vs CPU {losses['cpu']:.6f}; {leaves} "
        f"leaves, max relative |card - CPU| = {worst:.3e} ({worst_name}; "
        f"tolerance {TOL_GRAD_FP32})")
    if worst > TOL_GRAD_FP32 or abs(losses["cuda"] - losses["cpu"]) > 1e-4:
        fail("fp32 caption gradients on the card disagree with the CPU")
    return worst


def decoder_learning_check(seed, steps=40):
    """Depth 2 at full width, one fixed caption batch (B = 24), "adam,lr=
    0.0001", dropout on: the mean loss of the last 5 steps must be below
    that of the first 5."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    model = build_model(decoder_config(n_layers=2), seed + 3, "cuda")
    tx, _ = build_optimizer("adam,lr=0.0001")
    state = create_train_state(model, tx)
    step = decoder_step("caption")
    gens = Generators.from_seed(seed + 3, "cuda")
    batch = decoder_batch("caption", seed + 3, "cuda")
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, gens)
        losses.append(m["ce"])
    losses = torch.stack(losses).float().cpu()
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    log(f"[learn decoder] depth 2, B={batch['tokens'].shape[0]}, {steps} "
        f"caption steps of adam lr 1e-4 on one batch: mean loss of the "
        f"first 5 steps {first:.4f}, of the last 5 {last:.4f}")
    if not torch.isfinite(losses).all() or not last < first:
        fail(f"the caption model did not learn: {losses.tolist()}")
    return {"first5": first, "last5": last}


# ---------------------------------------------------------------------------
# phase 11: generation
# ---------------------------------------------------------------------------

# the engine's defaults (`m3p_tpu/serve/engine.py:57-59`); 16 images of
# 100 regions or 16 sentences of the 32-token bucket a throughput call
GEN_B, GEN_BEAM, GEN_LEN, GEN_PENALTY = 16, 5, 20, 1.0
# the other calls of the phase: the 64-image bucket, two images on the
# custom /v1/caption path (one on the batcher's) and three sentences on
# /v1/translate
GEN_BIG_B, GEN_HTTP_IMAGES, GEN_HTTP_TEXTS = 64, 2, 3
GEN_TEXT_BUCKET = 32
GEN_WARM, GEN_TIMED = 2, 5
# /v1/caption requests of one image timed one after another
GEN_HTTP_REQUESTS = 12
# the cache length from which the self-attention takes #5 (PALLAS_MIN_KV_LEN
# keys), and the longest the positions allow
LONG_DECODE = 514
# fp32 logits of the full-width decoder on the card against the CPU: 12
# blocks of fp32 GEMMs and the 768-long dot products of the word head,
# summed in another order (TOL_SCORE_FP32's reason)
TOL_LOGIT_FP32 = 1e-3
GEN_LANGS = {"en": 0, "de": 1}


def generation_source_shapes():
    """(B, S) of each source encoding on phase 11's path, B the engine's
    batch bucket of the call: captions over the regions, translations over
    the text bucket."""
    from m3p_tpu_torch.serve.engine import DEFAULT_BATCH_BUCKETS, _bucket

    regions = full_width_config("bfloat16").max_region_num
    caps = (GEN_B, 1, GEN_HTTP_IMAGES, GEN_BIG_B)
    texts = (GEN_B, GEN_HTTP_TEXTS)
    return sorted({(_bucket(n, DEFAULT_BATCH_BUCKETS), s)
                   for ns, s in ((caps, regions), (texts, GEN_TEXT_BUCKET))
                   for n in ns})


def generation_calls(cfg, what, max_len=GEN_LEN):
    """Launches one engine call of ``what`` makes: the source encoder's
    attention layers through #1 (the refiner's and the blocks' for a
    caption, the blocks' for a translation), all on the tensor cores in
    bf16, and none in the decode steps below LONG_DECODE - 2 = 512 cached
    keys (`mha_reference`, no kernel); from there one #5 a block and a
    step, all on the tensor cores."""
    layers = cfg.n_layers + (cfg.refine_layers if what == "caption" else 0)
    steps = max_len - 1
    flash = cfg.n_layers * steps if max_len >= 512 else 0
    return expected_launches((layers, 0), (flash, 0))


def counted_call(what, fn, per_call):
    """One call of the main path, its launches counted and checked."""
    import torch

    zero_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    check_launches(what, counts, per_call, 1)
    return out, counts


def gen_images(rng, n):
    return [image(rng, int(rng.randint(10, 101))) for _ in range(n)]


def gen_texts(rng, n):
    """Sentences of 20-28 one-piece words: 22-30 ids with the specials,
    the 32-token bucket."""
    return [sentence(rng, int(rng.randint(20, 29))) for _ in range(n)]


def check_eos_rule(toks, lens, max_len, what):
    """lengths = first generated EOS + 2 (max_len without one), PAD after
    the EOS; -> the number of rows that ended with an EOS."""
    from m3p_tpu_torch.config import EOS_IDX, PAD_IDX

    ended = 0
    for row, n in zip(toks.tolist(), lens.tolist()):
        gen = row[1:]
        want = gen.index(EOS_IDX) + 2 if EOS_IDX in gen else max_len
        if n != want or any(t != PAD_IDX for t in row[want:]):
            fail(f"{what}: a row of length {n} breaks the EOS rule: {row}")
        ended += EOS_IDX in gen
    return ended


def greedy_sanity(engine, imgs):
    """Learning-free: greedy lengths obey the EOS rule and rows after their
    EOS hold PAD.  A random 250,002-word model hardly emits EOS, so the
    check runs twice: as it is, and with the word head's EOS bias raised
    for one call to the median of the first step's gaps between a row's
    top logit and its EOS logit, so that about half the rows end at once
    and the others go on."""
    import torch

    from m3p_tpu_torch.config import EOS_IDX
    from m3p_tpu_torch.model.generation import _decode_step, greedy_generate

    model = engine.model
    feats, locs, mask = engine.image_batch(imgs)
    with torch.inference_mode():
        enc = model.encode_image(feats, locs, mask, True)
        toks, lens = greedy_generate(model, enc, mask, GEN_LEN)
        plain = check_eos_rule(toks, lens, GEN_LEN, "greedy")
        cache = model.init_decode_cache(enc, 2)
        start = torch.zeros((feats.shape[0], 1), dtype=torch.long,
                            device=enc.device)
        logits = _decode_step(model, start, start, None, enc, mask, cache)
        gap = logits.max(dim=-1).values - logits[:, EOS_IDX]
        bias = model.pred_layer.bias
        saved = bias[EOS_IDX].item()
        bias[EOS_IDX] += gap.median().item()
        try:
            toks, lens = greedy_generate(model, enc, mask, GEN_LEN)
        finally:
            bias[EOS_IDX] = saved
        ended = check_eos_rule(toks, lens, GEN_LEN, "greedy, EOS raised")
    if not 0 < ended:
        fail("greedy with the EOS bias raised: no row ended; the EOS rule "
             "went unchecked")
    log(f"[generation] EOS rule held: {plain} of {len(imgs)} rows ended "
        f"with the model as it is, {ended} with the EOS bias raised by "
        f"{gap.median().item():.4f} (lengths {lens.tolist()})")
    return {"rows": len(imgs), "ended": plain, "ended_eos_raised": ended}


def teacher_forced_logits(model, enc, mask, toks):
    """fp32 logits (steps, B, V) of the cached decoder fed ``toks``."""
    import torch

    from m3p_tpu_torch.model.generation import _decode_step

    b, n = toks.shape
    cache = model.init_decode_cache(enc, n)
    out = []
    with torch.inference_mode():
        for t in range(n - 1):
            pos = torch.full((b, 1), t, device=enc.device)
            out.append(_decode_step(model, toks[:, t:t + 1], pos, None, enc,
                                    mask, cache))
    return torch.stack(out)


def compare_generation_with_cpu(seed, tokenizer):
    """fp32 at full width: greedy on the card (`mha_reference` in the
    decode steps, #1's CUDA-core design in the encoder), then the card's
    tokens teacher-forced through the cached decoder on the card and on the
    CPU: the largest logit difference of each step, each card token within
    TOL_LOGIT_FP32 of the CPU's top logit, and the card's own teacher-forced
    argmax equal to its greedy tokens."""
    import numpy as np
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.generation import greedy_generate
    from m3p_tpu_torch.ops.attention import attention_packed
    from m3p_tpu_torch.serve.engine import InferenceEngine

    t0 = time.time()
    rng = np.random.RandomState(seed + 11)
    cfg = full_width_config("float32")
    # drawn on the card, where the initialisation is fast; the CPU gets a
    # copy of the same weights
    gpu_model = build_model(cfg, seed, "cuda")
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    imgs = [image(rng, n) for n in (100, 37)]
    logits, toks = {}, None
    before = dict(attention_packed.launches_by_design)
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        engine = InferenceEngine(model, tokenizer, device=dev)
        feats, locs, mask = engine.image_batch(imgs)
        with torch.inference_mode():
            enc = model.encode_image(feats, locs, mask, True)
            if toks is None:
                toks, _ = greedy_generate(model, enc, mask, GEN_LEN)
            logits[dev] = teacher_forced_logits(model, enc, mask,
                                                toks.to(dev)).float().cpu()
    took = launched_design(attention_packed.launches_by_design, before,
                           cfg.n_layers + cfg.refine_layers)
    from m3p_tpu_torch.config import EOS_IDX

    toks = toks.cpu()
    gpu, cpu = logits["cuda"], logits["cpu"]
    per_step = (gpu - cpu).abs().amax(dim=(1, 2)).tolist()
    gen = toks[:, 1:].T                               # (steps, B)
    # a row's steps up to its first EOS (after it, it emits PAD)
    live = torch.cumsum((gen == EOS_IDX).long(), 0) - (gen == EOS_IDX).long()
    live = live == 0
    slack = (cpu.max(dim=-1).values
             - cpu.gather(2, gen[..., None])[..., 0])[live].max()
    own = (gpu.argmax(dim=-1) == gen)[live]
    log(f"[fp32 generation] 2 images, greedy at max_len {GEN_LEN} on the "
        f"card ({took} in the encoder), teacher-forced card vs CPU: max "
        f"|logit diff| by step {[f'{d:.2e}' for d in per_step]} (tolerance "
        f"{TOL_LOGIT_FP32}); the CPU's top logit above the card token's by "
        f"at most {slack.item():.3e}; tokens {toks.tolist()}")
    if took != "cuda_cores" or max(per_step) > TOL_LOGIT_FP32 \
            or slack.item() > TOL_LOGIT_FP32 or not own.all():
        fail("fp32 generation on the card disagrees with the CPU")
    return {"max_logit_diff": max(per_step),
            "max_logit_diff_by_step": per_step,
            "cpu_top_minus_card_token_max": slack.item(),
            "check_s": time.time() - t0}


def time_decode_step(engine, imgs):
    """The parts of one beam-5 decode step at B * K = 80 rows and a cache of
    GEN_LEN positions, CUDA events over 50 calls each: the blocks (the
    embeddings and 12 blocks at one position), the word head (the tied
    250,002-word table and its fp32 cast), the stable top-2K with the
    logsumexp over (80, 250002) fp32 logits, and the self-cache gather of
    the surviving beams."""
    import torch

    from m3p_tpu_torch.ops.topk import top_k

    model = engine.model
    feats, locs, mask = engine.image_batch(imgs)
    bk = feats.shape[0] * GEN_BEAM
    dev = feats.device
    with torch.inference_mode():
        enc = model.encode_image(feats, locs, mask, True)
        cache = model.init_decode_cache(enc, GEN_LEN, bk)
        tok = torch.full((bk, 1), 5, device=dev)
        pos = torch.full((bk, 1), 5, device=dev)
        step_mask = torch.ones((bk, 1), dtype=torch.bool, device=dev)

        def blocks():
            cache.pos = 5
            return model.encode_text(tok, step_mask, None, pos, causal=True,
                                     src_enc=enc, src_mask=mask, cache=cache)

        hidden = blocks()
        logits = model.word_logits(hidden[:, 0]).float()
        rows = torch.arange(bk, device=dev).flip(0)
        parts = {
            "blocks": cuda_ms(blocks),
            "word_head": cuda_ms(
                lambda: model.word_logits(hidden[:, 0]).float()),
            "top_k_and_lse": cuda_ms(
                lambda: (top_k(logits, 2 * GEN_BEAM),
                         torch.logsumexp(logits, dim=-1))),
            "self_cache_gather": cuda_ms(lambda: cache.select(rows)),
        }
    kv = cache.layers[0].self_kv.k
    # k and v of every block read and written once
    gather_bytes = 2 * 2 * kv.numel() * kv.element_size() * len(cache.layers)
    return {"ms": parts, "rows": bk, "self_cache_gather_bytes": gather_bytes}


def time_flash_decode_shape(gen):
    """#5 at the decode shape (B * K = 80, Sq = 1, Sk = 514, H = 12,
    Dh = 64, bf16, every cached key valid): as issued and replayed from a
    CUDA graph, beside its plain version, SDPA on head-major copies with
    the same boolean mask (one call each way), `attention_bhsd` with its
    copy of the cache into the packed layout, and the bound: q, k, v and
    the mask read once and o written once (the cache is read once)."""
    import torch
    import torch.nn.functional as F

    from m3p_tpu_torch.ops import attention as ops

    b, sq, sk, h, dh = DECODE_SHAPE
    q, k, v, mask = decode_inputs(sk, torch.bfloat16, gen)
    scale = dh ** -0.5
    before = dict(ops.attention_flash.launches_by_design)
    ops._launch_flash_fwd(q, k, v, mask, h, False, scale, 0.0, None)
    torch.cuda.synchronize()
    if launched_design(ops.attention_flash.launches_by_design, before,
                       1) != "tensor_cores":
        fail("the decode shape does not take the tensor-core design")
    mask_c = mask.contiguous()

    def kernel():
        return ops._launch_flash_fwd(q, k, v, mask_c, h, False, scale, 0.0,
                                     None)

    qh, kh, vh = (t.view(b, t.shape[1], h, dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    sdpa_mask = mask_c[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=sdpa_mask)

    ms = cuda_ms(kernel)
    ms_graph = graph_ms(kernel)
    lib_ms = cuda_ms(sdpa)
    lib_graph = graph_ms(sdpa)
    route_ms = cuda_ms(lambda: ops.attention_bhsd(qh, kh, vh, mask_c))
    plain_ms = cuda_ms(lambda: ops.attention_flash_reference(q, k, v, mask_c,
                                                             h),
                       iters=10, warmup=2)
    n_bytes = (2 * b * sq + 2 * b * sk) * h * dh * 2 + b * sk
    flops = 4 * b * h * sq * sk * dh
    bound_ms, bound_by = bound(n_bytes, flops)
    out = {"ms": ms, "ms_graph": ms_graph, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_ms_graph": lib_graph,
           "attention_bhsd_ms": route_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes": n_bytes, "flops": flops,
           "design": "tensor_cores",
           "shape": {"B": b, "Sq": sq, "Sk": sk, "H": h, "Dh": dh,
                     "dtype": "bfloat16"}}
    log(f"[time] flash_attention_fwd at the decode shape B={b} Sq={sq} "
        f"Sk={sk} bf16: {ms:.4f} ms as issued, {ms_graph:.4f} from a CUDA "
        f"graph; plain {plain_ms:.4f}; sdpa {lib_ms:.4f} ({lib_graph:.4f} "
        f"from a graph); attention_bhsd with the packed copy {route_ms:.4f}; "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return out


def full_vocab_tokenizer(n_ids=250002):
    """A tokenizer of ``n_ids`` ids (250,002: the flagship's): n_ids - 2
    pieces with the four specials and <mask>, so that every id a random
    model of that vocabulary emits decodes (``decode`` raises on an id
    past the vocab)."""
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.tsv")
        write_vocab(vocab, n_ids - 2)
        tokenizer = XLMRTokenizer(vocab)
    if tokenizer.vocab_size != n_ids:
        fail(f"the generated vocab has {tokenizer.vocab_size} ids")
    return tokenizer


def generation_setup(seed, tokenizer):
    """Phase 11's engine (the flagship width in bf16, its weights from
    ``seed``) and inputs: -> (cfg, engine, rng, GEN_B images, GEN_B
    sentences)."""
    import numpy as np

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.serve.engine import InferenceEngine

    rng = np.random.RandomState(seed + 10)
    cfg = full_width_config("bfloat16")
    engine = InferenceEngine(build_model(cfg, seed, "cuda"), tokenizer,
                             device="cuda", max_regions=cfg.max_region_num,
                             beam_size=GEN_BEAM, max_gen_len=GEN_LEN,
                             length_penalty=GEN_PENALTY, lang2id=GEN_LANGS)
    return cfg, engine, rng, gen_images(rng, GEN_B), gen_texts(rng, GEN_B)


def generation_slice(seed, tokenizer, gen):
    """Phase 11: captions and translations at the flagship width, bf16,
    through the engine and over HTTP, each call's launches counted; the
    EOS rule; throughput, the 64-image bucket, /v1/caption latency, a
    profile of a beam-5 call, the decode step's parts; then a beam-5
    caption call at max_len 514 on a depth-2 model, whose self-attention
    takes #5 from the first step."""
    import numpy as np
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.serve.engine import InferenceEngine
    from m3p_tpu_torch.serve.server import make_server

    t0 = time.time()
    cfg, engine, rng, imgs, texts = generation_setup(seed, tokenizer)
    ids = tokenizer.encode_batch(texts, max_ids=62)
    if not all(GEN_TEXT_BUCKET // 2 < len(s) + 2 <= GEN_TEXT_BUCKET
               for s in ids):
        fail("the translation texts do not fall in the 32-token bucket")
    cap_calls = generation_calls(cfg, "caption")
    mt_calls = generation_calls(cfg, "translate")
    runs = {}
    server, app = make_server(engine, host="127.0.0.1", port=0,
                              max_body_bytes=512 * 1024 * 1024)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        # ---- the main path, counted call by call ----
        caps = {}
        for name, beam in (("greedy", 1), ("beam", GEN_BEAM)):
            caps[name], runs[f"caption_{name}"] = counted_call(
                f"caption {name}", lambda: engine.caption(
                    imgs, beam_size=beam), cap_calls)
            _, runs[f"translate_{name}"] = counted_call(
                f"translate {name}", lambda: engine.translate(
                    texts, "de", "en", beam_size=beam), mt_calls)
        one = as_json(imgs[0])
        http, runs["http_caption"] = counted_call(
            "/v1/caption (batcher)",
            lambda: post(base, "/v1/caption", {"images": [one]}), cap_calls)
        custom, runs["http_caption_custom"] = counted_call(
            "/v1/caption (custom)",
            lambda: post(base, "/v1/caption", {
                "images": [one] * GEN_HTTP_IMAGES, "beam_size": GEN_BEAM}),
            cap_calls)
        mt_http, runs["http_translate"] = counted_call(
            "/v1/translate", lambda: post(base, "/v1/translate", {
                "texts": texts[:GEN_HTTP_TEXTS], "src_lang": "en",
                "tgt_lang": "de"}),
            mt_calls)
        # ---- checks ----
        for name, out in caps.items():
            if len(out) != GEN_B or not all(isinstance(c, str) and c
                                            for c in out):
                fail(f"caption {name}: {out}")
        if http["captions"] != custom["captions"][:1] \
                or custom["captions"][0] != custom["captions"][1]:
            fail(f"/v1/caption: the batcher {http} and the custom path "
                 f"{custom} disagree")
        if len(mt_http["translations"]) != GEN_HTTP_TEXTS:
            fail(f"/v1/translate: {mt_http}")
        engine_one = engine.caption(imgs[:1])
        if http["captions"] != engine_one:
            fail(f"/v1/caption {http} vs engine.caption {engine_one}")
        sublap("p11_main_path")
        log(f"[generation] launches per call {json.dumps(runs)}; caption "
            f"(beam 5) {caps['beam'][0][:60]!r}, /v1/caption "
            f"{http['captions'][0][:60]!r}")
        sanity = greedy_sanity(engine, imgs)

        # ---- numbers ----
        feats, locs, mask = engine.image_batch(imgs)
        with torch.inference_mode():
            encode_ms = cuda_ms(lambda: engine.model.encode_image(
                feats, locs, mask, True), iters=10, warmup=2)
        numbers = {"encode_image_ms": encode_ms}
        # caption 2 + 5 calls, translate 1 + 5 (to keep the phase short)
        for name, beam in (("greedy", 1), ("beam", GEN_BEAM)):
            ms = cuda_ms(lambda: engine.caption(imgs, beam_size=beam),
                         iters=GEN_TIMED, warmup=GEN_WARM)
            numbers[f"caption_{name}"] = {
                "ms": ms, "images_per_s": GEN_B / (ms / 1e3),
                "decode_tokens_per_s": GEN_B * (GEN_LEN - 1) / (ms / 1e3),
                "ms_per_decode_step": (ms - encode_ms) / (GEN_LEN - 1)}
            ms = cuda_ms(lambda: engine.translate(texts, "de", "en",
                                                  beam_size=beam),
                         iters=5, warmup=1)
            numbers[f"translate_{name}"] = {
                "ms": ms, "sentences_per_s": GEN_B / (ms / 1e3),
                "decode_tokens_per_s": GEN_B * (GEN_LEN - 1) / (ms / 1e3)}
        big = gen_images(rng, GEN_BIG_B)
        engine.caption(big)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: engine.caption(big), iters=1, warmup=0)
        numbers["caption_beam_64"] = {
            "ms": ms, "images_per_s": GEN_BIG_B / (ms / 1e3),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        post(base, "/v1/caption", {"images": [one]})
        lat = []
        for i in range(GEN_HTTP_REQUESTS):
            body = {"images": [as_json(imgs[i % GEN_B])]}
            t1 = time.perf_counter()
            post(base, "/v1/caption", body)
            lat.append((time.perf_counter() - t1) * 1e3)
        p50, p99 = (float(x) for x in np.percentile(lat, [50, 99]))
        numbers["http_caption_p50_ms"] = p50
        numbers["http_caption_p99_ms"] = p99
        numbers["decode_step_parts"] = time_decode_step(engine, imgs)
        numbers["profile_beam"] = profile_window(
            f"caption beam {GEN_BEAM}, {GEN_B} images",
            lambda: engine.caption(imgs), reps=1)
    finally:
        server.shutdown()
        server.server_close()
        app.close()
        thread.join(timeout=30)
    if thread.is_alive():
        fail("server thread did not stop")
    sublap("p11_main_path_and_numbers")
    numbers["main_path_and_numbers_s"] = time.time() - t0
    log(f"[perf] generation at {GEN_B} images / sentences, max_gen_len "
        f"{GEN_LEN}: {json.dumps(numbers)}")
    del engine, app, server
    torch.cuda.empty_cache()

    # ---- the long decode: #5 in every step, counted ----
    long_cfg = dataclasses.replace(cfg, n_layers=2)
    engine = InferenceEngine(build_model(long_cfg, seed, "cuda"), tokenizer,
                             device="cuda", max_regions=cfg.max_region_num,
                             lang2id=GEN_LANGS)
    per_call = generation_calls(long_cfg, "caption", LONG_DECODE)
    t1 = time.perf_counter()
    long_caps, runs["long_decode"] = counted_call(
        f"caption beam {GEN_BEAM} at max_len {LONG_DECODE}, depth 2",
        lambda: engine.caption(imgs, beam_size=GEN_BEAM,
                               max_len=LONG_DECODE), per_call)
    long_s = time.perf_counter() - t1
    if len(long_caps) != GEN_B:
        fail(f"long decode: {len(long_caps)} captions")
    log(f"[generation] beam {GEN_BEAM} at max_len {LONG_DECODE}, depth 2, "
        f"{GEN_B} images: {long_s:.2f} s, launches {runs['long_decode']} = "
        f"{per_call}")
    del engine
    torch.cuda.empty_cache()
    numbers.update(launches=runs, sanity=sanity, long_decode_s=long_s,
                   flash_decode_shape=time_flash_decode_shape(gen),
                   phase_s=time.time() - t0)
    return numbers


# ---------------------------------------------------------------------------
# phase 12: the denoising and adversarial objectives
# ---------------------------------------------------------------------------

# FreeLB at the trainer's settings (m3p_tpu/config.py:351-356, passed by
# m3p_tpu/train/trainer.py:256-260; adv_init_mag at FreeLBConfig's 1e-4,
# which the trainer does not set)
FREELB = dict(adv_steps=3, adv_lr=1e-3, adv_max_norm=0.0, norm_type="l2",
              free_text=True, free_img=True)
FREELB_WARMUP, FREELB_STEPS = 1, 4
FREELB_SHORT_WARMUP, FREELB_SHORT_STEPS = 1, 2
# the MCT loss of the FreeLB step packs its MLM slots at
# mct_pretrain_loss's default, which the JAX FreeLB step keeps; the
# trainer's plain step at DataConfig.mlm_pack_ratio, the same 0.5
FREELB_PACK = 0.5
# the stream objectives: DataConfig's batch_size x bptt (m3p_tpu/config.py:
# 189, 227) and --word_mass 0.5 (:346); the word noise of --use_noise and
# of AE at XLM's settings (--word_shuffle 3 --word_dropout 0.1
# --word_blank 0.1)
STREAM_B, BPTT, WORD_MASS = 24, 128, 0.5
WORD_NOISE = (3.0, 0.1, 0.1)
# the projection check: a step long enough for the ball to bite
PROJECT_MAX_NORM, PROJECT_LR = 1e-2, 1e-2


def denoising_shapes():
    """(Sq, Sk, causal) of phase 12's attention at B = STREAM_B (the
    `gpu` tests hold them as `DENOISING_CASES`): MASS's decoder, causal
    over its span of round(BPTT * WORD_MASS) positions and across over the
    BPTT-token stream; BART's and AE's decoder, causal over BPTT - 1
    positions and across over the BPTT-token source; the stream encoder;
    the PC pair of two CAPTION_LEN-token sides joined on one EOS."""
    span = max(int(round(BPTT * WORD_MASS)), 1)
    pair = 2 * CAPTION_LEN - 1
    return [(span, span, True), (span, BPTT, False),
            (BPTT - 1, BPTT - 1, True), (BPTT - 1, BPTT, False),
            (BPTT, BPTT, False), (pair, pair, False)]


def freelb_config(**kw):
    from m3p_tpu_torch.train.freelb import FreeLBConfig

    return FreeLBConfig(**{**FREELB, **kw})


def times(per_step, n):
    return {k: v * n for k, v in per_step.items()}


def freelb_mct_slice(seed, fused):
    """The FreeLB MCT step at the flagship width (`m3p_tpu_torch.bench`'s
    model, batch and optimizer; configuration A or B): 1 warm-up and 4
    timed steps, the launches counted, a profile of one step with the
    deltas' ascent as its own span.  Returns (numbers, state, gens,
    batch)."""
    import numpy as np

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.train.freelb import (
        ASCENT_SPAN, make_freelb_pretrain_step)

    label = "B (use_fused_dropout)" if fused else "A"
    cfg = float_mct_config(fused_dropout=fused)
    state, _, gens = bench.setup(cfg, seed, "cuda")
    step = make_freelb_pretrain_step(state.model, bench.SAMPLE_N,
                                     bench.mask_config(cfg), freelb_config())
    batch = bench.make_batch(0, "cuda")
    watched = {n: p.detach().clone()
               for n, p in state.model.named_parameters()
               if n in ("block_0.attn.q_lin.weight", "text_emb.word.weight",
                        "obj_pred.proj.weight")}
    per_step = times(mct_per_step(cfg), FREELB["adv_steps"])
    # ---- the main path, counted ----
    zero_launch_counts()
    numbers = bench.run(state, step, batch, gens, FREELB_WARMUP,
                        FREELB_STEPS)
    counts = launch_counts()
    # ---- checks ----
    n_steps = FREELB_WARMUP + FREELB_STEPS
    if not np.isfinite(numbers["losses"]).all():
        fail(f"FreeLB MCT {label}: non-finite loss {numbers['losses']}")
    check_launches(f"FreeLB MCT {label}", counts, per_step, n_steps)
    moved = {n: (p.detach().float() - watched[n].float()).abs().max().item()
             for n, p in state.model.named_parameters() if n in watched}
    if state.step != n_steps or not all(v > 0 for v in moved.values()):
        fail(f"FreeLB MCT {label}: the parameters did not change: {moved}")
    flops = FREELB["adv_steps"] * bench.mct_step_flops(
        cfg, numbers["bn"], pack_ratio=FREELB_PACK)
    numbers.update({
        "launches": counts, "launches_per_step": per_step,
        "flops_per_step": flops,
        "mfu": flops / (numbers["step_ms"] / 1e3) / BF16_FLOPS_PER_S,
        "loss_first": numbers["losses"][0],
        "loss_last": numbers["losses"][-1]})
    del numbers["losses"]
    log(f"[freelb mct {label}] {n_steps} steps of K = "
        f"{FREELB['adv_steps']} passes at BN={numbers['bn']}: "
        f"{numbers['step_ms']:.2f} ms a step (CUDA events, "
        f"{numbers['steps']} steps), {numbers['samples_per_s']:.1f} "
        f"samples/s, host wall {numbers['wall_step_ms']:.2f} ms a step, "
        f"peak memory {numbers['peak_memory_gb']:.2f} GB; launches "
        f"{counts} = {per_step} x {n_steps}; {flops / 1e12:.3f} TFLOP a "
        f"step, MFU {numbers['mfu']:.4f} of 989 TF/s; loss "
        f"{numbers['loss_first']:.4f} -> {numbers['loss_last']:.4f}; max "
        f"|param change| {moved}")
    prof = profile_window(f"one FreeLB MCT step {label}",
                          lambda: step(state, batch, gens), reps=1,
                          spans=(ASCENT_SPAN,))
    if prof:
        prof["idle_share_vs_event_step"] = (
            1.0 - prof["device_busy_ms"] / numbers["step_ms"])
    numbers["profile"] = prof
    return numbers, state, gens, batch


def trainer_pair(state, gens, batch):
    """The trainer's ``is_freelb`` dispatch for ``pretrain_rel``
    (`m3p_tpu/train/trainer.py:249-287`): the plain MCT step, then the
    FreeLB step, on one batch; the launches of the pair counted."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.train.freelb import make_freelb_pretrain_step

    cfg = state.model.cfg
    plain = bench.make_step(cfg, pack_ratio=FREELB_PACK)
    adv = make_freelb_pretrain_step(state.model, bench.SAMPLE_N,
                                    bench.mask_config(cfg), freelb_config())

    def combined(st, b, g):
        st, m = plain(st, b, g)
        st, m_adv = adv(st, b, g)
        return st, dict(m, adv_loss=m_adv["loss"])

    per_pair = times(mct_per_step(cfg), 1 + FREELB["adv_steps"])
    # ---- the main path, counted ----
    zero_launch_counts()
    state, m = combined(state, batch, gens)
    torch.cuda.synchronize()
    counts = launch_counts()
    # ---- checks ----
    check_launches("the trainer's is_freelb pair", counts, per_pair, 1)
    if not all(torch.isfinite(v).all() for v in m.values()):
        fail(f"the trainer's is_freelb pair: non-finite metrics {m}")
    metrics = {k: v.item() for k, v in m.items()}
    log(f"[freelb] the trainer's is_freelb pair (plain MCT step, then "
        f"FreeLB) on one batch: launches {counts} = {per_pair}; metrics "
        f"{metrics}")
    return state, {"launches": counts, "metrics": metrics}


def freelb_projection_check(state, gens, batch):
    """One FreeLB MCT step with adv_max_norm = PROJECT_MAX_NORM and
    adv_lr = PROJECT_LR: every delta after every ascent finite and inside
    the ball, and the ball reached (so the projection ran)."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.train import freelb

    adv = freelb_config(adv_max_norm=PROJECT_MAX_NORM, adv_lr=PROJECT_LR)
    step = freelb.make_freelb_pretrain_step(
        state.model, bench.SAMPLE_N, bench.mask_config(state.model.cfg), adv)
    seen = []
    ascend = freelb._ascend

    def recording(*args, **kw):
        out = ascend(*args, **kw)
        seen.append(out.detach())
        return out

    freelb._ascend = recording
    try:
        state, m = step(state, batch, gens)
    finally:
        freelb._ascend = ascend
    norms = [torch.linalg.vector_norm(d.reshape(d.shape[0], -1).double(),
                                      dim=1) for d in seen]
    largest = max(n.max().item() for n in norms)
    finite = all(torch.isfinite(d).all().item() for d in seen)
    log(f"[freelb] projection: {len(seen)} deltas after ascent (K = "
        f"{adv.adv_steps}, text and image), adv_max_norm "
        f"{PROJECT_MAX_NORM}, adv_lr {PROJECT_LR}: finite {finite}, largest "
        f"row norm {largest:.9f}; loss {m['loss'].item():.4f}")
    if len(seen) != 2 * adv.adv_steps or not finite:
        fail(f"FreeLB projection: {len(seen)} deltas, finite {finite}")
    if not PROJECT_MAX_NORM * 0.999 <= largest <= PROJECT_MAX_NORM * (
            1 + 1e-5):
        fail(f"FreeLB projection: largest row norm {largest}, ball "
             f"{PROJECT_MAX_NORM}")
    return state, {"deltas": len(seen), "largest_row_norm": largest}


def timed_steps(what, state, step, batch, gens, per_step):
    """FREELB_SHORT_WARMUP + FREELB_SHORT_STEPS steps of a FreeLB step
    (`bench.run`), the launches counted and checked."""
    import numpy as np

    from m3p_tpu_torch import bench

    # ---- the main path, counted ----
    zero_launch_counts()
    out = bench.run(state, step, batch, gens, FREELB_SHORT_WARMUP,
                    FREELB_SHORT_STEPS)
    counts = launch_counts()
    # ---- checks ----
    n_steps = FREELB_SHORT_WARMUP + FREELB_SHORT_STEPS
    check_launches(what, counts, per_step, n_steps)
    if not np.isfinite(out["losses"]).all():
        fail(f"{what}: non-finite loss {out['losses']}")
    out.update(launches=counts, launches_per_step=per_step,
               loss_first=out["losses"][0], loss_last=out["losses"][-1])
    del out["losses"]
    log(f"[freelb] {what}: {n_steps} steps, {out['step_ms']:.2f} ms a step "
        f"(CUDA events, {FREELB_SHORT_STEPS} steps), "
        f"{out['samples_per_s']:.1f} samples/s, host wall "
        f"{out['wall_step_ms']:.2f} ms, peak memory "
        f"{out['peak_memory_gb']:.2f} GB; launches {counts} = {per_step} x "
        f"{n_steps}; loss {out['loss_first']:.4f} -> {out['loss_last']:.4f}")
    return out


def freelb_itm_and_caption(seed):
    """The FreeLB ITM step over phase 6's batch and the FreeLB caption step
    over phase 10's, each at the flagship width, timed and counted."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.freelb import (
        make_freelb_ic_step, make_freelb_itm_step)
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    out = {}
    k = FREELB["adv_steps"]
    for kind in ("itm", "caption"):
        cfg = train_config() if kind == "itm" else decoder_config()
        model = build_model(cfg, seed, "cuda")
        tx, _ = build_optimizer(OPTIM_SPEC, clip_grad_norm=CLIP)
        state = create_train_state(model, tx)
        gens = Generators.from_seed(seed, "cuda")
        word = model.text_emb.word.weight.detach().clone()
        if kind == "itm":
            step = make_freelb_itm_step(model, SAMPLE_N, freelb_config())
            batch = train_batch(seed, "cuda")
            per_step = times(mct_per_step(cfg), k)
        else:
            step = make_freelb_ic_step(model, freelb_config())
            batch = decoder_batch("caption", seed, "cuda")
            per_step = times(decoder_per_step(cfg, "caption"), k)
        out[kind] = timed_steps(f"FreeLB {kind}", state, step, batch, gens,
                                per_step)
        # the ITM step takes the word embeddings outside the passes: the
        # word table gets no gradient and does not move
        still = torch.equal(model.text_emb.word.weight, word)
        if still != (kind == "itm"):
            fail(f"FreeLB {kind}: the word table moved: {not still}")
        del state, model, step
        torch.cuda.empty_cache()
    return out


def denoising_batches(seed, mask_index, n_words):
    """The batches of the denoising rows, from ``RandomState(seed)``: MASS,
    BART (with --use_noise) and AE over one stream batch of STREAM_B x
    BPTT, IDA over phase 10's caption batch with Poisson region noise, PC
    pairs of two CAPTION_LEN-token sides (half the labels 0: the target of
    another row), each checked against `denoising_shapes`."""
    import numpy as np

    from m3p_tpu_torch.data import loader, synthetic
    from m3p_tpu_torch.data.noise import concat_batches
    from m3p_tpu_torch.data.span_masking import poisson_region_noise

    rng = np.random.RandomState(seed)
    stream = synthetic.make_stream_batch(rng, STREAM_B, BPTT, n_words)
    out = {
        "mass": loader.make_mass_transform(WORD_MASS, mask_index, n_words)(
            rng, dict(stream), 0),
        "bart": loader.make_bart_transform(mask_index, WORD_NOISE)(
            rng, dict(stream), 0),
        "ae": loader.make_ae_transform(*WORD_NOISE, mask_index)(
            rng, dict(stream), 0)}
    cap = synthetic.make_caption_batch(rng, CAPTION_B, CAPTION_LEN, REGIONS,
                                       n_words)
    cap["feats"] = poisson_region_noise(rng, cap["feats"], cap["img_len"])
    out["ida"] = cap
    pairs = synthetic.make_mt_batch(rng, STREAM_B, CAPTION_LEN, n_words)
    labels = (np.arange(STREAM_B) % 2).astype(np.int32)
    other = np.roll(np.arange(STREAM_B), 1)
    tgt = np.where(labels[:, None] > 0, pairs["tgt_tokens"],
                   pairs["tgt_tokens"][other])
    tgt_len = np.where(labels > 0, pairs["tgt_len"], pairs["tgt_len"][other])
    toks, lens, pos, langs = concat_batches(
        pairs["src_tokens"], pairs["src_len"], 0, tgt, tgt_len, 1)
    width = 2 * CAPTION_LEN - 1
    pad = width - toks.shape[1]
    out["pc"] = {"tokens": np.pad(toks, ((0, 0), (0, pad)),
                                  constant_values=1),
                 "lengths": lens,
                 "positions": np.pad(pos, ((0, 0), (0, pad))),
                 "langs": np.pad(langs, ((0, 0), (0, pad))),
                 "labels": labels}
    got = [(STREAM_B,) + out["mass"]["dec_tokens"].shape[1:],
           out["mass"]["enc_tokens"].shape,
           (STREAM_B, out["bart"]["tgt_tokens"].shape[1] - 1),
           out["bart"]["src_tokens"].shape, out["ae"]["src_tokens"].shape,
           out["pc"]["tokens"].shape]
    shapes = denoising_shapes()
    want = [(STREAM_B, shapes[i][j]) for i, j in ((0, 0), (1, 1), (2, 0),
                                                   (3, 1), (4, 0), (5, 0))]
    if [tuple(g) for g in got] != want:
        fail(f"phase 12's batches {got} are not at the shapes phase 2 "
             f"held (`denoising_shapes`: {want})")
    return out


def denoising_steps(seed):
    """One counted step each of MASS, BART, AE, IDA and PC at the flagship
    width (dropout and attention dropout 0.1, phase 10's optimizer), on
    one model."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train import steps
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    cfg = decoder_config()
    model = build_model(cfg, seed, "cuda")
    tx, _ = build_optimizer(OPTIM_SPEC, clip_grad_norm=CLIP)
    state = create_train_state(model, tx)
    gens = Generators.from_seed(seed, "cuda")
    batches = denoising_batches(seed + 4, cfg.mask_index, cfg.n_words)
    L = cfg.n_layers
    rows = {  # loss, batch, launches a step
        "mass": (steps.mass_loss, "mass", expected_launches((3 * L, 6 * L))),
        "bart": (steps.mt_loss, "bart", decoder_per_step(cfg, "mt")),
        "ae": (steps.mt_loss, "ae", decoder_per_step(cfg, "mt")),
        "ida": (steps.caption_loss, "ida", decoder_per_step(cfg,
                                                           "caption")),
        "pc": (steps.pc_loss, "pc", expected_launches((L, 2 * L))),
    }
    out = {}
    for name, (loss, kind, per_step) in rows.items():
        batch = {k: torch.from_numpy(v).to("cuda")
                 for k, v in batches[kind].items()}
        state, out[name] = one_step(name, state,
                                    steps.make_train_step(loss), batch, gens,
                                    per_step)
    del state, model
    torch.cuda.empty_cache()
    return out


def compare_freelb_grads_with_cpu(seed):
    """fp32 parameter gradients after the K passes of the FreeLB MCT step
    at depth 2 and full width, rate 0, on the card (the CUDA-core designs
    of #1/#2) and on the CPU (plain versions): one coin, masking and pair
    of initial deltas fed to both."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.ops.attention import attention_packed
    from m3p_tpu_torch.train.freelb import (
        _init_delta, make_freelb_pretrain_step)
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state
    from m3p_tpu_torch.train.steps import mct_draws

    cfg = float_mct_config(n_layers=2, dtype="float32", rate=0.0)
    adv = freelb_config()
    cpu_model = cpu_model_from_card(cfg, seed)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    # one group: the CPU's K = 3 passes over two were the phase's largest
    # part
    batch = bench.make_batch(seed + 2, "cpu", groups=1)
    mask_cfg = bench.mask_config(cfg)
    draws = mct_draws(torch.Generator().manual_seed(seed), batch, mask_cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    bn, s = batch["tokens"].shape
    deltas = (_init_delta(gen, (bn, s, cfg.emb_dim), batch["text_len"],
                          cfg.emb_dim, adv.adv_init_mag, adv.norm_type),
              _init_delta(gen, batch["feats"].shape, torch.ones(bn),
                          cfg.img_feat_dim, adv.adv_init_mag,
                          adv.norm_type))
    losses = {}
    before = (dict(attention_packed.launches_by_design),
              dict(attention_packed.bwd_launches_by_design))
    for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
        state = create_train_state(model, build_optimizer("adam,lr=0.0")[0])
        step = make_freelb_pretrain_step(model, bench.SAMPLE_N, mask_cfg,
                                         adv)
        moved = {k: ([t.to(dev) for t in v] if isinstance(v, (list, tuple))
                     else v.to(dev)) for k, v in draws.items()}
        _, m = step(state, {k: t.to(dev) for k, t in batch.items()}, None,
                    deltas=tuple(d.to(dev) for d in deltas),
                    deterministic=True, **moved)
        losses[dev] = m["loss"].item()
    # 5 layers a pass, K passes: one forward and two backward launches each
    n = (cfg.n_layers + cfg.refine_layers) * adv.adv_steps
    if (launched_design(attention_packed.launches_by_design, before[0], n),
            launched_design(attention_packed.bwd_launches_by_design,
                            before[1], 2 * n)) != ("cuda_cores",) * 2:
        fail("the fp32 FreeLB check did not take the CUDA-core design")
    worst, worst_name, leaves = worst_grad_diff(gpu_model, cpu_model)
    log(f"[fp32 grads freelb] FreeLB MCT, K = {adv.adv_steps}, depth 2, "
        f"BN={bn}, rate 0: mean loss card {losses['cuda']:.6f} vs CPU "
        f"{losses['cpu']:.6f}; {leaves} leaves, max relative |card - CPU| "
        f"= {worst:.3e} ({worst_name}; tolerance {TOL_GRAD_FP32})")
    if worst > TOL_GRAD_FP32 or abs(losses["cuda"] - losses["cpu"]) > 1e-4:
        fail("fp32 FreeLB gradients on the card disagree with the CPU")
    return worst


def freelb_learning_check(seed, steps=30):
    """Depth 2 at full width, BN = 80, fused dropout, FusedAdam (bf16
    moments, fp32 master) at lr 1e-4, one batch, and every step from
    generators of one seed (the same coin, maskings, initial deltas and
    dropout masks, as the JAX test holds its PRNG key): the mean loss of
    the last 5 steps must be below that of the first 5."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.freelb import make_freelb_pretrain_step

    cfg = float_mct_config(fused_dropout=True, n_layers=2)
    state, _, _ = bench.setup(
        cfg, seed + 3, "cuda", spec="adam,lr=0.0001,fused=1,"
        "mu_dtype=bfloat16,nu_dtype=bfloat16,master=1")
    step = make_freelb_pretrain_step(state.model, bench.SAMPLE_N,
                                     bench.mask_config(cfg), freelb_config())
    batch = bench.make_batch(seed + 3, "cuda")
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, Generators.from_seed(seed + 3, "cuda"))
        losses.append(m["loss"])
    losses = torch.stack(losses).float().cpu()
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    log(f"[learn freelb] depth 2, BN={batch['tokens'].shape[0]}, {steps} "
        f"FreeLB MCT steps (K = {FREELB['adv_steps']}) of FusedAdam lr 1e-4 "
        f"on one batch and one generator seed: mean loss of the first 5 "
        f"steps {first:.4f}, of the last 5 {last:.4f}")
    if not torch.isfinite(losses).all() or not last < first:
        fail(f"the FreeLB MCT model did not learn: {losses.tolist()}")
    return {"first5": first, "last5": last}


def freelb_slice(seed):
    """Phase 12: the FreeLB MCT step in configurations A and B (timed,
    counted, profiled), the trainer's is_freelb pair and the projection
    check on B's model, the FreeLB ITM and caption steps, one step of each
    denoising row; then the fp32 gradient check and the learning check."""
    import torch

    t0 = time.time()
    out = {}
    for label, fused in (("A", False), ("B", True)):
        out[label], state, gens, batch = freelb_mct_slice(seed, fused)
        sublap(f"p12_mct_{label}")
        if fused:
            state, out["pair_B"] = trainer_pair(state, gens, batch)
            state, out["projection"] = freelb_projection_check(state, gens,
                                                               batch)
            sublap("p12_pair_and_projection")
        del state
        torch.cuda.empty_cache()
    out.update(freelb_itm_and_caption(seed))
    sublap("p12_itm_and_caption")
    out["denoising"] = denoising_steps(seed)
    sublap("p12_denoising")
    out["phase_s"] = time.time() - t0
    out["fp32_grad_card_vs_cpu_max_rel"] = compare_freelb_grads_with_cpu(
        seed)
    sublap("p12_vs_cpu")
    return out


# ---------------------------------------------------------------------------
# phase 13: evaluation
# ---------------------------------------------------------------------------

# tools/bench_eval_grid.py's default grid: 100 images of 100 regions, 500
# captions of 8-20 tokens at width 64 (DataConfig.seq_per_img = 5 captions
# an image), chunk 512; Multi30K's test grid (1000 x 5000) cut by 100
EVAL_GRID = (100, 500, 512)
EVAL_SEQ_PER_IMG = 5
# the profile of a few chunks: 6 images x 256 captions, 3 chunks
EVAL_PROFILE_GRID = (6, 256)
# two batches a loss family (the DataConfig sizes of phases 6, 10 and 12);
# the generation evals at EvalConfig's eval_batch_size, two caption
# batches, one of sentences of the 32-token bucket
EVAL_BATCHES = 2
EVAL_GEN_B = 64
EVAL_GEN_CAPTION_BATCHES = 2
EVAL_COCO = "Bleu,METEOR,ROUGE_L,CIDEr"
# fp32 on the card against the CPU at depth EVAL_FP32_LAYERS (1, to leave
# room for phase 18: depth 2 took 33.6 s of phase 13 on an H100 80GB HBM3
# at 700 W): the same families, one batch
# each at B = 2 (2 groups of the retrieval grid), a 4 x 20 grid at chunk
# 32, one image and one sentence a family to decode at max_gen_len 16 (on
# the H100 machine's host CPU the CPU side took 123.8 s at two batches of
# 4 and two rows decoded to 40 tokens: the word head and the stable sort of
# 250,002 logits a row and step)
EVAL_FP32_B, EVAL_FP32_GROUPS, EVAL_FP32_BATCHES = 2, 2, 1
EVAL_FP32_GEN_B, EVAL_FP32_GEN_LEN = 1, 16
EVAL_FP32_GRID = (4, 20, 32)
# and a 32,002-id vocabulary (mask id 32,001), on both sides: the CPU's
# word head over 250,002 ids was most of the check's time; phases 10 and
# 11 hold the full vocabulary's head card vs CPU
EVAL_FP32_WORDS = 32002
EVAL_FP32_LAYERS = 1
# fp32 losses, accuracies and recalls on the card against the CPU, and the
# grid scores: 2 layers of fp32 GEMMs and reductions in another order
TOL_EVAL_FP32 = dict(rtol=1e-4, atol=0.0)
TOL_EVAL_GRID_FP32 = 1e-4
# the families of phase 13's loss evals -> #1 launches a batch (below)
EVAL_LOSS_KEYS = ("caption_batches", "mass_batches", "mlm_batches",
                  "mmt_batches", "mt_batches", "ntg_batches",
                  "retrieval_valid_batches", "slide_batches")


def eval_config(model_cfg, eval_path="", **eval_kw):
    """A TrainConfig for the Evaluator: ``model_cfg``, phase 6's candidate
    grid, EvalConfig's defaults (beam 4, max_gen_len 40, length penalty
    1.0, no early stopping) with all four caption metrics and
    ``eval_path``."""
    from m3p_tpu_torch.config import DataConfig, EvalConfig, TrainConfig

    return TrainConfig(model=model_cfg, data=DataConfig(sample_n=SAMPLE_N),
                       eval=EvalConfig(coco_method=EVAL_COCO,
                                       eval_path=eval_path, **eval_kw))


def eval_loss_data(seed, n_words, mask_index, b=STREAM_B, groups=GROUPS,
                   batches=EVAL_BATCHES):
    """The loss families of phase 13, ``batches`` batches each, from
    ``RandomState(seed)``: retrieval valid as (t2i, i2t) tuples of phase
    6's grid (``groups`` x SAMPLE_N pairs of TEXT_LEN tokens and REGIONS
    regions), captioning (``b`` images, captions of CAPTION_LEN), MT and
    NTG (``b`` pairs of CAPTION_LEN), multimodal MT (MT with images),
    slide, MLM on ``b`` streams of BPTT and MASS over such streams."""
    import numpy as np

    from m3p_tpu_torch.data import loader, synthetic

    rng = np.random.RandomState(seed)
    mass = loader.make_mass_transform(WORD_MASS, mask_index, n_words)

    def n(fn):
        return [fn() for _ in range(batches)]

    def grid():
        return synthetic.make_retrieval_batch(rng, groups, SAMPLE_N,
                                              TEXT_LEN, REGIONS, n_words)

    def mmt():
        batch = synthetic.make_mt_batch(rng, b, CAPTION_LEN, n_words)
        images = synthetic.make_caption_batch(rng, b, CAPTION_LEN, REGIONS,
                                              n_words)
        batch.update({k: images[k] for k in ("feats", "locs", "img_len")})
        return batch

    return {
        "retrieval_valid_batches": n(lambda: (grid(), grid())),
        "caption_batches": n(lambda: synthetic.make_caption_batch(
            rng, b, CAPTION_LEN, REGIONS, n_words)),
        "mt_batches": n(lambda: synthetic.make_mt_batch(
            rng, b, CAPTION_LEN, n_words)),
        "ntg_batches": n(lambda: synthetic.make_mt_batch(
            rng, b, CAPTION_LEN, n_words)),
        "mmt_batches": n(mmt),
        "slide_batches": n(lambda: synthetic.make_slide_batch(
            rng, b, CAPTION_LEN, REGIONS, n_words)),
        "mlm_batches": n(lambda: synthetic.make_stream_batch(
            rng, b, BPTT, n_words)),
        "mass_batches": n(lambda: mass(rng, synthetic.make_stream_batch(
            rng, b, BPTT, n_words), 0)),
    }


def eval_loss_launches(cfg, data):
    """#1 launches of `run_all_evals` over ``data``'s loss families: a
    joint encode (the refiner and the blocks) per retrieval-valid or slide
    batch, the blocks per MLM batch, and for the seq2seq losses the source
    encoder plus the decoder's causal self-attention and cross-attention in
    every block (`decoder_per_step`'s forward counts); MASS encodes and
    decodes as MT."""
    L, R = cfg.n_layers, cfg.refine_layers
    per_batch = {"retrieval_valid_batches": 2 * (R + L),
                 "caption_batches": R + 3 * L, "mt_batches": 3 * L,
                 "ntg_batches": 3 * L, "mmt_batches": R + 3 * L,
                 "slide_batches": R + L, "mlm_batches": L,
                 "mass_batches": 3 * L}
    return sum(per_batch[k] * len(data[k]) for k in data)


def eval_sentences(rng, n, n_words, width=GEN_TEXT_BUCKET):
    """``n`` source sentences of the 32-token bucket: BOS, 20-28 random
    ids, EOS (22-30 tokens), padded to ``width``."""
    import numpy as np

    from m3p_tpu_torch.config import BOS_IDX, EOS_IDX, PAD_IDX

    lens = rng.randint(22, 31, n)
    toks = np.full((n, width), PAD_IDX, np.int64)
    for i, length in enumerate(lens):
        toks[i, 0] = BOS_IDX
        toks[i, 1:length - 1] = rng.randint(4, n_words - 1, length - 2)
        toks[i, length - 1] = EOS_IDX
    return toks, lens.astype(np.int64)


def eval_images(rng, n):
    """``n`` images of 10-100 regions (L2-normalized features, boxes as
    `data.features.norm_boxes` gives them), padded to REGIONS."""
    import numpy as np

    from m3p_tpu_torch.data.features import l2_normalize, norm_boxes

    feats = np.zeros((n, REGIONS, 2048), np.float32)
    locs = np.zeros((n, REGIONS, 5), np.float32)
    lens = rng.randint(10, REGIONS + 1, n)
    for i, r in enumerate(lens):
        img = image(rng, int(r))
        feats[i, :r] = l2_normalize(img["features"])
        locs[i, :r] = norm_boxes(img["boxes"], *img["wh"])
    return {"feats": feats, "locs": locs, "img_len": lens.astype(np.int64)}


def eval_gen_data(seed, tokenizer, n_words, b=EVAL_GEN_B,
                  caption_batches=EVAL_GEN_CAPTION_BATCHES):
    """The generation families: ``caption_batches`` batches of ``b``
    images to caption (image ids for the artifact), ``b`` sentences to
    translate and ``b`` sentences with images for multimodal MT, each
    with 5 (captions) or 1 (translations) references of `WORDS`."""
    import numpy as np

    rng = np.random.RandomState(seed)
    caps = [eval_images(rng, b) for _ in range(caption_batches)]
    n_caps = b * caption_batches
    src, src_len = eval_sentences(rng, b, n_words)
    msrc, msrc_len = eval_sentences(rng, b, n_words)

    def refs(n, k):
        return [[sentence(rng, int(rng.randint(8, 15))) for _ in range(k)]
                for _ in range(n)]

    return {
        "caption_gen": {"batches": caps, "references": refs(n_caps, 5),
                        "tokenizer": tokenizer, "lang_id": 0,
                        "image_ids": [f"img{i}" for i in range(n_caps)]},
        "mt_gen": {"batches": [{"src_tokens": src, "src_len": src_len}],
                   "references": refs(b, 1), "tokenizer": tokenizer,
                   "lang_id": 1, "name": "mt"},
        "mmt_gen": {"batches": [{"src_tokens": msrc, "src_len": msrc_len,
                                 **eval_images(rng, b)}],
                    "references": refs(b, 1), "tokenizer": tokenizer,
                    "lang_id": 1, "name": "mmt"},
    }


def eval_gen_launches(cfg, data, keys):
    """#1 launches of the generation families ``keys``: the source
    encoder of each batch (the refiner and the blocks over the regions for
    a caption, the blocks for a translation, both over the joint sequence
    for multimodal MT), none in the decode steps (`mha_reference` below
    512 cached keys)."""
    L, R = cfg.n_layers, cfg.refine_layers
    per = {"caption_gen": R + L, "mt_gen": L, "mmt_gen": R + L}
    return sum(per[k] * len(data[k]["batches"]) for k in keys)


def eval_shapes():
    """(B, Sq, Sk, causal) of every #1 launch of phase 13's bf16 path: the
    grid's chunks (the refiner over the regions, the blocks over the joint
    sequence at the full 64-token width and at the 16- and 32-token
    buckets), retrieval valid at phase 6's BN, the loss families at
    STREAM_B (image or text encoders, the decoders' causal self-attention
    and cross-attention), and the generation source encoders at
    EVAL_GEN_B.  Phase 2 holds #1 at each; phase 13 fails if it launches #1
    at any other."""
    chunk, r = EVAL_GRID[2], REGIONS
    b, t = STREAM_B, CAPTION_LEN - 1
    span = max(int(round(BPTT * WORD_MASS)), 1)
    shapes = [(chunk, s, s, False) for s in (r, r + TEXT_LEN, r + 16,
                                             r + 32)]
    bn = GROUPS * SAMPLE_N
    shapes += [(bn, r, r, False), (bn, r + TEXT_LEN, r + TEXT_LEN, False)]
    shapes += [(b, r, r, False), (b, r + TEXT_LEN, r + TEXT_LEN, False),
               (b, CAPTION_LEN, CAPTION_LEN, False), (b, t, t, True),
               (b, t, r, False), (b, t, CAPTION_LEN, False),
               (b, t, r + TEXT_LEN, False), (b, BPTT, BPTT, False),
               (b, span, span, True), (b, span, BPTT, False)]
    g = EVAL_GEN_B
    shapes += [(g, r, r, False), (g, GEN_TEXT_BUCKET, GEN_TEXT_BUCKET, False),
               (g, r + GEN_TEXT_BUCKET, r + GEN_TEXT_BUCKET, False)]
    return sorted(set(shapes))


@contextlib.contextmanager
def recorded_launch_shapes(shapes):
    """Within the block, record ("fwd" / "bwd", B, Sq, Sk, causal, dtype,
    dropout on) of every #1 and #2 launch (`ops.attention._launch_fwd`,
    `_launch_bwd`) into ``shapes``; the launches and their counts are
    untouched."""
    from m3p_tpu_torch.ops import attention as ops

    launch_fwd, launch_bwd = ops._launch_fwd, ops._launch_bwd

    def note(kind, q, k, causal, rate):
        shapes.add((kind, q.shape[0], q.shape[1], k.shape[1], bool(causal),
                    str(q.dtype).replace("torch.", ""), rate > 0))

    def fwd(q, k, v, kv_mask, n_heads, causal, scale, rate, *args, **kw):
        note("fwd", q, k, causal, rate)
        return launch_fwd(q, k, v, kv_mask, n_heads, causal, scale, rate,
                          *args, **kw)

    def bwd(q, k, v, kv_mask, do, n_heads, causal, scale, rate, *args,
            **kw):
        note("bwd", q, k, causal, rate)
        return launch_bwd(q, k, v, kv_mask, do, n_heads, causal, scale,
                          rate, *args, **kw)

    ops._launch_fwd, ops._launch_bwd = fwd, bwd
    try:
        yield shapes
    finally:
        ops._launch_fwd, ops._launch_bwd = launch_fwd, launch_bwd


def check_held_shapes(what, recorded):
    """Fail unless phase 2 held each recorded (kernel, shape, dtype,
    dropout) against the plain version."""
    missed = sorted(recorded - HELD_SHAPES)
    if missed:
        fail(f"{what} launched at shapes phase 2 did not hold: {missed}")
    return sorted(recorded)


def eval_grid(model, ev, tmp):
    """The full-grid retrieval test at the tool's shape: the counted pass
    through `Evaluator.run_all_evals` (R@k, the score matrix and
    inference.log in ``tmp``), then bucketed and unbucketed passes in
    turns, each timed and counted; a profile of a few chunks."""
    import numpy as np
    import torch

    from m3p_tpu_torch.bench_eval_grid import grid_flops, grid_pool
    from m3p_tpu_torch.eval.retrieval import (
        _tasks, recall_at_k, retrieval_grid_scores)

    cfg = model.cfg
    n_img, n_cap, chunk = EVAL_GRID
    pool = grid_pool(n_img, n_cap, n_words=cfg.n_words)
    cap_to_img = np.arange(n_cap) // EVAL_SEQ_PER_IMG
    n_chunks = {bucket: len(_tasks(pool[1], n_img, TEXT_LEN, chunk, bucket,
                                   16)) for bucket in (False, True)}
    widths = sorted({w for w, _, _ in _tasks(pool[1], n_img, TEXT_LEN,
                                             chunk, True, 16)})
    flops = {bucket: grid_flops(cfg, pool[1], n_img, chunk, bucket)
             for bucket in (False, True)}

    def grid(bucket):
        return retrieval_grid_scores(model, *pool, chunk_size=chunk,
                                     length_bucket=bucket)

    per_chunk = cfg.n_layers + cfg.refine_layers

    def timed(bucket):
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = grid(bucket)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check_launches(f"eval grid, length_bucket={bucket}", launch_counts(),
                       expected_launches((per_chunk, 0)), n_chunks[bucket])
        return secs, scores

    # ---- the main path, counted ----
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    recall = ev.run_all_evals({"retrieval_test": (
        pool[0], pool[1], cap_to_img, *pool[2:], chunk)})
    torch.cuda.synchronize()
    evaluator_s = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # ---- checks ----
    check_launches("eval grid", counts,
                   expected_launches((per_chunk, 0)), n_chunks[False])
    scores = np.load(os.path.join(tmp, "score_test_rank0.npy"))
    with open(os.path.join(tmp, "inference.log")) as f:
        logged = f.read().split()
    if scores.shape != (n_img, n_cap) or scores.dtype != np.float32 \
            or not np.isfinite(scores).all():
        fail(f"eval grid: scores {scores.shape} {scores.dtype}, finite "
             f"{bool(np.isfinite(scores).all())}")
    if recall != recall_at_k(scores, cap_to_img) or \
            [float(x) for x in logged] != [recall[f"i2t_r{k}"]
                                           for k in (1, 5, 10)]:
        fail(f"eval grid: R@k {recall} against the saved matrix, "
             f"inference.log {logged}")
    # ---- one pass with length buckets, one without ----
    turns = {False: [], True: []}
    bucket_scores = None
    for bucket in (True, False):
        secs, got = timed(bucket)
        turns[bucket].append(secs)
        if bucket:
            bucket_scores = got
    bucket_diff = float(np.abs(bucket_scores - scores).max())
    bucket_recall = recall_at_k(bucket_scores, cap_to_img)
    pairs = n_img * n_cap
    secs = min(turns[False])
    out = {
        "grid": [n_img, n_cap], "chunk": chunk, "chunks": n_chunks[False],
        "pairs": pairs, "launches": counts,
        "evaluator_pass_s": evaluator_s,
        "pairs_per_s": pairs / secs, "pairs_per_s_turns":
            [pairs / s for s in turns[False]],
        "ms_per_chunk": secs * 1e3 / n_chunks[False],
        "flops": flops[False], "gflop_per_pair": flops[False] / pairs / 1e9,
        "mfu_vs_bf16_peak": flops[False] / secs / BF16_FLOPS_PER_S,
        "peak_memory_gb": peak_gb, "recall": recall,
        "bucketed": {"widths": widths, "chunks": n_chunks[True],
                     "pairs_per_s": pairs / min(turns[True]),
                     "pairs_per_s_turns": [pairs / s for s in turns[True]],
                     "mfu_vs_bf16_peak": flops[True] / min(turns[True])
                     / BF16_FLOPS_PER_S,
                     "max_abs_diff_vs_unbucketed": bucket_diff,
                     "recall": bucket_recall,
                     "recall_changed": bucket_recall != recall}}
    p_img, p_cap = EVAL_PROFILE_GRID
    small = (pool[0][:p_cap], pool[1][:p_cap], pool[2][:p_img],
             pool[3][:p_img], pool[4][:p_img])
    out["profile"] = profile_window(
        f"eval grid {p_img} x {p_cap}, chunk {chunk}",
        lambda: retrieval_grid_scores(model, *small, chunk_size=chunk),
        reps=1)
    log(f"[eval grid] {n_img} x {n_cap} at chunk {chunk}: "
        f"{json.dumps({k: v for k, v in out.items() if k != 'profile'})}")
    return out


def eval_losses(ev, data, cfg):
    """`run_all_evals` over the loss families, counted; again, bitwise the
    same dict; each family alone, timed."""
    import numpy as np
    import torch

    # ---- the main path, counted ----
    zero_launch_counts()
    t0 = time.perf_counter()
    scores = ev.run_all_evals(data)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = launch_counts()
    # ---- checks ----
    check_launches("eval losses", counts,
                   expected_launches((eval_loss_launches(cfg, data), 0)), 1)
    want = {"T2I_acc", "I2T_acc", "retrieval_acc", "ic_ppl", "ic_acc",
            "mt_ppl", "mt_acc", "ntg_ppl", "ntg_acc", "mmt_ppl", "mmt_acc",
            "slide_acc", "mlm_ppl", "mlm_loss", "mass_ppl"}
    if set(scores) != want or not all(np.isfinite(v)
                                      for v in scores.values()):
        fail(f"eval losses: keys {sorted(scores)} (expected "
             f"{sorted(want)}), values {scores}")
    again = ev.run_all_evals(data)
    if again != scores:
        fail(f"eval losses: a second run_all_evals differs: {scores} then "
             f"{again}")
    family_s = {}
    for key in sorted(data):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev.run_all_evals({key: data[key]})
        family_s[key] = time.perf_counter() - t1
    out = {"scores": scores, "repeat_bitwise_equal": True,
           "launches": counts, "run_all_evals_s": total_s,
           "family_s": family_s}
    log(f"[eval losses] {json.dumps(out)}")
    return out


def eval_generation(ev, ev_greedy, data, cfg, tmp):
    """The generation families through `run_all_evals` at beam 4 (counted;
    the caption artifact checked), MT and multimodal MT again greedy
    (counted); images/s and sentences/s; the four caption metrics' host
    seconds on the decoded captions."""
    import numpy as np
    import torch

    from m3p_tpu_torch.eval.bleu import corpus_bleu
    from m3p_tpu_torch.eval.caption_metrics import meteor_score, rouge_l_score
    from m3p_tpu_torch.eval.cider import cider_score

    out = {"family_s": {}}
    scores = {}
    for name, evaluator, keys in (
            ("beam", ev, ("caption_gen", "mt_gen", "mmt_gen")),
            ("greedy", ev_greedy, ("mt_gen", "mmt_gen"))):
        # ---- the main path, counted ----
        zero_launch_counts()
        for key in keys:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = evaluator.run_all_evals({key: data[key]})
            out["family_s"][f"{key}_{name}"] = time.perf_counter() - t0
            scores.update({f"{k}_{name}": v for k, v in got.items()})
        counts = launch_counts()
        # ---- checks ----
        check_launches(f"eval generation ({name})", counts, expected_launches(
            (eval_gen_launches(cfg, data, keys), 0)), 1)
        out[f"launches_{name}"] = counts
    if not all(np.isfinite(v) for v in scores.values()) or len(scores) != 8:
        fail(f"eval generation: scores {scores}")
    artifact = os.path.join(tmp, "caption_translate.xx.json")
    with open(artifact) as f:
        captions = json.load(f)
    ids = data["caption_gen"]["image_ids"]
    if [c["image_id"] for c in captions] != ids or not all(
            isinstance(c["caption"], str) for c in captions):
        fail(f"eval generation: {artifact} holds {captions[:2]}...")
    hyps = [c["caption"] for c in captions]
    refs = data["caption_gen"]["references"]
    metric_s = {}
    for metric, fn in (("bleu", corpus_bleu), ("cider", cider_score),
                       ("meteor", meteor_score), ("rouge_l", rouge_l_score)):
        t0 = time.perf_counter()
        value = fn(hyps, refs)
        metric_s[metric] = time.perf_counter() - t0
        if value != scores[f"caption_{metric}_beam"]:
            fail(f"eval generation: {metric} of the artifact's captions "
                 f"{value} != {scores[f'caption_{metric}_beam']}")
    n_caps = len(ids)
    n_src = len(data["mt_gen"]["references"])
    fs = out["family_s"]
    out.update(scores=scores, metric_host_s=metric_s,
               caption_images_per_s=n_caps / fs["caption_gen_beam"],
               mt_sentences_per_s={n: n_src / fs[f"mt_gen_{n}"]
                                   for n in ("beam", "greedy")},
               mmt_sentences_per_s={n: n_src / fs[f"mmt_gen_{n}"]
                                    for n in ("beam", "greedy")},
               artifacts=sorted(os.listdir(tmp)),
               mean_caption_words=float(np.mean([len(h.split())
                                                 for h in hyps])))
    log(f"[eval generation] {json.dumps(out)}")
    return out


def eval_slice(seed, tokenizer):
    """Phase 13: the evaluation layer at the flagship width, bf16, random
    weights from ``seed``: the full-grid retrieval test, the loss families
    through `run_all_evals` (and the bitwise repeat), the generation
    families at beam 4 and greedy, every #1 launch at a shape phase 2
    held."""
    import torch

    from m3p_tpu_torch.eval.evaluator import Evaluator
    from m3p_tpu_torch.model import build_model

    t0 = time.time()
    cfg = full_width_config("bfloat16")
    model = build_model(cfg, seed, "cuda")
    shapes = set()
    out = {}
    part_s = {}
    with tempfile.TemporaryDirectory() as tmp, \
            recorded_launch_shapes(shapes):
        ev = Evaluator(model, eval_config(cfg, tmp))
        out["grid"] = eval_grid(model, ev, tmp)
        torch.cuda.empty_cache()
        part_s["grid"] = time.time() - t0
        loss_data = eval_loss_data(seed + 13, cfg.n_words, cfg.mask_index)
        out["losses"] = eval_losses(ev, loss_data, cfg)
        part_s["losses"] = time.time() - t0 - sum(part_s.values())
        gen_data = eval_gen_data(seed + 14, tokenizer, cfg.n_words)
        greedy = Evaluator(model, eval_config(cfg, tmp, beam_size=1))
        out["generation"] = eval_generation(ev, greedy, gen_data, cfg, tmp)
        part_s["generation"] = time.time() - t0 - sum(part_s.values())
        if sorted(os.listdir(tmp)) != ["caption_translate.xx.json",
                                       "inference.log",
                                       "score_test_rank0.npy"]:
            fail(f"eval artifacts: {sorted(os.listdir(tmp))}")
    out["shapes"] = check_held_shapes("phase 13", shapes)
    out["main_path_s"] = time.time() - t0
    del model, ev, greedy
    torch.cuda.empty_cache()
    out["fp32_card_vs_cpu"] = compare_eval_with_cpu(seed)
    part_s["fp32_card_vs_cpu"] = out["fp32_card_vs_cpu"]["check_s"]
    out["part_s"] = part_s
    out["phase_s"] = time.time() - t0
    log(f"[eval] phase 13 in {out['phase_s']:.1f} s: {json.dumps(part_s)}")
    return out


def eval_source(ev, batch):
    """The source encoding and mask of a generation batch, as the
    Evaluator's `generate_captions` / `generate_translations` make them."""
    import torch

    from m3p_tpu_torch.model.transformer import lengths_to_mask

    b, model = ev._batch(batch), ev.model
    if "src_tokens" not in b:
        mask = lengths_to_mask(b["img_len"], b["feats"].shape[1])
        return model.encode_image(b["feats"], b["locs"], mask, True), mask
    mask = lengths_to_mask(b["src_len"], b["src_tokens"].shape[1])
    if "feats" not in b:
        return model.encode_text(b["src_tokens"], mask), mask
    img = lengths_to_mask(b["img_len"], b["feats"].shape[1])
    enc = model.encode_joint(b["src_tokens"], mask, b["feats"], b["locs"],
                             img, True)
    return enc, torch.cat([img, mask], 1)


def tie_margins(cpu_ev, batch, lang_id, row, toks):
    """The smallest top-2 logit margin (fp32, on the CPU) along the token
    sequence ``toks`` of ``row``, teacher-forced through the cached
    decoder: where a card and a CPU hypothesis part, the margin that
    decided it."""
    import torch

    from m3p_tpu_torch.model.generation import _decode_step

    model = cpu_ev.model
    with torch.inference_mode():
        enc, mask = eval_source(cpu_ev, batch)
        enc, mask = enc[row:row + 1], mask[row:row + 1]
        toks = torch.as_tensor(toks)[None, :]
        cache = model.init_decode_cache(enc, toks.shape[1])
        margins = []
        for t in range(toks.shape[1] - 1):
            pos = torch.full((1, 1), t)
            langs = None if lang_id is None else torch.full((1, 1), lang_id)
            logits = _decode_step(model, toks[:, t:t + 1], pos, langs, enc,
                                  mask, cache)
            top = torch.topk(logits[0], 2).values
            margins.append(float(top[0] - top[1]))
    return min(margins) if margins else None


def flip_margins(evs, gen, key, beam, rows):
    """For each flipped row of generation family ``key``: the card's and
    the CPU's token sequences and the smallest top-2 margin along each."""
    import torch

    fam = key.rsplit("_", 1)[0]
    batch, lang_id = gen[fam]["batches"][0], gen[fam]["lang_id"]
    toks = {}
    for dev, ev in evs.items():
        with torch.inference_mode():
            enc, mask = eval_source(ev, batch)
            toks[dev], lens = ev._decode(ev.model, enc, mask, beam,
                                         ev.cfg.eval.max_gen_len, lang_id)
            toks[dev] = [t[:n].tolist() for t, n in zip(toks[dev], lens)]
    return [{"row": row, **{f"{dev}_tokens": toks[dev][row] for dev in toks},
             **{f"{dev}_path_min_top2_margin": tie_margins(
                 evs["cpu"], batch, lang_id, row, toks[dev][row])
                for dev in toks}} for row in rows]


@contextlib.contextmanager
def cpu_drawn_masking():
    """Within the block, `train.steps.mlm_loss` masks its tokens with draws
    from a fresh CPU generator of the eval seed, moved to the tokens'
    device: the card and the CPU then score the same masks (a CUDA
    generator draws other numbers than a CPU one of the same seed)."""
    import torch

    from m3p_tpu_torch.eval.evaluator import EVAL_SEED
    from m3p_tpu_torch.train import steps

    draw = steps.mask_tokens

    def drawn(generator, tokens, valid_mask, cfg, mask_scores=None):
        cpu = torch.Generator().manual_seed(EVAL_SEED)
        out = draw(cpu, tokens.cpu(), valid_mask.cpu(), cfg,
                   None if mask_scores is None else mask_scores.cpu())
        return [t.to(tokens.device) for t in out]

    steps.mask_tokens = drawn
    try:
        yield
    finally:
        steps.mask_tokens = draw


def compare_eval_with_cpu(seed):
    """fp32 at depth EVAL_FP32_LAYERS and EVAL_FP32_WORDS words (a tokenizer of as many
    ids), the same families on the card and on the CPU:
    `run_all_evals` over the loss families (MLM's masks drawn on the CPU
    for both, `cpu_drawn_masking`) and a small grid within TOL_EVAL_FP32
    (R@k equal), the grid's scores within
    TOL_EVAL_GRID_FP32, and the beam and greedy hypotheses of the
    generation families equal string for string (a mismatch is shown with
    both token sequences and the smallest top-2 logit margin along each,
    and fails)."""
    import numpy as np

    from m3p_tpu_torch.bench_eval_grid import grid_pool
    from m3p_tpu_torch.eval import evaluator as E
    from m3p_tpu_torch.model import build_model

    t0 = time.time()
    cfg = dataclasses.replace(full_width_config("float32"), n_layers=EVAL_FP32_LAYERS,
                              n_words=EVAL_FP32_WORDS,
                              mask_index=EVAL_FP32_WORDS - 1)
    tokenizer = full_vocab_tokenizer(EVAL_FP32_WORDS)
    # drawn on the card, where the initialisation is fast; the CPU gets a
    # copy of the same weights
    gpu_model = build_model(cfg, seed, "cuda")
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    losses = eval_loss_data(seed + 15, cfg.n_words, cfg.mask_index,
                            b=EVAL_FP32_B, groups=EVAL_FP32_GROUPS,
                            batches=EVAL_FP32_BATCHES)
    gen = eval_gen_data(seed + 16, tokenizer, cfg.n_words,
                        b=EVAL_FP32_GEN_B, caption_batches=1)
    n_img, n_cap, chunk = EVAL_FP32_GRID
    pool = grid_pool(n_img, n_cap, n_words=cfg.n_words)
    test = (pool[0], pool[1], np.arange(n_cap) // EVAL_SEQ_PER_IMG,
            *pool[2:], chunk)
    got, evs, secs = {}, {}, {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        t1 = time.time()
        ev = evs[dev] = E.Evaluator(model, eval_config(
            cfg, max_gen_len=EVAL_FP32_GEN_LEN))
        greedy = E.Evaluator(model, eval_config(
            cfg, beam_size=1, max_gen_len=EVAL_FP32_GEN_LEN))
        # the grid's scores as the retrieval test computed them (one pass
        # of the grid, not two)
        seen = []
        with cpu_drawn_masking(), patched(E, "recall_at_k", lambda recall: (
                lambda scores, c2i: seen.append(np.asarray(scores))
                or recall(scores, c2i))):
            scores = ev.run_all_evals({**losses, "retrieval_test": test})
        grid = seen[0]
        hyps = {}
        for name, e in (("beam", ev), ("greedy", greedy)):
            hyps[f"caption_gen_{name}"] = e.generate_captions(
                gen["caption_gen"]["batches"], tokenizer, 0)
            for key in ("mt_gen", "mmt_gen"):
                hyps[f"{key}_{name}"] = e.generate_translations(
                    gen[key]["batches"], tokenizer, 1)
        got[dev] = (scores, grid, hyps)
        secs[dev] = time.time() - t1
    (gs, gg, gh), (cs, cg, ch) = got["cuda"], got["cpu"]
    rel = {k: abs(gs[k] - cs[k]) / max(abs(cs[k]), 1e-30)
           for k in cs if k in gs}
    grid_diff = float(np.abs(gg - cg).max())
    flips = {k: [i for i, (a, b) in enumerate(zip(gh[k], ch[k])) if a != b]
             for k in ch}
    flips = {k: rows for k, rows in flips.items() if rows}
    out = {"max_rel_diff": max(rel.values()), "rel_diff": rel,
           "grid_max_abs_diff": grid_diff,
           "hypotheses_equal": gh == ch and not flips,
           "hypotheses": sum(len(v) for v in ch.values()),
           "scores_card": gs, "scores_cpu": cs, "secs": secs}
    if flips:
        out["flips"] = {k: flip_margins(evs, gen, k, 1 if k.endswith(
            "greedy") else evs["cpu"].cfg.eval.beam_size, rows)
            for k, rows in flips.items()}
    log(f"[fp32 eval] depth {EVAL_FP32_LAYERS}, card vs CPU: "
        f"{json.dumps(out)} (tolerance "
        f"{TOL_EVAL_FP32}, grid {TOL_EVAL_GRID_FP32})")
    if set(gs) != set(cs) or any(not np.isclose(gs[k], cs[k],
                                                **TOL_EVAL_FP32)
                                 for k in cs):
        fail("fp32 eval scores on the card disagree with the CPU")
    if grid_diff > TOL_EVAL_GRID_FP32:
        fail("fp32 eval grid on the card disagrees with the CPU")
    if not out["hypotheses_equal"]:
        fail("fp32 generated hypotheses on the card differ from the CPU's "
             "(tokens and margins above)")
    out["check_s"] = time.time() - t0
    return out


# ---------------------------------------------------------------------------
# phase 14: the trainer
# ---------------------------------------------------------------------------

# the reference MSCOCO fine-tune recipe (tests/test_cli.py:489-518) without
# its paths; captioning beside retrieval (--cross_modal_steps, the
# recipe's cross_ic_steps), one validation metric with early stopping on
# it, and each epoch cut to TRAINER_STEPS trainer steps
TRAINER_STEPS = 16
TRAINER_B = 24
TRAINER_ARGV = [
    "--exp_name", "phase14", "--batch_size", str(TRAINER_B),
    "--emb_dim", "768",
    "--n_layers", "12", "--n_heads", "12", "--n_dec_layers", "-1",
    "--dropout", "0.1", "--attention_dropout", "0.1",
    "--gelu_activation", "True", "--optimizer", OPTIM_SPEC,
    "--lgs", "en-de-fr", "--cross_rel_steps", "coco-img",
    "--cross_modal_steps", "coco-img", "--mlm_steps", "",
    "--epoch_size", str(TRAINER_B * TRAINER_STEPS), "--max_epoch", "2",
    "--bptt", "128", "--max_len", "64", "--fp16", "True",
    "--validation_metrics", "valid_I2T_acc",
    "--stopping_criterion", "valid_I2T_acc,5",
    "--max_region_num", "100", "--accumulate_gradients", "4",
    "--amp", "1", "--refine_image", "False", "--refine_encoder", "False",
    "--save_every_epoch", "5", "--is_generation", "False",
    "--is_understanding", "True", "--is_pretrain", "False",
    "--use_new_fea", "True", "--t2i_flag", "True", "--i2t_flag", "True",
    "--eval_n", "50", "--sent_ratio", "0.8", "--word_ratio", "0.8",
    "--seq_per_img", "5", "--eval_images", "-1", "--sample_n", "4",
    "--multi_cls_loss_weight", "0", "--bin_cls_loss_weight", "1",
    "--num_workers", "4", "--ft_lgs", "en", "--src_lgs", "en",
    "--ag_lgs", "", "--eval_only", "False", "--is_freelb", "False",
]
TRAINER_K = 4
# the recipe run: one epoch (`TRAINER_ARGV` says 2 of TRAINER_STEPS, as the
# recipe does: a second epoch repeats the first and its 5.4 GB checkpoint)
# of 20 steps, where the trainer writes its first stats line
TRAINER_EPOCHS, TRAINER_RECIPE_STEPS = 1, 20
# the eval grid of the recipe run: 10 images x 50 captions, one chunk
TRAINER_GRID = (10, 50)
# the checkpoints of the recipe run (the state 5.4 GB: fp32 parameters,
# Adam's two moments, the accumulation buffer), a temporary sibling while
# one is written, the old one until the new one is in, and the .pth
TRAINER_DISK_GB = 24
# fp32 at depth 2, card against CPU: the recipe with accumulation 2, weight
# decay and Adam's eps at 1e-3, which keeps an update smooth in a gradient
# that is zero up to rounding (the key biases': the softmax ignores a
# per-row shift), 2 groups x 4 candidates and 2 captions a batch
TRAINER_FP32_SPEC = ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.001,"
                     "warmup_updates=2,eps=0.001,weight_decay=0.01")
TRAINER_FP32_GROUPS, TRAINER_FP32_B = 2, 2
# and a 32,002-word vocabulary (mask id 32,001): the CPU's Adam over the
# 250,002 x 768 word table was most of the check's time; the word head at
# the full vocabulary is held card vs CPU by phases 10 and 13
TRAINER_FP32_WORDS = 32002
# the parameters' change after 4 micro-steps (2 updates), card against CPU,
# per leaf relative to the leaf's largest change; a leaf whose largest
# change is under 1e-3 of the model's largest (the key biases) relative to
# the model's largest: fp32 GEMMs and reductions in another order through
# 2 blocks, the word head and Adam
TOL_TRAINER_FP32 = 1e-3
# the micro-steps after the resume (rel, ic, rel, ic, ic, ic)
RESUME_STEPS = ("rel", "ic", "rel", "ic", "ic", "ic")
# the fp32 check's 4 micro-steps: two windows of 2 that mix the kinds
FP32_STEPS = ("ic", "rel", "ic")
FP32_UPDATES = 2


class CycledBatches:
    """An in-memory dataset: ``epoch_iterator`` yields its ready-made
    batches in turn, ``repeat`` times, whatever the epoch (numpy makes one
    96-row batch's 79 MB of features slower than a step runs)."""

    def __init__(self, batches, repeat=8):
        self.batches = batches
        self.repeat = repeat

    def epoch_iterator(self, batch_size, epoch=0):
        for _ in range(self.repeat):
            yield from self.batches


def trainer_shapes():
    """(B, Sq, Sk, causal) of phase 14's attention: "bwd" those of its
    steps (#1 and #2), "fwd" those and its evals' (#1 only).  The ITM
    micro-step's blocks over the joint sequence at BN = TRAINER_B x
    SAMPLE_N (no refiner: refine_image False); the caption micro-step at
    TRAINER_B images (the encoder over the regions, the decoder's causal
    self-attention and its cross-attention); valid_I2T_acc's pair at the
    same BN, refined (the Evaluator's ITM loss refines), the grid's one
    chunk and the caption loss's own shapes.  Phase 2 holds both kernels at
    each; phase 14 fails if it launches one at any other."""
    bn, r, t = TRAINER_B * SAMPLE_N, REGIONS, CAPTION_LEN - 1
    joint = REGIONS + TEXT_LEN
    steps = [(bn, joint, joint, False), (TRAINER_B, r, r, False),
             (TRAINER_B, t, t, True), (TRAINER_B, t, r, False)]
    evals = [(bn, r, r, False), (EVAL_GRID[2], joint, joint, False)]
    return {"bwd": sorted(set(steps)), "fwd": sorted(set(steps + evals))}


def trainer_data(seed, groups=TRAINER_B, caption_b=TRAINER_B,
                 n_words=250002):
    """LoadedData for the recipe: two (t2i, i2t) pairs of ``groups`` x
    SAMPLE_N candidates (TEXT_LEN tokens, REGIONS regions) and two caption
    batches of ``caption_b`` images, token ids below ``n_words``; eval
    data: one pair for valid_I2T_acc, a TRAINER_GRID retrieval grid, one
    caption batch."""
    import numpy as np

    from m3p_tpu_torch.bench_eval_grid import grid_pool
    from m3p_tpu_torch.data import synthetic
    from m3p_tpu_torch.data.loader import LoadedData

    rng = np.random.RandomState(seed)

    def pair():
        return tuple(synthetic.make_retrieval_batch(
            rng, groups, SAMPLE_N, TEXT_LEN, REGIONS, n_words)
            for _ in range(2))

    def caption():
        return synthetic.make_caption_batch(rng, caption_b, CAPTION_LEN,
                                            REGIONS, n_words)

    n_img, n_cap = TRAINER_GRID
    tok, lens, feats, locs, img_len = grid_pool(n_img, n_cap)
    cap_to_img = np.arange(n_cap) // (n_cap // n_img)
    return LoadedData(
        train_datasets={("rel", "coco"): CycledBatches([pair(), pair()]),
                        ("ic", "coco"): CycledBatches([caption(),
                                                       caption()])},
        eval_data={"retrieval_valid_batches": [pair()],
                   "retrieval_test": (tok, lens, cap_to_img, feats, locs,
                                      img_len),
                   "caption_batches": [caption()]})


@contextlib.contextmanager
def patched(obj, name, make):
    """``obj.name`` replaced by ``make(original)`` inside the block."""
    original = getattr(obj, name)
    setattr(obj, name, make(original))
    try:
        yield original
    finally:
        setattr(obj, name, original)


def tensor_tree(tree, prefix=""):
    """(path, leaf) of a state: tensors and counters of nested dicts and
    lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tensor_tree(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tensor_tree(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def state_copy(state):
    """A copy of a train state's tensors (model, optimizer) and step."""
    import torch

    def copy_leaf(v):
        return v.detach().clone() if isinstance(v, torch.Tensor) else v

    return {"step": state.step,
            "model": {k: v.detach().clone()
                      for k, v in state.model.state_dict().items()},
            "opt": [(p, copy_leaf(v)) for p, v in
                    tensor_tree(state.opt_state)]}


def bitwise_equal(state, saved):
    """Paths where ``state`` differs from `state_copy` ``saved`` (dtype or
    a bit), and the number of tensors compared."""
    import torch

    now = state_copy(state)
    bad, n = [], 0
    if now["step"] != saved["step"]:
        bad.append(f"step {now['step']} != {saved['step']}")
    pairs = [(f"model.{k}", v, saved["model"].get(k))
             for k, v in now["model"].items()]
    if [p for p, _ in now["opt"]] != [p for p, _ in saved["opt"]]:
        bad.append("optimizer state layout")
    pairs += [(f"opt{p}", v, w) for (p, v), (_, w) in
              zip(now["opt"], saved["opt"])]
    for path, v, w in pairs:
        if isinstance(v, torch.Tensor):
            n += 1
            if not (isinstance(w, torch.Tensor) and v.dtype == w.dtype
                    and torch.equal(v, w)):
                bad.append(path)
        elif v != w:
            bad.append(path)
    return bad, n


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def trainer_launches(cfg, kind):
    """#1/#2 launches of one trainer step: a (t2i, i2t) pair of ITM
    micro-steps (the refiner's layers when refine_image, the blocks) or a
    caption micro-step (the refiner, the encoder, the decoder's causal
    self-attention and cross-attention), all on the tensor cores."""
    m = cfg.model
    refine = m.refine_layers if cfg.refine_image else 0
    fwd = 2 * (refine + m.n_layers) if kind == "rel" else \
        refine + 3 * m.n_layers
    return expected_launches((fwd, 2 * fwd))


def trainer_recipe(seed, data, tmp):
    """(a) The recipe through `train_x.main(argv, data=...)` at the
    flagship width: counted, each step's launches checked, one update per
    TRAINER_K micro-steps, the logged lr, the reload's kept language
    table, the epochs, evals and checkpoints timed, the final checkpoint
    restored bit for bit; then the trainer's steps in turns with the bare
    steps (`trainer_in_turns`)."""
    import re

    import torch

    from m3p_tpu_torch import checkpoint as ckpt
    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.eval.evaluator import Evaluator
    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.train import trainer as trainer_mod
    from m3p_tpu_torch.train.state import TrainState

    dump_root = os.path.join(tmp, "dump")
    argv = TRAINER_ARGV + [
        "--dump_path", dump_root, "--exp_id", "a",
        "--max_epoch", str(TRAINER_EPOCHS),
        "--epoch_size", str(TRAINER_B * TRAINER_RECIPE_STEPS)]
    cfg = train_x.args_to_config(train_x.get_parser().parse_args(argv))
    # the pre-trained .pth: another random model at one language more
    t0 = time.time()
    ref_cfg = dataclasses.replace(cfg.model, n_langs=cfg.model.n_langs + 1)
    ref = build_model(ref_cfg, seed + 1, "cuda")
    pth = os.path.join(tmp, "pretrained.pth")
    ckpt.save_reference_checkpoint(pth, ref, ref_cfg.n_layers,
                                   ref_cfg.refine_layers)
    ref_q = ref.state_dict()["block_0.attn.q_lin.weight"].clone()
    del ref
    init_lang = build_model(cfg.model, cfg.seed, "cuda").state_dict()[
        "text_emb.lang.weight"].clone()
    pth_s = time.time() - t0
    watched = ("block_0.attn.q_lin.weight",
               f"block_{cfg.model.n_layers - 1}.ffn.lin2.weight",
               "text_emb.ln_emb.weight")
    rec = {"steps": [], "micro": [], "epochs": [], "evals": [],
           "saves": []}

    def on_init(orig):
        def init(self, *a, **kw):
            orig(self, *a, **kw)
            p = dict(self.model.named_parameters())
            rec["initial"] = [p[n].detach().clone() for n in watched]
            rec["lang"] = p["text_emb.lang.weight"].detach().clone()
            rec["q"] = p["block_0.attn.q_lin.weight"].detach().clone()
        return init

    def on_step(orig):
        def step_once(self, kind, task):
            before = launch_counts()
            t = time.perf_counter()
            orig(self, kind, task)
            host_ms = (time.perf_counter() - t) * 1e3
            after = launch_counts()
            rec["steps"].append((kind, {k: after[k] - before[k]
                                        for k in after}, host_ms))
        return step_once

    def on_apply(orig):
        def apply(self):
            out = orig(self)
            if len(rec["micro"]) < 2 * TRAINER_K:
                p = dict(self.model.named_parameters())
                rec["micro"].append((self.step,
                                     self.opt_state["mini_step"],
                                     [p[n].detach().clone()
                                      for n in watched]))
            return out
        return apply

    def timed(key, orig):
        def run(*a, **kw):
            torch.cuda.synchronize()
            n0, t = len(rec["steps"]), time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            rec[key].append((time.perf_counter() - t, rec["steps"][n0:]))
            return out
        return run

    def on_save(orig):
        def save(path, state, extra=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            orig(path, state, extra)
            rec["saves"].append({"name": os.path.basename(path),
                                 "s": time.perf_counter() - t,
                                 "bytes": dir_bytes(path)})
        return save

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(trainer_mod.Trainer, "__init__",
                                    on_init))
        stack.enter_context(patched(trainer_mod.Trainer, "step_once",
                                    on_step))
        stack.enter_context(patched(TrainState, "apply_gradients",
                                    on_apply))
        stack.enter_context(patched(trainer_mod.Trainer, "train_epoch",
                                    lambda o: timed("epochs", o)))
        stack.enter_context(patched(Evaluator, "run_all_evals",
                                    lambda o: timed("evals", o)))
        stack.enter_context(patched(ckpt, "save_checkpoint", on_save))
        shapes = stack.enter_context(recorded_launch_shapes(set()))
        # ---- the main path, counted ----
        zero_launch_counts()
        t0 = time.time()
        trainer = train_x.main(argv + ["--reload_model", pth], data=data)
        torch.cuda.synchronize()
        main_s = time.time() - t0
        counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    dump = trainer.cfg.dump_path
    listing = sorted(os.listdir(dump))
    # ---- checks ----
    shapes = check_held_shapes("phase 14's train_x.main", shapes)
    for kind, got, _ in rec["steps"]:
        if got != trainer_launches(trainer.cfg, kind):
            fail(f"trainer: a {kind} step launched {got}; expected "
                 f"{trainer_launches(trainer.cfg, kind)}")
    if len(rec["epochs"]) != TRAINER_EPOCHS or \
            trainer.epoch != TRAINER_EPOCHS:
        fail(f"trainer: {len(rec['epochs'])} epochs ran, epoch "
             f"{trainer.epoch}; expected {TRAINER_EPOCHS}")
    start = rec["initial"]
    for i, (step, mini, params) in enumerate(rec["micro"]):
        emitted = (i + 1) % TRAINER_K == 0
        if step != (i + 1) // TRAINER_K or mini != (i + 1) % TRAINER_K:
            fail(f"trainer: after micro-step {i + 1} step {step}, mini-step "
                 f"{mini}; expected {(i + 1) // TRAINER_K}, "
                 f"{(i + 1) % TRAINER_K}")
        same = all(torch.equal(a, b) for a, b in zip(params, start))
        if emitted == same:
            fail(f"trainer: micro-step {i + 1} "
                 f"{'left the parameters unmoved' if same else 'moved them'}"
                 f" (an update every {TRAINER_K} micro-steps)")
        if emitted:
            start = params
    if not torch.equal(rec["lang"], init_lang):
        fail("trainer: the reload changed the language table, whose shape "
             "the .pth does not share")
    if not torch.equal(rec["q"], ref_q):
        fail("trainer: the reload did not load block_0.attn.q_lin.weight")
    with open(os.path.join(dump, "train.log")) as f:
        log_text = f.read()
    lr_lines = re.findall(r"iter (\d+) - (.*) - [\d.]+ sent/s - \d+ words/s"
                          r" - lr ([0-9.e+-]+)", log_text)
    if not lr_lines:
        fail("trainer: no stats line in train.log")
    for n, stats, lr in lr_lines:
        want = f"{trainer.lr_schedule(int(n) // TRAINER_K):.3e}"
        if lr != want:
            fail(f"trainer: iter {n} logged lr {lr}; the schedule at update "
                 f"{int(n) // TRAINER_K} is {want}")
        values = [float(v) for v in re.findall(r": *([-+0-9.naife]+)",
                                                stats)]
        if not values or not all(v == v and abs(v) < 1e30 for v in values):
            fail(f"trainer: stats {stats!r}")
    if not {"checkpoint", "best-I2T_acc", "params.json",
            "train.log"} <= set(listing):
        fail(f"trainer: dump directory {listing}")
    # the final checkpoint is the live state: restore it in place, timed
    saved = state_copy(trainer.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(os.path.join(dump, "checkpoint"), trainer.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    bad, n_tensors = bitwise_equal(trainer.state, saved)
    if bad:
        fail(f"trainer: restore differs at {bad[:5]}")
    del saved
    turns = trainer_in_turns(trainer, data)
    epoch_s, steps = rec["epochs"][-1]
    micro = sum(2 if kind == "rel" else 1 for kind, _, _ in steps)
    rows = sum(2 * TRAINER_B * SAMPLE_N if kind == "rel" else TRAINER_B
               for kind, _, _ in steps)
    # the host's time a step, launch to launch (the step is host-paced:
    # nothing waits for the card inside an epoch but the stats line)
    host_ms = {k: sorted(ms for kind, _, ms in steps if kind == k)
               for k in ("rel", "ic")}
    host_ms = {k: v[len(v) // 2] for k, v in host_ms.items() if v}
    m = trainer.cfg.model
    state_count = {"parameters": sum(p.numel()
                                     for p in trainer.model.parameters()),
                   "fp32_bytes_params_moments_acc":
                       4 * 4 * sum(p.numel()
                                   for p in trainer.model.parameters())}
    numbers = {
        "main_s": main_s, "pth_write_s": pth_s,
        "epochs_s": [s for s, _ in rec["epochs"]],
        "steps_per_epoch": [len(s) for _, s in rec["epochs"]],
        "micro_steps_per_epoch": micro,
        "ms_per_micro_step": epoch_s * 1e3 / micro,
        "samples_per_s": rows / epoch_s,
        "ms_per_micro_step_first_epoch":
            rec["epochs"][0][0] * 1e3 / micro,
        "host_ms_per_step_median": host_ms,
        "in_turns_with_bare_steps": turns,
        "launch_shapes": [list(x) for x in shapes],
        "eval_s_per_epoch": [s for s, _ in rec["evals"]],
        "checkpoints": rec["saves"], "restore_s": restore_s,
        "restore_tensors_bitwise": n_tensors, "state_count": state_count,
        "peak_memory_gb": peak_gb, "dump": listing,
        "launches": counts,
        "launches_per_step": {k: trainer_launches(trainer.cfg, k)[
            "packed_fwd"] for k in ("rel", "ic")},
        "lr_logged": [(int(n), lr) for n, _, lr in lr_lines],
        "update_every": TRAINER_K, "best_metrics": trainer.best_metrics,
        "refine_image": trainer.cfg.refine_image, "n_layers": m.n_layers,
    }
    log(f"[trainer] the recipe through train_x.main at {m.n_layers} x "
        f"{m.emb_dim}d, bf16, "
        f"dropout 0.1, accumulation {TRAINER_K}, refine_image "
        f"{trainer.cfg.refine_image}: {len(rec['epochs'])} epochs of "
        f"{numbers['steps_per_epoch']} steps ({micro} micro-steps) in "
        f"{numbers['epochs_s']} s; {numbers['ms_per_micro_step']:.2f} ms a "
        f"micro-step, {numbers['samples_per_s']:.1f} samples/s, host ms a "
        f"step (median) {host_ms}; #1/#2 a step: rel {trainer_launches(trainer.cfg, 'rel')['packed_fwd']}/"
        f"{trainer_launches(trainer.cfg, 'rel')['packed_bwd']}, ic "
        f"{trainer_launches(trainer.cfg, 'ic')['packed_fwd']}/"
        f"{trainer_launches(trainer.cfg, 'ic')['packed_bwd']}, all on the "
        f"tensor cores; main path {counts['packed_fwd']} #1, "
        f"{counts['packed_bwd']} #2; eval {numbers['eval_s_per_epoch']} s "
        f"an epoch; checkpoints {rec['saves']}; restore {restore_s:.2f} s, "
        f"{n_tensors} tensors bitwise; peak {peak_gb:.2f} GB; lr logged "
        f"{numbers['lr_logged']}; dump {listing}; every launch at a shape "
        f"phase 2 held: {shapes}")
    return numbers


def trainer_in_turns(trainer, data, n=TRAINER_K):
    """`Trainer.step_once` beside the bare `make_train_step` step of the
    same kind at the trainer's own batch, in one process and in turns
    (bare, trainer, trainer, bare; each block n steps of the kind, the
    host's clock around a synchronised block): the ITM (t2i, i2t) pair and
    the caption step, both on the trainer's model and optimizer state (the
    accumulation in both, a block of n steps holding the same number of
    updates either way).  The difference is what the trainer adds: the
    staging thread, the lambdas, the seeds and the stats."""
    import torch

    from m3p_tpu_torch.data.pipeline import prefetch_to_device
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train import steps as S

    dev = trainer.device
    out = {}
    for kind in ("rel", "ic"):
        task = (kind, "coco")
        staging = prefetch_to_device(
            iter(data.train_datasets[task].batches[:1]), device=dev)
        batch = next(staging)
        staging.close()
        halves = batch if isinstance(batch, tuple) else (batch,)
        step = S.make_train_step(trainer._loss_fn(kind))
        seed = [trainer.cfg.seed]

        def bare():
            for b in halves:
                trainer.state, _ = step(trainer.state, b,
                                        Generators.from_seed(seed[0], dev))
            seed[0] += 977

        def through_trainer():
            trainer.step_once(kind, task)

        def block(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3 / n

        through_trainer()   # the kind's staging thread started
        bare()
        b1, t1, t2, b2 = (block(f) for f in (bare, through_trainer,
                                             through_trainer, bare))
        rows = len(halves) * (TRAINER_B * SAMPLE_N if kind == "rel"
                              else TRAINER_B)
        bare_ms, trainer_ms = (b1 + b2) / 2, (t1 + t2) / 2
        out[kind] = {"steps_a_block": n, "micro_steps_a_step": len(halves),
                     "bare_ms_a_step": bare_ms,
                     "trainer_ms_a_step": trainer_ms,
                     "readings_bare_trainer_trainer_bare": [b1, t1, t2, b2],
                     "bare_samples_per_s": rows * 1e3 / bare_ms,
                     "trainer_samples_per_s": rows * 1e3 / trainer_ms,
                     "trainer_minus_bare_ms": trainer_ms - bare_ms}
    trainer._close_iterators()
    log(f"[trainer] in turns at the trainer's batch (bare, trainer, trainer,"
        f" bare; {n} steps a block): " + "; ".join(
            f"{k} bare {v['bare_ms_a_step']:.2f} ms a step "
            f"({v['bare_samples_per_s']:.1f} samples/s), trainer "
            f"{v['trainer_ms_a_step']:.2f} ms ({v['trainer_samples_per_s']:.1f}"
            f" samples/s), difference {v['trainer_minus_bare_ms']:+.2f} ms, "
            f"readings {[round(x, 2) for x in v['readings_bare_trainer_trainer_bare']]}"
            for k, v in out.items()))
    return out


def trainer_preemption(seed, data, tmp):
    """(b) SIGTERM between micro-steps at depth 2, bf16: the checkpoint at
    the next step boundary, a fresh model and Trainer reloading it bit for
    bit, the next micro-steps from both, the handler's restore; and a
    FusedAdam state (bf16 moments, fp32 master) saved and restored bit for
    bit."""
    import signal

    import torch

    from m3p_tpu_torch import checkpoint as ckpt
    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state
    from m3p_tpu_torch.train.trainer import Trainer

    argv = TRAINER_ARGV + ["--n_layers", "2"]
    cfg = train_x.args_to_config(train_x.get_parser().parse_args(argv))
    cfg.dump_path = os.path.join(tmp, "preempt")
    os.makedirs(cfg.dump_path)
    before = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(cfg, build_model(cfg.model, seed, "cuda"),
                      data.train_datasets)
    trainer.install_preemption_handler()
    at_save = {}
    micro = [0]
    apply0 = trainer.state.apply_gradients

    def apply():
        out = apply0()
        micro[0] += 1
        if micro[0] == TRAINER_K + 1:
            os.kill(os.getpid(), signal.SIGTERM)
            at_save["pending_at_once"] = trainer._pending_save
        return out

    trainer.state.apply_gradients = apply

    def on_save(orig):
        def save(path, state, extra=None):
            at_save.update(state=state_copy(state), extra=dict(extra),
                           micro=micro[0])
            orig(path, state, extra)
            # the uninterrupted run pauses here: the epoch's budget is spent
            trainer.n_sentences = cfg.epoch_size
        return save

    try:
        with patched(ckpt, "save_checkpoint", on_save):
            trainer.train_epoch()
        if "state" not in at_save:
            fail("trainer: SIGTERM scheduled no checkpoint")
        if not at_save["pending_at_once"]:
            fail("trainer: the SIGTERM handler did not run at once")
        saved = at_save["state"]
        if saved["step"] != 1:
            fail(f"trainer: SIGTERM's checkpoint at update {saved['step']}")
        mini = dict(saved["opt"])[".mini_step"]
        if mini == 0 or at_save["extra"]["n_total_iter"] != \
                trainer.n_total_iter:
            fail(f"trainer: SIGTERM's checkpoint at mini-step {mini}, "
                 f"n_total_iter {at_save['extra']['n_total_iter']} (the "
                 f"run at {trainer.n_total_iter})")
        resumed = Trainer(cfg, build_model(cfg.model, seed + 7, "cuda"),
                          data.train_datasets)
        t0 = time.perf_counter()
        if not resumed.reload_checkpoint():
            fail("trainer: no checkpoint to resume from")
        reload_s = time.perf_counter() - t0
        bad, n_tensors = bitwise_equal(resumed.state, saved)
        if bad or resumed.n_total_iter != trainer.n_total_iter:
            fail(f"trainer: the resumed state differs at {bad[:5]}")
        # the next micro-steps from both, on the same batches and seeds
        trainer._close_iterators()
        trainer.stats.flush()
        losses = {"uninterrupted": [], "resumed": []}
        for kind in RESUME_STEPS:
            for name, t in (("uninterrupted", trainer),
                            ("resumed", resumed)):
                t.step_once(kind, (kind, "coco"))
                losses[name].append(t.stats.flush()[f"{kind}-coco"])
        a = torch.tensor(losses["uninterrupted"])
        b = torch.tensor(losses["resumed"])
        if not torch.allclose(b, a, **TOL_BF16) or not torch.isfinite(a).all():
            fail(f"trainer: losses after the resume {losses}")
        bitwise = bool(torch.equal(a, b))
        if resumed.state.step != trainer.state.step:
            fail(f"trainer: {resumed.state.step} updates after the resume, "
                 f"{trainer.state.step} without")
    finally:
        trainer.uninstall_preemption_handler()
    if signal.getsignal(signal.SIGTERM) != before:
        fail("trainer: SIGTERM's disposition was not restored")
    resumed._close_iterators()
    trainer._close_iterators()
    micro_steps = sum(2 if k == "rel" else 1 for k in RESUME_STEPS)
    # FusedAdam: bf16 moments and an fp32 master
    tx, _ = build_optimizer(LONG_SPEC, clip_grad_norm=CLIP)
    state = create_train_state(build_model(cfg.model, seed, "cuda"), tx)
    state, _ = itm_step()(state, train_batch(seed, "cuda"),
                          Generators.from_seed(seed, "cuda"))
    path = os.path.join(tmp, "fused")
    ckpt.save_checkpoint(path, state, {"epoch": 0})
    fused_saved = state_copy(state)
    fresh = create_train_state(build_model(cfg.model, seed + 3, "cuda"),
                               build_optimizer(LONG_SPEC,
                                               clip_grad_norm=CLIP)[0])
    ckpt.restore_checkpoint(path, fresh)
    fused_bad, fused_n = bitwise_equal(fresh, fused_saved)
    if fused_bad or "master" not in fresh.opt_state:
        fail(f"trainer: the FusedAdam state differs at {fused_bad[:5]}")
    numbers = {"sigterm_after_micro_step": TRAINER_K + 1,
               "checkpoint_at_micro_step": at_save["micro"],
               "checkpoint_update": saved["step"],
               "checkpoint_mini_step": mini,
               "checkpoint_n_total_iter": at_save["extra"]["n_total_iter"],
               "resume_tensors_bitwise": n_tensors, "reload_s": reload_s,
               "micro_steps_after_resume": micro_steps,
               "losses_after_resume": losses,
               "losses_bitwise_equal": bitwise,
               "fused_master_tensors_bitwise": fused_n}
    log(f"[trainer] preemption at depth 2: SIGTERM after micro-step "
        f"{TRAINER_K + 1}, checkpoint at the step boundary after micro-step "
        f"{at_save['micro']} (update {saved['step']}, mini-step {mini}); a "
        f"fresh Trainer reloaded {n_tensors} tensors bit for bit in "
        f"{reload_s:.2f} s; {micro_steps} micro-steps after: losses "
        f"{'bitwise equal' if bitwise else 'within TOL_BF16, not bitwise'} "
        f"{losses}; the handler restored; FusedAdam (bf16 moments, fp32 "
        f"master) {fused_n} tensors bit for bit")
    return numbers


def trainer_fp32_vs_cpu(seed):
    """(c) 4 trainer micro-steps of rel + ic at depth 2, fp32, rate 0,
    accumulation 2 and weight decay, a TRAINER_FP32_WORDS vocabulary, on
    the card and on the CPU from the same weights and batches: the
    parameters' change per leaf."""
    import torch

    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.train.trainer import Trainer

    argv = TRAINER_ARGV + [
        "--n_layers", "2", "--fp16", "False", "--dropout", "0",
        "--attention_dropout", "0", "--accumulate_gradients", "2",
        "--optimizer", TRAINER_FP32_SPEC]
    cfg = train_x.args_to_config(train_x.get_parser().parse_args(argv))
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, n_words=TRAINER_FP32_WORDS,
        mask_index=TRAINER_FP32_WORDS - 1))
    data = trainer_data(seed + 5, TRAINER_FP32_GROUPS, TRAINER_FP32_B,
                        TRAINER_FP32_WORDS)
    cpu_model = cpu_model_from_card(cfg.model, seed)
    start = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    gpu_model = build_model(cfg.model, seed, "cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    t0 = time.time()
    trainers = {side: Trainer(cfg, m, data.train_datasets)
                for side, m in (("card", gpu_model), ("host", cpu_model))}
    zero_launch_counts()
    for kind in FP32_STEPS:
        for t in trainers.values():
            t.step_once(kind, (kind, "coco"))
    counts = launch_counts()
    for t in trainers.values():
        t._close_iterators()
    if trainers["card"].state.step != FP32_UPDATES or \
            trainers["host"].state.step != FP32_UPDATES:
        fail(f"trainer fp32: not {FP32_UPDATES} updates in "
             f"{2 * FP32_UPDATES} micro-steps")
    if counts["packed_fwd"] == 0 or counts["packed_fwd_tensor_cores"]:
        fail(f"trainer fp32: launches {counts} (fp32 takes the CUDA-core "
             f"designs)")
    change = {k: v.cpu() - start[k]
              for k, v in gpu_model.state_dict().items()}
    want = {k: v - start[k] for k, v in cpu_model.state_dict().items()}
    largest = max(v.abs().max().item() for v in want.values())
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        scale = w.abs().max().item()
        if scale < 1e-3 * largest:
            scale = largest
        err = (change[name] - w).abs().max().item() / max(scale, 1e-30)
        if err > worst:
            worst, worst_name = err, name
    if not worst <= TOL_TRAINER_FP32:
        fail(f"trainer fp32: parameter change card vs CPU {worst:.3e} at "
             f"{worst_name} (tolerance {TOL_TRAINER_FP32})")
    log(f"[trainer] fp32 at depth 2, card vs CPU, {2 * FP32_UPDATES} "
        f"micro-steps ({FP32_UPDATES} updates, weight decay 0.01): worst change difference {worst:.3e} at "
        f"{worst_name} (tolerance {TOL_TRAINER_FP32}, relative to the leaf's"
        f" largest change); largest change {largest:.3e}; "
        f"{time.time() - t0:.1f} s")
    return {"worst_rel": worst, "leaf": worst_name, "largest_change": largest,
            "tolerance": TOL_TRAINER_FP32, "s": time.time() - t0}


def trainer_slice(seed):
    """Phase 14: the trainer path (train_x -> Trainer -> the steps ->
    Evaluator -> checkpoints) in three parts; the dump directory removed
    at the end."""
    import logging
    import shutil

    import torch

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="m3p_trainer_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        if free_gb < TRAINER_DISK_GB:
            fail(f"trainer: {free_gb:.1f} GB free under {tmp}; the phase "
                 f"writes flagship checkpoints and needs {TRAINER_DISK_GB} "
                 f"GB")
        data = trainer_data(seed)
        data_s = time.time() - t0
        out = {"data_s": data_s, "disk_free_gb": free_gb}
        sublap("p14_data")
        out["recipe"] = trainer_recipe(seed, data, tmp)
        torch.cuda.empty_cache()
        sublap("p14a_recipe")
        out["preemption"] = trainer_preemption(seed, data, tmp)
        torch.cuda.empty_cache()
        sublap("p14b_preemption")
        out["fp32_card_vs_cpu"] = trainer_fp32_vs_cpu(seed)
    finally:
        logger = logging.getLogger("m3p_tpu_torch")
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            handler.close()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t0
    log(f"[trainer] phase 14: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the datasets and the input pipeline
# ---------------------------------------------------------------------------

# (a) `train_x.main` from a data directory, no data=: the flagship width at
# depth 2 (phase 14 times the full-depth step), a token stream (xMLM, bptt
# 256) and parallel text (MT en-de, 64 tokens) at B = 24 through the row
# loader with 2 read threads, one epoch of DATASET_STEPS steps; evals:
# MLM, the MT loss and greedy MT (EvalConfig's max_gen_len 40), one batch
# each
DATASET_B, DATASET_BPTT, DATASET_STEPS = 24, 256, 12
DATASET_ARGV = [
    "--exp_name", "phase15", "--batch_size", str(DATASET_B),
    "--emb_dim", "768", "--n_layers", "2", "--n_dec_layers", "2",
    "--n_heads", "12", "--dropout", "0.1", "--attention_dropout", "0.1",
    "--gelu_activation", "True", "--optimizer", OPTIM_SPEC,
    "--lgs", "en-de", "--mt_steps", "en-de", "--mlm_steps", "en",
    "--bptt", str(DATASET_BPTT), "--max_len", str(CAPTION_LEN),
    "--fp16", "True", "--epoch_size", str(DATASET_B * DATASET_STEPS),
    "--max_epoch", "1", "--use_grain", "True", "--num_workers", "2",
    "--eval_n", str(DATASET_B), "--beam_size", "1", "--device", "cuda"]
# SIGTERM after this step, the end of a round of the two tasks: the
# checkpoint lands at the step boundary right after it
DATASET_SIGTERM_AT = 4
# the directory: train / valid token counts of the stream, sentence pairs
DATASET_STREAM = (120_000, 2 * DATASET_B * DATASET_BPTT)
DATASET_PAIRS = (480, 2 * DATASET_B)
# (b) phase 14's recipe over the ported RetrievalDataset and CaptionDataset
# over an in-memory store of DATASET_IMAGES images (100 regions x 2048, 328
# MB), DATASET_CAPTIONS captions each; the loader alone over this many
# batches of each dataset
DATASET_IMAGES, DATASET_CAPTIONS, LOADER_BATCHES = 400, 5, 6
# its timed epochs, one each after a warm-up epoch: the row loader with the
# recipe's read threads (None), the datasets' ready-made batches cycled in
# memory as phase 14 steps them, and the row loader with 1 read thread
DATASET_TURNS = (("row_loader", None), ("in_memory", None),
                 ("row_loader", 1))


class InMemoryStore:
    """`data.features.RegionFeatureStore`'s methods (`get`, `get_into`,
    `index_of`, `image_ids`, `feat_dim`, ``max_region_num``) over arrays
    in host memory, the chip machine having no h5py: ``n`` images of
    ``max_region_num`` regions x 2048 random non-negative features, 10 to
    all of them valid, boxes in a 600 x 600 image, object classes."""

    def __init__(self, seed, n, max_region_num=REGIONS):
        import numpy as np

        from m3p_tpu_torch.data.features import norm_boxes

        rng = np.random.default_rng(seed)
        r = self.max_region_num = max_region_num
        self.raw = rng.standard_normal((n, r, 2048), dtype=np.float32)
        np.maximum(self.raw, 0, out=self.raw)
        boxes = np.sort(rng.random((n, r, 2, 2)) * 600, axis=2)
        self.locs = np.stack([norm_boxes(b.reshape(r, 4), 600.0, 600.0)
                              for b in boxes])
        self.objects = rng.integers(0, 1600, (n, r)).astype(np.int32)
        self.num_boxes = rng.integers(10, r + 1, n)
        self._ids = np.array([f"img{i}" for i in range(n)])
        self._index = {str(i): k for k, i in enumerate(self._ids)}

    def __len__(self):
        return len(self._ids)

    @property
    def feat_dim(self):
        return self.raw.shape[-1]

    @property
    def image_ids(self):
        return self._ids

    def index_of(self, image_id):
        return self._index[str(image_id)]

    def get(self, index, normalize=True):
        import numpy as np

        from m3p_tpu_torch.data.features import l2_normalize

        n = int(self.num_boxes[index])
        mask = np.zeros((self.max_region_num,), np.int32)
        mask[:n] = 1
        raw = self.raw[index]
        return {"feats": l2_normalize(raw) if normalize else raw.copy(),
                "raw_feats": raw.copy(), "locs": self.locs[index].copy(),
                "mask": mask, "objects": self.objects[index].copy(),
                "num_boxes": np.int32(n)}

    def get_into(self, index, raw_out, locs_out, objects_out):
        raw_out[:] = self.raw[index]
        locs_out[:] = self.locs[index]
        objects_out[:] = self.objects[index]
        return int(self.num_boxes[index])


def dataset_shapes():
    """(B, Sq, Sk, causal) of phase 15(a)'s attention, steps and evals
    alike: the stream encoder over DATASET_BPTT tokens; MT's encoder over
    CAPTION_LEN source tokens, its decoder causal over CAPTION_LEN - 1
    positions and across over the source.  Phase 15(b) runs phase 14's
    (`trainer_shapes`).  Phase 2 holds both kernels at each; phase 15
    fails if it launches one at any other."""
    b, s, t = DATASET_B, CAPTION_LEN, CAPTION_LEN - 1
    steps = sorted({(b, DATASET_BPTT, DATASET_BPTT, False), (b, s, s, False),
                    (b, t, t, True), (b, t, s, False)})
    return {"bwd": steps, "fwd": steps}


def dataset_launches(cfg, kind):
    """#1/#2 launches of one step of phase 15(a): the stream encoder's L
    self-attentions (xMLM) or MT's 3 L (`decoder_per_step`), all on the
    tensor cores."""
    if kind == "mlm":
        n = cfg.model.n_layers
        return expected_launches((n, 2 * n))
    return decoder_per_step(cfg.model, "mt")


def write_data_dir(root, seed):
    """A data directory `load_data` reads for DATASET_ARGV: phase 11's
    250,002-id vocab, an English token stream (`train.en.npy`,
    `valid.en.npy`) and en-de parallel text of 5-60 words a sentence."""
    import numpy as np

    rng = np.random.RandomState(seed)
    write_vocab(os.path.join(root, "vocab.tsv"), 250000)
    for split, n in zip(("train", "valid"), DATASET_STREAM):
        np.save(os.path.join(root, f"{split}.en.npy"),
                rng.randint(4, 250001, n).astype(np.int32))
    for split, n in zip(("train", "valid"), DATASET_PAIRS):
        for side in ("en", "de"):
            with open(os.path.join(root, f"{split}.en-de.{side}.txt"), "w",
                      encoding="utf-8") as f:
                f.writelines(sentence(rng, int(rng.randint(5, 61))) + "\n"
                             for _ in range(n))


def same_batches(a, b):
    """Whether two staged batches (a dict of tensors, or a tuple of such)
    are equal bit for bit."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(same_batches, a, b))
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def dataset_cli(seed, tmp):
    """(a) Three runs of `train_x.main(argv)` over a data directory, no
    ``data=``: one epoch uninterrupted; the same run with SIGTERM after
    step DATASET_SIGTERM_AT, whose checkpoint at the next step boundary
    ends the process (an exception out of `main`); a fresh `main` that
    resumes it mid-epoch.  The task order's RandomState is no part of a
    checkpoint (nor in the JAX trainer): the resumed run is handed the
    preempted one's, so that both runs take the same steps.  Each task's
    batches (before the checkpoint and after the resume) are bitwise the
    uninterrupted run's, and so are the losses; each step's #1/#2
    launches are counted, every launch at a shape phase 2 held."""
    import json as _json
    import signal

    import numpy as np
    import torch

    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.eval.evaluator import Evaluator
    from m3p_tpu_torch.train import trainer as trainer_mod

    data = os.path.join(tmp, "data")
    os.makedirs(data)
    t0 = time.time()
    write_data_dir(data, seed)
    write_s = time.time() - t0
    argv = DATASET_ARGV + ["--data_path", data, "--vocab_path",
                           os.path.join(data, "vocab.tsv"), "--dump_path",
                           os.path.join(tmp, "dump"), "--seed", str(seed)]
    runs = {name: {"batches": {}, "losses": [], "steps": [], "scores": []}
            for name in ("whole", "cut", "resumed")}
    now = {"run": None, "rng": None}

    class Preempted(Exception):
        pass

    def on_init(orig):
        def init(self, *a, **kw):
            orig(self, *a, **kw)
            rec = runs[now["run"]]
            add = self.stats.add
            self.stats.add = lambda key, v: (rec["losses"].append((key, v)),
                                             add(key, v))[1]
            if now["run"] == "resumed":
                self.rng.set_state(now["rng"])
        return init

    def on_batch(orig):
        def get_batch(self, task):
            batch = orig(self, task)
            runs[now["run"]]["batches"].setdefault(task, []).append(batch)
            return batch
        return get_batch

    def on_step(orig):
        def step_once(self, kind, task):
            before = launch_counts()
            orig(self, kind, task)
            after = launch_counts()
            runs[now["run"]]["steps"].append(
                (kind, {k: after[k] - before[k] for k in after}))
            if now["run"] == "cut" and self.n_total_iter == \
                    DATASET_SIGTERM_AT:
                os.kill(os.getpid(), signal.SIGTERM)
        return step_once

    def on_save(orig):
        def save(self, name="checkpoint"):
            orig(self, name)
            if now["run"] == "cut" and \
                    self.n_sentences < self.cfg.epoch_size:
                now["rng"] = self.rng.get_state()
                now["saved_at"] = self.n_total_iter
                raise Preempted
        return save

    def on_eval(orig):
        def run(self, eval_data):
            scores = orig(self, eval_data)
            runs[now["run"]]["scores"].append(scores)
            return scores
        return run

    main_s = {}
    cut_dump = os.path.join(tmp, "dump", "phase15", "cut")
    with contextlib.ExitStack() as stack:
        for name, make in (("__init__", on_init), ("_get_batch", on_batch),
                           ("step_once", on_step),
                           ("save_checkpoint", on_save)):
            stack.enter_context(patched(trainer_mod.Trainer, name, make))
        stack.enter_context(patched(Evaluator, "run_all_evals", on_eval))
        shapes = stack.enter_context(recorded_launch_shapes(set()))
        # ---- the main path, counted ----
        zero_launch_counts()
        for name, exp in (("whole", "whole"), ("cut", "cut"),
                          ("resumed", "cut")):
            now["run"] = name
            t = time.time()
            try:
                trainer = train_x.main(argv + ["--exp_id", exp])
            except Preempted:
                trainer = None
                if name != "cut":
                    raise
            torch.cuda.synchronize()
            main_s[name] = time.time() - t
            if name == "cut":
                if trainer is not None:
                    fail("datasets: the SIGTERM checkpoint did not end the "
                         "run")
                # the resumed run's epoch-end checkpoint replaces this one
                with open(os.path.join(cut_dump, "checkpoint",
                                       "loader_state.0.json")) as f:
                    states = {k: _json.loads(v)["next_batch"]
                              for k, v in _json.load(f).items()}
            if name != "cut" and (trainer.epoch != 1 or
                                  trainer.n_total_iter != DATASET_STEPS):
                fail(f"datasets: the {name} run ended at epoch "
                     f"{trainer.epoch}, iter {trainer.n_total_iter}")
        counts = launch_counts()
    # ---- checks ----
    shapes = check_held_shapes("phase 15(a)'s train_x.main", shapes)
    cfg = trainer.cfg
    if sorted(trainer.datasets) != [("mlm", "en"), ("mt", "en")]:
        fail(f"datasets: load_data gave {sorted(trainer.datasets)}")
    for name, rec in runs.items():
        for kind, got in rec["steps"]:
            if got != dataset_launches(cfg, kind):
                fail(f"datasets: a {kind} step of the {name} run launched "
                     f"{got}; expected {dataset_launches(cfg, kind)}")
    if now.get("saved_at") != DATASET_SIGTERM_AT:
        fail(f"datasets: SIGTERM after step {DATASET_SIGTERM_AT}, the "
             f"checkpoint after step {now.get('saved_at')}")
    taken = {"|".join(k): len(v) for k, v in runs["cut"]["batches"].items()}
    if states != taken:
        fail(f"datasets: the checkpoint's loader positions {states}, the "
             f"steps took {taken}")
    with open(os.path.join(cut_dump, "train.log")) as f:
        log_text = f.read()
    if "resumed MID-EPOCH" not in log_text:
        fail("datasets: the log does not report a mid-epoch resume")
    batches_equal = {}
    for task, want in runs["whole"]["batches"].items():
        got = runs["cut"]["batches"].get(task, []) + \
            runs["resumed"]["batches"].get(task, [])
        batches_equal["|".join(task)] = len(want)
        if len(got) != len(want) or not all(map(same_batches, got, want)):
            fail(f"datasets: {task}'s batches before the checkpoint and "
                 f"after the resume are not the uninterrupted run's")
    losses = {name: [(k, float(v)) for k, v in rec["losses"]]
              for name, rec in runs.items()}
    a = losses["whole"]
    b = losses["cut"] + losses["resumed"]
    if [k for k, _ in a] != [k for k, _ in b]:
        fail(f"datasets: the resumed run took other steps {b} than the "
             f"uninterrupted run {a}")
    la, lb = torch.tensor([v for _, v in a]), torch.tensor([v for _, v in b])
    if not torch.isfinite(la).all() or not torch.allclose(lb, la,
                                                          **TOL_BF16):
        fail(f"datasets: losses {a} uninterrupted, {b} preempted and "
             f"resumed")
    for name, rec in runs.items():
        for scores in rec["scores"]:
            if not scores or not all(np.isfinite(v) for v in
                                     scores.values()):
                fail(f"datasets: the {name} run's eval scores {scores}")
    n_fwd = counts["packed_fwd"]
    if counts["packed_fwd_tensor_cores"] != n_fwd or \
            counts["packed_bwd_tensor_cores"] != counts["packed_bwd"] or \
            counts["flash_fwd"] or counts["small_fwd"]:
        fail(f"datasets: main path launches {counts}")
    out = {"write_data_s": write_s, "main_s": main_s,
           "steps": {n: len(r["steps"]) for n, r in runs.items()},
           "launches": counts,
           "launches_per_step": {k: dataset_launches(cfg, k)["packed_fwd"]
                                 for k in ("mlm", "mt")},
           "checkpoint_after_step": now["saved_at"],
           "loader_positions": states, "batches_compared": batches_equal,
           "losses_bitwise_equal": bool(torch.equal(la, lb)),
           "losses": {"uninterrupted": a, "preempted_then_resumed": b},
           "eval_scores": runs["whole"]["scores"],
           "launch_shapes": [list(x) for x in shapes]}
    log(f"[datasets] (a) train_x.main from a data directory at "
        f"{cfg.model.n_layers} x {cfg.model.emb_dim}d bf16, mlm (bptt "
        f"{DATASET_BPTT}) + mt en-de at B = {DATASET_B} through the row "
        f"loader: runs {main_s} s; SIGTERM after step {DATASET_SIGTERM_AT}, "
        f"checkpoint after step {now['saved_at']} at loader positions "
        f"{states}; the resume took each task's next batches bitwise "
        f"({batches_equal} compared), losses "
        f"{'bitwise equal' if out['losses_bitwise_equal'] else 'within TOL_BF16'}"
        f" {a}; #1/#2 a step {out['launches_per_step']} / twice that, "
        f"main path {counts['packed_fwd']} #1, {counts['packed_bwd']} #2, "
        f"all tensor cores; eval {runs['whole']['scores']}; every launch at "
        f"a shape phase 2 held: {shapes}")
    return out


def rss_mb():
    """(resident, peak resident) memory of this process in MB: the pages of
    /proc/self/statm, and getrusage's ru_maxrss (KB on Linux)."""
    import resource

    with open("/proc/self/statm") as f:
        resident = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return resident / 2 ** 20, peak / 1024


def loader_records_per_s(dataset, cfg, workers):
    """Records a second of `make_row_loader` alone at the trainer's batch,
    LOADER_BATCHES batches after one (the first waits for the threads to
    start)."""
    from m3p_tpu_torch.data.row_pipeline import make_row_loader

    it = iter(make_row_loader(dataset, cfg.data.batch_size, seed=cfg.seed,
                              epoch=7, num_epochs=None,
                              worker_count=workers))
    next(it)
    t = time.perf_counter()
    for _ in range(LOADER_BATCHES):
        next(it)
    secs = time.perf_counter() - t
    it.close()
    return LOADER_BATCHES * cfg.data.batch_size / secs


def recipe_config(tokenizer, tmp, extra=()):
    """Phase 14's recipe config (`TRAINER_ARGV` + ``extra``) over
    ``tokenizer``'s vocabulary, dumping into a new directory of ``tmp``."""
    from m3p_tpu_torch.cli import train_x

    cfg = train_x.args_to_config(train_x.get_parser().parse_args(
        TRAINER_ARGV + list(extra)))
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, n_words=tokenizer.vocab_size,
        mask_index=tokenizer.mask_token_id))
    cfg.dump_path = tempfile.mkdtemp(prefix="recipe", dir=tmp)
    return cfg


def recipe_captions(seed, store):
    """DATASET_CAPTIONS captions of 8-20 words for each image of
    ``store``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {i: [sentence(rng, int(rng.randint(8, 21)))
                for _ in range(DATASET_CAPTIONS)]
            for i in store.image_ids}


def recipe_datasets(cfg, store, captions, tokenizer):
    """Phase 15(b)'s datasets: rel and ic over ``store``, tokenized by
    ``tokenizer``."""
    from m3p_tpu_torch.data.datasets import CaptionDataset, RetrievalDataset

    return {("rel", "coco"): RetrievalDataset(
                captions, store, tokenizer, lang="en",
                sample_n=cfg.data.sample_n, max_len=cfg.data.max_len,
                seed=cfg.seed),
            ("ic", "coco"): CaptionDataset(
                captions, store, tokenizer, lang="en",
                max_len=cfg.data.max_len, seed=cfg.seed,
                lang_id=cfg.lang2id.get("en"))}


def dataset_recipe(seed, tokenizer, phase14_ms, tmp):
    """(b) Phase 14's recipe (rel + ic, accumulation 4, BN = 24 x 4, 100
    regions, captions of 64 tokens, bf16 at the flagship width) with its
    in-memory batches replaced by the ported `RetrievalDataset` and
    `CaptionDataset` over an `InMemoryStore`, through the row loader: a
    warm-up epoch, then DATASET_TURNS' epochs, one each (the recipe's 4 read
    threads, 1 read thread, the datasets' ready-made batches in memory),
    timed and counted (each step's launches checked, every launch at a
    held shape); the loader alone (4 read threads and 1) beside the
    records the steps consumed; the process's RSS; at depth 2, a checkpoint after 5 steps
    and a fresh Trainer resuming it: the next 3 batches of each task
    bitwise."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.train.trainer import Trainer

    def config(extra):
        return recipe_config(tokenizer, tmp, extra)

    rss_before = rss_mb()
    t0 = time.time()
    cfg = config([])
    store = InMemoryStore(seed, DATASET_IMAGES)
    captions = recipe_captions(seed, store)

    def datasets():
        return recipe_datasets(cfg, store, captions, tokenizer)

    loaded = datasets()
    # the in-memory batches phase 14 steps: ready-made batches of the same
    # datasets, cycled
    memory = {task: CycledBatches(list(itertools.islice(
        ds.epoch_iterator(cfg.data.batch_size, 0), 2)))
        for task, ds in loaded.items()}
    build_s = time.time() - t0
    workers = cfg.data.num_workers
    trainer = Trainer(cfg, build_model(cfg.model, seed, "cuda"), loaded)
    steps, readings = [], []

    def on_step(orig):
        def step_once(kind, task):
            before = launch_counts()
            orig(kind, task)
            after = launch_counts()
            steps.append((kind, {k: after[k] - before[k] for k in after}))
        return step_once

    def epoch(source, threads):
        trainer.datasets = memory if source == "in_memory" else loaded
        trainer.cfg = trainer.cfg.replace(data=dataclasses.replace(
            trainer.cfg.data, num_workers=threads))
        n0 = len(steps)
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_epoch()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        trainer.epoch += 1
        trainer._close_iterators()
        done = steps[n0:]
        readings.append({"source": source,
                         "threads": threads if source == "row_loader"
                         else None, "s": secs,
                         "steps": len(done),
                         "micro_steps": sum(2 if k == "rel" else 1
                                            for k, _ in done)})

    with patched(trainer, "step_once", on_step):
        epoch("row_loader", workers)        # warm-up
        steps.clear()
        readings.clear()
        with recorded_launch_shapes(set()) as shapes:
            # ---- the main path, counted: one epoch each ----
            zero_launch_counts()
            for source, threads in DATASET_TURNS:
                epoch(source, threads or workers)
            counts = launch_counts()
    rss_after = rss_mb()
    shapes = check_held_shapes("phase 15(b)'s trainer", shapes)
    for kind, got in steps:
        if got != trainer_launches(cfg, kind):
            fail(f"datasets recipe: a {kind} step launched {got}; expected "
                 f"{trainer_launches(cfg, kind)}")
    by_mode = {}
    for r in readings:
        key = f"{r['source']}_{r['threads']}" if r["source"] == \
            "row_loader" else r["source"]
        by_mode.setdefault(key, []).append(r)
    ms = {k: sum(r["s"] for r in v) * 1e3 / sum(r["micro_steps"] for r in v)
          for k, v in by_mode.items()}
    consumed = {k: sum(r["steps"] for r in v) * cfg.data.batch_size
                / sum(r["s"] for r in v) for k, v in by_mode.items()}
    alone = {f"{task[0]}_{w}_threads": loader_records_per_s(loaded[task],
                                                            cfg, w)
             for task in sorted(loaded) for w in (workers, 1)}
    del trainer
    torch.cuda.empty_cache()

    # one resume mid-epoch at depth 2, over new datasets of the same data
    small = config(["--n_layers", "2"])
    tasks = [("rel", "coco"), ("ic", "coco")]
    ta = Trainer(small, build_model(small.model, seed, "cuda"), datasets())
    for kind in ("rel", "ic", "rel", "ic", "ic"):
        ta.step_once(kind, (kind, "coco"))
    ta.save_checkpoint()
    nxt = {task: [ta._get_batch(task) for _ in range(3)] for task in tasks}
    tb = Trainer(small, build_model(small.model, seed + 7, "cuda"),
                 datasets())
    if not tb.reload_checkpoint() or tb._resume_sentences != \
            5 * small.data.batch_size:
        fail("datasets recipe: no mid-epoch resume")
    for task in tasks:
        got = [tb._get_batch(task) for _ in range(3)]
        if not all(map(same_batches, got, nxt[task])):
            fail(f"datasets recipe: {task}'s batches after the resume are "
                 f"not the uninterrupted run's")
    ta._close_iterators()
    tb._close_iterators()
    out = {"build_s": build_s, "epochs_in_turns": readings,
           "ms_per_micro_step": ms,
           "phase14_in_memory_ms_per_micro_step": phase14_ms,
           "records_consumed_per_s": consumed,
           "loader_alone_records_per_s": alone,
           "rss_mb_before_after": [rss_before[0], rss_after[0]],
           "peak_rss_mb_process": rss_after[1],
           "store_mb": store.raw.nbytes / 2 ** 20,
           "launches": counts, "launch_shapes": [list(x) for x in shapes],
           "resume_batches_bitwise": 3 * len(tasks)}
    log(f"[datasets] (b) phase 14's recipe over RetrievalDataset + "
        f"CaptionDataset of {DATASET_IMAGES} in-memory images, epochs in "
        f"turns {[(r['source'], r['threads'], round(r['s'], 3)) for r in readings]}"
        f": ms a micro-step {json.dumps(ms)} (phase 14's in-memory batches "
        f"{phase14_ms:.2f} ms); the steps consumed {json.dumps(consumed)} "
        f"records/s, the loader alone {json.dumps(alone)} records/s; RSS "
        f"{rss_before[0]:.0f} -> {rss_after[0]:.0f} MB, the process's peak "
        f"{rss_after[1]:.0f} MB; #1/#2 {counts['packed_fwd']} / "
        f"{counts['packed_bwd']}, all tensor cores, at held shapes "
        f"{shapes}; a depth-2 resume mid-epoch took each task's next 3 "
        f"batches bitwise")
    return out


def dataset_slice(seed, tokenizer, phase14_ms):
    """Phase 15: (a) `train_x.main` from a data directory with a mid-epoch
    resume, (b) phase 14's recipe over the ported datasets; the temporary
    directory removed at the end."""
    import logging
    import shutil

    import torch

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="m3p_datasets_")
    try:
        out = {"cli": dataset_cli(seed, tmp)}
        torch.cuda.empty_cache()
        sublap("p15a_cli")
        out["recipe"] = dataset_recipe(seed, tokenizer, phase14_ms, tmp)
        sublap("p15b_recipe")
    finally:
        logger = logging.getLogger("m3p_tpu_torch")
        for handler in list(logger.handlers):
            logger.removeHandler(handler)
            handler.close()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t0
    log(f"[datasets] phase 15: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 16: the rest of serving -- the native tokenizer, the preprocessing
# CLI, the store-backed gallery and frozen-weight int8 serving
# ---------------------------------------------------------------------------

# (a) sentences of phase 15's generator held native against Python, and
# timed through each encoder's encode_batch in turns
QUANT_SENTENCES = 2000
# (c) /v1/score at these pair counts over the 16-token text bucket (S =
# 100 + 16): 1 and 16 pairs are 116 and 1856 rows, under the 2048-row gate
# (int8), 32 pairs 3712 rows, above it (the plain GEMMs); the gallery the
# CLI stages from the store; the images of a beam-5 caption call
QUANT_SCORE_PAIRS = (1, 16, 32)
QUANT_TEXT_BUCKET = 16
QUANT_GALLERY = 200
QUANT_CAPTION_IMAGES = 16
# (d) the gallery bucket at which retrieval engages int8: 16 x 116 rows
QUANT_INT8_CHUNK = 16
# (e) the int8 model in fp32 on the card against the CPU, depth 2, B = 2,
# each CPU GEMM handed the card's quantized activations: the integer parts
# equal, the float parts sum in another order (TOL_SCORE_FP32's reason)
QUANT_FP32_B = 2
TOL_INT8_FP32 = 1e-3
# the int8 GEMMs of one block's encode through the gate: the fused QKV, the
# out projection, the FFN's two
INT8_GEMMS_PER_BLOCK = 4


def quant_shapes():
    """(B, Sq, Sk, causal) of every #1 launch of phase 16: the refiner over
    the regions and the blocks over regions + the 16-token bucket at each
    /v1/score pair count's batch bucket, at the retrieval chunks (64, the
    engine's, and QUANT_INT8_CHUNK), the caption call's source encoder,
    (e)'s fp32 encode at B = 2 and (f)'s caption eval at B = 16."""
    from m3p_tpu_torch.serve.engine import DEFAULT_BATCH_BUCKETS, _bucket

    r, s = REGIONS, REGIONS + QUANT_TEXT_BUCKET
    bs = {_bucket(n, DEFAULT_BATCH_BUCKETS) for n in QUANT_SCORE_PAIRS}
    bs |= {DEFAULT_BATCH_BUCKETS[-1], QUANT_INT8_CHUNK, QUANT_FP32_B}
    shapes = [(b, w, w, False) for b in sorted(bs) for w in (r, s)]
    shapes.append((_bucket(QUANT_CAPTION_IMAGES, DEFAULT_BATCH_BUCKETS), r,
                   r, False))
    return sorted(set(shapes))


def quant_counts():
    from m3p_tpu_torch.ops import quant

    return {"gate": dict(quant.GATE_COUNTS),
            "int8_matmul_pre": dict(quant.int8_matmul_pre.calls_by_route),
            "int8_matmul_nt_pre": dict(
                quant.int8_matmul_nt_pre.calls_by_route)}


def tokenizer_slice(seed, tmp):
    """16(a), first half: the full vocabulary's native and Python
    tokenizers give the same ids over QUANT_SENTENCES sentences of phase
    15's generator and as many of letters that need the Viterbi, and their
    encode_batch sentences/s in turns (native, Python, Python, native).
    -> (numbers, native tokenizer, Python tokenizer)."""
    import numpy as np

    from m3p_tpu_torch.ops import _build
    from m3p_tpu_torch.tokenization import native
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    vocab = os.path.join(tmp, "vocab.tsv")
    write_vocab(vocab, full_width_config("bfloat16").n_words - 2)
    t0 = time.perf_counter()
    nat = XLMRTokenizer(vocab)
    load_native_s = time.perf_counter() - t0
    py = XLMRTokenizer(vocab, use_native=False)
    lib = _build.host_library_path("m3ptok", native.SOURCES)
    if nat._native is None or not lib.exists():
        fail("the native tokenizer was not built into build/")
    rng = np.random.RandomState(seed + 16)
    texts = [sentence(rng, int(rng.randint(5, 61)))
             for _ in range(QUANT_SENTENCES)]
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    texts += [" ".join("".join(rng.choice(letters, rng.randint(1, 12)))
                       for _ in range(rng.randint(1, 30)))
              for _ in range(QUANT_SENTENCES)]
    for t in texts[:200]:
        if nat.encode(t) != py.encode(t):
            fail(f"native and Python encode differ on {t!r}")
    got, want = (tok.encode_batch(texts, max_ids=256) for tok in (nat, py))
    if got != want:
        bad = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        fail(f"native and Python encode_batch differ on {texts[bad]!r}")
    turns = []
    nat.encode_batch(texts[:500], max_ids=256)     # untimed, each once
    py.encode_batch(texts[:500], max_ids=256)
    for name, tok in (("native", nat), ("python", py), ("python", py),
                      ("native", nat)):
        t0 = time.perf_counter()
        tok.encode_batch(texts, max_ids=256)
        turns.append((name, len(texts) / (time.perf_counter() - t0)))
    rate = {name: float(np.mean([r for n, r in turns if n == name]))
            for name in ("native", "python")}
    out = {"sentences_held": len(texts), "ids": sum(map(len, got)),
           "library": lib.name, "native_load_s": load_native_s,
           "encode_batch_sentences_per_s": rate,
           "encode_batch_turns": turns,
           "native_over_python": rate["native"] / rate["python"]}
    log(f"[tokenizer] native ({lib.name}, built by "
        f"{_build.cxx_path()}) and Python: the same ids over {len(texts)} "
        f"sentences ({out['ids']} ids); encode_batch sentences/s in turns "
        f"{[(n, round(r, 1)) for n, r in turns]}: native "
        f"{rate['native']:.1f}, Python {rate['python']:.1f} "
        f"({out['native_over_python']:.2f}x)")
    return out, nat, py


def tokenizer_recipe_turns(seed, tokenizers, tmp):
    """16(a), second half: phase 15(b)'s recipe (phase 14's, at the full
    depth, over RetrievalDataset + CaptionDataset of an InMemoryStore
    through the row loader, the recipe's read threads) with the datasets
    tokenizing natively and in Python: a warm-up epoch, then one epoch
    each in turns, ms a micro-step; and the loader alone, records/s."""
    import torch

    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.train.trainer import Trainer

    native_tok = tokenizers["native"]
    cfg = recipe_config(native_tok, tmp)
    store = InMemoryStore(seed, DATASET_IMAGES)
    captions = recipe_captions(seed, store)
    loaded = {name: recipe_datasets(cfg, store, captions, tok)
              for name, tok in tokenizers.items()}
    workers = cfg.data.num_workers
    trainer = Trainer(cfg, build_model(cfg.model, seed, "cuda"),
                      loaded["native"])
    readings = []
    micro = []

    def on_step(orig):
        def step_once(kind, task):
            orig(kind, task)
            micro.append(2 if kind == "rel" else 1)
        return step_once

    def epoch(name):
        trainer.datasets = loaded[name]
        n0 = len(micro)
        torch.cuda.synchronize()
        t = time.perf_counter()
        trainer.train_epoch()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        trainer.epoch += 1
        trainer._close_iterators()
        readings.append({"tokenizer": name, "s": secs,
                         "micro_steps": sum(micro[n0:])})

    with patched(trainer, "step_once", on_step):
        epoch("native")     # warm-up
        readings.clear()
        for name in ("native", "python"):
            epoch(name)
    ms = {r["tokenizer"]: r["s"] * 1e3 / r["micro_steps"] for r in readings}
    alone = {f"{task[0]}_{name}": loader_records_per_s(ds[task], cfg,
                                                       workers)
             for name, ds in loaded.items() for task in sorted(ds)}
    del trainer
    torch.cuda.empty_cache()
    out = {"ms_per_micro_step": ms, "epochs_in_turns": readings,
           "loader_alone_records_per_s": alone, "read_threads": workers}
    log(f"[tokenizer] phase 15(b)'s recipe, one epoch each in turns "
        f"{[(r['tokenizer'], round(r['s'], 3)) for r in readings]}: ms a "
        f"micro-step {json.dumps(ms)}; the loader alone "
        f"{json.dumps(alone)} records/s ({workers} read threads)")
    return out


def preprocess_slice(tmp):
    """16(b): `cli.preprocess` on the card's machine: train-vocab native and
    python give the same model (pieces, and scores to the last bit);
    spm-to-tsv and binarize round-trip a `write_spm` file."""
    import numpy as np

    from m3p_tpu_torch.cli import preprocess
    from m3p_tpu_torch.tokenization.spm_reader import (
        TYPE_CONTROL, TYPE_NORMAL, TYPE_UNKNOWN, write_spm)
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer
    from m3p_tpu_torch.tokenization.unigram import UnigramModel

    rng = np.random.RandomState(16)
    corpus = os.path.join(tmp, "corpus.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        f.write("\n".join(sentence(rng, int(rng.randint(4, 20)))
                          for _ in range(400)))
    t0 = time.perf_counter()
    models = {}
    for impl in ("native", "python"):
        out = os.path.join(tmp, f"{impl}.tsv")
        preprocess.main(["train-vocab", corpus, "--out", out, "--size",
                         "300", "--impl", impl])
        models[impl] = UnigramModel.load(out)
    a, b = models["native"], models["python"]
    if a.pieces != b.pieces or a.scores != b.scores:
        fail("train-vocab native and python trained different models")
    pieces = ["<unk>", "<s>", "</s>"] + b.pieces
    types = [TYPE_UNKNOWN, TYPE_CONTROL, TYPE_CONTROL] + \
        [TYPE_NORMAL] * len(b.pieces)
    spm = os.path.join(tmp, "vocab.spm")
    write_spm(spm, pieces, [0.0] * 3 + b.scores, types)
    tsv = os.path.join(tmp, "from_spm.tsv")
    preprocess.main(["spm-to-tsv", spm, "--out", tsv])
    back, direct = UnigramModel.load(tsv), UnigramModel.load(spm)
    if (back.pieces, back.scores, back.types) != (
            direct.pieces, direct.scores, direct.types):
        fail("spm-to-tsv did not round-trip the write_spm file")
    stream = os.path.join(tmp, "stream.npy")
    preprocess.main(["binarize", corpus, "--vocab", tsv, "--out", stream])
    tok = XLMRTokenizer(spm)
    with open(corpus, encoding="utf-8") as f:
        want = [i for line in f for i in tok.encode(line.rstrip("\n"))[:512]
                + [2]]
    got = np.load(stream)
    if got.dtype != np.int32 or got.tolist() != want:
        fail("binarize over the converted TSV is not the .spm tokenizer's "
             "stream")
    out = {"pieces": len(a), "stream_ids": int(got.size),
           "s": time.perf_counter() - t0}
    log(f"[preprocess] train-vocab native == python ({len(a)} pieces, "
        f"scores to the bit); spm-to-tsv and binarize round-trip a "
        f"write_spm file ({got.size} ids); {out['s']:.2f} s")
    return out


def quant_cli_engine(argv, store, what):
    """`cli.serve.main(argv, store=..., serve=False)`, timed."""
    from m3p_tpu_torch.cli import serve

    t0 = time.perf_counter()
    engine = serve.main(argv, store=store, serve=False)
    log(f"[quant] {what}: the CLI built the engine in "
        f"{time.perf_counter() - t0:.2f} s")
    return engine


def counted_quant_call(what, fn, want_gate=None, per_call=None):
    """One call of phase 16's main path with its #1 launches and int8
    counts zeroed before and read after; fails unless #1 ran ``per_call``
    launches, all on the tensor cores, and (with ``want_gate``) the gate
    decided as given."""
    import torch

    from m3p_tpu_torch.ops import quant

    zero_launch_counts()
    quant.zero_counts()
    out = fn()
    torch.cuda.synchronize()
    counts, q = launch_counts(), quant_counts()
    if per_call is not None:
        check_launches(what, counts, expected_launches((per_call, 0)), 1)
    if want_gate is not None and q["gate"] != want_gate:
        fail(f"{what}: the int8 gate decided {q['gate']}; expected "
             f"{want_gate}")
    return out, {"packed_fwd": counts["packed_fwd"], **q}


def quant_serve_slice(seed, tokenizer, tmp):
    """16(c) and (d): `cli.serve --quant int8 --load_gallery N` over an
    InMemoryStore at the flagship width, bf16, random weights from
    ``seed`` saved as a checkpoint; /v1/score on both sides of the gate,
    /v1/retrieve and /v1/caption over HTTP, every call's #1 launches and
    int8 routes counted and each #1 launch at a held shape; the q8
    capture; then the same checkpoint without --quant: retrieval and
    caption agreement, ms in turns, the device ms of a decode step."""
    import numpy as np
    import torch

    from m3p_tpu_torch.model import build_model, capture_q8
    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.serve.server import make_server

    cfg = full_width_config("bfloat16")
    vocab = os.path.join(tmp, "serve_vocab.tsv")
    write_vocab(vocab, cfg.n_words - 2)
    ckpt = os.path.join(tmp, "flagship.pt")
    model = build_model(cfg, seed, "cuda")
    torch.save(model.state_dict(), ckpt)
    del model
    store = InMemoryStore(seed + 16, QUANT_GALLERY)
    # the CLI's model is the checkpoint's: one language (n_langs 2), the
    # flagship's widths, FFN 4 x 768
    argv = ["--reload_model", ckpt, "--vocab_path", vocab,
            "--emb_dim", str(cfg.emb_dim), "--n_layers", str(cfg.n_layers),
            "--n_heads", str(cfg.n_heads),
            "--refine_layers", str(cfg.refine_layers),
            "--max_region_num", str(cfg.max_region_num), "--lgs", "en",
            "--beam_size", str(GEN_BEAM), "--max_gen_len", str(GEN_LEN),
            "--warmup", "true", "--load_gallery", str(QUANT_GALLERY)]
    engine = quant_cli_engine(argv + ["--quant", "int8"], store,
                              "--quant int8 --load_gallery")
    if engine.device.type != "cuda" or engine.model.cfg.ffn_quant != \
            "int8_infer" or engine.stats()["gallery_size"] != QUANT_GALLERY:
        fail(f"the int8 CLI engine: {engine.stats()}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q8_bytes = capture_q8(engine.model)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    head = engine.model.pred_layer.q8_emb
    head_bytes = head.wq.nbytes + head.sw.nbytes
    log(f"[quant] q8 capture {capture_s:.3f} s, {q8_bytes} bytes on the "
        f"card ({head_bytes} the vocab table, {q8_bytes - head_bytes} the "
        f"{cfg.n_layers} blocks')")

    rng = np.random.RandomState(seed + 17)
    per_pass = cfg.n_layers + cfg.refine_layers
    int8_gemms = INT8_GEMMS_PER_BLOCK * cfg.n_layers
    calls = {}
    shapes = set()
    server, app = make_server(engine, host="127.0.0.1", port=0,
                              max_body_bytes=512 * 1024 * 1024)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with recorded_launch_shapes(shapes):
            # ---- the main path, counted call by call ----
            for n in QUANT_SCORE_PAIRS:
                texts = [sentence(rng, int(rng.randint(4, 12)))
                         for _ in range(n)]
                ids = [f"img{int(i)}" for i in rng.randint(0, 50, n)]
                rows = max(n, 1) * (REGIONS + QUANT_TEXT_BUCKET)
                want = ({"int8": int8_gemms, "plain": 0}
                        if rows <= quant.PREQUANT_MAX_M
                        else {"int8": 0, "plain": int8_gemms})
                scores, calls[f"score_{n}"] = counted_quant_call(
                    f"/v1/score {n} pair(s)", lambda: post(
                        base, "/v1/score", {"pairs": [
                            {"text": t, "image_id": i}
                            for t, i in zip(texts, ids)]})["scores"],
                    want, per_pass)
                if len(scores) != n or not np.isfinite(scores).all():
                    fail(f"/v1/score {n}: {scores}")
            query = sentence(rng, 6)
            res, calls["retrieve"] = counted_quant_call(
                "/v1/retrieve", lambda: post(base, "/v1/retrieve", {
                    "text": query, "top_k": 5})["results"],
                {"int8": 0, "plain": int8_gemms * -(-QUANT_GALLERY // 64)},
                per_pass * -(-QUANT_GALLERY // 64))
            vals = [r["score"] for r in res]
            if len(res) != 5 or vals != sorted(vals, reverse=True):
                fail(f"/v1/retrieve: {res}")
            imgs = [{"image_id": f"img{i}"}
                    for i in range(QUANT_CAPTION_IMAGES)]
            caps, calls["caption"] = counted_quant_call(
                f"/v1/caption beam {GEN_BEAM}", lambda: post(
                    base, "/v1/caption", {"images": imgs, "beam_size":
                                          GEN_BEAM})["captions"],
                None, per_pass)
            if len(caps) != QUANT_CAPTION_IMAGES:
                fail(f"/v1/caption: {len(caps)} captions")
            if calls["caption"]["int8_matmul_nt_pre"]["int8"] < 1:
                fail(f"the caption call's word head took no int8 GEMM: "
                     f"{calls['caption']}")
    finally:
        server.shutdown()
        server.server_close()
        app.close()
        thread.join(timeout=30)
    if thread.is_alive():
        fail("server thread did not stop")
    held = check_held_shapes("phase 16(c)", shapes)
    log(f"[quant] the main path call by call (#1 launches, the gate, the "
        f"int8 GEMM routes): {json.dumps(calls)}")

    # ---- (d) int8 against bf16, the same checkpoint ----
    plain = quant_cli_engine(argv, store, "without --quant")
    if plain.q8_bytes or plain.model.cfg.ffn_quant != "none":
        fail("the plain CLI engine holds int8 tables")
    compare = quant_vs_bf16(engine, plain, rng)
    server_numbers = {"q8_capture_s": capture_s, "q8_bytes": q8_bytes,
                      "q8_vocab_table_bytes": head_bytes, "calls": calls,
                      "launch_shapes": [list(s) for s in held]}
    return {**server_numbers, **compare}, engine, plain


def decode_step_fn(engine, imgs):
    """One beam-5 decode step at GEN_LEN cached positions over
    ``imgs``' source encoding: the blocks, the word head and the top-2K
    with the logsumexp (`time_decode_step`'s parts)."""
    import torch

    from m3p_tpu_torch.ops.topk import top_k

    model = engine.model
    feats, locs, mask = engine.image_batch(imgs)
    bk = feats.shape[0] * GEN_BEAM
    dev = feats.device
    with torch.inference_mode():
        enc = model.encode_image(feats, locs, mask, True)
        cache = model.init_decode_cache(enc, GEN_LEN, bk)
    tok = torch.full((bk, 1), 5, device=dev)
    pos = torch.full((bk, 1), 5, device=dev)
    step_mask = torch.ones((bk, 1), dtype=torch.bool, device=dev)

    def step():
        with torch.inference_mode():
            cache.pos = 5
            hidden = model.encode_text(tok, step_mask, None, pos,
                                       causal=True, src_enc=enc,
                                       src_mask=mask, cache=cache)
            logits = model.word_logits(hidden[:, 0]).float()
            return top_k(logits, 2 * GEN_BEAM), torch.logsumexp(logits, -1)
    return step


def quant_vs_bf16(q8, plain, rng):
    """16(d): retrieval top-1 and the largest score difference as a share
    of the score range, at the engine's chunk (above the gate: the same
    GEMMs) and at QUANT_INT8_CHUNK (int8); the share of caption tokens
    that agree; ms per /v1/score of 16 pairs and per caption call, int8
    and bf16 in turns; the device ms of one beam-5 decode step from a
    profile, each engine."""
    import numpy as np
    import torch

    queries = [sentence(rng, int(rng.randint(4, 12))) for _ in range(4)]
    retrieval = {}
    for chunk in (None, QUANT_INT8_CHUNK):
        saved = (q8.batch_buckets, plain.batch_buckets)
        if chunk is not None:
            q8.batch_buckets = plain.batch_buckets = tuple(
                b for b in saved[0] if b <= chunk)
        top1, worst, worst_abs, spans = 0, 0.0, 0.0, []
        for q in queries:
            a = {r["id"]: r["score"] for r in q8.retrieve(q, QUANT_GALLERY)}
            b = {r["id"]: r["score"] for r in plain.retrieve(q,
                                                             QUANT_GALLERY)}
            span = max(b.values()) - min(b.values())
            diff = max(abs(a[k] - b[k]) for k in b)
            top1 += max(a, key=a.get) == max(b, key=b.get)
            worst, worst_abs = max(worst, diff / span), max(worst_abs, diff)
            spans.append(span)
        q8.batch_buckets, plain.batch_buckets = saved
        retrieval["engine_chunk" if chunk is None else
                  f"chunk_{chunk}"] = {"top1_agree": top1,
                                       "queries": len(queries),
                                       "max_diff_share_of_range": worst,
                                       "max_abs_diff": worst_abs,
                                       "score_ranges": spans}
    if retrieval["engine_chunk"]["max_diff_share_of_range"] != 0.0:
        fail("retrieval above the gate differs between int8 and bf16")
    if retrieval[f"chunk_{QUANT_INT8_CHUNK}"]["top1_agree"] != len(queries):
        fail(f"int8 retrieval changed a query's best image: {retrieval}")
    imgs = [{"image_id": f"img{i}"} for i in range(QUANT_CAPTION_IMAGES)]
    toks, lens = {}, {}
    for name, e in (("int8", q8), ("bf16", plain)):
        with torch.inference_mode():
            feats, locs, mask = e.image_batch(imgs)
            enc = e.model.encode_image(feats, locs, mask, True)
            toks[name], lens[name] = e._generate(enc, mask, GEN_BEAM,
                                                 GEN_LEN, None)
    # the tokens after the start token, up to the longer caption of a row
    span = np.maximum(lens["int8"], lens["bf16"])
    pos = np.arange(toks["int8"].shape[1])[None, :]
    live = (pos >= 1) & (pos < span[:, None])
    agree = float((toks["int8"] == toks["bf16"])[live].mean())
    texts = [sentence(rng, int(rng.randint(4, 12))) for _ in range(16)]
    pairs = [{"image_id": f"img{i}"} for i in range(16)]
    turns = []
    for name, e in (("int8", q8), ("bf16", plain), ("bf16", plain),
                    ("int8", q8)):
        score_ms = cuda_ms(lambda: e.score(texts, pairs), iters=10,
                           warmup=2)
        caption_ms = cuda_ms(lambda: e.caption(imgs), iters=2, warmup=1)
        turns.append({"engine": name, "score_16_ms": score_ms,
                      "caption_ms": caption_ms})
    ms = {name: {k: float(np.mean([t[k] for t in turns
                                   if t["engine"] == name]))
                 for k in ("score_16_ms", "caption_ms")}
          for name in ("int8", "bf16")}
    step = {name: profile_window(f"a beam-{GEN_BEAM} decode step, {name}",
                                 decode_step_fn(e, imgs), reps=2)
            for name, e in (("int8", q8), ("bf16", plain))}
    out = {"retrieval": retrieval, "caption_token_agreement": agree,
           "ms_in_turns": turns, "ms": ms,
           "decode_step_device_ms": {n: s.get("device_busy_ms")
                                     for n, s in step.items()},
           "decode_step_groups_ms": {n: s.get("groups_ms")
                                     for n, s in step.items()}}
    log(f"[quant] int8 vs bf16: retrieval {json.dumps(retrieval)}; caption "
        f"tokens agree {agree:.4f}; ms {json.dumps(ms)}; a decode step's "
        f"device ms {json.dumps(out['decode_step_device_ms'])}")
    return out


def quant_fp32_vs_cpu(seed, tokenizer):
    """16(e): the int8 model in fp32 at depth 2 on the card against the
    CPU: `encode_joint` of QUANT_FP32_B pairs and `word_logits` of their
    first tokens.  Each int8 GEMM's quantized activations and int32
    accumulators are recorded on the card.  The CPU runs twice: free (the
    share of activations quantized alike, GEMM by GEMM, and the outputs'
    distance: a float sum in another order moves an activation across a
    rounding boundary of its int8 step now and then, and the moved step
    moves every later activation) and with each GEMM handed the card's
    quantized activations, where its accumulators must equal the card's
    bit for bit and the outputs agree within TOL_INT8_FP32."""
    import numpy as np
    import torch

    from m3p_tpu_torch.model import capture_q8
    from m3p_tpu_torch.model.transformer import lengths_to_mask
    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.tokenization.tokenizer import batch_sentences

    t0 = time.perf_counter()
    cfg = dataclasses.replace(full_width_config("float32"), n_layers=2,
                              ffn_quant="int8_infer",
                              head_quant="int8_infer")
    cpu = cpu_model_from_card(cfg, seed)
    card = copy.deepcopy(cpu).to("cuda")
    capture_q8(cpu)
    capture_q8(card)
    rng = np.random.RandomState(seed + 18)
    ids = tokenizer.encode_batch([sentence(rng, n) for n in (5, 11)],
                                 max_ids=QUANT_TEXT_BUCKET - 2)
    toks, lens, _ = batch_sentences(ids, max_len=QUANT_TEXT_BUCKET)
    imgs = eval_images(rng, QUANT_FP32_B)
    gemm = quant._int_gemm

    def run(model, dev, forced=None):
        rec = []

        def recording(xq, wq, entry):
            if forced is not None:
                given = forced[len(rec)][0]
                if given.shape != xq.shape:
                    fail(f"int8 GEMM {len(rec)}: activations {xq.shape} on "
                         f"the CPU, {given.shape} on the card")
                xq = given.to(xq.device)
            acc = gemm(xq, wq, entry)
            rec.append((xq.cpu(), acc.cpu()))
            return acc

        t = torch.from_numpy(toks).long().to(dev)
        tmask = lengths_to_mask(torch.from_numpy(lens).long().to(dev),
                                toks.shape[1])
        f = torch.from_numpy(imgs["feats"]).to(dev)
        lo = torch.from_numpy(imgs["locs"]).to(dev)
        im = lengths_to_mask(torch.from_numpy(imgs["img_len"]).to(dev),
                             REGIONS)
        quant._int_gemm = recording
        try:
            with torch.inference_mode():
                h = model.encode_joint(t, tmask, f, lo, im, True)
                logits = model.word_logits(h[:, 0])
        finally:
            quant._int_gemm = gemm
        return h.cpu(), logits.cpu(), rec

    quant.zero_counts()
    with recorded_launch_shapes(set()) as shapes:
        h_card, l_card, rec_card = run(card, "cuda")
    check_held_shapes("phase 16(e)", shapes)
    routes = dict(quant.int8_matmul_pre.calls_by_route)
    head_routes = dict(quant.int8_matmul_nt_pre.calls_by_route)
    h_free, l_free, rec_free = run(cpu, "cpu")
    h_cpu, l_cpu, rec_cpu = run(cpu, "cpu", forced=rec_card)
    if not rec_card or not len(rec_card) == len(rec_free) == len(rec_cpu):
        fail(f"int8 GEMMs: {len(rec_card)} on the card, {len(rec_free)} / "
             f"{len(rec_cpu)} on the CPU")
    for i, ((_, acc_d), (_, acc_c)) in enumerate(zip(rec_card, rec_cpu)):
        if not torch.equal(acc_d, acc_c):
            fail(f"int8 GEMM {i}: the card's int32 accumulators are not the "
                 f"CPU's over the same quantized activations")
    alike = [float((a == b).float().mean())
             for (a, _), (b, _) in zip(rec_card, rec_free)]
    h_diff = float((h_card - h_cpu).abs().max())
    l_diff = float((l_card - l_cpu).abs().max())
    out = {"int8_gemms": len(rec_card), "accumulators_equal": True,
           "free_run_activations_alike_by_gemm": alike,
           "free_run_hidden_max_abs_diff": float(
               (h_card - h_free).abs().max()),
           "free_run_logits_max_abs_diff": float(
               (l_card - l_free).abs().max()),
           "hidden_max_abs_diff": h_diff, "logits_max_abs_diff": l_diff,
           "tolerance": TOL_INT8_FP32, "routes": routes,
           "head_routes": head_routes, "s": time.perf_counter() - t0}
    log(f"[quant] fp32 depth 2, card vs CPU: {len(rec_card)} int8 GEMMs; "
        f"with the card's quantized activations the CPU's accumulators "
        f"equal the card's and the outputs differ by {h_diff:.3e} (hidden) "
        f"/ {l_diff:.3e} (logits), tolerance {TOL_INT8_FP32}; free, the "
        f"activations quantized alike GEMM by GEMM "
        f"{[round(a, 6) for a in alike]}, outputs "
        f"{out['free_run_hidden_max_abs_diff']:.3e} / "
        f"{out['free_run_logits_max_abs_diff']:.3e}; routes {routes}, head "
        f"{head_routes}")
    if not (torch.isfinite(h_card).all() and torch.isfinite(l_card).all()):
        fail("the int8 fp32 model gave non-finite values on the card")
    if max(h_diff, l_diff) > TOL_INT8_FP32:
        fail("the int8 fp32 model on the card disagrees with the CPU")
    return out


def quant_eval_slice(seed, model, tokenizer, tmp):
    """16(f): one caption-eval family through `Evaluator` with
    ``eval.quant="int8"`` over the flagship bf16 model: the generation
    model holds int8 tables, its int8 GEMMs run, #1 launches 15 a batch."""
    import torch

    from m3p_tpu_torch.eval.evaluator import Evaluator

    cfg = model.cfg
    data = eval_gen_data(seed + 19, tokenizer, cfg.n_words,
                         b=QUANT_CAPTION_IMAGES, caption_batches=1)
    ev = Evaluator(model, eval_config(cfg, tmp, quant="int8"))
    t0 = time.perf_counter()
    with recorded_launch_shapes(set()) as shapes:
        scores, counts = counted_quant_call(
            "caption eval, eval.quant int8",
            lambda: ev.run_all_evals({"caption_gen": data["caption_gen"]}),
            None, cfg.n_layers + cfg.refine_layers)
    secs = time.perf_counter() - t0
    check_held_shapes("phase 16(f)", shapes)
    if ev.gen_model is ev.model or counts["gate"]["int8"] == 0 or \
            counts["int8_matmul_nt_pre"]["int8"] == 0:
        fail(f"the int8 caption eval ran no int8 GEMM: {counts}")
    if "caption_bleu" not in scores:
        fail(f"int8 caption eval: {scores}")
    del ev
    torch.cuda.empty_cache()
    log(f"[quant] caption eval with eval.quant int8: {json.dumps(scores)} "
        f"in {secs:.2f} s; {json.dumps(counts)}")
    return {"scores": scores, "s": secs, "counts": counts}


def quant_slice(seed, tokenizer):
    """Phase 16: (a) the native tokenizer, (b) `cli.preprocess`, (c) and
    (d) `cli.serve --quant int8` over a store against bf16, (e) the int8
    fp32 model card vs CPU, (f) an int8 caption eval; the temporary
    directory removed at the end."""
    import shutil

    import torch

    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="m3p_quant_")
    out = {}
    part_s = {}

    def lap(name):
        part_s[name] = time.time() - t0 - sum(part_s.values())

    try:
        out["tokenizer"], nat, py = tokenizer_slice(seed, tmp)
        lap("tokenizer")
        out["tokenizer"]["recipe"] = tokenizer_recipe_turns(
            seed, {"native": nat, "python": py}, tmp)
        torch.cuda.empty_cache()
        lap("recipe_in_turns")
        out["preprocess"] = preprocess_slice(tmp)
        lap("preprocess")
        out["serve"], q8, plain = quant_serve_slice(seed, tokenizer, tmp)
        del q8
        torch.cuda.empty_cache()
        lap("serve")
        out["eval"] = quant_eval_slice(seed, plain.model, tokenizer, tmp)
        del plain
        torch.cuda.empty_cache()
        lap("eval")
        out["fp32_card_vs_cpu"] = quant_fp32_vs_cpu(seed, tokenizer)
        lap("fp32_card_vs_cpu")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["part_s"] = part_s
    out["phase_s"] = time.time() - t0
    log(f"[quant] phase 16: {out['phase_s']:.1f} s: {json.dumps(part_s)}")
    return out


# ---------------------------------------------------------------------------
# phase 17: the int8 training modes and the single-card model variants
# ---------------------------------------------------------------------------

# (a) the training GEMMs on the card against the CPU, bf16: (function, M,
# K, N), x (M, K) and w (K, N), or (N, K) for the nt head.  13120 is the
# MCT step's BN x S tokens, 320 its packed MLM slots; 16 rows take the
# CUDA rule's row padding, 1001 tokens a wgrad contraction off the
# multiple of 8, the 250,002 words a head whose dgrad contracts over V
TRAIN_GEMM_CASES = (
    ("int8_matmul_qbwd", 13120, 768, 3072),
    ("int8_matmul_qbwd", 13120, 3072, 768),
    ("int8_matmul_qbwd", 16, 768, 3072),
    ("int8_matmul_qbwd", 1001, 768, 3072),
    ("int8_matmul", 1001, 768, 3072),
    ("int8_matmul_nt", 320, 768, 250002),
)
# the CPU recomputes about this many multiply-adds of each GEMM's int32
# accumulator from the card's quantized operands (at least 16 rows, at
# most 256): its int8 GEMM runs about 10 GMAC/s, the whole set would take
# about 40 s
TRAIN_GEMM_CHECK_MACS = 2e9
# (b) windows of the MCT step in turns: warm-up and timed steps each
# (half of (2, 10), whose windows took 64 s on an H100 80GB HBM3 at 700 W,
# to leave room for phase 18)
INT8_TURN_STEPS = (1, 2)
# the int8 GEMMs an encode makes: 12 blocks x 2 FFN GEMMs forward, two
# each backward
INT8_FFN_FWD, INT8_FFN_BWD = 24, 48
# (d) the MoE variant: 4 experts (tests/test_moe.py::test_moe_model_trains)
# on every 2nd block at capacity factor 2.0 (the CLI's defaults)
MOE = dict(moe_experts=4, moe_interval=2, moe_capacity_factor=2.0)
# (e) the asm head's log-probabilities come back in bf16: each rounds by up
# to 2^-9 of its size (about 12 at 250,002 words), so their logsumexp
# lies within this of 0; in fp32 within TOL_ASM_FP32
TOL_ASM_BF16 = 0.05
TOL_ASM_FP32 = 1e-4
# (f) the latent modules at the flagship width in fp32, card vs CPU
LATENT_SHAPE = (4, 164, 768)
ZERO_GRAD_CROSS_ALIGN = ("att_weight_c.weight", "att_weight_c.bias",
                         "att_weight_q.bias")
# (g) the grid tool's pool: 16 images x 64 captions, two 512-pair chunks
P17_GRID = ("16", "64", "512")


def p17_counts():
    """The #1/#2 launch counts and the training int8 GEMM counts."""
    from m3p_tpu_torch.ops import quant

    return {**launch_counts(), **{
        name: {"calls_by_pass": dict(getattr(quant, name).calls_by_pass),
               "calls_by_route": dict(getattr(quant, name).calls_by_route)}
        for name in ("int8_matmul", "int8_matmul_qbwd", "int8_matmul_nt")}}


def zero_p17_counts():
    from m3p_tpu_torch.ops import quant

    zero_launch_counts()
    quant.zero_counts()


def check_int8_calls(what, counts, want, n_steps=1):
    """``want`` {function: (forward, backward) GEMMs a step}: each call
    counted so, none on the CPU route."""
    for name in ("int8_matmul", "int8_matmul_qbwd", "int8_matmul_nt"):
        fwd, bwd = want.get(name, (0, 0))
        got = counts[name]
        if got["calls_by_pass"] != {"fwd": fwd * n_steps,
                                    "bwd": bwd * n_steps}:
            fail(f"{what}: {name} made {got['calls_by_pass']} int8 GEMMs in "
                 f"{n_steps} step(s); expected ({fwd}, {bwd}) a step")
        if got["calls_by_route"]["cpu"]:
            fail(f"{what}: {name} ran an int8 GEMM on the CPU route")


def train_gemms_vs_cpu(seed):
    """17(a): each training GEMM forward and backward on the card, then on
    the CPU from the same bf16 inputs.  Each CPU GEMM checks that its
    quantized operands equal the card's (bitwise), recomputes a share of
    the card's int32 accumulator from them (`TRAIN_GEMM_CHECK_MACS`) and
    must find it equal, then carries on with the card's accumulator; the
    outputs and the int8 gradients must then equal the card's bit for bit,
    the straight-through float gradients within TOL_BF16."""
    import torch

    from m3p_tpu_torch.ops import quant

    gemm = quant._gemm_nt
    out = {}
    t0 = time.time()
    for name, m, k, n in TRAIN_GEMM_CASES:
        fn = getattr(quant, name)
        gen = torch.Generator().manual_seed(seed + m + n)
        x = (torch.randn(m, k, generator=gen) * 2).to(torch.bfloat16)
        w = (torch.randn(*((n, k) if name == "int8_matmul_nt" else (k, n)),
                         generator=gen) * 0.05).to(torch.bfloat16)
        g = torch.randn(m, n, generator=gen).to(torch.bfloat16)
        card_ops = []
        checked = []

        def on_card(qa, qb, entry, padded, pass_):
            acc = gemm(qa, qb, entry, padded, pass_)
            card_ops.append((qa, qb, acc))
            return acc

        def on_cpu(qa, qb, entry, padded, pass_):
            i = len(checked)
            cqa, cqb, cacc = card_ops[i]
            if not (torch.equal(qa, cqa.cpu()) and torch.equal(qb,
                                                               cqb.cpu())):
                fail(f"17(a) {name} {m}x{k}x{n}: int8 GEMM {i}'s quantized "
                     f"operands differ between the card and the CPU")
            r = max(16, min(256, int(TRAIN_GEMM_CHECK_MACS
                                     / (qa.shape[1] * qb.shape[0]))))
            rows = torch.unique(torch.linspace(0, qa.shape[0] - 1, r)
                                .round().long())
            acc = cacc.cpu()
            if not torch.equal(torch._int_mm(qa[rows], qb.t()), acc[rows]):
                fail(f"17(a) {name} {m}x{k}x{n}: int8 GEMM {i}'s int32 "
                     f"accumulators differ between the card and the CPU")
            checked.append(len(rows))
            entry.calls += 1
            entry.calls_by_route["cpu"] += 1
            entry.calls_by_pass[pass_] += 1
            return acc

        results = []
        for dev, wrapper in (("cuda", on_card), ("cpu", on_cpu)):
            xd = x.to(dev).requires_grad_()
            wd = w.to(dev).requires_grad_()
            quant.zero_counts()
            quant._gemm_nt = wrapper
            try:
                y = fn(xd, wd)
                y.backward(g.to(dev))
            finally:
                quant._gemm_nt = gemm
            if dev == "cuda":
                torch.cuda.synchronize()
                routes = dict(fn.calls_by_route)
            results.append([t.detach().cpu() for t in (y, xd.grad, wd.grad)])
        (y_d, dx_d, dw_d), (y_c, dx_c, dw_c) = results
        if not torch.equal(y_d, y_c):
            fail(f"17(a) {name} {m}x{k}x{n}: the outputs differ")
        if name == "int8_matmul":
            for a, b in ((dx_d, dx_c), (dw_d, dw_c)):
                _compare(a.float(), b.float(), TOL_BF16,
                         f"17(a) {name} straight-through gradient")
        elif not (torch.equal(dx_d, dx_c) and torch.equal(dw_d, dw_c)):
            fail(f"17(a) {name} {m}x{k}x{n}: the int8 gradients differ")
        if routes["cpu"] or routes["int8"] + routes["int8_pad"] != len(
                card_ops):
            fail(f"17(a) {name}: routes {routes} for {len(card_ops)} GEMMs")
        key = f"{name}_{m}x{k}x{n}"
        out[key] = {"gemms": len(card_ops), "routes": routes,
                    "accumulator_rows_checked": checked,
                    "st_dx_max_abs_diff": float((dx_d.float()
                                                 - dx_c.float()).abs().max())}
        log(f"[int8 train] 17(a) {key}: {len(card_ops)} int8 GEMMs on the "
            f"card, routes {routes}; operands equal, accumulators equal on "
            f"{checked} rows, outputs bit for bit, gradients "
            + ("within TOL_BF16" if name == "int8_matmul"
               else "bit for bit"))
        del card_ops
        torch.cuda.empty_cache()
    out["s"] = time.time() - t0
    return out


def mct_int8_turns(seed, fused):
    """17(b): `m3p_tpu_torch.bench`'s MCT step under bench.py's
    ``int8_bwd`` and with the float FFN (``none``, a `shared_variant` over
    the same parameters and optimizer state) in turns none, int8, int8,
    none (`INT8_TURN_STEPS` each), configuration A or B (``fused``):
    samples/s, step ms, MFU, peak memory; #1/#2 (#7/#8) launches and int8
    GEMMs by route per step; a profile of one step of each.  Returns
    (numbers, state, gens, batch) for 17(c)."""
    import numpy as np

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.model import shared_variant

    label = "B" if fused else "A"
    cfg = bench.bench_config(fused_dropout=fused)
    state, step, gens = bench.setup(cfg, seed, "cuda")
    batch = bench.make_batch(0, "cuda")
    models = {"int8_bwd": state.model,
              "none": shared_variant(state.model, ffn_quant="none")}
    per_step = mct_per_step(cfg)
    warmup, steps = INT8_TURN_STEPS
    n_steps = warmup + steps
    readings = {"none": [], "int8_bwd": []}
    counts = {}
    launches = dict.fromkeys(per_step, 0)
    for mode in ("none", "int8_bwd", "int8_bwd", "none"):
        state.model = models[mode]
        zero_p17_counts()
        r = bench.run(state, step, batch, gens, warmup, steps)
        c = p17_counts()
        check_launches(f"MCT {label} {mode}", {k: c[k] for k in per_step},
                       per_step, n_steps)
        want = ({"int8_matmul_qbwd": (INT8_FFN_FWD, INT8_FFN_BWD)}
                if mode == "int8_bwd" else {})
        check_int8_calls(f"MCT {label} {mode}", c, want, n_steps)
        if not np.isfinite(r["losses"]).all():
            fail(f"MCT {label} {mode}: non-finite loss {r['losses']}")
        readings[mode].append({k: r[k] for k in ("step_ms", "peak_memory_gb",
                                                 "wall_step_ms")})
        counts[mode] = c
        for k in launches:
            launches[k] += c[k]
    flops = bench.mct_step_flops(cfg, r["bn"])
    numbers = {}
    for mode, rs in readings.items():
        ms = sum(x["step_ms"] for x in rs) / len(rs)
        numbers[mode] = {
            "step_ms": ms, "samples_per_s": r["bn"] / (ms / 1e3),
            "mfu": flops / (ms / 1e3) / BF16_FLOPS_PER_S,
            "peak_memory_gb": max(x["peak_memory_gb"] for x in rs),
            "readings": rs,
            "int8_gemms_per_step": {
                "fwd": counts[mode]["int8_matmul_qbwd"]["calls_by_pass"][
                    "fwd"] / n_steps,
                "bwd": counts[mode]["int8_matmul_qbwd"]["calls_by_pass"][
                    "bwd"] / n_steps,
                "routes": {k: v / n_steps for k, v in counts[mode][
                    "int8_matmul_qbwd"]["calls_by_route"].items()}},
            "packed_per_step": {k: counts[mode][k] / n_steps
                                for k in ("packed_fwd", "packed_bwd")}}
        state.model = models[mode]
        numbers[mode]["profile"] = profile_window(
            f"one MCT step {label} {mode}", lambda: step(state, batch, gens),
            reps=1)
    numbers["int8_over_none_step_ms"] = (numbers["int8_bwd"]["step_ms"]
                                         / numbers["none"]["step_ms"])
    numbers["flops_per_step"] = flops
    numbers["launches"] = launches
    log(f"[int8 train] 17(b) MCT {label} at BN={r['bn']}, none / int8_bwd "
        f"in turns: {numbers['none']['step_ms']:.2f} / "
        f"{numbers['int8_bwd']['step_ms']:.2f} ms a step (int8/none "
        f"{numbers['int8_over_none_step_ms']:.4f}), "
        f"{numbers['none']['samples_per_s']:.1f} / "
        f"{numbers['int8_bwd']['samples_per_s']:.1f} samples/s, MFU "
        f"{numbers['none']['mfu']:.4f} / {numbers['int8_bwd']['mfu']:.4f}, "
        f"peak {numbers['none']['peak_memory_gb']:.2f} / "
        f"{numbers['int8_bwd']['peak_memory_gb']:.2f} GB; int8 GEMMs a step "
        f"{numbers['int8_bwd']['int8_gemms_per_step']}; #1/#2 a step "
        f"{numbers['int8_bwd']['packed_per_step']}")
    state.model = models["int8_bwd"]
    return numbers, state, gens, batch


def int8_modes_steps(state, gens, batch):
    """17(c): one counted MCT step each under ``ffn_quant="int8"``,
    ``"int8_all"`` and ``head_quant="int8_bwd"`` on 17(b)'s model and
    state (`shared_variant`s): routes and launches; under "int8_all" each
    block's self-attention projects through the fused int8 QKV (one more
    int8 GEMM forward and two backward a block) and still feeds #1/#2 on
    the tensor cores."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.model import shared_variant

    base = state.model
    cfg = base.cfg
    per_step = mct_per_step(cfg)
    blocks = cfg.n_layers
    modes = {
        "int8": (dict(ffn_quant="int8"), {"int8_matmul": (INT8_FFN_FWD, 0)}),
        "int8_all": (dict(ffn_quant="int8_all"), {"int8_matmul_qbwd": (
            INT8_FFN_FWD + blocks, INT8_FFN_BWD + 2 * blocks)}),
        "head_int8_bwd": (dict(head_quant="int8_bwd"), {
            "int8_matmul_qbwd": (INT8_FFN_FWD, INT8_FFN_BWD),
            "int8_matmul_nt": (1, 2)}),
    }
    out = {}
    for mode, (change, want) in modes.items():
        state.model = shared_variant(base, **change)
        step = bench.make_step(state.model.cfg)
        zero_p17_counts()
        state, m = step(state, batch, gens)
        torch.cuda.synchronize()
        c = p17_counts()
        check_launches(f"MCT {mode}", {k: c[k] for k in per_step}, per_step,
                       1)
        check_int8_calls(f"MCT {mode}", c, want)
        if not torch.isfinite(m["loss"]):
            fail(f"MCT {mode}: non-finite loss")
        out[mode] = {"loss": m["loss"].item(),
                     "packed": {k: c[k] for k in ("packed_fwd",
                                                  "packed_fwd_tensor_cores",
                                                  "packed_bwd",
                                                  "packed_bwd_tensor_cores")},
                     **{name: c[name] for name in want}}
        log(f"[int8 train] 17(c) one MCT step {mode}: "
            f"{json.dumps(out[mode])}")
    state.model = base
    return out


def int8_learning_check(seed, steps=30):
    """17(b): depth 2 at full width under ``int8_bwd``, BN = 80, one batch,
    coin and masking, FusedAdam at lr 1e-4: the mean loss of the last 5
    steps below that of the first 5."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.train.steps import mct_draws

    cfg = bench.bench_config(fused_dropout=True, n_layers=2)
    state, _, gens = bench.setup(
        cfg, seed + 3, "cuda", spec="adam,lr=0.0001,fused=1,"
        "mu_dtype=bfloat16,nu_dtype=bfloat16,master=1")
    batch = bench.make_batch(seed + 3, "cuda")
    step = bench.make_step(cfg, **mct_draws(gens.device, batch,
                                            bench.mask_config(cfg)))
    losses = []
    for _ in range(steps):
        state, m = step(state, batch, gens)
        losses.append(m["loss"])
    losses = torch.stack(losses).float().cpu()
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    log(f"[int8 train] 17(b) learning, depth 2, int8_bwd, {steps} steps: "
        f"mean loss of the first 5 {first:.4f}, of the last 5 {last:.4f}")
    if not torch.isfinite(losses).all() or not last < first:
        fail(f"the int8_bwd MCT model did not learn: {losses.tolist()}")
    return {"first5": first, "last5": last}


def timed_variant_steps(what, cfg, seed, n=(1, 2)):
    """`bench.run` of ``n`` (warm-up, timed) MCT steps of ``cfg`` at BN =
    80, its launches checked (15 #1, 30 #2 a step): (numbers, state,
    gens)."""
    import numpy as np

    from m3p_tpu_torch import bench

    state, step, gens = bench.setup(cfg, seed, "cuda")
    batch = bench.make_batch(0, "cuda")
    per_step = mct_per_step(cfg)
    zero_p17_counts()
    r = bench.run(state, step, batch, gens, *n)
    c = p17_counts()
    check_launches(what, {k: c[k] for k in per_step}, per_step, sum(n))
    if not np.isfinite(r["losses"]).all():
        fail(f"{what}: non-finite loss {r['losses']}")
    numbers = {k: r[k] for k in ("step_ms", "samples_per_s", "wall_step_ms",
                                 "peak_memory_gb")}
    numbers["launches"] = {k: c[k] for k in per_step}
    numbers["loss_last"] = r["losses"][-1]
    log(f"[variants] {what}: {numbers['step_ms']:.2f} ms a step, "
        f"{numbers['samples_per_s']:.1f} samples/s, peak "
        f"{numbers['peak_memory_gb']:.2f} GB, launches {numbers['launches']}")
    return numbers, state, gens


def variant_fp32_vs_cpu(seed, what, **change):
    """``mct_pretrain_loss`` and its gradients in fp32 at depth 2 and full
    width, dropout 0, on the card and on the CPU with one coin and
    masking: the loss within 1e-4, every leaf within TOL_GRAD_FP32 of its
    largest entry.  Under MoE the CPU takes the card's expert choices
    (`ops.topk.top_k`'s indices, handed over as 16(e) hands over the int8
    activations); a free CPU run reports how many choices differ."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.model import layers
    from m3p_tpu_torch.train.steps import mct_draws, mct_pretrain_loss

    cfg = bench.bench_config(n_layers=2, dtype="float32", rate=0.0,
                             ffn_quant="none")
    cfg = dataclasses.replace(cfg, **change)
    cpu = cpu_model_from_card(cfg, seed)
    card = copy.deepcopy(cpu).to("cuda")
    batch = bench.make_batch(seed + 2, "cpu", groups=2)
    draws = mct_draws(torch.Generator().manual_seed(seed), batch,
                      bench.mask_config(cfg))
    top_k = layers.top_k

    def run(model, dev, forced=None):
        chosen = []

        def choosing(values, k):
            vals, idx = top_k(values, k)
            if forced is not None:
                idx = forced[len(chosen)].to(idx.device)
                vals = values.gather(-1, idx)
            chosen.append(idx.cpu())
            return vals, idx

        model.zero_grad(set_to_none=True)
        moved = {key: ([t.to(dev) for t in v] if isinstance(v, (list, tuple))
                       else v.to(dev)) for key, v in draws.items()}
        layers.top_k = choosing
        try:
            loss, _ = mct_pretrain_loss(
                model, {key: t.to(dev) for key, t in batch.items()}, None,
                bench.mask_config(cfg), bench.SAMPLE_N, deterministic=True,
                pack_ratio=bench.PACK_RATIO, **moved)
            loss.backward()
        finally:
            layers.top_k = top_k
        return loss.item(), chosen

    loss_d, chosen_d = run(card, "cuda")
    _, chosen_free = run(cpu, "cpu")
    differ = sum(int((a.sort(-1).values != b.sort(-1).values).sum())
                 for a, b in zip(chosen_d, chosen_free))
    loss_c, _ = run(cpu, "cpu", forced=chosen_d)
    worst, worst_name, leaves = worst_grad_diff(card, cpu)
    log(f"[variants] {what} fp32 depth 2: loss card {loss_d:.6f} vs CPU "
        f"{loss_c:.6f}; {leaves} leaves, max relative |card - CPU| "
        f"{worst:.3e} ({worst_name}; tolerance {TOL_GRAD_FP32}); expert "
        f"choices differing in a free CPU run: {differ} of "
        f"{sum(c.numel() for c in chosen_d)}")
    if worst > TOL_GRAD_FP32 or abs(loss_d - loss_c) > 1e-4:
        fail(f"{what}: fp32 gradients on the card disagree with the CPU")
    return {"loss_card": loss_d, "loss_cpu": loss_c, "worst_rel": worst,
            "worst_leaf": worst_name, "leaves": leaves,
            "free_run_choices_differing": differ}


def moe_slice(seed):
    """17(d): the MCT step with MoE blocks (`MOE`) at the flagship width,
    bench.py's configuration otherwise: step ms, peak memory, launches; a
    causal call refused; fp32 card vs CPU at depth 2."""
    import torch

    from m3p_tpu_torch import bench

    cfg = dataclasses.replace(bench.bench_config(), **MOE)
    out, state, _ = timed_variant_steps("17(d) MCT with MoE", cfg, seed)
    model = state.model
    if sum(b.moe_ffn is not None for b in model.blocks) != \
            cfg.n_layers // cfg.moe_interval:
        fail("17(d): the MoE blocks are not every 2nd block")
    toks = torch.zeros(2, 8, dtype=torch.long, device="cuda")
    try:
        model.encode_text(toks, torch.ones_like(toks, dtype=torch.bool),
                          causal=True)
    except ValueError as exc:
        out["causal_refused"] = str(exc)
    else:
        fail("17(d): a causal call through MoE blocks did not raise")
    del state, model
    torch.cuda.empty_cache()
    out["fp32_card_vs_cpu"] = variant_fp32_vs_cpu(seed, "17(d) MoE", **MOE)
    return out


def asm_slice(seed):
    """17(e): the MCT step with the adaptive softmax head (``asm``, the
    default cutoffs 8000 / 20000), one greedy caption call through it, the
    log-probabilities' logsumexp about 0 on the card; fp32 card vs CPU at
    depth 2."""
    import numpy as np
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.model.generation import greedy_generate
    from m3p_tpu_torch.model.transformer import lengths_to_mask

    cfg = dataclasses.replace(bench.bench_config(), asm=True)
    out, state, _ = timed_variant_steps("17(e) MCT with asm", cfg, seed)
    model = state.model.eval()
    rng = np.random.RandomState(seed + 17)
    imgs = eval_images(rng, 16)
    feats = torch.from_numpy(imgs["feats"]).cuda()
    locs = torch.from_numpy(imgs["locs"]).cuda()
    mask = lengths_to_mask(torch.from_numpy(imgs["img_len"]).cuda(), REGIONS)
    zero_p17_counts()
    with torch.inference_mode():
        enc = model.encode_image(feats, locs, mask, refine_image=True)
        toks, lens = greedy_generate(model, enc, mask, 20)
        lp = model.word_logits(enc[:, :4])
    torch.cuda.synchronize()
    c = launch_counts()
    lse = torch.logsumexp(lp.float(), dim=-1)
    out["caption"] = {"tokens_shape": list(toks.shape),
                      "mean_length": lens.float().mean().item(),
                      "packed_fwd": c["packed_fwd"],
                      "logsumexp_max_abs": lse.abs().max().item()}
    log(f"[variants] 17(e) greedy caption of 16 images through the asm "
        f"head: {out['caption']}")
    if (c["packed_fwd"] != c["packed_fwd_tensor_cores"]
            or c["packed_fwd"] != model.cfg.n_layers + model.cfg.refine_layers):
        fail(f"17(e): the caption call's #1 launches {c}")
    if not torch.isfinite(lp).all() or out["caption"][
            "logsumexp_max_abs"] > TOL_ASM_BF16:
        fail("17(e): the asm log-probabilities are not normalized")
    del state, model
    torch.cuda.empty_cache()
    out["fp32_card_vs_cpu"] = variant_fp32_vs_cpu(seed, "17(e) asm",
                                                  asm=True)
    return out


def fusion_and_latent_slice(seed):
    """17(f): ``encode_text`` with ``image_enc`` (the flagship width, bf16,
    dropout 0.1) forward and backward on the card; `CrossAlignMatrix`,
    `VaeEncoder` (both branches, the noise from one CPU generator on both
    sides) and `LatentDecoder` in fp32 on the card against the CPU."""
    import numpy as np
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.model.misc import (
        CrossAlignMatrix, LatentDecoder, VaeEncoder)
    from m3p_tpu_torch.model.transformer import lengths_to_mask

    cfg = dataclasses.replace(bench.bench_config(), image_fusion=True)
    model = build_model(cfg, seed, "cuda").train()
    rng = np.random.RandomState(seed + 19)
    imgs = eval_images(rng, 16)
    feats = torch.from_numpy(imgs["feats"]).cuda()
    locs = torch.from_numpy(imgs["locs"]).cuda()
    img_mask = lengths_to_mask(torch.from_numpy(imgs["img_len"]).cuda(),
                               REGIONS)
    toks = torch.from_numpy(rng.randint(5, cfg.n_words, (16, TEXT_LEN))
                            ).cuda()
    text_mask = lengths_to_mask(torch.from_numpy(
        rng.randint(8, TEXT_LEN, 16)).cuda(), TEXT_LEN)
    gens = Generators.from_seed(seed, "cuda")
    zero_p17_counts()
    enc = model.encode_image(feats, locs, img_mask, True, False, gens)
    hidden = model.encode_text(toks, text_mask, deterministic=False,
                               generator=gens, image_enc=enc,
                               image_mask=img_mask)
    hidden.float().square().mean().backward()
    torch.cuda.synchronize()
    c = launch_counts()
    layers = 2 * cfg.n_layers + cfg.refine_layers
    if (c["packed_fwd"], c["packed_bwd"]) != (layers, 2 * layers) or (
            c["packed_fwd_tensor_cores"], c["packed_bwd_tensor_cores"]) != (
            layers, 2 * layers):
        fail(f"17(f): launches {c}")
    grad = model.cross_align.align_output.weight.grad
    if not (torch.isfinite(hidden).all() and grad is not None
            and grad.abs().max().item() > 0):
        fail("17(f): the image fusion gave no finite output or gradient")
    out = {"launches": {k: c[k] for k in ("packed_fwd", "packed_bwd")},
           "cross_align_grad_max": grad.abs().max().item()}
    del model, enc, hidden
    torch.cuda.empty_cache()
    b, s, d = LATENT_SHAPE
    gen = torch.Generator().manual_seed(seed + 23)
    x = torch.randn(b, s, d, generator=gen)
    c = torch.randn(b, s, d, generator=gen)
    q = torch.randn(b, REGIONS, d, generator=gen)
    q_mask = torch.rand(b, REGIONS, generator=gen) > 0.2
    worst = {}
    for name, make, args in (
            ("cross_align", lambda: CrossAlignMatrix(d), (x, q, q_mask)),
            ("latent_decoder", lambda: LatentDecoder(d), (x,)),
            ("vae_deterministic", lambda: VaeEncoder(d), (x, c)),
            ("vae_stochastic", lambda: VaeEncoder(d), (x, c))):
        torch.manual_seed(seed)
        cpu_mod = make()
        for p in cpu_mod.parameters():
            p.data.normal_(0, d ** -0.5, generator=gen)
        card_mod = copy.deepcopy(cpu_mod).cuda()
        results = []
        for mod, dev in ((card_mod, "cuda"), (cpu_mod, "cpu")):
            targs = [a.detach().clone().to(dev) for a in args]
            targs[0].requires_grad_()
            extra = ((torch.Generator().manual_seed(seed), False)
                     if name == "vae_stochastic" else ())
            y = mod(*targs, *extra)
            if isinstance(y, tuple):
                y = y[0] if y[1] is None else y[0].sum(-1) + y[1]
            y.float().square().mean().backward()
            results.append({"out": y.detach().cpu(),
                            "input_grad": targs[0].grad.cpu(),
                            **{n: p.grad.cpu()
                               for n, p in mod.named_parameters()
                               if p.grad is not None}})
        largest = max(v.abs().max().item() for k, v in results[1].items()
                      if k != "out")
        errs = {}
        for key, want in results[1].items():
            # w_c . c_i and w_q's bias shift a row of the image softmax
            # alike: their gradients are zero up to rounding, held against
            # the module's largest gradient
            scale = (largest if key in ZERO_GRAD_CROSS_ALIGN
                     else want.abs().max().item())
            errs[key] = ((results[0][key] - want).abs().max().item()
                         / max(scale, 1e-30))
        worst[name] = max(errs.values())
        if worst[name] > TOL_GRAD_FP32:
            fail(f"17(f) {name}: fp32 card vs CPU relative difference "
                 f"{worst[name]:.3e} (tolerance {TOL_GRAD_FP32})")
    out["fp32_card_vs_cpu_max_rel"] = worst
    log(f"[variants] 17(f) image fusion {out['launches']}; fp32 card vs CPU, "
        f"outputs and gradients, max relative {worst}")
    return out


def grid_int8_slice():
    """17(g): `python -m m3p_tpu_torch.bench_eval_grid` on a small pool
    (`P17_GRID`), bf16 then ``--int8``, in this process: pairs/s of each
    and the int8 FFN GEMMs of the timed pass."""
    import io

    from m3p_tpu_torch import bench_eval_grid
    from m3p_tpu_torch.ops import quant

    out = {}
    for flag in ((), ("--int8",), ("--int8",), ()):
        buf = io.StringIO()
        quant.zero_counts()
        with contextlib.redirect_stdout(buf):
            rc = bench_eval_grid.main(list(P17_GRID) + list(flag))
        if rc != 0:
            fail(f"17(g): bench_eval_grid {' '.join(flag)} exited {rc}")
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        key = "int8" if flag else "bf16"
        out.setdefault(key, []).append(line["pairs_per_s"])
        if flag and quant.int8_matmul_qbwd.calls_by_route["cpu"]:
            fail("17(g): an int8 GEMM ran on the CPU route")
        out[f"{key}_packed_fwd_launches"] = line["packed_fwd_launches"]
        out[f"{key}_int8_gemms"] = quant.int8_matmul_qbwd.calls
    out["pairs_per_s"] = {k: sum(out[k]) / 2 for k in ("bf16", "int8")}
    log(f"[variants] 17(g) bench_eval_grid {' x '.join(P17_GRID)}: pairs/s "
        f"bf16 {out['pairs_per_s']['bf16']:.1f}, --int8 "
        f"{out['pairs_per_s']['int8']:.1f} (in turns {out['bf16']} / "
        f"{out['int8']})")
    return out


def int8_variants_slice(seed):
    """Phase 17: (a) the training GEMMs against the CPU, (b) the MCT step
    under ``int8_bwd`` in turns with the float FFN, A and B, and a
    learning check, (c) one step each of the other int8 modes, (d) MoE,
    (e) the adaptive softmax, (f) image fusion and the latent modules,
    (g) the grid tool's ``--int8``."""
    import torch

    t0 = time.time()
    out, part_s = {}, {}

    def lap(name):
        part_s[name] = time.time() - t0 - sum(part_s.values())
        torch.cuda.empty_cache()

    out["gemms"] = train_gemms_vs_cpu(seed)
    lap("gemms")
    out["mct_B"], state, gens, batch = mct_int8_turns(seed, fused=True)
    del state
    lap("mct_B")
    out["mct_A"], state, gens, batch = mct_int8_turns(seed, fused=False)
    out["modes"] = int8_modes_steps(state, gens, batch)
    del state, gens, batch
    lap("mct_A_and_modes")
    out["learning"] = int8_learning_check(seed)
    lap("learning")
    out["moe"] = moe_slice(seed)
    lap("moe")
    out["asm"] = asm_slice(seed)
    lap("asm")
    out["fusion"] = fusion_and_latent_slice(seed)
    lap("fusion")
    out["grid"] = grid_int8_slice()
    lap("grid")
    out["part_s"] = part_s
    out["phase_s"] = time.time() - t0
    log(f"[int8 train] phase 17: {out['phase_s']:.1f} s: "
        f"{json.dumps(part_s)}")
    return out


# ---------------------------------------------------------------------------
# phase 18: several processes -- data parallelism and sequence parallelism
# ---------------------------------------------------------------------------

# Each part launches its ranks with `python -m torch.distributed.run
# --standalone --nproc_per_node N chip_smoke.py --p18 <config>`; the ranks
# share this card, so `parallel.mesh.choose_backend` picks gloo: its
# collectives take the CUDA tensors and copy them through host memory, and
# the ring's point-to-point stages through pinned host buffers
# (`parallel.mesh.exchange`).  Ranks sharing one card over gloo say nothing
# of data-parallel speed: their times are the cost of the path, not a
# speed-up.
#
# (a) phase 14's recipe (rel + ic, accumulation 4, BN = 24 x 4, bf16 at the
# flagship width) through `train_x.main` on each of 2 ranks, --mesh_data 2,
# its batches from phase 15(b)'s ported datasets over InMemoryStore (the
# card's machine has no h5py: the COCO family cannot come from a data
# directory there).
# Dropout 0, so that one process on the same global batches (each rank's
# row-loader batch, concatenated: `ShardsAsOne`) is comparable.
P18_DP_RANKS = 2
P18_DP_STEPS = 4                 # micro-steps: one update at accumulation 4
# fp32 at depth 2: 4 micro-steps (rel, ic, ...) without accumulation, 4
# updates, over phase 14's TRAINER_FP32_WORDS vocabulary (the all-reduce
# and the checkpoint of the 250,002-row table were most of the run)
P18_FP32_STEPS = 4
# that run takes SIGTERM on both ranks after micro-step 1, the flags
# checked every 2 micro-steps: the checkpoint at 2, mid-epoch; the run goes
# on to its end, and a resume from that checkpoint must take its last 2
# micro-steps bitwise (at depth 2: the flagship's 5.4 GB checkpoint, saved
# and read back, took 20 s of the phase on an H100 80GB HBM3 host)
P18_SIGTERM_AT, P18_SAVE_EVERY = 1, 2
# images of the in-memory store: a rank's strided half holds the 5 row
# batches of 12 its steps take
P18_IMAGES = 96
# bf16 at the flagship width, one process against 2 ranks on the same
# global batches: GEMMs over 12 rows a rank against 24 may pick other
# kernels, so the losses agree to bf16's rounding through 12 layers (1.72e-4
# read on an H100 80GB HBM3 at 700 W), and Adam's first moment (the
# window's mean gradient x 0.1, each gradient of bf16 precision: 2 ranks'
# average rounded once against one sum over 24 rows) per leaf to a share of
# the leaf's largest entry (3.2e-2 to 3.9e-2 read there)
TOL_P18_LOSS_BF16 = 1e-3
TOL_P18_MU_BF16 = 6e-2
# fp32 at depth 2: the losses, and every parameter after the 2 updates per
# leaf relative to its largest entry, or to 1e-2 of the model's largest
# (the LayerNorm scales, 1) for a leaf that is still its 2 updates from a
# zero start (against the leaf alone: 6.0e-6 at such a bias on the H100)
TOL_P18_FP32 = 1e-5
P18_PARAM_FLOOR = 1e-2
# (b) the long_context_config model (12 x 768, 250,002 words, 8192
# positions, bf16) over 4 ranks of a seq axis: the non-causal xMLM step at
# B = 4, S = 4096 through `parallel.sp.SPModel`, FusedAdam as in phase 7
P18_SP_RANKS = 4
# B = 4: the preset's remat runs each layer's forward ring twice, and the
# script's time limit holds phase 19 too
P18_SP_B, P18_SP_S = 4, 4096
# one step, timed from its start (its pinned buffers' allocation included:
# 7.12 s a step after a warm-up step against 9.3-11.0 s on an H100 80GB
# HBM3 at 700 W)
P18_SP_WARMUP, P18_SP_STEPS = 0, 1
# fp32 at depth 2 (a 32,002-word vocabulary: the comparison is of the
# stack, not of the 250,002-row table), the SP step's loss and every
# gradient against one process, whose attention takes #5/#6; per leaf
# relative to the leaf's largest entry, a leaf whose largest entry is under
# 1e-3 of the model's largest (the key biases: a per-row shift the softmax
# ignores) relative to the model's largest
P18_SP_FP32_WORDS = 32002
TOL_P18_SP_GRAD = 1e-4
P18_TIMEOUT_S = 600
# rank 0's fp32 gradients of 18(b), in the launch's temporary directory
P18_SP_GRADS = "sp.grads.pt"


class ShardsAsOne:
    """The global batches of ``count`` batch shards in one process: each
    shard's row-loader batch (`make_row_loader` with ``shard``, as the
    trainer of each rank makes it), concatenated in shard order."""

    def __init__(self, dataset, count, seed, workers):
        self.dataset, self.count = dataset, count
        self.seed, self.workers = seed, workers

    def epoch_iterator(self, batch_size, epoch=0):
        import numpy as np

        from m3p_tpu_torch.data.row_pipeline import make_row_loader

        loaders = [iter(make_row_loader(
            self.dataset, batch_size // self.count, seed=self.seed,
            epoch=epoch, worker_count=self.workers, shard=(r, self.count)))
            for r in range(self.count)]
        try:
            for parts in zip(*loaders):
                if isinstance(parts[0], tuple):
                    yield tuple({k: np.concatenate([p[i][k] for p in parts])
                                 for k in parts[0][i]}
                                for i in range(len(parts[0])))
                else:
                    yield {k: np.concatenate([p[k] for p in parts])
                           for k in parts[0]}
        finally:
            for it in loaders:
                it.close()


def p18_dp_argv(seed, dump, extra=()):
    return TRAINER_ARGV + [
        "--dropout", "0", "--attention_dropout", "0",
        "--epoch_size", str(TRAINER_B * P18_DP_STEPS), "--max_epoch", "1",
        "--save_check_every", str(P18_SAVE_EVERY), "--dump_path", dump,
        "--seed", str(seed)] + list(extra)


def p18_recipe_data(seed, vocab, tmp, shards=None):
    """Phase 15(b)'s rel and ic datasets over InMemoryStore (seeded alike
    on every rank), as `LoadedData`; with ``shards`` each wrapped in
    `ShardsAsOne`."""
    from m3p_tpu_torch.data.loader import LoadedData
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    tok = XLMRTokenizer(vocab)
    store = InMemoryStore(seed, P18_IMAGES)
    cfg = recipe_config(tok, tmp)
    datasets = recipe_datasets(cfg, store, recipe_captions(seed, store), tok)
    if shards:
        # the trainer's row loaders draw with the run's --seed
        datasets = {k: ShardsAsOne(d, shards, seed, cfg.data.num_workers)
                    for k, d in datasets.items()}
    return LoadedData(train_datasets=datasets, tokenizer=tok)


def p18_run_main(argv, data, rec, on_step=None, on_save=None, rng=None,
                 save=True):
    """`train_x.main(argv, data=...)` recording into ``rec`` each micro-step's
    kind, loss, #1/#2 launches, ms (host clock to a synchronize) and staged
    batch; ``on_save(trainer)`` runs after each checkpoint (one that returns
    True ends the run); ``save`` False writes none (a reference run).
    Returns (trainer or None if ``on_save`` ended it, seconds)."""
    import torch

    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.train import trainer as trainer_mod

    class Ended(Exception):
        pass

    def wrap_init(orig):
        def init(self, *a, **kw):
            orig(self, *a, **kw)
            add = self.stats.add
            self.stats.add = lambda key, v: (rec["losses"].append(
                (key, float(v))), add(key, v))[1]
            if rng is not None:
                self.rng.set_state(rng)
        return init

    def wrap_batch(orig):
        def get_batch(self, task):
            batch = orig(self, task)
            rec["batches"].append(batch)
            return batch
        return get_batch

    def wrap_step(orig):
        def step_once(self, kind, task):
            torch.cuda.synchronize()
            before = launch_counts()
            t = time.perf_counter()
            orig(self, kind, task)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t) * 1e3)
            after = launch_counts()
            rec["steps"].append((kind, {k: after[k] - before[k]
                                        for k in ("packed_fwd", "packed_bwd",
                                                  "flash_fwd", "flash_bwd")}))
            if on_step is not None:
                on_step(self)
        return step_once

    def wrap_save(orig):
        def save_(self, name="checkpoint"):
            if save:
                orig(self, name)
            if on_save is not None and on_save(self):
                raise Ended
        return save_

    t0 = time.time()
    with contextlib.ExitStack() as stack:
        for name, make in (("__init__", wrap_init),
                           ("_get_batch", wrap_batch),
                           ("step_once", wrap_step),
                           ("save_checkpoint", wrap_save)):
            stack.enter_context(patched(trainer_mod.Trainer, name, make))
        try:
            trainer = train_x.main(argv, data=data)
        except Ended:
            trainer = None
    torch.cuda.synchronize()
    return trainer, time.time() - t0


def p18_dp_rank(cfg):
    """18(a) on one rank: the whole bf16 run at the flagship width (rank 0
    writes Adam's first moment at its end), then the fp32 run at depth 2,
    cut by SIGTERM after micro-step P18_SIGTERM_AT, going on to its end, and
    resumed from its mid-epoch checkpoint (the resume's batches, losses and
    final parameters bitwise the whole run's)."""
    import signal

    import torch
    import torch.distributed as dist

    from m3p_tpu_torch.parallel import data_parallel as DP
    from m3p_tpu_torch.parallel.mesh import HOST_STAGED_BYTES

    seed, tmp = cfg["seed"], cfg["tmp"]
    data = p18_recipe_data(seed, cfg["vocab"], tmp)
    data32 = p18_recipe_data(seed, cfg["vocab32"], tmp)
    dump = os.path.join(tmp, "dump")
    mesh_args = ["--mesh_data", str(P18_DP_RANKS)]
    out = {"rank": None}

    def new_rec():
        return {"losses": [], "batches": [], "ms": [], "steps": []}

    def write_mu(trainer):
        # the end of the epoch: rank 0's Adam first moment, in place of the
        # 5.4 GB checkpoint that would hold it
        if dist.get_rank() == 0:
            opt = trainer.state.opt_state
            torch.save([t.cpu() for t in opt.get("inner", opt)["mu"]],
                       os.path.join(tmp, "dp_mu.pt"))
        return False

    whole = new_rec()
    # ---- the main path, counted ----
    zero_launch_counts()
    DP.REDUCED_BYTES.update(gradients=0, steps=0)
    HOST_STAGED_BYTES.update(to_host=0, to_device=0)
    torch.cuda.reset_peak_memory_stats()
    trainer, secs = p18_run_main(
        p18_dp_argv(seed, dump, mesh_args + ["--exp_id", "whole"]), data,
        whole, on_save=write_mu, save=False)
    counts = launch_counts()
    out["rank"] = dist.get_rank()
    out["whole"] = {
        "seconds": secs, "n_total_iter": trainer.n_total_iter,
        "losses": whole["losses"], "ms": whole["ms"],
        "steps": whole["steps"],
        "launches": {k: counts[k] for k in ("packed_fwd", "packed_bwd",
                                            "flash_fwd", "flash_bwd")},
        "reduced_bytes": dict(DP.REDUCED_BYTES),
        "host_staged_bytes": dict(HOST_STAGED_BYTES),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "mesh": dict(trainer.mesh.shape), "backend": trainer.mesh.backend,
        "shard": [trainer.shard_index, trainer.shard_count]}
    del trainer
    torch.cuda.empty_cache()

    # ---- fp32 at depth 2, SIGTERM after micro-step P18_SIGTERM_AT ----
    # the mid-epoch checkpoint is linked aside (the end of the epoch saves
    # over it) for the resume, and the run goes on to its end: the
    # uninterrupted run
    fp32_args = ["--fp16", "False", "--n_layers", "2",
                 "--optimizer", TRAINER_FP32_SPEC, "--accumulate_gradients",
                 "1", "--epoch_size", str(TRAINER_B * P18_FP32_STEPS)]
    state = {}
    cut = os.path.join(dump, "phase14", "cut", "checkpoint")

    def kill(trainer):
        if trainer.n_total_iter == P18_SIGTERM_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    def keep(trainer):
        if trainer.n_sentences < trainer.cfg.epoch_size:
            state["rng"] = trainer.rng.get_state()
            state["saved_at"] = trainer.n_total_iter
            state["losses_at"] = len(fp32["losses"])
            if dist.get_rank() == 0:
                src = trainer.checkpoint_path()
                os.makedirs(cut)
                for name in os.listdir(src):
                    os.link(os.path.join(src, name), os.path.join(cut, name))
            dist.barrier()
        return False

    fp32 = new_rec()
    trainer, secs = p18_run_main(p18_dp_argv(seed, dump, mesh_args + [
        "--exp_id", "fp32"] + fp32_args), data32, fp32, on_step=kill,
        on_save=keep)
    if "saved_at" not in state:
        fail(f"phase 18(a) rank {out['rank']}: SIGTERM made no checkpoint "
             "mid-epoch")
    out["fp32"] = {"seconds": secs, "losses": fp32["losses"]}
    final = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    del trainer
    torch.cuda.empty_cache()

    # ---- the resume from the SIGTERM checkpoint ----
    resumed = new_rec()
    trainer, resumed_s = p18_run_main(p18_dp_argv(seed, dump, mesh_args + [
        "--exp_id", "cut"] + fp32_args), data32, resumed, rng=state["rng"],
        save=False)
    at = state["saved_at"]
    later = fp32["batches"][at:]
    out["resume"] = {
        "saved_at": at, "resumed_seconds": resumed_s,
        "steps_after": len(resumed["batches"]),
        "batches_bitwise": (len(resumed["batches"]) == len(later) > 0
                            and all(map(same_batches, resumed["batches"],
                                        later))),
        "losses_bitwise": resumed["losses"] == fp32["losses"][
            state["losses_at"]:],
        "params_bitwise": all(torch.equal(p, final[n]) for n, p in
                              trainer.model.named_parameters())}
    with open(f"{cfg['out']}.{out['rank']}.json", "w") as f:
        json.dump(out, f)


def p18_launch(part, n, cfg):
    """``n`` ranks of this script under torchrun for ``part``: (rc, seconds,
    output tail, per-rank results)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    path = os.path.join(cfg["tmp"], f"{part}.json")
    cfg = dict(cfg, part=part, out=os.path.join(cfg["tmp"], f"{part}.out"))
    with open(path, "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), str(Path(__file__).resolve()), "--p18",
           path]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=P18_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        fail(f"phase 18 {part}: the ranks did not end in {P18_TIMEOUT_S} s: "
             f"{str(e.stdout)[-3000:]}")
    secs = time.time() - t0
    tail = (proc.stdout[-4000:] + proc.stderr[-4000:])
    if proc.returncode != 0:
        fail(f"phase 18 {part}: a rank failed (rc {proc.returncode}):\n{tail}")
    results = []
    for r in range(n):
        with open(f"{cfg['out']}.{r}.json") as f:
            results.append(json.load(f))
    return secs, results


def p18_one_process(seed, vocab, tmp, extra):
    """18(a)'s recipe in this process on the ranks' global batches over
    ``vocab``: the trainer and its record, whose ``"fault"`` is
    `p18_fault_reading` at the first caption step."""
    data = p18_recipe_data(seed, vocab, tmp, shards=P18_DP_RANKS)
    rec = {"losses": [], "batches": [], "ms": [], "steps": []}

    def read_fault(trainer):
        if rec["steps"][-1][0] == "ic" and "fault" not in rec:
            rec["fault"] = p18_fault_reading(trainer, rec["batches"][-1])

    trainer, secs = p18_run_main(
        p18_dp_argv(seed, os.path.join(tmp, "one"), extra), data, rec,
        on_step=read_fault, save=False)
    return trainer, rec


def p18_fault_reading(trainer, batch):
    """What a planted fault would read: the caption loss as the mean of the
    ranks' own per-token means (each shard's sum over its own count) against
    the global-count loss, on one global batch at the trainer's parameters;
    ``before_update`` says whether no update has been applied yet (the
    parameters are then the step's own)."""
    import torch

    from m3p_tpu_torch.train import steps as S

    cfg = trainer.cfg
    b = S.expand_compact_batch(batch)
    rows = b["tokens"].shape[0]
    half = rows // P18_DP_RANKS

    def loss(part):
        return float(S.caption_loss(
            trainer.model, part, None, refine_image=cfg.refine_image,
            deterministic=True, refine_encoder=cfg.refine_encoder)[0])

    with torch.no_grad():
        whole = loss(b)
        shards = [loss({k: v[r * half:(r + 1) * half]
                        if torch.is_tensor(v) and v.dim() and
                        v.shape[0] == rows else v for k, v in b.items()})
                  for r in range(P18_DP_RANKS)]
    fault = sum(shards) / len(shards)
    return {"global": whole, "per_rank_mean": fault,
            "rel": abs(fault - whole) / abs(whole),
            "before_update": trainer.state.step == 0}


def leaf_rel_diff(got, want, floor=1e-3):
    """(max over leaves of max |got - want| over the leaf's largest |want|,
    the leaf): a leaf whose largest is under ``floor`` of the model's
    largest is taken over that share of the model's largest."""
    top = max(float(w.abs().max()) for w in want.values())
    worst, where = 0.0, None
    for name, w in want.items():
        scale = max(float(w.abs().max()), floor * top)
        d = float((got[name].to(w.device).float()
                   - w.float()).abs().max()) / scale
        if d > worst:
            worst, where = d, name
    return worst, where


def dp_slice(seed, tmp):
    """18(a): the ranks' runs (`p18_dp_rank`), then one process on the same
    global batches, bf16 at full width and fp32 at depth 2."""
    import numpy as np
    import torch

    vocab = os.path.join(tmp, "vocab.tsv")
    write_vocab(vocab, 250000)
    vocab32 = os.path.join(tmp, "vocab32.tsv")
    write_vocab(vocab32, TRAINER_FP32_WORDS - 2)
    cfg = {"seed": seed, "vocab": vocab, "vocab32": vocab32, "tmp": tmp}
    secs, ranks = p18_launch("dp", P18_DP_RANKS, cfg)
    r0 = ranks[0]
    t0 = time.time()
    for r in ranks:
        if r["whole"]["backend"] != "gloo" or r["whole"]["mesh"]["data"] != 2:
            fail(f"phase 18(a): rank {r['rank']} ran {r['whole']['mesh']} "
                 f"over {r['whole']['backend']}")
        if r["whole"]["n_total_iter"] != P18_DP_STEPS:
            fail(f"phase 18(a): rank {r['rank']} took "
                 f"{r['whole']['n_total_iter']} micro-steps")
        bad = [k for k, v in r["resume"].items()
               if k.endswith("bitwise") and not v]
        if bad:
            fail(f"phase 18(a) rank {r['rank']}: the resume is not bitwise "
                 f"the uninterrupted run's: {bad} {r['resume']}")
        if r["whole"]["losses"] != r0["whole"]["losses"]:
            fail("phase 18(a): the ranks log different (reduced) losses")

    # ---- one process on the same global batches ----
    one, rec = p18_one_process(seed, vocab, tmp, ["--exp_id", "one"])
    got = np.array([v for _, v in r0["whole"]["losses"]])
    want = np.array([v for _, v in rec["losses"]])
    loss_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if [k for k, _ in rec["losses"]] != [k for k, _ in r0["whole"]["losses"]]:
        fail("phase 18(a): one process took other steps than the ranks")
    if loss_rel > TOL_P18_LOSS_BF16:
        fail(f"phase 18(a): bf16 losses of 2 ranks against one process "
             f"differ by {loss_rel} > {TOL_P18_LOSS_BF16}")
    # rank 0's Adam first moment at the end of the epoch
    mu = torch.load(os.path.join(tmp, "dp_mu.pt"), map_location="cpu",
                    weights_only=True)
    opt = one.state.opt_state
    names = [n for n, _ in one.model.named_parameters()]
    mu_rel = leaf_rel_diff(dict(zip(names, mu)),
                           dict(zip(names, opt.get("inner", opt)["mu"])))
    one_steps = rec["steps"]
    fault = rec.get("fault")
    del mu, one
    torch.cuda.empty_cache()
    one_s = {"bf16": time.time() - t0}
    if mu_rel[0] > TOL_P18_MU_BF16:
        fail(f"phase 18(a): Adam's first moment of 2 ranks against one "
             f"process differs by {mu_rel} > {TOL_P18_MU_BF16}")
    for r in ranks:
        if [s for s in r["whole"]["steps"]] != [list(s) for s in one_steps]:
            fail(f"phase 18(a): rank {r['rank']}'s #1/#2 launches a step "
                 f"{r['whole']['steps']} are not one process's {one_steps}")
        if r["whole"]["launches"]["packed_fwd"] == 0 or \
                r["whole"]["launches"]["packed_bwd"] == 0:
            fail(f"phase 18(a): rank {r['rank']} launched no #1/#2")

    # ---- fp32 at depth 2 ----
    one, rec32 = p18_one_process(seed, vocab32, tmp, [
        "--exp_id", "one32", "--fp16", "False", "--n_layers", "2",
        "--optimizer", TRAINER_FP32_SPEC, "--accumulate_gradients", "1",
        "--epoch_size", str(TRAINER_B * P18_FP32_STEPS)])
    fault32 = rec32.get("fault")
    got = np.array([v for _, v in r0["fp32"]["losses"]])
    want = np.array([v for _, v in rec32["losses"]])
    loss32 = float(np.max(np.abs(got - want) / np.abs(want)))
    blob = torch.load(os.path.join(tmp, "dump", "phase14", "fp32",
                                   "checkpoint", "state.pt"),
                      map_location="cpu", weights_only=True, mmap=True)
    param32 = leaf_rel_diff(
        blob["model"], {n: p.detach() for n, p in one.model.named_parameters()},
        floor=P18_PARAM_FLOOR)
    del blob, one
    torch.cuda.empty_cache()
    one_s["fp32"] = time.time() - t0 - one_s["bf16"]
    if loss32 > TOL_P18_FP32 or param32[0] > TOL_P18_FP32:
        fail(f"phase 18(a): fp32 depth 2, 2 ranks against one process: "
             f"losses {loss32}, parameters {param32} > {TOL_P18_FP32}")
    # the fp32 check's teeth: a per-rank-mean caption loss would read above
    # its limit (the bf16 limits are bf16's rounding, and may not see it)
    if fault32 is None or fault32["rel"] <= TOL_P18_FP32:
        fail(f"phase 18(a): a per-rank-mean caption loss reads {fault32} "
             f"against the global-count one, within the fp32 limit "
             f"{TOL_P18_FP32}: the check would not see it")

    n_steps = P18_DP_STEPS
    out = {
        "launch_s": secs, "ranks": P18_DP_RANKS, "backend": "gloo",
        "rank0_s": {"whole": r0["whole"]["seconds"],
                    "resume": r0["resume"]["resumed_seconds"],
                    "fp32": r0["fp32"]["seconds"]},
        "one_process_s": one_s,
        "micro_steps": n_steps,
        "grad_bytes_all_reduced_per_micro_step":
            r0["whole"]["reduced_bytes"]["gradients"]
            / r0["whole"]["reduced_bytes"]["steps"],
        "host_staged_bytes_per_micro_step": {
            k: v / n_steps for k, v in
            r0["whole"]["host_staged_bytes"].items()},
        "launches_per_rank": {r["rank"]: r["whole"]["launches"]
                              for r in ranks},
        "launches_per_micro_step_by_kind": {
            kind: c for kind, c in dict(
                (k, c) for k, c in r0["whole"]["steps"]).items()},
        # the first micro-step of each rank builds its loaders and warms up
        "ms_per_micro_step_per_rank": {
            r["rank"]: float(np.mean(r["whole"]["ms"][1:])) for r in ranks},
        "ms_per_micro_step_one_process": float(np.mean(rec["ms"][1:])),
        "peak_memory_gb_per_rank": {r["rank"]: r["whole"]["peak_memory_gb"]
                                    for r in ranks},
        "bf16_loss_max_rel_vs_one_process": loss_rel,
        "bf16_adam_mu_max_rel_vs_one_process": mu_rel,
        "tolerances": {"bf16_loss": TOL_P18_LOSS_BF16,
                       "bf16_mu": TOL_P18_MU_BF16, "fp32": TOL_P18_FP32},
        # a per-rank-mean caption loss in place of the global-count one
        "planted_per_rank_mean_loss_bf16": fault,
        "planted_per_rank_mean_loss_fp32_depth2": fault32,
        "fp32_depth2_loss_max_rel": loss32,
        "fp32_depth2_param_max_rel": param32,
        "resume": {r["rank"]: r["resume"] for r in ranks},
        "speed_note": ("2 ranks sharing one card over gloo, whose "
                       "collectives go through host memory: the cost of "
                       "the path, not a data-parallel speed")}
    log(f"[parallel] 18(a) data parallelism: {json.dumps(out)}")
    return out


def p18_sp_config(n_layers=12, dtype="bfloat16", n_words=250002):
    """long_context_config's model: 8192 positions; its ``seq_axis`` names
    the mesh axis `SPModel` shards the stack over."""
    from m3p_tpu_torch.config import long_context_config

    m = long_context_config().model
    return dataclasses.replace(m, n_layers=n_layers, dtype=dtype,
                               n_words=n_words, mask_index=n_words - 1)


def p18_sp_batch(seed, n_words, device):
    import numpy as np
    import torch

    from m3p_tpu_torch.data.synthetic import make_stream_batch

    batch = make_stream_batch(np.random.RandomState(seed), P18_SP_B,
                              P18_SP_S, n_words)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def p18_sp_masking(seed, batch, n_words):
    """The xMLM masking of ``batch`` drawn on the CPU from ``seed``."""
    import torch

    from m3p_tpu_torch.config import long_context_config
    from m3p_tpu_torch.data.masking import MaskingConfig, mask_tokens
    from m3p_tpu_torch.model.transformer import lengths_to_mask

    data = long_context_config().data
    cfg = MaskingConfig(max_pred=data.max_pred_per_seq, n_words=n_words,
                        mask_index=n_words - 1)
    tokens = batch["tokens"].long().cpu()
    mask = lengths_to_mask(batch["lengths"].cpu(), tokens.shape[1])
    gen = torch.Generator().manual_seed(seed)
    return [t.to(batch["tokens"].device)
            for t in mask_tokens(gen, tokens, mask, cfg)]


def p18_sp_part(cfg):
    """18(b) on one rank, the last part of phase 19's launch
    (`p19_rank`): the bf16 SP step at full width (launches, ring bytes,
    ms), then the fp32 depth-2 step's loss and gradients (rank 0 writes
    them to ``cfg["tmp"]``'s `P18_SP_GRADS`)."""
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch.config import MeshConfig, long_context_config
    from m3p_tpu_torch.data.masking import MaskingConfig
    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.ops.ring_attention import RING_BYTES
    from m3p_tpu_torch.parallel.data_parallel import batch_reduction
    from m3p_tpu_torch.parallel.mesh import (
        HOST_STAGED_BYTES, auto_init_distributed, make_mesh)
    from m3p_tpu_torch.parallel.sp import SPModel
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state
    from m3p_tpu_torch.train.steps import make_train_step, mlm_loss
    from m3p_tpu_torch.train.trainer import broadcast_parameters

    seed = cfg["seed"]
    t0 = time.time()
    auto_init_distributed("cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(MeshConfig(data=1, seq=P18_SP_RANKS), dev)
    rank = dist.get_rank()
    out = {"rank": rank, "backend": mesh.backend, "mesh": dict(mesh.shape)}

    mcfg = p18_sp_config()
    data = long_context_config().data
    model = build_model(mcfg, seed, dev)
    broadcast_parameters(model, mesh)
    tx, _ = build_optimizer(LONG_SPEC, clip_grad_norm=CLIP)
    state = create_train_state(model, tx, mesh)
    sp = SPModel(model, mesh)
    mask_cfg = MaskingConfig(max_pred=data.max_pred_per_seq,
                             n_words=mcfg.n_words, mask_index=mcfg.mask_index)
    step = make_train_step(lambda _m, b, g: mlm_loss(sp, b, g, mask_cfg))
    batch = p18_sp_batch(seed, mcfg.n_words, dev)
    gens = Generators.from_seed(seed, dev)
    for _ in range(P18_SP_WARMUP):
        state, m = step(state, batch, gens)
    torch.cuda.synchronize()
    dist.barrier()
    # ---- the main path, counted ----
    zero_launch_counts()
    RING_BYTES.update(forward=0, backward=0, rotations=0)
    HOST_STAGED_BYTES.update(to_host=0, to_device=0)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    losses = []
    for _ in range(P18_SP_STEPS):
        state, m = step(state, batch, gens)
        losses.append(float(m["mlm"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / P18_SP_STEPS
    counts = launch_counts()
    out["bf16"] = {
        "ms_per_step": ms, "losses": losses,
        "launches": {k: counts[k] for k in ("packed_fwd", "packed_bwd",
                                            "flash_fwd", "flash_bwd")},
        "ring_bytes_per_step": {k: v / P18_SP_STEPS
                                for k, v in RING_BYTES.items()},
        "host_staged_bytes_per_step": {
            k: v / P18_SP_STEPS for k, v in HOST_STAGED_BYTES.items()},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "n_params": sum(p.numel() for p in model.parameters())}
    del state, model, sp, step, batch
    torch.cuda.empty_cache()

    t1 = time.time()
    # ---- fp32 at depth 2: the loss and every gradient ----
    mcfg = p18_sp_config(2, "float32", P18_SP_FP32_WORDS)
    model = build_model(mcfg, seed + 1, dev)
    broadcast_parameters(model, mesh)
    tx, _ = build_optimizer("sgd,lr=0.1")
    state = create_train_state(model, tx, mesh)
    batch = p18_sp_batch(seed + 1, mcfg.n_words, dev)
    masking = p18_sp_masking(seed + 1, batch, mcfg.n_words)
    sp = SPModel(model, mesh)
    # the step's loss and its gradients as the optimizer would take them
    with batch_reduction(state.mesh):
        loss, m = mlm_loss(sp, batch, None, mask_cfg, deterministic=True,
                           masking=masking)
    loss.backward()
    m = state.sync_gradients(dict(m))
    out["fp32"] = {"loss": float(m["mlm"])}
    out["seconds"] = {"bf16": t1 - t0, "fp32": time.time() - t1}
    if rank == 0:
        torch.save({n: p.grad.cpu() for n, p in model.named_parameters()
                    if p.grad is not None},
                   os.path.join(cfg["tmp"], P18_SP_GRADS))
    del state, model, sp, batch
    torch.cuda.empty_cache()
    return out


def sp_slice(seed, secs, ranks, grads):
    """18(b): the ranks' SP steps (`p18_sp_part`, on phase 19's launch:
    its ``secs``, each rank's results, rank 0's fp32 gradients), then one
    process's fp32 depth-2 step on the same batch and masking (#5/#6)."""
    import numpy as np
    import torch

    from m3p_tpu_torch.config import long_context_config
    from m3p_tpu_torch.data.masking import MaskingConfig
    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.train.steps import mlm_loss

    t0 = time.time()
    for r in ranks:
        c = r["bf16"]["launches"]
        if r["backend"] != "gloo" or r["mesh"]["seq"] != P18_SP_RANKS:
            fail(f"phase 18(b): rank {r['rank']} ran {r['mesh']} over "
                 f"{r['backend']}")
        if any(c.values()):
            fail(f"phase 18(b): rank {r['rank']} launched attention kernels "
                 f"inside the SP step: {c}")
        if not np.isfinite(r["bf16"]["losses"]).all():
            fail(f"phase 18(b): non-finite loss {r['bf16']['losses']}")
        if r["bf16"]["losses"] != ranks[0]["bf16"]["losses"]:
            fail("phase 18(b): the ranks' losses differ")
    # one process, the same model outside the SP path: its whole sequence
    # through #5/#6
    mcfg = p18_sp_config(2, "float32", P18_SP_FP32_WORDS)
    data = long_context_config().data
    mask_cfg = MaskingConfig(max_pred=data.max_pred_per_seq,
                             n_words=mcfg.n_words, mask_index=mcfg.mask_index)
    model = build_model(mcfg, seed + 1, "cuda")
    batch = p18_sp_batch(seed + 1, mcfg.n_words, "cuda")
    masking = p18_sp_masking(seed + 1, batch, mcfg.n_words)
    # ---- the one-process reference, counted ----
    zero_launch_counts()
    loss, _ = mlm_loss(model, batch, None, mask_cfg, deterministic=True,
                       masking=masking)
    loss.backward()
    torch.cuda.synchronize()
    ref_launches = {k: v for k, v in launch_counts().items()
                    if k in ("flash_fwd", "flash_bwd", "packed_fwd",
                             "packed_bwd")}
    # remat (the preset's) runs each layer's forward again in the backward
    forwards = (2 if mcfg.remat else 1) * mcfg.n_layers
    if ref_launches["flash_fwd"] != forwards or \
            ref_launches["flash_bwd"] != 2 * mcfg.n_layers:
        fail(f"phase 18(b): the one-process step launched {ref_launches}")
    grads = {n: g.cuda() for n, g in grads.items()}
    want = {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}
    got = {n: grads.get(n, torch.zeros_like(w)) for n, w in want.items()}
    grad_rel = leaf_rel_diff(got, want)
    loss = float(loss.detach())
    loss_rel = abs(ranks[0]["fp32"]["loss"] - loss) / abs(loss)
    del model, grads, want, got
    torch.cuda.empty_cache()
    if loss_rel > TOL_P18_FP32 or grad_rel[0] > TOL_P18_SP_GRAD:
        fail(f"phase 18(b): fp32 depth 2, SP over {P18_SP_RANKS} ranks "
             f"against one process: loss {loss_rel} (tolerance "
             f"{TOL_P18_FP32}), gradients {grad_rel} (tolerance "
             f"{TOL_P18_SP_GRAD})")
    r0 = ranks[0]["bf16"]
    full = p18_sp_config()
    # one of K and V of one layer, bf16: B x H x S_local x Dh x 2 bytes
    kv = P18_SP_B * full.emb_dim * (P18_SP_S // P18_SP_RANKS) * 2
    out = {
        "launch_s": secs, "ranks": P18_SP_RANKS, "backend": "gloo",
        "rank0_s": ranks[0]["seconds"],
        "shape": {"B": P18_SP_B, "S": P18_SP_S,
                  "S_local": P18_SP_S // P18_SP_RANKS},
        "n_params": r0["n_params"],
        "ms_per_step_per_rank": {r["rank"]: r["bf16"]["ms_per_step"]
                                 for r in ranks},
        "losses": r0["losses"],
        "launches_in_sp_step_per_rank": {r["rank"]: r["bf16"]["launches"]
                                         for r in ranks},
        "ring_bytes_per_step_rank0": r0["ring_bytes_per_step"],
        "ring_bytes_predicted": {
            "kv_block_each_of_k_v": kv,
            "forward": ((2 if full.remat else 1) * (P18_SP_RANKS - 1) * 2
                        * kv * full.n_layers),
            "backward": ((P18_SP_RANKS - 1) * 2 * kv
                         + P18_SP_RANKS * 2 * kv) * full.n_layers,
            "note": "forward: 3 rotations of K and V a layer, twice under "
                    "remat (the recompute); backward: K and V again and 4 "
                    "hops of their dK/dV, bf16"},
        "host_staged_bytes_per_step_rank0": r0["host_staged_bytes_per_step"],
        "peak_memory_gb_per_rank": {r["rank"]: r["bf16"]["peak_memory_gb"]
                                    for r in ranks},
        "fp32_depth2_loss_rel_vs_one_process": loss_rel,
        "fp32_depth2_grad_max_rel_vs_one_process": grad_rel,
        "one_process_launches": ref_launches,
        "speed_note": ("4 ranks sharing one card over gloo, the ring "
                       "staged through pinned host memory: "
                       "the cost of the path, not a sequence-parallel "
                       "speed"),
        "check_s": time.time() - t0}
    log(f"[parallel] 18(b) sequence parallelism: {json.dumps(out)}")
    return out


def parallel_slice(seed):
    """Phase 18's (a): data parallelism through train_x.main over 2 ranks;
    (b), sequence parallelism with ring attention over 4, runs on phase
    19's launch (`sp_slice`)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        out = {"dp": dp_slice(seed, tmp)}
    out["phase_s"] = time.time() - t0
    log(f"[parallel] phase 18(a) in {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: parameter sharding -- FSDP, tensor and expert parallelism
# ---------------------------------------------------------------------------

# One torchrun launch of 4 ranks sharing this card over gloo
# (`parallel.mesh.choose_backend`): its collectives take the CUDA tensors
# (torch 2.11's gloo runs all_reduce, all_gather_into_tensor and
# reduce_scatter_tensor on them: `parallel.probe_gloo`).  One card shared by
# 4 ranks says nothing of FSDP's or TP's speed; what it shows is each rank's
# share of the state and the global step computed shard by shard.
#
# (a) the scale-up preset (`config.scale_up_config`: 24 layers, 768 wide,
# 12 heads, 250,002 words, 101 languages, bf16, remat) through
# `train_x.main` as fsdp 2 x tensor 2: the MCT step, one warm-up and
# P19_TIMED timed micro-steps, the preset's batch (8 groups of 4) at 32
# tokens and 36 regions; its checkpoint is not written (`p18_run_main`
# save=False: the 4.7 GB state).
P19_RANKS = 4
P19_TIMED = 1
P19_B, P19_SAMPLE_N, P19_TEXT, P19_REGIONS = 8, 4, 32, 36
P19_LGS = "-".join(f"l{i}" for i in range(100))
P19_ARGV = [
    "--lgs", P19_LGS, "--emb_dim", "768", "--n_layers", "24", "--n_heads",
    "12", "--fp16", "True", "--remat", "True", "--is_pretrain", "True",
    "--cross_rel_steps", "coco-img", "--batch_size", str(P19_B),
    "--sample_n", str(P19_SAMPLE_N), "--max_len", str(P19_TEXT),
    "--max_region_num", str(P19_REGIONS),
    "--epoch_size", str(P19_B * (1 + P19_TIMED)), "--max_epoch", "1",
    "--use_grain", "False", "--optimizer",
    "adam_inverse_sqrt,lr=0.0001,warmup_updates=100",
    "--clip_grad_norm", "5.0", "--dropout", "0.1", "--attention_dropout",
    "0.1", "--mesh_fsdp", "2", "--mesh_tensor", "2", "--device", "cuda",
    "--exp_name", "p19", "--exp_id", "a"]
# (b)-(d) at fp32, depth 2, full width, a 32,002-word vocabulary (the
# comparison is of the sharded step, not of the 250,002-row table): the MCT
# step on fsdp 2 x tensor 2 against one process on the same global batch
# (rank 0 runs it); a planted fault (the row-parallel all-reduce skipped)
# must break the equality; tensor 2 alone (each data line of a data 2 x
# tensor 2 mesh runs the whole batch) at dropout and attention dropout 0.1
# with the fused residual dropout (#7/#8) against one process; MoE (4
# experts on every second block) on data 2 x expert 2 against one process;
# the checkpoint round trip, sharded -> one process -> sharded, bitwise.
# Per leaf relative to its largest entry or to P18_PARAM_FLOOR, as phase
# 18(a) holds its fp32 run.
P19_FP32_WORDS = 32002
P19_SPEC = "adam,lr=0.001,eps=0.001"
TOL_P19_FP32 = 1e-5


class PretrainRows:
    """MCT batches of `data.synthetic.make_pretrain_batch`, a stream seeded
    alike on every rank (the trainer takes every count-th batch of it on
    each batch shard)."""

    def __init__(self, seed, n_words):
        self.seed, self.n_words = seed, n_words

    def __len__(self):
        return 1 << 20

    def epoch_iterator(self, batch_size, epoch=0):
        import numpy as np

        from m3p_tpu_torch.data.synthetic import make_pretrain_batch

        rng = np.random.RandomState(self.seed + epoch)
        while True:
            yield make_pretrain_batch(rng, batch_size, P19_SAMPLE_N,
                                      P19_TEXT, P19_REGIONS, self.n_words)


def state_bytes(state):
    """This rank's bytes of parameters, gradients and optimizer state, and
    one process's (the whole shapes of the sharded leaves)."""
    import numpy as np
    import torch

    from m3p_tpu_torch.parallel.sharding import train_state_shardings
    from m3p_tpu_torch.parallel.tensor_parallel import shard_of

    params = list(state.model.parameters())

    def whole(t, spec):
        n = int(np.prod(spec.shape)) if spec is not None else t.numel()
        return n * t.element_size()

    out = {"params": [sum(p.numel() * p.element_size() for p in params),
                      sum(whole(p, shard_of(p)) for p in params)],
           "grads": [sum(p.grad.numel() * p.grad.element_size()
                         for p in params if p.grad is not None),
                     sum(whole(p.grad, shard_of(p)) for p in params
                         if p.grad is not None)]}
    specs = train_state_shardings(state)["opt_state"]
    local = whole_b = 0

    def walk(tree, spec):
        nonlocal local, whole_b
        if isinstance(tree, torch.Tensor):
            local += tree.numel() * tree.element_size()
            whole_b += whole(tree, spec)
        elif isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k] if isinstance(spec, dict) else None)
        elif isinstance(tree, (list, tuple)):
            for i, t in enumerate(tree):
                walk(t, spec[i] if isinstance(spec, (list, tuple))
                     else None)

    walk(state.opt_state, specs)
    out["optimizer"] = [local, whole_b]
    return out


def p19_preset(cfg):
    """19(a) on one rank: the preset's MCT steps through train_x.main."""
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch.data.loader import LoadedData
    from m3p_tpu_torch.parallel import data_parallel as DP
    from m3p_tpu_torch.parallel.mesh import COLLECTIVE_BYTES

    seed, tmp = cfg["seed"], cfg["tmp"]
    data = LoadedData(train_datasets={("rel", "coco"): PretrainRows(
        seed, 250002)}, tokenizer=None)
    rec = {"losses": [], "batches": [], "ms": [], "steps": []}
    snaps = []

    def on_step(trainer):
        snaps.append({"collective": dict(COLLECTIVE_BYTES),
                      "reduced": dict(DP.REDUCED_BYTES),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        if len(snaps) == 1:           # after the warm-up
            torch.cuda.reset_peak_memory_stats()
        rec["batches"].clear()        # keep no batch on the card

    zero_launch_counts()
    COLLECTIVE_BYTES.update(all_reduce=0, all_gather=0, reduce_scatter=0)
    DP.REDUCED_BYTES.update(gradients=0, steps=0)
    trainer, secs = p18_run_main(P19_ARGV + [
        "--dump_path", os.path.join(tmp, "dump"), "--seed", str(seed)],
        data, rec, on_step=on_step, save=False)
    attn = trainer.model.blocks[0].attn
    timed = snaps[-1]
    per_step = {k: (timed["collective"][k] - snaps[0]["collective"][k])
                / P19_TIMED for k in COLLECTIVE_BYTES}
    per_step["gradient_all_reduce"] = (
        timed["reduced"]["gradients"] - snaps[0]["reduced"]["gradients"]
    ) / P19_TIMED
    out = {"rank": dist.get_rank(), "seconds": secs,
           "mesh": {k: v for k, v in trainer.mesh.shape.items() if v > 1},
           "backend": trainer.mesh.backend,
           "n_total_iter": trainer.n_total_iter,
           "losses": [v for _, v in rec["losses"]],
           "ms": rec["ms"], "steps": rec["steps"],
           "bytes_per_step": per_step,
           "state_bytes": state_bytes(trainer.state),
           "peak_memory_gb": timed["peak_gb"],
           "local_heads": [attn.n_heads, attn.head_base, attn.heads_total],
           "n_layers": trainer.cfg.model.n_layers,
           "remat": trainer.cfg.model.remat,
           "dtype": trainer.cfg.model.dtype}
    del trainer
    torch.cuda.empty_cache()
    return out


def p19_model(seed, **kw):
    from m3p_tpu_torch.config import ModelConfig
    from m3p_tpu_torch.model import build_model

    cfg = ModelConfig(n_words=P19_FP32_WORDS, mask_index=P19_FP32_WORDS - 1,
                      n_langs=3, emb_dim=768, n_layers=2, n_heads=12,
                      max_region_num=P19_REGIONS, dtype="float32",
                      **{"dropout": 0.0, "attention_dropout": 0.0, **kw})
    return build_model(cfg, seed, "cuda")


def p19_batch(seed, n_words):
    import numpy as np

    from m3p_tpu_torch.data.synthetic import make_pretrain_batch

    return make_pretrain_batch(np.random.RandomState(seed), 4, 2, 24,
                               P19_REGIONS, n_words)


def leaf_gap(got, want):
    """The largest of each leaf's max |got - want| relative to its largest
    entry or to P18_PARAM_FLOOR."""
    worst, name = 0.0, None
    for n, w in want.items():
        scale = max(float(w.abs().max()), P18_PARAM_FLOOR)
        gap = float((got[n].float() - w.float()).abs().max()) / scale
        if gap > worst:
            worst, name = gap, n
    return worst, name


def p19_step(model, mesh, kind, batch, draws=None, gens=None, spec=P19_SPEC,
             shard_rows=True, reduce=True):
    """One step of ``kind`` ("mct" or "itm") over ``mesh`` (None: one
    process); ``shard_rows`` takes this rank's batch shard, ``reduce`` sets
    the state's mesh (the gradient reduction over the batch shards).
    Returns (loss, the whole parameters after the update, the state)."""
    import torch

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.parallel.sharding import batch_sharding, shard_batch
    from m3p_tpu_torch.parallel.tensor_parallel import gather_whole, shard_of
    from m3p_tpu_torch.train import steps as S
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    tb = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    d = dict(draws or {})
    if mesh is not None and shard_rows:
        sh = batch_sharding(mesh)
        tb = shard_batch(tb, sh)
        d = {k: (shard_batch(v, sh) if torch.is_tensor(v)
                 else [shard_batch(t, sh) for t in v]) for k, v in d.items()}
    tx, _ = build_optimizer(spec, clip_grad_norm=CLIP)
    state = create_train_state(model, tx, mesh if reduce else None)
    mask_cfg = bench.mask_config(model.cfg)
    det = gens is None

    def loss_fn(m, b, g):
        if kind == "mct":
            return S.mct_pretrain_loss(m, b, g, mask_cfg, 2, pack_ratio=0.5,
                                       deterministic=det, **d)
        return S.itm_finetune_loss(m, b, g, 2, deterministic=det)

    step = S.make_train_step(loss_fn)
    state, metrics = step(state, tb, gens)
    # the whole parameters alone (gathering the optimizer's moments too
    # tripled the bytes each check moved)
    params = {n: gather_whole(p.detach(), shard_of(p))
              for n, p in model.named_parameters()}
    return float(metrics["loss"]), params, state


# the rank of phase 19's launch that runs each check's one-process
# reference (rank 0 runs the checkpoint's)
P19_OWNER = {"b": 1, "tensor2_dropout": 2, "c_moe": 3}


def p19_checks(cfg):
    """19(b)-(d) on one rank; ranks 1-3 run the one-process references of
    (b), tensor 2 at dropout and (c), side by side after the sharded
    steps (`P19_OWNER`), rank 0 (d)'s."""
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch import checkpoint as ckpt
    from m3p_tpu_torch.config import MeshConfig
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.parallel import tensor_parallel as TP
    from m3p_tpu_torch.parallel.mesh import make_mesh
    from m3p_tpu_torch.parallel.sharding import (
        gather_train_state, shard_model)
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state
    from m3p_tpu_torch.train.steps import mct_draws

    seed, tmp = cfg["seed"] + 1, cfg["tmp"]
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    batch = p19_batch(seed, P19_FP32_WORDS)
    from m3p_tpu_torch import bench

    one = p19_model(seed)
    draws = mct_draws(torch.Generator(device="cuda").manual_seed(seed),
                      {k: torch.as_tensor(v).cuda()
                       for k, v in batch.items()},
                      bench.mask_config(one.cfg))
    del one

    # (b) fsdp 2 x tensor 2 against one process, then the planted fault
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2), dev)
    runs = {}
    for fault in (None, "row_no_reduce"):
        model = p19_model(seed)
        shard_model(model, mesh)
        with contextlib.ExitStack() as stack:
            if fault:
                stack.enter_context(patched(
                    __import__("m3p_tpu_torch.model.layers",
                               fromlist=["x"]), "reduce_from",
                    lambda make: (lambda x, m, a: x if a == "tensor"
                                  else TP.reduce_from(x, m, a))))
            loss, params, state = p19_step(model, mesh, "mct", batch, draws)
        runs[fault] = (loss, params)
        if fault is None:
            # (d) the sharded state saved, read back by one process
            path = os.path.join(tmp, "p19_sharded")
            ckpt.save_checkpoint(path, state, {"epoch": 1})
            saved = gather_train_state(state)
        del model, state
        torch.cuda.empty_cache()
    if rank != P19_OWNER["b"]:
        del runs
    dist.barrier()

    # (d) sharded -> one process -> sharded, bitwise
    if rank == 0:
        model = p19_model(seed)
        tx, _ = build_optimizer(P19_SPEC, clip_grad_norm=CLIP)
        st = create_train_state(model, tx)
        st, _ = ckpt.restore_checkpoint(os.path.join(tmp, "p19_sharded"), st)
        sd = model.state_dict()
        out["d"] = {"to_one_process_bitwise": all(
            torch.equal(sd[k], v) for k, v in saved["model"].items()) and all(
            torch.equal(a, b) for key in ("mu", "nu") for a, b in zip(
                st.opt_state[key], saved["opt_state"][key]))}
        # one process's save (`save_checkpoint` is collective in a group)
        os.makedirs(os.path.join(tmp, "p19_one"))
        torch.save({"model": model.state_dict(), "opt_state": st.opt_state,
                    "step": st.step},
                   os.path.join(tmp, "p19_one", ckpt.STATE_FILE))
        del model, st
    dist.barrier()
    model = p19_model(seed)
    shard_model(model, mesh)
    tx, _ = build_optimizer(P19_SPEC, clip_grad_norm=CLIP)
    st = create_train_state(model, tx, mesh)
    st, _ = ckpt.restore_checkpoint(os.path.join(tmp, "p19_one"), st)
    back = gather_train_state(st)
    blob = torch.load(os.path.join(tmp, "p19_one", "state.pt"),
                      map_location=dev, weights_only=True)
    out.setdefault("d", {})["to_sharded_bitwise"] = all(
        torch.equal(back["model"][k], v) for k, v in blob["model"].items())
    del model, st, back, blob
    torch.cuda.empty_cache()

    # tensor 2 alone at dropout 0.1, the fused residual dropout on
    rate = dict(dropout=RATE, attention_dropout=RATE, use_fused_dropout=True)
    mesh = make_mesh(MeshConfig(data=2, tensor=2), dev)
    model = p19_model(seed, **rate)
    shard_model(model, mesh)
    zero_launch_counts()
    loss, params, _ = p19_step(model, mesh, "itm", batch,
                               gens=Generators.from_seed(seed, "cuda"),
                               shard_rows=False, reduce=False)
    counts = launch_counts()
    del model
    dropout_run = (loss, params) if rank == P19_OWNER["tensor2_dropout"] \
        else None
    del params
    torch.cuda.empty_cache()

    # (c) MoE on data 2 x expert 2
    moe = dict(moe_experts=4, moe_interval=2)
    mesh = make_mesh(MeshConfig(data=2, expert=2), dev)
    model = p19_model(seed, **moe)
    shard_model(model, mesh)
    loss, params, _ = p19_step(model, mesh, "itm", batch)
    del model
    moe_run = (loss, params) if rank == P19_OWNER["c_moe"] else None
    del params
    torch.cuda.empty_cache()

    # the one-process references, each on its rank
    def compare(got, ref):
        gap, name = leaf_gap(got[1], ref[1])
        return {"loss": got[0], "one_process_loss": ref[0],
                "loss_gap": abs(got[0] - ref[0]) / abs(ref[0]),
                "param_gap": gap, "worst_leaf": name}

    if rank == P19_OWNER["b"]:
        ref = p19_step(p19_model(seed), None, "mct", batch, draws)
        out["b"] = {str(fault): compare(run, ref)
                    for fault, run in runs.items()}
        del runs, ref
    if dropout_run is not None:
        ref = p19_step(p19_model(seed, **rate), None, "itm", batch,
                       gens=Generators.from_seed(seed, "cuda"))
        out["tensor2_dropout"] = dict(compare(dropout_run, ref), launches={
            k: counts[k] for k in ("packed_fwd", "packed_bwd",
                                   "dropout_fwd", "dropout_bwd")})
        del dropout_run, ref
    if moe_run is not None:
        ref = p19_step(p19_model(seed, **moe), None, "itm", batch)
        out["c_moe"] = compare(moe_run, ref)
        del moe_run, ref
    torch.cuda.empty_cache()
    return out


def p19_rank(cfg):
    """A rank of phases 20, 19, 21, 22(b) and 18(b) (one launch: a launch
    costs about 20 s beyond its ranks' work on an H100 80GB HBM3 host):
    phase 20's part first, in fresh processes, then phase 19's (a), then
    (b)-(d), then phase 21's, then 22(b), then 18(b)'s; one JSON per
    rank."""
    import torch.distributed as dist

    from m3p_tpu_torch.parallel.mesh import auto_init_distributed

    auto_init_distributed("cuda")
    t = time.time()
    p20 = {"a": p20_full_width(cfg)}
    t1 = time.time()
    p20["b"] = p20_checks(cfg)
    p20["seconds"] = {"a": t1 - t, "b": time.time() - t1}
    t0 = time.time()
    out = {"p20": p20, "a": p19_preset(cfg)}
    t1 = time.time()
    out.update(p19_checks(cfg))
    t2 = time.time()
    out["seconds"] = {"a": t1 - t0, "checks": t2 - t1}
    p21 = {"a": p21_full_width(cfg)}
    t3 = time.time()
    p21["b"] = p21_checks(cfg)
    p21["seconds"] = {"a": t3 - t2, "b": time.time() - t3}
    out["p21"] = p21
    out["p22_moe"] = p22_moe(cfg)
    out["p18_sp"] = p18_sp_part(cfg)
    with open(f"{cfg['out']}.{dist.get_rank()}.json", "w") as f:
        json.dump(out, f)


# the heads a tensor rank holds whose offset phase 19 checks on the card:
# (head_base, heads) of a rank of tensor 2 (heads 6-11), of tensor 5 in
# the padded layout (ceil(12 / 5) = 3 a rank: rank 3's 9-11) and of tensor
# 8 (2 a rank: rank 5's 10-11)
HEAD_OFFSET_CASES = ((6, 6), (9, 3), (10, 2))


def check_head_offset():
    """Module 3 on the card: kernels #1-#6 over the heads of each of
    `HEAD_OFFSET_CASES` (heads 6-11, 9-11 and 10-11 of 12: ``head_base``
    and ``heads_total`` 12) at rate 0.1 give bitwise the slice of the call
    over all 12 heads, forward and backward, bf16 and fp32."""
    import torch

    from m3p_tpu_torch.ops import attention as A

    b, s, h, dh, rate, seed = 4, 68, 12, 64, 0.1, 20260
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(7)
        q, k, v, do = (torch.randn(b, s, h * dh, device="cuda", generator=g
                                   ).to(dtype) for _ in range(4))
        mask = torch.arange(s, device="cuda")[None] < torch.tensor(
            [[s], [s - 5], [s], [40]], device="cuda")
        sc = dh ** -0.5
        whole = A._launch_fwd(q, k, v, mask, h, False, sc, rate, seed)
        gw = A._launch_bwd(q, k, v, mask, do, h, False, sc, rate, seed)
        fo, fs = A._launch_flash_fwd(q, k, v, mask, h, False, sc, rate, seed)
        fw = A._launch_flash_bwd(q, k, v, mask, fo, fs, do, h, False, sc,
                                 rate, seed)
        hm = [t.view(b, s, h, dh).transpose(1, 2) for t in (q, k, v, do)]
        so = A._launch_small_fwd(*hm[:3], mask, False, sc, rate, seed)
        sw = A._launch_small_bwd(*hm[:3], mask, hm[3], False, sc, rate, seed)
        for base, n in HEAD_OFFSET_CASES:
            cols = slice(base * dh, (base + n) * dh)
            heads = slice(base, base + n)
            part = [t[..., cols] for t in (q, k, v)]
            mine = dict(head_base=base, heads_total=h)
            gaps = {}
            got = A._launch_fwd(*part, mask, n, False, sc, rate, seed, **mine)
            gaps["packed_fwd"] = (whole[..., cols] - got).abs().max().item()
            gm = A._launch_bwd(*part, mask, do[..., cols], n, False, sc,
                               rate, seed, **mine)
            gaps["packed_bwd"] = max((a[..., cols] - c).abs().max().item()
                                     for a, c in zip(gw, gm))
            mo, ms = A._launch_flash_fwd(*part, mask, n, False, sc, rate,
                                         seed, **mine)
            gaps["flash_fwd"] = max((fo[..., cols] - mo).abs().max().item(),
                                    (fs[:, heads] - ms).abs().max().item())
            gm = A._launch_flash_bwd(*part, mask, mo, ms, do[..., cols], n,
                                     False, sc, rate, seed, **mine)
            gaps["flash_bwd"] = max((a[..., cols] - c).abs().max().item()
                                    for a, c in zip(fw, gm))
            sm = A._launch_small_fwd(*(t[:, heads] for t in hm[:3]), mask,
                                     False, sc, rate, seed, **mine)
            gaps["small_fwd"] = (so[:, heads] - sm).abs().max().item()
            gm = A._launch_small_bwd(*(t[:, heads] for t in hm[:3]), mask,
                                     hm[3][:, heads], False, sc, rate, seed,
                                     **mine)
            gaps["small_bwd"] = max((a[:, heads] - c).abs().max().item()
                                    for a, c in zip(sw, gm))
            # and a slice drawn as a call of its own draws other masks
            plain = A._launch_fwd(*part, mask, n, False, sc, rate, seed)
            gaps["own_call_differs"] = (whole[..., cols] - plain).abs().max(
                ).item()
            name = str(dtype).replace("torch.", "")
            out[f"{name}_heads_{base}_{base + n - 1}"] = gaps
    torch.cuda.synchronize()
    for case, gaps in out.items():
        bad = {k: v for k, v in gaps.items()
               if (v != 0.0) != (k == "own_call_differs")}
        if bad:
            fail(f"phase 19: a call over some heads of 12 did not draw its "
                 f"slice of the full call's masks ({case}): {bad}")
    return out


def remat_memory(seed):
    """The preset's MCT forward and backward in this process, bf16, on one
    model with remat off and on in turns (off, on, on, off): the peak
    memory over the parameters' and the ms of each (the optimizer's
    update, whose temporaries are the same either way, left out)."""
    import torch

    from m3p_tpu_torch.config import scale_up_config
    from m3p_tpu_torch.data.masking import MaskingConfig
    from m3p_tpu_torch.model import build_model
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train import steps as S

    batch = next(PretrainRows(seed, 250002).epoch_iterator(P19_B // 2))
    cfg = scale_up_config().model
    model = build_model(cfg, seed, "cuda")
    tb = S.expand_compact_batch({k: torch.as_tensor(v).cuda()
                                 for k, v in batch.items()})
    mask = MaskingConfig(n_words=cfg.n_words, mask_index=cfg.mask_index)
    runs = {"plain": [], "remat": []}
    for remat in (False, True, True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, _ = S.mct_pretrain_loss(model, tb, Generators.from_seed(
            seed, "cuda"), mask, P19_SAMPLE_N, pack_ratio=0.5)
        loss.backward()
        torch.cuda.synchronize()
        runs["remat" if remat else "plain"].append({
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "ms": (time.perf_counter() - t) * 1e3, "loss": float(loss)})
    del model, tb
    torch.cuda.empty_cache()
    plain = min(r["peak_gb"] for r in runs["plain"])
    remat = max(r["peak_gb"] for r in runs["remat"])
    if not remat < plain:
        fail(f"phase 19: remat did not lower the step's peak memory: {runs}")
    if len({r["loss"] for rs in runs.values() for r in rs}) != 1:
        fail(f"phase 19: remat changed the loss: {runs}")
    return {"batch_rows": P19_B // 2 * P19_SAMPLE_N, **runs}


def sharding_slice(seed):
    """Phase 19: (a)-(d) on 4 ranks (`p19_rank`), the head offset on the
    card, remat's memory.  Its launch is shared with phases 20 (which
    runs first on the ranks), 21 and 18(b) (last: phase 19's part once
    took twice as long on ranks that had run 18(b) first).  Returns
    (phase 19's numbers, the other parts' results: by rank under "p20"
    and "p21", and 18(b)'s (launch seconds, results by rank, rank 0's
    fp32 gradients) under "p18_sp")."""
    import torch

    t0 = time.time()
    heads = check_head_offset()
    sublap("p19_head_offset")
    with tempfile.TemporaryDirectory() as tmp:
        secs, ranks = p18_launch("p19", P19_RANKS, {"seed": seed,
                                                    "tmp": tmp})
        sp_grads = torch.load(os.path.join(tmp, P18_SP_GRADS),
                              weights_only=True)
    sublap("p19_ranks")
    n_layers, refine = 24, 3
    want = {"packed_fwd": 2 * n_layers + refine,
            "packed_bwd": 2 * (n_layers + refine)}
    problems = []
    for r, res in enumerate(ranks):
        a = res["a"]
        if a["n_total_iter"] != 1 + P19_TIMED:
            problems.append(f"rank {r} took {a['n_total_iter']} steps")
        if a["local_heads"][0] != 6 or a["local_heads"][2] != 12:
            problems.append(f"rank {r} heads {a['local_heads']}")
        for kind, counts in a["steps"]:
            if {k: counts[k] for k in want} != want:
                problems.append(f"rank {r} {kind} launches {counts}")
        if not all(map(math.isfinite, a["losses"])):
            problems.append(f"rank {r} losses {a['losses']}")
        for part, (mine, whole) in a["state_bytes"].items():
            if not 0 < mine <= 0.3 * whole:
                problems.append(f"rank {r} holds {mine} of {whole} {part} "
                                "bytes")
    zero = ranks[0]
    b = ranks[P19_OWNER["b"]]["b"]
    checks = {key: ranks[P19_OWNER[key]][key]
              for key in ("tensor2_dropout", "c_moe")}
    if not (b["None"]["loss_gap"] <= TOL_P19_FP32
            and b["None"]["param_gap"] <= TOL_P19_FP32):
        problems.append(f"fsdp 2 x tensor 2 is not the one-process step: "
                        f"{b['None']}")
    fault = b["row_no_reduce"]
    if max(fault["loss_gap"], fault["param_gap"]) <= TOL_P19_FP32:
        problems.append(f"the planted fault was not seen: {fault}")
    for key in ("tensor2_dropout", "c_moe"):
        if not (checks[key]["loss_gap"] <= TOL_P19_FP32
                and checks[key]["param_gap"] <= TOL_P19_FP32):
            problems.append(f"{key} is not the one-process step: "
                            f"{checks[key]}")
    if checks["tensor2_dropout"]["launches"]["dropout_fwd"] == 0:
        problems.append("tensor 2 at dropout launched no #7")
    if not all(r["d"]["to_sharded_bitwise"] for r in ranks) or not zero[
            "d"]["to_one_process_bitwise"]:
        problems.append(f"the checkpoint round trip is not bitwise: "
                        f"{[r['d'] for r in ranks]}")
    if problems:
        fail("phase 19: " + "; ".join(problems))
    remat = remat_memory(seed)
    sublap("p19_remat_memory")
    a = zero["a"]
    out = {"launch_s": secs, "ranks": P19_RANKS, "mesh": a["mesh"],
           "backend": a["backend"], "rank0_s": zero["seconds"],
           "preset": {"n_layers": a["n_layers"], "remat": a["remat"],
                      "dtype": a["dtype"], "local_heads": a["local_heads"],
                      "batch": [P19_B, P19_SAMPLE_N, P19_TEXT,
                                P19_REGIONS]},
           "ms_per_step_per_rank": {r: res["a"]["ms"][1:]
                                    for r, res in enumerate(ranks)},
           "warmup_ms_per_rank": {r: res["a"]["ms"][0]
                                  for r, res in enumerate(ranks)},
           "losses_rank0": a["losses"],
           "bytes_per_step_rank0": a["bytes_per_step"],
           "state_bytes_rank0": a["state_bytes"],
           "state_share_rank0": {k: v[0] / v[1]
                                 for k, v in a["state_bytes"].items()},
           "peak_memory_gb_per_rank": {r: res["a"]["peak_memory_gb"]
                                       for r, res in enumerate(ranks)},
           "launches_per_step": want,
           "launches_per_rank": {r: {k: sum(c[k] for _, c in res["a"][
               "steps"]) for k in want} for r, res in enumerate(ranks)},
           "fp32": {"fsdp2_tensor2": b["None"],
                    "planted_row_no_reduce": fault,
                    "tensor2_dropout": checks["tensor2_dropout"],
                    "moe_data2_expert2": checks["c_moe"],
                    "checkpoint": [r["d"] for r in ranks]},
           "head_offset_max_abs_diff": heads, "remat": remat,
           "phase_s": time.time() - t0 - sum(
               zero["p20"]["seconds"].values()) - sum(
               zero["p21"]["seconds"].values()) - sum(
               zero["p18_sp"]["seconds"].values())
               - zero["p22_moe"]["seconds"]}
    log(f"[sharding] phase 19: {json.dumps(out)}")
    shared = {part: [dict(res[part], launch_s=secs) for res in ranks]
              for part in ("p20", "p21")}
    shared["p22_moe"] = [res["p22_moe"] for res in ranks]
    shared["p18_sp"] = (secs, [res["p18_sp"] for res in ranks], sp_grads)
    return out, shared


# ---------------------------------------------------------------------------
# phase 20: the GPipe pipeline over ranks sharing the card
# ---------------------------------------------------------------------------

# (a) the flagship (12 x 768, 12 heads, 250,002 words, bf16, dropout and
# attention dropout 0.1) through `train_x.main` on phase 19's 4 ranks
# (`p19_rank` runs this part first) as pp 2 x data 2
# with 4 microbatches: the ITM fine-tune step (refiner on), one warm-up and
# P20_TIMED timed micro-steps; a data shard's 32 rows (8 groups of 4) at 64
# tokens and 100 regions make microbatches of 8 rows of 164 positions.
P20_TIMED = 1
P20_B, P20_SAMPLE_N, P20_TEXT, P20_REGIONS = 16, 4, 64, 100
P20_STAGES, P20_M, P20_LAYERS, P20_REFINE = 2, 4, 12, 3
P20_ARGV = [
    "--lgs", "en", "--emb_dim", "768", "--n_layers", str(P20_LAYERS),
    "--n_heads", "12", "--fp16", "True", "--cross_rel_steps", "coco-img",
    "--refine_image", "True", "--batch_size", str(P20_B),
    "--sample_n", str(P20_SAMPLE_N), "--max_len", str(P20_TEXT),
    "--max_region_num", str(P20_REGIONS),
    "--epoch_size", str(P20_B * (1 + P20_TIMED)), "--max_epoch", "1",
    "--use_grain", "False", "--optimizer",
    "adam_inverse_sqrt,lr=0.0001,warmup_updates=100",
    "--clip_grad_norm", str(CLIP), "--dropout", str(RATE),
    "--attention_dropout", str(RATE), "--pp_stages", str(P20_STAGES),
    "--pp_microbatches", str(P20_M), "--mesh_data", "2", "--device", "cuda",
    "--exp_name", "p20", "--exp_id", "a"]
# (b) fp32 at depth 4, full width, a 32,002-word vocabulary (as phase 19
# cuts it): the ITM step on pp 2 x data 2 (2 microbatches of a shard's 4
# rows) and on pp 2 x fsdp 2 against one process on the same global
# batch, per leaf at TOL_P19_FP32; the planted fault (``pp`` left out of
# the gradient reduction) must break it; at dropout 0.1 with the fused
# residual dropout
# (#7), the pipelined forward against one process fed the same
# per-(microbatch, layer) seeds (a one-stage `PPModel`).
P20_CHECK_LAYERS, P20_CHECK_M = 4, 2


class RetrievalRows:
    """ITM retrieval batches of `data.synthetic.make_retrieval_batch`, a
    stream seeded alike on every rank (each batch shard takes every
    count-th batch of it)."""

    def __init__(self, seed, n_words):
        self.seed, self.n_words = seed, n_words

    def __len__(self):
        return 1 << 20

    def epoch_iterator(self, batch_size, epoch=0):
        import numpy as np

        from m3p_tpu_torch.data.synthetic import make_retrieval_batch

        rng = np.random.RandomState(self.seed + epoch)
        while True:
            yield make_retrieval_batch(rng, batch_size, P20_SAMPLE_N,
                                       P20_TEXT, P20_REGIONS, self.n_words)


def p20_launches_per_step():
    """#1 / #2 a rank a step: each of the M microbatches through the
    stage's n_layers / S blocks, the refiner's 3 on every rank (bubble
    steps compute nothing); #2 twice that."""
    fwd = P20_M * P20_LAYERS // P20_STAGES + P20_REFINE
    return {"packed_fwd": fwd, "packed_bwd": 2 * fwd}


def p20_boundary_bytes():
    """The bytes of one microbatch's activation at a stage boundary:
    (B / data / M, S, 768) bf16."""
    rows = P20_B // 2 * P20_SAMPLE_N // P20_M
    return rows * (P20_TEXT + P20_REGIONS) * 768 * 2


def p20_full_width(cfg):
    """20(a) on one rank: the flagship ITM steps through train_x.main."""
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch.data.loader import LoadedData
    from m3p_tpu_torch.parallel import data_parallel as DP
    from m3p_tpu_torch.parallel import mesh as PM

    seed, tmp = cfg["seed"], cfg["tmp"]
    data = LoadedData(train_datasets={("rel", "coco"): RetrievalRows(
        seed, 250002)}, tokenizer=None)
    rec = {"losses": [], "batches": [], "ms": [], "steps": []}
    snaps = []

    def on_step(trainer):
        snaps.append({"p2p": dict(PM.P2P_BYTES),
                      "collective": dict(PM.COLLECTIVE_BYTES),
                      "staged": dict(PM.HOST_STAGED_BYTES),
                      "reduced": dict(DP.REDUCED_BYTES),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        if len(snaps) == 1:           # after the warm-up
            torch.cuda.reset_peak_memory_stats()
        rec["batches"].clear()

    zero_launch_counts()
    trainer, secs = p18_run_main(P20_ARGV + [
        "--dump_path", os.path.join(tmp, "dump"), "--seed", str(seed)],
        data, rec, on_step=on_step, save=False)
    first, timed = snaps[0], snaps[-1]

    def per_step(key):
        return {k: (timed[key][k] - first[key][k]) / P20_TIMED
                for k in timed[key]}

    out = {"rank": dist.get_rank(), "seconds": secs,
           "stage": trainer.mesh.index("pp"),
           "mesh": {k: v for k, v in trainer.mesh.shape.items() if v > 1},
           "backend": trainer.mesh.backend,
           "shard": trainer.shard_index,
           "loss_model": type(trainer.loss_model).__name__,
           "n_total_iter": trainer.n_total_iter,
           "losses": [v for _, v in rec["losses"]],
           "ms": rec["ms"], "steps": rec["steps"],
           "p2p_bytes_per_step": per_step("p2p"),
           "collective_bytes_per_step": per_step("collective"),
           "staged_bytes_per_step": per_step("staged"),
           "gradient_bytes_per_step": per_step("reduced")["gradients"],
           "peak_memory_gb": timed["peak_gb"]}
    del trainer
    torch.cuda.empty_cache()
    return out


def p20_model(seed, **kw):
    from m3p_tpu_torch.config import ModelConfig
    from m3p_tpu_torch.model import build_model

    cfg = ModelConfig(n_words=P19_FP32_WORDS, mask_index=P19_FP32_WORDS - 1,
                      n_langs=3, emb_dim=768, n_layers=P20_CHECK_LAYERS,
                      n_heads=12, max_region_num=P19_REGIONS,
                      dtype="float32",
                      **{"dropout": 0.0, "attention_dropout": 0.0, **kw})
    return build_model(cfg, seed, "cuda")


def p20_step(model, mesh, batch, fault=None):
    """One deterministic ITM step (refiner on) on ``mesh``'s batch shard
    with the stack pipelined (None: one process); ``fault`` "pp_no_reduce"
    leaves ``pp`` out of the gradient reduction.  Returns (loss, the
    parameters after the update)."""
    import torch

    from m3p_tpu_torch.parallel import data_parallel as DP
    from m3p_tpu_torch.parallel.pipeline import PPModel
    from m3p_tpu_torch.parallel.sharding import (
        batch_sharding, is_sharded, shard_batch, shard_model)
    from m3p_tpu_torch.parallel.tensor_parallel import gather_whole, shard_of
    from m3p_tpu_torch.train import steps as S
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    tb = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    handle = model
    if mesh is not None:
        if is_sharded(mesh.shape):
            shard_model(model, mesh)
        tb = shard_batch(tb, batch_sharding(mesh))
        handle = PPModel(model, mesh, n_microbatches=P20_CHECK_M)
    tx, _ = build_optimizer(P19_SPEC, clip_grad_norm=CLIP)
    state = create_train_state(model, tx, mesh)
    step = S.make_train_step(lambda m, b, g: S.itm_finetune_loss(
        handle, b, g, 2, deterministic=True))
    with contextlib.ExitStack() as stack:
        if fault == "pp_no_reduce":
            stack.enter_context(patched(DP, "GRAD_AXES", lambda axes: tuple(
                a for a in axes if a != "pp")))
        _, metrics = step(state, tb, None)
    return float(metrics["loss"]), {
        n: gather_whole(p.detach(), shard_of(p))
        for n, p in model.named_parameters()}


def p20_checks(cfg):
    """20(b) on one rank; rank 0 runs the one-process reference."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch.config import MeshConfig
    from m3p_tpu_torch.data.synthetic import make_retrieval_batch
    from m3p_tpu_torch.model import lengths_to_mask
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.parallel.mesh import Mesh, make_mesh
    from m3p_tpu_torch.parallel.pipeline import PPModel
    from m3p_tpu_torch.parallel.sharding import batch_sharding, shard_batch

    seed = cfg["seed"] + 2
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = make_retrieval_batch(np.random.RandomState(seed), 4, 2, 24,
                                 P19_REGIONS, P19_FP32_WORDS)
    ref = p20_step(p20_model(seed), None, batch) if rank == 0 else None
    fsdp = make_mesh(MeshConfig(data=1, fsdp=2, pp=P20_STAGES), dev)
    mesh = make_mesh(MeshConfig(data=2, pp=P20_STAGES), dev)
    out = {"stage": mesh.index("pp")}
    for key, m, fault in (("None", mesh, None),
                          ("pp_no_reduce", mesh, "pp_no_reduce"),
                          ("fsdp2", fsdp, None)):
        loss, params = p20_step(p20_model(seed), m, batch, fault)
        if rank == 0:
            gap, name = leaf_gap(params, ref[1])
            out[key] = {"loss": loss, "one_process_loss": ref[0],
                        "loss_gap": abs(loss - ref[0]) / abs(ref[0]),
                        "param_gap": gap, "worst_leaf": name}
        del params
        torch.cuda.empty_cache()
    # the training forward at dropout 0.1 (#7 in the blocks) against one
    # stage fed the same generators
    model = p20_model(seed, dropout=RATE, attention_dropout=RATE,
                      use_fused_dropout=True)
    tb = shard_batch({k: torch.as_tensor(v).cuda() for k, v in
                      batch.items()}, batch_sharding(mesh))
    args = (tb["tokens"].long(),
            lengths_to_mask(tb["text_len"], tb["tokens"].shape[1]),
            tb["feats"], tb["locs"],
            lengths_to_mask(tb["img_len"], tb["feats"].shape[1]), True,
            False)
    one_stage = Mesh((1,) * 6, 0, dev, None)
    outs = []
    zero_launch_counts()
    with torch.no_grad():
        for m in (mesh, one_stage):
            gen = Generators.from_seed(seed, "cuda", mesh.batch_shards[0])
            outs.append(PPModel(model, m, n_microbatches=P20_CHECK_M)
                        .encode_joint(*args, gen))
            if m is mesh:
                counts = launch_counts()
    out["dropout"] = {
        "max_rel": float((outs[0] - outs[1]).abs().max()
                         / outs[1].abs().max()),
        "vs_deterministic": float((outs[0] - model.encode_joint(
            *args[:5], True).detach()).abs().max()),
        "launches": {k: counts[k] for k in ("packed_fwd", "dropout_fwd")}}
    del model, outs
    torch.cuda.empty_cache()
    return out


def pipeline_slice(ranks):
    """Phase 20: (a) and (b) on the 4 ranks of phase 19's launch, sharing
    the card (`p19_rank` runs them first): ``ranks`` holds each rank's
    results.  Their times are gloo's host transport's, not a parallel
    speed.  The phase's own clock is rank 0's seconds over its part and
    this check."""
    t0 = time.time()
    secs = ranks[0]["launch_s"]
    ranks = [{"a": r["a"], "b": r["b"], "seconds": r["seconds"]}
             for r in ranks]
    want = p20_launches_per_step()
    boundary = p20_boundary_bytes()
    problems = []
    for r, res in enumerate(ranks):
        a = res["a"]
        if a["n_total_iter"] != 1 + P20_TIMED:
            problems.append(f"rank {r} took {a['n_total_iter']} steps")
        if a["loss_model"] != "PPModel":
            problems.append(f"rank {r} ran {a['loss_model']}")
        for kind, counts in a["steps"]:
            if {k: counts[k] for k in want} != want:
                problems.append(f"rank {r} {kind} launches {counts}")
        if not all(map(math.isfinite, a["losses"])):
            problems.append(f"rank {r} losses {a['losses']}")
        p2p = a["p2p_bytes_per_step"]
        if p2p != {"sent": P20_M * boundary, "received": P20_M * boundary}:
            problems.append(f"rank {r} exchanged {p2p}, not {P20_M} x "
                            f"{boundary} bytes each way")
    # the ranks of a pp line compute the same loss
    for r, res in enumerate(ranks):
        mate = next(m for m in ranks if m["a"]["shard"] == res["a"]["shard"]
                    and m is not res)
        if res["a"]["losses"] != mate["a"]["losses"]:
            problems.append(f"rank {r}'s losses are not its pp line's")
    b = ranks[0]["b"]
    for key in ("None", "fsdp2"):
        if not (b[key]["loss_gap"] <= TOL_P19_FP32
                and b[key]["param_gap"] <= TOL_P19_FP32):
            problems.append(f"pp 2 x {key} is not the one-process step: "
                            f"{b[key]}")
    fault = b["pp_no_reduce"]
    if max(fault["loss_gap"], fault["param_gap"]) <= TOL_P19_FP32:
        problems.append(f"the planted fault was not seen: {fault}")
    for r, res in enumerate(ranks):
        d = res["b"]["dropout"]
        if d["max_rel"] > TOL_P19_FP32 or d["vs_deterministic"] < 1e-3:
            problems.append(f"rank {r} dropout: {d}")
        if d["launches"]["dropout_fwd"] == 0:
            problems.append(f"rank {r} launched no #7 in its stage")
    if problems:
        fail("phase 20: " + "; ".join(problems))
    a = ranks[0]["a"]
    out = {"launch_s": secs, "ranks": P19_RANKS, "mesh": a["mesh"],
           "backend": a["backend"], "rank0_s": ranks[0]["seconds"],
           "microbatches": P20_M,
           "batch": [P20_B, P20_SAMPLE_N, P20_TEXT, P20_REGIONS],
           "stages": {r: res["a"]["stage"] for r, res in enumerate(ranks)},
           "ms_per_step_per_rank": {r: res["a"]["ms"][1:]
                                    for r, res in enumerate(ranks)},
           "warmup_ms_per_rank": {r: res["a"]["ms"][0]
                                  for r, res in enumerate(ranks)},
           "losses_rank0": a["losses"],
           "boundary_bytes": boundary,
           "p2p_bytes_per_step_rank0": a["p2p_bytes_per_step"],
           "collective_bytes_per_step_rank0":
               a["collective_bytes_per_step"],
           "staged_bytes_per_step_rank0": a["staged_bytes_per_step"],
           "gradient_bytes_per_step_rank0": a["gradient_bytes_per_step"],
           "peak_memory_gb_per_rank": {r: res["a"]["peak_memory_gb"]
                                       for r, res in enumerate(ranks)},
           "launches_per_step": want,
           "launches_per_rank": {r: {k: sum(c[k] for _, c in res["a"][
               "steps"]) for k in want} for r, res in enumerate(ranks)},
           "fp32": {"pp2_data2": b["None"], "pp2_fsdp2": b["fsdp2"],
                    "planted_pp_no_reduce": fault,
                    "dropout": {r: res["b"]["dropout"]
                                for r, res in enumerate(ranks)}},
           "phase_s": time.time() - t0 + sum(
               ranks[0]["seconds"].values())}
    log(f"[pipeline] phase 20: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 21: the configurations sharding refused before -- the int8 modes and
# the adaptive softmax under tensor, int8 tables over sharded parameters,
# uneven splits
# ---------------------------------------------------------------------------

# On phase 19's 4 ranks sharing the card over gloo (`p19_rank` runs this
# part after phase 19's), so the times are the host transport's, not a
# parallel speed.
#
# (a) phase 19(a)'s scale-up preset, batch and mesh (fsdp 2 x tensor 2)
# with the int8 FFN and head (`P21_QUANT`) through the port's Trainer
# (`train_x.main` with the modes set on its config: neither train_x has
# --ffn_quant), one warm-up and P21_TIMED timed micro-steps; #1 / #2 as in
# phase 19(a).
P21_TIMED = 1
P21_QUANT = dict(ffn_quant="int8_bwd", head_quant="int8_bwd")
P21_ARGV = [("p21" if a == "p19" else a) for a in P19_ARGV]
# the amax all-reduces a step a rank of (a): in each of the 24 blocks
# under remat, lin1's dgrad (g and w per row over N, split by tensor) 2,
# lin2's forward (x and w along K, split by tensor) 2 and again in the
# recompute 2, the two wgrads' x and g along the rows over fsdp 4; the
# word head's dgrad (g and the table along the vocabulary) 2 and its
# wgrad's rows 2
P21_AMAX_PER_STEP = 24 * (2 + 2 + 2 + 4) + 4
# (b) fp32 at depth 2, full width, 32,002 words (phase 19's checks'
# model), each step against one process: the loss, and each parameter
# leaf relative to its largest entry or P18_PARAM_FLOOR.  The float steps
# within TOL_P21_FP32, as phase 19 holds its steps.  An activation an ulp
# off one process's (the ranks sum in other orders) can cross a rounding
# boundary of an int8 step, so an int8 step is held to one int8 step's
# effect, as the CPU tests hold it against JAX: the loss within
# TOL_P21_INT8_LOSS relative and each leaf within TOL_P21_INT8 (a step
# has read 5.9e-3-1.01e-2 of a leaf on an H100).  A wrong scale moves a
# step by re-rounding too, so the steps cannot tell one: the scales are
# held exactly at the GEMMs and at the modules (below), where the planted
# faults read 10x the tolerance or more.
TOL_P21_FP32 = 1e-5
TOL_P21_INT8 = 3e-2
TOL_P21_INT8_LOSS = 2e-3
# the int8 GEMMs alone, and each int8 module as the sharded model wires
# it, on the card at full-width shapes, each rank's part against the same
# function on the whole operands: the quantized values are the whole's,
# so the outputs differ by the fp32 sums of the ranks' parts alone; the
# planted faults (an amax that tensor splits taken rank-local; the
# wgrads' rows rank-local, fault 16's parent) must read 10x this
TOL_P21_GEMM = 1e-5
P21_GEMM_SHAPE = (1024, 768, 3072)
# (the model's modes, its modules and their planted faults): the first
# block's FFN GEMMs (column- / row-parallel `QuantDense`s), its fused
# int8 Q/K/V, the word head over vocabulary shards, lin2's row-parallel
# frozen-weight table; on data 2 x tensor 2 at P21_MODULE_ROWS rows.  The
# straight-through "int8" lin1 quantizes along K = embed alone, which no
# rank splits: no fault can show there.
P21_MODULES = (
    (P21_QUANT, (("lin1", ("amax_local", "rows_local")),
                 ("lin2", ("amax_local", "rows_local")),
                 ("head", ("amax_local", "rows_local")),
                 ("q8_lin2", ("amax_local",)))),
    (dict(ffn_quant="int8"), (("lin1", ()), ("lin2", ("amax_local",)))),
    (dict(ffn_quant="int8_all"), (("qkv", ("amax_local", "rows_local")),)))
P21_MODULE_ROWS = 1024
P21_EVAL = dict(images=4, beam=2, max_len=8)


def p21_config(make):
    """`train_x.args_to_config` with `P21_QUANT` on the model."""
    def to_config(args):
        cfg = make(args)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **P21_QUANT))
    return to_config


def p21_int8_counts():
    from m3p_tpu_torch.ops import quant

    return {name: dict(getattr(quant, name).calls_by_route)
            for name in ("int8_matmul_qbwd", "int8_matmul_nt")}


def p21_full_width(cfg):
    """21(a) on one rank: the preset's int8 MCT steps through
    train_x.main."""
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.data.loader import LoadedData
    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.parallel import data_parallel as DP
    from m3p_tpu_torch.parallel.mesh import COLLECTIVE_BYTES

    seed, tmp = cfg["seed"], cfg["tmp"]
    data = LoadedData(train_datasets={("rel", "coco"): PretrainRows(
        seed, 250002)}, tokenizer=None)
    rec = {"losses": [], "batches": [], "ms": [], "steps": []}
    snaps = []

    def on_step(trainer):
        snaps.append({"collective": dict(COLLECTIVE_BYTES),
                      "reduced": dict(DP.REDUCED_BYTES),
                      "amax": dict(quant.AMAX_REDUCED),
                      "int8": p21_int8_counts(),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        if len(snaps) == 1:           # after the warm-up
            torch.cuda.reset_peak_memory_stats()
        rec["batches"].clear()

    zero_launch_counts()
    quant.zero_counts()
    with patched(train_x, "args_to_config", p21_config):
        trainer, secs = p18_run_main(P21_ARGV + [
            "--dump_path", os.path.join(tmp, "dump"), "--seed", str(seed)],
            data, rec, on_step=on_step, save=False)
    first, timed = snaps[0], snaps[-1]

    def per_step(key):
        return {k: (timed[key][k] - first[key][k]) / P21_TIMED
                for k in timed[key]}

    ffn = trainer.model.blocks[0].ffn
    out = {"rank": dist.get_rank(), "seconds": secs,
           "mesh": {k: v for k, v in trainer.mesh.shape.items() if v > 1},
           "quant": [trainer.cfg.model.ffn_quant,
                     trainer.cfg.model.head_quant],
           "ffn_modules": [type(ffn.lin1).__name__,
                           ffn.lin1.keep == ("tensor",)
                           and ffn.lin1.row_parallel is None,
                           ffn.lin2.row_parallel is not None],
           "n_total_iter": trainer.n_total_iter,
           "losses": [v for _, v in rec["losses"]],
           "ms": rec["ms"], "steps": rec["steps"],
           "collective_bytes_per_step": per_step("collective"),
           "amax_reduced_per_step": per_step("amax"),
           "gradient_bytes_per_step": per_step("reduced")["gradients"],
           "int8_gemms_per_step": {
               name: {r: (timed["int8"][name][r] - first["int8"][name][r])
                      / P21_TIMED for r in routes}
               for name, routes in timed["int8"].items()},
           "peak_memory_gb": timed["peak_gb"]}
    del trainer
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def p21_sharded(mesh, fault=None, every_amax=False):
    """The block in which a rank runs its part of an int8 GEMM or module:
    the batch shards of ``mesh`` reduced (`batch_reduction`), and
    ``fault`` planted: "amax_local" takes the amaxes that ``tensor``
    splits rank-local (``every_amax``: every amax), "rows_local" the
    wgrads' amaxes over this rank's rows alone (fault 16's parent)."""
    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.parallel.data_parallel import batch_reduction

    def local(amax):
        return lambda xf, axis, over: amax(xf, axis, None if every_amax or (
            over and over[1] == "tensor") else over)

    with contextlib.ExitStack() as stack:
        stack.enter_context(batch_reduction(mesh))
        if fault == "amax_local":
            stack.enter_context(patched(quant, "_amax", local))
        elif fault == "rows_local":
            stack.enter_context(patched(quant, "batch_line",
                                        lambda _: (lambda: None)))
        yield


def p21_gemm_gap(case, mesh, fault=None):
    """One int8 training GEMM on the card (P21_GEMM_SHAPE; the vocab head
    at (512, 768, 32002)) on ``mesh``, this rank's part against the GEMM
    on the whole operands, which every rank computes: the largest gap of
    y, dx or dw relative to its largest entry, over the ranks.  ``case``:
    "rows" / "nt_rows" (`int8_matmul_qbwd` / `_nt` with the rows over the
    batch shards), "col" / "row" (N / K over ``tensor``), "nt_vocab" (the
    vocabulary over ``tensor``, padded where it does not divide).
    ``fault``: "amax_local" (every amax rank-local) or "rows_local" (the
    wgrads' rows this rank's, fault 16's parent)."""
    import torch

    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.parallel import mesh as PM
    from m3p_tpu_torch.parallel.data_parallel import BATCH_AXES
    from m3p_tpu_torch.parallel.tensor_parallel import shard_width

    gen = torch.Generator(device="cuda").manual_seed(2100)
    nt = case.startswith("nt")
    m, k, n = (512, 768, 32002) if nt else P21_GEMM_SHAPE

    def draw(rows, cols):
        return (torch.randn(rows, cols, device="cuda", generator=gen)
                * torch.rand(rows, 1, device="cuda", generator=gen) * 3)

    x, g = draw(m, k), draw(m, n)
    w = draw(n, k) if nt else draw(k, n)
    fn = quant.int8_matmul_nt if nt else quant.int8_matmul_qbwd

    def run(x, w, g, *lines):
        x = x.detach().clone().requires_grad_()
        w = w.detach().clone().requires_grad_()
        y = fn(x, w, *lines)
        y.backward(g)
        return y.detach(), x.grad, w.grad

    whole = run(x, w, g)
    line = (mesh, "tensor")
    i = mesh.index("tensor")
    with p21_sharded(mesh, fault, every_amax=True):
        if case in ("rows", "nt_rows"):
            b, count = mesh.batch_shards
            rows = slice(b * m // count, (b + 1) * m // count)
            part = run(x[rows], w, g[rows])
            want = [("part", whole[0][rows]), ("part", whole[1][rows]),
                    ("sum", whole[2], BATCH_AXES)]
        elif case == "col":
            c = slice(i * n // 2, (i + 1) * n // 2)
            part = run(x, w[:, c], g[:, c], None, line)
            want = [("part", whole[0][:, c]), ("sum", whole[1], "tensor"),
                    ("part", whole[2][:, c])]
        elif case == "row":
            r = slice(i * k // 2, (i + 1) * k // 2)
            part = run(x[:, r], w[r], g, line)
            want = [("sum", whole[0], "tensor"), ("part", whole[1][:, r]),
                    ("part", whole[2][r])]
        else:
            c = shard_width(n, mesh.shape["tensor"])
            v = slice(i * c, min((i + 1) * c, n))
            part = run(x, w[v], g[:, v], line)
            want = [("part", whole[0][:, v]), ("sum", whole[1], "tensor"),
                    ("part", whole[2][v])]
    gap = 0.0
    for got, spec in zip(part, want):
        ref = spec[1]
        if spec[0] == "sum":
            got = PM.all_reduce_sum(got, mesh, mesh.group(spec[2]))
        gap = max(gap, float((got - ref).abs().max() / ref.abs().max()))
    worst = PM.all_reduce_max(torch.tensor([gap], device="cuda"), mesh)
    return float(worst[0])


def p21_modules(seed, kw, cases, mesh):
    """The int8 modules ``cases`` ((module, planted faults) of
    P21_MODULES) of one full-width model (`p19_model` with ``kw``)
    sharded over ``mesh`` (data 2 x tensor 2), each as the model wires it
    (the first block's FFN GEMMs "lin1" / "lin2", its fused Q/K/V "qkv",
    the word head "head", lin2's frozen-weight table of the `capture_q8`
    copy "q8_lin2", forward only): forward and backward on this rank's
    part of P21_MODULE_ROWS rows, against the same int8 function on the
    whole operands, which every rank computes.  Returns for each module
    the largest gap of y, dx or dw relative to its largest entry over the
    ranks, and each planted fault's (`p21_sharded`)."""
    import torch

    from m3p_tpu_torch.model import capture_q8, quantized_inference_model
    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.parallel import mesh as PM
    from m3p_tpu_torch.parallel.sharding import shard_model

    model = p19_model(seed, **kw)
    names = {"lin1": ["ffn.lin1"], "lin2": ["ffn.lin2"],
             "q8_lin2": ["ffn.lin2"],
             "qkv": ["attn.q_lin", "attn.k_lin", "attn.v_lin"]}
    lins, wholes = {}, {}
    for case, _ in cases:
        lins[case] = [model.blocks[0].get_submodule(n)
                      for n in names.get(case, [])]
        if case == "head":
            wholes[case] = (model.text_emb.word.weight.detach().clone(),
                            model.pred_layer.bias.detach().clone())
        else:
            wholes[case] = (
                torch.cat([lin.weight.detach() for lin in lins[case]]).t(),
                torch.cat([lin.bias.detach() for lin in lins[case]]))
    shard_model(model, mesh)
    coords = {"data": mesh.index("data"), "tensor": mesh.index("tensor")}
    gen = torch.Generator(device="cuda").manual_seed(2102)

    def draw(cols):
        return (torch.randn(P21_MODULE_ROWS, cols, device="cuda",
                            generator=gen)
                * torch.rand(P21_MODULE_ROWS, 1, device="cuda",
                             generator=gen) * 3)

    def block(a, dim, cut):
        """This rank's block of ``a`` along ``dim`` under ``cut`` (axis,
        parts): its half of each of the parts."""
        return torch.cat([b.chunk(2, dim)[coords[cut[0]]]
                          for b in a.chunk(cut[1], dim)], dim)

    def whole(case, w, bias, x, g):
        """y, dx, dw on the whole operands, each with the axis and parts
        that split each dimension and the axes the ranks' parts sum over;
        dw in the module's weight layout ((N, K) for a Dense, the fused
        Q/K/V's three stacked, the head's (V, K) table)."""
        rows = ("data", 1)
        if case == "q8_lin2":
            with torch.no_grad():
                y = quant.Q8Table(w.t(), torch.float32)(x)
            return {"y": (y, (rows, None), ())}
        fn = (quant.int8_matmul_nt if case == "head"
              else quant.int8_matmul if kw["ffn_quant"] == "int8"
              else quant.int8_matmul_qbwd)
        xw, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xw, ww) + bias
        y.backward(g)
        dw = ww.grad if case == "head" else ww.grad.t()
        cut = ("tensor", 3 if case == "qkv" else 1)
        if case == "lin2":
            return {"y": (y.detach(), (rows, None), ()),
                    "dx": (xw.grad, (rows, cut), ()),
                    "dw": (dw, (None, cut), ("data",))}
        return {"y": (y.detach(), (rows, cut), ()),
                "dx": (xw.grad, (rows, None), ("tensor",)),
                "dw": (dw, (cut, None), ("data",))}

    def run(case, w, x, g, fault):
        cols = ("tensor", 1)
        rows, grad = block(x, 0, ("data", 1)), block(g, 0, ("data", 1))
        with p21_sharded(mesh, fault):
            if case == "q8_lin2":
                q = quantized_inference_model(model)
                capture_q8(q)
                with torch.no_grad():
                    return {"y": q.blocks[0].ffn.q8_lin2(
                        block(rows, 1, cols))}
            if case == "head":
                vocab = model.pred_layer.vocab
                weights = [w[vocab.lo:vocab.lo + vocab.n].clone()
                           .requires_grad_()]
            else:
                weights = [lin.weight for lin in lins[case]]
                for p in weights:
                    p.grad = None
            inp = (block(rows, 1, cols) if case == "lin2"
                   else rows).clone().requires_grad_()
            if case == "qkv":
                ys = [y[0] for y in
                      model.blocks[0].attn._fused_int8_qkv(inp[None])]
                grads = [block(c, 1, cols) for c in grad.chunk(3, dim=1)]
            elif case == "head":
                ys = [model.pred_layer(inp, embedding=weights[0])]
                grads = [block(grad, 1, cols)]
            else:
                ys = [lins[case][0](inp)]
                grads = [grad if case == "lin2" else block(grad, 1, cols)]
            torch.autograd.backward(ys, grads)
        return {"y": torch.cat(ys, dim=1).detach(), "dx": inp.grad,
                "dw": torch.cat([p.grad for p in weights])}

    def gap(got, want):
        worst = 0.0
        for key, (ref, dims, summed) in want.items():
            part = got[key]
            for axis in summed:
                part = PM.all_reduce_sum(part, mesh, mesh.group(axis))
            mine = ref
            for dim, cut in enumerate(dims):
                if cut is not None:
                    mine = block(mine, dim, cut)
            worst = max(worst, float((part - mine).abs().max()
                                     / ref.abs().max()))
        out = PM.all_reduce_max(torch.tensor([worst], device="cuda"), mesh)
        return float(out[0])

    out = {}
    for case, faults in cases:
        w, bias = wholes[case]
        x = draw(w.shape[1] if case == "head" else w.shape[0])
        g = draw(w.shape[0] if case == "head" else w.shape[1])
        want = whole(case, w, bias, x, g)
        res = {"gap": gap(run(case, w, x, g, None), want)}
        for fault in faults:
            res[fault] = gap(run(case, w, x, g, fault), want)
        out[f"{case}_{kw['ffn_quant']}"] = res
    del model
    return out


class IdsTokenizer:
    """Decodes a caption's ids as they are, so equal strings are equal
    tokens."""

    def decode(self, ids):
        return " ".join(str(int(t)) for t in ids)


def p21_eval(seed, mesh, batches):
    """The evaluator's int8 caption eval (`eval.quant="int8"`: the model's
    frozen-weight int8 copy, tables captured over its shards) on ``mesh``
    (None: one process): the hypotheses, each rank's table bytes and its
    int8 GEMMs."""
    from m3p_tpu_torch.config import EvalConfig, TrainConfig
    from m3p_tpu_torch.eval.evaluator import Evaluator
    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.parallel.sharding import shard_model

    model = p19_model(seed)
    if mesh is not None:
        shard_model(model, mesh)
    ev = Evaluator(model, TrainConfig(model=model.cfg, eval=EvalConfig(
        quant="int8", beam_size=P21_EVAL["beam"],
        max_gen_len=P21_EVAL["max_len"])))
    quant.zero_counts()
    hyps = {beam: ev.generate_captions(batches, IdsTokenizer(),
                                       beam_size=beam)
            for beam in (1, P21_EVAL["beam"])}
    tables = sum(t.wq.nbytes + t.sw.nbytes for t in ev.gen_model.modules()
                 if isinstance(t, quant.Q8Table))
    return {"hyps": hyps, "table_bytes": tables,
            "int8_gemms": quant.int8_matmul_pre.calls
            + quant.int8_matmul_nt_pre.calls}


# (case, model kw, mesh, step kind, the batch sharded and reduced): each
# one-process reference runs on the rank that owns the case (`P21_OWNER`),
# the ranks' references side by side; rank 0 owns the one-process eval
P21_CASES = (("int8_bwd_fsdp2_tensor2", P21_QUANT, "fsdp2_tensor2", "mct",
              True),
             ("int8_all_tensor2", dict(ffn_quant="int8_all"),
              "data2_tensor2", "itm", False),
             ("int8_bwd_data2_fsdp2", P21_QUANT, "data2_fsdp2", "mct", True),
             ("asm_tensor2", dict(asm=True), "data2_tensor2", "mct", False),
             ("uneven_tensor4", {}, "tensor4", "mct", True))
P21_OWNER = {"int8_bwd_fsdp2_tensor2": 1, "int8_all_tensor2": 2,
             "int8_bwd_data2_fsdp2": 3, "asm_tensor2": 2,
             "uneven_tensor4": 3}


def p21_checks(cfg):
    """21(b) on one rank: every rank runs each sharded part; the rank that
    owns a case (`P21_OWNER`) then runs its one-process references and
    compares, rank 0 the one-process eval and checkpoint read."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch import bench
    from m3p_tpu_torch import checkpoint as ckpt
    from m3p_tpu_torch.config import MeshConfig
    from m3p_tpu_torch.data.synthetic import make_retrieval_batch
    from m3p_tpu_torch.parallel.mesh import make_mesh
    from m3p_tpu_torch.parallel.sharding import (
        gather_train_state, padding_max, shard_model)
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state
    from m3p_tpu_torch.train.steps import mct_draws

    seed, tmp = cfg["seed"] + 3, cfg["tmp"]
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = p19_batch(seed, P19_FP32_WORDS)
    draws = mct_draws(torch.Generator(device="cuda").manual_seed(seed),
                      {k: torch.as_tensor(v).cuda()
                       for k, v in batch.items()},
                      bench.mask_config(p19_model(seed).cfg))
    meshes = {"fsdp2_tensor2": MeshConfig(data=1, fsdp=2, tensor=2),
              "data2_tensor2": MeshConfig(data=2, tensor=2),
              "data2_fsdp2": MeshConfig(data=2, fsdp=2),
              "tensor4": MeshConfig(data=1, tensor=4)}
    meshes = {k: make_mesh(v, dev) for k, v in meshes.items()}
    out = {"fp32": {}, "seconds": {}}
    kept = {}
    t = time.time()

    def part(name):
        nonlocal t
        out["seconds"][name] = time.time() - t
        t = time.time()

    for name, kw, mesh_name, kind, split in P21_CASES:
        model = p19_model(seed, **kw)
        shard_model(model, meshes[mesh_name])
        loss, params, state = p19_step(model, meshes[mesh_name], kind,
                                       batch, draws, shard_rows=split,
                                       reduce=split)
        if P21_OWNER[name] == rank:
            kept[name] = (loss, params)
        if name == "uneven_tensor4":
            out["uneven_pad_max"] = padding_max(state)
            out["uneven_local_rows"] = list(model.text_emb.word.weight.shape)
            path = os.path.join(tmp, "p21_tensor4")
            ckpt.save_checkpoint(path, state, {"epoch": 1})
            saved = gather_train_state(state)
        del model, state, params
        torch.cuda.empty_cache()
    part("steps")

    # the checkpoint of tensor 4 onto fsdp 2 x tensor 2
    model = p19_model(seed)
    shard_model(model, meshes["fsdp2_tensor2"])
    tx, _ = build_optimizer(P19_SPEC, clip_grad_norm=CLIP)
    st = create_train_state(model, tx, meshes["fsdp2_tensor2"])
    st, _ = ckpt.restore_checkpoint(os.path.join(tmp, "p21_tensor4"), st)
    back = gather_train_state(st)
    out["checkpoint"] = {"to_fsdp2_tensor2_bitwise": all(
        torch.equal(back["model"][k], v) for k, v in saved["model"].items())
        and all(torch.equal(a, b) for key in ("mu", "nu") for a, b in zip(
            back["opt_state"][key], saved["opt_state"][key]))}
    del model, st, back
    torch.cuda.empty_cache()
    part("checkpoint")

    # the int8 GEMMs on their meshes, good and with each planted fault
    gemms = {}
    for case, mesh_name, fault in (
            ("rows", "data2_fsdp2", "rows_local"),
            ("nt_rows", "data2_fsdp2", "rows_local"),
            ("col", "fsdp2_tensor2", "amax_local"),
            ("row", "fsdp2_tensor2", "amax_local"),
            ("nt_vocab", "tensor4", "amax_local")):
        mesh = meshes[mesh_name]
        gemms[f"{case}_{mesh_name}"] = {
            "gap": p21_gemm_gap(case, mesh),
            fault: p21_gemm_gap(case, mesh, fault)}
    out["gemms"] = gemms
    torch.cuda.empty_cache()
    part("gemms")

    # the int8 modules as the sharded model wires them
    out["modules"] = {}
    for kw, cases in P21_MODULES:
        out["modules"].update(p21_modules(seed, kw, cases,
                                          meshes["data2_tensor2"]))
    torch.cuda.empty_cache()
    part("modules")

    # the evaluator's int8 caption eval on fsdp 2 x tensor 2
    rng = np.random.RandomState(seed)
    batches = [make_retrieval_batch(rng, P21_EVAL["images"], 1, 8,
                                    P19_REGIONS, P19_FP32_WORDS)]
    got = p21_eval(seed, meshes["fsdp2_tensor2"], batches)
    out["eval"] = {"table_bytes": got["table_bytes"],
                   "int8_gemms": got["int8_gemms"]}
    torch.cuda.empty_cache()
    part("eval")

    # one process: each rank its own references, side by side
    for name, kw, mesh_name, kind, split in P21_CASES:
        if name not in kept:
            continue
        loss, params = kept.pop(name)
        ref = p19_step(p19_model(seed, **kw), None, kind, batch, draws)
        gap, leaf = leaf_gap(params, ref[1])
        res = {"loss": loss, "one_process_loss": ref[0],
               "loss_gap": abs(loss - ref[0]) / abs(ref[0]),
               "param_gap": gap, "worst_leaf": leaf}
        out["fp32"][name] = res
        del params, ref
        torch.cuda.empty_cache()
    if rank == 0:
        one = p19_model(seed)
        st = create_train_state(one, tx)
        st, _ = ckpt.restore_checkpoint(os.path.join(tmp, "p21_tensor4"), st)
        sd = one.state_dict()
        out["checkpoint"]["to_one_process_bitwise"] = all(
            sd[k].shape == v.shape and torch.equal(sd[k], v)
            for k, v in saved["model"].items())
        del one, st
        want = p21_eval(seed, None, batches)
        out["eval"].update(
            one_process_table_bytes=want["table_bytes"],
            tokens_equal={str(b): got["hyps"][b] == want["hyps"][b]
                          for b in want["hyps"]},
            hyps=got["hyps"])
    del saved
    torch.cuda.empty_cache()
    part("one_process")
    return out


def sharded_variants_slice(ranks):
    """Phase 21: (a) and (b) on the 4 ranks of phase 19's launch
    (`p19_rank` runs them after phase 19's part): ``ranks`` holds each
    rank's results.  The phase's own clock is rank 0's seconds over its
    part and this check."""
    t0 = time.time()
    secs = ranks[0]["launch_s"]
    n_layers, refine = 24, 3
    want = {"packed_fwd": 2 * n_layers + refine,
            "packed_bwd": 2 * (n_layers + refine)}
    problems = []
    for r, res in enumerate(ranks):
        a = res["a"]
        if a["n_total_iter"] != 1 + P21_TIMED:
            problems.append(f"rank {r} took {a['n_total_iter']} steps")
        if a["quant"] != [P21_QUANT["ffn_quant"], P21_QUANT["head_quant"]] \
                or a["ffn_modules"] != ["QuantDense", True, True]:
            problems.append(f"rank {r} ran {a['quant']} {a['ffn_modules']}")
        for kind, counts in a["steps"]:
            if {k: counts[k] for k in want} != want:
                problems.append(f"rank {r} {kind} launches {counts}")
        if not all(map(math.isfinite, a["losses"])):
            problems.append(f"rank {r} losses {a['losses']}")
        int8 = a["int8_gemms_per_step"]
        if not int8["int8_matmul_qbwd"]["cpu"] == 0 < sum(
                int8["int8_matmul_qbwd"].values()) or not sum(
                int8["int8_matmul_nt"].values()) > 0:
            problems.append(f"rank {r} int8 GEMMs {int8}")
        if a["amax_reduced_per_step"]["calls"] != P21_AMAX_PER_STEP:
            problems.append(f"rank {r} reduced {a['amax_reduced_per_step']}"
                            f" amaxes a step, not {P21_AMAX_PER_STEP}")
    b = ranks[0]["b"]
    fp32 = {name: ranks[P21_OWNER[name]]["b"]["fp32"][name]
            for name, *_ in P21_CASES}
    bounds = {}
    for name, kw, *_ in P21_CASES:
        res = fp32[name]
        bound = ((TOL_P21_INT8_LOSS, TOL_P21_INT8) if kw.get("ffn_quant")
                 else (TOL_P21_FP32, TOL_P21_FP32))
        bounds[name] = bound
        if not (res["loss_gap"] <= bound[0] and res["param_gap"] <= bound[1]):
            problems.append(f"{name} is not the one-process step within "
                            f"{bound}: {res}")
    for key, res in list(b["gemms"].items()) + list(b["modules"].items()):
        planted = [v for k, v in res.items() if k != "gap"]
        if not (res["gap"] <= TOL_P21_GEMM
                and all(v >= 10 * TOL_P21_GEMM for v in planted)):
            problems.append(f"int8 GEMM or module {key}: {res}")
    if not all(r["b"]["uneven_pad_max"] == 0.0 for r in ranks):
        problems.append(f"the padding moved: "
                        f"{[r['b']['uneven_pad_max'] for r in ranks]}")
    if not (all(r["b"]["checkpoint"]["to_fsdp2_tensor2_bitwise"]
                for r in ranks)
            and b["checkpoint"]["to_one_process_bitwise"]):
        problems.append(f"the uneven checkpoint's round trip is not "
                        f"bitwise: {[r['b']['checkpoint'] for r in ranks]}")
    ev = b["eval"]
    share = max(r["b"]["eval"]["table_bytes"] for r in ranks) / ev[
        "one_process_table_bytes"]
    if not all(ev["tokens_equal"].values()):
        problems.append(f"the int8 caption eval's tokens are not one "
                        f"process's: {ev}")
    if not all(r["b"]["eval"]["int8_gemms"] > 0 for r in ranks):
        problems.append("the int8 caption eval ran no int8 GEMM")
    if share > 0.51:
        problems.append(f"a rank holds {share} of one process's table bytes")
    if problems:
        fail("phase 21: " + "; ".join(problems))
    a = ranks[0]["a"]
    out = {"launch_s": secs, "ranks": len(ranks), "mesh": a["mesh"],
           "quant": a["quant"], "rank0_s": ranks[0]["seconds"],
           "ms_per_step_per_rank": {r: res["a"]["ms"][1:]
                                    for r, res in enumerate(ranks)},
           "warmup_ms_per_rank": {r: res["a"]["ms"][0]
                                  for r, res in enumerate(ranks)},
           "losses_rank0": a["losses"],
           "collective_bytes_per_step_rank0": a["collective_bytes_per_step"],
           "amax_reduced_per_step_rank0": a["amax_reduced_per_step"],
           "gradient_bytes_per_step_rank0": a["gradient_bytes_per_step"],
           "int8_gemms_per_step_rank0": a["int8_gemms_per_step"],
           "peak_memory_gb_per_rank": {r: res["a"]["peak_memory_gb"]
                                       for r, res in enumerate(ranks)},
           "launches_per_step": want,
           "launches_per_rank": {r: {k: sum(c[k] for _, c in res["a"][
               "steps"]) for k in want} for r, res in enumerate(ranks)},
           "fp32": fp32, "bounds": bounds,
           "gemms": b["gemms"], "modules": b["modules"],
           "uneven_local_rows": b["uneven_local_rows"],
           "checkpoint": [r["b"]["checkpoint"] for r in ranks],
           "b_seconds_rank0": b["seconds"],
           "eval": {"tokens_equal": ev["tokens_equal"],
                    "table_bytes_per_rank": [r["b"]["eval"]["table_bytes"]
                                             for r in ranks],
                    "one_process_table_bytes": ev["one_process_table_bytes"],
                    "table_share": share},
           "check_s": time.time() - t0}
    log(f"[sharded variants] phase 21: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 22: heads that do not divide by tensor, experts that do not divide
# by expert
# ---------------------------------------------------------------------------

# (a) one launch of 8 ranks sharing the card over gloo: the scale-up preset
# at full width and depth (24 x 768, 12 heads, 3072, 250,002 words, 101
# languages, bf16, remat) through `train_x.main` with --mesh_tensor 8 at
# phase 19's batch, one warm-up and P22_TIMED timed MCT steps; 12 heads
# over 8 ranks in the padded layout: ranks 0-5 hold 2 heads, ranks 6-7
# none.  Then at fp32 and depth 2 the MCT step on tensor 8 against one
# process, at rate 0 and at dropout and attention dropout 0.1 (the fused
# residual dropout on), and a planted fault (every rank calling the
# kernels at head_base 0) that must break the equality.
P22_RANKS = 8
P22_TIMED = 1
P22_LAYERS = 24
P22_REFINE = 3


def p22_argv():
    """P19_ARGV on tensor 8 alone, at P22_LAYERS blocks."""
    argv = [("p22" if a == "p19" else a) for a in P19_ARGV]
    argv[argv.index("--mesh_fsdp") + 1] = "1"
    argv[argv.index("--mesh_tensor") + 1] = str(P22_RANKS)
    argv[argv.index("--n_layers") + 1] = str(P22_LAYERS)
    return argv


def p22_heads(rank, n_heads=12, tensor=P22_RANKS):
    """(heads, head_base) of a tensor rank in the padded layout."""
    per = -(-n_heads // tensor)
    base = min(rank * per, n_heads)
    return min(per, n_heads - base), base


def p22_launches(rank, n_layers=P22_LAYERS, remat=True):
    """#1 / #2 launches an MCT step on ``rank``, counted from the code: a
    block's attention launches on a rank that holds heads (twice in the
    forward under remat: the recompute), the AoA refiner's on every rank
    (it is not split); #2 counts two launches a backward."""
    blocks = n_layers if p22_heads(rank)[0] else 0
    return {"packed_fwd": (2 if remat else 1) * blocks + P22_REFINE,
            "packed_bwd": 2 * (blocks + P22_REFINE)}


def p22_preset(cfg):
    """22(a) on one rank: the preset's MCT steps through train_x.main on
    tensor 8."""
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch.data.loader import LoadedData
    from m3p_tpu_torch.parallel.mesh import COLLECTIVE_BYTES
    from m3p_tpu_torch.parallel.tensor_parallel import RESHARD_BYTES

    seed, tmp = cfg["seed"], cfg["tmp"]
    data = LoadedData(train_datasets={("rel", "coco"): PretrainRows(
        seed, 250002)}, tokenizer=None)
    rec = {"losses": [], "batches": [], "ms": [], "steps": []}
    snaps = []

    def on_step(trainer):
        snaps.append({"collective": dict(COLLECTIVE_BYTES),
                      "reshard": dict(RESHARD_BYTES),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        if len(snaps) == 1:           # after the warm-up
            torch.cuda.reset_peak_memory_stats()
        rec["batches"].clear()

    zero_launch_counts()
    COLLECTIVE_BYTES.update(all_reduce=0, all_gather=0, reduce_scatter=0)
    RESHARD_BYTES.update(all_gather=0, reduce_scatter=0)
    trainer, secs = p18_run_main(p22_argv() + [
        "--dump_path", os.path.join(tmp, "dump"), "--seed", str(seed)],
        data, rec, on_step=on_step, save=False)
    attn = trainer.model.blocks[0].attn
    timed, warm = snaps[-1], snaps[0]
    per_step = {f"{k}": (timed["collective"][k] - warm["collective"][k])
                / P22_TIMED for k in COLLECTIVE_BYTES}
    per_step.update({f"reshard_{k}": (timed["reshard"][k]
                                      - warm["reshard"][k]) / P22_TIMED
                     for k in RESHARD_BYTES})
    out = {"rank": dist.get_rank(), "seconds": secs,
           "mesh": {k: v for k, v in trainer.mesh.shape.items() if v > 1},
           "backend": trainer.mesh.backend,
           "n_total_iter": trainer.n_total_iter,
           "losses": [v for _, v in rec["losses"]],
           "ms": rec["ms"], "steps": rec["steps"],
           "bytes_per_step": per_step,
           "peak_memory_gb": timed["peak_gb"],
           "local_heads": [attn.n_heads, attn.head_base, attn.heads_total],
           "n_layers": trainer.cfg.model.n_layers,
           "remat": trainer.cfg.model.remat,
           "dtype": trainer.cfg.model.dtype}
    del trainer
    torch.cuda.empty_cache()
    return out


def one_process_gap(got, ref):
    """A sharded step's (loss, whole parameters) against one process's."""
    gap, name = leaf_gap(got[1], ref[1])
    return {"loss": got[0], "one_process_loss": ref[0],
            "loss_gap": abs(got[0] - ref[0]) / abs(ref[0]),
            "param_gap": gap, "worst_leaf": name}


# the rank of 22(a)'s launch that runs each fp32 check's one-process
# reference (the fault is held against the dropout step's)
P22_OWNER = {"rate0": 1, "dropout": 2, "head_base_0": 2}


def p22_checks(cfg):
    """22(a)'s fp32 checks on one rank: every rank runs each step on tensor
    8; the rank that owns a case (`P22_OWNER`) runs its one-process
    reference and compares."""
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch import bench
    from m3p_tpu_torch.config import MeshConfig
    from m3p_tpu_torch.model.layers import Generators, MultiHeadAttention
    from m3p_tpu_torch.parallel.mesh import make_mesh
    from m3p_tpu_torch.parallel.sharding import shard_model
    from m3p_tpu_torch.train.steps import mct_draws

    seed = cfg["seed"] + 5
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = p19_batch(seed, P19_FP32_WORDS)
    draws = mct_draws(torch.Generator(device="cuda").manual_seed(seed),
                      {k: torch.as_tensor(v).cuda()
                       for k, v in batch.items()},
                      bench.mask_config(p19_model(seed).cfg))
    mesh = make_mesh(MeshConfig(data=1, tensor=P22_RANKS), dev)
    rate = dict(dropout=RATE, attention_dropout=RATE, use_fused_dropout=True)
    cases = (("rate0", {}), ("dropout", rate), ("head_base_0", rate))
    runs, launches = {}, {}
    for name, kw in cases:
        model = p19_model(seed, **kw)
        shard_model(model, mesh)
        if name == "head_base_0":
            for m in model.modules():
                if isinstance(m, MultiHeadAttention) and m.tp is not None:
                    m.head_base = 0
        zero_launch_counts()
        gens = Generators.from_seed(seed, "cuda") if kw else None
        loss, params, _ = p19_step(model, mesh, "mct", batch, draws,
                                   gens=gens)
        launches[name] = {k: launch_counts()[k]
                          for k in ("packed_fwd", "packed_bwd")}
        runs[name] = (loss, params if rank == P22_OWNER[name] else None)
        del model, params
        torch.cuda.empty_cache()
    out = {"launches": launches}
    refs = {}
    for name, kw in cases:
        if rank != P22_OWNER[name]:
            continue
        key = "dropout" if kw else "rate0"
        if key not in refs:
            gens = Generators.from_seed(seed, "cuda") if kw else None
            loss, params, _ = p19_step(p19_model(seed, **kw), None, "mct",
                                       batch, draws, gens=gens)
            refs[key] = (loss, params)
        out[name] = one_process_gap(runs[name], refs[key])
    del runs, refs
    torch.cuda.empty_cache()
    return out


def p22_rank(cfg):
    """A rank of 22(a)'s launch: the preset, then the fp32 checks; one
    JSON per rank."""
    import torch.distributed as dist

    from m3p_tpu_torch.parallel.mesh import auto_init_distributed

    auto_init_distributed("cuda")
    t0 = time.time()
    out = {"a": p22_preset(cfg)}
    t1 = time.time()
    out["checks"] = p22_checks(cfg)
    out["seconds"] = {"a": t1 - t0, "checks": time.time() - t1}
    with open(f"{cfg['out']}.{dist.get_rank()}.json", "w") as f:
        json.dump(out, f)


# (b) on phase 19's 4 ranks (`p19_rank`): MoE with 6 experts on every
# second block, over expert 4 (ceil(6 / 4) = 2 experts a rank: 2, 2, 2
# and none on rank 3), the ITM step at fp32 and depth 2 against one
# process, which P22_MOE_OWNER runs
P22_MOE = dict(moe_experts=6, moe_interval=2)
P22_MOE_OWNER = 3


def p22_moe(cfg):
    """22(b) on one rank of phase 19's launch."""
    import torch
    import torch.distributed as dist

    from m3p_tpu_torch.config import MeshConfig
    from m3p_tpu_torch.model.layers import MoEFFN
    from m3p_tpu_torch.parallel.mesh import make_mesh
    from m3p_tpu_torch.parallel.sharding import shard_model

    t0 = time.time()
    seed = cfg["seed"] + 6
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = p19_batch(seed, P19_FP32_WORDS)
    mesh = make_mesh(MeshConfig(data=1, expert=4), dev)
    model = p19_model(seed, **P22_MOE)
    shard_model(model, mesh)
    experts = [[m.expert_lo, m.n_local] for m in model.modules()
               if isinstance(m, MoEFFN)]
    got = p19_step(model, mesh, "itm", batch)[:2]
    del model
    out = {"experts": experts}
    if dist.get_rank() == P22_MOE_OWNER:
        ref = p19_step(p19_model(seed, **P22_MOE), None, "itm", batch)[:2]
        out["check"] = one_process_gap(got, ref)
        del ref
    del got
    torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    return out


def uneven_slice(seed, moe_ranks):
    """Phase 22: (a) on 8 ranks (`p22_rank`), and (b)'s results from phase
    19's launch (``moe_ranks``: each rank's `p22_moe`)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        secs, ranks = p18_launch("p22", P22_RANKS, {"seed": seed,
                                                    "tmp": tmp})
    sublap("p22_ranks")
    problems = []
    want_fp32 = {r: p22_launches(r, n_layers=2, remat=False)
                 for r in range(P22_RANKS)}
    for r, res in enumerate(ranks):
        a = res["a"]
        heads, base = p22_heads(r)
        if a["local_heads"] != [heads, base, 12]:
            problems.append(f"rank {r} heads {a['local_heads']}")
        if a["n_total_iter"] != 1 + P22_TIMED:
            problems.append(f"rank {r} took {a['n_total_iter']} steps")
        want = p22_launches(r)
        for kind, counts in a["steps"]:
            if {k: counts[k] for k in want} != want:
                problems.append(f"rank {r} {kind} launches {counts}, not "
                                f"{want}")
        if not all(map(math.isfinite, a["losses"])):
            problems.append(f"rank {r} losses {a['losses']}")
        for case, counts in res["checks"]["launches"].items():
            if counts != want_fp32[r]:
                problems.append(f"rank {r} fp32 {case} launches {counts}, "
                                f"not {want_fp32[r]}")
    checks = {name: ranks[owner]["checks"][name]
              for name, owner in P22_OWNER.items()}
    for name in ("rate0", "dropout"):
        c = checks[name]
        if not (c["loss_gap"] <= TOL_P19_FP32
                and c["param_gap"] <= TOL_P19_FP32):
            problems.append(f"tensor 8 {name} is not the one-process step: "
                            f"{c}")
    fault = checks["head_base_0"]
    if max(fault["loss_gap"], fault["param_gap"]) <= TOL_P19_FP32:
        problems.append(f"the planted fault was not seen: {fault}")
    moe = moe_ranks[P22_MOE_OWNER]["check"]
    if not (moe["loss_gap"] <= TOL_P19_FP32
            and moe["param_gap"] <= TOL_P19_FP32):
        problems.append(f"6 experts over expert 4 are not the one-process "
                        f"step: {moe}")
    experts = [r["experts"] for r in moe_ranks]
    if [e[0] for e in experts] != [[0, 2], [2, 2], [4, 2], [6, 0]]:
        problems.append(f"experts by rank {experts}")
    if problems:
        fail("phase 22: " + "; ".join(problems))
    zero = ranks[0]["a"]
    out = {"launch_s": secs, "ranks": P22_RANKS, "mesh": zero["mesh"],
           "backend": zero["backend"],
           "rank_s": {r: res["seconds"] for r, res in enumerate(ranks)},
           "preset": {"n_layers": zero["n_layers"], "remat": zero["remat"],
                      "dtype": zero["dtype"],
                      "batch": [P19_B, P19_SAMPLE_N, P19_TEXT,
                                P19_REGIONS]},
           "local_heads_per_rank": {r: res["a"]["local_heads"]
                                    for r, res in enumerate(ranks)},
           "ms_per_step_per_rank": {r: res["a"]["ms"][1:]
                                    for r, res in enumerate(ranks)},
           "warmup_ms_per_rank": {r: res["a"]["ms"][0]
                                  for r, res in enumerate(ranks)},
           "losses_rank0": zero["losses"],
           "bytes_per_step_per_rank": {r: res["a"]["bytes_per_step"]
                                       for r, res in enumerate(ranks)},
           "peak_memory_gb_per_rank": {r: res["a"]["peak_memory_gb"]
                                       for r, res in enumerate(ranks)},
           "launches_per_step_per_rank": {r: p22_launches(r)
                                          for r in range(P22_RANKS)},
           "launches_per_rank": {r: {k: sum(c[k] for _, c in res["a"][
               "steps"]) for k in ("packed_fwd", "packed_bwd")}
               for r, res in enumerate(ranks)},
           "fp32": checks,
           "fp32_launches_per_rank": {r: res["checks"]["launches"]
                                      for r, res in enumerate(ranks)},
           "moe_expert4": {"check": moe, "experts_by_rank": experts,
                           "rank_s": [r["seconds"] for r in moe_ranks]},
           "phase_s": time.time() - t0}
    log(f"[uneven] phase 22: {json.dumps(out)}")
    return out


def p18_rank(path):
    """A rank of phase 18, or 19 and 20, under torchrun (``--p18
    <config>``)."""
    import torch

    from m3p_tpu_torch.parallel.mesh import auto_init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(path) as f:
        cfg = json.load(f)
    if cfg["part"] == "dp":
        auto_init_distributed("cuda")
        p18_dp_rank(cfg)
    elif cfg["part"] == "p22":
        p22_rank(cfg)
    else:
        p19_rank(cfg)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--p18", default=None,
                   help="run as a rank of phase 18 (under torchrun) with "
                        "this JSON config")
    args = p.parse_args()
    if not (REPO / "m3p_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: m3p_tpu_torch is not beside this script; run it "
              "from a checkout of the repo", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.p18:
        return p18_rank(args.p18)
    name = torch.cuda.get_device_name(0)
    from m3p_tpu_torch import bench

    card = bench.card()
    log(f"[card] {name} ({card}); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; host: {os.cpu_count()} CPUs, "
        f"{len(os.sched_getaffinity(0))} usable, torch threads "
        f"{torch.get_num_threads()}")
    t_start = CLOCK["t"] = CLOCK["sub"] = time.time()

    build_kernels()
    lap("build")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst = check_kernels(gen)
    worst_train = check_dropout_and_backward(gen)
    keep_share = check_mask_identity()
    keep_share_bf16 = check_mask_identity(dtype=torch.bfloat16)
    keep_share_causal = check_mask_identity(dtype=torch.bfloat16,
                                            causal_t63=True)
    flash_worst = check_flash_kernels(gen)
    flash_share = check_mask_identity(flash=True)
    flash_share_bf16 = check_mask_identity(flash=True, dtype=torch.bfloat16)
    drop_worst, drop_share = check_fused_dropout(gen)
    lap("p2_checks")
    times = time_kernels(gen)
    lap("p3_time_kernels")
    drop_fwd, drop_bwd = time_fused_dropout(gen)
    sublap("p3_fused_dropout")
    train_times = time_training_kernels(gen)
    sublap("p3_training_kernels")
    decoder_times = time_decoder_kernels(gen)
    sublap("p3_decoder_kernels")
    flash_fwd, flash_bwd = time_flash_kernels(gen)
    torch.cuda.empty_cache()
    lap("p3_time_rest")

    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    with tempfile.TemporaryDirectory() as tmp:
        vocab = os.path.join(tmp, "vocab.tsv")
        write_vocab(vocab)
        tokenizer = XLMRTokenizer(vocab)
    sublap("p4_tokenizer")
    engine, numbers = serve_slice(args.seed, tokenizer)
    del engine
    torch.cuda.empty_cache()
    lap("p4_5_serve")
    fp32_diff = compare_fp32_with_cpu(args.seed, tokenizer)
    lap("p4_fp32_vs_cpu")

    training = train_slice(args.seed)
    torch.cuda.empty_cache()
    lap("p6_train")
    training["fp32_grad_card_vs_cpu_max_rel"] = compare_grads_with_cpu(
        args.seed)
    lap("p6_vs_cpu")
    training["learning"] = learning_check(args.seed)
    lap("p6_learning")
    torch.cuda.empty_cache()

    long_ctx = long_context_slice(args.seed)
    torch.cuda.empty_cache()
    lap("p7_xmlm")
    long_ctx["fp32_grad_card_vs_cpu_max_rel"] = compare_long_grads_with_cpu(
        args.seed)
    lap("p7_vs_cpu")
    long_ctx["learning"] = long_learning_check(args.seed)
    lap("p7_learning")
    torch.cuda.empty_cache()

    mct = {"A": mct_slice(args.seed, fused=False)}
    torch.cuda.empty_cache()
    sublap("p8_mct_A")
    mct["B"] = mct_slice(args.seed, fused=True)
    torch.cuda.empty_cache()
    lap("p8_mct_A_B")
    mct["in_turns"] = mct_in_turns(args.seed)
    lap("p8_in_turns")
    torch.cuda.empty_cache()
    mct["fp32_grad_card_vs_cpu_max_rel"] = compare_mct_grads_with_cpu(
        args.seed)
    lap("p8_vs_cpu")
    mct["learning"] = mct_learning_check(args.seed)
    lap("p8_learning")
    mct_a, mct_b = mct["A"]["launches"], mct["B"]["launches"]
    mct_clcm = mct["B"]["clcm_step"]["launches"]
    torch.cuda.empty_cache()

    small_worst, small_share, layout = check_small_attention()
    lap("p9_small_checks")
    bhsd_counts = head_major_path()
    small_times = time_small_attention()
    torch.cuda.empty_cache()
    lap("p9_small_path_and_times")
    ffn_worst = check_fused_ffn()
    ffn_block = ffn_model_check(args.seed)
    ffn = fused_ffn_path()
    torch.cuda.empty_cache()
    lap("p9_ffn")

    decoder = decoder_slice(args.seed)
    lap("p10_decoder")
    decoder["fp32_grad_card_vs_cpu_max_rel"] = \
        compare_decoder_grads_with_cpu(args.seed)
    lap("p10_vs_cpu")
    decoder["learning"] = decoder_learning_check(args.seed)
    lap("p10_learning")
    decoder["kernel_times"] = decoder_times
    dec_runs = {"caption": decoder["launches"], **{
        path: out["launches"] for path, out in decoder["paths"].items()}}
    dec_packed = [p for p in dec_runs if p != "clm"]
    torch.cuda.empty_cache()

    full_tokenizer = full_vocab_tokenizer()
    sublap("p11_tokenizer")
    generation = generation_slice(args.seed, full_tokenizer, gen)
    lap("p11_generation")
    generation["fp32_card_vs_cpu"] = compare_generation_with_cpu(
        args.seed, full_tokenizer)
    gen_runs = generation["launches"]
    lap("p11_vs_cpu")
    gen_paths = {
        path: [r for name, r in gen_runs.items()
               if path in name and name != "long_decode"]
        for path in ("caption", "translate")}
    gen_packed = {f"generation_{path}": sum(r["packed_fwd"] for r in runs)
                  for path, runs in gen_paths.items()}
    gen_packed["generation_long_decode"] = \
        gen_runs["long_decode"]["packed_fwd"]
    gen_packed_tc = sum(r["packed_fwd_tensor_cores"]
                        for r in gen_runs.values())
    long_flash = gen_runs["long_decode"]["flash_fwd"]
    torch.cuda.empty_cache()

    freelb = freelb_slice(args.seed)
    lap("p12_freelb")
    fl_runs = {"freelb_mct_A": freelb["A"]["launches"],
               "freelb_mct_B": freelb["B"]["launches"],
               "freelb_pair_B": freelb["pair_B"]["launches"],
               "freelb_itm": freelb["itm"]["launches"],
               "freelb_caption": freelb["caption"]["launches"],
               **{name: r["launches"]
                  for name, r in freelb["denoising"].items()}}
    fl_fused = ("freelb_mct_B", "freelb_pair_B")
    torch.cuda.empty_cache()

    evaluation = eval_slice(args.seed, full_tokenizer)
    lap("p13_eval")
    ev_gen = [evaluation["generation"][f"launches_{n}"]
              for n in ("beam", "greedy")]
    ev_runs = {"eval_grid": evaluation["grid"]["launches"],
               "eval_losses": evaluation["losses"]["launches"],
               "eval_generation": {k: sum(r[k] for r in ev_gen)
                                   for k in ev_gen[0]}}
    torch.cuda.empty_cache()

    trainer = trainer_slice(args.seed)
    lap("p14_trainer")
    ev_runs["trainer"] = trainer["recipe"]["launches"]
    torch.cuda.empty_cache()

    datasets = dataset_slice(args.seed, full_tokenizer,
                             trainer["recipe"]["ms_per_micro_step"])
    lap("p15_datasets")
    ev_runs["datasets_cli"] = datasets["cli"]["launches"]
    ev_runs["datasets_recipe"] = datasets["recipe"]["launches"]
    data_runs = ("datasets_cli", "datasets_recipe")
    torch.cuda.empty_cache()

    quant = quant_slice(args.seed, full_tokenizer)
    lap("p16_quant")
    quant_calls = {**quant["serve"]["calls"],
                   "eval_int8": quant["eval"]["counts"]}
    quant_packed = {f"quant_{name}": c["packed_fwd"]
                    for name, c in quant_calls.items()}
    torch.cuda.empty_cache()

    variants = int8_variants_slice(args.seed)
    lap("p17_int8_variants")
    p17_runs = {"int8_mct_A": variants["mct_A"]["launches"],
                "int8_mct_B": variants["mct_B"]["launches"],
                **{f"int8_mct_{mode}": r["packed"]
                   for mode, r in variants["modes"].items()},
                "moe_mct": variants["moe"]["launches"],
                "asm_mct": variants["asm"]["launches"],
                "fusion": variants["fusion"]["launches"]}
    p17_fwd = {**{p: r["packed_fwd"] for p, r in p17_runs.items()},
               "asm_caption": variants["asm"]["caption"]["packed_fwd"],
               "grid_int8": variants["grid"]["int8_packed_fwd_launches"]}
    torch.cuda.empty_cache()

    parallel = parallel_slice(args.seed)
    lap("p18a_parallel")
    dp_launches = parallel["dp"]["launches_per_rank"]
    p18_packed = {k: sum(c[k] for c in dp_launches.values())
                  for k in ("packed_fwd", "packed_bwd")}
    torch.cuda.empty_cache()

    sharding, shared_ranks = sharding_slice(args.seed)
    lap("p19_sharding")
    p19_packed = {k: sum(c[k] for c in sharding["launches_per_rank"].values())
                  for k in ("packed_fwd", "packed_bwd")}
    torch.cuda.empty_cache()

    pipeline = pipeline_slice(shared_ranks["p20"])
    lap("p20_pipeline")
    p20_packed = {k: sum(c[k] for c in pipeline["launches_per_rank"].values())
                  for k in ("packed_fwd", "packed_bwd")}
    variants21 = sharded_variants_slice(shared_ranks["p21"])
    lap("p21_sharded_variants")
    parallel["sp"] = sp_slice(args.seed, *shared_ranks["p18_sp"])
    lap("p18b_sequence_parallel")
    uneven = uneven_slice(args.seed, shared_ranks["p22_moe"])
    lap("p22_uneven")
    p22_packed = {k: sum(c[k] for c in uneven["launches_per_rank"].values())
                  for k in ("packed_fwd", "packed_bwd")}
    sp_flash = parallel["sp"]["one_process_launches"]
    p21_packed = {k: sum(c[k] for c in variants21[
        "launches_per_rank"].values()) for k in ("packed_fwd", "packed_bwd")}

    blocks, refiner = times["blocks"], times["refiner"]
    dself, dcross = (decoder["kernel_times"][k] for k in ("self", "cross"))
    tblocks, trefiner = train_times["blocks"], train_times["refiner"]
    kernels = {"kernels": [{
        "name": "packed_attention_fwd",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/packed_attention.cu",
        "replaces": "m3p_tpu/ops/attention.py:1016",
        "launches": (numbers["launches"] + training["launches"]["fwd"]
                     + mct_a["packed_fwd"] + mct_b["packed_fwd"]
                     + sum(dec_runs[p]["packed_fwd"] for p in dec_packed)
                     + sum(gen_packed.values())
                     + sum(r["packed_fwd"] for r in fl_runs.values())
                     + sum(r["packed_fwd"] for r in ev_runs.values())
                     + sum(quant_packed.values()) + sum(p17_fwd.values())
                     + p18_packed["packed_fwd"] + p19_packed["packed_fwd"]
                     + p20_packed["packed_fwd"] + p21_packed["packed_fwd"]
                     + p22_packed["packed_fwd"]),
        "launches_by_path": {"serving": numbers["launches"],
                             "training": training["launches"]["fwd"],
                             "mct_A": mct_a["packed_fwd"],
                             "mct_B": mct_b["packed_fwd"],
                             "mct_B_clcm_step": mct_clcm["packed_fwd"],
                             **{p: dec_runs[p]["packed_fwd"]
                                for p in dec_packed},
                             **gen_packed,
                             **{p: r["packed_fwd"]
                                for p, r in fl_runs.items()},
                             **{p: r["packed_fwd"]
                                for p, r in ev_runs.items()},
                             **quant_packed, **p17_fwd,
                             "dp_ranks": p18_packed["packed_fwd"],
                             "sharded_ranks": p19_packed["packed_fwd"],
                             "pipeline_ranks": p20_packed["packed_fwd"],
                             "sharded_int8_ranks":
                                 p21_packed["packed_fwd"],
                             "uneven_ranks": p22_packed["packed_fwd"]},
        "launches_per_forward": numbers["launches_per_forward"],
        "launches_by_design": {
            "serving": numbers["launches_by_design"],
            "training": training["fwd_launches_by_design"],
            "mct_A_tensor_cores": mct_a["packed_fwd_tensor_cores"],
            "mct_B_tensor_cores": mct_b["packed_fwd_tensor_cores"],
            **{f"{p}_tensor_cores": dec_runs[p]["packed_fwd_tensor_cores"]
               for p in dec_packed},
            "generation_tensor_cores": gen_packed_tc,
            **{f"{p}_tensor_cores": r["packed_fwd_tensor_cores"]
               for p, r in fl_runs.items()},
            **{f"{p}_tensor_cores": r["packed_fwd_tensor_cores"]
               for p, r in ev_runs.items()}},
        "design": blocks["design"],
        "max_abs_err": max(worst["bfloat16_tensor_cores"],
                           worst_train["fwd"]["bfloat16_tensor_cores"]),
        "max_abs_err_cuda_cores": max(
            worst["bfloat16_cuda_cores"],
            worst_train["fwd"]["bfloat16_cuda_cores"]),
        "max_abs_err_fp32": max(worst["float32"],
                                worst_train["fwd"]["float32"]),
        "ms": blocks["ms"], "plain_ms": blocks["plain_ms"],
        "bound_ms": blocks["bound_ms"], "bound_by": blocks["bound_by"],
        "library_ms": blocks["library_ms"],
        "ms_cuda_cores": blocks["ms_cuda_cores"],
        "speedup_over_cuda_cores": blocks["speedup_over_cuda_cores"],
        "shape": blocks["shape"],
        "refiner": refiner,
        "rate_0.1_training_shapes": {"blocks": tblocks["fwd_rate_0.1"],
                                     "refiner": trefiner["fwd_rate_0.1"]},
        "rate_0.1_decoder_shapes": {"self": dself["fwd_rate_0.1"],
                                    "cross": dcross["fwd_rate_0.1"]},
    }, {
        "name": "packed_attention_bwd",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/packed_attention_bwd.cu",
        "replaces": "m3p_tpu/ops/attention.py:1036",
        "launches": (training["launches"]["bwd"] + mct_a["packed_bwd"]
                     + mct_b["packed_bwd"]
                     + sum(dec_runs[p]["packed_bwd"] for p in dec_packed)
                     + sum(r["packed_bwd"] for r in fl_runs.values())
                     + sum(ev_runs[p]["packed_bwd"]
                           for p in ("trainer",) + data_runs)
                     + sum(r["packed_bwd"] for r in p17_runs.values())
                     + p18_packed["packed_bwd"] + p19_packed["packed_bwd"]
                     + p20_packed["packed_bwd"] + p21_packed["packed_bwd"]
                     + p22_packed["packed_bwd"]),
        "launches_by_path": {"training": training["launches"]["bwd"],
                             "mct_A": mct_a["packed_bwd"],
                             "mct_B": mct_b["packed_bwd"],
                             "mct_B_clcm_step": mct_clcm["packed_bwd"],
                             **{p: dec_runs[p]["packed_bwd"]
                                for p in dec_packed},
                             **{p: r["packed_bwd"]
                                for p, r in fl_runs.items()},
                             **{p: ev_runs[p]["packed_bwd"]
                                for p in ("trainer",) + data_runs},
                             **{p: r["packed_bwd"]
                                for p, r in p17_runs.items()},
                             "dp_ranks": p18_packed["packed_bwd"],
                             "sharded_ranks": p19_packed["packed_bwd"],
                             "pipeline_ranks": p20_packed["packed_bwd"],
                             "sharded_int8_ranks":
                                 p21_packed["packed_bwd"],
                             "uneven_ranks": p22_packed["packed_bwd"]},
        "launches_per_step": training["launches_per_step"]["bwd"],
        "launches_by_design": {
            "training": training["bwd_launches_by_design"],
            "mct_A_tensor_cores": mct_a["packed_bwd_tensor_cores"],
            "mct_B_tensor_cores": mct_b["packed_bwd_tensor_cores"],
            **{f"{p}_tensor_cores": dec_runs[p]["packed_bwd_tensor_cores"]
               for p in dec_packed},
            **{f"{p}_tensor_cores": r["packed_bwd_tensor_cores"]
               for p, r in fl_runs.items()},
            **{f"{p}_tensor_cores": ev_runs[p]["packed_bwd_tensor_cores"]
               for p in ("trainer",) + data_runs}},
        "design": tblocks["bwd"]["design"],
        "max_abs_err": worst_train["bwd"]["bfloat16_tensor_cores"],
        "max_abs_err_cuda_cores": worst_train["bwd"]["bfloat16_cuda_cores"],
        "max_abs_err_fp32": worst_train["bwd"]["float32"],
        "ms": tblocks["bwd"]["ms"], "plain_ms": tblocks["bwd"]["plain_ms"],
        "bound_ms": tblocks["bwd"]["bound_ms"],
        "bound_by": tblocks["bwd"]["bound_by"],
        "library_ms": tblocks["bwd"]["library_ms"],
        "library_backend": tblocks["bwd"]["library_backend"],
        "ms_rate_0.1": tblocks["bwd"]["ms_rate_0.1"],
        "ms_cuda_cores": tblocks["bwd"]["ms_cuda_cores"],
        "ms_cuda_cores_rate_0.1": tblocks["bwd"]["ms_cuda_cores_rate_0.1"],
        "tflops_per_s": tblocks["bwd"]["tflops_per_s"],
        "plain_ms_rate_0.1": tblocks["bwd"]["plain_ms_rate_0.1"],
        "shape": tblocks["shape"],
        "refiner": trefiner["bwd"],
        "decoder_shapes": {"self": dself["bwd"], "cross": dcross["bwd"]},
        "mask_identity_keep_share": keep_share,
        "mask_identity_keep_share_bf16": keep_share_bf16,
        "mask_identity_keep_share_causal_t63": keep_share_causal,
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/flash_attention.cu",
        "replaces": "m3p_tpu/ops/attention.py:177",
        "launches": (long_ctx["launches"]["fwd"]
                     + dec_runs["clm"]["flash_fwd"] + long_flash
                     + sp_flash["flash_fwd"]),
        "launches_by_path": {"xmlm": long_ctx["launches"]["fwd"],
                             "clm": dec_runs["clm"]["flash_fwd"],
                             "generation_long_decode": long_flash,
                             "sp_one_process": sp_flash["flash_fwd"]},
        "launches_per_step": long_ctx["launches_per_step"]["fwd"],
        "launches_by_design": {
            **long_ctx["launches_by_design"]["fwd"],
            "generation_long_decode_tensor_cores":
                gen_runs["long_decode"]["flash_fwd_tensor_cores"]},
        "design": flash_fwd["design"],
        "decode_shape": generation["flash_decode_shape"],
        "max_abs_err_decode_shape": flash_worst["decode"],
        "max_abs_err": flash_worst["fwd"]["bfloat16_tensor_cores"],
        "max_abs_err_cuda_cores": flash_worst["fwd"]["bfloat16_cuda_cores"],
        "max_abs_err_fp32": flash_worst["fwd"]["float32"],
        "ms": flash_fwd["ms"], "plain_ms": flash_fwd["plain_ms"],
        "bound_ms": flash_fwd["bound_ms"], "bound_by": flash_fwd["bound_by"],
        "library_ms": flash_fwd["library_ms"],
        "ms_rate_0.1": flash_fwd["ms_rate_0.1"],
        "ms_cuda_cores": flash_fwd["ms_cuda_cores"],
        "ms_cuda_cores_rate_0.1": flash_fwd["ms_cuda_cores_rate_0.1"],
        "tflops_per_s": flash_fwd["tflops_per_s"],
        "shape": flash_fwd["shape"],
        "mask_identity_keep_share": flash_share,
        "mask_identity_keep_share_bf16": flash_share_bf16,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "m3p_tpu/ops/attention.py:471",
        "replaces_also": "m3p_tpu/ops/attention.py:512",
        "launches": (long_ctx["launches"]["bwd"]
                     + dec_runs["clm"]["flash_bwd"] + sp_flash["flash_bwd"]),
        "launches_by_path": {"xmlm": long_ctx["launches"]["bwd"],
                             "clm": dec_runs["clm"]["flash_bwd"],
                             "sp_one_process": sp_flash["flash_bwd"]},
        "launches_per_step": long_ctx["launches_per_step"]["bwd"],
        "launches_by_design": long_ctx["launches_by_design"]["bwd"],
        "design": flash_bwd["design"],
        "max_abs_err": flash_worst["bwd"]["bfloat16_tensor_cores"],
        "max_abs_err_cuda_cores": flash_worst["bwd"]["bfloat16_cuda_cores"],
        "max_abs_err_fp32": flash_worst["bwd"]["float32"],
        "ms": flash_bwd["ms"], "plain_ms": flash_bwd["plain_ms"],
        "bound_ms": flash_bwd["bound_ms"], "bound_by": flash_bwd["bound_by"],
        "library_ms": flash_bwd["library_ms"],
        "ms_rate_0.1": flash_bwd["ms_rate_0.1"],
        "ms_cuda_cores": flash_bwd["ms_cuda_cores"],
        "ms_cuda_cores_rate_0.1": flash_bwd["ms_cuda_cores_rate_0.1"],
        "tflops_per_s": flash_bwd["tflops_per_s"],
        "shape": flash_bwd["shape"],
    }, {
        "name": "fused_dropout_fwd",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/fused_dropout.cu",
        "replaces": "m3p_tpu/ops/dropout.py:35",
        "launches": (mct_b["dropout_fwd"]
                     + dec_runs["caption_fused"]["dropout_fwd"]
                     + sum(fl_runs[p]["dropout_fwd"] for p in fl_fused)
                     + p17_runs["int8_mct_B"]["dropout_fwd"]),
        "launches_by_path": {
            "mct_B": mct_b["dropout_fwd"],
            "caption_fused": dec_runs["caption_fused"]["dropout_fwd"],
            **{p: fl_runs[p]["dropout_fwd"] for p in fl_fused},
            "int8_mct_B": p17_runs["int8_mct_B"]["dropout_fwd"]},
        "launches_per_step": mct["B"]["launches_per_step"]["dropout_fwd"],
        "launches_clcm_step": mct_clcm["dropout_fwd"],
        "design": drop_fwd["design"],
        "launches_by_design": {"mct_B_wide": mct_b["dropout_fwd_wide"],
                               "mct_B_clcm_step_wide":
                                   mct_clcm["dropout_fwd_wide"],
                               "caption_fused_wide":
                                   dec_runs["caption_fused"][
                                       "dropout_fwd_wide"],
                               **{f"{p}_wide":
                                  fl_runs[p]["dropout_fwd_wide"]
                                  for p in fl_fused}},
        "ms_narrow": drop_fwd["ms_narrow"],
        "ms_turns": drop_fwd["ms_turns"],
        "speedup_over_narrow": drop_fwd["speedup_over_narrow"],
        "max_abs_err": drop_worst["bfloat16"],
        "max_abs_err_fp32": drop_worst["float32"],
        "ms": drop_fwd["ms"], "plain_ms": drop_fwd["plain_ms"],
        "bound_ms": drop_fwd["bound_ms"], "bound_by": drop_fwd["bound_by"],
        "library_ms": drop_fwd["library_ms"],
        "shape": drop_fwd["shape"],
        "mask_identity_keep_share": drop_share,
    }, {
        "name": "fused_dropout_bwd",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/fused_dropout.cu",
        "replaces": "m3p_tpu/ops/dropout.py:43",
        "launches": (mct_b["dropout_bwd"]
                     + dec_runs["caption_fused"]["dropout_bwd"]
                     + sum(fl_runs[p]["dropout_bwd"] for p in fl_fused)
                     + p17_runs["int8_mct_B"]["dropout_bwd"]),
        "launches_by_path": {
            "mct_B": mct_b["dropout_bwd"],
            "caption_fused": dec_runs["caption_fused"]["dropout_bwd"],
            **{p: fl_runs[p]["dropout_bwd"] for p in fl_fused},
            "int8_mct_B": p17_runs["int8_mct_B"]["dropout_bwd"]},
        "launches_per_step": mct["B"]["launches_per_step"]["dropout_bwd"],
        "launches_clcm_step": mct_clcm["dropout_bwd"],
        "design": drop_bwd["design"],
        "launches_by_design": {"mct_B_wide": mct_b["dropout_bwd_wide"],
                               "mct_B_clcm_step_wide":
                                   mct_clcm["dropout_bwd_wide"],
                               "caption_fused_wide":
                                   dec_runs["caption_fused"][
                                       "dropout_bwd_wide"],
                               **{f"{p}_wide":
                                  fl_runs[p]["dropout_bwd_wide"]
                                  for p in fl_fused}},
        "ms_narrow": drop_bwd["ms_narrow"],
        "ms_turns": drop_bwd["ms_turns"],
        "speedup_over_narrow": drop_bwd["speedup_over_narrow"],
        "max_abs_err": drop_worst["bfloat16"],
        "max_abs_err_fp32": drop_worst["float32"],
        "ms": drop_bwd["ms"], "plain_ms": drop_bwd["plain_ms"],
        "bound_ms": drop_bwd["bound_ms"], "bound_by": drop_bwd["bound_by"],
        "library_ms": drop_bwd["library_ms"],
        "shape": drop_bwd["shape"],
    }, {
        "name": "small_attention_fwd",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/small_attention.cu",
        "replaces": "m3p_tpu/ops/attention.py:696",
        "launches": bhsd_counts["small_fwd"],
        "launches_by_path": {"attention_bhsd": bhsd_counts},
        "launches_by_design": {
            "tensor_cores": bhsd_counts["small_fwd_tensor_cores"]},
        "design": small_times["fwd"]["design"],
        "max_abs_err": small_worst["fwd"]["bfloat16_tensor_cores"],
        "max_abs_err_cuda_cores": small_worst["fwd"]["bfloat16_cuda_cores"],
        "max_abs_err_fp32": small_worst["fwd"]["float32"],
        "ms": small_times["fwd"]["ms"],
        "plain_ms": small_times["fwd"]["plain_ms"],
        "bound_ms": small_times["fwd"]["bound_ms"],
        "bound_by": small_times["fwd"]["bound_by"],
        "library_ms": small_times["fwd"]["library_ms"],
        "ms_rate_0": small_times["fwd"]["ms_rate_0"],
        "ms_turns": small_times["fwd"]["ms_turns"],
        "ms_cuda_cores": small_times["fwd"]["ms_cuda_cores"],
        "speedup_over_cuda_cores":
            small_times["fwd"]["speedup_over_cuda_cores"],
        "packed_layout_ms": small_times["fwd"]["packed_layout_ms"],
        "shape": small_times["fwd"]["shape"],
        "mask_identity_keep_share": small_share["float32"],
        "vs_packed_path_max_abs_diff": layout,
    }, {
        "name": "small_attention_bwd",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/small_attention.cu",
        "replaces": "m3p_tpu/ops/attention.py:713",
        "launches": bhsd_counts["small_bwd"],
        "launches_by_design": {
            "tensor_cores": bhsd_counts["small_bwd_tensor_cores"]},
        "design": small_times["bwd"]["design"],
        "max_abs_err": small_worst["bwd"]["bfloat16_tensor_cores"],
        "max_abs_err_cuda_cores": small_worst["bwd"]["bfloat16_cuda_cores"],
        "max_abs_err_fp32": small_worst["bwd"]["float32"],
        "mask_identity_keep_share_bf16": small_share["bfloat16"],
        "ms": small_times["bwd"]["ms"],
        "plain_ms": small_times["bwd"]["plain_ms"],
        "bound_ms": small_times["bwd"]["bound_ms"],
        "bound_by": small_times["bwd"]["bound_by"],
        "library_ms": small_times["bwd"]["library_ms"],
        "library_backend": small_times["bwd"]["library_backend"],
        "ms_rate_0": small_times["bwd"]["ms_rate_0"],
        "ms_turns": small_times["bwd"]["ms_turns"],
        "ms_cuda_cores": small_times["bwd"]["ms_cuda_cores"],
        "ms_cuda_cores_rate_0": small_times["bwd"]["ms_cuda_cores_rate_0"],
        "packed_layout_ms": small_times["bwd"]["packed_layout_ms"],
        "shape": small_times["bwd"]["shape"],
    }, {
        "name": "fused_ffn_ln",
        "route": "cuda",
        "source": "m3p_tpu_torch/csrc/fused_ffn.cu",
        "replaces": "m3p_tpu/ops/fused_ffn.py:35",
        "launches": ffn["launches"],
        "launches_by_design": ffn["launches_by_design"],
        "design": ffn["design"],
        "max_abs_err": ffn_worst["bfloat16_cluster"][0],
        "mean_abs_err": ffn_worst["bfloat16_cluster"][1],
        "max_abs_err_tile32": ffn_worst["bfloat16_tile32"][0],
        "max_abs_err_cuda_cores": ffn_worst["bfloat16_cuda_cores"][0],
        "max_abs_err_fp32": ffn_worst["float32_cuda_cores"][0],
        "max_abs_err_vs_encoder_block": ffn_block["max_abs"],
        "ms": ffn["kernel_ms"], "plain_ms": ffn["plain_ms"],
        "bound_ms": ffn["bound_ms"], "bound_by": ffn["bound_by"],
        "library_ms": ffn["library_ms"],
        "ms_turns": ffn["ms_turns"], "ms_tile32": ffn["ms_tile32"],
        "speedup_over_tile32": ffn["speedup_over_tile32"],
        "clusters_at_once": ffn["clusters_at_once"],
        "shape": ffn["shape"],
    }]}
    serving = {k: numbers[k] for k in ("score_pairs_per_s",
                                       "forward_ms_64x164",
                                       "retrieve_p50_ms", "retrieve_p99_ms")}
    serving["fp32_card_vs_cpu_max_diff"] = fp32_diff
    log(f"[serving] {json.dumps(serving)} on {card}")
    log(f"[training] {json.dumps(training)} on {card}")
    log(f"[long_context] {json.dumps(long_ctx)} on {card}")
    log(f"[mct] {json.dumps(mct)} on {card}")
    log(f"[fused_ffn] {json.dumps(ffn)}")
    log(f"[decoder] {json.dumps(decoder)} on {card}")
    log(f"[generation] {json.dumps(generation)} on {card}")
    log(f"[freelb] {json.dumps(freelb)} on {card}")
    log(f"[eval] {json.dumps(evaluation)} on {card}")
    log(f"[trainer] {json.dumps(trainer)} on {card}")
    log(f"[datasets] {json.dumps(datasets)} on {card}")
    log(f"[quant] {json.dumps(quant)} on {card}")
    log(f"[int8 train and variants] {json.dumps(variants)} on {card}")
    log(f"[parallel] {json.dumps(parallel)} on {card}")
    log(f"[uneven] {json.dumps(uneven)} on {card}")
    log(f"[clock] {json.dumps(CLOCK['laps'])}; in {CLOCK['profiles']} "
        f"profiler windows {CLOCK['profile_s']:.1f} s")
    log(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
