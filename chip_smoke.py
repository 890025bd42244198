#!/usr/bin/env python
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a build) and the repository
around it; it exits non-zero, printing no result, without either. Phases,
each of which raises on failure:

  0. build every kernel of the port from ``opentransformer_tpu_torch/csrc``
     with nvcc (one process per source, all at once) and print ptxas's
     register, shared-memory and spill lines; the top-k kernels must not
     spill;
  1. hold the ``project_logp_topk`` kernel against its plain PyTorch
     version on the card at the decode shapes (the conformer's D=384
     among them), the tile edges (N=65, N=2561, D=40, D=56, V=131, rows not
     on 16 bytes) and ties, and time the kernel, the plain version and the
     unfused three-call composition, with the achieved rate and the share of
     the bound, at the beam step's shapes, at the anchor's CTC shapes
     (N = 100 utterances x 239 frames, k=1 and k=32 with lse), at the
     streamed CTC tick (N = 32 slots x 16 frames, D=384, k=1) and at the
     transducer's greedy lattice step (k=1, D=256, N = 1, 4, 8, 16, 32, 64);
     device time (``torch.profiler``) beside the top-1 and top-32 times;
  1b. the same for the two-head ``project2_logp_topk`` kernel of LM shallow
     fusion: flagship, LSTM-LM and anchor widths, the tile edges (D2=1024
     among them), lm weights 0.1, 0 and -0.3, ties;
  1c. hold kernel 4 (``beam_attention``, the beam step's attention over its
     caches, both entries) against its plain version on the card at the
     offline decode cell's shapes (B = 1,024 utterances, beam 5, 4 heads of
     64, bf16; 62 and 374 frames, steps 1 and 54) and in float32 at heads of
     32 and 96 (bf16 cross calls take the one-pass entry, held to the
     float64 attention within twice the plain version's own distance), and
     time the kernel, the plain version and, for the cross entry,
     ``scaled_dot_product_attention`` beside the byte bound (the one-pass
     entry at the long-form shape, B 128, K 5, H 20, T 1,500, and at the
     decode shape, also with its key padding); and the wrapper's host time
     a call; every later phase counts kernel 4's
     launches in this process (phase 3's decode: one of each entry per
     decoder block and step, every cross launch through the one-pass entry);
  1d. hold kernel 5 (``encoder_attention``, self-attention at inference:
     the encoders' bf16 encode) against the float64 attention at the
     long-form cell's slice (22 Whisper windows, 20 heads of 64, 1,500
     positions), the decode cell's longest bucket (1,024 x 374, 4 heads of
     64, key padding), heads of 32 and 128, T_q != T_k, a row with no valid
     key, a mask with holes and rows of 1 to 130 keys: within twice the
     plain composition's own distance, the short rows also launched 50
     times back to back, each equal to the first; time the kernel, the
     plain version and
     ``scaled_dot_product_attention`` at the first two beside the bf16
     operation bound; every later phase counts kernel 5's launches;
  2. decode the 500-utterance synthetic test split with the committed
     anchor weights through the eval CLI in float32 (fails above 0.75% CER;
     the JAX package scored 0.65%; fails when more than 5 utterances' 1-best
     ids differ from the JAX package's, committed beside the weights as
     ``anchor_synth_f16.jax_1best.json``) and in bfloat16, showing the
     decode went through the kernel;
  3. drive the flagship geometry (d256, 12 encoder + 6 decoder blocks,
     V=4233) with seeded random weights: beam 5, bf16, 512 utterances x 500
     frames, 24 steps with EOS disabled, as bench.py's worst-case row; its
     counted decode launches kernel 4 twice a decoder block and step and
     kernel 5 once an encoder block;
  4. decode the anchor split through the eval CLI with a seeded random
     transformer LM handed over as an npz: at ``-lmw 0.0`` the fused score
     is the model's own, so the CER limit of phase 2 holds and every step
     must have gone through the two-head kernel, and the 1-best ids are
     held to the JAX fixture as in phase 2; ``-lmw 0.1`` and
     ``-lm_resc 0.1`` are run and reported (the LM is untrained);
  5. the flagship geometry with LM shallow fusion: fused and unfused
     decodes agree on a small input for a transformer LM (ancestry-map
     caches) and an LSTM LM (gathered state), then the worst case of phase 3
     with bench.py's ``lm_fusion`` LM, one two-head launch per step, and
     what fusion costs: decodes without and with the LM timed in turns;
  6. hold the ``spec_mel`` fbank kernel (FFT → power → mel → log) against
     its plain version and a float64 spectrum through ``fbank_batch`` at the
     on-device pipeline's geometries, ragged rows and a silent row included,
     and time the kernel, the plain version, the rfft composition and the
     framing (``extract_frames``) at 16 utterances of 10 s, each call on one
     of four separate frame buffers so that its input is cold in L2;
  7. train ``transformer_baseline`` (conf/transformer_baseline.json: d256,
     12 encoder + 6 decoder blocks, V=4233, batch 16, accum 4) from raw
     waveforms through the training CLI on a seeded corpus of 64 + 16 wavs:
     2 epochs, 8 micro-batches, 2 updates, one fbank launch per micro-batch;
     finite losses, no skipped update, a checkpoint that reloads into the
     same decode; the kernel against the plain spectrum on one micro-batch
     (features and loss); seconds per update and peak memory; and a
     width-64 model that must halve its loss in 40 updates on 8 utterances;
  8. CTC decoding of the anchor split through the eval CLI in float32,
     each decode held to the JAX package's CPU ids in
     ``anchor_synth_f16.jax_ctc.json`` (``tools/torch_port_ctc_parity.py``;
     at most 5 of 500 may differ): (a) the anchor's frontend, encoder and
     CTC head as a ``ctc`` model, greedy, one top-1 launch of kernel 1 per
     batch, CER at most 0.10 points above the fixture's; (b) the same at
     prefix beam 5 over each frame's top 32 (kernel 1 with lse, one launch
     per batch, then the native decoder), CER within 0.10 points; (c) the
     speech2text anchor at beam 5 with joint CTC/attention rescoring at
     ``-ctcw 0.3`` (CER at most 0.75%, n-best scores sorted); (d) the hybrid
     loss of one anchor batch with seeded targets on the card against the
     CPU, CTC and attention parts each to 1e-4 relative;
  9. the conformer configs (``conf/conformer_baseline.json`` and
     ``conformer_streaming.json``, encoded offline) at full width with
     seeded weights: (a) in float32 against the JAX package's CPU numbers
     of the same weights and 16 seeded utterances,
     ``conformer_seeded.jax.json`` (``tools/torch_port_conformer_parity.py``):
     the encoder memory projected on a seeded unit vector, teacher-forced
     log-probs, beam-5 1-best ids over 24 forced steps (limits below), one
     kernel-1 launch a step; (b) fused and unfused decodes agree on a small
     input; (c) the worst case of phase 3 at 80 mel in bf16, and the encode
     alone; (d) ``conformer_baseline`` trained through the CLI on phase 7's
     corpus, with phase 7's checks;
  10. streaming and serving (``conformer_streaming`` at full width, seeded
     weights, float32 unless said): (a) the 16 utterances of phase 9 streamed
     in 64-frame feeds through ``StreamingEncoderSession`` and through
     ``MultiStreamAttention`` with 16 slots opened on 16 ticks, the memory
     projection held to the JAX package's streamed numbers in
     ``conformer_streaming.jax_stream.json`` (``tools/torch_port_stream_parity.py``)
     and the memory to the port's offline chunk-masked encode; (b) a ``ctc``
     model of that encoder through ``MultiStreamCTC``, ids held to JAX's
     and to the port's offline greedy, one kernel-1 launch a tick (N = 16 x
     16 rows); (c) ``LongFormRecognizer`` on two 2,500-3,000-frame
     utterances, the windowed memory against JAX's, 24 kernel-1 launches in
     a forced beam-5 decode; (d) the anchor's 500 utterances through the
     serve CLI's ``DynamicBatcher`` (8 rows, buckets 200-1600), CER and ids
     as phase 2, then with phase 4's LM at weight 0 through the two-head
     kernel; (e) the serve CLI with ``--streaming --streams 4`` on a free
     port, 8 concurrent PCM clients sending phase 7's wavs in 100 ms frames,
     each FINAL equal to an in-process ``run_stream`` over the same
     ``StreamingFbank`` features, every slot free afterwards; (f) 32 slots
     of 20 s through ``MultiStreamCTC`` and ``MultiStreamAttention`` (beam
     5, 32 forced steps, a re-decode every tick) in bf16: tick times, RTFx,
     peak memory, launches a tick and the encoder step's share;
  11. the transducer (``conf/transducer.json`` and ``transducer_streaming.json``:
     d256, 12 blocks, a 1-layer d256 LSTM predictor, d_joint 256, V=4233, 40
     mel) at full width with seeded weights (the joint's output kernel scaled
     so that the beam's 1-best holds labels, its blank bias raised so that
     blank is the argmax at about a third of the lattice steps), float32
     unless said, held to the JAX package's CPU numbers in
     ``transducer_seeded.jax.json`` (``tools/torch_port_transducer_parity.py``)
     on 16 seeded utterances of 300-500 frames: (a) the encoder memory
     projection, the joint log-probs along a lattice path and the greedy ids,
     one kernel-1 launch (k=1) a greedy loop iteration; (b) beam 4 with 2
     expansions a frame, without an LM and with a seeded LSTM and transformer
     LM fused at 0.3 (plain PyTorch: no kernel), most 1-bests labelled; (c)
     the streaming config through ``StreamingTransducerRecognizer`` in
     64-frame feeds (held to the port's offline greedy of each chunk-masked
     utterance and to JAX's streamed ids) and ``MultiStreamTransducer`` (16
     staggered slots, a slot reused); (d) ``cli/eval.py -bw 1`` and ``-bw 4`` over phase 7's dev wavs,
     and the serve CLI with ``--streaming --streams 4`` (its default ``-mt
     8``) and 4 PCM clients; (e) timed: greedy (with kernel 1's device time
     from ``torch.profiler``) and beam over 64 x 500 frames, and 32 slots x
     20 s through ``MultiStreamTransducer`` in bf16;
  12. the anchor recipe (``conf/anchor.json``: kaldi features, bucketing,
     the device-resident corpus, noise 0.3, bf16 autocast, steps_per_exec
     24, the per-epoch dev greedy-CER probe, the hybrid CTC loss) through the
     training CLI on the full synthetic corpus, cut to 2 epochs of its 80:
     624 updates, finite losses, no NaN skip, the resident corpus 1,843,200,000
     bytes, one kernel-1 launch (k=1) a probe step and none elsewhere in the
     run, epoch 1's mean loss below the first 50 updates'; kernel 1 at the
     probe's step on the trained model's own hidden states against its plain
     version, and timed; the average of epochs 0-1 through the averaging and
     eval CLIs over the 500 test utterances at beam 5, ``-ml 32`` (n-best
     sorted; CER recorded, not gated); seconds per update, peak memory and
     the resident upload recorded;
  13. training every model family the port decodes (float32 unless said):
     (a) the JAX package's tiny transducer test (its corpus of 40 utterances
     and its d32 config, 40 epochs at a constant 3e-3) through the training
     CLI, then ``cli/eval.py`` greedy from the last checkpoint: CER below
     20% (the JAX test's gate), kernel-1 launches = the greedy loop's
     iterations; (b) ``conf/transducer.json`` at full width on the first
     1,024 synthetic train utterances, batch 8, 100 updates with the full
     joint (``joint_t_block: -1``) and 20 with T-blocks of 32: seconds per
     update, peak memory and the RNN-T loss's own forward + backward time of
     each, and a checkpoint that reloads to the same greedy ids; (c)
     ``conformer_baseline`` with BatchNorm conv modules through the CLI on
     phase 7's wavs (phase 7's checks: one kernel-3 launch a micro-batch, a
     reload, with its batch_stats, to the same beam-5 ids through kernel 1
     at D = 384), every block's running statistics moved, and one
     micro-batch's statistics update on the card within 1e-4 relative of
     the CPU's; (d) phase 8a's ``ctc`` model warm-started from the anchor
     (``-im``) for 50 updates, reloaded to the same greedy ids, decoded by
     the eval CLI (one launch a batch); (e) ``conf/rnn_lm.json`` and
     ``conf/transformer_lm.json`` at full width, one epoch of the 20,000
     train lines each through the CLI (batch 16, accum 4): held-out NLL of
     the 500 test lines, the RNN LM's at most 6.0 nats, the transformer
     LM's below its untrained value; the anchor decoded with the trained
     transformer LM's checkpoint directory at ``-lmw 0.3`` through kernel 2 alone
     (CER recorded); and each family at width 64 halving its loss in 40
     updates on 8 samples;
  14. the reference user's round trip: (a) the committed anchor exported by
     ``tools/torch_export_reference.py`` to a reference ``anchor.pt`` and
     imported back by ``tools/torch_import_reference.py`` (every array bitwise
     the npz's as float32), then decoded anchor.sh's way, ``cli/eval.py -m
     anchor.pt -c <conf/anchor.json on the synthetic dir> -bw 5 -pn 0.6 -ml 32
     -b 100 -d test``: CER at most 0.75%, at most 5 of 500 1-best ids off the
     JAX fixture, one kernel-1 launch a beam step (counted apart, as calls of
     the cached top-k step), no kernel-2 launch, and JAX's directory name
     ``decode_test_bw5_pn0.6_ml32``; again with phase 4's seeded LM as a
     reference LM ``.pt`` at ``-lmw 0.0`` (CER at most 0.75%, kernel 2 only),
     and with ``-ns 100 -sba -s sba`` (100 utterances, each n-best ranked by
     score / length); (b) seeded full-width ``conformer_baseline`` (BatchNorm,
     ``ref_compat``, rel-pos; seeded BatchNorm statistics) and
     ``transformer_baseline`` (``concat_after`` in encoder and decoder,
     ``front_end_layer_norm``) through the port's export to ``.pt`` and its
     import (bitwise), then ``cli/eval.py -m x.pt -c`` at beam 5 on 16 seeded
     utterances (80 and 40 mel): 1-bests equal to the in-process decode of the
     unexported model, kernel 1 at D = 384 and D = 256; (c)
     ``transformer_baseline`` from phase 7's wavs for 3 epochs with ``-ms``,
     ``train.fused_update``, ``adam_m_dtype: bfloat16``, ``--async-save`` and
     ``--supervise 1`` with the fault armed at epoch 1's update: the fault
     fires once, every epoch's checkpoint exists, kernel 3 launches once a
     micro-batch across both child processes (each appends its ``--record``
     line), losses finite with no NaN skip, the resumed child starting at the
     saved global step; then ``cli/eval.py -m EXP -d dev --profile`` (kernel 1,
     a trace with device kernels) equal to an ``--npz`` decode of the same
     checkpoint, and seconds per update of the unfused and fused updates in
     turns;
  15. mixture of experts (float32 unless said): (a) ``conf/transformer_moe.json``
     (the aishell MoE speech-transformer: d256, 12 encoder blocks, every second
     one's FFN 4 experts of d_ff 1024, top-2, capacity 1.25; 41 M parameters)
     with seeded weights on phase 11's 16 utterances, held to the JAX package's
     CPU numbers in ``transformer_moe_seeded.jax.json``
     (``tools/torch_port_moe_parity.py``): the memory projection, teacher-forced
     log-probs, each MoE layer's load-balance loss (1e-4 relative) and routing
     (every choice's expert, kept or dropped: at most 0.1% of a layer's tokens
     differing), beam-5 1-best ids over 24 forced steps, one kernel-1 launch a
     step; (b) phase 3's bf16 worst case with it, its encode alone timed in
     turns with the dense flagship's and its peak memory, and one MoE FFN call
     (and its routing alone) beside a dense one; (c) trained through the CLI on
     phase 7's wavs with router jitter and dropout on (phase 7's checks: one
     kernel-3 launch a micro-batch, a reload to the same beam-5 ids), every
     ``moe_aux`` finite, one micro-batch's loss and ``moe_aux`` on the card
     within 1e-4 relative of the CPU's, and its width-64 model halving its loss
     in 40 updates; (d) ``conf/transformer_lm.json`` as a drop-free MoE LM (4
     experts, top-1, capacity 4.0): fused and unfused decodes agree on a small
     input, the anchor at ``-lmw 0.0`` through kernel 2 alone within phase 4's
     limits, and the drop-free warning at capacity 1.25; (e)
     ``conformer_streaming`` with a drop-free MoE second FFN (4 experts, top-2,
     capacity 2.0) streamed in 64-frame feeds through ``StreamingEncoderSession``
     and ``MultiStreamAttention`` (16 slots, one reused): the memory against the
     port's offline chunk-masked encode and its projection against JAX's
     streamed one in ``conformer_streaming_moe.jax_stream.json``, a ctc head
     through ``MultiStreamCTC`` (one kernel-1 launch a tick), and the capacity
     warning at capacity 1.25;
  16. parallelism on ``torch.distributed`` (``opentransformer_tpu_torch/parallel/``),
     on phase 7's first 16 wavs in batches of 8 with SpecAugment, dropout and
     router jitter off: (a) at world 1 through the training CLI (an NCCL
     process group; each axis has one rank, so no collective is issued),
     ``transformer_baseline`` with ``scan_layers`` under ``-n 1 --tp 1 --pp 1
     --ep 1``, ``--pp-schedule sharded`` and ``--pp-schedule 1f1b
     --pp-micro-batches 2``, and ``transformer_moe`` under ``-n 1 --ep 1``,
     each run's losses held to the plain trainer's on the same seed (the 1F1B
     run to its loss rule, two row blocks with the loss over 2, on the plain
     trainer) within 1e-5 relative, an update's time beside the plain
     trainer's, then ``eval -n 1`` of the ``-n 1`` checkpoint through kernel
     1; (b) two ranks on the one card: a child process finds whether NCCL
     carries two ranks on ``cuda:0`` (it refuses a duplicate device), and the
     2-rank world runs dp 2, tp 2, pp 2 (sharded, and 1F1B where the backend
     carries its point-to-point sends: Gloo does not for CUDA tensors) and ep 2
     at full width over the backend that carries them, each step's loss (1e-5
     relative), gradients (1e-3 of each tensor's largest) and norm held to the
     one-rank step, and each rank of the sharded pipe below the one-rank
     step's peak and held memory, a mode not run printed with its reason
     (no run here moves data over NCCL between ranks); then ``eval -n
     2`` of the anchor on 101 test utterances at ``-b 50`` with and without
     ``-lm`` against ``eval -n 1`` (the same predict.txt and RESULT, predict.log
     up to a score's last printed digit), kernels 1 and 2 launched on each
     rank;
  17. the port's measuring tools and recipe, each tool's ``main`` run in
     this process at its own sizes: (a) ``tools/torch_profile_decode.py
     --quick`` (encode, searches of 24 and 4 steps and their slope, B=512
     x 500 frames, bf16, beam 5) and ``--lm`` (no LM, LMs of 0, 1 and 6
     blocks): kernel 1 launched once a search step without an LM and never
     with one, kernel 2 once a step with one, each timing's device time
     (``torch.profiler``) above 0; (b) ``tools/torch_profile_train.py
     --iters 4`` (the flagship update, B16 x T512, bf16): its categories sum
     to the device total, its idle share in [0, 1]; (c)
     ``tools/torch_stream_latency.py -n 16 --seconds 10`` and ``--paced
     --seconds 5``: a FINAL on every stream, one kernel-1 launch a tick; (d)
     ``tools/torch_probe_decode_precision.py``: the anchor's 500 test
     utterances in five precision configurations, f32 within phase 2's
     limits (CER 0.75%, 5 of 500 ids off JAX's), the others recorded; (e)
     ``tools/torch_probe_cost_analysis.py``: the flagship update's FLOPs
     (20 updates and 4 micro-batches counting 20 and 4 times one) and its
     MFU; (f) ``--multihost``'s per-host loading: two processes in
     torchrun's environment on the one card (Gloo), each reading only its
     data shard of phase 16's corpus in batches of 7 (4 + 3 rows: gathered
     whole), each step's loss and gradients held to the plain trainer's
     step on the host-major global batch within 16b's limits; (g)
     ``conf/flagship.json`` on phase 12's corpus through the training CLI,
     cut to its first epoch's 32 updates (``-debug``) with the resident
     corpus and the dev probe (one kernel-1 launch a greedy step), then
     the average, decode (500 utterances) and export commands of
     ``egs/synth_bench/continue_torch.sh``, each run as the script runs it.

The two lines before the last are the kernels' JSON record and the card's
name and power limit; the last line is the run's JSON status.
"""

from __future__ import annotations

import gc
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, TF32 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# the tensor-core kernels (top-k, the encoder's attention) are held to 0 bytes
# of register spill and of stack frame (an accumulator or list array that
# falls to local memory)
NO_SPILL_SOURCES = ("project_topk", "project2_topk", "encoder_attention")
ANCHOR = os.path.join(REPO, "egs", "synth_bench", "trained", "anchor_synth_f16")
ANCHOR_CER_LIMIT = 0.75
# the JAX package's 1-best ids of the anchor split (CPU, float32), written by
# tools/torch_port_anchor_parity.py --write; phases 2 (f32) and 4 (-lmw 0.0)
# fail when more utterances than this decode to other ids on the card
ANCHOR_JAX_1BEST = ANCHOR + ".jax_1best.json"
ANCHOR_ID_LIMIT = 5
# phase 8: the JAX package's CTC decodes of the split (greedy, prefix beam,
# -ctcw rescoring), written by tools/torch_port_ctc_parity.py --write; the
# card's CER may sit 0.10 points off the fixture's
ANCHOR_JAX_CTC = ANCHOR + ".jax_ctc.json"
CTC_CER_MARGIN = 0.10
# phase 8d: the card's hybrid-loss parts against the CPU's, relative
HYBRID_LOSS_RTOL = 1e-4
# kernel 1 at the anchor's CTC shapes: 100 utterances of up to 960 frames,
# 239 encoder frames each after the 4x subsampling
CTC_ROWS = 100 * 239
# kernel 1 in a streamed CTC tick: 32 slots x a chunk of 16 encoder frames
STREAM_ROWS = 32 * 16
# phase 6: the device pipeline's geometries (tools/tpu_smoke.py:64-65) plus a
# silent row; |Δ log-mel| on valid frames. The plain version sums 400
# float32 products per DFT bin, the kernel's FFT 9 radix-2 levels, each
# with a rounding error relative to the sum of the magnitudes it combines.
# Where a mel energy is large that moves its log by ~1e-6; in a mel bin that
# holds only a strong tone's side lobes the terms cancel to ~1e-3 of their
# magnitude, and either float32 route can land ~1e-3 from the exact
# (float64) log-mel (the plain version 7e-4 at M = 80, the FFT 3e-4). So the
# kernel is held to 1e-3 of the float64 result and to 2e-3 of the plain
# version, whose own error may fall on the other side.
FBANK_ATOL = 2e-3
FBANK_EXACT_ATOL = 1e-3
FBANK_CASES = [("B=4 N=16000 M=40", 4, 16000, 40, None),
               ("B=2 N=65536 M=40", 2, 65536, 40, None),
               ("B=4 N=48000 M=80", 4, 48000, 80, None),
               ("B=8 N=160000 M=40", 8, 160000, 40, None),
               ("B=3 N=32000 M=40 with a silent row", 3, 32000, 40, 2)]
FBANK_TIMED = (16, 160000, 40)  # the training batch: 16 utterances of 10 s
CONF_DIR = os.path.join(REPO, "opentransformer_tpu_torch", "conf")
TRAIN_CONF = os.path.join(CONF_DIR, "transformer_baseline.json")
TRAIN_CORPUS = dict(train=64, dev=16, min_s=2.0, max_s=10.0, min_units=8, max_units=28)
OVERFIT = dict(d_model=64, enc_blocks=2, dec_blocks=1, d_ff=256, utts=8, updates=40, lr=1e-3)
FLAGSHIP_CFG = {
    "type": "speech2text",
    "frontend": {"input_size": 40, "output_size": 256, "in_channel": 1, "mid_channel": 64,
                 "out_channel": 128, "kernel_size": [[3, 3], [3, 3]], "stride": [2, 2]},
    "encoder": {"d_model": 256, "n_heads": 4, "d_ff": 2048, "n_blocks": 12,
                "normalize_before": False, "activation": "glu"},
    "decoder": {"vocab_size": 4233, "d_model": 256, "n_heads": 4, "d_ff": 2048,
                "memory_dim": 256, "n_blocks": 6, "activation": "glu", "share_embedding": True},
}
# the LM of bench.py's lm_fusion row, and the LSTM LM of egs/aishell/conf/rnnlm.yaml
FLAGSHIP_LM_CFG = {"type": "transformer_lm", "vocab_size": 4233, "d_model": 256, "n_heads": 4,
                   "d_ff": 2048, "num_blocks": 6, "activation": "glu", "share_embedding": True}
LSTM_LM_CFG = {"type": "rnn_lm", "vocab_size": 4233, "num_layers": 2, "hidden_size": 1024,
               "share_embedding": True}
# anchor-sized LM for the CLI phase: the flagship LM's widths, depth cut to 2
ANCHOR_LM_CFG = dict(FLAGSHIP_LM_CFG, num_blocks=2)
WORST_CASE = dict(batch=512, frames=500, max_len=24, beam=5)
# phase 9: the committed conformer configs, held on the card to the JAX
# package's CPU run of the same seeded weights and inputs
# (tools/torch_port_conformer_parity.py --write): the encoder memory
# projected on a seeded unit vector within CONFORMER_MEMORY_ATOL,
# teacher-forced log-probs within CONFORMER_LOGP_ATOL, and at most
# CONFORMER_ID_LIMIT of the 16 utterances' beam-5 1-best ids over 24 forced
# steps differing
CONFORMERS = ("conformer_baseline", "conformer_streaming")
CONFORMER_FIXTURE = os.path.join(REPO, "egs", "synth_bench", "trained", "conformer_seeded.jax.json")
CONFORMER_INPUTS = dict(weights_seed=0, inputs_seed=5, probe_seed=9, utts=16, frames=500,
                        min_frames=300, min_units=8, max_units=24, mel=80, steps=24, beam=5)
CONFORMER_MEMORY_ATOL = 2e-4
CONFORMER_LOGP_ATOL = 3e-3
CONFORMER_ID_LIMIT = 2
# phase 10: conformer_streaming streamed, held to the JAX package's CPU
# numbers of the same seeded weights and utterances
# (tools/torch_port_stream_parity.py --write): the streamed memory
# projection within STREAM_MEMORY_ATOL (9a's limit) with equal frame
# counts, and within STREAM_OFFLINE_ATOL of the port's own offline
# chunk-masked encode of each utterance at its length; at most
# STREAM_CTC_ID_LIMIT of the 16 greedy CTC id sequences differing
STREAM_FIXTURE = os.path.join(REPO, "egs", "synth_bench", "trained",
                              "conformer_streaming.jax_stream.json")
STREAM_NAME = "conformer_streaming"
STREAM_CHUNK_FRAMES = 64  # raw frames a feed: chunk 16 x the frontend's hop 4
STREAM_CTC_SEED = 3       # the ctc head's seeded weights
STREAM_MEMORY_ATOL = 2e-4
STREAM_OFFLINE_ATOL = 1e-4
STREAM_CTC_ID_LIMIT = 1
# 10a's multi-stream server decodes each stream's FINAL only, 4 forced steps
STREAM_SEARCH = dict(beam_width=5, max_len=4, partial_every=10 ** 6, eos_id=-1)
LONG_FORM = dict(seed=6, utts=2, frames=3000, min_frames=2500, window=1200, context=200,
                 steps=24, beam=5)
# 10d: the anchor's 500 test utterances through the dynamic batcher
BATCHER = dict(max_batch=8, buckets=(200, 400, 800, 1600), timeout_ms=30.0)
# 10e: PCM clients over TCP; 10f: streaming throughput at full width
PCM = dict(streams=4, clients=8, frame_ms=100, timeout_s=300.0)
STREAM_LOAD = dict(slots=32, seconds=20.0, seed=12, beam=5, max_len=32, partial_every=1)
# phase 11: the committed transducer configs (d256, 12 blocks, a 1-layer d256
# LSTM predictor, d_joint 256, V=4233, 40 mel) with seeded weights, held to
# the JAX package's CPU numbers (tools/torch_port_transducer_parity.py
# --write). Random joints put the blank's logit among 4,233 others of about
# the same size, so it is almost never the argmax, and their log-probs all
# sit near -log V, so the beam's best hypothesis is the empty one. The seeded
# tree (both packages) scales the joint's output kernel by ``joint_scale``,
# so that the argmax label costs far less than log V and the beam's 1-best
# holds labels, then raises the blank bias by ``blank_bias`` to make blank
# the argmax at about a third of the JAX greedy run's lattice steps. The
# greedy caps (``max_symbols`` >= frames x ``max_per_frame``) never bind.
TRANSDUCERS = ("transducer", "transducer_streaming")
TRANSDUCER_FIXTURE = os.path.join(REPO, "egs", "synth_bench", "trained",
                                  "transducer_seeded.jax.json")
TRANSDUCER_INPUTS = dict(weights_seed=0, inputs_seed=5, probe_seed=9, utts=16, frames=500,
                         min_frames=300, min_units=8, max_units=24, mel=40, joint_scale=10.0,
                         blank_bias=10.5, max_symbols=1024, max_per_frame=8, beam=4,
                         expansions=2, beam_max_symbols=256, lm_weight=0.3, rnn_lm_seed=13,
                         transformer_lm_seed=11)
# LMs fused in 11b: the LSTM LM of egs/aishell/conf/rnnlm.yaml and phase 4's
# transformer LM (the flagship LM's widths, depth cut to 2)
TRANSDUCER_LMS = {"rnn_lm": LSTM_LM_CFG, "transformer_lm": ANCHOR_LM_CFG}
TRANSDUCER_MEMORY_ATOL = 2e-4
TRANSDUCER_LOGP_ATOL = 3e-3
TRANSDUCER_GREEDY_LIMIT = 1    # of 16 greedy id sequences off JAX's (11a, 11c)
TRANSDUCER_BEAM_LIMIT = 2      # of 16 beam 1-best (and n-best) id lists off JAX's (11b)
TRANSDUCER_SCORE_RTOL = 1e-4   # n-best scores of hypotheses with the same ids
# 11b compares labelled hypotheses: at least 12 of 16 beam 1-bests hold a
# label and one holds two or more (a second label is scored by the LM state
# stepped at the hypothesis's own position 1)
TRANSDUCER_BEAM_LABELLED = 12
TRANSDUCER_BEAM_LONGEST = 2
# 11e: greedy and beam over a batch of 64 x 500 frames, 32 slots x 20 s streamed
TRANSDUCER_LOAD = dict(batch=64, frames=500, seed=14, slots=32, seconds=20.0)
# kernel 1's rows in a transducer greedy step on phase 11's paths (phase 1)
TRANSDUCER_ROWS = (1, 4, 8, 16, 32, 64)
# phase 12: conf/anchor.json cut to 2 epochs of its 80; 312 full batches of
# 64 an epoch (20,000 utterances, drop_last); the resident corpus is
# 20,000 x 1152 frames x 40 float16
ANCHOR_CONF = os.path.join(CONF_DIR, "anchor.json")
RECIPE = dict(epochs=2, updates=624, log_interval=50, seed=1234,
              resident_bytes=20000 * 1152 * 40 * 2)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5, queued: bool = False) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events).
    ``queued``: the calls wait behind a spin of the card (``torch.cuda._sleep``,
    ~60 ms at 1.7 GHz) while the host queues them, so that the card runs them
    back to back even where a call's host work outlasts its device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def topk_ops_ms(flops: float, dtype: torch.dtype) -> float:
    """Least time for the products of the top-k kernels: bf16 at the bf16
    tensor-core rate; float32 at float32 accuracy as three TF32 passes
    (3xTF32: hi·hi + hi·lo + lo·hi) at the TF32 rate, which is faster than
    one pass at the 67 TFLOP/s FMA rate."""
    if dtype == torch.float32:
        return 3.0 * flops / PEAK_TF32 * 1e3
    return flops / PEAK_FLOPS[dtype] * 1e3


def topk_bound_ms(n: int, d: int, v: int, k: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one projection→log-softmax→top-k: the larger of its
    operations over the rate of ``topk_ops_ms`` and its bytes (inputs read
    once, outputs written once) over the memory rate."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n * d + v * d) * esize + v * 4 + n * k * 8 + n * 4
    t_ops, t_bytes = topk_ops_ms(2.0 * n * d * v, dtype), nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def topk2_bound_ms(n: int, d1: int, d2: int, v: int, k: int,
                   dtype: torch.dtype) -> tuple[float, str]:
    """The same for the two-head form: two projections, two biases, one
    list of k values and ids per row."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (n + v) * (d1 + d2) * esize + 8 * v + 8 * n * k
    t_ops, t_bytes = topk_ops_ms(2.0 * n * v * (d1 + d2), dtype), nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def beam_attention_bound_ms(entry: str, b: int, k: int, h: int, dh: int, n_pos: int,
                            dtype: torch.dtype, distinct_rows: int = 0) -> tuple[float, str, int]:
    """Least time for one call of kernel 4 (the beam step's attention): its
    bytes at the memory rate (K beams do 2K operations an element of keys
    and values read, far under the ~295 a byte at which the tensor cores
    would bind). Cross: each utterance's keys and values [H, T, Dh] read
    once, q and the mask read, the context written. Self: each distinct
    (row, position) below
    ``index`` that some lineage reads, read once (``distinct_rows``: a row
    shared by several lineages counts once), the step's keys and values read
    and written into the caches, q and the context, the lineage map. Returns
    (ms, "bytes", bytes)."""
    es = torch.tensor([], dtype=dtype).element_size()
    if entry == "cross":
        nbytes = 2 * b * h * n_pos * dh * es + 2 * b * k * h * dh * es + b * n_pos
    else:
        nbytes = (2 * distinct_rows * h * dh * es + 6 * b * k * h * dh * es
                  + b * k * n_pos * 8)
    return nbytes / PEAK_BYTES * 1e3, "bytes", nbytes


def fbank_bound_ms(frames: int, mel: int, mel_nnz: int, window: int = 400,
                   n_fft: int = 512) -> tuple[float, str]:
    """Least time for the fbank spectrum stage as the function needs it: a
    real FFT of ``n_fft`` points (2.5·n·log2 n flops), the power (3 a
    frequency) and the mel step's ``mel_nnz`` nonzero weights (2 each) at
    the float32 rate, against the frames, the mel matrix, the twiddle table,
    the mel ranges and the output read or written once."""
    freqs = n_fft // 2 + 1
    flops = frames * (2.5 * n_fft * np.log2(n_fft) + 3 * freqs + 2.0 * mel_nnz)
    nbytes = 4.0 * (frames * window + freqs * mel + 2 * n_fft + 3 * mel + frames * mel)
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fbank_dense_ops_ms(frames: int, mel: int, window: int = 400, freqs: int = 257) -> float:
    """The operations of the TPU kernel's dense formulation (two DFT
    products against the cos/sin bases, power, dense mel product) at the
    float32 rate: the bound of the first, dense kernel, printed beside the
    function's."""
    flops = frames * (2.0 * 2 * window * freqs + 3 * freqs + 2.0 * freqs * mel)
    return flops / PEAK_FLOPS[torch.float32] * 1e3


def cuda_ms_cold(fn, inputs, iters: int = 48, warmup: int = 4) -> float:
    """Mean time per call of ``fn(x)`` between CUDA events, with ``x`` taken
    in turn from ``inputs``, separate buffers whose sum exceeds the 50 MB L2
    cache, so that each call finds its input in device memory and not in
    the cache. A call whose device work is shorter than its host work (a
    few tens of microseconds of Python and launches) measures the host."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_cold(fn, inputs, iters: int = 48, warmup: int = 4) -> float:
    """Device time per call of ``fn(x)``, ``x`` in turn from ``inputs`` as in
    ``cuda_ms_cold``: the summed durations of the device kernels and copies
    the calls ran, from ``torch.profiler``, so that host time between
    launches does not count. Raises if the profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return us / 1e3 / iters


def rate_note(flops: float, ms: float, bound: float) -> str:
    """The achieved product rate and the share of the bound, for a log line."""
    return f"{flops / ms * 1e-9:.1f} TFLOP/s achieved, {100.0 * bound / ms:.1f}% of the bound"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 0
def phase_build():
    from opentransformer_tpu_torch.ops import cuda_build

    sources = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith(".cu"))
    t0 = time.time()
    cuda_build.build_all(sources)
    log(f"phase0 built {sources} in {time.time() - t0:.1f} s")
    spills = []
    for name in sources:
        for line in cuda_build.build_log(name).splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"phase0 {name}: {line.strip()}")
            elif "spill stores" in line:
                log(f"phase0 {name}:   {line.strip()}")
                if name in NO_SPILL_SOURCES and any(int(x) for x in re.findall(r"\d+", line)):
                    spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError(f"the top-k kernels must keep to registers (no stack frame, "
                             f"no spill): {spills}")


# ---------------------------------------------------------------- phase 1
def _inputs(n, d, v, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=g)
    w = torch.randn(v, d, generator=g) * 0.3
    b = torch.randn(v, generator=g) * 0.1
    return h.cuda().to(dtype), w.cuda().to(dtype), b.cuda()


# Whisper large-v3's beam step: 128 windows x beam 5 rows, D 1,280, its tied
# head of 51,866 rows with no bias (the wrapper reads zeros), k 5, bf16
WHISPER_HEAD = (640, 1280, 51866, 5)


def _whisper_head_inputs(seed):
    """(h, W, None) at ``WHISPER_HEAD``, drawn on the card: weights of the
    model's scale (1/sqrt(D)), so logits of about unit spread."""
    n, d, v, _ = WHISPER_HEAD
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(v, d, generator=gen, device="cuda") / d ** 0.5).to(torch.bfloat16)
    return h, w, None


def untied_slots(wide: torch.Tensor, k: int, tie: float) -> torch.Tensor:
    """bool[N, k]: the slots of a plain top-k whose ids a kernel must
    reproduce, given the plain top-(k+1) values ``wide`` (top-k when k = V):
    those whose value stands more than ``tie`` apart from both neighbours."""
    gap = wide[:, :-1] - wide[:, 1:]
    sep = torch.ones((wide.shape[0], k), dtype=torch.bool, device=wide.device)
    sep[:, 1:] &= gap[:, : k - 1] > tie
    if wide.shape[1] > k:  # the k-th slot must also stand apart from the (k+1)-th value
        sep &= gap[:, :k] > tie
    return sep


def check_topk(h, w, b, k, label):
    """Kernel vs plain on the same card tensors. Ids must agree wherever the
    plain values are not tied within ``tie``; values and lse within
    ``atol`` = 1e-4, for float32 and bf16 inputs alike: both paths see the
    same (possibly bf16) h and W and accumulate in float32; bf16 products
    are exact in float32, float32 products go through 3xTF32 in the kernel
    (~2^-22 of each product), and the summation order differs.
    Every returned id must also carry its returned value in the full
    log-softmax. Returns the largest value error."""
    from opentransformer_tpu_torch.ops.project_topk import (
        project_logp_topk,
        project_logp_topk_plain,
    )

    vals, ids, lse = project_logp_topk(h, w, b, k, with_lse=True)
    torch.cuda.synchronize()
    logits = h.float() @ w.float().T
    if b is not None:
        logits += b.float()
    scale = logits.abs().max().item()
    atol = 1e-4
    tie = 1e-5 * max(scale, 1.0)
    ref_vals, ref_ids, ref_lse = project_logp_topk_plain(h, w, b, k, with_lse=True)
    wide, _ = project_logp_topk_plain(h, w, b, min(k + 1, w.shape[0]))
    sep = untied_slots(wide, k, tie)
    bad_ids = int(((ids != ref_ids) & sep).sum())
    err = (vals - ref_vals).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    picked = torch.log_softmax(logits, -1).gather(1, ids.long())
    pick_err = (picked - vals).abs().max().item()
    ok = bad_ids == 0 and err <= atol and lse_err <= atol and pick_err <= atol
    log(f"phase1 {label}: max|dvals|={err:.3e} max|dlse|={lse_err:.3e} "
        f"max|dpicked|={pick_err:.3e} atol={atol:.1e} untied-id mismatches={bad_ids} "
        f"({int(sep.sum())} untied slots) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"project_logp_topk kernel disagrees with its plain version: {label}")
    return err


# the case of kernel 1 at Whisper large-v3's widths that the JSON line carries
WHISPER_HEAD_RECORD = "whisper bf16"


def phase_kernel():
    from opentransformer_tpu_torch.ops.project_topk import (
        project_logp_topk,
        project_logp_topk_plain,
    )

    cases = [
        ("flagship beam step N=2560 D=256 V=4233 k=5 bf16", 2560, 256, 4233, 5, torch.bfloat16),
        ("flagship beam step N=2560 D=256 V=4233 k=5 f32", 2560, 256, 4233, 5, torch.float32),
        ("conformer beam step N=2560 D=384 V=4233 k=5 bf16", 2560, 384, 4233, 5, torch.bfloat16),
        ("conformer beam step N=2560 D=384 V=4233 k=5 f32", 2560, 384, 4233, 5, torch.float32),
        ("anchor beam step N=500 D=128 V=4233 k=5 f32", 500, 128, 4233, 5, torch.float32),
        ("greedy k=1 N=512 D=256 V=4233 bf16", 512, 256, 4233, 1, torch.bfloat16),
        (f"streamed CTC tick k=1 N={STREAM_ROWS} D=384 V=4233 bf16", STREAM_ROWS, 384, 4233, 1,
         torch.bfloat16),
        (f"streamed CTC tick k=1 N={STREAM_ROWS} D=384 V=4233 f32", STREAM_ROWS, 384, 4233, 1,
         torch.float32),
        ("CTC sparse beam k=32+lse N=4096 D=256 V=4233 f32", 4096, 256, 4233, 32, torch.float32),
        (f"anchor CTC greedy k=1 N={CTC_ROWS} D=128 V=4233 f32", CTC_ROWS, 128, 4233, 1,
         torch.float32),
        (f"anchor CTC sparse beam k=32+lse N={CTC_ROWS} D=128 V=4233 f32", CTC_ROWS, 128, 4233,
         32, torch.float32),
        ("ragged N=7 D=256 V=4233 k=5 bf16", 7, 256, 4233, 5, torch.bfloat16),
        ("widest k=128 N=33 D=40 V=131 f32", 33, 40, 131, 128, torch.float32),
        # tile edges: 64-row blocks, 128-byte depth slices, 128-column tiles
        ("row edge N=65 D=256 V=4233 k=5 bf16", 65, 256, 4233, 5, torch.bfloat16),
        ("row edge N=2561 D=256 V=4233 k=5 f32", 2561, 256, 4233, 5, torch.float32),
        ("depth edge D=40 N=500 V=4233 k=5 bf16", 500, 40, 4233, 5, torch.bfloat16),
        ("depth edge D=56 N=130 V=4233 k=5 f32", 130, 56, 4233, 5, torch.float32),
        ("vocab edge V=131 N=65 D=256 k=5 bf16", 65, 256, 131, 5, torch.bfloat16),
        ("rows off 16 bytes D=50 N=70 V=300 k=8 bf16", 70, 50, 300, 8, torch.bfloat16),
        # phase 10's serving shapes: streamed CTC ticks (16 and 4 slots), the
        # beams of 10a (16 streams), 10c (2 utterances), 10d (8 rows) and 10f
        ("10b streamed CTC tick k=1 N=256 D=384 V=4233 f32", 256, 384, 4233, 1, torch.float32),
        ("10e PCM CTC tick k=1 N=64 D=384 V=4233 f32", 64, 384, 4233, 1, torch.float32),
        ("10a multi-stream FINAL beam N=80 D=384 V=4233 k=5 f32", 80, 384, 4233, 5,
         torch.float32),
        ("10c long-form beam N=10 D=384 V=4233 k=5 f32", 10, 384, 4233, 5, torch.float32),
        ("10d batcher beam N=40 D=128 V=4233 k=5 f32", 40, 128, 4233, 5, torch.float32),
        ("10f multi-stream beam N=160 D=384 V=4233 k=5 bf16", 160, 384, 4233, 5, torch.bfloat16),
        # phase 11's transducer greedy lattice steps: one online stream (N=1),
        # the PCM server's 4 slots, the eval CLI's batches of 8, 16 utterances or
        # slots, 32 slots, 64 rows
        *((f"11 transducer greedy k=1 N={n} D=256 V=4233 {label}", n, 256, 4233, 1, dtype)
          for n in TRANSDUCER_ROWS for label, dtype in (("f32", torch.float32),
                                                        ("bf16", torch.bfloat16))),
    ]
    max_err = 0.0
    for i, (label, n, d, v, k, dtype) in enumerate(cases):
        max_err = max(max_err, check_topk(*_inputs(n, d, v, dtype, seed=i), k, label))
    n, d, v, k = WHISPER_HEAD
    max_err = max(max_err, check_topk(*_whisper_head_inputs(21), k,
                                      f"whisper beam step N={n} D={d} V={v} k={k} bf16 no bias"))
    # hand-made ties: identical rows; every logit value appears 40 times
    g = torch.Generator().manual_seed(3)
    h = torch.linspace(-1.0, 1.0, 16).repeat(4, 1).cuda()
    w = torch.randn(7, 16, generator=g).repeat(40, 1).cuda()
    b = torch.zeros(280, device="cuda")
    vals, ids = project_logp_topk(h, w, b, 6)
    ref_vals, ref_ids = project_logp_topk_plain(h, w, b, 6)
    if not torch.equal(ids, ref_ids):
        raise AssertionError(f"tie rule broken: kernel {ids.tolist()} plain {ref_ids.tolist()}")
    log(f"phase1 ties: ids identical to the plain version {ids[0].tolist()} ok")

    card = card_line()
    timings = {}
    for label, n, d, k, dtype in (("flagship bf16", 2560, 256, 5, torch.bfloat16),
                                  ("flagship f32", 2560, 256, 5, torch.float32),
                                  ("conformer bf16", 2560, 384, 5, torch.bfloat16),
                                  ("conformer f32", 2560, 384, 5, torch.float32),
                                  ("anchor f32", 500, 128, 5, torch.float32)):
        h, w, b = _inputs(n, d, 4233, dtype, seed=99)
        kern = cuda_ms(lambda: project_logp_topk(h, w, b, k))
        plain = cuda_ms(lambda: project_logp_topk_plain(h, w, b, k))
        unfused = cuda_ms(lambda: torch.topk(torch.log_softmax(
            (h @ w.T).float() + b, dim=-1), k))
        bound, bound_by = topk_bound_ms(n, d, 4233, k, dtype)
        timings[label] = (kern, plain, bound, bound_by)
        log(f"phase1 time {label} N={n} D={d} V=4233 k={k}: kernel {kern:.4f} ms, "
            f"plain version {plain:.4f} ms, unfused matmul+log_softmax+topk "
            f"(a composition of three calls, not a library call) {unfused:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by}); {rate_note(2.0 * n * d * 4233, kern, bound)}"
            f"{'' if kern < unfused else ', SLOWER than the composition'} [{card}]")
    n, d, v, k = WHISPER_HEAD
    h, w, b = _whisper_head_inputs(22)
    kern = cuda_ms(lambda: project_logp_topk(h, w, b, k))
    plain = cuda_ms(lambda: project_logp_topk_plain(h, w, b, k))
    unfused = cuda_ms(lambda: torch.topk(torch.log_softmax((h @ w.T).float(), dim=-1), k))
    bound, bound_by = topk_bound_ms(n, d, v, k, torch.bfloat16)
    timings[WHISPER_HEAD_RECORD] = (kern, plain, bound, bound_by)
    library = {WHISPER_HEAD_RECORD: unfused}
    log(f"phase1 time {WHISPER_HEAD_RECORD} N={n} D={d} V={v} k={k} (no bias): kernel "
        f"{kern:.4f} ms, plain version {plain:.4f} ms, unfused matmul+log_softmax+topk (a "
        f"composition of three calls, not a library call) {unfused:.4f} ms, bound {bound:.4f} ms "
        f"({bound_by}); {rate_note(2.0 * n * d * v, kern, bound)}"
        f"{'' if kern < unfused else ', SLOWER than the composition'} [{card}]")
    # the CTC head's calls: top-1 for greedy and for the streamed tick, top-32
    # with lse for the prefix beam; the transducer's greedy lattice step: top-1
    # of the joint, D = d_joint = 256. At a few rows the calls are short enough
    # that the host's launch work may set the back-to-back time, so the device
    # time (torch.profiler) stands beside it
    for label, n, d, k, dtype in (("anchor CTC greedy f32", CTC_ROWS, 128, 1, torch.float32),
                                  ("anchor CTC sparse beam f32", CTC_ROWS, 128, 32, torch.float32),
                                  ("streamed CTC tick bf16", STREAM_ROWS, 384, 1, torch.bfloat16),
                                  ("streamed CTC tick f32", STREAM_ROWS, 384, 1, torch.float32),
                                  *((f"transducer greedy {tag}", n, 256, 1, dtype)
                                    for n in TRANSDUCER_ROWS
                                    for tag, dtype in (("bf16", torch.bfloat16),
                                                       ("f32", torch.float32)))):
        h, w, b = _inputs(n, d, 4233, dtype, seed=98)
        lse = k > 1
        if lse:
            def composition():
                logits = h @ w.T + b
                return (torch.topk(torch.log_softmax(logits, dim=-1), k),
                        torch.logsumexp(logits, dim=-1))
            what = "matmul + log_softmax + topk, and logsumexp"
        else:
            def composition():
                return torch.max(torch.log_softmax((h @ w.T).float() + b, dim=-1), dim=-1)
            what = "matmul + log_softmax + max"
        iters = 20 if n == CTC_ROWS else 50
        kern = cuda_ms(lambda: project_logp_topk(h, w, b, k, with_lse=lse), iters=iters)
        plain = cuda_ms(lambda: project_logp_topk_plain(h, w, b, k, with_lse=lse), iters=iters)
        unfused = cuda_ms(composition, iters=iters)
        dev_kern = device_ms_cold(lambda _x: project_logp_topk(h, w, b, k, with_lse=lse), [None],
                                  iters=iters)
        dev_unfused = device_ms_cold(lambda _x: composition(), [None], iters=iters)
        bound, bound_by = topk_bound_ms(n, d, 4233, k, dtype)
        timings[f"{label} N={n}"] = (kern, plain, bound, bound_by)
        log(f"phase1 time {label} N={n} D={d} V=4233 k={k}{' + lse' if lse else ''}: "
            f"kernel {kern:.4f} ms, plain version {plain:.4f} ms, unfused {what} (a composition "
            f"of calls, not a library call) {unfused:.4f} ms, bound {bound:.4f} ms ({bound_by}); "
            f"{rate_note(2.0 * n * d * 4233, kern, bound)}"
            f"{'' if kern < unfused else f', SLOWER than the composition by {kern / unfused:.2f}x'}"
            f"; device time (torch.profiler, warm L2) kernel {dev_kern:.4f} ms, composition "
            f"{dev_unfused:.4f} ms [{card}]")
    return max_err, timings, library


# ---------------------------------------------------------------- phase 1b
def _inputs2(n, d1, d2, v, dtype, seed):
    return _inputs(n, d1, v, dtype, seed) + _inputs(n, d2, v, dtype, seed + 1000)


def check_topk2(args, lam, k, label):
    """Two-head kernel vs plain on the same card tensors, as ``check_topk``:
    ids agree wherever the plain values are not tied within ``tie``, values
    within ``atol`` = 1e-4 (both paths accumulate the same inputs in
    float32; they differ in summation order, in the kernel's 3xTF32
    products for float32 inputs and in where the two normalisers are
    subtracted), and every returned id carries its returned
    value in the materialised ``lp1 + lam * lp2``. Returns the largest
    value error."""
    from opentransformer_tpu_torch.ops.project_topk import (
        project2_logp_topk,
        project2_logp_topk_plain,
    )

    h1, w1, b1, h2, w2, b2 = args
    vals, ids = project2_logp_topk(*args, lam, k)
    torch.cuda.synchronize()
    l1 = h1.float() @ w1.float().T + b1.float()
    l2 = h2.float() @ w2.float().T + b2.float()
    atol = 1e-4
    tie = 1e-5 * max(l1.abs().max().item(), abs(lam) * l2.abs().max().item(), 1.0)
    ref_vals, ref_ids = project2_logp_topk_plain(*args, lam, k)
    wide, _ = project2_logp_topk_plain(*args, lam, min(k + 1, w1.shape[0]))
    sep = untied_slots(wide, k, tie)
    bad_ids = int(((ids != ref_ids) & sep).sum())
    err = (vals - ref_vals).abs().max().item()
    combined = torch.log_softmax(l1, -1) + lam * torch.log_softmax(l2, -1)
    pick_err = (combined.gather(1, ids.long()) - vals).abs().max().item()
    ok = bad_ids == 0 and err <= atol and pick_err <= atol
    log(f"phase1b {label} lam={lam}: max|dvals|={err:.3e} max|dpicked|={pick_err:.3e} "
        f"atol={atol:.1e} untied-id mismatches={bad_ids} ({int(sep.sum())} untied slots) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"project2_logp_topk kernel disagrees with its plain version: {label}")
    return err


def phase_kernel2():
    from opentransformer_tpu_torch.ops.project_topk import (
        project2_logp_topk,
        project2_logp_topk_plain,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("flagship beam step N=2560 D1=D2=256 V=4233 k=5 bf16", 2560, 256, 256, 4233, 5, bf16, 0.1),
        ("flagship beam step N=2560 D1=D2=256 V=4233 k=5 f32", 2560, 256, 256, 4233, 5, f32, 0.1),
        ("flagship beam step f32", 2560, 256, 256, 4233, 5, f32, 0.0),
        ("flagship beam step f32", 2560, 256, 256, 4233, 5, f32, -0.3),
        ("LSTM-LM widths N=2560 D1=256 D2=1024 V=4233 k=5 bf16", 2560, 256, 1024, 4233, 5, bf16, 0.1),
        ("anchor beam step N=500 D1=128 D2=256 V=4233 k=5 f32", 500, 128, 256, 4233, 5, f32, 0.1),
        ("anchor beam step f32", 500, 128, 256, 4233, 5, f32, 0.0),
        ("ragged N=7 D1=D2=256 V=4233 k=5 bf16", 7, 256, 256, 4233, 5, bf16, -0.3),
        ("widest k=128 N=33 D1=40 D2=56 V=131 f32", 33, 40, 56, 131, 128, f32, 0.1),
        # tile edges: 64-row blocks, 128-byte depth slices, 128-column tiles
        ("row edge N=65 D1=D2=256 V=4233 k=5 bf16", 65, 256, 256, 4233, 5, bf16, 0.1),
        ("row edge N=2561 D1=D2=256 V=4233 k=5 f32", 2561, 256, 256, 4233, 5, f32, -0.3),
        ("depth edges D1=40 D2=56 N=500 V=4233 k=5 bf16", 500, 40, 56, 4233, 5, bf16, 0.1),
        ("wide LM head D2=1024 N=130 V=4233 k=5 f32", 130, 256, 1024, 4233, 5, f32, 0.1),
        ("vocab edge V=131 N=65 D1=256 D2=1024 k=5 bf16", 65, 256, 1024, 131, 5, bf16, 0.0),
        ("rows off 16 bytes D1=50 D2=24 N=70 V=300 k=8 bf16", 70, 50, 24, 300, 8, bf16, 0.1),
        # phase 10d's batcher with the LM: 8 rows x beam 5
        ("10d batcher + LM N=40 D1=128 D2=256 V=4233 k=5 f32", 40, 128, 256, 4233, 5, f32, 0.0),
        ("10d batcher + LM N=40 D1=128 D2=256 V=4233 k=5 f32", 40, 128, 256, 4233, 5, f32, 0.1),
    ]
    max_err = 0.0
    for i, (label, n, d1, d2, v, k, dtype, lam) in enumerate(cases):
        args = _inputs2(n, d1, d2, v, dtype, seed=100 + i)
        max_err = max(max_err, check_topk2(args, lam, k, label))
    # hand-made ties: identical rows; every combined value appears 40 times
    g = torch.Generator().manual_seed(3)
    h1 = torch.linspace(-1.0, 1.0, 16).repeat(4, 1).cuda()
    h2 = torch.linspace(1.0, -0.5, 24).repeat(4, 1).cuda()
    w1 = torch.randn(7, 16, generator=g).repeat(40, 1).cuda()
    w2 = torch.randn(7, 24, generator=g).repeat(40, 1).cuda()
    b = torch.zeros(280, device="cuda")
    for lam in (0.1, 0.0, -0.3):
        vals, ids = project2_logp_topk(h1, w1, b, h2, w2, b, lam, 6)
        ref_vals, ref_ids = project2_logp_topk_plain(h1, w1, b, h2, w2, b, lam, 6)
        if not torch.equal(ids, ref_ids):
            raise AssertionError(f"tie rule broken at lam={lam}: kernel {ids.tolist()} "
                                 f"plain {ref_ids.tolist()}")
        log(f"phase1b ties lam={lam}: ids identical to the plain version {ids[0].tolist()} ok")

    card = card_line()
    timings = {}
    for label, n, d1, d2, k, dtype in (("flagship bf16", 2560, 256, 256, 5, bf16),
                                       ("flagship f32", 2560, 256, 256, 5, f32),
                                       ("anchor f32", 500, 128, 256, 5, f32),
                                       ("LSTM-LM widths bf16", 2560, 256, 1024, 5, bf16)):
        h1, w1, b1, h2, w2, b2 = args = _inputs2(n, d1, d2, 4233, dtype, seed=199)
        kern = cuda_ms(lambda: project2_logp_topk(*args, 0.1, k))
        plain = cuda_ms(lambda: project2_logp_topk_plain(*args, 0.1, k))
        unfused = cuda_ms(lambda: torch.topk(
            torch.log_softmax((h1 @ w1.T).float() + b1, dim=-1)
            + 0.1 * torch.log_softmax((h2 @ w2.T).float() + b2, dim=-1), k))
        bound, bound_by = topk2_bound_ms(n, d1, d2, 4233, k, dtype)
        timings[label] = (kern, plain, bound, bound_by)
        log(f"phase1b time {label} N={n} D1={d1} D2={d2} V=4233 k={k}: kernel {kern:.4f} ms, "
            f"plain version {plain:.4f} ms, unfused 2 matmuls + 2 log_softmax + add + topk "
            f"(a composition of calls, not a library call) {unfused:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by}); "
            f"{rate_note(2.0 * n * (d1 + d2) * 4233, kern, bound)}"
            f"{'' if kern < unfused else ', SLOWER than the composition'} [{card}]")
    return max_err, timings


# ---------------------------------------------------------------- phase 1c
def beam_attention_case(entry: str, b: int, k: int, h: int, dh: int, n_pos: int,
                        dtype: torch.dtype, seed: int, device="cuda", empty_row: bool = False):
    """Inputs of one entry of kernel 4 in the layouts the decoder hands
    over: q (and the step's key and value) head splits of one projection's
    output, the cross keys and values the halves of kv_proj's, a padded key
    mask (every third utterance a third shorter; ``empty_row``: utterance 1
    all padding), and lineages that merge going back as a beam search leaves
    them (every slot from slot 0 at the first step, then a random parent a
    step, the identity at ``index``). Cross: (q, k, v, mask) over ``n_pos``
    frames; self: (q, k_t, v_t, cache_k, cache_v, index, src) at index
    ``n_pos`` - 1."""
    from opentransformer_tpu_torch.models.modules import split_heads

    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g).to(device, dtype)

    d = h * dh
    if entry == "cross":
        q = split_heads(normal(b * k, 1, d), h)[:, :, 0]
        key, value = (split_heads(a, h) for a in normal(b, n_pos, 2 * d).chunk(2, dim=-1))
        lens = torch.full((b,), n_pos)
        lens[::3] = max(1, 2 * n_pos // 3)
        if empty_row:
            lens[1 % b] = 0
        mask = (torch.arange(n_pos)[None] < lens[:, None]).to(device)
        return q, key, value, mask
    q, k_t, v_t = (split_heads(a, h)[:, :, 0] for a in normal(b * k, 1, 3 * d).chunk(3, dim=-1))
    u_max = n_pos + 3
    cache_k, cache_v = normal(b * k, h, u_max, dh), normal(b * k, h, u_max, dh)
    src = torch.arange(k)[None, :, None].repeat(b, 1, u_max)
    for p in range(n_pos - 1):
        parent = (torch.randint(0, k, (b, k), generator=g) if p
                  else torch.zeros((b, k), dtype=torch.long))
        src = torch.gather(src, 1, parent[:, :, None].expand(b, k, u_max))
        src[:, :, p + 1] = torch.arange(k)
    return q, k_t, v_t, cache_k, cache_v, n_pos - 1, src.to(device)


def distinct_rows(src: torch.Tensor, index: int) -> int:
    """The (utterance, row, position)s below ``index`` that some lineage of
    ``src`` [B, K, U] reads."""
    b, k, _ = src.shape
    seen = torch.zeros((b, k, index), dtype=torch.bool, device=src.device)
    seen.scatter_(1, src[:, :, :index], True)
    return int(seen.sum())


def beam_context_gap(got, ref, weighted_abs) -> tuple[float, float]:
    """Kernel 4's context against the plain version's, each rounded once to
    the output type from float32 sums taken in another order: (the largest
    difference over its room, the share of elements equal). bf16: the room
    is one bf16 rounding step at the element's magnitude plus 2⁻⁷ of
    ``weighted_abs`` (Σ w·|v|, the plain version over |v|): a softmax weight
    w that the two paths compute a few float32 ulps apart can round to
    neighbouring bf16 values, one bf16 step apart (≤ 2⁻⁷·w); and at least
    99% of the elements must be equal. float32: 1e-5 of the (beam, head)
    row's largest magnitude. Within the limit where the first number is at
    most 1 (and, in bf16, the second at least 0.99)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{got.dtype} {tuple(got.shape)} against {ref.dtype} "
                             f"{tuple(ref.shape)}")
    bf16 = ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    if bf16:
        mag = torch.maximum(got.abs(), ref.abs())
        step = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), 0.0)
        room = step + weighted_abs.float() * 2.0 ** -7
    else:
        room = 1e-5 * ref.abs().amax(-1, keepdim=True)
    over = torch.where(diff == 0, 0.0, diff / room)
    return float(over.max()), float((diff == 0).float().mean())


def beam_cross_f64(q, k, v, mask, rows: int = 8) -> torch.Tensor:
    """The cross attention of q [B·K, H, Dh] over k, v [B, H, T, Dh] in
    float64 with no rounding between (``NEG_INF`` where the mask is False), a
    few utterances at a time."""
    from opentransformer_tpu_torch.ops.masks import apply_attn_mask

    b, h, _, dh = k.shape
    beams = q.shape[0] // b
    out = []
    for i in range(0, b, rows):
        qb = q[i * beams:(i + rows) * beams].double().reshape(-1, beams, h, dh)
        s = torch.einsum("bkhd,bhtd->bkht", qb, k[i:i + rows].double()) / math.sqrt(dh)
        if mask is not None:
            s = apply_attn_mask(s, mask[i:i + rows, None, None, :])
        out.append(torch.einsum("bkht,bhtd->bkhd", torch.softmax(s, dim=-1),
                                v[i:i + rows].double()))
    return torch.cat(out).reshape(q.shape)


def beam_cross_errors(got, q, k, v, mask) -> tuple[float, float]:
    """(max |Δ| of the one-pass cross entry's context from the float64
    attention, the same of the plain version's). Both round the weights to
    bf16 once, at other points (the kernel the unnormalised weights, then a
    division by the float32 sum; the plain version the normalised ones), and
    the context once, so neither is the other's reference: the kernel is held
    to twice the plain version's own distance from the exact value (kernel
    5's rule)."""
    from opentransformer_tpu_torch.ops.beam_attention import cross_attention_plain

    exact = beam_cross_f64(q, k, v, mask)
    plain = cross_attention_plain(q, k, v, mask, torch.bfloat16)
    return (float((got.double() - exact).abs().max()),
            float((plain.double() - exact).abs().max()))


def beam_context_within(got, ref, weighted_abs) -> bool:
    worst, equal = beam_context_gap(got, ref, weighted_abs)
    return worst <= 1.0 and (equal >= 0.99 or ref.dtype != torch.bfloat16)


def beam_attention_host_us(calls: int = 2000) -> dict:
    """The host's time a call of each entry of kernel 4 at a size whose
    device work is far shorter (B8 K5 H4 Dh64, 16 positions, bf16): the
    wrapper's checks, its allocation and the launch."""
    from opentransformer_tpu_torch.ops import beam_attention as ba

    q, key, value, mask = beam_attention_case("cross", 8, 5, 4, 64, 16, torch.bfloat16, 1)
    args = beam_attention_case("self", 8, 5, 4, 64, 16, torch.bfloat16, 1)
    out = {}
    for name, fn in (("cross_us", lambda: ba.beam_cross_attention(q, key, value, mask)),
                     ("self_us", lambda: ba.beam_self_attention(*args))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


# entry, B, K, H, Dh, positions (cross T, self u), dtype: the offline decode
# cell's beam step (B = 1,024 utterances, beam 5, d256 over 4 heads, bf16)
# over the shortest and the longest bucket's frames and at the first and the
# 54th step; float32 models at d128 and d384 over 4 heads; the long-form
# cell's Whisper large-v3 step (128 windows, beam 5, 20 heads of 64) over
# 1,500-frame cross caches (48 KB of scores a block: the scratch path) and
# its self caches at the 129th step
BEAM_ATTENTION_CASES = [("cross", 1024, 5, 4, 64, 62, torch.bfloat16),
                        ("cross", 1024, 5, 4, 64, 374, torch.bfloat16),
                        ("self", 1024, 5, 4, 64, 1, torch.bfloat16),
                        ("self", 1024, 5, 4, 64, 54, torch.bfloat16),
                        ("cross", 1024, 5, 4, 32, 374, torch.float32),
                        ("cross", 1024, 5, 4, 96, 374, torch.float32),
                        ("self", 1024, 5, 4, 32, 54, torch.float32),
                        ("self", 1024, 5, 4, 96, 54, torch.float32),
                        ("cross", 128, 5, 20, 64, 1500, torch.bfloat16),
                        ("self", 128, 5, 20, 64, 129, torch.bfloat16)]


# the decode cell's longest bucket timed with its key padding (the bf16
# cross cases above take the one-pass entry, timed without): label, B, K, H,
# Dh, T
BEAM_ATTENTION_PADDED = ("cross B=1024 K=5 H=4 Dh=64 T=374 bf16 key padding", 1024, 5, 4, 64, 374)


# the case whose times kernel 4's entry of the JSON line carries, and the
# long-form cell's cases it carries beside them
BEAM_ATTENTION_RECORD = "cross B=1024 K=5 H=4 Dh=64 T=374 bf16"
BEAM_ATTENTION_WHISPER = ("cross B=128 K=5 H=20 Dh=64 T=1500 bf16",
                          "self B=128 K=5 H=20 Dh=64 u=129 bf16")


def phase_kernel4():
    """Phase 1c. Kernel 4 (``csrc/beam_attention.cu``, both entries) against
    its plain version on the card at ``BEAM_ATTENTION_CASES``, held to
    ``beam_context_gap``'s limit (the self entry's cache writes equal), then
    timed: the kernel, the plain version and, for the cross entry, PyTorch's
    ``scaled_dot_product_attention`` over the same tensors (a yardstick: the
    same function but for where the weights are rounded; the port never
    calls it), each queued back to back over a mask of no padding, beside
    ``beam_attention_bound_ms``; and the wrapper's host time a call. Returns
    (the largest |Δ| of a context, {case: (ms, plain ms, bound ms, bound
    by)}, {case: library ms}, host µs)."""
    from opentransformer_tpu_torch.ops import beam_attention as ba

    card = card_line()
    max_err, timings, library = 0.0, {}, {}
    for entry, b, k, h, dh, n_pos, dtype in BEAM_ATTENTION_CASES:
        label = (f"{entry} B={b} K={k} H={h} Dh={dh} {'T' if entry == 'cross' else 'u'}={n_pos} "
                 f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")
        args = beam_attention_case(entry, b, k, h, dh, n_pos, dtype, seed=b + k + dh + n_pos)
        if entry == "cross":
            q, key, value, mask = args
            ref = ba.cross_attention_plain(*args, dtype)
            weighted_abs = ba.cross_attention_plain(q, key, value.abs(), mask, dtype)
            got = ba.beam_cross_attention(*args, dtype)
            writes_ok = True
        else:
            q, k_t, v_t, cache_k, cache_v, index, src = args
            ref_k, ref_v = cache_k.clone(), cache_v.clone()
            ref = ba.self_attention_plain(q, k_t, v_t, ref_k, ref_v, index, src)
            weighted_abs = ba.self_attention_plain(q, k_t, v_t.abs(), cache_k.clone(),
                                                   cache_v.abs(), index, src)
            got = ba.beam_self_attention(*args)
            writes_ok = torch.equal(cache_k, ref_k) and torch.equal(cache_v, ref_v)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        max_err = max(max_err, err)
        if entry == "cross" and dtype == torch.bfloat16:
            # the one-pass entry: held to the float64 attention
            exact_err, plain_err = beam_cross_errors(got, *args)
            ok = exact_err <= 2.0 * plain_err
            log(f"phase1c {label} (one pass): max|dctx| from float64 {exact_err:.3e}, plain "
                f"{plain_err:.3e} ({exact_err / max(plain_err, 1e-30):.2f}x), from the plain "
                f"version {err:.3e} {'ok' if ok else 'FAIL'}")
        else:
            worst, equal = beam_context_gap(got, ref, weighted_abs)
            ok = beam_context_within(got, ref, weighted_abs) and writes_ok
            writes = "" if entry == "cross" else f", cache writes equal {writes_ok}"
            log(f"phase1c {label}: max|dctx|={err:.3e}, {worst:.3f} of the room, "
                f"{100 * equal:.2f}% of the elements equal{writes} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel 4 disagrees with its reference: {label}")

        if entry == "cross":
            mask = torch.ones_like(mask)
            kern = cuda_ms(lambda: ba.beam_cross_attention(q, key, value, mask), 20, 3, True)
            plain = cuda_ms(lambda: ba.cross_attention_plain(q, key, value, mask, dtype),
                            20, 3, True)
            qb = q.reshape(b, k, h, dh).transpose(1, 2)
            library[label] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qb, key, value), 20, 3, True)
            bound, bound_by, nbytes = beam_attention_bound_ms(entry, b, k, h, dh, n_pos, dtype)
            extra = f", scaled_dot_product_attention {library[label]:.4f} ms"
        else:
            kern = cuda_ms(lambda: ba.beam_self_attention(*args), 20, 3, True)
            plain = cuda_ms(lambda: ba.self_attention_plain(*args), 20, 3, True)
            rows = distinct_rows(src, index)
            bound, bound_by, nbytes = beam_attention_bound_ms(entry, b, k, h, dh, n_pos, dtype,
                                                              rows)
            extra = f" ({rows} distinct (row, position)s of {b * k * index} lineage references)"
        timings[label] = (kern, plain, bound, bound_by)
        kind = "one-pass entry" if entry == "cross" and dtype == torch.bfloat16 else "kernel"
        log(f"phase1c time {label}: {kind} {kern:.4f} ms, plain version {plain:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB){extra}; "
            f"{100 * bound / kern:.1f}% of the bound [{card}]")
    # the one-pass entry queued back to back over the decode cell's key
    # padding: the bound counts the valid frames' keys and values, all that
    # the entry reads
    label, b, k, h, dh, n_pos = BEAM_ATTENTION_PADDED
    q, key, value, mask = beam_attention_case("cross", b, k, h, dh, n_pos, torch.bfloat16,
                                              seed=b + k + dh + n_pos)
    before = ba.beam_cross_attention.one_pass_launches
    kern = cuda_ms(lambda: ba.beam_cross_attention(q, key, value, mask), 20, 3, True)
    if ba.beam_cross_attention.one_pass_launches != before + 23:
        raise AssertionError(f"phase1c {label}: the one-pass entry did not take the calls")
    qb = q.reshape(b, k, h, dh).transpose(1, 2)
    library[label] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, key, value, attn_mask=mask[:, None, None, :]), 20, 3, True)
    valid = int(mask.sum())
    nbytes = 2 * h * valid * dh * 2 + 2 * b * k * h * dh * 2 + b * n_pos
    bound = nbytes / PEAK_BYTES * 1e3
    timings[label] = (kern, None, bound, "bytes")
    log(f"phase1c time {label}: one-pass entry {kern:.4f} ms, bound {bound:.4f} ms (bytes: "
        f"{nbytes / 1e6:.1f} MB, {valid} valid frames of {b * n_pos}); {100 * bound / kern:.1f}% "
        f"of the bound; scaled_dot_product_attention over the same tensors "
        f"{library[label]:.4f} ms [{card}]")
    host = beam_attention_host_us()
    log(f"phase1c host {host['cross_us']:.1f} us a cross call, {host['self_us']:.1f} us a self "
        f"call (B8 K5 H4 Dh64, 16 positions, bf16: the wrapper's checks, allocation and launch)")
    return max_err, timings, library, host


# ---------------------------------------------------------------- phase 1d
def encoder_attention_case(b: int, h: int, t_q: int, t_k: int, dh: int, seed: int,
                           mask: str = "ragged", empty_row: bool = False, device="cuda"):
    """Inputs of kernel 5 in the layouts an encoder hands over: q, k and v
    the head splits of one fused QKV projection's output [B, T, 3·H·Dh]
    (with T_q ≠ T_k, q the first third of a projection of T_q positions and
    k, v the last two of one of T_k), bf16, and a key mask [B, 1, 1, T_k]:
    "full" all True (the long-form cell's), "ragged" every third row a third
    shorter (key padding), "holes" every fifth key masked, "short" every
    row a valid prefix of 1 to 130 keys, or None; ``empty_row`` leaves row 1
    no valid key."""
    from opentransformer_tpu_torch.models.modules import split_heads

    g = torch.Generator().manual_seed(seed)
    d = h * dh

    def qkv(t):
        return [split_heads(a, h) for a in
                torch.randn(b, t, 3 * d, generator=g).to(device, torch.bfloat16).chunk(3, -1)]

    q, k, v = qkv(t_q)
    if t_k != t_q:
        _, k, v = qkv(t_k)
    if mask is None:
        return q, k, v, None
    keep = torch.ones(b, t_k, dtype=torch.bool)
    if mask == "ragged":
        keep[::3, max(1, 2 * t_k // 3):] = False
    elif mask == "holes":
        keep[:, ::5] = False
    elif mask == "short":
        keys = torch.randint(1, min(130, t_k) + 1, (b, 1), generator=g)
        keep = torch.arange(t_k)[None, :] < keys
    if empty_row:
        keep[1 % b] = False
    return q, k, v, keep.to(device)[:, None, None, :]


def attention_f64(q, k, v, mask, rows: int = 4) -> torch.Tensor:
    """The attention of bf16 q, k, v in float64 with no rounding between
    (``NEG_INF`` where the mask is False), a few rows of the batch at a time."""
    from opentransformer_tpu_torch.ops.masks import apply_attn_mask

    out = []
    for i in range(0, q.shape[0], rows):
        m = None if mask is None else mask[i:i + rows] if mask.shape[0] > 1 else mask
        s = torch.matmul(q[i:i + rows].double(), k[i:i + rows].double().transpose(-1, -2))
        s = apply_attn_mask(s / math.sqrt(q.shape[-1]), m)
        out.append(torch.matmul(torch.softmax(s, dim=-1), v[i:i + rows].double()))
    return torch.cat(out)


def encoder_attention_errors(got, q, k, v, mask) -> tuple[float, float]:
    """(max |Δ| of kernel 5's context from the float64 attention, the same of
    the plain composition's). Both round to bf16 twice, the weights and the
    context, at other points (the kernel rounds the unnormalised weights and
    divides by the float32 sum at the end), so the kernel is held to twice
    the composition's own distance from the exact value."""
    from opentransformer_tpu_torch.ops.encoder_attention import attention_plain

    exact = attention_f64(q, k, v, mask)
    plain = torch.cat([attention_plain(q[i:i + 4], k[i:i + 4], v[i:i + 4],
                                       None if mask is None else
                                       mask[i:i + 4] if mask.shape[0] > 1 else mask)
                       for i in range(0, q.shape[0], 4)])
    return (float((got.double() - exact).abs().max()),
            float((plain.double() - exact).abs().max()))


def encoder_attention_repeats_differing(q, k, v, mask, first) -> int:
    """Of ``ENCODER_ATTENTION_REPEATS`` launches of kernel 5 queued back to
    back, those whose context is not bit for bit ``first``: a block that
    left a copy in flight into shared memory would corrupt the next one."""
    from opentransformer_tpu_torch.ops.encoder_attention import encoder_self_attention

    outs = [encoder_self_attention(q, k, v, mask) for _ in range(ENCODER_ATTENTION_REPEATS)]
    return sum(not torch.equal(o, first) for o in outs)


def encoder_attention_bound_ms(b: int, h: int, t_q: int, t_k: int, dh: int) -> float:
    """Least time for one call of kernel 5: its 4·B·H·T_q·T_k·Dh operations
    (the two products, every key counted) at the bf16 rate; its bytes (q, k,
    v and the context once) take ~1/(2·T) of that."""
    return 4.0 * b * h * t_q * t_k * dh / PEAK_FLOPS[torch.bfloat16] * 1e3


# label, B, H, T_q, T_k, Dh, mask, a row with no valid key: the long-form
# cell's slice (22 Whisper windows of 1,500 positions, 20 heads of 64, all
# keys valid) and the decode cell's longest bucket (1,024 utterances of 374
# positions, 4 heads of 64, key padding), then the other head widths, T_q ≠
# T_k, a row with no valid key, a mask with holes, fewer keys than a tile and
# rows of a few keys each (most of the tiles loaded ahead go unused)
ENCODER_ATTENTION_SHORT = "B=1024 H=4 T=374 Dh=64 rows of 1-130 keys"
ENCODER_ATTENTION_CASES = [
    ("longform B=22 H=20 T=1500 Dh=64 full", 22, 20, 1500, 1500, 64, "full", False),
    ("decode B=1024 H=4 T=374 Dh=64 ragged", 1024, 4, 374, 374, 64, "ragged", False),
    ("B=64 H=4 T=300 Dh=32 ragged", 64, 4, 300, 300, 32, "ragged", False),
    ("B=16 H=8 T=500 Dh=128 ragged", 16, 8, 500, 500, 128, "ragged", False),
    ("B=8 H=4 Tq=77 Tk=250 Dh=64 ragged", 8, 4, 77, 250, 64, "ragged", False),
    ("B=6 H=4 Tq=1 Tk=129 Dh=64 none", 6, 4, 1, 129, 64, None, False),
    ("B=6 H=4 T=200 Dh=64 no valid key in row 1", 6, 4, 200, 200, 64, "ragged", True),
    ("B=6 H=4 T=200 Dh=128 holes", 6, 4, 200, 200, 128, "holes", False),
    ("B=6 H=4 Tq=3 Tk=7 Dh=32 ragged", 6, 4, 3, 7, 32, "ragged", False),
    (ENCODER_ATTENTION_SHORT, 1024, 4, 374, 374, 64, "short", False),
]
ENCODER_ATTENTION_TIMED = ENCODER_ATTENTION_CASES[:2]
# launches of the short-row case back to back, each equal to the first
ENCODER_ATTENTION_REPEATS = 50


def phase_kernel5():
    """Phase 1d. Kernel 5 (``csrc/encoder_attention.cu``) against the float64
    attention at ``ENCODER_ATTENTION_CASES``, held to twice the plain
    composition's own distance (``encoder_attention_errors``); then, at the
    long-form slice and the decode shape, the kernel, the plain version and
    PyTorch's ``scaled_dot_product_attention`` over the same tensors (a
    yardstick; the port never calls it) queued back to back beside the bf16
    operation bound. Returns (the largest |Δ| from float64, {case: (ms,
    plain ms, bound ms, "operations")}, {case: library ms})."""
    from opentransformer_tpu_torch.ops.encoder_attention import (
        attention_plain,
        encoder_self_attention,
    )

    card = card_line()
    max_err, timings, library = 0.0, {}, {}
    for label, b, h, t_q, t_k, dh, mask, empty in ENCODER_ATTENTION_CASES:
        q, k, v, m = encoder_attention_case(b, h, t_q, t_k, dh, seed=b + h + t_q + dh,
                                            mask=mask, empty_row=empty)
        before = encoder_self_attention.launches
        got = encoder_self_attention(q, k, v, m)
        torch.cuda.synchronize()
        if encoder_self_attention.launches != before + 1 or got.shape != q.shape:
            raise AssertionError(f"phase1d {label}: no launch, or {tuple(got.shape)}")
        err, plain_err = encoder_attention_errors(got, q, k, v, m)
        max_err = max(max_err, err)
        ok = err <= 2.0 * plain_err
        log(f"phase1d {label}: max|d| from float64 kernel {err:.3e}, plain {plain_err:.3e} "
            f"({err / plain_err:.2f}x) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel 5 strays from float64 more than twice the plain "
                                 f"composition: {label}")
        if label == ENCODER_ATTENTION_SHORT:
            differ = encoder_attention_repeats_differing(q, k, v, m, got)
            log(f"phase1d {label}: {ENCODER_ATTENTION_REPEATS} launches back to back, "
                f"{differ} differ from the first {'ok' if differ == 0 else 'FAIL'}")
            if differ:
                raise AssertionError(f"kernel 5 gave {differ} other results of {label}")
    for label, b, h, t_q, t_k, dh, mask, empty in ENCODER_ATTENTION_TIMED:
        q, k, v, m = encoder_attention_case(b, h, t_q, t_k, dh, seed=b + h + t_q + dh,
                                            mask=mask, empty_row=empty)
        kern = cuda_ms(lambda: encoder_self_attention(q, k, v, m), 20, 3, True)
        plain = cuda_ms(lambda: attention_plain(q, k, v, m), 5, 1, True)
        sdpa_mask = None if mask == "full" else m
        library[label] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask), 20, 3, True)
        bound = encoder_attention_bound_ms(b, h, t_q, t_k, dh)
        flops = 4.0 * b * h * t_q * t_k * dh
        timings[label] = (kern, plain, bound, "operations")
        log(f"phase1d time {label}: kernel {kern:.4f} ms ({rate_note(flops, kern, bound)}), "
            f"plain version {plain:.4f} ms, scaled_dot_product_attention "
            f"{library[label]:.4f} ms, bound {bound:.4f} ms (operations: {flops / 1e9:.1f} "
            f"GFLOP at 989 TFLOP/s) [{card}]")
    return max_err, timings, library


# ---------------------------------------------------------------- phase 2
def ids_differing_from_jax(decode_dir: str, vocab_path: str, want=None) -> int:
    """Utterances whose 1-best in ``predict.txt`` is not the JAX package's
    (``want``: {utt: ids}; by default ``ANCHOR_JAX_1BEST``'s, read with
    json); raises unless the decode holds exactly the fixture's utterances."""
    if want is None:
        with open(ANCHOR_JAX_1BEST, encoding="utf-8") as f:
            want = json.load(f)["utts"]
    with open(vocab_path, encoding="utf-8") as f:
        vocab = {unit: int(idx) for unit, idx in (line.split() for line in f if line.strip())}
    got = {}
    with open(os.path.join(decode_dir, "predict.txt"), encoding="utf-8") as f:
        for line in f:
            utt, *units = line.split()
            got[utt] = [vocab[u] for u in units]
    if got.keys() != want.keys():
        raise AssertionError(f"{decode_dir}: decoded {len(got)} utterances, the JAX fixture "
                             f"holds {len(want)} others")
    return sum(got[utt] != ids for utt, ids in want.items())


def anchor_decode(tag: str, data: str, out: str, dtype: str, extra=(),
                  model_cfg: str = ANCHOR + ".manifest.json", want=None):
    """The 500-utterance split through the eval CLI → (CER %, one-head
    launches, two-head launches, utterances whose 1-best ids differ from
    the JAX package's: ``want``, or the beam-5 fixture's); logs the RESULT
    lines. ``extra`` flags follow (and override) beam 5, penalty 0.6,
    max_len 32."""
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    project_logp_topk.launches = project2_logp_topk.launches = 0
    t0 = time.time()
    rc = eval_cli.main([
        "--npz", ANCHOR + ".npz", "--model_cfg", model_cfg,
        "--feats", os.path.join(data, "test", "feats.scp"),
        "--text", os.path.join(data, "test", "text"),
        "--vocab", os.path.join(data, "vocab"),
        "-b", "100", "-bw", "5", "-pn", "0.6", "-ml", "32",
        "--dtype", dtype, "--decode_dir", out, *extra])
    one, two = project_logp_topk.launches, project2_logp_topk.launches
    with open(os.path.join(out, "RESULT")) as f:
        result = f.read().splitlines()
    if rc != 0:
        raise AssertionError(f"{tag}: the eval CLI returned {rc}")
    differ = ids_differing_from_jax(out, os.path.join(data, "vocab"), want)
    log(f"{tag}: {result[0]} | {result[1]} | {result[2]} | {result[3]} | "
        f"kernel launches one-head {one} two-head {two} | 1-best ids differ from the JAX "
        f"package's on {differ} of 500 | wall {time.time() - t0:.1f} s "
        f"[{card_line() if torch.cuda.is_available() else 'cpu'}]")
    return float(result[0].split()[1].rstrip("%")), one, two, differ


def phase_anchor(workdir: str):
    from opentransformer_tpu_torch.data import synth

    data = os.path.join(workdir, "synth")
    t0 = time.time()
    synth.write_corpus(data, splits=("test",))
    log(f"phase2 wrote the synthetic test split (500 utts) in {time.time() - t0:.1f} s")
    cers, differ = {}, {}
    for dtype in ("float32", "bfloat16"):
        cers[dtype], launches, _, differ[dtype] = anchor_decode(
            f"phase2 anchor {dtype}", data, os.path.join(workdir, f"decode_{dtype}"), dtype)
        if launches == 0:
            raise AssertionError(f"anchor {dtype} decode did not run through the kernel")
    if cers["float32"] > ANCHOR_CER_LIMIT:
        raise AssertionError(f"anchor f32 CER {cers['float32']}% above {ANCHOR_CER_LIMIT}% "
                             "(JAX package: 0.65%, 58/8958)")
    if differ["float32"] > ANCHOR_ID_LIMIT:
        raise AssertionError(f"anchor f32: {differ['float32']} of 500 1-best ids differ from the "
                             f"JAX package's, more than {ANCHOR_ID_LIMIT}")
    log(f"phase2 anchor f32 CER {cers['float32']}% <= {ANCHOR_CER_LIMIT}% ok "
        f"(JAX package 0.65%), 1-best ids differ from JAX's on {differ['float32']} <= "
        f"{ANCHOR_ID_LIMIT} of 500 ok; bf16 CER {cers['bfloat16']}%, {differ['bfloat16']} differ "
        f"(not gated)")
    return data


# ---------------------------------------------------------------- phase 3
def seeded_params(model, seed: int, embedding_std: float = 1.0) -> dict:
    """Seeded random weights for ``model`` in the JAX package's layout
    (numpy generator; shapes taken from the model's own parameters, and
    BatchNorm running variances of one; an MoE's stacked expert kernels
    ``w1`` / ``w2`` [E, in, out] and biases ``b1`` / ``b2`` U(±1/sqrt(in)) of
    their kernel, as the JAX package initialises them)."""
    from opentransformer_tpu_torch import compat

    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = fill(val)
            elif key in ("scale", "var"):
                out[key] = np.ones_like(val)
            elif key == "embedding":
                out[key] = (embedding_std * rng.normal(size=val.shape)).astype(np.float32)
            else:  # kernels U(±1/sqrt(fan_in)), biases U(±1/sqrt(width))
                if key in ("w1", "w2", "b1", "b2"):  # an MoE's [E, ...] expert stacks
                    fan_in = tree["w" + key[1]].shape[-2]
                else:
                    fan_in = int(np.prod(val.shape[:-1])) if key == "kernel" else val.shape[0]
                bound = 1.0 / np.sqrt(fan_in)
                out[key] = rng.uniform(-bound, bound, size=val.shape).astype(np.float32)
        return out

    return fill(compat.params_to_jax(model))


def seeded_model(cfg: dict, dtype, seed: int):
    """``cfg`` built on the card with seeded random weights, made in the
    JAX package's layout and carried over by ``compat.params_from_jax``."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    model = build_model(cfg, dtype=dtype)
    return compat.load_into(model, seeded_params(model, seed))


def small_input_check(tag: str, model32, lm=None, feat_dim: int = 40):
    """Fused and unfused decodes of a small float32 input give the same ids."""
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 200, feat_dim, generator=g).cuda()
    m = torch.ones(2, 200, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        mem, mm = model32.encode(x, m)
    beam = WORST_CASE["beam"]
    fused = make_memory_search(model32, beam, 8, lm=lm, eos_id=-1)(mem, mm)
    plain = make_memory_search(model32, beam, 8, lm=lm, eos_id=-1, fused_topk=False)(mem, mm)
    if not torch.equal(fused.tokens, plain.tokens):
        raise AssertionError(f"{tag}: fused and unfused decodes disagree")
    log(f"{tag} small input: fused-kernel decode == unfused decode ok")


def worst_case_run(model, lm=None, feat_dim: int = 40, encode_only: bool = False):
    """The flagship worst case as a closure: encode + beam search, bf16
    model, beam 5, B=512 x 500 seeded random frames, 24 forced steps (or
    the encode alone)."""
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    batch, frames, max_len, beam = (WORST_CASE[k] for k in ("batch", "frames", "max_len", "beam"))
    search = make_memory_search(model, beam, max_len, lm=lm, eos_id=-1)
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(batch, frames, feat_dim, generator=g).cuda()
    mask = torch.ones(batch, frames, dtype=torch.bool, device="cuda")

    def run():
        with torch.inference_mode():
            memory, memory_mask = model.encode(feats, mask)
            return memory if encode_only else search(memory, memory_mask)

    return run


def host_seconds(run) -> float:
    """Host-clock time of one ``run()`` ending in a device synchronise."""
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    return time.time() - t0


def worst_case_decode(tag: str, model, lm=None, feat_dim: int = 40):
    """One warm-up of the flagship worst case, one counted run (launch
    counts, peak memory, output checks), then the median of three timed
    runs. Returns (one-head launches, two-head launches, median seconds,
    kernel-4 launches, kernel-5 launches), the launches of the counted run."""
    from opentransformer_tpu_torch.ops.encoder_attention import encoder_self_attention
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    batch, frames, max_len, beam = (WORST_CASE[k] for k in ("batch", "frames", "max_len", "beam"))
    run = worst_case_run(model, lm, feat_dim)
    run()  # warm-up: cuBLAS/cuDNN plans, kernel library load
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    project_logp_topk.launches = project2_logp_topk.launches = 0
    encoder_self_attention.launches = 0
    att0 = attention_launches()
    hyp = run()
    torch.cuda.synchronize()
    one, two = project_logp_topk.launches, project2_logp_topk.launches
    att = attention_launches() - att0
    enc = encoder_self_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    shape_ok = tuple(hyp.tokens.shape) == (batch, beam, max_len + 1)
    finite = bool(torch.isfinite(hyp.scores).all())
    full = bool((hyp.lengths == max_len + 1).all())
    # the host clock varies from run to run: time three more and take the median
    times = [host_seconds(run) for _ in range(3)]
    secs = sorted(times)[1]
    log(f"{tag} bf16 beam {beam} B={batch} x {frames} frames, {max_len} steps: "
        f"median {secs:.3f} s of {[round(t, 3) for t in times]}, {batch / secs:.2f} utts/s, "
        f"RTFx {batch * frames * 0.01 / secs:.2f}, peak memory {peak:.2f} GiB, "
        f"kernel launches one-head {one} two-head {two} beam attention {att} encoder "
        f"attention {enc} [{card_line()}]")
    if not (shape_ok and finite and full):
        raise AssertionError(f"{tag}: decode output wrong: shape {tuple(hyp.tokens.shape)}, "
                             f"finite {finite}, all full-length {full}")
    return one, two, secs, att, enc


def phase_flagship():
    """Phase 3. Returns (kernel-1 launches, the decode's median seconds,
    kernel-4 launches, kernel-5 launches) of one decode. Every cross call of
    the bf16 decodes takes kernel 4's one-pass entry."""
    small_input_check("phase3 flagship f32", seeded_model(FLAGSHIP_CFG, torch.float32, seed=0))
    cross0 = cross_launch_counts()
    one, two, secs, att, enc = worst_case_decode(
        "phase3 flagship", seeded_model(FLAGSHIP_CFG, torch.bfloat16, seed=0))
    cross, one_pass = (n - n0 for n, n0 in zip(cross_launch_counts(), cross0))
    log(f"phase3 kernel 4 cross launches {cross}, through the one-pass entry {one_pass}")
    if cross == 0 or one_pass != cross:
        raise AssertionError(f"phase3: {one_pass} of {cross} bf16 cross launches took the "
                             f"one-pass entry")
    max_len = WORST_CASE["max_len"]
    # kernel 4: each decoder block's self and cross attention at every step;
    # kernel 5: each encoder block's self-attention, the batch in one slice
    att_want = 2 * FLAGSHIP_CFG["decoder"]["n_blocks"] * max_len
    enc_want = FLAGSHIP_CFG["encoder"]["n_blocks"]
    if one != max_len or two != 0 or att != att_want or enc != enc_want:
        raise AssertionError(f"expected one one-head kernel launch per decode step ({max_len}), "
                             f"no two-head launch, {att_want} beam attention launches and "
                             f"{enc_want} encoder attention launches, counted {one}, {two}, "
                             f"{att} and {enc}")
    return one, secs, att, enc


# ---------------------------------------------------------------- phase 4
def nbest_scores_sorted(decode_dir: str) -> int:
    """Number of utterances in ``predict.log``; raises unless each one's
    n-best scores are in descending order."""
    nbest: dict[str, list[float]] = {}
    with open(os.path.join(decode_dir, "predict.log")) as f:
        for line in f:
            utt, _, score = line.split()[:3]
            nbest.setdefault(utt, []).append(float(score.split("=")[1]))
    for utt, scores in nbest.items():
        if scores != sorted(scores, reverse=True):
            raise AssertionError(f"n-best scores of {utt} are not sorted: {scores}")
    return len(nbest)


def phase_anchor_lm(workdir: str, data: str):
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    lm_npz, lm_json = os.path.join(workdir, "lm.npz"), os.path.join(workdir, "lm.json")
    # a unit-variance tied embedding gives a random LM logits of scale
    # sqrt(d_model) = 16, which swamp the model even at weight 0.1; scaled
    # down to unit logits it acts like a weak LM: it moves scores, not all ids
    d_model = ANCHOR_LM_CFG["d_model"]
    compat.save_npz(lm_npz, seeded_params(build_model(ANCHOR_LM_CFG), seed=11,
                                          embedding_std=d_model ** -0.5))
    with open(lm_json, "w") as f:
        json.dump(ANCHOR_LM_CFG, f)
    lm_args = ("-lm", lm_npz, "--lm_cfg", lm_json)

    out = os.path.join(workdir, "decode_lmw0")
    cer, one, two, differ = anchor_decode("phase4 anchor f32 + random transformer LM, -lmw 0.0",
                                          data, out, "float32", (*lm_args, "-lmw", "0.0"))
    if two == 0 or one != 0:
        raise AssertionError("the LM-fusion decode must go through the two-head kernel only: "
                             f"one-head launches {one}, two-head launches {two}")
    if cer > ANCHOR_CER_LIMIT:
        raise AssertionError(f"anchor f32 CER {cer}% at lm weight 0 above {ANCHOR_CER_LIMIT}% "
                             "(the fused score is then the model's own)")
    if differ > ANCHOR_ID_LIMIT:
        raise AssertionError(f"anchor f32 at lm weight 0: {differ} of 500 1-best ids differ from "
                             f"the JAX package's, more than {ANCHOR_ID_LIMIT}")
    log(f"phase4 anchor f32 at lm weight 0 through the two-head kernel: CER {cer}% <= "
        f"{ANCHOR_CER_LIMIT}% ok, 1-best ids differ from JAX's on {differ} <= {ANCHOR_ID_LIMIT} "
        f"of 500 ok, {two} two-head launches, 0 one-head launches")

    out = os.path.join(workdir, "decode_lmw01")
    cer, _, _, _ = anchor_decode("phase4 anchor f32 + random transformer LM, -lmw 0.1",
                                  data, out, "float32", (*lm_args, "-lmw", "0.1"))
    log(f"phase4 -lmw 0.1: CER {cer}% (not gated: the LM is untrained)")
    out = os.path.join(workdir, "decode_resc")
    anchor_decode("phase4 anchor f32 + random transformer LM, -lmw 0.1 -lm_resc 0.1",
                  data, out, "float32", (*lm_args, "-lmw", "0.1", "-lm_resc", "0.1"))
    log(f"phase4 -lm_resc 0.1: n-best scores sorted for {nbest_scores_sorted(out)} utterances ok")
    return two


# ---------------------------------------------------------------- phase 5
def phase_flagship_lm():
    model32 = seeded_model(FLAGSHIP_CFG, torch.float32, seed=0)
    small_input_check("phase5 flagship f32 + transformer LM (ancestry-map caches)", model32,
                      seeded_model(FLAGSHIP_LM_CFG, torch.float32, seed=1))
    small_input_check("phase5 flagship f32 + LSTM LM (gathered state)", model32,
                      seeded_model(LSTM_LM_CFG, torch.float32, seed=2))
    del model32
    model = seeded_model(FLAGSHIP_CFG, torch.bfloat16, seed=0)
    lm = seeded_model(FLAGSHIP_LM_CFG, torch.bfloat16, seed=1)
    one, two, _, _, _ = worst_case_decode("phase5 flagship + transformer LM shallow fusion", model,
                                       lm)
    max_len = WORST_CASE["max_len"]
    if two != max_len or one != 0:
        raise AssertionError(f"expected one two-head kernel launch per decode step ({max_len}) "
                             f"and no one-head launch, counted {two} and {one}")
    # what fusion costs: the host clock drifts between phases, so the decode
    # without and with the LM run in turns on the same model and inputs
    run_plain, run_lm = worst_case_run(model), worst_case_run(model, lm)
    pairs = [(host_seconds(run_plain), host_seconds(run_lm)) for _ in range(7)]
    mid = len(pairs) // 2
    plain_s = sorted(p for p, _ in pairs)[mid]
    lm_s = sorted(f for _, f in pairs)[mid]
    diff_s = sorted(f - p for p, f in pairs)[mid]
    log(f"phase5 cost of LM fusion, {len(pairs)} alternating pairs: median without LM "
        f"{plain_s:.3f} s, with LM {lm_s:.3f} s, median difference {diff_s:+.3f} s per batch "
        f"(pairs {[(round(p, 3), round(f, 3)) for p, f in pairs]}) [{card_line()}]")
    return two


# ---------------------------------------------------------------- phase 6
def fbank_waves(b: int, n: int, seed: int, silent=None, device="cuda"):
    """f32[B, N] noise plus two tones per row; row 1 ragged at 3/4 of N."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    w = np.empty((b, n), np.float32)
    for i in range(b):
        f1, f2 = 200.0 + 97.0 * i, 1500.0 + 311.0 * i
        w[i] = (0.05 * rng.normal(size=n) + 0.3 * np.sin(2 * np.pi * f1 * t)
                + 0.1 * np.sin(2 * np.pi * f2 * t))
    lens = np.full(b, n, np.int32)
    if b > 1:
        lens[1] = 3 * n // 4
        w[1, lens[1]:] = 0.0
    if silent is not None:
        w[silent] = 0.0
    return torch.from_numpy(w).to(device), torch.from_numpy(lens).to(device)


def plain_fbank(waveforms, lengths, num_mel_bins: int):
    """``fbank_batch`` with the plain spectrum stage called directly."""
    from opentransformer_tpu_torch.ops import fbank_kernel as fk

    frames = fk.extract_frames(waveforms)
    b, t, ws = frames.shape
    tab = fk.device_bases(num_mel_bins, 16000.0, frames.device)
    feats = fk.spec_mel_plain(frames.reshape(b * t, ws), tab.cos, tab.sin, tab.mel_t)
    feats = feats.reshape(b, t, num_mel_bins)
    return feats, fk.wave_frame_lengths(lengths)


def exact_fbank(waveforms, num_mel_bins: int) -> torch.Tensor:
    """The spectrum stage in float64 on the same float32 frames and bases."""
    from opentransformer_tpu_torch.ops import fbank_kernel as fk

    frames = fk.extract_frames(waveforms).double()
    tab = fk.device_bases(num_mel_bins, 16000.0, frames.device)
    cos_b, sin_b, mel_t = tab.cos.double(), tab.sin.double(), tab.mel_t.double()
    power = (frames @ cos_b).square() + (frames @ sin_b).square()
    return torch.log(torch.clamp_min(power @ mel_t, fk.EPSILON)).float()


def valid_max_err(a, b, frame_lengths) -> float:
    valid = torch.arange(a.shape[1], device=a.device)[None] < frame_lengths[:, None]
    return (a - b).abs()[valid].max().item()


def phase_fbank():
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.ops.fbank import num_frames
    from opentransformer_tpu_torch.utils import disable_tf32

    disable_tf32()
    max_err = 0.0
    for i, (label, b, n, bins, silent) in enumerate(FBANK_CASES):
        w, lens = fbank_waves(b, n, seed=60 + i, silent=silent)
        before = fk.spec_mel.launches
        feats, flens = fk.fbank_batch(w, lens, bins)
        launched = fk.spec_mel.launches - before
        ref, rlens = plain_fbank(w, lens, bins)
        exact = exact_fbank(w, bins)
        torch.cuda.synchronize()
        want = [num_frames(int(m)) for m in lens.tolist()]
        counts_ok = (flens.tolist() == rlens.tolist() == want
                     and feats.shape == ref.shape == (b, max(num_frames(n), 1), bins))
        err = valid_max_err(feats, ref, flens)
        err_exact = valid_max_err(feats, exact, flens)
        plain_exact = valid_max_err(ref, exact, flens)
        finite = bool(torch.isfinite(feats).all())
        silent_ok = True
        if silent is not None:
            silent_ok = bool((feats[silent] == float(np.float32(np.log(fk.EPSILON)))).all())
        ok = (counts_ok and finite and silent_ok and launched == 1 and err <= FBANK_ATOL
              and err_exact <= FBANK_EXACT_ATOL)
        log(f"phase6 {label}: frames {flens.tolist()} (plain {rlens.tolist()}), max|dlogmel| on "
            f"valid frames vs plain {err:.3e} (atol {FBANK_ATOL:.0e}), vs float64 {err_exact:.3e} "
            f"(atol {FBANK_EXACT_ATOL:.0e}; plain vs float64 {plain_exact:.3e}), "
            f"launches {launched}"
            f"{', silent row exactly log(EPSILON)' if silent is not None and silent_ok else ''} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fbank kernel disagrees with its plain version: {label}")
        max_err = max(max_err, err)

    # the timed batch, cold: four copies of the frames (4 x 25.5 MB) in turn
    b, n, bins = FBANK_TIMED
    w, _ = fbank_waves(b, n, seed=99)
    waves = [w.clone() for _ in range(4)]
    flats = [fk.extract_frames(x).reshape(-1, 400) for x in waves]
    flat = flats[0]
    tab = fk.device_bases(bins, 16000.0, flat.device)
    kernel_args = (tab.mel_t, tab.twiddles, tab.mel_ranges)

    def composition(x):
        spec = torch.fft.rfft(x, n=512, dim=-1)
        power = spec.real.square() + spec.imag.square()
        return torch.log(torch.clamp_min(power @ tab.mel_t, fk.EPSILON))

    comp_err = (composition(flat) - fk.spec_mel(flat, *kernel_args)).abs().max().item()
    # device time (torch.profiler) in turns, kernel first and last; the kernel's
    # time between CUDA events beside it, which counts the host's launch work
    kernel = lambda x: fk.spec_mel(x, *kernel_args)  # noqa: E731
    kern_runs = [device_ms_cold(kernel, flats)]
    plain = device_ms_cold(lambda x: fk.spec_mel_plain(x, tab.cos, tab.sin, tab.mel_t), flats)
    comp = device_ms_cold(composition, flats)
    framing = device_ms_cold(fk.extract_frames, waves)
    kern_runs.append(device_ms_cold(kernel, flats))
    kern = min(kern_runs)
    kern_events = cuda_ms_cold(kernel, flats)
    mel_nnz = int((tab.mel_t != 0).sum())
    bound, bound_by = fbank_bound_ms(flat.shape[0], bins, mel_nnz)
    dense = fbank_dense_ops_ms(flat.shape[0], bins)
    log(f"phase6 time B={b} x {n} samples = {flat.shape[0]} frames M={bins}, device time per call "
        f"(torch.profiler), cold L2 (each call reads one of 4 separate frame buffers, 4 x "
        f"{flat.numel() * 4 / 1e6:.1f} MB): kernel {kern:.4f} ms (runs "
        f"{[round(x, 4) for x in kern_runs]}; {kern_events:.4f} ms a call between CUDA events, "
        f"host launch work included), plain version {plain:.4f} ms, rfft + |.|^2 + mel matmul + "
        f"log (a composition of calls, not a library call; max|d| vs kernel {comp_err:.2e}) "
        f"{comp:.4f} ms; bound {bound:.4f} ms ({bound_by}: FFT, power and {mel_nnz} mel weights "
        f"a frame), {100.0 * bound / kern:.1f}% of it reached (the TPU kernel's dense products "
        f"alone would take {dense:.4f} ms at the float32 rate); framing (extract_frames, {b} x "
        f"{n} samples, cold) {framing:.4f} ms"
        f"{'' if kern < min(plain, comp) else ', SLOWER than the plain version or the composition'}"
        f" [{card_line()}]")
    return max_err, (kern, plain, bound, bound_by)


# ---------------------------------------------------------------- phase 7
def write_train_corpus(root: str, seed: int = 7) -> dict:
    """Seeded wavs (noise plus tones, 2-10 s) with 8-28-unit transcripts
    over the 4,230 units, a vocab, and wav.scp/text for a train and a dev
    split; returns {split: (wav.scp, text)} and the vocab path."""
    import scipy.io.wavfile as siw

    from opentransformer_tpu_torch.data import write_vocab

    c = TRAIN_CORPUS
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    units = [f"u{i:04d}" for i in range(4230)]
    write_vocab({"<PAD>": 0, "<S/E>": 1, "<UNK>": 2, **{u: 3 + i for i, u in enumerate(units)}},
                os.path.join(root, "vocab"))
    paths = {"vocab": os.path.join(root, "vocab")}
    for split in ("train", "dev"):
        scp, text = [], []
        for i in range(c[split]):
            n = int(rng.uniform(c["min_s"], c["max_s"]) * 16000)
            t = np.arange(n) / 16000.0
            tones = sum(a * np.sin(2 * np.pi * f * t)
                        for a, f in zip(rng.uniform(0.05, 0.3, 3), rng.uniform(100, 4000, 3)))
            wav = 0.05 * rng.normal(size=n) + tones
            wav = (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16)
            path = os.path.join(root, f"{split}{i:03d}.wav")
            siw.write(path, 16000, wav)
            ids = rng.integers(0, len(units), size=rng.integers(c["min_units"], c["max_units"] + 1))
            scp.append(f"{split}{i:03d} {path}")
            text.append(f"{split}{i:03d} " + " ".join(units[j] for j in ids))
        for name, lines in (("wav.scp", scp), ("text", text)):
            with open(os.path.join(root, f"{split}.{name}"), "w") as f:
                f.write("\n".join(lines) + "\n")
        paths[split] = (os.path.join(root, f"{split}.wav.scp"), os.path.join(root, f"{split}.text"))
    return paths


def train_config(paths: dict, epochs: int = 2, model_cfg=None, conf: str = TRAIN_CONF) -> dict:
    """A committed training config (the baseline by default) pointed at the
    seeded corpus."""
    with open(conf) as f:
        cfg = json.load(f)
    cfg["data"]["vocab"] = paths["vocab"]
    for split in ("train", "dev"):
        cfg["data"][split] = {"feat": [paths[split][0]], "text": [paths[split][1]]}
    cfg["data"].pop("test")
    cfg["train"]["epochs"] = epochs
    if model_cfg is not None:
        cfg["model"] = model_cfg
    return cfg


def overfit_model_cfg(model_cfg: dict) -> dict:
    """A speech model config at width 64 with 2 encoder blocks (and 1
    decoder block; a transducer's predictor of 1 layer and joint of 64)."""
    o = OVERFIT
    d = o["d_model"]
    cfg = json.loads(json.dumps(model_cfg))
    cfg["frontend"]["output_size"] = d
    blocks = "nblocks" if "nblocks" in cfg["encoder"] else "n_blocks"
    cfg["encoder"].update({"d_model": d, "d_ff": o["d_ff"], blocks: o["enc_blocks"]})
    if "decoder" in cfg:
        cfg["decoder"].update(d_model=d, memory_dim=d, n_blocks=o["dec_blocks"], d_ff=o["d_ff"])
    if cfg["type"] == "transducer":
        cfg["predictor"] = dict(cfg.get("predictor") or {}, d_model=d, num_layers=1)
        cfg["d_joint"] = d
    return cfg


def attention_launches() -> int:
    """Kernel 4's launches so far in this process, both entries."""
    from opentransformer_tpu_torch.ops.beam_attention import (
        beam_cross_attention,
        beam_self_attention,
    )

    return beam_cross_attention.launches + beam_self_attention.launches


def cross_launch_counts() -> tuple[int, int]:
    """Kernel 4's cross launches so far in this process, and those of them
    through its one-pass entry."""
    from opentransformer_tpu_torch.ops.beam_attention import beam_cross_attention

    return beam_cross_attention.launches, beam_cross_attention.one_pass_launches


def reset_launch_counts():
    from opentransformer_tpu_torch.ops.fbank_kernel import spec_mel
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    spec_mel.launches = project_logp_topk.launches = project2_logp_topk.launches = 0


def cli_train(tag: str, workdir: str, paths: dict, device: str = "cuda", model_cfg=None,
              conf: str = TRAIN_CONF, name: str | None = None):
    """Train ``conf`` (cut to ``model_cfg`` if given) on the seeded corpus
    through the training CLI for 2 epochs, then check the run: one fbank
    launch per training micro-batch (none on the CPU), no top-k launch,
    finite losses, no NaN skip, both checkpoints, and the newest one
    reloaded into a fresh model decoding a dev batch to the same ids; last,
    the steady-state seconds per update. ``name`` (default: the config's
    file name) names the run's files under ``workdir``. Returns (trainer,
    config, fbank launches)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk
    from opentransformer_tpu_torch.recognize.base import make_memory_search
    from opentransformer_tpu_torch.train.checkpoint import Checkpointer
    from opentransformer_tpu_torch.train.trainer import feature_args

    cuda = device == "cuda"
    cfg = train_config(paths, model_cfg=model_cfg, conf=conf)
    name = name or os.path.splitext(os.path.basename(conf))[0]
    conf_path = os.path.join(workdir, f"train_{name}.json")
    with open(conf_path, "w") as f:
        json.dump(cfg, f)
    expdir = os.path.join(workdir, f"exp_{name}")

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    trainer = run_cli.run(["-c", conf_path, "--expdir", expdir, "--log_interval", "1", "-s", "7",
                           *([] if cuda else ["--device", device])])
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fk.spec_mel.launches
    topk_launches = project_logp_topk.launches + project2_logp_topk.launches
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    batches_per_epoch = -(-TRAIN_CORPUS["train"] // cfg["data"]["batch_size"])
    micro = batches_per_epoch * cfg["train"]["epochs"]
    losses = [x for r in trainer.history for x in r["losses"]]
    finite = all(np.isfinite(losses)) and all(np.isfinite(trainer.dev_losses))
    ck = Checkpointer(expdir)
    gaps = [b["time"] - a["time"] for a, b in zip(trainer.history, trainer.history[1:])]
    n_params = sum(p.numel() for p in trainer.model.parameters())
    log(f"{tag} trained {name} ({n_params} parameters) {cfg['train']['epochs']} epochs in "
        f"{wall:.1f} s: {len(losses)} "
        f"micro-batches, {len(trainer.history)} updates (lr {[r['lr'] for r in trainer.history]}, "
        f"grad norms {[round(r['gnorm'], 3) for r in trainer.history]}), losses "
        f"{[round(x, 4) for x in losses]}, dev losses {[round(x, 4) for x in trainer.dev_losses]}, "
        f"NaN skips {trainer.nan_skips}, fbank launches {launches} (train micro-batches {micro}, "
        f"dev 0), top-k launches {topk_launches}, checkpoints {ck.list_epochs()}, peak memory "
        f"{peak:.2f} GiB, host seconds between updates {[round(g, 3) for g in gaps]}")
    updates = cfg["train"]["epochs"] * -(-batches_per_epoch // cfg["train"]["accum_steps"])
    # one kernel launch per training micro-batch (none on a CPU rehearsal)
    if not (launches == (micro if cuda else 0) and micro == len(losses) and topk_launches == 0
            and finite and trainer.nan_skips == 0 and ck.list_epochs() == [0, 1]
            and len(trainer.history) == updates):
        raise AssertionError(f"{tag}: the training run is not what was asked for (see above)")

    # the newest checkpoint, reloaded into a fresh model, decodes one dev
    # batch to the same ids as the trained model
    model = trainer.model.eval()
    fresh = compat.load_into(build_model(cfg["model"], device=device),
                             ck.load_params(ck.epoch_path(1)))
    batch = next(iter(FeatureLoader(cfg, "dev", is_eval=True)))
    feats, mask, _, _ = feature_args(batch, device)
    ids = []
    for m in (model, fresh):
        with torch.inference_mode():
            memory, memory_mask = m.encode(feats, mask)
        ids.append(make_memory_search(m, 5, 16)(memory, memory_mask).tokens)
    if not torch.equal(ids[0], ids[1]):
        raise AssertionError(f"{tag}: the reloaded checkpoint decodes differently")
    log(f"{tag} model.epoch.1 reloaded into a fresh model: beam-5 decode of a dev batch of "
        f"{feats.shape[0]} gives identical ids {tuple(ids[0].shape)} ok")

    # steady-state seconds per update: full windows of this epoch's batches
    model.train()
    window = list(FeatureLoader(cfg, "train", seed=7))[: cfg["train"]["accum_steps"]]
    secs = []
    for _ in range(4):
        start = time.time()
        for b in window:
            trainer.micro_step(b)
        trainer.update()
        if cuda:
            torch.cuda.synchronize()
        secs.append(time.time() - start)
    log(f"{tag} seconds per update ({len(window)} micro-batches of "
        f"{cfg['data']['batch_size']} each, host clock, after the first): "
        f"{[round(x, 3) for x in secs[1:]]}, median {sorted(secs[1:])[1]:.3f} s "
        f"(first {secs[0]:.3f} s) [{card_line() if cuda else device}]")
    return trainer, cfg, launches


def phase_train(workdir: str, device: str = "cuda", model_cfg=None):
    """Train through the CLI, then the checks of the module docstring.
    ``device="cpu"`` with a cut ``model_cfg`` rehearses the phase on the CPU
    (where the fbank count stays 0); the card run uses the baseline as
    committed. Returns (fbank launches, the corpus's paths)."""
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.train.trainer import Trainer

    t0 = time.time()
    paths = write_train_corpus(os.path.join(workdir, "corpus"))
    log(f"phase7 wrote the corpus in {time.time() - t0:.1f} s")
    trainer, cfg, launches = cli_train("phase7", workdir, paths, device, model_cfg)
    model = trainer.model

    # one micro-batch with the kernel and with the plain spectrum, called directly
    train_batch = next(iter(FeatureLoader(cfg, "train", seed=7)))
    _, inputs, tg = train_batch
    w = torch.as_tensor(inputs["waveforms"]).to(device)
    wl = torch.as_tensor(inputs["wave_lengths"]).to(device)
    frontend = trainer.frontend
    feats_k, mask_k = frontend.finish(*fk.fbank_batch(w, wl, frontend.num_mel_bins), train=False)
    feats_p, mask_p = frontend.finish(*plain_fbank(w, wl, frontend.num_mel_bins), train=False)
    feat_err = valid_max_err(feats_k, feats_p, mask_k.sum(1))
    targets = torch.as_tensor(tg["targets"]).long().to(device)
    tlen = torch.as_tensor(tg["targets_length"]).long().to(device)
    model.eval()
    with torch.no_grad():
        loss_k = model(feats_k, mask_k, targets, tlen)[0].item()
        loss_p = model(feats_p, mask_p, targets, tlen)[0].item()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    ok = torch.equal(mask_k, mask_p) and feat_err <= FBANK_ATOL and rel <= 1e-4
    log(f"phase7 one micro-batch ({w.shape[0]} x {w.shape[1]} samples) through the kernel and "
        f"through the plain spectrum: max|dfeats| {feat_err:.3e} (atol {FBANK_ATOL:.0e}), "
        f"loss {loss_k:.6f} vs {loss_p:.6f}, relative {rel:.2e} (limit 1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase7: kernel and plain spectrum disagree on a training batch")

    # overfit: width 64, 2 + 1 blocks, constant lr, one batch of 8 utterances
    o = OVERFIT
    small = build_model(overfit_model_cfg(cfg["model"]), device=device)
    over = Trainer({"accum_steps": 1, "clip_grad": cfg["train"]["clip_grad"],
                    "optimizer_type": "adam", "optimizer": cfg["train"]["optimizer"],
                    "scheduler_type": "constant", "scheduler": {"lr": o["lr"]}},
                   small, frontend, torch.Generator(device=device).manual_seed(3))
    batch8 = next(iter(FeatureLoader(cfg, "train", batch_size=o["utts"], seed=3)))
    small.train()
    curve = []
    for _ in range(o["updates"]):
        over.micro_step(batch8)
        curve.append(over.update()["losses"][0])
    ok = all(np.isfinite(curve)) and curve[-1] < 0.5 * curve[0] and over.nan_skips == 0
    log(f"phase7 overfit width {o['d_model']}, {o['enc_blocks']}+{o['dec_blocks']} blocks, "
        f"lr {o['lr']}, {len(batch8[0])} utterances, {o['updates']} updates: loss "
        f"{curve[0]:.4f} -> {curve[-1]:.4f} (every 10th: {[round(x, 3) for x in curve[::10]]}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase7: the width-64 model did not halve its loss in 40 updates")
    return launches, paths


# ---------------------------------------------------------------- phase 8
def ctc_model_cfg(cfg: dict) -> dict:
    """The anchor's frontend, encoder and CTC head as a ``ctc`` model (as
    ``tools/torch_port_ctc_parity.py`` builds it)."""
    return {"type": "ctc", "frontend_type": cfg.get("frontend_type", "conv"),
            "frontend": cfg["frontend"], "encoder_type": cfg.get("encoder_type", "transformer"),
            "encoder": cfg["encoder"], "vocab_size": cfg["decoder"]["vocab_size"]}


def hybrid_batch(data: str, n: int = 100, seed: int = 8):
    """The split's first ``n`` utterances, collated as the eval CLI does,
    with seeded targets (BOS ⧺ 8-28 units ⧺ EOS ⧺ PAD…) → numpy arrays."""
    from opentransformer_tpu_torch.cli.eval import collate
    from opentransformer_tpu_torch.data import BOS, EOS
    from opentransformer_tpu_torch.data.kaldi_io import load_mat, read_scp

    scp = list(read_scp(os.path.join(data, "test", "feats.scp")).values())[:n]
    x, mask, _ = collate([load_mat(rx) for rx in scp])
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 29, size=n)
    targets = np.zeros((n, int(lens.max()) + 2), np.int64)
    targets[:, 0] = BOS
    for i, u in enumerate(lens):
        targets[i, 1 : 1 + u] = rng.integers(3, 4233, size=u)
        targets[i, 1 + u] = EOS
    return x, mask, targets, lens + 1


def phase_anchor_ctc(workdir: str, data: str, device: str = "cuda"):
    """Phase 8 (module docstring). ``device="cpu"`` rehearses it on the CPU,
    where kernel 1 is never launched and (d) compares the CPU with itself.
    Returns {decode: kernel 1 launches}."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    cuda = device == "cuda"
    with open(ANCHOR_JAX_CTC, encoding="utf-8") as f:
        fixture = json.load(f)["decodes"]
    with open(ANCHOR + ".manifest.json", encoding="utf-8") as f:
        cfg = json.load(f)["model_cfg"]
    ctc_json = os.path.join(workdir, "anchor_ctc.json")
    with open(ctc_json, "w") as f:
        json.dump(ctc_model_cfg(cfg), f)
    dev_args = () if cuda else ("--device", "cpu")
    batches = -(-500 // 100)
    runs = {
        "greedy": ("phase8a anchor CTC greedy f32", ctc_json, ("-md", "greedy")),
        "beam": ("phase8b anchor CTC prefix beam 5, prune 32, f32", ctc_json,
                 ("-bw", "5", "-prune", "32")),
        "ctcw": ("phase8c anchor beam 5 + CTC rescoring -ctcw 0.3 f32",
                 ANCHOR + ".manifest.json", ("-ctcw", "0.3")),
    }
    launches = {}
    for name, (tag, model_cfg, flags) in runs.items():
        want = fixture[name]
        out = os.path.join(workdir, f"decode_ctc_{name}")
        cer, one, two, differ = anchor_decode(tag, data, out, "float32", (*flags, *dev_args),
                                              model_cfg=model_cfg, want=want["utts"])
        launches[name] = one
        want_cer = float(want["cer"].split()[0].rstrip("%"))
        if name == "ctcw":
            n_sorted = nbest_scores_sorted(out)
            ok = cer <= ANCHOR_CER_LIMIT and (one > 0) == cuda
            gate = (f"CER {cer}% <= {ANCHOR_CER_LIMIT}% (JAX {want['cer']}), n-best scores "
                    f"sorted for {n_sorted} utterances, {one} one-head launches (beam steps)")
        else:
            margin_ok = (cer <= want_cer + CTC_CER_MARGIN if name == "greedy"
                         else abs(cer - want_cer) <= CTC_CER_MARGIN)
            ok = margin_ok and one == (batches if cuda else 0)
            gate = (f"CER {cer}% {'<=' if name == 'greedy' else 'within'} {CTC_CER_MARGIN} "
                    f"points of the JAX package's {want['cer']}, kernel 1 launches {one} "
                    f"(one per batch: {batches})")
        ok = ok and differ <= ANCHOR_ID_LIMIT and two == 0
        log(f"{tag}: {gate}, 1-best ids differ from JAX's on {differ} <= {ANCHOR_ID_LIMIT} "
            f"of 500, two-head launches {two} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: a gate failed (see above)")

    # (d) the hybrid loss of one batch on the device against the CPU
    tree = compat.load_npz(ANCHOR + ".npz")
    x, mask, targets, tlen = hybrid_batch(data)
    parts = {}
    for where in ("cpu", device):
        model = compat.load_into(build_model(cfg, device=where), tree)
        args = [torch.from_numpy(a).to(where) for a in (x, mask, targets, tlen)]
        with torch.no_grad():
            loss, aux = model(*args)
        parts[where] = {"loss": loss.item(), "ctc_loss": aux["ctc_loss"].item(),
                        "att_loss": aux["att_loss"].item()}
    rel = {key: abs(parts[device][key] - val) / abs(val) for key, val in parts["cpu"].items()}
    ok = all(np.isfinite(list(parts[device].values()))) and max(rel.values()) <= HYBRID_LOSS_RTOL
    log(f"phase8d hybrid loss of {x.shape[0]} anchor utterances ({x.shape[1]} frames) with "
        f"seeded targets, {device} against cpu: "
        + ", ".join(f"{key} {parts[device][key]:.6f} vs {parts['cpu'][key]:.6f} (relative "
                    f"{rel[key]:.2e})" for key in parts["cpu"])
        + f", limit {HYBRID_LOSS_RTOL:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase8d: the card's hybrid loss disagrees with the CPU's")
    return launches


# ---------------------------------------------------------------- phase 9
def conformer_model_cfg(name: str) -> dict:
    """The ``model`` section of a committed config (``conf/<name>.json``)."""
    with open(os.path.join(CONF_DIR, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)["model"]


def conformer_inputs(seed: int, utts: int, frames: int, min_frames: int, min_units: int,
                     max_units: int, mel: int, vocab: int = 4233):
    """Seeded features f32[utts, frames, mel] (the first utterance full
    length, the others ``min_frames``-``frames`` long, zero past their
    end), their masks, and targets BOS ⧺ ``min_units``-``max_units`` units
    ⧺ EOS ⧺ PAD… as numpy arrays."""
    from opentransformer_tpu_torch.data import BOS, EOS

    rng = np.random.default_rng(seed)
    lens = rng.integers(min_frames, frames + 1, size=utts)
    lens[0] = frames
    mask = np.arange(frames)[None] < lens[:, None]
    feats = rng.normal(size=(utts, frames, mel)).astype(np.float32) * mask[..., None]
    units = rng.integers(min_units, max_units + 1, size=utts)
    targets = np.zeros((utts, int(units.max()) + 2), np.int64)
    targets[:, 0] = BOS
    for i, u in enumerate(units):
        targets[i, 1 : 1 + u] = rng.integers(3, vocab, size=u)
        targets[i, 1 + u] = EOS
    return feats, mask, targets


def checksum(arrays) -> float:
    """Sum of |x| over numpy arrays (or a nested dict of them), in float64:
    tells a changed random stream from a disagreeing model."""
    from opentransformer_tpu_torch import compat

    if hasattr(arrays, "items"):
        arrays = [leaf for _, leaf in compat._flatten(arrays)]
    return float(sum(np.abs(np.asarray(a, np.float64)).sum() for a in arrays))


def memory_probe(d_model: int, seed: int) -> np.ndarray:
    """A seeded unit vector f32[d_model] that the encoder memory is
    projected onto: one number a frame that moves with any of its channels."""
    u = np.random.default_rng(seed).normal(size=d_model)
    return (u / np.linalg.norm(u)).astype(np.float32)


def conformer_outputs(model, feats, mask, targets, steps: int, beam: int, probe_seed: int):
    """On the model's device: the encoder memory projected onto
    ``memory_probe`` (f32[B, T']) with its mask, the teacher-forced
    log-probs of ``targets`` (f32[B, U+1]; ``targets[:, :-1]`` in,
    ``targets[:, 1:]`` scored) and the beam-``beam`` 1-best ids over
    ``steps`` forced steps (EOS disabled, int[B, steps]), as numpy."""
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    dev = next(model.parameters()).device
    x, m, tg = (torch.from_numpy(a).to(dev) for a in (feats, mask, targets))
    with torch.inference_mode():
        memory, memory_mask = model.encode(x, m)
        probe = torch.from_numpy(memory_probe(memory.shape[-1], probe_seed)).to(dev)
        proj = memory.float() @ probe
        logits = model.decode_full(tg[:, :-1], memory, memory_mask)
        logp = torch.log_softmax(logits.float(), dim=-1).gather(-1, tg[:, 1:, None])[..., 0]
    hyp = make_memory_search(model, beam, steps, eos_id=-1)(memory, memory_mask)
    return {"memory": proj.cpu().numpy(), "memory_mask": memory_mask.cpu().numpy(),
            "logp": logp.cpu().numpy(), "ids": hyp.tokens[:, 0, 1:].cpu().numpy()}


def conformer_parity(out: dict, want: dict, rows: int | None = None) -> dict:
    """Against a fixture entry, over its first ``rows`` utterances (or all):
    the largest |Δ| of the memory projection over each utterance's frames
    (``memory``), of the log-probs over its target positions (``logp``),
    and the utterances whose 1-best ids differ (``ids_differ``), or whose
    encoder frame count does (``frames_differ``)."""
    got = {"memory": 0.0, "logp": 0.0, "ids_differ": 0, "frames_differ": 0}
    n = len(want["ids"]) if rows is None else rows
    for i in range(n):
        frames = int(out["memory_mask"][i].sum())
        mem = np.asarray(want["memory"][i], np.float32)
        got["frames_differ"] += int(frames != len(mem))
        got["memory"] = max(got["memory"], float(np.abs(out["memory"][i, : len(mem)] - mem).max()))
        lp = np.asarray(want["logp"][i], np.float32)
        got["logp"] = max(got["logp"], float(np.abs(out["logp"][i, : len(lp)] - lp).max()))
        got["ids_differ"] += int(out["ids"][i].tolist() != want["ids"][i])
    return got


def conformer_parity_ok(got: dict) -> bool:
    return (got["memory"] <= CONFORMER_MEMORY_ATOL and got["logp"] <= CONFORMER_LOGP_ATOL
            and got["ids_differ"] <= CONFORMER_ID_LIMIT and got["frames_differ"] == 0)


def load_conformer_fixture() -> dict:
    with open(CONFORMER_FIXTURE, encoding="utf-8") as f:
        return json.load(f)


def seeded_conformer(name: str, fixture: dict, device="cuda"):
    """The committed ``name`` config in float32 on ``device`` with the
    fixture's seeded weights; raises if the config or the weights' checksum
    differs from the fixture's."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    cfg = conformer_model_cfg(name)
    if cfg != fixture["configs"][name]:
        raise AssertionError(f"{name}: the committed config is not the fixture's")
    model = build_model(cfg, dtype=torch.float32, device=device)
    params = seeded_params(model, fixture["inputs"]["weights_seed"])
    got, want = checksum(params), fixture["checksums"]["weights"]
    if abs(got - want) > 1e-9 * want:
        raise AssertionError(f"{name}: the seeded weights' checksum {got!r} is not the "
                             f"fixture's {want!r} (numpy's random stream changed?)")
    return compat.load_into(model, params)


def fixture_inputs(fixture: dict):
    """The fixture's seeded features, masks and targets, checksum-checked."""
    c = fixture["inputs"]
    feats, mask, targets = conformer_inputs(
        c["inputs_seed"], c["utts"], c["frames"], c["min_frames"], c["min_units"],
        c["max_units"], c["mel"])
    got, want = checksum([feats]), fixture["checksums"]["feats"]
    if abs(got - want) > 1e-9 * want or checksum([targets]) != fixture["checksums"]["targets"]:
        raise AssertionError("the seeded inputs are not the fixture's (numpy's random stream "
                             "changed?)")
    return feats, mask, targets


def phase_conformer():
    """Phases 9a-9c (module docstring). Returns {path: kernel 1 launches}."""
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    fixture = load_conformer_fixture()
    c = fixture["inputs"]
    feats, mask, targets = fixture_inputs(fixture)
    launches = {}
    for name in CONFORMERS:
        model = seeded_conformer(name, fixture)
        project_logp_topk.launches = project2_logp_topk.launches = 0
        t0 = time.time()
        out = conformer_outputs(model, feats, mask, targets, c["steps"], c["beam"],
                                c["probe_seed"])
        one, two = project_logp_topk.launches, project2_logp_topk.launches
        got = conformer_parity(out, fixture["results"][name])
        ok = (conformer_parity_ok(got) and one == c["steps"] and two == 0
              and bool(np.isfinite(out["logp"]).all() and np.isfinite(out["memory"]).all()))
        log(f"phase9a {name} f32, seeded weights, {c['utts']} utterances of up to {c['frames']} "
            f"frames x {c['mel']} mel, against JAX: encoder memory (projected) max|d| "
            f"{got['memory']:.3e} (atol {CONFORMER_MEMORY_ATOL:.0e}; encoder frame counts differ "
            f"on {got['frames_differ']}), teacher-forced log-probs max|d| {got['logp']:.3e} (atol "
            f"{CONFORMER_LOGP_ATOL:.0e}), beam {c['beam']} 1-best ids over {c['steps']} forced "
            f"steps differ on {got['ids_differ']} <= {CONFORMER_ID_LIMIT} of {c['utts']}, kernel 1 "
            f"launches {one}, two-head {two}, wall {time.time() - t0:.1f} s "
            f"{'ok' if ok else 'FAIL'} [{card_line()}]")
        if not ok:
            raise AssertionError(f"phase9a {name}: a gate failed (see above)")
        launches[f"phase9a {name} decode"] = one
        if name == CONFORMERS[0]:
            small_input_check(f"phase9b {name} f32", model, feat_dim=c["mel"])
        del model

    model = seeded_model(conformer_model_cfg(CONFORMERS[0]), torch.bfloat16,
                         seed=c["weights_seed"])
    one, two, secs, _, _ = worst_case_decode(f"phase9c {CONFORMERS[0]}", model,
                                             feat_dim=c["mel"])
    if one != WORST_CASE["max_len"] or two != 0:
        raise AssertionError(f"phase9c: expected one one-head kernel launch per decode step "
                             f"({WORST_CASE['max_len']}) and no two-head launch, counted {one} "
                             f"and {two}")
    encode = worst_case_run(model, feat_dim=c["mel"], encode_only=True)
    encode()
    times = [host_seconds(encode) for _ in range(3)]
    enc = sorted(times)[1]
    log(f"phase9c {CONFORMERS[0]} encode alone (bf16, B={WORST_CASE['batch']} x "
        f"{WORST_CASE['frames']} frames): median {enc:.3f} s of {[round(t, 3) for t in times]}, "
        f"{100.0 * enc / secs:.1f}% of the decode's median {secs:.3f} s; the search "
        f"{secs - enc:.3f} s [{card_line()}]")
    launches[f"phase9c {CONFORMERS[0]} worst case"] = one
    return launches


def phase_conformer_train(workdir: str, paths: dict):
    """Phase 9d: ``conformer_baseline`` trained through the CLI on phase 7's
    corpus (``cli_train``). Returns the fbank launches."""
    _, _, launches = cli_train("phase9d", workdir, paths,
                               conf=os.path.join(CONF_DIR, "conformer_baseline.json"))
    return launches


# --------------------------------------------------------------- phase 10
def as_numpy(x) -> np.ndarray:
    """A tensor (any device or dtype) or an array → a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def stream_ctc_cfg() -> dict:
    """A ``ctc`` model of ``conformer_streaming``'s frontend and encoder."""
    cfg = conformer_model_cfg(STREAM_NAME)
    return {"type": "ctc", "frontend_type": cfg["frontend_type"], "frontend": cfg["frontend"],
            "encoder_type": cfg["encoder_type"], "encoder": cfg["encoder"],
            "vocab_size": cfg["decoder"]["vocab_size"], "lookahead_steps": 0}


def seeded_stream_ctc(device="cuda", dtype=torch.float32):
    """The ctc model of ``stream_ctc_cfg`` with seeded weights → (model,
    its JAX-layout params)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    model = build_model(stream_ctc_cfg(), dtype=dtype, device=device)
    params = seeded_params(model, STREAM_CTC_SEED)
    return compat.load_into(model, params), params


def long_form_inputs():
    """Two seeded utterances of 2,500-3,000 frames x 80 mel (the first
    3,000), zero past their end → (feats, mask)."""
    c = LONG_FORM
    feats, mask, _ = conformer_inputs(c["seed"], c["utts"], c["frames"], c["min_frames"], 8, 24,
                                      CONFORMER_INPUTS["mel"])
    return feats, mask


def load_stream_fixture() -> dict:
    with open(STREAM_FIXTURE, encoding="utf-8") as f:
        return json.load(f)


def staggered(ms, feats, mask):
    """Open one utterance a tick on the multi-stream server ``ms`` (of
    either package), push it whole and close it; tick until every stream is
    final. Returns ({utt: slot}, {utt: final text}). 16 utterances on 16
    slots: no slot is reused, and the rows stand at 16 different depths."""
    slots, finals = {}, {}
    lens = mask.sum(axis=1)
    i = 0
    while len(finals) < len(feats):
        if i < len(feats):
            slots[i] = ms.open_stream(f"u{i}", lambda _t: None,
                                      lambda t, _i=i: finals.__setitem__(_i, t))
            ms.push(slots[i], feats[i, : lens[i]])
            ms.close(slots[i])
            i += 1
        ms.tick()
    return slots, finals


def session_memory(model, feats, mask) -> list:
    """Each utterance alone through ``StreamingEncoderSession``: 64-frame
    feeds, then the tail → its streamed memory [T', D] (a tensor)."""
    from opentransformer_tpu_torch.recognize.online import StreamingEncoderSession

    sess = StreamingEncoderSession(model)
    rc = sess.raw_chunk
    if rc != STREAM_CHUNK_FRAMES:
        raise AssertionError(f"the streamed chunk is {rc} raw frames, not {STREAM_CHUNK_FRAMES}")
    out = []
    for i, n in enumerate(mask.sum(axis=1)):
        sess.reset()
        x = feats[i: i + 1, :n]
        full = n // rc
        for s in range(full):
            sess.feed(x[:, s * rc:(s + 1) * rc])
        mem, _ = sess.finish(x[:, full * rc:])
        out.append(mem[0])
    return out


def stream_outputs(model, ctc_model, feats, mask, probe, long_feats, long_mask) -> dict:
    """The port's streamed numbers on the models' device: memory projections
    through the session (``session``) and through ``MultiStreamAttention``
    with staggered slots (``multi``), the memories themselves, the
    ``MultiStreamCTC`` ids (``ctc``; with its tick count and kernel-1
    launches) and ``encode_windowed``'s projection (``long_form``)."""
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.multistream import MultiStreamAttention, MultiStreamCTC
    from opentransformer_tpu_torch.recognize.streaming import encode_windowed

    dev = next(model.parameters()).device
    pr = torch.from_numpy(probe).to(dev)
    mems = session_memory(model, feats, mask)
    out = {"session_mem": mems, "session": [as_numpy(m.float() @ pr) for m in mems]}
    project_logp_topk.launches = 0
    ms = MultiStreamAttention(model, n_streams=len(feats), **STREAM_SEARCH)
    slots, _ = staggered(ms, feats, mask)
    out["multi"] = [as_numpy(ms._mem[slots[i]].view().float() @ pr) for i in range(len(feats))]
    out["multi_launches"], out["multi_ticks"] = project_logp_topk.launches, ms.ticks
    project_logp_topk.launches = 0
    ms = MultiStreamCTC(ctc_model, n_streams=len(feats))
    _, finals = staggered(ms, feats, mask)
    out["ctc"] = [[int(x) for x in finals[i].split()] for i in range(len(feats))]
    out["ctc_launches"], out["ctc_ticks"] = project_logp_topk.launches, ms.ticks
    x = torch.from_numpy(long_feats).to(dev)
    lmem, lmask = encode_windowed(model, x, torch.from_numpy(long_mask.sum(axis=1)),
                                  LONG_FORM["window"], LONG_FORM["context"])
    proj = as_numpy(lmem.float() @ pr)
    out["long_form"] = [row[:n] for row, n in zip(proj, as_numpy(lmask).sum(axis=1).astype(int))]
    return out


def stream_parity(out: dict, fixture: dict) -> dict:
    """Against the stream fixture: the largest |Δ| of the session, the
    multi-stream and the long-form projections, the utterances whose frame
    counts differ, and the CTC id sequences that differ."""
    got = {"session": 0.0, "multi": 0.0, "long_form": 0.0, "frames_differ": 0, "ctc_differ": 0}
    for key, want in (("session", fixture["stream"]["memory"]),
                      ("multi", fixture["stream"]["memory"]),
                      ("long_form", fixture["long_form"]["memory"])):
        for mine, theirs in zip(out[key], want):
            theirs = np.asarray(theirs, np.float32)
            if len(mine) != len(theirs):
                got["frames_differ"] += 1
                continue
            got[key] = max(got[key], float(np.abs(mine - theirs).max()))
    got["ctc_differ"] = sum(a != b for a, b in zip(out["ctc"], fixture["ctc"]["ids"]))
    return got


def stream_parity_ok(got: dict) -> bool:
    return (max(got["session"], got["multi"], got["long_form"]) <= STREAM_MEMORY_ATOL
            and got["frames_differ"] == 0 and got["ctc_differ"] <= STREAM_CTC_ID_LIMIT)


@torch.inference_mode()
def offline_ctc_ids(ctc_model, feats, mask) -> list:
    """The offline greedy of each utterance at its own length, as
    ``CTCRecognizer`` decodes it (``recognize_argmax``, then the collapse);
    a padded batch would count one frame more for some lengths."""
    from opentransformer_tpu_torch.recognize.ctc_decode import ctc_collapse_ids

    dev = next(ctc_model.parameters()).device
    ids = []
    for i, n in enumerate(mask.sum(axis=1)):
        frame_ids, frame_mask = ctc_model.recognize_argmax(
            torch.from_numpy(feats[i: i + 1, :n]).to(dev),
            torch.ones((1, n), dtype=torch.bool, device=dev))
        toks, lens = ctc_collapse_ids(frame_ids, frame_mask)
        ids.append(toks[0, : int(lens[0])].tolist())
    return ids


@torch.inference_mode()
def offline_memory_err(model, feats, mask, streamed) -> float:
    """The largest |Δ| between each utterance's streamed memory and the
    port's offline chunk-masked encode of that utterance at its length."""
    dev = next(model.parameters()).device
    err = 0.0
    for i, n in enumerate(mask.sum(axis=1)):
        mem, mm = model.encode(torch.from_numpy(feats[i: i + 1, :n]).to(dev),
                               torch.ones((1, n), dtype=torch.bool, device=dev))
        t = int(mm.sum())
        if t != streamed[i].shape[0]:
            raise AssertionError(f"utterance {i}: offline encode has {t} frames, the stream "
                                 f"{streamed[i].shape[0]}")
        err = max(err, (mem[0, :t].float() - streamed[i].float()).abs().max().item())
    return err


def read_units(path: str) -> dict:
    """{utt: units} of a ``text`` file."""
    with open(path, encoding="utf-8") as f:
        return {p[0]: p[1:] for p in (line.split() for line in f) if p}


def batcher_decode(tag: str, data: str, recognizer, out: str) -> dict:
    """The anchor split's 500 utterances submitted at once to the port's
    ``DynamicBatcher`` (phase 2's beam, penalty and -ml 32) → CER, ids off
    the JAX fixture, launches and ``stats()``; writes ``out/predict.txt``."""
    from opentransformer_tpu_torch.cli.serve import DynamicBatcher, _Request
    from opentransformer_tpu_torch.data import UNK, load_idx2unit_map, load_vocab
    from opentransformer_tpu_torch.data.kaldi_io import load_mat, read_scp
    from opentransformer_tpu_torch.ops.levenshtein import ErrorRateAccumulator
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    b = BATCHER
    dev = next(recognizer.model.parameters()).device
    batcher = DynamicBatcher(recognizer, b["buckets"], max_batch=b["max_batch"],
                             timeout_ms=b["timeout_ms"])
    scp = read_scp(os.path.join(data, "test", "feats.scp"))
    feats = {utt: load_mat(rx) for utt, rx in scp.items()}
    batcher.set_n_feat(next(iter(feats.values())).shape[1])
    texts, lock = {}, threading.Lock()

    def reply(utt, text):
        with lock:
            texts[utt] = text

    project_logp_topk.launches = project2_logp_topk.launches = 0
    t0 = time.time()
    batcher.start()
    for utt, x in feats.items():
        batcher.submit(_Request(utt, x, reply))
    batcher.drain_and_stop()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    one, two = project_logp_topk.launches, project2_logp_topk.launches
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "predict.txt"), "w", encoding="utf-8") as f:
        for utt in feats:
            f.write(f"{utt} {texts[utt]}\n")
    vocab = os.path.join(data, "vocab")
    unit2idx, idx2unit = load_vocab(vocab), load_idx2unit_map(vocab)
    refs = read_units(os.path.join(data, "test", "text"))
    cer = ErrorRateAccumulator()
    for utt in feats:
        cer.update([idx2unit.get(unit2idx.get(u, UNK), "<UNK>") for u in refs[utt]],
                   texts[utt].split())
    differ = ids_differing_from_jax(out, vocab)
    stats = batcher.stats()
    log(f"{tag}: {len(texts)} requests in {stats['batches']} batches of {b['max_batch']} rows "
        f"(buckets {list(b['buckets'])}), CER {cer.rate * 100:.2f}% ({cer.errors}/{cer.tokens}), "
        f"1-best ids differ from the JAX package's on {differ} of 500, kernel launches one-head "
        f"{one} two-head {two}, stats {stats}, wall {wall:.1f} s "
        f"[{card_line() if dev.type == 'cuda' else 'cpu'}]")
    return {"cer": cer.rate * 100, "differ": differ, "one": one, "two": two, "stats": stats}


def pcm_client(port: int, utt: str, wav: np.ndarray, frame: int, timeout: float) -> list:
    """Stream int16 ``wav`` to the server as PCM frames of ``frame`` samples
    and the end frame; returns the server's lines for the stream."""
    import socket
    import struct

    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(f"PCM {utt} 16000\n".encode())
        for s in range(0, len(wav), frame):
            data = wav[s: s + frame].astype("<i2").tobytes()
            sock.sendall(struct.pack("<I", len(data)) + data)
        sock.sendall(struct.pack("<I", 0))
        lines, buf = [], b""
        while not any(line.split("\t")[1] == "FINAL" for line in lines):
            more = sock.recv(65536)
            if not more:
                raise AssertionError(f"{utt}: the server closed the connection before FINAL")
            buf += more
            *done, buf = buf.split(b"\n")
            lines += [d.decode() for d in done]
        return lines


def pcm_features(extractor, wav: np.ndarray, frame: int) -> np.ndarray:
    """The features the server makes of ``wav`` sent in frames of ``frame``
    samples: ``StreamingFbank`` fed the same frames, then finished."""
    from opentransformer_tpu_torch.cli.serve import StreamingFbank

    sfe = StreamingFbank(extractor, 16000.0)
    parts = [sfe.feed(wav[s: s + frame].astype(np.float32) / 32768.0)
             for s in range(0, len(wav), frame)]
    return np.concatenate(parts + [sfe.finish()], axis=0)


def stream_data_cfg(vocab: str) -> dict:
    """The data section of the committed ``conformer_streaming`` config
    that features depend on (80 mel, per-utterance CMVN), with ``vocab``."""
    with open(os.path.join(CONF_DIR, f"{STREAM_NAME}.json"), encoding="utf-8") as f:
        data = json.load(f)["data"]
    return {"num_mel_bins": data["num_mel_bins"], "normalization": data["normalization"],
            "vocab": vocab}


def start_server(argv: list) -> tuple:
    """``serve.main(argv)`` in a thread; returns (server, thread, result
    dict) once the server is bound. Whatever ``main`` raises lands in
    ``result["error"]``, for the caller to raise."""
    from opentransformer_tpu_torch.cli import serve

    server, result = {}, {}
    ready = threading.Event()

    def on_ready(srv):
        server["srv"] = srv
        ready.set()

    def run():
        try:
            result["rc"] = serve.main(argv, on_ready=on_ready)
        except BaseException as e:  # the caller raises it
            result["error"] = e
            ready.set()

    thread = threading.Thread(target=run)
    thread.start()
    if not ready.wait(300) or "error" in result:
        thread.join(60)
        raise AssertionError("the server did not start") from result.get("error")
    return server["srv"], thread, result


def phase_pcm(workdir: str, corpus: dict, device: str = "cuda") -> int:
    """10e: the serve CLI with ``--streaming`` on the ctc model of 10b; 8
    concurrent PCM clients; each FINAL against an in-process ``run_stream``
    over the same ``StreamingFbank`` features. Returns kernel-1 launches."""
    _, params = seeded_stream_ctc(device="cpu")
    return pcm_check("phase10e", workdir, "stream_ctc", params, stream_ctc_cfg(),
                     stream_data_cfg(corpus["vocab"]), corpus, PCM["clients"], device)


def pcm_check(tag: str, workdir: str, name: str, params: dict, model_cfg: dict, data_cfg: dict,
              corpus: dict, clients: int, device: str = "cuda") -> int:
    """The serve CLI with ``--streaming --streams PCM["streams"]`` on ``params``
    saved as ``name``.npz + JSON; ``clients`` concurrent PCM clients send
    phase 7's training wavs in 100 ms frames;
    each FINAL is held to an in-process ``run_stream`` over the same
    ``StreamingFbank`` features, and every slot must be free after. Returns
    kernel-1 launches."""
    import scipy.io.wavfile as siw

    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.cli import serve
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    npz, cfg_path = os.path.join(workdir, f"{name}.npz"), os.path.join(workdir, f"{name}.json")
    compat.save_npz(npz, params, dtype=np.float32)
    with open(cfg_path, "w") as f:
        json.dump({"data": data_cfg, "model": model_cfg}, f)
    with open(corpus["train"][0]) as f:
        wavs = [line.split()[1] for line in f][:clients]
    project_logp_topk.launches = 0
    srv, thread, result = start_server(["--npz", npz, "--model_cfg", cfg_path, "--streaming",
                                        "--streams", str(PCM["streams"]), "--port", "0",
                                        "--device", device])
    frame = 16000 * PCM["frame_ms"] // 1000
    audio = [siw.read(p)[1] for p in wavs]
    lines = [None] * len(wavs)
    errors = []

    def client(i):
        try:
            lines[i] = pcm_client(srv.server_address[1], f"pcm{i}", audio[i], frame,
                                  PCM["timeout_s"])
        except BaseException as e:  # the phase raises it below
            errors.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(wavs))]
    for c in threads:
        c.start()
    for c in threads:
        c.join(PCM["timeout_s"])
    wall = time.time() - t0
    launches = project_logp_topk.launches
    try:
        if errors or any(x is None for x in lines):
            raise AssertionError(f"{tag}: a PCM client failed") from (errors[0] if errors
                                                                      else None)
        front = srv.front
        extractor = serve.FeatureExtractor(data_cfg)
        bad, partials = [], 0
        for i, got in enumerate(lines):
            kinds = [line.split("\t")[1] for line in got]
            finals = [line.split("\t", 2)[2] for line in got if line.split("\t")[1] == "FINAL"]
            want = front.run_stream(pcm_features(extractor, audio[i], frame), lambda _t: None)
            partials += kinds.count("PARTIAL")
            if finals != [want] or kinds[-1] != "FINAL":
                bad.append((i, finals, want))
        free = front.ms.free_slots()
    finally:
        srv.shutdown()
        thread.join(60)
    if "error" in result:
        raise AssertionError(f"{tag}: the server failed") from result["error"]
    seconds = sum(len(a) for a in audio) / 16000.0
    ok = (not bad and partials > 0 and free == PCM["streams"] and result["rc"] == 0
          and (launches > 0) == (device == "cuda"))
    log(f"{tag} PCM over TCP ({model_cfg['type']}): {len(wavs)} concurrent clients on "
        f"{PCM['streams']} slots, {seconds:.1f} s of audio in {PCM['frame_ms']} ms frames, wall "
        f"{wall:.1f} s; FINALs equal to in-process run_stream over the same StreamingFbank "
        f"features on {len(wavs) - len(bad)} of {len(wavs)} {bad[:1]}, {partials} PARTIAL lines, "
        f"each stream's FINAL last, free slots after {free} of {PCM['streams']}, kernel 1 "
        f"launches {launches}, server exit {result['rc']} {'ok' if ok else 'FAIL'} "
        f"[{card_line() if device == 'cuda' else device}]")
    if not ok:
        raise AssertionError(f"{tag}: a gate failed (see above)")
    return launches


def stream_load(tag: str, ms, feats) -> dict:
    """10f: every slot of ``ms`` gets one of ``feats`` whole and closed at
    once; ticks run until all are final. Host-clock tick times (each tick
    ends in a copy to the host), the encoder step's share (CUDA events
    around ``_encode``, read after the run: no host synchronize inside a
    tick), RTFx and peak memory."""
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    encode = ms._encode
    spans = []

    def timed_encode(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = encode(*args)
        end.record()
        spans.append((start, end))
        return y

    ms._encode = timed_encode
    finals = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    project_logp_topk.launches = 0
    ticks = []
    t0 = time.perf_counter()
    for i, x in enumerate(feats):
        slot = ms.open_stream(f"u{i}", lambda _t: None, lambda t, _i=i: finals.__setitem__(_i, t))
        ms.push(slot, x)
        ms.close(slot)
    while len(finals) < len(feats):
        t = time.perf_counter()
        if ms.tick() == 0:
            raise AssertionError(f"{tag}: a tick advanced no stream before every FINAL")
        ticks.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = project_logp_topk.launches
    del ms._encode
    audio = sum(x.shape[0] for x in feats) * 0.01
    got = {"ticks": len(ticks), "tick_ms_median": float(np.median(ticks)) * 1e3,
           "tick_ms_p95": float(np.percentile(ticks, 95)) * 1e3,
           "chunks_per_s": ms.chunks_advanced / wall, "rtfx": audio / wall, "wall_s": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "launches": launches,
           "launches_per_tick": launches / len(ticks),
           "encode_share": sum(a.elapsed_time(b) for a, b in spans) / 1e3 / sum(ticks)}
    log(f"{tag}: {len(feats)} slots x {feats[0].shape[0] * 0.01:.0f} s, {got['ticks']} ticks, "
        f"tick median {got['tick_ms_median']:.2f} ms p95 {got['tick_ms_p95']:.2f} ms, "
        f"{got['chunks_per_s']:.1f} chunks/s, RTFx {got['rtfx']:.1f} ({audio:.0f} s of audio in "
        f"{wall:.2f} s), peak memory {got['peak_gib']:.2f} GiB, kernel 1 launches {launches} "
        f"({got['launches_per_tick']:.2f} a tick), encoder step {100 * got['encode_share']:.1f}% "
        f"of the tick time, the rest the head (CTC top-1 and collapse, the beam re-decode, or "
        f"the transducer's greedy lattice walk) "
        f"[{card_line()}]")
    return got


def phase_streaming(workdir: str, data: str, corpus: dict):
    """Phase 10 (module docstring). Returns ({path: kernel 1 launches}, the
    two-head launches of 10d with the LM)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.data import load_idx2unit_map
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer
    from opentransformer_tpu_torch.recognize.multistream import MultiStreamAttention, MultiStreamCTC
    from opentransformer_tpu_torch.recognize.streaming import LongFormRecognizer

    t_phase = time.time()
    offline = load_conformer_fixture()
    fixture = load_stream_fixture()
    feats, mask, _ = fixture_inputs(offline)
    probe = memory_probe(384, offline["inputs"]["probe_seed"])
    model = seeded_conformer(STREAM_NAME, offline)
    ctc_model, ctc_params = seeded_stream_ctc()
    want = fixture["checksums"]["ctc_weights"]
    if abs(checksum(ctc_params) - want) > 1e-9 * want:
        raise AssertionError("phase10: the seeded ctc weights are not the fixture's")
    long_feats, long_mask = long_form_inputs()
    want = fixture["checksums"]["long_feats"]
    if abs(checksum([long_feats]) - want) > 1e-9 * want:
        raise AssertionError("phase10: the long-form inputs are not the fixture's")
    launches = {}

    # 10a-c: the streamed numbers against JAX's and the port's offline ones
    out = stream_outputs(model, ctc_model, feats, mask, probe, long_feats, long_mask)
    got = stream_parity(out, fixture)
    off_err = offline_memory_err(model, feats, mask, out["session_mem"])
    ok = (max(got["session"], got["multi"]) <= STREAM_MEMORY_ATOL and got["frames_differ"] == 0
          and off_err <= STREAM_OFFLINE_ATOL and out["multi_launches"] > 0)
    log(f"phase10a {STREAM_NAME} f32 streamed, 16 utterances in {STREAM_CHUNK_FRAMES}-frame feeds "
        f"+ tail: memory projection vs JAX's streamed one, through StreamingEncoderSession max|d| "
        f"{got['session']:.3e}, through MultiStreamAttention (16 slots opened on 16 ticks, "
        f"{out['multi_ticks']} ticks) {got['multi']:.3e} (atol {STREAM_MEMORY_ATOL:.0e}; frame "
        f"counts differ on {got['frames_differ']}); streamed memory vs the port's offline "
        f"chunk-masked encode max|d| {off_err:.3e} (atol {STREAM_OFFLINE_ATOL:.0e}); kernel 1 "
        f"launches {out['multi_launches']} (the FINALs' beam) {'ok' if ok else 'FAIL'} "
        f"[{card_line()}]")
    if not ok:
        raise AssertionError("phase10a: a gate failed (see above)")
    launches["phase10a multi-stream attention FINALs (k=5)"] = out["multi_launches"]
    offline_ids = offline_ctc_ids(ctc_model, feats, mask)
    off_differ = sum(a != b for a, b in zip(out["ctc"], offline_ids))
    ok = (got["ctc_differ"] <= STREAM_CTC_ID_LIMIT and off_differ == 0
          and out["ctc_launches"] == out["ctc_ticks"])
    log(f"phase10b MultiStreamCTC, 16 staggered slots: ids differ from JAX's on "
        f"{got['ctc_differ']} <= {STREAM_CTC_ID_LIMIT} of 16, from the port's offline greedy on "
        f"{off_differ} of 16 (lengths {[len(x) for x in out['ctc']]}), kernel 1 launches "
        f"{out['ctc_launches']} = ticks {out['ctc_ticks']} (k=1, N = 16 slots x 16 frames) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase10b: a gate failed (see above)")
    launches["phase10b multi-stream CTC (k=1)"] = out["ctc_launches"]
    c = LONG_FORM
    rec = LongFormRecognizer(model, beam_width=c["beam"], max_len=c["steps"], eos_id=-1,
                             window=c["window"], context=c["context"])
    project_logp_topk.launches = 0
    hyp = rec.recognize_arrays(torch.from_numpy(long_feats).cuda(),
                               torch.from_numpy(long_mask).cuda())
    n_long = project_logp_topk.launches
    ok = (got["long_form"] <= STREAM_MEMORY_ATOL and n_long == c["steps"]
          and bool(torch.isfinite(hyp.scores).all()))
    log(f"phase10c LongFormRecognizer (window {c['window']}, context {c['context']}), 2 "
        f"utterances of {long_mask.sum(axis=1).tolist()} frames: windowed memory projection vs "
        f"JAX max|d| {got['long_form']:.3e} (atol {STREAM_MEMORY_ATOL:.0e}), beam {c['beam']} over "
        f"{c['steps']} forced steps: kernel 1 launches {n_long} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase10c: a gate failed (see above)")
    launches["phase10c long-form decode (k=5)"] = n_long
    log(f"phase10a-c wall {time.time() - t_phase:.1f} s")
    del model, ctc_model, out, rec

    # 10d: the anchor through the batcher, without and with an LM at -lmw 0.0
    with open(ANCHOR + ".manifest.json", encoding="utf-8") as f:
        anchor = compat.load_into(build_model(json.load(f)["model_cfg"]),
                                  compat.load_npz(ANCHOR + ".npz"))
    idx2unit = load_idx2unit_map(os.path.join(data, "vocab"))
    rec = SpeechToTextRecognizer(anchor, beam_width=5, max_len=32, penalty=0.6, idx2unit=idx2unit)
    res = batcher_decode("phase10d anchor f32 through the DynamicBatcher", data, rec,
                         os.path.join(workdir, "batcher"))
    lm = build_model(ANCHOR_LM_CFG)
    compat.load_into(lm, seeded_params(lm, seed=11, embedding_std=ANCHOR_LM_CFG["d_model"] ** -0.5))
    rec = SpeechToTextRecognizer(anchor, lm=lm, beam_width=5, max_len=32, penalty=0.6,
                                 lm_weight=0.0, idx2unit=idx2unit)
    res_lm = batcher_decode("phase10d anchor f32 + random transformer LM at -lmw 0.0 through the "
                            "DynamicBatcher", data, rec, os.path.join(workdir, "batcher_lm"))
    ok = (max(res["cer"], res_lm["cer"]) <= ANCHOR_CER_LIMIT
          and max(res["differ"], res_lm["differ"]) <= ANCHOR_ID_LIMIT
          and res["one"] > 0 and res["two"] == 0 and res_lm["two"] > 0 and res_lm["one"] == 0)
    log(f"phase10d gates (without / with the LM): CER {res['cer']:.2f}% / {res_lm['cer']:.2f}% <= "
        f"{ANCHOR_CER_LIMIT}%, ids off JAX {res['differ']} / {res_lm['differ']} <= "
        f"{ANCHOR_ID_LIMIT} of 500, launches one-head {res['one']} / {res_lm['one']}, two-head "
        f"{res['two']} / {res_lm['two']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase10d: a gate failed (see above)")
    launches["phase10d batcher, anchor (k=5)"] = res["one"]
    del anchor, lm, rec

    # 10e: PCM clients against the serve CLI
    launches["phase10e PCM over TCP, streamed CTC (k=1)"] = phase_pcm(workdir, corpus)

    # 10f: 32 slots of 20 s at full width in bf16
    c = STREAM_LOAD
    rng = np.random.default_rng(c["seed"])
    load = [rng.normal(size=(int(c["seconds"] * 100), CONFORMER_INPUTS["mel"])).astype(np.float32)
            for _ in range(c["slots"])]
    ctc16 = seeded_stream_ctc(dtype=torch.bfloat16)[0]
    ctc_load = stream_load("phase10f MultiStreamCTC bf16", MultiStreamCTC(ctc16, c["slots"]), load)
    del ctc16
    s2t16 = seeded_model(conformer_model_cfg(STREAM_NAME), torch.bfloat16,
                         seed=offline["inputs"]["weights_seed"])
    att = MultiStreamAttention(s2t16, c["slots"], beam_width=c["beam"], max_len=c["max_len"],
                               partial_every=c["partial_every"], eos_id=-1)
    att_load = stream_load(f"phase10f MultiStreamAttention bf16 (beam {c['beam']}, -ml "
                           f"{c['max_len']} forced, partial_every {c['partial_every']})", att, load)
    if ctc_load["launches"] != ctc_load["ticks"] or att_load["launches"] == 0:
        raise AssertionError("phase10f: expected one kernel-1 launch a CTC tick and a launch in "
                             "every attention re-decode step")
    launches["phase10f throughput, multi-stream CTC (k=1)"] = ctc_load["launches"]
    launches["phase10f throughput, multi-stream attention (k=5)"] = att_load["launches"]
    log(f"phase10 wall {time.time() - t_phase:.1f} s")
    return launches, res_lm["two"]


# --------------------------------------------------------------- phase 11
def load_transducer_fixture() -> dict:
    with open(TRANSDUCER_FIXTURE, encoding="utf-8") as f:
        return json.load(f)


def seeded_transducer_params(model, seed: int, blank_bias: float,
                             joint_scale: float = 1.0) -> dict:
    """``seeded_params`` of a transducer with the joint's output kernel
    scaled by ``joint_scale``, then its blank bias raised by ``blank_bias``
    (``TRANSDUCER_INPUTS``)."""
    from opentransformer_tpu_torch.data import BLK

    params = seeded_params(model, seed)
    dense = params["params"]["joint"]["output_layer"]["dense"]
    dense["kernel"] *= np.float32(joint_scale)
    dense["bias"][BLK] += np.float32(blank_bias)
    return params


def beam_holds_labels(best: list) -> bool:
    """11b's coverage gate on the beam 1-bests' lengths ``best``."""
    return (sum(n > 0 for n in best) >= TRANSDUCER_BEAM_LABELLED
            and max(best) >= TRANSDUCER_BEAM_LONGEST)


def seeded_transducer(name: str, c: dict, device="cuda", dtype=torch.float32, want=None):
    """The committed ``name`` config on ``device`` with the seeded weights
    of ``c`` (``TRANSDUCER_INPUTS`` or a fixture's inputs) → (model, its
    JAX-layout params); with ``want`` (a fixture) the config and the
    weights' checksum must be the fixture's."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    cfg = conformer_model_cfg(name)
    model = build_model(cfg, dtype=dtype, device=device)
    params = seeded_transducer_params(model, c["weights_seed"], c["blank_bias"],
                                      c["joint_scale"])
    if want is not None:
        got, sum_want = checksum(params), want["checksums"]["weights"]
        if cfg != want["configs"][name] or abs(got - sum_want) > 1e-9 * sum_want:
            raise AssertionError(f"{name}: the committed config or the seeded weights' checksum "
                                 f"{got!r} is not the fixture's {sum_want!r}")
    return compat.load_into(model, params), params


def seeded_lm(kind: str, c: dict, device="cuda"):
    """The LM of ``TRANSDUCER_LMS[kind]`` with seeded weights (a transformer
    LM's tied embedding at std d^-1/2, as phase 4's) → (lm, params)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    cfg = TRANSDUCER_LMS[kind]
    lm = build_model(cfg, device=device)
    std = cfg["d_model"] ** -0.5 if kind == "transformer_lm" else 1.0
    params = seeded_params(lm, c[f"{kind}_seed"], embedding_std=std)
    return compat.load_into(lm, params), params


def transducer_inputs(c: dict):
    """16 seeded utterances of 300-500 frames x 40 mel, masks and targets
    (``conformer_inputs`` at ``c``'s seeds and sizes)."""
    return conformer_inputs(c["inputs_seed"], c["utts"], c["frames"], c["min_frames"],
                            c["min_units"], c["max_units"], c["mel"])


def lattice_path(frames: int, units: int) -> list:
    """A monotone path through the lattice: label u at frame u·frames//units."""
    return [(u * frames // units, u) for u in range(units)]


def path_logp(logp, labels, frames: int) -> list:
    """Joint log-probs f32[T, U+1, V] of one utterance → along
    ``lattice_path``: each label's and the blank's at its point, then the
    final blank at (T − 1, U)."""
    out = []
    for t, u in lattice_path(frames, len(labels)):
        out += [float(logp[t, u, labels[u]]), float(logp[t, u, 0])]
    return out + [float(logp[frames - 1, len(labels), 0])]


def target_units(targets) -> list:
    """The label count of each BOS ⧺ y ⧺ EOS ⧺ PAD row (EOS not counted)."""
    return [int(u) for u in ((np.asarray(targets)[:, 1:] != 0).sum(axis=1) - 1)]


def transducer_outputs(model, feats, mask, targets, c: dict) -> dict:
    """On the model's device: the encoder memory projected on
    ``memory_probe`` with its mask, each utterance's teacher-forced joint
    log-probs along ``lattice_path`` (``path_logp``; its joint alone, at its
    own frames), the greedy ids (``max_symbols``, ``max_per_frame`` of
    ``c``) and the greedy loop's iterations, as numpy / lists."""
    dev = next(model.parameters()).device
    x, m, tg = (torch.from_numpy(a).to(dev) for a in (feats, mask, targets))
    units = target_units(targets)
    with torch.inference_mode():
        memory, memory_mask = model.encode(x, m)
        probe = torch.from_numpy(memory_probe(memory.shape[-1], c["probe_seed"])).to(dev)
        proj = memory.float() @ probe
        frames = memory_mask.sum(dim=1).tolist()
        logp = []
        for i, (n, u) in enumerate(zip(frames, units)):
            logits = model.joint(memory[i: i + 1, :n], model.predictor(tg[i: i + 1, : u + 1]))
            lp = torch.log_softmax(logits, dim=-1)[0].cpu().numpy()
            logp.append(path_logp(lp, targets[i, 1: 1 + u], n))
    it0 = model.greedy_iterations
    tokens, n = model.greedy_decode(x, m, c["max_symbols"], c["max_per_frame"])
    tokens, n = tokens.cpu().numpy(), n.cpu().numpy()
    return {"memory": proj.cpu().numpy(), "memory_mask": memory_mask.cpu().numpy(),
            "logp": logp, "greedy": [tokens[i, : n[i]].tolist() for i in range(len(n))],
            "iterations": model.greedy_iterations - it0}


def transducer_parity(out: dict, want: dict) -> dict:
    """Against a fixture entry: the largest |Δ| of the memory projection
    over each utterance's frames and of the path log-probs, and the
    utterances whose frame count or greedy ids differ."""
    got = {"memory": 0.0, "logp": 0.0, "ids_differ": 0, "frames_differ": 0}
    for i, mem in enumerate(want["memory"]):
        mem = np.asarray(mem, np.float32)
        got["frames_differ"] += int(int(out["memory_mask"][i].sum()) != len(mem))
        got["memory"] = max(got["memory"], float(np.abs(out["memory"][i, : len(mem)] - mem).max()))
        got["logp"] = max(got["logp"], float(np.abs(np.asarray(out["logp"][i])
                                                    - np.asarray(want["logp"][i])).max()))
        got["ids_differ"] += int(out["greedy"][i] != want["greedy"][i])
    return got


def transducer_beam(model, feats, mask, c: dict, lm=None) -> dict:
    """Beam ``c["beam"]``, ``c["expansions"]`` a frame, at most
    ``beam_max_symbols`` tokens, with ``lm`` fused at ``lm_weight`` if given
    → {"ids": [utt][hyp] id lists, "scores": [utt][hyp]}, best first."""
    from opentransformer_tpu_torch.recognize.base import make_lm_adapter

    dev = next(model.parameters()).device
    lm_init, lm_step = make_lm_adapter(lm, c["beam_max_symbols"])
    tokens, lens, scores = model.beam_decode(
        torch.from_numpy(feats).to(dev), torch.from_numpy(mask).to(dev), c["beam"],
        c["beam_max_symbols"], c["expansions"], lm_init, lm_step,
        c["lm_weight"] if lm is not None else 0.0)
    tokens, lens = tokens.cpu().numpy(), lens.cpu().numpy()
    return {"ids": [[tokens[i, j, : lens[i, j]].tolist() for j in range(tokens.shape[1])]
                    for i in range(tokens.shape[0])],
            "scores": scores.float().cpu().numpy().tolist()}


def beam_parity(got: dict, want: dict) -> dict:
    """Utterances whose 1-best ids (``best_differ``) or whose n-best id
    lists (``nbest_differ``) differ, the largest relative score difference
    over hypotheses present in both n-best lists (``score_rtol``), and the
    utterances whose scores are not sorted (``unsorted``)."""
    out = {"best_differ": 0, "nbest_differ": 0, "score_rtol": 0.0, "unsorted": 0}
    for ids, scores, wids, wscores in zip(got["ids"], got["scores"], want["ids"],
                                          want["scores"]):
        out["best_differ"] += int(ids[0] != wids[0])
        out["nbest_differ"] += int(ids != wids)
        out["unsorted"] += int(scores != sorted(scores, reverse=True))
        for j, hyp in enumerate(wids):
            if hyp in ids:
                g = scores[ids.index(hyp)]
                out["score_rtol"] = max(out["score_rtol"],
                                        abs(g - wscores[j]) / max(abs(wscores[j]), 1e-30))
    return out


def feed_stream(rec, x) -> list:
    """One utterance [1, T, F] through a streaming recognizer of either
    package in ``raw_chunk``-frame feeds and the tail → its ids."""
    rec.reset()
    rc = rec.session.raw_chunk
    full = x.shape[1] // rc
    for s in range(full):
        rec.feed(x[:, s * rc:(s + 1) * rc])
    rec.finish(x[:, full * rc:])
    return list(rec.tokens[0])


def streamed_transducer_ids(rec, feats, mask) -> list:
    """Each utterance alone through ``rec`` (a StreamingTransducerRecognizer
    of either package, batch 1)."""
    return [feed_stream(rec, feats[i: i + 1, :n]) for i, n in enumerate(mask.sum(axis=1))]


def offline_transducer_ids(model, feats, mask, c: dict) -> list:
    """The port's offline greedy ids of each utterance encoded alone at its
    own length (the streamed frame count; chunk-masked for a chunked
    encoder)."""
    dev = next(model.parameters()).device
    out = []
    for i, n in enumerate(mask.sum(axis=1)):
        x = torch.from_numpy(feats[i: i + 1, :n]).to(dev)
        tokens, k = model.greedy_decode(x, torch.ones(x.shape[:2], dtype=torch.bool, device=dev),
                                        c["max_symbols"], c["max_per_frame"])
        out.append(tokens[0, : int(k[0])].tolist())
    return out


def multistream_reuse(ms, feats, mask, again: int = 0):
    """The utterances opened one a tick on the multi-stream server ``ms``
    (pushed whole and closed), then utterance ``again`` once more as soon
    as a slot frees, so that a slot takes a second stream; ticks until
    every stream is final. Returns ({key: slot}, {key: final text}), the
    second stream under key ``"again"``."""
    lens = mask.sum(axis=1)
    queue = [(i, i) for i in range(len(feats))] + [("again", again)]
    slots, finals = {}, {}
    while len(finals) < len(queue):
        if len(slots) < len(queue):
            key, i = queue[len(slots)]
            slot = ms.open_stream(f"u{key}", lambda _t: None,
                                  lambda t, _k=key: finals.__setitem__(_k, t), timeout=0)
            if slot is not None:
                slots[key] = slot
                ms.push(slot, feats[i, : lens[i]])
                ms.close(slot)
        ms.tick()
    return slots, finals


def transducer_cli(tag: str, workdir: str, corpus: dict, params: dict, cfg: dict,
                   device: str = "cuda"):
    """11d (eval): the dev split of phase 7's corpus (16 wavs of 2-10 s) as
    40-mel features (the serve CLI's extractor with the config's data
    section) in a kaldi ark; the seeded transducer saved as npz + JSON;
    ``cli/eval.py -bw 1`` (greedy) and ``-bw 4`` (beam), each ``predict.txt``
    held to an in-process ``build_recognizer`` decode of the same batches.
    Returns the greedy run's kernel-1 launches."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.cli import serve
    from opentransformer_tpu_torch.data import load_idx2unit_map
    from opentransformer_tpu_torch.data.kaldi_io import load_mat, read_scp, write_ark
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.base import build_recognizer

    root = os.path.join(workdir, "transducer_cli")
    os.makedirs(root, exist_ok=True)
    extractor = serve.FeatureExtractor(cfg["data"])
    with open(corpus["dev"][0]) as f:
        wavs = [line.split() for line in f if line.strip()]
    scp = os.path.join(root, "feats.scp")
    write_ark(os.path.join(root, "feats.ark"), {u: extractor(p) for u, p in wavs}, scp)
    npz, cfg_path = os.path.join(root, "transducer.npz"), os.path.join(root, "transducer.json")
    compat.save_npz(npz, params, dtype=np.float32)
    with open(cfg_path, "w") as f:
        json.dump({"model": cfg["model"]}, f)
    model = compat.load_into(build_model(cfg["model"], device=device), params)
    idx2unit = load_idx2unit_map(corpus["vocab"])
    feats = [(u, load_mat(rx)) for u, rx in read_scp(scp).items()]
    batch, launches = 8, 0
    for bw in (1, 4):
        out = os.path.join(root, f"decode_bw{bw}")
        project_logp_topk.launches = 0
        rc = eval_cli.main(["--npz", npz, "--model_cfg", cfg_path, "--feats", scp,
                            "--text", corpus["dev"][1], "--vocab", corpus["vocab"],
                            "-b", str(batch), "-bw", str(bw), "--decode_dir", out,
                            "--device", device])
        cli_launches = project_logp_topk.launches
        with open(os.path.join(out, "predict.txt"), encoding="utf-8") as f:
            got = [line.rstrip("\n") for line in f]
        rec = build_recognizer("transducer", model, args={"beam_width": bw, "max_len": 100},
                               idx2unit=idx2unit)
        want = []
        for s in range(0, len(feats), batch):
            chunk = feats[s: s + batch]
            x, m, _ = eval_cli.collate([a for _, a in chunk])
            texts, _ = rec.recognize(torch.from_numpy(x).to(device), torch.from_numpy(m).to(device))
            want += [f"{u} {eval_cli.postprocess(t[0])}".rstrip() for (u, _), t in
                     zip(chunk, texts)]
        same = sum(a.rstrip() == b for a, b in zip(got, want))
        ok = (rc == 0 and same == len(feats) == len(got)
              and (cli_launches > 0) == (bw == 1 and device == "cuda"))
        lens = [len(line.split()) - 1 for line in got]
        log(f"{tag} cli/eval.py -bw {bw} over {len(feats)} dev wavs of phase 7 (40-mel host "
            f"features, batches of {batch}): predict.txt equals the in-process decode on {same} "
            f"of {len(feats)} (tokens {min(lens)}-{max(lens)} an utterance), kernel 1 launches "
            f"{cli_launches} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag} -bw {bw}: a gate failed (see above)")
        if bw == 1:
            launches = cli_launches
    return launches


def timed_greedy(tag: str, model, c: dict, feats, mask) -> dict:
    """11e: the offline greedy over one batch, warm-up then the median of
    three host-clock runs ending in a synchronize; its loop iterations and
    kernel-1 launches; then one more run under ``torch.profiler`` for the
    device time of kernel 1 (its partial and merge kernels) and of all the
    device work in that run, each beside the median host time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    def run():
        return model.greedy_decode(feats, mask, c["max_symbols"], c["max_per_frame"])

    run()
    torch.cuda.synchronize()
    it0, project_logp_topk.launches = model.greedy_iterations, 0
    tokens, n = run()
    torch.cuda.synchronize()
    iters, launches = model.greedy_iterations - it0, project_logp_topk.launches
    times = [host_seconds(run) for _ in range(3)]
    secs = sorted(times)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern_us = dev_us = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            dev_us += us
            if "partial_topk_kernel" in e.name or "merge_topk_kernel" in e.name:
                kern_us += us
    got = {"seconds": secs, "iterations": iters, "launches": launches,
           "kernel_ms": kern_us / 1e3, "device_ms": dev_us / 1e3, "tokens": int(n.sum())}
    log(f"{tag}: greedy B={feats.shape[0]} x {feats.shape[1]} frames: median {secs:.3f} s of "
        f"{[round(t, 3) for t in times]}, {iters} loop iterations, kernel 1 launches {launches}; "
        f"in one more run under torch.profiler kernel 1's device time {got['kernel_ms']:.2f} ms "
        f"({1e3 * got['kernel_ms'] / max(launches, 1):.1f} us a launch, "
        f"{0.1 * got['kernel_ms'] / secs:.1f}% of the median host time) and all device work "
        f"{got['device_ms']:.2f} ms ({0.1 * got['device_ms'] / secs:.1f}%); {got['tokens']} "
        f"tokens, {1e3 * secs / max(iters, 1):.2f} ms an iteration [{card_line()}]")
    if launches != iters or iters == 0 or not bool((n > 0).any()) or kern_us <= 0:
        raise AssertionError(f"{tag}: expected one kernel-1 launch an iteration, tokens and "
                             f"kernel-1 device time")
    return got


def phase_transducer(workdir: str, corpus: dict):
    """Phase 11 (module docstring). Returns {path: kernel 1 launches}."""
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.multistream import MultiStreamTransducer
    from opentransformer_tpu_torch.recognize.online import StreamingTransducerRecognizer

    t_phase = time.time()
    fixture = load_transducer_fixture()
    c = fixture["inputs"]
    feats, mask, targets = transducer_inputs(c)
    got_sum = checksum([feats])
    if (abs(got_sum - fixture["checksums"]["feats"]) > 1e-9 * got_sum
            or checksum([targets]) != fixture["checksums"]["targets"]):
        raise AssertionError("phase11: the seeded inputs are not the fixture's")
    launches = {}

    # 11a: offline greedy against JAX's
    name = TRANSDUCERS[0]
    want = fixture["results"][name]
    model, params = seeded_transducer(name, c, want=fixture)
    project_logp_topk.launches = 0
    out = transducer_outputs(model, feats, mask, targets, c)
    one = project_logp_topk.launches
    got = transducer_parity(out, want)
    ok = (got["memory"] <= TRANSDUCER_MEMORY_ATOL and got["logp"] <= TRANSDUCER_LOGP_ATOL
          and got["frames_differ"] == 0 and got["ids_differ"] <= TRANSDUCER_GREEDY_LIMIT
          and one == out["iterations"] > 0)
    log(f"phase11a {name} f32, seeded weights (joint output kernel x{c['joint_scale']}, blank "
        f"bias +{c['blank_bias']}), {c['utts']} "
        f"utterances of up to {c['frames']} frames x {c['mel']} mel, against JAX: encoder memory "
        f"(projected) max|d| {got['memory']:.3e} (atol {TRANSDUCER_MEMORY_ATOL:.0e}; frame "
        f"counts differ on {got['frames_differ']}), joint log-probs along a lattice path max|d| "
        f"{got['logp']:.3e} (atol {TRANSDUCER_LOGP_ATOL:.0e}), greedy ids differ on "
        f"{got['ids_differ']} <= {TRANSDUCER_GREEDY_LIMIT} of {c['utts']} (tokens "
        f"{sum(map(len, out['greedy']))}, JAX {sum(map(len, want['greedy']))}; blank the JAX "
        f"argmax at {100 * want['blank_share']:.1f}% of its lattice steps), kernel 1 launches "
        f"{one} = loop iterations {out['iterations']} (k=1, N={c['utts']}) "
        f"{'ok' if ok else 'FAIL'} [{card_line()}]")
    if not ok:
        raise AssertionError("phase11a: a gate failed (see above)")
    launches["phase11a transducer greedy (k=1, N=16)"] = one

    # 11b: beam 4, plain and with each LM fused
    for kind in ("none", *TRANSDUCER_LMS):
        lm = None
        if kind != "none":
            lm, lm_params = seeded_lm(kind, c)
            want_sum = fixture["checksums"][kind]
            if abs(checksum(lm_params) - want_sum) > 1e-9 * want_sum:
                raise AssertionError(f"phase11b: the seeded {kind} is not the fixture's")
        project_logp_topk.launches = 0
        t0 = time.time()
        beam = transducer_beam(model, feats, mask, c, lm)
        wall = time.time() - t0
        got = beam_parity(beam, want["beam"][kind])
        best = [len(h[0]) for h in beam["ids"]]
        ok = (got["best_differ"] <= TRANSDUCER_BEAM_LIMIT and got["unsorted"] == 0
              and got["nbest_differ"] <= TRANSDUCER_BEAM_LIMIT
              and got["score_rtol"] <= TRANSDUCER_SCORE_RTOL and project_logp_topk.launches == 0
              and beam_holds_labels(best))
        weight = "" if lm is None else f" at -lmw {c['lm_weight']}"
        log(f"phase11b beam {c['beam']}, {c['expansions']} expansions a frame, LM {kind}{weight}: "
            f"1-best ids differ from JAX's on {got['best_differ']} <= {TRANSDUCER_BEAM_LIMIT} of "
            f"{c['utts']}, n-best id lists on {got['nbest_differ']} <= {TRANSDUCER_BEAM_LIMIT}, "
            f"scores of hypotheses in "
            f"both max rel|d| {got['score_rtol']:.2e} (rtol {TRANSDUCER_SCORE_RTOL:.0e}), "
            f"unsorted {got['unsorted']}, 1-best lengths {best} (labelled on "
            f"{sum(n > 0 for n in best)} >= {TRANSDUCER_BEAM_LABELLED}, longest >= "
            f"{TRANSDUCER_BEAM_LONGEST}), n-best lengths "
            f"{sorted({len(x) for h in beam['ids'] for x in h})}, wall {wall:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase11b {kind}: a gate failed (see above)")
        del lm
    del model

    # 11c: the streaming config, single-stream and multi-stream
    name = TRANSDUCERS[1]
    model, stream_params = seeded_transducer(name, c, want=fixture)
    rec = StreamingTransducerRecognizer(model, max_per_frame=c["max_per_frame"])
    if rec.session.raw_chunk != STREAM_CHUNK_FRAMES:
        raise AssertionError(f"the streamed chunk is {rec.session.raw_chunk} raw frames")
    project_logp_topk.launches, it0 = 0, model.greedy_iterations
    streamed = streamed_transducer_ids(rec, feats, mask)
    one, iters = project_logp_topk.launches, model.greedy_iterations - it0
    offline = offline_transducer_ids(model, feats, mask, c)
    jax_differ = sum(a != b for a, b in zip(streamed, fixture["results"][name]["streamed"]))
    off_differ = sum(a != b for a, b in zip(streamed, offline))
    ms = MultiStreamTransducer(model, n_streams=c["utts"], max_per_frame=c["max_per_frame"])
    project_logp_topk.launches, it0 = 0, model.greedy_iterations
    slots, finals = multistream_reuse(ms, feats, mask)
    ms_one, ms_iters = project_logp_topk.launches, model.greedy_iterations - it0
    ms_differ = sum(finals[i] != " ".join(map(str, ids)) for i, ids in enumerate(streamed))
    ms_differ += int(finals["again"] != finals[0])
    reused = slots["again"] in slots.values() and ms.free_slots() == c["utts"]
    ok = (jax_differ <= TRANSDUCER_GREEDY_LIMIT and off_differ == 0 and ms_differ == 0
          and reused and one == iters > 0 and ms_one == ms_iters > 0)
    log(f"phase11c {name} f32 streamed in {STREAM_CHUNK_FRAMES}-frame feeds: "
        f"StreamingTransducerRecognizer ids differ from the port's offline greedy of each "
        f"chunk-masked utterance on {off_differ} of {c['utts']}, from JAX's streamed ids on "
        f"{jax_differ} <= {TRANSDUCER_GREEDY_LIMIT} (tokens {sum(map(len, streamed))}), kernel 1 "
        f"launches {one} = iterations {iters} (k=1, N=1); MultiStreamTransducer, {c['utts']} "
        f"slots opened one a tick, utterance 0 again in the first freed slot (slot "
        f"{slots['again']}), {ms.ticks} ticks: FINALs differ from the single-stream ids on "
        f"{ms_differ} of {c['utts'] + 1}, free slots after {ms.free_slots()}, kernel 1 launches "
        f"{ms_one} = iterations {ms_iters} (k=1, N={c['utts']}) {'ok' if ok else 'FAIL'} "
        f"[{card_line()}]")
    if not ok:
        raise AssertionError("phase11c: a gate failed (see above)")
    launches["phase11c online transducer (k=1, N=1)"] = one
    launches["phase11c multi-stream transducer (k=1, N=16)"] = ms_one
    del model, rec, ms

    # 11d: the CLIs
    with open(os.path.join(CONF_DIR, f"{TRANSDUCERS[0]}.json"), encoding="utf-8") as f:
        offline_cfg = json.load(f)
    launches["phase11d eval CLI, transducer greedy (k=1, N=8)"] = transducer_cli(
        "phase11d", workdir, corpus, params, offline_cfg)
    data_cfg = {"num_mel_bins": offline_cfg["data"]["num_mel_bins"],
                "normalization": offline_cfg["data"]["normalization"], "vocab": corpus["vocab"]}
    launches["phase11d serve --streaming, transducer (k=1, N=4)"] = pcm_check(
        "phase11d", workdir, name, stream_params, conformer_model_cfg(name), data_cfg, corpus,
        PCM["streams"])
    log(f"phase11a-d wall {time.time() - t_phase:.1f} s")

    # 11e: timed, not gated
    t = TRANSDUCER_LOAD
    g = torch.Generator().manual_seed(t["seed"])
    x = torch.randn(t["batch"], t["frames"], c["mel"], generator=g).cuda()
    m = torch.ones(t["batch"], t["frames"], dtype=torch.bool, device="cuda")
    for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        model, _ = seeded_transducer(TRANSDUCERS[0], c, dtype=dtype)
        got = timed_greedy(f"phase11e transducer {label}", model, c, x, m)
        launches[f"phase11e transducer greedy {label} (k=1, N={t['batch']})"] = got["launches"]
        if dtype == torch.bfloat16:
            run = lambda: model.beam_decode(x, m, c["beam"], c["beam_max_symbols"],  # noqa: E731
                                            c["expansions"])
            run()
            secs = host_seconds(run)
            log(f"phase11e transducer bf16 beam {c['beam']} ({c['expansions']} expansions a "
                f"frame) B={t['batch']} x {t['frames']} frames: {secs:.3f} s a batch (one run "
                f"after a warm-up) [{card_line()}]")
        del model
    model, _ = seeded_transducer(TRANSDUCERS[1], c, dtype=torch.bfloat16)
    rng = np.random.default_rng(t["seed"])
    load = [rng.normal(size=(int(t["seconds"] * 100), c["mel"])).astype(np.float32)
            for _ in range(t["slots"])]
    ms = MultiStreamTransducer(model, t["slots"], max_per_frame=c["max_per_frame"])
    it0 = model.greedy_iterations
    got = stream_load("phase11e MultiStreamTransducer bf16", ms, load)
    if got["launches"] != model.greedy_iterations - it0 or got["launches"] == 0:
        raise AssertionError("phase11e: expected one kernel-1 launch a lattice iteration")
    launches[f"phase11e multi-stream transducer bf16 (k=1, N={t['slots']})"] = got["launches"]
    log(f"phase11 wall {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 12
def recipe_config(data: str, epochs: int) -> dict:
    """``conf/anchor.json`` at ``epochs``, its data paths under ``data``."""
    with open(ANCHOR_CONF, encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["train"]["epochs"] = epochs
    cfg["data"]["vocab"] = os.path.join(data, "vocab")
    for split in ("train", "dev", "test"):
        cfg["data"][split] = {"feat": [os.path.join(data, split, "feats.scp")],
                              "text": [os.path.join(data, split, "text")]}
    return cfg


def probe_step_inputs(trainer):
    """The first greedy step of the probe's first dev batch: (h, W, b) as
    the trained model hands them to kernel 1 under the run's autocast."""
    model, probe = trainer.model.eval(), trainer.dev_probe_fn
    _, feats, mask = probe.batches[0]
    with torch.inference_mode(), trainer.autocast():
        memory, memory_mask = model.encode(feats, mask)
        cache = model.init_cache(memory, probe.max_len + 1)
        bos = torch.ones(feats.shape[0], dtype=torch.long, device=feats.device)
        h, _ = model.decode_hidden_step(bos, cache, 0, memory_mask)
        w, b = model.vocab_head()
    model.train()
    return h.contiguous(), w.detach(), b.detach()


def update_seconds(trainer, batches, cuda: bool) -> float:
    """Median host seconds of one update a batch, after one warm-up."""
    trainer.model.train()
    secs = []
    for batch in [batches[0], *batches]:
        start = time.time()
        trainer.micro_step(batch)
        trainer.update()
        if cuda:
            torch.cuda.synchronize()
        secs.append(time.time() - start)
    return float(np.median(secs[1:]))


def phase_anchor_recipe(workdir: str, data: str, device: str = "cuda"):
    """The anchor recipe cut to 2 epochs: ``conf/anchor.json`` through the
    training CLI (kaldi features, bucketing, the device-resident corpus,
    noise 0.3, bf16 autocast, steps_per_exec 24, the dev CER probe, the
    hybrid loss) on the full synthetic corpus, kernel 1 at the probe's step
    against its plain version, then the average of epochs 0-1 decoded over
    the 500 test utterances at beam 5, ``-ml 32``, through the eval CLI.
    ``data`` holds phase 2's test split; the train and dev splits are
    written beside it. Returns ({path: kernel-1 launches}, the probe step's
    (kernel ms, plain ms, bound ms, bound by))."""
    from opentransformer_tpu_torch.cli import average as average_cli
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.data import synth
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk, \
        project_logp_topk_plain

    cuda = device == "cuda"
    r = RECIPE
    t0 = time.time()
    synth.write_corpus(data, splits=("train", "dev"))
    log(f"phase12 wrote the synthetic train and dev splits ({synth.SPLIT_SIZES['train']} + "
        f"{synth.SPLIT_SIZES['dev']} utts) in {time.time() - t0:.1f} s")
    cfg = recipe_config(data, r["epochs"])
    conf = os.path.join(workdir, "anchor_recipe.json")
    with open(conf, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    expdir = os.path.join(workdir, "exp_anchor_torch")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    trainer = run_cli.run(["-c", conf, "--expdir", expdir, "--log_interval",
                           str(r["log_interval"]), "-s", str(r["seed"]),
                           *([] if cuda else ["--device", device])])
    if cuda:
        torch.cuda.synchronize()
    wall = time.time() - t0
    run_launches = project_logp_topk.launches  # the probe is the run's only caller
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    hist, probe, res = trainer.history, trainer.dev_probe_fn, trainer.resident
    losses = [x for rec in hist for x in rec["losses"]]
    first = float(np.mean([x for rec in hist[: r["log_interval"]] for x in rec["losses"]]))
    last_epoch = float(np.mean([x for rec in hist if rec["epoch"] == r["epochs"] - 1
                                for x in rec["losses"]]))
    gaps = [b["time"] - a["time"] for a, b in zip(hist, hist[1:])
            if a["epoch"] == b["epoch"] == r["epochs"] - 1]
    spu = float(np.median(gaps))
    steps = sum(rec["steps"] for rec in probe.records)
    probe_launches = sum(rec["launches"] for rec in probe.records)
    cers = [round(100 * rec["cer"], 2) for rec in probe.records]
    epoch_loss = [round(float(np.mean([x for q in hist if q["epoch"] == e for x in q["losses"]])), 4)
                  for e in range(r["epochs"])]
    ok = (np.isfinite(losses).all() and np.isfinite(trainer.dev_losses).all()
          and trainer.nan_skips == 0 and len(hist) == r["updates"]
          and res.nbytes == r["resident_bytes"] and [rec["epoch"] for rec in probe.records]
          == list(range(r["epochs"])) and last_epoch < first
          and probe_launches == run_launches == (steps if cuda else 0) and steps > 0)
    log(f"phase12 anchor recipe {r['epochs']} epochs through the training CLI in {wall:.1f} s: "
        f"{len(hist)} updates (want {r['updates']}), NaN skips {trainer.nan_skips}, "
        f"steps_per_exec {trainer.steps_per_exec}, autocast {trainer.autocast_dtype}, "
        f"resident corpus {res.nbytes} bytes (want {r['resident_bytes']}) {tuple(res.feats.shape)} "
        f"{res.feats.dtype} uploaded in {res.upload_seconds:.3f} s; mean loss of the first "
        f"{r['log_interval']} updates {first:.4f}, of epoch {r['epochs'] - 1} {last_epoch:.4f}; "
        f"per-epoch train loss {epoch_loss}, "
        f"dev loss {[round(x, 4) for x in trainer.dev_losses]}, dev greedy CER % {cers} "
        f"({probe.records[0]['utts']} utts, max_len {probe.max_len}), probe greedy steps {steps}, "
        f"kernel-1 launches in the probe {probe_launches} (whole run {run_launches}), probe "
        f"seconds {[round(q['seconds'], 3) for q in probe.records]}; seconds per update (host "
        f"clock, epoch {r['epochs'] - 1}) median {spu:.4f}, min {min(gaps):.4f}, max "
        f"{max(gaps):.4f}; peak memory {peak} bytes {'ok' if ok else 'FAIL'} "
        f"[{card_line() if cuda else device}]")
    if not ok:
        raise AssertionError("phase12: the recipe run is not what was asked for (see above)")

    # what the hybrid loss' CTC term costs an update: the same resident
    # batches with and without it, in turns (recorded, not gated)
    batches = [b for _, b in zip(range(4), FeatureLoader(cfg, "train", seed=r["seed"]))]
    secs = {}
    for weight in (trainer.model.ctc_weight, 0.0, trainer.model.ctc_weight, 0.0):
        trainer.model.ctc_weight = weight
        secs.setdefault(weight, []).append(update_seconds(trainer, batches, cuda))
    log(f"phase12 seconds per update on {len(batches)} resident batches (host clock, after a "
        f"warm-up, in turns): hybrid loss (ctc_weight {cfg['model']['ctc_weight']}) "
        f"{[round(x, 4) for x in secs[cfg['model']['ctc_weight']]]}, attention loss alone "
        f"{[round(x, 4) for x in secs[0.0]]} [{card_line() if cuda else device}]")

    # kernel 1 at the probe's greedy step: the trained model's own h and W
    h, w, b = probe_step_inputs(trainer)
    vals, ids = project_logp_topk(h, w, b, 1)
    ref_vals, ref_ids = project_logp_topk_plain(h, w, b, 1)
    err = (vals - ref_vals).abs().max().item()
    wide, _ = project_logp_topk_plain(h, w, b, 2)
    untied = (wide[:, 0] - wide[:, 1]) > 1e-5 * max(wide.abs().max().item(), 1.0)
    bad = int(((ids != ref_ids)[:, 0] & untied).sum())
    n, d = h.shape
    timing = None
    if cuda:
        kern = cuda_ms(lambda: project_logp_topk(h, w, b, 1))
        plain = cuda_ms(lambda: project_logp_topk_plain(h, w, b, 1))
        unfused = cuda_ms(lambda: torch.max(torch.log_softmax(
            (h @ w.to(h.dtype).T).float() + b, dim=-1), dim=-1))
        bound, bound_by = topk_bound_ms(n, d, w.shape[0], 1, h.dtype)
        timing = (kern, plain, bound, bound_by)
        log(f"phase12 time the probe's greedy step N={n} D={d} V={w.shape[0]} k=1 "
            f"{h.dtype}: kernel {kern:.4f} ms, plain version {plain:.4f} ms, unfused matmul + "
            f"log_softmax + max (a composition of calls) {unfused:.4f} ms, bound {bound:.4f} ms "
            f"({bound_by}); {rate_note(2.0 * n * d * w.shape[0], kern, bound)} [{card_line()}]")
    if err > 1e-4 or bad:
        raise AssertionError(f"phase12: kernel 1 disagrees with its plain version at the probe's "
                             f"step (max|dvals| {err:.3e}, {bad} untied ids)")
    log(f"phase12 kernel 1 at the probe's step ({h.dtype} h, {w.dtype} W, N={n}): max|dvals| "
        f"{err:.3e} (atol 1e-4), untied id mismatches {bad} ok")
    del trainer, h, w, b

    # the average of both epochs, reloaded by the eval CLI, decodes the test split
    average_cli.main([expdir, "0", str(r["epochs"] - 1)])
    avg = os.path.join(expdir, f"model.average.from0to{r['epochs'] - 1}")
    out = os.path.join(workdir, "decode_recipe_avg")
    project_logp_topk.launches = 0
    t0 = time.time()
    rc = eval_cli.main(["--npz", os.path.join(avg, "params.npz"),
                        "--model_cfg", os.path.join(expdir, "config.json"),
                        "--feats", cfg["data"]["test"]["feat"][0],
                        "--text", cfg["data"]["test"]["text"][0], "--vocab", cfg["data"]["vocab"],
                        "-b", "100", "-bw", "5", "-pn", "0.6", "-ml", "32", "--decode_dir", out,
                        *([] if cuda else ["--device", device])])
    decode_launches = project_logp_topk.launches
    with open(os.path.join(out, "RESULT"), encoding="utf-8") as f:
        result = f.read().splitlines()
    n_utts = nbest_scores_sorted(out)
    ok = (rc == 0 and n_utts == synth.SPLIT_SIZES["test"]
          and (decode_launches > 0 or not cuda))
    log(f"phase12 average of epochs 0-{r['epochs'] - 1} decoded at beam 5, -ml 32: "
        f"{' | '.join(result)} | {n_utts} utts, n-best sorted, kernel-1 launches "
        f"{decode_launches} (k=5), wall {time.time() - t0:.1f} s (CER not gated: "
        f"{r['epochs']} of 80 epochs) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase12: the averaged checkpoint did not decode (see above)")
    return ({f"phase12 anchor recipe dev CER probe (k=1, N={n})": probe_launches,
             f"phase12 averaged recipe checkpoint decode (k=5, {n_utts} utts)": decode_launches},
            timing)


# ---------------------------------------------------------------- phase 13
# the tiny corpus and transducer of the JAX package's
# tests/test_transducer.py::test_transducer_cli_train_and_decode
CTC_CORPUS = dict(units=6, feat_dim=16, vocab=9, utts=40)


def make_ctc_corpus(root: str, n_utts: int = CTC_CORPUS["utts"], seed: int = 0) -> None:
    """40 seeded utterances of 2-3 units (a, b, ...; no unit twice in a
    row), each a 16-dim pattern held 12 frames plus noise at 0.1, as kaldi
    arks (``feats.scp``), a ``text`` and a ``vocab`` under ``root`` (the
    JAX package's ``tests/test_ctc_e2e.py:make_ctc_corpus``, the same
    draws)."""
    from opentransformer_tpu_torch.data import write_vocab
    from opentransformer_tpu_torch.data.kaldi_io import write_ark

    c = CTC_CORPUS
    rng = np.random.default_rng(seed)
    units = [chr(ord("a") + i) for i in range(c["units"])]
    write_vocab({"<PAD>": 0, "<S/E>": 1, "<UNK>": 2, **{u: 3 + i for i, u in enumerate(units)}},
                os.path.join(root, "vocab"))
    patterns = rng.normal(size=(c["units"], c["feat_dim"])).astype(np.float32) * 2.0
    feats, lines = {}, []
    for i in range(n_utts):
        n_tok = int(rng.integers(2, 4))
        toks = [int(rng.integers(0, c["units"]))]
        while len(toks) < n_tok:
            t = int(rng.integers(0, c["units"]))
            if t != toks[-1]:
                toks.append(t)
        frames = np.concatenate([np.tile(patterns[t], (12, 1)) for t in toks])
        frames = frames + 0.1 * rng.normal(size=frames.shape).astype(np.float32)
        feats[f"utt{i:03d}"] = frames.astype(np.float32)
        lines.append(f"utt{i:03d} " + " ".join(units[t] for t in toks))
    write_ark(os.path.join(root, "feats.ark"), feats, os.path.join(root, "feats.scp"))
    with open(os.path.join(root, "text"), "w") as f:
        f.write("\n".join(lines) + "\n")


def tiny_transducer_cfg() -> dict:
    """The JAX test's ``_tiny_cfg``: d32, 2 blocks, a 1-layer predictor."""
    return {"type": "transducer", "frontend_type": "conv",
            "frontend": {"input_size": CTC_CORPUS["feat_dim"], "output_size": 32,
                         "mid_channel": 8, "out_channel": 16, "kernel_size": [[3, 3], [3, 3]],
                         "stride": [2, 2]},
            "encoder_type": "transformer",
            "encoder": {"d_model": 32, "n_heads": 2, "d_ff": 64, "n_blocks": 2,
                        "residual_dropout": 0.0},
            "vocab_size": CTC_CORPUS["vocab"], "predictor": {"num_layers": 1}, "d_joint": 32}


def ctc_corpus_config(root: str, epochs: int = 40) -> dict:
    """The JAX test's training config for the tiny corpus (kaldi features,
    batch 8, Adam at a constant 3e-3, clip 5; test = train), model unset."""
    split = {"feat": [os.path.join(root, "feats.scp")], "text": [os.path.join(root, "text")]}
    return {"data": {"dataset_type": "kaldi", "vocab": os.path.join(root, "vocab"),
                     "batch_size": 8, "train": split, "test": split},
            "model": None,
            "train": {"optimizer_type": "adam", "optimizer": {"lr": 3e-3},
                      "scheduler_type": "constant", "scheduler": {"lr": 3e-3},
                      "clip_grad": 5, "epochs": epochs, "save_name": "tiny"}}


# the sizes of phase 13 (a CPU rehearsal cuts them)
FAMILIES = dict(
    tiny_epochs=40, tiny_cer_limit=20.0,
    transducer_utts=1024, transducer_batch=8, transducer_updates=100, blocked_updates=20,
    t_block=32, loss_reps=3, ctc_utts=800, ctc_batch=16, lm_lines=None, lm_test_lines=None,
    rnn_lm_nll_limit=6.0, lm_weight=0.3, stats_rtol=1e-4, cut_width=False)
FAMILY_OVERFIT_LR = 3e-3  # phase 7's overfit at this lr
TRANSDUCER_CONF = os.path.join(CONF_DIR, "transducer.json")
LM_CONFS = {name: os.path.join(CONF_DIR, f"{name}.json") for name in ("rnn_lm", "transformer_lm")}


def subset_split(data: str, split: str, n, root: str) -> dict:
    """The first ``n`` utterances (all with ``None``) of a synthetic split
    as a kaldi ``{feat, text}`` section under ``root`` (the arks are
    shared)."""
    os.makedirs(root, exist_ok=True)
    out = {}
    for key, name in (("feat", "feats.scp"), ("text", "text")):
        with open(os.path.join(data, split, name), encoding="utf-8") as f:
            lines = f.read().splitlines()[:n]
        out[key] = [os.path.join(root, f"{split}.{name}")]
        with open(out[key][0], "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return out


def kaldi_cfg(data: str, train: dict, batch: int, conf: str, **data_extra) -> dict:
    """``conf``'s model and train sections over the synthetic corpus's kaldi
    features: batch ``batch``, its vocab, ``train`` as the train split."""
    with open(conf, encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["data"] = {"dataset_type": "kaldi", "vocab": os.path.join(data, "vocab"),
                   "batch_size": batch, "train": train, **data_extra}
    return cfg


def write_conf(workdir: str, name: str, cfg: dict) -> str:
    path = os.path.join(workdir, f"{name}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    return path


def run_checks(tag: str, trainer, updates: int) -> list:
    """Every loss finite, no NaN skip, ``updates`` updates: the losses."""
    losses = [x for r in trainer.history for x in r["losses"]]
    if not (np.isfinite(losses).all() and trainer.nan_skips == 0
            and len(trainer.history) == updates):
        raise AssertionError(f"{tag}: {len(trainer.history)} updates (want {updates}), NaN skips "
                             f"{trainer.nan_skips}, finite losses {np.isfinite(losses).all()}")
    return losses


def seconds_per_update(history, skip: int = 2) -> float:
    """Median host seconds between update records, after the first ``skip``."""
    gaps = [b["time"] - a["time"] for a, b in zip(history, history[1:])][skip:]
    return float(np.median(gaps)) if gaps else float("nan")


def overfit_family(tag: str, model_cfg: dict, batch, device: str, frontend=None) -> list:
    """A family's width-64 model on one batch of 8: 40 updates at a
    constant lr from a seeded init; the last loss must be under half the
    first (phase 7's gate)."""
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.train.trainer import Trainer

    o, lr = OVERFIT, FAMILY_OVERFIT_LR
    torch.manual_seed(3)
    model = build_model(model_cfg, device=device).train()
    trainer = Trainer({"accum_steps": 1, "clip_grad": 5, "optimizer_type": "adam",
                       "optimizer": {"lr": lr}, "scheduler_type": "constant",
                       "scheduler": {"lr": lr}},
                      model, frontend, torch.Generator(device=device).manual_seed(3))
    curve = []
    for _ in range(o["updates"]):
        trainer.micro_step(batch)
        curve.append(trainer.update()["losses"][0])
    ok = np.isfinite(curve).all() and curve[-1] < 0.5 * curve[0] and trainer.nan_skips == 0
    log(f"{tag} overfit width {o['d_model']}, {len(batch[0])} samples, lr {lr}, "
        f"{o['updates']} updates: loss {curve[0]:.4f} -> {curve[-1]:.4f} (every 10th: "
        f"{[round(x, 3) for x in curve[::10]]}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the width-{o['d_model']} model did not halve its loss")
    return curve


def phase13a_tiny_transducer(workdir: str, device: str) -> int:
    """13a: the JAX package's tiny transducer test on the card: its corpus
    and config through the training CLI (40 epochs, constant lr 3e-3),
    then ``cli/eval.py`` greedy from the last checkpoint directory. Gates:
    CER below 20% (the JAX test's gate), kernel-1 launches = the greedy
    loop iterations of the same decode in process > 0, finite losses, no
    NaN skip. Returns the CLI decode's kernel-1 launches."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.data import load_idx2unit_map
    from opentransformer_tpu_torch.data.kaldi_io import load_mat, read_scp
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.base import build_recognizer

    cuda = device == "cuda"
    dev_args = [] if cuda else ["--device", device]
    root = os.path.join(workdir, "tiny_transducer")
    os.makedirs(root, exist_ok=True)
    make_ctc_corpus(root)
    cfg = ctc_corpus_config(root, epochs=FAMILIES["tiny_epochs"])
    cfg["model"] = tiny_transducer_cfg()
    expdir = os.path.join(root, "exp")
    t0 = time.time()
    trainer = run_cli.run(["-c", write_conf(root, "tiny_transducer", cfg), "--expdir", expdir,
                           "--log_interval", "1000", "-s", "1234", *dev_args])
    wall = time.time() - t0
    n_batches = -(-CTC_CORPUS["utts"] // cfg["data"]["batch_size"])
    losses = run_checks("phase13a", trainer, n_batches * FAMILIES["tiny_epochs"])
    ckpt = os.path.join(expdir, f"model.epoch.{FAMILIES['tiny_epochs'] - 1}")
    out = os.path.join(root, "decode_greedy")
    project_logp_topk.launches = 0
    rc = eval_cli.main(["--npz", os.path.join(ckpt, "params.npz"),
                        "--model_cfg", os.path.join(expdir, "config.json"),
                        "--feats", os.path.join(root, "feats.scp"),
                        "--text", os.path.join(root, "text"), "--vocab", os.path.join(root, "vocab"),
                        "-md", "greedy", "--decode_dir", out, *dev_args])
    cli_launches = project_logp_topk.launches
    with open(os.path.join(out, "RESULT"), encoding="utf-8") as f:
        result = f.read().splitlines()
    cer = float(result[0].split()[1].rstrip("%"))
    # the same decode in process, for its loop iterations
    model = compat.load_into(build_model(cfg["model"], device=device),
                             compat.load_npz(os.path.join(ckpt, "params.npz")))
    rec = build_recognizer("transducer", model, args={"beam_width": 1, "max_len": 100},
                           idx2unit=load_idx2unit_map(os.path.join(root, "vocab")))
    feats = [load_mat(rx) for rx in read_scp(os.path.join(root, "feats.scp")).values()]
    for s in range(0, len(feats), 16):  # the eval CLI's batches
        x, m, _ = eval_cli.collate(feats[s : s + 16])
        rec.recognize(torch.from_numpy(x).to(device), torch.from_numpy(m).to(device))
    iterations = model.greedy_iterations
    ok = (rc == 0 and cer < FAMILIES["tiny_cer_limit"] and iterations > 0
          and cli_launches == (iterations if cuda else 0))
    log(f"phase13a tiny transducer ({sum(p.numel() for p in trainer.model.parameters())} "
        f"parameters) {FAMILIES['tiny_epochs']} epochs through the training CLI in {wall:.1f} s: "
        f"{len(trainer.history)} updates, loss {losses[0]:.3f} -> {losses[-1]:.3f}, NaN skips "
        f"{trainer.nan_skips}; cli/eval.py -md greedy from {os.path.basename(ckpt)}: "
        f"{' | '.join(result)}; CER {cer}% < {FAMILIES['tiny_cer_limit']}% (the JAX test's "
        f"gate), kernel-1 launches {cli_launches} = greedy loop iterations {iterations} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase13a: a gate failed (see above)")
    return cli_launches


def loss_seconds(trainer, batch, device: str, reps: int) -> dict:
    """On one batch, for the full joint and for T-blocks: the RNN-T loss
    alone, forward + backward, over the joint's log-probs or its two slices
    (made beforehand, without gradient), and one whole update (forward,
    backward, clip, Adam) with that joint; median host seconds of ``reps``
    runs after a warm-up, each ending in a synchronize."""
    from opentransformer_tpu_torch.data import BLK
    from opentransformer_tpu_torch.ops.masks import mask_to_length
    from opentransformer_tpu_torch.ops.rnnt_loss import rnnt_loss_from_blank_emit, rnnt_loss_mean
    from opentransformer_tpu_torch.train.trainer import feature_args

    model = trainer.model
    feats, mask, targets, tlen = feature_args(batch, device)
    with torch.no_grad():
        memory, memory_mask = model.encode(feats, mask)
        pred = model.predictor(targets[:, :-1])
        frame_len = mask_to_length(memory_mask)
        log_probs = torch.log_softmax(model.joint(memory, pred), dim=-1)
        u_max = pred.shape[1] - 1
        slices = model.joint.blank_emit_log_probs(memory, pred, targets[:, 1 : 1 + u_max],
                                                  blank=BLK, t_block=FAMILIES["t_block"])

    def timed(fn):
        secs = []
        for _ in range(reps + 1):
            if device == "cuda":
                torch.cuda.synchronize()
            start = time.time()
            fn()
            if device == "cuda":
                torch.cuda.synchronize()
            secs.append(time.time() - start)
        return float(np.median(secs[1:]))

    def update():
        trainer.micro_step(batch)
        trainer.update()

    def full_loss():
        x = log_probs.detach().requires_grad_()
        rnnt_loss_mean(x, targets[:, 1:], frame_len, tlen - 1, BLK).backward()

    def blocked_loss():
        xs = [x.detach().requires_grad_() for x in slices]
        rnnt_loss_from_blank_emit(xs[0], xs[1], frame_len, tlen - 1).mean().backward()

    out = {"shape": tuple(log_probs.shape)}
    for name, t_block, loss_fn in (("full", 0, full_loss), ("blocked", FAMILIES["t_block"],
                                                            blocked_loss)):
        model.joint_t_block = t_block
        model.train()
        out[name] = {"loss": timed(loss_fn), "update": timed(update)}
    return out


def phase13b_full_transducer(workdir: str, data: str, device: str):
    """13b: ``conf/transducer.json`` at full width on the first 1,024 train
    utterances of the synthetic corpus (kaldi features, batch 8, one
    micro-batch an update), 100 updates with ``joint_t_block`` -1 then 20
    with 32; for each, seconds per update and peak memory, and on the
    longest batch the RNN-T loss's own forward + backward time beside a
    whole update's; a checkpoint that reloads to the same greedy ids
    (kernel 1, launches = iterations). Returns (the reload check's kernel-1
    launches, a batch of 8 for the overfit gate, the model config)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.train.checkpoint import Checkpointer
    from opentransformer_tpu_torch.train.trainer import Trainer, feature_args

    cuda = device == "cuda"
    f = FAMILIES
    root = os.path.join(workdir, "full_transducer")
    train = subset_split(data, "train", f["transducer_utts"], root)
    cfg = kaldi_cfg(data, train, f["transducer_batch"], TRANSDUCER_CONF)
    cfg["train"]["accum_steps"] = 1
    if f["cut_width"]:
        cfg["model"] = overfit_model_cfg(cfg["model"])
    torch.manual_seed(1234)
    model = build_model(cfg["model"], device=device)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(cfg["train"], model, None,
                      torch.Generator(device=device).manual_seed(1234), log_interval=10 ** 9)
    batches = list(FeatureLoader(cfg, "train", seed=1234))
    model.train()
    runs = {}
    done = 0
    for t_block, n in ((-1, f["transducer_updates"]), (f["t_block"], f["blocked_updates"])):
        model.joint_t_block = t_block
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        first = len(trainer.history)
        for batch in [batches[(done + i) % len(batches)] for i in range(n)]:
            trainer.micro_step(batch)
            trainer.update()
        if cuda:
            torch.cuda.synchronize()
        done += n
        hist = trainer.history[first:]
        runs[t_block] = {"updates": n, "spu": seconds_per_update(hist),
                         "peak": torch.cuda.max_memory_allocated() if cuda else 0,
                         "loss": [hist[0]["losses"][0], hist[-1]["losses"][0]]}
    run_checks("phase13b", trainer, f["transducer_updates"] + f["blocked_updates"])
    for t_block, r in runs.items():
        log(f"phase13b transducer ({n_params} parameters) joint_t_block {t_block}: "
            f"{r['updates']} updates of {f['transducer_batch']} utterances, loss "
            f"{r['loss'][0]:.3f} -> {r['loss'][1]:.3f}, seconds per update (host clock, median "
            f"after 2) {r['spu']:.4f}, peak memory {r['peak']} bytes "
            f"[{card_line() if cuda else device}]")
    longest = max(batches, key=lambda b: b[1]["inputs"].shape[1])
    timed = loss_seconds(trainer, longest, device, f["loss_reps"])
    for key, what in (("full", "the full joint's log-probs"),
                      ("blocked", f"the blank and label slices of T-blocks of {f['t_block']}")):
        t = timed[key]
        log(f"phase13b the longest batch {timed['shape']}, {what}: the RNN-T loss alone "
            f"(forward + backward) {t['loss']:.4f} s, a whole update {t['update']:.4f} s, the "
            f"loss's share {t['loss'] / t['update']:.1%} (host clock, median of "
            f"{f['loss_reps']} after a warm-up) [{card_line() if cuda else device}]")
    # a checkpoint of the trained model reloads to the same greedy ids
    ck = Checkpointer(os.path.join(root, "exp"), config=cfg)
    ck.save(0, model, trainer.optimizer)
    fresh = compat.load_into(build_model(cfg["model"], device=device),
                             ck.load_params(ck.epoch_path(0)))
    feats, mask, _, _ = feature_args(batches[0], device)
    project_logp_topk.launches = 0
    ids = []
    for m in (model.eval(), fresh):
        m.greedy_iterations = 0
        tokens, n = m.greedy_decode(feats, mask)
        ids.append([tokens[i, :k].tolist() for i, k in enumerate(n.tolist())])
    iterations = model.greedy_iterations + fresh.greedy_iterations
    launches = project_logp_topk.launches
    ok = ids[0] == ids[1] and iterations > 0 and launches == (iterations if cuda else 0)
    log(f"phase13b checkpoint reloaded into a fresh model: greedy ids of a batch of "
        f"{feats.shape[0]} equal ({sum(map(len, ids[0]))} tokens), kernel-1 launches {launches} "
        f"= greedy loop iterations {iterations} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase13b: the reloaded checkpoint decodes differently")
    return launches, batches[0], cfg["model"]


def bn_stats_update(model, feats, mask, targets, tlen) -> list:
    """One forward with only the BatchNorm modules in training mode (no
    dropout), from the model's weights and running statistics: the moved
    (running_mean, running_var) of every BatchNorm, as float64 numpy."""
    from opentransformer_tpu_torch.models.modules import BatchNorm

    model.eval()
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.train()
    with torch.no_grad():
        model(feats, mask, targets, tlen)
    model.eval()
    return [(bn.running_mean.double().cpu().numpy(), bn.running_var.double().cpu().numpy())
            for bn in bns]


def phase13c_batch_norm_conformer(workdir: str, corpus: dict, device: str):
    """13c: ``conf/conformer_baseline.json`` with ``conv_norm_type: batch``
    at full width through the training CLI on phase 7's wavs (``cli_train``:
    one kernel-3 launch a micro-batch, a checkpoint that reloads, with its
    batch_stats, to the same beam-5 ids through kernel 1 at D = 384); every
    block's running statistics moved off (0, 1); one micro-batch's update
    of them on the card within 1e-4 relative of the CPU's from the same
    weights and features. Returns (kernel-3 launches, kernel-1 launches of
    the reload check, the trainer's device frontend, config)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.modules import BatchNorm
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    conf = os.path.join(CONF_DIR, "conformer_baseline.json")
    model_cfg = conformer_model_cfg("conformer_baseline")
    model_cfg["encoder"]["conv_norm_type"] = "batch"
    if FAMILIES["cut_width"]:
        model_cfg = overfit_model_cfg(model_cfg)
    trainer, cfg, fbank_launches = cli_train("phase13c", workdir, corpus, device,
                                             model_cfg=model_cfg, conf=conf,
                                             name="conformer_batch_norm")
    beam_launches = project_logp_topk.launches
    model = trainer.model
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    moved = min(min(float((bn.running_mean).abs().max()),
                    float((bn.running_var - 1).abs().max())) for bn in bns)
    # one micro-batch's statistics update, card against CPU
    _, inputs, tg = next(iter(FeatureLoader(cfg, "train", seed=7)))
    w = torch.as_tensor(inputs["waveforms"]).to(device)
    wl = torch.as_tensor(inputs["wave_lengths"]).to(device)
    with torch.no_grad():
        feats, mask = trainer.frontend(w, wl, trainer.generator, train=False)
    targets = torch.as_tensor(tg["targets"]).long()
    tlen = torch.as_tensor(tg["targets_length"]).long()
    tree = compat.params_to_jax(model)
    on_cpu = compat.load_into(build_model(cfg["model"], device="cpu"), tree)
    got = bn_stats_update(model, feats, mask, targets.to(device), tlen.to(device))
    want = bn_stats_update(on_cpu, feats.cpu(), mask.cpu(), targets, tlen)
    compat.load_into(model, tree)  # the trained statistics back
    rel = max(float(np.abs(g - w_).max() / np.abs(w_).max())
              for pair_g, pair_w in zip(got, want) for g, w_ in zip(pair_g, pair_w))
    ok = (moved > 1e-3 and rel <= FAMILIES["stats_rtol"]
          and (beam_launches > 0) == (device == "cuda"))
    log(f"phase13c BatchNorm conformer: {len(bns)} BatchNorm modules, each block's running "
        f"statistics off (0, 1) by at least {moved:.3e}; one micro-batch's statistics update "
        f"({tuple(feats.shape)}) on {device} against the CPU from the same weights and features: "
        f"max relative difference {rel:.2e} (limit {FAMILIES['stats_rtol']:.0e}); the reload "
        f"check's beam-5 decode took {beam_launches} kernel-1 launches (D = "
        f"{model_cfg['encoder']['d_model']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase13c: a gate failed (see above)")
    return fbank_launches, beam_launches, trainer.frontend, cfg


def phase13d_ctc(workdir: str, data: str, device: str):
    """13d: the anchor's ``ctc`` model (phase 8a's), warm-started from the
    anchor's weights with ``-im`` (the decoder left out), trained through
    the CLI for 50 updates of 16 synthetic utterances (the anchor's train
    section, float32, one update an execution); finite losses, no NaN
    skip; the checkpoint reloads to the same greedy ids on a test batch (one
    kernel-1 launch a batch), and ``cli/eval.py -md greedy`` decodes the
    test split from it (one launch a batch of 100). Returns (kernel-1
    launches of the CLI decode, the model config, a batch of 8)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.train.trainer import feature_args

    cuda = device == "cuda"
    f = FAMILIES
    root = os.path.join(workdir, "ctc_warm")
    with open(ANCHOR + ".manifest.json", encoding="utf-8") as fh:
        model_cfg = ctc_model_cfg(json.load(fh)["model_cfg"])
    cfg = kaldi_cfg(data, subset_split(data, "train", f["ctc_utts"], root), f["ctc_batch"],
                    ANCHOR_CONF, bucket={"bucket_boundaries": [1152], "drop_last": True})
    cfg["model"] = model_cfg
    cfg["train"].update(epochs=1, dtype="float32", steps_per_exec=1, dev_cer_probe=False)
    expdir = os.path.join(root, "exp")
    t0 = time.time()
    trainer = run_cli.run(["-c", write_conf(root, "ctc_warm", cfg), "--expdir", expdir,
                           "-im", ANCHOR + ".npz", "-s", "1234", "--log_interval", "1000",
                           *([] if cuda else ["--device", device])])
    wall = time.time() - t0
    losses = run_checks("phase13d", trainer, f["ctc_utts"] // f["ctc_batch"])
    ckpt = os.path.join(expdir, "model.epoch.0")
    fresh = compat.load_into(build_model(model_cfg, device=device),
                             compat.load_npz(os.path.join(ckpt, "params.npz")))
    test = FeatureLoader({"data": dict(cfg["data"], test={
        "feat": [os.path.join(data, "test", "feats.scp")],
        "text": [os.path.join(data, "test", "text")]}, bucket=None)}, "test", is_eval=True,
        batch_size=100)
    feats, mask, _, _ = feature_args(next(iter(test)), device)
    project_logp_topk.launches = 0
    with torch.no_grad():
        ids = [m.eval().recognize_argmax(feats, mask)[0] for m in (trainer.model, fresh)]
    reload_launches = project_logp_topk.launches
    out = os.path.join(root, "decode_greedy")
    project_logp_topk.launches = 0
    rc = eval_cli.main(["--npz", os.path.join(ckpt, "params.npz"),
                        "--model_cfg", os.path.join(expdir, "config.json"),
                        "--feats", os.path.join(data, "test", "feats.scp"),
                        "--text", os.path.join(data, "test", "text"),
                        "--vocab", os.path.join(data, "vocab"), "-b", "100", "-md", "greedy",
                        "--decode_dir", out, *([] if cuda else ["--device", device])])
    cli_launches = project_logp_topk.launches
    with open(os.path.join(out, "RESULT"), encoding="utf-8") as fh:
        result = fh.read().splitlines()
    with open(os.path.join(data, "test", "feats.scp"), encoding="utf-8") as fh:
        batches = -(-sum(1 for line in fh if line.strip()) // 100)
    ok = (rc == 0 and torch.equal(ids[0], ids[1])
          and reload_launches == (2 if cuda else 0) and cli_launches == (batches if cuda else 0))
    log(f"phase13d ctc model warm-started from the anchor (-im), {len(trainer.history)} updates "
        f"in {wall:.1f} s: loss {losses[0]:.4f} -> {losses[-1]:.4f}, NaN skips "
        f"{trainer.nan_skips}; model.epoch.0 reloaded: greedy ids of {feats.shape[0]} test "
        f"utterances equal ({reload_launches} kernel-1 launches, one a batch); cli/eval.py -md "
        f"greedy: {' | '.join(result)}, kernel-1 launches {cli_launches} (one a batch of 100) "
        f"{'ok' if ok else 'FAIL'} [{card_line() if cuda else device}]")
    if not ok:
        raise AssertionError("phase13d: a gate failed (see above)")
    return cli_launches, model_cfg


def lm_nll(model, loader, device: str) -> float:
    """Mean negative log-likelihood per target token (EOS included, PAD
    not), unsmoothed, over a text loader's batches."""
    from opentransformer_tpu_torch.train.trainer import text_args

    total, count = 0.0, 0
    model.eval()
    with torch.no_grad():
        for batch in loader:
            src, tgt, _ = text_args(batch, device)
            logp = torch.log_softmax(model.logits(src).float(), dim=-1)
            nll = -torch.gather(logp, 2, tgt[..., None])[..., 0]
            keep = tgt != 0
            total += float(nll[keep].sum())
            count += int(keep.sum())
    return total / count


def phase13e_lms(workdir: str, data: str, device: str):
    """13e: ``conf/rnn_lm.json`` (2 x 1024) and ``conf/transformer_lm.json``
    (d256, 6 blocks) at full width, one epoch each over the synthetic
    corpus's 20,000 train lines (batch 16, accum_steps 4) through the
    training CLI; finite losses, no NaN skip; the held-out NLL over the 500
    test lines (unsmoothed, per token with EOS) before and after: the RNN
    LM's at most 6.0 nats, the transformer LM's below its untrained value
    (its 12,000-update warm-up keeps the lr near 1e-5). Then the anchor
    decoded through ``cli/eval.py`` with the trained transformer LM's run
    directory at ``-lmw 0.3``: kernel 2 launched, kernel 1 not; the CER is
    recorded. Returns (kernel-2 launches, {name: trainer})."""
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model

    cuda = device == "cuda"
    f = FAMILIES
    root = os.path.join(workdir, "lms")
    vocab = os.path.join(data, "vocab")
    texts = {}
    for split, n in (("train", f["lm_lines"]), ("test", f["lm_test_lines"])):
        texts[split] = subset_split(data, split, n, os.path.join(root, "text"))["text"]
    trainers, expdirs = {}, {}
    for name, conf in LM_CONFS.items():
        with open(conf, encoding="utf-8") as fh:
            cfg = json.load(fh)
        cfg["data"].update(vocab=vocab, src_vocab=vocab, tgt_vocab=vocab,
                           train={"src": texts["train"], "tgt": texts["train"]},
                           test={"src": texts["test"], "tgt": texts["test"]})
        cfg["train"]["epochs"] = 1
        test = FeatureLoader(cfg, "test", is_eval=True)
        torch.manual_seed(1234)  # the CLI's initial weights
        before = lm_nll(build_model(cfg["model"], device=device), test, device)
        expdirs[name] = os.path.join(root, f"exp_{name}")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        trainer = run_cli.run(["-c", write_conf(root, name, cfg), "--expdir", expdirs[name],
                               "-s", "1234", "--log_interval", "1000",
                               *([] if cuda else ["--device", device])])
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        n_batches = len(FeatureLoader(cfg, "train", seed=1234))
        accum = cfg["train"]["accum_steps"]
        losses = run_checks(f"phase13e {name}", trainer, -(-n_batches // accum))
        after = lm_nll(trainer.model, test, device)
        limit = f["rnn_lm_nll_limit"] if name == "rnn_lm" else before
        ok = after <= limit if name == "rnn_lm" else after < before
        log(f"phase13e {name} ({sum(p.numel() for p in trainer.model.parameters())} parameters) "
            f"1 epoch of {n_batches} batches of {cfg['data']['batch_size']} lines, accum "
            f"{accum}: {len(trainer.history)} updates in {wall:.1f} s, seconds per update (host "
            f"clock, median) {seconds_per_update(trainer.history):.4f}, peak memory {peak} "
            f"bytes, loss {np.mean(losses[:accum * 10]):.4f} (first 10 updates) -> "
            f"{np.mean(losses[-accum * 10:]):.4f} (last 10), lr {trainer.history[-1]['lr']:.3e} "
            f"at the end, NaN skips {trainer.nan_skips}; held-out NLL per token "
            f"({len(test.dataset)} lines, unsmoothed, EOS in) {before:.4f} -> {after:.4f} nats "
            f"({'<= ' + str(limit) if name == 'rnn_lm' else '< the untrained value'}) "
            f"{'ok' if ok else 'FAIL'} [{card_line() if cuda else device}]")
        if not ok:
            raise AssertionError(f"phase13e {name}: the held-out NLL gate failed")
        trainers[name] = trainer
    # the anchor with the trained transformer LM, handed over as its checkpoint directory
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    out = os.path.join(root, "decode_anchor_lm")
    project_logp_topk.launches = project2_logp_topk.launches = 0
    t0 = time.time()
    rc = eval_cli.main(["--npz", ANCHOR + ".npz", "--model_cfg", ANCHOR + ".manifest.json",
                        "--feats", os.path.join(data, "test", "feats.scp"),
                        "--text", os.path.join(data, "test", "text"), "--vocab", vocab,
                        "-b", "100", "-bw", "5", "-pn", "0.6", "-ml", "32",
                        "-lm", os.path.join(expdirs["transformer_lm"], "model.epoch.0"), "-lmw", str(f["lm_weight"]),
                        "--decode_dir", out, *([] if cuda else ["--device", device])])
    one, two = project_logp_topk.launches, project2_logp_topk.launches
    with open(os.path.join(out, "RESULT"), encoding="utf-8") as fh:
        result = fh.read().splitlines()
    ok = rc == 0 and one == 0 and (two > 0) == cuda
    log(f"phase13e the anchor (f32, beam 5, -ml 32) with the trained transformer LM at -lmw "
        f"{f['lm_weight']}, handed to cli/eval.py as its checkpoint directory: {' | '.join(result)} "
        f"(CER recorded, not gated), kernel-2 launches {two}, kernel-1 launches {one}, wall "
        f"{time.time() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase13e: the fused decode did not go through kernel 2 alone")
    return two, trainers


def phase_train_families(workdir: str, data: str, corpus: dict, device: str = "cuda"):
    """Phase 13 (module docstring): ``data`` holds phase 12's synthetic
    corpus (train, dev) and phase 2's test split, ``corpus`` phase 7's wavs.
    Returns ({path: kernel-1 launches}, {path: kernel-2 launches},
    {path: kernel-3 launches})."""
    from opentransformer_tpu_torch.data.loader import FeatureLoader, collate_text
    from opentransformer_tpu_torch.data.datasets import TextDataset

    t_phase = time.time()
    k1, k2, k3 = {}, {}, {}
    k1["phase13a tiny transducer, cli/eval.py greedy (k=1)"] = phase13a_tiny_transducer(
        workdir, device)
    launches, speech8, transducer_cfg = phase13b_full_transducer(workdir, data, device)
    k1["phase13b transducer checkpoint greedy (k=1)"] = launches
    fbank, beam, frontend, bn_cfg = phase13c_batch_norm_conformer(workdir, corpus, device)
    k3["phase13c BatchNorm conformer training"] = fbank
    k1["phase13c BatchNorm conformer checkpoint beam 5 (D=384)"] = beam
    launches, ctc_cfg = phase13d_ctc(workdir, data, device)
    k1["phase13d ctc checkpoint, cli/eval.py greedy (k=1)"] = launches
    two, _ = phase13e_lms(workdir, data, device)
    k2["phase13e anchor + the trained transformer LM"] = two

    # the overfit gates: each family at width 64 on 8 samples
    o = OVERFIT
    speech8 = (speech8[0][: o["utts"]], speech8[1], speech8[2])
    overfit_family("phase13 transducer", overfit_model_cfg(transducer_cfg), speech8, device)
    overfit_family("phase13 ctc", overfit_model_cfg(ctc_cfg), speech8, device)
    wave8 = next(iter(FeatureLoader(bn_cfg, "train", batch_size=o["utts"], seed=3)))
    overfit_family("phase13 BatchNorm conformer", overfit_model_cfg(bn_cfg["model"]), wave8, device,
                   frontend=frontend)
    vocab = os.path.join(data, "vocab")
    text = os.path.join(data, "train", "text")
    ds = TextDataset({"src_vocab": vocab, "tgt_vocab": vocab}, {"src": [text], "tgt": [text]})
    text8 = collate_text([ds[i] for i in range(o["utts"])])
    d = o["d_model"]
    overfit_family("phase13 rnn_lm", {"type": "rnn_lm", "vocab_size": 4233, "num_layers": 2,
                                      "hidden_size": d}, text8, device)
    overfit_family("phase13 transformer_lm", {"type": "transformer_lm", "vocab_size": 4233,
                                              "num_blocks": 2, "d_model": d, "n_heads": 4,
                                              "d_ff": 256}, text8, device)
    log(f"phase13 wall {time.time() - t_phase:.1f} s")
    return k1, k2, k3


# ---------------------------------------------------------------- phase 14
# reference checkpoints in and out, the eval CLI's -m/-c/-d, resumed and
# supervised MixSpeech training with the fused update
REFERENCE = dict(anchor_utts=500, sba_utts=100, ref_utts=16, ref_max_len=16, ref_seed=23,
                 fault_step=3, epochs=3, time_reps=4, cut_width=False)


def counting(cls, name: str):
    """Wrap ``cls.name`` to count its calls → (the count list, an undo)."""
    orig = getattr(cls, name)
    count = [0]

    def wrapped(self, *args, **kwargs):
        count[0] += 1
        return orig(self, *args, **kwargs)

    setattr(cls, name, wrapped)
    return count, lambda: setattr(cls, name, orig)


def flat_arrays(tree) -> dict:
    """{"//"-joined path: float32 array} of a variables tree."""
    from opentransformer_tpu_torch import compat

    return {"//".join(k): np.asarray(v, np.float32) for k, v in compat._flatten(tree)}


def cli_decode(tag: str, argv: list, decode_dir: str, device: str):
    """``cli/eval.py argv`` → (RESULT lines, kernel-1 launches, kernel-2
    launches, beam steps: calls of the speech2text cached top-k step);
    raises unless it wrote ``decode_dir``."""
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.models.speech2text import SpeechToText
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    project_logp_topk.launches = project2_logp_topk.launches = 0
    steps, undo = counting(SpeechToText, "decode_step_topk")
    t0 = time.time()
    try:
        rc = eval_cli.main([*argv, *([] if device == "cuda" else ["--device", device])])
    finally:
        undo()
    if rc != 0 or not os.path.isdir(decode_dir):
        raise AssertionError(f"{tag}: the eval CLI returned {rc} without {decode_dir}")
    with open(os.path.join(decode_dir, "RESULT")) as f:
        result = f.read().splitlines()
    one, two = project_logp_topk.launches, project2_logp_topk.launches
    log(f"{tag}: {' | '.join(result)} | kernel launches one-head {one} two-head {two}, beam "
        f"steps {steps[0]} | {os.path.basename(decode_dir)} | wall {time.time() - t0:.1f} s")
    return result, one, two, steps[0]


def anchor_conf(workdir: str, data: str) -> str:
    """``conf/anchor.json`` with its data paths on the synthetic dir."""
    with open(ANCHOR_CONF, encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["data"]["vocab"] = os.path.join(data, "vocab")
    for split in ("train", "dev", "test"):
        cfg["data"][split] = {"feat": [os.path.join(data, split, "feats.scp")],
                              "text": [os.path.join(data, split, "text")]}
    return write_conf(workdir, "anchor_synth", cfg)


def sba_sorted(decode_dir: str) -> int:
    """Utterances of ``predict.log``; raises unless each n-best list is in
    descending score / (tokens + 1) and ``predict.txt`` holds its head."""
    nbest: dict[str, list] = {}
    with open(os.path.join(decode_dir, "predict.log")) as f:
        for line in f:
            utt, _, score, *units = line.split()
            nbest.setdefault(utt, []).append((float(score.split("=")[1]), units))
    with open(os.path.join(decode_dir, "predict.txt")) as f:
        best = {u: rest for u, *rest in (line.split() for line in f)}
    for utt, hyps in nbest.items():
        avg = [s / (len(units) + 1) for s, units in hyps]
        if avg != sorted(avg, reverse=True) or best[utt] != hyps[0][1]:
            raise AssertionError(f"{decode_dir}: {utt}'s n-best is not ranked by score / length")
    return len(nbest)


def phase14a_anchor_pt(workdir: str, data: str, device: str):
    """The committed anchor through a reference .pt: export, import
    (bitwise), anchor.sh's decode with -m anchor.pt, with a reference LM
    .pt at -lmw 0.0, and -ns/-sba/-s. Returns (k1 launches, k2 launches)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_export_reference
    import torch_import_reference

    c = REFERENCE
    dev_flags = [] if device == "cuda" else ["--device", device]
    ref = os.path.join(workdir, "ref")
    pt = os.path.join(ref, "anchor.pt")
    t0 = time.time()
    torch_export_reference.main([ANCHOR + ".npz", pt, "--model_cfg", ANCHOR + ".manifest.json",
                                 *dev_flags])
    conf = anchor_conf(workdir, data)
    torch_import_reference.main([pt, os.path.join(workdir, "imported"), "-c", conf, *dev_flags])
    got = flat_arrays(compat.load_npz(os.path.join(workdir, "imported", "model.imported",
                                                   "params.npz")))
    want = flat_arrays(compat.load_npz(ANCHOR + ".npz"))
    same = got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    log(f"phase14a anchor npz -> tools/torch_export_reference.py -> anchor.pt "
        f"({os.path.getsize(pt) / 1e6:.1f} MB) -> tools/torch_import_reference.py: {len(got)} "
        f"arrays, bitwise equal to the npz as float32: {same} ({time.time() - t0:.1f} s)")
    if not same:
        raise AssertionError("phase14a: the reference round trip changed the anchor's arrays")

    base = ["-m", pt, "-c", conf, "-bw", "5", "-pn", "0.6", "-ml", "32", "-b", "100",
            "-d", "test"]
    out = os.path.join(ref, "decode_test_bw5_pn0.6_ml32")
    result, one, two, steps = cli_decode("phase14a anchor.pt -m/-c/-d decode", base, out, device)
    cer = float(result[0].split()[1].rstrip("%"))
    differ = ids_differing_from_jax(out, os.path.join(data, "vocab"))
    ok = (cer <= ANCHOR_CER_LIMIT and differ <= ANCHOR_ID_LIMIT and two == 0 and steps > 0
          and one == (steps if device == "cuda" else 0))
    log(f"phase14a anchor.pt: CER {cer}% (limit {ANCHOR_CER_LIMIT}%), 1-best ids differ from "
        f"the JAX package's on {differ} of {c['anchor_utts']} (limit {ANCHOR_ID_LIMIT}), kernel-1 "
        f"launches {one} = beam steps {steps}, kernel-2 launches {two} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase14a: the anchor.pt decode failed its gates (see above)")
    k1 = {"phase14a anchor.pt, cli/eval.py -m -c -d test (k=5)": one}

    # phase 4's seeded LM as a reference LM .pt, at weight 0
    d_model = ANCHOR_LM_CFG["d_model"]
    lm = build_model(ANCHOR_LM_CFG, device=device)
    compat.load_into(lm, seeded_params(lm, seed=11, embedding_std=d_model ** -0.5))
    lm_pt = os.path.join(ref, "lm.pt")
    torch.save(compat.export_reference_checkpoint(lm, {"model": ANCHOR_LM_CFG}), lm_pt)
    out = os.path.join(ref, "decode_test_bw5_pn0.6_ml32_lm0.0")
    result, one, two, steps = cli_decode("phase14a anchor.pt + lm.pt at -lmw 0.0",
                                         [*base, "-lm", lm_pt, "-lmw", "0.0"], out, device)
    cer = float(result[0].split()[1].rstrip("%"))
    ok = cer <= ANCHOR_CER_LIMIT and one == 0 and (two > 0 if device == "cuda" else two == 0)
    log(f"phase14a anchor.pt + reference LM .pt at weight 0: CER {cer}% (limit "
        f"{ANCHOR_CER_LIMIT}%), kernel-1 launches {one}, kernel-2 launches {two} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase14a: the decode with the reference LM failed its gates")
    k2 = {"phase14a anchor.pt + reference lm.pt at -lmw 0.0": two}

    out = os.path.join(ref, "decode_test_bw5_pn0.6_ml32_sba")
    result, one, _, steps = cli_decode(
        "phase14a anchor.pt -ns 100 -sba -s sba",
        [*base, "-ns", str(c["sba_utts"]), "-sba", "-s", "sba"], out, device)
    n = sba_sorted(out)
    utts = int(result[3].split()[1])
    if not (n == utts == c["sba_utts"] and one == (steps if device == "cuda" else 0)):
        raise AssertionError(f"phase14a -ns/-sba: {utts} utterances decoded, {n} in predict.log")
    log(f"phase14a -ns {c['sba_utts']} -sba: {n} utterances, every n-best ranked by score / "
        "length ok")
    k1["phase14a anchor.pt -ns 100 -sba (k=5)"] = one
    return k1, k2


def reference_models() -> dict:
    """The two full-width reference-layout models of phase 14b: a
    ``ref_compat`` BatchNorm conformer_baseline and a transformer_baseline
    with concat_after and front_end_layer_norm (cut to 2 + 1 blocks with
    ``cut_width``)."""
    conformer = conformer_model_cfg("conformer_baseline")
    conformer["encoder"].update(conv_norm_type="batch", ref_compat=True)
    with open(TRAIN_CONF, encoding="utf-8") as f:
        transformer = json.load(f)["model"]
    transformer["encoder"]["concat_after"] = True
    transformer["decoder"]["concat_after"] = True
    transformer["frontend"]["front_end_layer_norm"] = True
    if REFERENCE["cut_width"]:
        conformer["encoder"]["nblocks"] = transformer["encoder"]["n_blocks"] = 2
        conformer["decoder"]["n_blocks"] = transformer["decoder"]["n_blocks"] = 1
    return {"conformer_baseline": conformer, "transformer_baseline": transformer}


def write_feature_split(root: str, feats, mask, targets, vocab: str) -> dict:
    """Seeded features and targets as a kaldi test split (arks, text)."""
    from opentransformer_tpu_torch.data import load_idx2unit_map
    from opentransformer_tpu_torch.data.kaldi_io import write_ark

    os.makedirs(root, exist_ok=True)
    idx2unit = load_idx2unit_map(vocab)
    utts = {f"ref{i:02d}": feats[i, : int(mask[i].sum())] for i in range(len(feats))}
    write_ark(os.path.join(root, "feats.ark"), utts, os.path.join(root, "feats.scp"))
    with open(os.path.join(root, "text"), "w", encoding="utf-8") as f:
        for i, utt in enumerate(utts):
            units = [idx2unit[int(t)] for t in targets[i, 1:] if t > 2]
            f.write(f"{utt} {' '.join(units)}\n")
    return {"feat": [os.path.join(root, "feats.scp")], "text": [os.path.join(root, "text")]}


def phase14b_reference_models(workdir: str, data: str, device: str) -> dict:
    """Seeded full-width reference models: the port's export to .pt and
    import (bitwise), then ``cli/eval.py -m x.pt -c`` at beam 5 against the
    in-process decode of the unexported model. Returns {path: k1 launches}."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.base import SpeechToTextRecognizer
    from opentransformer_tpu_torch.data import load_idx2unit_map

    c = REFERENCE
    vocab = os.path.join(data, "vocab")
    idx2unit = load_idx2unit_map(vocab)
    k1 = {}
    for name, cfg in reference_models().items():
        t0 = time.time()
        mel = cfg["frontend"]["input_size"]
        model = build_model(cfg, dtype=torch.float32, device=device)
        tree = seeded_params(model, c["ref_seed"])
        rng = np.random.default_rng(c["ref_seed"])
        for path, leaf in compat._flatten(tree.get("batch_stats", {})):
            node = tree["batch_stats"]
            for p in path[:-1]:
                node = node[p]
            node[path[-1]] = (rng.uniform(0.5, 1.5, leaf.shape) if path[-1] == "var"
                              else rng.normal(0.0, 0.1, leaf.shape)).astype(np.float32)
        compat.load_into(model, tree)
        root = os.path.join(workdir, f"ref_{name}")
        os.makedirs(root, exist_ok=True)
        pt = os.path.join(root, f"{name}.pt")
        torch.save(compat.export_reference_checkpoint(model, {"model": cfg}), pt)
        back, _ = compat.load_reference_any(pt)
        state = model.state_dict()
        same = sorted(back) == sorted(state) and all(
            torch.equal(back[k], v.cpu()) for k, v in state.items())
        feats, mask, targets = conformer_inputs(
            CONFORMER_INPUTS["inputs_seed"], c["ref_utts"], CONFORMER_INPUTS["frames"],
            CONFORMER_INPUTS["min_frames"], CONFORMER_INPUTS["min_units"],
            CONFORMER_INPUTS["max_units"], mel)
        split = write_feature_split(os.path.join(root, "data"), feats, mask, targets, vocab)
        run_cfg = {"data": {"dataset_type": "kaldi", "vocab": vocab, "batch_size": c["ref_utts"],
                            "test": split}, "model": cfg, "train": {}}
        conf = write_conf(root, "conf", run_cfg)
        out = os.path.join(root, f"decode_test_bw5_pn0.6_ml{c['ref_max_len']}")
        _, one, _, steps = cli_decode(
            f"phase14b {name} .pt", ["-m", pt, "-c", conf, "-bw", "5", "-ml",
                                     str(c["ref_max_len"]), "-d", "test"], out, device)
        with open(os.path.join(out, "predict.txt"), encoding="utf-8") as f:
            got = dict(line.rstrip("\n").split(" ", 1) for line in f)
        # the unexported model, in-process, on the loader's same batches
        model.eval()
        rec = SpeechToTextRecognizer(model, beam_width=5, max_len=c["ref_max_len"],
                                     idx2unit=idx2unit)
        want = {}
        for utt_ids, inputs, _ in FeatureLoader(run_cfg, "test", is_eval=True):
            texts, _ = rec.recognize(torch.as_tensor(inputs["inputs"]).to(device),
                                     torch.as_tensor(inputs["mask"]).to(device))
            want.update({u: t[0] for u, t in zip(utt_ids, texts)})
        ok = (same and got == want and len(got) == c["ref_utts"]
              and one == (steps if device == "cuda" else 0) and steps > 0)
        d_model = cfg["encoder"]["d_model"]
        log(f"phase14b {name} (d {d_model}, {sum(p.numel() for p in model.parameters())} "
            f"parameters): export -> .pt -> import bitwise {same}; cli/eval.py -m .pt -c beam 5 "
            f"1-bests equal to the in-process decode on {sum(got[u] == want[u] for u in want)} "
            f"of {len(want)}; kernel-1 launches {one} at D = {d_model} "
            f"({time.time() - t0:.1f} s) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"phase14b {name}: the reference round trip failed its gates")
        k1[f"phase14b {name} reference .pt decode (k=5, D={d_model})"] = one
    return k1


def supervised_train(tag: str, workdir: str, paths: dict, device: str):
    """phase 7's config for 3 epochs with MixSpeech, the fused update with
    a bfloat16 first moment, asynchronous saves and ``--supervise 1``, the
    fault armed at ``fault_step`` (epoch 1's update): → (expdir, the
    children's records, the config)."""
    from opentransformer_tpu_torch.cli import run as run_cli

    c = REFERENCE
    cfg = train_config(paths, epochs=c["epochs"])
    cfg["train"]["fused_update"] = True
    cfg["train"]["optimizer"]["adam_m_dtype"] = "bfloat16"
    if c["cut_width"]:
        cfg["model"] = overfit_model_cfg(cfg["model"])
    conf = write_conf(workdir, "supervised", cfg)
    expdir = os.path.join(workdir, "exp_supervised")
    marker, record = os.path.join(workdir, "fault.marker"), os.path.join(workdir, "record.jsonl")
    env = {"OT_FAULT_INJECT_STEP": str(c["fault_step"]), "OT_FAULT_INJECT_MARKER": marker,
           "PYTHONPATH": REPO}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.time()
    try:
        rc = run_cli.main(["-c", conf, "--expdir", expdir, "--log_interval", "1", "-s", "7",
                           "-ms", "--async-save", "--supervise", "1", "--record", record,
                           *([] if device == "cuda" else ["--device", device])])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with open(record, encoding="utf-8") as f:
        runs = [json.loads(line) for line in f]
    with open(marker, encoding="utf-8") as f:
        fired = f.read()
    log(f"{tag} supervised run (2 children) returned {rc} in {time.time() - t0:.1f} s; fault "
        f"marker {fired!r}; child records: {json.dumps(runs)}")
    if rc != 0:
        raise AssertionError(f"{tag}: the supervised training returned {rc}")
    return expdir, runs, cfg


def update_timing(tag: str, cfg: dict, device: str) -> dict:
    """Seconds per update of phase 7's config from float32 weights, the
    unfused and the fused update in turns on the same window of
    micro-batches (host clock, synchronised)."""
    from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.train.trainer import Trainer

    window = list(FeatureLoader(cfg, "train", seed=7))[: cfg["train"]["accum_steps"]]
    frontend = make_device_frontend(cfg["data"], device)
    trainers = {}
    for fused in (False, True):
        torch.manual_seed(0)
        model = build_model(cfg["model"], device=device).train()
        trainers[fused] = Trainer(dict(cfg["train"], fused_update=fused), model, frontend,
                                  torch.Generator(device=device).manual_seed(0))
    secs = {False: [], True: []}
    for fused in [False, True, True, False] * REFERENCE["time_reps"]:
        tr = trainers[fused]
        start = time.time()
        for b in window:
            tr.micro_step(b)
        tr.update()
        if device == "cuda":
            torch.cuda.synchronize()
        secs[fused].append(time.time() - start)
    med = {k: sorted(v[1:])[len(v[1:]) // 2] for k, v in secs.items()}
    log(f"{tag} seconds per update ({len(window)} micro-batches of {cfg['data']['batch_size']}, "
        f"host clock, the first of each dropped), in turns unfused/fused/fused/unfused: unfused "
        f"{[round(x, 4) for x in secs[False]]} median {med[False]:.4f} s, fused "
        f"{[round(x, 4) for x in secs[True]]} median {med[True]:.4f} s "
        f"[{card_line() if device == 'cuda' else device}]")
    return med


def phase14c_supervised_training(workdir: str, paths: dict, device: str):
    """transformer_baseline from phase 7's waveforms: resumed, supervised,
    mixed and fused training, then the trained expdir decoded by ``-m EXP
    -d dev --profile`` and the same checkpoint by ``--npz``. Returns
    (k3 launches of the children, k1 launches of the -m decode)."""
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.data.datasets import AudioDataset
    from opentransformer_tpu_torch.data.kaldi_io import write_ark

    c = REFERENCE
    cuda = device == "cuda"
    expdir, runs, cfg = supervised_train("phase14c", workdir, paths, device)
    crashed, resumed = runs if len(runs) == 2 else (None, None)
    with open(os.path.join(expdir, "model.epoch.0", "extra.json"), encoding="utf-8") as f:
        saved_step = json.load(f)["global_step"]
    micro = sum(len(r["losses"]) for r in runs)
    fbank = sum(r["launches"]["fbank_spec_mel"] for r in runs)
    per_epoch = -(-TRAIN_CORPUS["train"] // cfg["data"]["batch_size"])
    epochs = sorted(int(n.split(".")[-1]) for n in os.listdir(expdir)
                    if re.fullmatch(r"model\.epoch\.\d+", n))
    ok = (crashed is not None and "fault injection" in (crashed["error"] or "")
          and resumed["error"] is None and resumed["resumed_from"] == 0
          and resumed["first_step"] == saved_step
          and epochs == list(range(c["epochs"]))
          and micro == per_epoch * (len(crashed["epochs"]) + len(resumed["epochs"]))
          and fbank == (micro if cuda else 0)
          and all(np.isfinite(r["losses"]).all() and r["nan_skips"] == 0 for r in runs))
    log(f"phase14c: the fault fired once (child 1 ended with {crashed and crashed['error']!r} "
        f"at step {crashed and crashed['next_step']}), child 2 resumed at step "
        f"{resumed and resumed['first_step']} after the saved {saved_step}, epochs {epochs}; "
        f"kernel-3 launches {fbank} over {micro} micro-batches of both children; losses finite, "
        f"no NaN skip {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase14c: the supervised run failed its gates (see above)")

    # -m EXP -d dev with a profiler trace, and the same checkpoint by --npz
    prof = os.path.join(workdir, "profile_decode")
    out = os.path.join(expdir, "decode_dev_bw5_pn0.6_ml16")
    _, one, _, steps = cli_decode("phase14c -m EXP -d dev --profile",
                                  ["-m", expdir, "-d", "dev", "-bw", "5", "-ml", "16", "-b", "16",
                                   "--profile", prof], out, device)
    with open(os.path.join(prof, "trace.json"), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    ds = AudioDataset(cfg["data"], cfg["data"]["dev"], is_eval=True)
    feats_dir = os.path.join(workdir, "dev_feats")
    os.makedirs(feats_dir, exist_ok=True)
    write_ark(os.path.join(feats_dir, "feats.ark"), {ds[i][0]: ds[i][1] for i in range(len(ds))},
              os.path.join(feats_dir, "feats.scp"))
    npz_out = os.path.join(workdir, "decode_dev_npz")
    last = os.path.join(expdir, f"model.epoch.{c['epochs'] - 1}")
    eval_cli.main(["--npz", os.path.join(last, "params.npz"),
                   "--model_cfg", os.path.join(expdir, "config.json"),
                   "--feats", os.path.join(feats_dir, "feats.scp"),
                   "--text", cfg["data"]["dev"]["text"][0], "--vocab", cfg["data"]["vocab"],
                   "-bw", "5", "-ml", "16", "-b", "16", "--decode_dir", npz_out,
                   *([] if cuda else ["--device", device])])
    preds = []
    for d in (out, npz_out):
        with open(os.path.join(d, "predict.txt"), encoding="utf-8") as f:
            preds.append(dict(line.rstrip("\n").split(" ", 1) for line in f))
    ok = (preds[0] == preds[1] and len(preds[0]) == TRAIN_CORPUS["dev"] and len(events) > 0
          and one == (steps if cuda else 0) and (kernels > 0 or not cuda))
    log(f"phase14c -m EXP -d dev: {len(preds[0])} utterances, predict.txt equal to the --npz "
        f"decode of model.epoch.{c['epochs'] - 1}: {preds[0] == preds[1]}; torch.profiler trace "
        f"{len(events)} events, {kernels} device kernel events; kernel-1 launches {one} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase14c: the -m EXP decode failed its gates (see above)")
    timing_cfg = train_config(paths, epochs=1)
    if c["cut_width"]:
        timing_cfg["model"] = overfit_model_cfg(timing_cfg["model"])
    update_timing("phase14c transformer_baseline", timing_cfg, device)
    return fbank, one


def phase_reference(workdir: str, data: str, corpus: dict, device: str = "cuda"):
    """Phase 14 (module docstring): ``data`` holds phase 2's test split,
    ``corpus`` phase 7's wavs. Returns ({path: kernel-1 launches}, {path:
    kernel-2 launches}, {path: kernel-3 launches})."""
    t_phase = time.time()
    k1, k2 = phase14a_anchor_pt(workdir, data, device)
    k1.update(phase14b_reference_models(workdir, data, device))
    k3, one = phase14c_supervised_training(workdir, corpus, device)
    k1["phase14c -m EXP -d dev (k=5)"] = one
    log(f"phase14 wall {time.time() - t_phase:.1f} s")
    return k1, k2, {"phase14c supervised MixSpeech training (both children)": k3}


# ---------------------------------------------------------------- phase 15
# mixture of experts. conf/transformer_moe.json (the aishell YAML: d256, 12
# encoder blocks, every second one's FFN 4 experts of d_ff 1024, top-2,
# capacity 1.25, router jitter 0.01) is held on the card to the JAX
# package's CPU run of the same seeded weights on phase 11's 16 utterances
# (tools/torch_port_moe_parity.py --write): the memory projection within
# MOE_MEMORY_ATOL, teacher-forced log-probs within MOE_LOGP_ATOL, each MoE
# layer's load-balance loss within MOE_AUX_RTOL relative, each layer's
# routing (every choice's expert, kept or dropped) differing on at most
# MOE_ROUTING_SHARE of its tokens, and at most MOE_ID_LIMIT of the 16 beam-5
# 1-bests over 24 forced steps
MOE_NAME = "transformer_moe"
MOE_CONF = os.path.join(CONF_DIR, f"{MOE_NAME}.json")
MOE_FIXTURE = os.path.join(REPO, "egs", "synth_bench", "trained", "transformer_moe_seeded.jax.json")
MOE_STREAM_FIXTURE = os.path.join(REPO, "egs", "synth_bench", "trained",
                                  "conformer_streaming_moe.jax_stream.json")
MOE_INPUTS = dict(weights_seed=0, inputs_seed=5, probe_seed=9, utts=16, frames=500,
                  min_frames=300, min_units=8, max_units=24, mel=40, steps=24, beam=5)
MOE_MEMORY_ATOL = 2e-4
MOE_LOGP_ATOL = 3e-3
MOE_AUX_RTOL = 1e-4
MOE_ROUTING_SHARE = 1e-3
MOE_ID_LIMIT = 2
MOE_CARD_CPU_RTOL = 1e-4  # 15c: one micro-batch's loss and moe_aux, card against CPU
# 15d: conf/transformer_lm.json with a drop-free MoE FFN (capacity = E / k)
MOE_LM = dict(moe_experts=4, moe_top_k=1, moe_capacity_factor=4.0)
MOE_LM_SEED = 11
# 15e: conformer_streaming with a drop-free MoE second FFN (capacity = E / k)
MOE_STREAM = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=2.0)


def moe_lm_cfg() -> dict:
    return dict(conformer_model_cfg("transformer_lm"), **MOE_LM)


def moe_stream_cfg(ctc: bool = False) -> dict:
    """``conformer_streaming`` with ``MOE_STREAM``'s MoE; as a ``ctc`` model
    of its frontend and encoder with ``ctc``."""
    cfg = conformer_model_cfg(STREAM_NAME)
    cfg["encoder"] = dict(cfg["encoder"], **MOE_STREAM)
    if ctc:
        cfg = {"type": "ctc", "frontend_type": cfg["frontend_type"], "frontend": cfg["frontend"],
               "encoder_type": cfg["encoder_type"], "encoder": cfg["encoder"],
               "vocab_size": cfg["decoder"]["vocab_size"], "lookahead_steps": 0}
    return cfg


def routing_code(experts, kept, valid) -> str:
    """A layer's routing as text: one character per (choice, valid token),
    choice-major, tokens in row-major order: the expert's digit where the
    token was kept, its letter (``a`` = expert 0) where it was dropped."""
    e, k = np.asarray(experts)[:, valid], np.asarray(kept)[:, valid]
    return np.where(k, 48 + e, 97 + e).astype(np.uint8).tobytes().decode("ascii")


def routing_differ(got: str, want: str, top_k: int) -> float:
    """Share of a layer's tokens whose routing (any choice) differs."""
    a = np.frombuffer(got.encode(), np.uint8).reshape(top_k, -1)
    b = np.frombuffer(want.encode(), np.uint8).reshape(top_k, -1)
    return float((a != b).any(axis=0).mean()) if a.shape == b.shape else 1.0


class MoECalls:
    """While active, records every ``MoEFeedForward`` call of ``model``:
    its input, pad mask and load-balance loss. ``summary()`` gives, per
    layer name (``encoder.block_1.moe``), the loss and the routing's
    ``routing_code`` (the layer's ``route`` of the recorded input)."""

    def __init__(self, model):
        from opentransformer_tpu_torch.models.modules import MoEFeedForward

        self.modules = [(n, m) for n, m in model.named_modules() if isinstance(m, MoEFeedForward)]
        self.calls = []

    def __enter__(self):
        def hook(name):
            def record(module, args, kwargs, output):
                pm = args[1] if len(args) > 1 else kwargs.get("pad_mask")
                self.calls.append((name, module, args[0].detach(), pm, float(output[1])))
            return record

        self.handles = [m.register_forward_hook(hook(n), with_kwargs=True)
                        for n, m in self.modules]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def summary(self) -> tuple[dict, dict]:
        aux, codes = {}, {}
        for name, module, x, pm, loss in self.calls:
            with torch.no_grad():
                r = module.route(x, pm)
            valid = (np.ones(x.shape[:2], bool) if pm is None else pm.cpu().numpy())
            aux[name] = loss
            codes[name] = routing_code(r.experts.cpu().numpy(), r.kept.cpu().numpy(), valid)
        return aux, codes


def moe_outputs(model, feats, mask, targets, c: dict) -> dict:
    """``conformer_outputs`` of an MoE speech2text model, with each MoE
    layer's load-balance loss (``aux``) and routing (``routing``)."""
    with MoECalls(model) as rec:
        out = conformer_outputs(model, feats, mask, targets, c["steps"], c["beam"],
                                c["probe_seed"])
    out["aux"], out["routing"] = rec.summary()
    return out


def moe_parity(out: dict, want: dict, top_k: int) -> dict:
    """``conformer_parity`` plus the largest relative difference of a
    layer's load-balance loss (``aux``) and the largest share of a layer's
    tokens routed differently (``routing``)."""
    got = conformer_parity(out, want)
    if sorted(out["aux"]) != sorted(want["aux"]):
        raise AssertionError(f"MoE layers {sorted(out['aux'])}, the fixture's "
                             f"{sorted(want['aux'])}")
    got["aux"] = max(abs(out["aux"][n] - a) / abs(a) for n, a in want["aux"].items())
    got["routing"] = max(routing_differ(out["routing"][n], code, top_k)
                         for n, code in want["routing"].items())
    return got


def moe_parity_ok(got: dict) -> bool:
    return (got["memory"] <= MOE_MEMORY_ATOL and got["logp"] <= MOE_LOGP_ATOL
            and got["aux"] <= MOE_AUX_RTOL and got["routing"] <= MOE_ROUTING_SHARE
            and got["ids_differ"] <= MOE_ID_LIMIT and got["frames_differ"] == 0)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def seeded_checked(cfg: dict, seed: int, want: float, device="cuda", dtype=torch.float32):
    """``cfg`` with seeded weights, their checksum held to ``want`` → (model,
    its JAX-layout params)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model

    model = build_model(cfg, dtype=dtype, device=device)
    params = seeded_params(model, seed)
    if abs(checksum(params) - want) > 1e-9 * want:
        raise AssertionError(f"the seeded weights' checksum {checksum(params)!r} is not the "
                             f"fixture's {want!r} (numpy's random stream changed?)")
    return compat.load_into(model, params), params


class LogCount(logging.Handler):
    """Counts the records of a logger that contain ``needle``."""

    def __init__(self, logger: str, needle: str):
        super().__init__(logging.WARNING)
        self.logger, self.needle, self.count = logging.getLogger(logger), needle, 0

    def emit(self, record):
        self.count += self.needle in record.getMessage()

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def phase15a_parity(device: str) -> int:
    """15a: ``transformer_moe`` in float32 against the JAX fixture. Returns
    the kernel-1 launches of its beam."""
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    fixture = load_json(MOE_FIXTURE)
    c = fixture["inputs"]
    cfg = conformer_model_cfg(MOE_NAME)
    if cfg != fixture["config"]:
        raise AssertionError("phase15a: the committed transformer_moe config is not the fixture's")
    model, _ = seeded_checked(cfg, c["weights_seed"], fixture["checksums"]["weights"], device)
    feats, mask, targets = fixture_inputs(fixture)
    n_params = sum(p.numel() for p in model.parameters())
    n_moe = sum(p.numel() for n, p in model.named_parameters() if ".moe." in n)
    project_logp_topk.launches = project2_logp_topk.launches = 0
    t0 = time.time()
    out = moe_outputs(model, feats, mask, targets, c)
    one, two = project_logp_topk.launches, project2_logp_topk.launches
    got = moe_parity(out, fixture["results"], cfg["encoder"]["moe_top_k"])
    kept = np.mean([np.char.isdigit(np.array(list(code))).mean()
                    for code in out["routing"].values()])
    ok = (moe_parity_ok(got) and one == (c["steps"] if device == "cuda" else 0) and two == 0
          and bool(np.isfinite(out["logp"]).all() and np.isfinite(out["memory"]).all()))
    log(f"phase15a {MOE_NAME} f32 ({n_params} parameters, {n_moe} of them in "
        f"{len(out['aux'])} MoE layers), seeded weights, {c['utts']} utterances of "
        f"{c['min_frames']}-{c['frames']} frames x {c['mel']} mel, against JAX: encoder memory "
        f"(projected) max|d| {got['memory']:.3e} (atol {MOE_MEMORY_ATOL:.0e}; frame counts differ "
        f"on {got['frames_differ']}), teacher-forced log-probs max|d| {got['logp']:.3e} (atol "
        f"{MOE_LOGP_ATOL:.0e}), per-layer aux max relative {got['aux']:.2e} (limit "
        f"{MOE_AUX_RTOL:.0e}; values {[round(a, 6) for a in out['aux'].values()]}), routing "
        f"differs on at most {100 * got['routing']:.3f}% of a layer's tokens (limit "
        f"{100 * MOE_ROUTING_SHARE:.1f}%; {100 * kept:.2f}% of the choices kept), beam "
        f"{c['beam']} 1-best ids over {c['steps']} forced steps differ on {got['ids_differ']} <= "
        f"{MOE_ID_LIMIT} of {c['utts']}, kernel 1 launches {one}, two-head {two}, wall "
        f"{time.time() - t0:.1f} s {'ok' if ok else 'FAIL'} "
        f"[{card_line() if device == 'cuda' else device}]")
    if not ok:
        raise AssertionError("phase15a: a gate failed (see above)")
    return one


def moe_ffn_ms(d_model: int, d_ff: int, moe_kw: dict, rows: int, frames: int) -> dict:
    """Device time (``torch.profiler``: the summed kernel durations, so the
    parts add up) of one MoE FFN call, of its routing alone and of its
    expert products alone (the two batched products and the GLU over the E
    buffers of ``rows`` x capacity rows), against one dense GLU FFN of the
    same d_ff and of 2·d_ff, bf16, on x [rows, frames, d_model]; and the
    back-to-back time (CUDA events, the host's launches included) of the
    MoE call and of the 2·d_ff FFN. What the call's device time holds
    beyond routing and experts is the dispatch: the buffer slots' scatter,
    the gathers and the combine."""
    from opentransformer_tpu_torch.models.modules import MoEFeedForward, PositionwiseFeedForward

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(rows, frames, d_model, generator=g, device="cuda", dtype=torch.bfloat16)
    moe = MoEFeedForward(d_model, d_ff, activation="glu", **moe_kw).cuda().bfloat16().eval()
    dense = PositionwiseFeedForward(d_model, d_ff, "glu").cuda().bfloat16().eval()
    wide = PositionwiseFeedForward(d_model, 2 * d_ff, "glu").cuda().bfloat16().eval()
    xe = torch.randn(moe.n_experts, rows * moe.capacity(frames), d_model, generator=g,
                     device="cuda", dtype=torch.bfloat16)

    def experts():
        a, b = (torch.bmm(xe, moe.w1) + moe.b1[:, None, :]).chunk(2, dim=-1)
        return torch.bmm(a * torch.sigmoid(b), moe.w2) + moe.b2[:, None, :]

    parts = {"moe": lambda: moe(x), "route": lambda: moe.route(x), "experts": experts,
             "dense": lambda: dense(x), "dense_2x": lambda: wide(x)}
    with torch.inference_mode():
        out = {k: device_ms_cold(lambda _, f=f: f(), [None], iters=20) for k, f in parts.items()}
        out.update(moe_host=cuda_ms(parts["moe"], iters=20),
                   dense_2x_host=cuda_ms(parts["dense_2x"], iters=20))
    return out


def phase15b_worst_case(flagship_secs: float) -> int:
    """15b: ``transformer_moe`` through phase 3's worst case, its encode
    alone beside the dense flagship's (in turns), and one MoE FFN call
    beside a dense one. Returns the kernel-1 launches."""
    cfg = conformer_model_cfg(MOE_NAME)
    model = seeded_model(cfg, torch.bfloat16, seed=MOE_INPUTS["weights_seed"])
    one, two, secs, _, _ = worst_case_decode(f"phase15b {MOE_NAME}", model)
    if one != WORST_CASE["max_len"] or two != 0:
        raise AssertionError(f"phase15b: expected one one-head kernel launch per decode step "
                             f"({WORST_CASE['max_len']}) and no two-head launch, counted {one} "
                             f"and {two}")
    dense = seeded_model(FLAGSHIP_CFG, torch.bfloat16, seed=0)
    runs = {"moe": worst_case_run(model, encode_only=True),
            "dense": worst_case_run(dense, encode_only=True)}
    peak = {}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    times = {"moe": [], "dense": []}
    for order in (("dense", "moe"), ("moe", "dense"), ("dense", "moe")):
        for name in order:
            times[name].append(host_seconds(runs[name]))
    med = {k: sorted(v)[1] for k, v in times.items()}
    enc = cfg["encoder"]
    frames = model.frontend.output_length(WORST_CASE["frames"])
    ffn = moe_ffn_ms(enc["d_model"], enc["d_ff"],
                     dict(n_experts=enc["moe_experts"], top_k=enc["moe_top_k"],
                          capacity_factor=enc["moe_capacity_factor"]),
                     WORST_CASE["batch"], frames)
    log(f"phase15b {MOE_NAME} bf16 worst case: decode median {secs:.3f} s against phase 3's dense "
        f"flagship {flagship_secs:.3f} s (same decoder); encode alone, in turns: MoE median "
        f"{med['moe']:.3f} s of {[round(t, 3) for t in times['moe']]}, dense flagship "
        f"{med['dense']:.3f} s of {[round(t, 3) for t in times['dense']]}, peak memory of an "
        f"encode MoE {peak['moe']:.2f} GiB, dense {peak['dense']:.2f} GiB; one FFN at "
        f"[{WORST_CASE['batch']}, {frames}, {enc['d_model']}]: MoE ({enc['moe_experts']} x "
        f"d_ff {enc['d_ff']}, top-{enc['moe_top_k']}, capacity {enc['moe_capacity_factor']}) "
        f"device time {ffn['moe']:.3f} ms: routing {ffn['route']:.3f} ms, expert products "
        f"{ffn['experts']:.3f} ms, the dispatch and combine the other "
        f"{ffn['moe'] - ffn['route'] - ffn['experts']:.3f} ms; dense d_ff {enc['d_ff']} "
        f"{ffn['dense']:.3f} ms, dense d_ff {2 * enc['d_ff']} {ffn['dense_2x']:.3f} ms; "
        f"back-to-back (the host's launches included) MoE {ffn['moe_host']:.3f} ms, dense d_ff "
        f"{2 * enc['d_ff']} {ffn['dense_2x_host']:.3f} ms [{card_line()}]")
    return one


def phase15c_training(workdir: str, corpus: dict, device: str):
    """15c: ``transformer_moe`` through the training CLI on phase 7's wavs
    (``cli_train``; router jitter and dropout on), every update's
    ``moe_aux`` finite, one micro-batch's loss and ``moe_aux`` on the card
    against the CPU (jitter and dropout off), and the width-64 overfit.
    Returns (kernel-3 launches, kernel-1 launches of the reload check)."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    model_cfg = overfit_model_cfg(conformer_model_cfg(MOE_NAME)) if device != "cuda" else None
    trainer, cfg, fbank = cli_train("phase15c", workdir, corpus, device, model_cfg=model_cfg,
                                    conf=MOE_CONF)
    beam_launches = project_logp_topk.launches
    aux = [x for r in trainer.history for x in r.get("aux", {}).get("moe_aux", [])]
    n_micro = sum(len(r["losses"]) for r in trainer.history)
    model = trainer.model.eval()
    _, inputs, tg = next(iter(FeatureLoader(cfg, "train", seed=7)))
    w = torch.as_tensor(inputs["waveforms"]).to(device)
    wl = torch.as_tensor(inputs["wave_lengths"]).to(device)
    with torch.no_grad():
        feats, mask = trainer.frontend(w, wl, trainer.generator, train=False)
    targets = torch.as_tensor(tg["targets"]).long()
    tlen = torch.as_tensor(tg["targets_length"]).long()
    on_cpu = compat.load_into(build_model(cfg["model"], device="cpu"), compat.params_to_jax(model))
    with torch.no_grad():
        loss, parts = model(feats, mask, targets.to(device), tlen.to(device))
        loss_c, parts_c = on_cpu(feats.cpu(), mask.cpu(), targets, tlen)
    rel = max(abs(loss.item() - loss_c.item()) / abs(loss_c.item()),
              abs(parts["moe_aux"].item() - parts_c["moe_aux"].item()) / parts_c["moe_aux"].item())
    ok = (len(aux) == n_micro and bool(np.isfinite(aux).all()) and rel <= MOE_CARD_CPU_RTOL
          and (beam_launches > 0) == (device == "cuda"))
    log(f"phase15c moe_aux of the trainer's {n_micro} micro-batches (the run's and the timing's; jitter "
        f"{cfg['model']['encoder']['moe_router_jitter']}, residual dropout "
        f"{cfg['model']['encoder']['residual_dropout']}): {[round(a, 4) for a in aux]}, all "
        f"finite; one micro-batch ({tuple(feats.shape)}) in eval mode on {device} against the "
        f"CPU: loss {loss.item():.6f} vs {loss_c.item():.6f}, moe_aux "
        f"{parts['moe_aux'].item():.6f} vs {parts_c['moe_aux'].item():.6f}, max relative "
        f"{rel:.2e} (limit {MOE_CARD_CPU_RTOL:.0e}); the reload check's beam-5 decode took "
        f"{beam_launches} kernel-1 launches {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase15c: a gate failed (see above)")
    wave8 = next(iter(FeatureLoader(cfg, "train", batch_size=OVERFIT["utts"], seed=3)))
    overfit_family("phase15c transformer_moe", overfit_model_cfg(cfg["model"]), wave8, device,
                   frontend=trainer.frontend)
    return fbank, beam_launches


def phase15d_lm(workdir: str, data: str, device: str) -> int:
    """15d: the drop-free MoE transformer LM: fused and unfused decodes
    agree on a small input, the anchor at ``-lmw 0.0`` through kernel 2
    alone, and the drop-free warning at capacity 1.25. Returns the kernel-2
    launches of the anchor decode."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.recognize.base import make_memory_search

    cfg = moe_lm_cfg()
    d_model = cfg["d_model"]
    lm32 = build_model(cfg, device=device)
    params = seeded_params(lm32, MOE_LM_SEED, embedding_std=d_model ** -0.5)
    compat.load_into(lm32, params)
    if device == "cuda":
        small_input_check("phase15d flagship f32 + MoE transformer LM",
                          seeded_model(FLAGSHIP_CFG, torch.float32, seed=0), lm32)
    lm_npz, lm_json = os.path.join(workdir, "moe_lm.npz"), os.path.join(workdir, "moe_lm.json")
    compat.save_npz(lm_npz, params)
    with open(lm_json, "w") as f:
        json.dump(cfg, f)
    cer, one, two, differ = anchor_decode(
        "phase15d anchor f32 + MoE transformer LM, -lmw 0.0", data,
        os.path.join(workdir, "decode_moe_lm"), "float32",
        ("-lm", lm_npz, "--lm_cfg", lm_json, "-lmw", "0.0", "--device", device))
    binding = build_model(dict(cfg, moe_capacity_factor=1.25), device=device)
    with LogCount("opentransformer_tpu_torch.recognize.base", "MoE LM built for recognition") as c:
        make_memory_search(build_model(FLAGSHIP_CFG, device=device), 5, 8, lm=binding)
    ok = (cer <= ANCHOR_CER_LIMIT and differ <= ANCHOR_ID_LIMIT and one == 0
          and (two > 0) == (device == "cuda") and c.count == 1)
    log(f"phase15d MoE LM ({MOE_LM}, {sum(p.numel() for p in lm32.parameters())} parameters) at "
        f"-lmw 0.0: CER {cer}% <= {ANCHOR_CER_LIMIT}%, 1-best ids differ from JAX's on {differ} <= "
        f"{ANCHOR_ID_LIMIT} of 500, two-head launches {two}, one-head {one}; at capacity 1.25 the "
        f"drop-free warning logged {c.count} time(s) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase15d: a gate failed (see above)")
    return two


def moe_stream_outputs(model, ctc_model, feats, mask, probe) -> dict:
    """The MoE conformer's streamed numbers: projections through the session
    (``session``, with the memories) and through ``MultiStreamAttention``
    with a slot reused (``multi``: {utterance or "again": projection}, the
    reused slot's first utterance left out), and ``MultiStreamCTC``'s ids
    with its ticks and kernel-1 launches."""
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.multistream import MultiStreamAttention, MultiStreamCTC

    dev = next(model.parameters()).device
    pr = torch.from_numpy(probe).to(dev)
    mems = session_memory(model, feats, mask)
    out = {"session_mem": mems, "session": [as_numpy(m.float() @ pr) for m in mems]}
    ms = MultiStreamAttention(model, n_streams=len(feats), **STREAM_SEARCH)
    slots, _ = multistream_reuse(ms, feats, mask)
    reused = [k for k, s in slots.items() if k != "again" and s == slots["again"]]
    out["multi"] = {k: as_numpy(ms._mem[s].view().float() @ pr) for k, s in slots.items()
                    if k not in reused}
    project_logp_topk.launches = 0
    ms = MultiStreamCTC(ctc_model, n_streams=len(feats))
    _, finals = staggered(ms, feats, mask)
    out["ctc"] = [[int(x) for x in finals[i].split()] for i in range(len(feats))]
    out["ctc_launches"], out["ctc_ticks"] = project_logp_topk.launches, ms.ticks
    return out


def moe_stream_parity(out: dict, fixture: dict) -> dict:
    """The largest |Δ| of the session's and the multi-stream's projections
    against the fixture's (``again`` held to utterance 0), the utterances
    whose frame counts differ and the CTC id lists that differ."""
    want = [np.asarray(m, np.float32) for m in fixture["stream"]["memory"]]
    got = {"session": 0.0, "multi": 0.0, "frames_differ": 0}
    pairs = [("session", m, want[i]) for i, m in enumerate(out["session"])]
    pairs += [("multi", m, want[0 if k == "again" else k]) for k, m in out["multi"].items()]
    for key, mine, theirs in pairs:
        if len(mine) != len(theirs):
            got["frames_differ"] += 1
            continue
        got[key] = max(got[key], float(np.abs(mine - theirs).max()))
    got["ctc_differ"] = sum(a != b for a, b in zip(out["ctc"], fixture["ctc"]["ids"]))
    return got


def phase15e_streaming(device: str) -> int:
    """15e: the drop-free MoE ``conformer_streaming`` streamed, against the
    port's offline chunk-masked encode and the JAX fixture; a ctc head
    through ``MultiStreamCTC``; the capacity warning at capacity 1.25.
    Returns the kernel-1 launches of the CTC stream."""
    from opentransformer_tpu_torch.models.registry import build_model

    fixture = load_json(MOE_STREAM_FIXTURE)
    c = fixture["inputs"]
    if moe_stream_cfg() != fixture["config"]:
        raise AssertionError("phase15e: the MoE streaming config is not the fixture's")
    feats, mask, _ = fixture_inputs(load_conformer_fixture())
    model, _ = seeded_checked(moe_stream_cfg(), c["weights_seed"],
                              fixture["checksums"]["weights"], device)
    ctc_model, _ = seeded_checked(moe_stream_cfg(ctc=True), c["ctc_weights_seed"],
                                  fixture["checksums"]["ctc_weights"], device)
    probe = memory_probe(model.encoder.d_model, c["probe_seed"])
    t0 = time.time()
    out = moe_stream_outputs(model, ctc_model, feats, mask, probe)
    got = moe_stream_parity(out, fixture)
    off_err = offline_memory_err(model, feats, mask, out["session_mem"])
    offline_ids = offline_ctc_ids(ctc_model, feats, mask)
    off_differ = sum(a != b for a, b in zip(out["ctc"], offline_ids))
    enc = dict(moe_stream_cfg()["encoder"], moe_capacity_factor=1.25)
    binding = build_model(dict(moe_stream_cfg(), encoder=enc), device=device)
    with LogCount("opentransformer_tpu_torch.models.encoder", "streaming an MoE encoder") as w:
        binding.encoder.init_stream_cache(1)
    ok = (max(got["session"], got["multi"]) <= STREAM_MEMORY_ATOL and got["frames_differ"] == 0
          and off_err <= STREAM_OFFLINE_ATOL and got["ctc_differ"] <= STREAM_CTC_ID_LIMIT
          and off_differ == 0 and w.count == 1
          and out["ctc_launches"] == (out["ctc_ticks"] if device == "cuda" else 0))
    log(f"phase15e {STREAM_NAME} with MoE {MOE_STREAM} f32 streamed, 16 utterances in "
        f"{STREAM_CHUNK_FRAMES}-frame feeds + tail: memory projection vs JAX's streamed one "
        f"through StreamingEncoderSession max|d| {got['session']:.3e}, through "
        f"MultiStreamAttention (16 slots, one reused: {len(out['multi'])} streams compared) "
        f"{got['multi']:.3e} (atol {STREAM_MEMORY_ATOL:.0e}; frame counts differ on "
        f"{got['frames_differ']}); streamed memory vs the port's offline chunk-masked encode "
        f"max|d| {off_err:.3e} (atol {STREAM_OFFLINE_ATOL:.0e}); MultiStreamCTC ids differ from "
        f"JAX's on {got['ctc_differ']} <= {STREAM_CTC_ID_LIMIT}, from the port's offline greedy "
        f"on {off_differ} of 16, kernel 1 launches {out['ctc_launches']} = ticks "
        f"{out['ctc_ticks']}; capacity warning at 1.25 logged {w.count} time(s); wall "
        f"{time.time() - t0:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase15e: a gate failed (see above)")
    return out["ctc_launches"]


def phase_moe(workdir: str, data: str, corpus: dict, flagship_secs: float,
              device: str = "cuda"):
    """Phase 15 (module docstring): ``data`` holds phase 2's test split,
    ``corpus`` phase 7's wavs. Returns ({path: kernel-1 launches}, {path:
    kernel-2 launches}, {path: kernel-3 launches})."""
    t_phase = time.time()
    k1 = {"phase15a transformer_moe decode (k=5)": phase15a_parity(device)}
    if device == "cuda":
        k1["phase15b transformer_moe worst case"] = phase15b_worst_case(flagship_secs)
    fbank, beam = phase15c_training(workdir, corpus, device)
    k1["phase15c transformer_moe checkpoint beam 5"] = beam
    two = phase15d_lm(workdir, data, device)
    k1["phase15e MultiStreamCTC, MoE conformer (k=1)"] = phase15e_streaming(device)
    log(f"phase15 wall {time.time() - t_phase:.1f} s")
    return (k1, {"phase15d anchor + MoE transformer LM at -lmw 0.0": two},
            {"phase15c transformer_moe training": fbank})


# ---------------------------------------------------------------- phase 16
# parallelism on torch.distributed (opentransformer_tpu_torch/parallel/). The
# card is one H100: NCCL will not put two ranks of one communicator on one
# device, so 16a drives every mode's code at world 1 through the CLIs (an
# NCCL process group, but every axis has one rank, so the port issues no
# collective), and 16b runs two ranks on the one card over whichever backend
# carries each mode (Gloo here): no run on this machine moves data over NCCL
PARALLEL = dict(train_utts=16, batch=8, eval_utts=101, eval_batch=50, loss_rtol=1e-5,
                grad_rtol=1e-3, probe_timeout=120, cut_width=False)
PARALLEL_16A = [  # (config, scan_layers, the CLI's parallel flags of each run)
    ("transformer_baseline", True, [["-n", "1", "--tp", "1", "--pp", "1", "--ep", "1"],
                                    ["--pp-schedule", "sharded"],
                                    ["--pp-schedule", "1f1b", "--pp-micro-batches", "2"]]),
    (MOE_NAME, False, [["-n", "1", "--ep", "1"]]),
]
# 16b: (mode, config, (data, model, pipe, expert), pipe schedule); "one rank"
# is the plain step in each rank's process, the peak memory the modes' face
PARALLEL_16B = [("one rank", "transformer_baseline", None, None),
                ("dp 2", "transformer_baseline", (2, 1, 1, 1), None),
                ("tp 2", "transformer_baseline", (1, 2, 1, 1), None),
                ("pp 2 sharded", "transformer_baseline", (1, 1, 2, 1), "sharded"),
                ("pp 2 1f1b", "transformer_baseline", (1, 1, 2, 1), "1f1b"),
                ("ep 2", MOE_NAME, (1, 1, 1, 2), None)]


def parallel_cfg(workdir: str, corpus: dict, name: str, scan: bool, device: str) -> dict:
    """``conf/<name>.json`` on the first ``train_utts`` of phase 7's wavs in
    batches of ``batch``, one epoch, without SpecAugment, dropout or router
    jitter (so every mode's numbers can be held to another's), the encoder
    ``scan_layers`` when asked; at a cut width off the card."""
    root = os.path.join(workdir, "parallel_corpus")
    os.makedirs(root, exist_ok=True)
    scp = os.path.join(root, "train.wav.scp")
    text = os.path.join(root, "train.text")
    for src, dst in ((corpus["train"][0], scp), (corpus["train"][1], text)):
        with open(src) as f:
            lines = f.read().splitlines()[: PARALLEL["train_utts"]]
        with open(dst, "w") as f:
            f.write("\n".join(lines) + "\n")
    model_cfg = None
    if PARALLEL["cut_width"] or device != "cuda":
        with open(os.path.join(CONF_DIR, f"{name}.json")) as f:
            model_cfg = overfit_model_cfg(json.load(f)["model"])
    cfg = train_config(dict(corpus, train=(scp, text)), epochs=1, model_cfg=model_cfg,
                       conf=os.path.join(CONF_DIR, f"{name}.json"))
    cfg["data"].update(batch_size=PARALLEL["batch"], spec_augment=False)
    cfg["train"]["accum_steps"] = 1
    enc, dec = cfg["model"]["encoder"], cfg["model"]["decoder"]
    enc.update(residual_dropout=0.0, moe_router_jitter=0.0)
    dec["residual_dropout"] = 0.0
    if scan:
        enc["scan_layers"] = True
    return cfg


def losses_of(trainer) -> list:
    return [x for r in trainer.history for x in r["losses"]]


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-12)))


def microbatch_reference(cfg: dict, device: str, n_micro: int = 2) -> list:
    """The 1F1B loss rule on the plain trainer: each batch's features made
    whole, its ``n_micro`` row blocks forward and backward with the loss
    over ``n_micro`` (accumulation), one update; the mean of the blocks'
    losses a batch."""
    from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.train.trainer import Trainer

    torch.manual_seed(7)
    model = build_model(cfg["model"], dtype=torch.float32, device=device)
    loader = FeatureLoader(cfg, "train", seed=7)
    loader.set_epoch(0)
    trainer = Trainer(dict(cfg["train"], accum_steps=n_micro), model,
                      make_device_frontend(cfg["data"], device),
                      torch.Generator(device=device).manual_seed(7))
    model.train()
    out = []
    for batch in loader:
        for loss in row_blocks_backward(model, trainer.batch_args(batch), n_micro):
            trainer._window.append(loss)
            trainer._window_aux.append({})
        out.append(float(np.mean(trainer.update()["losses"])))
    return out


def row_blocks_backward(model, args, n: int) -> list:
    """Forward and backward of ``n`` row blocks of a batch's arguments, each
    loss over ``n`` (the 1F1B rule's gradient); returns the blocks' losses."""
    rows = args[0].shape[0] // n
    losses = []
    for m in range(n):
        loss, _ = model(*(a[m * rows : (m + 1) * rows] for a in args))
        (loss / n).backward()
        losses.append(loss.detach())
    return losses


def update_ms(trainer, cfg: dict, device: str, reps: int = 4) -> float:
    """Median milliseconds of an update (one micro-batch of ``batch`` and the
    step, host clock to a synchronize), after a first one."""
    from opentransformer_tpu_torch.data.loader import FeatureLoader

    batch = next(iter(FeatureLoader(cfg, "train", seed=7)))
    trainer.model.train()
    secs = []
    for _ in range(reps):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        trainer.micro_step(batch)
        trainer.update()
        if device == "cuda":
            torch.cuda.synchronize()
        secs.append(time.time() - t0)
    return float(np.median(secs[1:]) * 1e3)


def phase16a_world_one(workdir: str, corpus: dict, device: str):
    """16a: each mode through the training CLI at world 1 (an NCCL process
    group on the card, whose one rank issues no collective) against the
    plain trainer on the same seed (the 1F1B run against its loss rule on
    the plain trainer), an update's time under each, then
    ``eval -n 1`` of the ``-n 1`` checkpoint. Returns ({path: kernel-1
    launches}, {path: kernel-3 launches})."""
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    k3, dev_args = {}, ([] if device == "cuda" else ["--device", device])
    for name, scan, modes in PARALLEL_16A:
        cfg = parallel_cfg(workdir, corpus, name, scan, device)
        conf = write_conf(workdir, f"parallel_{name}", cfg)
        base = ["-c", conf, "--log_interval", "100", "-s", "7", *dev_args]
        reset_launch_counts()
        plain = run_cli.run(base + ["--expdir", os.path.join(workdir, f"p16_{name}_plain")])
        want = losses_of(plain)
        plain_ms = update_ms(plain, cfg, device)
        for flags in modes:
            reset_launch_counts()
            tag = f"phase16a {name} {' '.join(flags)}"
            expdir = os.path.join(workdir, f"p16_{name}_{'_'.join(f.strip('-') for f in flags)}")
            trainer = run_cli.run(base + ["--expdir", expdir, *flags])
            launches = k3[f"{tag} training"] = fk.spec_mel.launches
            got = losses_of(trainer)
            ref = microbatch_reference(cfg, device) if "1f1b" in flags else want
            err = rel_err(got, ref)
            ms = update_ms(trainer, cfg, device)
            ok = err <= PARALLEL["loss_rtol"] and trainer.parallel is not None
            log(f"{tag}: world {trainer.mesh.world} over "
                f"{'nccl' if device == 'cuda' else 'gloo'}, mesh {trainer.mesh.shape}, losses "
                f"{[round(x, 5) for x in got]} vs the plain trainer's "
                f"{'1F1B rule ' if '1f1b' in flags else ''}{[round(x, 5) for x in ref]}: max "
                f"relative {err:.2e} (limit {PARALLEL['loss_rtol']:.0e}); kernel-3 launches "
                f"{launches}; an update of {PARALLEL['batch']} utterances "
                f"{ms:.1f} ms against the plain trainer's {plain_ms:.1f} ms (median of 3) "
                f"{'ok' if ok else 'FAIL'} [{card_line() if device == 'cuda' else device}]")
            if not ok:
                raise AssertionError(f"{tag}: a gate failed (see above)")
            if flags[0] == "-n" and name == "transformer_baseline":
                n1_exp = expdir
    project_logp_topk.launches = 0
    dec = os.path.join(workdir, "p16_eval_n1")
    rc = eval_cli.main(["-m", n1_exp, "-d", "dev", "-n", "1", "-b", str(PARALLEL["batch"]),
                        "-bw", "5", "-ml", "32", "--decode_dir", dec, *dev_args])
    with open(os.path.join(dec, "RESULT")) as f:
        result = f.read().splitlines()
    k1 = project_logp_topk.launches
    ok = rc == 0 and (k1 > 0) == (device == "cuda") and f"UTTS {TRAIN_CORPUS['dev']} " in result[3]
    log(f"phase16a eval -n 1 of the -n 1 checkpoint (dev split, beam 5): {' | '.join(result)}, "
        f"kernel-1 launches {k1} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("phase16a: the eval -n 1 decode failed its gate (see above)")
    return {"phase16a eval -n 1 of the -n 1 transformer_baseline checkpoint": k1}, k3


def nccl_two_ranks(rank: int) -> None:
    """One all-reduce on ``cuda:0`` from each of two NCCL ranks."""
    t = torch.ones(4, device="cuda:0")
    torch.distributed.all_reduce(t)
    torch.cuda.synchronize()


def nccl_two_ranks_probe() -> tuple[bool, str]:
    """Whether NCCL carries two ranks on the one card: the all-reduce run in
    a child process, killed after ``probe_timeout`` seconds."""
    code = ("import sys; sys.path.insert(0, '.'); import chip_smoke as c; "
            "from opentransformer_tpu_torch.parallel import launch; "
            "launch.spawn(c.nccl_two_ranks, 2, backend='nccl')")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=PARALLEL["probe_timeout"])
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        return False, f"the all-reduce did not finish in {PARALLEL['probe_timeout']} s"
    if proc.returncode == 0:
        return True, "ran"
    lines = [ln for ln in out.splitlines() if re.search(r"[Ee]rror|NCCL|[Dd]uplicate", ln)]
    return False, (lines[-1].strip() if lines else f"exit code {proc.returncode}")[:300]


def parallel_step(cfg: dict, device, dims=None, schedule=None):
    """One training micro-batch of ``cfg``'s first batch (seed 7) on a mesh
    of ``dims`` (the plain trainer without): (loss, one-card gradients,
    gradient norm, kernel-3 launches, seconds, (peak GiB, GiB held after
    the optimizer's first step: weights, gradients and moments), the
    trainer)."""
    from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.parallel.mesh import make_mesh
    from opentransformer_tpu_torch.train.trainer import Trainer

    cuda = torch.device(device).type == "cuda"
    torch.manual_seed(7)
    model = build_model(cfg["model"], dtype=torch.float32, device=device)
    loader = FeatureLoader(cfg, "train", seed=7)
    loader.set_epoch(0)
    batch = next(iter(loader))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    pipe = dict(pp_schedule=schedule, pp_micro_batches=2) if schedule == "1f1b" else {}
    trainer = Trainer(dict(cfg["train"], **pipe), model, make_device_frontend(cfg["data"], device),
                      torch.Generator(device=device).manual_seed(7),
                      mesh=None if dims is None else make_mesh(*dims))
    model.train()
    t0 = time.time()
    loss = trainer.micro_step(batch)
    if trainer.parallel is not None:
        trainer.parallel.sync_grads(trainer.optimizer)
        loss = trainer.parallel.report(loss.reshape(1).clone())[0]
    if cuda:
        torch.cuda.synchronize()
    secs = time.time() - t0
    # Adam's moments come into being at the first step (lr 0 here: the
    # weights stay): a pipe rank holds the weights, gradients and moments of
    # the blocks it owns alone
    trainer.optimizer.step()
    held = torch.cuda.memory_allocated() / 2**30 if cuda else float("nan")
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    if trainer.parallel is None:
        grads = {n: p.grad for n, p in model.named_parameters()}
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))
    else:  # the one-card gathers come after the step's peak is read
        gnorm = trainer.parallel.grad_norm()
        grads = trainer.parallel.gather_grads()
    return (float(loss), grads, float(gnorm), fk.spec_mel.launches, secs, (peak, held),
            trainer)


def grad_rel_err(got: dict, want: dict) -> float:
    """The largest of each parameter's max |Δ| over its max |g|."""
    return max(float((got[n].float().cpu() - w.float().cpu()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30)) for n, w in want.items())


def phase16b_rank(rank: int, workdir: str, backend: str, device_type: str) -> None:
    """One rank of 16b: each mode's step on the 2-rank mesh, held (on rank
    0) to the one-rank reference ``phase16b_references`` saved; every rank
    writes its own results."""
    device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    sys.path.insert(0, REPO)
    out = {}
    for mode, name, dims, schedule in PARALLEL_16B:
        if schedule == "1f1b" and backend != "nccl" and device.type == "cuda":
            continue
        with open(os.path.join(workdir, f"parallel_16b_{name}.json")) as f:
            cfg = json.load(f)
        loss, grads, gnorm, k3, secs, (peak, held), trainer = parallel_step(cfg, device, dims,
                                                                            schedule)
        rec = {"loss": loss, "gnorm": gnorm, "k3": k3, "secs": secs, "peak_gib": peak,
               "held_gib": held}
        if rank == 0 and dims is not None:
            ref = torch.load(os.path.join(workdir, f"parallel_16b_ref_{name}"
                                          f"{'_1f1b' if schedule == '1f1b' else ''}.pt"))
            rec.update(loss_err=abs(loss - ref["loss"]) / abs(ref["loss"]),
                       gnorm_err=abs(gnorm - ref["gnorm"]) / ref["gnorm"],
                       grad_err=grad_rel_err(grads, ref["grads"]))
        out[mode] = rec
        del trainer, grads
        gc.collect()  # a sharded pipe's hooks close a cycle through the model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    with open(os.path.join(workdir, f"parallel_16b_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase16b_references(workdir: str, corpus: dict, device: str) -> None:
    """The one-rank results 16b is held to: the plain trainer's step (and,
    for 1F1B, its loss rule: two row blocks with the loss over 2)."""
    from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.train.trainer import Trainer

    card = card_line() if device == "cuda" else device
    for name, scan in (("transformer_baseline", True), (MOE_NAME, False)):
        cfg = parallel_cfg(workdir, corpus, name, scan, device)
        with open(os.path.join(workdir, f"parallel_16b_{name}.json"), "w") as f:
            json.dump(cfg, f)
        loss, grads, gnorm, _, secs, (peak, _), trainer = parallel_step(cfg, device)
        torch.save({"loss": loss, "gnorm": gnorm, "grads": {n: g.cpu() for n, g in grads.items()}},
                   os.path.join(workdir, f"parallel_16b_ref_{name}.pt"))
        log(f"phase16b one-rank reference {name}: loss {loss:.6f}, step {secs:.2f} s, peak "
            f"memory {peak:.3f} GiB [{card}]")
        del trainer
        if name != "transformer_baseline":
            continue
        torch.manual_seed(7)
        model = build_model(cfg["model"], dtype=torch.float32, device=device).train()
        loader = FeatureLoader(cfg, "train", seed=7)
        loader.set_epoch(0)
        tr = Trainer(dict(cfg["train"]), model, make_device_frontend(cfg["data"], device),
                     torch.Generator(device=device).manual_seed(7))
        losses = row_blocks_backward(model, tr.batch_args(next(iter(loader))), 2)
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        gnorm = float(torch.sqrt(sum(torch.sum(g ** 2) for g in grads.values())))
        torch.save({"loss": float(torch.stack(losses).mean()), "gnorm": gnorm, "grads": grads},
                   os.path.join(workdir, f"parallel_16b_ref_{name}_1f1b.pt"))


def anchor_subset(workdir: str, data: str, n: int) -> str:
    """The first ``n`` utterances of phase 2's test split (scp and text)."""
    root = os.path.join(workdir, "anchor_subset")
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    for name in ("feats.scp", "text"):
        with open(os.path.join(data, "test", name)) as f:
            lines = f.read().splitlines()[:n]
        with open(os.path.join(root, "test", name), "w") as f:
            f.write("\n".join(lines) + "\n")
    shutil.copy(os.path.join(data, "vocab"), os.path.join(root, "vocab"))
    return root


def nbest_log_equal(a: str, b: str, score_atol: float = 2e-4) -> bool:
    """Two predict.log files list the same utterances, n-best ranks and
    hypotheses, with scores within ``score_atol`` (the 4-decimal print of a
    float32 score can flip its last digit when a batch's rows are decoded
    in a smaller batch: another matmul blocking, another summation order)."""
    la, lb = a.splitlines(), b.splitlines()
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        ua, ka, sa, ha = (x.split(" ", 3) + [""])[:4]
        ub, kb, sb, hb = (y.split(" ", 3) + [""])[:4]
        if (ua, ka, ha) != (ub, kb, hb) or abs(float(sa[6:]) - float(sb[6:])) > score_atol:
            return False
    return True


def eval_ranks(tag: str, workdir: str, subset: str, lm_args, device: str) -> dict:
    """``eval -n 2`` of the anchor on ``subset`` against ``eval -n 1``: the
    same predict.txt and RESULT (timings aside), predict.log equal up to a
    score's last printed digit (``nbest_log_equal``), each rank's kernel
    launches from ``--record``."""
    from opentransformer_tpu_torch.cli import eval as eval_cli

    out, recs = {}, {}
    for n in ("1", "2"):
        d = os.path.join(workdir, f"p16_{tag}_n{n}")
        rec = d + ".jsonl"
        t0 = time.time()
        rc = eval_cli.main(["--npz", ANCHOR + ".npz", "--model_cfg", ANCHOR + ".manifest.json",
                            "--feats", os.path.join(subset, "test", "feats.scp"),
                            "--text", os.path.join(subset, "test", "text"),
                            "--vocab", os.path.join(subset, "vocab"), "-b",
                            str(PARALLEL["eval_batch"]), "-bw", "5", "-pn", "0.6", "-ml", "32",
                            "-n", n, "--decode_dir", d, "--record", rec, *lm_args,
                            *([] if device == "cuda" else ["--device", device])])
        wall = time.time() - t0
        files = {}
        for name in ("predict.txt", "predict.log", "RESULT"):
            with open(os.path.join(d, name)) as f:
                files[name] = f.read()
        files["RESULT"] = re.sub(r"^(RTF|UTTS \d+ DECODE_SECONDS) .*$", r"\1", files["RESULT"],
                                 flags=re.M)
        with open(rec) as f:
            recs[n] = [json.loads(line) for line in f]
        out[n] = (rc, files, wall)
    one, two = out["1"][1], out["2"][1]
    same = (one["predict.txt"] == two["predict.txt"] and one["RESULT"] == two["RESULT"]
            and nbest_log_equal(one["predict.log"], two["predict.log"]))
    exact = one["predict.log"] == two["predict.log"]
    key = "project2_logp_topk" if lm_args else "project_logp_topk"
    per_rank = {r["rank"]: r["launches"][key] for r in recs["2"]}
    cuda = device == "cuda"
    ok = (out["1"][0] == out["2"][0] == 0 and same and sorted(per_rank) == [0, 1]
          and all((v > 0) == cuda for v in per_rank.values()))
    log(f"phase16b eval -n 2 {tag}: the anchor on {PARALLEL['eval_utts']} test utterances at "
        f"-b {PARALLEL['eval_batch']} (the last batch of one decoded whole by rank 0): "
        f"predict.txt and RESULT {'equal' if same else 'DIFFER'} to -n 1's, predict.log "
        f"{'byte-equal' if exact else 'equal but for a score digit' if same else 'DIFFERS'}; "
        f"{key} launches by rank {per_rank} (-n 1: "
        f"{recs['1'][0]['launches'][key]}); wall -n 1 {out['1'][2]:.1f} s, -n 2 "
        f"{out['2'][2]:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"phase16b eval -n 2 {tag}: a gate failed (see above)")
    return {f"phase16b eval -n 2 {tag}, rank {r}": v for r, v in per_rank.items()}


def phase16b_two_ranks(workdir: str, data: str, corpus: dict, device: str):
    """16b: two ranks sharing the one card. Returns ({kernel-1 path: launches},
    {kernel-2 ...}, {kernel-3 ...})."""
    from opentransformer_tpu_torch.parallel import launch

    cuda = device == "cuda"
    if cuda:
        nccl_ok, nccl_why = nccl_two_ranks_probe()
        backend = "nccl" if nccl_ok else "gloo"
        log(f"phase16b NCCL with two ranks on cuda:0: "
            f"{'carries them' if nccl_ok else 'refused: ' + nccl_why}; "
            f"the 2-rank training modes run over {backend}")
    else:
        backend = "gloo"
    phase16b_references(workdir, corpus, device)
    t0 = time.time()
    launch.spawn(phase16b_rank, 2, args=(workdir, backend, torch.device(device).type),
                 backend=backend)
    wall = time.time() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"parallel_16b_rank{r}.json")) as f:
            ranks.append(json.load(f))
    k3, ok = {}, True
    plain = ranks[0]["one rank"]
    log(f"phase16b the plain one-rank step in a rank's process (transformer_baseline; the "
        f"process's first step): {plain['secs']:.2f} s, peak memory {plain['peak_gib']:.3f} GiB, "
        f"held after Adam's first step {plain['held_gib']:.3f} GiB "
        f"[{card_line() if cuda else device}]")
    for mode, name, dims, schedule in PARALLEL_16B[1:]:
        if mode not in ranks[0]:
            log(f"phase16b {mode} ({name}): not run: its stages hand activations over point to "
                f"point, which NCCL would carry but refuses for two ranks on one device (above), "
                f"and Gloo carries for CPU tensors only (torch.distributed's backend table: "
                f"Gloo on CUDA tensors has broadcast and all-reduce alone); its multi-rank "
                f"witness is tests/test_torch_port_parallel.py (pp_1f1b_* against JAX's mesh)")
            continue
        r0 = ranks[0][mode]
        good = (r0["loss_err"] <= PARALLEL["loss_rtol"] and r0["grad_err"] <= PARALLEL["grad_rtol"]
                and r0["gnorm_err"] <= PARALLEL["loss_rtol"] * 10
                and all((ranks[r][mode]["k3"] > 0) == cuda for r in range(2)))
        memory_gate = mode == "pp 2 sharded" and cuda  # each rank holds half the blocks
        if memory_gate:
            good &= all(ranks[r][mode][k] < plain[k] for r in range(2)
                        for k in ("peak_gib", "held_gib"))
        ok &= good
        for r in range(2):
            k3[f"phase16b {mode} {name} step, rank {r}"] = ranks[r][mode]["k3"]
        log(f"phase16b {mode} ({name}, {backend} on one card, mesh {dims}): loss {r0['loss']:.6f} "
            f"relative to the one-rank step {r0['loss_err']:.2e} (limit "
            f"{PARALLEL['loss_rtol']:.0e}), gradients max |Δ|/max|g| a tensor {r0['grad_err']:.2e} "
            f"(limit {PARALLEL['grad_rtol']:.0e}), norm {r0['gnorm_err']:.2e}; kernel-3 launches "
            f"{[ranks[r][mode]['k3'] for r in range(2)]}; step {r0['secs']:.2f} s, peak memory by "
            f"rank {[round(ranks[r][mode]['peak_gib'], 3) for r in range(2)]} GiB, held after "
            f"Adam's first step {[round(ranks[r][mode]['held_gib'], 3) for r in range(2)]} GiB"
            f"{' (both below the one-rank step in the process: a gate)' if memory_gate else ''} "
            f"{'ok' if good else 'FAIL'} [{card_line() if cuda else device}]")
    log(f"phase16b 2-rank world wall {wall:.1f} s")
    if not ok:
        raise AssertionError("phase16b: a 2-rank mode disagreed with its one-rank step")
    subset = anchor_subset(workdir, data, PARALLEL["eval_utts"])
    lm_npz, lm_json = os.path.join(workdir, "lm.npz"), os.path.join(workdir, "lm.json")
    if not os.path.exists(lm_npz):  # phase 4's seeded LM
        from opentransformer_tpu_torch import compat
        from opentransformer_tpu_torch.models.registry import build_model

        compat.save_npz(lm_npz, seeded_params(build_model(ANCHOR_LM_CFG, device="cpu"), seed=11,
                                              embedding_std=ANCHOR_LM_CFG["d_model"] ** -0.5))
        with open(lm_json, "w") as f:
            json.dump(ANCHOR_LM_CFG, f)
    k1 = eval_ranks("without an LM", workdir, subset, (), device)
    k2 = eval_ranks("with -lm at -lmw 0.1", workdir, subset,
                    ("-lm", lm_npz, "--lm_cfg", lm_json, "-lmw", "0.1"), device)
    return k1, k2, k3


def phase_parallel(workdir: str, data: str, corpus: dict, device: str = "cuda"):
    """Phase 16 (module docstring): ``data`` holds phase 2's test split,
    ``corpus`` phase 7's wavs. Returns ({path: kernel-1 launches}, {path:
    kernel-2 launches}, {path: kernel-3 launches})."""
    t_phase = time.time()
    k1, k3 = phase16a_world_one(workdir, corpus, device)
    k1b, k2, k3b = phase16b_two_ranks(workdir, data, corpus, device)
    log(f"phase16 wall {time.time() - t_phase:.1f} s")
    return {**k1, **k1b}, k2, {**k3, **k3b}


# ---------------------------------------------------------------- phase 17
# the port's measuring tools (tools/torch_*.py) run in this process, at
# their own sizes on the card (TOOL_CPU_ARGS cut them for a CPU rehearsal);
# 17f's two ranks read their data shards; 17g's flagship cut to 32 updates
TOOL_STREAMS = dict(streams=16, seconds=10.0, paced_seconds=5.0)
TOOL_TRAIN_ITERS = 4
TOOL_CPU_ARGS = {
    "torch_profile_decode": ["-b", "2", "--frames", "40", "--iters", "1"],
    "torch_profile_train": ["-b", "2", "-t", "64", "-u", "4"],
    "torch_stream_latency": [],
    "torch_probe_decode_precision": ["--utts", "16"],
    "torch_probe_cost_analysis": ["-b", "2", "-t", "64", "-u", "4", "--time-iters", "1"],
}
MULTIHOST = dict(batch=7, steps=2, timeout=600)  # 7 rows: 4 + 3, the shards split unevenly
# cli/run.py -debug: an epoch's first 32 updates; a CPU rehearsal cuts the
# width and the batch
RECIPE_CUT = dict(updates=32, timeout=900,
                  cpu_sets=["--set", "model.encoder.n_blocks=1", "--set",
                            "model.decoder.n_blocks=1", "--set", "data.batch_size=4"])


def load_tool(name: str):
    """``tools/<name>.py`` as a module."""
    import importlib.util

    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    spec = importlib.util.spec_from_file_location(name, os.path.join(tools, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_tool(tag: str, name: str, argv: list, device: str) -> dict | None:
    """``main(argv)`` of a tool in this process (its output echoed under
    ``tag``) → its last line as JSON (None when that is not a JSON object).
    Off the card ``--device`` and the cut sizes of ``TOOL_CPU_ARGS`` go in."""
    import contextlib
    import io

    if device != "cuda":
        argv = argv + TOOL_CPU_ARGS[name] + ["--device", device]
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = load_tool(name).main(argv)
    text = out.getvalue().strip()
    for line in text.splitlines():
        if not line.startswith("{"):
            log(f"{tag} | {line}")
    log(f"{tag} tools/{name}.py {' '.join(argv)}: {time.time() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"{tag}: tools/{name}.py exited {rc}")
    last = text.splitlines()[-1] if text else ""
    return json.loads(last) if last.startswith("{") else None


def phase17a_decode_split(device: str) -> tuple[dict, dict]:
    """The decode split without an LM (--quick) and the LM attribution
    (--lm): kernel 1 once a search step without an LM and never with one,
    kernel 2 once a step with one; device time > 0."""
    from opentransformer_tpu_torch.ops.project_topk import project2_logp_topk, project_logp_topk

    cuda = device == "cuda"
    reset_launch_counts()
    rec = run_tool("phase17a", "torch_profile_decode", ["--quick"], device)
    k1_quick = project_logp_topk.launches
    bad = []
    if cuda:
        for s in rec["searches"]:
            if s["k1"] != s["max_len"] or s["k2"] != 0 or not s["device_ms"] > 0:
                bad.append(f"--quick max_len {s['max_len']}: {s}")
        if not rec["encode"]["device_ms"] > 0:
            bad.append(f"encode: {rec['encode']}")
    reset_launch_counts()
    lm = run_tool("phase17a", "torch_profile_decode", ["--lm"], device)
    k1_lm, k2_lm = project_logp_topk.launches, project2_logp_topk.launches
    if cuda:
        for v in lm["lm"]:
            for s in v["searches"]:
                want = (s["max_len"], 0) if v["num_blocks"] is None else (0, s["max_len"])
                if (s["k1"], s["k2"]) != want or not s["device_ms"] > 0:
                    bad.append(f"--lm {v['label']} max_len {s['max_len']}: {s}")
    if bad:
        raise AssertionError("phase17a: launches or device time wrong: " + "; ".join(bad))
    log(f"phase17a decode split: kernel-1 launches {k1_quick} (--quick), {k1_lm} (--lm, the "
        f"no-LM variant), kernel-2 launches {k2_lm} (--lm) ok")
    return ({"phase17a profile_decode --quick": k1_quick,
             "phase17a profile_decode --lm, no-LM searches": k1_lm},
            {"phase17a profile_decode --lm, LM searches": k2_lm})


def phase17b_train_profile(workdir: str, device: str) -> None:
    """The flagship update's trace: categories sum to the total, idle share
    in [0, 1]."""
    rec = run_tool("phase17b", "torch_profile_train",
                   ["--iters", str(TOOL_TRAIN_ITERS), "--trace-dir",
                    os.path.join(workdir, "train_trace")], device)
    total = rec["device_ms"] if device == "cuda" else rec["cpu_self_ms"]
    cats = sum(rec["by_category"].values())
    ok = abs(cats - total) <= 1e-6 * total and total > 0
    if device == "cuda":
        ok &= 0.0 <= rec["idle_share"] <= 1.0
    if not ok:
        raise AssertionError(f"phase17b: categories {cats} against total {total}, idle share "
                             f"{rec.get('idle_share')}")


def phase17c_stream_latency(device: str) -> dict:
    """Saturated and paced multi-stream CTC: one kernel-1 launch a tick,
    a FINAL on every stream."""
    out = {}
    s = TOOL_STREAMS
    for mode, argv in (("saturated", ["-n", str(s["streams"]), "--seconds", str(s["seconds"])]),
                       ("paced", ["-n", str(s["streams"]), "--paced", "--seconds",
                                  str(s["paced_seconds"])])):
        reset_launch_counts()
        rec = run_tool("phase17c", "torch_stream_latency", argv, device)
        good = rec["finals"] == s["streams"] and (
            rec["kernel1_launches"] == rec["ticks"] if device == "cuda" else True)
        if not good:
            raise AssertionError(f"phase17c {mode}: finals {rec['finals']}, kernel-1 launches "
                                 f"{rec['kernel1_launches']} against {rec['ticks']} ticks")
        out[f"phase17c stream_latency {mode}"] = rec["kernel1_launches"]
    return out


def phase17d_precision(workdir: str, device: str) -> dict:
    """The five precision configurations on the anchor's test split: f32
    within phase 2's CER and id limits, the others recorded."""
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    path = os.path.join(workdir, "probe_results.jsonl")
    reset_launch_counts()
    run_tool("phase17d", "torch_probe_decode_precision", ["--out", path], device)
    with open(path) as f:
        recs = {r["probe"]: r for r in map(json.loads, f)}
    f32 = recs["f32"]
    limit_ids = ANCHOR_ID_LIMIT if device == "cuda" else 1
    if f32["cer_pct"] > ANCHOR_CER_LIMIT or f32["ids_off_jax"] > limit_ids:
        raise AssertionError(f"phase17d f32: CER {f32['cer_pct']}% (limit {ANCHOR_CER_LIMIT}%), "
                             f"{f32['ids_off_jax']} ids off JAX's (limit {limit_ids})")
    log("phase17d " + ", ".join(f"{k} CER {r['cer_pct']}% ({r['ids_off_jax']} off JAX's ids)"
                                for k, r in recs.items()) + " ok")
    return {"phase17d probe_decode_precision, 5 configurations": project_logp_topk.launches}


def phase17e_cost(device: str) -> None:
    """FLOPs of the flagship update (eager: 20 and 4 times one update) and
    its MFU on the card."""
    rec = run_tool("phase17e", "torch_probe_cost_analysis", [], device)
    ok = rec["accum4"] == 4 * rec["single"] and rec["steps_per_exec20"] == 20 * rec["single"]
    if device == "cuda":
        ok &= 0.0 < rec["mfu"] < 1.0
        log(f"phase17e flagship update B{rec['b']} T{rec['t']} U{rec['u']}: {rec['single']:.4e} "
            f"FLOPs counted ({rec['single/hand_roofline']:.3f} of the hand roofline), "
            f"{rec['update_ms']:.2f} ms an update, MFU {rec['mfu']:.4f} of 989 TFLOP/s "
            f"[{card_line()}]")
    if not ok:
        raise AssertionError(f"phase17e: counts or MFU wrong: {rec}")


def multihost_cfg(workdir: str, corpus: dict, device: str) -> str:
    cfg = parallel_cfg(workdir, corpus, "transformer_baseline", False, device)
    cfg["data"]["batch_size"] = MULTIHOST["batch"]
    path = os.path.join(workdir, "multihost_17f.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def multihost_trainer(cfg: dict, device, mesh=None):
    from opentransformer_tpu_torch.data.device_pipeline import make_device_frontend
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.train.trainer import Trainer

    torch.manual_seed(7)
    model = build_model(cfg["model"], dtype=torch.float32, device=device).train()
    return Trainer(dict(cfg["train"]), model, make_device_frontend(cfg["data"], device),
                   torch.Generator(device=device).manual_seed(7), log_interval=10 ** 9,
                   mesh=mesh, data_shards=mesh is not None)


def phase17f_rank(conf: str, out: str, device_type: str) -> None:
    """One rank of 17f in torchrun's environment: its data shard of each of
    the first steps' batches, one step each from the same weights; rank 0
    saves the steps' losses and one-card gradients."""
    from opentransformer_tpu_torch.data.loader import FeatureLoader
    from opentransformer_tpu_torch.ops import fbank_kernel as fk
    from opentransformer_tpu_torch.parallel import launch
    from opentransformer_tpu_torch.parallel.mesh import make_mesh

    device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    launch.init_from_env("gloo")
    try:
        with open(conf) as f:
            cfg = json.load(f)
        mesh = make_mesh(2, 1, 1, 1)
        loader = FeatureLoader(cfg, "train", seed=7, num_shards=mesh.size("data"),
                               shard_id=mesh.index("data"))
        loader.set_epoch(0)
        trainer = multihost_trainer(cfg, device, mesh)
        steps = []
        reset_launch_counts()
        for j, batch in zip(range(MULTIHOST["steps"]), loader):
            trainer.optimizer.zero_grad(set_to_none=True)
            loss = trainer.micro_step(batch)
            trainer.parallel.sync_grads(trainer.optimizer)
            loss = trainer.parallel.report(loss.reshape(1).float().clone())
            grads = trainer.parallel.gather_grads()
            trainer._window, trainer._window_aux = [], []
            steps.append({"loss": float(loss[0]), "rows": len(batch[0]),
                          "grads": {n: g.cpu() for n, g in grads.items()}})
        if mesh.rank == 0:
            torch.save({"steps": steps, "k3": fk.spec_mel.launches}, out)
        else:
            torch.save({"k3": fk.spec_mel.launches}, out + ".rank1")
    finally:
        launch.shutdown()


def multihost_references(cfg: dict, device: str) -> list:
    """The plain trainer's step on each host-major global batch: shard i's
    rows (``idxs[i::2]``) in shard order, read and collated as one batch."""
    from opentransformer_tpu_torch.data.device_pipeline import collate_waveforms
    from opentransformer_tpu_torch.data.loader import FeatureLoader

    loader = FeatureLoader(cfg, "train", seed=7)
    loader.set_epoch(0)
    trainer = multihost_trainer(cfg, device)
    out = []
    for _, (_, idxs) in zip(range(MULTIHOST["steps"]), loader.sampler):
        order = [k for i in range(2) for k in (idxs[i::2] or [idxs[0]])]
        batch = collate_waveforms([loader.dataset[k] for k in order])
        trainer.optimizer.zero_grad(set_to_none=True)
        loss = trainer.micro_step(batch)
        trainer._window, trainer._window_aux = [], []
        out.append({"loss": float(loss), "rows": len(order),
                    "grads": {n: p.grad.detach().cpu().clone()
                              for n, p in trainer.model.named_parameters()}})
    return out


def phase17f_multihost(workdir: str, corpus: dict, device: str) -> dict:
    """``--multihost``'s data path: two processes in torchrun's environment on
    the one card (Gloo), each reading its data shard of every batch (7 rows:
    4 + 3, gathered whole; then the next batch), each step's loss (1e-5
    relative) and gradients (1e-3 of each tensor's largest) held to the
    plain trainer's step on the host-major global batch."""
    from opentransformer_tpu_torch.parallel import launch

    conf = multihost_cfg(workdir, corpus, device)
    with open(conf) as f:
        cfg = json.load(f)
    want = multihost_references(cfg, device)
    out = os.path.join(workdir, "multihost_17f.pt")
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(launch.free_port()),
               WORLD_SIZE="2", PYTHONPATH=REPO)
    code = (f"import chip_smoke as c; c.phase17f_rank({conf!r}, {out!r}, "
            f"{torch.device(device).type!r})")
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=MULTIHOST["timeout"]) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0, 0]:
        raise AssertionError(f"phase17f: the ranks exited {rcs}")
    got = torch.load(out)
    k3 = {"phase17f --multihost data shards, rank 0": got["k3"],
          "phase17f --multihost data shards, rank 1": torch.load(out + ".rank1")["k3"]}
    ok = len(got["steps"]) == len(want) == MULTIHOST["steps"]
    for j, (g, w) in enumerate(zip(got["steps"], want)):
        loss_err = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        grad_err = grad_rel_err(g["grads"], w["grads"])
        good = loss_err <= PARALLEL["loss_rtol"] and grad_err <= PARALLEL["grad_rtol"]
        ok &= good
        log(f"phase17f step {j}: global batch of {w['rows']} rows, rank 0's shard {g['rows']} "
            f"rows; loss {g['loss']:.6f} relative to the plain step {loss_err:.2e} (limit "
            f"{PARALLEL['loss_rtol']:.0e}), gradients max |Δ|/max|g| a tensor {grad_err:.2e} "
            f"(limit {PARALLEL['grad_rtol']:.0e}) {'ok' if good else 'FAIL'}")
    if device == "cuda":
        ok &= all(v > 0 for v in k3.values())
    log(f"phase17f 2-rank --multihost world (Gloo, one card) wall {time.time() - t0:.1f} s, "
        f"kernel-3 launches {list(k3.values())} [{card_line() if device == 'cuda' else device}]")
    if not ok:
        raise AssertionError("phase17f: the sharded steps disagree with the global batch's")
    return k3


def phase17g_recipe(workdir: str, data: str, device: str) -> dict:
    """``conf/flagship.json`` on phase 12's corpus through the training CLI,
    cut to an epoch's first 32 updates (``-debug``), then the average,
    decode and export commands of ``egs/synth_bench/continue_torch.sh``."""
    from opentransformer_tpu_torch.cli import run as run_cli
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk

    conf = os.path.join(workdir, "flagship_17g.json")
    cut = [] if device == "cuda" else RECIPE_CUT["cpu_sets"]
    if load_tool("torch_edit_config").main([os.path.join(CONF_DIR, "flagship.json"), conf,
                                            "--data", data, "--set", "train.epochs=1",
                                            *cut]):
        raise AssertionError("phase17g: the config edit failed")
    expdir = os.path.join(workdir, "exp_flagship_17g")
    argv = ["-c", conf, "--expdir", expdir, "--debug", "--log_interval", "8"]
    if device != "cuda":
        argv += ["--device", device]
    reset_launch_counts()
    t0 = time.time()
    trainer = run_cli.run(argv)
    train_secs = time.time() - t0
    k1 = project_logp_topk.launches
    losses = losses_of(trainer)
    probe = trainer.dev_probe_fn.records[0]
    ok = (len(trainer.history) == RECIPE_CUT["updates"] and trainer.nan_skips == 0
          and all(np.isfinite(losses)) and (k1 == probe["steps"] if device == "cuda" else True))
    log(f"phase17g flagship.json, {len(trainer.history)} updates (-debug) in {train_secs:.1f} s "
        f"with the resident corpus and the dev probe; loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"dev greedy CER {probe['cer'] * 100:.2f}% over {probe['steps']} greedy steps, "
        f"kernel-1 launches {k1} [{card_line() if device == 'cuda' else device}]")
    del trainer
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    # continue_torch.sh's last three commands, on the one epoch (0) trained
    avg = os.path.join(expdir, "model.average.from0to0")
    result = os.path.join(expdir, "decode_test_bw5_pn0.6_ml32_avg0-0", "RESULT")
    export = os.path.join(expdir, "flagship_synth_f16.npz")
    dev = [] if device == "cuda" else ["--device", device]
    commands = [
        ["tools/torch_average.py", expdir, "0", "0"],
        ["-m", "opentransformer_tpu_torch.cli.eval", "-m", avg, "-bw", "5", "-pn", "0.6",
         "-ml", "32", "-b", "100", "-d", "test", *dev],
        ["tools/torch_export_trained_synth.py", avg, export, "--result", result,
         "--embed-model-cfg", "--regenerate", "bash egs/synth_bench/run_torch.sh"]]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.time()
    for argv in commands:
        run = subprocess.run([sys.executable, *argv], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=RECIPE_CUT["timeout"])
        if run.returncode != 0:
            log(f"phase17g {argv[0] if argv[0] != '-m' else argv[1]} exited {run.returncode}: "
                f"{run.stderr[-2000:]}")
            ok = False
            break
    ok &= os.path.exists(result) and os.path.exists(export)
    if ok:
        with open(result) as f:
            text = f.read()
        ok &= "UTTS 500 " in text or device != "cuda"
        log(f"phase17g continue_torch.sh's average, decode and export commands in "
            f"{time.time() - t0:.1f} s: {' | '.join(text.strip().splitlines())}")
    if not ok:
        raise AssertionError("phase17g: the flagship recipe's cut failed")
    return {"phase17g flagship recipe, the dev probe": k1}


def phase_tools(workdir: str, data: str, corpus: dict, device: str = "cuda"):
    """Phase 17 (module docstring): ``data`` holds phase 12's corpus,
    ``corpus`` phase 7's wavs. Returns ({path: kernel-1 launches}, {path:
    kernel-2 launches}, {path: kernel-3 launches})."""
    t_phase = time.time()
    k1, k2 = phase17a_decode_split(device)
    phase17b_train_profile(workdir, device)
    k1.update(phase17c_stream_latency(device))
    k1.update(phase17d_precision(workdir, device))
    phase17e_cost(device)
    k3 = phase17f_multihost(workdir, corpus, device)
    k1.update(phase17g_recipe(workdir, data, device))
    log(f"phase17 wall {time.time() - t_phase:.1f} s")
    return k1, k2, k3


def kernel_record(name, source, replaces, launches, max_err, timing, by_path, library_ms=None,
                  at_shapes=None):
    """The kernel's entry of the JSON line: ``launches`` on its first main
    path, ``launches_by_path`` on each path that launches it; ``library_ms``
    a library call that computes the same, where one exists; ``at_shapes``
    {case: (timing, library ms or None)} the times of other cases."""
    kern, plain, bound, bound_by = timing
    shapes = {}
    for case, ((s_kern, s_plain, s_bound, s_by), s_lib) in (at_shapes or {}).items():
        shapes[case] = {"ms": s_kern, "plain_ms": s_plain, "bound_ms": s_bound,
                        "bound_by": s_by, "library_ms": s_lib}
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": kern, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
            "launches_by_path": by_path, "at_shapes": shapes}


WHISPER_CONF = os.path.join(CONF_DIR, "whisper_large_v3.json")
# phase 18: two batches of full 30-s windows, beam 5, a few steps
WHISPER = {"windows": 4, "batch": 2, "max_len": 6, "frames": 3000}


def whisper_state(model_cfg: dict, seed: int) -> dict:
    """Seeded float32 weights of ``model_cfg`` by the port's names, built
    from the shapes of a model on the meta device: LayerNorm gains 1,
    other vectors 0.02, matrices and embeddings 1/sqrt(fan-in)."""
    from opentransformer_tpu_torch.models.registry import build_model

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in build_model(model_cfg, device="meta").state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, shape in shapes.items():
        x = torch.randn(shape, generator=g)
        if len(shape) > 1:
            state[name] = x / float(np.prod(shape[1:])) ** 0.5
        elif "norm" in name and name.endswith("weight"):
            state[name] = torch.ones(shape)
        else:
            state[name] = 0.02 * x
    return state


def phase_whisper(workdir: str, device: str = "cuda", model_cfg=None) -> int:
    """Phase 18: Whisper large-v3 (``conf/whisper_large_v3.json``) through the
    eval CLI's ``--npz`` path, as a user decodes it: seeded weights written
    as an npz in the JAX layout (float16, 3.1 GB at full size), two batches
    of full 30-s windows of 128-mel features, beam 5, bf16. Every step runs
    kernel 1 once and kernel 4 twice a block, each cross call through its
    one-pass entry; the n-best scores come out
    sorted; each encoder block runs kernel 5 once a slice of each batch.
    ``model_cfg`` (a cut width) and ``device`` rehearse it on the CPU.
    Returns kernel 1's launches."""
    from opentransformer_tpu_torch import compat
    from opentransformer_tpu_torch.cli import eval as eval_cli
    from opentransformer_tpu_torch.config import load_config
    from opentransformer_tpu_torch.data import write_vocab
    from opentransformer_tpu_torch.data.kaldi_io import write_ark
    from opentransformer_tpu_torch.models.registry import build_model
    from opentransformer_tpu_torch.ops.encoder_attention import encoder_self_attention
    from opentransformer_tpu_torch.ops.project_topk import project_logp_topk
    from opentransformer_tpu_torch.recognize.base import encode_slice_rows

    t0 = time.time()
    model_cfg = model_cfg or load_config(WHISPER_CONF)["model"]
    root = os.path.join(workdir, "whisper")
    os.makedirs(root, exist_ok=True)
    cfg_path = os.path.join(root, "model.json")
    with open(cfg_path, "w") as f:
        json.dump(model_cfg, f)
    state = whisper_state(model_cfg, seed=18)
    with torch.device("meta"):
        meta = build_model(model_cfg, device="meta")
    npz = os.path.join(root, "whisper.npz")
    compat.save_npz(npz, compat.params_to_jax(meta, state))
    del state
    # kernel 5's launches: every encoder block once a slice, each batch in
    # as many slices as the recognizer cuts it into
    sizes = [min(WHISPER["batch"], WHISPER["windows"] - i)
             for i in range(0, WHISPER["windows"], WHISPER["batch"])]
    five_want = model_cfg["encoder"]["n_blocks"] * sum(
        -(-n // encode_slice_rows(meta, n, WHISPER["frames"])) for n in sizes)
    vocab = model_cfg["decoder"]["vocab_size"]
    write_vocab({f"w{i}": i for i in range(vocab)}, os.path.join(root, "vocab"))
    rng = np.random.default_rng(18)
    mel = model_cfg["frontend"]["input_size"]
    utts = {f"win{i:03d}": rng.normal(size=(WHISPER["frames"], mel)).astype(np.float32)
            for i in range(WHISPER["windows"])}
    write_ark(os.path.join(root, "feats.ark"), utts, os.path.join(root, "feats.scp"))
    with open(os.path.join(root, "text"), "w") as f:
        for utt in utts:
            f.write(utt + " " + " ".join(f"w{i}" for i in rng.integers(3, vocab, 20)) + "\n")
    log(f"phase18: npz and {len(utts)} windows written in {time.time() - t0:.1f} s")
    out = os.path.join(root, "decode")
    before = (project_logp_topk.launches, attention_launches(), encoder_self_attention.launches)
    cross0 = cross_launch_counts()
    rc = eval_cli.main([
        "--npz", npz, "--model_cfg", cfg_path, "--feats", os.path.join(root, "feats.scp"),
        "--text", os.path.join(root, "text"), "--vocab", os.path.join(root, "vocab"),
        "-b", str(WHISPER["batch"]), "-bw", "5", "-pn", "0.6", "-ml", str(WHISPER["max_len"]),
        "--dtype", "bfloat16", "--decode_dir", out, "--device", device])
    if rc != 0:
        raise AssertionError(f"phase18: the eval CLI returned {rc}")
    one = project_logp_topk.launches - before[0]
    four = attention_launches() - before[1]
    five = encoder_self_attention.launches - before[2]
    cross, one_pass = (n - n0 for n, n0 in zip(cross_launch_counts(), cross0))
    decoded = nbest_scores_sorted(out)
    with open(os.path.join(out, "RESULT")) as f:
        result = f.read().splitlines()
    blocks = model_cfg["decoder"]["n_blocks"]
    if decoded != WHISPER["windows"]:
        raise AssertionError(f"phase18: {decoded} of {WHISPER['windows']} windows decoded")
    if device != "cpu" and (one == 0 or four != 2 * blocks * one or five != five_want
                            or one_pass != cross or cross != blocks * one):
        raise AssertionError(f"phase18: kernel 1 launched {one} times, kernel 4 {four} times "
                             f"(2 x {blocks} blocks a step), {cross} of them cross and "
                             f"{one_pass} through the one-pass entry (every bf16 cross call), "
                             f"kernel 5 {five} times ({five_want}: each encoder block once a "
                             f"slice)")
    log(f"phase18 whisper large-v3 eval CLI: {decoded} windows in {len(sizes)} batches | "
        f"{result[3]} | kernel 1 launches {one}, kernel 4 {four} ({cross} cross, {one_pass} "
        f"through the one-pass entry), kernel 5 {five} | wall "
        f"{time.time() - t0:.1f} s "
        f"[{card_line() if torch.cuda.is_available() else 'cpu'}]")
    return one


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import opentransformer_tpu_torch  # noqa: F401  (fails outside the repository)

    t0 = time.time()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()
    max_err, timings, library1 = phase_kernel()
    max_err2, timings2 = phase_kernel2()
    max_err4, timings4, library4, _ = phase_kernel4()
    max_err5, timings5, library5 = phase_kernel5()
    # kernel 4 runs on every beam and greedy decode of an attention decoder,
    # kernel 5 on every bf16 inference encode: their launches in this
    # process, counted from 0 over each phase
    att, enc = {}, {}

    def counted(label, phase, *args):
        from opentransformer_tpu_torch.ops.beam_attention import (
            beam_cross_attention,
            beam_self_attention,
        )
        from opentransformer_tpu_torch.ops.encoder_attention import encoder_self_attention

        beam_cross_attention.launches = beam_self_attention.launches = 0
        encoder_self_attention.launches = 0
        out = phase(*args)
        att[label] = attention_launches()
        enc[label] = encoder_self_attention.launches
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        data = counted("phase2 anchor eval CLI (f32, bf16)", phase_anchor, workdir)
        launches, flagship_secs, launches4, launches5 = counted("phase3 flagship",
                                                                phase_flagship)
        counted("phase4 anchor eval CLI + LM", phase_anchor_lm, workdir, data)
        ctc_launches = counted("phase8 anchor CTC and beam + CTC rescoring", phase_anchor_ctc,
                               workdir, data)
        launches2 = counted("phase5 flagship + LM", phase_flagship_lm)
        max_err3, timing3 = phase_fbank()
        launches3, corpus = counted("phase7 training and its reload decode", phase_train, workdir)
        conformer_train_launches = counted("phase9d conformer training and its reload decode",
                                           phase_conformer_train, workdir, corpus)
        conformer_launches = counted("phase9 conformer decodes", phase_conformer)
        stream_launches, stream_launches2 = counted("phase10 streaming and serving",
                                                    phase_streaming, workdir, data, corpus)
        transducer_launches = counted("phase11 transducer", phase_transducer, workdir, corpus)
        recipe_launches, _ = counted("phase12 anchor recipe and its decode", phase_anchor_recipe,
                                     workdir, data)
        family_launches, family_launches2, family_launches3 = counted(
            "phase13 model families", phase_train_families, workdir, data, corpus)
        ref_launches, ref_launches2, ref_launches3 = counted(
            "phase14 reference checkpoints", phase_reference, workdir, data, corpus)
        moe_launches, moe_launches2, moe_launches3 = counted(
            "phase15 mixture of experts", phase_moe, workdir, data, corpus, flagship_secs)
        par_launches, par_launches2, par_launches3 = counted(
            "phase16 parallelism (this process)", phase_parallel, workdir, data, corpus)
        tool_launches, tool_launches2, tool_launches3 = counted(
            "phase17 tools and recipe (this process)", phase_tools, workdir, data, corpus)
        whisper_launches = counted("phase18 whisper large-v3 eval CLI", phase_whisper, workdir)
    log(f"kernel 4 launches by phase: {att}")
    log(f"kernel 5 launches by phase: {enc}")

    # launches: each kernel's count on its own main paths (phase 3 without an
    # LM, phase 8's CTC decodes, phase 9's conformer decodes, phase 10's
    # serving paths, phase 11's transducer paths, phase 12's dev CER
    # probe and averaged-checkpoint decode, phase 13's decodes of the
    # trained families, phase 14's reference-checkpoint and -m decodes and
    # phase 15's MoE decodes, phase 16's eval -n 1 and each rank's eval -n 2,
    # phase 17's tools and the flagship recipe's dev probe, phases 5, 10d,
    # 13e, 14a, 15d, 16b and 17a with an LM, phases 7, 9d, 13c, 14c, 15c,
    # 16 and 17f's training runs and steps; kernel 4 on phase 3's counted
    # decode and each phase's decodes in this process); times at the flagship
    # bf16 beam-step shape, at the 16 x 10 s training batch and, for kernel
    # 4, at the decode cell's longest cross attention
    record = {"kernels": [
        kernel_record("project_logp_topk", "opentransformer_tpu_torch/csrc/project_topk.cu",
                      "opentransformer_tpu/ops/project_topk.py:96", launches, max_err,
                      timings["flagship bf16"],
                      {"phase3 flagship decode": launches,
                       "phase8a anchor CTC greedy (k=1)": ctc_launches["greedy"],
                       "phase8b anchor CTC prefix beam (k=32 + lse)": ctc_launches["beam"],
                       "phase8c anchor beam + CTC rescoring (k=5)": ctc_launches["ctcw"],
                       **conformer_launches, **stream_launches, **transducer_launches,
                       **recipe_launches, **family_launches, **ref_launches,
                       **moe_launches, **par_launches, **tool_launches,
                       "phase18 whisper large-v3 eval CLI": whisper_launches},
                      at_shapes={WHISPER_HEAD_RECORD: (timings[WHISPER_HEAD_RECORD],
                                                       library1[WHISPER_HEAD_RECORD])}),
        kernel_record("project2_logp_topk", "opentransformer_tpu_torch/csrc/project2_topk.cu",
                      "opentransformer_tpu/ops/project_topk.py:190", launches2, max_err2,
                      timings2["flagship bf16"],
                      {"phase5 flagship decode + LM": launches2,
                       "phase10d batcher, anchor + LM at -lmw 0.0": stream_launches2,
                       **family_launches2, **ref_launches2, **moe_launches2,
                       **par_launches2, **tool_launches2}),
        kernel_record("fbank_spec_mel", "opentransformer_tpu_torch/csrc/fbank_spec_mel.cu",
                      "opentransformer_tpu/ops/fbank_pallas.py:60", launches3, max_err3, timing3,
                      {"phase7 training": launches3,
                       "phase9d conformer_baseline training": conformer_train_launches,
                       **family_launches3, **ref_launches3, **moe_launches3,
                       **par_launches3, **tool_launches3}),
        kernel_record("beam_attention", "opentransformer_tpu_torch/csrc/beam_attention.cu",
                      "none", launches4, max_err4, timings4[BEAM_ATTENTION_RECORD],
                      {"phase3 flagship decode": launches4, **att},
                      library4[BEAM_ATTENTION_RECORD],
                      at_shapes={case: (timings4[case], library4.get(case))
                                 for case in (*BEAM_ATTENTION_WHISPER,
                                              BEAM_ATTENTION_PADDED[0])}),
        kernel_record("encoder_attention", "opentransformer_tpu_torch/csrc/encoder_attention.cu",
                      "none", launches5, max_err5,
                      timings5[ENCODER_ATTENTION_TIMED[0][0]], enc,
                      library5[ENCODER_ATTENTION_TIMED[0][0]],
                      at_shapes={case[0]: (timings5[case[0]], library5[case[0]])
                                 for case in ENCODER_ATTENTION_TIMED[1:]}),
    ]}
    log(f"chip_smoke ran every phase in {time.time() - t0:.1f} s")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
