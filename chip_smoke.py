"""Smoke run of openeat_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and turns TF32
   off for the float32 phases. Builds openeat_torch/csrc/*.cu with nvcc,
   one process per source, all started together, and prints each kernel
   entry's registers and spills (ptxas -v); an entry that spills fails.
2. Kernel phase: holds K3 (openeat_torch/csrc/depthwise_conv.cu) against
   depthwise_conv1d_plain on the card, at the decode shape [8, 138, 256]
   K=15, at ragged shapes (C=100 in bfloat16 takes the cp.async route,
   the rest TMA; C=99 in bfloat16 and a bfloat16 input at a 2-byte offset
   take the element-load route), and at the shapes the decode runs below
   give it, in float32 (bit-equal) and bfloat16 (<= 1 bf16 ulp of the
   float32 sum; bit-equal on the element route). Times the kernel, the
   plain version and F.conv1d(groups=C) (the library yardstick, which
   the port never calls) as device time per call from CUDA-graph
   replays over inputs rotated through more than the 50 MB L2, beside
   the least time the card needs for the bytes and operations.
   Then the training kernels, at the shapes the training run below
   gives them, at fixed larger ones and at ragged ones ([3, 40, 100]
   K=7, [1, 15, 4] K=15, whose dgrad has T < K, and the element route):
   K3's dgrad (the kernel's dgrad entry on dy and w as they are; float32
   bit-equal to the plain dgrad, bfloat16 within 1 bf16 ulp) and wgrad
   (one launch; the same bits on two runs; float32 within 1e-5 x
   max|dw| of the plain sum; bfloat16 within 1 bf16 ulp of the kernel's
   own float32 sums), with aten.convolution_backward as their
   yardstick. torch.profiler shows that one call of depthwise_conv1d,
   depthwise_conv1d_dgrad, depthwise_conv1d_wgrad, ctc_dp_shared and
   ctc_dp_global each runs exactly one device kernel. K2's launch plan
   (openeat_ctc_global_plan) must equal ctc.global_plan. K3 at K = 31
   (k31_cases): forward, dgrad and wgrad at the LibriSpeech micro-batches
   [4, 353, 256], [3, 428, 256] and [2, 453, 256] (timed) and at ragged
   shapes on every route, each case's three routes checked, by the rules
   above (forward and dgrad bit-equal in both dtypes); the wgrad's plan
   (openeat_dwconv1d_wgrad_plan) must equal dw.wgrad_plan at every K
   kind, both dtypes and two SM counts. Then the CTC
   forward-backward K1/K2 counterparts (openeat_torch/csrc/ctc_loss.cu)
   against the plain recursions, bit for bit in loss and gamma (NEG_INF
   entries equal), with repeats, an infeasible row, len == 1 and an
   input length of T + 5 in every case (K2 also at a tall S = 49 and at
   S = 1001), each beside its bytes bound and its chain bound (T x one
   dependent step, timed by ctc.chain_step_ms). The port's whole CTC op
   (gather, kernel, scatter; forward and backward) is timed beside
   F.ctc_loss forward and backward at the same (B, T, V, L), the
   yardstick the port never calls.
3. Slice phase: writes 16 synthetic 3-8 s wavs, a 4233-entry dict, the
   flagship AIShell Conformer config (examples/aishell/conf/
   train_conformer.yaml model_conf: d=256, 12 blocks, 3+3 decoders) as
   JSON and a model with seeded random weights, then runs
   openeat_torch.bin.recognize on cuda in the four modes at batch 8 and
   beam 10 (greedy, prefix beam and rescoring with --timestamp_file),
   once more in the attention mode with --adaptive_steps 1
   --length_penalty 0.5, and in rescoring and attention with
   compute_dtype bfloat16. Checks that every key is written, that K3
   launched 12 times per encoded batch, and that the timestamp JSONL has
   one row per key with as many times as tokens, nondecreasing and
   below T' x 40 ms. In float32 the encoder output and CTC log-probs
   match a CPU run of the same model (plain path) within ENC_TOL, greedy
   tokens agreeing wherever the CPU top-2 margin exceeds 10 x ENC_TOL.
   In float32 and bfloat16, every utterance's CTC searches on the card
   against the port's python oracle (openeat_torch/decode/numpy_ref.py)
   on the same log-probs: greedy tokens equal, and the prefix beam's
   best prefix at beam 10 equal with its score within 1e-4 (either of
   the oracle's two best where they lie within 1e-4, none where the
   oracle's prefix is longer than max_hyp_len); in bf16 the beam search
   and its oracle take the log-probs in float64 less 1e-3 x seeded
   uniform noise, since the bf16 head's exact ties let the two prune
   apart. Prints agree / ties / capped and the oracle's time.
   The KV cache against recompute: the cached attention search gives
   the full-prefix search's tokens on both batches, decoder_step along
   a fixed prefix matches decoder_logits within ENC_TOL, and its first 4
   steps match a CPU run within ENC_TOL.
4. Breakdown: model load, host collate and each decode stage per batch
   (the attention search with its steps per batch), the device's idle
   share over one rescoring pass and over the attention search, and the
   host time the search spends blocked in its per-step "all finished"
   test (torch.profiler).
5. Training through openeat_torch.bin.train on cuda: 40 wavs of 3-8 s
   with round(3 x seconds) tokens and two of 19.5 s with 120 tokens
   (their batch's T x S history only fits device memory, so K2's
   counterpart runs), a 4-utterance cv set, the flagship config (bf16,
   SpecAugment, dropout 0.1, dynamic 10000-frame batches), 2 epochs;
   then a resume from epoch_1.pt for one epoch, and recognize from
   epoch_2.pt and train.json. Checks finite losses, the files, the
   continued step count, and the launch counts: K3 forward, dgrad and
   wgrad 12 times per train step (forward also 12 per cv batch and per
   decoded batch), one CTC kernel per train step and cv batch, both
   variants used.
6. Recipe, after that training run (examples/aishell/run.sh's order):
   openeat_torch.bin.average_model --val_best --num 2 over its epoch_1
   and epoch_2 (each averaged tensor equal to a float64 host mean),
   openeat_torch.bin.train_lm on cuda at examples/aishell/conf/
   train_lm.yaml's width for 2 epochs on the training and cv
   transcripts (finite losses, files written), a Kneser-Ney bigram ARPA
   of the training transcripts by openeat_torch.tools.train_ngram, then
   recognize of the cv set from avg_2.pt in attention_rescoring with the
   Transformer LM (--lm_weight 0.3) and with the n-gram, each with its
   CER through
   openeat_torch.utils.wer.corpus_wer (printed, no threshold; random
   transcripts; the unfused decode with its CER is phase 17's stage 4).
   The fused scores must differ from the unfused ones on some
   candidate, and the LM's float32 log_probs on the card match a CPU
   run within ENC_TOL.
7. One float32 train step, GPU against CPU, on a 4-utterance batch at
   full width (dropout 0, SpecAugment off, TF32 off, same weights).
8. Overfit: 30 steps on one repeated 8-utterance batch (dropout 0,
   SpecAugment off); the mean loss of the last 5 must be below 0.9 x
   the first.
9. (No phase: the training rate, its layers and the device's idle share
   are perfbench's, `python3 -m perfbench.run`.)
10. Streaming (before 7-8), the streaming Conformer of examples/aishell/
   conf/train_conformer_streaming.yaml (causal convs, dynamic chunks;
   static chunk 16 with 4 left chunks for the offline reference) at full
   width with seeded random weights, float32, chunks of 16 positions
   (640 ms) with 4 left chunks, 200 ms pieces. In the kernel phase K3
   runs at the chunk step's shapes [1, 30, 256] and [8, 30, 256] (the
   conv cache in front of the chunk) in both dtypes, by TMA, bit-equal
   to its plain version, timed beside a copy of its input. Then: the
   encoder rows StreamingRecognizer collects for 4 decode wavs match the
   offline chunk-masked encode on the card within rtol 1e-3 / atol 2e-4
   and the streamed greedy result is the offline one (frame argmax equal
   wherever the top-2 margin exceeds 10 x the measured log-prob gap),
   with 12 K3 launches per chunk step at [1, 30, 256] by TMA; one
   stream's rows on the card against the CPU within ENC_TOL;
   StreamingBatch at S = 8 over the 16 wavs with ragged arrivals and
   reused slots against 16 sequential S = 1 runs, by the same rules,
   12 K3 launches per step. openeat_torch.bin.stream_recognize on cuda
   over the 16 wavs with --timestamp_file: --slots 1 greedy (seconds
   per chunk step, p50 and p99 piece latency) and --slots 8
   attention_rescoring (aggregate x-realtime), in float32 and bfloat16.
   The device's idle share over profiled chunk steps at S = 1 and S = 8.
   Then bin.train on the streaming config (bf16, dynamic chunks,
   SpecAugment, dropout) for one epoch of the training corpus, finite
   losses, the launch counts of 5, and stream_recognize --slots 4 of the
   cv set from its checkpoint.
11. Serving and int8 (after 10's stream runs), the same streaming model
   in float32. bin/serve's build_server on cuda, 127.0.0.1, port 0,
   --slots 8, rescoring finals, reverse_weight 0.3: 16 AsrClient
   threads send the decode wavs in 200 ms pieces as fast as the socket
   takes them (8 wait for admission) and one more sends the first wav
   at 8 kHz. Every final's tokens and times_ms equal a direct float16
   StreamingBatch run of the same int16 audio on the card, each
   session's partials concatenate to a prefix of its direct greedy
   path, no error event arrives, and K3 runs 12 times a chunk step at
   [8, 30, 256] float32 by TMA; aggregate x-realtime (first open to last
   final), end-to-final p50/p99, first-partial p50, the smallest top-2
   CTC log-prob margin, and the device's idle share over a second,
   profiled round of the 16 clients. serve_endpoint: one session on
   --endpoint --endpoint_rule3_ms 2000 at the audio's own pace and no
   "end" gets its final with endpoint true after at most 2000 + 640 ms
   of decoded audio. int8: the widened weights on the card bit-equal to
   the CPU's, bin/serve --quantize int8 under the same 16 clients
   (x-realtime; finals equal to float32's counted, not asserted),
   bin/recognize --quantize int8 on the flagship (attention_rescoring,
   batch 8, RTF), and its greedy tokens on 4 wavs equal to a CPU run's.

12. MoE (after 6), examples/aishell/conf/train_conformer_moe.yaml's
   model_conf (the flagship's, with a top-2 mixture of 4 experts at
   capacity factor 1.25 in every block's main FFN, bf16) through
   openeat_torch.bin.train for one epoch of the training corpus with the
   flagship phase's 10000-frame batches (the recipe's are 80000): finite
   losses and a finite moe_aux in every step record, the launch counts of
   5, then recognize (attention_rescoring) of the cv set from its
   epoch_1.pt and each layer's share of routed (token, expert) pairs past
   the capacity on three training batches. (Phase 19's MoE leg trains
   the same model through the MoE drive's script at its static batch of
   64.) One float32 MoE FFN at full
   width on the card against the CPU: output within MOE_TOL of max |y|,
   aux within 1e-5, the same kept pairs, some dropped.
13. Distributed paths, in child processes of this script: (b) runs
   beside 12, (a) after it. (a) bin.train of the flagship in float32 with dropout 0 on 30
   training utterances, alone and as a one-rank NCCL world (the loss
   shares, the flat gradient all-reduce, the metric sums), with
   deterministic algorithms: step metrics and epoch_1.pt bit-equal; then
   the all-reduce of a float32 buffer of the model's gradients, and the
   flatten, all-reduce and unflatten that apply_update does, timed. (b)
   two ranks sharing the card over gloo (NCCL takes one rank a device):
   one float32 SGD step at dp = 2, one at tp = 2 and one of the MoE
   model at dp = 2 with capacity factor 0.5 (tokens drop), each held to
   the one-rank step on the same 4-utterance batch within 7's
   tolerances (losses STEP_LOSS_TOL, the norm and each tensor's update
   STEP_GRAD_TOL). These check correctness; no multi-card speed is
   measured.
14. Pipeline and sequence parallelism, in 13's child processes: (b)
   also runs the GPipe step of openeat_torch/parallel/pipeline.py at
   pipe = 2 with 4 microbatches (pp2: the loss tail on both pipe ranks;
   pp2_tail: on the last stage only) and the tp = 2 step with
   sequence_sharding (sp_tp2) on the batch cut to an even T', each held
   to the one-rank step by 13's rules. Each case records its step's
   wall time, each rank's launches of K3 forward, dgrad and wgrad and of
   the CTC kernels (their sum over the ranks must be non-zero), each
   pipe rank's parameter bytes against the whole model's (smaller), and
   the K3 inputs sp_tp2 saw, which must be [4, T'/2 + 14, 256]: the
   shard with its halo. (a) runs one step of the schedule at pipe = 1
   with 4 microbatches on NCCL against the plain step (not bit-equal:
   another summation order), its kernels launched. These steps'
   launches join the kernels line.

15. WeNet pre-trained fine-tuning (after 9; examples/asrucs2019/run.sh
   stage 2 and examples/wenet_pre-trained_decoding/run.sh): global CMVN
   statistics of the training wavs from openeat_torch.tools.compute_cmvn
   on cuda, held against the phase's own fbank sums on the card (equal
   frame counts, within CMVN_TOOL_RTOL), as the tool's JSON and a kaldi
   text file, a WeNet-layout final.pt (the flagship with seeded random
   weights and those statistics, under WeNet's names and layouts) and a
   WeNet train.yaml written as YAML text, which the port's reader must
   give back as the dict it was written from. Then
   openeat_torch.bin.convert_wenet, which must give back the model the
   .pt was written from; recognize with the WeNet train.yaml in the four
   modes on 8 decode wavs (bf16, the default of a config naming no
   dtype), 12 K3 launches each; the decoded model's statistics equal
   the written ones, its frontend feeds raw fbank, and its float32
   encoder on the card is within ENC_TOL of the CPU's on that batch.
   Then bin.train --checkpoint <converted> --only_adapter --profile_dir
   with the asrucs2019 model_conf, adapters on (down_size 64, scalar
   0.1), bf16, dataset_conf.speed_perturb, speed_perturb_rate 0.5 and
   wav_dither 1.0, one epoch of the training corpus (max_length 3000,
   so the 19.5 s wavs, 21.7 s at speed 0.9, run K2): every non-adapter
   tensor of epoch_1.pt bit-equal to the converted checkpoint's, CMVN
   included, every adapter tensor moved from its init, finite losses,
   train.json with use_global_cmvn true and normalization false, the
   trace naming openeat_dwconv1d_fwd, _dgrad and _wgrad (the wrappers'
   launch regions) and the K3 and ctc_dp_* device kernels, and the
   launch counts of 5 with the 4 profiled warm-up
   steps (K2 among them). The adapter step's seconds against the full
   step's on one batch. Last, bin.train --cmvn_file <kaldi text>
   --is_json_cmvn false from scratch, 8 epochs of one 8-utterance batch
   (dropout 0, no SpecAugment): the loss falls and the checkpoint's
   statistics equal the file's.

16. LibriSpeech (after 15; examples/librispeech/run.sh stages 1-4 at
   conf/train_conformer.yaml's full width: d 256, FFN 2048, 12 blocks,
   kernel 31, 3+3 decoders, bf16, SpecAugment, wav dither 0.1, online
   speed perturbation 0.5, 12000-frame batches, accum_grad 4). A seeded
   English corpus: 3000 train transcripts over a 3000-word Zipf lexicon,
   16-bit 16 kHz FLAC (the port's encoder, on 8 processes) for the first
   36 of them (32 of 3-16 s, 4 of 24-28 s: T' past 600, S past 128) and
   a 4-utterance cv set, one train entry a `path,start,end` segment.
   openeat_torch.bin.train_bpe at 1000 (its symbols and merges must
   reach 1000), the dict from the port's tokenize; every file read by
   the native library (native/openeat_io.cc, built with g++) equals the
   port's Python decoder, sample for sample (s per audio-s of each).
   bin.train --bpe_model for 3 epochs (12 optimizer steps, the phase's
   cut): finite losses, every waveform read by the native library and
   none by the Python decoder, K2 at T' > 600, and the launch counts (12
   K3 forward, dgrad and wgrad and one CTC kernel a micro-batch; 12
   forward and one CTC a cv batch). average_model --val_best, then
   recognize --bpe_model of the cv set in ctc_greedy_search and
   attention_rescoring (no `▁` in the text, word WER from utils/wer.py,
   RTF), and its float32 encoder on the card within ENC_TOL of the
   CPU's. Kaldi: the fbank of 8
   training utterances as a plain and a compressed ark, 2 --data_type
   kaldi train steps on the compressed one, and recognize --data_type
   kaldi of the plain one, equal to a decode of the same features in
   memory. conv2d6, conv2d8, linear and no_pos at 2 blocks: a finite
   bf16 train step, the float32 encoder on the card within ENC_TOL of
   the CPU's. ctc_impl parallel against F.ctc_loss in float64 at every
   training CTC shape (CTC_PARALLEL_TOL). K1 and K2 bit-equal to the
   plain recursions at every (B, T, S) of the training run (as in 3),
   timed at each one's largest T x S, and K2's plan at the run's
   widths. K3 at K = 31 at the run's largest and most frequent shapes,
   float32 and bfloat16: forward and dgrad bit-equal to the plain
   versions, wgrad by the rules of 2, with times, bounds and library
   times. Launches at each shape are what the wrappers counted at that
   shape in the training run. Last, one profiled bf16 train step of
   this model, which must name the train step's spans, the K3 wrappers'
   regions, the K3 kernels and a CTC kernel.

17. Recipe script (after 16): openeat_torch/examples/aishell/run.sh
   --stage 0 --stop_stage 4 --device cuda as a child process (its CLIs
   and tools in grandchildren, which load the kernels this process
   built) over a synthetic corpus in AIShell-1's on-disk layout (24
   train wavs of 3-8 s and one of 19.5 s with 120 characters, 4 dev, 8
   test), with a copy of examples/aishell/conf/train_conformer.yaml in
   which only max_epoch: 2, warmup_epoch: 1 and log_interval: 1 are
   rewritten (the port's reader must give it the repo file's dict but
   for those keys): the flagship at full width, bf16, SpecAugment and
   dropout on. Checks each stage's files, finite losses, avg_best2.pt
   and train.json, every test key in each mode's hypotheses, one CER
   line a mode (printed; random transcripts, no threshold), each
   stage's seconds. The script's `python` starts each
   openeat_torch.bin CLI through this file (role counted_cli), which
   sets every kernel wrapper's count to 0, runs the CLI and at exit
   writes its counts and the counts a shape; those are the phase's
   launches. The train stage must launch K3's forward 12 times a train
   step and cv batch, its dgrad and wgrad 12 times a step, one CTC
   kernel a step and cv batch, K1 and K2 both (K2 on the 19.5 s wav's
   batch); each decode 12 K3 launches a batch; no other CLI a kernel.
   K3's forward, dgrad and wgrad and K1 and K2 are checked at every
   shape the script launched them at and timed at the largest. Then in
   this process: recognize of avg_best2.pt in attention_rescoring must
   give the script's hypotheses (where a key's tokens differ, its top-2
   rescoring margin must be within 10 x ENC_TOL), 12 K3 launches a
   batch; openeat_torch.tools.compute_cmvn on cuda over the train
   format.data must equal its CPU run (frame counts, per-frame mean and
   variance within CMVN_CPU_ATOL).
18. Quality corpus (after 17): python -m
   openeat_torch.quality.make_structured_corpus --profile lmhard at
   64 / 4 / 8 utterances, 200 lm_text sentences and the adversarial
   splits at 4 (QUALITY_CORPUS), twice, into two directories: the two
   builds byte-equal (wav.scp once the root is replaced); every dev,
   test and adversarial FLAC read by the native reader
   (openeat_torch/runtime/native_io.py) and by the Python decoder to the
   same samples; openeat_torch.quality.confs' derived training and LM
   configs, written as JSON, load through load_config to the dicts of
   the round-5 drive's conf_synth.yaml and conf_lm.yaml
   (benchmarks/results/r5_recipe_lmhard/, read by the port's YAML
   reader). Then openeat_torch/quality/run_recipe.sh --stage 1
   --stop_stage 1 --device cuda (dict.txt and the three format.data
   files); openeat_torch/quality/init_draw.py's draw at the drive's
   seed (777), written as exp/epoch_0.pt, equal bit for bit to the
   model bin.train --max_epoch 0 builds on this host, its sha256
   printed on a line of its own (quality_corpus init_draw); then
   --stage 2 --stop_stage 2 --max_epoch 1 through the counted_cli shim
   of phase 17, which resumes from that draw at step 0 (bin.train's own
   draw at that seed, so the same step): one epoch of conf_synth.json
   (round 5's but max_epoch) at the flagship's width, one training step
   on the static batch of 64 and one cv batch, finite losses. Its
   bin.train must launch K3's forward 12 times a step and cv batch,
   its dgrad and wgrad 12 times a step, all at batch 64, and K1 once a
   step and cv batch, K2 never; K3's forward, dgrad and wgrad and K1
   are checked at every shape it launched them at and timed
   at the largest. The drive itself (60 epochs) is not a phase:
   openeat_torch/quality/drive.sh runs it.
19. Streaming drive (after 18): the hard corpus at 64 / 4 / 8
   utterances by openeat_torch/quality/run_recipe.sh --stage 0
   --stop_stage 1, then openeat_torch/quality/run_streaming.sh
   --max_epoch 1 --device cuda through the counted_cli shim of phase
   17: global CMVN, one training step of conf_stream.json (the hard
   profile's config, causal, static 16-frame chunks) at the flagship's
   width and its static batch of 64 and one cv batch, the average, the
   offline greedy and rescoring decodes and the 16-slot stream_recognize
   with attention-rescoring finals, each with its CER, and
   results_streaming.json with round 3's keys
   (benchmarks/results/r3_streaming_hard/). Its bin.train must launch
   K3 and K1 as phase 18's does, each offline decode K3's forward 12
   times a test batch, stream_recognize K3's forward 12 times a chunk
   step, every step at [16, 14 + 16, 256], between the longest
   stream's chunks and all streams' chunks; K3's forward, dgrad and
   wgrad and K1 are checked at every shape launched and timed at the
   largest, and K3 at the chunk step's shape once more, by TMA,
   bit-equal, timed. The MoE leg, once that corpus exists:
   openeat_torch/quality/run_moe.sh --max_epoch 1 --device cuda on it,
   stage 1 (conf_moe.json: the hard profile's config with round 3's
   top-2-of-4 experts and warmup 8; its log interval cut to 1) and then
   stages 2-5 through the counted shim: one training step at the
   flagship's width and batch 64 and one cv batch, the average, the
   greedy and rescoring decodes with their CERs, and results_moe.json
   with round 3's keys in its order, finite
   (benchmarks/results/r3_moe_hard/); a finite loss and moe_aux in every
   step record; hypotheses of every test key. Its CLIs: bin.train 1,
   average_model 1, recognize 2, launching as the streamed leg's offline
   CLIs do; every kernel is checked at every shape launched and timed at
   the largest. Both legs' child processes run on threads of their own
   (the MoE leg's waits for the corpus) beside phase 17's script, and
   phase 17 waits for them before it times a kernel. The drives
   themselves (40 and 60 epochs) are not phases: drive.sh --script
   run_streaming.sh and --script run_moe.sh run them.

The phases' configs are the repo's files (examples/*/conf/*.yaml) as
openeat_torch.config.load_config reads them, without PyYAML; each
phase's cuts (epochs, warmup, batch frames, log interval) go on top.
Any failed check raises. Before the last two stdout lines it prints the
card's name and power limit again; then the kernels line (each kernel's
launches on the main path, error, times and bounds; the CTC rows with
their chain bound; K3 once more at each chunk-step shape with the
stream runs' launches there; K3 at K = 31 and K1 and K2 once more at
the LibriSpeech run's shapes, with that run's launches there; each
kernel once more at the largest shape the recipe script of phase 17
the quality drive's step of phase 18 and the streamed and MoE drives'
CLIs of phase 19 launched it at, with that run's launches at all its shapes,
`shape_launches` listing them, and the largest error over them;
`phase` names the run; K3 at phase 19's chunk step; and the update's
four multi-tensor kernels at each benchmark configuration's parameter
list, with the launches of slice 2's bf16 training and of the LibriSpeech
phase's profiled steps, which count them from 0) and the JSON
result. Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import atexit
import copy
import ctypes
import itertools
import json
import math
import os
import re
import runpy
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import warnings
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.profiler_util import _filter_name

from openeat_torch.bin import (average_model, convert_wenet, recognize,
                               stream_recognize, train_lm)
from openeat_torch.bin import serve as serve_cli
from openeat_torch.bin import train as train_cli
from openeat_torch.bin import train_bpe
from openeat_torch.config import TrainConfig, load_config
from openeat_torch.dataset import audio as audio_lib
from openeat_torch.dataset import kaldi_io
from openeat_torch.dataset.audio import read_wav, resample, write_wav
from openeat_torch.dataset.batching import pad_batch_2d
from openeat_torch.dataset.bpe import load_bpe
from openeat_torch.dataset.dataset import (AudioCollate, AudioDataset,
                                           PrefetchLoader)
from openeat_torch.dataset.text import (load_dict, remove_punctuation,
                                        token_ids_to_text, tokenize)
from openeat_torch.decode import attention_beam, numpy_ref
from openeat_torch.decode.attention_beam import recognize as attention_decode
from openeat_torch.decode.ctc_greedy import ctc_greedy_search
from openeat_torch.decode.rescoring import (attention_rescoring,
                                            rescoring_scores)
from openeat_torch.decode.ctc_prefix_beam import (ctc_prefix_beam_search,
                                                  prefix_beam_init,
                                                  prefix_beam_step)
from openeat_torch.decode.streaming import (FRAME_MS, StreamingRecognizer,
                                            zero_caches)
from openeat_torch.decode.streaming_batch import StreamingBatch
from openeat_torch.lm.ngram import load_lm as load_ngram
from openeat_torch.models.asr_model import build_asr_model, init_parameters
from openeat_torch.modules import convolution as conv_module
from openeat_torch.modules.dropout import set_generator
from openeat_torch.modules.layers import Dense
from openeat_torch.ops import ctc_loss as ctc
from openeat_torch.ops import depthwise_conv as dw
from openeat_torch.ops import fbank as fbank_mod
from openeat_torch.ops import multi_tensor as mt
from openeat_torch.ops import nvcc
from openeat_torch.ops.ctc_parallel import ctc_loss_parallel
from openeat_torch.ops.frontend import (FrontendConfig, augment_features,
                                        compute_features)
from openeat_torch.modules.feed_forward import MoEPositionwiseFeedForward
from openeat_torch.parallel import mesh as mesh_lib
from openeat_torch.parallel.pipeline import make_pp_loss_fn
from openeat_torch.parallel.train_step import TrainState, build_train_step
from openeat_torch.pipeline import DeviceFeeder
from openeat_torch.quality import init_draw
from openeat_torch.runtime import native_io
from openeat_torch.runtime.client import AsrClient
from openeat_torch.runtime.server import recv_frame, send_json
from openeat_torch.tools import compute_cmvn as compute_cmvn_tool
from openeat_torch.tools import train_ngram
from openeat_torch.utils.cmvn import load_cmvn
from openeat_torch.utils.common import get_activation, make_generator
from openeat_torch.utils.optim import build_optimizer
from openeat_torch.utils.quantize import quantized_bytes
from openeat_torch.utils.wenet_convert import convert_wenet_config
from openeat_torch.utils.wer import corpus_wer
from perfbench.trace import union_length

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
# outside the tensor cores, where K3 does its multiply-adds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
L2_BYTES = 50 * 2 ** 20

SEED = 20261016
N_UTTS = 16
BATCH = 8
VOCAB = 4233
ENC_TOL = 2e-3  # float32 GPU vs CPU, TF32 off: summation order only
ORACLE_TOL = 1e-4  # prefix beam score vs the python oracle, as the tests
ORACLE_NOISE = 1e-3  # bf16 log-probs' tie-breaking noise (oracle_checks)
# the spans a train step opens (openeat_torch/utils/profiling.py:span)
STEP_SPANS = ("openeat.step.forward", "openeat.step.backward",
              "openeat.step.update", "openeat.step.sync")


def repo_config(rel: str, **cuts) -> dict:
    """A config file of the repo as the port's load_config reads it (YAML
    without PyYAML), with a phase's top-level cuts on top."""
    return {**load_config(os.path.join(REPO, rel)), **cuts}


AISHELL_CONFIG = "examples/aishell/conf/train_conformer.yaml"
# the flagship: the AIShell recipe's config, with a short warmup, two
# epochs and a loss record every step for the smoke run
TRAIN_CONFIG = repo_config(AISHELL_CONFIG, max_epoch=2, log_interval=1,
                           warmup_steps=4, seed=SEED)
# the decode phases' model (seeded random weights): float32, and swish,
# the default that the recipe configs leave unset
FLAGSHIP_MODEL_CONF = dict(TRAIN_CONFIG["model_conf"], compute_dtype="float32",
                           activation="swish")
MODES = ["ctc_greedy_search", "ctc_prefix_beam_search", "attention",
         "attention_rescoring"]
BEAM = 10
MAX_HYP_LEN = 64
N_TRAIN = 40           # 3-8 s, round(3 x seconds) tokens
LONG_SECONDS, LONG_TOKENS = 19.5, 120
N_CV = 4
STEP_LOSS_TOL = 1e-5   # float32 GPU vs CPU train step, relative
STEP_GRAD_TOL = 1e-3   # per tensor, of its max |grad|


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing

def device_ms(fn, n_inputs: int, reps: int = 7) -> float:
    """Median device time of one call. `fn(i)` runs the call on input
    copy i; a CUDA graph holds one call per copy, so the host's launch
    cost is out of the measurement and each call finds its input cold."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(3, n_inputs)):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inputs):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_inputs)
    return statistics.median(times)


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at each float32 value: 2**(exponent - 8) for
    |ref| = m * 2**exponent, 0.5 <= m < 1 (8 significant bits)."""
    _, exp = torch.frexp(ref)
    return torch.ldexp(torch.ones_like(ref), exp - 8)


# ---------------------------------------------------------------- kernel

def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` one element past a buffer's start: for
    bfloat16 an address 2 bytes off every 4-byte boundary, which only
    K3's element-load route takes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def kernel_case(b: int, tp: int, c: int, k: int, dtype, gen,
                offset: bool = False, exact: bool = False,
                timed: bool = True) -> dict:
    """K3's forward against its plain version; times it, a copy of its
    input, the plain version and the library call, unless `offset` (the
    input at a 2-byte offset) or not `timed` (checked only). `exact`
    asks bit-equality in bfloat16 too."""
    dev = torch.device("cuda")
    x32 = torch.randn((b, tp, c), generator=gen, device=dev)
    w32 = torch.randn((k, c), generator=gen, device=dev) * 0.3
    x, w = x32.to(dtype), w32.to(dtype)
    if offset:
        x = offset_view(x)
    out = dw.depthwise_conv1d(x, w)
    plain = dw.depthwise_conv1d_plain(x, w)
    torch.cuda.synchronize()
    assert out.shape == (b, tp - k + 1, c) and out.dtype == dtype
    err = (out.float() - plain.float()).abs()
    row = {"shape": [b, tp, c], "k": k, "dtype": str(dtype).split(".")[-1],
           "route": dw.device_plan(x, k, dgrad=False).route,
           "offset_bytes": x.data_ptr() % 16, "max_abs_err": float(err.max())}
    if dtype == torch.float32 or exact:
        ok = row["max_abs_err"] == 0.0
    else:
        ulp = bf16_ulp(dw.depthwise_conv1d_plain(x.float(), w.float()))
        row["max_err_ulps"] = float((err / ulp).max())
        ok = row["max_err_ulps"] <= 1.0
    if not ok:
        raise AssertionError(f"K3 disagrees with its plain version: {row}")
    if offset or not timed:
        return row

    t_out = tp - k + 1
    item = x.element_size()
    nbytes = (x.numel() + w.numel() + b * t_out * c) * item
    flops = 2 * b * t_out * c * k
    n_inputs = max(2, min(64, math.ceil(2 * L2_BYTES / nbytes)))
    xs = [x.clone() for _ in range(n_inputs)]
    x_ncw = [xi.transpose(1, 2).contiguous() for xi in xs]
    w_conv = w.t().contiguous()[:, None, :]           # [C, 1, K]
    lib = F.conv1d(x_ncw[0], w_conv, groups=c)
    row["library_max_abs_err"] = float(
        (lib.transpose(1, 2).float() - plain.float()).abs().max())
    row["ms"] = device_ms(lambda i: dw.depthwise_conv1d(xs[i], w), n_inputs)
    dst = [torch.empty_like(xi) for xi in xs]
    row["copy_ms"] = device_ms(lambda i: dst[i].copy_(xs[i]), n_inputs)
    row["plain_ms"] = device_ms(
        lambda i: dw.depthwise_conv1d_plain(xs[i], w), n_inputs)
    row["library_ms"] = device_ms(
        lambda i: F.conv1d(x_ncw[i], w_conv, groups=c), n_inputs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return row


def main_path_shapes(durations: list[float]) -> list[tuple]:
    """K3's input shapes in the decode runs: static batches of the
    duration-sorted utterances, wavs padded to whole seconds, fbank
    frames (25 ms / 10 ms), conv2d x4 subsampling, + (K - 1) padding."""
    n = sorted(int(d * 16000) for d in durations)
    shapes = []
    for i in range(0, len(n), BATCH):
        padded = math.ceil(max(n[i:i + BATCH]) / 16000) * 16000
        frames = (padded - 400) // 160 + 1
        t_enc = ((frames - 3) // 2 + 1 - 3) // 2 + 1
        shapes.append((BATCH, t_enc + 14, 256, 15))
    return shapes


# ---------------------------------------------------------------- slice

def write_corpus(rng: np.random.Generator) -> tuple[str, str, list]:
    wav_dir = os.path.join(WORK, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    vocab = ["<blank>", "<unk>"] + [chr(0x4E00 + i) for i in range(VOCAB - 3)] \
        + ["<sos/eos>"]
    dict_path = os.path.join(WORK, "dict.txt")
    with open(dict_path, "w", encoding="utf-8") as f:
        f.writelines(f"{tok} {i}\n" for i, tok in enumerate(vocab))
    lines, durations = [], []
    for i in range(N_UTTS):
        dur = float(np.round(rng.uniform(3.0, 8.0), 3))
        t = np.arange(int(dur * 16000)) / 16000.0
        x = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 3000) * t)
                for _ in range(3)) + 0.02 * rng.standard_normal(t.size)
        path = os.path.join(wav_dir, f"utt{i:03d}.wav")
        write_wav(path, x.astype(np.float32), 16000)
        text = "".join(vocab[j] for j in rng.integers(2, VOCAB - 1, 12))
        lines.append(f"utt:utt{i:03d}\tfeat:{path}\tfeat_shape:{dur:.3f}\t"
                     f"text:{text}\n")
        durations.append(dur)
    manifest = os.path.join(WORK, "format.data")
    with open(manifest, "w", encoding="utf-8") as f:
        f.writelines(lines)
    return manifest, dict_path, durations


def write_config(compute_dtype: str) -> str:
    cfg = {"model_conf": dict(FLAGSHIP_MODEL_CONF,
                              compute_dtype=compute_dtype),
           "vocab_size": VOCAB, "input_size": 80,
           "collate_conf": {"feature_extraction_conf": {"mel_bins": 80},
                            "spec_aug": True},
           "dataset_conf": {"max_length": 2000, "min_length": 10}}
    path = os.path.join(WORK, f"train_{compute_dtype}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def random_model_state(gen: torch.Generator,
                       conf: dict = FLAGSHIP_MODEL_CONF) -> dict:
    """Full-width model with weights drawn from `gen`: matrices scaled by
    1/sqrt(fan_in), LayerNorm gains near 1, small biases."""
    model = build_asr_model(conf, 80, VOCAB)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=gen)
            if name.endswith("embed.weight"):
                p.copy_(z)
            elif name.endswith("depthwise_conv.weight"):
                p.copy_(z / math.sqrt(p.shape[0]))
            elif p.dim() >= 2 and "pos_bias" not in name:
                p.copy_(z / math.sqrt(p[0].numel()))
            elif p.dim() == 1 and name.endswith(".weight"):  # LayerNorm
                p.copy_(1.0 + 0.05 * z)
            else:
                p.copy_(0.05 * z)
    return model.state_dict()


def run_recognize(cfg: str, ckpt: str, manifest: str, dict_path: str,
                  mode: str, tag: str, extra=(), timestamps: bool = False
                  ) -> tuple[dict, float, int, list | None]:
    """recognize on cuda with K3's count set to 0 just before and read
    just after. Returns (hyps by key, wall s, K3 launches, the
    --timestamp_file rows when `timestamps`)."""
    out = os.path.join(WORK, f"hyp_{tag}.txt")
    ts_path = os.path.join(WORK, f"ts_{tag}.jsonl")
    ts_args = ["--timestamp_file", ts_path] if timestamps else []
    dw.depthwise_conv1d.launches = 0
    t0 = time.perf_counter()
    recognize.main(["--config", cfg, "--checkpoint", ckpt, "--test_data",
                    manifest, "--dict", dict_path, "--result_file", out,
                    "--mode", mode, "--batch_size", str(BATCH),
                    "--beam_size", str(BEAM), "--max_hyp_len",
                    str(MAX_HYP_LEN), "--reverse_weight", "0.3",
                    "--device", "cuda", *ts_args, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dw.depthwise_conv1d.launches
    with open(out, encoding="utf-8") as f:
        hyps = dict((line.rstrip("\n").split(" ", 1) + [""])[:2]
                    for line in f)
    rows = None
    if timestamps:
        with open(ts_path, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
    return hyps, wall, launches, rows


def encoder_frames(seconds: float) -> int:
    """Encoder positions of a wav of `seconds` at 16 kHz."""
    return encoder_positions(int(seconds * 16000))


def encoder_positions(samples: int) -> int:
    """Encoder positions of `samples` at 16 kHz: fbank frames (25 ms /
    10 ms) through the conv2d x4 subsampling."""
    frames = (samples - 400) // 160 + 1
    return ((frames - 3) // 2 + 1 - 3) // 2 + 1


def check_timestamps(tag: str, rows: list, hyps: dict,
                     t_enc: dict) -> dict:
    """One JSONL row per key, as many times as tokens, nondecreasing and
    inside the utterance (below T' x 40 ms)."""
    if sorted(r["key"] for r in rows) != sorted(hyps):
        raise AssertionError(f"{tag}: timestamp keys "
                             f"{[r['key'] for r in rows]}")
    n_tokens = 0
    for r in rows:
        times = r["times_ms"]
        if len(times) != len(r["tokens"]) or times != sorted(times) \
                or any(not 0 <= t < t_enc[r["key"]] * 40.0 for t in times):
            raise AssertionError(f"{tag}: bad timestamps {r}")
        n_tokens += len(times)
    return {"rows": len(rows), "tokens": n_tokens}


def compare_with_cpu(cfg_path: str, ckpt: str, manifest: str,
                     dict_path: str) -> dict:
    """First batch: GPU (K3) vs CPU (plain) frontend, encoder and CTC."""
    cfg = json.load(open(cfg_path))
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"))
    cpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cpu"))
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=BATCH)
    feeds = {}
    for dev in ("cuda", "cpu"):
        feeder = DeviceFeeder(PrefetchLoader(ds, AudioCollate()),
                              FrontendConfig(), torch.device(dev), BATCH)
        feeds[dev] = next(iter(feeder))[1]
    feats = feeds["cuda"]["features"]
    lens = feeds["cuda"]["features_length"]
    with torch.inference_mode():
        g_enc, g_lens = gpu.encode(feats, lens)
        g_lp = gpu.ctc_log_probs(g_enc)
        c_enc, c_lens = cpu.encode(feats.cpu(), lens.cpu())
        c_lp = cpu.ctc_log_probs(c_enc)
    for t in (g_enc, g_lp):
        assert torch.isfinite(t).all(), "non-finite encoder/CTC output"
    assert g_enc.shape == (BATCH, g_enc.shape[1], 256)
    assert g_lp.shape == g_enc.shape[:2] + (VOCAB,)
    assert torch.equal(g_lens.cpu(), c_lens)
    valid = (torch.arange(c_enc.shape[1])[None, :] < c_lens[:, None])
    res = {
        "feature_max_abs_err": float((feeds["cuda"]["features"].cpu()
                                      - feeds["cpu"]["features"]).abs().max()),
        "encoder_max_abs_err": float((g_enc.cpu() - c_enc).abs()[valid].max()),
        "ctc_logp_max_abs_err": float((g_lp.cpu() - c_lp).abs()[valid].max()),
    }
    top2 = c_lp.topk(2, dim=-1).values
    sure = valid & (top2[..., 0] - top2[..., 1] > 10 * ENC_TOL)
    agree = g_lp.argmax(-1).cpu() == c_lp.argmax(-1)
    res["greedy_frames_checked"] = int(sure.sum())
    res["greedy_frames_valid"] = int(valid.sum())
    res["greedy_disagreements"] = int((sure & ~agree).sum())
    if res["encoder_max_abs_err"] > ENC_TOL \
            or res["ctc_logp_max_abs_err"] > ENC_TOL \
            or res["greedy_disagreements"]:
        raise AssertionError(f"GPU decode path disagrees with CPU: {res}")
    return res


def oracle_checks(cfg_path: str, ckpt: str, manifest: str,
                  dict_path: str) -> dict:
    """Every utterance's CTC searches on the card against the port's
    plain python oracle (openeat_torch/decode/numpy_ref.py) on the same
    log-probs: ctc_greedy_search's tokens equal ctc_greedy_ref's, and
    ctc_prefix_beam_search's best prefix equals ctc_prefix_beam_ref's at
    BEAM with its score within ORACLE_TOL (relative and absolute). Where
    the oracle's two best scores lie within ORACLE_TOL (a tie) either
    prefix is accepted; an oracle prefix longer than MAX_HYP_LEN
    (capped) is not compared. Counts agree / ties / capped and times
    the oracle.

    In bfloat16 the CTC head's logits are bf16: a frame's log-probs
    tie often (`tied_frames`: frames whose top BEAM + 1 holds a tie),
    and since every CTC path takes one log-prob a frame, the score gap
    between two paths is a sum of logit gaps on bf16's coarse grid, so
    distinct prefixes tie exactly as well. The search and the oracle
    break such ties in different orders (a stable top-k against numpy's
    argsort, float32 against python floats), and their beams prune
    apart. So in bfloat16 the prefix beam search and its oracle both
    take the log-probs in float64 less ORACLE_NOISE x uniform [0, 1)
    noise drawn from SEED on the card, which leaves no two paths equal
    and every near-tie far above float64's rounding; greedy takes the
    decode's own log-probs in both dtypes (argmax takes the first
    maximum on both sides)."""
    cfg = json.load(open(cfg_path))
    dtype = cfg["model_conf"]["compute_dtype"]
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"))
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=BATCH)
    feeder = DeviceFeeder(PrefetchLoader(ds, AudioCollate()),
                          FrontendConfig(), torch.device("cuda"), BATCH)
    res = {"utterances": 0, "greedy_equal": 0, "agree": 0, "ties": 0,
           "capped": 0, "frames": 0, "tied_frames": 0, "oracle_s": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        for _, batch in feeder:
            enc, lens = gpu.encode(batch["features"],
                                   batch["features_length"])
            lp = gpu.ctc_log_probs(enc)
            assert torch.isfinite(lp).all(), f"{dtype}: non-finite log-probs"
            hyps, hyp_lens = ctc_greedy_search(lp, lens)
            top = lp.topk(BEAM + 1, dim=-1).values
            valid = (torch.arange(lp.shape[1], device=lp.device)
                     < lens[:, None])
            res["frames"] += int(valid.sum())
            res["tied_frames"] += int(((top[..., 1:] == top[..., :-1])
                                       .any(dim=-1) & valid).sum())
            beam_lp = lp
            if dtype == "bfloat16":
                beam_lp = lp.double() - ORACLE_NOISE * torch.rand(
                    lp.shape, generator=gen, dtype=torch.float64,
                    device=lp.device)
            nbest, nbest_lens, scores = ctc_prefix_beam_search(
                beam_lp, lens, beam_size=BEAM, max_hyp_len=MAX_HYP_LEN)
            lp_host = lp.cpu().numpy()
            beam_host = beam_lp.cpu().numpy()
            lens = lens.cpu().tolist()
            hyps, hyp_lens = hyps.cpu(), hyp_lens.cpu().tolist()
            nbest, nbest_lens = nbest.cpu(), nbest_lens.cpu().tolist()
            scores = scores.cpu().tolist()
            for i, n in enumerate(lens):
                t0 = time.perf_counter()
                want_greedy = numpy_ref.ctc_greedy_ref(lp_host[i], n)
                ref = numpy_ref.ctc_prefix_beam_ref(beam_host[i], n, BEAM)
                res["oracle_s"] += time.perf_counter() - t0
                utt = res["utterances"]
                res["utterances"] += 1
                got_greedy = hyps[i, :hyp_lens[i]].tolist()
                if got_greedy != want_greedy:
                    raise AssertionError(
                        f"{dtype} utterance {utt}: ctc_greedy_search "
                        f"{got_greedy} != oracle {want_greedy}")
                res["greedy_equal"] += 1
                if len(ref[0][0]) > MAX_HYP_LEN:
                    res["capped"] += 1
                    continue
                got = (tuple(nbest[i, 0, :nbest_lens[i][0]].tolist()),
                       scores[i][0])
                tie = ref[0][1] - ref[1][1] <= ORACLE_TOL
                ok = [(p, s) for p, s in ref[:2 if tie else 1]
                      if p == got[0] and abs(got[1] - s)
                      <= ORACLE_TOL + ORACLE_TOL * abs(s)]
                if not ok:
                    raise AssertionError(
                        f"{dtype} utterance {utt}: prefix beam best {got} "
                        f"not the oracle's {ref[:2]}")
                res["ties" if tie else "agree"] += 1
    return res


def stage_breakdown(cfg_path: str, ckpt: str, manifest: str,
                    dict_path: str, dev: torch.device) -> dict:
    """Where a decode run's time goes: model load, host collate, and
    each device stage per batch (host clock around synchronized work,
    median of 3 passes over both batches), the attention search's steps
    among them; then the device's busy share over one full
    attention_rescoring pass, and over one attention search of both
    batches with the host time blocked in its per-step "all finished"
    test (torch.profiler's aten::_local_scalar_dense, the search's only
    host sync) and the operators it dispatches a step, from
    torch.profiler's kernel, copy and operator events."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    model = recognize.load_model(json.load(open(cfg_path)), ckpt, VOCAB, dev)
    torch.cuda.synchronize()
    out = {"model_load_s": time.perf_counter() - t0}
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=BATCH)
    t0 = time.perf_counter()
    host = [AudioCollate()(ds[i])[1] for i in range(len(ds))]
    out["host_collate_s_per_batch"] = (time.perf_counter() - t0) / len(ds)
    wavs = [(torch.from_numpy(b["wav"]).to(dev),
             torch.from_numpy(b["wav_lens"]).to(dev)) for b in host]
    fe = FrontendConfig()
    steps = [0]
    step_fn = model.decoder_step

    def counted_step(*args):
        steps[0] += 1
        return step_fn(*args)

    model.decoder_step = counted_step

    def attention(enc, enc_lens):
        attention_decode(model, enc, enc_lens, beam_size=BEAM,
                         max_steps=min(int(enc.shape[1]), MAX_HYP_LEN))

    def one_pass(lap):
        for wav, lens in wavs:
            feats, flens = compute_features(wav, lens, fe)
            lap("frontend")
            enc, enc_lens = model.encode(feats, flens)
            lap("encode")
            lp = model.ctc_log_probs(enc)
            lap("ctc_head")
            ctc_greedy_search(lp, enc_lens)
            lap("greedy_search")
            nbest = ctc_prefix_beam_search(lp, enc_lens, beam_size=BEAM,
                                           max_hyp_len=MAX_HYP_LEN)
            lap("prefix_beam_search")
            attention_rescoring(model, enc, enc_lens, *nbest,
                                ctc_weight=0.5, reverse_weight=0.3)
            lap("rescoring")
            attention(enc, enc_lens)
            lap("attention_search")

    totals: dict[str, list] = {}
    with torch.inference_mode():
        for _ in range(3):
            run = {}
            clock = [time.perf_counter()]

            def lap(name):
                torch.cuda.synchronize()
                now = time.perf_counter()
                run[name] = run.get(name, 0.0) + now - clock[0]
                clock[0] = now

            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
            steps[0] = 0
            one_pass(lap)
            for name, sec in run.items():
                totals.setdefault(name, []).append(sec / len(wavs))
        out["stage_s_per_batch"] = {k: statistics.median(v)
                                    for k, v in totals.items()}
        out["attention_steps_per_batch"] = steps[0] / len(wavs)
        out["attention_s_per_step"] = (out["stage_s_per_batch"][
            "attention_search"] / out["attention_steps_per_batch"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_pass(lambda name: None)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        encoded = [model.encode(*compute_features(w, n, fe)) for w, n in wavs]
        torch.cuda.synchronize()
        steps[0] = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as aprof:
            t0 = time.perf_counter()
            for enc, enc_lens in encoded:
                attention(enc, enc_lens)
            torch.cuda.synchronize()
            attn_wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = _device_busy_us(prof)
    out["profiled_wall_s"] = wall_us / 1e6
    out["device_busy_s"] = busy_us / 1e6
    # no device events means the profiler could not trace the card
    out["device_idle_share"] = 1.0 - busy_us / wall_us if busy_us else None
    attn_busy = _device_busy_us(aprof)
    sync_us = _host_us(aprof, "aten::_local_scalar_dense")
    # operators the host dispatches: what a step costs the host
    host_ops = _top_level_host_ops(aprof)
    out["attention_search"] = {
        "host_ops_per_step": host_ops / steps[0],
        "wall_s_per_batch": attn_wall_us / 1e6 / len(wavs),
        "device_busy_s_per_batch": attn_busy / 1e6 / len(wavs),
        "device_idle_share": (1.0 - attn_busy / attn_wall_us
                              if attn_busy else None),
        "host_sync_s_per_batch": sync_us / 1e6 / len(wavs)}
    return out


def _raw_events(prof) -> list:
    """The profile's events as the profiler recorded them, less those
    that prof.events() leaves out too. prof.events() builds an event
    object, its memory use and its place in the call tree for each,
    which over a long window takes far longer than the window itself;
    these are read as they are (name(), duration_ns(), ...)."""
    return [e for e in prof.profiler.kineto_results.events()
            if not _filter_name(e.name())
            and not getattr(e, "is_hidden_event", lambda: False)()]


def _device_kernel_events(prof) -> list:
    """The profile's device kernels (and copies): its CUDA events less
    the user annotations, such as the regions the kernel wrappers open
    around their launches (openeat_torch/ops/nvcc.py:launch_region)."""
    return [e for e in _raw_events(prof)
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def _device_busy_us(prof) -> float:
    """The union of the device's kernel and copy intervals (streams that
    overlap count once)."""
    return union_length([(e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in _device_kernel_events(prof)]) / 1e3


def _top_level_host_ops(prof) -> int:
    """The aten operators the host dispatched at the top of its call
    tree (views and no-op casts included): the CPU events that no other
    CPU event of their thread encloses, as prof.events() nests them
    (EventList._populate_cpu_children), counted without building it."""
    by_thread = {}
    for e in _raw_events(prof):
        if e.device_type() == torch.autograd.DeviceType.CPU \
                and not e.is_async() \
                and e.start_thread_id() == e.end_thread_id():
            by_thread.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), e.name()))
    n = 0
    for events in by_thread.values():
        open_ends = []
        for start, neg_end, name in sorted(events):
            while open_ends and (start >= open_ends[-1]
                                 or -neg_end > open_ends[-1]):
                open_ends.pop()
            n += not open_ends and name.startswith("aten::")
            open_ends.append(-neg_end)
    return n


def _host_us(prof, name: str) -> float:
    """The host time of every event named `name`."""
    return sum(e.duration_ns() for e in _raw_events(prof)
               if e.name() == name) / 1e3


def attention_cache_checks(cfg_path: str, ckpt: str, manifest: str,
                           dict_path: str) -> dict:
    """The KV cache against recompute on the card, float32: the cached
    beam search gives the full-prefix search's tokens on both batches;
    decoder_step along a fixed prefix (the first batch's best
    hypotheses) matches decoder_logits within ENC_TOL; its first 4
    steps match a CPU run of the same weights within ENC_TOL."""
    cfg = json.load(open(cfg_path))
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"))
    cpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cpu"))
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=BATCH)
    feeder = DeviceFeeder(PrefetchLoader(ds, AudioCollate()),
                          FrontendConfig(), torch.device("cuda"), BATCH)
    out = {"searches": []}
    with torch.inference_mode():
        for i, (_, batch) in enumerate(feeder):
            enc, lens = gpu.encode(batch["features"],
                                   batch["features_length"])
            steps = min(int(enc.shape[1]), MAX_HYP_LEN)
            cached = attention_beam.attention_beam_search_cached(
                gpu, enc, lens, beam_size=BEAM, max_steps=steps)
            full = attention_decode(gpu, enc, lens, beam_size=BEAM,
                                    max_steps=steps, use_cache=False)
            row = {"batch": i, "max_steps": steps,
                   "tokens_equal": bool(torch.equal(cached[0], full[0])
                                        and torch.equal(cached[1], full[1])),
                   "score_max_abs_diff": float((cached[2] - full[2]).abs()
                                               .max()),
                   "mean_len": float(cached[1].float().mean())}
            out["searches"].append(row)
            if not row["tokens_equal"]:
                raise AssertionError(f"cached and full-prefix attention "
                                     f"searches differ: {row}")
            if i == 0:
                first = (enc, lens, cached[0])
        enc, lens, hyps = first
        b, t = enc.shape[:2]
        ys = torch.cat([torch.full((b, 1), gpu.sos, device=enc.device),
                        torch.where(hyps < 0, gpu.eos, hyps)], dim=1)
        n_pos = ys.shape[1]
        full = gpu.decoder_logits(enc, lens, ys, torch.full((b,), n_pos,
                                                            device=enc.device))
        cache = gpu.decoder_init_cache(enc, b, n_pos)
        cpu_cache = cpu.decoder_init_cache(enc.cpu(), b, n_pos)
        step_err = cpu_err = 0.0
        for pos in range(n_pos):
            lp, cache = gpu.decoder_step(ys[:, pos], pos, cache, lens, t)
            step_err = max(step_err, float((lp - full[:, pos]).abs().max()))
            if pos < 4:
                c_lp, cpu_cache = cpu.decoder_step(ys[:, pos].cpu(), pos,
                                                   cpu_cache, lens.cpu(), t)
                cpu_err = max(cpu_err, float((lp.cpu() - c_lp).abs().max()))
    out.update(prefix_positions=n_pos, step_vs_full_max_abs_err=step_err,
               step_gpu_vs_cpu_max_abs_err=cpu_err)
    if step_err > ENC_TOL or cpu_err > ENC_TOL:
        raise AssertionError(f"decoder_step disagrees: {out}")
    return out


# ---------------------------------------------------------------- recipe

# examples/aishell/conf/train_lm.yaml, two epochs
LM_CONFIG = repo_config("examples/aishell/conf/train_lm.yaml", max_epoch=2,
                        log_interval=1, seed=SEED)
LM_WEIGHT = 0.3


def manifest_texts(manifest: str) -> dict:
    """{key: text} of a manifest's `utt:` and `text:` fields."""
    out = {}
    with open(manifest, encoding="utf-8") as f:
        for line in f:
            fields = dict(x.split(":", 1) for x in line.rstrip("\n")
                          .split("\t"))
            out[fields["utt"]] = fields["text"]
    return out


def write_text(texts: dict, name: str) -> str:
    path = os.path.join(WORK, name)
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(f"{k} {v}\n" for k, v in texts.items())
    return path


def run_recipe(exp: str, train_data: str, cv_data: str,
               dict_path: str) -> dict:
    """The recipe after training: average_model --val_best --num 2 over
    the run's epoch_1/epoch_2 (held to a float64 host mean), train_lm on
    cuda for 2 epochs on the transcripts, a bigram ARPA of them by
    tools.train_ngram, then recognize of the cv set
    from avg_2.pt in attention_rescoring with the Transformer LM fused
    and with the n-gram fused, and the CER of each decode. K3's count is
    set to 0 before the decodes and read after them."""
    out = {}
    avg_path = average_model.main(["--exp_dir", exp, "--dst", "avg_2",
                                   "--num", "2", "--val_best"])
    avg = torch.load(avg_path, weights_only=True)
    epochs = [torch.load(os.path.join(exp, f"epoch_{e}.pt"),
                         weights_only=True) for e in (1, 2)]
    for k, v in avg.items():
        ref = ((epochs[0][k].double() + epochs[1][k].double()) / 2).float() \
            if v.is_floating_point() else epochs[1][k]
        if not torch.equal(v, ref):
            raise AssertionError(f"average_model: {k} is not the mean")
    out["averaged_tensors"] = len(avg)

    train_texts, cv_texts = manifest_texts(train_data), manifest_texts(cv_data)
    lm_cfg = os.path.join(WORK, "train_lm.json")
    with open(lm_cfg, "w") as f:
        json.dump(LM_CONFIG, f)
    lm_exp = os.path.join(WORK, "exp_lm")
    lm_tr = write_text(train_texts, "lm_tr")
    t0 = time.perf_counter()
    lm_state = train_lm.main([
        "--config", lm_cfg, "--train_data", lm_tr,
        "--cv_data", write_text(cv_texts, "lm_cv"), "--dict", dict_path,
        "--exp_dir", lm_exp, "--device", "cuda", "--num_workers", "2"])
    torch.cuda.synchronize()
    out["train_lm_wall_s"] = time.perf_counter() - t0
    with open(os.path.join(lm_exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    out["lm_step_losses"] = [r["loss"] for r in records
                             if r["kind"] == "train"]
    out["lm_cv_losses"] = [r["cv_loss"] for r in records
                           if r["kind"] == "epoch"]
    if len(out["lm_step_losses"]) != lm_state.step or not all(
            math.isfinite(x) for x in out["lm_step_losses"]
            + out["lm_cv_losses"]):
        raise AssertionError(f"train_lm losses: {records}")
    for name in ("epoch_1.pt", "epoch_1.json", "epoch_2.pt", "epoch_2.json",
                 "train.json"):
        if not os.path.exists(os.path.join(lm_exp, name)):
            raise AssertionError(f"train_lm did not write {name}")
    arpa = os.path.join(WORK, "lm.arpa")
    train_ngram.main([lm_tr, arpa, "--order", "2", "--format", "kaldi"])

    cfg = os.path.join(exp, "train.json")
    lm_args = ["--lm_config", os.path.join(lm_exp, "train.json"),
               "--lm_checkpoint", os.path.join(lm_exp, "epoch_2.pt"),
               "--lm_weight", str(LM_WEIGHT)]
    ngram_args = ["--ngram_lm", arpa, "--lm_weight", str(LM_WEIGHT)]
    n_batches = math.ceil(len(cv_texts) / BATCH)
    out["decodes"] = []
    launches = 0
    # the unfused rescoring decode and its CER are phase 17's stage 4
    for tag, extra in (("recipe_lm", lm_args), ("recipe_ngram", ngram_args)):
        hyps, wall, k3, _ = run_recognize(cfg, avg_path, cv_data, dict_path,
                                          "attention_rescoring", tag, extra)
        launches += k3
        if set(hyps) != set(cv_texts) or k3 != 12 * n_batches:
            raise AssertionError(f"{tag}: keys {sorted(hyps)}, K3 {k3}")
        cer = corpus_wer(cv_texts, hyps)
        row = {"run": tag, "wall_s": wall, "k3_launches": k3,
               "cer": cer.wer, "ref_chars": cer.ref_len}
        out["decodes"].append(row)
        print("recipe decode " + json.dumps(row), flush=True)
    out["k3_launches"] = launches
    out["fusion"] = fusion_checks(cfg, avg_path, lm_exp, arpa, cv_data,
                                  dict_path)
    return out


def fusion_checks(cfg_path: str, ckpt: str, lm_exp: str, arpa: str,
                  cv_data: str, dict_path: str) -> dict:
    """On the cv batch: the LM-fused rescoring scores differ from the
    unfused ones on at least one candidate, and some candidate has a
    nonzero n-gram term; the LM's float32 log_probs on the card match a
    CPU run within ENC_TOL. The scores are taken at ctc_weight 0: a
    model this briefly trained can leave near-uniform CTC posteriors
    whose prefix beams all die at -1e30, which would swamp every other
    term in float32."""
    dev = torch.device("cuda")
    char_dict = load_dict(dict_path)
    id2tok = {v: k for k, v in char_dict.items()}
    model = recognize.load_model(json.load(open(cfg_path)), ckpt, VOCAB, dev)
    lm_cfg = json.load(open(os.path.join(lm_exp, "train.json")))
    lm_ckpt = os.path.join(lm_exp, "epoch_2.pt")
    lm = recognize.load_language_model(lm_cfg, lm_ckpt, len(char_dict), dev)
    ngram = load_ngram(arpa)
    ds = AudioDataset(cv_data, char_dict, batch_size=BATCH)
    feeder = DeviceFeeder(PrefetchLoader(ds, AudioCollate()),
                          FrontendConfig(), dev, BATCH)
    with torch.inference_mode():
        _, batch = next(iter(feeder))
        enc, lens = model.encode(batch["features"], batch["features_length"])
        nbest = ctc_prefix_beam_search(model.ctc_log_probs(enc), lens,
                                       beam_size=BEAM,
                                       max_hyp_len=MAX_HYP_LEN)
        kw = dict(ctc_weight=0.0, reverse_weight=0.3)
        plain = rescoring_scores(model, enc, lens, *nbest, **kw)
        fused = rescoring_scores(model, enc, lens, *nbest, **kw,
                                 lm_logp_fn=lm.log_probs,
                                 lm_weight=LM_WEIGHT)
        hyps, hyp_lens = nbest[0].cpu(), nbest[1].cpu()
        ngram_terms = [[ngram.score(" ".join(
            id2tok.get(int(t), "<unk>") for t in hyps[b, k, :hyp_lens[b, k]]))
            for k in range(hyps.shape[1])] for b in range(hyps.shape[0])]
        f32_conf = dict(lm_cfg["model_conf"], compute_dtype="float32")
        lm_f32 = {d: recognize.load_language_model(
            dict(lm_cfg, model_conf=f32_conf), lm_ckpt, len(char_dict),
            torch.device(d)) for d in ("cuda", "cpu")}
        ys = torch.cat([torch.full((hyps.shape[0], 1), lm.sos),
                        torch.where(hyps[:, 0] < 0, lm.eos, hyps[:, 0])], 1)
        ys_lens = hyp_lens[:, 0] + 1
        g_lp = lm_f32["cuda"].log_probs(ys.to(dev), ys_lens.to(dev))
        c_lp = lm_f32["cpu"].log_probs(ys, ys_lens)
    res = {"lm_fused_candidates_changed": int(((fused - plain).abs() > 0)
                                              .sum()),
           "candidates": int(plain.numel()),
           "dead_prefix_beams": int((nbest[2] <= -1e29).sum()),
           "ngram_nonzero_terms": sum(t != 0 for row in ngram_terms
                                      for t in row),
           "lm_f32_gpu_vs_cpu_max_abs_err": float(
               (g_lp.cpu() - c_lp).abs().max())}
    if not res["lm_fused_candidates_changed"] \
            or not res["ngram_nonzero_terms"] \
            or res["lm_f32_gpu_vs_cpu_max_abs_err"] > ENC_TOL:
        raise AssertionError(f"LM fusion checks: {res}")
    return res


# ---------------------------------------------------------------- stream

CHUNK, LEFT_CHUNKS = 16, 4     # bin/stream_recognize's defaults: 640 ms
PIECE_MS = 200
# examples/aishell/conf/train_conformer_streaming.yaml: its training, one
# epoch with the smoke's warmup and 10000-frame batches (the recipe's are
# 80000); its model_conf (causal convs, dynamic chunks) with the static
# chunk that the offline reference masks with, so that its offline
# forward is what the stream reproduces
STREAM_TRAIN_CONFIG = repo_config(
    "examples/aishell/conf/train_conformer_streaming.yaml", max_epoch=1,
    log_interval=1, warmup_steps=4, seed=SEED)
STREAM_TRAIN_CONFIG["dataset_conf"]["max_frames_in_batch"] = 10000
STREAM_MODEL_CONF = dict(
    STREAM_TRAIN_CONFIG["model_conf"], compute_dtype="float32",
    activation="swish", use_dynamic_chunk=True, static_chunk_size=CHUNK,
    num_left_chunks=LEFT_CHUNKS)
STREAM_TOL = (1e-3, 2e-4)   # rtol, atol: tests/test_streaming.py's


def write_stream_config(compute_dtype: str) -> str:
    cfg = {"model_conf": dict(STREAM_MODEL_CONF, compute_dtype=compute_dtype),
           "vocab_size": VOCAB, "input_size": 80,
           "collate_conf": {"feature_extraction_conf": {"mel_bins": 80},
                            "normalization": True}}
    path = os.path.join(WORK, f"stream_{compute_dtype}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def manifest_wavs(manifest: str) -> dict:
    """{key: x32768-scaled samples} of a manifest's wavs."""
    out = {}
    with open(manifest, encoding="utf-8") as f:
        for line in f:
            fields = dict(x.split(":", 1) for x in line.rstrip("\n")
                          .split("\t"))
            out[fields["utt"]] = read_wav(fields["feat"])[0] * 32768.0
    return out


def stream_wav(model, wav: np.ndarray, piece_ms: int = PIECE_MS,
               **kw) -> StreamingRecognizer:
    """One stream through StreamingRecognizer in piece_ms pieces, then
    finish()."""
    sr = StreamingRecognizer(model, chunk_size=CHUNK,
                             num_left_chunks=LEFT_CHUNKS, **kw)
    n = 16 * piece_ms
    for i in range(0, len(wav), n):
        sr.accept_waveform(wav[i:i + n])
    sr.finish()
    return sr


def _within(got: torch.Tensor, ref: torch.Tensor, rtol: float,
            atol: float) -> tuple[bool, float]:
    err = (got.float() - ref.float()).abs()
    return bool((err <= atol + rtol * ref.float().abs()).all()), \
        float(err.max())


def _frame_agreement(lp_ref: torch.Tensor, lp_got: torch.Tensor) -> dict:
    """Frame argmax of lp_got [T, V] against lp_ref on the frames whose
    top-2 margin in lp_ref exceeds 10 x the largest |lp_got - lp_ref|
    (the others are near-ties that rounding may flip)."""
    gap = float((lp_got - lp_ref).abs().max())
    top2 = lp_ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 10 * gap
    agree = lp_got.argmax(-1) == lp_ref.argmax(-1)
    return {"frames": int(lp_ref.shape[0]), "near_ties": int((~sure).sum()),
            "disagreements": int((sure & ~agree).sum()), "lp_gap": gap}


class K3Trace:
    """Records (shape, dtype, route, grad) of each depthwise_conv1d call
    that the conv modules make, by wrapping the name they call (grad:
    whether autograd records it, so that its dgrad and wgrad follow);
    the wrapper's own launch count is untouched."""

    def __init__(self):
        self.calls: list[tuple] = []
        self._orig = conv_module.depthwise_conv1d

    def __enter__(self):
        def traced(x, w):
            route = dw.device_plan(x, w.shape[0], dgrad=False).route
            self.calls.append((tuple(x.shape), str(x.dtype).split(".")[-1],
                               route, torch.is_grad_enabled()))
            return self._orig(x, w)
        conv_module.depthwise_conv1d = traced
        return self

    def __exit__(self, *exc):
        conv_module.depthwise_conv1d = self._orig


def stream_checks(cfg_path: str, ckpt: str, manifest: str) -> dict:
    """The streaming path on the card, float32, full width, seeded random
    weights, c = 16 with 4 left chunks, 200 ms pieces:
    - for 4 of the decode wavs, the encoder rows StreamingRecognizer
      collects match the offline chunk-masked encode of the same model
      on the card (host fbank of the whole wav) within rtol 1e-3 / atol
      2e-4, and the streamed greedy result is the offline greedy result
      (frame argmax equal wherever the top-2 margin exceeds 10 x the
      measured log-prob gap; tokens equal when no frame is that close);
      K3 runs 12 times per chunk step, at [1, 30, 256] float32, by TMA;
    - one stream's encoder rows on the card against the CPU (plain
      kernels) within ENC_TOL;
    - StreamingBatch at S = 8 over all 16 wavs, ragged (two piece sizes,
      16 streams through 8 slots, so slots are reused), against 16
      sequential S = 1 runs: the same frame-argmax rule and tokens,
      encoder rows within rtol 1e-3 / atol 2e-4, 12 K3 launches a step."""
    cfg = json.load(open(cfg_path))
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"))
    cpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cpu"))
    wavs = manifest_wavs(manifest)
    keys = sorted(wavs)
    rtol, atol = STREAM_TOL
    # K3's input on the chunk step: the conv cache, then the chunk
    chunk_shape = (1, gpu.cnn_module_kernel - 1 + CHUNK, gpu.d_model)
    out = {"streamed_vs_offline": []}
    with torch.inference_mode():
        for key in keys[:4]:
            wav = wavs[key]
            dw.depthwise_conv1d.launches = 0
            with K3Trace() as trace:
                sr = stream_wav(gpu, wav, collect_encoder_out=True)
            launches = dw.depthwise_conv1d.launches
            steps = sr.offset // CHUNK
            streamed = torch.from_numpy(np.concatenate(sr.enc_chunks)).cuda()
            t = streamed.shape[0]
            feats, flens = fbank_mod.fbank(
                torch.from_numpy(wav.astype(np.float32))[None],
                torch.tensor([len(wav)]))
            enc, lens = gpu.encode(feats.cuda(), flens.cuda())
            ok, err = _within(streamed, enc[0, :t], rtol, atol)
            lp_ref = gpu.ctc_log_probs(enc[:, :t])[0]
            agree = _frame_agreement(lp_ref, gpu.ctc_log_probs(
                streamed[None])[0])
            hyp, hyp_len = ctc_greedy_search(lp_ref[None],
                                             torch.tensor([t]).cuda())
            offline = hyp[0, :hyp_len[0]].tolist()
            row = {"key": key, "seconds": len(wav) / 16000, "rows": t,
                   "offline_rows": int(lens[0]), "chunk_steps": steps,
                   "k3_launches": launches,
                   "k3_shapes": sorted({c[:2] for c in trace.calls}),
                   "k3_routes": sorted({c[2] for c in trace.calls}),
                   "max_abs_err": err, "within_tol": ok,
                   "tokens": len(sr.result()),
                   "tokens_equal": sr.result() == offline, **agree}
            out["streamed_vs_offline"].append(row)
            print("stream_vs_offline " + json.dumps(row), flush=True)
            if not ok or t != int(lens[0]) or agree["disagreements"] \
                    or (not agree["near_ties"] and not row["tokens_equal"]):
                raise AssertionError(f"streamed encoder differs from the "
                                     f"offline chunk-masked one: {row}")
            if launches != 12 * steps or len(trace.calls) != launches \
                    or row["k3_routes"] != ["tma"] \
                    or row["k3_shapes"] != [(chunk_shape, "float32")]:
                raise AssertionError(f"K3 on the chunk step: {row}")

        wav = wavs[keys[0]]
        g = stream_wav(gpu, wav, collect_encoder_out=True)
        c = stream_wav(cpu, wav, collect_encoder_out=True)
        err = float(np.abs(np.concatenate(g.enc_chunks)
                           - np.concatenate(c.enc_chunks)).max())
        out["gpu_vs_cpu"] = {"key": keys[0], "max_abs_err": err,
                             "tokens_equal": g.result() == c.result()}
        if err > ENC_TOL:
            raise AssertionError(f"stream GPU vs CPU: {out['gpu_vs_cpu']}")

        seq = {}
        for key in keys:
            sr = stream_wav(gpu, wavs[key], collect_encoder_out=True)
            seq[key] = (sr.result(), np.concatenate(sr.enc_chunks))
        batch = StreamingBatch(gpu, slots=8, chunk_size=CHUNK,
                               num_left_chunks=LEFT_CHUNKS, beam_size=BEAM,
                               max_hyp_len=MAX_HYP_LEN)
        n_steps = [0]
        step = batch._step

        def counted(*args):
            n_steps[0] += 1
            return step(*args)

        batch._step = counted
        dw.depthwise_conv1d.launches = 0
        pending, live, got, slots_used = list(keys), [], {}, {}
        while pending or live:
            while pending and len(live) < 8:
                key = pending.pop(0)
                h = batch.open()
                slots_used.setdefault(h.slot, []).append(key)
                live.append([h, key, 0, 16 * (200 if h.slot % 2 else 130)])
            for ent in live:
                h, key, pos, n = ent
                batch.accept(h, wavs[key][pos:pos + n])
                ent[2] = pos + n
            batch.run_ready()
            still = []
            for ent in live:
                h, key, pos, _ = ent
                if pos < len(wavs[key]):
                    still.append(ent)
                    continue
                got[key] = (batch.finish(h, rescore=False),
                            batch.encoder_out(h))
                batch.close(h)
            live = still
        rows = []
        for key in keys:
            ref_toks, ref_enc = seq[key]
            toks, enc = got[key]
            ok, err = _within(torch.from_numpy(enc), torch.from_numpy(ref_enc),
                              rtol, atol)
            agree = _frame_agreement(
                gpu.ctc_log_probs(torch.from_numpy(ref_enc).cuda()[None])[0],
                gpu.ctc_log_probs(torch.from_numpy(enc).cuda()[None])[0])
            rows.append({"key": key, "tokens_equal": toks == ref_toks,
                         "rows_equal_count": enc.shape == ref_enc.shape,
                         "max_abs_err": err, "within_tol": ok, **agree})
        out["batch_vs_sequential"] = {
            "slots": 8, "streams": len(keys), "steps": n_steps[0],
            "k3_launches": dw.depthwise_conv1d.launches,
            "slots_reused": sum(len(v) > 1 for v in slots_used.values()),
            "streams_tokens_equal": sum(r["tokens_equal"] for r in rows),
            "near_tie_frames": sum(r["near_ties"] for r in rows),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}
        print("stream_batch " + json.dumps(out["batch_vs_sequential"]),
              flush=True)
        bad = [r for r in rows
               if not (r["within_tol"] and r["rows_equal_count"])
               or r["disagreements"]
               or (not r["near_ties"] and not r["tokens_equal"])]
        res = out["batch_vs_sequential"]
        if bad or res["k3_launches"] != 12 * res["steps"] \
                or not res["slots_reused"]:
            raise AssertionError(f"S = 8 batch vs sequential: {res} {bad}")
        out["batch_rows"] = rows
    return out


def stream_cli_runs(cfg32: str, cfg16: str, ckpt: str, manifest: str,
                    dict_path: str, t_enc: dict) -> list:
    """bin/stream_recognize on cuda over the 16 decode wavs, with
    --timestamp_file: --slots 1 greedy (piece latencies) and --slots 8
    attention_rescoring (aggregate x-realtime), in float32 and in
    bfloat16. K3's count is set to 0 before each run and read after;
    every key is written, the timestamps are sane, K3 ran 12 times per
    chunk step (S = 1: one step per 16 encoder positions, each stream's
    last one short)."""
    keys = {f"utt{i:03d}" for i in range(N_UTTS)}
    s1_steps = sum(math.ceil(t / CHUNK) for t in t_enc.values())
    runs = []
    for tag, cfg, extra in (
            ("stream_s1_greedy", cfg32,
             ["--slots", "1", "--final_mode", "ctc_greedy_search"]),
            ("stream_s8_rescoring", cfg32,
             ["--slots", "8", "--final_mode", "attention_rescoring",
              "--reverse_weight", "0.3", "--beam_size", str(BEAM)]),
            ("stream_s1_greedy_bf16", cfg16,
             ["--slots", "1", "--final_mode", "ctc_greedy_search"]),
            ("stream_s8_rescoring_bf16", cfg16,
             ["--slots", "8", "--final_mode", "attention_rescoring",
              "--reverse_weight", "0.3", "--beam_size", str(BEAM)])):
        out = os.path.join(WORK, f"hyp_{tag}.txt")
        ts = os.path.join(WORK, f"ts_{tag}.jsonl")
        dw.depthwise_conv1d.launches = 0
        stats = stream_recognize.main(
            ["--config", cfg, "--checkpoint", ckpt, "--test_data", manifest,
             "--dict", dict_path, "--result_file", out, "--timestamp_file",
             ts, "--device", "cuda", *extra])
        launches = dw.depthwise_conv1d.launches
        with open(out, encoding="utf-8") as f:
            hyps = dict((line.rstrip("\n").split(" ", 1) + [""])[:2]
                        for line in f)
        with open(ts, encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
        steps = launches // 12
        run = {"run": tag, "k3_launches": launches, "chunk_steps": steps,
               "s_per_chunk_step": stats["wall_s"] / max(steps, 1),
               "rtf": stats["wall_s"] / stats["audio_s"], **stats,
               "timestamps": check_timestamps(tag, rows, hyps, t_enc),
               "nonempty_hyps": sum(bool(v) for v in hyps.values())}
        runs.append(run)
        print("stream_cli " + json.dumps(run), flush=True)
        if set(hyps) != keys or launches % 12 \
                or ("_s1_" in tag and steps != s1_steps):
            raise AssertionError(f"{tag}: keys {sorted(hyps)}, K3 "
                                 f"{launches}, expected 12 x {s1_steps} "
                                 f"steps at S = 1")
    return runs


def stream_idle(cfg_path: str, ckpt: str, manifest: str) -> dict:
    """The device's idle share over profiled chunk steps (torch.profiler):
    one 200 ms-piece S = 1 stream of the longest wav, and one S = 8 batch
    of 8 wavs whose audio is all in before its steps run; host clock
    around each, synchronized."""
    from torch.profiler import ProfilerActivity, profile
    model = recognize.load_model(json.load(open(cfg_path)), ckpt, VOCAB,
                                 torch.device("cuda"))
    wavs = manifest_wavs(manifest)
    keys = sorted(wavs, key=lambda k: -len(wavs[k]))
    out = {}

    def s1():
        return stream_wav(model, wavs[keys[0]]).offset // CHUNK

    def s8():
        batch = StreamingBatch(model, slots=8, chunk_size=CHUNK,
                               num_left_chunks=LEFT_CHUNKS, beam_size=BEAM,
                               max_hyp_len=MAX_HYP_LEN)
        hs = [batch.open() for _ in range(8)]
        for h, key in zip(hs, keys[:8]):
            batch.accept(h, wavs[key])
        batch.run_ready()
        return int(batch._offset_host.max()) // CHUNK

    with torch.inference_mode():
        for name, fn in (("s1", s1), ("s8", s8)):
            fn()   # warm-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps = fn()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy = _device_busy_us(prof)
            host_ops = _top_level_host_ops(prof)
            out[name] = {"chunk_steps": steps,
                         "profiled_wall_s": wall_us / 1e6,
                         "s_per_chunk_step": wall_us / 1e6 / steps,
                         "host_ops_per_chunk_step": host_ops / steps,
                         "device_busy_s": busy / 1e6,
                         "device_idle_share": (1.0 - busy / wall_us
                                               if busy else None)}
        # the S = 8 step's two halves, host clock around synchronized
        # work: encode_chunk with the CTC head, and the c prefix-beam
        # frames the step carries
        s, dev = 8, next(model.parameters()).device
        k, v, cnn = zero_caches(model, s, LEFT_CHUNKS * CHUNK, dev)
        win = torch.randn((s, 4 * CHUNK + 3, 80), device=dev)
        offset = torch.zeros((s,), dtype=torch.long, device=dev)
        valid = torch.full((s,), CHUNK, device=dev)
        lp = torch.randn((s, CHUNK, VOCAB), device=dev).log_softmax(-1)

        def encode():
            enc = model.encode_chunk(win, offset, k, v, offset, cnn, valid)[0]
            model.ctc_log_probs(enc).argmax(-1)

        def beam():
            st = prefix_beam_init(s, BEAM, MAX_HYP_LEN, dev, True)
            for i in range(CHUNK):
                prefix_beam_step(st, lp[:, i], valid > i, 0, offset + i)

        for name, fn in (("encode_s", encode), ("beam_s", beam)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            out["s8"][name + "_per_chunk_step"] = \
                (time.perf_counter() - t0) / 5
    return out


def stream_training(train_data: str, cv_data: str, dict_path: str) -> dict:
    """bin.train on cuda with the streaming config (causal,
    use_dynamic_chunk, bf16) for one epoch; finite losses and the launch
    counts of check_train_counts; then bin/stream_recognize --slots 4 of
    the cv set from epoch_1.pt (no quality threshold)."""
    cfg_path = os.path.join(WORK, "train_conformer_streaming.json")
    with open(cfg_path, "w") as f:
        json.dump(STREAM_TRAIN_CONFIG, f)
    exp = os.path.join(WORK, "exp_stream")
    n_cv = len(AudioDataset(cv_data, load_dict(dict_path),
                            batch_type="dynamic", max_frames_in_batch=10000))
    _reset_counts()
    t0 = time.perf_counter()
    state = train_cli.main(["--config", cfg_path, "--train_data", train_data,
                            "--cv_data", cv_data, "--dict", dict_path,
                            "--exp_dir", exp, "--device", "cuda",
                            "--num_workers", "4"])
    torch.cuda.synchronize()
    counts = _counts()
    out = {"train_wall_s": time.perf_counter() - t0, "steps": state.step,
           "launches": counts}
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    out["step_losses"] = [r["loss"] for r in records if r["kind"] == "train"]
    out["cv"] = [r for r in records if r["kind"] == "epoch"]
    if len(out["step_losses"]) != state.step or not all(
            math.isfinite(x) for x in out["step_losses"]):
        raise AssertionError(f"streaming training losses: {records}")
    check_train_counts({"n_train_steps": state.step, "n_cv_batches": n_cv},
                       counts, decode_batches=0)
    hyp = os.path.join(WORK, "hyp_stream_trained.txt")
    dw.depthwise_conv1d.launches = 0
    stats = stream_recognize.main([
        "--config", os.path.join(exp, "train.json"), "--checkpoint",
        os.path.join(exp, "epoch_1.pt"), "--test_data", cv_data, "--dict",
        dict_path, "--result_file", hyp, "--slots", "4", "--device", "cuda"])
    with open(hyp, encoding="utf-8") as f:
        out["decoded"] = sum(1 for _ in f)
    out["decode"] = dict(stats, k3_launches=dw.depthwise_conv1d.launches)
    if out["decoded"] != N_CV:
        raise AssertionError(f"stream_recognize wrote {out['decoded']} lines")
    return out


# ---------------------------------------------------------------- serving

SERVE_SLOTS = 8
ENDPOINT_RULE3_MS = 2000.0


def build_served(cfg_path: str, ckpt: str, dict_path: str, *extra):
    """An AsrServer through bin/serve's build_server on cuda, 127.0.0.1,
    port 0, --slots 8, rescoring finals, reverse_weight 0.3."""
    return serve_cli.build_server(serve_cli.get_parser().parse_args(
        ["--config", cfg_path, "--checkpoint", ckpt, "--dict", dict_path,
         "--port", "0", "--slots", str(SERVE_SLOTS), "--chunk_size",
         str(CHUNK), "--num_left_chunks", str(LEFT_CHUNKS), "--beam_size",
         str(BEAM), "--max_hyp_len", str(MAX_HYP_LEN), "--reverse_weight",
         "0.3", "--device", "cuda", *extra]))


def client_session(addr, wav: np.ndarray, rate: int = 16000,
                   pace: bool = False, send_end: bool = True) -> dict:
    """One AsrClient session: `wav` (x32768 floats at `rate`) in
    PIECE_MS pieces, as fast as the socket takes them (at the audio's
    own pace when `pace`), then "end" (unless not `send_end`: then it
    waits for the server's endpoint final and stops sending when it
    arrives). A reader thread stamps each event on the host clock."""
    c = AsrClient(*addr, sample_rate=rate, timeout=300)
    out = {"partials": [], "t_partials": [], "errors": [], "final": None,
           "sent_s": 0.0}

    def reader():
        try:
            while True:
                frame = recv_frame(c.sock)
                if frame is None:
                    return
                t, ev = time.perf_counter(), json.loads(frame[1])
                if ev["event"] == "partial":
                    out["partials"].append(ev)
                    out["t_partials"].append(t)
                elif ev["event"] == "error":
                    out["errors"].append(ev)
                    return
                elif ev["event"] == "final":
                    out["final"], out["t_final"] = ev, t
                    return
        except OSError as e:
            out["errors"].append({"message": repr(e)})

    th = threading.Thread(target=reader, daemon=True)
    try:
        out["t_open"] = t0 = time.perf_counter()
        th.start()
        n = rate * PIECE_MS // 1000
        for i in range(0, len(wav), n):
            if pace:
                time.sleep(max(0.0, t0 + i / rate - time.perf_counter()))
            if out["final"] is not None:
                break
            c.send_audio(wav[i:i + n])
            out["sent_s"] = min(i + n, len(wav)) / rate
        out["t_end"] = time.perf_counter()
        if send_end:
            send_json(c.sock, {"op": "end"})
        th.join(timeout=300)
    finally:
        c.close()
    if th.is_alive() or out["errors"] or out["final"] is None:
        raise AssertionError(f"serve session: {out['errors']}, final "
                             f"{out['final']}")
    return out


def serve_traffic(srv, wavs: list, wav8k=None) -> dict:
    """Every wav as a concurrent client session (a thread each), plus
    one at 8 kHz; K3's count set to 0 just before and read just after;
    the server's chunk steps counted and K3's shapes traced."""
    n_steps = [0]
    step = srv.batch._step

    def counted(*args):
        n_steps[0] += 1
        return step(*args)

    srv.batch._step = counted
    jobs = [(w, 16000) for w in wavs]
    if wav8k is not None:
        jobs.append((wav8k, 8000))
    sessions = [None] * len(jobs)
    failures = []

    def run(i):
        try:
            sessions[i] = client_session(srv.addr, *jobs[i])
        except (AssertionError, OSError) as e:
            failures.append(repr(e))

    dw.depthwise_conv1d.launches = 0
    with K3Trace() as trace:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
    launches = dw.depthwise_conv1d.launches
    srv.batch._step = step
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve traffic: {failures}")
    t0 = min(s["t_open"] for s in sessions)
    t1 = max(s["t_final"] for s in sessions)
    audio_s = sum(s["final"]["audio_s"] for s in sessions)
    end_to_final = [s["t_final"] - s["t_end"] for s in sessions]
    first_partial = [s["t_partials"][0] - s["t_open"] for s in sessions
                     if s["t_partials"]]
    shapes = Counter(c[:2] for c in trace.calls)
    routes = Counter(c[2] for c in trace.calls)
    res = {"sessions": len(sessions), "audio_s": audio_s, "wall_s": t1 - t0,
           "x_realtime": audio_s / (t1 - t0), "chunk_steps": n_steps[0],
           "k3_launches": launches,
           "k3_shapes": {f"{list(k[0])} {k[1]}": v for k, v in shapes.items()},
           "k3_routes": dict(routes),
           "end_to_final_ms_p50": float(np.percentile(end_to_final, 50) * 1e3),
           "end_to_final_ms_p99": float(np.percentile(end_to_final, 99) * 1e3),
           "first_partial_ms_p50": (float(np.percentile(first_partial, 50)
                                          * 1e3) if first_partial else None),
           "sessions_with_partials": len(first_partial)}
    if launches != 12 * n_steps[0] or not launches \
            or sum(shapes.values()) != launches or set(routes) != {"tma"} \
            or set(shapes) != {((SERVE_SLOTS, 14 + CHUNK,
                                 srv.batch.model.d_model), "float32")}:
        raise AssertionError(f"K3 while serving: {res}")
    return {"stats": res, "sessions": sessions}


def _pcm(wav: np.ndarray) -> np.ndarray:
    """The samples as AsrClient sends them: rounded to int16."""
    return np.clip(np.round(wav), -32768, 32767).astype(np.int16)


def direct_finals(model, wavs: list, wav8k=None) -> list:
    """What the server must answer: each wav (as int16, the 8 kHz one
    resampled piece by piece as the server does) through a float16
    StreamingBatch with the server's settings, 8 at a time; per stream
    (final tokens, times_ms, full-chunk greedy path before finish, the
    smallest top-2 CTC log-prob margin of its frames)."""
    streams = [[_pcm(w).astype(np.float32)] for w in wavs]
    if wav8k is not None:
        pcm, n = _pcm(wav8k), 8000 * PIECE_MS // 1000
        streams.append([resample(pcm[i:i + n].astype(np.float32), 8000,
                                 16000) for i in range(0, len(pcm), n)])
    batch = StreamingBatch(model, slots=SERVE_SLOTS, chunk_size=CHUNK,
                           num_left_chunks=LEFT_CHUNKS, beam_size=BEAM,
                           max_hyp_len=MAX_HYP_LEN, normalization="running",
                           transfer_dtype="float16")
    out = []
    for g in range(0, len(streams), SERVE_SLOTS):
        group = streams[g:g + SERVE_SLOTS]
        hs = [batch.open() for _ in group]
        for h, pieces in zip(hs, group):
            for p in pieces:
                batch.accept(h, p)
        batch.run_ready()
        greedy = [h.result() for h in hs]
        finals = batch.finish_many(hs, rescore=True, ctc_weight=0.5,
                                   reverse_weight=0.3)
        for h, gr in zip(hs, greedy):
            with torch.inference_mode():
                lp = model.ctc_log_probs(torch.from_numpy(
                    batch.encoder_out(h)).cuda())
            top2 = lp.topk(2, dim=-1).values
            out.append((finals[h.slot], h.result_times_ms(), gr,
                        float((top2[:, 0] - top2[:, 1]).min())))
            batch.close(h)
    return out


def serve_checks(cfg_path: str, ckpt: str, manifest: str,
                 dict_path: str) -> dict:
    """bin/serve on the card, float32, the streaming Conformer: 16
    clients sending the decode wavs in 200 ms pieces as fast as the
    socket takes them (8 wait for admission) and one at 8 kHz. Every
    final equals the direct float16 StreamingBatch's tokens and times;
    the partials of each session concatenate to a prefix of its direct
    greedy path; no error event. x-realtime, end-to-final and
    first-partial latency, K3 launches; then the same 16 clients again
    under torch.profiler for the idle share over the serving window."""
    from torch.profiler import ProfilerActivity, profile
    wavs = manifest_wavs(manifest)
    keys = sorted(wavs)
    wav8k = resample(wavs[keys[0]], 16000, 8000)
    srv = build_served(cfg_path, ckpt, dict_path)
    srv.start()
    try:
        run = serve_traffic(srv, [wavs[k] for k in keys], wav8k)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prof_run = serve_traffic(srv, [wavs[k] for k in keys])
    finally:
        srv.shutdown()
    busy = _device_busy_us(prof)
    wall = prof_run["stats"]["wall_s"]
    direct = direct_finals(srv.batch.model, [wavs[k] for k in keys], wav8k)
    rows = []
    for key, s, (toks, times, greedy, margin) in zip(
            keys + ["8khz"], run["sessions"], direct):
        streamed = [t for p in s["partials"] for t in p["tokens"]]
        rows.append({"key": key, "tokens": len(toks),
                     "final_equal": (s["final"]["tokens"] == toks
                                     and s["final"]["times_ms"] == times),
                     "partials_prefix": streamed == greedy[:len(streamed)],
                     "partial_tokens": len(streamed),
                     "min_logp_margin": margin})
    out = dict(run["stats"], profiled_wall_s=wall,
               profiled_x_realtime=prof_run["stats"]["x_realtime"],
               device_busy_s=busy / 1e6,
               device_idle_share=1.0 - busy / 1e6 / wall if busy else None,
               finals_equal=sum(r["final_equal"] for r in rows),
               min_logp_margin=min(r["min_logp_margin"] for r in rows),
               profiled_k3_launches=prof_run["stats"]["k3_launches"])
    out["finals"] = {k: s["final"]["tokens"]
                     for k, s in zip(keys, run["sessions"])}
    print("serve " + json.dumps({k: v for k, v in out.items()
                                 if k != "finals"}), flush=True)
    bad = [r for r in rows if not (r["final_equal"] and r["partials_prefix"])]
    if bad or not out["sessions_with_partials"]:
        raise AssertionError(f"server vs direct StreamingBatch: {bad}")
    out["rows"] = rows
    return out


def serve_endpoint(cfg_path: str, ckpt: str, manifest: str,
                   dict_path: str) -> dict:
    """One session on bin/serve --endpoint --endpoint_rule3_ms 2000, the
    longest decode wav sent at its own pace and no "end": the final must
    come with "endpoint": true once at most 2000 ms plus one chunk
    (640 ms) of audio is decoded (read when the server calls finish),
    before the wav is all sent."""
    wavs = manifest_wavs(manifest)
    wav = max(wavs.values(), key=len)
    srv = build_served(cfg_path, ckpt, dict_path, "--endpoint",
                       "--endpoint_rule3_ms", str(ENDPOINT_RULE3_MS))
    decoded_ms = []
    finish = srv.batch.finish

    def noted(handle, **kw):
        decoded_ms.append(int(srv.batch._offset_host[handle.slot])
                          * FRAME_MS)
        return finish(handle, **kw)

    srv.batch.finish = noted
    srv.start()
    try:
        s = client_session(srv.addr, wav, pace=True, send_end=False)
    finally:
        srv.shutdown()
    out = {"wav_s": len(wav) / 16000, "sent_s": s["sent_s"],
           "final_audio_s": s["final"]["audio_s"],
           "endpoint": s["final"]["endpoint"], "decoded_ms": decoded_ms,
           "tokens": len(s["final"]["tokens"]),
           "open_to_final_s": s["t_final"] - s["t_open"]}
    print("serve_endpoint " + json.dumps(out), flush=True)
    if out["endpoint"] is not True or len(decoded_ms) != 1 \
            or decoded_ms[0] > ENDPOINT_RULE3_MS + CHUNK * FRAME_MS \
            or out["sent_s"] >= out["wav_s"]:
        raise AssertionError(f"endpoint final: {out}")
    return out


def int8_checks(cfg_s32: str, ckpt_s: str, cfg32: str, ckpt: str,
                manifest: str, dict_path: str, f32_finals: dict) -> dict:
    """--quantize int8 on the card: bin/serve with the same 16 clients
    (x-realtime; how many finals equal the float32 server's, reported
    only: random weights decide nothing about quality) and
    bin/recognize on the flagship, attention_rescoring, batch 8 (RTF,
    agreement with the float32 run, reported only). The widened weights
    on the card are bit-equal to the CPU's; on 4 wavs the int8 greedy
    tokens on the card equal the CPU's."""
    out = {}
    cfg = json.load(open(cfg32))
    gpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cuda"), "int8")
    cpu = recognize.load_model(cfg, ckpt, VOCAB, torch.device("cpu"), "int8")
    now, fp32 = quantized_bytes(gpu)
    out["weight_mb"], out["ratio_vs_fp32"] = now / 1e6, fp32 / now
    print(f"int8 weight quantization: {now / 1e6:.1f} MB "
          f"({fp32 / now:.2f}x vs fp32)", flush=True)
    cpu_modules = dict(cpu.named_modules())
    n_q = 0
    with torch.inference_mode():
        for name, m in gpu.named_modules():
            if isinstance(m, Dense) and m.q is not None:
                n_q += 1
                if not torch.equal(m.dense_weight().cpu(),
                                   cpu_modules[name].dense_weight()):
                    raise AssertionError(f"int8 {name}: card != CPU")
    out["dense_int8"] = n_q
    del gpu, cpu

    wavs = manifest_wavs(manifest)
    keys = sorted(wavs)
    srv = build_served(cfg_s32, ckpt_s, dict_path, "--quantize", "int8")
    srv.start()
    try:
        run = serve_traffic(srv, [wavs[k] for k in keys])
    finally:
        srv.shutdown()
    out["serve"] = dict(run["stats"], finals_equal_f32=sum(
        s["final"]["tokens"] == f32_finals[k]
        for k, s in zip(keys, run["sessions"])))

    hyps, wall, launches, _ = run_recognize(
        cfg32, ckpt, manifest, dict_path, "attention_rescoring", "int8",
        ["--quantize", "int8"])
    with open(os.path.join(WORK, "hyp_attention_rescoring.txt"),
              encoding="utf-8") as f:
        f32 = dict((line.rstrip("\n").split(" ", 1) + [""])[:2] for line in f)
    audio_s = sum(len(w) for w in wavs.values()) / 16000
    out["recognize"] = {"wall_s": wall, "rtf": wall / audio_s,
                        "k3_launches": launches,
                        "hyps_equal_f32": sum(hyps[k] == f32[k] for k in keys)}
    if set(hyps) != set(keys) or launches % 12 or not launches:
        raise AssertionError(f"recognize --quantize int8: {out['recognize']}")

    small = os.path.join(WORK, "format4.data")
    with open(manifest, encoding="utf-8") as f, \
            open(small, "w", encoding="utf-8") as g:
        g.writelines(f.readlines()[:4])
    got = {}
    for dev in ("cuda", "cpu"):
        hyp = os.path.join(WORK, f"hyp_int8_{dev}.txt")
        recognize.main(["--config", cfg32, "--checkpoint", ckpt, "--test_data",
                        small, "--dict", dict_path, "--result_file", hyp,
                        "--mode", "ctc_greedy_search", "--batch_size", "4",
                        "--quantize", "int8", "--device", dev])
        with open(hyp, encoding="utf-8") as f:
            got[dev] = dict((line.rstrip("\n").split(" ", 1) + [""])[:2]
                            for line in f)
    out["greedy_gpu_equals_cpu"] = sum(got["cuda"][k] == got["cpu"][k]
                                       for k in got["cpu"])
    print("int8 " + json.dumps(out), flush=True)
    if len(got["cpu"]) != 4 or out["greedy_gpu_equals_cpu"] != 4:
        raise AssertionError(f"int8 greedy tokens, card vs CPU: {got}")
    return out


# ---------------------------------------------------------------- timing 2

def event_ms(fn, reps: int = 5) -> float:
    """Mean time per call from CUDA events around `reps` calls launched
    from the host (for calls that cannot be captured in a graph, or whose
    launch cost is part of what is compared)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _n_copies(nbytes: int) -> int:
    return max(2, min(64, math.ceil(2 * L2_BYTES / nbytes)))


# ---------------------------------------------------- multi-tensor update

MT_CONFIGS = ("perfbench/configs/aishell_conformer.json",
              "perfbench/configs/librispeech_conformer.json")
MT_REPS = 20


def _mt_tables(path: str, gen: torch.Generator) -> dict:
    """The parameter list of a benchmark configuration's model on the
    card, twice (kernel, plain) with the same random values: parameters,
    Adam moments at step 3 (every parameter but the first LayerNorm's,
    which stands for a frozen one), and the micro-batch gradients the
    gather takes (bfloat16 for a matrix or a bias, float32 for a
    LayerNorm or an embedding, none for every 50th parameter)."""
    with open(os.path.join(REPO, path)) as f:
        conf = json.load(f)
    model = build_asr_model(conf["model_conf"], 80, conf["vocab_size"])
    params = [p.detach().cuda() for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    del model
    frozen = next(i for i, n in enumerate(names) if n.endswith("norm.weight"))

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    values = [rand(p.shape, 0.05) for p in params]
    moments = [None if i == frozen else (rand(p.shape, 1e-3),
                                         rand(p.shape, 1e-3).square())
               for i, p in enumerate(params)]
    direct = [("norm" in n and n.endswith(("weight", "bias")))
              or "embed" in n for n in names]
    grads16, grads32 = [], []
    for i, p in enumerate(params):
        skip = i % 50 == 49
        g = rand(p.shape, 1e-2)
        grads16.append(None if skip or direct[i] else g.bfloat16())
        grads32.append(g if direct[i] and not skip else None)

    def table():
        ps = [v.clone() for v in values]
        mo = [None if m is None else (m[0].clone(), m[1].clone())
              for m in moments]
        return mt.ParamTable(ps, mo)

    return {"kernel": table(), "plain": table(), "g16": grads16,
            "g32": grads32, "numel": sum(p.numel() for p in params),
            "trainable": sum(p.numel() for p, m in zip(params, moments)
                             if m is not None),
            "n_params": len(params),
            "bf16_grad_elems": sum(g.numel() for g in grads16
                                   if g is not None),
            "f32_grad_elems": sum(g.numel() for g in grads32
                                  if g is not None)}


def multi_tensor_case(path: str, gen: torch.Generator) -> dict:
    """The three multi-tensor kernels against their plain versions (run
    on the card too) at a benchmark configuration's parameter list, and
    their device times beside their byte bounds: the gather of four
    micro-batches (the last divides by 4: bits equal), the norm (relative
    1e-6: double in fixed slices against float32 a tensor), Adam at step
    3 (relative 1e-6 on each tensor's largest element; the mirror equal to
    the kernel's own parameters cast, the frozen one's as the mirror pass
    wrote it first) and the mirror pass; and the device times of the
    library calls that do the norm, Adam and the mirror's copy."""
    c = _mt_tables(path, gen)
    k, pl = c["kernel"], c["plain"]
    g16, g32 = c["g16"], c["g32"]
    counts0 = (mt.gather.launches, mt.global_norm.launches,
               mt.adam.launches, mt.write_mirror.launches)
    mt.write_mirror(k)   # as a mirror's build writes it
    mt.write_mirror_plain(pl)
    for first, accum in ((True, 1), (False, 1), (False, 1), (False, 4)):
        mt.gather(k, g16, g32, first, accum)
        mt.gather_plain(pl, g16, g32, first, accum)
    torch.cuda.synchronize()
    gather_equal = torch.equal(k.acc, pl.acc)
    out_k = mt.global_norm(k, 5.0)
    out_p = mt.global_norm_plain(pl, 5.0)
    norm_rel = abs(float(out_k[0]) - float(out_p[0])) / float(out_p[0])
    h = mt.AdamHyper.of(1e-3, (0.9, 0.999), 1e-8, 0.0, False, 3.0)
    mt.adam(k, out_k[1], h)
    mt.adam_plain(pl, out_k[1], h)
    torch.cuda.synchronize()

    def worst(xs, ys):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()),
                                                      1e-30)
                   for x, y in zip(xs, ys))

    adam_rel = {
        "param": worst(k.params, pl.params),
        "exp_avg": worst([m[0] for m in k.moments if m],
                         [m[0] for m in pl.moments if m]),
        "exp_avg_sq": worst([m[1] for m in k.moments if m],
                            [m[1] for m in pl.moments if m])}
    mirror_equal = all(torch.equal(cp, p.to(torch.bfloat16))
                       for cp, p in zip(k.copies, k.params))
    frozen_kept = all(torch.equal(a, b) for a, b, m in
                      zip(k.params, pl.params, k.moments) if m is None)
    k.mirror.zero_()
    mt.write_mirror(k)
    torch.cuda.synchronize()
    write_equal = all(torch.equal(cp, p.to(torch.bfloat16))
                      for cp, p in zip(k.copies, k.params))
    launches = [a - b for a, b in zip(
        (mt.gather.launches, mt.global_norm.launches, mt.adam.launches,
         mt.write_mirror.launches), counts0)]
    ok = (gather_equal and norm_rel <= 1e-6 and mirror_equal and write_equal
          and frozen_kept and max(adam_rel.values()) <= 1e-6
          and launches == [4, 1, 1, 2])
    # device time: MT_REPS calls queued behind a sleep of the device, so
    # that the host's launches (the gather's 1,240 addresses) are out of
    # it (the flat buffers, 130-180 MB, are past the 50 MB L2)
    n, n16, n32 = c["numel"], c["bf16_grad_elems"], c["f32_grad_elems"]
    # the one-call library forms the port never makes, on the plain
    # table's lists: Adam without the clip and the mirror (28 bytes a
    # parameter), the norm of the per-tensor norms, a copy of each
    # parameter into its bf16 slice; none adds bf16 and f32 gradients
    # into one f32 accumulator
    live = [i for i, m in enumerate(pl.moments) if m is not None]
    steps = [torch.tensor(3.0, device="cuda") for _ in live]

    def fused_adam():
        torch._fused_adam_(
            [pl.params[i] for i in live], [pl.grads[i] for i in live],
            [pl.moments[i][0] for i in live],
            [pl.moments[i][1] for i in live], [], steps, lr=1e-3,
            beta1=0.9, beta2=0.999, weight_decay=0.0, eps=1e-8,
            amsgrad=False, maximize=False)

    def foreach_norm():
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(pl.grads)))

    norm_abs = abs(float(out_k[0]) - float(out_p[0]))
    adam_abs = max(float((x - y).abs().max())
                   for x, y in zip(k.params, pl.params))
    times = {
        "gather": (lambda: mt.gather(k, g16, g32, False, 1),
                   lambda: mt.gather_plain(pl, g16, g32, False, 1), None,
                   2 * n16 + 4 * n32 + 8 * (n16 + n32),
                   0.0 if gather_equal else math.inf),
        "norm": (lambda: mt.global_norm(k, 5.0),
                 lambda: mt.global_norm_plain(pl, 5.0), foreach_norm, 4 * n,
                 norm_abs),
        "adam": (lambda: mt.adam(k, out_k[1], h),
                 lambda: mt.adam_plain(pl, out_k[1], h), fused_adam,
                 30 * c["trainable"], adam_abs),
        "mirror": (lambda: mt.write_mirror(k),
                   lambda: mt.write_mirror_plain(pl),
                   lambda: torch._foreach_copy_(pl.copies, pl.params), 6 * n,
                   0.0 if write_equal else math.inf)}
    rows = {}
    for name, (kern, plain, library, nbytes, err) in times.items():
        kern_ms = queued_ms(kern, MT_REPS)
        plain_ms = event_ms(plain, 3)
        # device time too, behind a longer sleep: a library call may
        # launch a kernel a tensor
        library_ms = (None if library is None else
                      queued_ms(library, MT_REPS, 1_000_000_000))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": kern_ms, "bound_ms": bound_ms,
                      "x_bound": kern_ms / bound_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bytes": nbytes,
                      "bound_by": "bytes", "max_abs_err": err}
    return {"config": os.path.basename(path), "ok": ok,
            "n_params": c["n_params"], "elements": n,
            "trainable": c["trainable"], "gather_equal": gather_equal,
            "norm_rel": norm_rel, "adam_rel": adam_rel,
            "mirror_equal": mirror_equal, "write_equal": write_equal,
            "frozen_kept": frozen_kept, "launches": launches,
            "times": rows}


def queued_ms(fn, reps: int, sleep_cycles: int = 100_000_000) -> float:
    """Device time a call of `fn` (host launches), timed by events around
    `reps` calls that the host queued while the device slept (about 50
    ms); raises if the host did not get ahead."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event()
    torch.cuda._sleep(sleep_cycles)
    done.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if done.query():
        raise AssertionError("the host's launches outlasted the sleep")
    end.synchronize()
    return start.elapsed_time(end) / reps


def multi_tensor_cases() -> list:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for path in MT_CONFIGS:
        row = multi_tensor_case(path, gen)
        print("multi_tensor " + json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"multi-tensor kernels differ: {bad}")
    return rows


def multi_tensor_role() -> None:
    """This phase alone (python3 chip_smoke.py multi_tensor): the build
    of csrc/multi_tensor.cu with its ptxas report, then the cases, into
    chiprun_out/multi_tensor.json."""
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    nvcc.build_libraries([mt.SOURCE])
    report = {"card": card_line(), "torch": torch.__version__,
              "build_s": time.perf_counter() - t0,
              "ptxas": nvcc.ptxas_entries(nvcc.build_log(mt.SOURCE))}
    for e in report["ptxas"]:
        print(f"ptxas {mt.SOURCE} {json.dumps(e)}", flush=True)
    report["cases"] = multi_tensor_cases()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "multi_tensor.json"), "w") as f:
        json.dump(report, f, indent=1)


# ---------------------------------------------------------- K3 backward

def dwconv_grad_case(b: int, tp: int, c: int, k: int, dtype, gen,
                     offset: bool = False, timed: bool = True) -> dict:
    """K3 dgrad and wgrad against their plain versions; times them, unless
    `offset` (x and dy at a 2-byte offset) or not `timed` (checked
    only)."""
    dev = torch.device("cuda")
    t = tp - k + 1
    x = torch.randn((b, tp, c), generator=gen, device=dev).to(dtype)
    dy = torch.randn((b, t, c), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, c), generator=gen, device=dev) * 0.3).to(dtype)
    if offset:
        x, dy = offset_view(x), offset_view(dy)
    name = str(dtype).split(".")[-1]
    dx = dw.depthwise_conv1d_dgrad(dy, w)
    dx_plain = dw.depthwise_conv1d_dgrad_plain(dy, w)
    dwk = dw.depthwise_conv1d_wgrad(x, dy)
    dw_plain = dw.depthwise_conv1d_wgrad_plain(x, dy)
    torch.cuda.synchronize()
    dgrad_err = float((dx.float() - dx_plain.float()).abs().max())
    w_ref = dw.depthwise_conv1d_wgrad_plain(x.float(), dy.float())
    wgrad_err = float((dwk.float() - w_ref).abs().max())
    row = {"shape": [b, tp, c], "k": k, "dtype": name,
           "dgrad_route": dw.device_plan(dy, k, dgrad=True).route,
           "wgrad_route": dw.wgrad_plan(
               b, tp, c, k, x.element_size(), x_ptr=x.data_ptr() % 16,
               dy_ptr=dy.data_ptr() % 16).route,
           "offset_bytes": x.data_ptr() % 16,
           "dgrad_max_abs_err": dgrad_err, "wgrad_max_abs_err": wgrad_err,
           "wgrad_rel_err": wgrad_err / float(w_ref.abs().max()),
           "wgrad_vs_plain_max_abs_err": float(
               (dwk.float() - dw_plain.float()).abs().max())}
    if not torch.equal(dw.depthwise_conv1d_wgrad(x, dy), dwk):
        raise AssertionError("wgrad differs between two runs")
    if dtype == torch.float32:
        ok = dgrad_err == 0.0 and row["wgrad_rel_err"] <= 1e-5
    else:
        ulp_dx = bf16_ulp(dw.depthwise_conv1d_dgrad_plain(dy.float(),
                                                          w.float()))
        row["dgrad_max_err_ulps"] = float(
            ((dx.float() - dx_plain.float()).abs() / ulp_dx).max())
        # bf16 dw is the kernel's float32 sum rounded once
        own = dw.depthwise_conv1d_wgrad(x.float(), dy.float())
        row["wgrad_max_err_ulps"] = float(
            ((dwk.float() - own).abs() / bf16_ulp(own)).max())
        row["wgrad_max_err_ulps_vs_plain"] = float(
            ((dwk.float() - w_ref).abs() / bf16_ulp(w_ref)).max())
        ok = row["dgrad_max_err_ulps"] <= 1.0 \
            and row["wgrad_max_err_ulps"] <= 1.0
    if not ok:
        raise AssertionError(f"K3 backward disagrees with its plain "
                             f"version: {row}")
    if offset or not timed:
        return row

    item = x.element_size()
    n = _n_copies((x.numel() + 2 * dy.numel()) * item)
    xs = [x.clone() for _ in range(n)]
    dys = [dy.clone() for _ in range(n)]
    x_ncw = [xi.transpose(1, 2).contiguous() for xi in xs]
    dy_ncw = [d.transpose(1, 2).contiguous() for d in dys]
    w_conv = w.t().contiguous()[:, None, :]

    def conv_bwd(i, mask):
        return torch.ops.aten.convolution_backward(
            dy_ncw[i], x_ncw[i], w_conv, None, [1], [0], [1], False, [0], c,
            mask)

    row["dgrad_ms"] = device_ms(
        lambda i: dw.depthwise_conv1d_dgrad(dys[i], w), n)
    row["dgrad_plain_ms"] = device_ms(
        lambda i: dw.depthwise_conv1d_dgrad_plain(dys[i], w), n)
    row["dgrad_library_ms"] = device_ms(
        lambda i: conv_bwd(i, [True, False, False]), n)
    row["wgrad_ms"] = device_ms(lambda i: dw.depthwise_conv1d_wgrad(
        xs[i], dys[i]), n)
    row["wgrad_plain_ms"] = device_ms(
        lambda i: dw.depthwise_conv1d_wgrad_plain(xs[i], dys[i]), n)
    row["wgrad_library_ms"] = device_ms(
        lambda i: conv_bwd(i, [False, True, False]), n)
    # dgrad: read dy and w, write dx; wgrad: read x and dy, write dw
    row["dgrad_bound_ms"], row["dgrad_bound_by"] = _bound(
        (dy.numel() + w.numel() + x.numel()) * item, 2 * b * tp * c * k)
    row["wgrad_bound_ms"], row["wgrad_bound_by"] = _bound(
        (x.numel() + dy.numel() + w.numel()) * item, 2 * b * t * c * k)
    return row


# K3 at K = 31 (the taps in registers; the wgrad's cluster instance) at
# fixed shapes, (B, T+K-1, C, dtype, 2-byte offset, the routes of the
# forward, the dgrad and the wgrad): the LibriSpeech micro-batches, timed;
# then ragged cases on every route, checked only: cp.async (C = 100 bf16;
# C = 4 bf16, whose rows take 8-byte copies), element loads (C = 99 bf16,
# an input at a 2-byte offset) and a dgrad with T < K
K31_TIMED = [(4, 353, 256), (3, 428, 256), (2, 453, 256)]
K31_RAGGED = [
    ((3, 60, 100), torch.bfloat16, False, "cp.async", "cp.async",
     "cp.async"),
    ((3, 60, 99), torch.bfloat16, False, "element", "element", "element"),
    ((2, 60, 256), torch.bfloat16, True, "element", "element", "element"),
    ((1, 35, 4), torch.float32, False, "tma", "tma", "tma"),
    ((1, 35, 4), torch.bfloat16, False, "cp.async", "cp.async", "cp.async"),
]


def k31_cases(gen) -> list:
    """K3's forward and dgrad at K = 31 bit-equal to their plain versions
    in both dtypes on every route, and its wgrad within dwconv_grad_case's
    tolerance and bit-equal between two runs, at K31_TIMED and
    K31_RAGGED; each case's three routes are checked against the
    table."""
    cases = [(shape, dtype, False, "tma", "tma", "tma", True)
             for shape in K31_TIMED
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(*case, False) for case in K31_RAGGED]
    rows = []
    for (b, tp, c), dtype, offset, *routes, timed in cases:
        fwd = kernel_case(b, tp, c, 31, dtype, gen, offset=offset,
                          exact=True, timed=timed)
        bwd = dwconv_grad_case(b, tp, c, 31, dtype, gen, offset=offset,
                               timed=timed)
        got = [fwd["route"], bwd["dgrad_route"], bwd["wgrad_route"]]
        if got != routes:
            raise AssertionError(f"K = 31 at {[b, tp, c]}: routes {got}, "
                                 f"not {routes}")
        if bwd["dgrad_max_abs_err"] != 0.0:
            raise AssertionError(f"K3 dgrad at K = 31 not bit-equal: {bwd}")
        plan = dw.wgrad_plan(b, tp, c, 31, 4 if dtype == torch.float32
                             else 2)
        row = {"shape": [b, tp, c], "dtype": fwd["dtype"], "fwd": fwd,
               "bwd": bwd, "wgrad_plan": {
                   "grid": plan.grid, "block": plan.block, "per": plan.per,
                   "rows": plan.rows, "cluster": plan.cluster}}
        rows.append(row)
        print("K3 K=31 " + json.dumps(row), flush=True)
        if timed:
            print(f"K3 K=31 wgrad {[b, tp, c]} {fwd['dtype']}: "
                  f"{bwd['wgrad_ms'] * 1e3:.2f} us, bound "
                  f"{bwd['wgrad_bound_ms'] * 1e3:.3f} us "
                  f"({bwd['wgrad_bound_by']}), aten.convolution_backward dw "
                  f"{bwd['wgrad_library_ms'] * 1e3:.2f} us, plain "
                  f"{bwd['wgrad_plain_ms'] * 1e3:.1f} us, grid "
                  f"{plan.grid} x {plan.block}", flush=True)
    return rows


# the wgrad instances' route parameter G, as ptxas names them
WGRAD_ROUTES = {"0": "tma", "2": "element", "4": "cp.async 4",
                "8": "cp.async 8"}


def check_wgrad_plan(sms: int) -> int:
    """The wgrad's plan as the C launcher makes it
    (openeat_dwconv1d_wgrad_plan) against dw.wgrad_plan over batches,
    lengths, widths and K (K_FIXED, K_WIDE and run-time K), both dtypes,
    on this card's `sms` SMs and on 3. Returns the number of plans
    compared."""
    fn = dw._entry("openeat_dwconv1d_wgrad_plan",
                   (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    out = (ctypes.c_longlong * len(dw.WGRAD_PLAN_FIELDS))()
    n = 0
    for b, tp, c, k in itertools.product(
            (1, 2, 3, 4, 9, 22), (31, 60, 162, 353, 428, 453, 700),
            (4, 99, 100, 256), (7, 15, 23, 31, 64)):
        if tp < k:
            continue
        for code, item in ((0, 4), (1, 2)):
            for n_sms in (sms, 3):
                rc = fn(b, tp, c, k, code, n_sms, ctypes.addressof(out))
                try:
                    py = dw.wgrad_plan_fields(dw.wgrad_plan(
                        b, tp, c, k, item, num_sms=n_sms))
                except ValueError:
                    py = None
                got = tuple(out) if rc == 0 else None
                if got != py:
                    raise AssertionError(
                        f"wgrad plan at B={b}, T={tp}, C={c}, K={k}, "
                        f"{item}-byte, {n_sms} SMs: C {got}, Python {py}")
                n += 1
    return n


def _device_kernels(call, attempts: int = 3) -> dict:
    """Names of the device kernels one call runs (torch.profiler), after a
    warm-up call, and the number of traces taken: a trace with no device
    event at all is taken as the profiler missing the call, so it is taken
    again, up to `attempts` times."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    names: list[str] = []
    for traces in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name() for e in _device_kernel_events(prof)]
        if names:
            break
    return {"kernels": names, "traces": traces}


def k3_kernels_per_call(shapes: list[tuple], ctc_shapes: list[tuple],
                        gen) -> list[dict]:
    """torch.profiler over one call each of depthwise_conv1d,
    depthwise_conv1d_dgrad and depthwise_conv1d_wgrad at `shapes`, and of
    the CTC kernel dispatch_variant picks (ctc_dp_shared or ctc_dp_global)
    at each of `ctc_shapes` (B, T, L), its inputs already in the kernel's
    dtypes: each must run exactly one device kernel. Each row keeps the
    number of traces its call took (`traces`, in chip_smoke.json)."""
    dev = torch.device("cuda")
    rows = []
    for b, tp, c, k, dtype in shapes:
        x = torch.randn((b, tp, c), generator=gen, device=dev).to(dtype)
        dy = torch.randn((b, tp - k + 1, c), generator=gen,
                         device=dev).to(dtype)
        w = torch.randn((k, c), generator=gen, device=dev).to(dtype)
        for name, call in (("depthwise_conv1d",
                            lambda: dw.depthwise_conv1d(x, w)),
                           ("depthwise_conv1d_dgrad",
                            lambda: dw.depthwise_conv1d_dgrad(dy, w)),
                           ("depthwise_conv1d_wgrad",
                            lambda: dw.depthwise_conv1d_wgrad(x, dy))):
            rows.append({"call": name, "shape": [b, tp, c], "k": k,
                         "dtype": str(dtype).split(".")[-1],
                         **_device_kernels(call)})
    for ctc_shape in ctc_shapes:
        p = ctc_problem(*ctc_shape, VOCAB, gen)
        z, s_lens = ctc.extended_labels(p["labels"], p["ll"])
        llp = ctc.gather_label_logp(p["log_probs"], z)
        il, sl = p["il"].int(), s_lens.int()
        a2 = ctc.transition_masks(z).to(torch.uint8)
        kernel = ctc.ctc_dp_shared \
            if ctc.dispatch_variant(*llp.shape) == "shared" \
            else ctc.ctc_dp_global
        rows.append({"call": kernel.__name__, "shape": list(llp.shape),
                     **_device_kernels(lambda: kernel(llp, il, sl, a2))})
    for row in rows:
        if len(row["kernels"]) != 1:
            raise AssertionError(f"one call ran {len(row['kernels'])} "
                                 f"device kernels: {row}")
    return rows


# ---------------------------------------------------------------- CTC

def check_global_plan(widths=(1, 32, 33, 49, 64, 65, 128, 129, 241, 256,
                              257, 512, 513, 1001, ctc.MAX_S)) -> list:
    """K2's plan as the C launcher makes it (openeat_ctc_global_plan)
    against ctc.global_plan at each of `widths` (by default from 1 to
    MAX_S)."""
    fn = ctc._entry("openeat_ctc_global_plan",
                    (ctypes.c_int, ctypes.c_void_p))
    out = (ctypes.c_int * 4)()
    plans = []
    for s in widths:
        fn(s, ctypes.addressof(out))
        if tuple(out) != ctc.global_plan(s):
            raise AssertionError(f"K2 plan at S = {s}: C {tuple(out)}, "
                                 f"Python {ctc.global_plan(s)}")
        plans.append([s, *out])
    return plans


def ctc_problem(b: int, t: int, l_pad: int, v: int, gen) -> dict:
    """Log-probs [B, T, V] and labels [B, L] on the card with a repeated
    label, an infeasible row (more labels than frames), len == 1 and an
    input length of T + 5 (row 3, or row 0 where B <= 3), which the
    kernels and the plain version walk as T."""
    dev = torch.device("cuda")
    lp = torch.randn((b, t, v), generator=gen, device=dev).log_softmax(-1)
    labels = torch.randint(1, v, (b, l_pad), generator=gen, device=dev)
    labels[0, 1] = labels[0, 0]
    il = torch.randint(max(t // 2, 1), t + 1, (b,), generator=gen,
                       device=dev)
    ll = torch.randint(max(l_pad // 2, 1), l_pad + 1, (b,), generator=gen,
                       device=dev)
    il[0], ll[0] = t, l_pad
    if b > 1:
        il[1], ll[1] = 1, 1
    if b > 2:
        il[2], ll[2] = max(l_pad // 2 - 1, 1), l_pad
    il[3 if b > 3 else 0] = t + 5
    return {"log_probs": lp, "labels": labels, "il": il, "ll": ll}


def ctc_case(b: int, t: int, l_pad: int, v: int, gen,
             step_ms: float | None = None, timed: bool = True) -> dict:
    """The CTC kernel dispatch_variant picks at [B, T, S=2L+1] against
    the plain recursions, bit for bit (loss and gamma, NEG_INF entries
    included); where `timed`, times of the kernel alone, the plain
    version, the port's whole CTC op and F.ctc_loss (forward and
    backward). `step_ms`, one chain step's device time
    (ctc.chain_step_ms), gives the chain bound: T dependent steps, alpha
    and beta side by side."""
    p = ctc_problem(b, t, l_pad, v, gen)
    z, s_lens = ctc.extended_labels(p["labels"], p["ll"])
    allow2 = ctc.transition_masks(z)
    llp = ctc.gather_label_logp(p["log_probs"], z)
    s = llp.shape[2]
    variant = ctc.dispatch_variant(b, t, s)
    kernel = ctc.ctc_dp_shared if variant == "shared" else ctc.ctc_dp_global
    loss, gamma = kernel(llp, p["il"], s_lens, allow2)
    ref_loss, ref_gamma = ctc.ctc_dp_plain(llp, p["il"], s_lens, allow2)
    torch.cuda.synchronize()
    fin = ref_gamma > -1e29
    row = {"shape": [b, t, s], "v": v, "variant": variant,
           "loss_max_abs_err": float((loss - ref_loss).abs().max()),
           "gamma_max_abs_err": float((gamma - ref_gamma).abs().max()),
           "neg_inf_equal": bool(torch.equal(gamma <= -1e29, ~fin)),
           "infeasible_loss": float(loss[2]) if b > 2 else None}
    row["max_abs_err"] = max(row["loss_max_abs_err"],
                             row["gamma_max_abs_err"])
    if not (row["max_abs_err"] == 0.0 and row["neg_inf_equal"]):
        raise AssertionError(f"CTC kernel disagrees with its plain version: "
                             f"{row}")
    if not timed:
        return row

    nbytes = 2 * llp.numel() * 4 + allow2.numel() + 3 * b * 4
    n = _n_copies(nbytes)
    llps = [llp.clone() for _ in range(n)]
    # the kernel alone: lengths already in its int32
    il32, sl32 = p["il"].int(), s_lens.int()
    row["ms"] = device_ms(lambda i: kernel(llps[i], il32, sl32, allow2), n)
    row["plain_ms"] = event_ms(lambda: ctc.ctc_dp_plain(
        llp, p["il"], s_lens, allow2), reps=2)
    # the bytes bound; the chain of dependent steps bounds the kernel
    row["bound_ms"], row["bound_by"] = _bound(nbytes, 20.0 * b * t * s)
    row["chain_bound_ms"] = t * step_ms if step_ms is not None else None

    lp = p["log_probs"].detach().requires_grad_()
    lp_tbv = p["log_probs"].transpose(0, 1).detach().requires_grad_()

    def port_op():
        per = ctc.ctc_loss(lp, p["il"], p["labels"], p["ll"])
        torch.autograd.grad(per.sum(), lp)

    il_t = p["il"].clamp(max=t)  # F.ctc_loss refuses lengths above T

    def library_op():
        loss = F.ctc_loss(lp_tbv, p["labels"], il_t, p["ll"], blank=0,
                          reduction="sum", zero_infinity=True)
        torch.autograd.grad(loss, lp_tbv)

    row["op_ms"] = event_ms(port_op)
    row["library_ms"] = event_ms(library_op)
    return row


# ---------------------------------------------------------- training

def write_wavs(rng: np.random.Generator, prefix: str, durations: list,
               n_tokens: list) -> str:
    """Synthetic wavs with random transcripts over the dict; returns the
    manifest path."""
    wav_dir = os.path.join(WORK, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    lines = []
    for i, (dur, n_tok) in enumerate(zip(durations, n_tokens)):
        t = np.arange(int(dur * 16000)) / 16000.0
        x = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 3000) * t)
                for _ in range(3)) + 0.02 * rng.standard_normal(t.size)
        path = os.path.join(wav_dir, f"{prefix}{i:03d}.wav")
        write_wav(path, x.astype(np.float32), 16000)
        text = "".join(chr(0x4E00 + j)
                       for j in rng.integers(0, VOCAB - 3, n_tok))
        lines.append(f"utt:{prefix}{i:03d}\tfeat:{path}\t"
                     f"feat_shape:{dur:.3f}\ttext:{text}\n")
    manifest = os.path.join(WORK, f"{prefix}.data")
    with open(manifest, "w", encoding="utf-8") as f:
        f.writelines(lines)
    return manifest


def write_train_corpus(rng: np.random.Generator) -> tuple[str, str, float]:
    durs = [float(np.round(rng.uniform(3.0, 8.0), 3)) for _ in range(N_TRAIN)]
    toks = [int(round(3 * d)) for d in durs]
    train = write_wavs(rng, "tr", durs + [LONG_SECONDS] * 2,
                       toks + [LONG_TOKENS] * 2)
    cv_durs = [float(np.round(rng.uniform(3.0, 8.0), 3)) for _ in range(N_CV)]
    cv = write_wavs(rng, "cv", cv_durs, [int(round(3 * d)) for d in cv_durs])
    return train, cv, sum(durs) + 2 * LONG_SECONDS


def train_shapes(manifest: str, dict_path: str) -> list[tuple]:
    """(B, T', L) of every training batch: the trainer's dynamic batches,
    wavs padded to whole seconds, fbank frames, conv2d x4 subsampling,
    labels padded to a multiple of 8."""
    dc = TRAIN_CONFIG["dataset_conf"]
    ds = AudioDataset(manifest, load_dict(dict_path),
                      max_length=dc["max_length"],
                      min_length=dc["min_length"], batch_type="dynamic",
                      max_frames_in_batch=dc["max_frames_in_batch"])
    shapes = []
    for batch in ds.batches:
        samples = max(round(u.num_frames * 160) for u in batch)
        padded = math.ceil(samples / 16000) * 16000
        frames = (padded - 400) // 160 + 1
        t_enc = ((frames - 3) // 2 + 1 - 3) // 2 + 1
        l_pad = math.ceil(max(len(u.token_ids) for u in batch) / 8) * 8
        shapes.append((len(batch), t_enc, l_pad))
    return shapes


COUNTED = (dw.depthwise_conv1d, dw.depthwise_conv1d_dgrad,
           dw.depthwise_conv1d_wgrad, ctc.ctc_dp_shared, ctc.ctc_dp_global)


def _reset_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0
        fn.shape_launches.clear()


def _counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}


# the update's multi-tensor kernels (ops/multi_tensor.py), counted apart:
# they have no shapes
MT_COUNTED = (mt.gather, mt.global_norm, mt.adam, mt.write_mirror)


def _reset_mt_counts() -> None:
    for fn in MT_COUNTED:
        fn.launches = 0


def _mt_counts() -> dict:
    return {fn.__name__: fn.launches for fn in MT_COUNTED}


def check_mt_counts(counts: dict, steps: int, micro: int) -> None:
    """The weight mirror's launches over `steps` bf16 Adam train steps of
    `micro` micro-batches without a mesh: a gather a micro-batch, a norm
    a step, Adam at most a step (a non-finite norm skips it) and at least
    once, and the mirror's first write."""
    if counts["gather"] != steps * micro \
            or counts["global_norm"] != steps \
            or not 0 < counts["adam"] <= steps \
            or not counts["write_mirror"]:
        raise AssertionError(f"multi-tensor kernels launched {counts} over "
                             f"{steps} steps of {micro} micro-batches")


def run_training(train_data: str, cv_data: str, dict_path: str) -> dict:
    """bin.train on cuda for 2 epochs, a resume from epoch_1.pt, and
    recognize from epoch_2.pt; checks and launch counts."""
    cfg_path = os.path.join(WORK, "train_conformer.json")
    with open(cfg_path, "w") as f:
        json.dump(TRAIN_CONFIG, f)
    exp = os.path.join(WORK, "exp")
    args = ["--config", cfg_path, "--train_data", train_data, "--cv_data",
            cv_data, "--dict", dict_path, "--exp_dir", exp, "--device",
            "cuda", "--num_workers", "4"]
    n_cv = len(AudioDataset(cv_data, load_dict(dict_path),
                            batch_type="dynamic",
                            max_frames_in_batch=10000))
    out = {}
    t0 = time.perf_counter()
    state = train_cli.main(args)
    torch.cuda.synchronize()
    out["train_wall_s"] = time.perf_counter() - t0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "train"]
    out["step_losses"] = losses
    out["epochs"] = [r for r in records if r["kind"] == "epoch"]
    if len(losses) != state.step or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses: {losses}")
    for name in ("epoch_1.pt", "epoch_1.json", "epoch_2.pt", "epoch_2.json",
                 "optimizer.pt", "train.json"):
        if not os.path.exists(os.path.join(exp, name)):
            raise AssertionError(f"training did not write {name}")
    steps_2 = state.step
    with open(os.path.join(exp, "epoch_1.json")) as f:
        steps_1 = json.load(f)["step"]
    # resume from epoch_1.pt for one epoch, into its own directory so that
    # epoch_2.pt stays for the decode below; optimizer.pt beside
    # epoch_1.pt is epoch 2's, so Adam starts afresh, as the JAX trainer
    # does in that case
    args_r = args[:args.index("--exp_dir")] + [
        "--exp_dir", os.path.join(WORK, "exp_resume")] + args[
        args.index("--exp_dir") + 2:]
    resumed = train_cli.main(args_r + ["--max_epoch", "2", "--checkpoint",
                                       os.path.join(exp, "epoch_1.pt")])
    if resumed.step != steps_2:
        raise AssertionError(f"resume from epoch 1 (step {steps_1}) ended at "
                             f"step {resumed.step}, not {steps_2}")
    out["steps"] = {"epoch_1": steps_1, "epoch_2": steps_2,
                    "resumed_epoch_2": resumed.step,
                    "resumed_applied_updates": resumed.n_applied}
    hyp = os.path.join(WORK, "train_hyp.txt")
    recognize.main(["--config", os.path.join(exp, "train.json"),
                    "--checkpoint", os.path.join(exp, "epoch_2.pt"),
                    "--test_data", cv_data, "--dict", dict_path,
                    "--result_file", hyp, "--mode", "ctc_greedy_search",
                    "--batch_size", str(N_CV), "--device", "cuda"])
    with open(hyp, encoding="utf-8") as f:
        out["decoded"] = sum(1 for _ in f)
    if out["decoded"] != N_CV:
        raise AssertionError(f"recognize wrote {out['decoded']} lines")
    out["n_train_steps"] = steps_2 + (resumed.step - steps_1)
    out["n_cv_batches"] = 3 * n_cv
    return out


def check_train_counts(run: dict, counts: dict,
                       decode_batches: int = 1) -> None:
    steps, cv = run["n_train_steps"], run["n_cv_batches"]
    want = {"depthwise_conv1d": 12 * (steps + cv + decode_batches),
            "depthwise_conv1d_dgrad": 12 * steps,
            "depthwise_conv1d_wgrad": 12 * steps}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name} launched {counts[name]} times, "
                                 f"expected {n} ({steps} train steps, {cv} "
                                 f"cv batches, {decode_batches} decoded "
                                 f"batches): {counts}")
    n_ctc = counts["ctc_dp_shared"] + counts["ctc_dp_global"]
    if n_ctc != steps + cv or not counts["ctc_dp_shared"] \
            or not counts["ctc_dp_global"]:
        raise AssertionError(f"CTC kernels launched {counts}, expected "
                             f"{steps + cv} in all with both variants")


def _host_batches(manifest: str, dict_path: str, n: int) -> dict:
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=n,
                      batch_type="static")
    return AudioCollate()(ds[0])[1]


def _features(host: dict, dev: torch.device, frontend: FrontendConfig,
              train: bool = False, gen=None) -> dict:
    b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    feats, flens = compute_features(b["wav"], b["wav_lens"], frontend, train,
                                    gen)
    return {"features": feats, "features_length": flens,
            "targets": b["targets"], "targets_length": b["targets_length"]}


def _flagship(dtype: str, dropout: float, **overrides) -> torch.nn.Module:
    conf = dict(TRAIN_CONFIG["model_conf"], compute_dtype=dtype,
                dropout_rate=dropout, **overrides)
    model = build_asr_model(conf, 80, VOCAB)
    init_parameters(model, make_generator(SEED))
    return model


def gpu_vs_cpu_step(manifest: str, dict_path: str) -> dict:
    """One float32 forward and backward at full width, GPU (kernels) and
    CPU (plain versions), same weights and features, dropout 0."""
    cpu = _flagship("float32", 0.0).train()
    gpu = copy.deepcopy(cpu).cuda().train()
    host = _host_batches(manifest, dict_path, 4)
    fe = FrontendConfig()
    batch = _features(host, torch.device("cpu"), fe)
    res = {}
    grads = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        b = {k: v.to(dev) for k, v in batch.items()}
        metrics = model(*b.values())
        metrics["loss"].backward()
        res[name] = {k: float(v) for k, v in metrics.items()}
        grads[name] = {n: p.grad.detach().cpu()
                       for n, p in model.named_parameters()}
    norm = {k: float(torch.stack([g.square().sum() for g in v.values()])
                     .sum().sqrt()) for k, v in grads.items()}
    g_max = max(float(g.abs().max()) for g in grads["cpu"].values())
    worst = []
    for n, ref in grads["cpu"].items():
        err = float((grads["gpu"][n] - ref).abs().max())
        if not n.endswith("linear_k.bias"):   # zero by shift invariance
            worst.append((err / max(float(ref.abs().max()), 1e-30), err, n))
        # the second term covers the attention key biases, whose
        # gradient is zero by the softmax's shift invariance and so is
        # rounding noise on both devices
        if err > STEP_GRAD_TOL * float(ref.abs().max()) + 1e-5 * g_max:
            raise AssertionError(f"gradient of {n}: GPU vs CPU max abs err "
                                 f"{err}, max |grad| {float(ref.abs().max())}")
    out = {"cpu": res["cpu"], "gpu": res["gpu"], "grad_norm": norm,
           "worst_grad_rel_err": sorted(worst, reverse=True)[:5],
           "batch_shape": list(batch["features"].shape)}
    for k in ("loss", "loss_ctc", "loss_att"):
        rel = abs(res["gpu"][k] - res["cpu"][k]) / abs(res["cpu"][k])
        out[f"{k}_rel_err"] = rel
        if rel > STEP_LOSS_TOL:
            raise AssertionError(f"{k}: GPU vs CPU relative error {rel}")
    out["acc_abs_err"] = abs(res["gpu"]["acc"] - res["cpu"]["acc"])
    out["grad_norm_rel_err"] = abs(norm["gpu"] - norm["cpu"]) / norm["cpu"]
    if out["grad_norm_rel_err"] > STEP_GRAD_TOL:
        raise AssertionError(f"grad norm GPU {norm['gpu']} CPU "
                             f"{norm['cpu']}")
    return out


def overfit(manifest: str, dict_path: str, steps: int = 30) -> dict:
    """Adam on one repeated 8-utterance batch, bf16, dropout 0, no
    SpecAugment: only the parameters change from step to step."""
    dev = torch.device("cuda")
    model = _flagship("bfloat16", 0.0).to(dev)
    batch = _features(_host_batches(manifest, dict_path, 8), dev,
                      FrontendConfig())
    opt, schedule = build_optimizer(model, 1e-3, 10)
    state = TrainState(model, opt)
    step = build_train_step(schedule, 1, 5.0)
    losses = [float(step(state, batch, None)["loss"]) for _ in range(steps)]
    ratio = statistics.mean(losses[-5:]) / losses[0]
    if not ratio < 0.9:
        raise AssertionError(f"overfit ratio {ratio}: {losses}")
    return {"losses": losses, "ratio_last5_over_first": ratio}


def profiled_step_names(manifest: str, dict_path: str, train_config: dict,
                        bpe=None) -> set:
    """The names in the profile of one bf16 train step of `train_config`'s
    model (dropout 0.1, SpecAugment) on the first dynamic batch of
    `manifest`, after one unprofiled step: its host events (the train
    step's spans, the kernel wrappers' regions) and its device kernels."""
    dev = torch.device("cuda")
    char_dict = load_dict(dict_path)
    conf = dict(train_config["model_conf"], compute_dtype="bfloat16",
                dropout_rate=0.1)
    model = build_asr_model(conf, 80, len(char_dict))
    init_parameters(model, make_generator(SEED))
    model.to(dev)
    dc = train_config["dataset_conf"]
    ds = AudioDataset(manifest, char_dict, bpe,
                      max_length=dc["max_length"],
                      min_length=dc["min_length"], batch_type="dynamic",
                      max_frames_in_batch=dc["max_frames_in_batch"])
    fe = FrontendConfig.from_collate_conf(train_config["collate_conf"])
    opt, schedule = build_optimizer(model, 1e-3, 4)
    state = TrainState(model, opt)
    step = build_train_step(schedule, 1, 5.0)
    gen = make_generator(SEED, dev)
    batch = _features(AudioCollate()(ds[0])[1], dev, fe, True, gen)
    step(state, batch, gen)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    return {e.name() for e in _raw_events(prof)}


# ---------------------------------------------------------------- moe

# examples/aishell/conf/train_conformer_moe.yaml: the flagship's
# model_conf with a top-2 mixture of 4 experts in each block's main FFN;
# trained like the flagship phase (10000-frame batches where the recipe
# has 80000), one epoch
MOE_TRAIN_CONFIG = repo_config(
    "examples/aishell/conf/train_conformer_moe.yaml", max_epoch=1,
    log_interval=1, warmup_steps=4, seed=SEED)
MOE_TRAIN_CONFIG["dataset_conf"]["max_frames_in_batch"] = 10000
MOE_KEYS = {k: v for k, v in MOE_TRAIN_CONFIG["model_conf"].items()
            if k.startswith("moe_")}
MOE_TOL = 1e-4    # float32 MoE layer, GPU vs CPU: relative to max |y|


def moe_drop_fractions(model, batches: list) -> list:
    """Per MoE layer, the share of routed (token, expert) pairs past the
    capacity over `batches` (eval forward of the encoder)."""
    stats = {}
    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, MoEPositionwiseFeedForward):
            def hook(mod, args, name=name):
                sel, keep = mod.route(*args)[1:3]
                st = stats.setdefault(name, [0, 0])
                st[0] += int((sel > 0).sum())
                st[1] += int(keep.sum())
            hooks.append(m.register_forward_pre_hook(hook))
    with torch.inference_mode():
        for b in batches:
            model.encode(b["features"], b["features_length"])
    for h in hooks:
        h.remove()
    return [1.0 - kept / routed for routed, kept in stats.values()]


def moe_training(train_data: str, cv_data: str, dict_path: str) -> dict:
    """bin.train on the MoE Conformer for one epoch and a rescoring
    recognize of its checkpoint; launch counts of that run."""
    cfg_path = os.path.join(WORK, "train_conformer_moe.json")
    with open(cfg_path, "w") as f:
        json.dump(MOE_TRAIN_CONFIG, f)
    exp = os.path.join(WORK, "exp_moe")
    _reset_counts()
    t0 = time.perf_counter()
    state = train_cli.main(["--config", cfg_path, "--train_data", train_data,
                            "--cv_data", cv_data, "--dict", dict_path,
                            "--exp_dir", exp, "--device", "cuda",
                            "--num_workers", "4"])
    torch.cuda.synchronize()
    out = {"train_wall_s": time.perf_counter() - t0}
    hyp = os.path.join(WORK, "moe_hyp.txt")
    recognize.main(["--config", os.path.join(exp, "train.json"),
                    "--checkpoint", os.path.join(exp, "epoch_1.pt"),
                    "--test_data", cv_data, "--dict", dict_path,
                    "--result_file", hyp, "--mode", "attention_rescoring",
                    "--batch_size", str(N_CV), "--beam_size", str(BEAM),
                    "--reverse_weight", "0.3", "--device", "cuda"])
    out["launches"] = _counts()
    with open(hyp, encoding="utf-8") as f:
        out["decoded"] = sum(1 for _ in f)
    if out["decoded"] != N_CV:
        raise AssertionError(f"MoE recognize wrote {out['decoded']} lines")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if r["kind"] == "train"]
    out["step_losses"] = [r["loss"] for r in steps]
    out["moe_aux"] = [r.get("moe_aux") for r in steps]
    if len(steps) != state.step or not all(
            math.isfinite(r["loss"]) and r.get("moe_aux") is not None
            and math.isfinite(r["moe_aux"]) for r in steps):
        raise AssertionError(f"MoE training records: {steps}")
    out["epoch"] = next(r for r in records if r["kind"] == "epoch")
    n_cv = len(AudioDataset(cv_data, load_dict(dict_path),
                            batch_type="dynamic", max_frames_in_batch=10000))
    out["n_train_steps"], out["n_cv_batches"] = state.step, n_cv
    check_train_counts(out, out["launches"])
    # the trained model's drops on the first training batches
    model = recognize.load_model(
        json.load(open(os.path.join(exp, "train.json"))),
        os.path.join(exp, "epoch_1.pt"), VOCAB, torch.device("cuda"))
    dc = TRAIN_CONFIG["dataset_conf"]
    ds = AudioDataset(train_data, load_dict(dict_path),
                      max_length=dc["max_length"], min_length=dc["min_length"],
                      batch_type="dynamic",
                      max_frames_in_batch=dc["max_frames_in_batch"])
    batches = [_features(AudioCollate()(ds[i])[1], torch.device("cuda"),
                         FrontendConfig()) for i in range(min(3, len(ds)))]
    out["dropped_pair_share_per_layer"] = moe_drop_fractions(model, batches)
    return out


def moe_layer_gpu_vs_cpu(b: int, t: int) -> dict:
    """One float32 MoE FFN at full width (d 256, 1024 hidden, 4 experts,
    top-2, cf 1.25, swish) on a [b, t, 256] input with ragged padding:
    the card against the CPU, output, aux and the kept pairs. The
    router's bias favours expert 0, so it saturates and pairs drop."""
    gen = torch.Generator().manual_seed(SEED)
    cpu = MoEPositionwiseFeedForward(256, 1024, 4, 2, 1.25,
                                     get_activation("swish"))
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (p.shape[-2] ** -0.5 if p.dim() > 1 else 0.1))
        cpu.router.bias.copy_(torch.tensor([20.0, 0.0, 0.0, 0.0]))
    x = torch.randn(b, t, 256, generator=gen)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen)
    mask = (torch.arange(t)[None, :] < lens[:, None])[:, None, :]
    gpu = copy.deepcopy(cpu).cuda()
    with torch.no_grad():
        y, aux = cpu(x, mask)
        keep = cpu.route(x, mask)[2]
        y_g, aux_g = gpu(x.cuda(), mask.cuda())
        keep_g = gpu.route(x.cuda(), mask.cuda())[2].cpu()
    err = float((y_g.cpu() - y).abs().max())
    out = {"shape": [b, t, 256], "max_abs_err": err,
           "max_abs_y": float(y.abs().max()),
           "aux_rel_err": abs(float(aux_g) - float(aux)) / float(aux),
           "kept_pairs": int(keep.sum()),
           "dropped_pairs": int(mask.sum()) * 2 - int(keep.sum()),
           "kept_sets_equal": bool(torch.equal(keep, keep_g))}
    if not out["kept_sets_equal"] or err > MOE_TOL * out["max_abs_y"] \
            or out["aux_rel_err"] > 1e-5 or not out["dropped_pairs"]:
        raise AssertionError(f"MoE layer GPU vs CPU: {out}")
    return out


# ---------------------------------------------------------------- dist



def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_role(role: str, *args, env: dict | list | None = None) -> list:
    """Start this script in `role`, one process per env in `env`."""
    envs = env if isinstance(env, list) else [env or {}]
    return [subprocess.Popen(
        ["python3", os.path.abspath(__file__), role, *map(str, args)],
        env=dict(os.environ, **e), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for e in envs]


def _wait_role(role: str, procs: list, timeout: int = 420) -> None:
    """Wait for every process of `role`; raises if one fails."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{role} failed ({p.returncode}): "
                                 f"{o[-3000:]}")


def dist_world1(train_data: str, dict_path: str) -> dict:
    """(a) bin.train of the flagship in float32 with dropout 0, once
    alone and once as a one-rank NCCL world (the distributed path: the
    loss shares, the flat all-reduce, the metric sums), deterministic
    algorithms on: the step metrics and epoch_1.pt must be bit-equal.
    Then one all-reduce of the model's gradient buffer, timed."""
    with open(train_data, encoding="utf-8") as f:
        lines = f.readlines()[:30]
    manifest = os.path.join(WORK, "dist.data")
    with open(manifest, "w", encoding="utf-8") as f:
        f.writelines(lines)
    _wait_role("dist_world1", _start_role(
        "dist_world1", WORK, manifest, dict_path,
        env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}))
    with open(os.path.join(WORK, "dist_world1.json")) as f:
        return json.load(f)


def dist_world1_role(work: str, manifest: str, dict_path: str) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    cfg = dict(TRAIN_CONFIG, max_epoch=1, model_conf=dict(
        TRAIN_CONFIG["model_conf"], compute_dtype="float32",
        dropout_rate=0.0))
    cfg_path = os.path.join(work, "dist_world1.json.cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    runs = {}
    port = _free_port()
    for name in ("alone", "nccl"):
        exp = os.path.join(work, f"exp_dist_{name}")
        if name == "nccl":
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                              LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(port))
        t0 = time.perf_counter()
        train_cli.main(["--config", cfg_path, "--train_data", manifest,
                        "--cv_data", manifest, "--dict", dict_path,
                        "--exp_dir", exp, "--device", "cuda",
                        "--num_workers", "2"])
        torch.cuda.synchronize()
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        runs[name] = {
            "wall_s": time.perf_counter() - t0,
            "steps": [{k: r[k] for k in ("loss", "acc", "grad_norm",
                                         "skipped")}
                      for r in recs if r["kind"] == "train"],
            "epoch": next(r for r in recs if r["kind"] == "epoch"),
            "params": torch.load(os.path.join(exp, "epoch_1.pt"),
                                 weights_only=True)}
    a, b = runs["alone"], runs["nccl"]
    unequal = [k for k in a["params"]
               if not torch.equal(a["params"][k], b["params"][k])]
    out = {"steps": a["steps"], "steps_equal": a["steps"] == b["steps"],
           "n_steps": len(a["steps"]), "params_unequal": unequal,
           "train_loss_equal": (a["epoch"]["train_loss"]
                                == b["epoch"]["train_loss"]),
           "wall_s": {k: v["wall_s"] for k, v in runs.items()}}
    if not out["steps_equal"] or unequal or not out["n_steps"]:
        raise AssertionError(f"NCCL world 1 vs alone: {out}, "
                             f"{b['steps']}")
    # one flat all-reduce of a float32 buffer the size of the gradients
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    os.environ["MASTER_PORT"] = str(_free_port())
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        grads = [torch.randn(v.shape, device="cuda")
                 for v in a["params"].values() if v.is_floating_point()]
        flat = _flatten_dense_tensors(grads)
        out["grad_numel"] = flat.numel()
        out["all_reduce_ms"] = event_ms(lambda: dist.all_reduce(flat), 20)


        def step_reduce():   # what apply_update does on a mesh
            buf = _flatten_dense_tensors(grads)
            dist.all_reduce(buf)
            for g, r in zip(grads, _unflatten_dense_tensors(buf, grads)):
                g.copy_(r)

        out["flatten_all_reduce_unflatten_ms"] = event_ms(step_reduce, 10)
        # the GPipe schedule at pipe = 1, four microbatches, on NCCL
        # against the plain step (another summation order: tolerances)
        batch = _features(_host_batches(manifest, dict_path, 4),
                          torch.device("cuda"), FrontendConfig())
        mesh = mesh_lib.make_pipe_mesh(1, 1)
        ref = _flagship("float32", 0.0).cuda()
        par = copy.deepcopy(ref)
        mesh_lib.apply_mesh(par, mesh)
        out["pp1"] = _case_step(par, mesh, make_pp_loss_fn(par, mesh, 4),
                                batch)
        out["pp1"].update(_hold_to_one_rank(ref, batch, out["pp1"].pop(
            "metrics"), mesh_lib.full_state_dict(par, mesh)))
        launched = out["pp1"]["launches"]
        if not out["pp1"]["ok"] or not all(launched[k] for k in (
                "depthwise_conv1d", "depthwise_conv1d_dgrad",
                "depthwise_conv1d_wgrad")) or not (
                launched["ctc_dp_shared"] + launched["ctc_dp_global"]):
            raise AssertionError(f"pp1 vs the plain step: {out['pp1']}")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, "dist_world1.json"), "w") as f:
        json.dump(out, f)


def dist_two_ranks(train_data: str, dict_path: str) -> list:
    """(b) two ranks sharing the card over gloo (NCCL takes one rank a
    device): one float32 SGD step at dp = 2, one at tp = 2, one of the
    MoE Conformer at dp = 2 with capacity factor 0.5 (at most half the
    routed pairs fit, so tokens drop), the GPipe step at pipe = 2 with 4
    microbatches (pp2; pp2_tail with the tail on the last stage) and
    the step at tp = 2 with sequence_sharding (sp_tp2, on the batch cut
    to an even T' so that time shards), each against the one-rank step
    on the same global batch of 4 utterances. Starts the two processes;
    check_two_ranks waits for them."""
    port = _free_port()
    return _start_role("dist_rank", WORK, train_data, dict_path, env=[
        {"RANK": str(r), "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
         "MASTER_PORT": str(port)} for r in range(2)])


def check_two_ranks(procs: list) -> dict:
    _wait_role("dist_rank", procs)
    with open(os.path.join(WORK, "dist_two_ranks.json")) as f:
        out = json.load(f)
    if sorted(out) != sorted(TWO_RANK_CASES) or not all(
            v["ok"] for v in out.values()):
        raise AssertionError(f"two ranks vs one: {out}")
    return out


def _hold_to_one_rank(ref: torch.nn.Module, batch: dict, m_par: dict,
                      full: dict) -> dict:
    """One SGD step (lr 1, clip 5) of `ref` on the whole batch, against a
    distributed step's metrics and gathered parameters `full`."""
    start = {k: v.clone() for k, v in ref.state_dict().items()}
    opt, sched = build_optimizer(ref, 1.0, 1, "sgd")
    m_ref = build_train_step(sched, 1, 5.0)(TrainState(ref, opt), batch,
                                             None)
    rel = {k: abs(m_par[k] - float(m_ref[k]))
           / max(abs(float(m_ref[k])), 1e-30)
           for k in m_ref if k != "skipped"}
    # the step's tolerances (the same arithmetic summed in another
    # order): losses within STEP_LOSS_TOL, the norm within STEP_GRAD_TOL,
    # each tensor's update (SGD at lr 1: the clipped gradient) within
    # STEP_GRAD_TOL of its largest plus 1e-5 of the model's largest, as
    # gpu_vs_cpu_step holds gradients
    after = ref.state_dict()
    steps = {k: float((after[k] - start[k]).abs().max()) for k in start}
    floor = 1e-5 * max(steps.values())
    worst = max((float((full[k] - after[k]).abs().max())
                 / (STEP_GRAD_TOL * steps[k] + floor), k) for k in start)
    return {"metrics": {k: float(v) for k, v in m_ref.items()},
            "rel_err": rel, "worst_update_err_over_tol": worst,
            "ok": (max(v for k, v in rel.items() if k != "grad_norm")
                   <= STEP_LOSS_TOL and rel["grad_norm"] <= STEP_GRAD_TOL
                   and worst[0] <= 1.0)}


def _case_step(par: torch.nn.Module, mesh, loss_fn, batch: dict) -> dict:
    """One SGD step (lr 1, clip 5) of the distributed `par` on its rows
    of `batch`, its kernels' launches counted from 0 and K3's inputs
    traced: metrics, wall time, launches, K3 shapes, parameter bytes."""
    rows = mesh.rows(len(batch["features"]))
    opt, sched = build_optimizer(par, 1.0, 1, "sgd")
    step = build_train_step(sched, 1, 5.0, loss_fn=loss_fn, mesh=mesh)
    _reset_counts()
    with K3Trace() as trace:
        t0 = time.perf_counter()
        m_par = step(TrainState(par, opt),
                     {k: v[rows] for k, v in batch.items()}, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"metrics": {k: float(v) for k, v in m_par.items()},
            "step_wall_s": wall, "launches": _counts(),
            "k3_inputs": sorted({f"{list(c[0])} {c[1]}"
                                 for c in trace.calls}),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in par.parameters())}


def _even_time(batch: dict) -> dict:
    """The batch cut by 4 frames when its T' = ((T-1)//2 - 1)//2 is odd,
    so that sequence parallelism shards time over two ranks."""
    t = batch["features"].shape[1]
    if ((t - 1) // 2 - 1) // 2 % 2 == 0:
        return batch
    return dict(batch, features=batch["features"][:, :t - 4].contiguous(),
                features_length=batch["features_length"].clamp(max=t - 4))


# name: (mesh layout, data, model or pipe ranks, model_conf overrides)
TWO_RANK_CASES = {
    "dp2": ("mesh", 2, 1, {}),
    "tp2": ("mesh", 1, 2, {}),
    "moe_dp2": ("mesh", 2, 1, dict(MOE_KEYS, moe_capacity_factor=0.5)),
    "pp2": ("pipe", 1, 2, {}),
    "pp2_tail": ("pipe_tail", 1, 2, {}),
    "sp_tp2": ("mesh", 1, 2, {"sequence_sharding": True}),
}
NEW_DIST_CASES = ("pp2", "pp2_tail", "sp_tp2")   # this slice's paths
PP_MICRO = 4


def dist_rank_role(work: str, train_data: str, dict_path: str) -> None:
    import torch.distributed as dist
    from datetime import timedelta
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", rank=rank, world_size=2,
                            timeout=timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    try:
        batch = _features(_host_batches(train_data, dict_path, 4), dev,
                          FrontendConfig())
        out = {}
        for name, (layout, dp, n, overrides) in TWO_RANK_CASES.items():
            ref = _flagship("float32", 0.0, **overrides).to(dev)
            par = copy.deepcopy(ref)
            if layout == "mesh":
                mesh, loss_fn = mesh_lib.make_mesh(dp, n), None
            else:
                mesh = mesh_lib.make_pipe_mesh(dp, n)
            mesh_lib.apply_mesh(par, mesh)
            if layout != "mesh":
                loss_fn = make_pp_loss_fn(par, mesh, PP_MICRO,
                                          layout == "pipe_tail")
            b = _even_time(batch) if name == "sp_tp2" else batch
            case = _case_step(par, mesh, loss_fn, b)
            full = mesh_lib.full_state_dict(par, mesh)
            ranks = [None, None]
            dist.all_gather_object(ranks, {k: case[k] for k in (
                "launches", "k3_inputs", "param_bytes")})
            if rank:
                continue
            res = _hold_to_one_rank(ref, b, case["metrics"], full)
            res.update(step_wall_s=case["step_wall_s"], ranks=ranks,
                       sharded=sum(hasattr(p, "tp_dim")
                                   for p in par.parameters()),
                       whole_param_bytes=sum(
                           p.numel() * p.element_size()
                           for p in ref.parameters()))
            if name in NEW_DIST_CASES:
                total = Counter()
                for r in ranks:
                    total.update(r["launches"])
                res["launches"] = dict(total)
                res["ok"] &= all(total[k] > 0 for k in (
                    "depthwise_conv1d", "depthwise_conv1d_dgrad",
                    "depthwise_conv1d_wgrad")) and (
                    total["ctc_dp_shared"] + total["ctc_dp_global"] > 0)
            if layout != "mesh":
                res["ok"] &= all(r["param_bytes"] < res["whole_param_bytes"]
                                 for r in ranks)
            if name == "sp_tp2":
                t_sub = ((b["features"].shape[1] - 1) // 2 - 1) // 2
                mc = TRAIN_CONFIG["model_conf"]
                want = (f"{[4, t_sub // 2 + mc['cnn_module_kernel'] - 1,
                            mc['d_model']]} float32")
                res["t_sub"] = t_sub
                res["ok"] &= all(r["k3_inputs"] == [want] for r in ranks)
            out[name] = res
        if rank == 0:
            with open(os.path.join(work, "dist_two_ranks.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- finetune

# examples/asrucs2019/conf/train_conformer.yaml's model_conf with the
# adapters on (run.sh stage 2), bf16; speed perturbation offline and
# online and wav dither, max_length 3000 so that the 19.5 s wavs,
# stretched to 21.7 s at speed 0.9, stay in (and run K2)
FINETUNE_CONFIG = repo_config("examples/asrucs2019/conf/train_conformer.yaml",
                              max_epoch=1, log_interval=1, warmup_steps=4,
                              seed=SEED)
FINETUNE_CONFIG["model_conf"].update(encoder_use_adapter=True,
                                     decoder_use_adapter=True)
FINETUNE_CONFIG["collate_conf"]["feature_extraction_conf"].update(
    speed_perturb_rate=0.5, wav_dither=1.0)
FINETUNE_CONFIG["dataset_conf"].update(speed_perturb=True, max_length=3000)
ADAPTER_KEYS = {k: FINETUNE_CONFIG["model_conf"][k] for k in (
    "encoder_use_adapter", "decoder_use_adapter", "down_size", "scalar")}
# a WeNet release's train.yaml (u2 Conformer, bitransformer decoder) at
# the flagship's widths, written as YAML text (yaml_text)
WENET_YAML = {
    "encoder": "conformer",
    "encoder_conf": {"output_size": 256, "attention_heads": 4,
                     "linear_units": 1024, "num_blocks": 12,
                     "cnn_module_kernel": 15, "dropout_rate": 0.1,
                     "positional_dropout_rate": 0.1,
                     "input_layer": "conv2d", "pos_enc_layer_type": "rel_pos",
                     "activation_type": "swish", "use_cnn_module": True,
                     "macaron_style": True, "normalize_before": True},
    "decoder": "bitransformer",
    "decoder_conf": {"attention_heads": 4, "linear_units": 1024,
                     "num_blocks": 3, "r_num_blocks": 3},
    "model_conf": {"ctc_weight": 0.3, "lsm_weight": 0.1,
                   "reverse_weight": 0.3, "length_normalized_loss": False},
    "dataset_conf": {"fbank_conf": {"num_mel_bins": 80}},
    "input_dim": 80, "output_dim": VOCAB}


def wenet_names(state: dict) -> dict:
    """The port's state_dict under WeNet's names and layouts (the inverse
    of openeat_torch/utils/wenet_convert.py): conv2d x4 as conv.0/conv.2,
    the post-subsampling projection's input in torch's (C, F) order,
    blocks numbered, pointwise convs [out, in, 1], depthwise [C, 1, K],
    embeddings as embed.0."""
    out = {}
    for k, v in state.items():
        v = v.clone()
        if k.startswith("encoder.embed.Conv_"):
            i = int(k[len("encoder.embed.Conv_")])
            k = f"encoder.embed.conv.{2 * i}{k[len('encoder.embed.Conv_0'):]}"
        elif k == "encoder.embed.Dense_0.weight":
            d, fc = v.shape
            v = v.reshape(d, fc // d, d).transpose(1, 2).reshape(d, fc)
            k = "encoder.embed.out.0.weight"
        elif k == "encoder.embed.Dense_0.bias":
            k = "encoder.embed.out.0.bias"
        elif k.startswith("encoder.encoders.after_norm."):
            k = k.replace("encoder.encoders.", "encoder.")
        if "pointwise_conv" in k and k.endswith(".weight"):
            v = v[..., None]
        if "depthwise_conv.weight" in k:
            v = v.t()[:, None, :]
        k = k.replace(".layer_", ".").replace("embed.weight",
                                              "embed.0.weight")
        out[k] = v.contiguous()
    return out


def yaml_text(cfg: dict, indent: int = 0) -> str:
    """A config of nested dicts, lists and scalars as block YAML text (the
    card machine has no PyYAML to dump it)."""
    def scalar(v) -> str:
        if isinstance(v, bool):
            return "true" if v else "false"
        if v is None:
            return "null"
        if isinstance(v, list):
            return "[" + ", ".join(scalar(x) for x in v) + "]"
        return str(v)
    pad = " " * indent
    return "".join(f"{pad}{k}:\n" + yaml_text(v, indent + 2)
                   if isinstance(v, dict) else f"{pad}{k}: {scalar(v)}\n"
                   for k, v in cfg.items())


CMVN_TOOL_RTOL = 1e-5   # the tool's float32 batch sums against float64


def cmvn_stats(manifest: str, dict_path: str) -> tuple:
    """Global CMVN statistics of the manifest's wavs (fbank on the card
    over their valid frames, float64 sums): (mean_stat, var_stat,
    frame_num), the reference that openeat_torch.tools.compute_cmvn is
    held against."""
    dev = torch.device("cuda")
    ds = AudioDataset(manifest, load_dict(dict_path), batch_size=8)
    total = torch.zeros((2, 80), dtype=torch.float64, device=dev)
    frames = 0
    for i in range(len(ds)):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in AudioCollate()(ds[i])[1].items()}
        feats, flens = fbank_mod.fbank(b["wav"], b["wav_lens"])
        valid = torch.arange(feats.shape[1], device=dev)[None] \
            < flens[:, None]
        f = feats[valid].double()
        total += torch.stack([f.sum(0), f.square().sum(0)])
        frames += int(valid.sum())
    mean_stat, var_stat = total.cpu().numpy()
    return mean_stat, var_stat, frames


def write_cmvn_stats(manifest: str, dict_path: str) -> tuple[str, str, dict]:
    """Global CMVN statistics from openeat_torch.tools.compute_cmvn on
    cuda, held against cmvn_stats (frame counts equal, per-frame mean and
    variance within CMVN_TOOL_RTOL), as its WeNet JSON file and as a
    kaldi text file of the same numbers; returns both paths and the
    comparison."""
    ref_mean, ref_var, ref_frames = cmvn_stats(manifest, dict_path)
    json_path = os.path.join(WORK, "global_cmvn.json")
    compute_cmvn_tool.main([manifest, json_path, "--device", "cuda"])
    with open(json_path) as f:
        stats = json.load(f)
    mean_stat = np.asarray(stats["mean_stat"])
    var_stat = np.asarray(stats["var_stat"])
    frames = stats["frame_num"]
    check = {"frame_num": frames, "reference_frame_num": ref_frames,
             "mean_max_rel_err": float(np.abs(mean_stat - ref_mean).max()
                                       / np.abs(ref_mean).max()),
             "var_max_rel_err": float(np.abs(var_stat - ref_var).max()
                                      / np.abs(ref_var).max())}
    if frames != ref_frames or max(check["mean_max_rel_err"],
                                   check["var_max_rel_err"]) \
            > CMVN_TOOL_RTOL:
        raise AssertionError(f"compute_cmvn on cuda against the phase's own "
                             f"statistics: {check}")
    kaldi_path = os.path.join(WORK, "cmvn.ark.txt")
    with open(kaldi_path, "w") as f:
        f.write(" [\n  " + " ".join(repr(float(x)) for x in mean_stat)
                + f" {frames}\n  "
                + " ".join(repr(float(x)) for x in var_stat) + " 0 ]\n")
    return json_path, kaldi_path, check


def _train_records(exp: str) -> list:
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train"]


def _trace_names(profile_dir: str) -> set:
    names = set()
    for name in os.listdir(profile_dir):
        with open(os.path.join(profile_dir, name)) as f:
            names |= {e.get("name", "") for e in json.load(f)["traceEvents"]}
    return names


def adapter_step_seconds(manifest: str, dict_path: str,
                         n_steps: int = 6) -> dict:
    """Seconds of a train step of the adapter model, bf16, dropout 0.1,
    on one 8-utterance batch: every parameter trained against
    --only_adapter (the whole backward either way: every gradient is
    taken and counted in the clip norm; Adam updates the adapters
    only). Host clock around synchronized steps, the first of each left
    out, median; full, adapter, adapter, full, each half the steps."""
    dev = torch.device("cuda")
    batch = _features(_host_batches(manifest, dict_path, 8), dev,
                      FrontendConfig())
    runs = {}
    for only in (False, True, True, False):
        model = _flagship("bfloat16", 0.1, **ADAPTER_KEYS).to(dev)
        opt, schedule = build_optimizer(model, 1e-3, 4, only_adapter=only)
        state, step = TrainState(model, opt), build_train_step(schedule)
        gen = make_generator(SEED, dev)
        times = []
        for _ in range(n_steps // 2 + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        runs.setdefault("adapter" if only else "full", []).extend(times[1:])
    out = {f"{k}_step_s": statistics.median(v) for k, v in runs.items()}
    out["adapter_over_full"] = out["adapter_step_s"] / out["full_step_s"]
    out["batch_shape"] = list(batch["features"].shape)
    return out


def finetune(manifest: str, dict_path: str, train_data: str,
             cv_data: str) -> dict:
    """The WeNet pre-trained fine-tuning path through the entry points:
    convert_wenet of a WeNet-layout final.pt and train.yaml, recognize in
    the four modes from the converted checkpoint and the WeNet config,
    train --only_adapter --profile_dir from it, and a from-scratch
    train --cmvn_file. Every check raises."""
    out = {}
    wdir = os.path.join(WORK, "wenet")
    os.makedirs(wdir)
    json_cmvn, kaldi_cmvn, out["cmvn_tool"] = write_cmvn_stats(train_data,
                                                               dict_path)
    mean, istd = load_cmvn(json_cmvn, True)
    port = random_model_state(torch.Generator().manual_seed(SEED + 11))
    port["encoder.global_cmvn.mean"] = torch.from_numpy(mean)
    port["encoder.global_cmvn.istd"] = torch.from_numpy(istd)
    torch.save(wenet_names(port), os.path.join(wdir, "final.pt"))
    wenet_cfg = os.path.join(wdir, "train.yaml")
    with open(wenet_cfg, "w") as f:
        f.write(yaml_text(WENET_YAML))
    if load_config(wenet_cfg) != WENET_YAML:
        raise AssertionError("the WeNet train.yaml does not read back")

    # 1. convert, then decode the converted checkpoint in four modes
    t0 = time.perf_counter()
    ckpt = convert_wenet.main(["--pt", os.path.join(wdir, "final.pt"),
                               "--d_model", "256", "--out",
                               os.path.join(wdir, "converted"),
                               "--wenet_config", wenet_cfg])
    out["convert_s"] = time.perf_counter() - t0
    converted = torch.load(ckpt, weights_only=True)
    if set(converted) != set(port) or any(
            not torch.equal(converted[k], v) for k, v in port.items()):
        raise AssertionError("convert_wenet did not give back the model "
                             "the WeNet checkpoint was written from")
    with open(manifest, encoding="utf-8") as f:
        lines = f.readlines()[:BATCH]
    eight = os.path.join(wdir, "decode8.data")
    with open(eight, "w", encoding="utf-8") as f:
        f.writelines(lines)
    decodes = []
    for mode in MODES:
        hyps, wall, launches, _ = run_recognize(wenet_cfg, ckpt, eight,
                                                dict_path, mode,
                                                f"wenet_{mode}")
        if len(hyps) != BATCH or launches != 12:
            raise AssertionError(f"wenet {mode}: {len(hyps)} keys written, "
                                 f"K3 launched {launches} times")
        decodes.append({"mode": mode, "wall_s": wall, "k3_launches": launches,
                        "nonempty_hyps": sum(bool(v) for v in hyps.values())})
    out["decodes"] = decodes
    cfg = convert_wenet_config(WENET_YAML)
    cfg["model_conf"]["compute_dtype"] = "float32"
    models = {d: recognize.load_model(cfg, ckpt, VOCAB, torch.device(d))
              for d in ("cuda", "cpu")}
    for m in models.values():
        got = m.encoder.global_cmvn
        if not (np.array_equal(got.mean.detach().cpu().numpy(), mean)
                and np.array_equal(got.istd.detach().cpu().numpy(), istd)):
            raise AssertionError("the decoded model's CMVN statistics are "
                                 "not the written ones")
    fe = FrontendConfig.from_collate_conf(cfg["collate_conf"])
    if fe.normalization:
        raise AssertionError("a WeNet config must decode raw fbank")
    feeder = DeviceFeeder(PrefetchLoader(AudioDataset(
        eight, load_dict(dict_path), batch_size=BATCH), AudioCollate()),
        fe, torch.device("cuda"), BATCH)
    feats = next(iter(feeder))[1]
    with torch.inference_mode():
        g_enc, g_lens = models["cuda"].encode(feats["features"],
                                              feats["features_length"])
        c_enc, _ = models["cpu"].encode(feats["features"].cpu(),
                                        feats["features_length"].cpu())
    valid = torch.arange(c_enc.shape[1])[None] < g_lens.cpu()[:, None]
    out["encoder_max_abs_err"] = float((g_enc.cpu() - c_enc).abs()[valid]
                                       .max())
    if not torch.isfinite(g_enc).all() \
            or out["encoder_max_abs_err"] > ENC_TOL:
        raise AssertionError(f"converted model GPU vs CPU: {out}")

    # 2. fine-tune the adapters from the converted checkpoint
    cfg_path = os.path.join(wdir, "finetune.json")
    with open(cfg_path, "w") as f:
        json.dump(FINETUNE_CONFIG, f)
    exp, prof = os.path.join(wdir, "exp"), os.path.join(wdir, "prof")
    common = ["--train_data", train_data, "--cv_data", cv_data, "--dict",
              dict_path, "--device", "cuda", "--num_workers", "4"]
    _reset_counts()
    t0 = time.perf_counter()
    state = train_cli.main(["--config", cfg_path, "--exp_dir", exp,
                            "--checkpoint", ckpt, "--only_adapter",
                            "--profile_dir", prof, *common])
    torch.cuda.synchronize()
    out["train_wall_s"] = time.perf_counter() - t0
    counts = out["launches"] = _counts()
    n_cv = len(AudioDataset(cv_data, load_dict(dict_path),
                            batch_type="dynamic", max_frames_in_batch=10000))
    steps = state.step + 4          # the 4 warm-up steps of --profile_dir
    want = {"depthwise_conv1d": 12 * (steps + n_cv),
            "depthwise_conv1d_dgrad": 12 * steps,
            "depthwise_conv1d_wgrad": 12 * steps}
    n_ctc = counts["ctc_dp_shared"] + counts["ctc_dp_global"]
    if any(counts[k] != v for k, v in want.items()) \
            or n_ctc != steps + n_cv or not counts["ctc_dp_global"]:
        raise AssertionError(f"fine-tune launches {counts}: expected {want} "
                             f"and {steps + n_cv} CTC with K2")
    losses = [r["loss"] for r in _train_records(exp)]
    out["step_losses"] = losses
    if len(losses) != state.step or not all(map(math.isfinite, losses)):
        raise AssertionError(f"fine-tune losses {losses}")
    tuned = torch.load(os.path.join(exp, "epoch_1.pt"), weights_only=True)
    init = _flagship("bfloat16", 0.1, **ADAPTER_KEYS).state_dict()
    frozen = [k for k in tuned if "adapter" not in k]
    adapters = [k for k in tuned if "adapter" in k]
    if set(frozen) != set(converted) or any(
            not torch.equal(tuned[k], converted[k]) for k in frozen):
        raise AssertionError("--only_adapter changed a frozen tensor")
    # 12 encoder and 3 + 3 decoder blocks, 6 tensors an adapter
    if len(adapters) != 18 * 6 or any(torch.equal(tuned[k], init[k])
                                      for k in adapters):
        raise AssertionError("an adapter tensor did not train")
    resolved = json.load(open(os.path.join(exp, "train.json")))
    if resolved["use_global_cmvn"] is not True \
            or resolved["collate_conf"]["normalization"] is not False:
        raise AssertionError(f"train.json: {resolved['use_global_cmvn']}, "
                             f"{resolved['collate_conf']}")
    # the wrappers' regions (named after their C entry points) and the
    # device kernels, whose names the trace demangles
    names = _trace_names(prof)
    traced = sorted(n for n in names if "dwconv1d" in n or "ctc_dp" in n)
    out["trace_names"] = traced
    if not {"openeat_dwconv1d_fwd", "openeat_dwconv1d_dgrad",
            "openeat_dwconv1d_wgrad"} <= names or not all(
            any(k in n for n in traced) for k in (
                "dwconv1d_kernel<", "dwconv1d_wgrad_kernel<", "ctc_dp_")):
        raise AssertionError(f"the --profile_dir trace names {traced}")
    out["n_steps"], out["n_cv_batches"] = state.step, n_cv
    out["frozen_tensors"], out["adapter_tensors"] = len(frozen), len(adapters)
    out.update(adapter_step_seconds(train_data, dict_path))

    # 3. from scratch with --cmvn_file (kaldi text): 8 epochs of one
    # 8-utterance batch
    small = os.path.join(wdir, "small.data")
    with open(train_data, encoding="utf-8") as f:
        lines = f.readlines()[:8]
    with open(small, "w", encoding="utf-8") as f:
        f.writelines(lines)
    scratch_cfg = dict(TRAIN_CONFIG, max_epoch=8, warmup_steps=2,
                       optim_conf={"lr": 0.002},
                       model_conf=dict(TRAIN_CONFIG["model_conf"],
                                       dropout_rate=0.0),
                       collate_conf=dict(TRAIN_CONFIG["collate_conf"],
                                         spec_aug=False))
    cfg_path = os.path.join(wdir, "scratch.json")
    with open(cfg_path, "w") as f:
        json.dump(scratch_cfg, f)
    exp = os.path.join(wdir, "exp_cmvn")
    state = train_cli.main(["--config", cfg_path, "--exp_dir", exp,
                            "--cmvn_file", kaldi_cmvn, "--is_json_cmvn",
                            "false", "--train_data", small, "--cv_data",
                            cv_data, "--dict", dict_path, "--device", "cuda",
                            "--num_workers", "4",
                            "--save_optimizer", "false"])
    losses = [r["loss"] for r in _train_records(exp)]
    out["cmvn_file_losses"] = losses
    if state.step != 8 or not losses[-1] < losses[0]:
        raise AssertionError(f"--cmvn_file run: {state.step} steps, "
                             f"losses {losses}")
    k_mean, k_istd = load_cmvn(kaldi_cmvn, False)
    last = torch.load(os.path.join(exp, "epoch_8.pt"), weights_only=True)
    if not (np.array_equal(last["encoder.global_cmvn.mean"].numpy(), k_mean)
            and np.array_equal(last["encoder.global_cmvn.istd"].numpy(),
                               k_istd)):
        raise AssertionError("the --cmvn_file model's statistics are not "
                             "the file's")
    out["cmvn_json_vs_kaldi_max_abs"] = float(np.abs(k_mean - mean).max())
    return out


# --------------------------------------------------------- librispeech

# examples/librispeech/conf/train_conformer.yaml, cut to 3 epochs of the
# phase's corpus (12 optimizer steps), with a loss record every step
LS_TRAIN_CONFIG = repo_config("examples/librispeech/conf/train_conformer.yaml",
                              max_epoch=3, log_interval=1, seed=SEED)
LS_BPE_SIZE = 1000
LS_N_TEXT = 3000            # the train set's transcripts: BPE's input
LS_TRAIN_SECONDS = [(3.0, 16.0)] * 32 + [(24.0, 28.0)] * 4
LS_CV_SECONDS = [(3.0, 8.0)] * 4
LS_WORDS_PER_S = 2.7
LS_INPUT_LAYERS = [("conv2d6", "rel_pos"), ("conv2d8", "rel_pos"),
                   ("linear", "rel_pos"), ("conv2d", "no_pos")]
# ctc_impl parallel in float32 against F.ctc_loss in float64: the loss's
# rtol, and the gradient's bound as a share of max |grad|. Its log values
# reach |log p| of about 5000 at T' 723, where a float32 ulp is 4.9e-4,
# so the posteriors (and the gradient) carry about 1e-4 of max |grad| of
# rounding (1.4e-5 to 1.0e-4 on the CPU at T 300-723, S 65-385)
CTC_PARALLEL_TOL = (1e-6, 1e-3)


class ReadTrace:
    """Counts the files the native reader decodes and the Python
    decoder's reads (openeat_torch/dataset/audio.py:read_audio)."""

    def __init__(self):
        self.native = self.python = 0
        self._native, self._python = native_io.read_wav_batch, \
            audio_lib.read_audio

    def __enter__(self):
        def native(paths, *a, **k):
            self.native += len(paths)
            return self._native(paths, *a, **k)

        def python(*a, **k):
            self.python += 1
            return self._python(*a, **k)
        native_io.read_wav_batch, audio_lib.read_audio = native, python
        return self

    def __exit__(self, *exc):
        native_io.read_wav_batch = self._native
        audio_lib.read_audio = self._python


def english_lexicon(rng: np.random.Generator, n: int = 3000) -> list[str]:
    """Pseudo-words of 2-10 letters, one in twenty with an apostrophe."""
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    words: list[str] = []
    seen = set()
    while len(words) < n:
        w = "".join(rng.choice(letters, int(rng.integers(2, 11))))
        if rng.random() < 0.05:
            w = w[:-1] + "'" + w[-1]
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


# The FLAC jobs' worker: the port's codec alone (numpy only), so that a
# worker starts in about half a second where a spawned copy of this
# script would import torch. "encode" writes each path from its .src.npy
# samples; "decode" reads each path with the Python decoder (the
# collate's read_audio for a FLAC file) into its .dec.npy.
FLAC_WORKER = """
import sys
import numpy as np
from openeat_torch.dataset.flac import read_flac, write_flac
for path in sys.argv[2:]:
    if sys.argv[1] == "encode":
        write_flac(path, np.load(path + ".src.npy"), 16000)
    else:
        np.save(path + ".dec.npy", read_flac(path)[0])
"""


def flac_jobs(op: str, paths: list[str], workers: int = 8) -> None:
    """FLAC_WORKER's `op` over `paths` in `workers` processes at once."""
    procs = [subprocess.Popen([sys.executable, "-c", FLAC_WORKER, op,
                               *paths[i::workers]], cwd=REPO)
             for i in range(min(workers, len(paths)))]
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise AssertionError(f"FLAC {op} workers exited {rcs}")


def write_librispeech_corpus(rng: np.random.Generator) -> dict:
    """A seeded English corpus in LibriSpeech's layout: LS_N_TEXT train
    transcripts over a Zipf lexicon (about LS_WORDS_PER_S words a
    second), 16-bit mono 16 kHz FLAC (the port's encoder, 8 processes) for
    the first len(LS_TRAIN_SECONDS) of them and a cv set, one wav.scp
    entry a `path,start,end` segment."""
    root = os.path.join(WORK, "librispeech")
    os.makedirs(root)
    lexicon = english_lexicon(rng)
    zipf = 1.0 / np.arange(1, len(lexicon) + 1)
    zipf /= zipf.sum()

    def sentence(seconds: float) -> str:
        n = max(2, int(round(LS_WORDS_PER_S * seconds)))
        return " ".join(lexicon[i] for i in rng.choice(len(lexicon), n,
                                                       p=zipf))

    out = {"root": root, "audio_s": {}}
    jobs = []
    for split, ranges in (("train", LS_TRAIN_SECONDS), ("cv", LS_CV_SECONDS)):
        lines, texts = [], []
        for i, (lo, hi) in enumerate(ranges):
            dur = float(np.round(rng.uniform(lo, hi), 3))
            t = np.arange(int(dur * 16000)) / 16000.0
            x = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 3000) * t)
                    for _ in range(3)) + 0.02 * rng.standard_normal(t.size)
            key = f"{split}{i:03d}"
            path = os.path.join(root, key + ".flac")
            np.save(path + ".src.npy", x.astype(np.float32))
            jobs.append((path, x.size))
            text = sentence(dur)
            entry = path
            if split == "train" and i == 0:     # a segment entry
                entry, dur = f"{path},0.250,{dur - 0.25:.3f}", dur - 0.5
            lines.append(f"utt:{key}\tfeat:{entry}\tfeat_shape:{dur:.3f}\t"
                         f"text:{text}\n")
            texts.append(f"{key} {text}\n")
            out["audio_s"][split] = out["audio_s"].get(split, 0.0) + dur
        if split == "train":
            texts += [f"text{i:05d} {sentence(rng.uniform(3.0, 16.0))}\n"
                      for i in range(LS_N_TEXT - len(ranges))]
        for name, rows in (("format.data", lines), ("text", texts)):
            with open(os.path.join(root, f"{split}.{name}"), "w",
                      encoding="utf-8") as f:
                f.writelines(rows)
        out[split] = os.path.join(root, f"{split}.format.data")
    t0 = time.perf_counter()
    flac_jobs("encode", [p for p, _ in jobs])
    out["flac_encode_s"] = time.perf_counter() - t0
    out["flac_paths"] = [p for p, _ in jobs]
    out["flac_audio_s"] = sum(n for _, n in jobs) / 16000.0
    out["text"] = os.path.join(root, "train.text")
    return out


def librispeech_dict(corpus: dict) -> tuple[str, str, int]:
    """Stage 1: openeat_torch.bin.train_bpe on the train text at
    LS_BPE_SIZE, then the dict from the port's tokenize (<blank>, <unk>,
    the sorted pieces, <sos/eos>). Returns (bpe model, dict, vocab)."""
    prefix = os.path.join(corpus["root"], f"bpe_{LS_BPE_SIZE}")
    bpe_path = train_bpe.main(["--input", corpus["text"], "--skip_ncols",
                               "1", "--model_prefix", prefix, "--vocab_size",
                               str(LS_BPE_SIZE)])
    model = load_bpe(bpe_path)
    # the trainer stops at vocab_size symbols + merges, or earlier when no
    # pair occurs twice: the corpus must be large enough for the former
    if len(model.vocab) + len(model.merges) < LS_BPE_SIZE:
        raise AssertionError(f"BPE stopped at {len(model.vocab)} symbols "
                             f"and {len(model.merges)} merges")
    pieces = set()
    with open(corpus["text"], encoding="utf-8") as f:
        for line in f:
            pieces.update(tokenize(remove_punctuation(
                line.rstrip("\n").split(" ", 1)[1]), model))
    vocab = ["<blank>", "<unk>"] + sorted(pieces) + ["<sos/eos>"]
    dict_path = os.path.join(corpus["root"], "dict.txt")
    with open(dict_path, "w", encoding="utf-8") as f:
        f.writelines(f"{tok} {i}\n" for i, tok in enumerate(vocab))
    return bpe_path, dict_path, len(vocab)


def check_native_reads(corpus: dict) -> dict:
    """Every FLAC file read by the native library and by the port's
    Python decoder (flac_jobs): the same samples; the seconds each takes
    per second of audio (8 threads against 8 processes)."""
    paths = corpus["flac_paths"]
    if not native_io.available():       # builds the library at first use
        raise AssertionError(f"the native reader did not build: "
                             f"{native_io.build_error}")
    t0 = time.perf_counter()
    cap = int(30 * 16000)
    wav, lens, rates = native_io.read_wav_batch(paths, [None] * len(paths),
                                                [None] * len(paths), cap, 8)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flac_jobs("decode", paths)
    python = [np.load(p + ".dec.npy") for p in paths]
    python_s = time.perf_counter() - t0
    for i, ref in enumerate(python):
        if rates[i] != 16000 or lens[i] != len(ref) \
                or not np.array_equal(wav[i, :lens[i]], ref):
            raise AssertionError(f"native and Python FLAC decodes differ: "
                                 f"{paths[i]}")
    audio_s = corpus["flac_audio_s"]
    return {"files": len(paths), "audio_s": audio_s,
            "native_s_per_audio_s": native_s / audio_s,
            "python_s_per_audio_s": python_s / audio_s,
            "encode_s_per_audio_s": corpus["flac_encode_s"] / audio_s}


def ls_train_counts(steps: int, cv_batches: int, accum: int,
                    blocks: int) -> dict:
    """Launches of a bin.train run of a `blocks`-block encoder with
    `steps` optimizer steps of `accum` micro-batches each and
    `cv_batches` cv batches in all."""
    micro = accum * steps
    return {"depthwise_conv1d": blocks * (micro + cv_batches),
            "depthwise_conv1d_dgrad": blocks * micro,
            "depthwise_conv1d_wgrad": blocks * micro,
            "ctc": micro + cv_batches}


def _feature_batch(manifest: str, dict_path: str, bpe_path: str,
                   n: int, dev: str) -> dict:
    ds = AudioDataset(manifest, load_dict(dict_path), load_bpe(bpe_path),
                      batch_size=n, max_length=1e9)
    host = AudioCollate()(ds[0])[1]
    return _features(host, torch.device(dev), FrontendConfig())


def encoder_gpu_vs_cpu(conf: dict, state: dict, vocab: int,
                       batch: dict) -> float:
    """The float32 encoder of `conf` with weights `state` on the card
    against the CPU's on `batch`: the largest difference over valid
    frames."""
    models = {}
    for dev in ("cuda", "cpu"):
        m = build_asr_model(dict(conf, compute_dtype="float32"), 80, vocab)
        m.load_state_dict(state)
        models[dev] = m.to(dev).eval()
    with torch.inference_mode():
        g, g_lens = models["cuda"].encode(batch["features"].cuda(),
                                          batch["features_length"].cuda())
        c, c_lens = models["cpu"].encode(batch["features"].cpu(),
                                         batch["features_length"].cpu())
    if not torch.isfinite(g).all() or not torch.equal(g_lens.cpu(), c_lens):
        raise AssertionError("card encoder output not finite, or lengths "
                             "differ from the CPU's")
    valid = torch.arange(c.shape[1])[None] < c_lens[:, None]
    return float((g.cpu() - c).abs()[valid].max())


def ctc_parallel_checks(shapes: list[tuple], vocab: int, gen) -> list:
    """ctc_impl parallel (openeat_torch/ops/ctc_parallel.py) on the card,
    float32, at each (B, T, S) the training run gave the CTC kernels:
    seeded random logits and labels; the feasible rows' losses and the
    gradient of their sum against F.ctc_loss in float64 on the same
    inputs, within CTC_PARALLEL_TOL (the loss relative, the gradient as
    a share of the largest |grad|). The port's K1/K2 op on the same
    rows, against the same reference, and the seconds of each (forward
    and backward) are reported beside it."""
    dev = torch.device("cuda")
    rows = []
    for b, t, s in shapes:
        l = (s - 1) // 2
        logits = torch.randn((b, t, vocab), generator=gen, device=dev)
        labels = torch.randint(1, vocab, (b, max(l, 1)), generator=gen,
                               device=dev)
        il = torch.randint(max(t // 2, 1), t + 1, (b,), generator=gen,
                           device=dev)
        ll = torch.randint(max(l // 2, 1), max(l, 1) + 1, (b,),
                           generator=gen, device=dev)
        il[0], ll[0] = t, max(l, 1)
        tpad = (torch.arange(t, device=dev)[None] >= il[:, None]).float()
        lpad = (torch.arange(labels.shape[1], device=dev)[None]
                >= ll[:, None]).float()
        ok = il >= 2 * ll + 1        # feasible with any repeats
        got_x = logits.clone().requires_grad_()
        op_x = logits.clone().requires_grad_()
        ref_x = logits.double().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ctc_loss_parallel(got_x, tpad, labels, lpad)
        got[ok].sum().backward()
        torch.cuda.synchronize()
        par_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        op = ctc.ctc_loss(torch.log_softmax(op_x, dim=-1), il, labels, ll)
        op[ok].sum().backward()
        torch.cuda.synchronize()
        op_s = time.perf_counter() - t0
        ref = F.ctc_loss(torch.log_softmax(ref_x, dim=-1).transpose(0, 1),
                         labels, il, ll, blank=0, reduction="none",
                         zero_infinity=True)
        ref[ok].sum().backward()
        g_max = float(ref_x.grad.abs().max())

        def errs(loss, x):
            return (float(((loss.double() - ref).abs() / ref.abs())
                          .detach()[ok].max()),
                    float((x.grad.double() - ref_x.grad).abs().max())
                    / g_max)
        row = {"shape": [b, t, s], "rows_checked": int(ok.sum())}
        row["loss_max_rel_err"], row["grad_max_abs_err_over_max"] = \
            errs(got, got_x)
        row["k1_k2_loss_max_rel_err"], row["k1_k2_grad_err_over_max"] = \
            errs(op, op_x)
        row.update(parallel_s=par_s, k1_k2_op_s=op_s)
        if not ok.any() or row["loss_max_rel_err"] > CTC_PARALLEL_TOL[0] \
                or row["grad_max_abs_err_over_max"] > CTC_PARALLEL_TOL[1]:
            raise AssertionError(f"ctc_impl parallel vs float64: {row}")
        rows.append(row)
    return rows


def input_layer_checks(batch: dict, vocab: int) -> list:
    """Each other input layer (and no_pos) in the LibriSpeech model at 2
    blocks: one bf16 train step (dropout 0.1, the batch's features)
    with a finite loss, then its float32 encoder on the card within
    ENC_TOL of the CPU's."""
    dev = torch.device("cuda")
    rows = []
    for layer, pos in LS_INPUT_LAYERS:
        conf = dict(LS_TRAIN_CONFIG["model_conf"], encoder_num_blocks=2,
                    input_layer=layer, pos_enc_layer_type=pos)
        model = build_asr_model(conf, 80, vocab)
        init_parameters(model, make_generator(SEED))
        model.to(dev).train()
        opt, schedule = build_optimizer(model, 1e-3, 4)
        state = TrainState(model, opt)
        metrics = build_train_step(schedule, 1, 5.0)(
            state, batch, make_generator(SEED, dev))
        loss = float(metrics["loss"])
        err = encoder_gpu_vs_cpu(conf, {k: v.cpu() for k, v in
                                        model.state_dict().items()},
                                 vocab, batch)
        row = {"input_layer": layer, "pos_enc": pos, "bf16_loss": loss,
               "subsampling_rate": model.encoder.embed.subsampling_rate,
               "encoder_max_abs_err": err}
        if not math.isfinite(loss) or err > ENC_TOL:
            raise AssertionError(f"input layer check: {row}")
        rows.append(row)
    return rows


def kaldi_checks(ckpt_cfg: str, ckpt: str, manifest: str, dict_path: str,
                 bpe_path: str, root: str) -> dict:
    """Kaldi ark input through the entry points: the raw fbank of
    `manifest`'s utterances (the card's frontend) written as a plain
    (FM) and a compressed (CM) ark; 2 train steps of the LibriSpeech
    config on the compressed ark from scratch (--data_type kaldi, 2
    epochs of one batch); recognize --data_type kaldi of the plain ark
    from `ckpt`, whose tokens must equal a decode of the same features
    passed in memory."""
    dev = torch.device("cuda")
    char_dict, bpe = load_dict(dict_path), load_bpe(bpe_path)
    ds = AudioDataset(manifest, char_dict, bpe, batch_size=64,
                      max_length=1e9)
    keys, host = AudioCollate()(ds[0])
    b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    feats, flens = compute_features(b["wav"], b["wav_lens"],
                                    FrontendConfig(normalization=False))
    mats = {k: feats[i, :int(flens[i])].cpu().numpy()
            for i, k in enumerate(keys)}
    texts = manifest_texts(manifest)
    arks = {}
    for kind, writer in (("fm", kaldi_io.write_ark_entry),
                         ("cm", kaldi_io.write_compressed_ark_entry)):
        ark, lines = os.path.join(root, f"fbank_{kind}.ark"), []
        with open(ark, "wb") as f:
            for k, m in mats.items():
                off = writer(f, k, m)
                lines.append(f"utt:{k}\tfeat:{ark}:{off}\tfeat_shape:"
                             f"{m.shape[0]},{m.shape[1]}\ttext:{texts[k]}\n")
        arks[kind] = os.path.join(root, f"fbank_{kind}.data")
        with open(arks[kind], "w", encoding="utf-8") as f:
            f.writelines(lines)
    out = {"utterances": len(mats)}
    cm_err = max(float(np.abs(kaldi_io.read_mat(
        line.split("\t")[1].split(":", 1)[1]) - mats[line.split("\t")[0][4:]])
        .max()) for line in open(arks["cm"], encoding="utf-8"))
    span = max(float(m.max() - m.min()) for m in mats.values())
    out["cm_max_abs_err"], out["fbank_span"] = cm_err, span
    if cm_err > 0.05 * span:
        raise AssertionError(f"compressed ark reads {cm_err} off")
    cfg = dict(LS_TRAIN_CONFIG, max_epoch=2, warmup_epoch=1)
    cfg_path = os.path.join(root, "kaldi_train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    exp = os.path.join(root, "exp_kaldi")
    _reset_counts()
    state = train_cli.main(["--config", cfg_path, "--train_data", arks["cm"],
                            "--cv_data", arks["fm"], "--dict", dict_path,
                            "--bpe_model", bpe_path, "--exp_dir", exp,
                            "--data_type", "kaldi", "--device", "cuda",
                            "--num_workers", "2", "--save_optimizer",
                            "false"])
    out["train_launches"] = _counts()
    losses = [r["loss"] for r in _train_records(exp)]
    resolved = json.load(open(os.path.join(exp, "train.json")))
    out["train_steps"], out["train_losses"] = state.step, losses
    if state.step != 2 or len(losses) != 2 \
            or not all(map(math.isfinite, losses)) \
            or resolved["input_size"] != 80:
        raise AssertionError(f"kaldi training: {out}")
    _reset_counts()
    hyps, wall, launches, _ = run_recognize(
        ckpt_cfg, ckpt, arks["fm"], dict_path, "ctc_greedy_search",
        "kaldi", ("--bpe_model", bpe_path, "--data_type", "kaldi"))
    out["decode_launches"] = _counts()
    # the same features in memory: padded as the collate pads them
    cfg = json.load(open(ckpt_cfg))
    model = recognize.load_model(cfg, ckpt, cfg["vocab_size"], dev)
    fe = FrontendConfig.from_collate_conf(cfg["collate_conf"])
    order = sorted(mats, key=lambda k: -mats[k].shape[0])
    id2tok = {v: k for k, v in char_dict.items()}
    want = {}
    for i in range(0, len(order), BATCH):
        part = order[i:i + BATCH]
        pad, lens = pad_batch_2d([mats[k] for k in part], 0.0, 100,
                                 np.float32)
        x = torch.from_numpy(pad).to(dev)
        xl = torch.from_numpy(lens).to(dev)
        with torch.inference_mode():
            enc, enc_lens = model.encode(
                augment_features(x, xl, fe.without_augmentation()), xl)
            toks, tok_lens = ctc_greedy_search(model.ctc_log_probs(enc),
                                               enc_lens)
        for j, k in enumerate(part):
            want[k] = token_ids_to_text(toks[j][:int(tok_lens[j])].tolist(),
                                        id2tok, eos_id=model.eos)
    out["decode_wall_s"] = wall
    out["decoded_equal_in_memory"] = sum(hyps.get(k) == v
                                         for k, v in want.items())
    if hyps != want:
        raise AssertionError(f"kaldi decode differs from the in-memory "
                             f"one: {hyps} vs {want}")
    return out


def librispeech(step_ms: float) -> dict:
    """The LibriSpeech recipe (examples/librispeech/run.sh stages 1-4) on
    the card at the recipe's full width; see the module docstring, item
    16. `step_ms` is one CTC chain step's device time
    (ctc.chain_step_ms). Every check raises."""
    out = {"phase_s": {}}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        out["phase_s"][name] = now - clock[0]
        clock[0] = now

    rng = np.random.default_rng(SEED + 12)
    corpus = write_librispeech_corpus(rng)
    lap("corpus")
    bpe_path, dict_path, vocab = librispeech_dict(corpus)
    out["vocab"] = vocab
    lap("bpe_dict")
    out["native_reads"] = check_native_reads(corpus)
    lap("native_vs_python")
    root = corpus["root"]
    out["audio_s"] = corpus["audio_s"]

    # stage 2: train
    cfg_path = os.path.join(root, "train_conformer.json")
    with open(cfg_path, "w") as f:
        json.dump(LS_TRAIN_CONFIG, f)
    exp = os.path.join(root, "exp")
    dc = LS_TRAIN_CONFIG["dataset_conf"]
    char_dict, bpe = load_dict(dict_path), load_bpe(bpe_path)
    n_batches = len(AudioDataset(
        corpus["train"], char_dict, bpe, max_length=dc["max_length"],
        min_length=dc["min_length"], batch_type="dynamic",
        max_frames_in_batch=dc["max_frames_in_batch"]))
    n_cv = len(AudioDataset(corpus["cv"], char_dict, bpe,
                            batch_type="dynamic",
                            max_frames_in_batch=dc["max_frames_in_batch"]))
    epochs, accum = LS_TRAIN_CONFIG["max_epoch"], LS_TRAIN_CONFIG["accum_grad"]
    _reset_counts()
    with ReadTrace() as reads:
        t0 = time.perf_counter()
        state = train_cli.main(["--config", cfg_path, "--train_data",
                                corpus["train"], "--cv_data", corpus["cv"],
                                "--dict", dict_path, "--bpe_model", bpe_path,
                                "--exp_dir", exp, "--device", "cuda",
                                "--num_workers", "4"])
        torch.cuda.synchronize()
        out["train_wall_s"] = time.perf_counter() - t0
    counts = out["launches"] = _counts()
    # the run's launches at each shape, as each wrapper counted them
    by_shape = {fn.__name__: dict(fn.shape_launches) for fn in COUNTED}
    lap("train")
    losses = [r["loss"] for r in _train_records(exp)]
    out["step_losses"], out["steps"] = losses, state.step
    if state.step != n_batches * epochs or len(losses) != state.step \
            or not all(map(math.isfinite, losses)):
        raise AssertionError(f"LibriSpeech training: {state.step} steps "
                             f"({n_batches} batches x {epochs}), {losses}")
    want = ls_train_counts(state.step, n_cv * epochs, accum,
                           LS_TRAIN_CONFIG["model_conf"]["encoder_num_blocks"])
    n_ctc = counts["ctc_dp_shared"] + counts["ctc_dp_global"]
    if any(counts[k] != v for k, v in want.items() if k != "ctc") \
            or n_ctc != want["ctc"] or not counts["ctc_dp_global"]:
        raise AssertionError(f"LibriSpeech launches {counts}, expected "
                             f"{want} with K2")
    k1, k2 = by_shape["ctc_dp_shared"], by_shape["ctc_dp_global"]
    out["k2_max_t"] = max(t for _, t, _ in k2)
    out["k2_max_s"] = max(s for _, _, s in k2)
    out["max_s"] = max(s for _, _, s in [*k1, *k2])
    if out["k2_max_t"] <= 600 or out["max_s"] <= 128:
        raise AssertionError(f"K2 ran at T' {out['k2_max_t']}, S up to "
                             f"{out['max_s']}")
    # the collate read every waveform through the native library
    n_utts = len(AudioDataset(corpus["train"], char_dict, bpe,
                              max_length=dc["max_length"],
                              min_length=dc["min_length"]).utts)
    out["reads"] = {"native": reads.native, "python": reads.python}
    if reads.python or reads.native < epochs * (
            n_utts + len(LS_CV_SECONDS)):
        raise AssertionError(f"the collate's reads: {out['reads']}")
    # K3 at [B, T'+30, 256], K = 31; a dgrad and a wgrad for each
    # forward that autograd recorded
    k3_fwd, k3_dgrad, k3_wgrad = (by_shape[fn.__name__] for fn in COUNTED[:3])
    out["k3_shapes"] = {f"{list(key[:3])} K={key[3]} {key[4]}": n
                        for key, n in k3_fwd.items()}
    ls_conf = LS_TRAIN_CONFIG["model_conf"]
    if any(key[2:4] != (ls_conf["d_model"], ls_conf["cnn_module_kernel"])
           for key in k3_fwd) or k3_dgrad != k3_wgrad \
            or any(n > k3_fwd.get(key, 0) for key, n in k3_dgrad.items()):
        raise AssertionError(f"K3 launches by shape: {by_shape}")
    ctc_shapes = sorted({*k1, *k2})

    # stage 3 and 4: average, then recognize --bpe_model in two modes
    avg = average_model.main(["--exp_dir", exp, "--dst", "avg_3", "--num",
                              "3", "--val_best"])
    ckpt = os.path.join(exp, "avg_3.pt")
    if not os.path.exists(ckpt):
        raise AssertionError(f"average_model wrote no {ckpt} ({avg})")
    refs = {k: v.upper() for k, v in manifest_texts(corpus["cv"]).items()}
    cv_audio_s = corpus["audio_s"]["cv"]
    decodes = []
    for mode in ("ctc_greedy_search", "attention_rescoring"):
        _reset_counts()
        hyps, wall, launches, _ = run_recognize(
            os.path.join(exp, "train.json"), ckpt, corpus["cv"], dict_path,
            mode, f"ls_{mode}", ("--bpe_model", bpe_path, "--ctc_weight",
                                 "0.5"))
        if set(hyps) != set(refs) or any("▁" in h for h in hyps.values()) \
                or launches != ls_conf["encoder_num_blocks"]:
            raise AssertionError(f"LibriSpeech {mode}: {hyps}, K3 "
                                 f"{launches}")
        stats = corpus_wer(refs, hyps, char_mode=False)
        decodes.append({"mode": mode, "wall_s": wall, "rtf": wall / cv_audio_s,
                        "wer": stats.wer, "ref_words": stats.ref_len,
                        "launches": _counts()})
    out["decodes"] = decodes
    avg_state = torch.load(ckpt, weights_only=True)
    cv_batch = _feature_batch(corpus["cv"], dict_path, bpe_path,
                              len(LS_CV_SECONDS), "cuda")
    out["encoder_gpu_vs_cpu"] = encoder_gpu_vs_cpu(ls_conf, avg_state, vocab,
                                                   cv_batch)
    if out["encoder_gpu_vs_cpu"] > ENC_TOL:
        raise AssertionError(f"LibriSpeech float32 encoder, card vs CPU: "
                             f"{out['encoder_gpu_vs_cpu']}")
    lap("recipe_tail")

    # kaldi ark input, the other input layers, ctc_impl parallel
    f32_cfg = os.path.join(root, "decode_f32.json")
    with open(f32_cfg, "w") as f:
        json.dump(dict(json.load(open(os.path.join(exp, "train.json"))),
                       model_conf=dict(ls_conf, compute_dtype="float32")),
                  f)
    small = os.path.join(root, "kaldi_utts.data")
    with open(corpus["train"], encoding="utf-8") as f:
        lines = sorted(f.readlines(), key=lambda s: float(
            s.split("\t")[2].split(":", 1)[1]))[:8]
    with open(small, "w", encoding="utf-8") as f:
        f.writelines(lines)
    out["kaldi"] = kaldi_checks(f32_cfg, ckpt, small, dict_path, bpe_path,
                                root)
    lap("kaldi")
    out["input_layers"] = input_layer_checks(cv_batch, vocab)
    lap("input_layers")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    out["ctc_parallel"] = ctc_parallel_checks(ctc_shapes, vocab, gen)
    lap("ctc_parallel")

    # K1 and K2 bit for bit against the plain recursions at every
    # (B, T, S) of the training run, timed at each one's largest T x S
    # (an utterance's work); K2's plan at the run's widths
    out["ctc_global_plans"] = check_global_plan(
        sorted({s for _, _, s in ctc_shapes}))
    timed_at = {variant: max(shapes, key=lambda b_t_s: (
        b_t_s[1] * b_t_s[2], b_t_s[0]))
        for variant, shapes in (("shared", k1), ("global", k2)) if shapes}
    cases = []
    for shape in ctc_shapes:
        variant = "global" if shape in k2 else "shared"
        b, t, s = shape
        row = ctc_case(b, t, (s - 1) // 2, vocab, gen, step_ms,
                       timed=shape == timed_at[variant])
        if row["variant"] != variant:
            raise AssertionError(f"CTC at {shape}: {row['variant']}, the "
                                 f"run's {variant}")
        row["launches"] = (k2 if variant == "global" else k1)[shape]
        cases.append(row)
    out["ctc_cases"] = cases
    lap("ctc_cases")

    # K3 at K = 31: the training run's largest shape and its most
    # frequent other one, with that run's launches there
    largest = max(k3_dgrad, key=lambda key: key[0] * key[1])
    common = next((key for key, _ in Counter(k3_dgrad).most_common()
                   if key != largest), largest)
    cases = []
    for b, tp, c, k, _ in dict.fromkeys([largest, common]):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            fwd = kernel_case(b, tp, c, k, dtype, gen, exact=True)
            bwd = dwconv_grad_case(b, tp, c, k, dtype, gen)
            if bwd["dgrad_max_abs_err"] != 0.0:
                raise AssertionError(f"K3 dgrad at K = 31 not bit-equal: "
                                     f"{bwd}")
            key = (b, tp, c, k, name)
            cases.append({"shape": [b, tp, c], "dtype": name, "fwd": fwd,
                          "bwd": bwd, "launches": {
                              "fwd": k3_fwd.get(key, 0),
                              "dgrad": k3_dgrad.get(key, 0),
                              "wgrad": k3_wgrad.get(key, 0)}})
    out["k31_cases"] = cases
    lap("k31_cases")
    # the profile of one train step must name the train step's spans, the
    # K3 wrappers' regions, the K3 kernels and a CTC kernel
    # (two steps, one micro-batch each, through the weight mirror)
    _reset_mt_counts()
    names = profiled_step_names(corpus["train"], dict_path, LS_TRAIN_CONFIG,
                                bpe)
    out["mt_launches"] = _mt_counts()
    check_mt_counts(out["mt_launches"], 2, 1)
    out["trace_names"] = sorted(n for n in names
                                if "dwconv1d" in n or "ctc_dp" in n
                                or n.startswith(("openeat.", "openeat_mt")))
    if not {"openeat_dwconv1d_fwd", "openeat_dwconv1d_dgrad",
            "openeat_dwconv1d_wgrad", *STEP_SPANS, "openeat.step.mirror",
            "openeat_mt_gather", "openeat_mt_norm",
            "openeat_mt_adam"} <= names or not all(
            any(k in n for n in out["trace_names"]) for k in (
                "dwconv1d_kernel<", "dwconv1d_wgrad_kernel<", "ctc_dp_")):
        raise AssertionError(f"the profile's names {out['trace_names']}")
    lap("profiled_step")
    return out


# ------------------------------------------------------- recipe script

RECIPE_SCRIPT = "openeat_torch/examples/aishell/run.sh"
RECIPE_SPLITS = (("train", 24), ("dev", 4), ("test", 8))
# the only lines of the recipe's config that the phase rewrites
RECIPE_CUTS = {"max_epoch": 2, "warmup_epoch": 1, "log_interval": 1}
RECIPE_CHARS = 400      # the transcripts' characters: chr(0x4E00 + i)
RECIPE_AVERAGE = 2


def write_aishell_layout(rng: np.random.Generator, root: str) -> None:
    """A synthetic corpus in AIShell-1's on-disk layout under `root`:
    wav/{train,dev,test}/<spk>/<utt>.wav of 3-8 s with round(3 x s)
    characters, and one more train wav of LONG_SECONDS with LONG_TOKENS
    characters (its batch's T x S history leaves shared memory, so K2
    runs); transcript/aishell_transcript_v0.8.txt with the characters
    space-separated, as the corpus has them."""
    lines = []
    for split, n in RECIPE_SPLITS:
        durs = [float(np.round(rng.uniform(3.0, 8.0), 3)) for _ in range(n)]
        toks = [int(round(3 * d)) for d in durs]
        if split == "train":
            durs.append(LONG_SECONDS)
            toks.append(LONG_TOKENS)
        for i, (dur, n_tok) in enumerate(zip(durs, toks)):
            spk = f"S{i % 4:04d}"
            utt = f"BAC009{spk}W{split[0].upper()}{i:04d}"
            wav_dir = os.path.join(root, "wav", split, spk)
            os.makedirs(wav_dir, exist_ok=True)
            t = np.arange(int(dur * 16000)) / 16000.0
            x = sum(0.1 * np.sin(2 * np.pi * rng.uniform(80, 3000) * t)
                    for _ in range(3)) + 0.02 * rng.standard_normal(t.size)
            write_wav(os.path.join(wav_dir, f"{utt}.wav"),
                      x.astype(np.float32), 16000)
            lines.append(utt + " " + " ".join(
                chr(0x4E00 + j) for j in rng.integers(0, RECIPE_CHARS,
                                                      n_tok)) + "\n")
    os.makedirs(os.path.join(root, "transcript"))
    with open(os.path.join(root, "transcript", "aishell_transcript_v0.8.txt"),
              "w", encoding="utf-8") as f:
        f.writelines(lines)


def recipe_config_copy() -> str:
    """examples/aishell/conf/train_conformer.yaml as text with only the
    RECIPE_CUTS lines rewritten; the port's reader must give it the repo
    file's dict but for those keys."""
    with open(os.path.join(REPO, AISHELL_CONFIG), encoding="utf-8") as f:
        text = f.read()
    for key, value in RECIPE_CUTS.items():
        text, n = re.subn(rf"^{key}: .*$", f"{key}: {value}", text,
                          flags=re.M)
        if n != 1:
            raise AssertionError(f"{AISHELL_CONFIG}: {n} lines of {key}")
    path = os.path.join(WORK, "recipe_train_conformer.yaml")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    if load_config(path) != repo_config(AISHELL_CONFIG, **RECIPE_CUTS):
        raise AssertionError("the recipe's config copy does not read as the "
                             "repo's file with its cuts")
    return path


def counted_cli(out_dir: str, flag: str, module: str, *argv: str) -> None:
    """Role: `python -m module argv` in this process, every kernel
    wrapper's count set to 0 at its start; at its exit the counts and
    the counts a shape go to out_dir/<pid>.json."""
    if flag != "-m":
        raise SystemExit(f"counted_cli runs `-m module`, not {flag}")
    _reset_counts()
    pid = os.getpid()

    def write_counts():
        if os.getpid() != pid:      # a forked worker
            return
        with open(os.path.join(out_dir, f"{pid}.json"), "w") as f:
            json.dump({"module": module, "argv": list(argv),
                       "launches": _counts(),
                       "shapes": {fn.__name__: [[list(k), n] for k, n in
                                                fn.shape_launches.items()]
                                  for fn in COUNTED}}, f)

    atexit.register(write_counts)
    # this file imported the CLI's module; runpy runs a fresh copy of it
    # as __main__, on the same ops modules and so the same counters
    warnings.filterwarnings("ignore", category=RuntimeWarning,
                            module="runpy")
    sys.argv = [module, *argv]
    runpy.run_module(module, run_name="__main__", alter_sys=True)


def _kill_group(proc: subprocess.Popen) -> None:
    """Kill a child started in a session of its own, and every process
    it started, and wait for it."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def run_script(cmd: list, cwd: str, log_path: str, count_dir: str,
               procs: list | None = None) -> dict:
    """Runs the recipe script as a child process (the port's CLIs and
    tools in grandchildren), echoing its stdout; returns its stdout lines
    and each stage's seconds, from its "stage N:" lines. Its `python` is
    this interpreter, which starts every `-m openeat_torch.bin.*` through
    counted_cli, writing into `count_dir` (the shim lives beside it, so
    two scripts can run at once). A failed run raises; the child and
    what it started are killed if this process stops reading it. The
    child is appended to `procs`, where given, for Background.stop."""
    bindir = count_dir + "_bin"
    os.makedirs(bindir)
    os.makedirs(count_dir)
    with open(os.path.join(bindir, "python"), "w") as f:
        f.write(f'#!/bin/sh\ncase "$1 $2" in\n'
                f'"-m openeat_torch.bin."*) exec "{sys.executable}" '
                f'"{os.path.abspath(__file__)}" counted_cli "{count_dir}" '
                f'"$@" ;;\nesac\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bindir, "python"), 0o755)
    env = dict(os.environ, PATH=bindir + os.pathsep + os.environ["PATH"])
    lines, stamps = [], []
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                                stderr=log, text=True, start_new_session=True)
        if procs is not None:
            procs.append(proc)
        try:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                print("recipe | " + lines[-1], flush=True)
                m = re.match(r"stage (\d+):", line)
                if m:
                    stamps.append((f"stage_{m[1]}", time.perf_counter()))
            rc = proc.wait()
        finally:
            if proc.poll() is None:
                _kill_group(proc)
    t_end = time.perf_counter()
    if rc != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise AssertionError(f"{' '.join(cmd)} exited {rc}:\n{tail}")
    ends = [t for _, t in stamps[1:]] + [t_end]
    return {"lines": lines, "wall_s": t_end - t0,
            "stage_s": {name: end - t for (name, t), end in zip(stamps, ends)}}


def _lines(path: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()


def check_recipe_files(work: str, exp: str) -> dict:
    """Every stage's files, the finite losses, the hypotheses of every
    test key in every mode and one CER line a mode."""
    data = os.path.join(work, "data")
    counts = {}
    for split, n in RECIPE_SPLITS:
        n += split == "train"
        for name in ("wav.scp", "text", "utt2spk", "format.data"):
            path = os.path.join(data, split, name)
            if not os.path.exists(path) or len(_lines(path)) != n:
                raise AssertionError(f"stages 0-1 wrote no {n}-line {path}")
        counts[split] = n
    dict_lines = _lines(os.path.join(data, "dict.txt"))
    if dict_lines[:2] != ["<blank> 0", "<unk> 1"] \
            or not dict_lines[-1].startswith("<sos/eos>"):
        raise AssertionError(f"stage 1's dict: {dict_lines[:3]}")
    for name in ("train.json", "epoch_1.pt", "epoch_2.pt", "metrics.jsonl",
                 f"avg_best{RECIPE_AVERAGE}.pt",
                 f"avg_best{RECIPE_AVERAGE}.json"):
        if not os.path.exists(os.path.join(exp, name)):
            raise AssertionError(f"stages 2-3 wrote no {name}")
    losses = [r["loss"] for r in _train_records(exp)]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"the recipe's training losses: {losses}")
    test_keys = [line.split()[0] for line in
                 _lines(os.path.join(data, "test", "text"))]
    cer = {}
    for mode in MODES:
        hyps = _lines(os.path.join(exp, f"hyp_{mode}.txt"))
        if sorted(h.split(" ", 1)[0] for h in hyps) != sorted(test_keys):
            raise AssertionError(f"hyp_{mode}.txt: {hyps}")
        last = _lines(os.path.join(exp, f"cer_{mode}.txt"))[-1]
        m = re.match(r"Overall -> (\d+\.\d+) %", last)
        if not m:
            raise AssertionError(f"cer_{mode}.txt ends with {last!r}")
        cer[mode] = float(m[1])
    return {"utterances": counts, "dict_size": len(dict_lines),
            "step_losses": losses, "cer": cer}


def recipe_decode_check(work: str, exp: str) -> dict:
    """recognize of the recipe's averaged checkpoint in
    attention_rescoring, in this process with the script's arguments, K3
    counted; its hypotheses must be the script's. Where a key's tokens
    differ, that utterance's two best candidates must lie within 10 x
    ENC_TOL of each other in this process's rescoring scores."""
    data = os.path.join(work, "data")
    cfg_path = os.path.join(exp, "train.json")
    ckpt = os.path.join(exp, f"avg_best{RECIPE_AVERAGE}.pt")
    test, dict_path = (os.path.join(data, "test", "format.data"),
                       os.path.join(data, "dict.txt"))
    hyp_path = os.path.join(WORK, "recipe_in_process_hyp.txt")
    _reset_counts()
    recognize.main(["--device", "cuda", "--config", cfg_path,
                    "--checkpoint", ckpt, "--test_data", test, "--dict",
                    dict_path, "--mode", "attention_rescoring",
                    "--beam_size", str(BEAM), "--dp", "1", "--batch_size",
                    str(BATCH), "--ctc_weight", "0.5", "--reverse_weight",
                    "0.3", "--result_file", hyp_path])
    torch.cuda.synchronize()
    counts = _counts()
    n_batches = -(-dict(RECIPE_SPLITS)["test"] // BATCH)
    blocks = load_config(cfg_path)["model_conf"]["encoder_num_blocks"]
    if counts["depthwise_conv1d"] != blocks * n_batches:
        raise AssertionError(f"the recipe decode: K3 {counts}, expected "
                             f"{blocks} x {n_batches} batches")
    mine = dict(line.split(" ", 1) if " " in line else (line, "")
                for line in _lines(hyp_path))
    script = dict(line.split(" ", 1) if " " in line else (line, "")
                  for line in _lines(os.path.join(
                      exp, "hyp_attention_rescoring.txt")))
    differ = sorted(k for k in script if mine.get(k) != script[k])
    margins = {}
    if differ:
        cfg = load_config(cfg_path)
        char_dict = load_dict(dict_path)
        dev = torch.device("cuda")
        model = recognize.load_model(cfg, ckpt, len(char_dict), dev)
        feeder = DeviceFeeder(PrefetchLoader(AudioDataset(
            test, char_dict, batch_size=BATCH), AudioCollate()),
            FrontendConfig.from_collate_conf(
                cfg["collate_conf"]).without_augmentation(), dev, BATCH)
        with torch.inference_mode():
            for keys, batch in feeder:
                enc, lens = model.encode(batch["features"],
                                         batch["features_length"])
                nbest = ctc_prefix_beam_search(
                    model.ctc_log_probs(enc), lens, beam_size=BEAM,
                    max_hyp_len=MAX_HYP_LEN)
                top2 = rescoring_scores(model, enc, lens, *nbest,
                                        ctc_weight=0.5, reverse_weight=0.3
                                        ).topk(2, dim=1).values.cpu()
                margins.update((k, float(top2[i, 0] - top2[i, 1]))
                               for i, k in enumerate(keys))
        wide = {k: margins[k] for k in differ if margins[k] > 10 * ENC_TOL}
        if wide:
            raise AssertionError(f"the in-process decode differs from the "
                                 f"script's where the top-2 margin is "
                                 f"wide: {wide}")
    return {"k3_launches": counts["depthwise_conv1d"],
            "differing_keys": differ, "margins": margins}


def script_counts(count_dir: str) -> list[dict]:
    """The counted_cli files of the script's processes, shapes as
    tuples."""
    procs = []
    for name in sorted(os.listdir(count_dir)):
        with open(os.path.join(count_dir, name)) as f:
            rec = json.load(f)
        rec["shapes"] = {fn: {tuple(k): n for k, n in pairs}
                         for fn, pairs in rec["shapes"].items()}
        procs.append(rec)
    return procs


def _n_batches(data: str, split: str, dc: dict) -> int:
    """The batches bin.train makes of data/<split>/format.data under the
    dataset_conf `dc`, its defaults included."""
    return len(AudioDataset(
        os.path.join(data, split, "format.data"),
        load_dict(os.path.join(data, "dict.txt")),
        max_length=dc.get("max_length", 10240),
        min_length=dc.get("min_length", 0),
        token_max_length=dc.get("token_max_length", 200),
        token_min_length=dc.get("token_min_length", 0),
        batch_type=dc.get("batch_type", "dynamic"),
        batch_size=dc.get("batch_size", 12),
        max_frames_in_batch=dc.get("max_frames_in_batch", 10000),
        sort=dc.get("sort", True)))


def _summed(procs: list) -> tuple[dict, dict]:
    """The launches and the launches a shape, summed over processes."""
    launches, shapes = Counter(), {fn.__name__: Counter() for fn in COUNTED}
    for r in procs:
        launches.update(r["launches"])
        for fn, by_shape in r["shapes"].items():
            shapes[fn].update(by_shape)
    return dict(launches), shapes


def check_script_counts(procs: list, work: str, exp: str,
                        conf: str) -> dict:
    """The launches of the script's CLIs: the train stage K3's forward
    `blocks` times a train step and cv batch, its dgrad and wgrad
    `blocks` times a step, one CTC kernel a step and cv batch, K1 and K2
    both, K2 on the LONG_SECONDS wav's batch (S >= 2 x LONG_TOKENS + 1);
    each decode K3's forward `blocks` times a test batch and nothing
    else; the other CLIs nothing. Returns the launches and the launches
    a shape summed over the processes."""
    cfg = load_config(conf)
    dc, blocks = cfg["dataset_conf"], cfg["model_conf"]["encoder_num_blocks"]
    data = os.path.join(work, "data")
    mods = Counter(r["module"] for r in procs)
    if mods["openeat_torch.bin.train"] != 1 \
            or mods["openeat_torch.bin.recognize"] != len(MODES):
        raise AssertionError(f"the script's counted CLIs: {dict(mods)}")
    steps = len(_train_records(exp))
    cv = cfg["max_epoch"] * _n_batches(data, "dev", dc)
    n_test = -(-dict(RECIPE_SPLITS)["test"] // BATCH)
    zero = {fn.__name__: 0 for fn in COUNTED}
    for r in procs:
        c = r["launches"]
        if r["module"] == "openeat_torch.bin.train":
            want = {"depthwise_conv1d": blocks * (steps + cv),
                    "depthwise_conv1d_dgrad": blocks * steps,
                    "depthwise_conv1d_wgrad": blocks * steps}
            long_s = [k for k in r["shapes"]["ctc_dp_global"]
                      if k[2] >= 2 * LONG_TOKENS + 1]
            ok = ({k: c[k] for k in want} == want
                  and c["ctc_dp_shared"] + c["ctc_dp_global"] == steps + cv
                  and c["ctc_dp_shared"] > 0 and long_s)
            expected = (f"{want}, {steps + cv} CTC with K1 and K2 on the "
                        f"long batch ({steps} steps, {cv} cv batches)")
        else:
            want = dict(zero)
            if r["module"] == "openeat_torch.bin.recognize":
                want["depthwise_conv1d"] = blocks * n_test
            ok = c == want
            expected = str(want)
        if not ok:
            raise AssertionError(f"{r['module']} {r['argv']}: launches "
                                 f"{c}, shapes {r['shapes']}; expected "
                                 f"{expected}")
    launches, shapes = _summed(procs)
    return {"launches": launches, "shapes": shapes,
            "train_steps": steps, "cv_batches": cv, "test_batches": n_test,
            "processes": dict(mods)}


CMVN_CPU_ATOL = 1e-3    # the fbank's GPU/CPU agreement (ROADMAP Queue 3)


def recipe_cmvn(work: str) -> dict:
    """openeat_torch.tools.compute_cmvn over the recipe's train
    format.data on cuda against the same tool on the CPU: equal frame
    counts, mean and variance per frame within CMVN_CPU_ATOL."""
    fmt = os.path.join(work, "data", "train", "format.data")
    stats = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(WORK, f"recipe_cmvn_{device}.json")
        t0 = time.perf_counter()
        compute_cmvn_tool.main([fmt, out, "--device", device])
        stats[device] = (json.load(open(out)), time.perf_counter() - t0)
    (g, g_s), (c, c_s) = stats["cuda"], stats["cpu"]
    n = g["frame_num"]
    err = {key: float(np.abs(np.asarray(g[key]) - np.asarray(c[key])).max()
                      / n) for key in ("mean_stat", "var_stat")}
    res = {"frame_num": n, "cpu_frame_num": c["frame_num"],
           "max_abs_err_per_frame": err, "cuda_s": g_s, "cpu_s": c_s}
    if n != c["frame_num"] or max(err.values()) > CMVN_CPU_ATOL:
        raise AssertionError(f"compute_cmvn, cuda vs cpu: {res}")
    return res


# each wrapper's TPU counterpart and the prefix of its keys in a case row
KERNEL_OF = {
    "depthwise_conv1d": ("openeat_torch/csrc/depthwise_conv.cu",
                         "openeat_tpu/ops/depthwise_conv.py:39", ""),
    "depthwise_conv1d_dgrad": ("openeat_torch/csrc/depthwise_conv.cu",
                               "openeat_tpu/ops/depthwise_conv.py:114",
                               "dgrad_"),
    "depthwise_conv1d_wgrad": ("openeat_torch/csrc/depthwise_conv.cu",
                               "openeat_tpu/ops/depthwise_conv.py:119",
                               "wgrad_"),
    "ctc_dp_shared": ("openeat_torch/csrc/ctc_loss.cu",
                      "openeat_tpu/ops/ctc_loss.py:251", ""),
    "ctc_dp_global": ("openeat_torch/csrc/ctc_loss.cu",
                      "openeat_tpu/ops/ctc_loss.py:139", "")}


def script_kernel_cases(shapes: dict, vocab: int, step_ms: float,
                        timed: dict) -> dict:
    """Every wrapper at every shape in `shapes` ({name: {shape key:
    launches}}) against its plain version, timed at its largest shape
    only; a shape an earlier phase checked and timed (`timed`, by
    ("fwd" | "bwd", B, T + K - 1, C, K, dtype) or ("ctc", B, T, S))
    reuses that case. Returns by name, for each wrapper that launched,
    the case at the largest shape with the launches at all shapes and
    the largest error over them."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = dict(timed)     # the dgrad and the wgrad share a case a shape

    def case(name, key, time_it):
        kind = ("fwd" if name == "depthwise_conv1d" else "bwd"
                if name.startswith("depthwise_conv1d_") else "ctc")
        tkey = (kind, *key)
        if tkey not in cases or (time_it and not any(
                k in cases[tkey] for k in ("ms", "dgrad_ms"))):
            if kind == "fwd":
                row = kernel_case(*key[:4], dtypes[key[4]], gen,
                                  timed=time_it)
            elif kind == "bwd":
                row = dwconv_grad_case(*key[:4], dtypes[key[4]], gen,
                                       timed=time_it)
            else:
                row = ctc_case(key[0], key[1], (key[2] - 1) // 2, vocab,
                               gen, step_ms, timed=time_it)
            cases[tkey] = row
        if kind == "ctc" and name != f"ctc_dp_{cases[tkey]['variant']}":
            raise AssertionError(f"{name} ran at {key}, where the dispatch "
                                 f"picks {cases[tkey]['variant']}")
        return cases[tkey]

    out = {}
    for name, by_shape in shapes.items():
        if not by_shape:        # a kernel the run did not launch
            continue
        _, _, prefix = KERNEL_OF[name]
        largest = max(by_shape, key=lambda k: math.prod(k[:3]))
        rows = [case(name, key, key == largest) for key in sorted(by_shape)]
        out[name] = {"row": case(name, largest, True), "prefix": prefix,
                     "launches": sum(by_shape.values()),
                     "shape_launches": [[list(k), n] for k, n in
                                        sorted(by_shape.items())],
                     "max_abs_err": max(r[f"{prefix}max_abs_err"]
                                        for r in rows)}
    return out


def recipe_script(step_ms: float, timed: dict, wait=None) -> dict:
    """Phase 17: openeat_torch/examples/aishell/run.sh stages 0-4 on cuda
    over a synthetic AIShell-layout corpus at the flagship's full width,
    its files and the launches its CLIs counted, checked; every kernel at
    every shape the script launched it at (script_kernel_cases); then
    the checks that need this process (the decode held to the
    script's, compute_cmvn). `wait`, where given, is called before any
    of this process's work on the card: what runs beside the script
    must end before kernels are timed."""
    t0 = time.perf_counter()
    root = os.path.join(WORK, "aishell_corpus")
    write_aishell_layout(np.random.default_rng(SEED + 17), root)
    conf = recipe_config_copy()
    work = os.path.join(WORK, "recipe_work")
    os.makedirs(work)
    exp = os.path.join(work, "exp")
    count_dir = os.path.join(WORK, "recipe_counts")
    run = run_script(["bash", os.path.join(REPO, RECIPE_SCRIPT), "--stage",
                      "0", "--stop_stage", "4", "--data", root, "--config",
                      conf, "--exp_dir", exp, "--average_num",
                      str(RECIPE_AVERAGE), "--device", "cuda"], work,
                     os.path.join(WORK, "recipe_stderr.log"), count_dir)
    out = {"script_s": run["wall_s"], "stage_s": run["stage_s"]}
    out.update(check_recipe_files(work, exp))
    printed = [line for line in run["lines"] if line.startswith("Overall")]
    if printed != [_lines(os.path.join(exp, f"cer_{m}.txt"))[-1]
                   for m in MODES]:
        raise AssertionError(f"the script's CER lines: {printed}")
    counted = check_script_counts(script_counts(count_dir), work, exp, conf)
    if wait is not None:
        wait()
    out["cases"] = script_kernel_cases(counted["shapes"], out["dict_size"],
                                       step_ms, timed)
    # the shape keys as text, for the report's JSON
    counted["shapes"] = {fn: {str(list(k)): n for k, n in by_shape.items()}
                         for fn, by_shape in counted["shapes"].items()}
    out["counts"] = counted
    out["decode"] = recipe_decode_check(work, exp)
    out["cmvn"] = recipe_cmvn(work)
    out["phase_s"] = time.perf_counter() - t0
    return out


QUALITY_SCRIPT = "openeat_torch/quality/run_recipe.sh"
# 64 train utterances: one static batch of conf_synth.json, the drive's
# training step at its full width and batch
QUALITY_SPLITS = (("train", 64), ("dev", 4), ("test", 8))
QUALITY_CORPUS = ["--profile", "lmhard", "--n_train", "64", "--n_dev", "4",
                  "--n_test", "8", "--lm_text_n", "200",
                  "--adversarial_tests", "--n_adv", "4"]
QUALITY_FLAC_SPLITS = ("dev", "test", "test_reverb", "test_long")
R5_DRIVE = "benchmarks/results/r5_recipe_lmhard"


def _corpus_files(root: str) -> dict:
    """{relative path: bytes} of a corpus, root replaced in wav.scp."""
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                data = f.read()
            if n == "wav.scp":
                data = data.replace(root.encode(), b"ROOT")
            files[os.path.relpath(path, root)] = data
    return files


def check_quality_counts(procs: list, work: str) -> dict:
    """The launches of run_recipe.sh's stage 2 at one epoch: one bin.train
    process; K3's forward `blocks` times a train step and cv batch, its
    dgrad and wgrad `blocks` times a step, all at the static batch of 64;
    K1 once a step and cv batch, K2 never (S <= 33). Returns the
    launches, the launches a shape and the epoch's info."""
    cfg = load_config(os.path.join(work, "conf_synth.json"))
    dc, blocks = cfg["dataset_conf"], cfg["model_conf"]["encoder_num_blocks"]
    data, exp = os.path.join(work, "data"), os.path.join(work, "exp")
    if [r["module"] for r in procs] != ["openeat_torch.bin.train"]:
        raise AssertionError("the drive's counted CLIs: "
                             f"{[r['module'] for r in procs]}")
    with open(os.path.join(exp, "epoch_1.json")) as f:
        info = json.load(f)
    steps, cv = info["step"], _n_batches(data, "dev", dc)
    if steps != _n_batches(data, "train", dc) or steps < 1 \
            or not all(math.isfinite(info[k])
                       for k in ("train_loss", "cv_loss")):
        raise AssertionError(f"the drive's epoch: {info}")
    c, shapes = procs[0]["launches"], procs[0]["shapes"]
    want = {"depthwise_conv1d": blocks * (steps + cv),
            "depthwise_conv1d_dgrad": blocks * steps,
            "depthwise_conv1d_wgrad": blocks * steps,
            "ctc_dp_shared": steps + cv, "ctc_dp_global": 0}
    batch = dc["batch_size"]
    full = {k[0] for name in ("depthwise_conv1d_dgrad",
                              "depthwise_conv1d_wgrad")
            for k in shapes[name]}
    if c != want or full != {batch} \
            or max(k[0] for k in shapes["ctc_dp_shared"]) != batch:
        raise AssertionError(f"the drive's launches {c}, shapes {shapes}; "
                             f"expected {want} at batch {batch} ({steps} "
                             f"steps, {cv} cv batches)")
    launches, by_shape = _summed(procs)
    return {"launches": launches, "shapes": by_shape, "train_steps": steps,
            "cv_batches": cv, "epoch": info}


def quality_init_draw(conf: str, corpus: str) -> dict:
    """The port's own initial weights at the drive's seed, drawn on the
    CPU by openeat_torch/quality/init_draw.py as bin.train draws them
    and written as corpus/exp/epoch_0.pt, from which run_recipe.sh's
    stage 2 resumes at step 0 with a fresh optimizer. The draw must
    equal, bit for bit, the model bin.train builds for itself on this
    host (its state after --max_epoch 0). Returns the seed, the tensor
    and parameter counts and the state dict's sha256."""
    seed = TrainConfig.from_dict(load_config(conf)).seed
    data = os.path.join(corpus, "data")
    _, state = init_draw.write_epoch0(
        conf, os.path.join(data, "dict.txt"), seed,
        os.path.join(corpus, "exp"))
    own = train_cli.main([
        "--config", conf, "--train_data",
        os.path.join(data, "train", "format.data"), "--cv_data",
        os.path.join(data, "dev", "format.data"), "--dict",
        os.path.join(data, "dict.txt"), "--exp_dir",
        os.path.join(WORK, "quality_own_draw"), "--device", "cpu",
        "--num_workers", "1", "--max_epoch", "0"]).model.state_dict()
    if list(own) != list(state) \
            or not all(torch.equal(own[k], state[k]) for k in own):
        raise AssertionError("init_draw's draw is not bin.train's own")
    return {"seed": seed, "tensors": len(state),
            "parameters": sum(v.numel() for v in state.values()),
            "sha256": init_draw.state_sha256(state)}


def quality_corpus(step_ms: float, timed: dict) -> dict:
    """Phase 18: the quality drive's corpus builder twice (byte-equal),
    its FLAC through both readers, the derived configs against round
    5's, then run_recipe.sh's stages 1-2 on cuda at one epoch: the dict,
    the manifests and one training step of conf_synth.json at the
    flagship's width and its static batch of 64, with a cv batch; the
    launches its bin.train counted, checked; every kernel at every
    shape it launched it at (script_kernel_cases)."""
    t0 = time.perf_counter()
    roots, build_s = [], []
    for name in ("quality_a", "quality_b"):
        root = os.path.join(WORK, name)
        t = time.perf_counter()
        subprocess.run([sys.executable, "-m",
                        "openeat_torch.quality.make_structured_corpus",
                        root, *QUALITY_CORPUS], cwd=REPO, check=True,
                       stdout=subprocess.DEVNULL)
        build_s.append(time.perf_counter() - t)
        roots.append(root)
    a, b = (_corpus_files(r) for r in roots)
    if sorted(a) != sorted(b) or any(a[k] != b[k] for k in a):
        raise AssertionError("two builds of the quality corpus differ: "
                             f"{sorted(k for k in a if a.get(k) != b.get(k))}")
    flacs = sorted(os.path.join(roots[0], k) for k in a
                   if k.endswith(".flac"))
    if {k.split(os.sep)[1] for k in a if k.endswith(".flac")} \
            != set(QUALITY_FLAC_SPLITS):
        raise AssertionError("the FLAC splits are not "
                             f"{QUALITY_FLAC_SPLITS}")
    if not native_io.available():
        raise AssertionError(f"the native reader did not build: "
                             f"{native_io.build_error}")
    wav, lens, rates = native_io.read_wav_batch(
        flacs, [None] * len(flacs), [None] * len(flacs), 16000 * 30, 8)
    for i, path in enumerate(flacs):
        ref, rate = audio_lib.read_audio(path)
        if rates[i] != rate or lens[i] != len(ref) \
                or not np.array_equal(wav[i, :lens[i]], ref):
            raise AssertionError(f"native and Python reads differ: {path}")
    conf_dir = os.path.join(REPO, "examples", "aishell", "conf")
    confs_checked = []
    for argv, r5 in (
            (["train", os.path.join(conf_dir, "train_conformer_tpu.yaml"),
              "lmhard", "60"], "conf_synth.yaml"),
            (["lm", os.path.join(conf_dir, "train_lm.yaml"), "6"],
             "conf_lm.yaml")):
        out = os.path.join(WORK, r5.replace(".yaml", ".json"))
        subprocess.run([sys.executable, "-m", "openeat_torch.quality.confs",
                        *argv, out], cwd=REPO, check=True)
        if load_config(out) != load_config(os.path.join(REPO, R5_DRIVE, r5)):
            raise AssertionError(f"{out} differs from {R5_DRIVE}/{r5}")
        confs_checked.append(r5)
    subprocess.run(["bash", os.path.join(REPO, QUALITY_SCRIPT), "--stage",
                    "1", "--stop_stage", "1", "--device", "cuda", roots[0],
                    "lmhard"], cwd=WORK, check=True,
                   stdout=subprocess.DEVNULL)
    draw = quality_init_draw(os.path.join(WORK, "conf_synth.json"),
                             roots[0])
    count_dir = os.path.join(WORK, "quality_counts")
    run = run_script(["bash", os.path.join(REPO, QUALITY_SCRIPT), "--stage",
                      "2", "--stop_stage", "2", "--max_epoch", "1",
                      "--device", "cuda", roots[0], "lmhard"],
                     WORK, os.path.join(WORK, "quality_stderr.log"),
                     count_dir)
    log = _lines(os.path.join(roots[0], "exp", "train.log"))
    if "resuming from epoch_0" not in run["lines"] or not any(
            f"initialized {draw['tensors']} tensors from" in line
            for line in log) \
            or any("restored optimizer state" in line for line in log):
        raise AssertionError("stage 2 did not start from the writer's "
                             "epoch-0 draw with a fresh optimizer")
    data = os.path.join(roots[0], "data")
    manifests = {}
    for split, n in QUALITY_SPLITS:
        rows = _lines(os.path.join(data, split, "format.data"))
        if len(rows) != n:
            raise AssertionError(f"{split}/format.data: {len(rows)} rows")
        manifests[split] = len(rows)
    tokens = {line.split()[0] for line in
              _lines(os.path.join(data, "dict.txt"))}
    chars = {c for line in _lines(os.path.join(data, "train", "text"))
             for c in line.split(maxsplit=1)[1]}
    if not chars or not chars <= tokens:
        raise AssertionError(f"dict.txt lacks {sorted(chars - tokens)}")
    # conf_synth.json as the drive derives it: round 5's but max_epoch
    derived = load_config(os.path.join(roots[0], "conf_synth.json"))
    r5 = load_config(os.path.join(REPO, R5_DRIVE, "conf_synth.yaml"))
    if dict(derived, max_epoch=r5["max_epoch"]) != r5:
        raise AssertionError("stage 2's conf_synth.json is not round 5's")
    counted = check_quality_counts(script_counts(count_dir), roots[0])
    cases = script_kernel_cases(counted["shapes"], len(tokens), step_ms,
                                timed)
    counted["shapes"] = {fn: {str(list(k)): n for k, n in by_shape.items()}
                         for fn, by_shape in counted["shapes"].items()}
    stage_s = [line.split("\t") for line in
               _lines(os.path.join(roots[0], "stage_times.tsv"))]
    return {"files": len(a), "flac_files": len(flacs),
            "build_s": build_s, "confs": confs_checked,
            "dict_size": len(tokens), "manifests": manifests,
            "init_draw": draw, "script_s": run["wall_s"],
            "command_s": {label: float(s) for _, label, s in stage_s},
            "counts": counted, "cases": cases,
            "phase_s": time.perf_counter() - t0}


STREAM_DRIVE_SCRIPT = "openeat_torch/quality/run_streaming.sh"
# the hard profile's corpus as the streamed drive gets it (run_recipe.sh
# stages 0-1), cut to one static batch of 64 train utterances
STREAM_DRIVE_SPLITS = (("train", 64), ("dev", 4), ("test", 8))
STREAM_DRIVE_CORPUS = "--n_train 64 --n_dev 4 --n_test 8"
STREAM_DRIVE_SLOTS = 16     # run_streaming.sh's --slots
STREAM_DRIVE_CHUNK = 16     # and its --chunk_size
R3_STREAMING = "benchmarks/results/r3_streaming_hard/results_streaming.json"


def check_streaming_counts(procs: list, work: str, corpus: str,
                           stream: bool = True) -> dict:
    """The launches of run_streaming.sh's CLIs at one epoch (of
    run_moe.sh's with `stream` False) under the config bin.train wrote
    (exp/train.json): bin.train
    K3's forward `blocks` times a train step and cv batch, its dgrad and
    wgrad `blocks` times a step at the static batch of 64, K1 once a step
    and cv batch, K2 never; average_model nothing; each offline decode
    K3's forward `blocks` times a test batch; stream_recognize K3's
    forward `blocks` times a chunk step, every step at [slots, K - 1 +
    chunk, d] (all slots ride along), between the longest stream's
    chunks and the sum of all streams' chunks; nothing else."""
    data, exp = os.path.join(corpus, "data"), os.path.join(work, "exp")
    cfg = load_config(os.path.join(exp, "train.json"))
    dc, blocks = cfg["dataset_conf"], cfg["model_conf"]["encoder_num_blocks"]
    mc = cfg["model_conf"]
    mods = Counter(r["module"] for r in procs)
    want_mods = {"openeat_torch.bin.train": 1,
                 "openeat_torch.bin.average_model": 1,
                 "openeat_torch.bin.recognize": 2}
    if stream:
        want_mods["openeat_torch.bin.stream_recognize"] = 1
    if dict(mods) != want_mods:
        raise AssertionError(f"the drive's counted CLIs: {mods}")
    with open(os.path.join(exp, "epoch_1.json")) as f:
        info = json.load(f)
    steps, cv = info["step"], _n_batches(data, "dev", dc)
    if steps != _n_batches(data, "train", dc) or steps < 1 \
            or not all(math.isfinite(info[k])
                       for k in ("train_loss", "cv_loss")):
        raise AssertionError(f"the drive's epoch: {info}")
    test_rows = _lines(os.path.join(data, "test", "format.data"))
    chunks = []
    for row in test_rows if stream else ():
        path = row.split("\t")[1].split(":", 1)[1]
        t = encoder_positions(len(audio_lib.read_audio(path)[0]))
        chunks.append(math.ceil(t / STREAM_DRIVE_CHUNK))
    n_test = -(-len(test_rows) // 64)
    zero = {fn.__name__: 0 for fn in COUNTED}
    halo = mc["cnn_module_kernel"] - 1
    chunk_key = (STREAM_DRIVE_SLOTS, halo + STREAM_DRIVE_CHUNK,
                 mc["d_model"], mc["cnn_module_kernel"], mc["compute_dtype"])
    chunk_steps = None
    for r in procs:
        c, shapes = r["launches"], r["shapes"]
        if r["module"] == "openeat_torch.bin.train":
            want = dict(zero, depthwise_conv1d=blocks * (steps + cv),
                        depthwise_conv1d_dgrad=blocks * steps,
                        depthwise_conv1d_wgrad=blocks * steps,
                        ctc_dp_shared=steps + cv)
            full = {k[0] for name in ("depthwise_conv1d_dgrad",
                                      "depthwise_conv1d_wgrad")
                    for k in shapes[name]}
            ok = c == want and full == {dc["batch_size"]}
        elif r["module"] == "openeat_torch.bin.stream_recognize":
            chunk_steps = c["depthwise_conv1d"] // blocks
            want = dict(zero, depthwise_conv1d=blocks * chunk_steps)
            ok = (c == want and set(shapes["depthwise_conv1d"]) == {chunk_key}
                  and max(chunks) <= chunk_steps <= sum(chunks))
            want = (f"{want}, {max(chunks)}-{sum(chunks)} chunk steps at "
                    f"{chunk_key}")
        else:
            want = dict(zero)
            if r["module"] == "openeat_torch.bin.recognize":
                want["depthwise_conv1d"] = blocks * n_test
            ok = c == want
        if not ok:
            raise AssertionError(f"{r['module']} {r['argv']}: launches {c}, "
                                 f"shapes {shapes}; expected {want}")
    launches, by_shape = _summed(procs)
    return {"launches": launches, "shapes": by_shape, "train_steps": steps,
            "cv_batches": cv, "test_batches": n_test,
            "chunk_steps": chunk_steps, "stream_chunks": chunks,
            "chunk_key": chunk_key, "epoch": info}


class Background:
    """`fn(*args, procs=...)` on a thread of its own, beside the main
    thread: work bound by its child processes' starts. join() waits and
    returns its result or raises its error; stop() kills the children
    it started (each appended to `procs`) and waits."""

    def __init__(self, fn, *args):
        self.procs = []
        self._out = {}

        def run():
            try:
                self._out["result"] = fn(*args, procs=self.procs)
            except Exception as e:      # raised again by join()
                self._out["error"] = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["result"]

    def stop(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                _kill_group(proc)
        self._thread.join()


STREAM_DRIVE_CORPUS_DIR = "stream_corpus"


def streaming_drive_script(corpus_ready: threading.Event, procs: list
                           ) -> dict:
    """Phase 19's child processes: the hard corpus by run_recipe.sh's
    stages 0-1 (64 / 4 / 8 utterances), which sets `corpus_ready` when it
    ends (moe_drive_script waits for it), then
    openeat_torch/quality/run_streaming.sh on cuda at one epoch through
    the counted shim. Nothing of it runs in this process, so it can run
    beside phase 17's script (Background)."""
    t0 = time.perf_counter()
    corpus = os.path.join(WORK, STREAM_DRIVE_CORPUS_DIR)
    cmd = ["bash", os.path.join(REPO, QUALITY_SCRIPT), "--stage", "0",
           "--stop_stage", "1", "--device", "cuda", "--corpus_opts",
           STREAM_DRIVE_CORPUS, corpus, "hard"]
    try:
        _child(cmd, procs)
    finally:
        corpus_ready.set()
    corpus_s = time.perf_counter() - t0
    work = os.path.join(WORK, "stream_work")
    count_dir = os.path.join(WORK, "stream_counts")
    run = run_script(["bash", os.path.join(REPO, STREAM_DRIVE_SCRIPT),
                      "--max_epoch", "1", "--device", "cuda", work, corpus],
                     WORK, os.path.join(WORK, "stream_stderr.log"),
                     count_dir, procs)
    return {"corpus": corpus, "work": work, "count_dir": count_dir,
            "corpus_s": corpus_s, "script_s": run["wall_s"]}


def streaming_drive(script: dict, step_ms: float, timed: dict) -> dict:
    """Phase 19, after streaming_drive_script: the corpus's manifests;
    every stage of run_streaming.sh at one epoch (global CMVN, one
    training step of conf_stream.json, the causal static-chunk flagship
    at full width and batch 64, the average, the two offline decodes and
    the 16-slot stream_recognize, each with its CER) and
    results_streaming.json with round 3's keys; the launches its CLIs
    counted, checked (check_streaming_counts); every kernel at every
    shape they launched it at (script_kernel_cases)."""
    t0 = time.perf_counter()
    corpus, work = script["corpus"], script["work"]
    data = os.path.join(corpus, "data")
    for split, n in STREAM_DRIVE_SPLITS:
        rows = _lines(os.path.join(data, split, "format.data"))
        if len(rows) != n:
            raise AssertionError(f"{split}/format.data: {len(rows)} rows")
    exp = os.path.join(work, "exp")
    with open(os.path.join(exp, "results_streaming.json")) as f:
        res = json.load(f)
    with open(os.path.join(REPO, R3_STREAMING)) as f:
        r3 = json.load(f)
    cmp = res.get("streamed_vs_offline_rescoring", {})
    if list(res) != list(r3) or list(cmp) != list(
            r3["streamed_vs_offline_rescoring"]) \
            or not all(isinstance(res[k], float) and math.isfinite(res[k])
                       for k in list(r3)[:3]) \
            or cmp["utts"] != dict(STREAM_DRIVE_SPLITS)["test"]:
        raise AssertionError(f"results_streaming.json: {res}")
    test_keys = sorted(line.split()[0] for line in
                       _lines(os.path.join(data, "test", "text")))
    for tag in ("offline_ctc_greedy_search", "offline_attention_rescoring",
                "streamed"):
        hyps = _lines(os.path.join(exp, f"hyp_{tag}.txt"))
        if sorted(h.split(" ", 1)[0] for h in hyps) != test_keys:
            raise AssertionError(f"hyp_{tag}.txt: {hyps}")
    tokens = {line.split()[0] for line in
              _lines(os.path.join(data, "dict.txt"))}
    counted = check_streaming_counts(script_counts(script["count_dir"]),
                                     work, corpus)
    cases = script_kernel_cases(counted["shapes"], len(tokens), step_ms,
                                timed)
    # K3 at the chunk step's shape, which cases["depthwise_conv1d"] only
    # checks (it times the largest, the training batch's): by TMA,
    # bit-equal, timed, with stream_recognize's launches
    key = counted["chunk_key"]
    chunk = kernel_case(*key[:4], getattr(torch, key[4]),
                        torch.Generator(device="cuda").manual_seed(SEED + 19),
                        exact=True)
    if chunk["route"] != "tma":
        raise AssertionError(f"the chunk step's K3 not by TMA: {chunk}")
    chunk["launches"] = counted["shapes"]["depthwise_conv1d"][key]
    counted["shapes"] = {fn: {str(list(k)): n for k, n in by_shape.items()}
                         for fn, by_shape in counted["shapes"].items()}
    stage_s = [line.split("\t") for line in
               _lines(os.path.join(work, "stage_times.tsv"))]
    return {"corpus_s": script["corpus_s"], "script_s": script["script_s"],
            "command_s": {label: float(s) for _, label, s in stage_s},
            "results": res, "counts": counted, "cases": cases,
            "chunk_case": chunk, "checks_s": time.perf_counter() - t0}


MOE_DRIVE_SCRIPT = "openeat_torch/quality/run_moe.sh"
R3_MOE = "benchmarks/results/r3_moe_hard"
# what the MoE leg's config must share with round 3's
MOE_R3_KEYS = ("moe_experts", "moe_top_k", "moe_capacity_factor",
               "moe_aux_weight", "warmup_epoch")


def _child(cmd: list, procs: list) -> None:
    """Run `cmd` from WORK in a session of its own, appended to `procs`
    (Background.stop kills it); a failure raises."""
    proc = subprocess.Popen(cmd, cwd=WORK, stdout=subprocess.DEVNULL,
                            start_new_session=True)
    procs.append(proc)
    if proc.wait() != 0:
        raise subprocess.CalledProcessError(proc.returncode, cmd)


def moe_drive_script(corpus_ready: threading.Event, procs: list) -> dict:
    """Phase 19's MoE leg, child processes only (Background): once
    streaming_drive_script's hard corpus exists, run_moe.sh on cuda at
    one epoch on it: stage 1 writes conf_moe.json, whose log interval is
    cut to 1 so that its one step is logged, then stages 2-5 through the
    counted shim."""
    corpus_ready.wait()
    corpus = os.path.join(WORK, STREAM_DRIVE_CORPUS_DIR)
    for split, n in STREAM_DRIVE_SPLITS:
        path = os.path.join(corpus, "data", split, "format.data")
        if not os.path.exists(path) or len(_lines(path)) != n:
            raise AssertionError(f"the MoE leg: no {n}-row {path}")
    work = os.path.join(WORK, "moe_work")
    script = os.path.join(REPO, MOE_DRIVE_SCRIPT)
    opts = ["--max_epoch", "1", "--device", "cuda"]
    _child(["bash", script, "--stage", "1", "--stop_stage", "1", *opts,
            work, corpus], procs)
    conf = os.path.join(work, "conf_moe.json")
    cfg = load_config(conf)
    cfg["log_interval"] = 1
    with open(conf, "w") as f:
        json.dump(cfg, f, indent=1)
    count_dir = os.path.join(WORK, "moe_counts")
    run = run_script(["bash", script, "--stage", "2", *opts, work, corpus],
                     WORK, os.path.join(WORK, "moe_stderr.log"), count_dir,
                     procs)
    return {"corpus": corpus, "work": work, "count_dir": count_dir,
            "script_s": run["wall_s"]}


def _host_syncs(fn) -> list[str]:
    """The synchronizing operations fn() runs on the card, each named by
    torch.cuda.set_sync_debug_mode("warn") ("called a synchronizing CUDA
    operation"; the mode's one warning that it is a prototype is not a
    sync)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).split("\n")[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def moe_host_syncs(b: int = 64, t: int = 48) -> dict:
    """The host syncs of one MoE FFN forward and backward at the drive's
    width (d 256, 1024 hidden, top-2 of 4, capacity 1.25, swish, bf16,
    dropout 0.1) and step shape [b, t, 256] at world 1 on the card,
    counted, not asserted; a count of 0 stands only where the mode then
    names the sync of a tensor's .item()."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    layer = MoEPositionwiseFeedForward(
        256, 1024, 4, 2, 1.25, get_activation("swish"),
        dtype=torch.bfloat16, dropout_rate=0.1).cuda().train()
    set_generator(layer, gen)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, device="cuda", generator=gen)
                    * 0.05)
    x = torch.randn(b, t, 256, device="cuda", generator=gen,
                    requires_grad=True)
    mask = torch.ones(b, 1, t, dtype=torch.bool, device="cuda")

    def step():
        y, aux = layer(x, mask)
        (y.float().sum() + aux).backward()

    # the control runs after the step, in case the mode warns only once
    syncs = _host_syncs(step)
    if not syncs and not _host_syncs(lambda: x.sum().item()):
        raise AssertionError("the sync debug mode missed .item()'s sync")
    return {"shape": [b, t, 256], "syncs": len(syncs), "first": syncs[:3]}


def moe_drive(script: dict, step_ms: float, timed: dict) -> dict:
    """Phase 19's MoE leg, after moe_drive_script: every stage of
    run_moe.sh at one epoch (conf_moe.json, one training step of the
    top-2-of-4 MoE flagship at full width and batch 64, the average, the
    greedy and rescoring decodes with their CERs) and results_moe.json
    with round 3's keys in its order, finite; a finite loss and moe_aux
    in every step record; the MoE keys and warmup of round 3's
    conf_moe.yaml; hypotheses of every test key; the launches its
    CLIs counted, by check_streaming_counts' rules without the stream;
    every kernel at every shape they launched it at
    (script_kernel_cases); the MoE layer's host syncs at the step's
    shape (moe_host_syncs)."""
    t0 = time.perf_counter()
    corpus, work = script["corpus"], script["work"]
    data, exp = os.path.join(corpus, "data"), os.path.join(work, "exp")
    # the MoE keys and the warmup of round 3's config
    moe_keys = [{k: c.get(k, c["model_conf"].get(k)) for k in MOE_R3_KEYS}
                for c in (load_config(os.path.join(exp, "train.json")),
                          load_config(os.path.join(REPO, R3_MOE,
                                                   "conf_moe.yaml")))]
    if moe_keys[0] != moe_keys[1]:
        raise AssertionError(f"the MoE leg trained {moe_keys[0]}, round 3 "
                             f"{moe_keys[1]}")
    with open(os.path.join(exp, "results_moe.json")) as f:
        res = json.load(f)
    with open(os.path.join(REPO, R3_MOE, "results_moe.json")) as f:
        r3 = json.load(f)
    if list(res) != list(r3) or not all(
            isinstance(v, float) and math.isfinite(v) for v in res.values()):
        raise AssertionError(f"results_moe.json: {res}")
    steps = _train_records(exp)
    if not steps or not all(
            math.isfinite(r["loss"]) and r.get("moe_aux") is not None
            and math.isfinite(r["moe_aux"]) for r in steps):
        raise AssertionError(f"the MoE leg's step records: {steps}")
    test_keys = sorted(line.split()[0] for line in
                       _lines(os.path.join(data, "test", "text")))
    for tag in r3:
        hyps = _lines(os.path.join(exp, f"hyp_{tag}.txt"))
        if sorted(h.split(" ", 1)[0] for h in hyps) != test_keys:
            raise AssertionError(f"hyp_{tag}.txt: {hyps}")
    tokens = {line.split()[0] for line in
              _lines(os.path.join(data, "dict.txt"))}
    counted = check_streaming_counts(script_counts(script["count_dir"]),
                                     work, corpus, stream=False)
    cases = script_kernel_cases(counted["shapes"], len(tokens), step_ms,
                                timed)
    counted["shapes"] = {fn: {str(list(k)): n for k, n in by_shape.items()}
                         for fn, by_shape in counted["shapes"].items()}
    stage_s = [line.split("\t") for line in
               _lines(os.path.join(work, "stage_times.tsv"))]
    return {"script_s": script["script_s"], "host_syncs": moe_host_syncs(),
            "command_s": {label: float(s) for _, label, s in stage_s},
            "results": res, "moe_aux": [r["moe_aux"] for r in steps],
            "step_losses": [r["loss"] for r in steps], "counts": counted,
            "cases": cases, "checks_s": time.perf_counter() - t0}


def _kernel_row(name: str, source: str, replaces: str, launches: int,
                row: dict, prefix: str = "") -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row[f"{prefix}max_abs_err"],
            "ms": row[f"{prefix}ms"], "plain_ms": row[f"{prefix}plain_ms"],
            "bound_ms": row[f"{prefix}bound_ms"],
            "bound_by": row[f"{prefix}bound_by"],
            "library_ms": row[f"{prefix}library_ms"]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    phase_s = report["phase_s"] = {}
    clock = [t_start]
    stream_script = moe_script = None

    def lap(name: str) -> None:
        """Seconds since the last lap, under `name`."""
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    try:
        t0 = time.perf_counter()
        sources = [dw.SOURCE, ctc.SOURCE, mt.SOURCE]
        nvcc.build_libraries(sources)
        report["build_s"] = time.perf_counter() - t0
        report["ptxas"] = {s: nvcc.ptxas_entries(nvcc.build_log(s))
                           for s in sources}
        print(f"kernels built in {report['build_s']:.2f} s", flush=True)
        for source, entries in report["ptxas"].items():
            for e in entries:
                print(f"ptxas {source} {json.dumps(e)}", flush=True)
        for e in report["ptxas"][dw.SOURCE]:
            m = re.search(r"wgrad_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
                          e["entry"])
            if m:
                kf = {"0": "run-time K"}.get(m[2], f"K = {m[2]}")
                print(f"ptxas wgrad {kf} "
                      f"{'float32' if m[1] == 'f' else 'bfloat16'} "
                      f"{WGRAD_ROUTES[m[3]]}: {e['registers']} registers, "
                      f"spills {e['spill_stores']} / {e['spill_loads']} "
                      f"bytes", flush=True)
        spilled = [e for entries in report["ptxas"].values() for e in entries
                   if e["spill_stores"] or e["spill_loads"]]
        if spilled:
            raise AssertionError(f"kernels spill: {spilled}")

        report["multi_tensor"] = multi_tensor_cases()
        rng = np.random.default_rng(SEED)
        manifest, dict_path, durations = write_corpus(rng)
        train_data, cv_data, train_audio_s = write_train_corpus(rng)
        main_shapes = main_path_shapes(durations)
        tshapes = train_shapes(train_data, dict_path)
        report["train_batch_shapes"] = tshapes
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        shapes = [(8, 138, 256, 15), (3, 40, 100, 7), (1, 15, 4, 15)] \
            + main_shapes
        rows = []
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                row = kernel_case(*shape, dtype, gen)
                rows.append(row)
                print("K3 " + json.dumps(row), flush=True)
        # the streaming chunk step's shapes, [S, K - 1 + c, 256]: the
        # conv cache in front of the chunk, by TMA and bit-equal to the
        # plain version in both dtypes
        chunk_rows = []
        for shape in ((1, 14 + CHUNK, 256, 15), (8, 14 + CHUNK, 256, 15)):
            for dtype in (torch.float32, torch.bfloat16):
                row = kernel_case(*shape, dtype, gen, exact=True)
                if row["route"] != "tma":
                    raise AssertionError(f"chunk shape not by TMA: {row}")
                chunk_rows.append(row)
                print("K3 chunk " + json.dumps(row), flush=True)
        report["k3_chunk_cases"] = chunk_rows
        # the element-load route: odd C in bfloat16, a 2-byte-offset input
        for shape, offset in (((3, 40, 99, 7), False),
                              ((2, 40, 256, 7), True)):
            row = kernel_case(*shape, torch.bfloat16, gen, offset=offset)
            if row["route"] != "element":
                raise AssertionError(f"not the element route: {row}")
            rows.append(row)
            print("K3 " + json.dumps(row), flush=True)
        report["k3_cases"] = rows
        lap("k3_forward_cases")

        # ---- training kernels at the training run's shapes and beyond
        train_grad_shapes = sorted({(b, t + 14, 256, 15)
                                    for b, t, _ in tshapes})
        grad_shapes = train_grad_shapes + [(12, 212, 256, 15),
                                           (3, 40, 100, 7), (1, 15, 4, 15)]
        grad_rows = []
        for shape in grad_shapes:
            for dtype in (torch.float32, torch.bfloat16):
                row = dwconv_grad_case(*shape, dtype, gen)
                grad_rows.append(row)
                print("K3 bwd " + json.dumps(row), flush=True)
        for shape, offset in (((3, 40, 99, 7), False),
                              ((2, 40, 256, 7), True)):
            row = dwconv_grad_case(*shape, torch.bfloat16, gen, offset=offset)
            if row["dgrad_route"] != "element" \
                    or row["wgrad_route"] != "element":
                raise AssertionError(f"not the element route: {row}")
            grad_rows.append(row)
            print("K3 bwd " + json.dumps(row), flush=True)
        report["k3_backward_cases"] = grad_rows
        lap("k3_backward_cases")
        report["k3_k31_cases"] = k31_cases(gen)
        report["wgrad_plans_checked"] = check_wgrad_plan(
            torch.cuda.get_device_properties(0).multi_processor_count)
        lap("k3_k31_cases")
        print(f"K3 K = 31 cases {phase_s['k3_k31_cases']:.2f} s", flush=True)
        report["k3_kernels_per_call"] = k3_kernels_per_call(
            [(8, 212, 256, 15, torch.float32),
             (8, 212, 256, 15, torch.bfloat16),
             (3, 40, 100, 7, torch.bfloat16)], [(14, 198, 24), (2, 1200, 24)],
            gen)
        if [r["call"] for r in report["k3_kernels_per_call"][-2:]] \
                != ["ctc_dp_shared", "ctc_dp_global"]:
            raise AssertionError("the profiler check missed a CTC kernel")
        print("kernels per call "
              + json.dumps(report["k3_kernels_per_call"]), flush=True)
        report["ctc_global_plans"] = check_global_plan()
        report["ctc_chain_step_ms"] = step_ms = ctc.chain_step_ms()
        print(f"CTC chain step {step_ms * 1e6:.1f} ns", flush=True)
        ctc_rows = []
        train_ctc_shapes = sorted(set(tshapes))
        # then the TPU batch, K2 at the JAX package's large shape, K2 at a
        # tall S = 49 and at S = 1001 (8 warps of 4 positions), and K1 at 1
        # and 4 label positions a lane; every case has a row of T + 5
        for b, t, l_pad in train_ctc_shapes + [(256, 77, 24), (8, 1024, 120),
                                               (2, 1200, 24), (2, 1100, 500),
                                               (5, 30, 15), (4, 70, 60)]:
            row = ctc_case(b, t, l_pad, VOCAB, gen, step_ms)
            ctc_rows.append(row)
            print("CTC " + json.dumps(row), flush=True)
        report["ctc_cases"] = ctc_rows
        lap("ctc_cases")

        # ---- slice 1: the decode path through the entry point
        cfg32 = write_config("float32")
        cfg16 = write_config("bfloat16")
        ckpt = os.path.join(WORK, "model.pt")
        torch.save(random_model_state(torch.Generator().manual_seed(SEED)),
                   ckpt)
        audio_s = sum(durations)
        n_batches = len(main_shapes)
        keys = {f"utt{i:03d}" for i in range(N_UTTS)}
        t_enc = {f"utt{i:03d}": encoder_frames(d)
                 for i, d in enumerate(durations)}
        runs = []
        decode_launches = 0
        adaptive = ["--adaptive_steps", "1", "--length_penalty", "0.5"]
        for mode, cfg, tag, extra in (
                [("ctc_greedy_search", cfg32, "warmup", [])]
                + [(m, cfg32, m, []) for m in MODES]
                + [("attention", cfg32, "attention_adaptive", adaptive),
                   ("attention_rescoring", cfg16, "bf16", []),
                   ("attention", cfg16, "attention_bf16", [])]):
            want_ts = cfg == cfg32 and tag in MODES and mode != "attention"
            hyps, wall, launches, ts = run_recognize(
                cfg, ckpt, manifest, dict_path, mode, tag, extra, want_ts)
            decode_launches += launches
            if set(hyps) != keys:
                raise AssertionError(f"{tag}: keys written {sorted(hyps)}")
            if launches != 12 * n_batches:
                raise AssertionError(f"{tag}: K3 launched {launches} times, "
                                     f"expected 12 x {n_batches} batches")
            run = {"run": tag, "mode": mode, "wall_s": wall,
                   "batches": n_batches, "s_per_batch": wall / n_batches,
                   "rtf": wall / audio_s, "k3_launches": launches,
                   "nonempty_hyps": sum(bool(v) for v in hyps.values())}
            if ts is not None:
                run["timestamps"] = check_timestamps(tag, ts, hyps, t_enc)
            runs.append(run)
            print("decode " + json.dumps(run), flush=True)
        report["decode_runs"] = runs
        lap("decode_runs")
        report["audio_s"] = audio_s
        report["cpu_parity"] = compare_with_cpu(cfg32, ckpt, manifest,
                                                dict_path)
        print("cpu_parity " + json.dumps(report["cpu_parity"]), flush=True)
        lap("decode_cpu_parity")
        report["oracle"] = {dt: oracle_checks(cfg, ckpt, manifest, dict_path)
                            for dt, cfg in (("float32", cfg32),
                                            ("bfloat16", cfg16))}
        print("oracle " + json.dumps(report["oracle"]), flush=True)
        lap("decode_oracle")
        report["attention_cache"] = attention_cache_checks(
            cfg32, ckpt, manifest, dict_path)
        print("attention_cache " + json.dumps(report["attention_cache"]),
              flush=True)
        lap("decode_attention_cache")
        report["breakdown"] = stage_breakdown(cfg32, ckpt, manifest,
                                              dict_path, torch.device("cuda"))
        print("breakdown " + json.dumps(report["breakdown"]), flush=True)
        lap("decode_breakdown")

        # ---- slice 2: training through the entry point
        _reset_counts()
        _reset_mt_counts()
        train_run = run_training(train_data, cv_data, dict_path)
        train_counts = _counts()
        check_train_counts(train_run, train_counts)
        train_run["mt_launches"] = _mt_counts()
        check_mt_counts(train_run["mt_launches"], train_run["n_train_steps"],
                        TRAIN_CONFIG.get("accum_grad", 1))
        train_run["launches"] = train_counts
        train_run["audio_s_per_epoch"] = train_audio_s
        report["train_run"] = train_run
        lap("train_run")
        print("train " + json.dumps({k: v for k, v in train_run.items()
                                     if k != "epochs"}), flush=True)
        report["recipe"] = run_recipe(os.path.join(WORK, "exp"), train_data,
                                      cv_data, dict_path)
        print("recipe " + json.dumps({k: v for k, v in report["recipe"].items()
                                      if k != "decodes"}), flush=True)
        lap("recipe")

        # ---- slice 9: the MoE Conformer through bin/train and recognize,
        # then the distributed paths (one NCCL rank; two gloo ranks)
        t0 = time.perf_counter()
        # the two-rank check runs in child processes beside the MoE
        # phase (correctness only; the MoE times reported are the
        # breakdown's, taken alone at the end)
        two_ranks = dist_two_ranks(train_data, dict_path)
        moe = moe_training(train_data, cv_data, dict_path)
        print("moe " + json.dumps({k: v for k, v in moe.items()
                                   if k not in ("step_losses", "moe_aux")}),
              flush=True)
        moe["layer_gpu_vs_cpu"] = moe_layer_gpu_vs_cpu(*tshapes[0][:2])
        print("moe_layer " + json.dumps(moe["layer_gpu_vs_cpu"]), flush=True)
        report["moe"] = moe
        report["dist_two_ranks"] = check_two_ranks(two_ranks)
        print("dist_two_ranks " + json.dumps(report["dist_two_ranks"]),
              flush=True)
        report["dist_world1"] = dist_world1(train_data, dict_path)
        print("dist_world1 " + json.dumps(report["dist_world1"]), flush=True)
        report["moe_dist_wall_s"] = time.perf_counter() - t0
        lap("moe_dist")

        # ---- slice 7: streaming through its entry points
        cfg_s32 = write_stream_config("float32")
        cfg_s16 = write_stream_config("bfloat16")
        ckpt_s = os.path.join(WORK, "stream_model.pt")
        torch.save(random_model_state(
            torch.Generator().manual_seed(SEED + 7), STREAM_MODEL_CONF),
            ckpt_s)
        t0 = time.perf_counter()
        report["stream"] = stream_checks(cfg_s32, ckpt_s, manifest)
        report["stream"]["checks_wall_s"] = time.perf_counter() - t0
        lap("stream_checks")
        with K3Trace() as trace:
            report["stream_cli"] = stream_cli_runs(
                cfg_s32, cfg_s16, ckpt_s, manifest, dict_path, t_enc)
        stream_launches = sum(r["k3_launches"]
                              for r in report["stream_cli"])
        chunk_tally = Counter(c[:2] for c in trace.calls)
        routes = Counter(c[2] for c in trace.calls)
        if sum(chunk_tally.values()) != stream_launches \
                or set(routes) != {"tma"}:
            raise AssertionError(f"K3 trace {chunk_tally} {routes} vs "
                                 f"count {stream_launches}")
        report["stream_k3_routes"] = dict(routes)
        report["stream_k3_shapes"] = {f"{list(k[0])} {k[1]}": v
                                      for k, v in chunk_tally.items()}
        report["stream_idle"] = stream_idle(cfg_s32, ckpt_s, manifest)
        print("stream_idle " + json.dumps(report["stream_idle"]), flush=True)
        lap("stream_cli_idle")

        # ---- slice 8: serving and int8 through their entry points
        t0 = time.perf_counter()
        report["serve"] = serve_checks(cfg_s32, ckpt_s, manifest, dict_path)
        report["serve_endpoint"] = serve_endpoint(cfg_s32, ckpt_s, manifest,
                                                  dict_path)
        report["int8"] = int8_checks(cfg_s32, ckpt_s, cfg32, ckpt, manifest,
                                     dict_path, report["serve"]["finals"])
        report["serve_int8_wall_s"] = time.perf_counter() - t0
        lap("serve_int8")
        # K3's launches at the chunk-step shape while serving
        serve_launches = (report["serve"]["k3_launches"]
                          + report["serve"]["profiled_k3_launches"]
                          + report["int8"]["serve"]["k3_launches"])
        shape = f"{[SERVE_SLOTS, 14 + CHUNK, 256]} float32"
        report["stream_k3_shapes"][shape] = \
            report["stream_k3_shapes"].get(shape, 0) + serve_launches
        report["stream_training"] = stream_training(train_data, cv_data,
                                                    dict_path)
        print("stream_training " + json.dumps(
            {k: v for k, v in report["stream_training"].items()
             if k != "cv"}), flush=True)
        stream_train_k3 = report["stream_training"]["launches"]
        train_counts = {k: v + stream_train_k3[k] + moe["launches"][k]
                        for k, v in train_counts.items()}
        lap("stream_training")

        report["train_step_gpu_vs_cpu"] = gpu_vs_cpu_step(train_data,
                                                          dict_path)
        print("train_step_gpu_vs_cpu "
              + json.dumps(report["train_step_gpu_vs_cpu"]), flush=True)
        report["overfit"] = overfit(train_data, dict_path)
        print("overfit " + json.dumps(report["overfit"]), flush=True)
        lap("gpu_vs_cpu_overfit")

        # ---- slice 11: WeNet pre-trained fine-tuning
        report["finetune"] = finetune(manifest, dict_path, train_data,
                                      cv_data)
        print("finetune " + json.dumps(
            {k: v for k, v in report["finetune"].items()
             if k not in ("step_losses", "cmvn_file_losses")}), flush=True)
        lap("finetune")

        # ---- slice 12: the LibriSpeech recipe, kaldi ark input, the
        # other input layers and ctc_impl parallel
        report["librispeech"] = librispeech(step_ms)
        print("librispeech " + json.dumps(
            {k: v for k, v in report["librispeech"].items()
             if k not in ("step_losses", "k3_shapes", "trace_names",
                          "k31_cases", "ctc_cases",
                          "ctc_global_plans")}), flush=True)
        for case in report["librispeech"]["ctc_cases"]:
            print("CTC LibriSpeech " + json.dumps(case), flush=True)
        for case in report["librispeech"]["k31_cases"]:
            print("K3 K=31 " + json.dumps(case), flush=True)
        lap("librispeech")

        # ---- slice 15: the recipe script, stages 0-4 on the card
        timed = {("fwd", *r["shape"], r["k"], r["dtype"]): r
                 for r in rows if "ms" in r}
        timed.update({("bwd", *r["shape"], r["k"], r["dtype"]): r
                      for r in grad_rows if "dgrad_ms" in r})
        timed.update({("ctc", *r["shape"]): r for r in ctc_rows
                      if "ms" in r})
        # phase 19's child processes run beside phase 17's script: both
        # are bound by their CLIs' starts; phase 17 waits for them
        # before it times a kernel
        corpus_ready = threading.Event()
        stream_script = Background(streaming_drive_script, corpus_ready)
        moe_script = Background(moe_drive_script, corpus_ready)
        rs = report["recipe_script"] = recipe_script(
            step_ms, timed,
            wait=lambda: (stream_script.join(), moe_script.join()))
        print("recipe_script " + json.dumps(
            {k: v for k, v in rs.items() if k not in ("step_losses",
                                                       "cases")}),
              flush=True)
        for name, case in rs["cases"].items():
            print(f"recipe_script {name} " + json.dumps(case), flush=True)
        print(f"recipe_script phase {rs['phase_s']:.1f} s, stages "
              + ", ".join(f"{k} {v:.1f} s" for k, v in rs["stage_s"].items()),
              flush=True)
        lap("recipe_script")

        # ---- slice 16: the quality drive's corpus, configs and a
        # training step at its full width and batch
        qc = report["quality_corpus"] = quality_corpus(step_ms, timed)
        print("quality_corpus init_draw " + json.dumps(qc["init_draw"]),
              flush=True)
        print("quality_corpus " + json.dumps(
            {k: v for k, v in qc.items() if k != "cases"}), flush=True)
        for name, case in qc["cases"].items():
            print(f"quality_corpus {name} " + json.dumps(case), flush=True)
        print(f"quality_corpus phase {qc['phase_s']:.1f} s", flush=True)
        lap("quality_corpus")

        # ---- slice 17: the streamed quality drive at one epoch (its
        # script ran beside phase 17's)
        sd = report["streaming_drive"] = streaming_drive(
            stream_script.join(), step_ms, timed)
        print("streaming_drive " + json.dumps(
            {k: v for k, v in sd.items() if k != "cases"}), flush=True)
        for name, case in sd["cases"].items():
            print(f"streaming_drive {name} " + json.dumps(case), flush=True)
        print(f"streaming_drive script {sd['script_s']:.1f} s beside phase "
              f"17, checks {sd['checks_s']:.1f} s", flush=True)
        lap("streaming_drive")

        # ---- slice 18: the MoE drive at one epoch on phase 19's corpus
        # (its script ran beside phase 17's and the streamed leg's)
        md = report["moe_drive"] = moe_drive(moe_script.join(), step_ms,
                                             timed)
        print("moe_drive " + json.dumps(
            {k: v for k, v in md.items() if k != "cases"}), flush=True)
        for name, case in md["cases"].items():
            print(f"moe_drive {name} " + json.dumps(case), flush=True)
        print(f"moe_drive script {md['script_s']:.1f} s beside phase 17, "
              f"checks {md['checks_s']:.1f} s", flush=True)
        lap("moe_drive")
    finally:
        for bg in (stream_script, moe_script):
            if bg is not None:
                bg.stop()
        shutil.rmtree(WORK, ignore_errors=True)
    report["wall_s"] = time.perf_counter() - t_start

    # the JSON line reports each kernel at the main path's largest shape,
    # float32 for K3
    k3 = next(r for r in rows if r["dtype"] == "float32"
              and (*r["shape"], r["k"]) == main_shapes[-1])
    largest = max(train_grad_shapes, key=lambda s: s[0] * s[1])
    k3b = next(r for r in grad_rows if r["dtype"] == "float32"
               and (*r["shape"], r["k"]) == largest)

    def train_ctc(variant):
        cands = [r for r in ctc_rows[:len(train_ctc_shapes)]
                 if r["variant"] == variant]
        return max(cands, key=lambda r: math.prod(r["shape"]))

    # this slice's distributed steps: pp2, pp2_tail and sp_tp2 over their
    # two ranks, and the pipe = 1 step on NCCL
    n = Counter(train_counts)
    for name in NEW_DIST_CASES:
        n.update(report["dist_two_ranks"][name]["launches"])
    n.update(report["dist_world1"]["pp1"]["launches"])
    n.update(report["finetune"]["launches"])
    ls = report["librispeech"]
    for run in ([ls["launches"], ls["kaldi"]["train_launches"],
                 ls["kaldi"]["decode_launches"]]
                + [d["launches"] for d in ls["decodes"]]):
        n.update(run)
    rs = report["recipe_script"]
    n.update(rs["counts"]["launches"])
    kernels = [
        _kernel_row("depthwise_conv1d", "openeat_torch/csrc/depthwise_conv.cu",
                    "openeat_tpu/ops/depthwise_conv.py:39",
                    decode_launches + n["depthwise_conv1d"]
                    + report["recipe"]["k3_launches"] + stream_launches
                    + serve_launches
                    + report["int8"]["recognize"]["k3_launches"]
                    + sum(d["k3_launches"]
                          for d in report["finetune"]["decodes"]), k3),
        _kernel_row("depthwise_conv1d_dgrad",
                    "openeat_torch/csrc/depthwise_conv.cu",
                    "openeat_tpu/ops/depthwise_conv.py:114",
                    n["depthwise_conv1d_dgrad"], k3b, "dgrad_"),
        _kernel_row("depthwise_conv1d_wgrad",
                    "openeat_torch/csrc/depthwise_conv.cu",
                    "openeat_tpu/ops/depthwise_conv.py:119",
                    n["depthwise_conv1d_wgrad"], k3b, "wgrad_"),
        _kernel_row("ctc_dp_shared", "openeat_torch/csrc/ctc_loss.cu",
                    "openeat_tpu/ops/ctc_loss.py:251",
                    n["ctc_dp_shared"], train_ctc("shared")),
        _kernel_row("ctc_dp_global", "openeat_torch/csrc/ctc_loss.cu",
                    "openeat_tpu/ops/ctc_loss.py:139",
                    n["ctc_dp_global"], train_ctc("global")),
    ]
    for row, case in ((kernels[3], train_ctc("shared")),
                      (kernels[4], train_ctc("global"))):
        row["chain_bound_ms"] = case["chain_bound_ms"]
    # K3 at the streaming chunk step's shapes: launches are those of the
    # stream_recognize runs and the servers at that shape and dtype
    for case in chunk_rows:
        shape = f"{case['shape']} {case['dtype']}"
        kernels.append(dict(
            _kernel_row("depthwise_conv1d", "openeat_torch/csrc/"
                        "depthwise_conv.cu",
                        "openeat_tpu/ops/depthwise_conv.py:39",
                        report["stream_k3_shapes"].get(shape, 0), case),
            shape=case["shape"], dtype=case["dtype"],
            copy_ms=case["copy_ms"]))
    # K3 at K = 31 (the LibriSpeech model) at the training run's shapes in
    # its dtype, with the launches each wrapper counted at that shape in
    # that run; the float32 cases, which the run does not launch, are in
    # chip_smoke.json
    source = "openeat_torch/csrc/depthwise_conv.cu"
    for case in ls["k31_cases"]:
        if not case["launches"]["fwd"]:
            continue
        extra = {"shape": case["shape"], "k": 31, "dtype": case["dtype"]}
        kernels.append(dict(_kernel_row(
            "depthwise_conv1d", source,
            "openeat_tpu/ops/depthwise_conv.py:39", case["launches"]["fwd"],
            case["fwd"]), **extra))
        for name, line in (("dgrad", 114), ("wgrad", 119)):
            kernels.append(dict(_kernel_row(
                f"depthwise_conv1d_{name}", source,
                f"openeat_tpu/ops/depthwise_conv.py:{line}",
                case["launches"][name], case["bwd"], f"{name}_"), **extra))
    # K1 and K2 at the LibriSpeech run's largest T x S of each, with that
    # run's launches there
    for case in ls["ctc_cases"]:
        if "ms" not in case:
            continue
        name, line = {"shared": ("ctc_dp_shared", 251),
                      "global": ("ctc_dp_global", 139)}[case["variant"]]
        kernels.append(dict(_kernel_row(
            name, "openeat_torch/csrc/ctc_loss.cu",
            f"openeat_tpu/ops/ctc_loss.py:{line}", case["launches"], case),
            shape=case["shape"], chain_bound_ms=case["chain_bound_ms"]))
    # each kernel at the largest shape the recipe script (phase 17), the
    # quality drive's training step (phase 18) and the streamed and MoE
    # drives' CLIs (phase 19) launched it at, with
    # the script's launches at all its shapes (its CLIs counted them in
    # their own processes) and the largest error over those shapes
    for phase, cases in (("recipe_script", rs["cases"]),
                         ("quality_corpus", qc["cases"]),
                         ("streaming_drive", sd["cases"]),
                         ("moe_drive", md["cases"])):
        for name, case in cases.items():
            src, replaces, prefix = KERNEL_OF[name]
            row = _kernel_row(name, src, replaces, case["launches"],
                              case["row"], prefix)
            row.update(max_abs_err=case["max_abs_err"],
                       shape=case["row"]["shape"],
                       shape_launches=case["shape_launches"], phase=phase)
            if name.startswith("ctc"):
                row["chain_bound_ms"] = case["row"]["chain_bound_ms"]
            else:
                row.update(k=case["row"]["k"], dtype=case["row"]["dtype"])
            kernels.append(row)
    chunk = sd["chunk_case"]
    kernels.append(dict(
        _kernel_row("depthwise_conv1d", "openeat_torch/csrc/depthwise_conv.cu",
                    "openeat_tpu/ops/depthwise_conv.py:39",
                    chunk["launches"], chunk),
        shape=chunk["shape"], k=chunk["k"], dtype=chunk["dtype"],
        copy_ms=chunk["copy_ms"], phase="streaming_drive"))
    # the update's multi-tensor kernels at each benchmark configuration's
    # parameter list, with the launches of a bf16 Adam training without a
    # mesh: the flagship's bin.train runs (slice 2) beside AIShell's list,
    # the LibriSpeech phase's two profiled steps beside LibriSpeech's
    for case, (counts, phase) in zip(
            report["multi_tensor"], ((train_run["mt_launches"], "train_run"),
                                     (ls["mt_launches"], "profiled_step"))):
        for name, fn in (("gather", "gather"), ("norm", "global_norm"),
                         ("adam", "adam"), ("mirror", "write_mirror")):
            kernels.append(dict(_kernel_row(
                f"mt_{name}", "openeat_torch/csrc/multi_tensor.cu",
                "none: optax's clip + adam, one XLA program", counts[fn],
                case["times"][name]), config=case["config"], phase=phase))
    report["kernels"] = kernels
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print("phase_s " + json.dumps(phase_s), flush=True)
    print(f"wall {report['wall_s']:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


ROLES = {"dist_world1": dist_world1_role, "dist_rank": dist_rank_role,
         "counted_cli": counted_cli, "multi_tensor": multi_tensor_role}

if __name__ == "__main__":
    import sys
    if len(sys.argv) > 1:   # a dist rank or a recipe CLI (ROLES)
        ROLES[sys.argv[1]](*sys.argv[2:])
    else:
        main()
