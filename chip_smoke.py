#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ml_audio_inpainting_torch``) on one NVIDIA
card: the quickest proof that the port builds, runs and agrees with itself.

    python3 chip_smoke.py

Phases, each printing one flushed line per step with the seconds since start:

1. device     -- the card's name, count and power limit (raises without CUDA);
2. build      -- one ``nvcc`` call a source, ``csrc/lstm_fwd.cu``,
                 ``csrc/lstm_bwd.cu`` and ``csrc/batchnorm.cu``, and one
                 ``g++`` call for the audio
                 codec ``native/audioio.cpp``, all started together; prints
                 the times and ptxas' register / shared-memory / spill
                 reports;
3. kernel     -- the forward LSTM kernel ``lstm_fwd`` (both directions of a
                 layer in one launch, on thread-block clusters of 8 CTAs
                 that hold W_hh on chip) against its plain PyTorch version,
                 h and c of both directions, at B=32 (serving), B=25
                 (training) and B=128 (T=417, H=128), TF32 off; two launches
                 must agree bit for bit; the launch plans (rows a cluster,
                 cluster, grid, shared memory) and ptxas' registers, spills
                 and stack; CUDA-event times of each batch as its path runs
                 it and at every choice of rows a cluster, of the plain
                 version, and of cuDNN's ``nn.LSTM`` on layer 1's
                 shapes as the library yardstick (the port never calls it)
                 beside the port's projection + ``lstm_fwd``;
4. kernel_bwd -- the backward kernels ``lstm_bwd`` (reverse-time sweep, one
                 thread-block cluster per 4 batch rows and direction) and
                 ``lstm_dwhh`` (split-K dW_hh reduction, two passes) against
                 the plain backward at the training shapes (B=25, T=417,
                 H=128, both directions), TF32 off; two launches must agree
                 bit for bit; the launch plans (cluster, grid, shared memory)
                 and ptxas' registers and spills; CUDA-event times, the plain
                 version's (for dW_hh a cuBLAS product), ``torch.bmm`` for
                 dW_hh, and cuDNN's ``nn.LSTM`` backward on layer 1's shapes
                 beside the port's projection + ``lstm_fwd`` + ``lstm_bwd`` +
                 ``lstm_dwhh``; then the same kernels checked and timed once at
                 B=128, the batch of ``cnn_blstm_formant_v2_b128_r4.npz``;
4b. kernel_bf16 -- the bf16 forms of the three kernels against their plain
                 versions in bf16 on the card (f32 carries and sums, bf16
                 stores; every product on the tensor cores: the forward's
                 from three bf16 pieces of the f32 h, the backward's dh
                 carry from three of the f32 dgates, dW_hh summed from the
                 pair (dxw, lo)), at the production recipe's batch (B=128)
                 and at B=25, T=417, H=128: every bf16 output within one bf16
                 ulp of the plain version's plus the f32 bound, dxw + lo
                 within 1e-4 of the plain f32 dgates; two launches bit for
                 bit; the bf16 kernels' launch plans, max active clusters
                 and ptxas' registers and spills; CUDA-event times (the
                 forward at each row choice too), the plain
                 versions', both bounds (the f32-FMA figure, and the bf16
                 forms' bytes and tensor-core products), cuBLAS's
                 ``h_prev^T @ dgates`` (f32, one a direction) and cuDNN's
                 ``nn.LSTM(256, 128, bidirectional=True)`` in bf16, forward
                 and backward, on layer 1's shapes as the yardsticks (the port
                 calls neither);
4c. batchnorm -- the train-mode BatchNorm + ReLU kernels
                 (``ops/cuda/batchnorm.py``, ``csrc/batchnorm.cu``) at the
                 bf16 step's five layers (B=128, 257 x 417, C = 16, 32, 64,
                 32, 16): forward and backward against their plain version on
                 the card (y and dx within a bf16 step of their value plus
                 1e-5 of their largest entry; the plain backward from the
                 kernels' statistics); CUDA-event times beside the
                 function's bound (4 bytes an element forward, 6 backward, at
                 3.35 TB/s), the design's traffic (6 and 10), the plain
                 version's, and ``F.batch_norm(training=True)`` + ``relu`` in
                 bf16 as the library yardstick (the port never calls it).
                 The LeakyReLU(0.2) form at each of the GAN generator's
                 thirteen layers (their shapes read off a forward of the
                 recipe's generator), bf16 at B=32 and f32 at B=8, as
                 gan_training runs them: y, the running statistics, dx,
                 dweight and dbias against the plain version on the card
                 (the bounds of the ``gpu`` tests), and the kernels' times;
5. serving    -- the CNN+BiLSTM runner with the committed
                 ``results/checkpoints/cnn_blstm_formant_v2_r2.npz`` answers 3
                 requests of 32 seeded speech-like 5 s clips with an 80 ms gap
                 at 2.0 s (``oracle``, ``oracle``, ``impaired``); ``lstm_fwd``
                 must launch 3 times a request (one a layer, both directions in
                 one launch) and the backward kernels never; clip 0 is held
                 against the port on the CPU;
6. gan_serving -- the JAX package's main path, ``bench.py``'s canonical line:
                 the GAN runner (``make_gan_runner``, PConv U-Net at its
                 default widths) with the committed
                 ``results/checkpoints/gan_formant_v2_r2.npz``, STFT
                 512/128/512, ``mode="enhanced"``, ``phase="oracle"``, through
                 the gap-only PCM16 transport (2048-sample window), on B=32
                 clips of 5 s from the port's ``SyntheticSpeechDataset`` with
                 an 80 ms gap at 2.0 s; in f32 (TF32 off) and in bf16: the
                 first request's seconds, 3 warm requests, 5 repeats of a
                 10-deep pipelined loop (request i+1 launched before request
                 i's payload is read on the host) as s-audio/s, peak memory,
                 host syncs inside a request, the bound from the shapes;
                 ``mode="parity"``: one timed request.  Checks: clip 0 in
                 both modes on the card against the port on the CPU (f32) and
                 in bf16 against the card's f32; the generator's output
                 finite; the composited clip equal to the input outside the
                 gap bit for bit; the host composite of the payload equal to
                 a full-clip PCM16 fetch, int16 for int16; no hand-written
                 kernel launched (the path has none);
6b. serving_deployable -- serving with no oracle, full width, the committed
                 ``gan_formant_v2_r2.npz`` and ``cnn_blstm_formant_v2_r2.npz``:
                 the GAN runner on ``gan_serving``'s batch under
                 ``extrapolate`` and ``griffinlim`` (64 iterations) in f32 and
                 ``extrapolate`` in bf16; the GAN and CNN+BiLSTM mask-driven
                 functions on 3 seeded gaps a clip; the GAN shift ensemble (4
                 shifts); the CNN+BiLSTM runner under ``extrapolate`` (3
                 ``lstm_fwd`` launches a request); long-form serving of a
                 seeded 60 s signal with 8 gaps, centered with PCM16 patches
                 (GAN) and by overlap-add (CNN+BiLSTM).  For each: the first
                 request's seconds, 3 warm requests (ms, s-audio/s), host
                 syncs inside a request (0, or it fails), peak memory.
                 Checks: every sample outside the gaps equal to the input, bit
                 for bit; clip 0 (long-form: gap 0) against the port on the
                 CPU; Griffin-Lim's spectrum no less consistent with its
                 magnitude than the ``extrapolate`` estimate it starts from;
                 bf16 against f32; no hand-written kernel on the GAN
                 functions;
6c. evaluation -- file-in/file-out serving and evaluation at full width,
                 the committed ``gan_formant_v2_r2.npz`` and
                 ``cnn_blstm_formant_v2_r2.npz``, default configs: 32 seeded
                 speech-like 5 s clips written as 16-bit FLAC by the port's
                 ``save_audio`` and read back (MD5 verified, equal to the
                 16-bit quantisation bit for bit; encode and decode timed);
                 each metric (gap SDR, SNR, LSD, fwSegSNR, PSM, ODG) at B=32
                 on the card (CUDA-event ms, first call, peak memory); the
                 port's ``evaluate`` CLI in-process over the 32 files (80 ms
                 gap at 2.0 s), one JSON each: the GAN (``enhanced``) under
                 ``oracle``, ``extrapolate`` in f32 and bf16, ``griffinlim``
                 (64 iterations), the CNN+BiLSTM under ``oracle`` and
                 ``extrapolate``, both with 3 gaps a clip under
                 ``extrapolate``; the quality table of each (means), the
                 wall-time split of one run a family (read, model, metrics);
                 the same regimes on the three committed formant FLACs, on
                 the card against the CLI on the CPU (``--device cpu``) per
                 clip; the ``inpaint`` CLI on the 32 files (GAN
                 ``extrapolate``) and ``--longform`` on a seeded 60 s file
                 (CNN+BiLSTM), each output equal to ``save_audio`` of the
                 runner's output on the card, bit for bit; ``lstm_fwd``
                 launched 3 times a CNN+BiLSTM request, nothing else;
7. training   -- the recipe of ``configs/cnn_blstm.yaml`` (1 clip x 25 gap
                 variants of 0.2 s, Adam at lr 1e-4, full width) takes 5 steps
                 on seeded clips and gap starts, twice: from the committed
                 checkpoint, and from it with its BiLSTM weights redrawn
                 (the checkpoint's BiLSTM is saturated, so no gradient
                 reaches it or the encoder, in either package).  Each step
                 must launch every kernel 3 times (one a BiLSTM layer) and
                 the BatchNorm kernels once a layer each way (5 and 5), and
                 give a finite loss; every parameter with a gradient must
                 move (from the redrawn BiLSTM: every parameter); step 0's
                 loss and gradients on a reduced batch (1 clip x 2 variants)
                 are held against the port's step in float64 on the CPU from
                 both starts; the
                 trained weights are exported to the JAX package's npz format
                 and serve one request;
8. training_bf16 -- the JAX package's production recipe
                 (``configs/cnn_blstm_b128.yaml`` with 3 gaps a clip,
                 ``train/recipe.py::b128_recipe_config``: 128 clips x 1
                 variant x 3 gaps of up to 0.2 s, Adam at lr 3e-4, full
                 width) in bf16 (``compute_dtype=torch.bfloat16``: f32
                 masters, bf16 network), 5 steps from the committed
                 ``cnn_blstm_formant_v2_b128_r4.npz`` and 5 from it with its
                 BiLSTM redrawn (its BiLSTM is saturated, as v2_r2's): warm
                 step ms (median of steps 1-4), s-audio/s (128 x 5 s a step),
                 peak memory; each step must launch each of the three
                 kernels 3 times and the BatchNorm kernels 5 times each way,
                 all in bf16, and no f32 form; step 0's loss
                 and every gradient are held against an f32 step on the card
                 from the same weights and batch;
9. gan_training -- the JAX package's fastest GAN recipe
                 (``train/recipe.py::gan_recipe_config``: ``configs/gan.yaml``
                 at B=32 clips of 5 s x 4 gaps of up to 0.2 s, all six loss
                 terms with VGG19 from the port's seeded initialiser, Adam at
                 lr 2e-4, betas (0.5, 0.999), EMA 0.999, full width): a
                 64-clip ``formant_v2`` corpus synthesised on 8 threads and
                 uploaded once (``data/pipeline.py::device_corpus_feed``,
                 timed); G from the committed ``gan_formant_v2_r2.npz``, D
                 seeded.  5 bf16 steps: step ms, warm step (median of steps
                 1-4), s-audio/s (32 x 5 s a step), peak memory, host syncs
                 in a step (0, or it fails), the device's idle share of one
                 traced step; every loss finite; every parameter with a
                 gradient moves (those with none are named); the EMA weights
                 exported to the npz format serve ``gan_serving``'s request
                 (``enhanced``, ``oracle``, PCM16 patches), equal to the input
                 outside the gap bit for bit.  Then 3 steps with ``remat``; 4
                 f32 steps (TF32 off) at the reference's B=8 (f32 at B=32
                 does not fit: B=8 peaks at 29 GB).  Checks, at step 0 of
                 the first batch's first 2 clips, VGG on: the card in f32
                 against the port's f64 step on the CPU, the f64 step
                 taking the card's branch at every kink (losses, every
                 gradient, D's u and sigma); the bf16 step on the card
                 against the card's f32 step, and a control, the bf16 step
                 with every cast rounded through float8_e5m2, which must
                 fall outside the same bounds; no LSTM kernel launched (the
                 path has none); the BatchNorm kernels launched in bf16 by
                 the bf16 runs, and in f32 by the f32 run and the f32 check
                 (whose tape records the fused kernels' branches).
9b. training_cli -- the training CLI (``cli/train.py``) in-process on the
                 card: the CNN+BiLSTM production recipe
                 (``b128_recipe_config`` as a JSON ``--config``, bf16,
                 B=128 x 3 gaps, the device feed, EMA 0.999) over a 128-clip
                 formant_v2 corpus for 8 steps with a 32-clip probe every 4
                 and saves at steps 4 and 8: 3 bf16 launches of each kernel
                 a step and 3 f32 ``lstm_fwd`` a probe, finite losses, the
                 checkpoints and ``best_inference.npz`` where the intervals
                 put them, 0 host syncs in the steps after which no interval
                 work ran; ``inpaint --checkpoint best_inference.npz`` equal,
                 bit for bit, to a runner of the restored best state; the
                 saved state restored bit for bit, one step from it equal to
                 one step from the state in memory (deterministic cuDNN),
                 and ``--resume-from`` one step on.  The phase-mode CNN,
                 anchored, at ``configs/cnn_blstm.yaml``'s values (1 clip x
                 25 variants, f32): step 0 plain and anchored on the card
                 against f64 on the CPU, 3 steps through the CLI (3 f32
                 launches a step), then its checkpoint directory served by
                 ``inpaint`` and ``evaluate`` (``cnn_phase_anchored``) on
                 the card against the CPU over 4 synthetic FLACs and the
                 formant FLACs.  Seeded reference-layout ``.pt`` files (full
                 width, and the global-pool lineage at hidden 64) through
                 ``inpaint``, card against CPU.  The GAN recipe
                 (``gan_recipe_config``, bf16, B=32, EMA) for 6 steps: a
                 sample FLAC, ``{g, d}`` restored bit for bit, no LSTM
                 kernel.  Prints the CLI's warm step against
                 the bare steps of ``training_bf16`` and ``gan_training``,
                 save and restore seconds and MB, and the probe's seconds;
10. classical -- the classical family at the CLI's defaults, built by the
                 port's ``inpaint`` CLI (``_build_runner``): ``arinpaint``,
                 ``janssen``, ``segmentation`` (p=512, context 4096,
                 ``maxit`` 10), ``aspain``, ``sspain``, ``aspain_learned``,
                 ``sspain_learned`` (100 iterations) and ``sspain_omp`` (30),
                 then ``--ar-preset tuned`` for arinpaint and janssen at 80 ms
                 and for janssen at 200 ms (context 16384, max_gap 4096,
                 banded), each on B=32 synthetic 5 s clips in f32 on the
                 card: first call s, warm ms, s-audio/s, peak memory, host
                 syncs in a request (0, or it fails), device operations a
                 request and the idle share of one traced request.  Checks:
                 the input outside the gap bit for bit; the same solve in f64
                 on the card against the port in f64 on the CPU (clip 0);
                 f32 against f64 on the card, per clip gap SDR; janssen under
                 torch's global TF32 switch equal to it switched off, and the
                 switch left as it was.  A quality table (gap SDR, PSM) over
                 the synthetic clips and the formant FLACs; then the
                 ``inpaint`` (arinpaint, tuned) and ``evaluate`` (janssen and
                 arinpaint, tuned) CLIs over the formant FLACs on the card
                 against the same CLIs on the CPU; no hand-written kernel
                 launched (the family has none);
11. refiner   -- the gap refiner (``train/refiner_trainer.py``): the committed
                 ``gan_formant_v2_r2.npz`` under ``extrapolate``, the AR fill
                 (p=512) and the committed ``refiner_formant_v2_r3.npz`` head
                 (C=64) on B=32 synthetic 5 s clips, f32, TF32 off: first
                 request s, warm ms, s-audio/s, peak memory, host syncs in a
                 request (0, or it fails), and the CUDA-event ms of the GAN,
                 the AR fill and the head each alone.  Checks: the input
                 outside the gap bit for bit; clip 0 against the port on the
                 CPU; a fresh head equal to the AR fill bit for bit.  Gap SDR
                 of the refined and AR fills with bootstrap intervals over
                 the synthetic clips and the formant FLACs (a record); the
                 ``inpaint`` and ``evaluate`` (refiner, arinpaint tuned) CLIs
                 on the FLACs, card against CPU.  ``cli/train_refiner.py``
                 for 20 steps at its defaults (B=8, C=64) on a 64-clip
                 formant_v2 corpus with a 16-clip probe every 10 (0 host
                 syncs in the steps between them); the bare warm step's
                 mean time on the wall clock; step 0 of the head on
                 the card (f32) against the CPU (f64); the export and its
                 soup with the committed head (``cli/soup.py``) served by
                 ``inpaint``.  ``evaluate --models gan --adapt-steps 10
                 --adapt-probe-every 5`` on the FLACs, the runner's generator
                 bit for bit as before.  ``ops/refine``'s
                 ``consistent_reconstruct`` (100 iterations) and
                 ``magnitude_descent`` (50 steps, an AR term) on the GAN's
                 magnitude from the AR fill at B=32: times, 0 host syncs, f64
                 card against CPU.  No hand-written kernel launched.
12. corpus_tools -- the corpus and tuning CLIs in-process, each on the card
                 and on the CPU (``--device cpu``): ``preprocess`` over a
                 nested tree of 64 seeded speech-like 5 s clips (one random
                 100 ms gap a file; files/s; every output its input with one
                 run of 1600 zeros, the card's files the CPU's bit for bit);
                 ``build_gaps_table --mode multi --write-audio`` over the same
                 tree (10 gaps of 10-80 ms a file, 4096 samples apart and
                 from the edges; the tables equal, the faded audio within one
                 LSB); ``ar_tune`` on the formant FLACs for arinpaint (4 grid
                 points) and Janssen (2), each row's probe score card against
                 CPU, the time of each grid point, and one traced probe
                 request of the winner (device operations, wall time an
                 operation, idle share); ``evaluate --golden`` with the
                 committed GAN and CNN+BiLSTM checkpoints over the formant
                 FLACs (``formant_1`` as the anchor clip ``81-121543-0008``)
                 and a golden directory of the port's tuned arinpaint output,
                 card against CPU; ``lstm_fwd`` launched by the CNN+BiLSTM,
                 nothing else.  ``ar_plots`` and ``utils/tb_analysis.py`` do
                 not run here: they need matplotlib and tensorboard, which
                 the card's machine lacks.
13. multi_device -- multi-device training and serving on
                 ``torch.distributed`` (``ml_audio_inpainting_torch/parallel/``).
                 The machine has one card, so it measures overhead, never
                 scaling.  One rank in this process on an NCCL group
                 (``FileStore``, mesh 1 x 1): ``make_sharded_serving_fn``
                 over ``gan_serving``'s request and the production CNN step
                 (bf16, 128 x 3 gaps, ``cnn_blstm_formant_v2_b128_r4.npz``
                 with its BiLSTM redrawn) through ``make_sharded_step``, each
                 equal to the bare form bit for bit.  NCCL's refusal of two
                 ranks on one card, quoted.  Two ranks sharing the card
                 (gloo, ``parallel/launch.py::spawn``): data 1 x model 2,
                 the production step in bf16 and ``configs/cnn_blstm.yaml``'s
                 in f32 (1 x 25, TF32 off), both from a redrawn BiLSTM, with
                 layer 0's ``w_ih`` and the ``projection`` split, against
                 the one-rank step (loss, every parameter, the running
                 statistics) and the two ranks' states equal, each rank
                 launching all six kernel forms 3 times; data 2 x model 1,
                 the GAN recipe step (bf16, 16 clips a rank, VGG19, EMA)
                 and sharded serving of the GAN main path, against one
                 rank; then ``cli/train.py --model-parallel 2`` (the
                 production recipe, 2 steps): its save equal to the gathered
                 state, restored on 1 x 2 bit for bit and into one rank,
                 and ``--resume-from`` it one step on.  Last,
                 ``scaling_bench --devices 1 2 --steps 5``: steps/s and the
                 loss drift.  Bounds named ``MD_*`` (``tests/test_parallel.py``'s);
                 each run's seconds, peak memory a rank and backend; the
                 ranks' kernel launches count under ``multi_device``.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero before the last line.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._pytree import tree_map

from ml_audio_inpainting_torch.ops.cuda import batchnorm, lstm_cell
from ml_audio_inpainting_torch.ops.cuda.lstm_cell import (
    BWD_THREADS,
    FWD_ROW_CHOICES,
    FWD_THREADS,
    bilstm_dwhh,
    bilstm_forward,
    bilstm_recurrence_backward,
    bilstm_recurrence_reference,
    bf16_residual,
    bwd_mma_layout,
    bwd_mma_plan,
    bwd_plan,
    dwhh_mma_plan,
    dwhh_plan,
    dwhh_reference,
    fwd_mma_layout,
    fwd_mma_plan,
    fwd_plan,
    fwd_smem_bytes,
    load_library,
    lstm_recurrence_backward_reference,
)
from ml_audio_inpainting_torch.classical.arinpaint import arinpaint
from ml_audio_inpainting_torch.cli import (
    ar_tune,
    build_gaps_table,
    evaluate,
    inpaint,
    preprocess,
    train_refiner,
)
from ml_audio_inpainting_torch.cli import scaling_bench
from ml_audio_inpainting_torch.cli import soup as soup_cli
from ml_audio_inpainting_torch.cli import train as train_cli
from ml_audio_inpainting_torch.data import audio_io
from ml_audio_inpainting_torch.data.audio_io import read_audio, save_audio
from ml_audio_inpainting_torch.data.dataset import FormantSpeechDataset
from ml_audio_inpainting_torch.data.multigap import multi_gap_mask
from ml_audio_inpainting_torch.data.pipeline import device_corpus_feed
from ml_audio_inpainting_torch.data.probe import load_real_probe_set
from ml_audio_inpainting_torch.models.build import build_generator, build_model
from ml_audio_inpainting_torch.models.cnn_blstm import FlaxBatchNorm2d
from ml_audio_inpainting_torch.models.port_torch import seeded_reference_cnn_state_dict
from ml_audio_inpainting_torch.models.refiner import WaveRefiner
from ml_audio_inpainting_torch.models.pconv_unet import LEAKY_SLOPE
from ml_audio_inpainting_torch.models.vgg import vgg19_params
from ml_audio_inpainting_torch.ops import masking
from ml_audio_inpainting_torch.ops.gaps import frame_mask_from_interval, gap_mask
from ml_audio_inpainting_torch.ops.linalg import lpc
from ml_audio_inpainting_torch.ops.lstm import BiLSTM
from ml_audio_inpainting_torch.ops.pcm import to_pcm16
from ml_audio_inpainting_torch.ops.phase import window_clear_frame_mask
from ml_audio_inpainting_torch.ops.refine import consistent_reconstruct, magnitude_descent
from ml_audio_inpainting_torch.ops.stft import stft
from ml_audio_inpainting_torch.parallel.launch import spawn
from ml_audio_inpainting_torch.parallel.mesh import initialize_distributed, make_mesh, shard_batch
from ml_audio_inpainting_torch.parallel.sharding import gather_state, make_sharded_step, place_state
from ml_audio_inpainting_torch.runtime.inference import (
    make_cnn_inpaint_fn,
    make_cnn_inpaint_mask_fn,
    make_gan_inpaint_fn,
    make_gan_inpaint_mask_fn,
    make_sharded_serving_fn,
    make_tta_shift_fn,
)
from ml_audio_inpainting_torch.runtime.longform import longform_inpaint, longform_inpaint_centered
from ml_audio_inpainting_torch.runtime.serve import load_generator, make_cnn_runner, make_gan_runner
from ml_audio_inpainting_torch.runtime.transport import (
    DEFAULT_PATCH_WINDOW,
    composite_gap_patch,
    composite_gap_patches_1d,
)
from ml_audio_inpainting_torch.runtime.synthetic import (
    BATCH,
    GAP_LEN,
    GAP_START,
    SAMPLE_RATE,
    gan_config,
    speech_like_batch,
    synthetic_dataset_batch,
)
from ml_audio_inpainting_torch.train import auditory, gan_trainer, metrics, peaq
from ml_audio_inpainting_torch.train.checkpoints import (
    CheckpointManager,
    export_params_npz,
    load_state_tree,
    state_tree,
)
from ml_audio_inpainting_torch.train.cnn_trainer import create_cnn_state, make_cnn_train_step
from ml_audio_inpainting_torch.train.features import gan_features
from ml_audio_inpainting_torch.train.gan_trainer import create_gan_states, make_gan_train_step
from ml_audio_inpainting_torch.train.recipe import (
    b128_recipe_config,
    gan_gap_layouts,
    gan_recipe_config,
    gap_starts,
    live_bilstm,
    multi_gap_layouts,
    recipe_config,
)
from ml_audio_inpainting_torch.train.refiner_trainer import (
    MAX_GAP,
    _gap_loss,
    create_refiner_state,
    draw_refiner_gaps,
    load_refiner,
    make_example_fn,
    make_refiner_apply_fn,
    make_refiner_train_step,
)
from ml_audio_inpainting_torch.utils.branch_tape import branch_tape
from ml_audio_inpainting_torch.utils.config import Config, load_config
from ml_audio_inpainting_torch.utils.precision import cast_floating, full_f32_convolutions
from ml_audio_inpainting_torch.utils.stats import bootstrap_ci
from ml_audio_inpainting_torch.weights import (
    cnn_blstm_flat_variables,
    load_params_npz,
    refiner_state_dict,
)
from scripts.torch_classical_precision import CLASSICAL_RUNS, classical_runner
from scripts.torch_cnn_serving_profile import busy_us

DEVICE = "cuda"
REPO = Path(__file__).resolve().parent
CHECKPOINT = REPO / "results" / "checkpoints" / "cnn_blstm_formant_v2_r2.npz"
GAN_CHECKPOINT = REPO / "results" / "checkpoints" / "gan_formant_v2_r2.npz"
B128_CHECKPOINT = REPO / "results" / "checkpoints" / "cnn_blstm_formant_v2_b128_r4.npz"
T0 = time.perf_counter()

# Published peaks of one H100 SXM (NVIDIA data sheet, at the full 700 W):
# HBM bandwidth, and f32 FMA outside the tensor cores (the kernel's math).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense, on the tensor cores

B, T, H = BATCH, 417, 128  # serving shapes of one sweep
B_TRAIN = 25  # the training recipe's 1 clip x 25 gap variants
B_LARGE = 128  # the batch of cnn_blstm_formant_v2_b128_r4.npz
KERNEL_ATOL = 1e-4  # f32 dots over H=128 in the kernel's order vs cuBLAS', over 417 steps
CUDNN_ATOL = 1e-4  # the same, plus cuDNN's own projection and gate order
CPU_ATOL = 1e-4  # one clip on the card vs the CPU: every sum in another order
# lstm_bwd's dxw against the plain backward: f32 dots over H and 4H in another
# order, carried through 417 reverse steps.
DXW_ATOL = 1e-4
# lstm_dwhh's dW_hh: a sum of B*T = 10 425 outer products in another order
# than cuBLAS', held within 1e-4 of the largest entry of dW_hh.
DWHH_RTOL_OF_MAX = 1e-4
# Training step 0 on the card in f32 vs the port's step in f64 on the CPU
# (1 clip x 2 variants, full width, TF32 off, the same weights and inputs):
# the loss to 1e-4 relative; each gradient tensor within 1e-3 of its largest
# entry.  What is left is the card's own f32 rounding; the worst tensor is
# the most ill-conditioned, a BatchNorm bias's gradient (a sum of 214 000
# terms of both signs): on an H100, enc_bn1.bias from the redrawn BiLSTM
# lies 6.5e-4 of its largest entry from f64 (the same in repeated runs; the
# port's f32 step on the CPU, 4.3e-4), and 1e-3 leaves 1.5x that for another
# choice of cuDNN algorithm, whose sums run in another order.  The conv biases in front of BatchNorm have an exact
# gradient of zero (the batch mean removes them), so theirs are the card's
# rounding noise and are held within the same bound of the model's largest
# gradient entry; so are the tensors whose f64 gradient lies below f32's
# resolution of it (from the committed checkpoint the saturated BiLSTM's,
# ~1e-13 of it in f64 and exactly zero in f32).
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL_OF_MAX = 1e-3
F32_EPS = float(np.finfo(np.float32).eps)
NOISE_GRAD = {"enc_conv0.bias", "enc_conv1.bias", "enc_conv2.bias", "dec_conv0.bias",
              "dec_conv1.bias"}
TRAIN_STEPS = 5
# GAN serving.  Clip 0 on the card in f32 (TF32 off) against the port on the
# CPU: every sum in another order (the CPU tests hold the port to JAX within
# 2e-5 on the waveform).  bf16 against the card's f32: the generator in bf16
# moves its Tanh output by ~2e-2 and the waveform by ~4e-4 (the port on the
# CPU, one 5 s clip of this batch, both modes); 5e-3 leaves room for cuDNN's
# own bf16 algorithms.
GAN_CPU_ATOL = 1e-4
GAN_BF16_ATOL = 5e-3
GAN_WARM = 3
GAN_DEPTH, GAN_REPEATS = 10, 5
# The bf16 kernels against their plain versions in bf16 on the card: both
# carry and sum in f32, where they differ as the f32 kernels do (the f32
# bounds above), and then round to bf16, where a value near a rounding
# boundary can land one bf16 ulp apart: each bf16 output within one bf16
# ulp of the plain version's plus the f32 bound; the f32 dgates within
# DXW_ATOL.  cuDNN's bf16 nn.LSTM is a yardstick of time only; its output
# is held to a sanity bound (h in (-1, 1); its bf16 recurrence rounds
# elsewhere).
CUDNN_BF16_SANITY = 0.1
# training_bf16's step 0 in bf16 against an f32 step on the card (same
# weights, batch and gaps): bf16 keeps 8 bits, and the L1 loss's gradient
# flips its sign where a prediction lies within that noise of its target.
# The port on the CPU, full width, 4 clips of this recipe: the loss 4e-5 to
# 8e-5 apart, each gradient tensor within 0.14 of its own L2 norm, the conv
# biases in front of BatchNorm (exact gradient zero: rounding noise in both)
# within 1.8e-4 of the largest tensor's norm.  Bounds: loss 1e-3 relative;
# gradients 0.3 of their L2 norm; the noise-only biases, and tensors whose
# f32 gradient is exactly zero (the saturated BiLSTM's), 1e-2 of the largest
# tensor's norm.
# serving_deployable.  Clip 0 on the card against the port on the CPU, inside
# the gaps (outside them both are the input, bit for bit), as a share of the
# CPU's largest |sample| in the gaps.  The extrapolated phase reaches |steps *
# dphi| of ~2.5e4 rad (62 frames at up to 402 rad a hop in the top bins), where
# an f32 ulp is 2e-3 rad, and the card divides by a constant as a product with
# its reciprocal, so princarg can wrap a turn elsewhere and the f32 sum then
# rounds another way (the generator itself agrees within 6e-7).  GAN under
# extrapolate (interval, mask, shift ensemble): 2e-2 (seen 5.8e-6, 4.7e-3 by
# mask, 7.3e-6); its long-form PCM16 patches within 1 + 2e-2 * peak LSB (seen
# 1).  CNN+BiLSTM under extrapolate (interval, mask, long-form): 5e-3 (seen
# 1.4e-3, 4.6e-4, 9.5e-6).
# Griffin-Lim's waveform in a gap is not a stable function of its inputs (a
# 1e-7 change of the clip moves the committed GAN's 80 ms gap by 7e-2 of its
# peak after 64 iterations, on the CPU), so at 64 iterations clip 0's STFT
# magnitude over the estimated frames is held within 5e-2 in relative L2 norm
# (seen 1.5e-2), and the same distance between Griffin-Lim's output and the
# extrapolate estimate it starts from (the control, 0.194 on the CPU) must be
# at least twice that bound; at 4 iterations the waveform, within 1e-2 of
# the gaps' peak (the 1e-7 change moves it by 8.5e-4 there).  Over the batch,
# Griffin-Lim must leave the spectrum at most 0.95 times as inconsistent as
# its start (seen 0.4263 against 0.4754).
GAN_DEPLOYABLE_RTOL = 2e-2
CNN_DEPLOYABLE_RTOL = 5e-3
GL_SPEC_RTOL = 5e-2
GL4_RTOL = 1e-2
GL_MIN_GAIN = 0.95
GL_ITERS = 64
TTA_SHIFTS = 4
LONG_S, LONG_GAPS = 60.0, 8
BF16_STEP_LOSS_RTOL = 1e-3
BF16_GRAD_L2_RTOL = 0.3
BF16_NOISE_OF_MAX_NORM = 1e-2
# gan_training: the JAX package's fastest GAN recipe (train/recipe.py::
# gan_recipe_config, bf16, B=32, 4 gaps a clip, VGG19 on, EMA 0.999) on the
# formant_v2 corpus through the device-resident feed.  The checks run step 0
# of the first batch's first 2 clips, VGG on, from the same weights; the
# readings behind every bound are scripts/torch_gan_step_precision.py's at
# that batch.  Card f32 against the port's f64 step on the CPU, the f64 step
# taking the card's branch at every kink (LeakyReLU, ReLU, max pool:
# utils/branch_tape.py; on an H100 397 LeakyReLU or ReLU inputs and 129 534
# pool windows went another way than in f64, and without the replay D's
# block3_conv bias lay 2.1e-3 of its largest entry from f64, with it every
# gradient within 1.5e-5): the losses within 1e-4 relative; each gradient within
# 1e-3 of its largest entry (or of the largest over both networks where its
# own lies below f32's resolution of that), the CNN step's bound; D's u and
# sigma after the D step within 1e-5 (unit vectors; sigmas relative).  The
# card's bf16 step against its f32 step, each bound about three times the
# port's bf16-vs-f32 reading on the CPU at this batch (losses 3.0e-3;
# gradients 0.106 of their L2 norm, g.enc0.norm.bias; u 1.4e-3; sigma
# 1.1e-2): losses 1e-2 relative, each gradient 0.3 of its own L2 norm, u
# 5e-3, sigma 2e-2 relative.  Exempt: D's final bias, one scalar whose
# gradient is the mean sigmoid of the real logits plus that of the fake
# ones less 1, two means near 0.5 whose small difference bf16's rounding of
# the logits swamps (0.302 of its norm on the CPU and on an H100); its
# reading is logged.  The control, the bf16
# step with every cast rounded through float8_e5m2, must fall outside these
# bounds (on the CPU: losses 1.3e-2, u 3.5e-2, 12 gradients beyond 0.3).
GAN_TRAIN_STEPS, GAN_REMAT_STEPS, GAN_F32_STEPS = 5, 3, 4
GAN_F32_BATCH = 8
GAN_CORPUS_ITEMS = 64
GAN_EMA = 0.999
GAN_CHECK_CLIPS = 2
GAN_SN_ATOL = 1e-5
GAN_STEP_GRAD_RTOL_OF_MAX = 1e-3
GAN_BF16_LOSS_RTOL = 1e-2
GAN_BF16_GRAD_L2_RTOL = 0.3
GAN_BF16_GRAD_EXEMPT = ("d.final_conv.bias",)
GAN_BF16_U_ATOL = 5e-3
GAN_BF16_SIGMA_RTOL = 2e-2


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {phase}: {msg}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events."""
    for _ in range(warmup):
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


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log("device", f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                  f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def ptxas_report(output: str) -> dict:
    """Kernel name -> registers, static shared memory, stack frame and
    spills, from ptxas' ``-v`` report.  An instance of a kernel template is
    named with its integer arguments, e.g. ``lstm_fwd_kernel<2,4>`` (Rows,
    KQ), ``lstm_fwd_mma_kernel<8>``; f32 is left out, and a bf16 type
    argument is ``bf16`` (``lstm_dwhh_reduce_kernel<bf16>``)."""
    report, name = {}, None
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:  # the mangled name holds <name>[I<template arguments>E]
            found = re.search(r"((?:lstm|bn)_[a-z_]*?kernel)(I(?:f|13__nv_bfloat16|Li\d+E)*E)?(?=[EI])",
                              m.group(1))
            if found:
                args = ["bf16" if a == "13__nv_bfloat16" else a[2:-1]
                        for a in re.findall(r"13__nv_bfloat16|Li\d+E", found.group(2) or "")]
                name = found.group(1) + (f"<{','.join(args)}>" if args else "")
            else:
                name = m.group(1)
            report[name] = {"registers": 0, "smem_bytes": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            report[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return report


def phase_build() -> dict:
    """Builds every source from nothing, in parallel: the two kernel sources
    (``nvcc``) and the audio codec (``g++``); returns ptxas' report of every
    kernel."""
    shutil.rmtree(lstm_cell.BUILD_DIR, ignore_errors=True)  # time a build from nothing
    names = list(lstm_cell.SOURCES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:  # one compiler a source, all at once
        codec = pool.submit(audio_io.load_library)
        libs = dict(zip(names, pool.map(load_library, names)))
        codec = codec.result()
    log("build", f"{len(names)} kernel sources and the audio codec in "
                 f"{time.perf_counter() - t0:.2f} s (in parallel)")
    log("build", f"g++ {' '.join(audio_io.CXX_FLAGS)} native/audioio.cpp -> {codec.path.name} in "
                 f"{codec.build_seconds:.2f} s")
    report = {}
    for name, lib in libs.items():
        log("build", f"nvcc {' '.join(lstm_cell.NVCC_FLAGS)} {name}.cu -> {lib.path.name} "
                     f"in {lib.build_seconds:.2f} s")
        for line in lib.compiler_output.splitlines():
            if line.strip():
                log("build", f"  {line.strip()}")
        report.update(ptxas_report(lib.compiler_output))
    for kernel, r in report.items():
        log("build", f"{kernel}: {r}")
    return report


def roofline(bytes_moved: float, flops: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time at the H100's peaks."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _forward_inputs(b: int, seed: int) -> tuple:
    """Seeded (xw_f, w_f, xw_b, w_b) of a layer on the card: xw ~ N(0, 1),
    W_hh ~ U(-1/sqrt(H), 1/sqrt(H))."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    bound = 1.0 / math.sqrt(H)
    xw_f, xw_b = (torch.tensor(rng.standard_normal((b, T, 4 * H)).astype(np.float32), device=dev)
                  for _ in range(2))
    w_f, w_b = (torch.tensor(rng.uniform(-bound, bound, (H, 4 * H)).astype(np.float32), device=dev)
                for _ in range(2))
    return xw_f, w_f, xw_b, w_b


def _forward_bound(b: int, with_c: bool, elem: int = 4) -> tuple:
    """(ms, by) of lstm_fwd at batch b, both directions, elements of
    ``elem`` bytes: xw and W_hh read once, h (and c) written once; h @ W_hh
    each step, in f32 FMA.  For bf16 this is the f32-FMA figure;
    :func:`_bf16_forward_bounds` is the bf16 form's own."""
    bytes_moved = 2 * elem * (b * T * 4 * H + H * 4 * H + (2 if with_c else 1) * b * T * H)
    flops = 2 * 2 * b * T * H * 4 * H
    return roofline(bytes_moved, flops)


def _layer_pair(dtype: torch.dtype) -> tuple:
    """cuDNN's ``nn.LSTM(256, 128, bidirectional=True)`` (layer 1's shapes)
    and the port's ``BiLSTM`` layer with the same weights, on the card in
    ``dtype``: the library yardstick (the port never calls it)."""
    dev = torch.device(DEVICE)
    cudnn = torch.nn.LSTM(2 * H, H, batch_first=True, bidirectional=True).to(dev, dtype)
    port = BiLSTM(2 * H, H, 1).to(dev, dtype)
    with torch.no_grad():
        port.load_state_dict({
            f"l0_{direction}_{name}": value
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))
            for name, value in (
                ("w_ih", getattr(cudnn, f"weight_ih_l0{suffix}").T),
                ("w_hh", getattr(cudnn, f"weight_hh_l0{suffix}").T),
                ("b", getattr(cudnn, f"bias_ih_l0{suffix}") + getattr(cudnn, f"bias_hh_l0{suffix}")),
            )
        })
    return cudnn, port


def phase_kernel(card: str, ptxas: dict) -> dict:
    """lstm_fwd against its plain version, h and c of both directions, at
    the serving batch (B=32), the training batch (B=25) and B=128; two
    launches bitwise equal; its launch plans, ptxas reports and times, each
    batch as its path runs it (serving h alone, training h and c), and at
    every choice of rows a cluster; cuDNN's layer-1 forward as the library
    yardstick."""
    dev = torch.device(DEVICE)
    smem_of = load_library("lstm_fwd").cdll.lstm_fwd_smem_bytes
    runs = {}
    for b, seed, with_c in ((B, 0, False), (B_TRAIN, 1, True), (B_LARGE, 3, True)):
        layer = _forward_inputs(b, seed)
        plan = fwd_plan(b, H)
        smem = smem_of(H, plan.rows, plan.cluster, plan.ksplit)
        if smem != fwd_smem_bytes(plan):
            raise AssertionError(f"lstm_fwd shared memory: source {smem}, plan "
                                 f"{fwd_smem_bytes(plan)} bytes")
        launch = {"rows": plan.rows, "cluster": plan.cluster, "grid": list(plan.grid),
                  "threads": FWD_THREADS, "dynamic_smem_bytes": smem,
                  "units_per_cta": plan.units, "ksplit": plan.ksplit}
        instance = ptxas.get(f"lstm_fwd_kernel<{plan.rows},{plan.ksplit}>")
        log("kernel", f"lstm_fwd launch at B={b}: {launch}; ptxas {instance}")
        with torch.inference_mode():
            h, c = bilstm_forward(*layer, with_c=True)
            again = bilstm_forward(*layer, with_c=True)
            torch.cuda.synchronize()
            want_h, want_c = bilstm_recurrence_reference(*layer, return_c=True)
            err = 0.0
            for name, sl in (("forward", slice(0, H)), ("backward", slice(H, 2 * H))):
                e_h = (h[..., sl] - want_h[..., sl]).abs().max().item()
                e_c = (c[..., sl] - want_c[..., sl]).abs().max().item()
                log("kernel", f"B={b} {name}: max |kernel - plain| h {e_h:.3e}, c {e_c:.3e} "
                              f"(atol {KERNEL_ATOL})")
                if not (e_h <= KERNEL_ATOL and e_c <= KERNEL_ATOL):
                    raise AssertionError(f"lstm_fwd (B={b} {name}) disagrees with its plain "
                                         f"version: h {e_h}, c {e_c} > {KERNEL_ATOL}")
                err = max(err, e_h, e_c)
            if not (torch.equal(h, again[0]) and torch.equal(c, again[1])):
                raise AssertionError(f"lstm_fwd is not deterministic at B={b}")
            del h, c, again, want_h, want_c
            ms = cuda_ms(lambda: bilstm_forward(*layer, with_c=with_c), reps=20)
            rows_ms = {r: cuda_ms(lambda: bilstm_forward(*layer, with_c=with_c, rows=r), reps=20)
                       for r in FWD_ROW_CHOICES}
            plain_ms = None
            if b == B:
                plain_ms = cuda_ms(lambda: bilstm_recurrence_reference(*layer), reps=3, warmup=1)
        bound_ms, bound_by = _forward_bound(b, with_c)
        log("kernel", f"B={b}, {'h and c' if with_c else 'h'}: second launch bitwise equal; "
                      f"kernel {ms:.4f} ms (bound {bound_ms:.5f} by {bound_by}); by rows a "
                      f"cluster {rows_ms}" + (f"; plain version {plain_ms:.3f} ms" if plain_ms else "")
                      + f" ({card})")
        runs[b] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                   "with_c": with_c, "launch": launch, "ptxas": instance, "rows_ms": rows_ms,
                   "plain_ms": plain_ms}

    # Library yardstick: cuDNN's bidirectional LSTM on layer 1's shapes
    # (input 2H=256), and the port's projection + kernel for the same work,
    # weights carried across.
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    x1 = torch.tensor(rng.standard_normal((B, T, 2 * H)).astype(np.float32), device=dev)
    cudnn, port = _layer_pair(torch.float32)
    with torch.inference_mode():
        err = (port(x1) - cudnn(x1)[0]).abs().max().item()
        log("kernel", f"port BiLSTM layer vs cuDNN nn.LSTM: max abs err {err:.3e} (atol {CUDNN_ATOL})")
        if not err <= CUDNN_ATOL:
            raise AssertionError(f"port BiLSTM disagrees with cuDNN: {err} > {CUDNN_ATOL}")
        library_ms = cuda_ms(lambda: cudnn(x1), reps=20)
        port_layer_ms = cuda_ms(lambda: port(x1), reps=20)
    log("kernel", f"layer-1 BiLSTM (B={B}, T={T}, 256->2x{H}): cuDNN nn.LSTM {library_ms:.4f} ms, "
                  f"port projection + kernel {port_layer_ms:.4f} ms ({card})")

    main = runs[B]
    return {
        "name": "lstm_fwd",
        "route": "cuda",
        "source": "ml_audio_inpainting_torch/csrc/lstm_fwd.cu",
        "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:40",
        "launches": None,  # filled from the main paths' runs
        "max_abs_err": main["max_abs_err"],
        "max_abs_err_is": "h and c, both directions, B=32",
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": library_ms,
        "library_call": "torch.nn.LSTM(256, 128, bidirectional=True), layer-1 shapes: "
                        "projection and both directions",
        "port_same_work_ms": port_layer_ms,
        "shapes": {"B": B, "T": T, "H": H, "directions": 2},
        "launch": main["launch"],
        "ptxas": main["ptxas"],
        "deterministic": True,
        "rows_ms": {f"B={b}": runs[b]["rows_ms"] for b in runs},
        **{f"b{b}": {k: runs[b][k] for k in ("ms", "bound_ms", "max_abs_err", "with_c", "launch",
                                             "ptxas")}
           for b in (B_TRAIN, B_LARGE)},
    }


def _backward_inputs(b: int, seed: int) -> tuple:
    """Seeded (xw_f, w_f, xw_b, w_b) and incoming gradient g of a layer on
    the card, and lstm_fwd's (h, c) of them."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    scale = 1.0 / math.sqrt(H)
    xw_f, xw_b = (torch.tensor(rng.standard_normal((b, T, 4 * H)).astype(np.float32), device=dev)
                  for _ in range(2))
    w_f, w_b = (torch.tensor(rng.uniform(-scale, scale, (H, 4 * H)).astype(np.float32),
                             device=dev) for _ in range(2))
    g = torch.tensor(rng.standard_normal((b, T, 2 * H)).astype(np.float32), device=dev)
    h, c = bilstm_forward(xw_f, w_f, xw_b, w_b, with_c=True)
    return (xw_f, w_f, xw_b, w_b), g, h, c


def _check_backward(label: str, layer: tuple, g, h, c, dxw: tuple, dw: tuple) -> tuple:
    """Each direction's dxw and dW_hh against the plain backward; returns the
    largest dxw error and the largest dW_hh error relative to max |dW_hh|."""
    xw_f, w_f, xw_b, w_b = layer
    err_dxw = err_dw = 0.0
    for name, sl, xw, w, d_xw, d_w, reverse in (
        ("forward", slice(0, H), xw_f, w_f, dxw[0], dw[0], False),
        ("backward", slice(H, 2 * H), xw_b, w_b, dxw[1], dw[1], True),
    ):
        want_dxw = lstm_recurrence_backward_reference(
            xw, w, h[..., sl], c[..., sl], g[..., sl], reverse=reverse)
        want_dw = dwhh_reference(h[..., sl], want_dxw, reverse)
        e_dxw = (d_xw - want_dxw).abs().max().item()
        e_dw = (d_w - want_dw).abs().max().item()
        dw_max = want_dw.abs().max().item()
        log("kernel_bwd", f"{label} {name}: max |dxw - plain| = {e_dxw:.3e} (atol {DXW_ATOL}); "
                          f"max |dW_hh - plain| = {e_dw:.3e} of max |dW_hh| {dw_max:.3e} "
                          f"(allowed {DWHH_RTOL_OF_MAX} of it)")
        if not e_dxw <= DXW_ATOL:
            raise AssertionError(f"lstm_bwd ({label} {name}) disagrees with its plain version: "
                                 f"{e_dxw} > {DXW_ATOL}")
        if not e_dw <= DWHH_RTOL_OF_MAX * dw_max:
            raise AssertionError(f"lstm_dwhh ({label} {name}) disagrees with its plain version: "
                                 f"{e_dw} > {DWHH_RTOL_OF_MAX} x {dw_max}")
        err_dxw, err_dw = max(err_dxw, e_dxw), max(err_dw, e_dw / dw_max)
    return err_dxw, err_dw


def _backward_bounds(b: int, elem: int = 4) -> tuple:
    """((ms, by) of lstm_bwd, (ms, by) of lstm_dwhh) at batch b, both
    directions, elements of ``elem`` bytes, as the f32 forms compute: the
    sweep reads xw, W_hh, h, c, g once and writes dxw once, and does two
    (B,H)x(H,4H) products a step (gates, dh); the sum reads h and the f32
    dgates (dxw) once and writes dW_hh once, one product of depth B*T.
    Products in f32 FMA.  For bf16 this is the f32-FMA figure of the
    kernels' arithmetic; :func:`_bf16_backward_bounds` is the bf16 forms'."""
    e, f4 = elem, 4
    bwd_bytes = 2 * e * (b * T * 4 * H + H * 4 * H + b * T * 4 * H) + 3 * e * b * T * 2 * H
    bwd_flops = 2 * 2 * (2 * b * T * H * 4 * H)
    dwhh_bytes = e * b * T * 2 * H + f4 * 2 * b * T * 4 * H + e * 2 * H * 4 * H
    dwhh_flops = 2 * (2 * b * T * H * 4 * H)
    log("kernel_bwd", f"B={b}, {e}-byte elements: lstm_bwd moves {bwd_bytes / 1e6:.1f} MB and does "
                      f"{bwd_flops / 1e9:.3f} GFLOP; lstm_dwhh {dwhh_bytes / 1e6:.1f} MB, "
                      f"{dwhh_flops / 1e9:.3f} GFLOP")
    return roofline(bwd_bytes, bwd_flops), roofline(dwhh_bytes, dwhh_flops)


def _bf16_backward_bounds(b: int) -> dict:
    """The bounds of the bf16 backward at batch b, both directions, at the
    H100's HBM rate and bf16 dense peak, each (ms, by, bytes, flop).

    The functions' minimum: "sweep" reads xw, W_hh, h, c, g once and writes
    dxw once and does two (B,H)x(H,4H) products a step (gates, dh); "dwhh"
    reads h and the dgates (as the bf16 pair dxw, lo: the f32 dgates' bytes)
    and writes dW_hh, one product of depth B*T; "b2" is B2 as a whole (the
    sweep and the sum), which reads xw, W_hh, h, c, g and writes dxw and
    dW_hh once, three products.

    The design's traffic: "sweep_design" adds the lo that the sweep writes
    for the sum, and counts the m16n8k16 products it issues (a CTA, a step,
    kc x kh x Rows/8 for the gates and kh x kc x DH_PIECES x Rows/8 for dh,
    over T and T - 1 steps); "dwhh_design" counts the sum's (16 a warp for
    each of dxw and lo per 16 rows of K, over every 32-row stage of every
    slice and column tile)."""
    e, mma = 2, 2 * 16 * 8 * 16
    plan = bwd_mma_plan(b, H)
    lay = bwd_mma_layout(plan)
    n_tiles = plan.rows // 8
    per_cta = (T * lay.kc * lay.kh + (T - 1) * lay.kh * lay.kc * lstm_cell.DH_PIECES) * n_tiles
    product = 2 * (2 * b * T * H * 4 * H)  # one (B*T, H) x (H, 4H) product, both directions
    reads = e * (2 * b * T * 4 * H + 2 * H * 4 * H + 3 * b * T * 2 * H)  # xw, W_hh, h, c, g
    dxw, dw = e * 2 * b * T * 4 * H, e * 2 * H * 4 * H
    dp = dwhh_mma_plan(b, T, H)
    stages = sum(-(-len(dp.rows_of(s)) // lstm_cell.DWHH_MMA_DEPTH) for s in range(dp.slices))
    work = {
        "sweep": (reads + dxw, 2 * product),
        "dwhh": (e * b * T * 2 * H + 2 * dxw + dw, product),
        "b2": (reads + dxw + dw, 3 * product),
        "sweep_design": (reads + 2 * dxw, mma * per_cta * plan.grid[0] * plan.grid[1]),
        "dwhh_design": (e * b * T * 2 * H + 2 * dxw + dw,
                        mma * 2 * dp.tiles_j * stages * (lstm_cell.DWHH_MMA_DEPTH // 16) * 2 * 8 * 16),
    }
    out = {}
    for name, (by, fl) in work.items():
        t_bytes, t_ops = by / HBM_BYTES_PER_S, fl / BF16_FLOP_PER_S
        out[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                     by, fl)
    log("kernel_bf16", "B={}, bf16 backward, bytes and GFLOP: {}".format(b, ", ".join(
        f"{k} {by / 1e6:.1f} MB, {fl / 1e9:.3f} GFLOP (bound {ms:.5f} ms by {bound_by})"
        for k, (ms, bound_by, by, fl) in out.items())))
    return out


def _bf16_forward_bounds(b: int) -> dict:
    """The bounds of the bf16 forward at batch b, both directions, h and c
    written, at the H100's HBM rate and bf16 dense peak, each (ms, by,
    bytes, flop).  "function": its function's minimum, xw and W_hh read
    once, h and c written once (bf16), one (B,H)x(H,4H) product a step;
    "design": the same bytes and the m16n8k16 products that
    lstm_fwd_mma_kernel issues (a tile pair, a step, 2 tiles x ktiles x
    FWD_PIECES, padding included, over every pair of every CTA and T
    steps)."""
    e, mma = 2, 2 * 16 * 8 * 16
    plan = fwd_mma_plan(b, H)
    lay = fwd_mma_layout(plan)
    pairs = lay.ugroups * plan.rows // 8  # tile pairs a CTA (each over all k-tiles)
    issued = T * pairs * 2 * lay.ktiles * lstm_cell.FWD_PIECES * plan.grid[0] * plan.grid[1]
    bytes_moved = e * 2 * (b * T * 4 * H + H * 4 * H + 2 * b * T * H)
    work = {"function": (bytes_moved, 2 * 2 * b * T * H * 4 * H),
            "design": (bytes_moved, mma * issued)}
    out = {}
    for name, (by, fl) in work.items():
        t_bytes, t_ops = by / HBM_BYTES_PER_S, fl / BF16_FLOP_PER_S
        out[name] = (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
                     by, fl)
    log("kernel_bf16", "B={}, bf16 forward, bytes and GFLOP: {}".format(b, ", ".join(
        f"{k} {by / 1e6:.1f} MB, {fl / 1e9:.3f} GFLOP (bound {ms:.5f} ms by {bound_by})"
        for k, (ms, bound_by, by, fl) in out.items())))
    return out


def _bf16_forward_plan(b: int, ptxas: dict) -> dict:
    """The bf16 forward's launch plan at batch b, its dynamic shared memory
    (the launcher's against ``fwd_mma_layout``), the most clusters of its
    configuration the card holds at once, and ptxas' report of its
    instance."""
    cdll = load_library("lstm_fwd").cdll
    plan = fwd_mma_plan(b, H)
    lay = fwd_mma_layout(plan)
    smem = cdll.lstm_fwd_mma_smem_bytes(H, plan.rows, plan.cluster)
    if smem != lay.smem_bytes:
        raise AssertionError(f"fwd_mma_layout says {lay.smem_bytes} bytes, the kernel {smem}")
    clusters = cdll.lstm_fwd_mma_max_clusters(H, plan.rows, plan.cluster)
    if clusters <= 0:
        raise AssertionError(f"cudaOccupancyMaxActiveClusters failed: {clusters}")
    kernel = f"lstm_fwd_mma_kernel<{plan.rows}>"
    return {"kernel": kernel, "rows": plan.rows, "cluster": plan.cluster, "grid": list(plan.grid),
            "ctas": plan.grid[0] * plan.grid[1], "threads": lay.threads,
            "ktiles": lay.ktiles, "pieces": lstm_cell.FWD_PIECES, "dynamic_smem_bytes": smem,
            "max_active_clusters": clusters,
            "waves": -(-plan.grid[0] * plan.grid[1] // (clusters * plan.cluster)),
            "ptxas": ptxas.get(kernel)}


def phase_kernel_bwd(card: str, ptxas: dict) -> list:
    """lstm_bwd and lstm_dwhh against the plain backward at the training
    shapes and at B=128; determinism; their launch plans, times, bounds and
    the library yardsticks."""
    dev = torch.device(DEVICE)
    b = B_TRAIN
    layer, g, h, c = _backward_inputs(b, seed=2)
    xw_f, w_f, xw_b, w_b = layer
    with torch.no_grad():
        dxw_f, dxw_b = bilstm_recurrence_backward(*layer, h, c, g)
        dw_f, dw_b = bilstm_dwhh(h, dxw_f, dxw_b)
        torch.cuda.synchronize()
        err_dxw, err_dw = _check_backward(f"B={b}", layer, g, h, c, (dxw_f, dxw_b), (dw_f, dw_b))

        # Two launches on the same inputs: bit for bit the same.
        again = bilstm_recurrence_backward(*layer, h, c, g)
        again = (*again, *bilstm_dwhh(h, *again))
        same = [torch.equal(x, y) for x, y in zip((dxw_f, dxw_b, dw_f, dw_b), again)]
        log("kernel_bwd", f"second launch bitwise equal (dxw_f, dxw_b, dW_f, dW_b): {same}")
        if not all(same):
            raise AssertionError(f"the backward kernels are not deterministic: {same}")

        bwd_ms = cuda_ms(lambda: bilstm_recurrence_backward(*layer, h, c, g), reps=20)
        dwhh_ms = cuda_ms(lambda: bilstm_dwhh(h, dxw_f, dxw_b), reps=50)
        plain_bwd_ms = cuda_ms(lambda: [lstm_recurrence_backward_reference(
            xw, w, h[..., sl], c[..., sl], g[..., sl], reverse=rev)
            for xw, w, sl, rev in ((xw_f, w_f, slice(0, H), False),
                                   (xw_b, w_b, slice(H, 2 * H), True))], reps=3, warmup=1)
        # The plain dW_hh: shifted copies of h and one cuBLAS product a direction.
        plain_dwhh_ms = cuda_ms(lambda: (dwhh_reference(h[..., :H], dxw_f, False),
                                         dwhh_reference(h[..., H:], dxw_b, True)), reps=20)
        # The reduction as one library call: a batched product over pre-shifted h.
        hp = torch.stack([
            torch.cat([torch.zeros_like(h[:, :1, :H]), h[:, :-1, :H]], dim=1),
            torch.cat([h[:, 1:, H:], torch.zeros_like(h[:, :1, H:])], dim=1),
        ]).reshape(2, b * T, H)
        dxw_both = torch.stack([dxw_f, dxw_b]).reshape(2, b * T, 4 * H)
        lib_dwhh = torch.bmm(hp.transpose(1, 2), dxw_both)
        e_lib = (lib_dwhh - torch.stack([dw_f, dw_b])).abs().max().item()
        log("kernel_bwd", f"dW_hh kernel vs torch.bmm on shifted h: max abs err {e_lib:.3e}")
        library_dwhh_ms = cuda_ms(lambda: torch.bmm(hp.transpose(1, 2), dxw_both), reps=50)
        del hp, dxw_both, lib_dwhh, again
    log("kernel_bwd", f"lstm_bwd {bwd_ms:.4f} ms (plain {plain_bwd_ms:.3f} ms), lstm_dwhh "
                      f"{dwhh_ms:.4f} ms, both passes (plain, cuBLAS on shifted copies, "
                      f"{plain_dwhh_ms:.4f} ms; torch.bmm {library_dwhh_ms:.4f} ms) at B={b}, "
                      f"T={T}, H={H}, both directions ({card})")

    # The batch of cnn_blstm_formant_v2_b128_r4.npz: 64 clusters a direction,
    # more CTAs than SMs.  Checked once, then timed.
    layer_l, g_l, h_l, c_l = _backward_inputs(B_LARGE, seed=3)
    with torch.no_grad():
        dxw_l = bilstm_recurrence_backward(*layer_l, h_l, c_l, g_l)
        dw_l = bilstm_dwhh(h_l, *dxw_l)
        torch.cuda.synchronize()
        err_l = _check_backward(f"B={B_LARGE}", layer_l, g_l, h_l, c_l, dxw_l, dw_l)
        bwd_l_ms = cuda_ms(lambda: bilstm_recurrence_backward(*layer_l, h_l, c_l, g_l), reps=10)
        dwhh_l_ms = cuda_ms(lambda: bilstm_dwhh(h_l, *dxw_l), reps=20)
    (bwd_l_bound, _), (dwhh_l_bound, _) = _backward_bounds(B_LARGE)
    log("kernel_bwd", f"B={B_LARGE}: lstm_bwd {bwd_l_ms:.4f} ms (bound {bwd_l_bound:.5f}), "
                      f"lstm_dwhh {dwhh_l_ms:.4f} ms (bound {dwhh_l_bound:.5f}) ({card})")
    del layer_l, g_l, h_l, c_l, dxw_l, dw_l

    # The launch plans at the training shapes.
    bp, dp = bwd_plan(b, H), dwhh_plan(b, T, H)
    smem = load_library("lstm_bwd").cdll.lstm_bwd_smem_bytes(H, bp.cluster, bp.ksplit)
    bwd_launch = {"cluster": bp.cluster, "grid": list(bp.grid), "threads": BWD_THREADS,
                  "dynamic_smem_bytes": smem, "units_per_cta": bp.units, "ksplit": bp.ksplit}
    dwhh_launch = {"grid": list(dp.grid), "threads": BWD_THREADS, "slices": dp.slices,
                   "rows_per_slice": dp.rows_per_slice,
                   "partials_shape": list(dp.partial_shape)}
    log("kernel_bwd", f"lstm_bwd launch at B={b}: {bwd_launch}; ptxas "
                      f"{ptxas.get('lstm_bwd_kernel')}")
    log("kernel_bwd", f"lstm_dwhh launch at B={b}: {dwhh_launch}; ptxas "
                      f"{ptxas.get('lstm_dwhh_partial_kernel')} and "
                      f"{ptxas.get('lstm_dwhh_reduce_kernel')}")

    # Library yardstick: cuDNN's bidirectional LSTM backward on layer 1's
    # shapes (fwd+bwd minus fwd), beside the port's layer for the same work.
    rng = np.random.default_rng(4)
    torch.manual_seed(0)
    x1 = torch.tensor(rng.standard_normal((b, T, 2 * H)).astype(np.float32), device=dev,
                      requires_grad=True)
    gout = torch.tensor(rng.standard_normal((b, T, 2 * H)).astype(np.float32), device=dev)
    cudnn, port = _layer_pair(torch.float32)
    grads = {}
    for name, layer_fn in (("cudnn", lambda: cudnn(x1)[0]), ("port", lambda: port(x1))):
        params = list(cudnn.parameters() if name == "cudnn" else port.parameters())
        grads[name] = torch.autograd.grad(layer_fn(), [x1, *params], gout)
    e_dx = (grads["port"][0] - grads["cudnn"][0]).abs().max().item()
    log("kernel_bwd", f"port BiLSTM layer backward vs cuDNN: max |dx| err {e_dx:.3e} "
                      f"(atol {CUDNN_ATOL})")
    if not e_dx <= CUDNN_ATOL:
        raise AssertionError(f"port BiLSTM backward disagrees with cuDNN: {e_dx} > {CUDNN_ATOL}")

    def fwd_bwd(layer_fn, params):
        return lambda: torch.autograd.grad(layer_fn(), [x1, *params], gout)

    # Forwards with grad on, as in training (the port's then keeps c).
    cudnn_f = cuda_ms(lambda: cudnn(x1), reps=10)
    port_f = cuda_ms(lambda: port(x1), reps=10)
    cudnn_fb = cuda_ms(fwd_bwd(lambda: cudnn(x1)[0], list(cudnn.parameters())), reps=10)
    port_fb = cuda_ms(fwd_bwd(lambda: port(x1), list(port.parameters())), reps=10)
    library_ms = cudnn_fb - cudnn_f
    log("kernel_bwd", f"layer-1 BiLSTM (B={b}, T={T}, 256->2x{H}): cuDNN nn.LSTM forward "
                      f"{cudnn_f:.4f} ms, forward+backward {cudnn_fb:.4f} ms (backward "
                      f"{library_ms:.4f} ms); port forward {port_f:.4f} ms, forward+backward "
                      f"{port_fb:.4f} ms (backward {port_fb - port_f:.4f} ms) ({card})")

    (bwd_bound, bwd_by), (dwhh_bound, dwhh_by) = _backward_bounds(b)
    log("kernel_bwd", f"bounds at B={b}: lstm_bwd {bwd_bound:.5f} ms by {bwd_by}; lstm_dwhh "
                      f"{dwhh_bound:.5f} ms by {dwhh_by} (H100 SXM peaks)")
    shapes = {"B": b, "T": T, "H": H, "directions": 2}
    return [
        {
            "name": "lstm_bwd",
            "route": "cuda",
            "source": "ml_audio_inpainting_torch/csrc/lstm_bwd.cu",
            "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:64",
            "launches": None,
            "max_abs_err": err_dxw,
            "ms": bwd_ms,
            "plain_ms": plain_bwd_ms,
            "bound_ms": bwd_bound,
            "bound_by": bwd_by,
            "library_ms": library_ms,
            "library_call": "torch.nn.LSTM(256, 128, bidirectional=True) backward, layer-1 "
                            "shapes (forward+backward minus forward)",
            "port_same_work_ms": port_fb - port_f,
            "shapes": shapes,
            "launch": bwd_launch,
            "ptxas": ptxas.get("lstm_bwd_kernel"),
            "deterministic": True,
            "b128": {"ms": bwd_l_ms, "bound_ms": bwd_l_bound, "max_abs_err": err_l[0]},
        },
        {
            "name": "lstm_dwhh",
            "route": "cuda",
            "source": "ml_audio_inpainting_torch/csrc/lstm_bwd.cu",
            "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:109",
            "launches": None,
            "max_abs_err": err_dw,
            "max_abs_err_is": "relative to max |dW_hh|",
            "ms": dwhh_ms,
            "plain_ms": plain_dwhh_ms,
            "plain_is": "dwhh_reference: shifted copies of h and one cuBLAS product a direction",
            "bound_ms": dwhh_bound,
            "bound_by": dwhh_by,
            "library_ms": library_dwhh_ms,
            "library_call": "torch.bmm of the shifted h_prev^T and dxw, both directions",
            "passes": ["lstm_dwhh_partial_kernel", "lstm_dwhh_reduce_kernel"],
            "shapes": shapes,
            "launch": dwhh_launch,
            "ptxas": {k: ptxas.get(k) for k in ("lstm_dwhh_partial_kernel",
                                                  "lstm_dwhh_reduce_kernel")},
            "deterministic": True,
            "b128": {"ms": dwhh_l_ms, "bound_ms": dwhh_l_bound, "max_abs_err": err_l[1]},
        },
    ]


def _bf16_err(label: str, got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    """max |got - want| of a bf16 output against its plain version; raises
    where an entry lies further than one bf16 ulp of ``want`` plus ``atol``."""
    if got.dtype != torch.bfloat16:
        raise AssertionError(f"{label}: {got.dtype}, expected bfloat16")
    err = (got.float() - want.float()).abs()
    mag = want.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    beyond = err - torch.exp2(torch.floor(torch.log2(mag)) - 7) - atol
    if beyond.max().item() > 0:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{int((beyond > 0).sum())} entries beyond one bf16 ulp + {atol}")
    return err.max().item()


def _bf16_inputs(b: int, seed: int) -> tuple:
    """Seeded bf16 (xw_f, w_f, xw_b, w_b) and incoming gradient g of a layer
    on the card: the f32 phases' draws (``_backward_inputs``), rounded."""
    layer, g, _, _ = _backward_inputs(b, seed)
    return tuple(t.to(torch.bfloat16) for t in layer), g.to(torch.bfloat16)


def _cudnn_bf16_yardstick(b: int, seed: int) -> dict:
    """cuDNN's bidirectional LSTM in bf16 on layer 1's shapes at batch b,
    forward and backward (forward+backward minus a forward with grad on),
    beside the port's bf16 layer (projection + lstm_fwd, + lstm_bwd and
    lstm_dwhh) with the same weights."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)
    bf16 = torch.bfloat16
    x1 = torch.tensor(rng.standard_normal((b, T, 2 * H)).astype(np.float32), device=dev).to(bf16)
    x1.requires_grad_(True)
    gout = torch.tensor(rng.standard_normal((b, T, 2 * H)).astype(np.float32), device=dev).to(bf16)
    cudnn, port = _layer_pair(bf16)
    with torch.no_grad():
        err = (port(x1).float() - cudnn(x1)[0].float()).abs().max().item()
    if not err <= CUDNN_BF16_SANITY:
        raise AssertionError(f"port bf16 BiLSTM layer vs cuDNN bf16: {err} > {CUDNN_BF16_SANITY}")

    def fwd_bwd(layer_fn, params):
        return lambda: torch.autograd.grad(layer_fn(), [x1, *params], gout)

    cudnn_f = cuda_ms(lambda: cudnn(x1), reps=10)
    port_f = cuda_ms(lambda: port(x1), reps=10)
    cudnn_fb = cuda_ms(fwd_bwd(lambda: cudnn(x1)[0], list(cudnn.parameters())), reps=10)
    port_fb = cuda_ms(fwd_bwd(lambda: port(x1), list(port.parameters())), reps=10)
    with torch.inference_mode():
        cudnn_inf = cuda_ms(lambda: cudnn(x1), reps=10)
        port_inf = cuda_ms(lambda: port(x1), reps=10)
    return {"max_abs_diff_port_vs_cudnn": err, "cudnn_forward_ms": cudnn_inf,
            "port_forward_ms": port_inf, "cudnn_backward_ms": cudnn_fb - cudnn_f,
            "port_backward_ms": port_fb - port_f}


def _bf16_backward_plan(b: int, ptxas: dict) -> dict:
    """The bf16 sweep's launch plan at batch b, its dynamic shared memory
    (the launcher's against ``bwd_mma_layout``), the most clusters of its
    configuration the card holds at once (cudaOccupancyMaxActiveClusters),
    and ptxas' report of its instance; the bf16 sum's plan."""
    cdll = load_library("lstm_bwd").cdll
    plan, dplan = bwd_mma_plan(b, H), dwhh_mma_plan(b, T, H)
    lay = bwd_mma_layout(plan)
    smem = cdll.lstm_bwd_mma_smem_bytes(H, plan.rows, plan.cluster, plan.ksplit)
    if smem != lay.smem_bytes:
        raise AssertionError(f"bwd_mma_layout says {lay.smem_bytes} bytes, the kernel {smem}")
    clusters = cdll.lstm_bwd_mma_max_clusters(H, plan.rows, plan.cluster, plan.ksplit)
    if clusters <= 0:
        raise AssertionError(f"cudaOccupancyMaxActiveClusters failed: {clusters}")
    tiles = next(t for t in lstm_cell.BWD_MMA_TILE_CHOICES if lay.tiles <= t)
    sweep = f"lstm_bwd_mma_kernel<{plan.rows},{tiles}>"
    vec = 8 if H % 8 == 0 else 4
    return {"sweep": {"kernel": sweep, "rows": plan.rows, "cluster": plan.cluster,
                      "grid": list(plan.grid), "ctas": plan.grid[0] * plan.grid[1],
                      "ksplit": plan.ksplit, "tiles": tiles, "dynamic_smem_bytes": smem,
                      "max_active_clusters": clusters,
                      "waves": -(-plan.grid[0] * plan.grid[1] // (clusters * plan.cluster)),
                      "ptxas": ptxas.get(sweep)},
            "dwhh": {"kernels": [f"lstm_dwhh_mma_kernel<{vec}>", "lstm_dwhh_reduce_kernel<bf16>"],
                     "grid": list(dplan.grid), "slices": dplan.slices,
                     "rows_per_slice": dplan.rows_per_slice,
                     "ptxas": {k: ptxas.get(k) for k in (f"lstm_dwhh_mma_kernel<{vec}>",
                                                          "lstm_dwhh_reduce_kernel<bf16>")}}}


def phase_kernel_bf16(card: str, ptxas: dict) -> list:
    """The bf16 forms of lstm_fwd, lstm_bwd and lstm_dwhh against their plain
    versions in bf16 on the card at B=128 (the production recipe's batch,
    the main path's) and B=25: lstm_fwd's h and c (the tensor-core kernel
    against the plain product of the same bf16 pieces) within one bf16 ulp
    + KERNEL_ATOL, lstm_bwd's dxw within one bf16 ulp + DXW_ATOL and its
    pair dxw + lo within DXW_ATOL of the plain f32 dgates, dW_hh within one
    bf16 ulp + DWHH_RTOL_OF_MAX of its largest entry; two launches bitwise
    equal; the bf16 kernels' launch plans, occupancy and ptxas reports;
    times (lstm_fwd at each row choice too), plain versions' times, both
    bounds (the f32-FMA figure and the bf16 forms' own), cuBLAS's h_prev^T
    @ dgates and cuDNN's bf16 layer as the yardsticks."""
    runs = {}
    for b, seed in ((B_LARGE, 7), (B_TRAIN, 8)):
        layer, g = _bf16_inputs(b, seed)
        xw_f, w_f, xw_b, w_b = layer
        with torch.no_grad():
            h, c = bilstm_forward(*layer, with_c=True)
            again = bilstm_forward(*layer, with_c=True)
            torch.cuda.synchronize()
            want_h, want_c = bilstm_recurrence_reference(*layer, return_c=True)
            err_f = max(_bf16_err(f"lstm_fwd bf16 h (B={b})", h, want_h, KERNEL_ATOL),
                        _bf16_err(f"lstm_fwd bf16 c (B={b})", c, want_c, KERNEL_ATOL))
            same = torch.equal(h, again[0]) and torch.equal(c, again[1])
            del again, want_h, want_c

            out = bilstm_recurrence_backward(*layer, h, c, g, dgates=True)
            dws = bilstm_dwhh(h, *out)
            torch.cuda.synchronize()
            err_b = err_dg = err_w = 0.0
            dgates = []  # the plain f32 dgates, for the yardstick below
            for i, (sl, xw, w, reverse) in enumerate(((slice(0, H), xw_f, w_f, False),
                                                      (slice(H, 2 * H), xw_b, w_b, True))):
                want_dxw, want_dg = lstm_recurrence_backward_reference(
                    xw, w, h[..., sl], c[..., sl], g[..., sl], reverse, return_dgates=True)
                err_b = max(err_b, _bf16_err(f"lstm_bwd bf16 dxw (B={b})", out[i], want_dxw,
                                             DXW_ATOL))
                e_dg = (out[i].float() + out[2 + i].float() - want_dg).abs().max().item()
                if not e_dg <= DXW_ATOL:
                    raise AssertionError(f"lstm_bwd bf16 dxw + lo vs the f32 dgates (B={b}): "
                                         f"{e_dg} > {DXW_ATOL}")
                err_dg = max(err_dg, e_dg)
                want_dw = dwhh_reference(h[..., sl], want_dxw, reverse,
                                         lo=bf16_residual(want_dg, want_dxw))
                dw_max = want_dw.float().abs().max().item()
                err_w = max(err_w, _bf16_err(f"lstm_dwhh bf16 (B={b})", dws[i], want_dw,
                                             DWHH_RTOL_OF_MAX * dw_max) / dw_max)
                dgates.append(want_dg)
                del want_dxw, want_dw
            again = bilstm_recurrence_backward(*layer, h, c, g, dgates=True)
            again = (*again, *bilstm_dwhh(h, *again))
            same = same and all(torch.equal(x, y) for x, y in zip((*out, *dws), again))
            if not same:
                raise AssertionError(f"the bf16 kernels are not deterministic at B={b}")
            del again
            log("kernel_bf16", f"B={b}: max |kernel - plain| lstm_fwd h, c {err_f:.3e}; lstm_bwd "
                               f"dxw {err_b:.3e}, dxw + lo vs the f32 dgates {err_dg:.3e}; "
                               f"lstm_dwhh {err_w:.3e} of max |dW_hh| (each within one bf16 ulp + "
                               f"the f32 bound); second launches bitwise equal")
            fwd_ms = cuda_ms(lambda: bilstm_forward(*layer, with_c=True), reps=20)
            bwd_ms = cuda_ms(lambda: bilstm_recurrence_backward(*layer, h, c, g, dgates=True),
                             reps=10)
            dwhh_ms = cuda_ms(lambda: bilstm_dwhh(h, *out), reps=20)
            # The library yardsticks of the sum, one cuBLAS product a
            # direction on pre-shifted h_prev: [h_prev; h_prev]^T @ [dxw; lo]
            # in bf16 (f32 accumulation, bf16 out: the kernel's function), and
            # h_prev^T @ dgates in f32 (the upcast h and the f32 dgates).
            hp = torch.stack([
                torch.cat([torch.zeros_like(h[:, :1, :H]), h[:, :-1, :H]], dim=1),
                torch.cat([h[:, 1:, H:], torch.zeros_like(h[:, :1, H:])], dim=1),
            ]).reshape(2, b * T, H)
            hp32 = hp.float()
            dg32 = [d.reshape(b * T, 4 * H) for d in dgates]
            hp2 = torch.cat([hp, hp], dim=1)
            pairs = [torch.cat([out[i], out[2 + i]]).reshape(2 * b * T, 4 * H) for i in range(2)]
            lib = {"f32_ms": cuda_ms(lambda: [torch.matmul(hp32[i].T, dg32[i]) for i in range(2)],
                                     reps=20),
                   "bf16_ms": cuda_ms(lambda: [torch.matmul(hp2[i].T, pairs[i]) for i in range(2)],
                                      reps=20)}
            del hp, hp32, dg32, hp2, pairs, dgates
            plain = {}
            if b == B_LARGE:
                plain["fwd"] = cuda_ms(lambda: bilstm_recurrence_reference(*layer, return_c=True),
                                       reps=2, warmup=1)
                plain["bwd"] = cuda_ms(lambda: [lstm_recurrence_backward_reference(
                    xw, w, h[..., sl], c[..., sl], g[..., sl], rev, return_dgates=True)
                    for xw, w, sl, rev in ((xw_f, w_f, slice(0, H), False),
                                           (xw_b, w_b, slice(H, 2 * H), True))],
                    reps=2, warmup=1)
                plain["dwhh"] = cuda_ms(lambda: (dwhh_reference(h[..., :H], out[0], False, out[2]),
                                                 dwhh_reference(h[..., H:], out[1], True, out[3])),
                                        reps=10)
        (fwd_f32, _) = _forward_bound(b, True, elem=2)
        fwd_bounds = _bf16_forward_bounds(b)
        fwd_launch = _bf16_forward_plan(b, ptxas)
        (bwd_f32, _), (dwhh_f32, _) = _backward_bounds(b, elem=2)
        bounds = _bf16_backward_bounds(b)
        launch = _bf16_backward_plan(b, ptxas)
        yard = _cudnn_bf16_yardstick(b, seed)
        log("kernel_bf16", f"B={b}, T={T}, H={H}, both directions: lstm_fwd {fwd_ms:.4f} ms "
                           f"(bound "
                           f"{fwd_bounds['function'][0]:.5f} by {fwd_bounds['function'][1]}; the "
                           f"design's products {fwd_bounds['design'][0]:.5f}; as f32 FMA "
                           f"{fwd_f32:.5f}), lstm_bwd {bwd_ms:.4f} ms (bound "
                           f"{bounds['sweep'][0]:.5f} by {bounds['sweep'][1]}; the design's "
                           f"traffic {bounds['sweep_design'][0]:.5f}; as f32 FMA {bwd_f32:.5f}), "
                           f"lstm_dwhh {dwhh_ms:.4f} ms (bound {bounds['dwhh'][0]:.5f} by "
                           f"{bounds['dwhh'][1]}; as f32 FMA {dwhh_f32:.5f}; cuBLAS bf16 pair "
                           f"[h_prev; h_prev]^T @ [dxw; lo] {lib['bf16_ms']:.4f}, f32 h_prev^T @ "
                           f"dgates {lib['f32_ms']:.4f}); B2 whole (sweep + sum) "
                           f"{bwd_ms + dwhh_ms:.4f} ms against its minimum "
                           f"{bounds['b2'][0]:.5f} by {bounds['b2'][1]}; plain {plain}; layer-1 "
                           f"yardstick {yard} ({card})")
        log("kernel_bf16", f"B={b}: bf16 lstm_fwd launch {fwd_launch}; lstm_bwd launch "
                           f"{launch['sweep']}; lstm_dwhh {launch['dwhh']}")
        runs[b] = {"fwd": {"ms": fwd_ms, "bound_ms": fwd_bounds["function"][0],
                           "bound_by": fwd_bounds["function"][1], "bound_f32_fma_ms": fwd_f32,
                           "bytes": fwd_bounds["function"][2], "flop": fwd_bounds["function"][3],
                           "design_bound_ms": fwd_bounds["design"][0],
                           "design_flop": fwd_bounds["design"][3],
                           "max_abs_err": err_f, "launch": fwd_launch},
                   "bwd": {"ms": bwd_ms, "bound_ms": bounds["sweep"][0],
                           "bound_by": bounds["sweep"][1], "bound_f32_fma_ms": bwd_f32,
                           "bytes": bounds["sweep"][2], "flop": bounds["sweep"][3],
                           "design_bound_ms": bounds["sweep_design"][0],
                           "design_bytes": bounds["sweep_design"][2],
                           "design_flop": bounds["sweep_design"][3],
                           "b2_ms": bwd_ms + dwhh_ms, "b2_bound_ms": bounds["b2"][0],
                           "b2_bound_by": bounds["b2"][1],
                           "max_abs_err": err_b, "pair_vs_f32_dgates_max_abs_err": err_dg,
                           "launch": launch["sweep"]},
                   "dwhh": {"ms": dwhh_ms, "bound_ms": bounds["dwhh"][0],
                            "bound_by": bounds["dwhh"][1], "bound_f32_fma_ms": dwhh_f32,
                            "bytes": bounds["dwhh"][2], "flop": bounds["dwhh"][3],
                            "design_flop": bounds["dwhh_design"][3],
                            "max_abs_err": err_w, "library_ms": lib["bf16_ms"],
                            "library_f32_ms": lib["f32_ms"], "launch": launch["dwhh"]},
                   "plain": plain, "yardstick": yard}
        del layer, g, h, c, out, dws

    main, small = runs[B_LARGE], runs[B_TRAIN]
    shapes = {"B": B_LARGE, "T": T, "H": H, "directions": 2, "dtype": "bfloat16"}
    common = {"route": "cuda", "launches": None, "shapes": shapes, "deterministic": True}
    return [
        {"name": "lstm_fwd_bf16", **common,
         "source": "ml_audio_inpainting_torch/csrc/lstm_fwd.cu",
         "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:40",
         "kernel": main["fwd"]["launch"]["kernel"],
         **main["fwd"], "plain_ms": main["plain"]["fwd"],
         "max_abs_err_is": "h and c, both directions, B=128 (bf16 outputs)",
         "bound_is": "its function (xw, W_hh in, h, c out; one product a step) at 3.35 TB/s and "
                     "989 TFLOP/s; design_* count the m16n8k16 products issued (FWD_PIECES "
                     "pieces of h, padding); bound_f32_fma_ms the same product in f32 FMA",
         "library_ms": main["yardstick"]["cudnn_forward_ms"],
         "library_call": "torch.nn.LSTM(256, 128, bidirectional=True) in bf16, layer-1 shapes: "
                         "projection and both directions",
         "port_same_work_ms": main["yardstick"]["port_forward_ms"],
         "ptxas": main["fwd"]["launch"]["ptxas"],
         "b25": {**small["fwd"], "library_ms": small["yardstick"]["cudnn_forward_ms"],
                 "port_same_work_ms": small["yardstick"]["port_forward_ms"]}},
        {"name": "lstm_bwd_bf16", **common,
         "source": "ml_audio_inpainting_torch/csrc/lstm_bwd.cu",
         "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:64",
         **main["bwd"], "plain_ms": main["plain"]["bwd"],
         "max_abs_err_is": "dxw (bf16), both directions, B=128",
         "bound_is": "the sweep's function (xw, W_hh, h, c, g in, dxw out; gate and dh "
                     "products) at 3.35 TB/s and 989 TFLOP/s; design_* add the lo written for "
                     "the sum and the products issued; b2_* are B2 whole (sweep + sum)",
         "library_ms": main["yardstick"]["cudnn_backward_ms"],
         "library_call": "torch.nn.LSTM(256, 128, bidirectional=True) backward in bf16, "
                         "layer-1 shapes (forward+backward minus forward)",
         "port_same_work_ms": main["yardstick"]["port_backward_ms"],
         "b25": {**small["bwd"], "library_ms": small["yardstick"]["cudnn_backward_ms"],
                 "port_same_work_ms": small["yardstick"]["port_backward_ms"]}},
        {"name": "lstm_dwhh_bf16", **common,
         "source": "ml_audio_inpainting_torch/csrc/lstm_bwd.cu",
         "replaces": "ml_audio_inpainting_tpu/ops/pallas/lstm_cell.py:109",
         **main["dwhh"], "plain_ms": main["plain"]["dwhh"],
         "plain_is": "dwhh_reference: shifted f32 copies of h, two cuBLAS products a direction "
                     "(dxw, lo)",
         "max_abs_err_is": "relative to max |dW_hh| (bf16 output)",
         "bound_is": "h, dxw and lo in, dW_hh out, one product of depth B*T, at 3.35 TB/s and "
                     "989 TFLOP/s",
         "library_call": "torch.matmul([h_prev; h_prev]^T, [dxw; lo]) in bf16, one a direction "
                         "(the kernel's function); library_f32_ms: h_prev^T @ dgates in f32",
         "b25": small["dwhh"]},
    ]


KERNELS = lstm_cell.KERNELS
_counts = lstm_cell.kernel_launches
_reset_counts = lstm_cell.reset_kernel_launches


# The bf16 step's BatchNorm layers (encoder 16-32-64, decoder 32-16) at
# B=128 over 257 x 417 bins.
BN_LAYERS = (("enc_bn0", 16), ("enc_bn1", 32), ("enc_bn2", 64), ("dec_bn0", 32), ("dec_bn1", 16))
BN_PLANE = (257, 417)
BN_BATCH = 128


def _bn_check(label: str, got: torch.Tensor, want: torch.Tensor, scale=None,
              two_steps: bool = False) -> float:
    """The worst distance of an output from the plain version's, in units
    of its bound (1e-5 of ``scale``, by default the largest entry, plus a
    bf16 step of the value in bf16, or two for a value rounded twice);
    raises above 1."""
    step = (2 if two_steps else 1) * 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    got, want = got.double(), want.double()
    bound = step * want.abs() + 1e-5 * (want.abs().max() if scale is None else scale)
    worst = ((got - want).abs() / bound).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{label}: {worst:.3f} of the bound")
    return worst


def phase_batchnorm(card: str, ptxas: dict) -> list:
    """The BatchNorm + ReLU kernels in bf16 at the bf16 step's five layers:
    checked against the plain version, timed beside their bounds, the plain
    version and the library's ``F.batch_norm(training=True)`` + ``relu``."""
    dev = torch.device(DEVICE)
    for name, r in ptxas.items():
        if name.startswith("bn_"):
            log("batchnorm", f"{name}: {r}")
    rows = []
    eps, keep = 1e-5, 0.99
    for layer, C in BN_LAYERS:
        shape = (BN_BATCH, C, *BN_PLANE)
        n = math.prod(shape)
        rng = np.random.default_rng(C)
        gen = torch.Generator(dev).manual_seed(C)
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.float32, device=dev)
        b = torch.tensor(rng.standard_normal(C), dtype=torch.float32, device=dev)
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)

        def stats():
            return (torch.zeros(C, device=dev), torch.ones(C, device=dev),
                    torch.zeros((), dtype=torch.int64, device=dev))

        st = stats()
        y, saved, counter = batchnorm.forward_kernel(x, wb, bb, *st, True, eps, keep, 0.0)
        dx, _, _ = batchnorm.backward_kernel(dy, x, wb, bb, saved, counter, eps, 0.0)
        py, _ = batchnorm.forward_reference(x, wb, bb, *stats(), True, eps, keep, 0.0)
        pdx, _, _ = batchnorm.backward_reference(dy, x, wb, bb, saved, eps, 0.0)
        errs = {"y": _bn_check(f"{layer} y", y, py), "dx": _bn_check(f"{layer} dx", dx, pdx)}
        del py, pdx
        kernel_f = cuda_ms(lambda: batchnorm.forward_kernel(x, wb, bb, *st, True, eps, keep, 0.0),
                           reps=20)
        kernel_b = cuda_ms(lambda: batchnorm.backward_kernel(dy, x, wb, bb, saved, counter, eps,
                                                             0.0), reps=20)
        plain_f = cuda_ms(lambda: batchnorm.forward_reference(x, wb, bb, *st, True, eps, keep,
                                                              0.0), reps=5)
        plain_b = cuda_ms(lambda: batchnorm.backward_reference(dy, x, wb, bb, saved, eps, 0.0),
                          reps=5)
        xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))

        def library():
            return torch.relu(F.batch_norm(xl, st[0], st[1], wl, bl, True, 1.0 - keep, eps))

        library_f = cuda_ms(library, reps=20)
        library_fb = cuda_ms(lambda: torch.autograd.grad(library(), [xl, wl, bl], dy), reps=20)
        for pas, kernel_ms, plain_ms, library_ms, least_b, design_b in (
                ("forward", kernel_f, plain_f, library_f, 4, 6),
                ("backward", kernel_b, plain_b, library_fb - library_f, 6, 10)):
            bound = 1e3 * least_b * n / HBM_BYTES_PER_S
            row = {"name": f"batchnorm {layer} {pas}", "shape": list(shape), "dtype": "bf16",
                   "kernel_ms": kernel_ms, "bound_ms": bound, "bound_by": "bytes",
                   "roofline_share": bound / kernel_ms,
                   "design_ms": 1e3 * design_b * n / HBM_BYTES_PER_S,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "max_err_of_bound": errs["y" if pas == "forward" else "dx"], "card": card}
            log("batchnorm", json.dumps(row))
            rows.append(row)
        del x, dy, y, dx, xl, saved
        torch.cuda.empty_cache()
    total = {pas: sum(r["kernel_ms"] for r in rows if r["name"].endswith(pas))
             for pas in ("forward", "backward")}
    log("batchnorm", f"five layers: forward {total['forward']:.3f} ms, backward "
                     f"{total['backward']:.3f} ms of kernels a step")
    return rows + _bn_gan_rows(card)


def _bn_gan_layers() -> list:
    """``(name, (C, H, W))`` of each BatchNorm layer of the GAN recipe's
    generator over one clip's spectrogram, in call order."""
    cfg = gan_recipe_config()
    dev = torch.device(DEVICE)
    feats = gan_features(torch.zeros(1, cfg.data.max_samples, device=dev),
                         torch.zeros(1, dtype=torch.int64, device=dev), cfg.data.spectrogram,
                         cfg.data.gap_len_s, cfg.data.sample_rate)
    gen = build_generator(cfg, dev)
    layers = []
    hooks = [m.register_forward_pre_hook(
        lambda _, args, name=name: layers.append((name, tuple(args[0].shape[1:]))))
        for name, m in gen.named_modules() if isinstance(m, FlaxBatchNorm2d)]
    with torch.no_grad():
        gen(feats["impaired_magnitude"], feats["mask"])
    for hook in hooks:
        hook.remove()
    return layers


def _bn_gan_rows(card: str) -> list:
    """The LeakyReLU(0.2) form at each BatchNorm layer of the GAN generator,
    at the batches of gan_training's runs (bf16 at the recipe's 32 clips,
    f32 at GAN_F32_BATCH), parameters in the input's type as the trainer
    casts them, checked on the card, and the kernels' times.  ``y`` bit for
    bit the eager ops' from the kernels' mean and variance (the ``gpu``
    test's check), and those within 1e-5 of the plain version's: against
    the plain ``y`` itself a bf16 LeakyReLU output may lie two steps off,
    since a step of its input, times 0.2, is up to 1.6 of its own before
    it is rounded again.  The running statistics, and ``dx``, ``dweight``
    and ``dbias`` against the plain backward from the kernels' statistics,
    within the bounds of ``tests/test_torch_gpu.py``'s BatchNorm tests: 1e-5
    of the largest entry (``dx``: of its largest term ``g m``; ``dweight``,
    ``dbias``: of each channel's sum of its terms' magnitudes), plus a bf16
    step of the value in bf16 (each rounded once)."""
    dev = torch.device(DEVICE)
    eps, keep, slope, dims = 1e-5, 0.99, LEAKY_SLOPE, (0, 2, 3)
    layers = _bn_gan_layers()
    log("batchnorm", f"GAN generator: {len(layers)} layers {layers}")
    rows = []
    for dtype, batch in ((torch.bfloat16, gan_recipe_config().training.batch_size),
                         (torch.float32, GAN_F32_BATCH)):
        for layer, (C, H, W) in layers:
            shape = (batch, C, H, W)
            gen = torch.Generator(dev).manual_seed(C * H * W)
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).to(dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            w = (torch.rand(C, generator=gen, device=dev) + 0.5).to(dtype)
            b = torch.randn(C, generator=gen, device=dev).to(dtype)
            st = (torch.zeros(C, device=dev), torch.ones(C, device=dev),
                  torch.zeros((), dtype=torch.int64, device=dev))
            pst = tuple(t.clone() for t in st)
            y, saved, counter = batchnorm.forward_kernel(x, w, b, *st, True, eps, keep, slope)
            dx, dw, db = batchnorm.backward_kernel(dy, x, w, b, saved, counter, eps, slope)
            py, psaved = batchnorm.forward_reference(x, w, b, *pst, True, eps, keep, slope)
            pdx, pdw, pdb = batchnorm.backward_reference(dy, x, w, b, saved, eps, slope)
            xc = x.float() - saved[:, 0][:, None, None]
            m = (torch.rsqrt(torch.clamp_min(saved[:, 1], 0.0) + eps) * w.float())[:, None, None]
            z = (xc * m + b.float()[:, None, None]).to(dtype)
            g = torch.where(z > 0, dy, dy * slope).float()
            label = f"GAN {layer} {shape} {dtype}"
            if not torch.equal(y, batchnorm.activate(z, slope)):
                raise AssertionError(f"{label} y: not the eager ops' from the kernels' statistics")
            errs = {"mean_var": _bn_check(f"{label} mean and variance", saved, psaved),
                    "y_of_plain": _bn_check(f"{label} y", y, py, two_steps=True),
                    "running_mean": _bn_check(f"{label} running mean", st[0], pst[0]),
                    "running_var": _bn_check(f"{label} running var", st[1], pst[1]),
                    "dx": _bn_check(f"{label} dx", dx, pdx, (g * m).abs().max()),
                    "dweight": _bn_check(f"{label} dweight", dw, pdw, (g * xc).abs().sum(dims)),
                    "dbias": _bn_check(f"{label} dbias", db, pdb, g.abs().sum(dims))}
            del py, pdx, xc, z, g
            kernel_f = cuda_ms(lambda: batchnorm.forward_kernel(x, w, b, *st, True, eps, keep,
                                                                slope), reps=10)
            kernel_b = cuda_ms(lambda: batchnorm.backward_kernel(dy, x, w, b, saved, counter, eps,
                                                                 slope), reps=10)
            row = {"name": f"batchnorm GAN {layer}", "shape": list(shape),
                   "dtype": "bf16" if dtype == torch.bfloat16 else "f32", "slope": slope,
                   "forward_ms": kernel_f, "backward_ms": kernel_b,
                   "max_err_of_bound": errs, "card": card}
            log("batchnorm", json.dumps(row))
            rows.append(row)
            del x, dy, y, dx, saved
            torch.cuda.empty_cache()
    return rows


def _fwd_launches() -> int:
    """``lstm_fwd``'s launches in both forms since the last reset."""
    counts = _counts()
    return counts["lstm_fwd"] + counts["lstm_fwd_bf16"]


def phase_serving(card: str) -> dict:
    cfg = Config()
    n_samples = cfg.data.max_samples
    runners = {
        phase: make_cnn_runner(cfg, CHECKPOINT, device=DEVICE, phase=phase)
        for phase in ("oracle", "impaired")
    }
    audio = speech_like_batch(np.random.default_rng(1), B)
    gap_start = np.full(B, GAP_START)
    gap_len = np.full(B, GAP_LEN)
    log("serving", f"runners built from {CHECKPOINT.name}; batch {audio.shape}, gap "
                   f"[{GAP_START}, {GAP_START + GAP_LEN}) samples")

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    outputs = []
    for i, phase in enumerate(("oracle", "oracle", "impaired")):
        before = _fwd_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = runners[phase](audio, gap_start, gap_len)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = _fwd_launches() - before
        if launched != 3:
            raise AssertionError(
                f"request {i}: lstm_fwd launched {launched} times, expected 3 "
                "(one per layer, both directions a launch)"
            )
        if tuple(restored.shape) != (B, n_samples) or not torch.isfinite(restored).all():
            raise AssertionError(f"request {i}: restored {tuple(restored.shape)} not finite/shaped")
        outputs.append(restored)
        log("serving", f"request {i} ({phase}): {1e3 * seconds:.2f} ms, "
                       f"{B * n_samples / SAMPLE_RATE / seconds:.1f} s-audio/s, "
                       f"{launched} lstm_fwd launches ({card})")
    launches = _counts()
    if any(n for k, n in launches.items() if k != "lstm_fwd"):
        raise AssertionError(f"serving launched a backward kernel or a bf16 form: {launches}")
    log("serving", f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card})")

    # Outside the gap's frames the output is the input: impaired exactly,
    # oracle up to the 1e-9 floor of the log10 magnitude.
    lo, hi = GAP_START - 512, GAP_START + GAP_LEN + 512
    outside = torch.ones(n_samples, dtype=torch.bool, device=DEVICE)
    outside[lo:hi] = False
    audio_d = torch.tensor(audio, device=DEVICE)
    err_o = (outputs[0] - audio_d)[:, outside].abs().max().item()
    if not torch.equal(outputs[2][:, outside], audio_d[:, outside]) or not err_o <= 1e-3:
        raise AssertionError(f"output differs from the input away from the gap (oracle {err_o})")

    # Clip 0 through the port on the CPU.
    for i, phase in ((0, "oracle"), (2, "impaired")):
        cpu = make_cnn_runner(cfg, CHECKPOINT, device="cpu", phase=phase)
        want = cpu(audio[:1], gap_start[:1], gap_len[:1])
        err = (outputs[i][:1].cpu() - want).abs().max().item()
        log("serving", f"clip 0 ({phase}) card vs CPU: max abs err {err:.3e} (atol {CPU_ATOL})")
        if not err <= CPU_ATOL:
            raise AssertionError(f"card and CPU disagree on clip 0 ({phase}): {err} > {CPU_ATOL}")
    return launches


def generator_work(generator, b: int, freq: int, frames: int, elem_bytes: int) -> dict:
    """Multiply-adds of the PConv U-Net on a (b, freq, frames) input, from its
    layers' shapes (each partial conv's convolution and its 1-channel mask
    convolution), and the bytes of its largest activations (final_pconv1's
    input and output, each written once and read once)."""
    f = generator.total_downsampling
    h, w = -(-freq // f) * f, -(-frames // f) * f
    macs, sizes = 0, [(h, w)]
    for i in range(generator.n_enc):
        conv = getattr(generator, f"enc{i}").pconv.conv
        sizes.append((-(-sizes[-1][0] // conv.stride[0]), -(-sizes[-1][1] // conv.stride[1])))
    layers = [(getattr(generator, f"enc{i}").pconv.conv, sizes[i + 1])
              for i in range(generator.n_enc)]
    layers += [(getattr(generator, f"dec{i}").pconv.conv, sizes[generator.n_enc - 1 - i])
               for i in range(generator.n_dec)]
    layers += [(generator.final_pconv1.conv, (h, w)), (generator.final_pconv2.conv, (h, w))]
    for conv, (ho, wo) in layers:
        k = conv.kernel_size[0] * conv.kernel_size[1]
        macs += b * ho * wo * k * (conv.in_channels * conv.out_channels + 1)
    c1 = generator.final_pconv1.conv
    act_bytes = 2 * b * h * w * (c1.in_channels + c1.out_channels) * elem_bytes
    return {"padded": (h, w), "macs": macs, "flop": 2 * macs, "largest_activation_bytes": act_bytes}


def phase_gan_serving(card: str) -> dict:
    """The GAN main path, ``bench.py``'s canonical line, in f32 and bf16."""
    cfg = gan_config()
    n_samples = cfg.data.max_samples
    audio = synthetic_dataset_batch(B, cfg.data.max_len_s)
    gap_start, gap_len = np.full(B, GAP_START), np.full(B, GAP_LEN)
    audio_d = torch.tensor(audio, device=DEVICE)
    gs_d = torch.tensor(gap_start, device=DEVICE)
    gl_d = torch.tensor(gap_len, device=DEVICE)
    seconds_of_audio = B * n_samples / SAMPLE_RATE
    spec = cfg.data.spectrogram
    freq, frames = spec.freq_bins, spec.frames(n_samples)
    log("gan_serving", f"{GAN_CHECKPOINT.name}; batch {audio.shape} from SyntheticSpeechDataset, "
                       f"gap [{GAP_START}, {GAP_START + GAP_LEN}); STFT {spec.n_fft}/"
                       f"{spec.hop_length}/{spec.win_length} -> {freq} x {frames}; patch window "
                       f"{DEFAULT_PATCH_WINDOW}")
    counts_before = _counts()
    summary = {"batch": B, "clip_s": cfg.data.max_len_s, "card": card}
    restored = {}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        runner = make_gan_runner(cfg, GAN_CHECKPOINT, device=DEVICE, mode="enhanced",
                                 phase="oracle", compute_dtype=dtype,
                                 transport_window=DEFAULT_PATCH_WINDOW)
        work = generator_work(runner.generator, B, freq, frames, 2 if dtype else 4)
        peak_rate = BF16_FLOP_PER_S if dtype else F32_FLOP_PER_S
        io_bytes = audio.nbytes + B * DEFAULT_PATCH_WINDOW * 2 + B * 4
        bound_ms, bound_by = 1e3 * max(work["flop"] / peak_rate, io_bytes / HBM_BYTES_PER_S), (
            "operations" if work["flop"] / peak_rate >= io_bytes / HBM_BYTES_PER_S else "bytes")
        act_ms = 1e3 * work["largest_activation_bytes"] / HBM_BYTES_PER_S

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        patch, start = runner(audio_d, gs_d, gl_d)
        patch_h, start_h = patch.cpu().numpy(), start.cpu().numpy()
        first_s = time.perf_counter() - t0
        warm_ms = []
        for _ in range(GAN_WARM):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            patch, start = runner(audio_d, gs_d, gl_d)
            patch.cpu(), start.cpu()
            torch.cuda.synchronize()
            warm_ms.append(1e3 * (time.perf_counter() - t0))
        if not (np.array_equal(patch.cpu().numpy(), patch_h)
                and np.array_equal(start.cpu().numpy(), start_h)):
            raise AssertionError(f"gan_serving {label}: two requests gave different payloads")

        # Host syncs inside one request (a pipelined loop needs none).
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runner(audio_d, gs_d, gl_d)
        torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message).splitlines()[0] for w in caught]

        rates = [seconds_of_audio / _pipelined(runner, audio_d, gs_d, gl_d, GAN_DEPTH)
                 for _ in range(GAN_REPEATS)]
        peak = torch.cuda.max_memory_allocated() / 2**20
        q1, med, q3 = np.percentile(rates, [25, 50, 75])
        log("gan_serving", f"{label}: first request {first_s:.3f} s; warm requests "
                           f"{', '.join(f'{t:.2f}' for t in warm_ms)} ms "
                           f"({seconds_of_audio / (min(warm_ms) / 1e3):.1f} s-audio/s at the best); "
                           f"pipelined {GAN_DEPTH}-deep, {GAN_REPEATS} repeats: median {med:.1f} "
                           f"s-audio/s (IQR {q1:.1f}-{q3:.1f}, all {[round(r, 1) for r in rates]}); "
                           f"peak device memory {peak:.1f} MiB ({card})")
        log("gan_serving", f"{label}: bound {bound_ms:.3f} ms by {bound_by}: {work['flop'] / 1e12:.3f} "
                           f"TFLOP at {peak_rate / 1e12:.0f} TFLOP/s on {work['padded']} (padded) "
                           f"x {B}; the request's I/O {io_bytes / 1e6:.2f} MB; final_pconv1's input "
                           f"and output, each written and read once, "
                           f"{work['largest_activation_bytes'] / 1e9:.2f} GB = {act_ms:.3f} ms at "
                           f"HBM rate; host syncs in a request: {len(syncs)} {syncs[:3]}")
        summary[label] = {"first_request_s": first_s, "warm_request_ms": warm_ms,
                          "pipelined_s_audio_per_s": rates, "pipelined_median": med,
                          "peak_mib": peak, "bound_ms": bound_ms, "bound_by": bound_by,
                          "tflop": work["flop"] / 1e12, "activation_ms": act_ms,
                          "host_syncs": len(syncs)}
        restored[label] = _gan_checks(label, runner, audio, audio_d, gs_d, gl_d)
        del runner

    # mode="parity": one timed request, f32.
    parity = make_gan_runner(cfg, GAN_CHECKPOINT, device=DEVICE, mode="parity")
    parity(audio_d, gs_d, gl_d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parity(audio_d, gs_d, gl_d)
    torch.cuda.synchronize()
    parity_ms = 1e3 * (time.perf_counter() - t0)
    log("gan_serving", f"parity f32: a warm request {parity_ms:.2f} ms ({card})")
    summary["parity_warm_request_ms"] = parity_ms
    restored["parity f32"] = parity.inpaint_fn(audio_d[:1], gs_d[:1], gl_d[:1])[0]
    parity_bf16 = make_gan_runner(cfg, GAN_CHECKPOINT, device=DEVICE, mode="parity",
                                  compute_dtype=torch.bfloat16)
    restored["parity bf16"] = parity_bf16.inpaint_fn(audio_d[:1], gs_d[:1], gl_d[:1])[0]

    # Clip 0: the card in f32 against the port on the CPU, bf16 against the
    # card's f32, in both modes.
    for mode in ("enhanced", "parity"):
        cpu = make_gan_runner(cfg, GAN_CHECKPOINT, device="cpu", mode=mode)
        want = cpu(audio[:1], gap_start[:1], gap_len[:1])
        f32 = restored["f32" if mode == "enhanced" else "parity f32"][:1].cpu()
        bf16 = restored["bf16" if mode == "enhanced" else "parity bf16"][:1].cpu()
        err, err_bf16 = (f32 - want).abs().max().item(), (bf16 - f32).abs().max().item()
        log("gan_serving", f"clip 0 ({mode}): card f32 vs CPU max abs err {err:.3e} (atol "
                           f"{GAN_CPU_ATOL}); card bf16 vs card f32 {err_bf16:.3e} (atol "
                           f"{GAN_BF16_ATOL})")
        if not err <= GAN_CPU_ATOL:
            raise AssertionError(f"GAN clip 0 ({mode}): card and CPU disagree: {err}")
        if not err_bf16 <= GAN_BF16_ATOL:
            raise AssertionError(f"GAN clip 0 ({mode}): bf16 and f32 disagree: {err_bf16}")
        summary[f"clip0_{mode}"] = {"f32_vs_cpu": err, "bf16_vs_f32": err_bf16}
    if _counts() != counts_before:
        raise AssertionError(f"GAN serving launched a hand-written kernel: {counts_before} -> "
                             f"{_counts()}")
    log("gan_serving", json.dumps(summary))
    return summary


def _pipelined(runner, audio_d, gs_d, gl_d, depth: int) -> float:
    """Seconds a request of a ``depth``-deep loop in which request i+1 is
    launched before request i's payload is read on the host: each payload
    is copied into pinned host memory behind its request, and read after
    the next request is launched."""
    torch.cuda.synchronize()
    bufs, pending = [None, None], None
    t0 = time.perf_counter()
    for i in range(depth + 1):
        if i < depth:
            patch, start = runner(audio_d, gs_d, gl_d)
            if bufs[i % 2] is None:
                bufs[i % 2] = (torch.empty(patch.shape, dtype=patch.dtype, pin_memory=True),
                               torch.empty(start.shape, dtype=start.dtype, pin_memory=True))
            host_patch, host_start = bufs[i % 2]
            host_patch.copy_(patch, non_blocking=True)
            host_start.copy_(start, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        if pending is not None:
            pending[0].synchronize()
            pending[1].numpy().copy(), pending[2].numpy().copy()
        pending = (done, host_patch, host_start) if i < depth else None
    return (time.perf_counter() - t0) / depth


def _gan_checks(label: str, runner, audio: np.ndarray, audio_d, gs_d, gl_d,
                phase: str = "gan_serving") -> torch.Tensor:
    """The generator's output finite; the composited clip equal to the input
    outside the gap; the host composite of the payload equal to a full-clip
    PCM16 fetch (messages under ``phase``).  Returns the restored batch."""
    with torch.inference_mode():
        restored, generated = runner.inpaint_fn(audio_d, gs_d, gl_d)
        patch, start = runner(audio_d, gs_d, gl_d)
        tmask = gap_mask(audio_d.shape[-1], gs_d, gl_d)
        composited = audio_d * tmask + restored * (1.0 - tmask)
        full = to_pcm16(composited).cpu().numpy()
    bad = (~torch.isfinite(generated)).sum().item()
    if bad or not torch.isfinite(restored).all():
        raise AssertionError(f"{phase} {label}: {bad} non-finite generator outputs")
    outside = tmask.bool()
    if not torch.equal(composited[outside], audio_d[outside]):
        raise AssertionError(f"{phase} {label}: output differs from the input outside the gap")
    client = to_pcm16(torch.tensor(audio)).numpy()
    host = composite_gap_patch(client, patch.cpu().numpy(), start.cpu().numpy())
    if not np.array_equal(host, full):
        raise AssertionError(f"{phase} {label}: host composite differs from the full fetch in "
                             f"{np.count_nonzero(host != full)} samples")
    if not np.array_equal(host[outside.cpu().numpy()], client[outside.cpu().numpy()]):
        raise AssertionError(f"{phase} {label}: delivered PCM differs from the input's outside "
                             "the gap")
    log(phase, f"{label}: generator output {tuple(generated.shape)} finite (range "
               f"{generated.min().item():.4f}..{generated.max().item():.4f}); composited "
               f"clip equal to the input outside the gap; host composite of the payload "
               f"equal to a full-clip PCM16 fetch, {host.size} int16 samples")
    return restored


# ------------------------------------------------------- serving_deployable


def _timed_requests(fn, label: str, seconds_of_audio: float,
                    phase: str = "serving_deployable", warm: int = GAN_WARM) -> tuple:
    """The first call's seconds, ``warm`` warm calls (ms and s-audio/s, each
    ending in a fetch of what ``fn`` returns), host syncs inside one call,
    and the peak device memory from the first call on.  Returns the numbers
    and the last call's result."""
    def fetch(out):
        return [t.cpu() for t in (out if isinstance(out, tuple) else (out,))]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fetch(fn())
    first_s = time.perf_counter() - t0
    warm_ms = []
    for _ in range(warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        fetch(out)
        warm_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught]
    fetch(out)
    peak = torch.cuda.max_memory_allocated() / 2**20
    rate = seconds_of_audio / (min(warm_ms) / 1e3)
    log(phase, f"{label}: first request {first_s:.3f} s; warm requests "
                              f"{', '.join(f'{t:.2f}' for t in warm_ms)} ms ({rate:.1f} s-audio/s "
                              f"at the best); host syncs in a request: {len(syncs)} "
                              f"{syncs[:2]}; peak device memory {peak:.1f} MiB")
    if syncs:
        raise AssertionError(f"{label}: {len(syncs)} host syncs inside a request: {syncs[:3]}")
    return {"first_request_s": first_s, "warm_request_ms": warm_ms, "s_audio_per_s": rate,
            "host_syncs": len(syncs), "peak_mib": peak}, out


def _check_outside(label: str, restored: torch.Tensor, audio: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """Every sample where ``valid`` is 1 equal to the input's, bit for bit."""
    keep = valid.bool()
    if not torch.isfinite(restored).all():
        raise AssertionError(f"{label}: non-finite output")
    if not torch.equal(restored[keep], audio[keep]):
        raise AssertionError(f"{label}: output differs from the input outside the gaps in "
                             f"{int((restored[keep] != audio[keep]).sum())} samples")


def _check_against_cpu(label: str, got: torch.Tensor, want: torch.Tensor, valid: torch.Tensor,
                       rtol_of_peak: float, phase: str = "serving_deployable") -> float:
    """The card against the port on the CPU (clip 0, or a long signal's gap
    0): inside the gaps within ``rtol_of_peak`` of the CPU's largest
    |sample| there.  Returns the error as that share."""
    gap = ~valid.bool().cpu()
    g, w = got.cpu()[gap], want.cpu()[gap]
    err = ((g - w).abs().max() / w.abs().max()).item()
    log(phase, f"{label}: card vs CPU inside the gaps {err:.3e} of the gaps' peak (bound "
               f"{rtol_of_peak})")
    if not err <= rtol_of_peak:
        raise AssertionError(f"{label}: card and CPU disagree: {err} > {rtol_of_peak}")
    return err


def _inconsistency(restored: torch.Tensor, out_mag: torch.Tensor, trust: torch.Tensor,
                   kw: dict) -> float:
    """``|| |STFT(x)| - mag || / || mag ||`` over the frames whose window
    touches a gap (``trust`` 0): how far ``x``'s spectrum lies from the
    magnitude it was rebuilt from, where its phase was estimated."""
    frames = (trust < 0.5)[:, None, :].expand_as(out_mag)
    diff = stft(restored, **kw).abs() - out_mag
    return (diff[frames].norm() / out_mag[frames].norm()).item()


def phase_serving_deployable(card: str) -> dict:
    """Deployable serving with no oracle: the ``extrapolate`` and
    ``griffinlim`` regimes, mask-driven multi-gap serving, the shift ensemble
    and long-form serving, both families at full width."""
    cfg, ccfg = gan_config(), Config()
    spec = cfg.data.spectrogram
    kw = dict(n_fft=spec.n_fft, hop_length=spec.hop_length, win_length=spec.win_length)
    n_samples = cfg.data.max_samples
    seconds_of_audio = B * n_samples / SAMPLE_RATE
    audio = synthetic_dataset_batch(B, cfg.data.max_len_s)
    audio_d = torch.tensor(audio, device=DEVICE)
    gs_d = torch.full((B,), GAP_START, device=DEVICE)
    gl_d = torch.full((B,), GAP_LEN, device=DEVICE)
    tmask = gap_mask(n_samples, gs_d, gl_d)
    summary = {"batch": B, "clip_s": cfg.data.max_len_s, "card": card}
    counts_before = _counts()

    # GAN by interval: extrapolate and griffinlim (f32), extrapolate (bf16).
    gan = {}
    for label, phase, dtype in (("gan extrapolate f32", "extrapolate", None),
                                ("gan griffinlim f32", "griffinlim", None),
                                ("gan extrapolate bf16", "extrapolate", torch.bfloat16)):
        runner = make_gan_runner(cfg, GAN_CHECKPOINT, device=DEVICE, mode="enhanced",
                                 phase=phase, compute_dtype=dtype, gl_iters=GL_ITERS,
                                 transport_window=DEFAULT_PATCH_WINDOW)
        summary[label], _ = _timed_requests(lambda: runner(audio_d, gs_d, gl_d), label,
                                            seconds_of_audio)
        with full_f32_convolutions():
            restored, generated = runner.inpaint_fn(audio_d, gs_d, gl_d)
        _check_outside(label, restored, audio_d, tmask)
        gan[label] = (runner, restored, generated)
    f32_runner, ext, generated = gan["gan extrapolate f32"]
    gl = gan["gan griffinlim f32"][1]
    # Griffin-Lim's output against the estimate it started from: the
    # magnitude both rebuild, over the frames whose phase was estimated.
    spec_gap = stft(audio_d * tmask, **kw)
    fmask = frame_mask_from_interval(gs_d, gs_d + gl_d, *spec_gap.shape[-2:], kw["hop_length"])
    out_mag = masking.log1p_denorm(masking.composite(generated, masking.log1p_norm(spec_gap.abs()),
                                                     fmask))
    trust = window_clear_frame_mask(tmask, out_mag.shape[-1], kw["hop_length"], kw["n_fft"],
                                    kw["win_length"])
    inc_ext, inc_gl = _inconsistency(ext, out_mag, trust, kw), _inconsistency(gl, out_mag, trust, kw)
    log("serving_deployable", f"spectral inconsistency over the estimated frames: extrapolate "
                              f"{inc_ext:.4f}, griffinlim ({GL_ITERS} iterations) {inc_gl:.4f}")
    if not inc_gl < GL_MIN_GAIN * inc_ext:
        raise AssertionError(f"Griffin-Lim did not make the spectrum more consistent: {inc_gl} >= "
                             f"{GL_MIN_GAIN} x {inc_ext}")
    summary["inconsistency"] = {"extrapolate": inc_ext, "griffinlim": inc_gl}
    bf16_err = (gan["gan extrapolate bf16"][1] - ext).abs().max().item()
    log("serving_deployable", f"gan extrapolate: bf16 vs f32 on the card {bf16_err:.3e} (atol "
                              f"{GAN_BF16_ATOL})")
    if not bf16_err <= GAN_BF16_ATOL:
        raise AssertionError(f"gan extrapolate: bf16 and f32 disagree: {bf16_err}")
    cpu_gen = make_gan_runner(cfg, GAN_CHECKPOINT, device="cpu").generator
    clip0 = (torch.tensor(audio[:1]), torch.tensor([GAP_START]), torch.tensor([GAP_LEN]))
    want = make_gan_inpaint_fn(cfg, cpu_gen, mode="enhanced", phase="extrapolate")(*clip0)[0]
    summary["gan extrapolate f32"]["clip0_vs_cpu"] = _check_against_cpu(
        "gan extrapolate f32, clip 0", ext[:1], want, tmask[:1], GAN_DEPLOYABLE_RTOL)
    want = make_gan_inpaint_fn(cfg, cpu_gen, mode="enhanced", phase="griffinlim",
                               gl_iters=GL_ITERS)(*clip0)[0]
    frames = (trust[:1].cpu() < 0.5)[:, None, :].expand(1, *out_mag.shape[-2:])

    def spectrum_distance(x, ref):
        got_s, want_s = stft(x.cpu(), **kw).abs(), stft(ref.cpu(), **kw).abs()
        return ((got_s - want_s)[frames].norm() / want_s[frames].norm()).item()

    err, control = spectrum_distance(gl[:1], want), spectrum_distance(gl[:1], ext[:1])
    log("serving_deployable", f"gan griffinlim f32, clip 0: card vs CPU, STFT magnitude over the "
                              f"estimated frames {err:.3e} in relative L2 (bound {GL_SPEC_RTOL}); "
                              f"control, Griffin-Lim vs its extrapolate start on the card "
                              f"{control:.3e} (at least {2 * GL_SPEC_RTOL})")
    if not err <= GL_SPEC_RTOL:
        raise AssertionError(f"gan griffinlim: card and CPU disagree on clip 0: {err}")
    if not control >= 2 * GL_SPEC_RTOL:
        raise AssertionError(f"gan griffinlim: output within {control} of its extrapolate start, "
                             f"too close for the bound {GL_SPEC_RTOL} to tell them apart")
    summary["gan griffinlim f32"]["clip0_spectrum_vs_cpu"] = err
    summary["gan griffinlim f32"]["clip0_spectrum_vs_extrapolate"] = control
    with full_f32_convolutions():
        got = make_gan_inpaint_fn(cfg, f32_runner.generator, mode="enhanced", phase="griffinlim",
                                  gl_iters=4)(*(t.to(DEVICE) for t in clip0))[0]
    want = make_gan_inpaint_fn(cfg, cpu_gen, mode="enhanced", phase="griffinlim",
                               gl_iters=4)(*clip0)[0]
    summary["gan griffinlim f32"]["clip0_4_iterations_vs_cpu"] = _check_against_cpu(
        "gan griffinlim f32, 4 iterations, clip 0", got, want, tmask[:1], GL4_RTOL)
    del gan

    # GAN, mask-driven (3 seeded gaps a clip) and the shift ensemble.
    u = torch.rand((2, B, 3), generator=torch.Generator().manual_seed(17))
    masks = multi_gap_mask(u[0], u[1], n_samples)[0].to(DEVICE)
    mask_fn = make_gan_inpaint_mask_fn(cfg, f32_runner.generator, phase="extrapolate")
    with full_f32_convolutions():
        summary["gan mask"], (restored, _) = _timed_requests(
            lambda: mask_fn(audio_d, masks), "gan mask-driven extrapolate f32, 3 gaps a clip",
            seconds_of_audio)
    _check_outside("gan mask", restored, audio_d, masks)
    with torch.inference_mode():
        want = make_gan_inpaint_mask_fn(cfg, cpu_gen, phase="extrapolate")(
            torch.tensor(audio[:1]), masks[:1].cpu())[0]
    summary["gan mask"]["clip0_vs_cpu"] = _check_against_cpu("gan mask, clip 0", restored[:1], want,
                                                             masks[:1], GAN_DEPLOYABLE_RTOL)
    tta = make_tta_shift_fn(f32_runner.inpaint_fn, kw["hop_length"], TTA_SHIFTS)
    with full_f32_convolutions():
        summary["gan tta"], (restored, _) = _timed_requests(
            lambda: tta(audio_d, gs_d, gl_d), f"gan TTA {TTA_SHIFTS} shifts extrapolate f32",
            seconds_of_audio)
    _check_outside("gan tta", restored, audio_d, tmask)
    cpu_tta = make_tta_shift_fn(make_gan_inpaint_fn(cfg, cpu_gen, mode="enhanced",
                                                    phase="extrapolate"), kw["hop_length"],
                                TTA_SHIFTS)
    want = cpu_tta(*clip0)[0]
    summary["gan tta"]["clip0_vs_cpu"] = _check_against_cpu("gan tta, clip 0", restored[:1], want,
                                                            tmask[:1], GAN_DEPLOYABLE_RTOL)

    # Long-form: a 60 s signal with 8 well-separated gaps.
    long_audio = speech_like_batch(np.random.default_rng(23), 1, LONG_S)[0]
    long_d = torch.tensor(long_audio, device=DEVICE)
    lstarts = (np.arange(LONG_GAPS) * (len(long_audio) // LONG_GAPS) + 24000).astype(np.int64)
    llens = np.full(LONG_GAPS, GAP_LEN, np.int64)
    lvalid = gap_mask(len(long_audio), torch.tensor(lstarts), torch.tensor(llens)).amin(0)
    client = to_pcm16(torch.tensor(long_audio)).numpy()

    def centered():
        return longform_inpaint_centered(f32_runner.inpaint_fn, long_d, lstarts, llens,
                                         window=n_samples, batch_size=LONG_GAPS)

    with full_f32_convolutions():
        summary["gan longform centered"], (patches, pstarts) = _timed_requests(
            centered, f"gan long-form centered, {LONG_S:.0f} s, {LONG_GAPS} gaps, PCM16 patches",
            LONG_S)
    host = composite_gap_patches_1d(client, patches.cpu().numpy(), pstarts.cpu().numpy())
    outside = lvalid.bool().numpy()
    if not np.array_equal(host[outside], client[outside]):
        raise AssertionError("gan long-form: delivered PCM differs from the input outside the gaps")
    want_p, want_s = longform_inpaint_centered(
        make_gan_inpaint_fn(cfg, cpu_gen, mode="enhanced", phase="extrapolate"),
        torch.tensor(long_audio), lstarts[:1], llens[:1], window=n_samples, batch_size=1)
    lsb = (patches[:1].cpu().int() - want_p.int()).abs().max().item()
    bound = 1 + GAN_DEPLOYABLE_RTOL * want_p.abs().max().item()
    log("serving_deployable", f"gan long-form: gap 0's patch card vs CPU {lsb} LSB (bound "
                              f"{bound:.1f}); starts {pstarts[:3].tolist()}...")
    if not (lsb <= bound and pstarts[0].item() == want_s[0].item()):
        raise AssertionError(f"gan long-form: card and CPU disagree on gap 0: {lsb} LSB")
    summary["gan longform centered"]["gap0_lsb_vs_cpu"] = lsb
    if _counts() != counts_before:
        raise AssertionError(f"the GAN functions launched a hand-written kernel: {counts_before} "
                             f"-> {_counts()}")
    del f32_runner, mask_fn, tta, cpu_tta
    torch.cuda.empty_cache()

    # CNN+BiLSTM: by interval, by mask and long-form, through lstm_fwd.
    cnn_audio = speech_like_batch(np.random.default_rng(1), B)
    cnn_d = torch.tensor(cnn_audio, device=DEVICE)
    runner = make_cnn_runner(ccfg, CHECKPOINT, device=DEVICE, phase="extrapolate")
    cpu_runner = make_cnn_runner(ccfg, CHECKPOINT, device="cpu", phase="extrapolate")
    cmask_fn = make_cnn_inpaint_mask_fn(ccfg, runner.model, phase="extrapolate")
    _reset_counts()
    summary["cnn extrapolate"], restored = _timed_requests(
        lambda: runner(cnn_d, gs_d, gl_d), "cnn extrapolate f32", seconds_of_audio)
    requests = 2 + GAN_WARM
    if _fwd_launches() != 3 * requests:
        raise AssertionError(f"cnn extrapolate: lstm_fwd launched {_fwd_launches()} "
                             f"times in {requests} requests, expected 3 a request")
    _check_outside("cnn extrapolate", restored, cnn_d, tmask)
    with full_f32_convolutions():
        summary["cnn mask"], (restored_m, _) = _timed_requests(
            lambda: cmask_fn(cnn_d, masks), "cnn mask-driven extrapolate f32, 3 gaps a clip",
            seconds_of_audio)
    _check_outside("cnn mask", restored_m, cnn_d, masks)

    def cnn_longform():
        with full_f32_convolutions():
            return longform_inpaint(runner.inpaint_fn, long_d, lstarts, llens, window=n_samples,
                                    hop=n_samples // 2, batch_size=2 * LONG_GAPS)

    summary["cnn longform"], long_out = _timed_requests(
        cnn_longform, f"cnn long-form, {LONG_S:.0f} s, {LONG_GAPS} gaps", LONG_S)
    _check_outside("cnn long-form", long_out[None], long_d[None], lvalid[None].to(DEVICE))
    launches = _counts()
    if any(n for k, n in launches.items() if k != "lstm_fwd") or not launches["lstm_fwd"]:
        raise AssertionError(f"serving_deployable launched a backward kernel or a bf16 form, "
                             f"or no lstm_fwd: {launches}")
    want = cpu_runner(cnn_audio[:1], np.full(1, GAP_START), np.full(1, GAP_LEN))
    summary["cnn extrapolate"]["clip0_vs_cpu"] = _check_against_cpu(
        "cnn extrapolate, clip 0", restored[:1], want, tmask[:1], CNN_DEPLOYABLE_RTOL)
    want = make_cnn_inpaint_mask_fn(ccfg, cpu_runner.model, phase="extrapolate")(
        torch.tensor(cnn_audio[:1]), masks[:1].cpu())[0]
    summary["cnn mask"]["clip0_vs_cpu"] = _check_against_cpu("cnn mask, clip 0", restored_m[:1], want,
                                                             masks[:1], CNN_DEPLOYABLE_RTOL)
    # Long-form gap 0 depends only on the two windows around it.
    want = longform_inpaint(cpu_runner.inpaint_fn, torch.tensor(long_audio), lstarts[:1],
                            llens[:1], window=n_samples, hop=n_samples // 2)
    g0 = gap_mask(len(long_audio), torch.tensor(lstarts[:1]), torch.tensor(llens[:1]))
    summary["cnn longform"]["gap0_vs_cpu"] = _check_against_cpu(
        "cnn long-form, gap 0", long_out[None].cpu(), want[None], g0, CNN_DEPLOYABLE_RTOL)
    summary["launches"] = launches
    log("serving_deployable", json.dumps(summary))
    return launches


# -------------------------------------------------------------- evaluation

EVAL_REGIMES = (  # (label, model, the CLI's flags)
    ("gan oracle", "gan", ["--mode", "enhanced", "--phase", "oracle"]),
    ("gan extrapolate", "gan", ["--mode", "enhanced", "--phase", "extrapolate"]),
    ("gan extrapolate bf16", "gan", ["--mode", "enhanced", "--phase", "extrapolate",
                                     "--infer-dtype", "bf16"]),
    ("gan griffinlim", "gan", ["--mode", "enhanced", "--phase", "griffinlim",
                               "--gl-iters", str(GL_ITERS)]),
    ("cnn_blstm oracle", "cnn_blstm", ["--phase", "oracle"]),
    ("cnn_blstm extrapolate", "cnn_blstm", ["--phase", "extrapolate"]),
    ("gan 3 gaps extrapolate", "gan", ["--mode", "enhanced", "--phase", "extrapolate",
                                       "--n-gaps", "3"]),
    ("cnn_blstm 3 gaps extrapolate", "cnn_blstm", ["--phase", "extrapolate", "--n-gaps", "3"]),
)
EVAL_CHECKPOINTS = {"gan": GAN_CHECKPOINT, "cnn_blstm": CHECKPOINT}
FORMANT_DIR = REPO / "results" / "formant_corpus_samples"
METRIC_KEYS = ("gap_sdr_db", "snr_db", "lsd_db", "fwseg_snr_db", "psm", "odg")
# evaluation: the CLI on the card against the same CLI on the CPU (--device
# cpu) on the three formant FLACs, per clip.  The card's FFTs and
# convolutions sum in another order.  What moves the metrics, on the CPU: a
# 1e-7 relative change of the clips moves gap SDR by at most 7e-7 dB under
# oracle and extrapolate (f32), 4.6e-4 dB in bf16 and 2.0e-4 dB under
# griffinlim (whose ODG moves by 1.0e-2: Griffin-Lim in a gap is not a stable
# function of its input); bf16 against f32 moves gap SDR by 4.7e-3 dB.  So:
# gap SDR within 1e-2 dB under oracle; within 5e-2 dB under extrapolate (the
# waveform in the gaps lies up to 4.7e-3 of the gaps' peak apart, card vs
# CPU, in serving_deployable), in bf16 too (ten times bf16's own distance to f32); under
# griffinlim the batch's mean gap SDR within 0.5 dB.  Under oracle also PSM
# within 1e-4 and ODG within 1e-3.
EVAL_SDR_DB = {"oracle": 1e-2, "extrapolate": 5e-2}
EVAL_GL_MEAN_SDR_DB = 0.5
EVAL_PSM_ATOL, EVAL_ODG_ATOL = 1e-4, 1e-3
EVAL_METRIC_REPS = 5
LONG_EVAL_GAP_S = 31.0  # the 60 s file's gap (80 ms)


def _flac16(x: np.ndarray) -> np.ndarray:
    """What the codec decodes of f32 ``x`` written as 16-bit FLAC: ``x *
    32768`` rounded half away from zero, clipped to int16, over 32768."""
    v = x.astype(np.float64) * 32768.0
    levels = np.clip(np.trunc(v + np.where(v >= 0, 0.5, -0.5)), -32768, 32767)
    return (levels / 32768.0).astype(np.float32)


def _eval_argv(model: str, flags: list, inp: Path, device: str) -> list:
    return ["--models", model, "--checkpoint", str(EVAL_CHECKPOINTS[model]), "--input", str(inp),
            *flags, "--device", device]


def _means(results: dict) -> dict:
    return {k: float(np.mean(results[k])) for k in METRIC_KEYS}


def _table_line(label: str, means: dict) -> str:
    return (f"{label:>30} | gap SDR {means['gap_sdr_db']:7.3f} dB | SNR {means['snr_db']:7.3f} | "
            f"LSD {means['lsd_db']:6.3f} | fwSegSNR {means['fwseg_snr_db']:7.3f} | "
            f"PSM {means['psm']:6.4f} | ODG {means['odg']:7.4f}")


def _same_decoded(label: str, got_files: list, want_files: list) -> int:
    """Each pair of files decodes to the same samples, bit for bit."""
    from ml_audio_inpainting_torch.data.audio_io import read_audio

    for g, w in zip(got_files, want_files, strict=True):
        a, b = read_audio(g)[0], read_audio(w)[0]
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: {g.name} differs from save_audio of the runner's "
                                 f"output in {int((a != b).sum())} samples")
    return len(got_files)


def phase_evaluation(card: str) -> dict:
    """File-in/file-out serving and evaluation: the codec, the metrics, the
    port's ``evaluate`` and ``inpaint`` CLIs at full width on the card."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_evaluation_"))
    try:
        return _evaluation(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _evaluation(card: str, work: Path) -> dict:
    summary = {"card": card, "batch": B}
    clips_dir = work / "clips"
    clips = speech_like_batch(np.random.default_rng(11), B)
    seconds_of_audio = B * clips.shape[-1] / SAMPLE_RATE
    _reset_counts()

    # 1. The clips through the codec: 16-bit FLAC and back, on the host.
    t0 = time.perf_counter()
    paths = [clips_dir / f"clip{i:02d}.flac" for i in range(B)]
    for clip, path in zip(clips, paths):
        save_audio(clip, path, SAMPLE_RATE)
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = [read_audio(p) for p in paths]
    decode_s = time.perf_counter() - t0
    for clip, path, (x, rate, md5_ok) in zip(clips, paths, decoded):
        want = _flac16(clip / np.abs(clip).max())
        if md5_ok != 1 or rate != SAMPLE_RATE or not np.array_equal(x[:, 0], want):
            raise AssertionError(f"{path.name}: md5_ok {md5_ok}, rate {rate}, decode differs from "
                                 f"the 16-bit quantisation of what was written")
    summary["codec"] = {"encode_s": encode_s, "decode_s": decode_s,
                        "encode_s_audio_per_s": seconds_of_audio / encode_s,
                        "decode_s_audio_per_s": seconds_of_audio / decode_s,
                        "bytes": sum(p.stat().st_size for p in paths)}
    log("evaluation", f"codec: {B} x 5 s clips written as 16-bit FLAC in {encode_s:.3f} s "
                      f"({seconds_of_audio / encode_s:.0f} s-audio/s), read back in "
                      f"{decode_s:.3f} s ({seconds_of_audio / decode_s:.0f} s-audio/s), MD5 "
                      f"verified, equal to the 16-bit quantisation bit for bit; "
                      f"{summary['codec']['bytes']} bytes")

    # 2. Each metric at B=32 on the card: the first call, CUDA-event ms and
    # peak memory, on the clean clips against the gapped ones.
    clean = torch.tensor(np.stack([x[:, 0] for x, _, _ in decoded]), device=DEVICE)
    valid = gap_mask(clean.shape[-1], torch.full((B,), GAP_START, device=DEVICE),
                     torch.full((B,), GAP_LEN, device=DEVICE))
    gapped = clean * valid
    metric_fns = {"gap_sdr": lambda: metrics.gap_sdr(clean, gapped, 1.0 - valid),
                  "snr": lambda: metrics.snr(clean, gapped),
                  "lsd": lambda: metrics.log_spectral_distance(clean, gapped),
                  "fwseg_snr": lambda: metrics.fwseg_snr(clean, gapped),
                  "psm": lambda: auditory.psm_score(clean, gapped),
                  "odg": lambda: peaq.odg_score(clean, gapped)}
    summary["metrics"] = {}
    for name, fn in metric_fns.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        ms = cuda_ms(fn, EVAL_METRIC_REPS, warmup=1)
        if tuple(out.shape) != (B,) or not torch.isfinite(out).all():
            raise AssertionError(f"metric {name}: {tuple(out.shape)}, finite "
                                 f"{bool(torch.isfinite(out).all())}")
        summary["metrics"][name] = {"ms": ms, "first_s": first_s, "peak_mib": peak}
        log("evaluation", f"metric {name} at B={B} x 5 s: {ms:.3f} ms (CUDA events, mean of "
                          f"{EVAL_METRIC_REPS}), first call {first_s:.3f} s, peak {peak:.1f} MiB "
                          f"above its inputs; clean vs gapped mean {out.mean().item():.4f}")
    del clean, gapped, valid

    # 3. The evaluate CLI on the 32 files, every regime, one JSON each.
    json_dir = work / "json"
    json_dir.mkdir()
    summary["evaluate"] = {}
    for label, model, flags in EVAL_REGIMES:
        out = json_dir / f"{label.replace(' ', '_')}.json"
        before = _fwd_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate.main(_eval_argv(model, flags, clips_dir, DEVICE) + ["--output-json", str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _fwd_launches() - before
        if launched != (3 if model == "cnn_blstm" else 0):
            raise AssertionError(f"evaluate {label}: lstm_fwd launched {launched} times, "
                                 f"expected {3 if model == 'cnn_blstm' else 0}")
        payload = json.loads(out.read_text())
        res = payload["results"][model]
        if any(len(res[k]) != B or not np.isfinite(res[k]).all() for k in METRIC_KEYS):
            raise AssertionError(f"evaluate {label}: results not {B} finite values each")
        means = _means(res)
        summary["evaluate"][label] = {"wall_s": wall, "lstm_fwd": launched, **means}
        log("evaluation", f"evaluate {B} files: {_table_line(label, means)} | {wall:.2f} s")

    # The wall-time split of one evaluate run a family (warm: built above).
    summary["split"] = {}
    for label, model, flags in (EVAL_REGIMES[1], EVAL_REGIMES[5]):
        timings = {}
        args = evaluate.build_argparser().parse_args(_eval_argv(model, flags, clips_dir, DEVICE))
        t0 = time.perf_counter()
        evaluate.run(args, timings)
        timings["total"] = time.perf_counter() - t0
        summary["split"][label] = timings
        log("evaluation", f"evaluate {label}, {B} files, wall seconds by part (device synced at "
                          f"each): " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))

    # 4. The three formant FLACs: the table, and card against the CPU.
    summary["formant"] = {}
    for label, model, flags in EVAL_REGIMES:
        runs = {}
        for device in (DEVICE, "cpu"):
            args = evaluate.build_argparser().parse_args(
                _eval_argv(model, flags, FORMANT_DIR, device))
            before = _fwd_launches()
            runs[device] = evaluate.run(args)[1][model]
            launched = _fwd_launches() - before
            if launched != (3 if model == "cnn_blstm" and device == DEVICE else 0):
                raise AssertionError(f"formant {label} on {device}: {launched} lstm_fwd launches")
        card_r, cpu_r = runs[DEVICE], runs["cpu"]
        d = {k: float(np.abs(card_r[k] - cpu_r[k]).max()) for k in METRIC_KEYS}
        phase_kind = "griffinlim" if "griffinlim" in label else (
            "oracle" if "oracle" in label else "extrapolate")
        if phase_kind == "griffinlim":
            err = abs(float(card_r["gap_sdr_db"].mean() - cpu_r["gap_sdr_db"].mean()))
            ok, bound = err <= EVAL_GL_MEAN_SDR_DB, f"mean gap SDR {err:.4f} <= {EVAL_GL_MEAN_SDR_DB}"
        else:
            err = d["gap_sdr_db"]
            ok = err <= EVAL_SDR_DB[phase_kind]
            bound = f"per-clip gap SDR {err:.2e} <= {EVAL_SDR_DB[phase_kind]}"
            if phase_kind == "oracle":
                ok = ok and d["psm"] <= EVAL_PSM_ATOL and d["odg"] <= EVAL_ODG_ATOL
                bound += (f", PSM {d['psm']:.2e} <= {EVAL_PSM_ATOL}, ODG {d['odg']:.2e} <= "
                          f"{EVAL_ODG_ATOL}")
        means = _means(card_r)
        summary["formant"][label] = {**means, "card_vs_cpu": d}
        log("evaluation", f"formant 3 files: {_table_line(label, means)}")
        log("evaluation", f"formant {label}: card vs CPU {bound}; largest per-clip differences "
                          + ", ".join(f"{k} {v:.2e}" for k, v in d.items()))
        if not ok:
            raise AssertionError(f"formant {label}: card and CPU disagree: {bound}")

    # 5. The inpaint CLI: the GAN on the 32 files, the CNN+BiLSTM long-form on
    # a 60 s file; each output equal to save_audio of the runner's output.
    out_dir, ref_dir = work / "inpainted", work / "reference"
    argv = ["--model", "gan", "--checkpoint", str(GAN_CHECKPOINT), "--mode", "enhanced",
            "--phase", "extrapolate", "--batch-size", str(B), "--input", str(clips_dir),
            "--output", str(out_dir), "--device", DEVICE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inpaint.main(argv)
    wall = time.perf_counter() - t0
    args = inpaint.build_argparser().parse_args(argv)
    runner = inpaint._build_runner(args, gan_config())
    audio = evaluate.load_clean(paths, Config())
    restored = runner(audio, np.full(B, GAP_START), np.full(B, GAP_LEN)).cpu().numpy()
    refs = []
    for j, path in enumerate(paths):
        refs.append(ref_dir / f"{path.stem}_gan_inpainted.flac")
        save_audio(restored[j], refs[-1], SAMPLE_RATE)
    n = _same_decoded("inpaint gan", sorted(out_dir.glob("*.flac")), refs)
    summary["inpaint gan extrapolate"] = {"wall_s": wall, "files": n}
    log("evaluation", f"inpaint gan extrapolate: {n} files in {wall:.2f} s, each equal to "
                      f"save_audio of the runner's output on the card, bit for bit")
    del runner

    long_audio = np.concatenate(list(speech_like_batch(np.random.default_rng(12), 12)))
    long_in, long_out, long_ref = work / "long" / "long60.flac", work / "long_out.flac", \
        work / "long_ref.flac"
    save_audio(long_audio, long_in, SAMPLE_RATE)
    argv = ["--model", "cnn_blstm", "--checkpoint", str(CHECKPOINT), "--phase", "extrapolate",
            "--longform", "--gap-start", str(LONG_EVAL_GAP_S), "--input", str(long_in),
            "--output", str(long_out), "--device", DEVICE]
    before = _fwd_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inpaint.main(argv)
    wall = time.perf_counter() - t0
    launched = _fwd_launches() - before
    args = inpaint.build_argparser().parse_args(argv)
    runner = inpaint._build_runner(args, Config())
    mono = torch.from_numpy(read_audio(long_in)[0][:, 0].copy()).to(DEVICE)
    restored = longform_inpaint(runner.inpaint_fn, mono, int(LONG_EVAL_GAP_S * SAMPLE_RATE),
                                GAP_LEN, window=Config().data.max_samples,
                                hop=Config().data.max_samples // 2, batch_size=args.batch_size)
    save_audio(restored, long_ref, SAMPLE_RATE)
    _same_decoded("inpaint cnn_blstm --longform", [long_out], [long_ref])
    if launched != 3:
        raise AssertionError(f"inpaint --longform: lstm_fwd launched {launched} times, expected 3 "
                             f"(one call of the two windows over the gap)")
    summary["inpaint cnn_blstm longform"] = {"wall_s": wall, "seconds": len(long_audio) / SAMPLE_RATE,
                                             "lstm_fwd": launched}
    log("evaluation", f"inpaint cnn_blstm --longform: {len(long_audio) / SAMPLE_RATE:.0f} s file in "
                      f"{wall:.2f} s, {launched} lstm_fwd launches, equal to save_audio of "
                      f"longform_inpaint on the card, bit for bit")

    launches = _counts()
    if any(n for k, n in launches.items() if k != "lstm_fwd") or not launches["lstm_fwd"]:
        raise AssertionError(f"evaluation launched a backward kernel or a bf16 form, or no "
                             f"lstm_fwd: {launches}")
    summary["launches"] = launches
    log("evaluation", json.dumps(summary))
    return launches


def _check_step_against_cpu(cfg: Config, flat: dict, audio: np.ndarray, starts: torch.Tensor,
                            label: str, phase: str = "training",
                            grad_rtol: float = STEP_GRAD_RTOL_OF_MAX, **step_kw) -> dict:
    """Step 0 of a reduced batch on the card in f32 and on the CPU in f64
    from the same weights and inputs (``step_kw`` to ``make_cnn_train_step``):
    the loss and every gradient tensor, within ``grad_rtol`` of the tensor's
    largest entry.  Returns the names of the tensors whose gradient is
    exactly zero on the card."""
    out = {}
    for side, device, dtype in (("card", DEVICE, torch.float32), ("cpu", "cpu", torch.float64)):
        state = create_cnn_state(cfg, device=device, params=flat)
        state.model.to(dtype)
        _, m = make_cnn_train_step(cfg, **step_kw)(
            state, torch.tensor(audio, device=device, dtype=dtype), starts.to(device))
        out[side] = (m["loss"].item(), {n: p.grad.detach().cpu().double()
                                        for n, p in state.model.named_parameters()})
    (loss_d, g_d), (loss_c, g_c) = out["card"], out["cpu"]
    rel = abs(loss_d - loss_c) / abs(loss_c)
    log(phase, f"{label}: step 0 of {tuple(starts.shape)} clips x variants: loss card "
               f"{loss_d:.6f}, CPU f64 {loss_c:.6f}, relative difference {rel:.3e} "
               f"(rtol {STEP_LOSS_RTOL})")
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"{label} step 0 loss: card {loss_d} vs CPU {loss_c}")
    g_max = max(g.abs().max().item() for g in g_c.values())
    worst = (0.0, "")
    for name, want in g_c.items():
        own = want.abs().max().item()
        scale = g_max if name in NOISE_GRAD or own <= F32_EPS * g_max else own
        err = (g_d[name] - want).abs().max().item()
        if not err <= grad_rtol * scale:
            raise AssertionError(f"{label} step 0 gradient {name}: card vs CPU max err {err} > "
                                 f"{grad_rtol} x {scale}")
        if scale > 0 and err / scale > worst[0]:
            worst = (err / scale, name)
    zero = sorted(n for n, g in g_d.items() if not g.any())
    log(phase, f"{label}: step 0 gradients, {len(g_c)} tensors: card vs CPU f64 within "
               f"{worst[0]:.3e} of their largest entry (worst {worst[1]}; allowed "
               f"{grad_rtol}); exactly zero on the card: {len(zero)} tensors")
    return {"loss_rel_err": rel, "grad_rel_err": worst[0], "zero_grad": zero}


def _step_counts() -> dict:
    """The LSTM's and the BatchNorm kernels' launch counts since their
    last resets."""
    return {**_counts(), **batchnorm.kernel_launches()}


def _train(card: str, cfg: Config, flat: dict, label: str, batches: list,
           compute_dtype=None) -> tuple:
    """TRAIN_STEPS steps from ``flat``, one on each of ``batches`` (clips and
    the gap tensors the step takes), in ``compute_dtype``; asserts the
    launches of every step (3 of each kernel in the step's form, none of the
    other) and finite losses.  Returns the state, the launch counts, the
    names of the parameter tensors that moved and of all of them, and the
    warm step's ms, s-audio/s and peak memory.  The launch counts hold the
    BatchNorm kernels' too: each layer's forward and backward once a step,
    in the step's form."""
    suffix = "_bf16" if compute_dtype == torch.bfloat16 else ""
    state = create_cnn_state(cfg, device=DEVICE, params=flat)
    norms = sum(isinstance(m, FlaxBatchNorm2d) for m in state.model.modules())
    expected = {f"{name}{form}": (3 if name in KERNELS else norms) if form == suffix else 0
                for name in (*KERNELS, *batchnorm.KERNELS) for form in ("", "_bf16")}
    step = make_cnn_train_step(cfg, compute_dtype=compute_dtype)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    batchnorm.reset_kernel_launches()
    seconds = []
    for i, (clips, gaps) in enumerate(batches):
        counts = _step_counts()
        audio = torch.tensor(clips, device=DEVICE)
        gaps = [t.to(DEVICE) for t in gaps]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, audio, *gaps)
        loss = metrics["loss"].item()  # synchronises
        seconds.append(time.perf_counter() - t0)
        launched = {k: v - counts[k] for k, v in _step_counts().items()}
        if launched != expected:
            raise AssertionError(f"{label} training step {i}: launches {launched}, expected "
                                 f"{expected} (the LSTM's one a BiLSTM layer, BatchNorm's one a "
                                 f"layer, in the step's form)")
        if not math.isfinite(loss):
            raise AssertionError(f"{label} training step {i}: loss {loss}")
        seqs = audio.shape[0] * cfg.data.gaps_per_audio
        log("training", f"{label}: step {i}: loss {loss:.4f}, {1e3 * seconds[-1]:.2f} ms, "
                        f"{seqs / seconds[-1]:.1f} sequences/s, launches {launched} ({card})")
    launches = _step_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    warm = sorted(seconds[1:])[len(seconds[1:]) // 2]
    stats = {"warm_step_ms": 1e3 * warm, "sequences_per_s": seqs / warm,
             "s_audio_per_s": seqs * cfg.data.max_len_s / warm, "first_step_ms": 1e3 * seconds[0],
             "peak_mib": peak}
    log("training", f"{label}: warm step (median of steps 1-{len(seconds) - 1}) "
                    f"{1e3 * warm:.2f} ms, {seqs / warm:.1f} sequences/s, "
                    f"{stats['s_audio_per_s']:.1f} s-audio/s; first step "
                    f"{1e3 * seconds[0]:.2f} ms; peak device memory {peak:.1f} MiB ({card})")
    moved = {n for n, p in state.model.named_parameters() if not torch.equal(p, before[n])}
    return state, launches, moved, set(before), stats


def phase_training(card: str) -> dict:
    cfg = recipe_config()
    G = cfg.data.gaps_per_audio
    flat = load_params_npz(CHECKPOINT)
    live = live_bilstm(flat, seed=6)
    clips = [speech_like_batch(np.random.default_rng(100 + i), 1) for i in range(TRAIN_STEPS)]
    gen = torch.Generator().manual_seed(5)
    starts = [gap_starts(gen, cfg, 1, G) for _ in range(TRAIN_STEPS)]
    batches = [(a, (gs,)) for a, gs in zip(clips, starts)]
    log("training", f"{TRAIN_STEPS} steps of 1 clip x {G} gap variants of "
                    f"{cfg.data.gap_len_s} s, lr {cfg.training.starter_learning_rate}, from "
                    f"{CHECKPOINT.name} and from it with its BiLSTM redrawn")

    # From the committed checkpoint: what has a gradient moves, and what has
    # none on the card has, in f64 on the CPU, none that f32 could resolve
    # (the gradient check allows a card's zero nowhere else).
    check = _check_step_against_cpu(cfg, flat, clips[0], starts[0][:, :2], "checkpoint")
    _, launches, moved, names, _ = _train(card, cfg, flat, "checkpoint", batches)
    if moved != names - set(check["zero_grad"]):
        raise AssertionError(f"checkpoint run: moved {sorted(moved)}, zero gradient at step 0 "
                             f"{check['zero_grad']}")
    log("training", f"checkpoint: {len(moved)} of {len(names)} tensors moved; no gradient "
                    f"reaches (below f32's resolution in f64 on the CPU) {check['zero_grad']}")

    # From the live BiLSTM: every parameter moves.
    live_check = _check_step_against_cpu(cfg, live, clips[0], starts[0][:, :2], "live BiLSTM")
    if live_check["zero_grad"]:
        raise AssertionError(f"live BiLSTM: exactly zero gradients {live_check['zero_grad']}")
    state, live_launches, moved, _, _ = _train(card, cfg, live, "live BiLSTM", batches)
    if moved != names:
        raise AssertionError(f"live BiLSTM: parameters that did not move {sorted(names - moved)}")
    log("training", f"live BiLSTM: every one of {len(names)} parameter tensors moved")

    # The trained weights, exported in the JAX package's format, serve a request.
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trained.npz"
        export_params_npz(path, state.model)
        runner = make_cnn_runner(cfg, path, device=DEVICE)
        audio = speech_like_batch(np.random.default_rng(1), B)
        before_serve = _fwd_launches()
        restored = runner(audio, np.full(B, GAP_START), np.full(B, GAP_LEN))
        torch.cuda.synchronize()
    if _fwd_launches() - before_serve != 3:
        raise AssertionError("the exported weights' request did not launch lstm_fwd 3 times")
    if tuple(restored.shape) != (B, cfg.data.max_samples) or not torch.isfinite(restored).all():
        raise AssertionError("the exported weights' request is not finite or shaped")
    log("training", f"exported {path.name} (f16 npz, flax keys) served a request of {B} "
                    f"clips: finite, shape {tuple(restored.shape)}")
    return {k: launches[k] + live_launches[k] for k in launches}


def _check_bf16_step_against_f32(cfg: Config, flat: dict, batch: tuple, label: str) -> dict:
    """Step 0 of ``batch`` in bf16 and in f32 on the card from the same
    weights: the loss and every gradient tensor.  Returns the errors and the
    names of the tensors whose bf16 gradient is exactly zero."""
    clips, gaps = batch
    audio = torch.tensor(clips, device=DEVICE)
    gaps = [t.to(DEVICE) for t in gaps]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        state = create_cnn_state(cfg, device=DEVICE, params=flat)
        _, m = make_cnn_train_step(cfg, compute_dtype=dtype)(state, audio, *gaps)
        out[dtype] = (m["loss"].item(), {n: p.grad.detach().double()
                                         for n, p in state.model.named_parameters()})
        del state
    (loss_32, g_32), (loss_16, g_16) = out[torch.float32], out[torch.bfloat16]
    rel = abs(loss_16 - loss_32) / abs(loss_32)
    log("training_bf16", f"{label}: step 0 of {clips.shape[0]} clips: loss bf16 {loss_16:.6f}, "
                         f"f32 {loss_32:.6f}, relative difference {rel:.3e} "
                         f"(rtol {BF16_STEP_LOSS_RTOL})")
    if not rel <= BF16_STEP_LOSS_RTOL:
        raise AssertionError(f"{label} bf16 step 0 loss: {loss_16} vs f32 {loss_32}")
    max_norm = max(g.norm().item() for g in g_32.values())
    worst, worst_noise = (0.0, ""), (0.0, "")
    for name, want in g_32.items():
        err = (g_16[name] - want).norm().item()
        norm = want.norm().item()
        if name in NOISE_GRAD or norm == 0.0:
            if not err <= BF16_NOISE_OF_MAX_NORM * max_norm:
                raise AssertionError(f"{label} bf16 step 0 gradient {name}: {err} > "
                                     f"{BF16_NOISE_OF_MAX_NORM} x {max_norm}")
            worst_noise = max(worst_noise, (err / max_norm, name))
        else:
            if not err <= BF16_GRAD_L2_RTOL * norm:
                raise AssertionError(f"{label} bf16 step 0 gradient {name}: |bf16 - f32| {err} > "
                                     f"{BF16_GRAD_L2_RTOL} x {norm}")
            worst = max(worst, (err / norm, name))
    zero = sorted(n for n, g in g_16.items() if not g.any())
    log("training_bf16", f"{label}: step 0 gradients, {len(g_32)} tensors: bf16 vs f32 within "
                         f"{worst[0]:.3e} of their L2 norm (worst {worst[1]}; allowed "
                         f"{BF16_GRAD_L2_RTOL}); noise-only and zero-gradient tensors within "
                         f"{worst_noise[0]:.3e} of the largest norm (worst {worst_noise[1]}; allowed "
                         f"{BF16_NOISE_OF_MAX_NORM}); exactly zero in bf16: {len(zero)} tensors")
    return {"loss_rel_err": rel, "grad_l2_rel_err": worst[0], "zero_grad": zero}


def phase_training_bf16(card: str) -> dict:
    """The production recipe in bf16 from the b128 checkpoint and from it
    with its BiLSTM redrawn; returns the launch counts of both runs."""
    cfg = b128_recipe_config()
    clips = cfg.training.batch_size
    flat = load_params_npz(B128_CHECKPOINT)
    live = live_bilstm(flat, seed=6)
    gen = torch.Generator().manual_seed(9)
    batches = [(speech_like_batch(np.random.default_rng(300 + i), clips),
                multi_gap_layouts(gen, cfg, clips, cfg.data.gaps_per_audio))
               for i in range(TRAIN_STEPS)]
    log("training_bf16", f"{TRAIN_STEPS} steps of {clips} clips x {cfg.data.gaps_per_audio} "
                         f"variant x {cfg.data.train_n_gaps} gaps of up to {cfg.data.gap_len_s} s "
                         f"(first clip's: starts {batches[0][1][0][0, 0].tolist()}, lengths "
                         f"{batches[0][1][1][0, 0].tolist()}), lr "
                         f"{cfg.training.starter_learning_rate}, bf16 network, f32 masters, from "
                         f"{B128_CHECKPOINT.name} and from it with its BiLSTM redrawn")
    runs, launches = {}, []
    for label, weights in (("checkpoint", flat), ("live BiLSTM", live)):
        check = _check_bf16_step_against_f32(cfg, weights, batches[0], label)
        state, counts, moved, names, stats = _train(card, cfg, weights, f"bf16 {label}", batches,
                                                    torch.bfloat16)
        if moved != names - set(check["zero_grad"]):
            raise AssertionError(f"bf16 {label}: moved {sorted(moved)}, zero gradient at step 0 "
                                 f"{check['zero_grad']}")
        if any(p.dtype != torch.float32 for p in state.model.parameters()):
            raise AssertionError(f"bf16 {label}: the master weights left f32")
        log("training_bf16", f"{label}: {len(moved)} of {len(names)} tensors moved; no gradient "
                             f"in bf16 for {check['zero_grad']}")
        runs[label] = {**stats, **{k: v for k, v in check.items() if k != "zero_grad"}}
        launches.append(counts)
        del state
    BARE_STEP_MS["cnn_bf16_b128"] = runs["live BiLSTM"]["warm_step_ms"]
    log("training_bf16", f"summary ({card}): {json.dumps(runs)}")
    return {k: sum(c[k] for c in launches) for k in launches[0]}


# ----------------------------------------------------------- gan_training


def _gan_states(cfg: Config, device, g_ema: float = 0.0) -> tuple:
    """G from the committed GAN checkpoint and D drawn from seed 0, on
    ``device``."""
    return create_gan_states(cfg, device=device, generator=torch.Generator().manual_seed(0),
                             g_ema=g_ema, params=load_params_npz(GAN_CHECKPOINT))


def _gan_step_state(g, d) -> tuple:
    """(gradients by network-prefixed name, D's u and sigma), f64 on the CPU."""
    grads = {f"g.{n}": p.grad.detach().double().cpu() for n, p in g.model.named_parameters()}
    grads.update({f"d.{n}": p.grad.detach().double().cpu() for n, p in d.model.named_parameters()})
    sn = {k: v.double().cpu() for k, v in d.model.state_dict().items()
          if k.endswith((".u", ".sigma"))}
    return grads, sn


def _device_busy_share(fn) -> tuple:
    """(busy share of the wall time, wall ms) of ``fn()``, ending in a
    synchronise, from a ``torch.profiler`` trace: the union of the device
    kernels' intervals over the host's span (the trainer's spans appear on
    the device's timeline too, and are not kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return busy / 1e3 / wall_ms, wall_ms


def _gan_train(card: str, cfg: Config, label: str, batches: list, vgg, steps: int,
               compute_dtype=None, remat: bool = False, check_syncs: bool = False) -> dict:
    """``steps`` steps of the recipe in ``cfg`` from :func:`_gan_states`, on
    the (audio, gaps) ``batches`` in turn; returns the timings, the states,
    and which parameters moved and had a gradient."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g, d = _gan_states(cfg, DEVICE, g_ema=GAN_EMA)
    step = make_gan_train_step(cfg, vgg=vgg, compute_dtype=compute_dtype, remat=remat,
                               g_ema=GAN_EMA)
    params = {**{f"g.{n}": p for n, p in g.model.named_parameters()},
              **{f"d.{n}": p for n, p in d.model.named_parameters()}}
    before = {n: p.detach().clone() for n, p in params.items()}
    seconds, metrics, nonzero, syncs = [], [], [], None
    for i in range(steps):
        audio, gaps = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if check_syncs and i == 2:  # host syncs inside one warm step
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                g, d, m = step(g, d, audio, *gaps)
            torch.cuda.set_sync_debug_mode("default")
            syncs = [str(w.message).splitlines()[0] for w in caught]
        else:
            g, d, m = step(g, d, audio, *gaps)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        metrics.append(m)
        nonzero.append(torch.stack([p.grad.ne(0).any() for p in params.values()]))
    peak = torch.cuda.max_memory_allocated() / 2**20
    losses = [{k: v.item() for k, v in m.items()} for m in metrics]
    bad = [(i, k) for i, m in enumerate(losses) for k, v in m.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"gan_training {label}: non-finite losses {bad}")
    had_grad = {n for n, any_step in zip(params, torch.stack(nonzero).any(0).tolist()) if any_step}
    moved = {n for n, p in params.items() if not torch.equal(p.detach(), before[n])}
    clips = audio.shape[0]
    warm = sorted(seconds[1:])[len(seconds[1:]) // 2]
    stats = {"warm_step_ms": 1e3 * warm, "step_ms": [1e3 * t for t in seconds],
             "s_audio_per_s": clips * cfg.data.max_len_s / warm, "peak_mib": peak,
             "g_total": [m["g_total"] for m in losses], "d_total": [m["d_total"] for m in losses]}
    if syncs is not None:
        stats["host_syncs"] = len(syncs)
    log("gan_training", f"{label}: steps {', '.join(f'{1e3 * t:.1f}' for t in seconds)} ms; warm "
                        f"step (median of steps 1-{steps - 1}) {1e3 * warm:.2f} ms, "
                        f"{stats['s_audio_per_s']:.1f} s-audio/s ({clips} x "
                        f"{cfg.data.max_len_s} s a step); peak device memory {peak:.1f} MiB; "
                        f"g_total {[round(v, 4) for v in stats['g_total']]}, d_total "
                        f"{[round(v, 4) for v in stats['d_total']]}"
                        + (f"; host syncs in a step: {len(syncs)} {syncs[:3]}"
                           if syncs is not None else "") + f" ({card})")
    if syncs:
        raise AssertionError(f"gan_training {label}: {len(syncs)} host syncs in a step: "
                             f"{syncs[:3]}")
    return {"stats": stats, "g": g, "d": d, "step": step, "moved": moved,
            "had_grad": had_grad, "names": set(params)}


def gan_training_batches(cfg: Config) -> tuple:
    """(the phase's ``GAN_TRAIN_STEPS`` (audio, gaps) batches on the card,
    the seconds the corpus took to synthesise and upload): a
    ``GAN_CORPUS_ITEMS``-clip formant_v2 corpus (seed 0) through the device
    feed, gap layouts drawn from seed 12."""
    clips = cfg.training.batch_size
    t0 = time.perf_counter()
    corpus = FormantSpeechDataset(n_items=GAN_CORPUS_ITEMS, variant="v2", seed=0, cache=False)
    feed = device_corpus_feed(corpus, clips, seed=0, device=DEVICE, workers=8)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(12)
    batches = [(next(feed), [t.to(DEVICE) for t in gan_gap_layouts(gen, cfg, clips)])
               for _ in range(GAN_TRAIN_STEPS)]
    return batches, corpus_s


def gan_check_batch(batches: list) -> tuple:
    """The first ``GAN_CHECK_CLIPS`` clips of the first batch, with their gaps."""
    audio, gaps = batches[0]
    return audio[:GAN_CHECK_CLIPS], [t[:GAN_CHECK_CLIPS] for t in gaps]


def _e5m2_rounded(x):
    """``x`` rounded to float8_e5m2 (2 mantissa bits; bf16 keeps 7), its
    gradient passed straight through; anything else as it is."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    return x + (x.to(torch.float8_e5m2).to(x.dtype) - x).detach()


def float8_rounded_casts(tree, dtype):
    """``cast_floating`` with every floating tensor rounded through
    float8_e5m2 first: patched into the trainer, the bf16 step computes on
    operands of less precision than it states (the control of the bf16
    check)."""
    return cast_floating(tree_map(_e5m2_rounded, tree), dtype)


def gan_step0(cfg: Config, batch: tuple, device, dtype=torch.float32, compute_dtype=None,
              vgg=None, control: bool = False, states=_gan_states, tape=None,
              replay: bool = False) -> tuple:
    """Step 0 of ``batch`` from ``states(cfg, device)`` (G and D) on
    ``device``, the networks in ``dtype`` (f32 or f64) and the step in
    ``compute_dtype`` (None, or bf16: the mixed step), with
    ``float8_rounded_casts`` if ``control``: (losses, gradients, D's u and
    sigma), on the CPU in f64.  ``vgg`` defaults to the seeded one, drawn
    anew, where ``cfg``'s VGG terms are on.  With a ``tape`` (a list), the
    step records its kinks' branches into it, or with ``replay`` takes
    them from it (``utils/branch_tape.py``)."""
    audio, gaps = batch
    g, d = states(cfg, device)
    g.model.to(dtype)
    d.model.to(dtype)
    t = cfg.training
    if vgg is None and (t.lambda_vgg_perceptual > 0 or t.lambda_vgg_style > 0):
        vgg = vgg19_params(device=device).to(dtype)
    step = make_gan_train_step(cfg, vgg=vgg, compute_dtype=compute_dtype)
    casts = float8_rounded_casts if control else cast_floating
    branches = contextlib.nullcontext() if tape is None else branch_tape(tape, replay)
    with mock.patch.object(gan_trainer, "cast_floating", casts), branches:
        _, _, m = step(g, d, audio.to(device=device, dtype=dtype), *[t.to(device) for t in gaps])
    return ({k: v.item() for k, v in m.items()}, *_gan_step_state(g, d))


def f32_grad_errors(got: dict, want: dict) -> dict:
    """Each gradient's largest distance from ``want``'s over its scale: its
    own largest entry, or the largest over both networks where its own
    lies below f32's resolution of that."""
    g_max = max(w.abs().max().item() for w in want.values())
    out = {}
    for name, w in want.items():
        own = w.abs().max().item()
        out[name] = (got[name] - w).abs().max().item() / (g_max if own <= F32_EPS * g_max else own)
    return out


def _check_gan_step_against_cpu(cfg: Config, batch: tuple, vgg) -> tuple:
    """Step 0 of ``batch`` on the card in f32 against the port's step in f64
    on the CPU from the same weights, taking the card's branch at every
    kink (``utils/branch_tape.py``): the losses, every gradient, D's u and
    sigma.  The card's step runs the fused BatchNorm kernels, as training
    does (the tape records their branches).  Returns (the card's step, the
    readings)."""
    tape = []
    before = batchnorm.kernel_launches()
    card = gan_step0(cfg, batch, DEVICE, vgg=vgg, tape=tape)
    fused = {k: v - before[k] for k, v in batchnorm.kernel_launches().items()}
    if not (fused["bn_fwd"] and fused["bn_bwd"]):
        raise AssertionError(f"gan_training step 0 on the card under the tape: BatchNorm "
                             f"launches {fused}")
    (m_d, g_d, sn_d), (m_c, g_c, sn_c) = card, gan_step0(cfg, batch, "cpu", torch.float64,
                                                         tape=tape, replay=True)
    loss_err = max(abs(m_d[k] - v) / abs(v) for k, v in m_c.items() if v)
    if not loss_err <= STEP_LOSS_RTOL:
        raise AssertionError(f"gan_training step 0 losses: card {m_d} vs CPU {m_c}")
    err = f32_grad_errors(g_d, g_c)
    worst = max(err, key=err.get)
    sn_err = {k: (sn_d[k] - v).abs().max().item() / (1.0 if k.endswith(".u") else v.item())
              for k, v in sn_c.items()}
    log("gan_training", f"step 0 of {batch[0].shape[0]} clips, VGG on, card f32 vs CPU f64 on the "
                        f"card's {len(tape)} kink branches (BatchNorm launches {fused}): losses "
                        f"within {loss_err:.3e} (rtol "
                        f"{STEP_LOSS_RTOL}); {len(g_c)} gradient tensors within {err[worst]:.3e} of "
                        f"their largest entry (worst {worst}; allowed {GAN_STEP_GRAD_RTOL_OF_MAX}); "
                        f"D's u and sigma after the D step within {max(sn_err.values()):.3e} "
                        f"({GAN_SN_ATOL})")
    beyond = {k: e for k, e in err.items() if not e <= GAN_STEP_GRAD_RTOL_OF_MAX}
    if beyond:
        raise AssertionError(f"gan_training step 0 gradients, card vs CPU f64: {beyond}")
    if not max(sn_err.values()) <= GAN_SN_ATOL:
        raise AssertionError(f"gan_training step 0 spectral-norm state: {sn_err}")
    return card, {"loss_rel_err": loss_err, "grad_rel_err": err[worst], "grad_worst": worst,
                  "sn_err": max(sn_err.values())}


def bf16_readings(got: tuple, want: tuple) -> dict:
    """A bf16 step's distance from the f32 step (each ``(losses, gradients,
    D's u and sigma)``): the losses relative, each gradient by its L2 norm,
    u's largest entry, sigma relative."""
    (m16, g16, sn16), (m32, g32, sn32) = got, want
    return {
        "loss": max(abs(m16[k] - v) / abs(v) for k, v in m32.items() if v),
        "grad": {k: (g16[k] - v).norm().item() / v.norm().item() for k, v in g32.items()
                 if v.norm().item() > 0},
        "u": max((sn16[k] - v).abs().max().item() for k, v in sn32.items() if k.endswith(".u")),
        "sigma": max(abs(sn16[k].item() / v.item() - 1) for k, v in sn32.items()
                     if k.endswith(".sigma")),
    }


def bf16_outside(r: dict) -> list:
    """What of :func:`bf16_readings` lies outside the bf16 check's bounds."""
    out = [k for k, e in r["grad"].items()
           if k not in GAN_BF16_GRAD_EXEMPT and not e <= GAN_BF16_GRAD_L2_RTOL]
    return out + [k for k, e, bound in (("loss", r["loss"], GAN_BF16_LOSS_RTOL),
                                        ("u", r["u"], GAN_BF16_U_ATOL),
                                        ("sigma", r["sigma"], GAN_BF16_SIGMA_RTOL))
                  if not e <= bound]


def _check_gan_bf16_against_f32(cfg: Config, batch: tuple, vgg, card_f32: tuple) -> dict:
    """Step 0 of ``batch`` in bf16 on the card against ``card_f32``, the f32
    step from the same weights; then the control (the bf16 step on
    float8_e5m2-rounded casts), which must fall outside the same bounds."""
    r, c = (bf16_readings(gan_step0(cfg, batch, DEVICE, compute_dtype=torch.bfloat16, vgg=vgg,
                                    control=control), card_f32)
            for control in (False, True))
    out, out_c = bf16_outside(r), bf16_outside(c)
    grads = {k: e for k, e in r["grad"].items() if k not in GAN_BF16_GRAD_EXEMPT}
    worst = max(grads, key=grads.get)
    log("gan_training", f"bf16 step 0 vs f32 on the card, {batch[0].shape[0]} clips: losses within "
                        f"{r['loss']:.3e} (rtol {GAN_BF16_LOSS_RTOL}); gradients within "
                        f"{grads[worst]:.3e} of their L2 norm (worst {worst}; allowed "
                        f"{GAN_BF16_GRAD_L2_RTOL}); exempt: "
                        f"{ {k: r['grad'][k] for k in GAN_BF16_GRAD_EXEMPT} }; u within "
                        f"{r['u']:.3e} ({GAN_BF16_U_ATOL}), sigma within {r['sigma']:.3e} "
                        f"({GAN_BF16_SIGMA_RTOL}); outside: {out}.  Control, casts rounded "
                        f"through float8_e5m2: losses {c['loss']:.3e}, gradients up to "
                        f"{max(c['grad'].values()):.3e} (median "
                        f"{sorted(c['grad'].values())[len(c['grad']) // 2]:.3e}), u {c['u']:.3e}, "
                        f"sigma {c['sigma']:.3e}; outside: {len(out_c)} ({out_c[:4]}...)")
    if out:
        raise AssertionError(f"gan_training: the bf16 step 0 is outside its bounds against f32: "
                             f"{out}")
    if not out_c:
        raise AssertionError("gan_training: the control (float8_e5m2 casts) is within the bf16 "
                             "bounds: they cannot tell a lower precision")
    return {"loss_rel_err": r["loss"], "grad_l2_rel_err": grads[worst], "grad_worst": worst,
            "exempt": {k: r["grad"][k] for k in GAN_BF16_GRAD_EXEMPT}, "u_err": r["u"],
            "sigma_rel_err": r["sigma"], "control_outside": len(out_c),
            "control_loss_rel_err": c["loss"], "control_grad_l2_rel_err": max(c["grad"].values())}


def phase_gan_training(card: str) -> dict:
    """GAN training at the JAX package's fastest recipe; returns the launch
    counts of the hand-written kernels: none of the LSTM's (the path has
    none), the BatchNorm kernels in the bf16 form in the bf16 runs and in
    the f32 form in the f32 run and the check against the CPU."""
    _reset_counts()
    batchnorm.reset_kernel_launches()
    cfg = gan_recipe_config()
    clips = cfg.training.batch_size
    batches, corpus_s = gan_training_batches(cfg)
    vgg = vgg19_params(device=DEVICE)  # MAI_VGG19_WEIGHTS unset: the seeded initialiser
    log("gan_training", f"corpus: {GAN_CORPUS_ITEMS} formant_v2 clips of {cfg.data.max_len_s} s "
                        f"synthesised (8 threads) and uploaded in {corpus_s:.2f} s; {clips} clips "
                        f"x {cfg.data.train_n_gaps} gaps of up to {cfg.data.gap_len_s} s a step "
                        f"(clip 0: starts {batches[0][1][0][0].tolist()}, lengths "
                        f"{batches[0][1][1][0].tolist()}); G from {GAN_CHECKPOINT.name}, D seeded; "
                        f"lambdas {cfg.training.lambda_adv}/{cfg.training.lambda_l1_valid}/"
                        f"{cfg.training.lambda_l1_hole}/{cfg.training.lambda_vgg_perceptual}/"
                        f"{cfg.training.lambda_vgg_style}/{cfg.training.lambda_mag_weighted}, "
                        f"EMA {GAN_EMA}")
    summary = {"card": card, "corpus_s": corpus_s}

    # The production recipe: bf16, B=32, VGG on.
    run = _gan_train(card, cfg, "bf16 B=32", batches, vgg, GAN_TRAIN_STEPS, torch.bfloat16,
                     check_syncs=True)
    if run["moved"] != run["had_grad"]:
        raise AssertionError(f"gan_training: moved {sorted(run['moved'] - run['had_grad'])} "
                             f"without a gradient, or stayed {sorted(run['had_grad'] - run['moved'])}"
                             f" with one")
    no_grad = sorted(run["names"] - run["had_grad"])
    log("gan_training", f"bf16 B=32: {len(run['moved'])} of {len(run['names'])} parameter tensors "
                        f"moved; no gradient in any step: {no_grad}")
    audio0, gaps0 = batches[0]
    busy, wall_ms = _device_busy_share(lambda: run["step"](run["g"], run["d"], audio0, *gaps0))
    summary["bf16_b32"] = {**run["stats"], "device_idle_share": 1.0 - busy, "traced_step_ms": wall_ms,
                           "no_grad": no_grad}
    BARE_STEP_MS["gan_bf16_b32"] = run["stats"]["warm_step_ms"]
    log("gan_training", f"bf16 B=32: one traced step {wall_ms:.1f} ms, device busy {100 * busy:.1f} "
                        f"%, idle {100 * (1 - busy):.1f} % ({card})")

    # The trained EMA weights, exported in the JAX package's npz format, serve a request.
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "gan_ema.npz"
        export_params_npz(path, run["g"].model, params=run["g"].ema_params)
        runner = make_gan_runner(cfg, path, device=DEVICE, mode="enhanced", phase="oracle",
                                 transport_window=DEFAULT_PATCH_WINDOW)
        audio = synthetic_dataset_batch(B, cfg.data.max_len_s)
        _gan_checks("EMA weights", runner, audio, torch.tensor(audio, device=DEVICE),
                    torch.full((B,), GAP_START, device=DEVICE),
                    torch.full((B,), GAP_LEN, device=DEVICE), phase="gan_training")
    del run, runner

    remat = _gan_train(card, cfg, "bf16 B=32 remat", batches, vgg, GAN_REMAT_STEPS,
                       torch.bfloat16, remat=True)
    summary["bf16_b32_remat"] = remat["stats"]
    del remat
    norms = batchnorm.kernel_launches()
    if not (norms["bn_fwd_bf16"] and norms["bn_bwd_bf16"]) or norms["bn_fwd"] or norms["bn_bwd"]:
        raise AssertionError(f"gan_training bf16 runs: BatchNorm launches {norms}, expected the "
                             f"bf16 form each way and no f32 form")

    # f32 (TF32 off) at the reference's batch, B=8 (configs/gan.yaml); B=32
    # does not fit (B=8 peaks at 29 GB).
    cfg_8 = gan_recipe_config()
    cfg_8.training.batch_size = GAN_F32_BATCH
    f32 = _gan_train(card, cfg_8, f"f32 B={GAN_F32_BATCH}",
                     [(a[:GAN_F32_BATCH], [t[:GAN_F32_BATCH] for t in gs]) for a, gs in batches],
                     vgg, GAN_F32_STEPS)
    summary["f32_b8"] = f32["stats"]
    del f32

    # Correctness on the card.
    small = gan_check_batch(batches)
    card_f32, summary["check_cpu"] = _check_gan_step_against_cpu(cfg, small, vgg)
    summary["check_bf16"] = _check_gan_bf16_against_f32(cfg, small, vgg, card_f32)

    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"gan_training launched an LSTM kernel: {launches}")
    norms = batchnorm.kernel_launches()
    if not all(norms.values()):
        raise AssertionError(f"gan_training: BatchNorm launches {norms}, expected both forms "
                             f"each way")
    launches = {**launches, **norms}
    summary["launches"] = launches
    log("gan_training", f"summary ({card}): {json.dumps(summary)}")
    return launches


# classical: the card in f64 against the port in f64 on the CPU (clip 0), within
# 1e-9 of the CPU's largest |sample| in the gap.  Every sum runs in another
# order; on the CPU a change of one ulp in every input sample moves these
# solves by at most 2.1e-11 of that peak (segmentation; Janssen 1.8e-12, the
# rest <= 5e-13: scripts/torch_classical_precision.py), and the port and JAX
# agree to 1e-11 in f64.
CLASSICAL_F64_RTOL = 1e-9
# classical: f32 against f64 on the card, per clip gap SDR over the 32 clips.
# f32 rounding flips discrete decisions on a few clips (which coefficients a
# threshold keeps, when a SPAIN loop stops, which system a Janssen iteration
# solves), so single clips move by up to 0.89 dB (the port on the CPU, the
# same clips, scripts/torch_classical_precision.py: sspain; on the card
# segmentation's worst clip moved 1.33 dB in the first run of this phase); the
# median moves by at most 4e-3 dB on the CPU (janssen), 2.7e-2 dB for
# segmentation, whose 256 windowed Janssen solves each round in f32.  A fault
# moves every clip.  Bounds: the median |difference| within 1e-2 dB (1e-1 for
# janssen and segmentation), every clip within 2 dB.
CLASSICAL_F32_MEDIAN_DB = {"janssen": 1e-1, "segmentation": 1e-1}
CLASSICAL_F32_MEDIAN_DB_DEFAULT = 1e-2
CLASSICAL_F32_MAX_DB = 2.0
CLASSICAL_WARM = 2
# classical CLIs, the card against the CPU, both f32: the decoded files within
# one LSB outside the gap and within 3 LSB or 1e-3 of the gap's peak inside it
# (the bounds tests/test_torch_classical_cli.py holds the port to JAX with);
# evaluate's metrics within 2e-3 (arinpaint) and 0.3 (janssen: its f32 system
# is ill-conditioned, and each f32 solve lies up to 0.15 dB from the f64 one).
CLASSICAL_CLI_GAP_LSB, CLASSICAL_CLI_GAP_RTOL = 3, 1e-3
CLASSICAL_EVAL_ATOL = {"arinpaint": 2e-3, "janssen": 0.3}


def _classical_runner(model: str, flags: list, device=None):
    """The solver as the ``inpaint`` CLI builds it, on ``device`` (the card
    if None)."""
    return classical_runner(model, flags, str(device or DEVICE))


def _trace_request(fn) -> tuple:
    """(device operations, busy share of the wall time, wall ms) of one
    ``fn()`` ending in a synchronise, from a ``torch.profiler`` trace of the
    device's activity (read as Kineto's raw events: building the profiler's
    event tree takes seconds for the ~80 000 operations of a request)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    spans = [(e.start_ns() / 1e3, e.end_ns() / 1e3) for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    return len(spans), busy_us(spans) / 1e3 / wall_ms, wall_ms


def _gap_rel_err(got: torch.Tensor, want: torch.Tensor, gap: torch.Tensor) -> float:
    g, w = got.cpu()[gap.cpu()], want.cpu()[gap.cpu()]
    return ((g - w).abs().max() / w.abs().max()).item()


def _classical_quality(clean: torch.Tensor, restored: torch.Tensor, gap: torch.Tensor) -> dict:
    """Gap SDR and PSM means of a batch, and how many clips came out non-finite
    (their metrics are left out of the means)."""
    finite = torch.isfinite(restored).all(-1)
    sdr = metrics.gap_sdr(clean.double(), restored.double(), gap.double())
    psm = auditory.psm_score(clean, torch.nan_to_num(restored.float()))
    keep = finite.cpu()
    return {"gap_sdr_db": sdr.cpu()[keep].mean().item(), "psm": psm.cpu()[keep].mean().item(),
            "non_finite_clips": int((~keep).sum())}


def _classical_solver(card: str, label: str, model: str, flags: list, gap_len: int,
                      audio: torch.Tensor, flacs: torch.Tensor) -> dict:
    """One solver of the classical phase: timings, trace, checks, quality."""
    runner = _classical_runner(model, flags)
    b, n = audio.shape
    gs = torch.full((b,), GAP_START, device=DEVICE)
    gl = torch.full((b,), gap_len, device=DEVICE)
    valid = gap_mask(n, gs, gl)
    gap = valid == 0
    stats, out32 = _timed_requests(lambda: runner(audio, gs, gl), label, b * n / SAMPLE_RATE,
                                   phase="classical", warm=CLASSICAL_WARM)
    _check_outside(f"classical {label}", out32, audio, valid)
    t0 = time.perf_counter()
    ops, busy, wall_ms = _trace_request(lambda: runner(audio, gs, gl))
    stats.update(device_ops=ops, idle_share=1.0 - busy, traced_ms=wall_ms,
                 trace_s=time.perf_counter() - t0)

    # f64 on the card, against f64 on the CPU (clip 0) and against f32 (every clip).
    audio64 = audio.double()
    t0 = time.perf_counter()
    out64 = runner(audio64, gs, gl)
    torch.cuda.synchronize()
    stats["f64_ms"] = 1e3 * (time.perf_counter() - t0)
    _check_outside(f"classical {label} f64", out64, audio64, valid)
    t0 = time.perf_counter()
    cpu64 = _classical_runner(model, flags, "cpu")(audio64[:1].cpu(), gs[:1].cpu(), gl[:1].cpu())
    stats["cpu_f64_clip_s"] = time.perf_counter() - t0
    stats["f64_card_vs_cpu"] = _gap_rel_err(out64[:1], cpu64, gap[:1])
    sdr32 = metrics.gap_sdr(audio64, out32.double(), gap.double())
    sdr64 = metrics.gap_sdr(audio64, out64, gap.double())
    diff = (sdr32 - sdr64).abs().cpu()
    stats.update(f32_vs_f64_median_db=diff.median().item(), f32_vs_f64_max_db=diff.max().item())
    median_bound = CLASSICAL_F32_MEDIAN_DB.get(model, CLASSICAL_F32_MEDIAN_DB_DEFAULT)
    log("classical", f"{label}: {ops} device operations a request, idle {100 * (1 - busy):.1f} % "
                     f"of a traced {wall_ms:.1f} ms (trace {stats['trace_s']:.1f} s); f64 "
                     f"{stats['f64_ms']:.1f} ms; the CPU's f64 clip {stats['cpu_f64_clip_s']:.1f} "
                     f"s; f64 card vs "
                     f"CPU (clip 0) {stats['f64_card_vs_cpu']:.3e} of the gap's peak (bound "
                     f"{CLASSICAL_F64_RTOL}); f32 vs f64 gap SDR |difference| median "
                     f"{stats['f32_vs_f64_median_db']:.2e} dB (bound {median_bound}), max "
                     f"{stats['f32_vs_f64_max_db']:.3f} dB (bound {CLASSICAL_F32_MAX_DB}) ({card})")
    if not stats["f64_card_vs_cpu"] <= CLASSICAL_F64_RTOL:
        raise AssertionError(f"classical {label}: f64 card and CPU disagree: "
                             f"{stats['f64_card_vs_cpu']} > {CLASSICAL_F64_RTOL}")
    if not (stats["f32_vs_f64_median_db"] <= median_bound
            and stats["f32_vs_f64_max_db"] <= CLASSICAL_F32_MAX_DB):
        raise AssertionError(f"classical {label}: f32 and f64 gap SDR too far apart: {diff}")

    # Quality, f32 on the card: the synthetic clips and the formant FLACs.
    fb = flacs.shape[0]
    fgs = torch.full((fb,), GAP_START, device=DEVICE)
    fgl = torch.full((fb,), gap_len, device=DEVICE)
    fvalid = gap_mask(flacs.shape[-1], fgs, fgl)
    fout = runner(flacs, fgs, fgl)
    keep = fvalid.bool()
    if not torch.equal(fout[keep], flacs[keep]):
        raise AssertionError(f"classical {label}: FLAC output differs from the input outside "
                             f"the gap")
    stats["synthetic"] = _classical_quality(audio, out32, 1 - valid)
    stats["flacs"] = _classical_quality(flacs, fout, 1 - fvalid)
    return stats


def _classical_clis(card: str, work: Path) -> dict:
    """The inpaint and evaluate CLIs over the formant FLACs on the card
    against the same CLIs on the CPU."""
    out = {}
    argv = ["--model", "arinpaint", "--ar-preset", "tuned", "--input", str(FORMANT_DIR)]
    walls = {}
    for where, device in (("card", DEVICE), ("cpu", "cpu")):
        t0 = time.perf_counter()
        inpaint.main([*argv, "--output", str(work / where), "--device", device])
        walls[where] = time.perf_counter() - t0
    worst_out, worst_gap = 0.0, 0.0
    gap = slice(GAP_START, GAP_START + GAP_LEN)
    for f in sorted((work / "cpu").glob("*.flac")):
        got, want = read_audio(work / "card" / f.name)[0][:, 0], read_audio(f)[0][:, 0]
        outside = np.ones(len(want), bool)
        outside[gap] = False
        d_out = np.abs(got - want)[outside].max() * 32768
        d_gap = np.abs(got - want)[gap].max()
        bound = max(CLASSICAL_CLI_GAP_LSB / 32768, CLASSICAL_CLI_GAP_RTOL * np.abs(want[gap]).max())
        if not (d_out <= 1.0001 and d_gap <= bound * 1.0001):
            raise AssertionError(f"classical inpaint CLI: {f.name} card vs CPU {d_out} LSB outside "
                                 f"the gap, {d_gap} inside (bound {bound})")
        worst_out, worst_gap = max(worst_out, float(d_out)), max(worst_gap, float(d_gap) * 32768)
    out["inpaint"] = {"wall_s": dict(walls), "lsb_outside": worst_out, "lsb_gap": worst_gap}
    log("classical", f"inpaint --model arinpaint --ar-preset tuned, 3 FLACs: card {walls['card']:.2f}"
                     f" s, CPU {walls['cpu']:.2f} s; card vs CPU {worst_out:.0f} LSB outside the "
                     f"gap, {worst_gap:.0f} LSB inside")

    argv = ["--models", "janssen", "arinpaint", "--ar-preset", "tuned", "--input", str(FORMANT_DIR)]
    results = {}
    for where, device in (("card", DEVICE), ("cpu", "cpu")):
        t0 = time.perf_counter()
        evaluate.main([*argv, "--output-json", str(work / f"{where}.json"), "--device", device])
        walls[f"evaluate_{where}"] = time.perf_counter() - t0
        results[where] = json.loads((work / f"{where}.json").read_text())
    if results["card"]["condition"] != results["cpu"]["condition"] or "phase" in results["card"][
            "condition"]:
        raise AssertionError("classical evaluate CLI: the conditions differ or carry a phase")
    worst = {}
    for model, bound in CLASSICAL_EVAL_ATOL.items():
        for key in METRIC_KEYS:
            d = np.abs(np.subtract(results["card"]["results"][model][key],
                                   results["cpu"]["results"][model][key])).max()
            worst[f"{model} {key}"] = float(d)
            if not d <= bound + 1e-9:
                raise AssertionError(f"classical evaluate CLI: {model} {key} card vs CPU {d} > "
                                     f"{bound}")
    out["evaluate"] = {"wall_s": {k: v for k, v in walls.items() if k.startswith("evaluate")},
                       "worst": worst, "card": results["card"]["results"]}
    log("classical", f"evaluate --models janssen arinpaint --ar-preset tuned, 3 FLACs: card "
                     f"{walls['evaluate_card']:.2f} s, CPU {walls['evaluate_cpu']:.2f} s; card vs "
                     f"CPU worst {json.dumps(worst)}")
    return out


def phase_classical(card: str) -> dict:
    """The classical family on the card through the inpaint CLI's runners and
    both CLIs; returns the launch counts of the hand-written kernels (all 0:
    the family has none)."""
    _reset_counts()
    audio = torch.tensor(synthetic_dataset_batch(B), device=DEVICE)
    files = sorted(FORMANT_DIR.glob("*.flac"))
    flacs = torch.tensor(evaluate.load_clean(files, Config()), device=DEVICE)
    log("classical", f"B={B} synthetic 5 s clips, gap at {GAP_START} samples; {len(files)} "
                     f"formant FLACs; f32 solves, checks in f64 ({card})")
    summary = {"card": card, "batch": B}
    for label, model, flags, gap_len in CLASSICAL_RUNS:
        summary[label] = _classical_solver(card, label, model, flags, gap_len, audio, flacs)

    # The solvers set full-f32 products in a scope of their own: under torch's
    # global TF32 switch janssen gives the same samples, and the switch stays on.
    runner = _classical_runner("janssen", [])
    gs = torch.full((B,), GAP_START, device=DEVICE)
    gl = torch.full((B,), GAP_LEN, device=DEVICE)
    want = runner(audio, gs, gl)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = runner(audio, gs, gl)
        if not torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("classical: janssen turned the global TF32 switch off")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.equal(got, want):
        raise AssertionError("classical: janssen under the global TF32 switch differs from full f32")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_classical_"))
    try:
        summary["clis"] = _classical_clis(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log("classical", "quality (f32 on the card; means over finite clips), gap SDR dB / PSM:")
    for label, *_ in CLASSICAL_RUNS:
        syn, fl = summary[label]["synthetic"], summary[label]["flacs"]
        log("classical", f"{label:>22} | synthetic {syn['gap_sdr_db']:7.3f} / {syn['psm']:.4f}"
                         f" ({syn['non_finite_clips']} non-finite) | FLACs {fl['gap_sdr_db']:7.3f}"
                         f" / {fl['psm']:.4f} ({fl['non_finite_clips']} non-finite)")
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"classical launched a hand-written kernel: {launches}")
    summary["launches"] = launches
    log("classical", f"summary ({card}): {json.dumps(summary)}")
    return launches


# ------------------------------------------------------------ training_cli

# training_cli: the training CLI (cli/train.py) driven in-process on the card.
CLI_CNN_CORPUS = 128  # formant_v2 clips: one epoch is one step of the production batch
CLI_CNN_STEPS = 8
CLI_PROBE_CLIPS = 32
CLI_CNN_LOGGING = {"metric_interval": 2, "checkpoint_interval": 4}  # saves at steps 4 and 8
CLI_CNN_PROBE_EVERY = 4
CLI_CNN_CLEAN_STEPS = (2, 4, 6, 8)  # steps after which nothing ran but the step itself
CLI_PHASE_CORPUS = 4
CLI_PHASE_STEPS = 3
CLI_GAN_CORPUS = 64  # B=32: two steps an epoch
CLI_GAN_STEPS = 6
CLI_GAN_LOGGING = {"log_interval": 2, "sample_interval": 4, "checkpoint_interval": 2}
CLI_GAN_CLEAN_STEPS = (2, 4, 6)
# The anchored phase-mode step 0, card f32 against the CPU in f64: the
# anchor (the phase of the gapped STFT carried across the gap) is
# ill-conditioned on bins that are quiet at the gap's edge, and its f32
# rounding turns the complex L1's unit error vectors there.  The same step
# in f32 against f64, both on the CPU (full width, 1 clip x 2 variants),
# reads 1.2e-5 on the loss and up to 2.2e-2 of a gradient tensor's largest
# entry (projection.bias; 1e-3 to 8e-3 for most); without the anchor
# 5.7e-8 and within 1e-3.  So the plain phase-mode step is held at the
# training phase's 1e-3, and the anchored one at 5e-2.
CLI_ANCHORED_GRAD_RTOL = 5e-2
# Phase-mode and .pt serving (the .pt models under --phase extrapolate, so
# that every sample outside the gap is the input's): f32 on the card held to
# f64 on the CPU inside the gap, within 5e-2 of the gap's peak.  The
# anchored phase-mode model's anchor and the extrapolated phase of bins
# quiet at the gap's edge are ill-conditioned: f32 on the card and on the
# CPU lay 2.9e-3 to 1.3e-2 of the gap's peak from f64 (an H100 80GB HBM3 at
# 700 W), card and CPU 1.3e-2 apart on the formant FLACs.  A fault (a sign,
# swapped channels, a wrong anchor) moves the gap by the order of its peak.
CLI_SERVE_F64_RTOL = 5e-2
# The evaluate CLI's per clip gap SDR against the same metric of the
# runners' outputs on each device (dB): the same computation, in f32 on the
# device against f64 here.
CLI_EVAL_SDR_DB = 1e-3
BARE_STEP_MS: dict = {}  # the bare warm steps of training_bf16 and gan_training
SYNC_WARNING = "synchronizing CUDA operation"


def _cli_config(work: Path, name: str, cfg: Config, logging: dict) -> str:
    """``cfg`` with ``logging`` merged in, as a JSON file (which the CLIs
    read without a YAML package), in the YAML files' layout: the CNN+BiLSTM
    keys at the top of ``model``."""
    tree = cfg.to_dict()
    model = tree["model"]
    tree["model"] = {**model.pop("cnn_blstm"), **model}
    tree["logging"] = {**tree["logging"], **logging}
    path = work / f"{name}.json"
    path.write_text(json.dumps(tree))
    return str(path)


def _cli_train(label: str, argv: list, clean_steps: tuple) -> tuple:
    """``cli/train.main(argv)`` on the card, host syncs caught
    (``set_sync_debug_mode("warn")``) and counted by step: a step's share
    is what ran between the launch of the step before it and its own.
    Returns the result and the wall seconds; raises if a step of
    ``clean_steps`` (one after which no log, probe, sample or save ran)
    synchronised."""
    marks = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = train_cli.main(argv, on_step=lambda s: marks.__setitem__(s, len(caught)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wall = time.perf_counter() - t0
    syncs = {s: [f"{Path(w.filename).name}:{w.lineno}" for w in caught[marks[s - 1]:marks[s]]
                 if SYNC_WARNING in str(w.message)] for s in clean_steps}
    log("training_cli", f"{label}: host syncs in steps {list(clean_steps)} (no interval work "
                        f"between them): {[len(v) for v in syncs.values()]}")
    bad = {s: v for s, v in syncs.items() if v}
    if bad:
        raise AssertionError(f"training_cli {label}: host syncs in steps (where): {bad}")
    return res, wall


def _clean_step_ms(res, busy_steps: set) -> float:
    """Median ms a step over the logged intervals that no probe, sample or
    save of their first step ran into."""
    per = [1e3 * sec / (b - a) for a, b, sec in res.intervals if a > 0 and a not in busy_steps]
    if not per:
        raise AssertionError(f"training_cli: no clean interval in {res.intervals}")
    return sorted(per)[len(per) // 2]


def _tree_equal(label: str, got, want, path: str = "state") -> int:
    """Every tensor and value of two checkpoint trees equal, bit for bit;
    returns how many tensors were compared."""
    if torch.is_tensor(want):
        if not (torch.is_tensor(got) and got.dtype == want.dtype and torch.equal(got, want)):
            raise AssertionError(f"{label}: {path} differs")
        return 1
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: {path} keys differ")
        return sum(_tree_equal(label, got[k], want[k], f"{path}/{k}") for k in want)
    if isinstance(want, (list, tuple)):
        return sum(_tree_equal(label, g, w, f"{path}/{i}") for i, (g, w) in
                   enumerate(zip(got, want, strict=True)))
    if got != want:
        raise AssertionError(f"{label}: {path} {got} != {want}")
    return 0


def _runner_of(model: str, flags: list, device: str):
    args = inpaint.build_argparser().parse_args(
        ["--model", model, "--input", "unused", "--output", "unused", *flags, "--device", device])
    cfg = load_config(args.config) if args.config else Config()
    return inpaint._build_runner(args, cfg), cfg


def _serve_card_and_cpu(label: str, model: str, flags: list, files: list, out: Path) -> dict:
    """``model`` with the ``inpaint`` CLI's ``flags`` over ``files`` (80 ms at
    2.0 s): the card's runner and the CPU's in f32, and the CPU's with the
    model and audio in f64, the reference.  Every sample outside the gap is
    the input's, bit for bit, in each; inside, the card lies within
    ``CLI_SERVE_F64_RTOL`` of the gap's peak from the f64 answer.
    ``inpaint.main`` on the card equals ``save_audio`` of the card runner's
    output, bit for bit.  Returns the errors and per clip gap SDR (dB) of
    the three outputs."""
    from ml_audio_inpainting_torch.data.audio_io import load_audio

    audio = np.stack([load_audio(f)[0] for f in files])
    n = len(files)
    gs, gl = np.full(n, GAP_START), np.full(n, GAP_LEN)
    valid = gap_mask(audio.shape[-1], torch.tensor(gs), torch.tensor(gl)).bool()
    outs = {}
    for device in (DEVICE, "cpu"):
        runner, _ = _runner_of(model, flags, device)
        outs[device] = runner(audio, gs, gl).cpu()
    runner.model.double()  # the CPU runner's model, now the f64 reference
    outs["f64"] = runner.inpaint_fn(torch.tensor(audio, dtype=torch.float64), torch.tensor(gs),
                                    torch.tensor(gl))[0]
    clean = torch.tensor(audio, dtype=torch.float64)
    for key, x in outs.items():
        if not torch.equal(x[valid], clean.to(x.dtype)[valid]) or not torch.isfinite(x).all():
            raise AssertionError(f"training_cli {label} ({key}): not finite, or samples outside "
                                 "the gap differ from the input")
    gap = ~valid
    peak = outs["f64"][gap].abs().max().item()
    err = {key: (outs[key].double()[gap] - outs["f64"][gap]).abs().max().item() / peak
           for key in (DEVICE, "cpu")}
    log("training_cli", f"{label}: against f64 on the CPU inside the gap, card {err[DEVICE]:.3e} "
                        f"and CPU f32 {err['cpu']:.3e} of the gap's peak (bound "
                        f"{CLI_SERVE_F64_RTOL}); card vs CPU f32 "
                        f"{(outs[DEVICE][gap] - outs['cpu'][gap]).abs().max().item() / peak:.3e}")
    if not err[DEVICE] <= CLI_SERVE_F64_RTOL:
        raise AssertionError(f"training_cli {label}: card {err[DEVICE]} from f64 > "
                             f"{CLI_SERVE_F64_RTOL}")
    got_dir, want_dir = out / "cli", out / "runner"
    inpaint.main(["--model", model, "--input", str(files[0].parent), "--output", str(got_dir),
                  *flags, "--device", DEVICE])
    for f, x in zip(files, outs[DEVICE].numpy()):
        save_audio(x, want_dir / f"{f.stem}_{model}_inpainted.flac", SAMPLE_RATE)
    _same_decoded(f"training_cli {label}", sorted(got_dir.glob("*.flac")),
                  sorted(want_dir.glob("*.flac")))
    sdr = {key: metrics.gap_sdr(clean, x.double(), gap.double()).numpy()
           for key, x in outs.items()}
    return {"card_err_of_peak": err[DEVICE], "cpu_f32_err_of_peak": err["cpu"], "files": n,
            "gap_sdr_db": sdr}


def phase_training_cli(card: str) -> dict:
    """The training CLI of both families on the card, resume, the phase-mode
    CNN and reference ``.pt`` checkpoints through the serving CLIs; returns
    the launch counts of the hand-written kernels."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    cache = os.environ.get("MAI_FORMANT_CACHE")
    os.environ["MAI_FORMANT_CACHE"] = str(work / "formant_cache")  # clips made once a phase
    try:
        return _training_cli(card, work)
    finally:
        if cache is None:
            os.environ.pop("MAI_FORMANT_CACHE", None)
        else:
            os.environ["MAI_FORMANT_CACHE"] = cache
        shutil.rmtree(work, ignore_errors=True)


def _training_cli(card: str, work: Path) -> dict:
    summary = {"card": card}
    counts_all = []

    # 1. The CNN production recipe through the CLI: bf16, B=128 x 3 gaps, the
    # device feed, EMA, a probe of 32 clips every 4 steps, saves at 4 and 8.
    cfg = b128_recipe_config()
    cfg_path = _cli_config(work, "cnn_b128", cfg, CLI_CNN_LOGGING)
    base = ["--model", "cnn_blstm", "--config", cfg_path, "--synthetic", str(CLI_CNN_CORPUS),
            "--corpus", "formant_v2", "--train-dtype", "bf16", "--batch-size",
            str(cfg.training.batch_size), "--train-n-gaps", str(cfg.data.train_n_gaps), "--feed",
            "device", "--ema", str(GAN_EMA), "--workers", "8", "--device", DEVICE]
    _reset_counts()
    res, wall = _cli_train("cnn bf16 B=128", [
        *base, "--steps", str(CLI_CNN_STEPS), "--probe-every", str(CLI_CNN_PROBE_EVERY),
        "--probe-clips", str(CLI_PROBE_CLIPS), "--base-dir", str(work / "cnn")],
        CLI_CNN_CLEAN_STEPS)
    counts = _counts()
    counts_all.append(counts)
    n_probes = len(res.probes)
    expected = {"lstm_fwd": 3 * n_probes, "lstm_bwd": 0, "lstm_dwhh": 0,
                **{f"{k}_bf16": 3 * CLI_CNN_STEPS for k in KERNELS}}
    if counts != expected:
        raise AssertionError(f"training_cli cnn: launches {counts}, expected {expected} (3 bf16 "
                             f"launches of each kernel a step, 3 f32 lstm_fwd a probe)")
    losses = [v["loss"] for _, v in res.losses]
    steps_saved = CheckpointManager(res.checkpoint_dir).all_steps()
    if (not all(math.isfinite(v) for v in losses) or steps_saved != [4, 8]
            or res.best_npz is None or not res.best_npz.is_file() or res.feed != "device"):
        raise AssertionError(f"training_cli cnn: losses {losses}, checkpoints {steps_saved}, "
                             f"best {res.best_npz}, feed {res.feed}")
    busy = {s for s, *_ in res.saves} | {s for s, *_ in res.probes}
    cli_ms = _clean_step_ms(res, busy)
    bare_ms = BARE_STEP_MS.get("cnn_bf16_b128")
    stats = {"wall_s": wall, "warm_step_ms": cli_ms, "bare_step_ms": bare_ms,
             "losses": losses, "checkpoints": steps_saved,
             "saves": [{"step": s, "s": t, "mb": b / 1e6} for s, t, b in res.saves],
             "probes": [{"step": s, "gap_sdr_db": d, "psm": p, "s": t}
                        for s, d, p, t in res.probes], "best_step": res.best_step,
             "launches": counts}
    log("training_cli", f"cnn bf16 B=128 x 3 gaps: {CLI_CNN_STEPS} steps in {wall:.1f} s (the "
                        f"corpus of {CLI_CNN_CORPUS} clips, the probe set, the model included); "
                        f"losses {[round(v, 2) for v in losses]}; warm step {cli_ms:.2f} ms "
                        f"through the CLI against {bare_ms} ms bare (training_bf16); saves "
                        + ", ".join(f"step {s}: {t:.2f} s {b / 1e6:.1f} MB" for s, t, b in res.saves)
                        + "; probes " + ", ".join(f"step {s}: {d:.2f} dB, PSM {p:.4f}, {t:.2f} s"
                                                  for s, d, p, t in res.probes)
                        + f"; launches {counts} ({card})")

    # best_inference.npz through the inpaint CLI against a runner of the
    # restored best state (its EMA weights rounded to f16 as the export
    # stores them), bit for bit.
    clips_dir = work / "clips"
    clips = speech_like_batch(np.random.default_rng(41), 4)
    files = [clips_dir / f"clip{i}.flac" for i in range(len(clips))]
    for clip, f in zip(clips, files):
        save_audio(clip, f, SAMPLE_RATE)
    tree = CheckpointManager(res.checkpoint_dir / "best").load_tree(res.best_step)
    best_model = build_model(cfg, DEVICE)
    best_model.load_state_dict({k: v.half().float() if v.is_floating_point() else v
                                for k, v in {**tree["model"], **tree["ema_params"]}.items()})
    from ml_audio_inpainting_torch.data.audio_io import load_audio

    audio = torch.tensor(np.stack([load_audio(f)[0] for f in files]), device=DEVICE)
    with full_f32_convolutions():
        want = make_cnn_inpaint_fn(cfg, best_model)(
            audio, torch.full((len(files),), GAP_START, device=DEVICE),
            torch.full((len(files),), GAP_LEN, device=DEVICE))[0]
    for f, x in zip(files, want.cpu().numpy()):
        save_audio(x, work / "best_runner" / f"{f.stem}_cnn_blstm_inpainted.flac", SAMPLE_RATE)
    inpaint.main(["--model", "cnn_blstm", "--config", cfg_path, "--checkpoint", str(res.best_npz),
                  "--input", str(clips_dir), "--output", str(work / "best_cli"), "--device",
                  DEVICE])
    _same_decoded("training_cli best_inference.npz", sorted((work / "best_cli").glob("*.flac")),
                  sorted((work / "best_runner").glob("*.flac")))
    log("training_cli", f"best_inference.npz (step {res.best_step}) served by the inpaint CLI: "
                        f"{len(files)} files equal, bit for bit, to a runner of the restored best "
                        f"state's EMA weights")
    del best_model

    # 2. Resume: the saved state restored bit for bit, one step from it equal
    # to one step from the state in memory, then the CLI's --resume-from.
    template = create_cnn_state(cfg, device=DEVICE, ema=GAN_EMA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(res.checkpoint_dir).restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    n_tensors = _tree_equal("training_cli restore", state_tree(template), state_tree(res.state))
    batch = torch.tensor(speech_like_batch(np.random.default_rng(42), cfg.training.batch_size),
                         device=DEVICE)
    gaps = train_cli.GapDraws(cfg, DEVICE, seed=43).cnn(cfg.training.batch_size)
    step = make_cnn_train_step(cfg, ema=GAN_EMA, compute_dtype=torch.bfloat16)
    with _deterministic_cudnn():
        for s in (template, res.state):
            step(s, batch, *gaps)
    _tree_equal("training_cli one step from the restored state", state_tree(template),
                state_tree(res.state))
    del template
    _reset_counts()
    res2, _ = _cli_train("cnn resumed", [
        *base, "--steps", str(CLI_CNN_STEPS + 1), "--base-dir", str(work / "cnn_resume"),
        "--resume-from", str(res.checkpoint_dir)], ())
    counts = _counts()
    counts_all.append(counts)
    adam_steps = {int(v["step"]) for v in res2.state.optimizer.state.values()}
    if (res2.step != CLI_CNN_STEPS + 1 or adam_steps != {CLI_CNN_STEPS + 1}
            or CheckpointManager(res2.checkpoint_dir).all_steps() != [CLI_CNN_STEPS + 1]
            or counts["lstm_fwd_bf16"] != 3):
        raise AssertionError(f"training_cli resume: step {res2.step}, Adam steps {adam_steps}, "
                             f"launches {counts}")
    summary["cnn"] = {**stats, "restore_s": restore_s, "restored_tensors": n_tensors}
    log("training_cli", f"resume: {n_tensors} tensors restored bit for bit in {restore_s:.2f} s "
                        f"(parameters, running statistics, Adam moments and step counts, EMA); "
                        f"one bf16 step from them equal, bit for bit, to one from the state in "
                        f"memory (deterministic cuDNN algorithms); --resume-from went on to step "
                        f"{res2.step}, Adam's step count {adam_steps}")
    del res, res2

    # 3. The phase-mode CNN, anchored, at full width: configs/cnn_blstm.yaml's
    # values (1 clip x 25 variants, f32, one gap).
    pcfg = recipe_config()
    pcfg_path = _cli_config(work, "cnn_phase", pcfg, {"metric_interval": 1})
    pcfg.model.cnn_blstm.in_channels = 2
    init = create_cnn_state(pcfg, device="cpu", seed=0)
    flat = live_bilstm(cnn_blstm_flat_variables(init.model.state_dict()), seed=6)
    del init
    clip = speech_like_batch(np.random.default_rng(100), 1)
    starts = gap_starts(torch.Generator().manual_seed(5), pcfg, 1, 2)
    checks = {}
    for label, anchor, rtol in (("phase-mode", False, STEP_GRAD_RTOL_OF_MAX),
                                ("phase-mode anchored", True, CLI_ANCHORED_GRAD_RTOL)):
        checks[label] = _check_step_against_cpu(pcfg, flat, clip, starts, label,
                                                phase="training_cli", grad_rtol=rtol,
                                                phase_mode=True, phase_anchor=anchor)
    pargv = ["--model", "cnn_blstm", "--config", pcfg_path, "--synthetic", str(CLI_PHASE_CORPUS),
             "--corpus", "formant_v2", "--phase-mode", "--phase-anchor", "--feed", "device",
             "--workers", "8", "--steps", str(CLI_PHASE_STEPS), "--base-dir", str(work / "phase"),
             "--device", DEVICE]
    _reset_counts()
    pres, pwall = _cli_train("phase-mode anchored", pargv, ())
    counts = _counts()
    counts_all.append(counts)
    expected = {**{k: 3 * CLI_PHASE_STEPS for k in KERNELS}, **{f"{k}_bf16": 0 for k in KERNELS}}
    plosses = [v["loss"] for _, v in pres.losses]
    if counts != expected or not all(math.isfinite(v) for v in plosses):
        raise AssertionError(f"training_cli phase: launches {counts} (expected {expected}), "
                             f"losses {plosses}")
    log("training_cli", f"phase-mode anchored, 1 clip x 25 variants, f32: {CLI_PHASE_STEPS} steps "
                        f"in {pwall:.1f} s, losses {[round(v, 2) for v in plosses]}, launches "
                        f"{counts} ({card})")
    # Served from its checkpoint directory, card against CPU, by both CLIs.
    _reset_counts()
    serving = {}
    flags = ["--config", pcfg_path, "--checkpoint", str(pres.checkpoint_dir)]
    for name, fs in (("synthetic", files), ("formant", sorted(FORMANT_DIR.glob("*.flac")))):
        served = _serve_card_and_cpu(f"cnn_phase_anchored on the {name} FLACs",
                                     "cnn_phase_anchored", flags, fs, work / f"ph_{name}")
        sdr = served.pop("gap_sdr_db")
        runs = {}
        for device in (DEVICE, "cpu"):
            eargs = evaluate.build_argparser().parse_args(
                ["--models", "cnn_phase_anchored", *flags, "--input", str(fs[0].parent),
                 "--device", device])
            runs[device] = evaluate.run(eargs)[1]["cnn_phase_anchored"]
        own = max(np.abs(runs[d]["gap_sdr_db"] - sdr[d]).max() for d in (DEVICE, "cpu"))
        if not own <= CLI_EVAL_SDR_DB:
            raise AssertionError(f"training_cli evaluate cnn_phase_anchored ({name}): gap SDR "
                                 f"{own} dB from the runners' outputs' > {CLI_EVAL_SDR_DB}")
        diff = np.abs(runs[DEVICE]["gap_sdr_db"] - runs["cpu"]["gap_sdr_db"]).max()
        serving[name] = {**served, "eval_gap_sdr_db": float(np.mean(runs[DEVICE]["gap_sdr_db"])),
                         "eval_card_vs_cpu_db": float(diff),
                         "f64_gap_sdr_db": float(np.mean(sdr["f64"]))}
        log("training_cli", f"evaluate cnn_phase_anchored ({name}): gap SDR "
                            f"{serving[name]['eval_gap_sdr_db']:.3f} dB (f64 "
                            f"{serving[name]['f64_gap_sdr_db']:.3f}), each device within {own:.1e} dB "
                            f"of its runner's outputs (bound {CLI_EVAL_SDR_DB}); card vs CPU "
                            f"{diff:.2e} dB")
    counts = _counts()
    counts_all.append(counts)
    if counts["lstm_fwd"] % 3 or not counts["lstm_fwd"] or any(
            v for k, v in counts.items() if k != "lstm_fwd"):
        raise AssertionError(f"training_cli phase serving: launches {counts}")
    summary["phase"] = {"checks": {k: {m: v for m, v in c.items() if m != "zero_grad"}
                                   for k, c in checks.items()},
                        "wall_s": pwall, "losses": plosses, "serving": serving}

    # 4. Reference .pt checkpoints (seeded, the reference's layout): full
    # width, and the v2 global-pool lineage (hidden 64, the BiLSTM reading
    # the encoder's 32 channels), card against CPU.
    _reset_counts()
    summary["pt"] = {}
    for label, kw in (("full width", {}),
                      ("global pool", {"hidden": 64, "global_pool": True})):
        path = work / f"{label.replace(' ', '_')}.pt"
        torch.save(seeded_reference_cnn_state_dict(51, **kw), path)
        served = _serve_card_and_cpu(
            f".pt {label}", "cnn_blstm", ["--checkpoint", str(path), "--phase", "extrapolate"],
            files, work / path.stem)
        served.pop("gap_sdr_db")
        summary["pt"][label] = served
    counts = _counts()
    counts_all.append(counts)
    if counts["lstm_fwd"] != 3 * 2 * 2 or any(v for k, v in counts.items() if k != "lstm_fwd"):
        raise AssertionError(f"training_cli .pt: launches {counts} (3 a card request)")

    # 5. GAN training through the CLI: gan_recipe_config, bf16, B=32, EMA.
    gcfg_path = _cli_config(work, "gan", gan_recipe_config(), CLI_GAN_LOGGING)
    gargv = ["--model", "gan", "--config", gcfg_path, "--synthetic", str(CLI_GAN_CORPUS),
             "--corpus", "formant_v2", "--train-dtype", "bf16", "--feed", "device", "--ema",
             str(GAN_EMA), "--workers", "8", "--steps", str(CLI_GAN_STEPS), "--base-dir",
             str(work / "gan"), "--device", DEVICE]
    _reset_counts()
    gres, gwall = _cli_train("gan bf16 B=32", gargv, CLI_GAN_CLEAN_STEPS)
    counts = _counts()
    counts_all.append(counts)
    if any(counts.values()):
        raise AssertionError(f"training_cli gan launched an LSTM kernel: {counts}")
    glosses = [(v["g_total"], v["d_total"]) for _, v in gres.losses]
    mgr = CheckpointManager(gres.checkpoint_dir)
    if (not all(math.isfinite(x) for pair in glosses for x in pair) or mgr.all_steps() != [4, 6]
            or len(gres.samples) != 1):
        raise AssertionError(f"training_cli gan: losses {glosses}, checkpoints "
                             f"{mgr.all_steps()}, samples {gres.samples}")
    samples, rate, md5_ok = read_audio(gres.samples[0])
    if md5_ok != 1 or rate != SAMPLE_RATE or samples.shape[0] != SAMPLE_RATE * 5:
        raise AssertionError(f"training_cli gan sample: md5_ok {md5_ok}, rate {rate}, "
                             f"{samples.shape}")
    gtemplate = dict(zip(("g", "d"), create_gan_states(gan_recipe_config(), device=DEVICE,
                                                         g_ema=GAN_EMA)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.restore(gtemplate)
    torch.cuda.synchronize()
    grestore_s = time.perf_counter() - t0
    n_gtensors = _tree_equal("training_cli gan restore", state_tree(gtemplate),
                             state_tree(gres.state))
    del gtemplate
    gbusy = {s for s, *_ in gres.saves} | {4}
    gcli_ms = _clean_step_ms(gres, gbusy)
    summary["gan"] = {"wall_s": gwall, "warm_step_ms": gcli_ms,
                      "bare_step_ms": BARE_STEP_MS.get("gan_bf16_b32"), "losses": glosses,
                      "saves": [{"step": s, "s": t, "mb": b / 1e6} for s, t, b in gres.saves],
                      "restore_s": grestore_s, "restored_tensors": n_gtensors,
                      "sample": gres.samples[0].name}
    log("training_cli", f"gan bf16 B=32: {CLI_GAN_STEPS} steps in {gwall:.1f} s; warm step "
                        f"{gcli_ms:.2f} ms through the CLI against "
                        f"{BARE_STEP_MS.get('gan_bf16_b32')} ms bare (gan_training); saves "
                        + ", ".join(f"step {s}: {t:.2f} s {b / 1e6:.1f} MB" for s, t, b in gres.saves)
                        + f"; {{g, d}} ({n_gtensors} tensors) restored bit for bit in "
                        f"{grestore_s:.2f} s; sample {gres.samples[0].name} (FLAC, MD5 verified); "
                        f"no LSTM kernel ({card})")
    del gres

    launches = {k: sum(c[k] for c in counts_all) for k in counts_all[0]}
    summary["launches"] = launches
    log("training_cli", f"summary ({card}): {json.dumps(summary)}")
    return launches


# ------------------------------------------------------------------ refiner

# refiner: the gap refiner (committed GAN + AR fill + committed head) served,
# trained through cli/train_refiner.py, test-time adaptation through evaluate,
# and the ops/refine solvers, at B=32 x 5 s, f32, TF32 off.
REFINER_CHECKPOINT = REPO / "results" / "checkpoints" / "refiner_formant_v2_r3.npz"
REFINER_WARM = 3
REFINER_SPLIT_REPS = 3  # CUDA-event reps of each part of a request
# Clip 0 on the card against the port on the CPU, inside the gap, as a share
# of the CPU's gap peak: the neural channel is the GAN under extrapolate, so
# serving_deployable's GAN bound (its phase can wrap a turn elsewhere on the
# card); the AR channel's f32 Levinson rounds apart well inside it (the
# classical phase's f32 CLI bound, 1e-3 of the gap's peak).
REFINER_RTOL = GAN_DEPLOYABLE_RTOL
# evaluate on the formant FLACs, card against CPU: the refiner's gap SDR
# within the extrapolate bound of the evaluation phase, arinpaint (tuned) as
# the classical phase holds it.
REFINER_EVAL_SDR_DB = EVAL_SDR_DB["extrapolate"]
# training: 20 steps at the CLI's defaults (B=8, C=64, lr 3e-4) on a 64-clip
# formant_v2 corpus, a 16-clip probe every 10 steps.  Clean steps: those
# after which nothing but the step ran (a log follows step 0, a probe steps 9
# and 19; the window of step i runs from step i-1's callback to its own).
REFINER_CORPUS = 64
REFINER_STEPS = 20
REFINER_PROBE_EVERY = 10
REFINER_PROBE_CLIPS = 16
REFINER_CLEAN_STEPS = tuple(i for i in range(2, REFINER_STEPS) if i != REFINER_PROBE_EVERY)
REFINER_TIMER_STEPS = 6  # bare steps timed, the first 2 left out
# step 0 of the head on the card (f32) against the CPU (f64) on the card's
# own example windows: loss rtol 1e-4, each gradient within 1e-3 of its
# largest entry (the training phase's bounds: sums in another order).
REFINER_STEP_LOSS_RTOL = 1e-4
REFINER_STEP_GRAD_RTOL_OF_MAX = 1e-3
REFINER_CHECK_CLIPS = 8
# adaptation: evaluate --models gan --adapt-steps 10 --adapt-probe-every 5.
ADAPT_STEPS = 10
ADAPT_PROBE_EVERY = 5
# ops/refine: 100 projections and 50 Adam steps (AR order 32 on the gap's
# 4096-sample left context, weight 0.1) at B=32; f64 on the card against f64
# on the CPU (clip 0) within 1e-6 of the gap's peak (sums in another order,
# ~1e-16 a step, through 100 iterations; Adam on gap samples whose gradients
# are far from rounding noise).
REFINE_ITERS = 100
REFINE_STEPS = 50
REFINE_AR_ORDER = 32
REFINE_AR_WEIGHT = 0.1
REFINE_F64_RTOL = 1e-6


def _refiner_quality(clean: torch.Tensor, restored: torch.Tensor, gap: torch.Tensor) -> dict:
    """Per-clip gap SDR (dB) and its bootstrap-t 95 % interval over the finite
    clips (a clip whose f32 AR fit blew up counts as non-finite)."""
    sdr = metrics.gap_sdr(clean.double(), restored.double(), gap.double()).cpu().numpy()
    keep = np.isfinite(sdr)
    mean, lo, hi = bootstrap_ci(sdr[keep]) if keep.sum() else (np.nan,) * 3
    return {"gap_sdr_db": [float(v) for v in sdr], "mean": float(mean), "ci95": [float(lo),
            float(hi)], "n": int(keep.sum()), "non_finite_clips": int((~keep).sum())}


def _refiner_serving(card: str, work: Path) -> dict:
    """Serving at B=32 x 5 s: times, the split of a request, checks, quality,
    then the inpaint and evaluate CLIs on the formant FLACs, card vs CPU."""
    cfg = gan_config()
    gen = load_generator(cfg, GAN_CHECKPOINT, DEVICE)
    head = load_refiner(load_params_npz(REFINER_CHECKPOINT), DEVICE)
    apply = make_refiner_apply_fn(cfg, gen)
    audio = torch.tensor(synthetic_dataset_batch(B), device=DEVICE)
    b, n = audio.shape
    gs = torch.full((b,), GAP_START, device=DEVICE)
    gl = torch.full((b,), GAP_LEN, device=DEVICE)
    valid = gap_mask(n, gs, gl)
    stats, restored = _timed_requests(lambda: apply(head, audio, gs, gl), "refiner serving",
                                      b * n / SAMPLE_RATE, phase="refiner", warm=REFINER_WARM)
    _check_outside("refiner serving", restored, audio, valid)

    # The device time of each part of a request, each timed alone by CUDA events.
    gan_fn = make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase="extrapolate")
    examples = make_example_fn(cfg, gen)
    ex = examples(audio, gs, gl)
    with full_f32_convolutions(), torch.inference_mode():
        split = {
            "gan_extrapolate_ms": cuda_ms(lambda: gan_fn(audio, gs, gl), REFINER_SPLIT_REPS, 1),
            "ar_fill_ms": cuda_ms(lambda: arinpaint(audio * valid, valid, gs, gl, order=512,
                                                   context=4096, max_gap=MAX_GAP),
                                  REFINER_SPLIT_REPS, 1),
            "head_ms": cuda_ms(lambda: head(ex["impaired"], ex["ar"], ex["neural"], ex["gap_ind"]),
                               10, 2),
        }
    split["whole_request_ms"] = min(stats["warm_request_ms"])
    split["rest_ms"] = split["whole_request_ms"] - sum(v for k, v in split.items()
                                                       if k != "whole_request_ms")
    stats["split"] = split
    log("refiner", "device time of a request's parts, each alone (CUDA events): " + ", ".join(
        f"{k} {v:.2f}" for k, v in split.items()) + f" ({card})")

    # A fresh head (zero last projection) is the AR fill inside the gap, bit for bit.
    fresh = WaveRefiner().init_weights(torch.Generator().manual_seed(0)).to(DEVICE)
    with torch.no_grad(), full_f32_convolutions():
        first = fresh(ex["impaired"], ex["ar"], ex["neural"], ex["gap_ind"])
    if not torch.equal(first, torch.where(ex["gap_ind"] > 0, ex["ar"], ex["impaired"])):
        raise AssertionError("refiner: a fresh head is not the AR fill bit for bit")

    # Clip 0 against the port on the CPU.
    t0 = time.perf_counter()
    cpu_gen = load_generator(cfg, GAN_CHECKPOINT, "cpu")
    want = make_refiner_apply_fn(cfg, cpu_gen)(load_refiner(load_params_npz(REFINER_CHECKPOINT),
                                                            "cpu"),
                                               audio[:1].cpu(), gs[:1].cpu(), gl[:1].cpu())
    stats["cpu_clip_s"] = time.perf_counter() - t0
    stats["clip0_vs_cpu"] = _check_against_cpu("refiner clip 0", restored[:1], want, valid[:1],
                                               REFINER_RTOL, phase="refiner")

    # Quality record (not a gate): the refined and the AR-filled gap.
    files = sorted(FORMANT_DIR.glob("*.flac"))
    flacs = torch.tensor(evaluate.load_clean(files, Config()), device=DEVICE)
    fgs = torch.full((len(files),), GAP_START, device=DEVICE)
    fgl = torch.full((len(files),), GAP_LEN, device=DEVICE)
    fvalid = gap_mask(flacs.shape[-1], fgs, fgl)
    frestored = apply(head, flacs, fgs, fgl)
    _check_outside("refiner FLACs", frestored, flacs, fvalid)
    with torch.inference_mode():
        ar_syn = arinpaint(audio * valid, valid, gs, gl, order=512, context=4096, max_gap=MAX_GAP)
        ar_fl = arinpaint(flacs * fvalid, fvalid, fgs, fgl, order=512, context=4096,
                          max_gap=MAX_GAP)
    stats["quality"] = {
        "synthetic": {"refined": _refiner_quality(audio, restored, 1 - valid),
                      "ar": _refiner_quality(audio, ar_syn, 1 - valid)},
        "flacs": {"refined": _refiner_quality(flacs, frestored, 1 - fvalid),
                  "ar": _refiner_quality(flacs, ar_fl, 1 - fvalid)}}
    for where, q in stats["quality"].items():
        log("refiner", f"quality ({where}, record, not a gate): gap SDR refined "
                       f"{q['refined']['mean']:.3f} dB (95 % CI {q['refined']['ci95'][0]:.3f} to "
                       f"{q['refined']['ci95'][1]:.3f}, n={q['refined']['n']}, "
                       f"{q['refined']['non_finite_clips']} non-finite), AR {q['ar']['mean']:.3f} dB (95 % CI {q['ar']['ci95'][0]:.3f}"
                       f" to {q['ar']['ci95'][1]:.3f}, n={q['ar']['n']}, {q['ar']['non_finite_clips']} "
                       f"non-finite)")

    # The CLIs over the formant FLACs, card against CPU.
    argv = ["--model", "refiner", "--checkpoint", str(REFINER_CHECKPOINT), "--input",
            str(FORMANT_DIR)]
    walls = {}
    for where, device in (("card", DEVICE), ("cpu", "cpu")):
        t0 = time.perf_counter()
        inpaint.main([*argv, "--output", str(work / "inpaint" / where), "--device", device])
        walls[f"inpaint_{where}"] = time.perf_counter() - t0
    gap = slice(GAP_START, GAP_START + GAP_LEN)
    worst_out, worst_gap = 0.0, 0.0
    for f in sorted((work / "inpaint" / "cpu").glob("*.flac")):
        got = read_audio(work / "inpaint" / "card" / f.name)[0][:, 0]
        want_f = read_audio(f)[0][:, 0]
        outside = np.ones(len(want_f), bool)
        outside[gap] = False
        d_out = np.abs(got - want_f)[outside].max() * 32768
        d_gap = np.abs(got - want_f)[gap].max()
        bound = max(1 / 32768, REFINER_RTOL * np.abs(want_f[gap]).max())
        if not (d_out <= 1.0001 and d_gap <= bound * 1.0001):
            raise AssertionError(f"refiner inpaint CLI: {f.name} card vs CPU {d_out} LSB outside "
                                 f"the gap, {d_gap} inside (bound {bound})")
        worst_out, worst_gap = max(worst_out, float(d_out)), max(worst_gap, float(d_gap) * 32768)
    results = {}
    argv = ["--models", "refiner", "arinpaint", "--ar-preset", "tuned", "--checkpoint",
            str(REFINER_CHECKPOINT), "--input", str(FORMANT_DIR)]
    for where, device in (("card", DEVICE), ("cpu", "cpu")):
        t0 = time.perf_counter()
        evaluate.main([*argv, "--output-json", str(work / f"refiner_{where}.json"), "--device",
                       device])
        walls[f"evaluate_{where}"] = time.perf_counter() - t0
        results[where] = json.loads((work / f"refiner_{where}.json").read_text())
    if results["card"]["condition"] != results["cpu"]["condition"]:
        raise AssertionError("refiner evaluate CLI: the conditions differ")
    bounds = {"refiner": REFINER_EVAL_SDR_DB, "arinpaint": CLASSICAL_EVAL_ATOL["arinpaint"]}
    worst = {}
    for model, bound in bounds.items():
        d = np.abs(np.subtract(results["card"]["results"][model]["gap_sdr_db"],
                               results["cpu"]["results"][model]["gap_sdr_db"])).max()
        worst[model] = float(d)
        if not d <= bound + 1e-9:
            raise AssertionError(f"refiner evaluate CLI: {model} gap SDR card vs CPU {d} > "
                                 f"{bound}")
    stats["clis"] = {"wall_s": walls, "inpaint_lsb_outside": worst_out,
                     "inpaint_lsb_gap": worst_gap, "evaluate_gap_sdr_worst_db": worst,
                     "evaluate_card": results["card"]["results"]}
    log("refiner", f"CLIs on the formant FLACs: inpaint card {walls['inpaint_card']:.2f} s, CPU "
                   f"{walls['inpaint_cpu']:.2f} s, card vs CPU {worst_out:.0f} LSB outside the "
                   f"gap, {worst_gap:.0f} inside; evaluate (refiner, arinpaint tuned) card "
                   f"{walls['evaluate_card']:.2f} s, CPU {walls['evaluate_cpu']:.2f} s, gap SDR "
                   f"card vs CPU worst {json.dumps(worst)} dB ({card})")
    return stats


def _refiner_step0(head_flat: dict, ex: dict, device, dtype) -> tuple:
    """Loss and gradients of the head's first step on the example windows
    ``ex`` on ``device`` in ``dtype``."""
    head = WaveRefiner()
    head.load_state_dict(refiner_state_dict(head_flat))
    head = head.to(device, dtype)
    w = {k: v.to(device, dtype) for k, v in ex.items() if k != "start"}
    with full_f32_convolutions():
        out = head(w["impaired"], w["ar"], w["neural"], w["gap_ind"])
        loss = _gap_loss(out, w["clean"], w["gap_ind"], energy_gate=True)
        grads = torch.autograd.grad(loss, list(head.parameters()))
    names = [k for k, _ in head.named_parameters()]
    return loss.item(), {k: g.double().cpu() for k, g in zip(names, grads)}


def _refiner_training(card: str, work: Path) -> dict:
    """train_refiner on the card, host syncs counted by step; a bare loop
    timed; step 0 against f64 on the CPU; the export served,
    and souped with the committed head and served."""
    cfg = gan_config()
    t0 = time.perf_counter()
    corpus = FormantSpeechDataset(n_items=REFINER_CORPUS + REFINER_PROBE_CLIPS,
                                  sample_rate=cfg.data.sample_rate, max_len_s=cfg.data.max_len_s,
                                  variant="v2")
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(corpus.__getitem__, range(len(corpus))))
    synth_s = time.perf_counter() - t0
    log("refiner", f"{len(corpus)} formant_v2 clips synthesised into the disk cache in "
                   f"{synth_s:.1f} s (8 threads), apart from the training time")

    out = work / "head.npz"
    argv = ["--synthetic", str(REFINER_CORPUS), "--corpus", "formant_v2", "--steps",
            str(REFINER_STEPS), "--probe-every", str(REFINER_PROBE_EVERY), "--probe-clips",
            str(REFINER_PROBE_CLIPS), "--gan-checkpoint", str(GAN_CHECKPOINT), "--out", str(out),
            "--device", DEVICE]
    marks = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = train_refiner.main(argv, on_step=lambda i, s, m: marks.__setitem__(
                i, len(caught)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    wall = time.perf_counter() - t0
    syncs = {i: [f"{Path(w.filename).name}:{w.lineno}" for w in caught[marks[i - 1]:marks[i]]
                 if SYNC_WARNING in str(w.message)] for i in REFINER_CLEAN_STEPS}
    bad = {i: v for i, v in syncs.items() if v}
    if bad:
        raise AssertionError(f"refiner training: host syncs in steps (where): {bad}")
    losses = [loss for _, loss, _ in res.logs]
    if (res.state.step != REFINER_STEPS or not out.is_file()
            or not all(math.isfinite(v) for _, a, b in res.probes for v in (a, b))
            or not all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"refiner training: steps {res.state.step}, export {out.is_file()}, "
                             f"probes {res.probes}, losses {losses}")
    stats = {"wall_s": wall, "synth_s": synth_s, "probes": res.probes, "best_step": res.best_step,
             "logs": res.logs, "host_syncs_clean_steps": 0,
             "cli_step_s_median": sorted(res.step_s[2:])[len(res.step_s[2:]) // 2]}
    log("refiner", f"train_refiner B=8 C=64: {REFINER_STEPS} steps in {wall:.1f} s (probes and "
                   f"the model included); probes (step, refined dB, AR dB) {res.probes}; best "
                   f"step {res.best_step}; host syncs in steps {list(REFINER_CLEAN_STEPS)}: 0; "
                   f"host time a step to its return (median) {1e3 * stats['cli_step_s_median']:.1f}"
                   f" ms ({card})")

    # The warm step on the wall clock, on one device batch: the steps after
    # the first 2 in one loop that ends in a synchronise.
    gen = load_generator(cfg, GAN_CHECKPOINT, DEVICE)
    state = create_refiner_state(torch.Generator().manual_seed(0), device=DEVICE,
                                 params=load_params_npz(REFINER_CHECKPOINT))
    step = make_refiner_train_step(cfg, gen)
    batch = torch.tensor(np.stack([corpus[i] for i in range(8)]), device=DEVICE)
    draws = torch.Generator(device=DEVICE).manual_seed(1)
    for i in range(REFINER_TIMER_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, batch, *draw_refiner_gaps(draws, cfg, 8, cfg.data.max_samples))
    torch.cuda.synchronize()
    stats["step_timer"] = {"steps": REFINER_TIMER_STEPS - 2,
                           "mean_ms": 1e3 * (time.perf_counter() - t0) / (REFINER_TIMER_STEPS - 2)}
    log("refiner", f"bare train step B=8 on the wall clock: {json.dumps(stats['step_timer'])} "
                   f"({card})")

    # Step 0 on the card (f32) against the CPU (f64), the card's own windows.
    gl, cands = draw_refiner_gaps(torch.Generator(device=DEVICE).manual_seed(2), cfg,
                                  REFINER_CHECK_CLIPS, cfg.data.max_samples)
    csum = torch.cumsum(batch[:REFINER_CHECK_CLIPS] ** 2, -1)
    energy = csum.gather(-1, cands + gl[:, None]) - csum.gather(-1, cands)
    gs = cands.gather(-1, energy.argmax(-1, keepdim=True))[:, 0]
    ex = make_example_fn(cfg, gen)(batch[:REFINER_CHECK_CLIPS], gs, gl)
    flat = load_params_npz(REFINER_CHECKPOINT)
    card_loss, card_g = _refiner_step0(flat, ex, DEVICE, torch.float32)
    t0 = time.perf_counter()
    cpu_loss, cpu_g = _refiner_step0(flat, ex, "cpu", torch.float64)
    worst = max((card_g[k] - cpu_g[k]).abs().max().item() / cpu_g[k].abs().max().item()
                for k in cpu_g if cpu_g[k].abs().max() > 0)
    stats["step0"] = {"card_loss": card_loss, "cpu_f64_loss": cpu_loss, "grad_err_of_max": worst,
                      "cpu_s": time.perf_counter() - t0}
    log("refiner", f"step 0 on {REFINER_CHECK_CLIPS} clips, card f32 vs CPU f64: loss {card_loss:.6f}"
                   f" vs {cpu_loss:.6f}, worst gradient {worst:.2e} of its largest entry (bounds "
                   f"rtol {REFINER_STEP_LOSS_RTOL}, {REFINER_STEP_GRAD_RTOL_OF_MAX})")
    if not (abs(card_loss - cpu_loss) <= REFINER_STEP_LOSS_RTOL * abs(cpu_loss)
            and worst <= REFINER_STEP_GRAD_RTOL_OF_MAX):
        raise AssertionError(f"refiner step 0: card and CPU f64 disagree: {stats['step0']}")

    # The export served by inpaint; the soup of it and the committed head too.
    soup_cli.main([str(work / "soup.npz"), str(out), str(REFINER_CHECKPOINT)])
    served = {}
    for name in ("head", "soup"):
        dest = work / f"served_{name}"
        inpaint.main(["--model", "refiner", "--checkpoint", str(work / f"{name}.npz"), "--input",
                      str(FORMANT_DIR), "--output", str(dest), "--device", DEVICE])
        decoded = [read_audio(f) for f in sorted(dest.glob("*.flac"))]
        if len(decoded) != 3 or not all(ok and np.isfinite(x).all() for x, _, ok in decoded):
            raise AssertionError(f"refiner: the {name} npz did not serve the 3 FLACs")
        served[name] = len(decoded)
    stats["served"] = served
    log("refiner", f"the export and its soup with the committed head served by inpaint "
                   f"(3 FLACs each, MD5 verified)")
    return stats


def _refiner_adaptation(card: str, work: Path) -> dict:
    """evaluate --models gan --adapt-steps on the formant FLACs; the runner's
    generator bit for bit as it was."""
    captured = {}
    build = inpaint._build_runner

    def capturing(args, cfg):
        runner = build(args, cfg)
        captured["runner"] = runner
        captured["before"] = {k: v.clone() for k, v in runner.model.state_dict().items()}
        return runner

    argv = ["--models", "gan", "--checkpoint", str(GAN_CHECKPOINT), "--mode", "enhanced",
            "--phase", "extrapolate", "--adapt-steps", str(ADAPT_STEPS), "--adapt-probe-every",
            str(ADAPT_PROBE_EVERY), "--input", str(FORMANT_DIR), "--output-json",
            str(work / "adapt.json"), "--device", DEVICE]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(inpaint, "_build_runner", capturing):
        evaluate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = captured["runner"].model.state_dict()
    changed = [k for k, v in captured["before"].items() if not torch.equal(v, after[k])]
    if changed:
        raise AssertionError(f"adaptation changed the runner's weights: {changed[:5]}")
    payload = json.loads((work / "adapt.json").read_text())
    info = payload["adapt_info"]
    probed = [0] + [i for i in range(1, ADAPT_STEPS + 1)
                    if i % ADAPT_PROBE_EVERY == 0 or i == ADAPT_STEPS]
    if payload["condition"]["adapt"]["steps"] != ADAPT_STEPS or len(info) != 3 or not all(
            [s for s, _ in v["probe_trajectory"]] == probed for v in info.values()):
        raise AssertionError(f"adaptation JSON: {payload['condition']}, {info}")
    stats = {"wall_s": wall, "s_a_clip": wall / len(info), "adapt_info": info,
             "gap_sdr_db": payload["results"]["gan"]["gap_sdr_db"],
             "runner_weights_unchanged": len(captured["before"])}
    log("refiner", f"evaluate --models gan --adapt-steps {ADAPT_STEPS} --adapt-probe-every "
                   f"{ADAPT_PROBE_EVERY}, 3 FLACs: {wall:.1f} s ({stats['s_a_clip']:.1f} s a clip, "
                   f"the model and metrics included); best steps "
                   f"{ {k: v['best_step'] for k, v in info.items()} }; trajectories "
                   f"{ {k: v['probe_trajectory'] for k, v in info.items()} }; gap SDR "
                   f"{stats['gap_sdr_db']}; the runner's {len(captured['before'])} tensors bit for "
                   f"bit as before ({card})")
    return stats


def _refine_ops(card: str) -> dict:
    """consistent_reconstruct and magnitude_descent at B=32 x 5 s on the GAN's
    magnitude, warm-started from the AR fill; f64 card vs CPU on clip 0."""
    cfg = gan_config()
    kw = dict(n_fft=cfg.data.spectrogram.n_fft, hop_length=cfg.data.spectrogram.hop_length,
              win_length=cfg.data.spectrogram.win_length)
    gen = load_generator(cfg, GAN_CHECKPOINT, DEVICE)
    audio = torch.tensor(synthetic_dataset_batch(B), device=DEVICE)
    b, n = audio.shape
    gs = torch.full((b,), GAP_START, device=DEVICE)
    gl = torch.full((b,), GAP_LEN, device=DEVICE)
    valid = gap_mask(n, gs, gl)
    observed = audio * valid
    with full_f32_convolutions(), torch.no_grad():  # the inputs take autograd in the descent
        generated = make_gan_inpaint_fn(cfg, gen, mode="enhanced", phase="extrapolate")(
            audio, gs, gl)[1]
        spec_gap = stft(observed, **kw)
        fmask = frame_mask_from_interval(gs, gs + gl, *spec_gap.shape[-2:], kw["hop_length"])
        mag = masking.log1p_denorm(masking.composite(generated, masking.log1p_norm(spec_gap.abs()),
                                                     fmask))
        init = arinpaint(observed, valid, gs, gl, order=512, context=4096, max_gap=MAX_GAP)
        init = torch.nan_to_num(init).clamp(-4.0, 4.0)
        ctx = observed[:, GAP_START - 4096:GAP_START]
        coef = lpc(ctx - ctx.mean(-1, keepdim=True), REFINE_AR_ORDER)
    frames = (1.0 - fmask[:, 0]).contiguous()
    calls = {
        "consistent_reconstruct": lambda m, o, v, x, c, f: consistent_reconstruct(
            m, o, v, x, n_iter=REFINE_ITERS, mag_frames=f, momentum=0.5, **kw),
        "magnitude_descent": lambda m, o, v, x, c, f: magnitude_descent(
            m, o, v, x, ar_coef=c, n_steps=REFINE_STEPS, ar_weight=REFINE_AR_WEIGHT,
            mag_frames=f, **kw),
    }
    stats = {}
    gap = valid == 0
    for name, call in calls.items():
        args = (mag, observed, valid, init, coef, frames)
        st, out = _timed_requests(lambda: call(*args), f"ops/refine {name}", b * n / SAMPLE_RATE,
                                  phase="refiner", warm=2)
        _check_outside(f"ops/refine {name}", out, audio, valid)
        card64 = call(*(a[:1].double() for a in args)).cpu()
        t0 = time.perf_counter()
        cpu64 = call(*(a[:1].double().cpu() for a in args))
        st["cpu_f64_clip_s"] = time.perf_counter() - t0
        st["f64_card_vs_cpu"] = _gap_rel_err(card64, cpu64, gap[:1])
        sdr = metrics.gap_sdr(audio.double(), out.double(), gap.double()).cpu().numpy()
        st["gap_sdr_db_mean"] = float(np.nanmean(sdr))
        stats[name] = st
        log("refiner", f"ops/refine {name}: f64 card vs CPU (clip 0) {st['f64_card_vs_cpu']:.2e} "
                       f"of the gap's peak (bound {REFINE_F64_RTOL}); mean gap SDR "
                       f"{st['gap_sdr_db_mean']:.3f} dB ({card})")
        if not st["f64_card_vs_cpu"] <= REFINE_F64_RTOL:
            raise AssertionError(f"ops/refine {name}: f64 card and CPU disagree: "
                                 f"{st['f64_card_vs_cpu']} > {REFINE_F64_RTOL}")
    return stats


def phase_refiner(card: str) -> dict:
    """The gap refiner served, trained and adapted on the card, the
    ops/refine solvers; returns the launch counts of the hand-written
    kernels (all 0: the path has none)."""
    _reset_counts()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_refiner_"))
    cache = os.environ.get("MAI_FORMANT_CACHE")
    os.environ["MAI_FORMANT_CACHE"] = str(work / "formant_cache")
    summary = {"card": card, "batch": B}
    try:
        summary["serving"] = _refiner_serving(card, work)
        summary["training"] = _refiner_training(card, work)
        summary["adaptation"] = _refiner_adaptation(card, work)
        summary["refine_ops"] = _refine_ops(card)
    finally:
        if cache is None:
            os.environ.pop("MAI_FORMANT_CACHE", None)
        else:
            os.environ["MAI_FORMANT_CACHE"] = cache
        shutil.rmtree(work, ignore_errors=True)
    launches = _counts()
    if any(launches.values()):
        raise AssertionError(f"refiner launched a hand-written kernel: {launches}")
    summary["launches"] = launches
    log("refiner", f"summary ({card}): {json.dumps(summary, default=str)}")
    return launches


# ------------------------------------------------------------ corpus_tools

# corpus_tools: the corpus and tuning CLIs in-process on the card, each
# against the same CLI on the CPU.  preprocess and build_gaps_table draw
# their gaps on the host from a generator seeded --seed, so the card's files
# and tables are the CPU's: preprocess's bit for bit (a product by 0 or 1),
# build_gaps_table's fades within one 16-bit LSB (cos on the card and on the
# CPU round apart by an ulp).  ar_tune: each grid row's probe mean gap SDR
# within evaluate's classical bounds (CLASSICAL_EVAL_ATOL: 2e-3 dB arinpaint,
# 0.3 dB janssen).  evaluate --golden: the reference outputs and the anchor
# check equal (host numpy on the same files), each model's gap SDR and delta
# within the evaluation phase's oracle bound (EVAL_SDR_DB), and its spectral
# L2 within 1e-3 (ten steps of its 4-decimal rounding).
CORPUS_FILES = 64
CORPUS_GAP_S = 0.1  # preprocess's default
CORPUS_TABLE_GAPS = 10  # build_gaps_table's defaults: 10 gaps of 10-80 ms, 4096 samples apart
CORPUS_TABLE_MS = (10.0, 80.0)
CORPUS_TABLE_MIN_DIST = 4096
# ar_tune over the formant FLACs: order 128 (at 512, f32 arinpaint blows up on
# formant_2.flac, Queue C 6), two probe positions a clip.
TUNE_GAP_S, TUNE_POSITIONS = 0.08, (1.0, 2.5)
TUNE_COMMON = ["--gap-len", str(TUNE_GAP_S), "--probe-dir", str(FORMANT_DIR), "--probe-positions",
               *map(str, TUNE_POSITIONS), "--orders", "128"]
TUNE_RUNS = (
    ("arinpaint", ["--contexts", "4096", "8192", "--blends", "cos2", "sigmoid:2"]),
    ("janssen", ["--contexts", "4096", "--maxits", "2", "5"]),
)
GOLDEN_SPEC_L2 = 1e-3


def _one_zero_run(out, inp, gap_len):
    """A start ``s`` such that ``out`` is ``inp`` with ``[s, s + gap_len)``
    zeroed (inside one run of zeros of ``out``), or None."""
    changed = np.flatnonzero(out != inp)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], out == 0, [0]]).astype(np.int8)))
    for a, b in zip(edges[::2], edges[1::2]):  # the runs of zeros, [a, b)
        lo, hi = a, b - gap_len
        if len(changed):
            lo, hi = max(lo, changed[-1] - gap_len + 1), min(hi, changed[0])
        if lo <= hi:
            return int(lo)
    return None


def _card_and_cpu(fn) -> tuple:
    """``fn(where, device)`` on the card (``where`` "card") and on the CPU
    ("cpu"): ``({where: result}, {where: wall s})``."""
    out, walls = {}, {}
    for where, device in (("card", DEVICE), ("cpu", "cpu")):
        t0 = time.perf_counter()
        out[where] = fn(where, device)
        if where == "card":
            torch.cuda.synchronize()
        walls[where] = time.perf_counter() - t0
    return out, walls


def _corpus_preprocess(tree: Path, work: Path) -> dict:
    gap_len = int(CORPUS_GAP_S * SAMPLE_RATE)
    written, walls = _card_and_cpu(lambda where, device: preprocess.main(
        ["--input", str(tree), "--output", str(work / f"pre_{where}"), "--gap-len",
         str(CORPUS_GAP_S), "--seed", "0", "--device", device]))
    starts = []
    for src, card_file, cpu_file in zip(sorted(tree.rglob("*.flac")), written["card"],
                                        written["cpu"], strict=True):
        got, want = read_audio(card_file)[0][:, 0], read_audio(cpu_file)[0][:, 0]
        if not np.array_equal(got, want):
            raise AssertionError(f"preprocess: {card_file.name} card and CPU differ in "
                                 f"{int((got != want).sum())} samples")
        s = _one_zero_run(got, read_audio(src)[0][:, 0], gap_len)
        if s is None:
            raise AssertionError(f"preprocess: {card_file} is not its input with one run of "
                                 f"{gap_len} zeros")
        starts.append(s)
    rate = len(starts) / walls["card"]
    log("corpus_tools", f"preprocess: {len(starts)} files of 5 s, one {gap_len}-sample gap each "
                        f"(starts {min(starts)}..{max(starts)}); card {walls['card']:.2f} s "
                        f"({rate:.1f} files/s), CPU {walls['cpu']:.2f} s; card = CPU bit for bit")
    return {"files": len(starts), "wall_s": walls, "files_per_s": rate,
            "distinct_starts": len(set(starts))}


def _corpus_gaps_table(tree: Path, work: Path) -> dict:
    tables, walls = _card_and_cpu(lambda where, device: build_gaps_table.main(
        ["--input", str(tree), "--output", str(work / f"table_{where}.json"), "--mode", "multi",
         "--write-audio", str(work / f"gapped_{where}"), "--seed", "0", "--device", device]))
    if tables["card"] != tables["cpu"]:
        raise AssertionError("build_gaps_table: the card's table differs from the CPU's")
    lo, hi = (int(ms * SAMPLE_RATE / 1000) for ms in CORPUS_TABLE_MS)
    worst_lsb = 0.0
    for entry in tables["card"]["entries"]:
        gaps = entry["gaps"]
        edges = [0] + [e for s, l in gaps for e in (s, s + l)] + [tables["card"]["n_samples"]]
        if not (len(gaps) == CORPUS_TABLE_GAPS and all(lo <= l <= hi for _, l in gaps)
                and all(b - a >= CORPUS_TABLE_MIN_DIST for a, b in zip(edges[::2], edges[1::2]))):
            raise AssertionError(f"build_gaps_table: {entry['file']} breaks the layout: {gaps}")
        name = f"{Path(entry['file']).stem}_gapped.flac"
        got = read_audio(work / "gapped_card" / name)[0][:, 0]
        want = read_audio(work / "gapped_cpu" / name)[0][:, 0]
        lsb = float(np.abs(got - want).max() * 32768)
        worst_lsb = max(worst_lsb, lsb)
        if lsb > 1.0001 or any(np.any(got[s:s + l] != 0) for s, l in gaps):
            raise AssertionError(f"build_gaps_table: {name} card vs CPU {lsb} LSB, or a gap not "
                                 f"zero")
    n = len(tables["card"]["entries"])
    log("corpus_tools", f"build_gaps_table --mode multi --write-audio: {n} files x "
                        f"{CORPUS_TABLE_GAPS} gaps; card {walls['card']:.2f} s, CPU "
                        f"{walls['cpu']:.2f} s; tables equal, audio card vs CPU {worst_lsb:.0f} "
                        f"LSB at most")
    return {"files": n, "wall_s": walls, "lsb": worst_lsb}


def _corpus_ar_tune(card: str, work: Path) -> dict:
    out = {}
    for model, flags in TUNE_RUNS:
        runs, walls = _card_and_cpu(lambda where, device: ar_tune.main(
            ["--model", model, *TUNE_COMMON, *flags, "--output-json",
             str(work / f"tune_{model}_{where}.json"), "--device", device]))
        got, want = runs["card"], runs["cpu"]
        bound = CLASSICAL_EVAL_ATOL[model]
        rows = []
        for g, w in zip(got["grid"], want["grid"], strict=True):
            setting = {k: v for k, v in g.items() if k not in ("probe_mean_db", "elapsed_s")}
            if setting != {k: v for k, v in w.items() if k not in ("probe_mean_db", "elapsed_s")}:
                raise AssertionError(f"ar_tune {model}: grid rows differ: {g} vs {w}")
            d = abs(g["probe_mean_db"] - w["probe_mean_db"])
            if not (np.isfinite(g["probe_mean_db"]) and d <= bound + 1e-9):
                raise AssertionError(f"ar_tune {model}: {setting} card {g['probe_mean_db']} vs "
                                     f"CPU {w['probe_mean_db']} dB (bound {bound})")
            rows.append({**setting, "card_db": g["probe_mean_db"], "cpu_db": w["probe_mean_db"],
                         "card_s": g["elapsed_s"], "cpu_s": w["elapsed_s"]})
            log("corpus_tools", f"ar_tune {model} {json.dumps(setting)}: probe {g['probe_mean_db']}"
                                f" dB (CPU {w['probe_mean_db']}), card {g['elapsed_s']} s, CPU "
                                f"{w['elapsed_s']} s")
        best = got["probe_best"]
        cpu_of_best = next(w["probe_mean_db"] for g, w in zip(got["grid"], want["grid"])
                           if all(g[k] == best[k] for k in best if k != "probe_mean_db"))
        if not cpu_of_best >= want["probe_best"]["probe_mean_db"] - bound - 1e-9:
            raise AssertionError(f"ar_tune {model}: the card's winner {best} scores "
                                 f"{cpu_of_best} dB on the CPU, the CPU's winner "
                                 f"{want['probe_best']}")
        # Each grid point's probe request on the card, warm (the rows keep 0.1 s), and the
        # winner's traced: device operations and wall time an operation.
        args = ar_tune.build_argparser().parse_args(
            ["--model", model, *TUNE_COMMON, *flags, "--device", DEVICE])
        clips, starts, _ = load_real_probe_set(FORMANT_DIR, TUNE_POSITIONS, SAMPLE_RATE, 5.0,
                                               TUNE_GAP_S)
        audio = torch.tensor(clips, device=DEVICE)
        gs = torch.tensor(starts, dtype=torch.int64, device=DEVICE)
        gl = torch.full_like(gs, int(TUNE_GAP_S * SAMPLE_RATE))
        for row, conf in zip(rows, ar_tune.grid(args), strict=True):
            runner = ar_tune.solver(args, conf, Config())
            runner(audio, gs, gl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner(audio, gs, gl)
            torch.cuda.synchronize()
            row["card_warm_ms"] = 1e3 * (time.perf_counter() - t0)
            log("corpus_tools", f"ar_tune {model} {json.dumps(conf)}: a warm probe request of "
                                f"{len(clips)} clips {row['card_warm_ms']:.1f} ms ({card})")
        runner = ar_tune.solver(args, {k: v for k, v in best.items() if k != "probe_mean_db"},
                                Config())
        ops, busy, wall_ms = _trace_request(lambda: runner(audio, gs, gl))
        us_per_op = 1e3 * wall_ms / ops
        log("corpus_tools", f"ar_tune {model} winner {json.dumps(best)}: a traced probe request "
                            f"{wall_ms:.1f} ms, {ops} device operations, {us_per_op:.2f} us of "
                            f"wall time an operation, idle {100 * (1 - busy):.1f} % ({card}); "
                            f"whole grid through the CLI: card {walls['card']:.2f} s, CPU "
                            f"{walls['cpu']:.2f} s")
        out[model] = {"rows": rows, "best": best, "wall_s": walls, "traced_ms": wall_ms,
                      "device_ops": ops, "us_per_op": us_per_op, "idle_share": 1.0 - busy}
    return out


def _corpus_golden(work: Path) -> dict:
    """evaluate --golden over the formant FLACs (formant_1 as the anchor
    clip) and a golden directory of the port's tuned arinpaint output."""
    clips = work / "golden_clips"
    clips.mkdir()
    for f in sorted(FORMANT_DIR.glob("*.flac")):
        name = "81-121543-0008.flac" if f.name == "formant_1.flac" else f.name
        shutil.copy(f, clips / name)
    inpaint.main(["--model", "arinpaint", "--ar-preset", "tuned", "--input", str(clips),
                  "--output", str(work / "arinpaint"), "--device", DEVICE])
    golden = work / "golden"
    golden.mkdir()
    for f in sorted((work / "arinpaint").glob("*_arinpaint_inpainted.flac")):
        stem = f.name[: -len("_arinpaint_inpainted.flac")]
        for tag in ("gan", "cnnlstm"):
            shutil.copy(f, golden / f"{stem}_{tag}_inpainted.flac")
    out = {}
    for model in ("gan", "cnn_blstm"):
        def golden_json(where: str, device: str) -> dict:
            path = work / f"golden_{model}_{where}.json"
            evaluate.main(["--models", model, "--checkpoint", str(EVAL_CHECKPOINTS[model]),
                           "--input", str(clips), "--golden", str(golden), "--output-json",
                           str(path), "--device", device])
            return json.loads(path.read_text())

        runs, walls = _card_and_cpu(golden_json)
        got, want = runs["card"], runs["cpu"]
        for key in ("condition", "recorded_model_comparison", "reference_outputs", "anchor_check"):
            if got[key] != want[key]:
                raise AssertionError(f"evaluate --golden {model}: {key} differs, card vs CPU")
        if set(got["anchor_check"]) != {"gan", "cnnlstm"}:
            raise AssertionError(f"evaluate --golden: no anchor check: {got['anchor_check']}")
        worst = {}
        for key, value in want["ours"][model].items():
            bound = GOLDEN_SPEC_L2 if key.startswith("spec_l2") else EVAL_SDR_DB["oracle"]
            mine = got["ours"][model][key]
            pairs = ([(mine[k], v) for k, v in value.items()] if isinstance(value, dict)
                     else [(mine, value)])
            d = max(abs(a - b) for a, b in pairs)
            worst[key] = d
            if not (all(np.isfinite(a) for a, _ in pairs) and d <= bound + 1e-9):
                raise AssertionError(f"evaluate --golden {model}: {key} card vs CPU {d} > {bound}")
        entry = got["ours"][model]
        log("corpus_tools", f"evaluate --golden --models {model}: mean gap SDR "
                            f"{entry['mean_gap_sdr_db']} dB, vs the golden files "
                            f"{entry['mean_delta_vs_gan_db']:+} dB; card {walls['card']:.2f} s, "
                            f"CPU {walls['cpu']:.2f} s; card vs CPU worst {json.dumps(worst)}")
        out[model] = {"wall_s": walls, "worst": worst, "ours": entry}
    out["anchor_check"] = got["anchor_check"]
    return out


def phase_corpus_tools(card: str) -> dict:
    """The corpus and tuning CLIs on the card against the CPU; returns the
    launch counts of the hand-written kernels (``lstm_fwd`` from
    ``evaluate --golden --models cnn_blstm``)."""
    _reset_counts()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_corpus_"))
    summary = {"card": card}
    try:
        tree = work / "corpus"
        t0 = time.perf_counter()
        for i, clip in enumerate(speech_like_batch(np.random.default_rng(23), CORPUS_FILES)):
            save_audio(clip * 0.8, tree / f"spk{i % 4}" / f"ch{i % 3}" / f"utt{i:02d}.flac",
                       SAMPLE_RATE, normalize=False)
        log("corpus_tools", f"{CORPUS_FILES} synthetic 5 s clips written in a nested tree in "
                            f"{time.perf_counter() - t0:.2f} s ({card})")
        summary["preprocess"] = _corpus_preprocess(tree, work)
        summary["build_gaps_table"] = _corpus_gaps_table(tree, work)
        summary["ar_tune"] = _corpus_ar_tune(card, work)
        summary["golden"] = _corpus_golden(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("corpus_tools", "ar_plots and utils/tb_analysis.py are host tools (matplotlib, "
                        "tensorboard) and do not run on the card's machine, which has neither")
    launches = _counts()
    if not launches["lstm_fwd"] or any(v for k, v in launches.items() if k != "lstm_fwd"):
        raise AssertionError(f"corpus_tools: lstm_fwd alone must launch (evaluate --golden "
                             f"--models cnn_blstm): {launches}")
    summary["launches"] = launches
    log("corpus_tools", f"summary ({card}): {json.dumps(summary, default=str)}")
    return launches


# ----------------------------------------------------------- multi_device

MD_LOSS_RTOL = {"f32": 1e-5, "bf16": 5e-3}  # tests/test_parallel.py: loss
MD_ADAM_STEP_LR = 2.1  # parameters within one Adam step, 2.1 lr (2.1e-4 CNN, 4.1e-4 GAN there)
MD_BN_TOL = {"f32": (1e-4, 1e-5), "bf16": (2e-2, 1e-3)}  # tests/test_parallel.py: (rtol, atol)
MD_SN_ATOL = 2e-2  # D's u and sigma in bf16 (tests/test_torch_gan_train.py's bf16 bound)
MD_SERVE_ATOL = 2e-6  # tests/test_parallel.py: sharded serving
MD_CLI_STEPS = 2
MD_SCALING_STEPS = 5
MD_GAN_CLIPS = 32
MD_CASE_STEPS = 2  # a 2-rank training case: the checked step, then one timed warm
MD_SIX_FORMS = {**{k: 3 * MD_CASE_STEPS for k in KERNELS},
                **{f"{k}_bf16": 3 * MD_CASE_STEPS for k in KERNELS}}
MD_RECIPES = {"b128_recipe_config": b128_recipe_config, "recipe_config": recipe_config}


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic convolution algorithms inside, the flags restored after."""
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = flags


def _md_cnn(device, mesh, recipe: str, flat: dict, batch: tuple, dtype: str) -> dict:
    """One CNN+BiLSTM train step over ``mesh``: the loss and the gathered
    model state, on the CPU; then a second step on the same rows, timed
    warm."""
    cfg = MD_RECIPES[recipe]()
    state = create_cnn_state(cfg, device=device, params=flat)
    step = make_sharded_step(make_cnn_train_step(
        cfg, compute_dtype=torch.bfloat16 if dtype == "bf16" else None), state, mesh)
    place_state(state, mesh)
    batch = shard_batch(batch, mesh)
    state, m = step(state, *batch)
    out = {"loss": m["loss"].item(), "model": gather_state(state, mesh)["model"],
           "sharded": sorted(state.shardings)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, *batch)[1]["loss"].item()
    return {**out, "step_s": time.perf_counter() - t0}


def _md_gan(device, mesh, batch: tuple) -> dict:
    """One step of the GAN recipe (bf16, VGG19, EMA) over ``mesh``; then a
    second on the same rows, timed warm."""
    cfg = gan_recipe_config()
    g, d = _gan_states(cfg, device, g_ema=GAN_EMA)
    step = make_sharded_step(make_gan_train_step(cfg, vgg=vgg19_params(device=device),
                                                 compute_dtype=torch.bfloat16, g_ema=GAN_EMA),
                             (g, d), mesh)
    batch = shard_batch(batch, mesh)
    g, d, m = step(g, d, *batch)
    out = {"metrics": {k: v.item() for k, v in m.items()},
           "g": {k: v.cpu() for k, v in g.model.state_dict().items()},
           "d": {k: v.cpu() for k, v in d.model.state_dict().items()}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(g, d, *batch)[2]["g_total"].item()
    return {**out, "step_s": time.perf_counter() - t0}


def _md_serve(device, mesh, batch: tuple) -> dict:
    """The GAN main path (``enhanced``, ``oracle``, f32) served over ``mesh``."""
    runner = make_gan_runner(gan_config(), GAN_CHECKPOINT, device=device, mode="enhanced",
                             phase="oracle")
    with full_f32_convolutions():
        restored, _ = make_sharded_serving_fn(runner.inpaint_fn, mesh)(
            *(torch.as_tensor(x) for x in batch))
    return {"restored": restored.cpu()}


def _md_cli_run(argv: list) -> dict:
    """``cli/train.py`` on this rank: the step, the losses, the run
    directory, and the tree of the state it ends with, gathered."""
    res = train_cli.main(argv)
    return {"step": res.step, "losses": res.losses, "mesh": dict(res.mesh.shape),
            "run_dir": str(res.checkpoint_dir), "tree": gather_state(res.state, res.mesh),
            "sharded": sorted(res.state.shardings)}


def md_rank(device, cases: list, cli: dict) -> dict:
    """One rank of the two that share the card: each case (``(label, mesh
    shape, kind, kwargs)``) with its seconds, peak memory, backend and
    kernel launches; then the training CLI with ``--model-parallel 2``,
    the save restored into a fresh state placed on a ``1 x 2`` mesh, and
    ``--resume-from`` it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes, out = {}, {}
    for label, shape, kind, kwargs in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=device)
        before = _counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out[label] = globals()[f"_md_{kind}"](device, meshes[shape], **kwargs)
        torch.cuda.synchronize()
        out[label].update(seconds=time.perf_counter() - t0, backend=dist.get_backend(),
                          peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                          launched={k: v - before[k] for k, v in _counts().items()})
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    first = _md_cli_run(cli["first"])
    saved_dir = Path(cli["first"][cli["first"].index("--base-dir") + 1]) / "checkpoints"
    (run_dir,) = saved_dir.iterdir()
    saved = CheckpointManager(run_dir).load_tree()
    n_saved = _tree_equal("multi_device save vs the gathered state", first.pop("tree"), saved)
    mesh = make_mesh(1, 2, device=device)
    state = create_cnn_state(load_config(cli["config"]), device=device, ema=GAN_EMA)
    CheckpointManager(run_dir).restore(state)
    place_state(state, mesh)
    n_restored = _tree_equal("multi_device restore on 1 x 2", gather_state(state, mesh), saved)
    del state, saved
    resumed = _md_cli_run([*cli["resume"], "--resume-from", str(run_dir)])
    resumed.pop("tree")
    out["cli"] = {"first": first, "resumed": resumed, "tensors_saved": n_saved,
                  "tensors_restored": n_restored, "seconds": time.perf_counter() - t0,
                  "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    return out


def md_nccl_pair(device) -> None:
    """An NCCL collective between two ranks on one card (NCCL refuses it)."""
    t = torch.ones(1, device=device)
    dist.all_reduce(t)
    torch.cuda.synchronize()


def _md_compare(label: str, got: dict, want: dict, dtype: str, lr: float) -> dict:
    """Parameters within one Adam step, running statistics within the BN
    bounds, D's spectral-norm state within ``MD_SN_ATOL``: the largest
    error of each kind."""
    rtol, atol = MD_BN_TOL[dtype]
    worst = {"param": 0.0, "bn": 0.0, "sn": 0.0}
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        err = (got[k].double() - w.double()).abs()
        if k.endswith(("running_mean", "running_var")):
            bound = atol + rtol * w.double().abs()
            kind = "bn"
        elif k.endswith((".u", ".sigma")):
            bound, kind = torch.full_like(err, MD_SN_ATOL), "sn"
        else:
            bound, kind = torch.full_like(err, MD_ADAM_STEP_LR * lr), "param"
        if not bool((err <= bound).all()):
            raise AssertionError(f"multi_device {label} {k}: max error {err.max().item():.3e} "
                                 f"out of bounds ({kind})")
        worst[kind] = max(worst[kind], err.max().item())
    return worst


def phase_multi_device(card: str) -> dict:
    """Multi-device training and serving on ``torch.distributed``: one
    NCCL rank in this process, two ranks sharing the card (gloo), the
    training CLI over a ``1 x 2`` mesh and ``scaling_bench`` on 1 and 2
    ranks.  Returns the launches of the parent and of every rank."""
    _reset_counts()
    b128 = b128_recipe_config()
    live128 = live_bilstm(load_params_npz(B128_CHECKPOINT), seed=6)
    clips = b128.training.batch_size
    b128_batch = (speech_like_batch(np.random.default_rng(500), clips),
                  *(t.numpy() for t in multi_gap_layouts(torch.Generator().manual_seed(501), b128,
                                                        clips, b128.data.gaps_per_audio)))
    yaml_cfg = recipe_config()
    live_yaml = live_bilstm(load_params_npz(CHECKPOINT), seed=6)
    yaml_batch = (speech_like_batch(np.random.default_rng(502), 1),
                  gap_starts(torch.Generator().manual_seed(503), yaml_cfg, 1,
                             yaml_cfg.data.gaps_per_audio).numpy())
    gcfg = gan_recipe_config()
    gan_batch = (speech_like_batch(np.random.default_rng(504), MD_GAN_CLIPS),
                 *(t.numpy() for t in gan_gap_layouts(torch.Generator().manual_seed(505), gcfg,
                                                      MD_GAN_CLIPS)))
    serve_batch = (synthetic_dataset_batch(BATCH, gan_config().data.max_len_s),
                   np.full(BATCH, GAP_START), np.full(BATCH, GAP_LEN))
    log("multi_device", f"the card's machine has one card ({card}): two ranks share it and measure "
                        "the collectives' and the host's overhead, not scaling")

    # 1. One rank, NCCL, in this process: the sharded forms equal the bare ones bit for bit.
    work = Path(tempfile.mkdtemp(prefix="multi_device_"))
    t0 = time.perf_counter()
    device = initialize_distributed("cuda", store=dist.FileStore(str(work / "store"), 1),
                                    rank=0, world_size=1)
    backend = dist.get_backend()
    one = torch.ones(4, device=device)
    dist.all_reduce(one)
    if backend != "nccl" or not bool((one == 1).all()):
        raise AssertionError(f"multi_device: one rank's backend {backend}, all_reduce {one}")
    mesh = make_mesh(device=device)
    torch.cuda.reset_peak_memory_stats()
    runner = make_gan_runner(gan_config(), GAN_CHECKPOINT, device=device, mode="enhanced",
                             phase="oracle")
    audio_d, gs_d, gl_d = (torch.as_tensor(x, device=device) for x in serve_batch)
    with _deterministic_cudnn(), full_f32_convolutions():
        plain, _ = runner.inpaint_fn(audio_d, gs_d, gl_d)
        sharded, _ = make_sharded_serving_fn(runner.inpaint_fn, mesh)(audio_d, gs_d, gl_d)
    if not torch.equal(plain, sharded):
        raise AssertionError("multi_device: 1-rank sharded serving differs from the runner")
    serve_ref = plain.cpu()
    del runner, plain, sharded, audio_d
    refs, batch_d = {}, tuple(torch.as_tensor(x, device=device) for x in b128_batch)
    with _deterministic_cudnn():
        for how in ("bare", "sharded"):
            state = create_cnn_state(b128, device=device, params=live128)
            step = make_cnn_train_step(b128, compute_dtype=torch.bfloat16)
            if how == "sharded":
                step = make_sharded_step(step, state, mesh)
                place_state(state, mesh)
            state, m = step(state, *batch_d)
            refs[how] = (m["loss"].item(), {k: v.cpu() for k, v in state.model.state_dict().items()})
            del state
    _tree_equal("multi_device 1-rank CNN step vs the bare step", refs["sharded"][1],
                refs["bare"][1])
    if refs["sharded"][0] != refs["bare"][0]:
        raise AssertionError(f"multi_device 1-rank loss {refs['sharded'][0]} != {refs['bare'][0]}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    dist.destroy_process_group()
    log("multi_device", f"1 rank, {backend}: sharded serving of B={BATCH} x 5 s and the b128 bf16 "
                        f"step through make_sharded_step equal the bare forms bit for bit "
                        f"({len(refs['bare'][1])} tensors); {time.perf_counter() - t0:.1f} s, "
                        f"peak {peak:.0f} MiB ({card})")

    # The one-rank references of the two-rank runs, here on the card.
    t0 = time.perf_counter()
    with full_f32_convolutions():
        state = create_cnn_state(yaml_cfg, device=device, params=live_yaml)
        state, m = make_cnn_train_step(yaml_cfg)(
            state, *(torch.as_tensor(x, device=device) for x in yaml_batch))
    yaml_ref = (m["loss"].item(), {k: v.cpu() for k, v in state.model.state_dict().items()})
    g, d = _gan_states(gcfg, device, g_ema=GAN_EMA)
    g, d, gm = make_gan_train_step(gcfg, vgg=vgg19_params(device=device),
                                   compute_dtype=torch.bfloat16, g_ema=GAN_EMA)(
        g, d, *(torch.as_tensor(x, device=device) for x in gan_batch))
    gan_ref = ({k: v.item() for k, v in gm.items()},
               {k: v.cpu() for k, v in g.model.state_dict().items()},
               {k: v.cpu() for k, v in d.model.state_dict().items()})
    del state, g, d, batch_d
    torch.cuda.empty_cache()
    log("multi_device", f"one-rank references (f32 cnn_blstm.yaml step, bf16 GAN step): "
                        f"{time.perf_counter() - t0:.1f} s")

    # 2. Two ranks on the one card: NCCL's refusal, then gloo.
    try:
        spawn(md_nccl_pair, 2, "cuda", backend="nccl", timeout_s=120)
        raise AssertionError("two NCCL ranks on one card ran an all_reduce")
    except RuntimeError as e:
        refusal = next((line.strip() for line in str(e).splitlines() if "Duplicate GPU" in line),
                       None)
        if refusal is None:
            raise
        log("multi_device", f"NCCL refuses two ranks on one card: {refusal[:300]}")
    cli_cfg = _cli_config(work, "b128", b128, {"metric_interval": 1, "checkpoint_interval": 100})
    cli_common = ["--model", "cnn_blstm", "--config", cli_cfg, "--train-dtype", "bf16", "--ema",
                  str(GAN_EMA), "--feed", "device", "--synthetic", str(clips), "--corpus",
                  "harmonic", "--model-parallel", "2", "--workers", "4"]
    # The CLI starts from the redrawn BiLSTM too: a step-0 checkpoint of it to resume from.
    init = create_cnn_state(b128, device=device, params=live128, ema=GAN_EMA)
    CheckpointManager(work / "init").save(0, init)
    del init
    cli = {"config": cli_cfg,
           "first": [*cli_common, "--steps", str(MD_CLI_STEPS), "--base-dir", str(work / "a"),
                     "--resume-from", str(work / "init")],
           "resume": [*cli_common, "--steps", str(MD_CLI_STEPS + 1), "--base-dir",
                      str(work / "b")]}
    cases = [
        ("cnn b128 bf16 1x2", (1, 2), "cnn", {"recipe": "b128_recipe_config", "flat": live128,
                                              "batch": b128_batch, "dtype": "bf16"}),
        ("cnn yaml f32 1x2", (1, 2), "cnn", {"recipe": "recipe_config", "flat": live_yaml,
                                             "batch": yaml_batch, "dtype": "f32"}),
        ("gan bf16 2x1", (2, 1), "gan", {"batch": gan_batch}),
        ("serve 2x1", (2, 1), "serve", {"batch": serve_batch}),
    ]
    t0 = time.perf_counter()
    ranks = spawn(md_rank, 2, "cuda", cases, cli, timeout_s=900)
    log("multi_device", f"2 ranks: {time.perf_counter() - t0:.1f} s with their start")
    launches = [r.kernel_launches for r in ranks]
    wants = {"cnn b128 bf16 1x2": (refs["bare"], "bf16", b128.training.starter_learning_rate),
             "cnn yaml f32 1x2": (yaml_ref, "f32", yaml_cfg.training.starter_learning_rate)}
    summary = {}
    for label, (want, dtype, lr) in wants.items():
        got = [r.value[label] for r in ranks]
        if got[0]["sharded"] != ["lstm.l0_bwd_w_ih", "lstm.l0_fwd_w_ih", "projection.weight"]:
            raise AssertionError(f"multi_device {label}: split {got[0]['sharded']}")
        if got[0]["loss"] != got[1]["loss"]:
            raise AssertionError(f"multi_device {label}: the ranks' losses differ")
        rel = abs(got[0]["loss"] - want[0]) / abs(want[0])
        if not rel <= MD_LOSS_RTOL[dtype]:
            raise AssertionError(f"multi_device {label}: loss {got[0]['loss']} vs one rank "
                                 f"{want[0]}")
        worst = _md_compare(label, got[0]["model"], want[1], dtype, lr)
        _tree_equal(f"multi_device {label} rank 1 vs rank 0", got[1]["model"], got[0]["model"])
        summary[label] = {"loss_rel_err": rel, **worst}
    forms = [{k: v for k, v in r.value["cnn b128 bf16 1x2"]["launched"].items() if v}
             | {k: v for k, v in r.value["cnn yaml f32 1x2"]["launched"].items() if v}
             for r in ranks]
    if any(f != MD_SIX_FORMS for f in forms):
        raise AssertionError(f"multi_device: launches on each rank of the 1 x 2 steps {forms}, "
                             f"expected {MD_SIX_FORMS}")
    gan = [r.value["gan bf16 2x1"] for r in ranks]
    for k in ("g_total", "d_total"):
        rel = abs(gan[0]["metrics"][k] - gan_ref[0][k]) / abs(gan_ref[0][k])
        if gan[0]["metrics"][k] != gan[1]["metrics"][k] or not rel <= MD_LOSS_RTOL["bf16"]:
            raise AssertionError(f"multi_device gan {k}: {[r['metrics'][k] for r in gan]} vs "
                                 f"one rank {gan_ref[0][k]}")
        summary.setdefault("gan bf16 2x1", {})[f"{k}_rel_err"] = rel
    for net, want in (("g", gan_ref[1]), ("d", gan_ref[2])):
        summary["gan bf16 2x1"][net] = _md_compare(f"gan {net}", gan[0][net], want, "bf16",
                                                   gcfg.training.g_lr)
    serve_err = max((r.value["serve 2x1"]["restored"] - serve_ref).abs().max().item()
                    for r in ranks)
    if not serve_err <= MD_SERVE_ATOL:
        raise AssertionError(f"multi_device: 2-rank serving off one rank by {serve_err}")
    summary["serve 2x1"] = {"max_abs_err": serve_err}
    for label in ("cnn b128 bf16 1x2", "cnn yaml f32 1x2", "gan bf16 2x1", "serve 2x1"):
        runs = [r.value[label] for r in ranks]
        step_s = [round(r["step_s"], 3) for r in runs] if "step_s" in runs[0] else "-"
        log("multi_device", f"{label}: warm step {step_s} s; the case "
                            f"{[round(r['seconds'], 2) for r in runs]} s, peak "
                            f"{[round(r['peak_mib']) for r in runs]} MiB a rank, backend "
                            f"{runs[0]['backend']}; {json.dumps(summary[label])} ({card})")
    cli_out = [r.value["cli"] for r in ranks]
    first, resumed = cli_out[0]["first"], cli_out[0]["resumed"]
    if (first["mesh"] != {"data": 1, "model": 2} or first["step"] != MD_CLI_STEPS
            or resumed["step"] != MD_CLI_STEPS + 1):
        raise AssertionError(f"multi_device cli: {first['mesh']}, steps {first['step']}, "
                             f"{resumed['step']}")
    one = create_cnn_state(b128, device=device, ema=GAN_EMA)
    saved = CheckpointManager(first["run_dir"]).load_tree()
    load_state_tree(one, saved)
    n_one = _tree_equal("multi_device cli save restored into one rank", state_tree(one), saved)
    del one, saved
    log("multi_device", f"cli/train.py --model-parallel 2, b128 bf16: {MD_CLI_STEPS} steps, "
                        f"losses {[x['loss'] for _, x in first['losses']]}; the save is the "
                        f"gathered state ({cli_out[0]['tensors_saved']} tensors) and restores on "
                        f"1 x 2 bit for bit ({cli_out[0]['tensors_restored']}) and into one rank "
                        f"({n_one}); --resume-from to step {resumed['step']}, loss "
                        f"{resumed['losses'][-1][1]['loss']:.4f}; {cli_out[0]['seconds']:.1f} s, "
                        f"peak {[round(c['peak_mib']) for c in cli_out]} MiB a rank ({card})")

    # 4. scaling_bench on 1 and 2 ranks.
    t0 = time.perf_counter()
    payload = scaling_bench.main(["--devices", "1", "2", "--steps", str(MD_SCALING_STEPS),
                                  "--device", "cuda", "--output-json",
                                  str(work / "scaling.json")])
    for n, per_rank in payload["kernel_launches"].items():
        launches += per_rank
    for model, rows in payload["models"].items():
        log("multi_device", f"scaling_bench {model}: steps/s "
                            f"{ {n: round(r['steps_per_sec'], 3) for n, r in rows.items()} }, "
                            f"relative loss drift 2 vs 1 rank "
                            f"{rows['2']['max_rel_loss_drift_vs_1dev']:.3e}, peak "
                            f"{ {n: r['peak_memory_bytes_per_rank'] for n, r in rows.items()} } "
                            f"bytes a rank, backend { {n: r['backend'] for n, r in rows.items()} }; "
                            f"two ranks on one card measure overhead, not scaling "
                            f"({card})")
    log("multi_device", f"scaling_bench: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    counts = _counts()
    return {k: counts[k] + sum(c[k] for c in launches) for k in counts}


def main() -> int:
    smi = phase_device()
    card = f"{torch.cuda.get_device_name(0)}, power limit {smi.split(',')[-1].strip()}"
    ptxas = phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = [phase_kernel(card, ptxas), *phase_kernel_bwd(card, ptxas),
               *phase_kernel_bf16(card, ptxas)]
    norms = phase_batchnorm(card, ptxas)
    paths = {"serving": phase_serving(card)}
    phase_gan_serving(card)
    paths["serving_deployable"] = phase_serving_deployable(card)
    paths["evaluation"] = phase_evaluation(card)
    paths["training"] = phase_training(card)
    paths["training_bf16"] = phase_training_bf16(card)
    paths["gan_training"] = phase_gan_training(card)
    paths["training_cli"] = phase_training_cli(card)
    paths["classical"] = phase_classical(card)
    paths["refiner"] = phase_refiner(card)
    paths["corpus_tools"] = phase_corpus_tools(card)
    paths["multi_device"] = phase_multi_device(card)
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items()
                                 if counts[k["name"]]}
        k["launches"] = sum(k["launches_by_path"].values())
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was never launched on the main paths")
    norm_launches = {path: {k: counts[k] for k in batchnorm.LAUNCH_COUNTERS if counts.get(k)}
                     for path, counts in paths.items()}
    norm_launches = {path: counts for path, counts in norm_launches.items() if counts}
    if norm_launches.get("training_bf16", {}).keys() != {"bn_fwd_bf16", "bn_bwd_bf16"}:
        raise AssertionError(f"BatchNorm launches by path {norm_launches}: training_bf16 "
                             f"launched other forms or none")
    for name in batchnorm.LAUNCH_COUNTERS:
        if not any(name in counts for counts in norm_launches.values()):
            raise AssertionError(f"{name} was never launched on the main paths")
    log("done", f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"batchnorm": norms, "launches_by_path": norm_launches}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
