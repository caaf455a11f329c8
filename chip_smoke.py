#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card: build, check, time,
serve, train, observe.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

1. environment: the card's name and power limit (nvidia-smi), torch's and
   CUDA's versions; no CUDA card is an error;
2. build: one nvcc per ``paddle_tpu_torch/csrc/*.cu``, all started
   together, into ``build/torch_kernels/`` (ptxas's register and
   shared-memory report is printed); the tensor-core kernels' (CE
   forward, dx and dW in bf16 and in fp32; flash forward, dq and dk/dv in
   bf16 and in fp32 at head_dim 64, 128 and 256) tensor-core
   instructions counted in the library's SASS (none fails; the fp32 dq
   and dk/dv at 64, 128 and 256 must hold all their sources issue,
   ``_SM90_HGMMA``, and no spill),
   with their registers and spills, and their grid geometry held against
   their wrappers';
3. every kernel against its plain PyTorch version on the card: the
   lm-head + CE forward in fp32 (split TF32 on the tensor cores) at the
   serving shapes, ragged with labels V and -1, at N = 1, D = 60 (padded)
   and D = 1000, and against float64 logits at the serving shapes within
   ``_TF32_MULTIPLE`` times the plain fp32 version's own error; in bf16
   (``_CE_FWD_CASES``) at both training shapes (N = 4096 and 16384),
   ragged with labels V and -1, at D = 60 (padded), D = 1000, N = 1 and
   N = 600; its dx and dW
   (``_CE_GRAD_CASES``, a non-uniform g): bf16 (tensor cores) at both
   training shapes, ragged with labels V and -1, at D = 1000, at D = 60
   (padded), at N = 1 and at N = 600 (fewer blocks than SMs), at one
   bf16 ulp plus 2^-6; fp32 (split TF32 on the tensor cores) at N =
   16384, ragged with labels V and -1, at D = 60 (padded), D = 1000 (two
   slabs), N = 1 and N = 511 (the column sweep in chunks), at 1e-4, and
   against float64 at N = 511 and 4096 within ``_BWD_TF32_MULTIPLE``
   times the plain fp32 version's own error; the CE kernels' peak added
   memory at the training shape, and fp32 dx and dW's at the static_amp
   step's N = 16384 (no [N, V] buffer); fused Adam(W) on bf16, fp32, 1-D
   and odd shapes, and on a bf16 p with the fp32 gradient a global-norm
   clip gives; the flash attention forward (out, lse), dq and dk/dv over
   ``_FLASH_CASES``: the seq-2048 training shape (bf16, causal, BTHD),
   fp32 and bf16 in both layouts causal and not, D = 128 and 256, Tq !=
   Tk (causal, bottom-right; rows that see no key give out 0 and lse
   -1e30 exactly) and sequence lengths that are not a multiple of the
   kernels' tiles; the fp32 forward (split TF32 on the tensor cores at D
   = 64, 128 and 256) against float64 within ``_F32_FLASH_MULTIPLE`` times
   the plain fp32 version's own error in out and in lse; the fp32 dq and
   dk/dv (split TF32 at D = 64, 128 and 256) against
   float64 within ``_F32_FLASH_BWD_MULTIPLE`` (D = 256) or
   ``_F32_DKV_MULTIPLE`` (64, 128) times the plain fp32 version's own
   error in dq, dk and dv, at small shapes and at the fp32 training
   shapes; the gradient chain
   (dq and dk/dv from the kernel
   forward's own out and lse) against the plain chain in fp32, within
   twice the plain bf16 chain's own error, at the seq-2048 shape, in
   BHTD at D = 128 and at train_d256's shape (D = 256), and in fp32 at
   train_d256's shape and at the fp32 training shapes at D = 64 and 128
   against the chain in float64; the flash
   kernels' peak added memory at the training
   shape (no [B, H, T, T] buffer);
4. timing with CUDA events (median of 30 after warm-up): each kernel, its
   plain version, one PyTorch library call computing the same function,
   and the card's bound for the same work, at the serving score shapes
   and at the training shapes (the CE forward, dx and dW at N = 4096 and
   16384, and the flash forward, dq and dk/dv, with TFLOP/s and their
   ratio to the library call); the fp32 CE kernels' and the fp32 flash
   kernels' bounds are their split-TF32 ones (three tf32 products a
   product), the FMA units' beside;
5. serving at full GPT width (12 x 768, vocab 32000, random weights from
   seed 0): 8 prompts covering every prefill bucket through
   ServingEngine.warm + submit + run_until_idle, first eagerly
   (PADDLE_TPU_EAGER=1), then on the card's default compiled route (the
   main path: decode, prefill and score replayed as CUDA graphs); the
   replayed greedy tokens must equal the eager ones and the replayed NLL
   the eager NLL within 1e-5; two prompts again, one after the other, on
   a threaded engine that captures on its scheduler thread (tokens must
   be bit-identical), greedy agreement of every request with the
   full-context reference, prompt scoring through the fused lm-head + CE
   kernel (its launch counter must rise), and a traced window of decode
   ticks, eager and replayed; tick wall, tokens/s and TTFT side by side;
   then the front tier (phase ``serve_tier``, ``_serve_tier``): two
   replica processes (``tools/torch_serve_replica.py``, the same seed-0
   params from one ``.npz``, each on a free loopback status port) behind
   a ``Router`` of ``HttpReplica``s; the 8 prompts at once (twice: cold,
   then warm) must give the replayed leg's tokens bit for bit, with no
   bit-match mismatch; again with replica 1 SIGKILLed while requests are
   out on it, stopped (SIGSTOP) before they are sent so they stay out
   (every request completes on replica 0 with the same tokens;
   re-dispatches and detection time printed); replica 1 respawned on its
   port and drained through ``Router.drain_replica`` while it holds
   admitted work (that work finishes there, new work goes to replica 0,
   its /healthz says drained); each replica's /status roofline: the
   analytic cost record, the legs on ``calibrate``'s numbers and on the
   data sheet's, the tick floor, the replayed tick's device ms and its
   ratio to the floor, the ledger's reconciliation (a tick beating a
   floor, or a rate above the prediction, by more than 1.5x fails);
   ``capacity.plan`` over the router's telemetry, uncalibrated; one
   ``Autoscaler.step`` scaling 2 -> 1, drain first, on real replicas
   while requests are out (none lost); every child killed at the end;
6. training at full width: bench.py's gpt2s config (vocab 32768,
   12 x 768, bf16, batch 8) through build_train_program, Adam.minimize
   and Executor.run, at seq 512 (phase ``train``: attention takes the
   einsum path, no flash launch) and at seq 2048 (phase ``train_long``:
   attention takes the flash kernels): 3 warm-up and 10 timed steps on
   one fixed batch, the learning rate 1e-4 and 5e-5 at the last step,
   twice from the same start: eagerly (E) and on the card's default
   compiled route (R, the main path: step 1 eager, step 2 captured as a
   CUDA graph and replayed once, every later step replayed). R must
   equal E bit for bit (losses and every persistable), or each
   difference must be one that a second eager run shares; both must read
   the schedule's learning rate back from the card and show beta1's
   power multiplied once a step (``_replay_agrees``); R's loss must be
   finite and fall; the wrappers' launch counts must show the steps run
   on the host (warm-up and capture), and FLASH_DISPATCH_COUNT 12 a
   host step at seq 2048; then one traced step each: R's replayed step
   must show, in the device trace, the CE forward, dx and dW once, Adam
   196 times, and the flash forward, dq and dk/dv 12 times at seq 2048;
   its other kernels' device time by op family; step wall, tokens/s,
   busy share and peak memory of R beside E; at seq 512, before both,
   the loss band (C2): the same 13 steps from the same initial
   parameters in fp32 (T) and in bf16 with the CE kernels replaced by
   their plain versions (Y); R (K) must lie within 2 max |Y - T| + 1e-3
   of T at every step (``_loss_band``);
   then ``train_d256``: the seq-2048 step in 3 heads of 256
   (``_D256``, gpt2s's width), as ``train_long``, its traced replayed
   step showing 12 launches each of the head_dim-256 forward, dq and
   dk/dv (``fwd_d256_sm90_kernel``, ``dq_d256_sm90_kernel``,
   ``dkv_d256_sm90_kernel``) with their device ms, and none of the
   retired SIMT dq (``dq_kernel``);
   then ``train_f32_d256``: the same program in fp32 (``_F32_D256``), as
   ``train_d256``, its traced replayed step showing 12 launches each of
   the split-TF32 forward, dq and dk/dv at head_dim 256
   (``fwd_f32_d256_sm90_kernel``, ``dq_f32_d256_sm90_kernel``,
   ``dkv_f32_d256_sm90_kernel``) and none of the retired SIMT dq or dk/dv
   (``_F32_D256_NAMES``), its step wall and device ms printed beside
   ``train_d256``'s (``train_f32_d256_vs_d256``);
   then ``train_observed`` (``_train_observed``): the seq-2048 step
   again with every step-side observability flag on (the goodput,
   memwatch and dynamics journals and the program dumps under
   ``build/observed/``, ``PADDLE_TPU_CHECK_NUMERICS=1``), replayed 6
   steps, each fetching every gradient, feeding dynamics
   (``grad_health``) and closing a goodput step; its losses must equal
   the same steps with every flag off bit for bit, and an eager run's
   with the sentinel on; its launches (counted from 0) show the seven
   kernels on the warm-up and the capture; goodput charges exactly
   those two runs to ``compile`` and the replays to ``device_compute``;
   memwatch's peak lies within 1% of ``torch.cuda.max_memory_allocated``
   with no leak episode and one journal record a step; dynamics keeps
   one record and journal line a step; ``compiled_insights()`` has one
   record whose FLOPs lie within 1% of the step's analytic count, and
   the dump holds the op list, the captured graph's DOT and cost.json,
   written last; one ``inf`` in ``gpt.wte`` raises the sentinel's typed
   error naming the first op that reads it, replayed and eagerly;
   ``TrainEpochRange`` over 2 epochs of 3 steps, crashed at epoch 1 and
   resumed on a fresh executor and scope, equals the uninterrupted loop
   bit for bit, and ``recovery.drift_audit`` passes on the journals
   across the restart; a status server's /status serves ``memory`` and
   ``dynamics``; the sentinel's and memwatch's cost a step are printed;
   then the sentinel's replayed seq-512 step against its eager one
   (``_sentinel_seq512``), and the OOM autopsy in a child process
   (``python3 chip_smoke.py --oom-child``): under a memory cap, once at
   the warm-up and once at the capture, the step must raise memwatch's
   typed ``ResourceExhausted`` naming the op that raised, with the
   footprint and a post-mortem JSON;
   then ``train_recipe`` (``_train_recipe``): the seq-2048 step as a team
   pretrains it: attention dropout 0.1 under a program seed, recompute
   with one checkpoint a layer (``RecomputeOptimizer``), AdamW (lr 1e-4,
   decay 0.01) behind ``ClipGradByGlobalNorm(1.0)``, replayed; 13 steps
   eagerly and 13 replayed (the main path, counted from 0) from one
   start must equal bit for bit (losses, global norms, clip scales,
   every persistable and the executor's (seed, step) tensor), and the
   same replayed steps without recompute must give the same losses;
   each step's dropout keeps 0.9 of the first layer's outputs within 5
   sigma, with a new mask each step; the clip's scale is min(1, 1 /
   norm) each step and the norm exceeds 1 at least once; the captured
   peak over three replays with recompute lies below the one without by
   at least half of 11 layers' tape bytes (``_segment_bytes``, reckoned
   from one eager step at 256 tokens); a traced replayed step launches
   the flash forward 24 times (12 recomputed), dq and dk/dv 12, the CE
   kernels once and Adam 196 times; the dropout hash's device ms; each
   of the eight other optimizers (Momentum, Adagrad, Adamax, centered
   RMSProp, Adadelta, Lamb, LARS, DGC) takes the seq-512 step eagerly
   and replayed, bit for bit; and the chunked lm-head CE's seq-512 loss
   lies within 2e-2 of the fused kernels' on the same weights;
   then ``train_eager`` (``_train_eager``), the eager API at full width:
   a masked-LM encoder (vocab 32768, 12 pre-norm layers of 768, 12
   heads, learned positions over seq 2048, dropout 0.1) written with the
   port's ``nn`` layers, built on the card from a seed, trained by
   ``Model.fit`` for 8 steps of batch 8 over a ``DataLoader`` (one batch,
   15% of the positions masked) with Adam (lr 1e-4) inside
   ``amp.auto_cast(dtype="bfloat16")``: finite, falling losses; the
   wrappers' launches counted from 0 show flash forward, dq and dk/dv
   (bf16, BHTD, non-causal) 12 a step and fused Adam 198 a step,
   ``FLASH_DISPATCH_COUNT`` 12 a step; the first layer's attention-dropout
   keep mask differs between steps 1 and 2, each keep share within 5
   sigma of 0.9; a traced ``train_batch`` shows the same launches, its
   device ms and the card's idle share beside the median step wall; the
   peak memory beside the reckoning; a 2-layer copy fitted 8 steps with a
   checkpoint every 4 (``PADDLE_TPU_CKPT_DIR``) and resumed from step 4
   into a fresh model ends with the uninterrupted run's ``state_digest``;
   then ``jit`` (``_jit``), the export path: the eval encoder's bf16
   forward under ``to_static`` (bit for bit against eager), control flow,
   and ``jit.save`` in fp32 then ``jit.load`` at batch 1 (``_jit_load``)
   of the encoder at 12 heads and at 3 heads of 256 (``jit_load_d256``),
   each loaded model's traced replay running 12 split-TF32 forwards;
   then the flash kernels timed at the eager shape (BHTD, non-causal);
   then the vision and fluid static path: ``vision_fit``
   (``_vision_fit``, BASELINE config 2): ResNet-50 (1000 classes, NCHW;
   267 parameter tensors, 161 trainable) built on the card from a seed,
   ``Model.fit`` 8 steps over a synthetic ImageNet batch of 64 x 3 x 224
   x 224 under bf16 autocast, Momentum(0.025, 0.9, L2 decay 1e-4) and
   the Accuracy metric: finite, falling losses; every BatchNorm's running
   statistics moved; two ``eval_batch`` calls equal bit for bit, the
   running statistics untouched; none of the seven kernels launched; a
   traced ``train_batch``'s device ms by kernel and op family (conv,
   batch_norm, elementwise, copies, the optimizer), the idle share and
   the peak memory beside the reckoning; ``static_amp``
   (``_static_amp``): the seq-2048 gpt2s built fp32 and decorated by
   ``static.amp`` (bf16, dynamic scaling), run through
   ``CompiledProgram.with_data_parallel``: casts and no ``equal`` op,
   every matmul and attention reading bf16, the CE fp32; parameters fp32
   in the scope; 5 steps replayed = 5 eager bit for bit; losses within
   2e-2 of the undecorated fp32 program's, each parameter's Adam moment1
   within 0.1 of its (relative norm); the seven kernels' launches
   (CE once, flash 12, Adam 196 a step) on the host steps and in a traced
   replayed step, of both programs, the fp32 one's showing the
   split-TF32 dq and dk/dv at head_dim 64 12 times each and the retired
   SIMT dq and dk/dv at no call (``_F32_D64_NAMES``); one step with an inf in a weight leaves every
   parameter and accumulator unchanged and halves the scale, replayed;
   ``fluid_lenet`` (``_fluid_lenet``, BASELINE config 1): LeNet written
   with ``fluid.layers`` and the ``Variable`` overloads over fake MNIST
   (batch 64, Adam) through ``fluid.CompiledProgram``, 20 steps replayed
   = 20 eager bit for bit, the loss falling, fused Adam 10 a step; then
   the fp32 routes timed where the new paths run them: the CE forward,
   dx and dW at N 16,384 (the ``static_amp`` step; first each against its
   plain version, the forward at 1e-4, dx and dW with a non-uniform g at
   fp32 ``_CE_GRAD_TOL``) and the flash kernels
   at batch 1, BHTD, non-causal (``jit.load``'s fp32 program; and at 6
   heads of 128), at the fp32 training shape (and at 6 heads of 128), and
   in fp32 at head_dim 256 at the ``jit_load_d256`` leg's shape and at the
   training shape, each with its kernel's and the library's device ms;
7. CPU against card: tiny fp32 configs train 2 steps from the same numpy
   values on the CPU (plain versions, eager) and on the card (kernels;
   step 1 the warm-up, step 2 captured and replayed): one at seq 16
   (einsum attention), one at seq 128 with PADDLE_TPU_FLASH_MIN_SEQ=128
   (flash attention); loss and every persistable must agree at 1e-4, and
   each Adam moment within 1e-4 of the largest moment of its kind; one
   head of 256 in bf16 at seq 128 (``flash_d256``: the tensor-core
   forward, dq and dk/dv at head_dim 256) trained 2 steps on the card and
   on the CPU, each Adam moment1 of the card's run within twice the CPU bf16
   run's distance from the fp32 program's, and its losses inside the
   loss band (``_bf16_leg_agrees``); the same head in fp32
   (``flash_f32_d256``: the split-TF32 forward, dq and dk/dv at head_dim
   256) held as the fp32 legs; and
   the eager encoder at 2 layers, d 128 and seq 1024 (flash on both
   sides), one ``Model.train_batch`` in fp32 from the same numpy weights,
   held the same way;
8. a ``phase_seconds`` line: each phase's wall seconds, build included;
   then a ``{"kernels": [...]}`` line: per ported kernel, its launches on the
   main paths (the wrapper's host count) and per replayed training step
   (the device trace's), its largest error against the plain version and
   its times at the training shape (the CE forward, dx and dW also at
   N = 16384, under ``long_shape``; the flash kernels also at the eager
   encoder's BHTD non-causal shape, under ``eager_shape``; the CE kernels
   in fp32 at N 16,384 under ``static_amp_shape``, the flash kernels in
   fp32 at batch 1 under ``jit_load_shape`` (at 6 heads of 128 under
   ``f32_d128_shape``) and at the fp32 training shape under
   ``train_f32_shape``, with static_amp's fp32 step's traced calls and
   device ms (at 6 heads of 128 under ``train_f32_d128_shape``), in bf16
   at head_dim 256 under
   ``d256_shape`` with its launches and device ms in train_d256's traced
   step, and in fp32 at head_dim 256 under ``f32_d256_shape`` with its
   launches and device ms in train_f32_d256's traced step, the
   forward also under ``jit_load_d256_shape`` with that leg's launches
   and traced device ms), its
   launches by path
   including ``train_eager``, ``vision_fit`` (none), ``static_amp`` and
   ``fluid_lenet``; a kernel whose bf16 path runs on
   the tensor cores names that source, with the fp32 one beside it
   (``source_fp32``, and ``source_d256`` for bf16 at head_dim 256:
   ``flash_attention_fwd_d256_sm90.cu``, ``flash_attention_dq_d256_sm90.cu``
   and ``flash_attention_dkv_d256_sm90.cu``; the CE kernels' and the flash
   forward's fp32 sources are their split-TF32 kernels, at head_dim 256
   under ``source_fp32_d256``: ``flash_attention_fwd_f32_d256_sm90.cu``,
   ``flash_attention_dq_f32_d256_sm90.cu`` and
   ``flash_attention_dkv_f32_d256_sm90.cu``; dq's and dk/dv's fp32 sources
   at 64 and 128 are ``flash_attention_dq_f32_sm90.cu`` and
   ``flash_attention_dkv_f32_sm90.cu``;
   ``serve_shapes``
   the CE forward's times at the serving shapes);
9. the card's name and power limit again, and the last line:
   ``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
_PEAK_BYTES_PER_S = 3.35e12
# fp32 on the FMA units, outside the tensor cores; tf32 the tensor cores'
# dense rate, which the fp32 CE kernels' three tf32 products run at
_PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tfloat32": 494.7e12}

_SERVE_D, _SERVE_V = 768, 32000
# the serving config (12 x 768, vocab 32000) and its engine's envelope
_SERVE_CFG = dict(vocab_size=_SERVE_V, n_layer=12, n_head=12,
                  d_model=_SERVE_D, max_seq_len=1024)
_SERVE_ENV = dict(max_batch=8, n_blocks=320, block_size=16,
                  prefill_buckets=[32, 128, 512])
# bench.py's headline training config (gpt2s @ seq 512)
_TRAIN = dict(vocab_size=32768, n_layer=12, n_head=12, d_model=768,
              max_seq_len=512, dtype="bfloat16")
_TRAIN_B, _TRAIN_T = 8, 512
_TRAIN_N = _TRAIN_B * _TRAIN_T  # tokens per step: the CE kernels' N
# bench.py's long-sequence training config (gpt2s @ seq 2048), which
# takes the flash attention kernels
_LONG = dict(_TRAIN, max_seq_len=2048)
_LONG_B, _LONG_T = 8, 2048
_LONG_N = _LONG_B * _LONG_T
_LAYERS = _LONG["n_layer"]
# the same at n_head 3: head_dim 256, which the head_dim-256 flash
# kernels take (train_d256)
_D256 = dict(_LONG, n_head=3)
# the kernels of train_d256's traced replayed step, by pieces of their
# names, and their calls a step: the head_dim-256 forward, dq and dk/dv on
# the tensor cores, and none of the retired SIMT dq (a guard: no source
# holds it)
_D256_NAMES = {"::fwd_d256_sm90_kernel(": _LAYERS,
               "::dq_d256_sm90_kernel(": _LAYERS,
               "::dkv_d256_sm90_kernel(": _LAYERS,
               "::dq_kernel<": 0}
# the same in fp32 (train_f32_d256): the split-TF32 forward, dq and dk/dv
# at head_dim 256, and none of the retired SIMT dq or dk/dv
_F32_D256 = dict(_D256, dtype="float32")
_F32_D256_NAMES = {"::fwd_f32_d256_sm90_kernel(": _LAYERS,
                   "::dq_f32_d256_sm90_kernel(": _LAYERS,
                   "::dkv_f32_d256_sm90_kernel(": _LAYERS,
                   "::dq_kernel<": 0, "::dkv_kernel<": 0}
# the flash backward kernels of static_amp's undecorated fp32 program's
# traced replayed step (head_dim 64): the split-TF32 dq and dk/dv 12 times
# each, and none of the retired SIMT dq and dk/dv they replaced
_F32_D64_NAMES = {"::dkv_f32_sm90_kernel<64>": _LAYERS,
                  "::dq_f32_sm90_kernel<64>": _LAYERS,
                  "::dq_kernel<": 0, "::dkv_kernel<": 0}
_WARM_STEPS, _TIMED_STEPS = 3, 10
_LR = 1e-4  # bench.py's Adam learning rate
# the last training step's rate: a schedule that changes after the
# capture, so that a learning rate frozen into the graph shows, in the
# rate read back from the card and in the final parameters, while every
# loss (read before its step's update) stays that of bench.py's constant
# rate
_LAST_LR = 5e-5
_ADAM_PER_STEP = 196  # wte, wpe, 16 per layer x 12, lnf scale and bias
_SCORE_NS = (31, 127, 511)  # score's N = bucket - 1 at buckets 32/128/512
_PROMPT_LENS = (17, 45, 96, 128, 200, 311, 480, 500)
_NEW_TOKENS = 32
_REPEATS = 30


_SAID = {}  # the last report printed for each phase


def _say(**kw) -> None:
    if "phase" in kw:
        _SAID[kw["phase"]] = kw
    print(json.dumps(kw), flush=True)


def _environment(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _say(phase="environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())
    return card


# the tensor-core kernels in SASS and in ptxas's report: each name is
# found by the pieces of its mangled symbol (its source's file name, the
# kernel, the template argument: bwd_sm90_kernel<TOKEN_ROWS> names the CE
# backward's product, fwd_sm90_kernel<D>, flash_fwd_f32_kernel<D>,
# dq_sm90_kernel<D> and dkv_sm90_kernel<D> the flash kernels' head_dim;
# fwd_d256_sm90_kernel, dq_d256_sm90_kernel and dkv_d256_sm90_kernel are
# head_dim 256's own in bf16, fwd_f32_d256_sm90_kernel the fp32 forward's,
# dq_f32_d256_sm90_kernel and dkv_f32_d256_sm90_kernel the fp32 backward's,
# dq_f32_sm90_kernel<D> and dkv_f32_sm90_kernel<D> the fp32 dq's and
# dk/dv's at head_dim 64 and 128; no two entries' pieces match one kernel)
_SM90_KERNELS = {
    "lmhead_ce_fwd": ("lmhead_ce_fwd_sm90", "fwd_sm90_kernel"),
    "lmhead_ce_fwd_f32": ("lmhead_ce_fwd_f32_sm90", "fwd_f32_sm90_kernel"),
    "lmhead_ce_dx": ("lmhead_ce_bwd_sm90", "bwd_sm90_kernelILb1E"),
    "lmhead_ce_dw": ("lmhead_ce_bwd_sm90", "bwd_sm90_kernelILb0E"),
    "lmhead_ce_dx_f32": ("lmhead_ce_bwd_f32_sm90", "bwd_f32_sm90_kernelILb1E"),
    "lmhead_ce_dw_f32": ("lmhead_ce_bwd_f32_sm90", "bwd_f32_sm90_kernelILb0E"),
    "flash_attention_fwd_d64": ("flash_attention_fwd_sm90",
                                "fwd_sm90_kernelILi64E"),
    "flash_attention_fwd_d128": ("flash_attention_fwd_sm90",
                                 "fwd_sm90_kernelILi128E"),
    "flash_attention_fwd_f32_d64": ("flash_attention_fwd_f32_sm90",
                                    "flash_fwd_f32_kernelILi64E"),
    "flash_attention_fwd_f32_d128": ("flash_attention_fwd_f32_sm90",
                                     "flash_fwd_f32_kernelILi128E"),
    "flash_attention_dq_d64": ("flash_attention_bwd_sm90",
                               "dq_sm90_kernelILi64E"),
    "flash_attention_dq_d128": ("flash_attention_bwd_sm90",
                                "dq_sm90_kernelILi128E"),
    "flash_attention_dkv_d64": ("flash_attention_bwd_sm90",
                                "dkv_sm90_kernelILi64E"),
    "flash_attention_dkv_d128": ("flash_attention_bwd_sm90",
                                 "dkv_sm90_kernelILi128E"),
    "flash_attention_fwd_d256": ("flash_attention_fwd_d256_sm90",
                                 "fwd_d256_sm90_kernel"),
    "flash_attention_dq_d256": ("flash_attention_dq_d256_sm90",
                                "dq_d256_sm90_kernel"),
    "flash_attention_dkv_d256": ("flash_attention_dkv_d256_sm90",
                                 "dkv_d256_sm90_kernel"),
    "flash_attention_fwd_f32_d256": ("flash_attention_fwd_f32_d256_sm90",
                                     "fwd_f32_d256_sm90_kernel"),
    "flash_attention_dq_f32_d256": ("flash_attention_dq_f32_d256_sm90",
                                    "dq_f32_d256_sm90_kernel"),
    "flash_attention_dkv_f32_d256": ("flash_attention_dkv_f32_d256_sm90",
                                     "dkv_f32_d256_sm90_kernel"),
    "flash_attention_dkv_f32_d64": ("flash_attention_dkv_f32_sm90",
                                    "dkv_f32_sm90_kernelILi64E"),
    "flash_attention_dkv_f32_d128": ("flash_attention_dkv_f32_sm90",
                                     "dkv_f32_sm90_kernelILi128E"),
    "flash_attention_dq_f32_d64": ("flash_attention_dq_f32_sm90",
                                   "dq_f32_sm90_kernelILi64E"),
    "flash_attention_dq_f32_d128": ("flash_attention_dq_f32_sm90",
                                    "dq_f32_sm90_kernelILi128E"),
}


# the tensor-core instructions the split-TF32 backward kernels' sources
# issue (dq at 256: 8 score chains of 12 wgmma and 12 accumulating ones;
# dk/dv at 256: the same and 24; dk/dv at 128 and 64, where each warpgroup
# runs one product's chains and one accumulating product: 4 chains and 12,
# 2 chains and 6; dq at 128 and 64, where each warpgroup runs both score
# products over all of D for its own rows: 8 chains and 12, 4 chains and
# 6), all of which their SASS must hold, with no spill: the two score
# products written as two calls of one function once compiled to one copy
# of the chains (48 HGMMA) that gave wrong sums
_SM90_HGMMA = {"flash_attention_dq_f32_d256": 108,
               "flash_attention_dkv_f32_d256": 120,
               "flash_attention_dkv_f32_d64": 30,
               "flash_attention_dkv_f32_d128": 60,
               "flash_attention_dq_f32_d64": 54,
               "flash_attention_dq_f32_d128": 108}


def _sm90_kernel(name):
    """The ``_SM90_KERNELS`` key of a mangled kernel name, or None."""
    return next((k for k, parts in _SM90_KERNELS.items()
                 if all(p in name for p in parts)), None)


def _sm90_report(so_path, log):
    """{kernel: {hgmma, hmma, registers, spill_stores, spill_loads}} of
    the tensor-core kernels: tensor-core instructions counted in the built
    library's SASS (``cuobjdump -sass``), registers and spills from
    ptxas's report in this process's build log."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", so_path], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    report = {}
    for body in sass.split("Function : ")[1:]:
        kernel = _sm90_kernel(body.split("\n", 1)[0].strip())
        if kernel:
            report[kernel] = {"hgmma": body.count("HGMMA"),
                              "hmma": body.count("HMMA")}
    for block in log.split("Compiling entry function '")[1:]:
        kernel = _sm90_kernel(block.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", block)
        if kernel and regs:
            report.setdefault(kernel, {}).update(
                registers=int(regs.group(1)),
                spill_stores=int(spills.group(1)) if spills else None,
                spill_loads=int(spills.group(2)) if spills else None)
    return report


def _build():
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fl
    from paddle_tpu_torch.ops import lmhead_ce as ce

    t0 = time.perf_counter()
    lib = _build.load()
    print(_build.build_log(), flush=True)
    geometry = {
        "lmhead_ce_bwd": ((lib.lmhead_ce_sm90_tile(),
                           lib.lmhead_ce_sm90_half(),
                           lib.lmhead_ce_sm90_slab()),
                          (ce.SM90_TILE, ce.SM90_HALF, ce.SM90_SLAB)),
        "lmhead_ce_bwd_f32": ((lib.lmhead_ce_bwd_f32_sm90_rows(),
                               lib.lmhead_ce_bwd_f32_sm90_cols(),
                               lib.lmhead_ce_bwd_f32_sm90_slab(),
                               lib.lmhead_ce_bwd_f32_sm90_pad()),
                              (ce.SM90_F32_BWD_ROWS, ce.SM90_F32_BWD_COLS,
                               ce.SM90_F32_BWD_SLAB, ce.SM90_F32_BWD_PAD)),
        "lmhead_ce_fwd": ((lib.lmhead_ce_fwd_sm90_tile_n(),
                           lib.lmhead_ce_fwd_sm90_tile_v()),
                          (ce.SM90_FWD_TILE_N, ce.SM90_FWD_TILE_V)),
        "lmhead_ce_fwd_f32": ((lib.lmhead_ce_fwd_f32_sm90_tile_n(),
                               lib.lmhead_ce_fwd_f32_sm90_tile_v()),
                              (ce.SM90_FWD_TILE_N, ce.SM90_FWD_TILE_V)),
        "flash_attention_fwd": ((lib.flash_attn_fwd_sm90_tile_q(),
                                 lib.flash_attn_fwd_sm90_tile_kv()),
                                (fl.SM90_FWD_TILE_Q, fl.SM90_FWD_TILE_KV)),
        "flash_attention_fwd_f32": ({d: (lib.flash_attn_fwd_f32_sm90_tile_q(d),
                                         lib.flash_attn_fwd_f32_sm90_tile_kv(d))
                                     for d in fl.SM90_F32_FWD_TILES},
                                    fl.SM90_F32_FWD_TILES),
        "flash_attention_bwd": ({d: (lib.flash_attn_bwd_sm90_tile(d),
                                     lib.flash_attn_dq_sm90_stage(d),
                                     lib.flash_attn_dkv_sm90_stage(d))
                                 for d in fl.SM90_BWD_TILES},
                                fl.SM90_BWD_TILES),
        "flash_attention_fwd_d256": ((lib.flash_attn_fwd_d256_sm90_tile_q(),
                                      lib.flash_attn_fwd_d256_sm90_tile_kv()),
                                     fl.SM90_D256_FWD_TILES),
        "flash_attention_dq_d256": ((lib.flash_attn_dq_d256_sm90_tile(),
                                     lib.flash_attn_dq_d256_sm90_stage()),
                                    fl.SM90_D256_DQ_TILES),
        "flash_attention_dkv_d256": ((lib.flash_attn_dkv_d256_sm90_tile(),
                                      lib.flash_attn_dkv_d256_sm90_stage()),
                                     fl.SM90_D256_DKV_TILES),
        "flash_attention_fwd_f32_d256": (
            (lib.flash_attn_fwd_f32_d256_sm90_tile_q(),
             lib.flash_attn_fwd_f32_d256_sm90_tile_kv()),
            fl.SM90_F32_D256_FWD_TILES),
        "flash_attention_dq_f32_d256": (
            (lib.flash_attn_dq_f32_d256_sm90_tile(),
             lib.flash_attn_dq_f32_d256_sm90_stage(),
             lib.flash_attn_dq_f32_d256_sm90_flush()),
            fl.SM90_F32_D256_DQ_TILES + (fl.SM90_F32_BWD_FLUSH,)),
        "flash_attention_dkv_f32_d256": (
            (lib.flash_attn_dkv_f32_d256_sm90_tile(),
             lib.flash_attn_dkv_f32_d256_sm90_stage(),
             lib.flash_attn_dkv_f32_d256_sm90_flush()),
            fl.SM90_F32_D256_DKV_TILES + (fl.SM90_F32_BWD_FLUSH,)),
        "flash_attention_dkv_f32": (
            (lib.flash_attn_dkv_f32_sm90_tile(),
             lib.flash_attn_dkv_f32_sm90_stage(),
             lib.flash_attn_dkv_f32_sm90_flush()),
            fl.SM90_F32_DKV_TILES + (fl.SM90_F32_BWD_FLUSH,)),
        "flash_attention_dq_f32": (
            (lib.flash_attn_dq_f32_sm90_tile(),
             lib.flash_attn_dq_f32_sm90_stage(),
             lib.flash_attn_dq_f32_sm90_flush()),
            fl.SM90_F32_DQ_TILES + (fl.SM90_F32_BWD_FLUSH,))}
    for name, (built, wrapper) in geometry.items():
        if built != wrapper:
            raise AssertionError(f"{name} (sm90) geometry {built} differs "
                                 f"from its wrapper's {wrapper}")
    sm90 = _sm90_report(_build.library_path(), _build.build_log())
    if sorted(sm90) != sorted(_SM90_KERNELS) or not all(
            k.get("hgmma", 0) > 0 for k in sm90.values()):
        raise AssertionError(f"tensor-core kernels without tensor-core "
                             f"instructions in their SASS: {sm90}")
    wrong = {k: sm90[k] for k, n in _SM90_HGMMA.items()
             if sm90[k]["hgmma"] != n or sm90[k].get("spill_stores")}
    if wrong:
        raise AssertionError(f"split-TF32 backward kernels not built as "
                             f"written (HGMMA wanted {_SM90_HGMMA}, no "
                             f"spill): {wrong}")
    serialized = [line.strip() for line in _build.build_log().splitlines()
                  if "wgmma" in line and "serialized" in line]
    _say(phase="build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(_build.build_seconds(), 3),
         sources=[os.path.relpath(s) for s in _build.sources()],
         headers=[os.path.relpath(s) for s in _build.headers()],
         sm90_kernels=sm90, wgmma_serialized=serialized)


def _inputs(torch, n, d, v, dtype, seed, device="cuda"):
    r = np.random.RandomState(seed)
    x = torch.from_numpy((r.randn(n, d) * 0.5).astype(np.float32))
    w = torch.from_numpy((r.randn(v, d) * 0.5).astype(np.float32))
    lbl = torch.from_numpy(r.randint(0, v, (n,)).astype(np.int64))
    return (x.to(device, dtype), w.to(device, dtype), lbl.to(device))


def _check_kernel(torch):
    """lmhead_ce against lmhead_ce_plain on the card, nll and lse, at
    rtol = atol = tol. fp32 (split TF32 on the tensor cores against exact
    fp32 products): 1e-4, as when both sides summed exact fp32 products;
    the split drops about 2^-22 of each product, and
    tests/test_torch_lmhead_ce_f32.py's emulation of the kernel lies within
    2e-4 of the plain version at |nll| of 10 to 40 (rtol 1e-4 gives 1e-3
    to 4e-3 there). bf16: 2e-3, the floor of tests/test_fused_lmhead_ce.py.
    fp32 cases: the serving shapes, then ragged N and V, N = 1, D = 60
    (padded to 64) and D = 1000 (a last 32-deep stage partly past D), with
    labels V and -1 at rows 3 and 7 off the serving shapes."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    cases = [(n, _SERVE_D, _SERVE_V, torch.float32, 1e-4) for n in _SCORE_NS]
    cases += [(511, _SERVE_D, _SERVE_V, torch.bfloat16, 2e-3),
              (33, 64, 130, torch.float32, 1e-4),
              (1, _SERVE_D, _SERVE_V, torch.float32, 1e-4),
              (64, 60, 130, torch.float32, 1e-4),
              (100, 1000, 300, torch.float32, 1e-4)]
    worst = 0.0
    for i, (n, d, v, dtype, tol) in enumerate(cases):
        x, w, lbl = _inputs(torch, n, d, v, dtype, seed=10 + i)
        if n > 7 and v != _SERVE_V:  # labels outside [0, V) pick nothing
            lbl[3], lbl[7] = v, -1
        got = ce.lmhead_ce_fwd(x, w, lbl)
        ref = ce.lmhead_ce_plain(x, w, lbl)
        torch.cuda.synchronize()
        err = _ce_fwd_agrees(torch, got, ref, lbl, v, tol,
                             f"n={n} d={d} v={v} {dtype}")
        worst = max(worst, err)
        _say(phase="kernel_check", kernel="lmhead_ce_fwd", n=n, d=d, v=v,
             dtype=str(dtype).replace("torch.", ""), tolerance_rel=tol,
             max_abs_err=err)
    return max(worst, _check_fp64_truth(torch))


# The fp32 CE forward (split TF32 on the tensor cores) against float64
# logits: its max abs error in nll and lse may be at most _TF32_MULTIPLE
# times the plain fp32 version's own (full fp32 products, TF32 off, and
# torch.logsumexp), plus _TF32_ATOL. Why 28:
# tests/test_torch_lmhead_ce_f32.py emulates the kernel's arithmetic on the
# CPU -- the split, its two accumulators, the online reduction by tiles and
# the combine -- with the tensor cores' fp32 accumulation modelled as
# truncating after every 4 products, and finds 14.0 times the plain
# version's error at N = 64, D = 768, V = 2048; the bound is twice that.
# A 1xTF32 kernel (hi . hi alone) lies 20 times beyond it there, so the
# bound tells split TF32 from TF32.
_TF32_MULTIPLE = 28.0
_TF32_ATOL = 1e-6


def _fp64_err(torch, got, x, w, labels) -> float:
    """Max abs error of (nll, lse) against those of float64 logits."""
    logits = x.double() @ w.double().t()
    lse = torch.logsumexp(logits, 1)
    v = w.shape[0]
    lbl = labels.long()
    hit = (lbl >= 0) & (lbl < v)
    picked = torch.where(hit, logits.gather(1, lbl.clamp(0, v - 1)[:, None])
                         [:, 0], torch.zeros_like(lse))
    return max(_err(got[0].double(), lse - picked), _err(got[1].double(), lse))


def _check_fp64_truth(torch) -> float:
    """The fp32 forward at the serving shapes against float64 logits,
    within ``_TF32_MULTIPLE`` times the plain fp32 version's own error plus
    ``_TF32_ATOL``; raises where it is not. Returns the kernel's largest
    error against the plain version."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    worst = 0.0
    for i, n in enumerate(_SCORE_NS):
        x, w, lbl = _inputs(torch, n, _SERVE_D, _SERVE_V, torch.float32,
                            seed=20 + i)
        got = ce.lmhead_ce_fwd(x, w, lbl)
        plain = ce.lmhead_ce_plain(x, w, lbl)
        torch.cuda.synchronize()
        err = _fp64_err(torch, got, x, w, lbl)
        own = _fp64_err(torch, plain, x, w, lbl)
        bound = _TF32_MULTIPLE * own + _TF32_ATOL
        _say(phase="kernel_check", kernel="lmhead_ce_fwd", check="fp64_truth",
             n=n, d=_SERVE_D, v=_SERVE_V, dtype="float32", max_abs_err=err,
             plain_max_abs_err=own, ratio=err / own if own else None,
             bound=bound, multiple=_TF32_MULTIPLE, atol=_TF32_ATOL)
        if not err <= bound or not all(bool(torch.isfinite(t).all())
                                       for t in got):
            raise AssertionError(
                f"lmhead_ce_fwd fp32 at n={n}: max abs error {err} against "
                f"float64 logits, beyond {bound} ({_TF32_MULTIPLE} x the "
                f"plain fp32 version's {own} + {_TF32_ATOL})")
        worst = max(worst, _err(got[0], plain[0]), _err(got[1], plain[1]))
    return worst


# The fp32 CE backward (dx and dW, split TF32 on the tensor cores) against
# float64: its max abs error may be at most _BWD_TF32_MULTIPLE times the
# plain fp32 version's own (full fp32 products, TF32 off) plus _TF32_ATOL,
# both given the same lse and g. Why 4:
# tests/test_torch_lmhead_ce_f32.py emulates the kernel's arithmetic on the
# CPU -- both products split, a new pair of accumulators for every 64 of D
# in the score and every 64-column tile in the product, added in fp32, the
# chunks' partials -- with the tensor cores' accumulation truncating after
# every 4 products, and finds 0.75 to 1.87 times the plain version's error
# over the seeds 10 to 21 at N = 64, D = 768, V = 2048 (1.87 at its seed
# 10); the bound is twice the largest, rounded up. A 1xTF32 kernel lies
# about 270 times beyond it there. The card's plain version (cuBLAS) errs
# more than the CPU's, so there the ratio is smaller.
_BWD_TF32_MULTIPLE = 4.0


def _bwd_fp64_err(torch, got, x, w, labels, lse, g) -> tuple:
    """Max abs errors of (dx, dW) against those of float64 logits and
    d-logits from the same lse and g."""
    logits = x.double() @ w.double().t()
    v = w.shape[0]
    lbl = labels.long()
    ok = (lbl >= 0) & (lbl < v)
    dl = torch.exp(logits - lse.double()[:, None])
    del logits
    rows = ok.nonzero()[:, 0]
    dl[rows, lbl[ok]] -= 1.0
    dl *= g.double()[:, None]
    dx = _err(got[0].double(), dl @ w.double())
    return dx, _err(got[1].double(), dl.t() @ x.double())


def _check_bwd_fp64_truth(torch) -> dict:
    """fp32 dx and dW against float64 at N 511 (a chunked sweep) and 4096
    (one chunk: the whole sweep), D 768, V 32768, labels V and -1, a
    non-uniform g: within ``_BWD_TF32_MULTIPLE`` times the plain fp32
    version's own error plus ``_TF32_ATOL``; raises where not. Returns
    {kernel: the largest error against the plain version}."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    worst = {"lmhead_ce_dx": 0.0, "lmhead_ce_dw": 0.0}
    d, v = _TRAIN["d_model"], _TRAIN["vocab_size"]
    for i, n in enumerate((511, _TRAIN_N)):
        x, w, lbl = _inputs(torch, n, d, v, torch.float32, seed=30 + i)
        lbl[3], lbl[7] = v, -1
        g = torch.from_numpy(np.random.RandomState(32 + i).uniform(
            0.5, 1.5, n).astype(np.float32)).cuda()
        lse = ce.lmhead_ce_plain(x, w, lbl)[1]
        got = (ce.lmhead_ce_dx(x, w, lbl, lse, g),
               ce.lmhead_ce_dw(x, w, lbl, lse, g))
        plain = (ce.lmhead_ce_dx_plain(x, w, lbl, lse, g),
                 ce.lmhead_ce_dw_plain(x, w, lbl, lse, g))
        torch.cuda.synchronize()
        errs = _bwd_fp64_err(torch, got, x, w, lbl, lse, g)
        owns = _bwd_fp64_err(torch, plain, x, w, lbl, lse, g)
        for name, k, p, err, own in zip(worst, got, plain, errs, owns):
            bound = _BWD_TF32_MULTIPLE * own + _TF32_ATOL
            _say(phase="kernel_check", kernel=name, check="fp64_truth", n=n,
                 d=d, v=v, dtype="float32", max_abs_err=err,
                 plain_max_abs_err=own, ratio=err / own if own else None,
                 bound=bound, multiple=_BWD_TF32_MULTIPLE, atol=_TF32_ATOL,
                 chunks=ce.sm90_f32_bwd_split(
                     *((n, v) if name == "lmhead_ce_dx" else (v, n)),
                     torch.cuda.get_device_properties(0)
                     .multi_processor_count)[1])
            if not err <= bound or not bool(torch.isfinite(k).all()):
                raise AssertionError(
                    f"{name} fp32 at n={n}: max abs error {err} against "
                    f"float64, beyond {bound} ({_BWD_TF32_MULTIPLE} x the "
                    f"plain fp32 version's {own} + {_TF32_ATOL})")
            worst[name] = max(worst[name], _err(k, p))
        del got, plain
    return worst


def _ce_fwd_agrees(torch, got, ref, lbl, v, tol, what) -> float:
    """Holds the CE forward's (nll, lse) against the plain version's at
    rtol = atol = tol, and a row whose label lies outside [0, V) to nll
    == lse exactly (it picks nothing); raises naming what disagrees or is
    not finite. Returns the max abs error."""
    (nll, lse), (ref_nll, ref_lse) = got, ref
    err = max(_err(nll, ref_nll), _err(lse, ref_lse))
    bad = _beyond(nll, ref_nll, tol, tol) + _beyond(lse, ref_lse, tol, tol)
    outside = (lbl < 0) | (lbl >= v)
    if bad or not (torch.isfinite(nll).all() and torch.isfinite(lse).all()) \
            or not (nll[outside] == lse[outside]).all():
        raise AssertionError(
            f"lmhead_ce_fwd disagrees with its plain version at {what}: "
            f"{bad} values beyond {tol}, max abs err {err}, or a label "
            f"outside [0, V) picked a logit")
    return err


def _median_ms(torch, fn, *args, repeats=_REPEATS):
    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# traces a timing takes in all where each loses its records (_device_ms)
_TRACE_TRIES = 2


def _device_ms(torch, fn, *args, calls=10):
    """Device ms of one call of ``fn``: its kernels' summed durations in a
    trace of ``calls`` calls after a traced warm-up (``_profiled``), over
    ``calls`` (the CUDA-event time of a short call also holds the host's
    time to launch it); a trace that lost records is taken again, up to
    ``_TRACE_TRIES`` traces in all; None where the last lost records or
    kept no kernel record. (Late in the smoke a trace of the wrappers'
    calls lost every record, markers included, while the library call's
    next to it kept them; the same traces kept them in a fresh
    process.)"""
    def run():
        for _ in range(calls):
            fn(*args)

    for attempt in range(_TRACE_TRIES):
        try:
            _, _, events = _profiled(torch, run)
            break
        except _TraceLost as e:
            _say(phase="trace_lost", fn=getattr(fn, "__name__", str(fn)),
                 attempt=attempt + 1, error=str(e))
    else:
        return None
    device_ms = _kernel_tally(torch, events)[1]
    return device_ms / calls if device_ms else None


def _bound(n, d, v, dtype_name, elem, products=1):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    ``products`` times 2*N*V*D FLOPs over the peak rate of
    ``dtype_name``. Bytes: x, W and the int64 labels read once, the fp32
    nll written once. fp32 at 67 TFLOP/s is the FMA units' bound; TF32
    alone (10 mantissa bits, about 1e-3 on a score) is ruled out for fp32,
    and split TF32, the tensor cores' route, takes three tf32 products a
    score (``"tfloat32"``, products=3)."""
    nbytes = (n * d + v * d) * elem + 8 * n + 4 * n
    t_bytes = nbytes / _PEAK_BYTES_PER_S
    t_ops = products * 2.0 * n * v * d / _PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _time_kernel(torch, card):
    """Kernel, plain, library and bound of the CE forward at the serving
    shapes (fp32, and bf16 at N = 511), CUDA-event medians; each row also
    carries the device time of the kernel and of the library call from a
    traced window (``_device_ms``), which leaves the host's launch time
    out. In fp32 the bound is the split-TF32 one (three tf32 products a
    score at the tensor cores' rate, the way the kernel computes), with
    the FMA units' bound beside it (``bound_fma_ms``) and the kernel's
    tf32 TFLOP/s."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import lmhead_ce as ce

    def library(x, w, lbl):
        return F.cross_entropy(x @ w.t(), lbl, reduction="none")

    rows = {}
    for n, dtype in [(n, torch.float32) for n in _SCORE_NS] + \
            [(511, torch.bfloat16)]:
        x, w, lbl = _inputs(torch, n, _SERVE_D, _SERVE_V, dtype, seed=n)
        name = str(dtype).replace("torch.", "")
        bound_ms, bound_by = (
            _bound(n, _SERVE_D, _SERVE_V, "tfloat32", 4, products=3)
            if dtype == torch.float32 else
            _bound(n, _SERVE_D, _SERVE_V, name, x.element_size()))
        row = dict(phase="kernel_time", kernel="lmhead_ce_fwd", n=n,
                   d=_SERVE_D, v=_SERVE_V, dtype=name,
                   kernel_ms=_median_ms(torch, ce.lmhead_ce, x, w, lbl),
                   plain_ms=_median_ms(torch, ce.lmhead_ce_plain, x, w, lbl),
                   library_ms=_median_ms(torch, library, x, w, lbl),
                   bound_ms=bound_ms, bound_by=bound_by,
                   repeats=_REPEATS, card=card)
        if dtype == torch.float32:  # the FMA units' bound, for comparison
            row["bound_fma_ms"] = _bound(n, _SERVE_D, _SERVE_V, name, 4)[0]
            row["tflops_tf32"] = (6.0 * n * _SERVE_V * _SERVE_D
                                  / row["kernel_ms"] / 1e9)
        row["over_library"] = row["kernel_ms"] / row["library_ms"]
        row["kernel_device_ms"] = _device_ms(torch, ce.lmhead_ce, x, w, lbl)
        row["library_device_ms"] = _device_ms(torch, library, x, w, lbl)
        _say(**row)
        rows[(n, name)] = row
    return rows


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _beyond(got, ref, rtol, atol) -> int:
    """Elements outside |got - ref| <= atol + rtol * |ref|."""
    got, ref = got.float(), ref.float()
    return int(((got - ref).abs() > atol + rtol * ref.abs()).sum())


def _no_big_buffer(torch, name, fn, limit, buffer, **shape) -> None:
    """A kernel allocates no buffer as large as ``buffer`` (the fused CE
    kernels no [N, V] buffer of logits or d-logits, the flash kernels no
    [B, H, T, T] buffer of scores): the peak device memory a call adds
    above what was allocated before it (its outputs and scratch) stays
    below ``limit`` bytes, the size of the smallest such buffer (bf16)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    _say(phase="kernel_memory", kernel=name, **shape, peak_added_bytes=added,
         limit_bytes=limit, limit=f"one bf16 {buffer} buffer")
    if added >= limit:
        raise AssertionError(f"{name} allocated {added} bytes at its peak, "
                             f"as much as a {buffer} buffer ({limit})")
    del out


# The bf16 CE forward (the tensor-core kernel) against its plain version
# at 2e-3, (N, D, V): both training shapes, then the kernel's edges --
# ragged N and V (labels V and -1 at rows 3 and 7 wherever N > 7), D = 60
# (the wrapper pads to 64), D = 1000 (16 chunks of 64, the last partly past
# D), N = 1, and N = 600, whose 5 row tiles leave most SMs to the
# vocabulary split
_CE_FWD_CASES = [
    (_TRAIN_N, 768, 32768), (_LONG_N, 768, 32768), (33, 64, 130),
    (64, 60, 130), (100, 1000, 300), (1, 768, 300), (600, 768, 5000),
]


# The CE backward kernels against their plain versions, (rtol, atol):
# |got - ref| <= atol + rtol * |ref|. fp32 at 1e-4 (exact fp32 products
# summed in another order). bf16 at one bf16 ulp (rtol 2^-7) plus atol
# 2^-6: both sides round the d-logits to bf16 and the fp32 sum once, but
# the kernel's scores are summed in another order and its exp is exp2f,
# so a d-logit lying at a bf16 rounding boundary may round the other way
# (about 2^-9 of a d-logit near 1, times a row of W or x) and move an
# output across a rounding boundary of its own. The card measured at
# most 9.5e-3 beyond one ulp (dx at N = 16384); atol 2^-6 (one ulp at
# |out| in [2, 4)) holds that with a third to spare.
# tests/test_torch_smoke_checks.py shows this bound rejecting an output
# accumulated in bf16, one that drops a column tile and one that reads
# the next row's lse, and passing the plain version summed in another
# order.
_CE_GRAD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -6)}
# (N, D, V, dtype): bf16 at both training shapes, then the bf16 kernel's
# edges -- ragged N and V with labels V and -1, D = 1000 (a third D block,
# partly past D), D = 60 (the wrapper pads to 64), N = 1, and N = 600,
# whose 10 row tiles x 2 D halves fill 20 of the card's SMs; fp32 (split
# TF32) at the static_amp step's N = 16384 (dx and dW one chunk each),
# then its edges -- ragged N and V with labels V and -1, D = 60 (padded to
# 64: five of the six product steps load nothing), D = 1000 (padded to
# 1024: two slabs, the scores built twice), N = 1 (dx: 5 chunks of one
# column tile) and N = 511 (dx: 16 row tiles x 8 chunks, the reduce)
_CE_GRAD_CASES = [
    (_TRAIN_N, 768, 32768, "bfloat16"), (_LONG_N, 768, 32768, "bfloat16"),
    (33, 64, 130, "bfloat16"), (100, 1000, 300, "bfloat16"),
    (64, 60, 130, "bfloat16"), (1, 768, 300, "bfloat16"),
    (600, 768, 5000, "bfloat16"),
    (_LONG_N, 768, 32768, "float32"), (33, 64, 130, "float32"),
    (64, 60, 130, "float32"), (100, 1000, 300, "float32"),
    (1, 768, 300, "float32"), (511, 768, 32768, "float32"),
]


def _excess(got, ref, rtol) -> float:
    """The largest |got - ref| beyond rtol * |ref| (what atol must hold)."""
    if not got.numel():
        return 0.0
    got, ref = got.float(), ref.float()
    return float(((got - ref).abs() - rtol * ref.abs()).max())


def _ce_grad_agrees(torch, got, ref, name, what) -> float:
    """Holds a CE gradient (dx or dW) against the plain version's at
    ``_CE_GRAD_TOL`` of its dtype; raises naming it if any value lies
    beyond or is not finite. Returns the max abs error."""
    rtol, atol = _CE_GRAD_TOL[str(ref.dtype).replace("torch.", "")]
    err = _err(got, ref)
    bad = _beyond(got, ref, rtol, atol)
    if bad or not torch.isfinite(got.float()).all():
        raise AssertionError(
            f"{name} disagrees with its plain version at {what}: {bad} "
            f"values beyond (rtol, atol) ({rtol}, {atol}), max abs err "
            f"{err}")
    return err


def _check_training_kernels(torch):
    """The training path's kernels against their plain versions on the
    card. The bf16 forward over ``_CE_FWD_CASES`` at 2e-3 (the floor of
    tests/test_fused_lmhead_ce.py:89), each line naming its blocks. dx and
    dW with a non-uniform per-row g in [0.5, 1.5] over ``_CE_GRAD_CASES``
    through ``_ce_grad_agrees``; each line names the blocks of its launch
    (and the fp32 one's column chunks); then the fp32 ones against float64
    (``_check_bwd_fp64_truth``). Adam, with and without weight decay, at an
    lr whose update spans several ulps of p: m and v at rtol 1e-5, p
    through its update in fp32 and bit for bit in bf16
    (``_adam_agrees``). The CE kernels must also allocate no [N, V]
    buffer at the training shape, nor fp32 dx and dW at the static_amp
    step's N. Returns {kernel: max abs err}."""
    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import lmhead_ce as ce

    worst = {"lmhead_ce_fwd": 0.0, "lmhead_ce_dx": 0.0, "lmhead_ce_dw": 0.0,
             "fused_adam": 0.0}
    d, v = _TRAIN["d_model"], _TRAIN["vocab_size"]
    x, w, lbl = _inputs(torch, _TRAIN_N, d, v, torch.bfloat16, seed=40)
    g = torch.full((_TRAIN_N,), 1.0 / _TRAIN_N, device="cuda")
    lse = ce.lmhead_ce_fwd(x, w, lbl)[1]
    for name, fn in (
            ("lmhead_ce_fwd", lambda: ce.lmhead_ce_fwd(x, w, lbl)),
            ("lmhead_ce_dx", lambda: ce.lmhead_ce_dx(x, w, lbl, lse, g)),
            ("lmhead_ce_dw", lambda: ce.lmhead_ce_dw(x, w, lbl, lse, g))):
        _no_big_buffer(torch, name, fn, _TRAIN_N * v * 2, "[N, V]",
                       n=_TRAIN_N, v=v)
    # the fp32 backward at the static_amp step's N (its scratch: the rows'
    # hi and lo, 2 x rows x D fp32, 201 MB for dW; an fp32 [N, V] buffer
    # would be 2.15 GB)
    x, w, lbl = _inputs(torch, _LONG_N, d, v, torch.float32, seed=41)
    g = torch.full((_LONG_N,), 1.0 / _LONG_N, device="cuda")
    lse = ce.lmhead_ce_fwd(x, w, lbl)[1]
    for name, fn in (
            ("lmhead_ce_dx", lambda: ce.lmhead_ce_dx(x, w, lbl, lse, g)),
            ("lmhead_ce_dw", lambda: ce.lmhead_ce_dw(x, w, lbl, lse, g))):
        _no_big_buffer(torch, name, fn, _LONG_N * v * 2, "[N, V]",
                       n=_LONG_N, v=v, dtype="float32")
    del x, w, lbl, lse, g
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (n, dd, vv) in enumerate(_CE_FWD_CASES):
        x, w, lbl = _inputs(torch, n, dd, vv, torch.bfloat16, seed=40 + i)
        if n > 7:  # labels outside [0, V) pick nothing
            lbl[3], lbl[7] = vv, -1
        got = ce.lmhead_ce_fwd(x, w, lbl)
        ref = ce.lmhead_ce_plain(x, w, lbl)
        torch.cuda.synchronize()
        err = _ce_fwd_agrees(torch, got, ref, lbl, vv, 2e-3,
                             f"n={n} d={dd} v={vv} bfloat16")
        worst["lmhead_ce_fwd"] = max(worst["lmhead_ce_fwd"], err)
        _say(phase="kernel_check", kernel="lmhead_ce_fwd", n=n, d=dd, v=vv,
             dtype="bfloat16", tolerance_rel=2e-3, max_abs_err=err, sms=sms,
             blocks=len(ce.sm90_fwd_blocks(n, vv, sms)))

    for i, (n, dd, vv, dtype_name) in enumerate(_CE_GRAD_CASES):
        x, w, lbl = _inputs(torch, n, dd, vv, getattr(torch, dtype_name),
                            seed=50 + i)
        if vv == 130:  # labels outside [0, V) hit no column
            lbl[3], lbl[7] = vv, -1
        g = torch.from_numpy(np.random.RandomState(60 + i).uniform(
            0.5, 1.5, n).astype(np.float32)).cuda()
        lse = ce.lmhead_ce_plain(x, w, lbl)[1]
        for name, kern, plain, rows, cols in (
                ("lmhead_ce_dx", ce.lmhead_ce_dx, ce.lmhead_ce_dx_plain, n,
                 vv),
                ("lmhead_ce_dw", ce.lmhead_ce_dw, ce.lmhead_ce_dw_plain, vv,
                 n)):
            got = kern(x, w, lbl, lse, g)
            ref = plain(x, w, lbl, lse, g)
            torch.cuda.synchronize()
            what = f"n={n} d={dd} v={vv} {dtype_name}"
            err = _ce_grad_agrees(torch, got, ref, name, what)
            worst[name] = max(worst[name], err)
            grid = (dict(blocks=len(ce.sm90_blocks(rows, dd)))
                    if dtype_name == "bfloat16" else
                    dict(blocks=len(ce.sm90_f32_bwd_blocks(rows, cols, sms)),
                         chunks=ce.sm90_f32_bwd_split(rows, cols, sms)[1]))
            _say(phase="kernel_check", kernel=name, n=n, d=dd, v=vv,
                 dtype=dtype_name, tolerance=_CE_GRAD_TOL[dtype_name],
                 max_abs_err=err, excess_over_rtol=_excess(
                     got, ref, _CE_GRAD_TOL[dtype_name][0]), sms=sms, **grid)
    for name, err in _check_bwd_fp64_truth(torch).items():
        worst[name] = max(worst[name], err)

    # the last case: a bf16 p with the fp32 gradient a global-norm clip
    # hands over (the recipe's path)
    shapes = [((v, d), torch.bfloat16, None), ((d, 4 * d), torch.float32,
                                                None),
              ((d,), torch.float32, None), ((7, 100), torch.float32, None),
              ((v, d), torch.bfloat16, torch.float32)]
    for i, (shape, dtype, g_dtype) in enumerate(shapes):
        for wd in (0.0, 0.5):
            p, g, m, vv, lr, b1p, b2p = _adam_inputs(torch, shape, dtype,
                                                     seed=70 + i,
                                                     g_dtype=g_dtype)
            ref = fa.fused_adam_plain(p, g, m, vv, lr, b1p, b2p,
                                      weight_decay=wd)
            got = fa.fused_adam(p.clone(), g, m.clone(), vv.clone(), lr, b1p,
                                b2p, weight_decay=wd)
            # p's value before its rounding to p's dtype: the plain update
            # in fp32 from the kernel's own m and v (beta1 = beta2 = 1
            # leaves them as they are; they are held against ref apart)
            pre_p = fa.fused_adam_plain(p.float(), g, got[1], got[2], lr, b1p,
                                        b2p, beta1=1.0, beta2=1.0,
                                        weight_decay=wd)[0]
            torch.cuda.synchronize()
            report = _adam_agrees(torch, p, got, pre_p, ref)
            err = max(_err(a, b) for a, b in zip(got, ref))
            worst["fused_adam"] = max(worst["fused_adam"], err)
            _say(phase="kernel_check", kernel="fused_adam", shape=list(shape),
                 dtype=str(dtype).replace("torch.", ""),
                 grad_dtype=str(g.dtype).replace("torch.", ""),
                 weight_decay=wd, max_abs_err=err, **report)
    return worst


def _adam_inputs(torch, shape, dtype, seed, device="cuda", g_dtype=None):
    """p ~ N(0, 1) in p's dtype, g ~ 0.1 N(0, 1) in ``g_dtype`` (p's by
    default), m ~ 0.01 N(0, 1), v ~ (0.01 N(0, 1))^2, lr 0.1, beta powers
    at step 3: the update is several bf16 ulps of p, and lr * wd * p at
    wd 0.5 is 5% of p."""
    r = np.random.RandomState(seed)
    host = [r.randn(*shape), 0.1 * r.randn(*shape), 0.01 * r.randn(*shape),
            np.square(0.01 * r.randn(*shape))]
    p, g, m, v = (torch.from_numpy(a.astype(np.float32)).to(device)
                  for a in host)
    return (p.to(dtype), g.to(g_dtype or dtype), m, v,
            torch.tensor(0.1, device=device),
            torch.tensor([0.9 ** 3], device=device),
            torch.tensor([0.999 ** 3], device=device))


def _adam_agrees(torch, p_in, got, pre_p, ref) -> dict:
    """Holds one fused Adam step (got = p, m, v after the kernel) against
    the plain version and raises where they differ. m and v: against the
    plain step's (ref), rtol 1e-5, atol 1e-7. p: through its update
    dp = p_out - p_in, not its value, so that a step far below p's ulp
    cannot hide a wrong update, against pre_p, the plain update in fp32
    from the kernel's own m and v (so that where m = b1 m + (1 - b1) g
    cancels, the two sides' rounding of m, already held above, does not
    count twice). The two fp32 values may differ by 1e-5 * |dp|
    (contracted multiply-adds) plus 2 fp32 ulps of p (each side rounds
    p - step once). fp32 p: dp within that. bf16 p: bit for bit the
    nearest-even rounding of pre_p, except where pre_p lies within the
    same distance of a bf16 rounding midpoint (a tie either side may
    round its own way; counted). Fails too unless the median update is at
    least 2 ulps of p in p's dtype, so that the check sees the update.
    ``p_worst``: the largest |dp error| / tolerance (fp32), the share of
    values off the nearest-even rounding (bf16)."""
    p_out, m_out, v_out = got
    _, ref_m, ref_v = ref
    p32 = p_in.float()
    dp_ref = pre_p - p32
    slack = 1e-5 * dp_ref.abs() + 2.0 ** -22 * p32.abs()
    ulp = torch.finfo(p_in.dtype).eps * p32.abs().clamp_min(1e-30)
    step_ulps = float((dp_ref.abs() / ulp).median())
    bad_mv = _beyond(m_out, ref_m, 1e-5, 1e-7) + _beyond(v_out, ref_v, 1e-5,
                                                         1e-7)
    ties = 0
    if p_in.dtype == torch.bfloat16:
        bits = pre_p.view(torch.int32)
        mid = ((bits & ~0xFFFF) | 0x8000).view(torch.float32)
        near_tie = (pre_p - mid).abs() <= slack
        off = p_out != pre_p.to(torch.bfloat16)
        ties = int((off & near_tie).sum())
        bad_p = int((off & ~near_tie).sum())
        worst = float(off.float().mean())
    else:
        over = (p_out.float() - p32 - dp_ref).abs() / slack
        bad_p = int((over > 1).sum())
        worst = float(over.max())
    report = dict(p_rule="update dp" if p_in.dtype == torch.float32
                  else "bit-exact rounding", median_step_ulps=step_ulps,
                  rounding_ties=ties, p_beyond=bad_p, mv_beyond=bad_mv,
                  p_worst=worst)
    if bad_p or bad_mv or step_ulps < 2.0:
        raise AssertionError(f"fused_adam disagrees with its plain version "
                             f"at {tuple(p_in.shape)} {p_in.dtype}: {report}")
    return report


# The flash kernels against their plain versions, (rtol, atol) each:
# |got - ref| <= atol + rtol * |ref|. fp32: out and lse at 1e-4, the
# gradients at 2e-4 (exact fp32 products summed in another order;
# tests/test_flash_attention.py holds the TPU kernel's gradients at 2e-4).
# bf16: out at 2e-2 (that file's :39: the kernel's online softmax rounds P
# against the running row max, the plain version the normalized P); lse
# at 1e-4 (fp32 sums of exact products of bf16 values); the gradients at
# one bf16 ulp (rtol 2^-7) plus atol 1e-3: both sides rebuild P from the
# same lse, round P and dS to bf16 at the same places and sum in fp32, so
# an output can differ only by one rounding flip where its fp32 value sits
# at a bf16 boundary (the card measured at most 9.8e-4, a flip near 0.2,
# and none at D = 64). tests/test_torch_smoke_checks.py shows this bound
# rejecting each fault there, among them three that 2e-2 lets through:
# P and dS left unrounded, lse stored in bf16, delta rounded to bf16.
_BF16_GRAD = (2.0 ** -7, 1e-3)
_FLASH_TOL = {"float32": dict(out=(1e-4, 1e-4), lse=(1e-4, 1e-4),
                              dq=(2e-4, 2e-4), dk=(2e-4, 2e-4),
                              dv=(2e-4, 2e-4)),
              "bfloat16": dict(out=(2e-2, 2e-2), lse=(1e-4, 1e-4),
                               dq=_BF16_GRAD, dk=_BF16_GRAD, dv=_BF16_GRAD)}
_FLASH_KERNEL = dict(out="flash_attention_fwd", lse="flash_attention_fwd",
                     dq="flash_attention_dq", dk="flash_attention_dkv",
                     dv="flash_attention_dkv")
# (dtype, layout, causal, B, H, Tq, Tk, D): the seq-2048 training shape
# of the static GPT step (BTHD, causal) and of the eager encoder
# (train_eager: BHTD, non-causal); fp32 in both layouts, causal and not; D = 128 and 256; causal Tq != Tk
# (bottom-right; the first is tests/test_flash_attention.py:62-85's); and
# sequence lengths that are not a multiple of the kernels' tiles. bf16 at
# D = 64 and 128 runs the tensor-core forward, dq and dk/dv (both layouts
# causal and not, Tq < Tk, Tq > Tk with rows that see no key, T = 1000
# and 300, and T = 333 at D = 128 in BTHD); bf16 at D = 256 the
# tensor-core forward, dq and dk/dv (both layouts causal and not, Tq >
# Tk with rows that see no key and Tq < Tk, T = 300 and 333, and
# train_d256's shape: B = 8, T = 2048, H = 3, causal, BTHD). fp32 at D =
# 64 and 128 runs the split-TF32 forward (both layouts causal and not, D
# = 128 in both layouts, Tq < Tk, Tq > Tk at both head_dims, T = 200 and
# 333, jit.load's shape: B = 1, T = 2048, H = 12, D = 64, BHTD,
# non-causal, and the fp32 training program's: B = 8, T = 2048, H = 12, D
# = 64, causal, BTHD), fp32 at D = 256 its own split-TF32 forward (both
# layouts causal and not, Tq > Tk with rows that see no key, Tq < Tk, T =
# 300 and 333, the head_dim-256 export path's shape: B = 1, T = 2048, H =
# 3, BHTD, non-causal, and the training shape at 3 heads: B = 8, causal,
# BTHD), and every fp32 case at D = 64 and 128 the split-TF32 dq and dk/dv
# (T = 320 too, whose last 64-row query tile holds no row, and the
# training shape at 6 heads of 128)
_FLASH_CASES = [
    ("bfloat16", "BTHD", True, 8, 12, 2048, 2048, 64),
    ("bfloat16", "BHTD", False, 8, 12, 2048, 2048, 64),
    ("float32", "BTHD", True, 2, 3, 256, 256, 64),
    ("float32", "BTHD", False, 2, 3, 256, 256, 64),
    ("float32", "BHTD", True, 2, 3, 256, 256, 64),
    ("float32", "BHTD", False, 2, 3, 256, 256, 64),
    ("bfloat16", "BTHD", True, 2, 4, 1024, 1024, 128),
    ("bfloat16", "BHTD", True, 2, 2, 512, 512, 256),
    ("float32", "BHTD", False, 1, 2, 300, 300, 256),
    ("float32", "BHTD", True, 1, 2, 128, 384, 64),
    ("bfloat16", "BTHD", True, 2, 2, 256, 640, 128),
    ("float32", "BTHD", True, 2, 3, 200, 200, 64),
    ("bfloat16", "BTHD", True, 1, 4, 1000, 1000, 64),
    ("bfloat16", "BHTD", True, 2, 3, 256, 256, 64),
    ("bfloat16", "BHTD", False, 2, 3, 256, 256, 64),
    ("bfloat16", "BHTD", True, 1, 2, 128, 384, 64),
    ("bfloat16", "BHTD", True, 1, 2, 384, 128, 64),
    ("bfloat16", "BHTD", False, 1, 2, 300, 300, 128),
    ("bfloat16", "BTHD", False, 2, 3, 256, 256, 64),
    ("bfloat16", "BTHD", True, 2, 2, 333, 333, 128),
    ("float32", "BTHD", False, 2, 2, 256, 256, 128),
    ("float32", "BHTD", True, 2, 2, 256, 256, 128),
    ("float32", "BHTD", True, 1, 2, 384, 128, 64),
    ("float32", "BTHD", True, 1, 2, 384, 128, 128),
    ("float32", "BTHD", True, 2, 2, 333, 333, 128),
    ("float32", "BHTD", False, 1, 12, 2048, 2048, 64),
    ("float32", "BTHD", True, 8, 12, 2048, 2048, 64),
    ("bfloat16", "BTHD", True, 8, 3, 2048, 2048, 256),
    ("bfloat16", "BTHD", False, 2, 3, 512, 512, 256),
    ("bfloat16", "BHTD", False, 1, 2, 300, 300, 256),
    ("bfloat16", "BHTD", True, 1, 2, 384, 128, 256),
    ("bfloat16", "BTHD", True, 1, 2, 128, 384, 256),
    ("bfloat16", "BTHD", True, 2, 2, 333, 333, 256),
    ("float32", "BTHD", True, 2, 2, 256, 256, 256),
    ("float32", "BHTD", True, 2, 2, 256, 256, 256),
    ("float32", "BTHD", False, 2, 3, 512, 512, 256),
    ("float32", "BHTD", True, 1, 2, 384, 128, 256),
    ("float32", "BTHD", True, 1, 2, 128, 384, 256),
    ("float32", "BTHD", True, 2, 2, 333, 333, 256),
    ("float32", "BHTD", False, 1, 3, 2048, 2048, 256),
    ("float32", "BTHD", True, 8, 3, 2048, 2048, 256),
    ("float32", "BTHD", True, 1, 2, 320, 320, 64),
    ("float32", "BHTD", False, 1, 2, 320, 320, 128),
    ("float32", "BTHD", True, 8, 6, 2048, 2048, 128),
]


def _flash_inputs(torch, b, h, tq, tk, d, dtype, layout, seed,
                  device="cuda"):
    """q, k, v and dO ~ N(0, 1) in the layout, rounded to dtype."""
    r = np.random.RandomState(seed)

    def make(t):
        shape = (b, t, h, d) if layout == "BTHD" else (b, h, t, d)
        return torch.from_numpy(r.randn(*shape).astype(np.float32)).to(
            device, dtype)

    return make(tq), make(tk), make(tk), make(tq)


def _flash_outputs(torch, q, k, v, do, causal, layout):
    """(got, ref): the wrappers' and the plain versions' out, lse, dq, dk
    and dv. Both backwards start from the plain forward's out and lse, so
    each backward kernel is held against its plain version on the same
    inputs."""
    from paddle_tpu_torch.ops import flash_attention as fl

    out, lse = fl.flash_attention_fwd(q, k, v, causal, None, layout)
    ref_out, ref_lse = fl.flash_attention_fwd_plain(q, k, v, causal, None,
                                                    layout)
    delta = fl.flash_attention_delta(ref_out, do, layout)
    args = (q, k, v, do, ref_lse, delta, causal, None, layout)
    dq = fl.flash_attention_dq(*args)
    dk, dv = fl.flash_attention_dkv(*args)
    ref_dk, ref_dv = fl.flash_attention_dkv_plain(*args)
    got = dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)
    ref = dict(out=ref_out, lse=ref_lse,
               dq=fl.flash_attention_dq_plain(*args), dk=ref_dk, dv=ref_dv)
    return got, ref


def _flash_agrees(torch, got, ref, dtype_name, what) -> dict:
    """Holds flash outputs (any of out, lse, dq, dk, dv) against the plain
    version's at ``_FLASH_TOL`` and raises naming each that disagrees or
    is not finite. Returns {kernel: max abs err}."""
    errs, bad = {}, []
    for name, want in ref.items():
        tol = _FLASH_TOL[dtype_name][name]
        have = got[name]
        err = _err(have, want)
        beyond = _beyond(have, want, *tol)
        if beyond or not torch.isfinite(have.float()).all():
            bad.append(f"{name}: {beyond} values beyond (rtol, atol) {tol}, "
                       f"max abs err {err}")
        kernel = _FLASH_KERNEL[name]
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    if bad:
        raise AssertionError(f"flash attention disagrees with its plain "
                             f"version at {what}: " + "; ".join(bad))
    return errs


def _check_flash(torch):
    """Every case of ``_FLASH_CASES`` through ``_flash_agrees``, the fp32
    forward against float64 (``_check_f32_flash_truth``), the gradient
    chain over ``_CHAIN_CASES`` through ``_flash_chain``, then
    the kernels' peak added memory at the training shape: no [B, H, T, T]
    buffer. Returns {kernel: max abs err}."""
    from paddle_tpu_torch.ops import flash_attention as fl

    worst = {}
    for i, (dtype_name, layout, causal, b, h, tq, tk, d) in enumerate(
            _FLASH_CASES):
        q, k, v, do = _flash_inputs(torch, b, h, tq, tk, d,
                                    getattr(torch, dtype_name), layout,
                                    seed=100 + i)
        got, ref = _flash_outputs(torch, q, k, v, do, causal, layout)
        torch.cuda.synchronize()
        what = (f"{dtype_name} {layout} {'causal' if causal else 'full'} "
                f"B={b} H={h} Tq={tq} Tk={tk} D={d}")
        errs = _flash_agrees(torch, got, ref, dtype_name, what)
        _no_key_rows_agree(got, causal, layout, tq, tk, what)
        for name, err in errs.items():
            worst[name] = max(worst.get(name, 0.0), err)
        _say(phase="kernel_check", kernel="flash_attention", dtype=dtype_name,
             layout=layout, causal=causal, b=b, h=h, tq=tq, tk=tk, d=d,
             tolerance=_FLASH_TOL[dtype_name],
             max_abs_err={n: _err(got[n], ref[n]) for n in ref})
        del got, ref

    _check_f32_flash_truth(torch)
    _check_f32_flash_bwd_truth(torch)
    _check_chain(torch)
    b, h, t, d = _LONG_B, _LONG["n_head"], _LONG_T, _head_dim(_LONG)
    q, k, v, do = _flash_inputs(torch, b, h, t, t, d, torch.bfloat16,
                                "BTHD", seed=99)
    out, lse = fl.flash_attention_fwd(q, k, v, True, None, "BTHD")
    delta = fl.flash_attention_delta(out, do, "BTHD")
    args = (q, k, v, do, lse, delta, True, None, "BTHD")
    shape = dict(b=b, h=h, t=t, d=d)
    limit = b * h * t * t * 2
    for name, fn in (
            ("flash_attention_fwd",
             lambda: fl.flash_attention_fwd(q, k, v, True, None, "BTHD")),
            ("flash_attention_dq", lambda: fl.flash_attention_dq(*args)),
            ("flash_attention_dkv", lambda: fl.flash_attention_dkv(*args))):
        _no_big_buffer(torch, name, fn, limit, "[B, H, T, T]", **shape)
    return worst


def _no_key_rows_agree(got, causal, layout, tq, tk, what) -> None:
    """Causal with Tq > Tk: the first Tq - Tk query rows see no key, and
    must give out exactly 0 and lse exactly -1e30, as the contract states
    (at -1e30 the relative tolerance of lse spans 1e26, and out's 2e-2
    would pass a small nonzero row)."""
    if not causal or tq <= tk:
        return
    rows = tq - tk
    out = got["out"][:, :rows] if layout == "BTHD" else \
        got["out"][:, :, :rows]
    if out.count_nonzero() or not (got["lse"][..., :rows] == -1e30).all():
        raise AssertionError(f"flash attention at {what}: a query row that "
                             f"sees no key gave a nonzero out or an lse "
                             f"other than -1e30")


# The fp32 forward (split TF32 on the tensor cores,
# csrc/flash_attention_fwd_f32_sm90.cu) against float64: its max abs error
# in out and in lse may each be at most _F32_FLASH_MULTIPLE times the plain
# fp32 version's own (full fp32 products, TF32 off), plus _F32_FLASH_ATOL,
# over _F32_FLASH_TRUTH_CASES at _F32_FLASH_SEEDS and at the fp32 training
# shape, _F32_FLASH_TRUTH_TRAIN, at _F32_FLASH_TRAIN_SEED. Why 28:
# tests/test_torch_flash_attention_f32.py emulates the kernel's arithmetic
# on the CPU -- the split, the tiles in order, the permuted keys, the
# online softmax -- with the tensor cores' fp32 sums modelled as
# truncating after every 4 products, and finds at most 13.8 times the
# plain version's error over these cases at seeds 1, 2, 7 and 8 (lse at D
# = 128, where the score sums 48 tf32 products a tile); the bound is twice
# that. A 1xTF32 emulation (hi . hi alone) lies 10.8x or more beyond it
# there, so the bound tells split TF32 from TF32. At the training shape's
# length (T = 2048, causal, BTHD, D = 64; B = 1, H = 1 on the CPU) the
# emulation lies at most 3.7 times the plain version's error (seeds 3, 7).
# The head_dim-256 kernel (csrc/flash_attention_fwd_f32_d256_sm90.cu) sums
# each 32-column box of D in a chain of its own and adds the chains in
# fp32: its emulation lies at most 2.2 times the plain version's error at
# its cases here (seeds 1, 2, 7, 8), and 1xTF32 430x or more; the bound
# stays 28 for every case.
_F32_FLASH_MULTIPLE = 28.0
_F32_FLASH_ATOL = 1e-8
# (layout, causal, B, H, Tq, Tk, D): D = 64, 128 and 256, both layouts,
# causal Tq < Tk and Tq > Tk (rows that see no key)
_F32_FLASH_TRUTH_CASES = [("BHTD", False, 1, 2, 256, 256, 64),
                          ("BTHD", True, 1, 2, 384, 384, 128),
                          ("BHTD", True, 1, 2, 128, 384, 64),
                          ("BTHD", True, 1, 2, 384, 128, 128),
                          ("BHTD", True, 1, 2, 256, 256, 256),
                          ("BTHD", True, 1, 2, 384, 128, 256)]
_F32_FLASH_SEEDS = (1, 2)
# the fp32 training program's shape (any fp32 build_train_program), and
# the same at 3 heads of 256 (the card alone: the emulation's cost)
_F32_FLASH_TRUTH_TRAIN = ("BTHD", True, 8, 12, 2048, 2048, 64)
_F32_FLASH_TRUTH_TRAIN_D128 = ("BTHD", True, 8, 6, 2048, 2048, 128)
_F32_FLASH_TRUTH_TRAIN_D256 = ("BTHD", True, 8, 3, 2048, 2048, 256)
_F32_FLASH_TRAIN_SEED = 3


def _flash_fp64_errs(torch, out, lse, q, k, v, causal, layout) -> tuple:
    """(max abs error of out, of lse) against the forward computed in
    float64 from the same fp32 inputs and the same fp32 scale; a row that
    sees no key holds out 0 and lse -1e30 as fp32 stores it."""
    from paddle_tpu_torch.ops import flash_attention as fl

    qd, kd, vd = (fl._heads_first(t, layout).double() for t in (q, k, v))
    scale = float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    s = fl._masked((qd @ kd.transpose(-1, -2)) * scale, causal,
                   float("-inf"))
    want_lse = torch.logsumexp(s, -1)
    want = torch.exp(s - want_lse[..., None]).nan_to_num(0.0) @ vd
    want_lse = want_lse.clamp_min(float(np.float32(-1e30)))
    return (float((fl._heads_first(out, layout).double() - want).abs().max()),
            float((lse.double() - want_lse).abs().max()))


def _f32_flash_truth_agrees(torch, got, plain, q, k, v, causal, layout,
                            what) -> dict:
    """Holds an fp32 forward's (out, lse) ``got`` against float64 within
    _F32_FLASH_MULTIPLE times the plain fp32 version's (``plain``) own
    error + _F32_FLASH_ATOL; raises naming each of out and lse beyond it.
    Returns {name: {err, plain_err, ratio, bound}}."""
    own = _flash_fp64_errs(torch, *plain, q, k, v, causal, layout)
    errs = _flash_fp64_errs(torch, *got, q, k, v, causal, layout)
    report, bad = {}, []
    for name, err, p in zip(("out", "lse"), errs, own):
        bound = _F32_FLASH_MULTIPLE * p + _F32_FLASH_ATOL
        report[name] = dict(err=err, plain_err=p, bound=bound,
                            ratio=err / p if p else None)
        if not err <= bound:
            bad.append(f"{name}: max abs error {err} against float64, bound "
                       f"{bound} ({_F32_FLASH_MULTIPLE} x the plain fp32 "
                       f"version's {p} + {_F32_FLASH_ATOL})")
    if bad:
        raise AssertionError(f"fp32 flash forward beyond its float64 bound "
                             f"at {what}: " + "; ".join(bad))
    return report


def _check_f32_flash_truth(torch) -> None:
    """The fp32 forward's kernel through ``_f32_flash_truth_agrees`` over
    _F32_FLASH_TRUTH_CASES at _F32_FLASH_SEEDS (the inputs the CPU test's
    emulation sets the bound on), and at the fp32 training shape at head_dim
    64 and 256."""
    from paddle_tpu_torch.ops import flash_attention as fl

    runs = [(case, seed) for case in _F32_FLASH_TRUTH_CASES
            for seed in _F32_FLASH_SEEDS]
    for (layout, causal, b, h, tq, tk, d), seed in runs + [
            (_F32_FLASH_TRUTH_TRAIN, _F32_FLASH_TRAIN_SEED),
            (_F32_FLASH_TRUTH_TRAIN_D256, _F32_FLASH_TRAIN_SEED)]:
        q, k, v, _ = _flash_inputs(torch, b, h, tq, tk, d, torch.float32,
                                   layout, seed)
        got = fl.flash_attention_fwd(q, k, v, causal, None, layout)
        plain = fl.flash_attention_fwd_plain(q, k, v, causal, None, layout)
        torch.cuda.synchronize()
        what = (f"{layout} {'causal' if causal else 'full'} B={b} H={h} "
                f"Tq={tq} Tk={tk} D={d} seed {seed}")
        report = _f32_flash_truth_agrees(torch, got, plain, q, k, v, causal,
                                         layout, what)
        _say(phase="kernel_check", kernel="flash_attention_fwd",
             dtype="float32", what="split TF32 against float64",
             layout=layout, causal=causal, b=b, h=h, tq=tq, tk=tk, d=d,
             seed=seed, multiple=_F32_FLASH_MULTIPLE, atol=_F32_FLASH_ATOL,
             **report)
        del q, k, v, got, plain


# The fp32 dq and dk/dv at head_dim 256 (split TF32 on the tensor cores,
# csrc/flash_attention_dq_f32_d256_sm90.cu and
# csrc/flash_attention_dkv_f32_d256_sm90.cu) against float64: fed the plain
# fp32 forward's lse and delta, the kernels' max abs error in each of dq,
# dk and dv against the backward computed in float64 from the same fp32
# inputs may be at most _F32_FLASH_BWD_MULTIPLE times the plain fp32
# version's own (full fp32 products, TF32 off, fed the same lse and
# delta), plus _F32_FLASH_ATOL, over the head_dim-256 cases of
# _F32_FLASH_TRUTH_CASES at _F32_FLASH_SEEDS and at
# _F32_FLASH_TRUTH_TRAIN_D256 at _F32_FLASH_TRAIN_SEED. Why 25:
# tests/test_torch_flash_attention_f32_bwd.py emulates the kernels'
# arithmetic on the CPU -- the split, the per-box chains and the traded
# partials of the scores, P and dS split, the transposed products over
# 16-row stage tiles, one accumulator a group of 128 rows (keys for dq),
# the groups added in fp32 -- with the tensor cores' fp32 sums modelled
# as truncating after every 4 products, and finds at most 12.1 times the
# plain version's error over these cases at seeds 1, 2, 7 and 8 (dv), 5.4
# at the training length (T = 2048 in one batch and head, seeds 3 and
# 7); the bound is about twice that. A 1xTF32 emulation (hi . hi alone, P
# and dS too) lies 21x or more beyond it there, so the bound tells split
# TF32 from TF32.
_F32_FLASH_BWD_MULTIPLE = 25.0
# The fp32 dq and dk/dv at head_dim 64 and 128
# (csrc/flash_attention_dq_f32_sm90.cu, csrc/flash_attention_dkv_f32_sm90.cu)
# at _F32_DKV_MULTIPLE, over the head_dim-64 and 128 cases of
# _F32_FLASH_TRUTH_CASES at _F32_FLASH_SEEDS and at _F32_FLASH_TRUTH_TRAIN
# and _F32_FLASH_TRUTH_TRAIN_D128 at _F32_FLASH_TRAIN_SEED. Why 32: the
# same emulation, with one warpgroup's chains over all of D and no trade,
# finds at most 15.4 times the plain version's error over these cases at
# seeds 1, 2, 7 and 8 (dv at D = 128, Tq = 384 > Tk = 128), 7.8 at the
# training length (T = 2048 in one batch and head, seeds 3 and 7); the
# bound is about twice that. A 1xTF32 emulation lies 14x or more beyond
# it there. The dq's emulation (each warpgroup's chains over all of D for
# its own rows) finds at most 9.0 (D = 64, seed 1) and 6.9 at the training
# length, and 1xTF32 22x or more beyond the bound: the same multiple holds
# it.
_F32_DKV_MULTIPLE = 32.0


def _f32_bwd_multiple(d) -> float:
    """The float64 bound's multiple of the fp32 backward at head_dim d."""
    return _F32_FLASH_BWD_MULTIPLE if d == 256 else _F32_DKV_MULTIPLE


def _flash_bwd_fp64(torch, q, k, v, do, causal, layout) -> dict:
    """dq, dk and dv computed in float64 from the same fp32 inputs and the
    same fp32 scale (the float64 forward's P, out and delta), in the
    inputs' layout."""
    from paddle_tpu_torch.ops import flash_attention as fl

    qd, kd, vd, dd = (fl._heads_first(t, layout).double()
                      for t in (q, k, v, do))
    scale = float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    s = fl._masked((qd @ kd.transpose(-1, -2)) * scale, causal,
                   float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, -1)[..., None]).nan_to_num(0.0)
    del s
    delta = (dd * (p @ vd)).sum(-1)
    ds = p * (dd @ vd.transpose(-1, -2) - delta[..., None])
    grads = dict(dq=(ds @ kd) * scale, dk=(ds.transpose(-1, -2) @ qd) * scale,
                 dv=p.transpose(-1, -2) @ dd)
    return {n: fl._to_layout(g, layout, torch.float64)
            for n, g in grads.items()}


def _f32_flash_bwd_truth_agrees(torch, got, plain, truth, what,
                                multiple=_F32_FLASH_BWD_MULTIPLE) -> dict:
    """Holds fp32 gradients ``got`` (dq, dk, dv) against float64
    (``truth``) within ``multiple`` (_F32_FLASH_BWD_MULTIPLE at head_dim
    256, _F32_DKV_MULTIPLE at 64 and 128: ``_f32_bwd_multiple``) times the
    plain fp32 version's (``plain``) own max abs error + _F32_FLASH_ATOL;
    raises naming each beyond it. Returns {name: {err, plain_err, ratio,
    bound}}."""
    report, bad = {}, []
    for name, want in truth.items():
        p = float((plain[name].double() - want).abs().max())
        err = float((got[name].double() - want).abs().max())
        bound = multiple * p + _F32_FLASH_ATOL
        report[name] = dict(err=err, plain_err=p, bound=bound,
                            ratio=err / p if p else None)
        if not err <= bound:
            bad.append(f"{name}: max abs error {err} against float64, bound "
                       f"{bound} ({multiple} x the plain fp32 "
                       f"version's {p} + {_F32_FLASH_ATOL})")
    if bad:
        raise AssertionError(f"fp32 flash backward beyond its float64 bound "
                             f"at {what}: " + "; ".join(bad))
    return report


def _f32_bwd_pair(torch, q, k, v, do, causal, layout) -> tuple:
    """(the wrappers', the plain versions') dq, dk, dv, both from the plain
    fp32 forward's lse and delta."""
    from paddle_tpu_torch.ops import flash_attention as fl

    out, lse = fl.flash_attention_fwd_plain(q, k, v, causal, None, layout)
    args = (q, k, v, do, lse, fl.flash_attention_delta(out, do, layout),
            causal, None, layout)
    dk, dv = fl.flash_attention_dkv(*args)
    pk, pv = fl.flash_attention_dkv_plain(*args)
    return (dict(dq=fl.flash_attention_dq(*args), dk=dk, dv=dv),
            dict(dq=fl.flash_attention_dq_plain(*args), dk=pk, dv=pv))


def _check_f32_flash_bwd_truth(torch, head_dims=(64, 128, 256)) -> None:
    """The fp32 dq and dk/dv through ``_f32_flash_bwd_truth_agrees`` at
    the cases of _F32_FLASH_TRUTH_CASES at _F32_FLASH_SEEDS (the inputs the
    CPU test's emulation sets the bound on) and at the fp32 training
    shapes at head_dim 64, 128 and 256 (_F32_FLASH_TRUTH_TRAIN,
    _F32_FLASH_TRUTH_TRAIN_D128, _F32_FLASH_TRUTH_TRAIN_D256), at the
    head_dims in ``head_dims``."""
    runs = [(case, seed) for case in _F32_FLASH_TRUTH_CASES
            for seed in _F32_FLASH_SEEDS] + [
        (train, _F32_FLASH_TRAIN_SEED) for train in (
            _F32_FLASH_TRUTH_TRAIN, _F32_FLASH_TRUTH_TRAIN_D128,
            _F32_FLASH_TRUTH_TRAIN_D256)]
    for (layout, causal, b, h, tq, tk, d), seed in (
            run for run in runs if run[0][-1] in head_dims):
        q, k, v, do = _flash_inputs(torch, b, h, tq, tk, d, torch.float32,
                                    layout, seed)
        got, plain = _f32_bwd_pair(torch, q, k, v, do, causal, layout)
        truth = _flash_bwd_fp64(torch, q, k, v, do, causal, layout)
        torch.cuda.synchronize()
        what = (f"{layout} {'causal' if causal else 'full'} B={b} H={h} "
                f"Tq={tq} Tk={tk} D={d} seed {seed}")
        report = _f32_flash_bwd_truth_agrees(torch, got, plain, truth, what,
                                             _f32_bwd_multiple(d))
        _say(phase="kernel_check", kernel="flash_attention_dq_dkv",
             dtype="float32", what="split TF32 against float64",
             layout=layout, causal=causal, b=b, h=h, tq=tq, tk=tk, d=d,
             seed=seed, multiple=_f32_bwd_multiple(d),
             atol=_F32_FLASH_ATOL, **report)
        del q, k, v, do, got, plain, truth
        torch.cuda.empty_cache()


# The gradient chain (forward, delta, dq, dk/dv) against its fp32 truth:
# the kernel chain's relative Frobenius error in each of dq, dk and dv may
# be at most _CHAIN_MULTIPLE times the plain bf16 chain's own, plus
# _CHAIN_ATOL. Why 2: both chains round P, dS and each output to bf16 at
# the same places, so each lies about as far from the truth; the kernel
# chain adds its own last-bit differences (P rounded against the running
# row max in the forward, exp2 for exp, another order of fp32 sums), which
# are independent of and no larger than those roundings, so its error
# stays near sqrt(2) times the plain chain's at most. A dropped tile, a
# wrong row of delta or lse, or a mask off the diagonal moves a gradient
# by a sizeable share of its norm, far beyond twice a bf16 rounding error.
# tests/test_torch_smoke_checks.py shows the bound passing the plain and
# a kernel-way chain and rejecting a dropped key tile in dk and delta
# taken from the wrong row.
_CHAIN_MULTIPLE = 2.0
_CHAIN_ATOL = 1e-3
# (B, H, T, D, layout) of the chain check, causal bf16: the seq-2048
# training shape, BHTD at head_dim 128, and train_d256's shape (gpt2s's
# width in 3 heads of 256)
_CHAIN_CASES = [(_LONG_B, _LONG["n_head"], _LONG_T, 64, "BTHD"),
                (2, 4, 1024, 128, "BHTD"),
                (_LONG_B, 3, _LONG_T, 256, "BTHD")]
# the same chain in fp32 at train_d256's shape (train_f32_d256's: the
# split-TF32 forward, dq and dk/dv at head_dim 256) and at the fp32
# training shape at head_dim 64 (static_amp's undecorated program: the
# split-TF32 forward, dq and dk/dv) and 128, held to the chain
# computed in float64 within _CHAIN_MULTIPLE times the plain fp32 chain's
# own relative error, plus _CHAIN_ATOL
_F32_CHAIN_CASES = [(_LONG_B, 3, _LONG_T, 256, "BTHD"),
                    (_LONG_B, _LONG["n_head"], _LONG_T, 64, "BTHD"),
                    (_LONG_B, 6, _LONG_T, 128, "BTHD")]


def _plain_chain(q, k, v, do, causal, layout) -> dict:
    """dq, dk, dv of the plain chain: the plain forward's out and lse,
    delta, the plain dq and dk/dv, in the inputs' dtype."""
    from paddle_tpu_torch.ops import flash_attention as fl

    out, lse = fl.flash_attention_fwd_plain(q, k, v, causal, None, layout)
    args = (q, k, v, do, lse, fl.flash_attention_delta(out, do, layout),
            causal, None, layout)
    dk, dv = fl.flash_attention_dkv_plain(*args)
    return dict(dq=fl.flash_attention_dq_plain(*args), dk=dk, dv=dv)


def _kernel_chain(q, k, v, do, causal, layout) -> dict:
    """dq, dk, dv as the training step makes them: the wrappers' forward,
    delta from its out, the wrappers' dq and dk/dv from its lse."""
    from paddle_tpu_torch.ops import flash_attention as fl

    out, lse = fl.flash_attention_fwd(q, k, v, causal, None, layout)
    args = (q, k, v, do, lse, fl.flash_attention_delta(out, do, layout),
            causal, None, layout)
    dk, dv = fl.flash_attention_dkv(*args)
    return dict(dq=fl.flash_attention_dq(*args), dk=dk, dv=dv)


def _rel_err(got, truth) -> float:
    """||got - truth||_F / ||truth||_F, summed in fp64."""
    diff = (got.double() - truth.double()).norm()
    return float(diff / truth.double().norm().clamp_min(1e-300))


def _chain_agrees(torch, got, plain, truth, what) -> dict:
    """Holds a gradient chain (``got``: dq, dk, dv) against the fp32
    ``truth`` within _CHAIN_MULTIPLE times the plain bf16 chain's own
    relative Frobenius error, plus _CHAIN_ATOL; raises naming each
    gradient that lies beyond or is not finite. Returns the report: each
    gradient's errors, bound and max abs errors."""
    report, bad = {}, []
    for name in ("dq", "dk", "dv"):
        own = _rel_err(plain[name], truth[name])
        err = _rel_err(got[name], truth[name])
        bound = _CHAIN_MULTIPLE * own + _CHAIN_ATOL
        report[name] = dict(rel_err=err, plain_rel_err=own, bound=bound,
                            max_abs_err=_err(got[name], truth[name]),
                            plain_max_abs_err=_err(plain[name], truth[name]))
        if not err <= bound or not torch.isfinite(got[name].float()).all():
            bad.append(f"{name}: relative error {err} against the fp32 "
                       f"chain, bound {bound} ({_CHAIN_MULTIPLE} x the plain "
                       f"bf16 chain's {own} + {_CHAIN_ATOL})")
    if bad:
        raise AssertionError(f"flash gradient chain beyond its bound at "
                             f"{what}: " + "; ".join(bad))
    return report


def _check_chain(torch) -> None:
    """``_flash_chain`` over ``_CHAIN_CASES`` (causal, bf16) and
    ``_F32_CHAIN_CASES`` (causal, fp32)."""
    cases = [(c, torch.bfloat16) for c in _CHAIN_CASES] + [
        (c, torch.float32) for c in _F32_CHAIN_CASES]
    for i, ((b, h, t, d, layout), dtype) in enumerate(cases):
        q, k, v, do = _flash_inputs(torch, b, h, t, t, d, dtype, layout,
                                    seed=98 + i)
        _flash_chain(torch, q, k, v, do, True, layout, b=b, h=h, t=t, d=d)
        del q, k, v, do
        torch.cuda.empty_cache()


def _flash_chain(torch, q, k, v, do, causal, layout, **shape) -> None:
    """The kernel chain (``_kernel_chain``, as the training step runs it)
    against the truth, the plain chain run in fp32 on the same bf16
    inputs (on fp32 inputs, the chain computed in float64), through
    ``_chain_agrees``."""
    got = _kernel_chain(q, k, v, do, causal, layout)
    plain = _plain_chain(q, k, v, do, causal, layout)
    if q.dtype == torch.float32:
        truth = _flash_bwd_fp64(torch, q, k, v, do, causal, layout)
    else:
        truth = _plain_chain(*(t.float() for t in (q, k, v, do)), causal,
                             layout)
    torch.cuda.synchronize()
    what = f"{layout} {'causal' if causal else 'full'} {shape}"
    report = _chain_agrees(torch, got, plain, truth, what)
    _say(phase="kernel_check", kernel="flash_attention_chain", **shape,
         dtype=str(q.dtype).replace("torch.", ""), layout=layout,
         causal=causal, what="dq, dk, dv from the kernel forward's out and "
         "lse against the fp32 chain (float64 for fp32 inputs)",
         multiple=_CHAIN_MULTIPLE,
         atol=_CHAIN_ATOL, **report)


def _head_dim(config) -> int:
    return config["d_model"] // config["n_head"]


def _bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / _PEAK_BYTES_PER_S
    t_ops = flops / _PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _time_training_kernels(torch, card):
    """Kernel, plain, library and bound at the training shapes (bf16,
    D = 768, V = 32768; g = 1/N, what mean() hands the loss; Adam on
    gpt.wte): the CE forward, dx and dW at N = 8 x 512 and 8 x 2048 (the
    seq-2048 step's N) tokens. Bounds count each input read once and each
    output written once, and the function's FLOPs: 2NVD for the forward,
    4NVD for dx and for dW (the score tile, then the product with the
    d-logits; the bf16 kernels build the score tile once per D half, 6NVD
    at D = 768). ``tflops``: the function's FLOPs over the kernel's time;
    ``over_library``: the kernel's time over the library call's. Returns
    {kernel: row}, each at N = 8 x 2048 under (kernel, "long")."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import lmhead_ce as ce

    d, v = _TRAIN["d_model"], _TRAIN["vocab_size"]
    rows = {}
    for n in (_TRAIN_N, _LONG_N):
        x, w, lbl = _inputs(torch, n, d, v, torch.bfloat16, seed=80)
        g = torch.full((n,), 1.0 / n, device="cuda")
        lse = ce.lmhead_ce_fwd(x, w, lbl)[1]

        def library_fwd():
            return F.cross_entropy(x @ w.t(), lbl, reduction="none")

        xr = x.detach().requires_grad_(True)
        wr = w.detach().requires_grad_(True)
        lib_loss = F.cross_entropy(xr @ wr.t(), lbl, reduction="none")

        def library_grad(*wrt):
            return lambda: torch.autograd.grad(lib_loss, wrt, g,
                                               retain_graph=True)

        io = (n * d + v * d) * 2 + 8 * n
        flops = 4.0 * n * v * d
        specs = [
            ("lmhead_ce_dx", lambda: ce.lmhead_ce_dx(x, w, lbl, lse, g),
             lambda: ce.lmhead_ce_dx_plain(x, w, lbl, lse, g),
             library_grad(xr),
             _bound_ms(io + 8 * n + 2 * n * d, flops, "bfloat16")),
            ("lmhead_ce_dw", lambda: ce.lmhead_ce_dw(x, w, lbl, lse, g),
             lambda: ce.lmhead_ce_dw_plain(x, w, lbl, lse, g),
             library_grad(wr),
             _bound_ms(io + 8 * n + 2 * v * d, flops, "bfloat16")),
        ]
        specs.insert(0, (
            "lmhead_ce_fwd", lambda: ce.lmhead_ce_fwd(x, w, lbl),
            lambda: ce.lmhead_ce_plain(x, w, lbl), library_fwd,
            _bound_ms(io + 4 * n, 2.0 * n * v * d, "bfloat16")))
        both_ms = _median_ms(torch, library_grad(xr, wr))
        for name, kern, plain, library, (bound, by) in specs:
            row = dict(phase="kernel_time", kernel=name, n=n, d=d, v=v,
                       dtype="bfloat16", kernel_ms=_median_ms(torch, kern),
                       plain_ms=_median_ms(torch, plain),
                       library_ms=_median_ms(torch, library), bound_ms=bound,
                       bound_by=by, repeats=_REPEATS, card=card)
            if name == "lmhead_ce_fwd":
                row["library"] = "F.cross_entropy(x @ w.t())"
                row["tflops"] = flops / 2 / row["kernel_ms"] / 1e9
            else:
                row["library"] = ("autograd.grad of F.cross_entropy(x @ "
                                  "w.t()) for this gradient alone")
                row["library_dx_dw_ms"] = both_ms
                row["tflops"] = flops / row["kernel_ms"] / 1e9
            row["over_library"] = row["kernel_ms"] / row["library_ms"]
            _say(**row)
            rows[name if n == _TRAIN_N else (name, "long")] = row
        del lib_loss, xr, wr, x, w

    numel = v * d
    p = (torch.randn(v, d, device="cuda") * 0.02).to(torch.bfloat16)
    gg = (torch.randn(v, d, device="cuda") * 1e-3).to(torch.bfloat16)
    m = torch.zeros(v, d, device="cuda")
    vv = torch.zeros(v, d, device="cuda")
    lr = torch.tensor(1e-4, device="cuda")
    b1p = torch.tensor([0.9], device="cuda")
    b2p = torch.tensor([0.999], device="cuda")
    p32 = torch.nn.Parameter(p.float())
    p32.grad = gg.float()
    opt = torch.optim.Adam([p32], lr=1e-4, fused=True)
    bound, by = _bound_ms(numel * 22, 15.0 * numel, "float32")
    row = dict(phase="kernel_time", kernel="fused_adam", shape=[v, d],
               dtype="bfloat16",
               kernel_ms=_median_ms(torch, lambda: fa.fused_adam(
                   p, gg, m, vv, lr, b1p, b2p)),
               plain_ms=_median_ms(torch, lambda: fa.fused_adam_plain(
                   p, gg, m, vv, lr, b1p, b2p)),
               library_ms=_median_ms(torch, opt.step),
               library="torch.optim.Adam(fused=True).step on an fp32 tensor "
                       "of the same shape",
               bound_ms=bound, bound_by=by, repeats=_REPEATS, card=card)
    _say(**row)
    rows["fused_adam"] = row
    return rows


_F32_REPEATS = 5  # the fp32 CE backward takes tens of ms a call at N 16384


def _time_ce_f32(torch, card):
    """The CE forward, dx and dW on their fp32 routes (split TF32 on the
    tensor cores) at the
    ``static_amp`` step's shape: N = 8 x 2048, D = 768, V = 32768, where
    the rewritten program feeds them fp32 (``fused_lm_head_ce`` is on
    neither AMP list). First each kernel against its plain version on the
    same inputs: the forward through ``_ce_fwd_agrees`` at 1e-4, dx and
    dW with a non-uniform per-row g in [0.5, 1.5] through
    ``_ce_grad_agrees`` (fp32 ``_CE_GRAD_TOL``); the vocabulary split and
    the block grid depend on N and V, and the phase's own checks put these
    kernels on both sides. Then kernel, plain and library
    (``F.cross_entropy(x @ w.t())`` in fp32 with TF32 off, and its
    gradient) by CUDA events, median of ``_F32_REPEATS``, with g = 1/N.
    Bounds: at three tf32 products a product on the tensor cores, the way
    the kernels compute (6NVD FLOPs for the forward, 12NVD for dx and for
    dW, at 494.7 TFLOP/s), with ``bound_fma_ms`` beside them (2NVD and 4NVD
    at the FMA units' 67 TFLOP/s) and ``tflops_tf32``, the tf32 FLOPs over
    the kernel's time. Returns {kernel: row}, each with its
    ``max_abs_err``."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import lmhead_ce as ce

    n, d, v = _LONG_N, _TRAIN["d_model"], _TRAIN["vocab_size"]
    x, w, lbl = _inputs(torch, n, d, v, torch.float32, seed=81)
    lse = ce.lmhead_ce_fwd(x, w, lbl)[1]
    what = f"n={n} d={d} v={v} float32"
    plain_fwd = ce.lmhead_ce_plain(x, w, lbl)
    errs = {"lmhead_ce_fwd": _ce_fwd_agrees(
        torch, ce.lmhead_ce_fwd(x, w, lbl), plain_fwd, lbl, v, 1e-4, what)}
    plain_lse = plain_fwd[1]
    g = torch.from_numpy(np.random.RandomState(82).uniform(
        0.5, 1.5, n).astype(np.float32)).cuda()
    for name, kern, plain in (
            ("lmhead_ce_dx", ce.lmhead_ce_dx, ce.lmhead_ce_dx_plain),
            ("lmhead_ce_dw", ce.lmhead_ce_dw, ce.lmhead_ce_dw_plain)):
        got = kern(x, w, lbl, plain_lse, g)
        ref = plain(x, w, lbl, plain_lse, g)
        torch.cuda.synchronize()
        errs[name] = _ce_grad_agrees(torch, got, ref, name, what)
        del got, ref
    for name, err in errs.items():
        _say(phase="kernel_check", kernel=name, n=n, d=d, v=v,
             dtype="float32", max_abs_err=err, path="static_amp")

    g = torch.full((n,), 1.0 / n, device="cuda")
    xr = x.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)
    lib_loss = F.cross_entropy(xr @ wr.t(), lbl, reduction="none")

    def library_grad(*wrt):
        return lambda: torch.autograd.grad(lib_loss, wrt, g,
                                           retain_graph=True)

    io = (n * d + v * d) * 4 + 8 * n
    flops = 4.0 * n * v * d
    specs = [
        ("lmhead_ce_fwd", lambda: ce.lmhead_ce_fwd(x, w, lbl),
         lambda: ce.lmhead_ce_plain(x, w, lbl),
         lambda: F.cross_entropy(x @ w.t(), lbl, reduction="none"),
         _bound_ms(io + 4 * n, 6.0 * n * v * d, "tfloat32")),
        ("lmhead_ce_dx", lambda: ce.lmhead_ce_dx(x, w, lbl, lse, g),
         lambda: ce.lmhead_ce_dx_plain(x, w, lbl, lse, g), library_grad(xr),
         _bound_ms(io + 8 * n + 4 * n * d, 3 * flops, "tfloat32")),
        ("lmhead_ce_dw", lambda: ce.lmhead_ce_dw(x, w, lbl, lse, g),
         lambda: ce.lmhead_ce_dw_plain(x, w, lbl, lse, g), library_grad(wr),
         _bound_ms(io + 8 * n + 4 * v * d, 3 * flops, "tfloat32")),
    ]
    fma = {"lmhead_ce_fwd": (io + 4 * n, 2.0 * n * v * d),
           "lmhead_ce_dx": (io + 8 * n + 4 * n * d, flops),
           "lmhead_ce_dw": (io + 8 * n + 4 * v * d, flops)}
    rows = {}
    for name, kern, plain, library, (bound, by) in specs:
        row = dict(phase="kernel_time_f32", kernel=name, n=n, d=d, v=v,
                   dtype="float32",
                   kernel_ms=_median_ms(torch, kern, repeats=_F32_REPEATS),
                   plain_ms=_median_ms(torch, plain, repeats=_F32_REPEATS),
                   library_ms=_median_ms(torch, library,
                                         repeats=_F32_REPEATS),
                   bound_ms=bound, bound_by=by, max_abs_err=errs[name],
                   repeats=_F32_REPEATS, card=card)
        row["bound_fma_ms"] = _bound_ms(*fma[name], "float32")[0]
        row["tflops_tf32"] = 3 * fma[name][1] / row["kernel_ms"] / 1e9
        if name == "lmhead_ce_fwd":
            row["library"] = "F.cross_entropy(x @ w.t()), fp32, TF32 off"
        else:
            row["library"] = ("autograd.grad of F.cross_entropy(x @ w.t()) "
                              "for this gradient alone, fp32, TF32 off")
        row["over_library"] = row["kernel_ms"] / row["library_ms"]
        _say(**row)
        rows[name] = row
    del lib_loss, xr, wr, x, w
    return rows


def _time_flash(torch, card, layout="BTHD", causal=True, dtype=None,
                batch=_LONG_B, repeats=_REPEATS, heads=_LONG["n_head"],
                device=False):
    """Kernel, plain, library and bound of the flash kernels at the
    seq-2048 training shape (B = 8, T = 2048, H = 12, D = 64, bf16), in
    ``layout``: causal BTHD is the static GPT step's, non-causal BHTD the
    eager encoder's (``train_eager``). Library:
    F.scaled_dot_product_attention on BHTD tensors (views of BTHD ones)
    for the forward, autograd.grad of that call for dq alone and for (dk,
    dv) alone, with the time of all three beside them. Bounds: each input
    read once, each output written once (lse and delta fp32), and 2*D
    FLOPs per visible score entry for each product of the kernel's own
    algorithm: 2 for the forward, 3 for dq (scores, dP, dS k), 4 for
    dk/dv (scores, dP, P^T dO, dS^T q). Each row also carries ``tflops``
    (those FLOPs over its time) and ``over_library`` (its time over the
    library call's). ``dtype`` (bf16 by default), ``batch`` and ``heads``
    (head_dim = 768 / heads) set the shape: fp32 at batch 1, BHTD,
    non-causal is ``jit.load``'s fp32 program (in 6 heads, its head_dim
    128 twin; in 3 heads, head_dim 256, the ``jit_load_d256`` leg's), fp32
    at batch 8, BTHD, causal the fp32 training program's, bf16 in 3 heads
    (head_dim 256) train_d256's (the head_dim-256 forward, dq and dk/dv
    on the tensor cores), and in fp32 train_f32_d256's. The fp32 kernels
    run on the tensor cores in split TF32 in every role and at every
    head_dim, bounded at three tf32 products a product at 494.7 TFLOP/s
    (``bound_fma_ms``, its FLOPs at 67, beside it, and ``bound_share``). With ``device``, each row also carries its kernel's and the
    library call's device ms a call in a warm trace of 10 calls
    (``kernel_device_ms``, ``library_device_ms``; ``_device_ms``: without
    the host's time to launch, which a CUDA-event time of one call holds;
    None where a trace lost a marker)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import flash_attention as fl

    dtype = dtype or torch.bfloat16
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    b, h, t, d = batch, heads, _LONG_T, _LONG["d_model"] // heads
    q, k, v, do = _flash_inputs(torch, b, h, t, t, d, dtype, layout,
                                seed=90)
    out, lse = fl.flash_attention_fwd(q, k, v, causal, None, layout)
    delta = fl.flash_attention_delta(out, do, layout)
    args = (q, k, v, do, lse, delta, causal, None, layout)

    def heads_first(x):
        return x.transpose(1, 2) if layout == "BTHD" else x

    def sdpa(a, bb, c):
        return F.scaled_dot_product_attention(
            heads_first(a), heads_first(bb), heads_first(c),
            is_causal=causal)

    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
    lib_out = sdpa(qr, kr, vr)

    def library_grad(*wrt):
        return lambda: torch.autograd.grad(lib_out, wrt, heads_first(do),
                                           retain_graph=True)

    # FLOPs of one product: 2 D per visible score entry, T (T + 1) / 2 of
    # them in each (batch, head) under the causal mask, T^2 without it
    product = 2.0 * d * b * h * (t * (t + 1) // 2 if causal else t * t)
    io = b * t * h * d * dtype.itemsize  # bytes of one q-sized tensor
    stats = b * h * t * 4   # bytes of one fp32 row-stat tensor
    specs = [  # name, kernel, plain, library, products, bytes
        ("flash_attention_fwd",
         lambda: fl.flash_attention_fwd(q, k, v, causal, None, layout),
         lambda: fl.flash_attention_fwd_plain(q, k, v, causal, None, layout),
         lambda: sdpa(q, k, v), 2, 4 * io + stats),
        ("flash_attention_dq", lambda: fl.flash_attention_dq(*args),
         lambda: fl.flash_attention_dq_plain(*args), library_grad(qr), 3,
         5 * io + 2 * stats),
        ("flash_attention_dkv", lambda: fl.flash_attention_dkv(*args),
         lambda: fl.flash_attention_dkv_plain(*args), library_grad(kr, vr),
         4, 6 * io + 2 * stats),
    ]
    all_ms = _median_ms(torch, library_grad(qr, kr, vr), repeats=repeats)
    rows = {}
    for name, kern, plain, library, products, nbytes in specs:
        split = dname == "float32"
        bound, by = _bound_ms(nbytes, products * product * (3 if split else 1),
                              "tfloat32" if split else dname)
        row = dict(phase="kernel_time", kernel=name, b=b, t=t, h=h, d=d,
                   dtype=dname, layout=layout, causal=causal,
                   kernel_ms=_median_ms(torch, kern, repeats=repeats),
                   plain_ms=_median_ms(torch, plain, repeats=repeats),
                   library_ms=_median_ms(torch, library, repeats=repeats),
                   bound_ms=bound, bound_by=by, flops=products * product,
                   bytes=nbytes, repeats=repeats, card=card)
        row["tflops"] = products * product / row["kernel_ms"] / 1e9
        row["over_library"] = row["kernel_ms"] / row["library_ms"]
        if device:
            row["kernel_device_ms"] = _device_ms(torch, kern)
            row["library_device_ms"] = _device_ms(torch, library)
        if split:
            row["bound_fma_ms"] = _bound_ms(nbytes, products * product,
                                            "float32")[0]
            row["tflops_tf32"] = 3 * row["tflops"]
            row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        if name == "flash_attention_fwd":
            row["library"] = (f"F.scaled_dot_product_attention(is_causal="
                              f"{causal}) on BHTD tensors")
        else:
            row["library"] = ("autograd.grad of F.scaled_dot_product_attention"
                              " for this pass's gradients alone")
            row["library_dq_dk_dv_ms"] = all_ms
        _say(**row)
        rows[name] = row
    return rows


def _train_program(config, batch, seq):
    """(main, startup, io): bench.py's GPT training program with
    Adam(1e-4) (``io["optimizer"]``), built under a fresh unique-name
    generator, so that two builds (bf16 and fp32) name their persistables
    alike."""
    from paddle_tpu_torch.framework import program_guard, unique_name
    from paddle_tpu_torch.models.gpt import GPTConfig, build_train_program
    from paddle_tpu_torch.optimizer import Adam

    with unique_name.guard():
        main, startup, io = build_train_program(GPTConfig(**config),
                                                batch=batch, seq=seq)
        with program_guard(main, startup):
            io["optimizer"] = Adam(learning_rate=_LR)
            io["optimizer"].minimize(io["loss"])
    if io["lm_head_impl"] != "pallas":
        raise AssertionError(f"loss path {io['lm_head_impl']!r}, not the "
                             f"fused kernels")
    return main, startup, io


def _fixed_batch(torch, vocab, batch, seq, device="cuda"):
    """bench.py:60-65's fixed batch: tokens and labels from seed 0."""
    r = np.random.RandomState(0)
    return {k: torch.from_numpy(r.randint(0, vocab, (batch, seq)).astype(
        np.int64)).to(device) for k in ("tokens", "labels")}


def _executor(device):
    from paddle_tpu_torch.framework import CPUPlace, Executor

    return Executor(CPUPlace() if device == "cpu" else None)


def _losses(program, start, feed, device, steps, dtype=None):
    """The loss of each of ``steps`` steps of ``program`` (main, startup,
    io) from the persistables ``start`` ({name: tensor}, cloned, cast to
    ``dtype`` where given) on ``device``."""
    from paddle_tpu_torch.framework import Scope

    main, _, io = program
    scope = Scope()
    for name, t in start.items():
        scope.set(name, t.to(dtype).clone() if dtype else t.clone())
    exe = _executor(device)
    return [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                          scope=scope)[0]) for _ in range(steps)]


@contextlib.contextmanager
def _plain_ce():
    """The three CE kernels (forward, dx, dW) replaced by their plain
    versions inside the wrappers, for the yardstick run Y of the loss band
    and nothing else; undone on exit, which also fails unless the CE
    kernels' launch counts stayed at 0 meanwhile."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    saved = ce._launch, ce._launch_dx, ce._launch_dw
    ce.reset_launches()
    ce._launch = ce.lmhead_ce_plain
    ce._launch_dx, ce._launch_dw = ce.lmhead_ce_dx_plain, ce.lmhead_ce_dw_plain
    try:
        yield
    finally:
        ce._launch, ce._launch_dx, ce._launch_dw = saved
    counts = ce.launches, ce.dx_launches, ce.dw_launches
    if counts != (0, 0, 0):
        raise AssertionError(f"CE kernels launched during the plain run: "
                             f"{counts}")


def _band_runs(torch, config, batch, seq, start, feed, device="cuda",
               steps=_WARM_STEPS + _TIMED_STEPS) -> dict:
    """The loss band's two reference trajectories from the initial
    persistables ``start`` of the bf16 main path: Y, the same bf16 program
    with the CE kernels replaced by their plain versions (``_plain_ce``),
    and T, the truth, the program in fp32 (TF32 off: every kernel on its
    fp32 route) from ``start`` cast up. Returns their losses and walls."""
    out = {}
    t0 = time.perf_counter()
    with _plain_ce():
        out["Y"] = _losses(_train_program(config, batch, seq), start, feed,
                           device, steps)
    t1 = time.perf_counter()
    out["T"] = _losses(_train_program(dict(config, dtype="float32"), batch,
                                      seq), start, feed, device, steps,
                       torch.float32)
    out["wall_s"] = {"Y": t1 - t0, "T": time.perf_counter() - t1}
    return out


# C2, the seq-512 loss band. K (the main path: bf16, the kernels), T (the
# truth: the same program in fp32 with TF32 off, every kernel on its fp32
# route) and Y (the yardstick: bf16 with the three CE kernels replaced by
# their plain versions) train 13 steps on the fixed batch from the same
# initial parameters (T's cast up to fp32). At every step t
#     |K_t - T_t| <= _BAND_MULTIPLE * max_{s <= t} |Y_s - T_s| + _BAND_ATOL.
# Why 2: K and Y run the same bf16 program and differ only in the CE
# kernels' own last-bit differences (another order of fp32 sums, exp2f for
# exp, d-logits rounded to bf16 at a boundary the other way); the bf16
# rounding of the whole model, which moves both away from T, is shared. So
# K should lie about as far from T as Y does, at most sqrt(2) times as far
# if the CE differences were as large as all of bf16's and independent of
# them; 2 leaves room above that. The running max keeps the band from
# closing where Y's trajectory happens to cross T's. Why 1e-3: at step 1
# (no update yet) K and Y differ only in the CE forward's summation order,
# about 1e-5 of a mean loss near 10.5, while |Y - T| may be small; 1e-3 is
# the last digit the loss is read to. A CE kernel that drops a vocabulary
# tile, picks the wrong logit or rebuilds the d-logits from the wrong lse
# moves every step's loss in one direction and leaves the band within a
# few steps (tests/test_torch_smoke_checks.py shows a dropped tile
# rejected and the plain and a reordered CE accepted).
_BAND_MULTIPLE = 2.0
_BAND_ATOL = 1e-3


def _loss_band(k, t, y) -> dict:
    """Holds trajectory ``k`` to the band around the truth ``t`` that the
    yardstick ``y`` sets (the rule above); raises naming the steps outside
    it, or if a loss is not finite or the lengths differ. Returns the
    report: the three trajectories, each step's bound and distance, and the
    worst ratio of distance to bound."""
    if not (len(k) == len(t) == len(y)) or not all(
            np.isfinite(k + t + y)):
        raise AssertionError(f"loss band: trajectories not finite or of "
                             f"unequal length: K {k}, T {t}, Y {y}")
    reach, bounds, dists = 0.0, [], []
    for kt, tt, yt in zip(k, t, y):
        reach = max(reach, abs(yt - tt))
        bounds.append(_BAND_MULTIPLE * reach + _BAND_ATOL)
        dists.append(abs(kt - tt))
    ratios = [dd / b for dd, b in zip(dists, bounds)]
    report = dict(K=k, T=t, Y=y, bound=bounds, k_to_t=dists,
                  worst_ratio=max(ratios), multiple=_BAND_MULTIPLE,
                  atol=_BAND_ATOL)
    outside = [i + 1 for i, r in enumerate(ratios) if not r <= 1.0]
    if outside:
        raise AssertionError(f"loss band: K lies outside the band at steps "
                             f"{outside}: {report}")
    return report


@contextlib.contextmanager
def _eager():
    """PADDLE_TPU_EAGER=1 inside: the card runs op by op (the eager leg
    E of a replay-versus-eager comparison); restored on exit."""
    saved = os.environ.get("PADDLE_TPU_EAGER")
    os.environ["PADDLE_TPU_EAGER"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PADDLE_TPU_EAGER", None)
        else:
            os.environ["PADDLE_TPU_EAGER"] = saved


def _lr_schedule(steps, first=_LR, last=_LAST_LR):
    """The learning rate of each step: ``first``, then ``last`` at the
    last step (see ``_LAST_LR``)."""
    return [first] * (steps - 1) + [last]


def _trajectory(exe, scope, program, feed, lrs) -> dict:
    """Runs one step per entry of ``lrs`` (the optimizer's rate set
    before each) and returns the trajectory: each step's loss, its
    learning rate read back from the device (the step's own copy, which
    a graph reads), the beta1 power of ``gpt.wte`` after it and its host
    wall; then every persistable of ``scope`` (``state``) and the
    executor's runs by phase over these steps."""
    main, _, io = program
    opt = io["optimizer"]
    b1p = next(n for n in scope.local_var_names()
               if n.startswith("gpt.wte_beta1_pow"))
    before = dict(exe.phases)
    out = {"losses": [], "lr": [], "beta1_pow": [], "step_s": []}
    for lr in lrs:
        opt.set_lr(lr)
        t0 = time.perf_counter()
        loss, got_lr = exe.run(main, feed=feed, scope=scope,
                               fetch_list=[io["loss"], opt._lr_var])
        out["step_s"].append(time.perf_counter() - t0)  # numpy: synced
        out["losses"].append(float(loss))
        out["lr"].append(float(got_lr))
        out["beta1_pow"].append(float(scope.get(b1p).reshape(-1)[0]))
    out["state"] = {n: scope.get(n) for n in sorted(scope.local_var_names())}
    out["phases"] = {k: exe.phases[k] - before[k] for k in before}
    return out


def _leg(program, start, feed, device, lrs, staged=False):
    """``_trajectory`` of ``program`` from the persistables ``start``
    ({name: tensor}, cloned) in a fresh scope and executor on
    ``device`` (``staged``: the compiled route on the CPU)."""
    from paddle_tpu_torch.framework import Scope

    scope = Scope()
    for name, t in start.items():
        scope.set(name, t.clone())
    exe = _executor(device)
    exe.staged = staged
    return _trajectory(exe, scope, program, feed, lrs)


def _beta_pows(b1p0, beta1, steps):
    """The beta1 power after each of ``steps`` steps from ``b1p0``: the
    previous one times ``beta1``, each product rounded to fp32 as the
    card's in-place multiply rounds it."""
    want, b = [], np.float32(b1p0)
    for _ in range(steps):
        b = np.float32(b * np.float32(beta1))
        want.append(float(b))
    return want


def _unequal(a, b):
    """Names whose tensors differ (or exist on one side only)."""
    return sorted(n for n in set(a) | set(b)
                  if n not in a or n not in b or not a[n].equal(b[n]))


def _replay_agrees(r, e, lrs, b1p0, beta1=0.9, again=None) -> dict:
    """Holds the replayed trajectory ``r`` (``_trajectory``) against the
    eager one ``e`` from the same start: each step's learning rate as
    read back from the device is the schedule's ``lrs`` on both (a rate
    frozen into a graph stays at the captured one); each step's beta1
    power is ``b1p0`` times ``beta1``, once a step (``_beta_pows``), on
    both (a step applied twice or never is off by one); the losses and
    every persistable after the last step equal bit for bit. A loss or
    persistable that differs is accepted only where ``again``, a second
    eager trajectory from the same start, differs from ``e`` at the same
    step or in the same persistable (the cause is then eager's own
    run-to-run variation, named in the report); raises otherwise.
    Returns the report."""
    steps = len(lrs)
    if not all(len(t[k]) == steps for t in (r, e)
               for k in ("losses", "lr", "beta1_pow")):
        raise AssertionError(f"replay vs eager: trajectories of another "
                             f"length than the {steps} steps")
    want_b = _beta_pows(b1p0, beta1, steps)
    for leg, t in (("replay", r), ("eager", e)):
        lr = [float(np.float32(x)) for x in lrs]
        if t["lr"] != lr:
            raise AssertionError(f"replay vs eager: {leg} ran the learning "
                                 f"rates {t['lr']}, not the schedule {lr}")
        if t["beta1_pow"] != want_b:
            off = [i + 1 for i, (g, w) in enumerate(zip(t["beta1_pow"],
                                                        want_b)) if g != w]
            raise AssertionError(
                f"replay vs eager: {leg}'s beta1 power {t['beta1_pow']} is "
                f"not {beta1} once a step ({want_b}) at steps {off}")
    if not all(np.isfinite(r["losses"])):
        raise AssertionError(f"replay vs eager: losses {r['losses']}")
    steps_off = [i + 1 for i, (a, b) in enumerate(zip(r["losses"],
                                                      e["losses"])) if a != b]
    state_off = _unequal(r["state"], e["state"])
    report = {"bit_identical": not steps_off and not state_off,
              "loss_steps_differing": steps_off,
              "persistables_differing": len(state_off),
              "persistables": len(e["state"]),
              "max_abs_loss_diff": max(abs(a - b) for a, b in
                                       zip(r["losses"], e["losses"]))}
    if report["bit_identical"]:
        return report
    if again is None:
        raise AssertionError(f"replay vs eager: losses differ at steps "
                             f"{steps_off} and {len(state_off)} "
                             f"persistables differ ({state_off[:5]}), with "
                             f"no second eager run to name a cause")
    eager_steps = {i + 1 for i, (a, b) in enumerate(zip(again["losses"],
                                                        e["losses"])) if a != b}
    eager_state = set(_unequal(again["state"], e["state"]))
    unexplained = ([s for s in steps_off if s < min(eager_steps, default=1e9)]
                   + [n for n in state_off if n not in eager_state])
    if unexplained:
        raise AssertionError(f"replay vs eager: differences that two eager "
                             f"runs do not share: {unexplained[:8]}")
    report["cause"] = ("eager's own run-to-run variation: a second eager "
                       "run from the same start differs from the first "
                       f"from step {min(eager_steps, default=None)} and in "
                       f"{len(eager_state)} persistables")
    return report


def _reset_launches() -> None:
    from paddle_tpu_torch.ops import flash_attention as fl
    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import lmhead_ce as ce

    ce.reset_launches()
    fa.reset_launches()
    fl.reset_launches()


def _all_launches() -> dict:
    """{kernel: the wrapper's launch count} of all seven kernels."""
    from paddle_tpu_torch.ops import lmhead_ce as ce

    return {"lmhead_ce_fwd": ce.launches, "lmhead_ce_dx": ce.dx_launches,
            "lmhead_ce_dw": ce.dw_launches, **_path_launches()}


def _train(torch, card, config, batch, seq, phase, flash_per_step,
           band=False, names=None):
    """bench.py's gpt2s at ``seq`` through the port's training entry
    points: 3 warm-up + 10 timed steps on one fixed batch, twice from the
    same initial persistables: E, eagerly (PADDLE_TPU_EAGER=1), then R,
    the main path, on the card's default compiled route (step 1 eager,
    step 2 captured as a CUDA graph and replayed once, steps 3-13
    replayed); the learning rate ``_lr_schedule``. R is held to E by
    ``_replay_agrees``, and its loss must be finite and falling. The
    kernel wrappers' launches are counted from 0 over R's 13 steps: they
    count the steps that ran on the host (R's warm-up and its capture),
    each the CE forward, dx and dW once, Adam 196 times, the flash
    forward, dq and dk/dv ``flash_per_step`` times (one per layer where
    attention takes flash, none where it takes the einsum path), and
    FLASH_DISPATCH_COUNT rises by as many forwards. Then one traced step
    of each: R's replayed step must show every path kernel's launches
    per step in the device trace. With ``band``, first the loss band's
    T and Y runs (``_band_runs``) from the same start, and R (K) is held
    by ``_loss_band``. With ``names`` ({piece of a kernel's name: calls}),
    R's traced step must also show the kernels whose names hold each
    piece launched so often (``_profile_step``). Returns the launches and
    R's traced step."""
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.ops import attention

    t0 = time.perf_counter()
    program = _train_program(config, batch, seq)
    main, startup, io = program
    build_s = time.perf_counter() - t0
    scope, exe = Scope(), _executor("cuda")
    exe.run(startup, scope=scope)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())
    feed = _fixed_batch(torch, config["vocab_size"], batch, seq)
    start = {v.name: scope.get(v.name).detach().clone()
             for v in main.list_vars() if v.persistable}
    b1p0 = float(start[next(n for n in start
                            if n.startswith("gpt.wte_beta1_pow"))])
    if band:
        runs = _band_runs(torch, config, batch, seq, start, feed)
    steps = _WARM_STEPS + _TIMED_STEPS
    lrs = _lr_schedule(steps)
    per_step = {"lmhead_ce_fwd": 1, "lmhead_ce_dx": 1, "lmhead_ce_dw": 1,
                "fused_adam": _ADAM_PER_STEP,
                "flash_attention_fwd": flash_per_step,
                "flash_attention_dq": flash_per_step,
                "flash_attention_dkv": flash_per_step}

    def measured(run):
        """``run()``'s trajectory, with the bytes allocated before it and
        its peak."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = run()
        torch.cuda.synchronize()
        t["memory"] = (before, torch.cuda.max_memory_allocated())
        return t

    legs, traced = {}, {}
    e_scope, e_exe = Scope(), _executor("cuda")
    for name, t in start.items():
        e_scope.set(name, t.clone())
    with _eager():
        legs["E"] = measured(lambda: _trajectory(e_exe, e_scope, program,
                                                 feed, lrs))

    # the main path, counted: every count starts from 0 here
    _reset_launches()
    dispatched = attention.FLASH_DISPATCH_COUNT
    legs["R"] = r = measured(lambda: _trajectory(exe, scope, program, feed,
                                                 lrs))
    dispatched = attention.FLASH_DISPATCH_COUNT - dispatched
    launches = _all_launches()
    on_host = r["phases"]["eager"] + r["phases"]["capture"]
    if r["phases"] != {"eager": 1, "capture": 1, "replay": steps - 2}:
        raise AssertionError(f"{phase}: runs by phase {r['phases']}, not "
                             f"1 warm-up, 1 capture and {steps - 2} replays")
    want = {k: on_host * n for k, n in per_step.items()}
    if launches != want or dispatched != on_host * flash_per_step:
        raise AssertionError(f"{phase} launches {launches} and "
                             f"{dispatched} flash dispatches, expected "
                             f"{want} and {on_host * flash_per_step} over "
                             f"the {on_host} steps run on the host")
    losses = r["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} loss not finite and falling: "
                             f"{losses}")
    again = None
    try:
        agree = _replay_agrees(r, legs["E"], lrs, b1p0)
    except AssertionError:
        # name the cause: a second eager leg from the same start
        with _eager():
            again = _leg(program, start, feed, "cuda", lrs)
        agree = _replay_agrees(r, legs["E"], lrs, b1p0, again=again)
    fetch_list = [io["loss"], io["optimizer"]._lr_var]  # _trajectory's
    with _eager():
        traced["E"] = _profile_step(torch, e_exe, main, feed, fetch_list,
                                    e_scope, card, phase + "_eager_profile")
    traced["R"] = _profile_step(torch, exe, main, feed, fetch_list, scope,
                                card, phase + "_profile", per_step=per_step,
                                names=names)

    def side(leg):
        t = legs[leg]
        ms = statistics.median(t["step_s"][_WARM_STEPS:]) * 1e3
        return {"step_ms_median": ms,
                "step_ms_all": [x * 1e3 for x in t["step_s"]],
                "tokens_per_s": batch * seq / (ms / 1e3),
                "device_busy_share": traced[leg]["device_ms"] / ms,
                "traced_wall_ms": traced[leg]["wall_ms"],
                "traced_device_ms": traced[leg]["device_ms"],
                "allocated_before": t["memory"][0],
                "max_memory_allocated": t["memory"][1],
                "losses": t["losses"]}

    _say(phase=phase, config=config, batch=batch, seq=seq,
         params=n_params, build_s=build_s, losses=losses,
         step_ms_median=side("R")["step_ms_median"],
         step_ms_all=[t * 1e3 for t in r["step_s"][_WARM_STEPS:]],
         tokens_per_s=side("R")["tokens_per_s"],
         max_memory_allocated=r["memory"][1], launches=launches,
         launches_on_host_per_step={k: n // on_host
                                    for k, n in launches.items()},
         launches_per_replayed_step={
             k: v["calls"] for k, v in traced["R"]["path_kernels"].items()},
         runs_by_phase=r["phases"], flash_dispatches=dispatched,
         lr=r["lr"], beta1_pow=r["beta1_pow"],
         adam_step_bound_ms=_bound_ms(n_params * 22, 15.0 * n_params,
                                      "float32")[0],
         card=card, note="one smoke run, not a benchmark; launches are the "
         "wrappers' host counts (the warm-up and the capture), "
         "launches_per_replayed_step the device trace's")
    _say(phase=phase + "_replay_vs_eager", seq=seq, replayed=side("R"),
         eager=side("E"), lr=lrs,
         device_ms_by_op_family=traced["E"]["by_op_family_ms"],
         non_kernel_ms_by_op_family=traced["E"][
             "non_kernel_by_op_family_ms"],
         by_op_share=traced["E"]["by_op_share"],
         by_op_note="the eager step's trace, charged to the executor's op "
         "ranges; the replayed step launches the same kernels "
         "(bit-identical results) with no host ops to charge them to",
         beta1_pow_expected=_beta_pows(b1p0, 0.9, steps),
         second_eager_losses=again and again["losses"], card=card, **agree)
    if band:
        _say(phase=phase + "_loss_band", config=config, batch=batch, seq=seq,
             wall_s=runs["wall_s"], card=card,
             what="|K - T| <= multiple x max over s <= t of |Y - T| + atol",
             **_loss_band(losses, runs["T"], runs["Y"]))
    return launches, traced["R"]


# the port's kernels in a trace of a training step, by pieces of the
# names the profiler gives their CUDA kernels (the CE backward's fp32
# product, ``bwd_f32_sm90_kernel``, for the static AMP step): the first
# tuple counts the kernel's launches, the second adds the time of its
# helper launches (the CE forward's combine, the fp32 backward's split and
# reduce)
_TRACE_NAMES = {
    "lmhead_ce_fwd": (("::fwd_sm90_kernel(", "::fwd_f32_sm90_kernel("),
                      ("::combine_kernel(",)),
    "lmhead_ce_dx": (("::bwd_sm90_kernel<true>",
                      "::bwd_f32_sm90_kernel<true>"),
                     ("::bwd_f32_split_kernel<true>",
                      "::bwd_f32_reduce_kernel<true>")),
    "lmhead_ce_dw": (("::bwd_sm90_kernel<false>",
                      "::bwd_f32_sm90_kernel<false>"),
                     ("::bwd_f32_split_kernel<false>",
                      "::bwd_f32_reduce_kernel<false>")),
    "flash_attention_fwd": (("::fwd_sm90_kernel<", "::flash_fwd_f32_kernel<",
                             "::fwd_d256_sm90_kernel(",
                             "::fwd_f32_d256_sm90_kernel("), ()),
    "flash_attention_dq": (("::dq_sm90_kernel<", "::dq_d256_sm90_kernel(",
                            "::dq_f32_d256_sm90_kernel(",
                            "::dq_f32_sm90_kernel<", "::dq_kernel<"), ()),
    "flash_attention_dkv": (("::dkv_sm90_kernel<", "::dkv_d256_sm90_kernel(",
                             "::dkv_f32_d256_sm90_kernel(",
                             "::dkv_f32_sm90_kernel<", "::dkv_kernel<"), ()),
    "fused_adam": (("::adam_kernel<",), ()),
}

# the other kernels of a traced step, by op family: the first family
# whose pieces a kernel's name holds (convolutions before GEMMs: cuDNN's
# names hold "xmma" and "gemm"; copies before elementwise: PyTorch names
# its copy and fill kernels inside its elementwise templates)
_FAMILIES = [
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "cudnn")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "gemv", "splitKreduce")),
    ("layer_norm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("copy", ("copy", "Memcpy", "Memset", "CatArray", "FillFunctor")),
    ("softmax", ("softmax", "Softmax")),
    ("reduction", ("reduce_kernel", "Reduce")),
    ("index", ("index", "gather", "scatter", "embedding")),
    ("elementwise", ("elementwise",)),
]


def _family(name) -> str:
    return next((f for f, pieces in _FAMILIES
                 if any(p in name for p in pieces)), "other")


# the GPT program's op types by family (a grad op goes with its forward
# op's); the first family whose prefix starts the type
_OP_FAMILIES = [
    ("gemm", ("matmul", "mul")),
    ("layer_norm", ("layer_norm",)),
    ("attention", ("fused_attention",)),
    ("lm_head_ce", ("fused_lm_head_ce",)),
    ("adam", ("adam",)),
    ("embedding", ("lookup_table",)),
    ("copy", ("reshape", "transpose", "slice", "cast", "concat", "split",
              "fill", "assign")),
    ("elementwise", ("elementwise", "gelu", "scale", "sum", "mean",
                     "softmax", "dropout")),
]


def _by_op(torch, events) -> dict:
    """Device ms by program op type, from a traced step that ran its ops
    on the host (eagerly): each host event's own device time (its
    kernels, not its children's: each kernel counts once, on whichever
    thread its host op ran -- a grad op's backward runs on autograd's
    thread while the caller waits in it) is charged to the innermost
    executor or tracer ``OP_RANGE`` range whose host interval holds the
    event's start (a scheduled trace's "ProfilerStep*" range,
    ``_profiled``, is no op's range). Returns {} for a replayed step,
    which runs no host ops."""
    import bisect

    from paddle_tpu_torch.framework.executor import OP_RANGE

    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name[len(OP_RANGE):]) for e in events
                    if e.name.startswith(OP_RANGE)
                    and e.device_type == torch.autograd.DeviceType.CPU)
    starts = [r[0] for r in ranges]
    # ranges nest (an eager op's range may hold another op's): each
    # range's enclosing one, for the walk out from a range that ended
    parent, stack = [], []
    for i, (start, end, _) in enumerate(ranges):
        while stack and ranges[stack[-1]][1] < start:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    out = {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CPU or not ranges
                or e.name.startswith(OP_RANGE)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if not us:
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and t > ranges[i][1]:  # an enclosing range, if any
            i = parent[i]
        op = (ranges[i][2] if i >= 0
              else f"(outside an op: {e.name[:60]})")
        out[op] = out.get(op, 0.0) + us / 1e3
    return out


# the op family each of the port's kernels runs in, where ``_by_op``
# charges it: the CE and flash kernels launch inside an autograd
# Function's torch op; the fused Adam kernel launches straight from its
# op's range, and the profiler charges such a kernel to no host op (it
# is the device time ``by_op_share`` misses)
_KERNEL_OPS = {
    "lm_head_ce": ("lmhead_ce_fwd", "lmhead_ce_dx", "lmhead_ce_dw"),
    "attention": ("flash_attention_fwd", "flash_attention_dq",
                  "flash_attention_dkv"),
}


def _op_family(op_type) -> str:
    base = op_type[:-len("_grad")] if op_type.endswith("_grad") else op_type
    return next((f for f, prefixes in _OP_FAMILIES
                 if base.startswith(prefixes)), "other")


def _kernel_tally(torch, events):
    """(kernels {name: (calls, ms)}, device ms, the port's kernels
    {name: {calls, ms}} by ``_TRACE_NAMES``, the other kernels by family,
    [(ms, name)] of the family "other") of a trace's events."""
    from paddle_tpu_torch.framework.executor import OP_RANGE

    kernels = {}
    for e in events:
        # an op's range, and a scheduled trace's step range
        # ("ProfilerStep*", ``_profiled``), also show on the device
        # timeline as user annotations (the span of their kernels): not
        # kernels
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(OP_RANGE)
                and not getattr(e, "is_user_annotation", False)):
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    device_ms = sum(t for _, t in kernels.values())
    ours, claimed = {}, set()
    for name, (counted, helpers) in _TRACE_NAMES.items():
        hits = [k for k in kernels if any(p in k for p in counted)]
        more = [k for k in kernels if any(p in k for p in helpers)]
        claimed.update(hits + more)
        ours[name] = {"calls": sum(kernels[k][0] for k in hits),
                      "ms": sum(kernels[k][1] for k in hits + more)}
    families, other = {}, []
    for k, (n, t) in kernels.items():
        if k in claimed:
            continue
        fam = families.setdefault(_family(k), {"calls": 0, "ms": 0.0})
        fam["calls"] += n
        fam["ms"] += t
        if _family(k) == "other":
            other.append((t, k[:80]))
    return kernels, device_ms, ours, families, other


def _named_kernels(kernels, names, phase) -> dict:
    """{piece: {calls, ms}}: the calls and device ms of the kernels of a
    trace (``_kernel_tally``'s {name: (calls, ms)}) whose names hold each
    piece of ``names`` ({piece: calls}); raises unless each piece's calls
    are those ``names`` wants."""
    named = {piece: {"calls": sum(n for k, (n, _) in kernels.items()
                                  if piece in k),
                     "ms": sum(t for k, (_, t) in kernels.items()
                               if piece in k)}
             for piece in names}
    if {p: v["calls"] for p, v in named.items()} != names:
        raise AssertionError(f"{phase}: kernels by name {named} in the "
                             f"traced step, not {names}")
    return named


def _profile_step(torch, exe, main, feed, fetch_list, scope, card, phase,
                  per_step=None, return_numpy=True, names=None) -> dict:
    """One traced training step: host wall, device kernel time, launches,
    each of the port's kernels' device calls and ms (``path_kernels``),
    the other kernels' device time by kernel family (``families``), the
    device time by program op type and op family where the step ran its
    ops on the host (``by_op_ms``, ``by_op_family_ms``: ``_by_op``) and
    the kernels that take the most device time. With ``per_step``
    ({kernel: launches}), the step must be a replay of the executor's
    captured step for ``fetch_list`` (the trajectory's, so the same
    analysed entry) and the trace must show each path kernel launched
    exactly so often (a replayed step's launches are counted here, from
    the device); with ``names`` ({piece: calls}), the kernels whose names
    hold each piece too (``named_kernels``: their calls and device ms).
    The counted step follows one traced warm-up step
    (``_profiled``), so the executor takes two steps here. A traced run:
    the tracer adds host time, so its wall is not the step metric, nor
    its busy share (``traced_busy_share``); the busy share is the device
    time over the untraced step's wall. Prints the report and returns
    it."""
    replays = exe.phases["replay"]
    _, wall_ms, events = _profiled(
        torch, lambda: exe.run(main, feed=feed, fetch_list=fetch_list,
                               scope=scope, return_numpy=return_numpy))
    if per_step is not None and exe.phases["replay"] != replays + 2:
        raise AssertionError(f"{phase}: the traced steps were not replays "
                             f"({exe.phases})")
    kernels, device_ms, ours, families, other = _kernel_tally(torch, events)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    if per_step is not None:
        seen = {k: v["calls"] for k, v in ours.items()}
        if seen != per_step:
            raise AssertionError(f"{phase}: path kernels launched {seen} "
                                 f"times in the traced step, not {per_step}")
    named = _named_kernels(kernels, names or {}, phase)
    by_op = _by_op(torch, events)
    by_family = {}
    for op, ms in by_op.items():
        fam = _op_family(op)
        by_family[fam] = by_family.get(fam, 0.0) + ms
    # the same less the port's kernels, each charged to its op's family
    non_kernel = {f: ms - sum(ours[k]["ms"] for k in _KERNEL_OPS.get(f, ()))
                  for f, ms in by_family.items()}
    report = dict(
        wall_ms=wall_ms, device_ms=device_ms,
        traced_busy_share=device_ms / wall_ms if kernels else None,
        launches=sum(n for n, _ in kernels.values()), path_kernels=ours,
        **({"named_kernels": named} if names else {}),
        non_kernel_ms=device_ms - sum(v["ms"] for v in ours.values()),
        families=families,
        other_top=[k for _, k in sorted(other, reverse=True)[:5]],
        by_op_ms=dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
        by_op_family_ms=by_family, non_kernel_by_op_family_ms=non_kernel,
        by_op_share=sum(by_op.values()) / device_ms if by_op else None,
        top_kernels=[{"name": k[:80], "calls": n, "ms": t}
                     for k, (n, t) in top])
    _say(phase=phase, **report, card=card,
         note="traced run; not measured if no CUDA events")
    return report


# tiny fp32 configs of the CPU-against-card phase: (leg, GPTConfig
# keywords, seq, PADDLE_TPU_FLASH_MIN_SEQ, Adam lr, Adam epsilon); batch 2
# each. The flash leg runs Adam at epsilon 1e-5, as
# tests/test_torch_static_training.py does: one gpt.wte gradient of its
# batch cancels to ~1e-10, and at the default 1e-8 Adam's first step,
# lr * g / (|g| + eps), turns the fp32 rounding difference of that sum
# between an H100 and the CPU into a step difference of 2e-4 at lr 1e-3
# (measured on an H100); at 1e-5 it shrinks a thousandfold, while the
# other parameters still move by about lr.
# The flash_d256 leg runs one head of 256 in bf16 (the tensor-core
# forward, dq and dk/dv at head_dim 256 in bf16), so it is held by
# ``_bf16_leg_agrees`` instead (``_cpu_vs_card_bf16``); the
# flash_f32_d256 leg the same head in fp32 (the split-TF32 forward, dq
# and dk/dv at head_dim 256), at _TINY_TOL.
_CPU_VS_CARD = [
    ("einsum", dict(vocab_size=128, n_layer=2, n_head=2, d_model=32,
                    max_seq_len=16), 16, None, 1e-3, 1e-8),
    ("flash", dict(vocab_size=256, n_layer=2, n_head=2, d_model=128,
                   max_seq_len=128), 128, 128, 1e-3, 1e-5),
    ("flash_d256", dict(vocab_size=256, n_layer=2, n_head=1, d_model=256,
                        max_seq_len=128, dtype="bfloat16"), 128, 128, 1e-3,
     1e-5),
    ("flash_f32_d256", dict(vocab_size=256, n_layer=2, n_head=1, d_model=256,
                            max_seq_len=128), 128, 128, 1e-3, 1e-5),
]
# the eager encoder of train_eager at 2 layers, d 128 (head_dim 64) and
# seq 1024, where attention takes flash on the card by default; one
# Model.train_batch at Adam lr 1e-3, epsilon 1e-5 (``_cpu_vs_card_eager``)
_EAGER_CPU_VS_CARD = dict(vocab=1024, seq=1024, d_model=128, n_head=2,
                          n_layer=2, dropout=0.0)
_TINY_TOL = 1e-4


def _tiny_build(config, seq, lr, eps):
    """(main, startup, io): a tiny GPT train program (batch 2) with Adam,
    built under a fresh unique-name generator, so that its bf16 and fp32
    builds name their persistables alike."""
    from paddle_tpu_torch.framework import program_guard, unique_name
    from paddle_tpu_torch.models.gpt import GPTConfig, build_train_program
    from paddle_tpu_torch.optimizer import Adam

    with unique_name.guard():
        main, startup, io = build_train_program(GPTConfig(**config), batch=2,
                                                seq=seq)
        with program_guard(main, startup):
            Adam(learning_rate=lr, epsilon=eps).minimize(io["loss"])
    return main, startup, io


def _tiny_feed(vocab, seq):
    r = np.random.RandomState(1)
    return {k: r.randint(0, vocab, (2, seq)).astype(np.int64)
            for k in ("tokens", "labels")}


def _tiny_program(config, seq, lr, eps):
    """(main, io, names, start, feed): a tiny fp32 GPT train program with
    Adam, its persistables' names and startup values (from a CPU run) and
    one seeded batch of 2."""
    from paddle_tpu_torch.framework import CPUPlace, Executor, Scope

    main, startup, io = _tiny_build(config, seq, lr, eps)
    scope = Scope()
    Executor(CPUPlace()).run(startup, scope=scope)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    start = {n: scope.get(n).numpy() for n in names}
    return main, io, names, start, _tiny_feed(config["vocab_size"], seq)


def _tiny_steps(program, dev, flash_min_seq, steps=2):
    """(losses, {persistable: np.ndarray}, flash dispatches): ``steps``
    steps of a ``_tiny_program`` from its start on ``dev`` ("cpu": plain
    versions, "cuda": kernels), with PADDLE_TPU_FLASH_MIN_SEQ at
    ``flash_min_seq`` where it is given."""
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.weights import scope_from_numpy

    main, io, names, start, feed = program
    saved = os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ")
    if flash_min_seq:
        os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = str(flash_min_seq)
    try:
        scope = scope_from_numpy(start, Scope(), dev)
        exe = _executor(dev)
        before = attention.FLASH_DISPATCH_COUNT
        losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                scope=scope)[0]) for _ in range(steps)]
        return (losses, {n: scope.get(n).cpu().numpy() for n in names},
                attention.FLASH_DISPATCH_COUNT - before)
    finally:
        if saved is None:
            os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
        else:
            os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = saved


def _tiny_agree(got, want, what) -> float:
    """Holds one ``_tiny_steps`` run against another: the losses and every
    persistable at rtol = atol = 1e-4, and each Adam moment also within
    1e-4 of the largest value of its kind (every moment1, every moment2).
    Adam's first steps move a parameter by about lr * sign(g), whatever
    the size of g, so the parameters alone would pass a gradient of the
    wrong size; its moments carry that size (m ~ g, v ~ g^2). Raises
    naming what disagrees; returns the largest parameter difference."""
    (gl, gv, _), (wl, wv, _) = got, want
    np.testing.assert_allclose(gl, wl, rtol=_TINY_TOL, atol=_TINY_TOL,
                               err_msg=f"{what}: losses")
    scale = {kind: max(float(np.abs(wv[n]).max()) for n in wv
                       if f"_{kind}_" in n) for kind in ("moment1", "moment2")}
    worst = 0.0
    for n in sorted(wv):
        np.testing.assert_allclose(gv[n], wv[n], rtol=_TINY_TOL,
                                   atol=_TINY_TOL, err_msg=f"{what}: {n}")
        diff = float(np.abs(gv[n] - wv[n]).max())
        kind = next((k for k in scale if f"_{k}_" in n), None)
        if kind and diff > _TINY_TOL * scale[kind]:
            raise AssertionError(
                f"{what}: {n} differs by {diff}, beyond 1e-4 of the largest "
                f"{kind} ({scale[kind]})")
        worst = max(worst, diff)
    return worst


def _cpu_vs_card(torch, leg, config, seq, flash_min_seq, lr, eps):
    """A tiny fp32 config trains 2 steps (batch 2) from the same numpy
    values on the CPU (plain versions) and on the card (kernels), held
    together by ``_tiny_agree`` (TF32 off: exact fp32 products, summed in
    another order). The flash leg lowers PADDLE_TPU_FLASH_MIN_SEQ to its
    seq, so that attention (head_dim 64) takes the flash kernels on both
    sides: FLASH_DISPATCH_COUNT must rise on each, and must not in the
    einsum leg. A bf16 config goes to ``_cpu_vs_card_bf16``."""
    if config.get("dtype") == "bfloat16":
        return _cpu_vs_card_bf16(torch, leg, config, seq, flash_min_seq, lr,
                                 eps)
    program = _tiny_program(config, seq, lr, eps)
    cpu = _tiny_steps(program, "cpu", flash_min_seq)
    card = _tiny_steps(program, "cuda", flash_min_seq)
    dispatched = {"cpu": cpu[2], "cuda": card[2]}
    if (min(dispatched.values()) > 0) != bool(flash_min_seq):
        raise AssertionError(f"cpu_vs_card {leg}: flash dispatches "
                             f"{dispatched}")
    worst = _tiny_agree(card, cpu, f"cpu_vs_card {leg}")
    _say(phase="cpu_vs_card", leg=leg, config=config, seq=seq, lr=lr,
         eps=eps, steps=2, losses_cpu=cpu[0], losses_card=card[0],
         flash_dispatches=dispatched, persistables=len(program[2]),
         max_abs_diff=worst, tolerance=_TINY_TOL,
         moment_tolerance="1e-4 of the largest moment of its kind")


# A bf16 leg against the CPU. K (the card: the kernels) and Y (the CPU:
# the plain versions) train the same bf16 program from one start; T, the
# truth, is the program built in fp32 on the CPU from that start cast up.
# After the steps, each Adam moment1 (which carries its gradient's size:
# m = (1 - beta1) g after one step) of K lies within _BF16_LEG_MULTIPLE
# times Y's distance from T (Frobenius norm), plus _BF16_LEG_ATOL times
# the largest moment1's norm in T, and K's losses inside ``_loss_band``'s
# band around T that Y sets. The floor is relative to the largest moment
# (as ``_tiny_agree``'s is to the largest of its kind), not to the
# moment's own: the key bias's gradient is 0 in exact arithmetic (a
# score row's softmax does not see a shift along its keys), so its
# moment is rounding noise in K, Y and T alike. Why 2:
# K and Y share the bf16 rounding of the whole program and differ in the
# kernels' own last-bit differences (and the CPU's and the card's fp32
# sums), so K lies about as far from T as Y does (the chain check's
# argument, ``_CHAIN_MULTIPLE``). A wrong gradient from a kernel (a
# dropped key tile of dk) moves its weights' moment by a large share of
# its norm (tests/test_torch_smoke_checks.py shows it rejected).
_BF16_LEG_STEPS = 2
_BF16_LEG_MULTIPLE = 2.0
_BF16_LEG_ATOL = 1e-3


def _bf16_leg_runs(torch, config, seq, flash_min_seq, lr, eps, card="cuda",
                   steps=_BF16_LEG_STEPS) -> dict:
    """{"K", "Y", "T": (losses, {moment1 name: fp32 CPU tensor}, flash
    dispatches)}: the bf16 program on ``card`` (K) and on the CPU (Y), the
    fp32 one on the CPU (T), ``steps`` steps each from one start (the bf16
    startup run on the CPU), with PADDLE_TPU_FLASH_MIN_SEQ at
    ``flash_min_seq``."""
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.ops import attention

    low = _tiny_build(config, seq, lr, eps)
    full = _tiny_build(dict(config, dtype="float32"), seq, lr, eps)
    scope = Scope()
    _executor("cpu").run(low[1], scope=scope)
    start = {v.name: scope.get(v.name) for v in low[0].list_vars()
             if v.persistable}
    moments = sorted(n for n in start if "_moment1_" in n)
    saved = os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ")
    os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = str(flash_min_seq)
    try:
        runs = {}
        for name, (main, _, io), dev, dtype in (
                ("K", low, card, None), ("Y", low, "cpu", None),
                ("T", full, "cpu", torch.float32)):
            scope = Scope()
            for n, t in start.items():
                scope.set(n, (t.to(dtype) if dtype else t).to(dev).clone())
            feed = {k: torch.from_numpy(a).to(dev)
                    for k, a in _tiny_feed(config["vocab_size"], seq).items()}
            exe = _executor(dev)
            before = attention.FLASH_DISPATCH_COUNT
            losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                    scope=scope)[0]) for _ in range(steps)]
            runs[name] = (losses, {n: scope.get(n).float().cpu()
                                   for n in moments},
                          attention.FLASH_DISPATCH_COUNT - before)
        return runs
    finally:
        if saved is None:
            os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
        else:
            os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = saved


def _bf16_leg_agrees(runs, what) -> dict:
    """Holds K of ``_bf16_leg_runs`` to T by the rule above (each moment1
    and the losses); raises naming each moment beyond its bound. Returns
    the worst moment's report and the loss band's."""
    (kl, km, _), (yl, ym, _), (tl, tm, _) = runs["K"], runs["Y"], runs["T"]
    if not km or sorted(km) != sorted(tm):
        raise AssertionError(f"{what}: moments {sorted(km)} against "
                             f"{sorted(tm)}")
    floor = _BF16_LEG_ATOL * max(float(m.double().norm()) for m in tm.values())
    bad, worst = [], None
    for n in sorted(km):
        own = float((ym[n].double() - tm[n].double()).norm())
        err = float((km[n].double() - tm[n].double()).norm())
        bound = _BF16_LEG_MULTIPLE * own + floor
        if worst is None or err / bound > worst["share"]:
            worst = dict(name=n, err=err, plain_err=own, bound=bound,
                         share=err / bound,
                         norm=float(tm[n].double().norm()))
        if not err <= bound:
            bad.append(f"{n}: distance {err} from fp32, bound {bound} "
                       f"({_BF16_LEG_MULTIPLE} x the CPU bf16 run's {own} + "
                       f"{floor})")
    if bad:
        raise AssertionError(f"{what}: moments beyond their bound: "
                             + "; ".join(bad))
    return dict(worst_moment=worst, moments=len(km),
                loss_band=_loss_band(kl, tl, yl))


def _cpu_vs_card_bf16(torch, leg, config, seq, flash_min_seq, lr, eps):
    """A tiny bf16 config trains ``_BF16_LEG_STEPS`` steps (batch 2) on
    the card (kernels) and on the CPU (plain versions) from one start,
    held by ``_bf16_leg_agrees`` against the fp32 program; flash must be
    dispatched on each side, and the card's run must launch the flash
    forward, dq and dk/dv kernels."""
    from paddle_tpu_torch.ops import flash_attention as fl

    fl.reset_launches()
    runs = _bf16_leg_runs(torch, config, seq, flash_min_seq, lr, eps)
    launches = (fl.fwd_launches, fl.dq_launches, fl.dkv_launches)
    dispatched = {k: runs[k][2] for k in runs}
    if min(dispatched.values()) <= 0 or min(launches) <= 0:
        raise AssertionError(f"cpu_vs_card {leg}: flash dispatches "
                             f"{dispatched}, kernel launches {launches}")
    report = _bf16_leg_agrees(runs, f"cpu_vs_card {leg}")
    _say(phase="cpu_vs_card", leg=leg, config=config, seq=seq, lr=lr,
         eps=eps, steps=_BF16_LEG_STEPS, losses_card=runs["K"][0],
         losses_cpu_bf16=runs["Y"][0], losses_cpu_fp32=runs["T"][0],
         flash_dispatches=dispatched, launches_fwd_dq_dkv=launches,
         multiple=_BF16_LEG_MULTIPLE, atol=_BF16_LEG_ATOL, **report)


def _serve_leg(model, prompts):
    """The 8 prompts through a fresh ServingEngine, warmed on its own
    pages first (on the compiled route: every program captured there),
    submitted at once and run until idle, then each prompt scored.
    Returns the tokens, each request's TTFT, each decode tick's wall, the
    wall, the decoded tokens the ledger counted and the scores."""
    from paddle_tpu_torch.serving import ServingEngine, ledger

    ledger.reset()
    engine = ServingEngine(model)
    engine.warm(full=True)
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=_NEW_TOKENS) for p in prompts]
    engine.run_until_idle()
    wall = time.perf_counter() - t0
    tokens = [h.result(timeout=60) for h in handles]
    if any(len(t) != _NEW_TOKENS for t in tokens):
        raise AssertionError(f"not every request got {_NEW_TOKENS} tokens: "
                             f"{[len(t) for t in tokens]}")
    ticks = {}
    for h in handles:
        for t_a, t_b, tick in h._req.tick_windows:
            ticks[tick] = (t_b - t_a) / 1e6
    return {"tokens": tokens, "wall_s": wall,
            "ttft_ms": [(h._req.t_first_token - h._req.t_submit) / 1e6
                        for h in handles],
            "tick_ms": list(ticks.values()),
            "decode_tokens": ledger.totals()["decode_tokens"],
            "scores": [model.score(p) for p in prompts]}


def _serve_side(leg) -> dict:
    """One serve leg's user-facing numbers."""
    n = sum(len(t) for t in leg["tokens"])
    return {"wall_s": leg["wall_s"], "generated_tokens": n,
            "tokens_per_s": n / leg["wall_s"],
            "ttft_ms_mean": statistics.mean(leg["ttft_ms"]),
            "ttft_ms_max": max(leg["ttft_ms"]),
            "decode_ticks": len(leg["tick_ms"]),
            "decode_tick_ms_mean": statistics.mean(leg["tick_ms"]),
            "decode_tick_ms_median": statistics.median(leg["tick_ms"])}


def _serve(torch, card):
    """Serving at full width: the 8 prompts first eagerly (E,
    PADDLE_TPU_EAGER=1), then on the card's default compiled route (R,
    the main path: decode, prefill per bucket and score per bucket
    replayed as CUDA graphs), each through ``_serve_leg``. R's greedy
    tokens must equal E's, and its NLL E's within 1e-5; R is held against
    the full-context reference; two prompts again, one after the other,
    on a threaded engine that captures on its scheduler thread (tokens
    bit-identical); then traced decode windows of both."""
    from paddle_tpu_torch.ops import lmhead_ce as ce
    from paddle_tpu_torch.serving import (DecodeModel, GPTConfig,
                                          ServingEngine, init_params)
    from paddle_tpu_torch.weights import params_from_numpy

    cfg = GPTConfig(**_SERVE_CFG)
    t0 = time.perf_counter()
    params = params_from_numpy(init_params(cfg, seed=0), "cuda")
    model = DecodeModel(cfg, params=params, device="cuda", **_SERVE_ENV)
    model.warm(full=True)
    n_params = sum(p.numel() for p in model.params.values())
    _say(phase="serve_setup", params=n_params,
         pages_bytes=model.init_pages(n_blocks=1).nbytes * model.n_blocks,
         seconds=round(time.perf_counter() - t0, 3))

    r = np.random.RandomState(0)
    prompts = [r.randint(1, _SERVE_V, size=n).tolist() for n in _PROMPT_LENS]
    with _eager():
        eager = _serve_leg(model, prompts)

    # the main path, counted: the kernel's launches start from 0 here
    ce.reset_launches()
    replayed = _serve_leg(model, prompts)
    launches = ce.launches
    if launches < 1:
        raise AssertionError("score never launched the lmhead_ce kernel")
    programs = {str(k): p.run.calls for k, p in model._programs.items()}
    if not all(c["replay"] for c in programs.values()):
        raise AssertionError(f"a serving program never replayed: {programs}")
    if replayed["tokens"] != eager["tokens"]:
        raise AssertionError("replayed greedy tokens differ from eager ones")
    nll_diff = max(float(np.abs(a[0] - b[0]).max()) for a, b in
                   zip(replayed["scores"], eager["scores"]))
    total_diff = max(abs(a[1] - b[1]) for a, b in
                     zip(replayed["scores"], eager["scores"]))
    if not nll_diff <= 1e-5:
        raise AssertionError(f"replayed nll off the eager nll by {nll_diff}")
    batched = replayed["tokens"]
    nll, total = replayed["scores"][-1]
    if nll.shape != (_PROMPT_LENS[-1] - 1,) or not np.isfinite(nll).all():
        raise AssertionError(f"score gave {nll.shape}, finite="
                             f"{np.isfinite(nll).all()}")
    if abs(total - float(nll.astype(np.float64).sum())) > 1e-4 * abs(total):
        raise AssertionError(f"score total {total} != sum {nll.sum()}")

    # reference checks (not counted: the main path's counts are read)
    logits = model.full_logits(prompts[-1])[0].astype(np.float64)
    m = logits.max(-1, keepdims=True)
    lse = m[:, 0] + np.log(np.exp(logits - m).sum(-1))
    ref_nll = lse[:-1] - logits[np.arange(len(nll)), prompts[-1][1:]]
    score_err = float(np.abs(nll - ref_nll).max())
    if score_err > 1e-3:
        raise AssertionError(f"score nll off the full-logits reference by "
                             f"{score_err}")

    seq_engine = ServingEngine(model)  # unwarmed: captures on its thread
    seq_engine.start()
    try:
        sequential = [seq_engine.submit(prompts[i], _NEW_TOKENS)
                      .result(timeout=120) for i in (0, 7)]
    finally:
        seq_engine.stop(flush=False)
    if sequential != [batched[0], batched[7]]:
        raise AssertionError("batched tokens differ from sequential ones")

    # greedy agreement, teacher-forced on the engine's own tokens: a
    # disagreement counts only where the reference's top-2 margin
    # exceeds 1e-4 (a near-tie may flip on summation order)
    disagree = 0
    for prompt, got in zip(prompts, batched):
        ref = model.full_logits(prompt + got)[0]
        for j, tok in enumerate(got):
            row = ref[len(prompt) - 1 + j]
            top2 = np.sort(row)[-2:]
            if int(row.argmax()) != tok and top2[1] - top2[0] > 1e-4:
                disagree += 1
    if disagree:
        raise AssertionError(f"{disagree} greedy tokens disagree with the "
                             f"full-context reference beyond a 1e-4 margin")

    with _eager():
        profiles = {"eager": _profile_decode(torch, model, card, "eager")}
    profiles["replayed"] = _profile_decode(torch, model, card, "replayed")
    rep = _serve_side(replayed)
    _say(phase="serve", requests=len(prompts), new_tokens=_NEW_TOKENS,
         generated_tokens=rep["generated_tokens"],
         decode_tokens=replayed["decode_tokens"], wall_s=rep["wall_s"],
         tokens_per_s=rep["tokens_per_s"], ttft_ms_mean=rep["ttft_ms_mean"],
         ttft_ms_max=rep["ttft_ms_max"], decode_ticks=rep["decode_ticks"],
         decode_tick_ms_mean=rep["decode_tick_ms_mean"],
         sequential_bit_identical=True, greedy_disagreements=disagree,
         score_total_nll=total, score_max_abs_err_vs_full_logits=score_err,
         lmhead_ce_launches=launches, programs=programs, card=card,
         note="one smoke run, not a benchmark; lmhead_ce_launches are the "
         "wrapper's host count (score's warm-ups and captures)")
    _say(phase="serve_replay_vs_eager", replayed=rep,
         eager=_serve_side(eager), tokens_equal=True,
         nll_max_abs_diff=nll_diff, total_nll_max_abs_diff=total_diff,
         decode_tick_traced={k: {f: v[f] for f in (
             "wall_ms_per_tick", "device_ms_per_tick", "traced_busy_share",
             "launches_per_tick")} for k, v in profiles.items()},
         decode_busy_share={
             "replayed": profiles["replayed"]["device_ms_per_tick"]
             / rep["decode_tick_ms_median"],
             "eager": profiles["eager"]["device_ms_per_tick"]
             / _serve_side(eager)["decode_tick_ms_median"]},
         busy_note="device ms of a traced tick over the median untraced "
         "engine tick (which also holds the host's staging and readback)",
         card=card)
    return launches, prompts, batched, profiles["replayed"]


def _profile_decode(torch, model, card, leg, ticks=5):
    """A traced window of decode ticks at full batch (8 slots, 500
    tokens of context each) on fresh pages, after warming them (on the
    compiled route that captures decode there): host wall per tick,
    device kernel time per tick (torch.profiler's CUDA activity),
    launches per tick and the kernels that take the most device time. A
    traced run: the tracer adds host time, so its wall is not the serving
    metric. Prints and returns the report."""
    from torch.profiler import ProfilerActivity, profile

    B, per = model.max_batch, 500 // model.block_size + 1
    tables = np.zeros((B, model.max_blocks_per_req), np.int32)
    for b in range(B):
        tables[b, :per] = 1 + b * per + np.arange(per)
    lens = np.full(B, 500, np.int32)
    toks = np.arange(B, dtype=np.int32)
    pages = model.init_pages()
    model.warm(pages=pages)
    model.decode(pages, tables, lens, toks)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            model.decode(pages, tables, lens, toks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    device_ms = sum(t for _, t in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:6]
    report = dict(
        wall_ms_per_tick=wall_ms / ticks,
        device_ms_per_tick=device_ms / ticks,
        traced_busy_share=device_ms / wall_ms if kernels else None,
        launches_per_tick=sum(n for n, _ in kernels.values()) / ticks,
        top_kernels=[{"name": k[:80], "calls": n, "ms": t}
                     for k, (n, t) in top])
    _say(phase="decode_profile", leg=leg, ticks=ticks, batch=B, context=500,
         **report, card=card,
         note="traced run; not measured if no CUDA events")
    return report


_ROOT = os.path.dirname(os.path.abspath(__file__))
# serve_tier: a replica's boot, a leg's requests and a replica's SIGTERM
# each get this long before the phase fails
_TIER_BOOT_S, _TIER_LEG_S, _TIER_TERM_S = 300.0, 180.0, 30.0
_TIER_HEADROOM = 1.5  # serving/ledger.py reconcile_roofline's headroom


class _Replica:
    """One ``tools/torch_serve_replica.py`` process on the card: its
    status port, its log (stdout and stderr) and, once booted, its
    ``READY`` document."""

    def __init__(self, index, params_path, work, port=None,
                 device="cuda"):
        from paddle_tpu_torch.status import free_port

        self.name = f"replica{index}"
        self.port = port or free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.log_path = os.path.join(work, f"{self.name}.{time.time()}.log")
        env = dict(os.environ, PADDLE_TPU_SERVE_PARAMS=params_path)
        for k in ("PADDLE_TPU_STATUS_PORT", "PADDLE_TPU_EAGER",
                  "PADDLE_TPU_SERVE_DIR", "PADDLE_TPU_CHAOS_SITES"):
            env.pop(k, None)
        cfg, eng = _SERVE_CFG, _SERVE_ENV
        cmd = [sys.executable,
               os.path.join(_ROOT, "tools", "torch_serve_replica.py"),
               "--device", device, "--port", str(self.port),
               "--rank", str(index), "--seed", "0",
               "--vocab", str(cfg["vocab_size"]),
               "--n-layer", str(cfg["n_layer"]),
               "--n-head", str(cfg["n_head"]),
               "--d-model", str(cfg["d_model"]),
               "--max-seq-len", str(cfg["max_seq_len"]),
               "--max-batch", str(eng["max_batch"]),
               "--kv-blocks", str(eng["n_blocks"]),
               "--block-size", str(eng["block_size"]),
               "--prefill-buckets",
               ",".join(str(b) for b in eng["prefill_buckets"]),
               "--slo-s", "120"]
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(cmd, env=env, stdout=log,
                                         stderr=subprocess.STDOUT)
        self.t_spawn = time.perf_counter()
        self.ready = None

    def tail(self, n=30) -> str:
        with open(self.log_path, errors="replace") as f:
            return "".join(f.readlines()[-n:])

    def poll_ready(self):
        """The READY document once printed; raises if the process died."""
        with open(self.log_path, errors="replace") as f:
            for line in f:
                if line.startswith("READY "):
                    self.ready = json.loads(line[len("READY "):])
                    self.ready["wall_to_ready_s"] = (time.perf_counter()
                                                     - self.t_spawn)
                    return self.ready
        if self.proc.poll() is not None:
            raise AssertionError(
                f"{self.name} exited with {self.proc.returncode} before "
                f"READY; log tail:\n{self.tail()}")
        return None

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.url + path, timeout=30) as r:
            return json.loads(r.read().decode())

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=_TIER_TERM_S)


def _boot(replicas):
    """Wait for every replica's READY line (booting in parallel)."""
    deadline = time.perf_counter() + _TIER_BOOT_S
    while not all(r.ready for r in replicas):
        for r in replicas:
            if not r.ready:
                r.poll_ready()
        if time.perf_counter() > deadline:
            late = [r for r in replicas if not r.ready]
            raise AssertionError(
                f"{[r.name for r in late]} not READY within {_TIER_BOOT_S}s;"
                f" log tail:\n{late[0].tail()}")
        time.sleep(0.2)
    return replicas


def _dispatches(router) -> int:
    return sum(r["dispatches"]
               for r in router.snapshot()["replicas"].values())


def _dispatch_all(router, prompts, tag, during=None):
    """The prompts through ``router.dispatch`` together, one thread each.
    Each is sent once the one before it is out on a replica (the router's
    dispatch count has risen, or the request is done): the router counts
    a replica's in-flight request only when the attempt starts on its
    pool, so requests sent together would all see the same load and pick
    one replica. ``during(futures)``, if given, runs on this thread while
    they are out. Returns the request records in prompt order."""
    from concurrent.futures import ThreadPoolExecutor

    futs = []
    with ThreadPoolExecutor(len(prompts)) as pool:
        for i, p in enumerate(prompts):
            sent = _dispatches(router)
            futs.append(pool.submit(router.dispatch, p,
                                    max_new_tokens=_NEW_TOKENS,
                                    request_id=f"{tag}-{i}"))
            while _dispatches(router) <= sent and not futs[-1].done():
                time.sleep(0.0005)
        if during is not None:
            during(futs)
        return [f.result(timeout=_TIER_LEG_S) for f in futs]


def _hold_tokens(recs, want, leg):
    """Every request completed with the in-process replayed leg's
    tokens, bit for bit."""
    bad = [(r["request_id"], r.get("error")) for r in recs if not r["ok"]]
    if bad:
        raise AssertionError(f"serve_tier {leg}: requests failed: {bad}")
    off = [r["request_id"] for r, w in zip(recs, want) if r["tokens"] != w]
    if off:
        raise AssertionError(f"serve_tier {leg}: tokens differ from the "
                             f"in-process replayed leg's for {off}")


def _wait_inflight(router, name, futs):
    """Until the router has a request out on replica ``name``; fails once
    every request of ``futs`` is done without one."""
    while router.snapshot()["replicas"][name]["inflight"] < 1:
        if all(f.done() for f in futs):
            raise AssertionError(f"no request was out on {name}")
        time.sleep(0.0005)


def _wait_admitted(replica, futs):
    """Until ``replica``'s engine holds admitted work (its /healthz);
    fails once every request of ``futs`` is done without that."""
    while True:
        srv = replica.get("/healthz").get("serving") or {}
        if srv.get("active", 0) + srv.get("queued", 0) >= 1:
            return
        if all(f.done() for f in futs):
            raise AssertionError(f"{replica.name} never held admitted work")
        time.sleep(0.002)


def _router_overhead_ms(recs):
    """Router wall minus the winning attempt's engine_e2e_s, a request."""
    out = []
    for r in recs:
        win = next(a for a in reversed(r["attempts"]) if a.get("ok"))
        out.append((r["latency_s"] - float(win["engine_e2e_s"])) * 1e3)
    return out


def _counter(name, **labels) -> float:
    from paddle_tpu_torch import monitor

    fam = monitor.snapshot().get("metrics", {}).get(name, {})
    return sum(float(s.get("value", 0.0)) for s in fam.get("series", [])
               if all(s.get("labels", {}).get(k) == v
                      for k, v in labels.items()))


def _tier_roofline(replica, decode_profile):
    """One replica's decode bound, read from its /status: the cost record
    (the READY line's, held against /status), the legs on calibrate's
    numbers and on the data sheet's, the tick floor, the replayed tick's
    device ms beside it, and the ledger's reconciliation. Fails where the
    card beats a floor by more than ``_TIER_HEADROOM``: the bound would be
    wrong."""
    serving = replica.get("/status")["serving"]
    roof, rec = serving["roofline"], serving["roofline_reconciliation"]
    cost = replica.ready["decode_cost"]
    if (roof["flops"], roof["bytes_accessed"], roof["program"]) != (
            cost["flops"], cost["bytes_accessed"], cost["key_hash"]):
        raise AssertionError(f"{replica.name}: /status roofline {roof} is "
                             f"not its cost record {cost}")
    sheet = {"compute_s": cost["flops"] / _PEAK_FLOPS["float32"],
             "memory_s": cost["bytes_accessed"] / _PEAK_BYTES_PER_S,
             "dispatch_s": roof["legs"]["dispatch_s"]}
    floors = {"calibrate": roof["tick_seconds_floor"],
              "data_sheet": max(sheet.values())}
    device_ms = decode_profile["device_ms_per_tick"]
    for what, floor in floors.items():
        if device_ms / 1e3 < floor / _TIER_HEADROOM:
            raise AssertionError(
                f"{replica.name}: the replayed tick's {device_ms} device ms "
                f"beats the {what} floor {floor * 1e3} ms by more than "
                f"{_TIER_HEADROOM}x")
    ratio = rec.get("ratio")
    if ratio is not None and ratio > _TIER_HEADROOM:
        raise AssertionError(f"{replica.name}: measured decode rate is "
                             f"{ratio}x the roofline's prediction")
    return {"cost": cost, "legs_calibrate": roof["legs"],
            "bound_by_calibrate": roof["bound_by"],
            "legs_data_sheet": sheet,
            "bound_by_data_sheet": max(sheet, key=sheet.get),
            "tick_floor_ms": {k: v * 1e3 for k, v in floors.items()},
            "calibration": roof["calibration"],
            "replayed_decode_device_ms_per_tick": device_ms,
            "device_ms_over_floor": {k: device_ms / (v * 1e3)
                                     for k, v in floors.items()},
            "roofline_reconciliation": rec,
            "finding": ("the replayed tick lies beyond the roofline's "
                        "bound factor" if rec.get("verdict")
                        == "outside_bound" else None)}


def _serve_tier(torch, card, prompts, want, decode_profile, device="cuda"):
    """The serving front tier on the card: two replica processes
    (``tools/torch_serve_replica.py``, the serving config's seed-0
    params from one ``.npz``) behind a ``Router`` of ``HttpReplica``s.
    The 8 prompts at once must give the in-process replayed leg's tokens
    (``want``) bit for bit, with no bit-match mismatch; again with
    replica 1 SIGKILLed while requests are out (every request completes,
    with the same tokens, on replica 0; replica 1 is stopped with SIGSTOP
    before they are sent, so the requests it is given stay out until the
    kill); replica 1 respawned on its port
    and drained while it holds admitted work (that work finishes there,
    new work goes to replica 0, /healthz says drained); each replica's
    decode roofline read from /status beside the replayed tick
    (``_tier_roofline``); ``capacity.plan`` over the router's telemetry
    and the card's roofline, uncalibrated; then one ``Autoscaler.step``
    over a quiet window that scales 2 -> 1, drain first, while requests
    are out (none lost). Every child is killed in a ``finally``.
    ``device`` is the replicas' (the CPU in tests, at a tiny config)."""
    import shutil
    import tempfile

    from paddle_tpu_torch.serving import (GPTConfig, HttpReplica, Router,
                                          capacity, init_params)
    from paddle_tpu_torch.serving.router import DEAD, TrafficTelemetry

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(_ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="serve_tier_", dir=os.path.join(_ROOT,
                                                                    "build"))
    params_path = os.path.join(work, "params.npz")
    np.savez(params_path, **init_params(GPTConfig(**_SERVE_CFG), seed=0))
    reps = {}
    router = None
    try:
        for i in (0, 1):
            reps[i] = _Replica(i, params_path, work, device=device)
        _boot(list(reps.values()))
        boots = {r.name: {k: r.ready[k] for k in (
            "boot_seconds", "wall_to_ready_s", "params_source", "device")}
            for r in reps.values()}
        router = Router([HttpReplica(r.name, r.url) for r in reps.values()],
                        retries=3, backoff_ms=20.0, hedge_ms=0.0,
                        default_slo_s=120.0, seed=0,
                        health_interval_s=0.25, health_timeout_s=2.0)
        mismatch0 = _counter("serve_router_bitmatch_total",
                             verdict="mismatch")

        # traffic: both replicas, the replayed leg's tokens; twice, as
        # the first requests of each process pay one-time costs (the
        # HTTP client's and server's first connections and lazy imports)
        overhead = {}
        for leg in ("cold", "warm"):
            recs = _dispatch_all(router, prompts, leg)
            _hold_tokens(recs, want, f"traffic ({leg})")
            ms = _router_overhead_ms(recs)
            overhead[leg] = {"mean": statistics.mean(ms), "max": max(ms),
                             "latency_s_max": max(r["latency_s"]
                                                  for r in recs)}
        by_replica = {r.name: sum(1 for x in recs if x["replica"] == r.name)
                      for r in reps.values()}

        # failover: SIGKILL replica 1 while requests are out on it. It is
        # stopped (SIGSTOP) before they are sent, so those it is given
        # stay out until the kill, however fast it would serve them
        router.start_health()
        t_kill = {}

        def kill_replica1(futs):
            _wait_inflight(router, "replica1", futs)
            from paddle_tpu_torch import profiler

            t_kill["unix"] = profiler.span_clock_unix()
            reps[1].proc.kill()

        stats0 = dict(router.snapshot()["stats"])
        reps[1].proc.send_signal(signal.SIGSTOP)
        recs_fail = _dispatch_all(router, prompts, "failover",
                                  during=kill_replica1)
        reps[1].proc.wait(timeout=_TIER_TERM_S)
        _hold_tokens(recs_fail, want, "failover")
        stats1 = router.snapshot()["stats"]
        redispatched = [r["request_id"] for r in recs_fail if r["failover"]]
        if not redispatched:
            raise AssertionError("serve_tier failover: no request was out "
                                 "on replica 1 when it was killed")
        if any(r["replica"] != "replica0" for r in recs_fail
               if r["request_id"] in redispatched):
            raise AssertionError("a re-dispatched request did not complete "
                                 "on replica 0")
        deaths = [e for e in router.health_events if e["replica"] ==
                  "replica1" and e["to"] == DEAD and e["time_unix"]
                  >= t_kill["unix"]]
        if not deaths:
            raise AssertionError("the router never marked replica 1 dead")
        failover = {
            "killed": "replica1", "requests": len(recs_fail),
            "redispatched": len(redispatched),
            "retries": stats1["retries"] - stats0["retries"],
            "failovers": stats1["failovers"] - stats0["failovers"],
            "detection_ms": (deaths[0]["time_unix"] - t_kill["unix"]) * 1e3,
            "detected_by": deaths[0]["reason"],
            "router_overhead_ms_mean": statistics.mean(
                _router_overhead_ms(recs_fail)),
            "latency_s_max": max(r["latency_s"] for r in recs_fail)}

        # drain: respawn replica 1 on its port (replica 2, for the
        # autoscale step, boots beside it), then drain replica 1 while it
        # holds admitted work
        reps[1] = _Replica(1, params_path, work, port=reps[1].port,
                           device=device)
        reps[2] = _Replica(2, params_path, work, device=device)
        _boot([reps[1], reps[2]])
        deadline = time.perf_counter() + _TIER_LEG_S
        while router.probe_once()["replica1"] != "healthy":
            if time.perf_counter() > deadline:
                raise AssertionError("the respawned replica 1 never "
                                     "rejoined the rotation")
            time.sleep(0.1)
        drained = {}

        def drain_replica1(futs):
            _wait_admitted(reps[1], futs)
            drained["ok"] = router.drain_replica("replica1",
                                                 timeout_s=_TIER_LEG_S)

        recs_drain = _dispatch_all(router, prompts, "drain",
                                   during=drain_replica1)
        _hold_tokens(recs_drain, want, "drain")
        if not drained.get("ok"):
            raise AssertionError("replica 1 never reported drained")
        # what replica 1 had admitted finished there; a request that
        # reached it after the drain began was bounced (typed 503) and
        # re-dispatched to replica 0
        on1 = [r["request_id"] for r in recs_drain
               if r["replica"] == "replica1"]
        bounced = [r["request_id"] for r in recs_drain if r["failover"]]
        if not on1:
            raise AssertionError("drain: no admitted work finished on "
                                 "replica 1")
        after = _dispatch_all(router, prompts[:2], "after-drain")
        _hold_tokens(after, want[:2], "after drain")
        if any(r["replica"] != "replica0" for r in after):
            raise AssertionError("new work went to the drained replica")
        health1 = reps[1].get("/healthz")["serving"]
        if not health1.get("drained"):
            raise AssertionError(f"replica 1's /healthz: {health1}")
        drain = {"completed_on_replica1": len(on1),
                 "bounced_to_replica0": len(bounced),
                 "new_work_on": sorted({r["replica"] for r in after}),
                 "healthz": {k: health1[k] for k in (
                     "draining", "drained", "active", "queued")},
                 "respawn_wall_to_ready_s": reps[1].ready["wall_to_ready_s"]}

        # roofline: each replica's /status beside the replayed tick
        roofs = {r.name: _tier_roofline(r, decode_profile)
                 for r in (reps[0], reps[1])}
        reps[1].proc.terminate()  # drained: its SIGTERM stops it cleanly
        if reps[1].proc.wait(timeout=_TIER_TERM_S) != 0:
            raise AssertionError(f"replica 1 exited "
                                 f"{reps[1].proc.returncode} on SIGTERM")
        router.remove_replica("replica1")

        # plan over the router's live telemetry and the card's roofline:
        # replica 0's, at the occupancy its cost record describes (a
        # decode tick always runs max_batch rows; score_config scales the
        # compute leg by max_batch over mean_active)
        roof0 = reps[0].get("/status")["serving"]["roofline"]
        mb = float(_SERVE_ENV["max_batch"])
        roofline = dict(roof0, mean_active=mb, predicted_tokens_per_sec=(
            mb / roof0["tick_seconds_floor"]))
        report = capacity.plan(router.telemetry.snapshot(), roofline,
                               device_budget=2, tp_degrees=(1,),
                               max_batches=(_SERVE_ENV["max_batch"],),
                               tokens_per_request=_NEW_TOKENS)
        decision = report["decision"]
        plan = {"roofline_mean_active": mb,
                "verdict": decision["verdict"],
                "pick": (decision["pick"] or {}).get("spec"),
                "demand_tokens_per_sec": decision["demand_tokens_per_sec"],
                "rejected_tally": decision["rejected_tally"],
                "calibration": report["calibration"],
                "text": capacity.render_plan_text(report)}

        # one autoscale step, 2 -> 1, drain first, while the prompts are
        # out on replica 2; its window is a quiet one (the router's rate
        # EMAs move only on arrivals, so it starts a fresh telemetry once
        # the prompts have arrived)
        router.add_replica(HttpReplica(reps[2].name, reps[2].url))
        router.probe_once()
        stopped = {}

        def stop_replica(name):
            r = next(x for x in reps.values() if x.name == name)
            r.proc.terminate()
            stopped[name] = r.proc.wait(timeout=_TIER_TERM_S)

        auto = capacity.Autoscaler(
            router, roofline, spawn_replica=None, stop_replica=stop_replica,
            device_budget=2, tp=1, max_batch=_SERVE_ENV["max_batch"],
            min_replicas=1, max_replicas=2, cooldown_s=0.0,
            tokens_per_request=_NEW_TOKENS)
        step = {}

        def autoscale_step(futs):
            _wait_admitted(reps[2], futs)
            router.telemetry = TrafficTelemetry()  # every arrival noted
            step["rec"] = auto.step()

        recs_auto = _dispatch_all(router, prompts, "autoscale",
                                  during=autoscale_step)
        _hold_tokens(recs_auto, want, "autoscale")
        rec = step["rec"] or {}
        actions = [d["action"] for d in auto.decisions]
        on2 = [r["request_id"] for r in recs_auto
               if r["replica"] == "replica2"]
        if (rec.get("action") != "scale_down" or not rec.get("drained")
                or actions != ["drain_start", "scale_down"]
                or stopped != {"replica2": 0}
                or router.replica_names() != ["replica0"] or not on2):
            raise AssertionError(
                f"autoscale: {rec}, actions {actions}, stopped {stopped}, "
                f"replicas {router.replica_names()}, on replica 2 {on2}")
        autoscale = {"actions": actions, "drained": rec["drained"],
                     "failovers": sum(1 for r in recs_auto
                                      if r["failover"]),
                     "from_replicas": auto.decisions[0]["from_replicas"],
                     "to_replicas": rec["to_replicas"],
                     "plan": auto.current_plan,
                     "completed_on_replica2": len(on2),
                     "requests_lost": 0, "stopped_exit_codes": stopped}

        mismatch = _counter("serve_router_bitmatch_total",
                            verdict="mismatch") - mismatch0
        if mismatch:
            raise AssertionError(f"{mismatch} bit-match mismatches")
        _say(phase="serve_tier", replicas_booted=boots,
             requests=len(prompts), new_tokens=_NEW_TOKENS,
             tokens_equal_in_process_replayed=True,
             bitmatch_mismatch=mismatch,
             bitmatch_checked=router.snapshot()["stats"]["bitmatch_checked"],
             traffic={"by_replica": by_replica,
                      "router_overhead_ms": overhead,
                      "overhead_note": "router wall minus the winning "
                      "attempt's engine_e2e_s, a request"},
             failover=failover, health_events=router.health_events,
             drain=drain, roofline=roofs, plan=plan, autoscale=autoscale,
             seconds=time.perf_counter() - t_phase, card=card)
    finally:
        if router is not None:
            router.stop()
        for r in reps.values():
            r.kill()
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# train_observed: the seq-2048 step with the step-side observability on
# ---------------------------------------------------------------------------

_OBSERVED_STEPS = 6
_EPOCHS, _EPOCH_STEPS = 2, 3
# compiled_insights()'s FLOPs over the analytic count of the step: the
# products are counted exactly on both sides and the kernels report the
# same formulas, so only a product outside the analytic count (or one
# counted twice) moves the ratio
_FLOPS_BAND = (0.99, 1.01)
_WATERMARK_REL = 0.01  # memwatch's peak against the allocator's own
_OBSERVED_DIR = os.path.join(_ROOT, "build", "observed")


def _observed_dirs(root) -> dict:
    return {"PADDLE_TPU_GOODPUT_DIR": os.path.join(root, "goodput"),
            "PADDLE_TPU_MEMWATCH_DIR": os.path.join(root, "memwatch"),
            "PADDLE_TPU_DYNAMICS_DIR": os.path.join(root, "dynamics"),
            "PADDLE_TPU_XLA_DUMP_DIR": os.path.join(root, "dump")}


@contextlib.contextmanager
def _env(**values):
    """The environment with ``values`` set (None: unset), restored on
    exit."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fresh_ledgers(dirs=None) -> None:
    """goodput's, memwatch's and dynamics' ledgers emptied, each journal
    persisted under ``dirs`` (``_observed_dirs``) or nowhere."""
    from paddle_tpu_torch import dynamics, goodput, memwatch

    for mod, key in ((goodput, "PADDLE_TPU_GOODPUT_DIR"),
                     (memwatch, "PADDLE_TPU_MEMWATCH_DIR"),
                     (dynamics, "PADDLE_TPU_DYNAMICS_DIR")):
        mod.disable_persistence()
        mod.reset()
        if dirs is not None:
            os.makedirs(dirs[key], exist_ok=True)
            mod.configure(dir=dirs[key])


@contextlib.contextmanager
def _observed(root):
    """Every A9 flag on: the three journals and the program dumps under
    ``root``, the numerics sentinel; the ledgers fresh on entry and
    again on exit (persistence off)."""
    dirs = _observed_dirs(root)
    with _env(PADDLE_TPU_CHECK_NUMERICS="1", PADDLE_TPU_XLA_INSIGHT="1",
              PADDLE_TPU_MEMWATCH="1", PADDLE_TPU_DYNAMICS="1", **dirs):
        _fresh_ledgers(dirs)
        try:
            yield dirs
        finally:
            _fresh_ledgers()


def _flags_off():
    """Every A9 flag off: no sentinel, insight, memwatch or dynamics, no
    journal or dump."""
    return _env(PADDLE_TPU_CHECK_NUMERICS=None, PADDLE_TPU_XLA_INSIGHT="0",
                PADDLE_TPU_MEMWATCH="0", PADDLE_TPU_DYNAMICS="0",
                **{k: None for k in _observed_dirs("")})


def _grad_names(main) -> list:
    """The gradient of each parameter, in the program's parameter order."""
    block = main.global_block()
    names = [p.name + "@GRAD" for p in main.all_parameters()]
    return [n for n in names if block._find_var_recursive(n) is not None]


def _observed_steps(torch, exe, scope, program, feed, steps, first=0,
                    close=True):
    """``steps`` steps of ``program`` (main, startup, io), each fetching
    the loss and every gradient. With ``close``, each step then feeds
    dynamics (the loss, ``grad_health`` over the fetched gradients, the
    learning rate) and closes the goodput step (which closes memwatch's
    and dynamics' too), numbered from ``first``. Returns the losses, the
    run's host wall and, on the card, its CUDA-event ms, the closed
    goodput steps and each run's phase."""
    from paddle_tpu_torch import dynamics, goodput

    main, _, io = program
    names = _grad_names(main)
    cuda = exe.device.type == "cuda"
    out = {"losses": [], "run_ms": [], "event_ms": [], "closed": [],
           "phases": [], "grad_norms": [], "nonfinite_grads": []}
    lr = float(io["optimizer"]._learning_rate)
    for i in range(steps):
        before = dict(exe.phases)
        t0 = time.perf_counter()
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        got = exe.run(main, feed=feed, fetch_list=[io["loss"]] + names,
                      scope=scope, return_numpy=False)
        if cuda:
            ev[1].record()
        loss = float(got[0])  # the host read: synced
        run_s = time.perf_counter() - t0
        out["losses"].append(loss)
        out["run_ms"].append(run_s * 1e3)
        if cuda:
            out["event_ms"].append(ev[0].elapsed_time(ev[1]))
        # the eager route (the CPU, PADDLE_TPU_EAGER) counts no phase
        out["phases"].append(next((k for k in exe.phases
                                   if exe.phases[k] != before[k]), "eager"))
        if close:
            norm, bad = dynamics.grad_health(zip(names, got[1:]))
            dynamics.feed(loss=loss, grad_norm=norm, lr=lr)
            out["grad_norms"].append(norm)
            out["nonfinite_grads"].append(bad)
            out["closed"].append(goodput.end_step(
                time.perf_counter() - t0,
                samples=float(feed["tokens"].numel()), step=first + i))
    return out


def _goodput_split(closed, phases) -> dict:
    """Holds each closed goodput step against the executor's phase of its
    run: a run that built (the warm-up, "eager", and the capture) is
    charged to ``compile`` and nothing to ``device_compute``; a replay
    the other way round. Raises at the first step that breaks this;
    returns the compile and device seconds by phase."""
    if len(closed) != len(phases):
        raise AssertionError(f"goodput: {len(closed)} closed steps for "
                             f"{len(phases)} runs")
    by = {}
    for i, (c, phase) in enumerate(zip(closed, phases)):
        built = phase in ("eager", "capture")
        comp, dev = c.get("compile", 0.0), c.get("device_compute", 0.0)
        if built != (comp > 0) or built == (dev > 0):
            raise AssertionError(
                f"goodput: step {i} ran as {phase!r} but was charged "
                f"{comp:.6f} s to compile and {dev:.6f} s to "
                f"device_compute")
        row = by.setdefault(phase, {"compile_s": 0.0, "device_compute_s": 0.0})
        row["compile_s"] += comp
        row["device_compute_s"] += dev
    return by


def _analytic_step_flops(config, batch, seq, n_params, flash=True,
                         plain=False) -> dict:
    """The FLOPs of one training step of the GPT program, from the
    config: each layer's q, k, v, projection and two MLP matmuls (24 N D^2
    forward, twice that backward); the lm head + CE (2NVD forward, 4NVD
    each for dx and dW); attention, 2 Dh FLOPs per score for each of its
    products per head and layer (flash: 2 forward + 3 dq + 4 dk/dv;
    einsum: 2 forward + 4 backward), over the visible causal scores as
    the kernels count them, or over all T^2 as the plain versions compute
    them (``plain``, the CPU); Adam's 15 FLOPs an element as its kernel
    reports them (none where ``plain``: the plain Adam has no product)."""
    n, d = batch * seq, config["d_model"]
    layers, heads = config["n_layer"], config["n_head"]
    v = config["vocab_size"]
    dh = d // heads
    scores = seq * seq if plain or not flash else seq * (seq + 1) // 2
    terms = {"matmul": 72.0 * n * d * d * layers,
             "lmhead_ce": 10.0 * n * v * d,
             "attention": ((9 if flash else 6) * 2.0 * dh * batch * heads
                           * scores * layers),
             "adam": 0.0 if plain else 15.0 * n_params}
    terms["total"] = sum(terms.values())
    return terms


def _insight_agrees(insights, analytic, band=_FLOPS_BAND) -> dict:
    """One record for the one entry, its FLOPs within ``band`` of the
    analytic count; returns the ratio and the record's parts."""
    if len(insights) != 1:
        raise AssertionError(f"insight: {len(insights)} records for one "
                             f"program entry")
    rec = insights[0]
    ratio = rec["flops"] / analytic["total"]
    if not band[0] <= ratio <= band[1]:
        raise AssertionError(f"insight: {rec['flops']:.6g} FLOPs, "
                             f"{ratio:.4f}x the analytic {analytic}, "
                             f"outside {band}")
    return {"ratio": ratio, "flops": rec["flops"],
            "product_flops": rec["cost_raw"].get("product flops"),
            "kernel_flops": rec["cost_raw"].get("kernel flops"),
            "peak_bytes": rec["peak_bytes"], "key_hash": rec["key_hash"]}


def _memwatch_agrees(totals, max_allocated, steps) -> dict:
    """memwatch's lifetime peak within ``_WATERMARK_REL`` of the
    allocator's, no leak episode, one journal record a step."""
    peak = totals["lifetime_peak_bytes"]
    rel = abs(peak - max_allocated) / max_allocated
    if rel > _WATERMARK_REL:
        raise AssertionError(f"memwatch: peak {peak} vs the allocator's "
                             f"{max_allocated} ({rel:.4f} apart)")
    if totals["leak_events"]:
        raise AssertionError(f"memwatch: {totals['leak_events']} leak "
                             f"episodes over {steps} steps")
    if totals["steps"] != steps or len(totals["step_series"]) != steps:
        raise AssertionError(f"memwatch: {totals['steps']} steps, "
                             f"{len(totals['step_series'])} records, "
                             f"for {steps} steps")
    return {"lifetime_peak_bytes": peak, "max_memory_allocated":
            max_allocated, "rel": rel, "leak_events": 0, "steps": steps}


def _names_op(err, op_idx, op_type, typed=True) -> dict:
    """The sentinel's error names the op: typed InvalidArgument with the
    op's provenance (index and type) and its index and type in the
    message (``typed``), or the legacy flag's FloatingPointError."""
    from paddle_tpu_torch.framework import errors

    msg = str(err)
    want = f"op #{op_idx} {op_type!r}"
    if typed:
        prov = getattr(err, "op_provenance", None)
        if (not isinstance(err, errors.InvalidArgumentError) or prov is None
                or prov.op_idx != op_idx or prov.op_type != op_type
                or want not in msg):
            raise AssertionError(f"sentinel: {type(err).__name__}: {msg} "
                                 f"does not name {want}")
    elif not isinstance(err, FloatingPointError) or want not in msg:
        raise AssertionError(f"FLAGS_check_nan_inf: {type(err).__name__}: "
                             f"{msg} does not name {want}")
    return {"op_idx": op_idx, "op_type": op_type,
            "error": type(err).__name__}


def _first_reader(main, name):
    """(index, type) of the first op of the block that reads ``name``."""
    for i, op in enumerate(main.global_block().ops):
        if name in op.input_arg_names():
            return i, op.type
    raise AssertionError(f"no op reads {name!r}")


def _poisoned(torch, exe, scope, program, feed, name, row) -> dict:
    """One step (``_observed_steps``' fetches, so a replay where that
    step was captured) after one ``inf`` is written into ``scope``'s
    ``name`` (in place, at [row, 0]) must raise the sentinel's error
    naming the first op that reads it."""
    main, _, io = program
    with torch.no_grad():
        scope.get(name)[row, 0] = float("inf")
    op_idx, op_type = _first_reader(main, name)
    phases = dict(exe.phases)
    try:
        exe.run(main, feed=feed, fetch_list=[io["loss"]] + _grad_names(main),
                scope=scope)
    except Exception as e:  # noqa: BLE001 - held by _names_op
        got = _names_op(e, op_idx, op_type)
    else:
        raise AssertionError(f"sentinel: the poisoned step of {name!r} "
                             f"raised nothing")
    # the eager route (the CPU, PADDLE_TPU_EAGER) counts no phase
    got["phase"] = next((k for k in exe.phases if exe.phases[k] !=
                         phases[k]), "eager")
    return got


def _epochs(torch, exe_of, program, start, feed, ckpt, name, stop_at=None,
            resume=False, first=0):
    """``TrainEpochRange(_EPOCHS, name)`` over ``_EPOCH_STEPS`` steps an
    epoch, on a fresh executor and scope from ``start`` (or, resumed,
    from the checkpoint alone), closing a goodput step each; stops when
    the range yields ``stop_at`` (a crash at that epoch's start). Returns
    the losses."""
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.incubate.checkpoint.auto_checkpoint import (
        TrainEpochRange)

    exe, scope = exe_of(), Scope()
    if not resume:
        for n, t in start.items():
            scope.set(n, t.clone())
    losses = []
    for epoch in TrainEpochRange(_EPOCHS, name, checkpoint_dir=ckpt,
                                 exe=exe, program=program[0], scope=scope,
                                 resume=resume):
        if epoch == stop_at:
            break
        out = _observed_steps(torch, exe, scope, program, feed,
                              _EPOCH_STEPS,
                              first=first + epoch * _EPOCH_STEPS)
        losses += out["losses"]
    return losses


def _recovery(torch, exe_of, program, start, feed, root) -> dict:
    """The epoch loop uninterrupted, then crashed at epoch 1's start and
    restarted on a fresh executor and scope, with the ledgers re-resumed
    from their journals as a restarted process would: the losses must
    equal bit for bit, and ``recovery.drift_audit`` must pass on the
    goodput and dynamics documents before the crash and after."""
    from paddle_tpu_torch import dynamics, goodput, recovery

    dirs = _observed_dirs(os.path.join(root, "epochs"))
    _fresh_ledgers()
    whole = _epochs(torch, exe_of, program, start, feed,
                    os.path.join(root, "ckpt"), "whole")
    _fresh_ledgers(dirs)
    crashed = _epochs(torch, exe_of, program, start, feed,
                      os.path.join(root, "ckpt"), "crash", stop_at=1)
    before = {"goodput": goodput.load_journal(goodput.flush()),
              "dynamics": dynamics.load_journal(dynamics.flush())}
    _fresh_ledgers(dirs)  # the restarted process resumes its journals
    resumed = _epochs(torch, exe_of, program, start, feed,
                      os.path.join(root, "ckpt"), "crash", resume=True)
    after = {"goodput": goodput.load_journal(goodput.flush()),
             "dynamics": dynamics.load_journal(dynamics.flush())}
    _fresh_ledgers()
    if crashed + resumed != whole:
        raise AssertionError(f"TrainEpochRange: resumed losses "
                             f"{crashed + resumed} vs uninterrupted {whole}")
    audit = recovery.drift_audit(
        goodput_before=before["goodput"], goodput_after=after["goodput"],
        dynamics_before=before["dynamics"],
        dynamics_after=after["dynamics"])
    if not audit["ok"]:
        raise AssertionError(f"drift audit: {recovery.render_audit(audit)}")
    return {"losses": whole, "bit_identical": True,
            "audit": [c["check"] for c in audit["checks"] if c["ok"]]}


def _sentinel_agrees(torch, program, start, feed, device, steps) -> dict:
    """The sentinel on, replayed (the staged route on the CPU) and eager
    from one start: the losses must equal bit for bit."""
    from paddle_tpu_torch.framework import Scope

    runs = {}
    with _env(PADDLE_TPU_CHECK_NUMERICS="1"):
        for leg in ("replayed", "eager"):
            scope = Scope()
            for n, t in start.items():
                scope.set(n, t.clone())
            exe = _executor(device)
            exe.staged = leg == "replayed" and device == "cpu"
            with _eager() if leg == "eager" else contextlib.nullcontext():
                runs[leg] = _observed_steps(torch, exe, scope, program, feed,
                                            steps, close=False)
            del exe, scope
    if runs["replayed"]["losses"] != runs["eager"]["losses"]:
        raise AssertionError(f"sentinel: replayed losses "
                             f"{runs['replayed']['losses']} vs eager "
                             f"{runs['eager']['losses']}")
    return {"losses": runs["eager"]["losses"], "bit_identical": True,
            "phases": runs["replayed"]["phases"]}


def _sentinel_seq512(torch, card, config=_TRAIN, batch=_TRAIN_B,
                     seq=_TRAIN_T, device="cuda", steps=4) -> dict:
    """``_sentinel_agrees`` on the seq-512 step (the seq-2048 one is in
    ``_train_observed``)."""
    from paddle_tpu_torch.framework import Scope

    t0 = time.perf_counter()
    program = _train_program(config, batch, seq)
    scope = Scope()
    _executor(device).run(program[1], scope=scope)
    start = {v.name: scope.get(v.name).detach().clone()
             for v in program[0].list_vars() if v.persistable}
    del scope
    feed = _fixed_batch(torch, config["vocab_size"], batch, seq, device)
    got = _sentinel_agrees(torch, program, start, feed, device, steps)
    _say(phase="train_observed_seq512", seq=seq, steps=steps,
         seconds=time.perf_counter() - t0, card=card, **got)
    return got


def _status_sections() -> dict:
    """A status server's /status: ``memory`` and ``dynamics`` are the
    ported modules' documents; ``comms`` is still not ported."""
    import urllib.request

    from paddle_tpu_torch import dynamics, memwatch, status

    status.start_status_server(port=0)
    try:
        url = f"http://127.0.0.1:{status.server_port()}/status"
        with urllib.request.urlopen(url, timeout=30) as r:
            doc = json.loads(r.read())
    finally:
        status.stop_status_server()
    if (doc["memory"].get("schema") != memwatch.SCHEMA
            or doc["dynamics"].get("schema") != dynamics.SCHEMA
            or doc["comms"] != {"available": False, "not_ported": "A12"}):
        raise AssertionError(f"/status sections: memory "
                             f"{doc['memory']}, dynamics {doc['dynamics']}, "
                             f"comms {doc['comms']}")
    return {"memory_steps": doc["memory"]["steps"],
            "dynamics_steps": doc["dynamics"]["steps"]}


def _sample_ms(torch, device, calls=20) -> float:
    """Median host ms of one memwatch sample on ``device``."""
    from paddle_tpu_torch import memwatch

    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        memwatch.sample(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _train_observed(torch, card, config=_LONG, batch=_LONG_B, seq=_LONG_T,
                    device="cuda", steps=_OBSERVED_STEPS, root=_OBSERVED_DIR):
    """bench.py's gpt2s step at seq 2048 with every A9 flag on (journals
    and dumps under ``root``, the numerics sentinel), replayed for
    ``steps`` steps, each fetching every gradient, feeding dynamics and
    closing a goodput step; beside the same steps with every flag off.
    Checks: the losses equal bit for bit; the kernels' launches (from 0:
    the warm-up and the capture); goodput's compile and device split
    (``_goodput_split``); memwatch against the allocator
    (``_memwatch_agrees``); one dynamics record and journal line a step;
    ``compiled_insights`` against the analytic FLOPs
    (``_insight_agrees``) and its dump (cost.json, the op list, the
    captured graph's DOT on the card); a poisoned weight raising the
    sentinel's error at the op that reads it, replayed and eagerly; the
    epoch loop's recovery (``_recovery``); /status's sections. Prints
    the sentinel's and memwatch's cost a step; returns the launches."""
    import gc

    from paddle_tpu_torch import dynamics, memwatch
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.framework import xla_insight as insight
    from paddle_tpu_torch.ops import flash_attention as fl
    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import lmhead_ce as ce

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    if os.path.isdir(root):
        shutil.rmtree(root)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    program = _train_program(config, batch, seq)
    main, startup, io = program
    scope = Scope()
    staged = not cuda

    def exe_of():
        exe = _executor(device)
        exe.staged = staged
        return exe

    exe_of().run(startup, scope=scope)
    start = {v.name: scope.get(v.name).detach().clone()
             for v in main.list_vars() if v.persistable}
    del scope
    feed = _fixed_batch(torch, config["vocab_size"], batch, seq, device)
    n_params = sum(int(np.prod(p.shape)) for p in main.all_parameters())

    def leg():
        s = Scope()
        for n, t in start.items():
            s.set(n, t.clone())
        return exe_of(), s

    with _flags_off():
        exe, scope = leg()
        off = _observed_steps(torch, exe, scope, program, feed, steps,
                              close=False)
    del exe, scope
    gc.collect()

    flash = seq >= int(os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ", 1024))
    per_step = {"lmhead_ce_fwd": 1, "lmhead_ce_dx": 1, "lmhead_ce_dw": 1,
                "fused_adam": _ADAM_PER_STEP,
                "flash_attention_fwd": config["n_layer"] if flash else 0,
                "flash_attention_dq": config["n_layer"] if flash else 0,
                "flash_attention_dkv": config["n_layer"] if flash else 0}
    with _observed(root) as dirs:
        exe, scope = leg()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # the main path, counted: every count starts from 0 here
        ce.reset_launches()
        fa.reset_launches()
        fl.reset_launches()
        on = _observed_steps(torch, exe, scope, program, feed, steps)
        launches = {"lmhead_ce_fwd": ce.launches,
                    "lmhead_ce_dx": ce.dx_launches,
                    "lmhead_ce_dw": ce.dw_launches,
                    "fused_adam": fa.launches,
                    "flash_attention_fwd": fl.fwd_launches,
                    "flash_attention_dq": fl.dq_launches,
                    "flash_attention_dkv": fl.dkv_launches}
        if on["losses"] != off["losses"]:
            raise AssertionError(f"train_observed: losses with every flag "
                                 f"on {on['losses']} vs off {off['losses']}")
        want_phases = ["eager", "capture"] + ["replay"] * (steps - 2)
        if on["phases"] != want_phases or off["phases"] != want_phases:
            raise AssertionError(f"train_observed: phases on "
                                 f"{on['phases']}, off {off['phases']}")
        # the CPU runs the plain versions, which launch nothing
        want = {k: 2 * n if cuda else 0 for k, n in per_step.items()}
        if launches != want:
            raise AssertionError(f"train_observed: launches {launches}, "
                                 f"expected {want} over the warm-up and "
                                 f"the capture")
        split = _goodput_split(on["closed"], on["phases"])
        if any(on["nonfinite_grads"]):
            raise AssertionError(f"train_observed: non-finite gradients "
                                 f"{on['nonfinite_grads']}")
        max_alloc = (torch.cuda.max_memory_allocated() if cuda else
                     memwatch.totals()["lifetime_peak_bytes"])
        mem = _memwatch_agrees(memwatch.totals(), max_alloc, steps)
        mem_journal = memwatch.load_journal(memwatch.flush())
        dyn = dynamics.totals()
        dyn_journal = dynamics.flush()
        with open(dyn_journal) as f:
            dyn_lines = sum(1 for line in f if line.strip()) - 1
        if (dyn["steps"] != steps or len(dyn["series"]) != steps
                or dyn_lines != steps or len(mem_journal["step_series"])
                != steps):
            raise AssertionError(f"train_observed: dynamics {dyn['steps']} "
                                 f"steps, {len(dyn['series'])} records, "
                                 f"{dyn_lines} journal lines; memwatch "
                                 f"journal {len(mem_journal['step_series'])}"
                                 f" records, for {steps} steps")
        if [r.get("loss") for r in dyn["series"]] != on["losses"]:
            raise AssertionError("train_observed: dynamics' losses are not "
                                 "the steps'")
        analytic = _analytic_step_flops(config, batch, seq, n_params, flash,
                                        plain=not cuda)
        ins = _insight_agrees(exe.compiled_insights(), analytic)
        probes = sum(len(e.probes.sites) for e in exe._cache.values()
                     if e.probes is not None)
        dumped = insight.load_dump_dir(dirs["PADDLE_TPU_XLA_DUMP_DIR"])
        kinds = ("ops", "dot") if cuda else ("ops",)
        rec = dumped.get(exe.compiled_insights()[0]["key_hash"])
        if rec is None or any(k not in rec["artifacts"] for k in kinds):
            raise AssertionError(f"train_observed: dump {dumped}")
        cost = os.path.join(dirs["PADDLE_TPU_XLA_DUMP_DIR"],
                            f"program.{rec['key_hash']}.cost.json")
        if any(os.path.getmtime(rec["artifacts"][k]) > os.path.getmtime(cost)
               for k in kinds):
            raise AssertionError("train_observed: cost.json not written last")
        status_doc = _status_sections()
        sample_ms = _sample_ms(torch, exe.device)
        row = int(feed["tokens"].reshape(-1)[0])
        poisoned = {"replayed": _poisoned(torch, exe, scope, program, feed,
                                          "gpt.wte", row)}
        if poisoned["replayed"]["phase"] != "replay":
            raise AssertionError(f"train_observed: the poisoned step ran as "
                                 f"{poisoned['replayed']['phase']!r}")
        del exe, scope
        gc.collect()
        with _eager():
            exe, scope = leg()
            exe.staged = False
            poisoned["eager"] = _poisoned(torch, exe, scope, program, feed,
                                          "gpt.wte", row)
        del exe, scope
        gc.collect()
        recovery = _recovery(torch, exe_of, program, start, feed, root)
    sentinel = _sentinel_agrees(torch, program, start, feed, device, steps)
    if sentinel["losses"] != on["losses"]:
        raise AssertionError(f"train_observed: sentinel legs "
                             f"{sentinel['losses']} vs {on['losses']}")
    replays = slice(2, None)
    cost_ms = {
        "run_ms_off": statistics.median(off["run_ms"][replays]),
        "run_ms_on": statistics.median(on["run_ms"][replays]),
        "memwatch_sample_ms": sample_ms,
        "memwatch_ms_per_step": sample_ms,
        "note": "run_ms: Executor.run's host wall of a replayed step "
                "(median of the replays), which fetches the loss and "
                "every gradient; on - off is the sentinel's cost (the "
                "insight, goodput and memwatch add nothing to a replayed "
                "run below the sampling cadence); memwatch samples once "
                "a closed step (its end_step), memwatch_sample_ms each"}
    cost_ms["sentinel_ms_per_step"] = cost_ms["run_ms_on"] - \
        cost_ms["run_ms_off"]
    if cuda:
        cost_ms["event_ms_off"] = statistics.median(off["event_ms"][replays])
        cost_ms["event_ms_on"] = statistics.median(on["event_ms"][replays])
        cost_ms["sentinel_device_ms_per_step"] = (cost_ms["event_ms_on"]
                                                  - cost_ms["event_ms_off"])
    report = dict(phase="train_observed", config=config, batch=batch,
                  seq=seq, steps=steps, losses=on["losses"],
                  bit_identical_to_flags_off=True, launches=launches,
                  goodput_by_phase=split, memwatch=mem,
                  dynamics={"steps": dyn["steps"], "journal_lines":
                            dyn_lines, "grad_norms": on["grad_norms"]},
                  insight=ins, analytic_flops=analytic, probes=probes,
                  poisoned=poisoned, recovery=recovery, status=status_doc,
                  sentinel_replayed_vs_eager=sentinel,
                  cost_ms=cost_ms, seconds=time.perf_counter() - t_phase,
                  card=card)
    _say(**report)
    return launches


def _autopsy(err, exe) -> dict:
    """The OOM post-mortem contract: typed ResourceExhausted, a blamed op
    (provenance), a footprint by layer, a post-mortem JSON on disk that
    blames the same op."""
    from paddle_tpu_torch import memwatch
    from paddle_tpu_torch.framework import errors

    prov = getattr(err, "op_provenance", None)
    report = getattr(err, "memory_report", None) or {}
    path = getattr(err, "postmortem_path", None)
    doc = None
    if path and os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    cause = err.__cause__
    got = {"typed": isinstance(err, errors.ResourceExhaustedError),
           "blamed_op": prov and prov.op_type, "blamed_idx": prov and
           prov.op_idx,
           "footprint_bytes": (report.get("footprint") or {}).get(
               "total_bytes"),
           "postmortem": path,
           "postmortem_blame": (doc or {}).get("blame", {}).get("op_type"),
           "in_capture": any("capturing" in n for n in
                             getattr(cause, "__notes__", ())),
           "phases": dict(exe.phases), "message": str(err)[:300]}
    got["ok"] = bool(got["typed"] and got["blamed_op"]
                     and got["footprint_bytes"] and doc is not None
                     and doc.get("schema") == memwatch.POSTMORTEM_SCHEMA
                     and got["postmortem_blame"] == got["blamed_op"])
    return got


def _oom_child() -> int:
    """``chip_smoke.py --oom-child``: the seq-2048 step under a memory
    cap it cannot fit, twice: the cap below the warm-up's need ("run"),
    then the warm-up run uncapped and the cap at what the process holds,
    so the capture's own pool cannot grow ("capture"). Each must raise
    memwatch's typed error (``_autopsy``). Prints one JSON line; exits 0
    only if both did."""
    import gc

    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.framework import Scope

    paddle_tpu_torch.enable_static()  # the step is a static program
    total = torch.cuda.get_device_properties(0).total_memory
    dump = os.path.join(_OBSERVED_DIR, "oom")
    os.makedirs(dump, exist_ok=True)
    os.environ["PADDLE_TPU_XLA_DUMP_DIR"] = dump
    program = _train_program(_LONG, _LONG_B, _LONG_T)
    main, startup, io = program
    feed = _fixed_batch(torch, _LONG["vocab_size"], _LONG_B, _LONG_T)
    scope = Scope()
    _executor("cuda").run(startup, scope=scope)
    cases = {}

    def capped(extra):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(
            min(1.0, (torch.cuda.memory_reserved() + extra) / total))

    for case in ("run", "capture"):
        exe = _executor("cuda")
        if case == "capture":  # the warm-up, uncapped
            exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
        capped(256 << 20 if case == "run" else 64 << 20)
        try:
            exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
        except Exception as e:  # noqa: BLE001 - the expected error, held
            cases[case] = _autopsy(e, exe)
        else:
            cases[case] = {"ok": False, "raised": None,
                           "phases": dict(exe.phases)}
        torch.cuda.set_per_process_memory_fraction(1.0)
        del exe
    ok = all(c["ok"] for c in cases.values())
    _say(phase="oom_child", ok=ok, cases=cases,
         total_memory=total)
    return 0 if ok else 1


def _oom_autopsy(card) -> dict:
    """Runs ``_oom_child`` in a child process (a capture that fails may
    leave its stream unusable) and holds its verdict."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--oom-child"], cwd=_ROOT, capture_output=True,
                          text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    doc = json.loads(lines[-1]) if lines else {}
    if proc.returncode != 0 or not doc.get("ok"):
        raise AssertionError(f"oom child: exit {proc.returncode}, {doc}; "
                             f"stderr tail {proc.stderr[-3000:]}")
    _say(phase="train_observed_oom", cases=doc["cases"],
         seconds=time.perf_counter() - t0, card=card)
    return doc


# -- train_recipe: the GPT pretraining recipe -------------------------------

# bench.py's gpt2s at seq 2048 run the way a team pretrains it: attention
# dropout 0.1 under a program seed, recompute with one checkpoint a layer,
# AdamW (lr 1e-4, decoupled decay 0.01) behind a global-norm clip at 1.0
_RECIPE = dict(_LONG, dropout=0.1)
_RECIPE_SEED = 2024
_RECIPE_CLIP = 1.0
_RECIPE_WD = 0.01
_RECIPE_STEPS = 13
_RECIPE_SIGMAS = 5.0  # the keep share's band around 1 - p, in sigmas
_RECOMPUTE_RTOL = 1e-5  # tests/test_recompute.py:55,102
_CHUNKED_RTOL = 2e-2  # bf16 rounding of the two loss routes
# the seq-512 step of each remaining optimizer: (class, keywords)
_RECIPE_OPTIMIZERS = [
    ("Momentum", dict(learning_rate=1e-3, momentum=0.9)),
    ("Adagrad", dict(learning_rate=1e-3)),
    ("Adamax", dict(learning_rate=1e-4)),
    ("RMSProp", dict(learning_rate=1e-4, centered=True, momentum=0.5)),
    ("Adadelta", dict(learning_rate=1.0)),
    ("Lamb", dict(learning_rate=1e-4)),
    ("LarsMomentum", dict(learning_rate=1e-2)),
    ("DGCMomentumOptimizer", dict(learning_rate=1e-3, momentum=0.9,
                                  rampup_begin_step=1)),
]
_OPTIMIZER_STEPS = 3


def _gpt_program(config, batch, seq, make_opt, checkpoints=False,
                 seed=None):
    """(main, startup, io): bench.py's GPT training program built under a
    fresh unique-name generator, ``make_opt()`` (its optimizer, in
    ``io["optimizer"]``) minimizing the loss, through a
    ``RecomputeOptimizer`` over one checkpoint a layer where
    ``checkpoints``; ``seed`` the program's random seed."""
    from paddle_tpu_torch.distributed.fleet import RecomputeOptimizer
    from paddle_tpu_torch.framework import program_guard, unique_name
    from paddle_tpu_torch.models.gpt import GPTConfig, build_train_program

    with unique_name.guard():
        main, startup, io = build_train_program(GPTConfig(**config),
                                                batch=batch, seq=seq)
        main.random_seed = seed
        with program_guard(main, startup):
            io["optimizer"] = opt = make_opt()
            if checkpoints:
                opt = RecomputeOptimizer(opt, {"checkpoints": [
                    v.name for v in io["checkpoints"]]})
            opt.minimize(io["loss"])
    return main, startup, io


def _recipe_program(config, batch, seq, recompute=True,
                    clip_norm=_RECIPE_CLIP):
    """The recipe's program (``_RECIPE``'s optimizer and clip, recompute
    where ``recompute``), with the global norm and the clip's scale
    (``io["global_norm"]``, ``io["clip_scale"]``: the outputs of the
    clip's one ``sqrt`` and one ``elementwise_div``) and the first
    layer's attention output after dropout (``io["attention"]``)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    program = _gpt_program(
        config, batch, seq, lambda: AdamW(
            learning_rate=_LR, weight_decay=_RECIPE_WD,
            grad_clip=ClipGradByGlobalNorm(clip_norm)),
        checkpoints=recompute, seed=_RECIPE_SEED)
    main, _, io = program
    ops = main.global_block().ops

    def out(op_type, slot="Out"):
        hits = [op.output(slot)[0] for op in ops if op.type == op_type]
        return hits[0]

    io["global_norm"] = out("sqrt")
    io["clip_scale"] = out("elementwise_div")
    io["attention"] = out("fused_attention_tpu")
    if io["lm_head_impl"] != "pallas":
        raise AssertionError(f"recipe loss path {io['lm_head_impl']!r}")
    return program


def _recipe_trajectory(torch, exe, scope, program, feed, steps) -> dict:
    """``steps`` steps of the recipe, each fetching the loss, the global
    norm, the clip's scale and the first layer's attention output after
    dropout: each step's loss, norm and scale, the dropout's keep share
    (the output's non-zero share), whether its mask differs from the last
    step's, and the host wall; then every persistable of ``scope`` and
    the executor's (seed, step) tensor (``state``) and the runs by
    phase."""
    main, _, io = program
    fetch = [io["loss"], io["global_norm"], io["clip_scale"],
             io["attention"]]
    before = dict(exe.phases)
    out = {"losses": [], "norms": [], "scales": [], "keep": [],
           "masks_differ": [], "step_s": []}
    last = None
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, norm, scale, attn = exe.run(main, feed=feed, scope=scope,
                                          fetch_list=fetch,
                                          return_numpy=False)
        out["losses"].append(float(loss))  # the host read: synced
        out["step_s"].append(time.perf_counter() - t0)
        out["norms"].append(float(norm))
        out["scales"].append(float(scale))
        mask = attn != 0
        out["keep"].append(float(mask.float().mean()))
        if last is not None:
            out["masks_differ"].append(bool((mask != last).any()))
        last = mask
    out["mask_elements"] = int(last.numel())
    out["state"] = {n: scope.get(n) for n in sorted(scope.local_var_names())}
    out["state"]["(seed, step)"] = exe.seed_step.clone()
    out["phases"] = {k: exe.phases[k] - before[k] for k in before}
    return out


def _keep_share_ok(keep, p, n, sigmas=_RECIPE_SIGMAS) -> dict:
    """Each step's keep share within ``sigmas`` binomial standard
    deviations of 1 - p over ``n`` elements; raises otherwise."""
    sd = (p * (1.0 - p) / n) ** 0.5
    off = [abs(k - (1.0 - p)) / sd for k in keep]
    if not all(np.isfinite(off)) or max(off) > sigmas:
        raise AssertionError(f"dropout keeps {keep} of {n} elements a "
                             f"step, {max(off):.2f} sigma from {1 - p} "
                             f"(band {sigmas} sigma, sigma {sd:.3g})")
    return {"keep_share": keep, "sigma": sd, "worst_sigmas": max(off),
            "band_sigmas": sigmas}


def _clip_agrees(norms, scales, clip) -> dict:
    """Each step's clip scale is clip / max(norm, clip) as the program
    computes it (the norm widened to fp32, an fp32 division: equal to the
    last bit), so min(1, clip / norm); and the norm exceeded the clip at
    least once, so that the clip path ran. Raises otherwise."""
    want = [float(np.float32(clip) / np.float32(max(np.float32(n),
                                                   np.float32(clip))))
            for n in norms]
    if scales != want:
        raise AssertionError(f"clip scales {scales}, expected "
                             f"min(1, {clip}/norm) = {want} for norms "
                             f"{norms}")
    clipped = sum(n > clip for n in norms)
    if not clipped:
        raise AssertionError(f"the global norm {norms} never exceeded the "
                             f"clip norm {clip}: the clip path did not run")
    return {"global_norm": norms, "scale": scales, "clip_norm": clip,
            "steps_clipped": clipped}


def _recompute_agrees(r, n, first_differing=None) -> dict:
    """The recomputed trajectory ``r`` against ``n``, the same replayed
    steps without recompute: losses equal bit for bit, or (naming the
    first differing op, ``first_differing()``) within
    ``_RECOMPUTE_RTOL``; raises otherwise."""
    if r["losses"] == n["losses"]:
        return {"bit_identical": True}
    rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], n["losses"]))
    report = {"bit_identical": False, "max_rel_loss_diff": rel,
              "first_differing": first_differing() if first_differing
              else None}
    if not rel <= _RECOMPUTE_RTOL:
        raise AssertionError(f"recompute vs none: losses {r['losses']} vs "
                             f"{n['losses']}: {report}")
    return report


def _peaks_agree(b, c, reckoned) -> dict:
    """The captured step's peak with recompute (``c``) below the one
    without (``b``) by at least half of ``reckoned``, the activation
    bytes the recompute should free; raises otherwise."""
    freed = b - c
    if not (c < b and freed >= 0.5 * reckoned):
        raise AssertionError(f"recompute frees {freed} B of the captured "
                             f"peak ({b} -> {c}), less than half of the "
                             f"reckoned {reckoned} B")
    return {"without": b, "with": c, "freed": freed, "reckoned": reckoned,
            "freed_over_reckoned": freed / reckoned}


def _segment_bytes(torch, config, device, batch=1, seq=256) -> dict:
    """The activation bytes the tape holds for one layer's segment of the
    recipe without recompute, reckoned at ``batch`` x ``seq`` tokens from
    one eager step: the distinct storages that the records of the
    segment's forward ops hold (the tensors their autograd graphs save,
    their leaf inputs and their outputs), less parameters, feeds and the
    checkpoints (which either way stay). Flash attention runs at this
    ``seq`` as at the recipe's. Every such tensor grows with the tokens,
    so ``per_token`` scales it to another batch and length."""
    from paddle_tpu_torch.framework import Scope, registry

    cfg = dict(config, n_layer=2, max_seq_len=seq)
    with _env(PADDLE_TPU_FLASH_MIN_SEQ=str(seq)):
        program = _recipe_program(cfg, batch, seq, recompute=False)
        main, startup, io = program
        scope, exe = Scope(), _executor(device)
        exe.run(startup, scope=scope)
        held = {}
        real = registry.LoweringContext.record

        def record(self, fwd_idx, opdef, ins, attrs, diff_slots):
            saved = []

            def pack(t):
                saved.append(t)
                return t

            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                outs = real(self, fwd_idx, opdef, ins, attrs, diff_slots)
            rec = self._records[fwd_idx]
            tensors = saved + [t for lv in rec.leaves.values() for t in lv
                               if t is not None]
            tensors += [t for ov in rec.outs.values() for t in ov
                        if isinstance(t, torch.Tensor)]
            held[fwd_idx] = {(t.untyped_storage().data_ptr(),
                              t.untyped_storage().nbytes())
                             for t in tensors}
            return outs

        registry.LoweringContext.record = record
        try:
            exe.run(main, feed=_fixed_batch(torch, cfg["vocab_size"], batch,
                                            seq, device),
                    fetch_list=[io["loss"]], scope=scope)
        finally:
            registry.LoweringContext.record = real
    ops = main.global_block().ops
    produced = {n: i for i, op in enumerate(ops)
                for n in op.output_arg_names()}
    ck = [produced[v.name] for v in io["checkpoints"]]
    keep = {(scope.get(n).untyped_storage().data_ptr())
            for n in scope.local_var_names()}
    segment = set()
    for i, storages in held.items():
        if ck[0] < i <= ck[1]:
            segment |= storages
    # the checkpoints' storages stay either way
    ck_ptrs = set()
    for i in ck:
        for s in held.get(i, ()):
            ck_ptrs.add(s[0])
    nbytes = sum(size for ptr, size in segment
                 if ptr not in keep and ptr not in ck_ptrs)
    return {"bytes": nbytes, "tokens": batch * seq,
            "per_token": nbytes / (batch * seq), "records": sum(
                1 for i in held if ck[0] < i <= ck[1])}


def _recipe_peak(torch, program, start, feed, replays=3) -> dict:
    """The recipe's peak device memory in a fresh executor and scope from
    ``start``: the eager warm-up's, then the capture's and ``replays``
    replays' (``torch.cuda.max_memory_allocated`` and memwatch's reading
    of the allocator)."""
    from paddle_tpu_torch import memwatch
    from paddle_tpu_torch.framework import Scope

    main, _, io = program
    scope, exe = Scope(), _executor("cuda")
    for n, t in start.items():
        scope.set(n, t.clone())

    def step():
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    warm = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(1 + replays):
        step()
    torch.cuda.synchronize()
    with _env(PADDLE_TPU_MEMWATCH="1"):
        mw = memwatch.sample(exe.device)
    out = {"eager_warmup_peak": warm,
           "captured_peak": torch.cuda.max_memory_allocated(),
           "memwatch_peak": mw and mw["peak_bytes_in_use"],
           "phases": dict(exe.phases)}
    if out["phases"] != {"eager": 1, "capture": 1, "replay": replays}:
        raise AssertionError(f"recipe peak run phases {out['phases']}")
    if out["memwatch_peak"] != out["captured_peak"]:
        raise AssertionError(f"memwatch's peak {out['memwatch_peak']} is "
                             f"not the allocator's {out['captured_peak']}")
    del exe, scope
    return out


def _optimizer_steps(torch, name, kw, config, batch, seq) -> dict:
    """The seq-512 step under the optimizer ``name`` (its keywords
    ``kw``): ``_OPTIMIZER_STEPS`` steps eagerly and as many on the card's
    compiled route (warm-up, capture, replays) from one start, equal bit
    for bit (losses and every persistable), the losses finite."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.framework import Scope

    program = _gpt_program(config, batch, seq,
                           lambda: getattr(topt, name)(**kw))
    main, startup, io = program
    scope = Scope()
    _executor("cuda").run(startup, scope=scope)
    start = {n: scope.get(n).clone() for n in scope.local_var_names()}
    feed = _fixed_batch(torch, config["vocab_size"], batch, seq)
    legs = {}
    for leg in ("E", "R"):
        s, exe = Scope(), _executor("cuda")
        for n, t in start.items():
            s.set(n, t.clone())
        with (_eager() if leg == "E" else contextlib.nullcontext()):
            losses = [float(exe.run(main, feed=feed, fetch_list=[io["loss"]],
                                    scope=s)[0])
                      for _ in range(_OPTIMIZER_STEPS)]
        legs[leg] = {"losses": losses, "phases": dict(exe.phases),
                     "state": {n: s.get(n) for n in s.local_var_names()}}
        del exe, s
    r, e = legs["R"], legs["E"]
    off = _unequal(r["state"], e["state"])
    if (r["losses"] != e["losses"] or off
            or not all(np.isfinite(r["losses"]))
            or r["phases"] != {"eager": 1, "capture": 1,
                               "replay": _OPTIMIZER_STEPS - 2}):
        raise AssertionError(f"{name}: replayed {r['losses']} "
                             f"({r['phases']}) vs eager {e['losses']}, "
                             f"persistables differing {off[:5]}")
    return {"losses": r["losses"], "persistables": len(e["state"]),
            "bit_identical": True}


def _chunked_vs_pallas(torch, config, batch, seq) -> dict:
    """One seq-512 step's loss through ``fused_lm_head="chunked"`` and
    through the fused kernels (``"pallas"``) from the same weights:
    within ``_CHUNKED_RTOL``."""
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.optimizer import Adam

    losses, start = {}, None
    for impl in ("pallas", "chunked"):
        program = _gpt_program(dict(config, fused_lm_head=impl), batch, seq,
                               lambda: Adam(learning_rate=_LR))
        main, startup, io = program
        if io["lm_head_impl"] != impl:
            raise AssertionError(f"loss path {io['lm_head_impl']!r}, not "
                                 f"{impl!r}")
        scope, exe = Scope(), _executor("cuda")
        if start is None:
            exe.run(startup, scope=scope)
            start = {n: scope.get(n).clone()
                     for n in scope.local_var_names()}
        else:
            for n, t in start.items():
                scope.set(n, t.clone())
        losses[impl] = float(exe.run(
            main, feed=_fixed_batch(torch, config["vocab_size"], batch, seq),
            fetch_list=[io["loss"]], scope=scope)[0])
        del exe, scope
    rel = abs(losses["chunked"] - losses["pallas"]) / abs(losses["pallas"])
    if not rel <= _CHUNKED_RTOL:
        raise AssertionError(f"chunked CE loss {losses['chunked']} vs the "
                             f"kernels' {losses['pallas']}: {rel:.3g} apart")
    return {"losses": losses, "rel": rel, "rtol": _CHUNKED_RTOL}


def _hash_ms(torch, config, batch, seq):
    """Device ms of one layer's dropout draw on the card at the recipe's
    shape: the counter-based hash of the (seed, step) tensor
    (``LoweringContext.uniform``) and the keep test (``_device_ms``: None
    where the trace lost records)."""
    from paddle_tpu_torch.framework.registry import LoweringContext

    shape = (batch, seq, config["n_head"],
             config["d_model"] // config["n_head"])
    seed_step = torch.tensor([_RECIPE_SEED, 0], device="cuda")

    def draw():
        LoweringContext("cuda", seed_step=seed_step).uniform(3, shape) < (
            1.0 - config["dropout"])

    return _device_ms(torch, draw)


def _first_differing_grad(torch, r_program, n_program, start, feed):
    """Where recompute and no recompute first part: one eager step of
    each from ``start``, fetching every parameter's final gradient; the
    first parameter, in the order the backward reaches them, whose
    gradients differ, and the op that produced it."""
    from paddle_tpu_torch.framework import Scope

    def grads(program):
        main, _, io = program
        block = main.global_block()
        names = {}
        for op in block.ops:
            if op.type in ("adamw", "adam"):
                names[op.input("Param")[0]] = op.input("Grad")[0]
        scope, exe = Scope(), _executor("cuda")
        for n, t in start.items():
            scope.set(n, t.clone())
        with _eager():
            got = exe.run(main, feed=feed, scope=scope,
                          fetch_list=list(names.values()),
                          return_numpy=False)
        producer = {n: op.type for op in block.ops
                    for n in op.output_arg_names()}
        return {p: (g, producer[n]) for (p, n), g in zip(names.items(), got)}

    a, b = grads(r_program), grads(n_program)
    for p in reversed(list(a)):
        if not a[p][0].equal(b[p][0]):
            return {"param": p, "op": a[p][1]}
    return None


def _train_recipe(torch, card, config=_RECIPE, batch=_LONG_B, seq=_LONG_T,
                  plain_peak=None) -> dict:
    """bench.py's gpt2s pretraining step at seq 2048 run as a team runs
    it (``_RECIPE``): dropout 0.1 under a program seed, recompute with one
    checkpoint a layer, AdamW (lr 1e-4, decay 0.01) behind a global-norm
    clip at 1.0, replayed as a CUDA graph. Checks, in order:

    1. 13 steps eagerly (E) and 13 replayed (R, the main path, its
       launches counted from 0) from one start: losses, global norms,
       clip scales and every persistable (the (seed, step) tensor too)
       equal bit for bit;
    2. the same 13 replayed steps without recompute (N): the losses R's
       bit for bit (else within 1e-5, the first differing gradient
       named, ``_recompute_agrees``);
    3. dropout: each step's keep share over the first layer's mask within
       5 sigma of 0.9, and each step's mask differs from the last's;
    4. the clip: each step's scale min(1, 1 / norm) and the norm above 1
       at least once (``_clip_agrees``);
    5. memory: the captured peak over three replays without recompute (b)
       and with it (c), each with memwatch's reading; c < b and b - c at
       least half of 11 segments' tape bytes (``_segment_bytes`` scaled
       to the recipe's tokens);
    6. one traced replayed step: flash forward 24 (12 + 12 recomputed),
       dq and dk/dv 12 each, the CE forward, dx and dW once, Adam 196;
       the dropout hash's device ms;
    7. each of the eight other optimizers at the seq-512 step, eager and
       replayed, bit for bit (``_optimizer_steps``);
    8. the chunked CE's seq-512 loss against the kernels'
       (``_chunked_vs_pallas``).

    ``plain_peak``: the plain seq-2048 step's peak (phase
    ``train_observed``), printed beside. Returns the launches."""
    import gc

    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.ops import flash_attention as fl
    from paddle_tpu_torch.ops import fused_adam as fa
    from paddle_tpu_torch.ops import lmhead_ce as ce

    t_phase = time.perf_counter()
    p = config["dropout"]
    reckoned = _segment_bytes(torch, config, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    program = _recipe_program(config, batch, seq, recompute=True)
    plain = _recipe_program(config, batch, seq, recompute=False)
    build_s = time.perf_counter() - t0
    main, startup, io = program
    scope = Scope()
    _executor("cuda").run(startup, scope=scope)
    start = {n: scope.get(n).clone() for n in scope.local_var_names()}
    del scope
    feed = _fixed_batch(torch, config["vocab_size"], batch, seq)
    steps = _RECIPE_STEPS

    def leg(prog, eager=False, counted=False):
        s, exe = Scope(), _executor("cuda")
        for n, t in start.items():
            s.set(n, t.clone())
        if counted:  # the main path: every count starts from 0 here
            ce.reset_launches()
            fa.reset_launches()
            fl.reset_launches()
        with (_eager() if eager else contextlib.nullcontext()):
            out = _recipe_trajectory(torch, exe, s, prog, feed, steps)
        return out, exe, s

    e, exe, s = leg(program, eager=True)
    del exe, s
    dispatched = attention.FLASH_DISPATCH_COUNT
    r, r_exe, r_scope = leg(program, counted=True)
    dispatched = attention.FLASH_DISPATCH_COUNT - dispatched
    launches = {"lmhead_ce_fwd": ce.launches, "lmhead_ce_dx": ce.dx_launches,
                "lmhead_ce_dw": ce.dw_launches, "fused_adam": fa.launches,
                "flash_attention_fwd": fl.fwd_launches,
                "flash_attention_dq": fl.dq_launches,
                "flash_attention_dkv": fl.dkv_launches}
    layers = config["n_layer"]
    per_step = {"lmhead_ce_fwd": 1, "lmhead_ce_dx": 1, "lmhead_ce_dw": 1,
                "fused_adam": _ADAM_PER_STEP,
                "flash_attention_fwd": 2 * layers,
                "flash_attention_dq": layers, "flash_attention_dkv": layers}
    if r["phases"] != {"eager": 1, "capture": 1, "replay": steps - 2}:
        raise AssertionError(f"train_recipe: runs by phase {r['phases']}")
    want = {k: 2 * n for k, n in per_step.items()}
    if launches != want or dispatched != 2 * 2 * layers:
        raise AssertionError(f"train_recipe launches {launches} and "
                             f"{dispatched} flash dispatches, expected "
                             f"{want} and {4 * layers} over the warm-up and "
                             f"the capture")
    # 1. replay = eager, bit for bit
    off = _unequal(r["state"], e["state"])
    for key in ("losses", "norms", "scales", "keep"):
        if r[key] != e[key]:
            off.append(key)
    if off:
        raise AssertionError(f"train_recipe: replayed vs eager differ in "
                             f"{off[:8]}: losses {r['losses']} vs "
                             f"{e['losses']}")
    if not all(np.isfinite(r["losses"])) or not r["losses"][-1] < \
            r["losses"][0]:
        raise AssertionError(f"train_recipe: loss not finite and falling: "
                             f"{r['losses']}")
    # 6. one traced replayed step (the trajectory's fetches: its entry)
    fetch = [io["loss"], io["global_norm"], io["clip_scale"],
             io["attention"]]
    traced = _profile_step(torch, r_exe, main, feed, fetch, r_scope, card,
                           "train_recipe_profile", per_step=per_step,
                           return_numpy=False)
    r_wall = statistics.median(r["step_s"][_WARM_STEPS:]) * 1e3
    del r_exe, r_scope
    gc.collect()
    # 2. recompute = no recompute
    n, exe, s = leg(plain)
    del exe, s
    gc.collect()
    rec = _recompute_agrees(r, n, lambda: _first_differing_grad(
        torch, program, plain, start, feed))
    # 3. dropout; 4. the clip
    drop = _keep_share_ok(r["keep"], p, r["mask_elements"])
    if not all(r["masks_differ"]):
        raise AssertionError(f"train_recipe: a step's dropout mask equals "
                             f"the last step's: {r['masks_differ']}")
    clip = _clip_agrees(r["norms"], r["scales"], _RECIPE_CLIP)
    # 5. memory
    torch.cuda.empty_cache()
    peaks = {"b": _recipe_peak(torch, plain, start, feed)}
    gc.collect()
    torch.cuda.empty_cache()
    peaks["c"] = _recipe_peak(torch, program, start, feed)
    gc.collect()
    torch.cuda.empty_cache()
    segment_full = reckoned["per_token"] * batch * seq
    mem = _peaks_agree(peaks["b"]["captured_peak"],
                       peaks["c"]["captured_peak"],
                       (config["n_layer"] - 1) * segment_full)
    hash_ms = _hash_ms(torch, config, batch, seq)
    _say(phase="train_recipe", config=config, batch=batch, seq=seq,
         seed=_RECIPE_SEED, clip_norm=_RECIPE_CLIP, weight_decay=_RECIPE_WD,
         lr=_LR, steps=steps, build_s=build_s, losses=r["losses"],
         step_ms_median=r_wall,
         step_ms_all=[x * 1e3 for x in r["step_s"]],
         eager_step_ms_median=statistics.median(
             e["step_s"][_WARM_STEPS:]) * 1e3,
         no_recompute_step_ms_median=statistics.median(
             n["step_s"][_WARM_STEPS:]) * 1e3,
         tokens_per_s=batch * seq / (r_wall / 1e3),
         device_busy_share=traced["device_ms"] / r_wall,
         traced_device_ms=traced["device_ms"],
         replay_vs_eager={"bit_identical": True,
                          "persistables": len(e["state"])},
         recompute_vs_none=rec, dropout=drop, clip=clip,
         memory=dict(mem, b=peaks["b"], c=peaks["c"],
                     segment_reckoning=reckoned,
                     segment_bytes_at_recipe=segment_full,
                     plain_seq2048_peak_train_observed=plain_peak,
                     plain_seq2048_peak_before_liveness=18675405312),
         launches=launches, launches_per_replayed_step={
             k: v["calls"] for k, v in traced["path_kernels"].items()},
         path_kernels=traced["path_kernels"], flash_dispatches=dispatched,
         dropout_hash_ms={"per_draw": hash_ms,
                          "draws_per_step": 2 * layers,
                          "per_step": hash_ms and 2 * layers * hash_ms},
         seconds=time.perf_counter() - t_phase, card=card,
         note="one smoke run, not a benchmark; launches are the wrappers' "
         "host counts (the warm-up and the capture)")
    # 7. the other optimizers; 8. the chunked CE
    t_opt = time.perf_counter()
    optimizers = {name: _optimizer_steps(torch, name, kw, _TRAIN, _TRAIN_B,
                                         _TRAIN_T)
                  for name, kw in _RECIPE_OPTIMIZERS}
    gc.collect()
    torch.cuda.empty_cache()
    t_chunked = time.perf_counter()
    chunked = _chunked_vs_pallas(torch, _TRAIN, _TRAIN_B, _TRAIN_T)
    gc.collect()
    torch.cuda.empty_cache()
    _say(phase="train_recipe_seq512", config=_TRAIN, batch=_TRAIN_B,
         seq=_TRAIN_T, optimizers=optimizers,
         optimizers_s=t_chunked - t_opt, chunked_ce=chunked,
         chunked_s=time.perf_counter() - t_chunked, card=card)
    return launches


# ---------------------------------------------------------------------------
# train_eager: the eager API (dygraph tracer, nn, amp, Model.fit) at full
# width
# ---------------------------------------------------------------------------

# the slice's masked-LM encoder at bench.py's gpt2s widths: vocab 32768,
# 12 pre-norm layers of 768 with 12 heads and an FFN of 3072, learned
# positions over seq 2048, dropout 0.1; batch 8
_EAGER = dict(vocab=32768, seq=2048, d_model=768, n_head=12, n_layer=12,
              dropout=0.1)
_EAGER_B = 8
_EAGER_STEPS = 8
_EAGER_SEED = 2026
_EAGER_LR = 1e-4
_EAGER_MASK = 0.15  # share of positions masked, as BERT masks
# fused Adam launches a step: 2 embeddings, 16 parameters a layer x 12,
# the final norm's 2 and the head's 2
_EAGER_ADAM = 198
# flash launches a step: one attention a layer
_EAGER_FLASH = 12
_EAGER_CKPT_STEPS = 4
_EAGER_CKPT_DIR = os.path.join(_ROOT, "build", "eager_ckpt")
# the peak the eager step was reckoned to need before its first run on the card
# (PERF.md): 2.2 GB of parameters, gradients and Adam moments, 1.9
# GB of tape a layer (about 38 fp32 [B*T, 768] tensors: activations, the
# bf16 casts the autocast keeps for the backward, dropout masks) and 7.5
# GB for the head and its cross-entropy ([B*T, 32768] logits in bf16,
# then fp32 with the log-softmax and softmax), 4 GB of backward transients
_EAGER_RECKONED_BYTES = 37e9


def _masked_lm(pkg, vocab, seq, d_model, n_head, n_layer, dropout):
    """The slice's model, written with ``pkg``'s nn API as a user of the
    reference writes it (``pkg`` is paddle_tpu_torch here; its tests pass
    the JAX package too): token and learned position embeddings, a
    pre-norm ``TransformerEncoder``, a final ``LayerNorm`` and the
    vocabulary head. Its parameters come from ``pkg``'s initializers on
    the default place."""
    nn = pkg.nn

    class MaskedLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.tok = nn.Embedding(vocab, d_model)
            self.pos = nn.Embedding(seq, d_model)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                d_model=d_model, nhead=n_head, dim_feedforward=4 * d_model,
                dropout=dropout, activation="gelu", normalize_before=True),
                num_layers=n_layer)
            self.norm = nn.LayerNorm(d_model)
            self.head = nn.Linear(d_model, vocab)
            self.positions = pkg.to_tensor(np.arange(seq, dtype=np.int64))

        def forward(self, ids):
            h = self.tok(ids) + self.pos(self.positions)
            return self.head(self.norm(self.encoder(h)))

    return MaskedLM()


def _mlm_batch(vocab, batch, seq, seed, share=_EAGER_MASK):
    """(ids, labels), int64 numpy: tokens from ``seed`` over the first
    vocab - 1 ids (the last id is the mask id); ``share`` of the positions
    masked: ids there replaced by the mask id, labels the original token
    there and -100 (ignored) elsewhere."""
    r = np.random.RandomState(seed)
    tokens = r.randint(0, vocab - 1, (batch, seq)).astype(np.int64)
    masked = r.rand(batch, seq) < share
    return (np.where(masked, vocab - 1, tokens),
            np.where(masked, tokens, -100).astype(np.int64))


def _mlm_loss(pkg):
    F = pkg.nn.functional
    return lambda logits, labels: F.cross_entropy(logits, labels,
                                                  ignore_index=-100)


def _step_log(pkg):
    """A fit-loop callback of ``pkg``: each step's loss (forced at the end,
    so the loop's asynchronous loss stays asynchronous) and host clock."""

    class StepLog(pkg.callbacks.Callback):
        def __init__(self):
            self.losses, self.t, self.t0 = [], [], None

        def on_train_begin(self, logs=None):
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.t.append(time.perf_counter())

        def on_train_end(self, logs=None):
            self.losses = [float(v) for v in self.losses]

        def walls_ms(self):
            t = [self.t0] + self.t
            return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

    return StepLog()


def _eager_fit(pkg, net, ids, labels, steps, lr=_EAGER_LR, amp=True,
               callbacks=()):
    """(Model, its ``_step_log``): ``net`` trained ``steps`` steps of batch
    ``len(ids)`` by ``Model.fit`` over a ``DataLoader`` that repeats the
    batch, with Adam and the masked-LM cross-entropy, under
    ``amp.auto_cast(dtype="bfloat16")`` (O1) when ``amp``."""
    b = len(ids)
    data = [(ids[i % b], labels[i % b]) for i in range(steps * b)]
    loader = pkg.io.DataLoader(data, batch_size=b, shuffle=False)
    model = pkg.Model(net)
    model.prepare(pkg.optimizer.Adam(learning_rate=lr,
                                     parameters=net.parameters()),
                  _mlm_loss(pkg))
    log = _step_log(pkg)
    ctx = (pkg.amp.auto_cast(dtype="bfloat16") if amp
           else contextlib.nullcontext())
    with ctx:
        model.fit(loader, epochs=1, verbose=0,
                  callbacks=[log] + list(callbacks))
    return model, log


def _masks_differ(masks, p, sigmas=_RECIPE_SIGMAS) -> dict:
    """Two consecutive steps' keep masks of one dropout (bool tensors of
    one shape): they must differ, and each keep share must lie within
    ``sigmas`` binomial standard deviations of 1 - p (``_keep_share_ok``).
    Raises otherwise."""
    if len(masks) != 2:
        raise AssertionError(f"dropout: {len(masks)} keep masks, not 2")
    a, b = masks
    n = int(a.numel())
    share = _keep_share_ok([float(m.float().mean()) for m in masks], p, n,
                           sigmas)
    differ = int((a != b).sum())
    if differ == 0:
        raise AssertionError(f"dropout drew the same keep mask at two "
                             f"consecutive steps ({n} elements)")
    return {**share, "elements": n, "differing": differ}


def _launches_agree(launches, steps, per_step) -> dict:
    """The wrappers' launch counts over ``steps`` steps against
    ``per_step`` ({kernel: launches a step}): each path kernel launched
    exactly ``per_step * steps`` times, none 0. Raises otherwise."""
    want = {k: n * steps for k, n in per_step.items()}
    got = {k: launches.get(k, 0) for k in per_step}
    if got != want or not all(got.values()):
        raise AssertionError(f"path kernels launched {got} times over "
                             f"{steps} steps, not {want}")
    return {"launches": got, "per_step": dict(per_step), "steps": steps}


def _digests_agree(full, resumed) -> dict:
    if full != resumed:
        raise AssertionError(f"resumed fit's state digest {resumed} is not "
                             f"the uninterrupted run's {full}")
    return {"digest": full, "bit_identical": True}


def _path_launches():
    """{kernel: the wrapper's launch count} of the eager path's kernels."""
    from paddle_tpu_torch.ops import flash_attention as fl
    from paddle_tpu_torch.ops import fused_adam

    return {"flash_attention_fwd": fl.fwd_launches,
            "flash_attention_dq": fl.dq_launches,
            "flash_attention_dkv": fl.dkv_launches,
            "fused_adam": fused_adam.launches}


def _eager_resume(pkg, config, batch, seed, steps, root) -> dict:
    """``Model.fit`` of ``config`` for ``steps`` steps with
    ``PADDLE_TPU_CKPT_DIR`` under ``root`` and a checkpoint every
    ``_EAGER_CKPT_STEPS``; then again from the same start, its checkpoints
    swept after the first, into a fresh model that resumes from it; the
    two runs' final ``state_digest`` must be equal (``_digests_agree``)."""
    from paddle_tpu_torch import checkpoint

    ids, labels = _mlm_batch(config["vocab"], batch, config["seq"], seed)
    shutil.rmtree(root, ignore_errors=True)
    ck = checkpoint.TrainCheckpointer(root)
    with _env(PADDLE_TPU_CKPT_DIR=root,
              PADDLE_TPU_CKPT_STEPS=str(_EAGER_CKPT_STEPS),
              PADDLE_TPU_CKPT_KEEP="4"):
        pkg.seed(seed)
        net = _masked_lm(pkg, **config)
        start = net.state_dict()
        full, log = _eager_fit(pkg, net, ids, labels, steps)
        digest_full = ck.current_digest(full.network, full._optimizer)
        kept = sorted(os.listdir(root))
        for name in kept[1:]:  # the run dies after its first checkpoint
            os.unlink(os.path.join(root, name))
        pkg.seed(seed + 1)  # a respawned process draws from elsewhere
        fresh = _masked_lm(pkg, **config)
        fresh.set_state_dict(start)  # overwritten by the resume anyway
        resumed, log2 = _eager_fit(pkg, fresh, ids, labels, steps)
        digest_resumed = ck.current_digest(resumed.network,
                                           resumed._optimizer)
    shutil.rmtree(root, ignore_errors=True)
    return {**_digests_agree(digest_full, digest_resumed),
            "checkpoints": kept, "steps": steps,
            "resumed_at": steps - len(log2.losses),
            "losses_full": log.losses, "losses_resumed": log2.losses}


def _cpu_vs_card_eager(torch, config, lr, eps) -> None:
    """The eager encoder (``config``, fp32, dropout 0) takes one
    ``Model.train_batch`` (Adam at ``lr``, ``eps``) from the same numpy
    weights on the CPU (plain versions) and on the card (kernels;
    attention takes flash at seq 1024 on both sides); the loss, every
    parameter and every Adam moment must agree as ``_tiny_agree`` holds
    the static legs (1e-4, the flash fp32 legs' tolerance, with each
    moment within 1e-4 of the largest of its kind)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.weights import layer_from_numpy

    ids, labels = _mlm_batch(config["vocab"], 2, config["seq"], seed=11)

    def one_step(net):
        model = pt.Model(net)
        opt = pt.optimizer.Adam(learning_rate=lr, epsilon=eps,
                                parameters=net.parameters())
        model.prepare(opt, _mlm_loss(pt))
        before = attention.FLASH_DISPATCH_COUNT
        loss = model.train_batch([ids], labels)[0][0]
        state = dict(net.state_dict())
        for slot in ("moment1", "moment2"):
            for qual, p in net.named_parameters():
                acc = opt._accumulators[slot][p.name]._value
                state[f"{qual}_{slot}_"] = acc.cpu().numpy()
        return [loss], state, attention.FLASH_DISPATCH_COUNT - before

    prev = core._default_place
    try:
        with dygraph.guard():
            pt.set_device("cpu")
            pt.seed(5)
            cpu_net = _masked_lm(pt, **config)
            start = cpu_net.state_dict()
            cpu = one_step(cpu_net)
            pt.set_device("gpu")
            card_net = layer_from_numpy(_masked_lm(pt, **config), start)
            card = one_step(card_net)
    finally:
        core._default_place = prev
    dispatched = {"cpu": cpu[2], "cuda": card[2]}
    if min(dispatched.values()) < config["n_layer"]:
        raise AssertionError(f"cpu_vs_card eager: flash dispatches "
                             f"{dispatched}")
    worst = _tiny_agree(card, cpu, "cpu_vs_card eager")
    _say(phase="cpu_vs_card", leg="eager", config=config, lr=lr, eps=eps,
         steps=1, losses_cpu=cpu[0], losses_card=card[0],
         flash_dispatches=dispatched, compared=len(cpu[1]),
         max_abs_diff=worst, tolerance=_TINY_TOL,
         moment_tolerance="1e-4 of the largest moment of its kind")


def _train_eager(torch, card) -> dict:
    """The eager main path at full width (``_EAGER``): the masked-LM
    encoder built on the card from a seed, ``Model.fit`` for
    ``_EAGER_STEPS`` steps over a DataLoader repeating one batch, Adam,
    the whole fit under ``amp.auto_cast(dtype="bfloat16")``. Checks:
    finite losses, the last below the first; the wrappers' launches
    counted from 0 over the fit: flash forward, dq and dk/dv 12 a step
    and fused Adam 198 (``_launches_agree``), ``FLASH_DISPATCH_COUNT`` 12
    a step; the first layer's attention-dropout keep masks at steps 1 and
    2 differ, each keep share within 5 sigma of 0.9 (``_masks_differ``);
    a traced step (``train_batch`` under ``torch.profiler``, after a traced
    warm-up step: ``_profiled``) launches the same kernels; and a 2-layer
    copy resumed from its step-4 checkpoint ends bit-identical to the
    uninterrupted run (``_eager_resume``).
    Reports the step wall (median of steps 3-8), the traced step's device
    ms and the card's idle share, each path kernel's device ms and
    launches, and the peak memory (memwatch's, the allocator's, and the
    reckoning). Returns {kernel: launches over the fit}."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph, memwatch
    from paddle_tpu_torch.ops import attention
    from paddle_tpu_torch.ops import flash_attention as fl
    from paddle_tpu_torch.ops import fused_adam

    cfg = _EAGER
    with dygraph.guard():
        pt.seed(_EAGER_SEED)
        net = _masked_lm(pt, **cfg)
        n_params = len(net.parameters())
        if n_params != _EAGER_ADAM:
            raise AssertionError(f"train_eager: {n_params} parameters, not "
                                 f"{_EAGER_ADAM}")
        ids, labels = _mlm_batch(cfg["vocab"], _EAGER_B, cfg["seq"],
                                 _EAGER_SEED)
        masks = []

        def keep_mask(layer, args):  # out_proj's input: the dropped output
            if len(masks) < 2:
                masks.append(args[0]._value != 0)

        hook = net.encoder.layers[0].self_attn.out_proj \
            .register_forward_pre_hook(keep_mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        memwatch.reset()
        fl.reset_launches()
        fused_adam.reset_launches()
        dispatched = attention.FLASH_DISPATCH_COUNT
        model, log = _eager_fit(pt, net, ids, labels, _EAGER_STEPS)
        launches = _path_launches()
        dispatched = attention.FLASH_DISPATCH_COUNT - dispatched
        torch.cuda.synchronize()
        hook.remove()
        max_alloc = torch.cuda.max_memory_allocated()
        peak = memwatch.totals()["lifetime_peak_bytes"]
        losses = log.losses
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"train_eager: losses {losses}")
        counted = _launches_agree(
            launches, _EAGER_STEPS,
            {"flash_attention_fwd": _EAGER_FLASH,
             "flash_attention_dq": _EAGER_FLASH,
             "flash_attention_dkv": _EAGER_FLASH,
             "fused_adam": _EAGER_ADAM})
        if dispatched != _EAGER_FLASH * _EAGER_STEPS:
            raise AssertionError(f"train_eager: FLASH_DISPATCH_COUNT rose "
                                 f"{dispatched} over {_EAGER_STEPS} steps")
        dropout = _masks_differ(masks, cfg["dropout"])
        del masks
        walls = log.walls_ms()
        wall_ms = statistics.median(walls[2:])

        with pt.amp.auto_cast(dtype="bfloat16"):
            _, traced_ms, events = _profiled(torch, model.train_batch,
                                             [ids], labels)
        kernels, device_ms, ours, families, _ = _kernel_tally(torch, events)
        del events
        seen = {k: ours[k]["calls"] for k in counted["per_step"]}
        if seen != counted["per_step"]:
            raise AssertionError(f"train_eager: the traced step launched "
                                 f"{seen}, not {counted['per_step']}")
        del model, net
        resume = _eager_resume(pt, dict(cfg, n_layer=2), _EAGER_B,
                               _EAGER_SEED, 2 * _EAGER_CKPT_STEPS,
                               _EAGER_CKPT_DIR)
    busy = device_ms / wall_ms
    tokens = _EAGER_B * cfg["seq"]
    _say(phase="train_eager", config=cfg, batch=_EAGER_B,
         steps=_EAGER_STEPS, lr=_EAGER_LR, amp="bfloat16 O1",
         losses=losses, loss_drop=losses[0] - losses[-1],
         step_walls_ms=walls, wall_ms=wall_ms,
         tokens_per_s=tokens / wall_ms * 1e3,
         traced_step_ms=traced_ms, device_ms=device_ms, busy_share=busy,
         idle_share=1.0 - busy, host_bound_ms=wall_ms - device_ms,
         path_kernels=ours, families=families,
         launches_traced=sum(n for n, _ in kernels.values()),
         fit_launches=counted, flash_dispatches=dispatched,
         dropout=dropout, memwatch_peak_bytes=peak,
         max_memory_allocated=max_alloc,
         reckoned_peak_bytes=_EAGER_RECKONED_BYTES,
         resume=resume, card=card,
         note="busy share: the traced step's device ms over the untraced "
         "fit's median step wall (steps 3-8)")
    return counted["launches"]


_JIT_SEED = 2027
_JIT_CALLS = 10
_JIT_FLASH = 12  # flash forward launches a forward: one attention a layer
_JIT_DECODE_TRIPS = 4.0  # the decode loop's bound; its break fires at 3
_JIT_LOAD_RTOL = 1e-4
_JIT_DIR = os.path.join(_ROOT, "build", "jit")
# bf16 rounding of a loop-route result against eager: one bf16 ulp
_JIT_LOOP_RTOL = 2.0 ** -7
# the decode loop where the host holds the card back: a narrow encoder
_JIT_NARROW = dict(vocab=1024, seq=128, d_model=128, n_head=2, n_layer=2,
                   dropout=0.0)
_JIT_NARROW_TRIPS = 32.0
_JIT_NARROW_CALLS = 5
# the export path's encoder at head_dim 256 (gpt2s's 768 in 3 heads, as
# train_d256's), which takes the fp32 forward at head_dim 256
_JIT_D256 = dict(_EAGER, n_head=3)


def _bit_identical(torch, got, want, what) -> dict:
    """``got`` and ``want`` (torch tensors) equal bit for bit: same shape,
    dtype and values. Raises otherwise."""
    if (tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype
            or not torch.equal(got, want)):
        diff = (float((got.double() - want.double()).abs().max())
                if got.shape == want.shape else None)
        raise AssertionError(f"{what}: not bit-identical to eager ({got.dtype}"
                             f" {tuple(got.shape)} against {want.dtype} "
                             f"{tuple(want.shape)}, max |diff| {diff})")
    return {"bit_identical": True, "shape": list(got.shape),
            "dtype": str(got.dtype).replace("torch.", "")}


def _rel_agrees(torch, got, want, rtol, what) -> dict:
    """max |got - want| over max |want| within ``rtol``; reports whether
    the two are also bit-identical. Raises otherwise."""
    g, w = got.double(), want.double()
    err = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    if tuple(got.shape) != tuple(want.shape) or not err <= rtol:
        raise AssertionError(f"{what}: relative error {err} against eager, "
                             f"tolerance {rtol}")
    return {"max_rel_err": err, "rtol": rtol,
            "bit_identical": bool(torch.equal(got, want))}


def _route_agrees(info, route, what, **want) -> dict:
    """A ``StaticFunction.routes`` entry took ``route`` and its counts are
    ``want``. Raises otherwise."""
    got = {k: info[k] for k in want}
    if info["route"] != route or got != want:
        raise AssertionError(f"{what}: route {info['route']} {got}, not "
                             f"{route} {want}")
    return info


def _counts_agree(seen, want, what) -> list:
    """The flash forward's launch count after each call against ``want``.
    Raises otherwise."""
    if list(seen) != list(want):
        raise AssertionError(f"{what}: flash forward launches after each "
                             f"call {list(seen)}, not {list(want)}")
    return list(seen)


def _if_nodes() -> bool:
    """Whether this torch can capture CUDA conditional nodes."""
    import torch

    return hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")


def _timed(torch, fn, *args):
    """(fn's result, its wall ms), the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# torch.profiler keeps a kernel's record only where it lies inside the
# trace's window on the host's clock, and the card's times, mapped onto
# that clock, stray by milliseconds (tools/torch_trace_window.py, on the
# H100): a kernel near the window's start was dropped (a flash forward of
# a replayed step's 24, the first 1-21 kernels of a cold trace) or one
# that ran before it kept (a warm-up step's last 298). So ``_profiled``
# runs its counted call ``_TRACE_MARGIN_S`` inside the window on both
# sides, between two marker kernels (``torch.cuda._sleep``'s), each run
# alone; it keeps the device records that lie between the markers on the
# card's own clock, and raises ``_TraceLost`` where a marker's record is
# gone (the window may then have lost others)
_TRACE_MARGIN_S = 0.25
_TRACE_MARKER = "spin_kernel"


class _TraceLost(AssertionError):
    """A trace that lost a marker kernel's record (``_profiled``)."""


def _mark(torch):
    """One ``_TRACE_MARKER`` kernel, with the card idle before and after."""
    torch.cuda.synchronize()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _profiled(torch, fn, *args):
    """(fn's result, its wall ms, the trace's events) of one call under
    ``torch.profiler``, after one traced warm-up call whose events are
    dropped (the profiler's ``warmup`` step), between two marker kernels
    ``_TRACE_MARGIN_S`` inside the trace's window. The events are
    ``_between_marks``'s: it raises ``_TraceLost`` where the trace lost a
    marker's record."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn(*args)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(_TRACE_MARGIN_S)
        _mark(torch)
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _mark(torch)
        time.sleep(_TRACE_MARGIN_S)
        prof.step()
    return out, wall_ms, _between_marks(torch, prof.events())


def _between_marks(torch, events):
    """The host's events and the device records that lie between the two
    ``_TRACE_MARKER`` records of a trace (``_profiled``) on the card's
    clock, the markers and their launches left out. Raises ``_TraceLost``
    unless both markers' records are there."""
    cuda = torch.autograd.DeviceType.CUDA
    marks = sorted(e.time_range.start for e in events
                   if e.device_type == cuda and _TRACE_MARKER in e.name)
    if len(marks) != 2:
        starts = [e.time_range.start for e in events
                  if e.device_type == cuda and _TRACE_MARKER not in e.name]
        raise _TraceLost(
            f"the trace kept {len(marks)} of its 2 marker kernels and "
            f"{len(starts)} other device records, "
            f"{[sum(t < m for t in starts) for m in marks]} of them before "
            "each marker kept: its window lost kernel records")

    def kept(e):
        if e.device_type == cuda:
            return (_TRACE_MARKER not in e.name
                    and marks[0] < e.time_range.start < marks[1])
        return not any(_TRACE_MARKER in getattr(k, "name", "")
                       for k in getattr(e, "kernels", ()))  # a launch

    return [e for e in events if kept(e)]


def _traced(torch, fn, *args):
    """(fn's result, its device ms, the port's kernels by ``_TRACE_NAMES``)
    of one call under ``torch.profiler`` (``_profiled``)."""
    out, _, events = _profiled(torch, fn, *args)
    _, device_ms, ours, _, _ = _kernel_tally(torch, events)
    return out, device_ms, ours


def _decode_loop(pt, net):
    """The greedy decode loop of the JAX package's dy2static model test
    over ``net``: a tensor ``while`` with ``break``, summing each trip's
    largest last-position logits."""
    def decode_scores(ids, max_new, limit):
        total = pt.to_tensor(np.float32(0))
        steps = pt.to_tensor(np.float32(0))
        while steps < max_new:
            logits = net(ids)
            nxt = logits[:, -1, :].max(axis=-1)
            total = total + nxt.sum()
            steps = steps + 1.0
            if total > limit:
                break
        return total

    return decode_scores


def _narrow_loop(torch, pt, jit, card) -> dict:
    """The decode loop (``_decode_loop``) where the host holds the card
    back: over a narrow encoder (``_JIT_NARROW``, batch 1, fp32) for
    ``_JIT_NARROW_TRIPS`` trips, no break. Eager against the loop route
    (each trip a replay of the captured body, and one host read):
    ``_JIT_NARROW_CALLS`` calls each, walls; the loop route's result
    within ``_JIT_LOAD_RTOL`` of eager's (``_rel_agrees``), its counts
    by ``_route_agrees``."""
    cfg = _JIT_NARROW
    pt.seed(_JIT_SEED)
    net = _masked_lm(pt, **cfg)
    net.eval()
    ids_np, _ = _mlm_batch(cfg["vocab"], 1, cfg["seq"], _JIT_SEED)
    decode_scores = _decode_loop(pt, net)
    args = (pt.to_tensor(ids_np), pt.to_tensor(np.float32(_JIT_NARROW_TRIPS)),
            pt.to_tensor(np.float32(np.inf)))
    eager_walls, walls, errs = [], [], []
    for _ in range(_JIT_NARROW_CALLS):
        want, ms = _timed(torch, decode_scores, *args)
        eager_walls.append(ms)
    static = jit.to_static(decode_scores)
    for i in range(_JIT_NARROW_CALLS):
        got, ms = _timed(torch, static, *args)
        walls.append(ms)
        errs.append(_rel_agrees(torch, got._value, want._value,
                                _JIT_LOAD_RTOL, f"narrow loop call {i + 1}"))
    trips = int(_JIT_NARROW_TRIPS)
    route = _route_agrees(
        list(static.routes.values())[0], "loop", "narrow loop",
        trips=trips * _JIT_NARROW_CALLS, loop_captures=1,
        host_reads=(trips + 1) * _JIT_NARROW_CALLS + 1)
    eager_ms = statistics.median(eager_walls[1:])
    loop_ms = statistics.median(walls[1:])
    return {"config": cfg, "batch": 1, "trips": trips, "dtype": "float32",
            "calls": errs, "route": route, "eager_walls_ms": eager_walls,
            "loop_walls_ms": walls, "eager_ms": eager_ms, "loop_ms": loop_ms,
            "eager_ms_per_trip": eager_ms / trips,
            "loop_ms_per_trip": loop_ms / trips,
            "eager_over_loop": eager_ms / loop_ms, "card": card,
            "note": "medians of calls 2 on; the loop route's first call "
                    "warms and captures the body"}


def _jit_load(torch, pt, jit, net, ids1, name, piece, hold=True):
    """(report, launches) of the export path for ``net`` (eval mode):
    ``jit.save`` in fp32 with ``InputSpec([None, 2048], "int64")`` (the
    recording forward runs at batch 1, so the saved reshapes are batch
    1's) under ``_JIT_DIR``/``name``, ``jit.load``, four calls at batch 1
    (``ids1``) through the loaded ``Executor`` (eager warm-up, capture, two
    replays): each within ``_JIT_LOAD_RTOL`` of the eager fp32 forward,
    fp32 flash forward launches 12, 24, 24, 24, a traced replay
    (``_profiled``: a lost marker fails) with 12 flash forward kernels,
    each one whose name holds ``piece``, and none of a SIMT forward
    (``::fwd_kernel<``); the replayed wall (calls 3-4), the traced device
    ms and the flash forwards' device ms. ``hold=False`` reports the
    traced kernels without holding their names (another tree's, whose
    names may differ)."""
    from paddle_tpu_torch.ops import flash_attention as fl

    t = _EAGER["seq"]
    path = os.path.join(_JIT_DIR, name)
    t0 = time.perf_counter()
    jit.save(net, path, input_spec=[jit.InputSpec([None, t], "int64")])
    save_s = time.perf_counter() - t0
    sizes = {ext: os.path.getsize(path + ext)
             for ext in (".pdmodel", ".pdiparams")}
    t0 = time.perf_counter()
    loaded = jit.load(path)
    load_s = time.perf_counter() - t0
    want = net(ids1)._value
    fl.reset_launches()
    seen, errs, walls = [], [], []
    for i in range(4):
        got, ms = _timed(torch, loaded, ids1)
        walls.append(ms)
        seen.append(fl.fwd_launches)
        errs.append(_rel_agrees(torch, got._value, want, _JIT_LOAD_RTOL,
                                f"{name} jit.load call {i + 1}"))
    launches = {"flash_attention_fwd": fl.fwd_launches}
    got, _, events = _profiled(torch, loaded, ids1)
    kernels, device_ms, ours, _, _ = _kernel_tally(torch, events)
    errs.append(_rel_agrees(torch, got._value, want, _JIT_LOAD_RTOL,
                            f"traced {name} jit.load call"))
    named = [(n, ms) for kernel, (n, ms) in kernels.items()
             if piece in kernel]
    simt = sum(n for kernel, (n, _) in kernels.items()
               if "::fwd_kernel<" in kernel)
    calls = sum(n for n, _ in named)
    if hold and (ours["flash_attention_fwd"]["calls"] != _JIT_FLASH
                 or calls != _JIT_FLASH or simt):
        raise AssertionError(f"{name} jit.load: the traced replay ran "
                             f"{ours['flash_attention_fwd']} flash forward "
                             f"kernels, {calls} of them {piece!r} and "
                             f"{simt} SIMT, not {_JIT_FLASH} of {piece!r}")
    phases = dict(loaded._exe.phases)  # the trace's warm-up replays too
    if phases != {"eager": 1, "capture": 1, "replay": 4}:
        raise AssertionError(f"{name} jit.load: executor phases {phases}")
    report = {
        "launches_after_each_call": _counts_agree(
            seen, [_JIT_FLASH] + [2 * _JIT_FLASH] * 3, f"{name} jit.load"),
        "calls": errs, "phases": phases, "dtype": "float32",
        "batch": 1, "walls_ms": walls,
        "replayed_ms": statistics.median(walls[2:]),
        "traced_device_ms": device_ms,
        "traced_flash_fwd": ours["flash_attention_fwd"],
        "flash_fwd_device_ms": ours["flash_attention_fwd"]["ms"],
        "kernel": piece, "traced_kernel_calls": calls,
        "traced_kernel_device_ms": sum(ms for _, ms in named),
        "file_bytes": sizes, "save_s": save_s, "load_s": load_s,
        "ops": len(loaded._program.global_block().ops)}
    del loaded, got, want
    return report, launches


def _jit(torch, card) -> dict:
    """The export path at full width (``_EAGER``'s encoder, eval mode, from
    ``_JIT_SEED``; batch ``_EAGER_B`` x seq 2048).

    1. ``jit.to_static(net)`` under ``amp.auto_cast("bfloat16")``: ten
       calls, each bit-identical to the eager forward
       (``_bit_identical``); flash forward launches counted from 0 after
       each call: 12, 24, then 24 (warm-up, capture, replays:
       ``_counts_agree``); one cache entry on the "graph" route with
       phases 1/1/8; a traced replay shows 12 flash forward kernels; a
       batch-4 call makes a second entry.
    2. ``set_value`` on one attention weight: the next call captures again
       (``recaptures`` 1) and equals the eager forward with the new weight.
    3. Control flow, each case against the same function run eagerly:
       the greedy decode loop (a tensor ``while`` with ``break``) over the
       encoder, two calls of 3 trips, on the "loop" route with one loop
       body captured, 4 host reads and 3 trips a call (and one read of
       the break's ``if`` in the first call's first trip, op by op), 36
       flash launches in all (that trip, the body's warm-up and its
       capture); and a tensor
       ``if`` on the encoder's output, on the "loop" route with one host
       read a call (this torch has no conditional nodes,
       ``_if_nodes``); each within ``_JIT_LOOP_RTOL`` (``_rel_agrees``);
       then the decode loop where the host holds the card back
       (``_narrow_loop``: a narrow encoder, eager against the loop route).
    4. ``jit.save`` in fp32 and ``jit.load`` (``_jit_load``): the loaded
       model's traced replay runs 12 split-TF32 forwards
       (``flash_fwd_f32_kernel``).
    5. The same for the encoder at 3 heads of 256 (``_JIT_D256``, from
       ``_JIT_SEED``, eval mode; ``jit_load_d256``): 12 of the head_dim-256
       split-TF32 forward (``fwd_f32_d256_sm90_kernel``) in its traced
       replay.

    Returns {kernel: launches} of the to_static calls (``jit``) and of the
    loaded models' (``jit_load``, ``jit_load_d256``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph, jit
    from paddle_tpu_torch.ops import flash_attention as fl

    cfg = _EAGER
    b, t = _EAGER_B, cfg["seq"]
    report, launches = {"card": card, "if_nodes": _if_nodes()}, {}
    # no tape: an eager forward would otherwise keep every activation for
    # a backward that never comes
    with dygraph.guard(), pt.no_grad():
        pt.seed(_JIT_SEED)
        net = _masked_lm(pt, **cfg)
        net.eval()
        ids_np, _ = _mlm_batch(cfg["vocab"], b, t, _JIT_SEED)
        ids = pt.to_tensor(ids_np)
        with pt.amp.auto_cast(dtype="bfloat16"):
            eager_walls = []
            for _ in range(3):
                eager, ms = _timed(torch, net, ids)
                eager_walls.append(ms)
            eager = eager._value
            static = jit.to_static(net)
            sf = static.forward.static_function
            fl.reset_launches()
            seen, walls = [], []
            for i in range(_JIT_CALLS):
                out, ms = _timed(torch, static, ids)
                walls.append(ms)
                seen.append(fl.fwd_launches)
                same = _bit_identical(torch, out._value, eager,
                                      f"jit call {i + 1}")
                del out
            launches["jit"] = {"flash_attention_fwd": fl.fwd_launches}
            report["to_static"] = {
                "launches_after_each_call": _counts_agree(
                    seen, [_JIT_FLASH] + [2 * _JIT_FLASH] * (_JIT_CALLS - 1),
                    "to_static"),
                "route": _route_agrees(
                    list(sf.routes.values())[0], "graph", "to_static",
                    phases={"eager": 1, "capture": 1,
                            "replay": _JIT_CALLS - 2, "op": 0},
                    recaptures=0, host_reads=0),
                "bit_identical_calls": _JIT_CALLS, "output": same,
                "walls_ms": walls, "replayed_ms": statistics.median(
                    walls[2:]), "eager_walls_ms": eager_walls,
                "eager_ms": statistics.median(eager_walls)}
            if len(sf._cache) != 1:
                raise AssertionError(f"to_static: {len(sf._cache)} entries")
            out, device_ms, ours = _traced(torch, static, ids)
            _bit_identical(torch, out._value, eager, "traced jit call")
            del out
            if ours["flash_attention_fwd"]["calls"] != _JIT_FLASH:
                raise AssertionError(f"to_static: the traced replay ran "
                                     f"{ours['flash_attention_fwd']} flash "
                                     f"forward kernels, not {_JIT_FLASH}")
            rep = report["to_static"]
            rep.update(traced_device_ms=device_ms,
                       traced_flash_fwd=ours["flash_attention_fwd"],
                       idle_share=1.0 - device_ms / rep["replayed_ms"],
                       eager_over_replayed=rep["eager_ms"]
                       / rep["replayed_ms"])
            static(pt.to_tensor(ids_np[:4]))
            if len(sf._cache) != 2:
                raise AssertionError(f"to_static: a batch-4 call left "
                                     f"{len(sf._cache)} entries, not 2")
            # 2. a parameter moves
            w = net.encoder.layers[0].self_attn.q_proj.weight
            w.set_value(w.numpy() * 0.5)
            out = static(ids)
            want = type(net).forward(net, ids)._value
            report["set_value"] = {
                **_bit_identical(torch, out._value, want, "after set_value"),
                "recaptures": _route_agrees(
                    sf.routes[next(iter(sf._cache))], "graph", "set_value",
                    recaptures=1)["recaptures"]}
            del out, want, eager, static
            net.__dict__.pop("forward")  # the eager forward again

            # 3. control flow
            decode_scores = _decode_loop(pt, net)
            one = float(decode_scores(ids, pt.to_tensor(np.float32(1)),
                                      pt.to_tensor(np.float32(1e30))))
            if not one > 0:
                raise AssertionError(f"decode: one trip's score {one}")
            args = (ids, pt.to_tensor(np.float32(_JIT_DECODE_TRIPS)),
                    pt.to_tensor(np.float32(2.5 * one)))
            want, eager_ms = _timed(torch, decode_scores, *args)
            static = jit.to_static(decode_scores)
            fl.reset_launches()
            cases, calls = {}, 2
            for i in range(calls):
                got, ms = _timed(torch, static, *args)
                cases[f"decode_call_{i + 1}"] = {
                    **_rel_agrees(torch, got._value, want._value,
                                  _JIT_LOOP_RTOL, f"decode call {i + 1}"),
                    "ms": ms}
            # the first call's first trip runs op by op (its loop-locals
            # are not yet tensors: one host read of the break's `if`),
            # then warms and captures the body; every later trip replays
            cases["decode"] = _route_agrees(
                list(static.routes.values())[0], "loop", "decode",
                trips=3 * calls, host_reads=4 * calls + 1, loop_captures=1,
                tensor_ifs=1)
            cases["decode"].update(
                eager_ms=eager_ms, score=float(want), one_trip_score=one,
                flash_fwd_launches=_counts_agree(
                    [fl.fwd_launches], [3 * _JIT_FLASH], "decode")[0])

            def gate(ids):
                h = net(ids)[:, -1, :]
                if h.mean() > 0:
                    out = h * 2.0
                else:
                    out = h - 1.0
                return out

            want = gate(ids)._value
            static = jit.to_static(gate)
            for i in range(calls):
                got = static(ids)._value
                cases[f"if_call_{i + 1}"] = _rel_agrees(
                    torch, got, want, _JIT_LOOP_RTOL,
                    f"tensor if call {i + 1}")
            cases["if"] = _route_agrees(
                list(static.routes.values())[0], "loop", "tensor if",
                tensor_ifs=calls, host_reads=calls, tensor_loops=0)
            report["control_flow"] = cases
            del static, want, got
        report["narrow_loop"] = _narrow_loop(torch, pt, jit, card)

        # 4. export and load, fp32
        shutil.rmtree(_JIT_DIR, ignore_errors=True)
        ids1 = pt.to_tensor(ids_np[:1])
        report["jit_load"], launches["jit_load"] = _jit_load(
            torch, pt, jit, net, ids1, "encoder", "::flash_fwd_f32_kernel<")
        del net
        # 5. the same at head_dim 256: the split-TF32 forward of its own
        pt.seed(_JIT_SEED)
        net = _masked_lm(pt, **_JIT_D256)
        net.eval()
        report["jit_load_d256"], launches["jit_load_d256"] = _jit_load(
            torch, pt, jit, net, ids1, "encoder_d256",
            "::fwd_f32_d256_sm90_kernel(")
        del net
    shutil.rmtree(_JIT_DIR, ignore_errors=True)
    _say(phase="jit", config=cfg, batch=b, **report, launches=launches,
         note="replayed_ms: median wall of calls 3-10 (input copy and "
         "output clone included); idle share: 1 - traced replay device "
         "ms / replayed_ms")
    return launches


# ---------------------------------------------------------------------------
# vision_fit, static_amp, fluid_lenet: the vision and fluid static path
# ---------------------------------------------------------------------------


# BASELINE config 2: ResNet-50 at ImageNet's shapes, PaddleClas's
# ResNet50 recipe per card (batch 64, Momentum 0.9, L2 decay 1e-4), under
# bf16 autocast; one synthetic batch from a seed. The recipe's rate, 0.1,
# is for a global batch of 256 (Goyal et al.'s linear rule); one card's
# 64 takes 0.1 x 64 / 256. At 0.1 this batch's loss climbed from 7.6 to
# 14.1 in 8 steps (NVIDIA H100 80GB HBM3 at 700 W); at 0.025 it falls.
# The JAX package's loss climbs at 0.1 too, and the port takes each of its
# steps (tests/test_torch_vision.py, resnet50 on one batch of 8 x 64 x 64)
_VISION_B = 64
_VISION_STEPS = 8
_VISION_SEED = 2028
_VISION_CLASSES = 1000
_VISION_LR = 0.1 * _VISION_B / 256
# parameter tensors and values, then the trainable ones (the rest: the
# 53 BatchNorms' running mean and variance), as the JAX package counts
_VISION_COUNTS = (267, 25610152, 161, 25557032)
# the peak reckoned before the first run on the card: 0.3 GB of weights,
# gradients and velocities; about 11M conv-output cells an image, each
# kept as the bf16 conv output, BatchNorm's fp32 input and output and the
# ReLU's fp32 output with its next conv's bf16 cast (16 B), 11.3 GB at
# batch 64; 2 GB of backward transients
_VISION_RECKONED_BYTES = 14e9
# forward GFLOP an image at 224 x 224 (4.1 G multiply-adds)
_VISION_GFLOP = 8.2

# op families of the eager ResNet step, for the traced step's device
# time by op (``_by_op``): the first family whose prefix starts the type
_VISION_OP_FAMILIES = [
    ("conv", ("conv2d", "depthwise_conv2d")),
    ("batch_norm", ("batch_norm",)),
    ("pool", ("pool2d",)),
    ("gemm", ("matmul", "mul")),
    ("optimizer", ("momentum", "adam", "sgd")),
    ("copy", ("cast", "reshape", "flatten", "assign", "fill", "transpose")),
    ("loss", ("softmax_with_cross_entropy", "mean", "reduce")),
    ("elementwise", ("elementwise", "relu", "scale", "sum")),
]


def _vision_family(op_type) -> str:
    base = op_type[:-len("_grad")] if op_type.endswith("_grad") else op_type
    return next((f for f, prefixes in _VISION_OP_FAMILIES
                 if base.startswith(prefixes)), "other")


def _vision_batch(seed):
    """(images [B, 3, 224, 224] fp32, zero mean and unit variance as a
    normalized ImageNet batch, labels [B, 1] int64 in [0, 1000))."""
    r = np.random.RandomState(seed)
    images = r.standard_normal((_VISION_B, 3, 224, 224)).astype(np.float32)
    labels = r.randint(0, _VISION_CLASSES, (_VISION_B, 1)).astype(np.int64)
    return images, labels


def _counts(net) -> tuple:
    ps = net.parameters()
    return (len(ps), sum(int(np.prod(p.shape)) for p in ps),
            sum(1 for p in ps if p.trainable),
            sum(int(np.prod(p.shape)) for p in ps if p.trainable))


def _stats_moved(before, after) -> dict:
    """Every BatchNorm running mean and variance (``before``/``after``:
    {name: tensor}) moved. Raises otherwise."""
    still = sorted(n for n in before if _same_tensor(before[n], after[n]))
    if still:
        raise AssertionError(f"vision_fit: {len(still)} running statistics "
                             f"did not move: {still[:4]}")
    return {"running_stats": len(before), "moved": len(before)}


def _same_tensor(a, b) -> bool:
    return bool(a.shape == b.shape and a.dtype == b.dtype and a.equal(b))


def _vision_fit(torch, card) -> dict:
    """BASELINE config 2 on the eager path at full width: ResNet-50 (1000
    classes, NCHW) built on the card from a seed; ``Model.fit`` for
    ``_VISION_STEPS`` steps over a DataLoader repeating one synthetic
    ImageNet batch of 64 x 3 x 224 x 224, ``Momentum(0.025, 0.9,
    weight_decay=L2Decay(1e-4))`` (``_VISION_LR``) and the ``Accuracy``
    metric, under
    ``amp.auto_cast(dtype="bfloat16")`` (conv2d on the white list,
    batch_norm on the black). Checks: the parameter counts
    (``_VISION_COUNTS``); finite losses, the last below the first; every
    BatchNorm's running mean and variance moved; two ``eval_batch`` calls
    on the batch give the same loss bit for bit and leave the running
    statistics as they were (is_test: the running statistics, not the
    batch's); ``Model.evaluate`` runs; none of the seven kernels launched
    (the path runs none of them). Reports the step wall (median of steps
    3-8), a traced ``train_batch``'s device ms by kernel family and by op
    family, the idle share, and the peak memory beside the reckoning."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dygraph, vision

    with dygraph.guard():
        pt.seed(_VISION_SEED)
        t0 = time.perf_counter()
        net = vision.models.resnet50(num_classes=_VISION_CLASSES)
        build_s = time.perf_counter() - t0
        counts = _counts(net)
        if counts != _VISION_COUNTS:
            raise AssertionError(f"vision_fit: parameter counts {counts}, "
                                 f"not {_VISION_COUNTS}")
        stats = {p.name: p._value.clone() for p in net.parameters()
                 if not p.trainable}
        images, labels = _vision_batch(_VISION_SEED)
        data = [(images[i % _VISION_B], labels[i % _VISION_B])
                for i in range(_VISION_STEPS * _VISION_B)]
        loader = pt.io.DataLoader(data, batch_size=_VISION_B, shuffle=False)
        model = pt.Model(net)
        opt = pt.optimizer.Momentum(
            learning_rate=_VISION_LR, momentum=0.9,
            parameters=net.parameters(),
            weight_decay=pt.regularizer.L2Decay(1e-4))
        model.prepare(opt, pt.nn.CrossEntropyLoss(),
                      metrics=pt.metric.Accuracy())
        log = _step_log(pt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with pt.amp.auto_cast(dtype="bfloat16"):
            model.fit(loader, epochs=1, verbose=0, callbacks=[log])
        torch.cuda.synchronize()
        max_alloc = torch.cuda.max_memory_allocated()
        launches = _all_launches()
        losses = log.losses
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"vision_fit: losses {losses}")
        if any(launches.values()):
            raise AssertionError(f"vision_fit launched the port's kernels "
                                 f"{launches}; its path runs none")
        velocities = len(opt._accumulators.get("velocity", {}))
        if velocities != _VISION_COUNTS[2]:
            raise AssertionError(f"vision_fit: Momentum keeps {velocities} "
                                 f"velocities, not one a trainable tensor")
        after = {p.name: p._value for p in net.parameters()
                 if not p.trainable}
        moved = _stats_moved(stats, after)
        walls = log.walls_ms()
        wall_ms = statistics.median(walls[2:])

        # evaluation reads the running statistics and leaves them
        frozen = {n: t.clone() for n, t in after.items()}
        x, y = images[:_VISION_B], labels[:_VISION_B]
        with pt.amp.auto_cast(dtype="bfloat16"):
            first = model.eval_batch([x], y)
            second = model.eval_batch([x], y)
            evaluated = model.evaluate(
                [(images[i], labels[i]) for i in range(_VISION_B)],
                batch_size=_VISION_B, verbose=0)
        first_loss = np.asarray(first[0][0] if isinstance(first, tuple)
                                else first[0])
        second_loss = np.asarray(second[0][0] if isinstance(second, tuple)
                                 else second[0])
        if first_loss.tobytes() != second_loss.tobytes():
            raise AssertionError(f"vision_fit: two eval calls gave "
                                 f"{first_loss} and {second_loss}")
        changed = [n for n, t in frozen.items()
                   if not _same_tensor(t, after[n])]
        if changed:
            raise AssertionError(f"vision_fit: evaluation moved the running "
                                 f"statistics {changed[:4]}")

        with pt.amp.auto_cast(dtype="bfloat16"):
            _, traced_ms, events = _profiled(torch, model.train_batch, [x],
                                             y)
        kernels, device_ms, ours, families, _ = _kernel_tally(torch, events)
        by_op = _by_op(torch, events)
        del events
        by_family = {}
        for op, ms in by_op.items():
            fam = _vision_family(op)
            by_family[fam] = by_family.get(fam, 0.0) + ms
        del model, net, opt, loader, data
    busy = device_ms / wall_ms
    flops = _VISION_GFLOP * 1e9 * 3 * _VISION_B
    _say(phase="vision_fit", model="resnet50", classes=_VISION_CLASSES,
         layout="NCHW", batch=_VISION_B, image=[3, 224, 224],
         steps=_VISION_STEPS, amp="bfloat16 O1",
         optimizer=f"Momentum({_VISION_LR}, 0.9, "
         "weight_decay=L2Decay(1e-4))",
         params={"tensors": counts[0], "values": counts[1],
                 "trainable_tensors": counts[2],
                 "trainable_values": counts[3]},
         build_s=build_s, losses=losses, loss_drop=losses[0] - losses[-1],
         running_stats=moved, eval_losses=[float(first_loss),
                                           float(second_loss)],
         eval_bit_identical=True, evaluate=evaluated,
         step_walls_ms=walls, wall_ms=wall_ms,
         images_per_s=_VISION_B / wall_ms * 1e3,
         traced_step_ms=traced_ms, device_ms=device_ms, busy_share=busy,
         idle_share=1.0 - busy, host_bound_ms=wall_ms - device_ms,
         families=families, device_ms_by_op_family=by_family,
         by_op_share=sum(by_op.values()) / device_ms if by_op else None,
         by_op_top={k: v for k, v in sorted(
             by_op.items(), key=lambda kv: -kv[1])[:12]},
         launches_traced=sum(n for n, _ in kernels.values()),
         port_kernels_launched=launches,
         flops_per_step=flops,
         bound_ms=_bound_ms(0.0, flops, "bfloat16")[0],
         max_memory_allocated=max_alloc,
         reckoned_peak_bytes=_VISION_RECKONED_BYTES, card=card,
         note="the path runs none of the seven kernels: convolutions are "
         "cuDNN's, pooling and batch norm plain torch (the JAX package's "
         "are XLA's); busy share: the traced step's device ms over the "
         "untraced fit's median step wall (steps 3-8)")
    return launches


# the static AMP path: bench.py's gpt2s at seq 2048, batch 8, built in
# fp32 and decorated with static.amp (bf16, dynamic loss scaling from
# 2^15, the reference's defaults), run as a CompiledProgram
_AMP_STEPS = 5
_AMP_RTOL = 2e-2  # tests/test_static_amp.py:108, the reference's bound
# Adam moves a parameter by about lr * sign(g) whatever the size of g, so
# the losses (about ln V after 5 steps at lr 1e-4) and the parameters would
# pass a step that hands Adam the scaled gradient; its first moment carries
# that size. Each parameter's moment1 after the steps, decorated (bf16
# compute) against the fp32 program's, through ``_leaves_agree``: a
# gradient left scaled by 2^15 reads about 2^15, one unscaled twice about 1.
# Sound, the worst parameter reads 1.5e-2 on an NVIDIA H100 80GB HBM3 at
# 700 W (this phase) and 3.6e-3 on the CPU's tiny GPT
# (tests/test_torch_smoke_checks.py), so the limit leaves a factor of 6.
_AMP_MOMENT_RTOL = 0.1
# an attention key's bias has a gradient of 0 in exact arithmetic (softmax
# ignores a constant added to a row of scores), so its moment or update is
# rounding alone on both sides; each leaf is judged against its own norm
# plus this share of the largest leaf's
_LEAF_FLOOR = 1e-4


def _leaves_agree(got, want, limit, what) -> dict:
    """Holds each leaf of ``got`` ({name: tensor}) against ``want``'s by
    ||got - want|| / (||want|| + ``_LEAF_FLOOR`` x the largest ||want||),
    at most ``limit`` at the worst leaf; raises naming it. Returns the
    worst, its name, the median and the count."""
    norms = {n: float(t.double().norm()) for n, t in want.items()}
    floor = _LEAF_FLOOR * max(norms.values(), default=0.0)
    rel = {n: float((got[n].double() - want[n].double()).norm())
           / (norms[n] + floor) for n in sorted(want)}
    worst = max(rel, key=rel.get) if floor else None
    if worst is None or not rel[worst] <= limit:
        raise AssertionError(f"{what} of {worst} lies {rel.get(worst)} "
                             f"(relative norm) from its control's, beyond "
                             f"{limit}")
    return {"worst": rel[worst], "worst_name": worst,
            "median": statistics.median(rel.values()), "leaves": len(rel),
            "limit": limit}


def _amp_program(batch, seq, decorate=True, config=_LONG, **amp_kw):
    """(main, startup, io) of ``config`` (gpt2s) built in fp32, under
    ``static.amp`` when ``decorate``; ``io["compiled"]`` the
    CompiledProgram over main."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.optimizer import Adam

    def make_opt():
        return (pt.static.amp.decorate(Adam(learning_rate=_LR), **amp_kw)
                if decorate else Adam(learning_rate=_LR))

    main, startup, io = _gpt_program(dict(config, dtype="float32"), batch,
                                     seq, make_opt)
    io["compiled"] = pt.static.CompiledProgram(main).with_data_parallel(
        loss_name=io["loss"].name)
    return main, startup, io


def _amp_rewrite_agrees(main) -> dict:
    """The rewritten program: casts, no ``equal``; every matmul and
    ``fused_attention_tpu`` reads bf16; the lm-head CE reads fp32 (it is
    on neither list, and the final layer norm is black). Raises
    otherwise."""
    ops = main.global_block().ops
    types = [op.type for op in ops]
    if "equal" in types or "cast" not in types:
        raise AssertionError(f"static_amp: {types.count('cast')} casts, "
                             f"{types.count('equal')} equal ops")

    def dtypes(op):
        return sorted({str(v.dtype).replace("torch.", "")
                       for vs in op._input_vars.values() for v in vs
                       if v.dtype.is_floating_point})

    white = [(op.type, dtypes(op)) for op in ops
             if op.type in ("matmul", "matmul_v2", "fused_attention_tpu")]
    wrong = [w for w in white if w[1] != ["bfloat16"]]
    if not white or wrong:
        raise AssertionError(f"static_amp: white-list ops reading other "
                             f"than bf16: {wrong[:4]}")
    ce = [dtypes(op) for op in ops if op.type == "fused_lm_head_ce"]
    return {"ops": len(ops), "casts": types.count("cast"), "equal_ops": 0,
            "bf16_white_list_ops": {t: types.count(t)
                                    for t in sorted({w[0] for w in white})},
            "lm_head_ce_inputs": ce, "where_gates": types.count("where")}


def _free(torch) -> None:
    """Collect what the caller dropped and hand the card's cached blocks
    back (each leg's graph pool), before the next leg allocates."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _amp_overflow(torch, batch, seq, start, feed, config=_LONG,
                  device="cuda") -> dict:
    """One replayed step of the decorated program
    (``decr_every_n_nan_or_inf=1``) with an inf written into one weight,
    in place, after the warm-up and the capture: ``FoundInfinite`` is
    set, every parameter and accumulator stays as it was, bit for bit,
    and the loss scale halves, inside the replayed graph (on the CPU, the
    staged route). The loss itself may come out finite: the flash
    kernels give a row whose scores are all -inf an output of 0. Raises
    otherwise."""
    from paddle_tpu_torch.framework import Scope

    main, _, io = program = _amp_program(batch, seq, config=config,
                                         decr_every_n_nan_or_inf=1)
    scope = Scope()
    for name, t in start.items():
        scope.set(name, t.clone())
    exe = _executor(device)
    exe.staged = device == "cpu"
    found_inf = next(op.output("FoundInfinite")[0]
                     for op in main.global_block().ops
                     if op.type == "check_finite_and_unscale")
    fetch = [io["loss"], found_inf]
    for _ in range(2):  # the warm-up and the capture
        exe.run(io["compiled"], feed=feed, fetch_list=fetch, scope=scope)
    poisoned = "gpt.h0.attn.q.w"
    scope.get(poisoned).view(-1)[0] = float("inf")
    before = {n: scope.get(n).clone() for n in start}
    replays = exe.phases["replay"]
    loss, found = exe.run(io["compiled"], feed=feed, fetch_list=fetch,
                          scope=scope)
    if exe.phases["replay"] != replays + 1:
        raise AssertionError(f"static_amp overflow: not a replay "
                             f"({exe.phases})")
    after = {n: scope.get(n) for n in start}
    scale = [float(before["@AMP.loss_scaling"][0]),
             float(after["@AMP.loss_scaling"][0])]
    moved = sorted(n for n in start if not n.startswith("@AMP")
                   and not _same_tensor(before[n], after[n]))
    if not bool(found.reshape(-1)[0]) or moved or scale[1] != scale[0] / 2:
        raise AssertionError(f"static_amp overflow: found_inf {found}, "
                             f"scale {scale}, {len(moved)} persistables "
                             f"moved ({moved[:4]})")
    out = {"loss": float(loss), "found_inf": True, "scale": scale,
           "poisoned": poisoned,
           "unchanged": len(start) - 3,
           "good_steps": int(after["@AMP.good_steps"][0]),
           "bad_steps": int(after["@AMP.bad_steps"][0])}
    del exe, scope, program, before, after
    if device != "cpu":
        _free(torch)
    return out


def _static_amp(torch, card) -> dict:
    """A8c on the kernels: ``_amp_program`` (gpt2s, seq 2048, batch 8,
    built fp32, ``static.amp.decorate(Adam(1e-4))``) through
    ``CompiledProgram(main).with_data_parallel(loss_name=...)`` and
    ``Executor.run``. Checks: the rewrite (``_amp_rewrite_agrees``);
    parameters stay fp32 in the scope; R, ``_AMP_STEPS`` steps replayed,
    equals E, as many eager steps (PADDLE_TPU_EAGER=1), bit for bit from
    one start (``_replay_agrees``); R's losses within ``_AMP_RTOL`` of the
    undecorated fp32 program's (F) from the same start, and R's Adam
    first moments within ``_AMP_MOMENT_RTOL`` of F's
    (``_leaves_agree``); the launches over
    R's host steps (the warm-up and the capture): the CE forward, dx and
    dW once a step, flash forward, dq and dk/dv 12, Adam 196, and a
    traced replayed step shows as many; F's the same, and a traced
    replayed step of F shows as many, the split-TF32 dq and dk/dv at
    head_dim 64 among them and the retired SIMT dq and dk/dv at no call
    (``_F32_D64_NAMES``); an
    overflow step (``_amp_overflow``). Reports the walls, the traced step's device ms
    by family and the CE kernels' device ms (their fp32 routes at N
    16,384)."""
    from paddle_tpu_torch.framework import Scope
    from paddle_tpu_torch.ops import attention

    batch, seq = _LONG_B, _LONG_T
    t0 = time.perf_counter()
    program = _amp_program(batch, seq)
    main, startup, io = program
    build_s = time.perf_counter() - t0
    rewrite = _amp_rewrite_agrees(main)
    scope = Scope()
    exe = _executor("cuda")
    exe.run(startup, scope=scope)
    start = {v.name: scope.get(v.name).detach().clone()
             for v in main.list_vars() if v.persistable}
    not_fp32 = [p.name for p in main.all_parameters()
                if start[p.name].dtype != torch.float32]
    if not_fp32:
        raise AssertionError(f"static_amp: parameters not fp32: "
                             f"{not_fp32[:4]}")
    b1p0 = float(start[next(n for n in start
                            if n.startswith("gpt.wte_beta1_pow"))])
    feed = _fixed_batch(torch, _LONG["vocab_size"], batch, seq)
    lrs = [_LR] * _AMP_STEPS
    compiled = (io["compiled"], startup, io)
    per_step = {"lmhead_ce_fwd": 1, "lmhead_ce_dx": 1, "lmhead_ce_dw": 1,
                "fused_adam": _ADAM_PER_STEP,
                "flash_attention_fwd": _LAYERS,
                "flash_attention_dq": _LAYERS,
                "flash_attention_dkv": _LAYERS}

    with _eager():
        e = _leg(compiled, start, feed, "cuda", lrs)
    _reset_launches()
    dispatched = attention.FLASH_DISPATCH_COUNT
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, t in start.items():
        scope.set(name, t.clone())
    r = _trajectory(exe, scope, compiled, feed, lrs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    # copies: the traced steps below move the scope's moments in place
    r_moments = {n: t.clone() for n, t in r["state"].items()
                 if "_moment1_" in n}
    launches = _all_launches()
    dispatched = attention.FLASH_DISPATCH_COUNT - dispatched
    if r["phases"] != {"eager": 1, "capture": 1, "replay": _AMP_STEPS - 2}:
        raise AssertionError(f"static_amp: runs by phase {r['phases']}")
    want = {k: 2 * n for k, n in per_step.items()}
    if launches != want or dispatched != 2 * _LAYERS:
        raise AssertionError(f"static_amp launches {launches} and "
                             f"{dispatched} flash dispatches, expected "
                             f"{want} over the warm-up and the capture")
    agree = _replay_agrees(r, e, lrs, b1p0)
    fetch_list = [io["loss"], io["optimizer"]._lr_var]
    traced = _profile_step(torch, exe, io["compiled"], feed, fetch_list,
                           scope, card, "static_amp_profile",
                           per_step=per_step)
    scales = [float(scope.get("@AMP.loss_scaling")[0]),
              int(scope.get("@AMP.good_steps")[0])]
    r_walls = [s * 1e3 for s in r["step_s"]]
    e_walls = [s * 1e3 for s in e["step_s"]]
    del e, exe, scope, r["state"]
    _free(torch)

    f_program = _amp_program(batch, seq, decorate=False)
    f_io = f_program[2]
    f_scope = Scope()
    for name, t in start.items():
        if not name.startswith("@AMP"):
            f_scope.set(name, t.clone())
    f_exe = _executor("cuda")
    _reset_launches()
    f = _trajectory(f_exe, f_scope, (f_io["compiled"],) + f_program[1:],
                    feed, lrs)
    f_launches = _all_launches()
    if f_launches != want:  # fp32 flash: the split-TF32 forward
        raise AssertionError(f"static_amp: the fp32 program launched "
                             f"{f_launches}, expected {want} over the "
                             f"warm-up and the capture")
    rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], f["losses"])]
    if not all(np.isfinite(r["losses"])) or max(rel) > _AMP_RTOL:
        raise AssertionError(f"static_amp: bf16 losses {r['losses']} "
                             f"against fp32 {f['losses']} (rel {rel})")
    moments = _leaves_agree(r_moments, {n: f["state"][n] for n in r_moments},
                            _AMP_MOMENT_RTOL, "static_amp: Adam's moment1")
    f_walls = [s * 1e3 for s in f["step_s"]]
    f_losses = f["losses"]
    # a replayed step of the fp32 program, traced: the split-TF32 dq and
    # dk/dv at head_dim 64 12 times each and the SIMT ones none
    # (_F32_D64_NAMES)
    f_traced = _profile_step(
        torch, f_exe, f_io["compiled"], feed,
        [f_io["loss"], f_io["optimizer"]._lr_var], f_scope, card,
        "static_amp_fp32_profile", per_step=per_step, names=_F32_D64_NAMES)
    del f, f_program, f_io, f_exe, f_scope, r_moments
    _free(torch)
    overflow = _amp_overflow(torch, batch, seq, start, feed)
    _say(phase="static_amp", config=dict(_LONG, dtype="float32"),
         batch=batch, seq=seq, amp="static.amp.decorate(Adam(1e-4)): "
         "bfloat16, dynamic loss scaling from 2^15", build_s=build_s,
         rewrite=rewrite, losses=r["losses"], fp32_losses=f_losses,
         loss_rel_to_fp32=rel, moment1_rel_to_fp32=moments,
         scale_after=scales,
         step_ms_all=r_walls, step_ms_median=statistics.median(r_walls[2:]),
         eager_step_ms_all=e_walls,
         fp32_step_ms_median=statistics.median(f_walls[2:]),
         fp32_step_ms_all=f_walls, fp32_launches=f_launches,
         fp32_device_ms=f_traced["device_ms"],
         fp32_busy_share=f_traced["device_ms"] / statistics.median(
             f_walls[2:]),
         fp32_path_kernels=f_traced["path_kernels"],
         fp32_named_kernels=f_traced["named_kernels"],
         tokens_per_s=batch * seq / statistics.median(r_walls[2:]) * 1e3,
         device_ms=traced["device_ms"],
         busy_share=traced["device_ms"] / statistics.median(r_walls[2:]),
         path_kernels=traced["path_kernels"], families=traced["families"],
         launches=launches,
         launches_per_replayed_step={
             k: v["calls"] for k, v in traced["path_kernels"].items()},
         flash_dispatches=dispatched, max_memory_allocated=peak,
         overflow=overflow, card=card, **agree)
    return launches


# BASELINE config 1 as a fluid-era script: LeNet by fluid.layers over
# fake MNIST, batch 64, Adam 1e-3, through CompiledProgram
_FLUID_B = 64
_FLUID_STEPS = 20
_FLUID_BATCHES = 4  # 20 steps cycle 4 batches: 5 epochs of 256 images
_FLUID_ADAM = 10  # conv1, conv2, fc1, fc2, fc3: weight and bias each


def _fluid_lenet_program(fluid, pkg, batch):
    """(main, startup, loss, accuracy): LeNet as a fluid-era script
    writes it, with the static ``Variable``'s overloads (``h + h * 0.5``,
    ``-x``, ``mean * 1.0``)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("img", [batch, 1, 28, 28], "float32")
        label = fluid.data("label", [batch, 1], "int64")
        c1 = fluid.layers.conv2d(img, 6, 3, padding=1, act="relu")
        p1 = fluid.layers.pool2d(c1, 2, "max", 2)
        c2 = fluid.layers.conv2d(p1, 16, 5, act="relu")
        p2 = fluid.layers.pool2d(c2, 2, "max", 2)
        f1 = fluid.layers.fc(p2, 120, act="relu")
        h = fluid.layers.fc(f1, 84, act="relu")
        h = h + h * 0.5
        logits = -fluid.layers.fc(h, 10)
        ce = fluid.layers.softmax_with_cross_entropy(logits, label)
        loss = fluid.layers.mean(ce) * 1.0
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), label)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss, acc


def _fluid_run(exe, scope, compiled, loss, acc, batches, steps):
    out = {"losses": [], "acc": [], "step_s": []}
    for i in range(steps):
        t0 = time.perf_counter()
        lv, av = exe.run(compiled, feed=batches[i % len(batches)],
                         fetch_list=[loss, acc], scope=scope)
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(lv))
        out["acc"].append(float(av))
    out["state"] = {n: scope.get(n) for n in sorted(scope.local_var_names())}
    return out


def _fluid_lenet(torch, card) -> dict:
    """BASELINE config 1 through the fluid namespace: ``import
    paddle_tpu_torch.fluid as fluid``, LeNet by ``fluid.layers``
    (``_fluid_lenet_program``), ``vision.datasets.MNIST(backend="fake")``
    through ``io.DataLoader`` at batch 64, Adam(1e-3), ``fluid.
    CompiledProgram(main).with_data_parallel(loss_name=loss.name)``, 20
    steps replayed (R) and 20 eager (E, PADDLE_TPU_EAGER=1) from one
    start, with ``accuracy`` fetched. Checks: R = E bit for bit (losses,
    accuracies, every persistable); finite losses whose mean over the
    last 4 steps lies below the first 4's (the steps cycle 4 batches);
    accuracies in [0, 1]; fused Adam launched 10 times a host step (R's
    warm-up and capture), and 10 times in a traced replayed step. Both
    legs run cuDNN's deterministic algorithms."""
    deterministic = torch.backends.cudnn.deterministic
    # cuDNN's default weight-gradient algorithms add with atomics, so two
    # eager runs already differ in the last bit; bit identity needs the
    # deterministic ones on both legs
    torch.backends.cudnn.deterministic = True
    try:
        return _fluid_lenet_legs(torch, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _fluid_lenet_legs(torch, card) -> dict:
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import io, vision

    main, startup, loss, acc = _fluid_lenet_program(fluid, pt, _FLUID_B)
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name)
    ds = vision.datasets.MNIST(mode="train", backend="fake")
    loader = io.DataLoader(ds, batch_size=_FLUID_B, shuffle=False,
                           drop_last=True)
    batches = []
    for b in loader:
        batches.append({"img": np.asarray(b[0]), "label": np.asarray(b[1])})
        if len(batches) == _FLUID_BATCHES:
            break
    scope, exe = fluid.Scope(), fluid.Executor()
    exe.run(startup, scope=scope)
    start = {n: scope.get(n).clone() for n in scope.local_var_names()}
    e_scope, e_exe = fluid.Scope(), fluid.Executor()
    for n, t in start.items():
        e_scope.set(n, t.clone())
    with _eager():
        e = _fluid_run(e_exe, e_scope, compiled, loss, acc, batches,
                       _FLUID_STEPS)
    _reset_launches()
    before = dict(exe.phases)
    r = _fluid_run(exe, scope, compiled, loss, acc, batches, _FLUID_STEPS)
    launches = _all_launches()
    phases = {k: exe.phases[k] - before[k] for k in before}
    if phases != {"eager": 1, "capture": 1, "replay": _FLUID_STEPS - 2}:
        raise AssertionError(f"fluid_lenet: runs by phase {phases}")
    want = {k: (2 * _FLUID_ADAM if k == "fused_adam" else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"fluid_lenet launches {launches}, not {want}")
    off = _unequal(r["state"], e["state"])
    if r["losses"] != e["losses"] or r["acc"] != e["acc"] or off:
        raise AssertionError(f"fluid_lenet: replay differs from eager: "
                             f"losses {r['losses']} / {e['losses']}, "
                             f"persistables {off[:4]}")
    losses = r["losses"]
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not (np.all(np.isfinite(losses)) and last < first
            and all(0.0 <= a <= 1.0 for a in r["acc"])):
        raise AssertionError(f"fluid_lenet: losses {losses}, accuracies "
                             f"{r['acc']}")
    traced = _profile_step(torch, exe, compiled, batches[0], [loss, acc],
                           scope, card, "fluid_lenet_profile",
                           per_step={k: want[k] // 2 for k in want})
    walls = [s * 1e3 for s in r["step_s"]]
    _say(phase="fluid_lenet", batch=_FLUID_B, steps=_FLUID_STEPS,
         batches=_FLUID_BATCHES, ops=len(main.global_block().ops),
         losses=losses, accuracy=r["acc"], loss_first4=first,
         loss_last4=last, replay_bit_identical=True,
         persistables=len(r["state"]), step_ms_all=walls,
         step_ms_median=statistics.median(walls[2:]),
         eager_step_ms_median=statistics.median(
             [s * 1e3 for s in e["step_s"]][2:]),
         device_ms=traced["device_ms"], families=traced["families"],
         launches=launches, launches_per_replayed_step={
             k: v["calls"] for k, v in traced["path_kernels"].items()},
         runs_by_phase=phases, card=card)
    return launches


def _kernel_row(name, replaces, source, launches, err, t, card, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], **extra, "card": card,
            "launches_note": "launches: the wrapper's count on the host "
            "over the training main path (its warm-up and capture steps; "
            "replays launch the captured kernels without Python); "
            "launches_per_replayed_step: a replayed step's device trace"}


def main() -> int:
    import torch

    card = _environment(torch)
    import paddle_tpu_torch

    # each phase's seconds, said before the kernels line: the command's
    # time is held to a budget, and these show which phase to cut
    seconds, mark = {}, [time.monotonic()]

    def lap(name):
        now = time.monotonic()
        seconds[name] = round(now - mark[0], 3)
        mark[0] = now

    # every phase but train_eager builds static programs; the port starts
    # in dygraph mode (train_eager enters it with dygraph.guard())
    paddle_tpu_torch.enable_static()
    # fp32 products in full fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build()
    lap("build")
    serve_err = _check_kernel(torch)
    errs = _check_training_kernels(torch)
    errs.update(_check_flash(torch))
    lap("kernel_check")
    serve_times = _time_kernel(torch, card)
    times = _time_training_kernels(torch, card)
    times.update(_time_flash(torch, card))
    lap("kernel_times")
    serve_launches, prompts, tokens, decode_profile = _serve(torch, card)
    lap("serve")
    _serve_tier(torch, card, prompts, tokens, decode_profile)
    lap("serve_tier")
    train, traced = _train(torch, card, _TRAIN, _TRAIN_B, _TRAIN_T, "train",
                           0, band=True)
    lap("train")
    train_long, traced_long = _train(torch, card, _LONG, _LONG_B, _LONG_T,
                                     "train_long", _LAYERS)
    lap("train_long")
    train_d256, traced_d256 = _train(torch, card, _D256, _LONG_B, _LONG_T,
                                     "train_d256", _LAYERS,
                                     names=_D256_NAMES)
    lap("train_d256")
    train_f32_d256, traced_f32_d256 = _train(
        torch, card, _F32_D256, _LONG_B, _LONG_T, "train_f32_d256", _LAYERS,
        names=_F32_D256_NAMES)
    _say(phase="train_f32_d256_vs_d256", card=card, **{
        leg: {"step_ms_median": _SAID[leg]["step_ms_median"],
              "tokens_per_s": _SAID[leg]["tokens_per_s"],
              "traced_device_ms": _SAID[leg + "_replay_vs_eager"]["replayed"][
                  "traced_device_ms"],
              "flash_device_ms": {
                  piece: traced["named_kernels"][piece]["ms"]
                  for piece in names if names[piece]}}
        for leg, traced, names in (
            ("train_d256", traced_d256, _D256_NAMES),
            ("train_f32_d256", traced_f32_d256, _F32_D256_NAMES))})
    lap("train_f32_d256")
    observed = _train_observed(torch, card)
    lap("train_observed")
    _sentinel_seq512(torch, card)
    _oom_autopsy(card)
    lap("sentinel_seq512_oom_autopsy")
    recipe = _train_recipe(torch, card, plain_peak=_SAID["train_observed"][
        "memwatch"]["max_memory_allocated"])
    lap("train_recipe")
    eager = _train_eager(torch, card)
    lap("train_eager")
    jitted = _jit(torch, card)
    lap("jit")
    eager_times = _time_flash(torch, card, "BHTD", False)
    lap("eager_kernel_times")
    vision = _vision_fit(torch, card)
    lap("vision_fit")
    amp = _static_amp(torch, card)
    lap("static_amp")
    fluid = _fluid_lenet(torch, card)
    lap("fluid_lenet")
    f32_times = _time_ce_f32(torch, card)
    load_times = _time_flash(torch, card, "BHTD", False, torch.float32,
                             batch=1, repeats=10, device=True)
    train_f32_times = _time_flash(torch, card, "BTHD", True, torch.float32,
                                  repeats=10, device=True)
    d128_f32_times = _time_flash(torch, card, "BHTD", False, torch.float32,
                                 batch=1, repeats=10, heads=6, device=True)
    train_f32_d128_times = _time_flash(torch, card, "BTHD", True,
                                       torch.float32, repeats=10, heads=6,
                                       device=True)
    lap("f32_kernel_times")
    d256_times = _time_flash(torch, card, "BTHD", True, torch.bfloat16,
                             repeats=10, heads=3, device=True)
    f32_d256_times = _time_flash(torch, card, "BTHD", True, torch.float32,
                                 repeats=5, heads=3, device=True)
    f32_d256_load_times = _time_flash(torch, card, "BHTD", False,
                                      torch.float32, batch=1, repeats=10,
                                      heads=3, device=True)
    lap("d256_kernel_times")
    for case in _CPU_VS_CARD:
        _cpu_vs_card(torch, *case)
    _cpu_vs_card_eager(torch, _EAGER_CPU_VS_CARD, 1e-3, 1e-5)
    lap("cpu_vs_card")
    _say(phase="phase_seconds", seconds=seconds)

    csrc = "paddle_tpu_torch/csrc/"
    ce_src = csrc + "lmhead_ce.cu"
    pallas = "paddle_tpu/ops/pallas/"
    shape = {"n": _TRAIN_N, "d": _TRAIN["d_model"],
             "v": _TRAIN["vocab_size"], "dtype": "bfloat16"}

    def by_path(name, **more):
        return {"train": train[name], "train_long": train_long[name],
                "train_d256": train_d256[name],
                "train_f32_d256": train_f32_d256[name],
                "train_observed": observed[name],
                "train_recipe": recipe[name],
                "train_eager": eager.get(name, 0),
                "jit": jitted["jit"].get(name, 0),
                "jit_load": jitted["jit_load"].get(name, 0),
                "jit_load_d256": jitted["jit_load_d256"].get(name, 0),
                "vision_fit": vision[name], "static_amp": amp[name],
                "fluid_lenet": fluid[name], **more}

    def replayed(name):  # the device trace's launches per replayed step
        return {"train": traced["path_kernels"][name]["calls"],
                "train_long": traced_long["path_kernels"][name]["calls"],
                "train_d256": traced_d256["path_kernels"][name]["calls"],
                "train_f32_d256": traced_f32_d256["path_kernels"][name][
                    "calls"]}

    amp_traced = _SAID["static_amp"]["path_kernels"]

    def amp_shape(name):
        """The fp32 route at the static_amp step's N (``_time_ce_f32``),
        with its calls and device ms in a traced replayed step."""
        t = f32_times[name]
        return {"n": _LONG_N, "d": _TRAIN["d_model"],
                "v": _TRAIN["vocab_size"], "dtype": "float32",
                "source": fp32_src if name == "lmhead_ce_fwd" else bwd32_src,
                "calls_per_replayed_step": amp_traced[name]["calls"],
                "device_ms_per_replayed_step": amp_traced[name]["ms"],
                **{k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                     "bound_by", "bound_fma_ms",
                                     "tflops_tf32", "library_ms",
                                     "over_library", "max_abs_err")
                   if k in t}}

    def flash_at(t, name, source, **shape):
        """A flash kernel's timing row at another shape."""
        t = t[name]
        return {"source": source,
                **{k: t[k] for k in ("b", "t", "h", "d", "dtype", "layout",
                                     "causal", "kernel_ms", "plain_ms",
                                     "bound_ms", "bound_by", "bound_fma_ms",
                                     "bound_share", "library_ms", "tflops",
                                     "tflops_tf32", "over_library",
                                     "kernel_device_ms", "library_device_ms")
                   if k in t}, **shape}

    def flash_fp32_src(name, d=64):
        if d == 256:
            return f32_d256_src[name]
        return {"flash_attention_fwd": f32_fwd_src,
                "flash_attention_dq": f32_dq_src,
                "flash_attention_dkv": f32_dkv_src}[name]

    def long_shape(name):
        t = times[(name, "long")]
        return {"n": _LONG_N, "d": _TRAIN["d_model"],
                "v": _TRAIN["vocab_size"], "dtype": "bfloat16",
                **{k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                     "library_ms", "library_dx_dw_ms",
                                     "tflops", "over_library") if k in t}}

    fp32_src = csrc + "lmhead_ce_fwd_f32_sm90.cu"
    bwd32_src = csrc + "lmhead_ce_bwd_f32_sm90.cu"
    fwd = _kernel_row(
        "lmhead_ce_fwd", pallas + "fused_lmhead_ce.py:99",
        csrc + "lmhead_ce_fwd_sm90.cu", train["lmhead_ce_fwd"],
        max(serve_err, errs["lmhead_ce_fwd"],
            f32_times["lmhead_ce_fwd"]["max_abs_err"]),
        times["lmhead_ce_fwd"], card,
        shape=shape, source_fp32=fp32_src, source_combine=ce_src,
        launches_by_path=by_path("lmhead_ce_fwd", serve=serve_launches),
        launches_per_replayed_step=replayed("lmhead_ce_fwd"),
        tflops=times["lmhead_ce_fwd"]["tflops"],
        over_library=times["lmhead_ce_fwd"]["over_library"],
        long_shape=long_shape("lmhead_ce_fwd"),
        static_amp_shape=amp_shape("lmhead_ce_fwd"),
        serve_shapes=[{"n": n, "d": _SERVE_D, "v": _SERVE_V,
                       "dtype": "float32", "source": fp32_src,
                       **{k: serve_times[(n, "float32")][k] for k in (
                           "kernel_ms", "plain_ms", "library_ms",
                           "bound_ms", "bound_fma_ms", "tflops_tf32",
                           "over_library")}}
                      for n in _SCORE_NS])

    rows = [fwd] + [
        _kernel_row(name, pallas + where, csrc + "lmhead_ce_bwd_sm90.cu",
                    train[name],
                    max(errs[name], f32_times[name]["max_abs_err"]),
                    times[name], card, shape=shape,
                    source_fp32=bwd32_src, launches_by_path=by_path(name),
                    launches_per_replayed_step=replayed(name),
                    library_dx_dw_ms=times[name]["library_dx_dw_ms"],
                    tflops=times[name]["tflops"],
                    over_library=times[name]["over_library"],
                    long_shape=long_shape(name),
                    static_amp_shape=amp_shape(name))
        for name, where in (("lmhead_ce_dx", "fused_lmhead_ce.py:188"),
                            ("lmhead_ce_dw", "fused_lmhead_ce.py:221"))]
    rows.append(_kernel_row(
        "fused_adam", pallas + "fused_adam.py:25", csrc + "fused_adam.cu",
        train["fused_adam"], errs["fused_adam"], times["fused_adam"], card,
        launches_by_path=by_path("fused_adam"),
        launches_per_replayed_step=replayed("fused_adam"),
        shape={"param": "gpt.wte", "dims": [_TRAIN["vocab_size"],
                                            _TRAIN["d_model"]],
               "dtype": "bfloat16"}))
    flash_shape = {"b": _LONG_B, "t": _LONG_T, "h": _LONG["n_head"],
                   "d": _head_dim(_LONG), "dtype": "bfloat16",
                   "layout": "BTHD", "causal": True}
    f32_dq_src = csrc + "flash_attention_dq_f32_sm90.cu"
    f32_fwd_src = csrc + "flash_attention_fwd_f32_sm90.cu"
    f32_dkv_src = csrc + "flash_attention_dkv_f32_sm90.cu"
    f32_d256_fwd_src = csrc + "flash_attention_fwd_f32_d256_sm90.cu"
    f32_d256_src = {
        "flash_attention_fwd": f32_d256_fwd_src,
        "flash_attention_dq": csrc + "flash_attention_dq_f32_d256_sm90.cu",
        "flash_attention_dkv": csrc + "flash_attention_dkv_f32_d256_sm90.cu"}
    jit_d256 = _SAID["jit"]["jit_load_d256"]
    d256_src = {"flash_attention_fwd": csrc + "flash_attention_fwd_d256_sm90.cu",
                "flash_attention_dq": csrc + "flash_attention_dq_d256_sm90.cu",
                "flash_attention_dkv": csrc + "flash_attention_dkv_d256_sm90.cu"}
    d256_piece = {"flash_attention_fwd": "::fwd_d256_sm90_kernel(",
                  "flash_attention_dq": "::dq_d256_sm90_kernel(",
                  "flash_attention_dkv": "::dkv_d256_sm90_kernel("}
    f32_d256_piece = {"flash_attention_fwd": "::fwd_f32_d256_sm90_kernel(",
                      "flash_attention_dq": "::dq_f32_d256_sm90_kernel(",
                      "flash_attention_dkv": "::dkv_f32_d256_sm90_kernel("}
    for name, bthd, bhtd in (
            ("flash_attention_fwd", 130, 68),
            ("flash_attention_dq", 354, 315),
            ("flash_attention_dkv", 471, 423)):
        extra = {"source_fp32": flash_fp32_src(name),
                 "source_fp32_d256": flash_fp32_src(name, 256),
                 "source_d256": d256_src[name],
                 "tflops": times[name]["tflops"],
                 "over_library": times[name]["over_library"]}
        if name == "flash_attention_fwd":
            source = csrc + "flash_attention_fwd_sm90.cu"
        else:
            extra["library_dq_dk_dv_ms"] = times[name]["library_dq_dk_dv_ms"]
            source = csrc + "flash_attention_bwd_sm90.cu"
        extra["jit_load_shape"] = flash_at(load_times, name,
                                            flash_fp32_src(name))
        amp_named = _SAID["static_amp"]["fp32_path_kernels"][name]
        extra["train_f32_shape"] = flash_at(
            train_f32_times, name, flash_fp32_src(name),
            launches_per_step=_LAYERS,
            path="the fp32 GPT training program (static_amp's undecorated "
                 "program)", calls_per_replayed_step=amp_named["calls"],
            device_ms_per_replayed_step=amp_named["ms"])
        extra["f32_d128_shape"] = flash_at(d128_f32_times, name,
                                           flash_fp32_src(name))
        extra["train_f32_d128_shape"] = flash_at(
            train_f32_d128_times, name, flash_fp32_src(name),
            path="no path: the fp32 training shape at 6 heads of 128")
        traced_named = traced_d256["named_kernels"][d256_piece[name]]
        device_ms = traced_named["ms"] / traced_named["calls"]
        library_ms = d256_times[name]["library_device_ms"]
        extra["d256_shape"] = flash_at(
            d256_times, name, d256_src[name], path="train_d256",
            launches=train_d256[name],
            calls_per_replayed_step=traced_named["calls"],
            device_ms_per_replayed_step=traced_named["ms"],
            kernel_device_ms=device_ms,
            over_library_device=device_ms / library_ms if library_ms
            else None)
        f32_named = traced_f32_d256["named_kernels"][
            f32_d256_piece[name]]
        f32_device_ms = f32_named["ms"] / f32_named["calls"]
        f32_library_ms = f32_d256_times[name]["library_device_ms"]
        extra["f32_d256_shape"] = flash_at(
            f32_d256_times, name, flash_fp32_src(name, 256),
            path="train_f32_d256", launches=train_f32_d256[name],
            calls_per_replayed_step=f32_named["calls"],
            device_ms_per_replayed_step=f32_named["ms"],
            kernel_device_ms_in_step=f32_device_ms,
            over_library_device=f32_device_ms / f32_library_ms
            if f32_library_ms else None)
        if name == "flash_attention_fwd":
            extra["jit_load_d256_shape"] = flash_at(
                f32_d256_load_times, name, f32_d256_fwd_src,
                path="jit_load_d256",
                launches=jitted["jit_load_d256"]["flash_attention_fwd"],
                calls_per_replay=jit_d256["traced_kernel_calls"],
                device_ms_per_replay=jit_d256["traced_kernel_device_ms"],
                replay_device_ms=jit_d256["traced_device_ms"],
                replayed_ms=jit_d256["replayed_ms"])
        extra["eager_shape"] = dict(
            flash_shape, layout="BHTD", causal=False,
            **{k: eager_times[name][k] for k in (
                "kernel_ms", "plain_ms", "bound_ms", "library_ms",
                "tflops", "over_library")})
        rows.append(_kernel_row(
            name, pallas + f"flash_attention.py:{bthd}", source,
            train_long[name], errs[name], times[name], card,
            replaces_bhtd=pallas + f"flash_attention.py:{bhtd}",
            launches_by_path=by_path(name),
            launches_per_replayed_step=replayed(name), shape=flash_shape,
            **extra))
    _say(kernels=rows)
    print(card, flush=True)
    _say(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--oom-child"]:
        sys.exit(_oom_child())
    sys.exit(main())
