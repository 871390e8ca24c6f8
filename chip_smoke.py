#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, evaluation and training paths (PushT,
kitchen, UMI, the robomimic tool-hang and LIBERO-10 suites, the CLIP text
tower) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds; a phase that fails raises, and the
script exits non-zero without its result line). The attention kernels are
built for head dimensions 64 (mar_base), 80 (mar_huge) and 128 (mar_small);
every check of an attention launch names the instance (kernel and D) that
attention_plan picks.

1. env     torch and CUDA versions, the card's name and power limit.
2. build   every kernel source of unified_video_action_tpu_torch/csrc/
           (attention.cu, int8_mm.cu) by nvcc, all started together.
3. kernel  each kernel against its plain PyTorch version on the card, at the
           serving paths' shapes and beyond (attention at D = 64, at the
           mar_small paths' D = 128 and at the mar_huge paths' D = 80; the
           int8 kernels at mar_base's shapes and at mar_huge's MAR layers,
           K = 1280 and the fc2 input's 5120), with times (CUDA-graph replay)
           beside its bound and beside one PyTorch library call computing
           the same function; every launch lands on the kernel its plan
           names (attention_plan, quantize_plan, gemm_plan); the attention
           kernels within attention_check's limits, which a planted
           unmasked ragged KV edge must fail at every ragged N; bf16 views
           off a 16-byte boundary through the staging copy (bit-equal to
           torch.stack) and the TMA kernels; at D = 80 the online kernel's
           exact-width tiles at ragged N (137, 500, 1000) in both work-item
           sizes, and the head-width control: views whose next 48 columns
           in memory hold NaN must come out finite and within the limits
           (no kernel reads a column past 79 from memory), and a planted
           kernel that reads all 128 columns must fail; the fp32
           (3xTF32) kernel at every D within 2e-5 at N = 144, a ragged N,
           unaligned views and N = 2304, and at the 256 px path's fp32
           (128, 1024, 12, 64); the int8
           kernels must be bit-equal, also with each planted fault (below)
           shown to break that.
4. serve   UnifiedVideoActionPolicy.predict_action_frames (the predict
           program on selected frames) at the flagship's width
           (mar_base: 12+12 blocks, d=768, 12 heads, 96 px, 144 tokens), in
           bf16 at B=1 and B=128 with 100 sampler steps. The VAE weights are
           the committed pusht_vae96.npz; the MAR and denoiser weights are
           numpy draws from a seed in the flax layout, through the weight
           bridge (the flagship's orbax checkpoint needs JAX to be read).
           Checks: shape, finite values inside the normalizer's range, the
           planned attention kernel launched once per ViT block per call
           (the single-pass wgmma kernel at both batches), the kernel route
           against the plain-attention route under the same noise, controls
           (the kernel with planted faults, which that comparison must
           reject), and the card in fp32 against the port on the CPU in fp32;
           one fp32 request at B=128 (the fp32 kernel once per block), its
           device time and stages.
5. serve_256px  the reference's own PushT model as the JAX package's parity
           tier serves it (config.PUSHT_256: mar_base, 96 px frames upscaled
           to 256 on the card, 1024 tokens, the KL-16 VAE with ch 128, 100
           sampler steps, bf16), numpy-seeded MAR, denoiser and VAE weights:
           the obs-dict predict_action at B=1 and B=128 with the online-
           softmax attention kernel launched once per ViT block (and no
           other attention kernel), the kernel route against the plain
           route at B=8 with the serve limits and the controls that can
           plant a fault at N = 1024, request times and a stage breakdown
           at both batches.
5b. serve_small96  mar_small, the single-chip PushT model (config.
           PUSHT_SMALL96: 6+6 blocks, d=768 over 6 heads of D = 128, 96 px,
           144 tokens, the committed pusht_vae96.npz, numpy-seeded MAR and
           denoiser): the obs-dict predict_action (100 steps, bf16) at B=1
           and B=128 and the deployed tier's predict_action_cached (ddim10 +
           int8 + yuv420, full then cached) at both, each call launching the
           single-pass kernel's D = 128 instance once per ViT block (12) and
           no other attention kernel, and the int8 kernels as the config
           implies; the int8 kernel route bit-equal to the plain-int8 route,
           the kernel route against the plain route with the serve limits and
           controls, the card in fp32 (the fp32 kernel at D = 128) against
           the CPU, request times.
5c. serve_kitchen128  the language-conditioned kitchen model (config.
           KITCHEN_SMALL128: mar_small at 128 px, 256 frame tokens and the
           64-token text buffer, 320 in all, 9-d actions, the committed
           kitchen_vae128.npz; the goal a string through the hash text
           encoder), the same checks with the online kernel's D = 128
           instance (a 64-row last KV tile), one call without a goal, and
           the goal shown to change the actions.
5d. serve_huge96  mar_huge, the MAR paper's largest size (config.
           PUSHT_HUGE96: 20+20 blocks, d=1280 over 16 heads of D = 80, 96 px,
           144 tokens, 876 M MAR and denoiser parameters, numpy-seeded, the
           committed pusht_vae96.npz): serve_small96's checks at the D the
           config implies (40 launches a call of the single-pass kernel's
           D = 80 instance; the deployed tier's fc2 rows, K = 5120, through
           the vector quantize kernel's widest instance).
5e. serve_huge256  mar_huge at 256 px (config.PUSHT_HUGE256: 1024 tokens,
           the seeded ch-128 KL-16 VAE): serve_256px's checks, 40 launches a
           call of the online kernel's D = 80 instance, request times, the
           stage breakdown at both batches.
5f. serve_umi  the UMI multi-task model (config.UMI_MULTI: mar_base at 256 px,
           224 px frames upscaled on the card, 1024 frame tokens and the
           64-token text buffer, N = 1088; the streams: history actions,
           the 16-d relative-pose state, CLIP-width language latents from the
           hash encoder; the seeded ch-128 KL-16 VAE, numpy-seeded MAR), the
           obs-dict predict_action on the 16-step relative-pose window with
           past_action at B=1 (a robot controller) and B=32: each call 24
           launches of the online kernel's D = 64 instance and no other
           attention kernel; the kernel route against the plain route at B=8
           with the streams, the serve limits and the controls that plant a
           fault at N = 1088 (a multiple of the serve controls' 64-row KV
           tile; the kernel phase plants the online kernel's 128-row edge
           there); the card in fp32 against the CPU in fp32 at B=1; request
           times.
5g. serve_toolhang  config.TOOLHANG (N = 1024, both 240 px cameras, the
           wrist one VAE-encoded as a stream, the 9-d state, a 9-d
           proprioception head): serve_umi's checks at B=1 and B=8 with the
           controls that plant a fault at N = 1024.
5h. real_loop  the real-robot deployment path in a closed loop: the
           shared-memory library built from native/shm_ipc.cpp by g++; the
           sim-backed UmiRealEnv (the arm, the gripper and a 224 px camera,
           each a spawned process over that library's rings and queues) at
           10 Hz with the 16-step UMI window; config.UMI_MULTI on
           serve_umi's seeded weights behind the port's PolicyInferenceNode
           (bf16, 100 steps, the hash encoder's latent as the task's). Each
           of 8 cycles: get_obs, get_real_umi_obs_dict against the
           episode's start pose, node.infer, get_real_umi_action, the
           timestamps the aligned obs time plus k / 10 Hz, exec_actions.
           Checks: 24 online D = 64 launches a request and no other
           attention kernel, finite absolute actions, at least one fresh
           action a cycle; one recorded cycle replayed through the kernel
           route against the plain route (the serve limits and controls)
           and in fp32 on the card against the CPU; at the end the arm's
           pose on its own trajectory and that on the last action within
           1e-3, the gripper on the last width; the episode's timestamps
           increasing and its actions those the controllers kept. Prints
           the request ms, the obs-to-first-action latency, the stale
           actions dropped, the control period and /dev/shm's size.
6. deployed  the deployed tier, predict_action_cached with ddim10 +
           serving_quant="int8" + obs_codec="yuv420", same width and
           weights, bf16, at B=1 and B=128: a full call on a 16-frame window,
           then a cached call (n_shift=8) that encodes 2 new frames. Checks:
           shapes, finite actions inside the normalizer's range, the launches
           of every kernel per call against the count the config implies,
           the kernel route bit-equal to the plain-int8 route under the same
           noise, the controls (the int8 kernels with planted faults, which
           that comparison must reject), and the int8 route apart from the
           bf16 route. Request times, a stage breakdown and the device's
           busy share.
7. rollout the PushT evaluation path: PushTImageRunner (16 test seeds from
           100000, 16 env steps: a full and a cached call per env) at
           the same width and weights, closing the loop through the port's
           env. (a) the deployed tier latent-cached over two streams, (b) the
           same with the plain-int8 route and the same generator seed, (c)
           bf16 ddim10 uncached over one stream, (d) rollout (a) with
           vector_env="async" (each env in a spawned process, from
           envs/pusht.make_runner_env). Checks: every env runs to
           its end, every action chunk finite and inside the normalizer's
           range, each kernel's launches over each rollout against the
           config, (a), (b) and (d) identical per seed (sim_max_reward and
           the final agent position), and no OpenCV or dill loaded. Host ms
           per env control step, ms per full and cached call, the rollouts'
           wall time and env seconds (sync against async), the env
           processes' start time and the host's resident memory at the first
           call, and rollout (a)'s device idle share.
7b. video  video generation at full width (Mar.sample_video: MaskGIT rounds
           of one encoder and decoder pass each, then the video head's
           100-step sampler on the tokens a round reveals; the VAE decode;
           eval/offline.test_video_fvd). The flagship (mar_base, 96 px, the
           numpy-seeded MAR and the committed pusht_vae96.npz with its
           decoder): test_video_fvd over 2 batches of 32 validation windows
           of the corpus at num_iter 1, video_fvd_vae and video_fvd_pixel,
           ms per batch by stage (encode, MAR, action sampler, video
           sampler, decode) and the device's busy share; sample_video at
           num_iter 2 and B=8 (the rank slices). Each counted: the single-
           pass D = 64 instance 24 times a round, no other attention
           kernel. The kernel route against the plain route under the same
           draws (every attention call within the serve limits, the latents
           within VIDEO_FLOOR_RATIO of the bf16 floor; the planted controls
           rejected); the card in fp32 against the CPU in fp32 at B=2,
           num_iter 1; the trained decoder's PSNR on 64 corpus frames, the
           card within 0.05 dB of the CPU. config.PUSHT_256 (the online D =
           64 kernel, 24 a round) and config.KITCHEN_SMALL128 with a goal
           and cfg 1.5 (8 rows at B=4, the online D = 128 kernel, 12 a
           round; the CFG no-op control: a projected goal equal to
           fake_latent gives bit-identical latents at cfg 3 and 7), each with
           the same route check.
8. train   the flagship's training step (train_torch.py's Trainer on the
           stage-2 recipe of latest/meta.json: mar_base at full width, 96 px,
           144 tokens, B=32, bf16 with fp32 parameters, policy_model and
           full_dynamic_model drawn per step, dropout 0.1, AdamW + EMA, the
           device-resident store with device-side augmentation), initialized
           from SEED, on a synthetic store of TRAIN_EPISODES episodes rolled
           out in the port's PushT env. Checks: 3 fp32 steps (no TF32) at B=2
           on the card and on the CPU with the same weights, batches, noise
           and dropout masks, each step's losses and grad_norm within
           TRAIN_PARITY_RTOL; 15 bf16 steps at B=32 with every metric finite
           and no uva_* kernel launched (training attends through the plain
           path: the kernels have no backward); an overfit run on one fixed
           batch whose loss must fall below OVERFIT_FRACTION of its first;
           the EMA weights served by the bf16 serving policy at B=1 and B=32,
           finite, inside the normalizer's range, through the attention
           kernel as the serve phase launches it. ms per step (median by
           CUDA events), samples/s, peak memory and the device idle share
           over 5 profiled steps. No evaluation, checkpoint or resume: those
           are train_run's.
9. train_run  a whole training run of the flagship's two-stage recipe
           (scripts/round4b_train.sh) through train_torch.py's Trainer at the
           same width, on the committed corpus (corpora/pusht_demos_r5b.npz:
           300 episodes, 74,256 steps, read by numpy; 66,289 training
           windows, the frames on the card), each epoch cut to RUN_STEPS
           steps: stage 1 (video_model, no action head) with a checkpoint
           and the video FVD of sample_every (logged, never skipped, the
           top-k named by video_fvd_vae as train_torch.py switches it);
           stage 2 from it through pretrained_model_path, the leaves kept at
           their initial values counted against the leaves stage 2 has and
           stage 1 lacks; two epochs with validation (RUN_VAL_STEPS batches)
           and a rollout of the EMA policy (RUN_TEST_SEEDS test seeds of
           RUN_MAX_STEPS steps) every epoch, latest and top-2 checkpoints,
           every logged metric finite, the tracker's steps those of
           logs.jsonl; every validation and rollout call launching the
           attention kernel its plan names once per ViT block and nothing
           else, the training steps no uva_* kernel; a resumed Trainer whose
           parameters, EMA, AdamW moments, scheduler, step and epoch are
           bit-equal to the first's in memory, then one more epoch; its slim
           export served through eval_sim_torch.py's loading path at B=1 and
           B=32, bit-equal to the EMA in memory under the same noise. Seconds
           and bytes of a checkpoint's save and load and of the export, ms
           per step on the corpus, the rollouts' wall time.
9b. pusht_pipeline  the PushT pipeline from the scripted expert to a
           recorded env: tools/gen_pusht_demos.py's generate tries 4
           episodes of the port's expert (env seeds from 20000, up to 300
           steps at 96 px), keeps those that reach 0.9 and writes them as an
           .npz, which PushTImageDataset loads with the host augmentation;
           train_torch.py's Trainer on config.PUSHT_256_RUN (uva_pusht.yaml:
           mar_base at 256 px, B = 16, data_aug) through the host loader with
           device_aug=false (the loader's threads crop, resize and blur every
           clip; the numpy-seeded ch-128 VAE) on the committed corpus: 4 bf16
           steps, every metric finite and no uva_* launch, each step's time
           by CUDA events beside its wait for the loader, peak memory; one
           validation reading with 24 launches of the online kernel's D = 64
           instance (B = 16, N = 1024); a PushTEnv(render_action=True) in
           VideoRecordingWrapper for 6 steps, every frame with the action
           marker, the GIF's header, frame count and trailer checked.
10. train_umi  the UMI model's stage 2 (config.UMI_MULTI with
           config.UMI_TRAIN_OVERRIDES and its grad_checkpointing on) through
           train_torch.py's Trainer and the host loader, on the port's
           synthetic corpus (three datasets of 4 episodes at 224 px, written
           here by tools/gen_synthetic_umi.py as reference-layout zarr v2
           stores, two directories and one .zarr.zip, every key zlib, read
           lazily through the byte-bounded chunk caches; one batch of them
           bit-equal to the same batch of an in-memory load; the caches'
           peak), the codec line (libblosc, libzstd, liblz4: a chunk round
           trip and a .zarr.tar.lz4 through tools/stage_datasets.py extract
           where the library loads, else the error naming it), the MAR and
           the VAE started from reference-format torch checkpoints written
           here from seeded weights (state_dicts.ema_model under model., a
           kl16.ckpt; a config object no machine can import) through
           pretrained_model_path and autoencoder_path, every imported leaf
           equal to its source; 3 fp32 steps at B=1 with the
           model cut to 2+2 blocks at full width on the card and on the CPU
           (the same batches, noise, label drop and dropout masks) within
           TRAIN_PARITY_RTOL; UMI_STEPS bf16 steps at B=32 at full depth,
           both task modes, the random history frequency, every metric
           finite, no uva_* kernel launched; ms per step by CUDA events, the
           host loader's wait a batch, peak memory; one
           val_action_l2_distances reading whose predict call
           launches the online kernel's D = 64 instance once per block.
11. suite_toolhang  robomimic's tool-hang trained then evaluated: a
           synthetic robomimic-layout store (8 demos of 64 steps, two 240 px
           cameras, a smooth absolute pose trajectory) written here by
           tools/gen_synthetic_suites.py; config.TOOLHANG with
           config.SUITE_TRAIN_OVERRIDES through train_torch.py's Trainer and
           the host loader, SUITE_STEPS bf16 steps at B = SUITE_B (every
           metric finite, no uva_* launch; ms per step, peak memory); the
           slim export evaluated through eval_sim_torch.py's evaluate on the
           stub backend (2 train and 4 test envs, 64 steps): every request 24
           launches of the online kernel's D = 64 instance and no other
           attention kernel, finite actions, each stub's action_log the
           runner's undone (axis-angle) actions, the log's keys and its
           .STUB file name; the first request through the kernel route
           against the plain route (the serve limits and the controls that
           plant a fault at N = 1024) and its first env in fp32 on the card
           against the CPU. Request ms at the runner's batch.
12. suite_libero10  LIBERO-10 the same way: ten synthetic task stores
           named by LIBERO10_TASK_NAMES (3 demos of 48 steps at 128 px),
           config.LIBERO10 with data_aug (ColorJitter on the host loader),
           make_libero_runners on the stub (2 test envs a task, 16 steps);
           beside suite_toolhang's checks, one language goal per runner and
           test_mean_score the mean of the per-task means.
13. clip   the CLIP text tower at the width of openai/clip-vit-base-patch32
           on seeded weights through get_text_encoder: fp32 and bf16 on the
           card against fp32 on the CPU.

The phases' depth was cut to keep the script inside its time limit when the
UMI phases joined: timed requests 5 at B=1 and 3 at larger B (9 and 5
before), stage breakdowns of 3 (5), the profiled request of a breakdown
(the device's busy share) only for the flagship at B=128 and the deployed
tier (the other breakdowns keep their stages by CUDA events), the fp32 request 3
(5), the video FVD 2 batches (4), sample_video at num_iter 2 (4), the
rollout 16 env steps (32), the train phase 15 bf16 steps, 6 timed and 2
profiled (30, 10 and 5), train_run 4 steps an epoch (8) and 16-step
rollouts (24). When the PushT pipeline joined: the video phase's
fp32 check at num_iter 1 (2), real_loop 8 cycles (10), LIBERO's stub
evaluation 16 steps (32).

The last lines are the card (``nvidia-smi`` name and power limit), one JSON
object with every kernel's numbers, and the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
It needs one card and reads only files of this repository.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

# what torch and numpy load by themselves (torch imports dill where it is
# installed): the rollout phase checks that the port loads no OpenCV and no
# dill beyond these
MODULES_BEFORE_THE_PORT = frozenset(m.split(".")[0] for m in sys.modules)

REPO = os.path.dirname(os.path.abspath(__file__))
LATEST = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest")
VAE_NPZ = os.path.join(REPO, "pretrained_models", "vae", "pusht_vae96.npz")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: outside the tensor cores
PEAK_INT8_OPS = 1979e12
# fp32 attention runs both products on the tensor cores as three TF32
# products each (3xTF32, csrc/attention.cu): its bound counts 3 x the
# products' operations at the TF32 dense peak
PEAK_TF32_FLOPS = 495e12
TF32_PRODUCTS = 3
KERNEL_SOURCES = ("attention", "int8_mm")
# attention: atol of tests/test_ops.py
ATTN_ATOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
# bf16 attention, beside ATTN_ATOL, limits that scale with the output (an
# output's RMS is about sqrt(e / N) for randn q, k, v: 0.05 at N = 1024, so
# ATTN_ATOL alone would pass a kernel whose outputs are all a few percent
# off): ||kernel - plain|| / ||plain|| (the bf16 roundings of P and of the
# output give about 2.5e-3; a KV edge left unmasked at N = 1000, 24 zero keys
# in the softmax, gives 1.4e-2) and max |kernel - plain| / RMS(plain) (about
# 0.03; one wrong q-tile gives several)
ATTN_BF16_REL_RMS = 6e-3
ATTN_BF16_MAX_OVER_RMS = 0.1
# the KV rows past N that a kernel's loads fill with zeros, which only its
# mask keeps out of the softmax: the single-pass kernel holds 144 rows, the
# online kernel streams 128-row tiles, the fp32 kernel 32-row ones
# (csrc/attention.cu)
KV_EDGE = {"attention_wgmma": 144, "attention_wgmma_online": 128, "attention_f32": 32}
# serve, the kernel route against the plain route in bf16 under the same
# noise (P is rounded to bf16 in the kernel and not in the plain version):
# - the decoder output that conditions the action head, after 24 bf16
#   blocks, measured against the same blocks in fp32: the kernel route's
#   mean |z - z_fp32| may exceed the plain route's (the bf16 floor of the
#   model) by at most this factor. Over seeds 0-4 of the random weights of
#   every served config (tools/serve_limits.py) the kernel's ratio reads
#   0.996-1.023, and a softmax scale 10 % off 1.03-3.14: below 1.1 at some
#   seeds at 96 px, where the floor of 24 bf16 blocks hides it.
SERVE_Z_FLOOR_RATIO = 1.1
# - the normalized action chunk ([-1, 1]): mean |da| and the 99th percentile
#   of |da|. Not the max: the sampler's first step multiplies x and eps by
#   about 2e4 before clipping x0 to [-1, 1], so an element whose terms nearly
#   cancel lands on either side under any bf16-level change of z.
SERVE_ACTION_MEAN_ATOL = 1e-2
SERVE_ACTION_P99_ATOL = 5e-2
# - every attention call of the request against the plain version on that
#   call's own inputs, with the limits that scale with its output (a path's
#   outputs reach 4-8, where one bf16 step is ATTN_ATOL): ||kernel - plain|| /
#   ||plain|| within this, and ATTN_BF16_MAX_OVER_RMS. Set from the same
#   sweep: the kernel's worst call reads 7.4e-4 to 9.0e-4, a softmax scale
#   10 % off 7.2e-3 to 5.8e-2 (the attention of the served models is flatter
#   than on randn inputs, where it reads 0.13); the limit sits near their
#   geometric mean, 2.8x from either.
SERVE_CALL_REL_RMS = 2.5e-3
# the planted faults (``control_faults``) that those limits must reject; the
# smaller scale errors are printed to show how far the limits see
REJECTED_CONTROLS = ("exp_base_2", "unmasked_kv_edge", "scale_x1.1")
# repetitions of the timed requests (B = 1; B of 32 and more) and of a stage
# breakdown's timed requests: 9, 5 and 5 before the UMI phases joined (the
# whole script must keep inside its time limit)
REPS_B1, REPS_LARGE, STAGE_REPS = 5, 3, 3
# the unmasked_kv_edge control pads the keys and values with zeros up to a
# multiple of this (144 -> 192): the softmax then weighs 48 zero keys, as a
# kernel that left a 64-wide KV tile's ragged edge unmasked would
KV_TILE = 64
# the card in fp32 against the CPU in fp32, normalized actions, max: summation
# order only, amplified by the sampler's first steps (tests/test_torch_policy.py)
SERVE_FP32_ATOL = 1e-3

_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        log(f"== phase {self.name} {'failed' if exc_type else 'done'} in {dt:.1f}s")
        return False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean device time of ``reps`` calls,
    by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    per_round = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per_round.append(start.elapsed_time(end) / reps)
    return statistics.median(per_round)


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the device time per call of one CUDA graph
    that replays ``reps`` calls of ``fn``, captured after a warm-up: no host
    dispatch between the launches, so a kernel of a few microseconds shows
    its own time (``time_ms`` would show the Python dispatch instead)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_round = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_round.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(per_round)


def attention_bound(B: int, N: int, H: int, D: int, dtype: torch.dtype):
    """Least time for (B, N, H, D) attention: q, k, v read once, out written
    once, and 4·B·H·N²·D operations at the bf16 peak, or in fp32 three times
    as many at the TF32 peak (the 3xTF32 kernel's work)."""
    item = torch.finfo(dtype).bits // 8
    t_bytes = 4 * B * N * H * D * item / HBM_BYTES_PER_S
    ops = 4 * B * H * N * N * D
    t_ops = (TF32_PRODUCTS * ops / PEAK_TF32_FLOPS if dtype == torch.float32
             else ops / PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# (B, N, H, D, dtype, aligned): aligned cases are strided views of one qkv
# tensor, as the fused projection leaves them; the unaligned ones start them
# an element off a 16-byte boundary (bf16: staged, then the TMA kernels)
ATTENTION_CASES = [
    (128, 144, 12, 64, torch.bfloat16, True),  # the serving shape at B=128
    (1, 144, 12, 64, torch.bfloat16, True),  # the serving shape at B=1
    (128, 1024, 12, 64, torch.bfloat16, True),  # the 256 px path at B=128
    (1, 1024, 12, 64, torch.bfloat16, True),  # the 256 px path at B=1 (64-row items)
    (16, 1024, 12, 64, torch.bfloat16, True),  # uva_pusht.yaml's validation at its B=16
    (128, 144, 12, 64, torch.float32, True),
    (8, 137, 12, 64, torch.bfloat16, True),  # a ragged single-pass N (7 rows of edge)
    (8, 100, 12, 64, torch.bfloat16, True), (8, 100, 12, 64, torch.float32, True),
    # past the single-pass kernel's limit, the online kernel: ragged last KV
    # tiles of 17, 1, 104 and 64 rows at N = 145, 257, 1000 and 1088, in 64-row
    # work items at B = 1 and N <= 257 and in 128-row ones at (8, 1000), (8, 1088)
    (8, 145, 12, 64, torch.bfloat16, True), (8, 256, 12, 64, torch.bfloat16, True),
    (8, 257, 12, 64, torch.bfloat16, True), (8, 1000, 12, 64, torch.bfloat16, True),
    (1, 1000, 12, 64, torch.bfloat16, True),
    (8, 1088, 12, 64, torch.bfloat16, True), (8, 1088, 12, 64, torch.float32, True),
    # the UMI path's N = 1088 (1024 frame tokens and the text buffer) at its
    # serving batches: 128-row items at B = 32, 64-row ones at B = 1
    (32, 1088, 12, 64, torch.bfloat16, True), (1, 1088, 12, 64, torch.bfloat16, True),
    (1, 2304, 12, 64, torch.bfloat16, True), (1, 2304, 12, 64, torch.float32, True),
    (8, 1088, 12, 64, torch.bfloat16, False),
    # fp32 (the 3xTF32 kernel) beyond the serving shape: the 256 px path's
    # (128, 1024) and unaligned views (4-byte copies)
    (128, 1024, 12, 64, torch.float32, True), (8, 1088, 12, 64, torch.float32, False),
    # head dimension 128 (mar_small, 6 heads): the 96 px mar_small path's N =
    # 144 (single pass, split at every B), the kitchen path's N = 320 (online,
    # a 64-row last KV tile, whose edge left unmasked must fail the checks;
    # 64-row items at B = 1 and 16, 128-row ones at B = 128), unaligned views
    # (staged) and fp32
    (1, 144, 6, 128, torch.bfloat16, True), (128, 144, 6, 128, torch.bfloat16, True),
    (1, 320, 6, 128, torch.bfloat16, True), (16, 320, 6, 128, torch.bfloat16, True),
    (128, 320, 6, 128, torch.bfloat16, True),
    (8, 320, 6, 128, torch.bfloat16, False),
    (128, 144, 6, 128, torch.float32, True),
    # fp32: a ragged N (its edge left unmasked must fail the checks),
    # unaligned views and N = 2304
    (8, 1000, 6, 128, torch.float32, True), (8, 320, 6, 128, torch.float32, False),
    (1, 2304, 6, 128, torch.float32, True),
    # head dimension 80 (mar_huge, 16 heads): the 96 px path's N = 144 (single
    # pass, split at every B, in D = 128's tiles with columns 80-127 from
    # TMA's zero fill), the 256 px path's N = 1024 (online, exact width), ragged
    # online N whose edge left unmasked must fail the checks, unaligned views
    # (staged) and fp32 (exact width: ten k-steps and n-tiles of 8) at N =
    # 144, a ragged N, unaligned and N = 2304
    (1, 144, 16, 80, torch.bfloat16, True), (128, 144, 16, 80, torch.bfloat16, True),
    (1, 1024, 16, 80, torch.bfloat16, True), (16, 1024, 16, 80, torch.bfloat16, True),
    (128, 1024, 16, 80, torch.bfloat16, True), (8, 1000, 16, 80, torch.bfloat16, True),
    (1, 500, 16, 80, torch.bfloat16, True),
    (8, 1024, 16, 80, torch.bfloat16, False),
    (128, 144, 16, 80, torch.float32, True), (8, 1000, 16, 80, torch.float32, True),
    (8, 1024, 16, 80, torch.float32, False), (1, 2304, 16, 80, torch.float32, True),
]


def attention_row(rows, B: int, N: int, dtype=torch.bfloat16, D: int = 64, aligned: bool = True) -> dict:
    """The kernel phase's row of one case."""
    name = str(dtype).split(".")[-1]
    return next(r for r in rows
                if (r["B"], r["N"], r["D"], r["dtype"], r["aligned"]) == (B, N, D, name, aligned))


def attention_check(out: torch.Tensor, ref: torch.Tensor):
    """(errors, ok): a kernel's output against the plain version's, with
    ATTN_ATOL and, in bf16, ATTN_BF16_REL_RMS and ATTN_BF16_MAX_OVER_RMS."""
    diff, ref = out.float() - ref.float(), ref.float()
    rms = ref.pow(2).mean().sqrt().item()
    errs = {"max_abs_err": diff.abs().max().item(),
            "rel_rms_err": diff.norm().item() / max(ref.norm().item(), 1e-30)}
    errs["max_err_over_rms"] = errs["max_abs_err"] / max(rms, 1e-30)
    ok = errs["max_abs_err"] <= ATTN_ATOL[out.dtype] and bool(torch.isfinite(out).all())
    if out.dtype == torch.bfloat16:
        ok = (ok and errs["rel_rms_err"] <= ATTN_BF16_REL_RMS
              and errs["max_err_over_rms"] <= ATTN_BF16_MAX_OVER_RMS)
    return errs, ok


def unmasked_edge_control(attention_ops, q, k, v, edge: int) -> dict:
    """The real kernel with its ragged KV edge left unmasked, planted by
    padding q, k and v with zeros up to a multiple of ``edge``: the softmax
    then weighs the zero keys that TMA fills past N. ``attention_check``
    must reject it."""
    n = q.shape[1]
    padded = (F.pad(x, (0, 0, 0, 0, 0, -n % edge)) for x in (q, k, v))
    out = attention_ops.flash_attention(*padded)[:, :n]
    errs, ok = attention_check(out, attention_ops.attention_plain(q, k, v))
    return {"rows": -n % edge, **errs, "rejected": not ok}


def stage_bound(q) -> tuple:
    """Least time for the staging copy of (B, N, H, D) q, k, v: each value
    read once and written once."""
    return 2 * 3 * q.numel() * q.element_size() / HBM_BYTES_PER_S * 1e3, "bytes"


def stage_check(attention_ops, q, k, v) -> dict:
    """The staging copy on views off a 16-byte boundary: one launch,
    bit-equal to its plain version (torch.stack), views that TMA can read;
    its time by CUDA-graph replay beside torch.stack's and the bound."""
    before = attention_ops.launch_count[attention_ops.STAGE]
    staged = attention_ops.stage_qkv(q, k, v)
    torch.cuda.synchronize()
    launches = attention_ops.launch_count[attention_ops.STAGE] - before
    want = attention_ops.stage_plain(q, k, v)
    got = torch.stack(staged, dim=2)
    bound_ms, bound_by = stage_bound(q)
    out = dict(launches=launches, bit_equal=bool(torch.equal(got, want)),
               max_abs_err=(got.float() - want.float()).abs().max().item(),
               aligned=attention_ops._check(*staged),
               ms=graph_ms(lambda: attention_ops.stage_qkv(q, k, v)),
               plain_ms=time_ms(lambda: attention_ops.stage_plain(q, k, v), reps=5),
               library_ms=graph_ms(lambda: torch.stack((q, k, v), dim=2)),
               bound_ms=bound_ms, bound_by=bound_by)
    if not (launches == 1 and out["bit_equal"] and out["aligned"]):
        raise AssertionError(f"the staging copy is not one launch bit-equal to torch.stack "
                             f"into views TMA can read: {out}")
    return out


def phase_kernel(attention_ops):
    """Every case of ATTENTION_CASES: one launch, of the kernel
    ``attention_plan`` names (after one of the staging copy where the plan
    is staged, the copy held bit-equal to torch.stack by ``stage_check``),
    within ``attention_check``'s limits of the plain version, and where N
    leaves a ragged KV edge, that edge planted unmasked must fail them; then
    its time by CUDA-graph replay beside ``scaled_dot_product_attention``'s
    (kernel, library, library, kernel), the plain version's and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for B, N, H, D, dtype, aligned in ATTENTION_CASES:
        shape = (B, N, 3, H, D)
        flat = torch.randn(int(np.prod(shape)) + (not aligned), generator=gen, device="cuda")
        qkv = flat.to(dtype)[int(not aligned):].view(shape)
        q, k, v = qkv.unbind(2)
        if attention_ops._check(q, k, v) != aligned:
            raise AssertionError(f"case ({B}, {N}, {H}, {D}, {dtype}): not {'un' * (not aligned)}aligned")
        plan = attention_ops.attention_plan(B, N, H, D, dtype, aligned)
        if plan.staged != (dtype == torch.bfloat16 and not aligned):
            raise AssertionError(f"case ({B}, {N}, {H}, {D}, {dtype}, {aligned}): plan {plan}")
        before = dict(attention_ops.instance_count)
        stages_before = attention_ops.launch_count[attention_ops.STAGE]
        out = attention_ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in attention_ops.instance_count.items() if c != before[n]}
        stages = attention_ops.launch_count[attention_ops.STAGE] - stages_before
        errs, ok = attention_check(out, attention_ops.attention_plain(q, k, v))
        ok = ok and launched == {plan.instance: 1} and stages == int(plan.staged)
        edge = KV_EDGE.get(plan.kernel)
        control = (unmasked_edge_control(attention_ops, q, k, v, edge)
                   if edge and N % edge else None)
        ok = ok and (control is None or control["rejected"])
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if dtype == torch.float32 and not aligned:
            # SDPA faults (misaligned address) on fp32 views 4 bytes off a
            # 16-byte boundary: it is timed on aligned copies of the same values
            qt, kt, vt = qt.contiguous(), kt.contiguous(), vt.contiguous()
        calls = {"kernel": lambda: attention_ops.flash_attention(q, k, v),
                 "library": lambda: F.scaled_dot_product_attention(qt, kt, vt)}
        readings = {k: [] for k in calls}
        for which in ("kernel", "library", "library", "kernel"):
            readings[which].append(graph_ms(calls[which]))
        bound_ms, bound_by = attention_bound(B, N, H, D, dtype)
        ms = statistics.mean(readings["kernel"])
        row = dict(B=B, N=N, H=H, D=D, dtype=str(dtype).split(".")[-1], aligned=aligned,
                   kernel=plan.kernel, instance=plan.instance, split=plan.split, staged=plan.staged,
                   launched=launched, **errs,
                   atol=ATTN_ATOL[dtype], unmasked_edge_control=control, ms=ms, readings=readings,
                   plain_ms=time_ms(lambda: attention_ops.attention_plain(q, k, v), reps=5),
                   library_ms=statistics.mean(readings["library"]),
                   bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms)
        if plan.staged:
            row["stage"] = stage_check(attention_ops, q, k, v)
        log("attention " + json.dumps(row))
        if not ok:
            raise AssertionError(f"attention kernel disagrees with its plain version or its "
                                 f"plan, or its checks pass an unmasked KV edge: {row}")
        rows.append(row)
    return rows


# the online kernel's exact-width D = 80 tiles at ragged N (one KV tile of
# 137 rows; last tiles of 116 and 104 rows), at B = 1 and 16, in both
# work-item sizes whatever the plan picks (at N = 137 it picks the single pass)
ONLINE_D80_RAGGED = [(B, N) for B in (1, 16) for N in (137, 500, 1000)]


def online_d80_ragged(attention_ops) -> list:
    """Each case of ONLINE_D80_RAGGED through ``uva_flash_attention_online``
    in both item sizes, into a NaN-filled output, within
    ``attention_check``'s limits of the plain version (a wrong 32-byte-swizzle
    descriptor or barrier count would give finite, wrong numbers). Direct
    calls: no launch is counted."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    lib = attention_ops._lib()
    rows = []
    for B, N in ONLINE_D80_RAGGED:
        q, k, v = torch.randn(B, N, 3, 16, 80, generator=gen, device="cuda").to(torch.bfloat16).unbind(2)
        want = attention_ops.attention_plain(q, k, v)
        for split in (True, False):
            out = torch.full((B, N, 16, 80), float("nan"), dtype=torch.bfloat16, device="cuda")
            rc = lib.uva_flash_attention_online(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, 16, 80,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(split),
                torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            errs, ok = attention_check(out, want)
            row = dict(B=B, N=N, split=split, rc=rc, **errs, ok=ok and rc == 0)
            log("online D = 80 ragged " + json.dumps(row))
            if not row["ok"]:
                raise AssertionError(f"the online kernel's D = 80 tiles disagree at a ragged N: {row}")
            rows.append(row)
    return rows


# the head-width control's shapes (B, N, dtype): D = 80 views of (B, N, 3, 16,
# 128) buffers whose columns 80-127 hold NaN, through the instance the plan
# names (the single pass, the online kernel in both item sizes, fp32)
HEAD_WIDTH_CASES = [(1, 144, torch.bfloat16), (128, 144, torch.bfloat16),
                    (1, 500, torch.bfloat16), (1, 1024, torch.bfloat16),
                    (16, 1024, torch.bfloat16), (8, 144, torch.float32)]


def reads_128_columns(attention_ops, buf):
    """The planted fault of the head-width control: a kernel that reads all
    128 columns of each row from memory (the D = 128 instance on the whole
    rows, q scaled by sqrt(128 / 80) so that with zeros past column 79 it
    computes the D = 80 function), cut back to 80 columns."""
    q, k, v = buf.unbind(2)
    return attention_ops.flash_attention(q * (128 / 80) ** 0.5, k, v)[..., :80]


def head_width_control(attention_ops) -> list:
    """D = 80 views whose next 48 columns in memory hold NaN: the kernel the
    plan names must launch, and its output be finite and within
    ``attention_check``'s limits of the plain version (the single pass takes
    columns 80-127 of its 128-column tiles from TMA's zero fill, the online
    kernel's boxes end at column 79); the planted kernel reading 128 columns
    must fail those limits, and pass them where the neighbouring columns
    hold zeros."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    rows = []
    for B, N, dtype in HEAD_WIDTH_CASES:
        buf = torch.randn(B, N, 3, 16, 128, generator=gen, device="cuda").to(dtype)
        buf[..., 80:] = float("nan")
        q, k, v = buf[..., :80].unbind(2)
        plan = attention_ops.attention_plan(B, N, 16, 80, dtype, attention_ops._check(q, k, v))
        before = dict(attention_ops.instance_count)
        out = attention_ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in attention_ops.instance_count.items() if c != before[n]}
        want = attention_ops.attention_plain(q, k, v)
        errs, ok = attention_check(out, want)
        _, faulty_ok = attention_check(reads_128_columns(attention_ops, buf), want)
        zeros = buf.clone()
        zeros[..., 80:] = 0
        _, faulty_on_zeros_ok = attention_check(reads_128_columns(attention_ops, zeros), want)
        row = dict(B=B, N=N, dtype=str(dtype).split(".")[-1], instance=plan.instance, launched=launched,
                   finite=bool(torch.isfinite(out).all()), **errs, ok=ok,
                   faulty_rejected=not faulty_ok, faulty_passes_on_zeros=faulty_on_zeros_ok)
        log("head-width control " + json.dumps(row))
        if not (ok and launched == {plan.instance: 1} and plan.head_dim == 80):
            raise AssertionError(f"a D = 80 kernel reads past column 79, or disagrees: {row}")
        if not (row["faulty_rejected"] and faulty_on_zeros_ok):
            raise AssertionError(f"the head-width control cannot tell a kernel reading 128 columns: {row}")
        rows.append(row)
    return rows


def control_faults(attention_ops) -> dict:
    """Attention kernels with a planted fault, built on the real kernel."""
    def scaled(factor):
        return lambda q, k, v: attention_ops.flash_attention(q * factor, k, v)

    def unmasked_edge(q, k, v):
        # the ragged KV tile left unmasked: keys and values past N read as zeros
        n = q.shape[1]
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, -n % KV_TILE)) for x in (q, k, v))
        return attention_ops.flash_attention(q, k, v)[:, :n]

    return {
        "exp_base_2": scaled(np.log(2.0)),  # exp2 without the log2(e) factor
        "unmasked_kv_edge": unmasked_edge,
        "scale_x1.1": scaled(1.1),
        "scale_x1.02": scaled(1.02),
        "scale_x1.005": scaled(1.005),
    }


def attention_plan_of(attention_ops, cfg, B: int, dtype):
    """The plan of every ViT block of a request at batch B: its (B, tokens,
    heads, head dimension), the text buffer's tokens included (the qkv
    views are 16-byte aligned)."""
    return attention_ops.attention_plan(B, cfg.attention_tokens, cfg.encoder_num_heads,
                                        cfg.encoder_embed_dim // cfg.encoder_num_heads, dtype)


def attention_launches_per_request(attention_ops, cfg, B: int, dtype) -> dict:
    """Launches of each attention kernel in one request at batch B, from the
    config: one per ViT block, of the kernel attention_plan names."""
    plan = attention_plan_of(attention_ops, cfg, B, dtype)
    return {n: (cfg.encoder_depth + cfg.decoder_depth) * (n == plan.kernel or (n == attention_ops.STAGE
                                                                                and plan.staged))
            for n in attention_ops.launch_count}


def attention_instances_per_request(attention_ops, cfg, B: int, dtype) -> dict:
    """As attention_launches_per_request, by instance (kernel and head dimension)."""
    plan = attention_plan_of(attention_ops, cfg, B, dtype)
    return {n: (cfg.encoder_depth + cfg.decoder_depth) * (n == plan.instance)
            for n in attention_ops.INSTANCES}


def normalized(policy, actions: torch.Tensor) -> torch.Tensor:
    return policy.normalizer["action"].normalize(actions.float())


def check_actions(policy, actions: torch.Tensor, batch: int) -> None:
    if tuple(actions.shape) != (batch, 16, policy.action_dim):
        raise AssertionError(f"action chunk shape {tuple(actions.shape)} != "
                             f"{(batch, 16, policy.action_dim)}")
    if not bool(torch.isfinite(actions).all()):
        raise AssertionError("non-finite actions")
    # x0 is clipped to [-1, 1] and the last step adds no noise, so the
    # normalized chunk lies in [-1, 1]
    span = normalized(policy, actions).abs().max().item()
    if span > 1.0 + 1e-2:
        raise AssertionError(f"normalized actions reach {span}, outside [-1, 1]")


def breakdown(policy, frames: torch.Tensor, noise, reps: int = STAGE_REPS,
              profiled: bool = True) -> dict:
    """One request's stages by CUDA events (median ms of ``reps``; the gaps
    the host leaves between launches count in the stage they fall in), and
    (``profiled``) the device's busy share of one request by
    ``torch.profiler``, with the kernels that took most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = frames.cuda()
    stages = ("vae_encode_ms", "mar_encoder_decoder_ms", "action_sampler_ms")
    times = {k: [] for k in stages}

    def request(events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        cond = policy._encode_frames(policy._prep_frames(frames), noise["vae"])
        mark(1)
        z = policy.mar.policy_latents(cond)
        mark(2)
        policy.mar.diffactloss.sample(z, noise["init"], noise["steps"],
                                      temperature=policy.temperature)
        mark(3)

    with torch.no_grad():
        for _ in range(reps):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            request(events)
            events[3].synchronize()
            for i, k in enumerate(stages):
                times[k].append(events[i].elapsed_time(events[i + 1]))
        out = {k: statistics.median(v) for k, v in times.items()}
        if not profiled:
            return out
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            request()
            end.record()
            end.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    wall_ms = start.elapsed_time(end)
    if busy_ms > 0:
        out["profiled_wall_ms"] = wall_ms
        out["device_busy_ms"] = busy_ms
        out["device_idle_share"] = max(0.0, 1.0 - busy_ms / wall_ms)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out["top_device_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 for e in top}
        out.update(kernel_device_ms(kernels))
    else:
        out["device_idle_share"] = "not measured (the profiler saw no device time)"
    return out


# the port's kernels by a part of their symbol names, for the profiler's sums
PORT_KERNELS = {"attention": "attn_", "quantize_rows": "quantize_rows", "int8_gemm": "int8_gemm"}


def kernel_device_ms(kernels) -> dict:
    """Device ms and launches of each of the port's kernels in a profile."""
    out = {}
    for name, part in PORT_KERNELS.items():
        events = [e for e in kernels if part in e.key]
        out[f"{name}_device_ms"] = sum(e.self_device_time_total for e in events) / 1e3
        out[f"{name}_launches"] = sum(e.count for e in events)
    return out


def flagship_config():
    """The flagship's config (``latest/meta.json``) on the meta device: its
    MarConfig, the weights' flax layout and the normalizer."""
    from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    meta = UnifiedVideoActionPolicy.from_run_config(os.path.join(LATEST, "meta.json"), device="meta")
    return meta, LinearNormalizer.load(os.path.join(LATEST, "normalizer.npz"))


def serving_weights(meta_policy):
    """The MAR and denoiser weights as numpy draws from SEED in the flax
    layout (the int8 model reads the same tree), and the committed VAE."""
    from unified_video_action_tpu_torch import convert

    if not os.path.isfile(VAE_NPZ):
        raise FileNotFoundError(f"the committed VAE weights are missing: {VAE_NPZ}")
    return convert.seeded_tree(meta_policy.mar, SEED), convert.load_flat_npz(VAE_NPZ)


@contextlib.contextmanager
def checked_attention(attention_ops, policy, impl):
    """Within the block, every attention call of ``policy``'s MAR runs
    through ``impl`` and is held against the plain version on that call's
    own inputs; yields the worst errors over the calls (``attention_check``'s)
    and whether every call was finite and within SERVE_CALL_REL_RMS and
    ATTN_BF16_MAX_OVER_RMS."""
    from unified_video_action_tpu_torch.models import transformer

    calls = {"calls": 0, "calls_ok": True, "calls_rel_rms_err": 0.0,
             "calls_max_err_over_rms": 0.0, "calls_max_abs_err": 0.0}

    def checked(q, k, v):
        out = impl(q, k, v)
        errs, _ = attention_check(out, attention_ops.attention_plain(q, k, v))
        ok = (bool(torch.isfinite(out).all()) and errs["rel_rms_err"] <= SERVE_CALL_REL_RMS
              and errs["max_err_over_rms"] <= ATTN_BF16_MAX_OVER_RMS)
        calls["calls"] += 1
        calls["calls_ok"] = calls["calls_ok"] and ok
        for key in ("rel_rms_err", "max_err_over_rms", "max_abs_err"):
            calls[f"calls_{key}"] = max(calls[f"calls_{key}"], errs[key])
        return out

    transformer.ATTN_IMPLS["checked"] = checked
    policy.set_attn_impl("checked")
    try:
        yield calls
    finally:
        policy.set_attn_impl("kernel")
        transformer.ATTN_IMPLS.pop("checked", None)


def route_readings(attention_ops, policy, policy32, frames: dict, noise: dict,
                   text: dict = None, streams: dict = None) -> dict:
    """The kernel route of the bf16 ``policy`` and each planted fault of
    ``control_faults``, against its plain-attention route at each batch of
    ``frames`` (with ``text``, the encoded goal of each batch) under the
    same weights and noise: {route: {B: readings}}. A route's readings: the
    decoder output z, its mean |z - z_fp32| against ``policy32``'s (fp32,
    plain attention) beside the plain route's; the normalized actions'
    differences; and every attention call of the request held against the
    plain version on that call's own inputs (the worst errors of
    ``attention_check``, and whether every call was finite and within
    SERVE_CALL_REL_RMS and ATTN_BF16_MAX_OVER_RMS). ``streams``: each
    batch's ``history_actions`` and ``proprio`` as ``predict_action_frames``
    takes them (the UMI and toolhang models)."""
    text = text or {B: None for B in frames}
    streams = streams or {B: {} for B in frames}
    refs = {}
    with torch.no_grad():
        policy.set_attn_impl("plain")
        policy32.set_attn_impl("plain")
        for B in frames:
            cond = policy._encode_frames(policy._prep_frames(frames[B].cuda()), noise[B]["vae"])
            proprio, history = policy._prep_modalities(streams[B].get("proprio"),
                                                       streams[B].get("history_actions"), noise[B])
            mods = {"history_actions": history, "proprio": proprio}
            refs[B] = {
                "cond": cond, "mods": mods, "z_ref": policy32.mar.policy_latents(cond, text[B], **mods),
                "z_plain": policy.mar.policy_latents(cond, text[B], **mods).float(),
                "actions": normalized(policy, policy.predict_action_frames(
                    frames[B], noise=noise[B], text_latents=text[B], **streams[B])),
            }
        policy32.set_attn_impl("kernel")

    def against_plain(impl, B: int) -> dict:
        """The route through ``impl``, against the plain route, at batch B."""
        r = refs[B]
        with checked_attention(attention_ops, policy, impl) as calls:
            with torch.no_grad():
                z = policy.mar.policy_latents(r["cond"], text[B], **r["mods"]).float()
            actions = policy.predict_action_frames(frames[B], noise=noise[B], text_latents=text[B],
                                                   **streams[B])
        da = (normalized(policy, actions) - r["actions"]).abs().flatten()
        return {
            "z_err_kernel": (z - r["z_ref"]).abs().mean().item(),
            "z_err_plain": (r["z_plain"] - r["z_ref"]).abs().mean().item(),
            "z_kernel_vs_plain_max": (z - r["z_plain"]).abs().max().item(),
            "z_max": r["z_ref"].abs().max().item(),
            "action_mean": da.mean().item(),
            "action_p99": torch.quantile(da, 0.99).item(),
            "action_max": da.max().item(),
            **calls,
        }

    routes = {"kernel": attention_ops.flash_attention, **control_faults(attention_ops)}
    return {name: {B: against_plain(impl, B) for B in frames} for name, impl in routes.items()}


def serve_limit_failures(d: dict) -> list:
    """The serve limits that a route's readings at one batch fail: the
    decoder output's distance from fp32 within SERVE_Z_FLOOR_RATIO of the
    plain route's, the actions within SERVE_ACTION_MEAN_ATOL and
    SERVE_ACTION_P99_ATOL, and every attention call of the request within
    SERVE_CALL_REL_RMS and ATTN_BF16_MAX_OVER_RMS of the plain version on its
    own inputs."""
    failed = []
    if d["z_err_kernel"] > SERVE_Z_FLOOR_RATIO * d["z_err_plain"]:
        failed.append("z_floor_ratio")
    if d["action_mean"] > SERVE_ACTION_MEAN_ATOL:
        failed.append("action_mean")
    if d["action_p99"] > SERVE_ACTION_P99_ATOL:
        failed.append("action_p99")
    if not d["calls_ok"]:
        failed.append("calls")
    return failed


def route_check(attention_ops, policy, policy32, frames: dict, noise: dict, rejected,
                text: dict = None, streams: dict = None) -> dict:
    """``route_readings``, held to the serve limits (``serve_limit_failures``):
    the kernel route must pass them at every batch, and each control named
    in ``rejected`` must fail one at some batch, else the limits could not
    tell a wrong kernel. Raises on a failure; returns the kernel route's
    readings by batch."""
    readings = route_readings(attention_ops, policy, policy32, frames, noise, text, streams)
    diffs = readings.pop("kernel")
    log(f"kernel vs plain attention, bf16: {json.dumps(diffs)}; limits: z_err_kernel <= "
        f"{SERVE_Z_FLOOR_RATIO} z_err_plain, action_mean {SERVE_ACTION_MEAN_ATOL}, "
        f"action_p99 {SERVE_ACTION_P99_ATOL}, every attention call: rel_rms_err {SERVE_CALL_REL_RMS}, "
        f"max_err_over_rms {ATTN_BF16_MAX_OVER_RMS}")
    for B, d in diffs.items():
        if serve_limit_failures(d):
            raise AssertionError(f"B={B}: kernel route disagrees with the plain route "
                                 f"({serve_limit_failures(d)}): {d}")
    for name, by_batch in readings.items():
        by_batch["failed_limits"] = sorted({f for d in by_batch.values() for f in serve_limit_failures(d)})
    log(f"controls, faulty kernels against the plain route: {json.dumps(readings)}")
    passed = [name for name in rejected if not readings[name]["failed_limits"]]
    if passed:
        raise AssertionError(f"faulty kernels pass the serve limits: {passed}")
    return diffs


# the fp32 request's batch: the serving batch of the throughput metric
FP32_REQUEST_BATCH = 128


def fp32_request(policy32, reps: int = REPS_LARGE) -> dict:
    """One fp32 ``predict_action_frames`` request of ``policy32`` (a mar_base
    policy with compute_dtype="float32") at FP32_REQUEST_BATCH, 100 steps,
    on seeded frames and noise: the attention launches of one request by
    instance (``attention_instances``), the median device time of ``reps``
    requests by CUDA events after a warm-up, and its stages by CUDA events
    (``breakdown``, not profiled)."""
    from unified_video_action_tpu_torch.ops import attention as attention_ops

    B = FP32_REQUEST_BATCH
    rng = np.random.default_rng(SEED + 13)
    frames = torch.from_numpy(rng.integers(0, 256, (B, 4, 3, 96, 96), dtype=np.uint8))
    noise = policy32.sample_noise(B, torch.Generator(device="cuda").manual_seed(SEED + 13))
    policy32.predict_action_frames(frames, noise=noise)  # warm-up
    torch.cuda.synchronize()
    before = dict(attention_ops.instance_count)
    policy32.predict_action_frames(frames, noise=noise)
    launches = {k: v - before[k] for k, v in attention_ops.instance_count.items() if v != before[k]}
    ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        policy32.predict_action_frames(frames, noise=noise)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return {"B": B, "median_ms": statistics.median(ms), "ms": ms, "attention_instances": launches,
            **breakdown(policy32, frames, noise, profiled=False)}


def phase_serve(attention_ops, trees, normalizer):
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    meta = os.path.join(LATEST, "meta.json")
    mar_tree, vae_tree = trees

    def make_policy(device: str, dtype: str):
        p = UnifiedVideoActionPolicy.from_run_config(meta, device=device, compute_dtype=dtype)
        p.set_normalizer(normalizer)
        return p

    policy = make_policy("cuda", "bfloat16")
    c = policy.mar_cfg
    log(f"policy: mar {c.encoder_depth}+{c.decoder_depth} blocks, d={c.encoder_embed_dim}, "
        f"{c.encoder_num_heads} heads, {c.img_size}px, {c.total_tokens} tokens, "
        f"{policy.mar.diffactloss.num_steps} sampler steps, {policy.dtype}")
    policy.load_params(mar_tree, vae_tree)
    n_mar = sum(p.numel() for p in policy.mar.parameters())
    n_vae = sum(p.numel() for p in policy.vae.parameters())
    log(f"weights: MAR+denoiser {n_mar / 1e6:.1f}M numpy-seeded (seed {SEED}) in flax layout "
        f"through convert.py (the orbax flagship needs JAX to be read); "
        f"VAE (encoder and decoder) {n_vae / 1e6:.1f}M from pretrained_models/vae/pusht_vae96.npz; normalizer from latest/normalizer.npz")

    rng = np.random.default_rng(SEED)
    frames = {B: torch.from_numpy(rng.integers(0, 256, (B, 4, 3, 96, 96), dtype=np.uint8))
              for B in (1, 128)}
    noise = {B: policy.sample_noise(B, torch.Generator(device="cuda").manual_seed(SEED + B))
             for B in (1, 128)}

    # warm-up (cuBLAS/cuDNN handles, kernel library load): not counted
    for B in (1, 128):
        policy.predict_action_frames(frames[B], noise=noise[B])
    torch.cuda.synchronize()

    # the main path: one request at B=1 and one at B=128, counted, through
    # the obs-dict entry point on a 16-frame window whose selected frames
    # (3, 7, 11, 15) are frames[B]
    windows = {}
    for B in (1, 128):
        windows[B] = np.zeros((B, 16, 3, 96, 96), dtype=np.uint8)
        windows[B][:, 3::4] = frames[B].numpy()
    for counter in (attention_ops.launch_count, attention_ops.instance_count):
        for name in counter:
            counter[name] = 0
    actions = {}
    per_call = {}
    for B in (1, 128):
        before = dict(attention_ops.launch_count)
        res = policy.predict_action({"image": windows[B]}, noise=noise[B])
        per_call[B] = {n: attention_ops.launch_count[n] - before[n] for n in before}
        if res["action"].shape != (B, policy.n_action_steps, 2):
            raise AssertionError(f"action shape {res['action'].shape}")
        actions[B] = torch.from_numpy(res["action_pred"]).cuda()
    launches = {**attention_ops.launch_count, **attention_ops.instance_count}
    blocks = c.encoder_depth + c.decoder_depth
    wants = {B: attention_launches_per_request(attention_ops, c, B, torch.bfloat16) for B in (1, 128)}
    log(f"attention launches: {per_call} per call, {launches} in all; want {wants} "
        f"({blocks} blocks per call, the kernel by attention_plan)")
    for B in (1, 128):
        check_actions(policy, actions[B], B)
        if per_call[B] != wants[B]:
            raise AssertionError(f"B={B}: attention launches {per_call[B]}, want {wants[B]}")
    if launches["attention_wgmma"] == 0 or launches["attention_wgmma_d64"] != launches["attention_wgmma"]:
        raise AssertionError(f"the single-pass launches are not all of its D = 64 instance: {launches}")

    # fp32 on the card, matmuls and convolutions without TF32: the reference
    # for the bf16 routes here, and held against the CPU below
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy32 = make_policy("cuda", "float32")
    policy32.load_params(mar_tree, vae_tree)
    diffs = route_check(attention_ops, policy, policy32, frames, noise, REJECTED_CONTROLS)

    # one fp32 request at B=128: the fp32 kernel's D = 64 instance once per
    # ViT block, its time and where it goes
    fp32 = fp32_request(policy32)
    log("fp32 request " + json.dumps(fp32))
    if fp32["attention_instances"] != {"attention_f32_d64": blocks}:
        raise AssertionError(f"the fp32 request launched {fp32['attention_instances']}, want "
                             f"{blocks} of attention_f32_d64")

    # timing: CUDA events around whole requests, after the warm-up
    def request_ms(B: int, reps: int):
        dev, host = [], []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            policy.predict_action_frames(frames[B], noise=noise[B])
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(start.elapsed_time(end))
        return statistics.median(dev), statistics.median(host)

    torch.cuda.reset_peak_memory_stats()
    p50_b1, host_b1 = request_ms(1, REPS_B1)
    ms_b128, host_b128 = request_ms(128, REPS_LARGE)
    serve = {
        "p50_latency_ms_b1": p50_b1, "p50_host_ms_b1": host_b1,
        "chunks_per_s_b128": 128 / (ms_b128 / 1e3), "median_ms_b128": ms_b128,
        "median_host_ms_b128": host_b128,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "attention_launches_per_call": blocks, "sampler_steps": policy.mar.diffactloss.num_steps,
        "dtype": "bfloat16", "kernel_vs_plain": diffs,
    }
    log("serve " + json.dumps(serve))
    for B in (1, 128):
        log(f"where the time goes, B={B}: " + json.dumps(breakdown(policy, frames[B], noise[B],
                                                                  profiled=B > 1)))

    # the card in fp32 (kernel route) against the port on the CPU in fp32
    cpu32 = make_policy("cpu", "float32")
    cpu32.load_params(mar_tree, vae_tree)
    cpu_noise = {k: v.cpu() for k, v in noise[1].items()}
    before = attention_ops.instance_count["attention_f32_d64"]
    on_card = policy32.predict_action_frames(frames[1], noise=cpu_noise).cpu()
    f32_launches = attention_ops.instance_count["attention_f32_d64"] - before
    on_cpu = cpu32.predict_action_frames(frames[1], noise=cpu_noise)
    d = (normalized(policy, on_card) - normalized(policy, on_cpu)).abs().max().item()
    log(f"card fp32 ({f32_launches} launches of attention_f32_d64) vs CPU fp32, B=1, normalized "
        f"actions: max abs {d}; atol {SERVE_FP32_ATOL}")
    if d > SERVE_FP32_ATOL or f32_launches != blocks:
        raise AssertionError(f"the card's fp32 run disagrees with the CPU's ({d}) or did not "
                             f"launch the fp32 kernel once per block ({f32_launches})")
    fp32_paths = {"serve_fp32_b128": fp32["attention_instances"],
                  "serve_fp32_vs_cpu_b1": {"attention_f32_d64": f32_launches}}
    return launches, fp32_paths, fp32


# ------------------------------------------------------- 256 px PushT path

# the 256 px phase's batches: B=1 (a controller) and B=128 (the JAX parity
# tier's, bench.py); the kernel route is held against the plain route at B=8
# (the plain version's (B, 12, 1024, 1024) fp32 scores stay small there)
BATCHES_256 = (1, 128)
ROUTE_BATCH_256 = 8
# 1024 is a multiple of every KV tile, so the unmasked_kv_edge control would
# plant no fault on this path; the kernel phase holds the online kernel's
# ragged edge (N = 145, 257, 1000 and 1088, where the edge left unmasked must
# fail its checks) in both work-item sizes
REJECTED_CONTROLS_256 = ("exp_base_2", "scale_x1.1")


def phase_serve_256px(attention_ops, normalizer, name: str, run_cfg: dict) -> dict:
    """A 256 px PushT model (``run_cfg``: config.PUSHT_256, the reference's
    own model as the JAX package's parity tier serves it, mar_base; or
    config.PUSHT_HUGE256, mar_huge): 96 px frames upscaled to 256 on the
    card, 1024 tokens, the KL-16 VAE with ch 128, 100 sampler steps, bf16,
    VAE encodes of 64 frames, with numpy-seeded MAR, denoiser and VAE
    weights: the obs-dict predict_action at B=1 and B=128 (counted: the
    online-softmax kernel's instance at the D the config implies once per
    ViT block, no other attention kernel), the kernel route against the
    plain route at B=8 with the serve limits and controls, then request
    times (median of REPS_LARGE) and the stage breakdown at both batches.
    Returns the launches of the counted calls."""
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    def make_policy(dtype: str):
        p = UnifiedVideoActionPolicy.from_cfg(run_cfg, device="cuda", compute_dtype=dtype)
        p.set_normalizer(normalizer)
        return p

    policy = make_policy("bfloat16")
    c = policy.mar_cfg
    D = c.encoder_embed_dim // c.encoder_num_heads
    trees = (convert.seeded_tree(policy.mar, SEED),
             convert.seeded_tree(policy.vae, SEED + 1))
    policy.load_params(*trees)
    log(f"{name} policy: mar {c.encoder_depth}+{c.decoder_depth} blocks, d={c.encoder_embed_dim}, "
        f"{c.encoder_num_heads} heads of D={D}, {c.img_size}px, {c.total_tokens} tokens, VAE ch "
        f"{policy.vae.encoder.conv_in.out_channels}, {policy.mar.diffactloss.num_steps} sampler "
        f"steps, {policy.dtype}, vae_encode_chunk {policy.vae_encode_chunk}; MAR+denoiser "
        f"{sum(p.numel() for p in policy.mar.parameters()) / 1e6:.1f}M and VAE (encoder and decoder) "
        f"{sum(p.numel() for p in policy.vae.parameters()) / 1e6:.1f}M numpy-seeded (seeds "
        f"{SEED}, {SEED + 1})")

    rng = np.random.default_rng(SEED + 30)
    batches = BATCHES_256 + (ROUTE_BATCH_256,)
    frames = {B: torch.from_numpy(rng.integers(0, 256, (B, 4, 3, 96, 96), dtype=np.uint8))
              for B in batches}
    noise = {B: policy.sample_noise(B, torch.Generator(device="cuda").manual_seed(SEED + 30 + B))
             for B in batches}
    for B in BATCHES_256:  # warm-up: not counted
        policy.predict_action_frames(frames[B], noise=noise[B])
    torch.cuda.synchronize()

    # the path: one obs-dict request at B=1 and one at B=128, counted
    for counter in (attention_ops.launch_count, attention_ops.instance_count):
        for k in counter:
            counter[k] = 0
    per_call = {}
    for B in BATCHES_256:
        window = np.zeros((B, 16, 3, 96, 96), dtype=np.uint8)
        window[:, 3::4] = frames[B].numpy()
        before = dict(attention_ops.launch_count)
        res = policy.predict_action({"image": window}, noise=noise[B])
        per_call[B] = {n: attention_ops.launch_count[n] - before[n] for n in before}
        if res["action"].shape != (B, policy.n_action_steps, 2):
            raise AssertionError(f"action shape {res['action'].shape}")
        check_actions(policy, torch.from_numpy(res["action_pred"]), B)
    launches = {**attention_ops.launch_count, **attention_ops.instance_count}
    wants = {B: attention_launches_per_request(attention_ops, c, B, torch.bfloat16) for B in BATCHES_256}
    log(f"{name} attention launches: {per_call} per call, {launches} in all; want {wants}")
    for B in BATCHES_256:
        if per_call[B] != wants[B] or per_call[B]["attention_wgmma_online"] != c.encoder_depth + c.decoder_depth:
            raise AssertionError(f"{name} B={B}: attention launches {per_call[B]}, want {wants[B]}")
    if launches[f"attention_wgmma_online_d{D}"] != launches["attention_wgmma_online"]:
        raise AssertionError(f"{name}: the online launches are not all of its D = {D} instance: {launches}")

    policy32 = make_policy("float32")
    policy32.load_params(*trees)
    route = ROUTE_BATCH_256
    diffs = route_check(attention_ops, policy, policy32, {route: frames[route]}, {route: noise[route]},
                        REJECTED_CONTROLS_256)
    del policy32

    def request_ms(B: int, reps: int = REPS_LARGE):
        dev, host = [], []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            policy.predict_action_frames(frames[B], noise=noise[B])
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(start.elapsed_time(end))
        return statistics.median(dev), statistics.median(host)

    torch.cuda.reset_peak_memory_stats()
    (ms_b1, host_b1), (ms_b128, host_b128) = request_ms(1), request_ms(128)
    serve = {"median_ms_b1": ms_b1, "median_host_ms_b1": host_b1, "median_ms_b128": ms_b128,
             "median_host_ms_b128": host_b128, "chunks_per_s_b128": 128 / (ms_b128 / 1e3),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "kernel_vs_plain": diffs,
             "card": card_line()}
    log(f"{name} " + json.dumps(serve))
    for B in BATCHES_256:
        log(f"{name}, where the time goes, B={B}: " + json.dumps(breakdown(
            policy, frames[B], noise[B], profiled=False)))
    return launches


# ------------------------------------------------- mar_small: head dim 128

# mar_small (6+6 blocks, d = 768 over 6 heads of 128) in its two single-chip
# configurations: the 96 px PushT model (144 tokens, the single-pass kernel)
# and the language-conditioned 128 px kitchen model (256 frame tokens and the
# 64-token text buffer: 320, the online kernel with a 64-row last KV tile)
SMALL_BATCHES = (1, 128)
KITCHEN_GOAL = "open the microwave"
# the kitchen path's N = 320 is a multiple of the unmasked_kv_edge control's
# 64-row tile, so that control plants no fault there; the kernel phase holds
# the online kernel's ragged 128-row edge at N = 320 (64 rows)
REJECTED_CONTROLS_KITCHEN = ("exp_base_2", "scale_x1.1")


def phase_serve_small(attention_ops, int8_ops, name: str, run_cfg: dict, normalizer,
                      goal: str = None, rejected=REJECTED_CONTROLS) -> dict:
    """One configuration at full width and depth (``run_cfg``:
    config.PUSHT_SMALL96 or config.KITCHEN_SMALL128, mar_small at D = 128;
    config.PUSHT_HUGE96, mar_huge at D = 80), numpy-seeded MAR and denoiser
    weights through the bridge and the committed VAE of the config, bf16,
    100 sampler steps. The path, counted: the obs-dict predict_action at B=1
    and B=128 (with ``goal``, and one more call at B=1 without a goal), then
    the deployed tier (ddim10 + int8 + yuv420) predict_action_cached, a full
    and a cached call at both batches. Each call launches the instance that
    attention_plan names at the D the config implies once per ViT block and
    no other attention kernel, and the int8 kernels as the config implies.
    Then the deployed kernel route against the plain-int8 route (bit-equal),
    the kernel route against the plain route under the same noise with the
    serve limits and the controls, the card in fp32 (the fp32 kernel at the
    config's D) against the port on the CPU, and request times. Returns the
    launches of the counted calls by kernel instance, and those of the fp32
    kernel in the fp32 call by path."""
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    amp = dict(run_cfg["model"]["policy"]["autoregressive_model_params"],
               act_diff_testing_steps="ddim10")

    def make_policy(device="cuda", dtype="bfloat16", **overrides):
        p = UnifiedVideoActionPolicy.from_cfg(run_cfg, device=device, compute_dtype=dtype, **overrides)
        if normalizer is not None:
            p.set_normalizer(normalizer)
        return p

    policy = make_policy()
    deployed = make_policy(autoregressive_model_params=amp, serving_quant="int8", obs_codec="yuv420")
    c = policy.mar_cfg
    D = c.encoder_embed_dim // c.encoder_num_heads
    vae_npz = os.path.join(REPO, policy.vae_path)
    if not os.path.isfile(vae_npz):
        raise FileNotFoundError(f"the committed VAE weights are missing: {vae_npz}")
    trees = convert.seeded_tree(policy.mar, SEED), convert.load_flat_npz(vae_npz)
    for p in (policy, deployed):
        p.load_params(*trees)
    log(f"{name} policy: mar {c.encoder_depth}+{c.decoder_depth} blocks, d={c.encoder_embed_dim}, "
        f"{c.encoder_num_heads} heads of D={D}, {c.img_size}px, {c.total_tokens} frame tokens, "
        f"{c.attention_tokens} attended, {policy.mar.diffactloss.num_steps} sampler steps, "
        f"{policy.dtype}, action dim {policy.action_dim}; text encoder "
        f"{type(policy.text_encoder).__name__ if policy.text_encoder else None} (max_length "
        f"{policy.max_length}); MAR+denoiser {sum(p.numel() for p in policy.mar.parameters()) / 1e6:.1f}M "
        f"numpy-seeded (seed {SEED}), VAE (encoder and decoder) {sum(p.numel() for p in policy.vae.parameters()) / 1e6:.1f}M "
        f"from {policy.vae_path}")
    if D not in attention_ops.HEAD_DIMS:
        raise AssertionError(f"{name}: head dimension {D} has no kernel instance")

    camera = "agentview_rgb" if goal else "image"
    rng = np.random.default_rng(SEED + 40)
    img = c.img_size
    windows = {B: [{camera: rng.integers(0, 256, (B, 16, 3, img, img), dtype=np.uint8)}
                   for _ in range(2)] for B in SMALL_BATCHES}
    noise, cached_noise = {}, {}
    for B in SMALL_BATCHES:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 40 + B)
        noise[B] = policy.sample_noise(B, gen)
        cached_noise[B] = (deployed.sample_noise(B, gen, n_new=4), deployed.sample_noise(B, gen, n_new=2))

    def serve_cached(B):
        full, cache = deployed.predict_action_cached(windows[B][0], noise=cached_noise[B][0],
                                                     language_goal=goal)
        cached, _ = deployed.predict_action_cached(windows[B][1], cache=cache, n_shift=8,
                                                   noise=cached_noise[B][1], language_goal=goal)
        return full, cached

    for B in SMALL_BATCHES:  # warm-up: not counted
        policy.predict_action(windows[B][0], noise=noise[B], language_goal=goal)
        serve_cached(B)
    torch.cuda.synchronize()

    # the path: every count set to 0 just before, read just after
    counters = (attention_ops.launch_count, attention_ops.instance_count, int8_ops.launch_count)
    for counter in counters:
        for k in counter:
            counter[k] = 0

    def counts() -> dict:
        return {k: v for counter in counters for k, v in counter.items()}

    calls = [(B, goal) for B in SMALL_BATCHES] + ([(1, None)] if goal else [])
    per_call, results = {}, {}
    for B, g in calls:
        before = counts()
        res = policy.predict_action(windows[B][0], noise=noise[B], language_goal=g)
        per_call[f"predict_action B={B} goal={g is not None}"] = (
            B, False, {k: v - before[k] for k, v in counts().items()})
        if res["action"].shape != (B, policy.n_action_steps, policy.action_dim):
            raise AssertionError(f"{name}: action shape {res['action'].shape}")
        check_actions(policy, torch.from_numpy(res["action_pred"]), B)
        results[(B, g)] = res["action_pred"]
    for B in SMALL_BATCHES:
        before = counts()
        cached = serve_cached(B)
        per_call[f"predict_action_cached B={B}"] = (
            B, True, {k: (v - before[k]) / 2 for k, v in counts().items()})
        for res in cached:
            check_actions(deployed, torch.from_numpy(res["action_pred"]), B)
        results[("cached", B)] = cached
    torch.cuda.synchronize()
    launches = counts()
    blocks = c.encoder_depth + c.decoder_depth
    for call, (B, int8_route, got) in per_call.items():
        plan = attention_plan_of(attention_ops, c, B, torch.bfloat16)
        want = {**attention_launches_per_request(attention_ops, c, B, torch.bfloat16),
                **attention_instances_per_request(attention_ops, c, B, torch.bfloat16),
                **{k: 0 for k in int8_ops.launch_count}}
        if int8_route:
            want.update(int8_kernels_per_request(deployed, int8_ops, B))
        log(f"{name} {call}: plan {plan}, launches {json.dumps({k: v for k, v in got.items() if v})}")
        if got != want or got[plan.instance] != blocks or plan.head_dim != D:
            raise AssertionError(f"{name} {call}: launches {got}, want {want} ({blocks} of {plan.instance})")
    if goal is not None and np.allclose(results[(1, goal)], results[(1, None)], atol=1e-3):
        raise AssertionError(f"{name}: the goal does not change the actions")

    # the deployed kernel route against the plain-int8 route: bit-equal
    deployed.set_int8_impl("plain")
    plain = {B: serve_cached(B) for B in SMALL_BATCHES}
    deployed.set_int8_impl("kernel")
    int8_diffs = {B: max(float(np.abs(a["action_pred"] - b["action_pred"]).max())
                         for a, b in zip(results[("cached", B)], plain[B])) for B in SMALL_BATCHES}
    log(f"{name} deployed, kernel vs plain-int8 route, max |da|: {json.dumps(int8_diffs)}; limit: bit-equal")
    if any(int8_diffs.values()):
        raise AssertionError(f"{name}: the int8 kernel route differs from the plain-int8 route: {int8_diffs}")

    # the kernel route against the plain route, bf16, same noise, and the
    # controls; the reference is fp32 on the card (its attention the fp32
    # kernel at the config's D below), matmuls and convolutions without TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy32 = make_policy(dtype="float32")
    policy32.load_params(*trees)
    frames = {B: torch.from_numpy(windows[B][0][camera][:, 3::4].copy()) for B in SMALL_BATCHES}
    text = {B: policy._encode_language_goal(goal, B) for B in SMALL_BATCHES}
    diffs = route_check(attention_ops, policy, policy32, frames, noise, rejected, text)

    # the card in fp32 (the fp32 kernel at the config's D) against the port on the CPU in fp32
    cpu32 = make_policy(device="cpu", dtype="float32")
    cpu32.load_params(*trees)
    cpu_noise = {k: v.cpu() for k, v in noise[1].items()}
    before = attention_ops.instance_count[f"attention_f32_d{D}"]
    on_card = policy32.predict_action_frames(frames[1], noise=cpu_noise, text_latents=text[1]).cpu()
    f32_launches = attention_ops.instance_count[f"attention_f32_d{D}"] - before
    on_cpu = cpu32.predict_action_frames(frames[1], noise=cpu_noise,
                                         text_latents=None if text[1] is None else text[1].cpu())
    d = (normalized(policy, on_card) - normalized(policy, on_cpu)).abs().max().item()
    log(f"{name} card fp32 ({f32_launches} launches of attention_f32_d{D}) vs CPU fp32, B=1, "
        f"normalized actions: max abs {d}; atol {SERVE_FP32_ATOL}")
    if d > SERVE_FP32_ATOL or f32_launches != blocks:
        raise AssertionError(f"{name}: the card's fp32 run disagrees with the CPU's ({d}) or did not "
                             f"launch the fp32 kernel once per block ({f32_launches})")
    fp32_paths = {f"{name}_fp32_vs_cpu_b1": {f"attention_f32_d{D}": f32_launches}}
    del policy32, cpu32

    # request times on the host clock, each until the action is on the host
    def request_ms(B: int, reps: int, cached: bool):
        cache = deployed.predict_action_cached(windows[B][0], noise=cached_noise[B][0],
                                               language_goal=goal)[1] if cached else None
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cached:
                deployed.predict_action_cached(windows[B][1], cache=cache, n_shift=8,
                                               noise=cached_noise[B][1], language_goal=goal)
            else:
                policy.predict_action(windows[B][0], noise=noise[B], language_goal=goal)
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    torch.cuda.reset_peak_memory_stats()
    serve = {"p50_ms_b1": request_ms(1, REPS_B1, False),
             "median_ms_b128": request_ms(128, REPS_LARGE, False),
             "p50_cached_deployed_ms_b1": request_ms(1, REPS_B1, True),
             "median_cached_deployed_ms_b128": request_ms(128, REPS_LARGE, True)}
    serve["chunks_per_s_b128"] = 128 / (serve["median_ms_b128"] / 1e3)
    serve.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, kernel_vs_plain=diffs,
                 attention_instance=attention_plan_of(attention_ops, c, 128, torch.bfloat16).instance,
                 card=card_line())
    log(f"{name} " + json.dumps(serve))
    # the stages of one request (the breakdown runs the MAR without a goal:
    # the text buffer's 64 tokens cost the same with the null latent)
    log(f"{name}, where the time goes, B=128: " + json.dumps(breakdown(
        policy, frames[128], noise[128], profiled=False)))
    return launches, fp32_paths


# ---------------------------------------------------------------- int8 W8A8

# The int8 kernels repeat their plain versions' arithmetic exactly, so every
# check of them is bit-equality: x_q, x_scale, the s32 product and the layer
# output in the kernel phase, and the actions and the returned latent cache
# of the kernel route against the plain-int8 route in the deployed phase.
# The planted faults (ops/int8_mm.FAULTS) that each of those must reject: all
# four. Two change every call (one scale for all columns; the bias added
# before the bf16 cast instead of after it); the other two change x_q where
# x / x_scale lies on or next to a rounding tie (half away from zero instead
# of half to even; x * (127 / amax) instead of the division), which bf16
# activations hit in every call: a row whose amax has the significand
# 254/128 gets a power-of-two scale, and then many of its elements land
# exactly on k + 0.5.
INT8_REJECTED = ("round_half_away", "reciprocal_scale", "per_tensor_w_scale",
                 "bias_before_cast")
# the int8 route must differ from the bf16 route (mean |da| of the normalized
# chunks): quantization is engaged
INT8_VS_BF16_MIN = 1e-3


def int8_path_shapes(cfg, batches=(128, 1)) -> list:
    """(layer, M, K, N, x dtype) of every W8A8 layer shape on the deployed path
    at each batch (B=128 and B=1), from the MAR config, and the ragged (100,
    128, 130)."""
    D, hidden = cfg.encoder_embed_dim, int(cfg.encoder_embed_dim * cfg.mlp_ratio)
    W, Dd = cfg.diffloss_act_w, cfg.decoder_embed_dim
    shapes = []
    for B in batches:
        m_mar, m_den = B * cfg.attention_tokens, B * cfg.num_action_tokens
        shapes += [
            (f"qkv B={B}", m_mar, D, 3 * D, torch.bfloat16),
            (f"proj B={B}", m_mar, D, D, torch.bfloat16),
            (f"mlp_fc1 B={B}", m_mar, D, hidden, torch.bfloat16),
            (f"mlp_fc2 B={B}", m_mar, hidden, D, torch.bfloat16),
            (f"ada_mod B={B}", m_den, W, 3 * W, torch.bfloat16),
            (f"fc1/fc2 B={B}", m_den, W, W, torch.bfloat16),
            (f"final.ada_mod B={B}", m_den, W, 2 * W, torch.bfloat16),
            (f"cond_embed B={B}", m_den, Dd, W, torch.bfloat16),
            # the quant denoiser's input_proj reads the fp32 sampler state
            (f"input_proj B={B}", m_den, cfg.action_dim, W, torch.float32),
        ]
    shapes.append(("ragged", 100, 128, 130, torch.bfloat16))
    return shapes


def int8_mar_shapes(cfg, B: int = 128) -> list:
    """(layer, M, K, N, x dtype) of the MAR's W8A8 layers at batch B (qkv,
    proj, mlp_fc1, mlp_fc2), named with the model's size: at mar_huge's d =
    1280, K = 1280 and mlp_fc2's K = 5120, whose rows the vector quantize
    kernel's widest instance (per_lane 20) takes."""
    D, hidden = cfg.encoder_embed_dim, int(cfg.encoder_embed_dim * cfg.mlp_ratio)
    m = B * cfg.attention_tokens
    return [(f"d{D} {name} B={B}", m, k, n, torch.bfloat16)
            for name, k, n in (("qkv", D, 3 * D), ("proj", D, D), ("mlp_fc1", D, hidden),
                               ("mlp_fc2", hidden, D))]


def int8_layer_calls(policy) -> dict:
    """W8A8 calls of one request for each layer of ``int8_path_shapes``: qkv,
    proj, mlp_fc1, mlp_fc2 once in every ViT block, and per sampler step the
    denoiser's input_proj, cond_embed, final.ada_mod and per block ada_mod,
    fc1 and fc2."""
    c = policy.mar_cfg
    blocks = c.encoder_depth + c.decoder_depth
    steps = policy.mar.diffactloss.num_steps
    return {"qkv": blocks, "proj": blocks, "mlp_fc1": blocks, "mlp_fc2": blocks,
            "ada_mod": steps * c.diffloss_act_d, "fc1/fc2": steps * 2 * c.diffloss_act_d,
            "final.ada_mod": steps, "cond_embed": steps, "input_proj": steps}


def int8_calls_per_request(policy) -> int:
    return sum(int8_layer_calls(policy).values())


def int8_kernels_per_request(policy, int8_ops, B: int) -> dict:
    """Launches of each int8 kernel (every quantize_rows and int8_gemm
    variant) in one request at batch B, from the config: every layer's
    shape through the wrappers' plans (the activations are contiguous
    tensors of their own and the weights parameters, both 16-byte aligned;
    the GEMM reads quantize_rows' output)."""
    calls = int8_layer_calls(policy)
    out = {k: 0 for k in int8_ops.launch_count}
    for layer, M, K, N, dtype in int8_path_shapes(policy.mar_cfg, (B,)):
        name, _, b = layer.partition(" B=")
        if b == str(B):
            out[int8_ops.quantize_plan(K, dtype).kernel] += calls[name]
            out[int8_ops.gemm_plan(M, N, K).kernel] += calls[name]
    return out


def int8_inputs(M: int, K: int, N: int, dtype, gen):
    x = torch.randn(M, K, generator=gen, device="cuda")
    x[0] *= 100.0  # an outlier row
    x[1] = 0.0  # an all-zero row: the 1e-12 scale floor
    w = torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
    from unified_video_action_tpu_torch.ops import quant

    w_q, w_scale = quant.quantize_weight(w)
    bias = 0.1 * torch.randn(N, generator=gen, device="cuda")
    return x.to(dtype), w_q.T.contiguous(), w_scale, bias


def int8_against_plain(int8_ops, quant, x, w_q, w_scale, bias) -> dict:
    """Both kernels and the layer against the plain versions: which parts are
    bit-equal, and the layer output's max |kernel - plain|."""
    x_q, x_scale = int8_ops.quantize_rows(x)
    y = int8_ops.int8_gemm(x_q, w_q)
    out = int8_ops.int8_gemm(x_q, w_q, x_scale, w_scale, bias, x.dtype)
    torch.cuda.synchronize()
    want_q, want_scale = quant.quantize_rows_plain(x)
    want = quant.w8a8_linear_plain(x, w_q, w_scale, bias)
    return {
        "x_q": torch.equal(x_q, want_q), "x_scale": torch.equal(x_scale, want_scale),
        "s32": torch.equal(y, quant.int8_gemm_plain(want_q, w_q)),
        "out": torch.equal(out, want),
        "max_abs_err": (out.float() - want.float()).abs().max().item(),
        "x_q_max_abs_err": (x_q.int() - want_q.int()).abs().max().item(),
    }


BIT_EQUAL_PARTS = ("x_q", "x_scale", "s32", "out")


def int8_bounds(M: int, K: int, N: int, x_bytes: int, out_bytes: int):
    """Least times (ms, bound_by) of the two kernels at (M, K, N): each input
    read once, each output written once at 3.35 TB/s, against the operations
    at their type's peak (the GEMM's 2MNK at 1,979 TOP/s int8; the row
    quantization's abs-max, division and rounding, 3 per element, at 67
    TFLOP/s fp32)."""
    def bound(n_bytes, t_ops):
        t_bytes = n_bytes / HBM_BYTES_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    gemm = bound(M * K + N * K + 4 * M + 8 * N + M * N * out_bytes, 2 * M * N * K / PEAK_INT8_OPS)
    rows = bound(M * K * x_bytes + M * K + 4 * M, 3 * M * K / PEAK_FLOPS[torch.float32])
    return gemm, rows


def scalar_rows_ms(int8_ops, quant, x) -> float:
    """The scalar quantize kernel on rows ``x``, by a direct call of its C
    entry point (no plan sends such rows there): bit-equal to the plain
    version, and its time, the kernel that rows wider than 3072 took before
    the vector kernel's per_lane 20 instance held them."""
    M, K = x.shape
    x_q = torch.empty(M, K, dtype=torch.int8, device="cuda")
    x_scale = torch.empty(M, dtype=torch.float32, device="cuda")

    def call():
        rc = int8_ops._lib().uva_quantize_rows(x.data_ptr(), x_q.data_ptr(), x_scale.data_ptr(), M, K,
                                               int8_ops._DTYPE_CODES[x.dtype], 0,
                                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"uva_quantize_rows: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    want_q, want_scale = quant.quantize_rows_plain(x)
    if not (torch.equal(x_q, want_q) and torch.equal(x_scale, want_scale)):
        raise AssertionError(f"the scalar quantize kernel differs from the plain version at {(M, K)}")
    return graph_ms(call)


def phase_kernel_int8(int8_ops, quant, shapes, misaligned: bool = True):
    """Every shape of ``shapes`` (``int8_path_shapes``, ``int8_mar_shapes``):
    both kernels bit-equal to their plain versions (the GEMM through the
    wrapper's dispatch), then the GEMM's
    device time by CUDA-graph replay, in turns: with the path's epilogue
    (rescale, cast, bias), with s32 out, and ``torch._int_mm`` (s32 out, the
    same function as the s32 kernel), each read twice (epilogue, s32,
    library, library, s32, epilogue); with the bound of each. Then, where
    ``misaligned``, an operand that is not 16-byte aligned, which must go to
    the mma.sync kernel and stay bit-equal."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for layer, M, K, N, dtype in shapes:
        x, w_q, w_scale, bias = int8_inputs(M, K, N, dtype, gen)
        plan = int8_ops.gemm_plan(M, N, K)
        rows_plan = int8_ops.quantize_plan(K, dtype)
        before = dict(int8_ops.launch_count)
        eq = int8_against_plain(int8_ops, quant, x, w_q, w_scale, bias)
        rows_launched = {k: int8_ops.launch_count[k] - before[k] for k in int8_ops.QUANT_KERNELS
                         if int8_ops.launch_count[k] != before[k]}
        if rows_launched != {rows_plan.kernel: 1}:
            raise AssertionError(f"int8 {layer}: quantize_rows launched {rows_launched}, plan {rows_plan}")
        x_q, x_scale = int8_ops.quantize_rows(x)
        out_bytes = torch.finfo(dtype).bits // 8
        (gemm_bound, gemm_by), (rows_bound, rows_by) = int8_bounds(M, K, N, out_bytes, out_bytes)
        (s32_bound, _), _ = int8_bounds(M, K, N, out_bytes, 4)
        calls = {"epilogue": lambda: int8_ops.int8_gemm(x_q, w_q, x_scale, w_scale, bias, dtype),
                 "s32": lambda: int8_ops.int8_gemm(x_q, w_q),
                 "library": lambda: torch._int_mm(x_q, w_q.T)}
        try:  # cuBLASLt's s8 x s8 -> s32, where its shape rules allow (M > 16, K, N % 8 == 0)
            torch._int_mm(x_q, w_q.T)
        except RuntimeError as e:
            del calls["library"]
            log(f"int8 {layer}: torch._int_mm refuses ({str(e).splitlines()[0][:100]})")
        readings = {k: [] for k in calls}
        for which in ("epilogue", "s32", "library", "library", "s32", "epilogue"):
            if which in calls:
                readings[which].append(graph_ms(calls[which]))
        gemm_ms, s32_ms = statistics.mean(readings["epilogue"]), statistics.mean(readings["s32"])
        library_ms = statistics.mean(readings["library"]) if "library" in calls else None
        row = dict(
            layer=layer, M=M, K=K, N=N, x_dtype=str(dtype).split(".")[-1],
            kernel=plan.kernel, tile=[plan.bm, plan.bn], bit_equal=eq,
            gemm_ms=gemm_ms, gemm_s32_ms=s32_ms, gemm_readings=readings,
            gemm_tops=2 * M * N * K / (gemm_ms * 1e-3) / 1e12,
            gemm_s32_vs_int_mm=None if library_ms is None else s32_ms / library_ms,
            gemm_s32_bound_ms=s32_bound,
            gemm_plain_ms=time_ms(lambda: quant.rescale_plain(
                quant.int8_gemm_plain(x_q, w_q), x_scale, w_scale, bias, dtype), reps=3),
            gemm_library_ms=library_ms, gemm_bound_ms=gemm_bound, gemm_bound_by=gemm_by,
            rows_kernel=rows_plan.kernel,
            rows_ms=graph_ms(lambda: int8_ops.quantize_rows(x)),
            rows_plain_ms=time_ms(lambda: quant.quantize_rows_plain(x), reps=5),
            rows_bound_ms=rows_bound, rows_bound_by=rows_by,
        )
        if K > 3072 and rows_plan.variant == "vector":  # the rows the per_lane 20 instance took over
            row["rows_scalar_ms"] = scalar_rows_ms(int8_ops, quant, x)
        log("int8 " + json.dumps(row))
        if not all(eq[k] for k in BIT_EQUAL_PARTS):
            raise AssertionError(f"int8 kernels differ from their plain versions: {row}")
        rows.append(row)
    if not misaligned:
        return rows

    # an operand 1 byte past a 16-byte boundary: TMA cannot read it
    M, K, N = 144, 768, 768
    x, w_q, w_scale, bias = int8_inputs(M, K, N, torch.bfloat16, gen)
    x_q, x_scale = int8_ops.quantize_rows(x)
    buf = torch.empty(M * K + 1, dtype=torch.int8, device="cuda")
    x_off = buf[1:].view(M, K)
    x_off.copy_(x_q)
    plan = int8_ops.gemm_plan(M, N, K, x_off.data_ptr() % 16 == 0)
    before = dict(int8_ops.launch_count)
    got = int8_ops.int8_gemm(x_off, w_q, x_scale, w_scale, bias, torch.bfloat16)
    torch.cuda.synchronize()
    launched = [k for k in int8_ops.GEMM_KERNELS if int8_ops.launch_count[k] != before[k]]
    want = quant.rescale_plain(quant.int8_gemm_plain(x_q, w_q), x_scale, w_scale, bias, torch.bfloat16)
    log(f"int8 misaligned x_q {(M, K, N)}: plan {plan}, launched {launched}, "
        f"bit-equal {torch.equal(got, want)}")
    if plan.kernel != "int8_gemm_mma_sync" or launched != ["int8_gemm_mma_sync"]:
        raise AssertionError(f"a misaligned operand did not take the mma.sync kernel: {plan}, {launched}")
    if not torch.equal(got, want):
        raise AssertionError("the mma.sync kernel differs from the plain version on a misaligned operand")

    # rows 2 bytes past a 16-byte boundary: the scalar quantize kernel
    buf = torch.empty(M * K + 1, dtype=torch.bfloat16, device="cuda")
    x_off = buf[1:].view(M, K)
    x_off.copy_(x)
    rows_plan = int8_ops.quantize_plan(K, x.dtype, x_off.data_ptr() % 16 == 0)
    before = dict(int8_ops.launch_count)
    got_q, got_scale = int8_ops.quantize_rows(x_off)
    torch.cuda.synchronize()
    launched = [k for k in int8_ops.QUANT_KERNELS if int8_ops.launch_count[k] != before[k]]
    want_q, want_scale = quant.quantize_rows_plain(x)
    same = torch.equal(got_q, want_q) and torch.equal(got_scale, want_scale)
    log(f"quantize_rows on misaligned rows {(M, K)}: plan {rows_plan}, launched {launched}, bit-equal {same}")
    if launched != [rows_plan.kernel] or rows_plan.kernel != "quantize_rows_scalar" or not same:
        raise AssertionError(f"misaligned rows: plan {rows_plan}, launched {launched}, bit-equal {same}")
    return rows


def int8_kernel_controls(int8_ops, quant, cfg) -> None:
    """Each planted fault through the kernel phase's bit-equality, at the
    path's B=128 shapes (the wgmma and the mma.sync kernels) and the ragged
    one: caught if any part differs."""
    shapes = [s for s in int8_path_shapes(cfg) if "B=" not in s[0] or "B=128" in s[0]]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    inputs = [int8_inputs(M, K, N, dtype, gen) for _, M, K, N, dtype in shapes]
    caught = {}
    try:
        for name, flag in int8_ops.FAULTS.items():
            int8_ops.planted_faults = flag
            broken = []
            for (layer, *_), args in zip(shapes, inputs):
                eq = int8_against_plain(int8_ops, quant, *args)
                broken += [f"{layer}:{k}" for k in BIT_EQUAL_PARTS if not eq[k]]
            caught[name] = {"caught": bool(broken), "where": broken[:6], "n": len(broken)}
    finally:
        int8_ops.planted_faults = 0
    log(f"int8 kernel controls: {json.dumps(caught)}")
    missed = [n for n in INT8_REJECTED if not caught[n]["caught"]]
    if missed:
        raise AssertionError(f"the kernel phase does not catch planted faults: {missed}")


def int8_request_ms(rows, calls: dict, B: int, key: str) -> float:
    """A request's int8_gemm device time at batch B modelled from the kernel
    phase: every layer's calls per request times its measured time."""
    return sum(calls[r["layer"].partition(" B=")[0]] * r[key] for r in rows
               if r["layer"].endswith(f" B={B}"))


def deployed_breakdown(policy, obs, cache, noise, reps: int = STAGE_REPS) -> dict:
    """One cached request's stages (median ms of ``reps``): the host's frame
    selection and YUV420 encode (host clock), then by CUDA events the copy
    to the card, the decode and VAE encode of the new frames, the MAR pass,
    the action sampler and the copy of the action back; and the device's
    busy share of one request by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unified_video_action_tpu_torch.utils.obs_codec import encode_yuv420

    stages = ("h2d_ms", "decode_vae_encode_ms", "mar_encoder_decoder_ms", "action_sampler_ms",
              "d2h_ms")
    times = {k: [] for k in ("host_select_encode_ms",) + stages}
    reuse_from, new_positions = policy.cache_plan(obs["image"].shape[1], cache, 8)

    def request(events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        t0 = time.perf_counter()
        packed = encode_yuv420(obs["image"][:, new_positions])
        host = (time.perf_counter() - t0) * 1e3
        mark(0)
        frames = torch.from_numpy(packed).to(policy.device)
        mark(1)
        new_lat = policy._encode_frames(policy._prep_frames(frames), noise["vae"])
        cond = torch.cat([cache[:, reuse_from], new_lat], dim=1)
        mark(2)
        z = policy.mar.policy_latents(cond)
        mark(3)
        nact = policy.mar.diffactloss.sample(z, noise["init"], noise["steps"],
                                             temperature=policy.temperature)
        mark(4)
        nact.cpu()
        mark(5)
        return host

    with torch.no_grad():
        for _ in range(reps):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            torch.cuda.synchronize()
            times["host_select_encode_ms"].append(request(events))
            events[5].synchronize()
            for i, k in enumerate(stages):
                times[k].append(events[i].elapsed_time(events[i + 1]))
        out = {k: statistics.median(v) for k, v in times.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            request()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms > 0:
        out["profiled_wall_ms"] = wall_ms
        out["device_busy_ms"] = busy_ms
        out["device_idle_share"] = max(0.0, 1.0 - busy_ms / wall_ms)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        out["top_device_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 for e in top}
        out.update(kernel_device_ms(kernels))
    else:
        out["device_idle_share"] = "not measured (the profiler saw no device time)"
    return out


def phase_serve_deployed(attention_ops, int8_ops, trees, normalizer) -> dict:
    """Returns the launches of every kernel on the deployed path, the
    int8_gemm device time of one cached request at each batch, and the W8A8
    calls of a request by layer."""
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    meta = os.path.join(LATEST, "meta.json")
    with open(meta) as f:
        amp = json.load(f)["cfg"]["model"]["policy"]["autoregressive_model_params"]
    amp = dict(amp, act_diff_testing_steps="ddim10")

    def make_policy(serving_quant):
        p = UnifiedVideoActionPolicy.from_run_config(
            meta, device="cuda", compute_dtype="bfloat16", autoregressive_model_params=amp,
            obs_codec="yuv420", serving_quant=serving_quant)
        p.set_normalizer(normalizer)
        p.load_params(*trees)
        return p

    policy = make_policy("int8")
    c = policy.mar_cfg
    per_call_int8 = int8_calls_per_request(policy)
    log(f"deployed policy: {policy.mar.diffactloss.num_steps} sampler steps (ddim10), "
        f"serving_quant={policy.serving_quant}, obs_codec={policy.obs_codec}, {policy.dtype}; "
        f"{per_call_int8} W8A8 layer calls per request from the config")

    rng = np.random.default_rng(SEED + 2)
    batches = (1, 128)
    windows = {B: [{"image": rng.integers(0, 256, (B, 16, 3, 96, 96), dtype=np.uint8)}
                   for _ in range(2)] for B in batches}
    noise = {}
    for B in batches:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 10 + B)
        noise[B] = (policy.sample_noise(B, gen, n_new=4), policy.sample_noise(B, gen, n_new=2))

    def serve(B):
        """A full call on the first window, then a cached call on the second."""
        full, cache = policy.predict_action_cached(windows[B][0], noise=noise[B][0])
        cached, cache2 = policy.predict_action_cached(windows[B][1], cache=cache, n_shift=8,
                                                      noise=noise[B][1])
        return (full, cache), (cached, cache2)

    for B in batches:  # warm-up: not counted
        serve(B)
    torch.cuda.synchronize()

    # the deployed path: a full and a cached request at B=1 and at B=128, counted
    counters = (attention_ops.launch_count, attention_ops.instance_count, int8_ops.launch_count)
    for counter in counters:
        for k in counter:
            counter[k] = 0

    def counts() -> dict:
        return {k: v for counter in counters for k, v in counter.items()}

    results, per_call = {}, {}
    for B in batches:
        before = counts()
        results[B] = serve(B)
        torch.cuda.synchronize()
        per_call[B] = {k: (v - before[k]) / 2 for k, v in counts().items()}
    launches = counts()
    wants = {B: {**attention_launches_per_request(attention_ops, c, B, torch.bfloat16),
                 **attention_instances_per_request(attention_ops, c, B, torch.bfloat16),
                 **int8_kernels_per_request(policy, int8_ops, B)} for B in batches}
    log(f"deployed launches per call: {per_call}; in all: {launches}; want {wants}")
    for B in batches:
        want = wants[B]
        quantize = sum(per_call[B][k] for k in int8_ops.QUANT_KERNELS)
        if per_call[B] != want or quantize != per_call_int8:
            raise AssertionError(f"B={B}: launches per call {per_call[B]}, want {want} "
                                 f"({per_call_int8} quantize_rows in all)")
        for res, cache in results[B]:
            check_actions(policy, torch.from_numpy(res["action_pred"]), B)
            if res["action"].shape != (B, policy.n_action_steps, 2):
                raise AssertionError(f"action shape {res['action'].shape}")
            if tuple(cache.shape) != (B, 4, c.vae_embed_dim, c.seq_hw, c.seq_hw):
                raise AssertionError(f"cache shape {tuple(cache.shape)}")

    def differences(got, want) -> dict:
        """max |d| of the normalized chunks and of the returned caches over
        the full and the cached call."""
        acts = max((normalized(policy, torch.from_numpy(g[0]["action_pred"]))
                    - normalized(policy, torch.from_numpy(w[0]["action_pred"]))).abs().max().item()
                   for g, w in zip(got, want))
        caches = max((g[1] - w[1]).abs().max().item() for g, w in zip(got, want))
        return {"action_max": acts, "cache_max": caches}

    # the kernel route against itself (the comparison below needs a
    # reproducible route) and against the plain-int8 route, same noise
    repeat = {B: differences(serve(B), results[B]) for B in batches}
    policy.set_int8_impl("plain")
    plain = {B: serve(B) for B in batches}
    policy.set_int8_impl("kernel")
    diffs = {B: differences(results[B], plain[B]) for B in batches}
    log(f"deployed, kernel route again: {json.dumps(repeat)}; kernel vs plain-int8 route: "
        f"{json.dumps(diffs)}; limit: bit-equal")
    for B in batches:
        if any(repeat[B].values()):
            raise AssertionError(f"B={B}: the kernel route does not reproduce itself: {repeat[B]}")
        if any(diffs[B].values()):
            raise AssertionError(f"B={B}: kernel route differs from the plain-int8 route: {diffs[B]}")

    # controls: the int8 kernels with a planted fault, through the same comparison
    controls = {}
    try:
        for name, flag in int8_ops.FAULTS.items():
            int8_ops.planted_faults = flag
            controls[name] = {B: differences(serve(B), plain[B]) for B in batches}
            controls[name]["rejected"] = any(v for B in batches for v in controls[name][B].values())
    finally:
        int8_ops.planted_faults = 0
    log(f"deployed controls, faulty int8 kernels against the plain-int8 route: {json.dumps(controls)}")
    passed = [n for n in INT8_REJECTED if not controls[n]["rejected"]]
    if passed:
        raise AssertionError(f"faulty int8 kernels pass the serve comparison: {passed}")

    # the int8 route against the bf16 route: quantization is engaged
    bf16_policy = make_policy(None)
    engaged = {}
    for B in batches:
        full_bf16, _ = bf16_policy.predict_action_cached(windows[B][0], noise=noise[B][0])
        da = (normalized(policy, torch.from_numpy(results[B][0][0]["action_pred"]))
              - normalized(policy, torch.from_numpy(full_bf16["action_pred"]))).abs()
        engaged[B] = {"action_mean": da.mean().item(), "action_max": da.max().item()}
    del bf16_policy
    log(f"int8 route vs bf16 route, full call: {json.dumps(engaged)}; mean must exceed {INT8_VS_BF16_MIN}")
    for B in batches:
        if engaged[B]["action_mean"] <= INT8_VS_BF16_MIN:
            raise AssertionError(f"B={B}: the int8 route matches the bf16 route: {engaged[B]}")

    # timing: host clock around whole requests (each ends with the action on
    # the host), after the warm-up
    def request_ms(B, cached, reps):
        ms = []
        cache = results[B][0][1]
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cached:
                policy.predict_action_cached(windows[B][1], cache=cache, n_shift=8,
                                             noise=noise[B][1])
            else:
                policy.predict_action_cached(windows[B][0], noise=noise[B][0])
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    torch.cuda.reset_peak_memory_stats()
    timing = {
        "p50_cached_ms_b1": request_ms(1, True, REPS_B1),
        "p50_full_ms_b1": request_ms(1, False, REPS_B1),
        "median_cached_ms_b128": request_ms(128, True, REPS_LARGE),
        "median_full_ms_b128": request_ms(128, False, REPS_LARGE),
    }
    timing["chunks_per_s_b128_cached"] = 128 / (timing["median_cached_ms_b128"] / 1e3)
    timing["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("deployed serve " + json.dumps(timing))
    gemm_request_ms = {}
    for B in batches:
        b = deployed_breakdown(policy, windows[B][1], results[B][0][1], noise[B][1])
        log(f"deployed, where the time goes, cached request, B={B}: " + json.dumps(b))
        gemm_request_ms[B] = b.get("int8_gemm_device_ms")
    return launches, gemm_request_ms, int8_layer_calls(policy)


# the rollout phase: PushTImageRunner on the test seeds from 100000, 4
# control steps of 8 actions each (a full and three cached calls per env)
ROLLOUT_ENVS = 16
ROLLOUT_MAX_STEPS = 16  # 32 before the UMI phases joined
ROLLOUT_SEED = SEED + 20


class RecordingPolicy:
    """The policy as the runner sees it, keeping every returned action
    tensor (on the card, not waited for) to check after the rollout, and
    calling ``on_first_call()`` at its first call (the envs are up by then)."""

    def __init__(self, policy, on_first_call=None):
        self.policy, self.device, self.actions = policy, policy.device, []
        self.on_first_call, self.first_call = on_first_call, None

    def _record(self, out):
        if not self.actions and self.on_first_call is not None:
            self.first_call = self.on_first_call()
        self.actions.append(out)

    def predict_action_async(self, obs_dict, generator=None):
        out = self.policy.predict_action_async(obs_dict, generator=generator)
        self._record(out)
        return out

    def predict_action_cached_async(self, obs_dict, cache=None, n_shift=8, generator=None):
        out, cond = self.policy.predict_action_cached_async(obs_dict, cache=cache, n_shift=n_shift,
                                                            generator=generator)
        self._record(out)
        return out, cond


def host_rss() -> dict:
    """This process's resident memory and that of its live child processes
    (the async rollout's env processes among them), GB, read from /proc."""
    def rss(pid) -> int:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    me, kids = os.getpid(), []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    if int(f.read().rsplit(")", 1)[1].split()[1]) == me:
                        kids.append(rss(d))
            except (OSError, ValueError, IndexError):
                continue
    return {"parent_gb": rss(me) / 1e9, "children": len(kids), "children_gb": sum(kids) / 1e9,
            "child_max_gb": max(kids, default=0) / 1e9}


def device_busy_ms(prof) -> float:
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def phase_rollout(attention_ops, int8_ops, trees, normalizer) -> dict:
    """Four closed-loop rollouts of the port's PushTImageRunner on the card,
    each with the launches of every kernel counted over the rollout:
    (a) the deployed tier (ddim10 + int8 + yuv420, bf16), latent-cached, two
    streams; (b) the same with the plain-int8 route and the same generator
    seed, which must give the same per-seed results and final agent
    positions; (c) bf16 ddim10 uncached, one stream; (d) rollout (a) with
    vector_env="async" (each env in a spawned process), which must give (a)'s
    results, with its env processes' start time and the host's resident
    memory while they run. Returns the launches of each rollout."""
    from torch.profiler import ProfilerActivity, profile

    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
    from unified_video_action_tpu_torch.runners.pusht_runner import PushTImageRunner

    meta = os.path.join(LATEST, "meta.json")
    with open(meta) as f:
        amp = json.load(f)["cfg"]["model"]["policy"]["autoregressive_model_params"]
    amp = dict(amp, act_diff_testing_steps="ddim10")

    def make_policy(serving_quant, obs_codec):
        p = UnifiedVideoActionPolicy.from_run_config(
            meta, device="cuda", compute_dtype="bfloat16", autoregressive_model_params=amp,
            obs_codec=obs_codec, serving_quant=serving_quant)
        p.set_normalizer(normalizer)
        p.load_params(*trees)
        return p

    counters = (attention_ops.launch_count, attention_ops.instance_count, int8_ops.launch_count)

    def counts() -> dict:
        return {k: v for counter in counters for k, v in counter.items()}

    def rollout(policy, latent_cache, n_streams, profiled=False, vector_env="sync"):
        runner = PushTImageRunner(n_train=0, n_test=ROLLOUT_ENVS, max_steps=ROLLOUT_MAX_STEPS,
                                  latent_cache=latent_cache, n_streams=n_streams,
                                  vector_env=vector_env)
        recording = RecordingPolicy(policy, host_rss)
        gen = torch.Generator(device="cuda").manual_seed(ROLLOUT_SEED)
        torch.cuda.synchronize()
        for counter in counters:
            for k in counter:
                counter[k] = 0
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                log = runner.run(recording, gen)
                torch.cuda.synchronize()
        else:
            log = runner.run(recording, gen)
            torch.cuda.synchronize()
        launches = counts()
        calls = len(recording.actions)
        want_calls = n_streams * ROLLOUT_MAX_STEPS // 8
        batch = ROLLOUT_ENVS // n_streams
        if calls != want_calls or runner.timing["env_steps"] != want_calls:
            raise AssertionError(f"{calls} policy calls and {runner.timing['env_steps']} env "
                                 f"steps, want {want_calls} each: an env did not run to its end")
        for actions in recording.actions:
            check_actions(policy, actions, batch)
        out = {"log": log, "final_agent_pos": runner.final_agent_pos.copy(),
               "launches": launches, "calls": calls, "batch": batch, "timing": dict(runner.timing),
               "host_rss": recording.first_call}
        if profiled:
            busy = device_busy_ms(prof)
            out["device_busy_ms"] = busy
            out["device_idle_share"] = (max(0.0, 1.0 - busy / (runner.timing["wall_s"] * 1e3))
                                        if busy > 0 else "not measured (no device time profiled)")
        return out

    def want_launches(policy, calls, batch, int8_route):
        per_call = {**attention_launches_per_request(attention_ops, policy.mar_cfg, batch, torch.bfloat16),
                    **attention_instances_per_request(attention_ops, policy.mar_cfg, batch,
                                                      torch.bfloat16)}
        if int8_route:
            per_call.update(int8_kernels_per_request(policy, int8_ops, batch))
        return {k: calls * per_call.get(k, 0) for k in counts()}

    deployed = make_policy("int8", "yuv420")
    results = {}
    results["a"] = rollout(deployed, latent_cache=True, n_streams=2, profiled=True)
    deployed.set_int8_impl("plain")
    results["b"] = rollout(deployed, latent_cache=True, n_streams=2)
    deployed.set_int8_impl("kernel")
    bf16 = make_policy(None, None)
    results["c"] = rollout(bf16, latent_cache=False, n_streams=1)
    results["d"] = rollout(deployed, latent_cache=True, n_streams=2, vector_env="async")

    wants = {"a": want_launches(deployed, results["a"]["calls"], results["a"]["batch"], True),
             "b": want_launches(deployed, results["b"]["calls"], results["b"]["batch"], False),
             "c": want_launches(bf16, results["c"]["calls"], results["c"]["batch"], False),
             "d": want_launches(deployed, results["d"]["calls"], results["d"]["batch"], True)}
    for name, r in results.items():
        log(f"rollout ({name}): {r['calls']} calls at B={r['batch']}, launches {r['launches']}, "
            f"want {wants[name]}; test/mean_score {r['log']['test/mean_score']:.4f}; "
            f"timing {json.dumps(r['timing'])}")
        if r["launches"] != wants[name]:
            raise AssertionError(f"rollout ({name}): launches {r['launches']}, want {wants[name]}")
    if results["a"]["log"] != results["b"]["log"]:
        raise AssertionError(f"rollouts (a) and (b) differ: {results['a']['log']} vs "
                             f"{results['b']['log']}")
    if not np.array_equal(results["a"]["final_agent_pos"], results["b"]["final_agent_pos"]):
        raise AssertionError("rollouts (a) and (b) end with different agent positions")
    if results["d"]["log"] != results["a"]["log"]:
        raise AssertionError(f"rollouts (d, async) and (a) differ: {results['d']['log']} vs "
                             f"{results['a']['log']}")
    if not np.array_equal(results["d"]["final_agent_pos"], results["a"]["final_agent_pos"]):
        raise AssertionError("rollouts (d, async) and (a) end with different agent positions")
    if results["d"]["host_rss"]["children"] < ROLLOUT_ENVS:
        raise AssertionError(f"rollout (d): {results['d']['host_rss']} child processes at its first "
                             f"call, want at least {ROLLOUT_ENVS} env processes")
    loaded = {m.split(".")[0] for m in sys.modules} - MODULES_BEFORE_THE_PORT
    if loaded & {"cv2", "dill"}:
        raise AssertionError(f"the port loaded {sorted(loaded & {'cv2', 'dill'})}")
    log("rollouts (a), (b) and (d, async): identical per-seed sim_max_reward and final agent "
        "positions; no cv2 or dill loaded")

    # the policy calls of rollout (a) alone: a full and a cached call at the
    # rollout's batch on the host clock, each until its action is on the host
    # (median of 5)
    batch = results["a"]["batch"]
    window = {"image": np.random.default_rng(SEED + 21).random(
        (batch, 16, 3, 96, 96)).astype(np.float32)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)

    def call_ms(cached):
        _, cache = deployed.predict_action_cached(window, generator=gen)
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            deployed.predict_action_cached(window, cache=cache if cached else None, generator=gen)
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    a, c = results["a"], results["c"]
    timing = {
        "full_call_ms": call_ms(False), "cached_call_ms": call_ms(True), "call_batch": batch,
        "env_control_step_ms_16_envs": 1e3 * c["timing"]["env_step_s"] / c["timing"]["env_steps"],
        "env_control_step_ms_8_envs": 1e3 * a["timing"]["env_step_s"] / a["timing"]["env_steps"],
        "rollout_wall_s": {k: r["timing"]["wall_s"] for k, r in results.items()},
        "env_step_s": {k: r["timing"]["env_step_s"] for k, r in results.items()},
        "env_start_s": {k: r["timing"]["env_start_s"] for k, r in results.items()},
        "host_rss_at_first_call": {k: results[k]["host_rss"] for k in ("a", "d")},
        "rollout_a_device_busy_ms": a.get("device_busy_ms"),
        "rollout_a_device_idle_share": a.get("device_idle_share"),
        "card": card_line(),
    }
    log("rollout timing " + json.dumps(timing))
    return {k: r["launches"] for k, r in results.items()}


# ------------------------------------------------------ video generation

# the video phase: Mar.sample_video (MaskGIT rounds, each one encoder and
# decoder pass, then the video head's sampler on the tokens the round
# reveals), the VAE decode and eval/offline.test_video_fvd
VIDEO_FVD_BATCHES, VIDEO_FVD_BATCH = 2, 32  # validation windows of the corpus (4 before the UMI phases joined)
VIDEO_ITER_BATCH, VIDEO_ITERS = 8, 2  # the rank slices: sample_video at num_iter 2 (4 before)
VIDEO_ROUTE_BATCH = 4  # the 256 px and kitchen paths' batch (8 rows under CFG)
VIDEO_CFG = 1.5
VIDEO_FP32_BATCH, VIDEO_FP32_ITERS = 2, 1  # the card in fp32 against the CPU (num_iter 2 before the PushT pipeline)
# the kernel route against the plain route, under the same draws: every
# attention call within SERVE_CALL_REL_RMS and ATTN_BF16_MAX_OVER_RMS of the
# plain version on its own inputs (the serve phases' limits; the planted
# controls must fail them), and the final latents' mean |x - x_fp32| within
# this factor of the plain route's, the bf16 floor of the path (the serve
# phases hold the decoder output z to 1.1 of its floor; the video head
# samples with clip_denoised=False from z, and under random weights its
# first step multiplies eps by about 1e4, so a latent's distance from fp32
# varies more from element to element than z's: 1.25)
VIDEO_FLOOR_RATIO = 1.25
# the card in fp32 (3xTF32 attention, no TF32 elsewhere) against the port on
# the CPU in fp32: max |x_card - x_cpu| over max |x_cpu| of the latents
# (summation order only, amplified by the sampler's first step)
VIDEO_FP32_RTOL = 1e-3
# the trained decoder's reconstruction PSNR, the card in fp32 against the CPU
VIDEO_PSNR_FRAMES = 64
VIDEO_PSNR_DB = 0.05


def draws_to(draws, device):
    """sample_video's draws (``Mar.sample_video_draws``) on ``device``."""
    return {"order_rank": draws["order_rank"].to(device),
            "rounds": [{k: v.to(device) for k, v in r.items()} for r in draws["rounds"]]}


def counted_launches(attention_ops, fn):
    """fn()'s attention launches by kernel and by instance, the counts set to
    0 just before it and read just after; returns (fn's result, launches)."""
    counters = (attention_ops.launch_count, attention_ops.instance_count)
    torch.cuda.synchronize()
    for counter in counters:
        for k in counter:
            counter[k] = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for counter in counters for k, v in counter.items()}


def video_route_check(attention_ops, name: str, policy, policy32, cond, draws, rejected,
                      **kw) -> dict:
    """``sample_video(cond, draws, **kw)`` of the bf16 ``policy`` through the
    kernel route and each planted fault of ``control_faults``, against the
    plain route and ``policy32`` (fp32, plain attention) under the same
    draws: every attention call held to the serve phases' per-call limits,
    the latents to VIDEO_FLOOR_RATIO of the plain route's distance from
    fp32. The kernel route must pass, each control in ``rejected`` fail.
    Returns the kernel route's readings."""
    policy.set_attn_impl("plain")
    policy32.set_attn_impl("plain")
    try:
        ref, _ = policy32.mar.sample_video(cond, draws, **kw)
        plain, _ = policy.mar.sample_video(cond, draws, **kw)
    finally:
        policy.set_attn_impl("kernel")
        policy32.set_attn_impl("kernel")
    floor = (plain - ref).abs().mean().item()

    def reading(impl) -> dict:
        with checked_attention(attention_ops, policy, impl) as calls:
            lat, _ = policy.mar.sample_video(cond, draws, **kw)
        return {"latent_err": (lat - ref).abs().mean().item(), "latent_err_plain": floor,
                "latent_vs_plain_rel_rms": ((lat - plain).norm() / plain.norm()).item(),
                "latent_max": ref.abs().max().item(), "finite": bool(torch.isfinite(lat).all()),
                **calls}

    def failures(d: dict) -> list:
        return ([] if d["calls_ok"] else ["calls"]) + \
            ([] if d["finite"] and d["latent_err"] <= VIDEO_FLOOR_RATIO * floor else ["latents"])

    routes = {"kernel": attention_ops.flash_attention, **control_faults(attention_ops)}
    readings = {r: reading(impl) for r, impl in routes.items()}
    diffs = readings.pop("kernel")
    log(f"video {name}, kernel vs plain attention, bf16: {json.dumps(diffs)}; limits: every call "
        f"rel_rms_err {SERVE_CALL_REL_RMS}, max_err_over_rms {ATTN_BF16_MAX_OVER_RMS}; latent_err "
        f"<= {VIDEO_FLOOR_RATIO} latent_err_plain")
    if failures(diffs):
        raise AssertionError(f"video {name}: the kernel route disagrees with the plain route "
                             f"({failures(diffs)}): {diffs}")
    for d in readings.values():
        d["failed_limits"] = failures(d)
    log(f"video {name}, controls against the plain route: {json.dumps(readings)}")
    passed = [r for r in rejected if not readings[r]["failed_limits"]]
    if passed:
        raise AssertionError(f"video {name}: faulty kernels pass the limits: {passed}")
    return diffs


def video_fvd_run(policy, batches, spans=None, num_batches=VIDEO_FVD_BATCHES) -> dict:
    """eval/offline.test_video_fvd of ``policy`` on ``batches``; with
    ``spans`` ({stage: []}), the stages of each call are recorded there as
    CUDA event pairs: encode (the VAE encodes of both halves), mar (the
    encoder and decoder passes), action_sampler, video_sampler, decode."""
    from unified_video_action_tpu_torch.eval.offline import test_video_fvd

    targets = [("encode", policy, "_encode_frames"), ("mar", policy.mar, "forward_encoder"),
               ("mar", policy.mar, "forward_decoder"),
               ("action_sampler", policy.mar.diffactloss, "sample"),
               ("video_sampler", policy.mar.diffloss, "sample"), ("decode", policy.vae, "decode")]

    def timed(stage, fn):
        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[stage].append((start, end))
            return out
        return run

    if spans is not None:
        for stage, obj, attr in targets:
            setattr(obj, attr, timed(stage, getattr(obj, attr)))
    try:
        return test_video_fvd(policy, batches, num_batches=num_batches, num_iter=1)
    finally:
        for _, obj, attr in targets:
            obj.__dict__.pop(attr, None)


def psnr_db(recon: torch.Tensor, frames: torch.Tensor) -> float:
    """Reconstruction PSNR over frames in [-1, 1] (peak-to-peak 2), the
    reconstruction clipped."""
    mse = (recon.float().clamp(-1, 1) - frames.float()).pow(2).mean().item()
    return 10.0 * float(np.log10(4.0 / mse))


def video_flagship(attention_ops, trees, normalizer, dataset) -> dict:
    """The flagship (mar_base, 96 px, 144 tokens), numpy-seeded MAR and the
    committed pusht_vae96.npz with its decoder: test_video_fvd over
    VIDEO_FVD_BATCHES batches of VIDEO_FVD_BATCH validation windows of the
    corpus (counted: 24 launches of the single-pass D = 64 instance a round,
    no other attention kernel), its stages by CUDA events and the device's
    busy share; sample_video at num_iter VIDEO_ITERS (counted); the kernel
    route against the plain route; the card in fp32 against the CPU; the
    trained decoder's PSNR on the card against the CPU."""
    from unified_video_action_tpu_torch.data.device_dataset import DeviceReplayDataset
    from unified_video_action_tpu_torch.eval.offline import decode_frames
    from unified_video_action_tpu_torch.models.vae import LATENT_SCALE
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    meta = os.path.join(LATEST, "meta.json")

    def make_policy(device="cuda", dtype="bfloat16"):
        p = UnifiedVideoActionPolicy.from_run_config(meta, device=device, compute_dtype=dtype)
        p.set_normalizer(normalizer)
        p.load_params(*trees)
        return p

    policy = make_policy()
    c = policy.mar_cfg
    blocks = c.encoder_depth + c.decoder_depth
    store = DeviceReplayDataset(dataset, "cuda")
    val = store.split(dataset.get_validation_dataset())
    batches = [val.gather(np.arange(i * VIDEO_FVD_BATCH, (i + 1) * VIDEO_FVD_BATCH))
               for i in range(VIDEO_FVD_BATCHES)]
    log(f"video flagship: mar {c.encoder_depth}+{c.decoder_depth} blocks, d={c.encoder_embed_dim}, "
        f"{c.img_size}px, {c.total_tokens} tokens, video head {policy.mar.diffloss.num_steps} steps, "
        f"action head {policy.mar.diffactloss.num_steps}, temperature {policy.temperature}, "
        f"{policy.dtype}; VAE decoder {sum(p.numel() for p in policy.vae.decoder.parameters()) / 1e6:.1f}M "
        f"from pretrained_models/vae/pusht_vae96.npz; {len(val)} validation windows, "
        f"{VIDEO_FVD_BATCHES} batches of {VIDEO_FVD_BATCH}")

    video_fvd_run(policy, batches, num_batches=1)  # warm-up: not counted
    spans = {k: [] for k in ("encode", "mar", "action_sampler", "video_sampler", "decode")}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def fvd():
        start.record()
        out = video_fvd_run(policy, batches, spans)
        end.record()
        return out

    metrics, launches = counted_launches(attention_ops, fvd)
    want = want_serving_launches(attention_ops, c, [VIDEO_FVD_BATCH] * VIDEO_FVD_BATCHES)
    want = {k: want.get(k, 0) for k in launches}
    log(f"video flagship test_video_fvd: {json.dumps(metrics)}; attention launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}, want {blocks} a round of the "
        f"instance attention_plan names")
    if (launches != want or launches["attention_wgmma_d64"] != blocks * VIDEO_FVD_BATCHES
            or set(metrics) != {"video_fvd_vae", "video_fvd_pixel"}
            or not all(np.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"video flagship FVD: {metrics}, launches {launches}, want {want}")
    stages = {k: sum(s.elapsed_time(e) for s, e in v) / VIDEO_FVD_BATCHES for k, v in spans.items()}
    stages["batch_ms"] = start.elapsed_time(end) / VIDEO_FVD_BATCHES
    # the profiler over one batch, device activity only (host events would
    # add thousands of operator records to process): the device's busy share
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p0, p1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        p0.record()
        video_fvd_run(policy, batches, num_batches=1)
        p1.record()
        p1.synchronize()
    busy = device_busy_ms(prof)
    stages.update(profiled_batch_ms=p0.elapsed_time(p1), device_busy_ms=busy,
                  device_idle_share=(max(0.0, 1.0 - busy / p0.elapsed_time(p1)) if busy > 0 else
                                     "not measured (the profiler saw no device time)"),
                  batch=VIDEO_FVD_BATCH, card=card_line())
    log(f"video flagship, ms per FVD batch by stage (CUDA events): {json.dumps(stages)}")

    # the rank slices on the card: num_iter VIDEO_ITERS at B = VIDEO_ITER_BATCH
    gen = torch.Generator().manual_seed(SEED + 60)
    frames = torch.from_numpy(np.random.default_rng(SEED + 60).integers(
        0, 256, (VIDEO_ITER_BATCH, 4, 3, 96, 96), dtype=np.uint8))
    cond = policy._encode_frames(policy._prep_frames(frames.cuda()),
                                 torch.randn(policy.noise_shapes(VIDEO_ITER_BATCH)["vae"],
                                             generator=gen).cuda())
    draws = draws_to(policy.mar.sample_video_draws(VIDEO_ITER_BATCH, gen, torch.device("cpu"),
                                                   VIDEO_ITERS), "cuda")
    kw = dict(num_iter=VIDEO_ITERS, temperature=policy.temperature)
    (lat, act), iter_launches = counted_launches(
        attention_ops, lambda: policy.mar.sample_video(cond, draws, **kw))
    want = want_serving_launches(attention_ops, c, [VIDEO_ITER_BATCH] * VIDEO_ITERS)
    want = {k: want.get(k, 0) for k in iter_launches}
    log(f"video flagship sample_video B={VIDEO_ITER_BATCH} num_iter={VIDEO_ITERS}: launches "
        f"{json.dumps({k: v for k, v in iter_launches.items() if v})}; latents "
        f"{tuple(lat.shape)}, max |x| {lat.abs().max().item():.4g}")
    if (iter_launches != want or iter_launches["attention_wgmma_d64"] != blocks * VIDEO_ITERS
            or tuple(lat.shape) != (VIDEO_ITER_BATCH * 4, c.vae_embed_dim, c.seq_hw, c.seq_hw)
            or not bool(torch.isfinite(lat).all())):
        raise AssertionError(f"video flagship num_iter {VIDEO_ITERS}: launches {iter_launches}, "
                             f"want {want}; latents {tuple(lat.shape)}")
    check_actions(policy, policy.normalizer["action"].unnormalize(act), VIDEO_ITER_BATCH)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy32 = make_policy(dtype="float32")
    route = video_route_check(attention_ops, "flagship", policy, policy32, cond, draws,
                              REJECTED_CONTROLS, **kw)

    # the card in fp32 (the fp32 kernel) against the port on the CPU in fp32
    cpu32 = make_policy(device="cpu", dtype="float32")
    B = VIDEO_FP32_BATCH
    gen = torch.Generator().manual_seed(SEED + 61)
    cond_cpu = cond[:B].float().cpu()
    draws_cpu = policy.mar.sample_video_draws(B, gen, torch.device("cpu"), VIDEO_FP32_ITERS)
    kw32 = dict(num_iter=VIDEO_FP32_ITERS, temperature=policy.temperature)
    (card, card_act), f32_launches = counted_launches(
        attention_ops, lambda: policy32.mar.sample_video(cond_cpu.cuda(), draws_to(draws_cpu, "cuda"),
                                                         **kw32))
    t0 = time.perf_counter()
    cpu, cpu_act = cpu32.mar.sample_video(cond_cpu, draws_cpu, **kw32)
    cpu_s = time.perf_counter() - t0
    rel = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    da = (normalized(policy, card_act.cpu()) - normalized(policy, cpu_act)).abs().max().item()
    log(f"video flagship card fp32 ({f32_launches['attention_f32_d64']} launches of "
        f"attention_f32_d64) vs CPU fp32 ({cpu_s:.1f}s), B={B}, num_iter {VIDEO_FP32_ITERS}: latents "
        f"max |d| / max |x| {rel:.3g} (limit {VIDEO_FP32_RTOL}), normalized actions max |d| {da:.3g} "
        f"(limit {SERVE_FP32_ATOL})")
    if (rel > VIDEO_FP32_RTOL or da > SERVE_FP32_ATOL
            or f32_launches["attention_f32_d64"] != blocks * VIDEO_FP32_ITERS):
        raise AssertionError(f"video flagship: the card's fp32 run disagrees with the CPU's "
                             f"(latents {rel}, actions {da}) or launched {f32_launches}")

    # the trained decoder: the posterior mean of corpus frames, decoded
    x = store.img[:VIDEO_PSNR_FRAMES].permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with torch.no_grad():
        recon = {"card_fp32": policy32.vae.decode(policy32.vae.encode(x)[0]),
                 "card_bf16": policy.vae.decode(policy.vae.encode(x)[0]),
                 "cpu_fp32": cpu32.vae.decode(cpu32.vae.encode(x.cpu())[0])}
    psnr = {k: psnr_db(v.cpu(), x.cpu()) for k, v in recon.items()}
    with torch.no_grad():
        u8 = decode_frames(policy, policy.vae.encode(x)[0] * LATENT_SCALE)
    ok = (abs(psnr["card_fp32"] - psnr["cpu_fp32"]) <= VIDEO_PSNR_DB
          and all(bool(torch.isfinite(v).all()) for v in recon.values())
          and u8.dtype == np.uint8 and u8.shape == (VIDEO_PSNR_FRAMES, 96, 96, 3))
    log(f"video flagship trained decoder, {VIDEO_PSNR_FRAMES} corpus frames encoded to the posterior "
        f"mean and decoded: PSNR {json.dumps(psnr)} dB (card fp32 vs CPU fp32 within "
        f"{VIDEO_PSNR_DB} dB); decode_frames uint8 {u8.shape}")
    if not ok:
        raise AssertionError(f"video flagship decoder: PSNR {psnr}, uint8 {u8.dtype} {u8.shape}")
    del policy32, cpu32, store, val
    return {"fvd": metrics, "stages": stages, "launches_fvd": launches,
            "launches_iter": iter_launches, "launches_fp32": f32_launches, "route": route,
            "psnr": psnr, "fp32_latent_rel": rel}


def video_cfg_noop(policy, cond, draws, text) -> None:
    """With ``text_proj_cond`` mapping every goal onto ``fake_latent``, the
    conditional and unconditional halves are the same rows: guidance scales
    3 and 7 must give bit-identical latents and actions on the card."""
    mar = policy.mar
    saved = {k: v.clone() for k, v in mar.text_proj_cond.state_dict().items()}
    try:
        with torch.no_grad():
            mar.text_proj_cond.weight.zero_()
            mar.text_proj_cond.bias.copy_(mar.fake_latent[0].to(mar.text_proj_cond.bias.dtype))
        outs = [mar.sample_video(cond, draws, num_iter=2, cfg=s, text_latents=text,
                                 temperature=policy.temperature) for s in (3.0, 7.0)]
    finally:
        mar.text_proj_cond.load_state_dict(saved)
    same = torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    log(f"video kitchen CFG no-op control (projected goal = fake_latent): cfg 3 and 7 bit-identical: "
        f"{same}")
    if not same:
        raise AssertionError("video kitchen: cfg moves the latents although both halves are the "
                             "same rows")


def video_path(attention_ops, name: str, run_cfg: dict, vae_tree, rejected, goal=None,
               cfg: float = 1.0, num_iter: int = 2) -> dict:
    """sample_video of a served config at B = VIDEO_ROUTE_BATCH (numpy-seeded
    MAR, ``vae_tree``), ``num_iter`` rounds, with ``goal`` and guidance
    ``cfg`` where given: counted (the instance attention_plan names at 2B
    rows under CFG, once per ViT block a round, no other attention kernel),
    then the kernel route against the plain route."""
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    def make_policy(dtype):
        p = UnifiedVideoActionPolicy.from_cfg(run_cfg, device="cuda", compute_dtype=dtype)
        p.load_params(mar_tree, vae_tree)
        return p

    mar_tree = convert.seeded_tree(
        UnifiedVideoActionPolicy.from_cfg(run_cfg, device="meta").mar, SEED)
    policy = make_policy("bfloat16")
    c = policy.mar_cfg
    B, rows = VIDEO_ROUTE_BATCH, VIDEO_ROUTE_BATCH * (2 if cfg != 1.0 else 1)
    D = c.encoder_embed_dim // c.encoder_num_heads
    gen = torch.Generator().manual_seed(SEED + 70)
    frames = torch.from_numpy(np.random.default_rng(SEED + 70).integers(
        0, 256, (B, 4, 3, 96, 96), dtype=np.uint8)).cuda()
    cond = policy._encode_frames(policy._prep_frames(frames),
                                 torch.randn(policy.noise_shapes(B)["vae"], generator=gen).cuda())
    text = policy._encode_language_goal(goal, B)
    draws = draws_to(policy.mar.sample_video_draws(B, gen, torch.device("cpu"), num_iter, cfg=cfg),
                     "cuda")
    kw = dict(num_iter=num_iter, cfg=cfg, text_latents=text, temperature=policy.temperature)
    policy.mar.sample_video(cond, draws, **kw)  # warm-up: not counted
    (lat, act), launches = counted_launches(attention_ops, lambda: policy.mar.sample_video(
        cond, draws, **kw))
    plan = attention_plan_of(attention_ops, c, rows, torch.bfloat16)
    want = want_serving_launches(attention_ops, c, [rows] * num_iter)
    want = {k: want.get(k, 0) for k in launches}
    blocks = c.encoder_depth + c.decoder_depth
    log(f"video {name}: mar {c.encoder_depth}+{c.decoder_depth} blocks, D={D}, {c.img_size}px, "
        f"{c.attention_tokens} tokens attended, {rows} rows (B={B}, cfg {cfg}, goal {goal!r}), "
        f"num_iter {num_iter}: plan {plan}, launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if (launches != want or launches[plan.instance] != blocks * num_iter
            or not bool(torch.isfinite(lat).all())
            or tuple(lat.shape) != (B * c.n_frames, c.vae_embed_dim, c.seq_hw, c.seq_hw)):
        raise AssertionError(f"video {name}: launches {launches}, want {want}; latents "
                             f"{tuple(lat.shape)}")
    if goal is not None:
        video_cfg_noop(policy, cond, draws, text)
    policy32 = make_policy("float32")
    route = video_route_check(attention_ops, name, policy, policy32, cond, draws, rejected, **kw)
    return {"launches": launches, "route": route, "instance": plan.instance}


def phase_video(attention_ops, trees, normalizer, dataset) -> dict:
    """The video generation slice at full width: the flagship
    (``video_flagship``), then config.PUSHT_256 (the seeded ch-128 VAE, the
    online D = 64 kernel) and config.KITCHEN_SMALL128 with a goal and
    classifier-free guidance at VIDEO_CFG (the online D = 128 kernel on 2B
    rows, and the CFG no-op control) through ``video_path``."""
    from unified_video_action_tpu_torch import config as port_config
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    flagship = video_flagship(attention_ops, trees, normalizer, dataset)
    vae256 = convert.seeded_tree(UnifiedVideoActionPolicy.from_cfg(port_config.PUSHT_256,
                                                                   device="meta").vae, SEED + 1)
    px256 = video_path(attention_ops, "256px", port_config.PUSHT_256, vae256,
                       REJECTED_CONTROLS_256)
    kitchen_vae = convert.load_flat_npz(os.path.join(
        REPO, port_config.KITCHEN_SMALL128["model"]["policy"]["vae_model_params"]["autoencoder_path"]))
    kitchen = video_path(attention_ops, "kitchen128", port_config.KITCHEN_SMALL128, kitchen_vae,
                         REJECTED_CONTROLS_KITCHEN, goal=KITCHEN_GOAL, cfg=VIDEO_CFG)
    return {"flagship": flagship, "256px": px256, "kitchen128": kitchen}


# the train phase: the flagship's stage-2 recipe (latest/meta.json) on a
# synthetic store of TRAIN_EPISODES episodes of the port's PushT env
TRAIN_EPISODES = 6
TRAIN_OUT = os.path.join(REPO, "build", "train_smoke")
TRAIN_EPOCHS, TRAIN_STEPS_PER_EPOCH = 3, 5  # 15 bf16 steps at the recipe's B = 32 (30 before)
TRAIN_PARITY_B = 2
TRAIN_PARITY_MODES = ("full_dynamic_model", "policy_model", "full_dynamic_model")
TRAIN_PARITY_RTOL = 1e-4
TRAIN_TIMED_STEPS, TRAIN_WARMUP_STEPS, TRAIN_PROFILED_STEPS = 6, 2, 2  # 10, 3, 5 before
OVERFIT_STEPS, OVERFIT_WARMUP = 30, 5
# the loss at the overfit run's last step must fall below this share of its
# first: on an NVIDIA H100 80GB HBM3 at 700 W the run gives 0.121 (5.307 ->
# 0.643); the bound is about twice that
OVERFIT_FRACTION = 0.25


def train_config(*overrides: str) -> dict:
    """The flagship's run config with the smoke's overrides."""
    from unified_video_action_tpu_torch.config import apply_overrides

    with open(os.path.join(LATEST, "meta.json")) as f:
        cfg = json.load(f)["cfg"]
    apply_overrides(cfg, [f"task.dataset.synthetic={TRAIN_EPISODES}", f"training.seed={SEED}",
                          f"training.num_epochs={TRAIN_EPOCHS}",
                          f"training.max_train_steps={TRAIN_STEPS_PER_EPOCH}",
                          "model.policy.autoregressive_model_params.pretrained_model_path=null",
                          f"model.policy.vae_model_params.autoencoder_path={VAE_NPZ}",
                          f"output_dir={TRAIN_OUT}",
                          # the step phase: no evaluation, checkpoint or resume (train_run's)
                          "training.val_every=0", "training.rollout_every=0",
                          "training.checkpoint_every=0", "training.sample_every=0",
                          "training.resume=false", "training.early_stop_patience=null",
                          *overrides])
    return cfg


def train_parity(trainer) -> dict:
    """TRAIN_PARITY_MODES' steps in fp32 (no TF32 in matmuls or convolutions)
    at B = TRAIN_PARITY_B on the card and on the CPU in this process: the same
    initial weights, batches, noise and dropout masks; each step's metrics
    must agree to TRAIN_PARITY_RTOL."""
    from unified_video_action_tpu_torch.data.device_dataset import DeviceReplayDataset
    from unified_video_action_tpu_torch.training.ema import EmaConfig
    from unified_video_action_tpu_torch.training.train_state import create_train_state, train_step
    from unified_video_action_tpu_torch.training.workspace import build_policy
    from unified_video_action_tpu_torch.utils.frames import select_frame_indices

    cfg = train_config("model.policy.compute_dtype=float32")
    policies = {dev: build_policy(cfg, torch.device(dev)) for dev in ("cpu", "cuda")}
    for p in policies.values():
        p.init_params(SEED)
        p.set_normalizer(trainer.normalizer)
    policies["cuda"].mar.load_state_dict(policies["cpu"].mar.state_dict())
    c = policies["cpu"].mar_cfg
    log(f"train parity: fp32, {c.encoder_depth}+{c.decoder_depth} blocks of d={c.encoder_embed_dim}, "
        f"B={TRAIN_PARITY_B}")
    stores = {"cpu": DeviceReplayDataset(trainer.dataset, "cpu"), "cuda": trainer.data}
    states = {dev: create_train_state(p, EmaConfig(), learning_rate=1e-4, weight_decay=0.02,
                                      betas=(0.9, 0.95), warmup_steps=500, total_steps=1000)
              for dev, p in policies.items()}
    rng = np.random.default_rng(SEED)
    frames = select_frame_indices(trainer.data.horizon, eval=False)
    seconds = {"cpu": 0.0, "cuda": 0.0}
    steps = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for k, mode in enumerate(TRAIN_PARITY_MODES):
            idxs = rng.choice(len(trainer.data), TRAIN_PARITY_B, replace=False)
            aug = trainer.draw_aug(TRAIN_PARITY_B)
            gen = torch.Generator().manual_seed(SEED + k)
            noise = policies["cpu"].sample_train_noise(TRAIN_PARITY_B, gen)
            drop = policies["cpu"].mar.draw_dropout(TRAIN_PARITY_B, gen, torch.device("cpu"))
            row = {"mode": mode}
            for dev in ("cpu", "cuda"):
                to = lambda t: t.to(dev)
                batch = stores[dev].gather(idxs, frames, aug)
                t0 = time.perf_counter()
                m = train_step(states[dev], batch, mode, frames, pregathered=True,
                               noise={k2: to(v) for k2, v in noise.items()},
                               drop={s2: [tuple(None if x is None else to(x) for x in blk)
                                          for blk in v] for s2, v in drop.items()})
                row[dev] = {k2: v.item() for k2, v in m.items()}
                seconds[dev] += time.perf_counter() - t0
            for key, want in row["cpu"].items():
                got = row["cuda"][key]
                if abs(got - want) > TRAIN_PARITY_RTOL * abs(want):
                    raise AssertionError(f"train parity step {k + 1} ({mode}): {key} {got} on the "
                                         f"card, {want} on the CPU")
            log(f"train parity step {k + 1} ({mode}): card {json.dumps(row['cuda'])}, "
                f"CPU {json.dumps(row['cpu'])}")
            steps.append(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    cpu_params = dict(policies["cpu"].mar.named_parameters())
    max_diff = max((p.detach().cpu() - cpu_params[n].detach()).abs().max().item()
                   for n, p in policies["cuda"].mar.named_parameters())
    log(f"train parity: largest parameter difference after step {len(steps)}: {max_diff:.3e}; "
        f"CPU {seconds['cpu']:.1f}s, card {seconds['cuda']:.1f}s for {len(steps)} steps")
    return {"depth": [c.encoder_depth, c.decoder_depth], "steps": steps,
            "max_param_diff": max_diff, "cpu_s": seconds["cpu"], "card_s": seconds["cuda"]}


def train_overfit(trainer) -> dict:
    """OVERFIT_STEPS bf16 steps on one fixed batch of the recipe's B with fixed
    noise, in full_dynamic_model mode, warmup OVERFIT_WARMUP: the last loss
    must fall below OVERFIT_FRACTION of the first."""
    from unified_video_action_tpu_torch.training.ema import EmaConfig
    from unified_video_action_tpu_torch.training.train_state import create_train_state, train_step
    from unified_video_action_tpu_torch.training.workspace import build_policy
    from unified_video_action_tpu_torch.utils.frames import select_frame_indices

    cfg = train_config()
    policy = build_policy(cfg, torch.device("cuda"))
    policy.init_params(SEED)
    policy.set_normalizer(trainer.normalizer)
    state = create_train_state(policy, EmaConfig(), learning_rate=1e-4, weight_decay=0.02,
                               betas=(0.9, 0.95), warmup_steps=OVERFIT_WARMUP,
                               total_steps=OVERFIT_STEPS)
    B = trainer.batch_size
    frames = select_frame_indices(trainer.data.horizon, eval=False)
    batch = trainer.data.gather(np.arange(B), frames, trainer.draw_aug(B))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    noise = policy.sample_train_noise(B, gen)
    losses = [train_step(state, batch, "full_dynamic_model", frames, noise=noise, generator=gen,
                         pregathered=True)["train_loss"] for _ in range(OVERFIT_STEPS)]
    losses = [x.item() for x in losses]
    ratio = losses[-1] / losses[0]
    log(f"train overfit: loss {losses[0]:.5f} at step 1, {losses[-1]:.5f} at step {OVERFIT_STEPS} "
        f"({ratio:.4f} of the first; must be below {OVERFIT_FRACTION}); every step: "
        f"{json.dumps([round(x, 5) for x in losses])}")
    if not all(np.isfinite(losses)) or ratio >= OVERFIT_FRACTION:
        raise AssertionError(f"the overfit run's loss went from {losses[0]} to {losses[-1]}")
    return {"first": losses[0], "last": losses[-1], "ratio": ratio}


def phase_train(attention_ops, int8_ops) -> dict:
    """The flagship's training step at full width on the card (train_torch.py's
    Trainer): the store, fp32 parity with the CPU, 30 bf16 steps at B = 32
    with the task mode drawn per step and no uva_* kernel launched, their
    time, memory and idle share, the overfit check, and the EMA weights
    served by the bf16 serving policy through the attention kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
    from unified_video_action_tpu_torch.training.train_state import train_step
    from unified_video_action_tpu_torch.training.workspace import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(train_config(), "cuda")
    c = trainer.policy.mar_cfg
    log(f"train build: {time.perf_counter() - t0:.1f}s; {c.encoder_depth}+{c.decoder_depth} blocks "
        f"of d={c.encoder_embed_dim}, {sum(p.numel() for p in trainer.policy.mar.parameters())} MAR "
        f"parameters, store {trainer.data.nbytes / 1e6:.1f} MB on the card ({len(trainer.data)} "
        f"windows of {trainer.dataset.replay_buffer.n_steps} steps), B={trainer.batch_size}, "
        f"{trainer.policy.dtype}, modes {trainer.policy.task_modes}")
    parity = train_parity(trainer)

    counters = (attention_ops.launch_count, attention_ops.instance_count, int8_ops.launch_count)
    for counter in counters:
        for k in counter:
            counter[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: v for counter in counters for k, v in counter.items()}
    if any(launches.values()):
        raise AssertionError(f"a uva_* kernel launched during training: {launches}")
    with open(os.path.join(TRAIN_OUT, "logs.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if state.step != TRAIN_EPOCHS * TRAIN_STEPS_PER_EPOCH or any(
            line["nonfinite_steps"] or not all(np.isfinite(line[k]) for k in (
                "train_loss", "diffusion_loss", "action_loss", "grad_norm")) for line in lines):
        raise AssertionError(f"the bf16 run: {state.step} steps, logs {lines}")
    log(f"train run: {state.step} bf16 steps in {run_s:.1f}s, every metric finite, 0 uva_* "
        f"launches; logs.jsonl: {json.dumps(lines)}")

    def steps(n):
        """n more of the run's steps, epoch after epoch."""
        while n:
            for mode, frames, batch in trainer.batches():
                yield lambda: train_step(state, batch, mode, frames, generator=trainer.generator,
                                         pregathered=True)
                n -= 1
                if not n:
                    return
            trainer.epoch += 1

    for step in steps(TRAIN_WARMUP_STEPS):
        step()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED_STEPS + 1)]
    events[0].record()
    for i, step in enumerate(steps(TRAIN_TIMED_STEPS)):
        step()
        events[i + 1].record()
    events[-1].synchronize()
    ms = statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(TRAIN_TIMED_STEPS))
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for step in steps(TRAIN_PROFILED_STEPS):
            step()
        end.record()
        end.synchronize()
    # the device's kernels, without the optimizer's annotation range, which
    # the profiler also puts on the device's timeline around its kernels
    annotation = lambda e: getattr(e, "is_user_annotation", False) or e.key.startswith("Optimizer.")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not annotation(e)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not annotation(e))
    covered, reach = 0.0, float("-inf")
    for a, b in spans:  # the union of the kernels' intervals
        covered += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    wall = start.elapsed_time(end)
    idle = (max(0.0, 1.0 - covered / 1e3 / wall) if covered > 0
            else "not measured (no device time profiled)")
    by_name = {}  # device ms by the kernel name's first 60 characters
    for e in kernels:
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + e.self_device_time_total / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    perf = {"ms_per_step": ms, "samples_per_s": trainer.batch_size * 1e3 / ms,
            "max_memory_allocated": peak, "profiled_steps": TRAIN_PROFILED_STEPS,
            "device_busy_ms": busy, "device_covered_ms": covered / 1e3, "profiled_wall_ms": wall,
            "device_idle_share": idle, "top_device_ms": top}
    log(f"train perf (B={trainer.batch_size}, {trainer.policy.dtype}, median of "
        f"{TRAIN_TIMED_STEPS} steps by CUDA events): {json.dumps(perf)}")

    serve = UnifiedVideoActionPolicy.from_cfg(trainer.cfg, device="cuda")
    serve.load_params(state.ema_tree(), convert.load_flat_npz(VAE_NPZ))
    serve.set_normalizer(trainer.normalizer)
    lo, hi = (trainer.normalizer["action"].input_stats[k] for k in ("min", "max"))
    handoff = {}
    for B in (1, trainer.batch_size):
        for k in attention_ops.launch_count:
            attention_ops.launch_count[k] = 0
        frames = trainer.data.img[torch.arange(4 * B, device="cuda")].permute(0, 3, 1, 2)
        actions = serve.predict_action_frames(frames.reshape(B, 4, *frames.shape[1:]),
                                              generator=torch.Generator(device="cuda").manual_seed(B))
        a = actions.cpu().numpy()
        want = attention_launches_per_request(attention_ops, c, B, serve.dtype)
        if (a.shape != (B, 16, 2) or not np.isfinite(a).all() or (a < lo - 1e-3).any()
                or (a > hi + 1e-3).any()):
            raise AssertionError(f"the EMA weights served {a.shape} actions in "
                                 f"[{a.min()}, {a.max()}], the range is [{lo}, {hi}]")
        if dict(attention_ops.launch_count) != want:
            raise AssertionError(f"serving the EMA weights at B={B} launched "
                                 f"{dict(attention_ops.launch_count)}, want {want}")
        handoff[f"B={B}"] = {"launches": dict(attention_ops.launch_count),
                             "range": [float(a.min()), float(a.max())]}
    log(f"train handoff: the EMA weights served in bf16 through the attention kernel: "
        f"{json.dumps(handoff)}")
    del serve
    overfit = train_overfit(trainer)
    return {"parity": parity, "perf": perf, "handoff": handoff, "overfit": overfit, "run_s": run_s}


# the train_run phase: the flagship's two-stage recipe (scripts/round4b_train.sh)
# on the committed corpus, cut to a few steps an epoch
CORPUS = os.path.join(REPO, "corpora", "pusht_demos_r5b.npz")
CORPUS_EPISODES, CORPUS_STEPS = 300, 74256
RUN_OUT = os.path.join(REPO, "build", "train_run")
RUN_STEPS = 4  # capped steps an epoch (8 before the UMI phases joined)
RUN_VAL_STEPS = 2
RUN_TEST_SEEDS, RUN_MAX_STEPS = 4, 16  # the rollout: test seeds from 100000, env steps (24 before)
RUN_TIMED_STEPS, RUN_WARMUP_STEPS = 8, 2


def train_run_config(stage: int, *overrides: str) -> dict:
    """Stage 1 (video_model, no action head) or stage 2 (the flagship's
    policy_model_full_dynamics_model from stage 1's latest) of the recipe, on
    the corpus, with the smoke's cuts."""
    from unified_video_action_tpu_torch.config import apply_overrides

    with open(os.path.join(LATEST, "meta.json")) as f:
        cfg = json.load(f)["cfg"]
    amp = "model.policy.autoregressive_model_params"
    stage_keys = {
        1: ["model.policy.selected_training_mode=video_model",
            "model.policy.action_model_params.predict_action=false", f"{amp}.pretrained_model_path=null",
            "training.rollout_every=1000", "training.sample_every=1", "training.num_epochs=1"],
        2: ["model.policy.selected_training_mode=policy_model_full_dynamics_model",
            "model.policy.action_model_params.predict_action=true",
            f"{amp}.pretrained_model_path={RUN_OUT}/stage1/checkpoints/latest",
            "training.rollout_every=1", "training.val_every=1", "training.num_epochs=2",
            f"training.max_val_steps={RUN_VAL_STEPS}", "checkpoint.topk.k=2",
            "task.env_runner.n_train=0", f"task.env_runner.n_test={RUN_TEST_SEEDS}",
            f"task.env_runner.max_steps={RUN_MAX_STEPS}"],
    }[stage]
    apply_overrides(cfg, [f"task.dataset.dataset_path={CORPUS}", f"training.seed={SEED}",
                          f"training.max_train_steps={RUN_STEPS}", "training.checkpoint_every=1",
                          f"model.policy.vae_model_params.autoencoder_path={VAE_NPZ}",
                          f"output_dir={RUN_OUT}/stage{stage}", *stage_keys, *overrides])
    return cfg


def counted(trainer, attention_ops, int8_ops, record: dict) -> None:
    """Wrap the trainer's train_epoch, validate and rollout so that each
    call's kernel launches land in record[name] (a list of (launches, info)),
    the counters set to 0 just before it and read just after."""
    counters = (attention_ops.launch_count, attention_ops.instance_count, int8_ops.launch_count)

    def wrap(name, fn, info):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            for counter in counters:
                for k in counter:
                    counter[k] = 0
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record.setdefault(name, []).append(
                ({k: v for counter in counters for k, v in counter.items()}, info(out)))
            return out
        return run

    val_batches = lambda n: [min(trainer.batch_size, len(trainer.val_data) - s)
                             for s in range(0, len(trainer.val_data), trainer.batch_size)][:n]
    trainer.train_epoch = wrap("train", trainer.train_epoch, lambda steps: {"steps": len(steps)})
    trainer.validate = wrap("validate", trainer.validate, lambda l2: {
        "batches": [] if l2 is None else val_batches(trainer.max_val_steps)})
    # the sample_every hook: test_video_fvd over 4 validation batches, one round each
    trainer.video_fvd = wrap("video_fvd", trainer.video_fvd,
                             lambda metrics: {"batches": val_batches(4), "metrics": metrics})
    trainer.rollout = wrap("rollout", trainer.rollout, lambda log: {
        "calls": int(trainer.env_runner.timing["dispatches"]),
        "batch": RUN_TEST_SEEDS, "wall_s": trainer.env_runner.timing["wall_s"]})


def want_serving_launches(attention_ops, cfg, batches) -> dict:
    """The attention launches of one predict call at each batch size of
    ``batches``, summed (by kernel and by instance)."""
    want = {}
    for B in batches:
        for per_call in (attention_launches_per_request(attention_ops, cfg, B, torch.bfloat16),
                         attention_instances_per_request(attention_ops, cfg, B, torch.bfloat16)):
            for k, n in per_call.items():
                want[k] = want.get(k, 0) + n
    return want


def check_counted(record: dict, attention_ops, cfg) -> dict:
    """The training steps launched no uva_* kernel; every validation and
    rollout call, and every MaskGIT round of the video FVD, launched the
    attention kernel its plan names once per ViT block and nothing else.
    Returns the launches of validation, rollouts and the FVD summed, by
    kernel."""
    totals = {"validate": {}, "rollout": {}, "video_fvd": {}}
    for name, calls in record.items():
        for launches, info in calls:
            if name == "train":
                want = {k: 0 for k in launches}
            elif name in ("validate", "video_fvd"):
                want = want_serving_launches(attention_ops, cfg, info["batches"])
            else:
                want = want_serving_launches(attention_ops, cfg, [info["batch"]] * info["calls"])
            want = {k: want.get(k, 0) for k in launches}
            if launches != want:
                raise AssertionError(f"train_run {name} ({info}): launches {launches}, want {want}")
            if name != "train":
                for k, n in launches.items():
                    totals[name][k] = totals[name].get(k, 0) + n
    return totals


def same_state(a, b) -> list:
    """What differs between two TrainStates bit for bit (parameters, EMA,
    AdamW moments and step counts, the scheduler's step, the step)."""
    diffs = []
    pa, pb = dict(a.mar.named_parameters()), dict(b.mar.named_parameters())
    for n in pa:
        if not torch.equal(pa[n], pb[n]):
            diffs.append(f"param {n}")
        if not torch.equal(a.ema[n], b.ema[n]):
            diffs.append(f"ema {n}")
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    if sa.keys() != sb.keys():
        diffs.append("optimizer state keys")
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            if not torch.equal(sa[i][k], sb[i][k]):
                diffs.append(f"optimizer {i} {k}")
    if a.scheduler.last_epoch != b.scheduler.last_epoch:
        diffs.append(f"scheduler {a.scheduler.last_epoch} vs {b.scheduler.last_epoch}")
    if a.step != b.step:
        diffs.append(f"step {a.step} vs {b.step}")
    return diffs


class Tee(io.TextIOBase):
    """Writes to every stream it is given."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self) -> None:
        for stream in self.streams:
            stream.flush()


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def phase_train_run(attention_ops, int8_ops, dataset) -> dict:
    """The flagship's recipe on the committed corpus (train_torch.py's
    Trainer at full width): stage 1 (video_model) for RUN_STEPS steps with a
    checkpoint; stage 2 bootstrapped from it through pretrained_model_path
    for two capped epochs with validation, rollouts of the EMA policy through
    the attention kernel, top-k and latest checkpoints; the video FVD of
    ``sample_every`` in stage 1 (its top-k by video_fvd_vae, as
    train_torch.py switches it) and in stage 2's first epoch; a resumed trainer
    bit-equal to the first in memory, then one more epoch; its slim export
    served through eval_sim_torch.py's loading path bit-equal to the EMA in
    memory. Then the times and sizes of a checkpoint's save and load and of
    the export, and ms per step on the corpus."""
    import shutil

    sys.path.insert(0, REPO)
    import eval_sim_torch
    from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
    from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
    from unified_video_action_tpu_torch.training import checkpoint as ckpt_lib
    from unified_video_action_tpu_torch.training.train_state import train_step
    from unified_video_action_tpu_torch.training.workspace import Trainer
    from train_torch import video_monitor

    t_phase = time.perf_counter()
    shutil.rmtree(RUN_OUT, ignore_errors=True)
    try:
        # 1. the corpus
        t0 = time.perf_counter()
        rb = ReplayBuffer.load(CORPUS)
        load_s = time.perf_counter() - t0
        if (rb.n_episodes, rb.n_steps) != (CORPUS_EPISODES, CORPUS_STEPS):
            raise AssertionError(f"the corpus holds {rb.n_episodes} episodes of {rb.n_steps} steps, "
                                 f"want {CORPUS_EPISODES} and {CORPUS_STEPS}")
        del rb
        t0 = time.perf_counter()
        stage1 = Trainer(video_monitor(train_run_config(1)), "cuda", dataset=dataset)
        log(f"train_run corpus: {CORPUS_EPISODES} episodes, {CORPUS_STEPS} steps, read by numpy in "
            f"{load_s:.1f}s; {len(stage1.data)} training windows, {len(stage1.val_data)} validation "
            f"windows of episodes {np.flatnonzero(dataset.val_mask).tolist()}; store "
            f"{stage1.data.nbytes} bytes on the card; stage 1 built in {time.perf_counter() - t0:.1f}s")

        # 2. stage 1
        record: dict = {}
        counted(stage1, attention_ops, int8_ops, record)
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            stage1.run()
        latest1 = os.path.join(RUN_OUT, "stage1", "checkpoints", "latest")
        missing = [n for n in ("meta.json", "normalizer.npz", ckpt_lib.PAYLOAD)
                   if not os.path.isfile(os.path.join(latest1, n))]
        if missing or stage1.state.step != RUN_STEPS:
            raise AssertionError(f"stage 1: {stage1.state.step} steps, latest lacks {missing}")
        # the sample_every hook fired: the video FVD logged, never skipped,
        # and the top-k kept by it
        with open(os.path.join(RUN_OUT, "stage1", "logs.jsonl")) as f:
            lines1 = [json.loads(line) for line in f]
        ckpts1 = sorted(os.listdir(os.path.join(RUN_OUT, "stage1", "checkpoints")))
        fvd_keys = ("video_fvd_vae", "video_fvd_pixel")
        if ("[fvd] skipped" in printed.getvalue()
                or not all(k in l and np.isfinite(l[k]) for l in lines1 for k in fvd_keys)
                or not any(c.startswith("epoch=0000-video_fvd_vae=") for c in ckpts1)
                or stage1.topk.monitor_key != "video_fvd_vae" or stage1.topk.mode != "min"):
            raise AssertionError(f"stage 1's video FVD: logs {lines1}; checkpoints {ckpts1}; "
                                 f"top-k by {stage1.topk.monitor_key} ({stage1.topk.mode})")
        log(f"train_run stage 1: video FVD {json.dumps({k: lines1[-1][k] for k in fvd_keys})}; "
            f"checkpoints {ckpts1} (top-k by video_fvd_vae, min)")
        stage1_leaves = set(torch.load(os.path.join(latest1, ckpt_lib.PAYLOAD), map_location="cpu",
                                       weights_only=True, mmap=True)["ema"])
        del stage1
        torch.cuda.empty_cache()

        # 3. stage 2 from stage 1's latest
        t0 = time.perf_counter()
        cfg2 = train_run_config(2)
        stage2 = Trainer(cfg2, "cuda", dataset=dataset)
        from unified_video_action_tpu_torch import convert
        stage2_leaves = {"/".join(p) for p in convert.flax_layout_shapes(stage2.state.mar)}
        kept = stage2.policy._last_mar_import_kept_at_init
        new = stage2_leaves - stage1_leaves
        if kept != len(new) or stage2.policy._last_mar_import_skipped != 0 or not new:
            raise AssertionError(f"bootstrap: {kept} leaves kept at init and "
                                 f"{stage2.policy._last_mar_import_skipped} skipped; stage 2 has "
                                 f"{len(new)} leaves that stage 1 lacks")
        log(f"train_run bootstrap: {kept} leaves kept at init = the {len(new)} leaves stage 2 has and "
            f"stage 1 lacks (under {sorted({k.split('/')[0] for k in new})}); built in "
            f"{time.perf_counter() - t0:.1f}s")
        counted(stage2, attention_ops, int8_ops, record)
        stage2.run()
        with open(os.path.join(cfg2["output_dir"], "logs.jsonl")) as f:
            lines = [json.loads(line) for line in f]
        with open(os.path.join(cfg2["output_dir"], "tracker", "metrics.jsonl")) as f:
            tracked = [json.loads(line) for line in f]
        numbers = [v for line in lines for v in line.values() if isinstance(v, (int, float))]
        if (len(lines) != 2 or not all(np.isfinite(numbers))
                or any("val_action_l2_distances" not in l or "test_mean_score" not in l for l in lines)
                or [l["_step"] for l in lines] != [l["_step"] for l in tracked]):
            raise AssertionError(f"stage 2 logs {lines}; tracker {tracked}")
        ckpts = sorted(os.listdir(os.path.join(cfg2["output_dir"], "checkpoints")))
        if "latest" not in ckpts or len([c for c in ckpts if c.startswith("epoch=")]) != 2:
            raise AssertionError(f"stage 2 checkpoints: {ckpts}")
        log(f"train_run stage 2: logs.jsonl {json.dumps(lines)}; checkpoints {ckpts}")

        # 4. resume
        stage3 = Trainer(dict(cfg2, training=dict(cfg2["training"], resume=True)), "cuda",
                         dataset=dataset)
        t0 = time.perf_counter()
        restored = stage3.restore()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if not restored:
            raise AssertionError("the resumed trainer found no checkpoint")
        diffs = same_state(stage3.state, stage2.state)
        if diffs or stage3.epoch != stage2.epoch - 1:
            raise AssertionError(f"resume: epoch {stage3.epoch} (want {stage2.epoch - 1}); "
                                 f"differs: {diffs[:10]}")
        log(f"train_run resume: parameters, EMA, AdamW moments, scheduler step {stage3.state.scheduler.last_epoch}"
            f" and step {stage3.state.step} bit-equal to the first trainer; epoch {stage3.epoch}")
        del stage2
        torch.cuda.empty_cache()
        counted(stage3, attention_ops, int8_ops, record)
        export_s = []
        export_fn = stage3.export

        def timed_export(*args):
            t0 = time.perf_counter()
            out = export_fn(*args)
            export_s.append(time.perf_counter() - t0)
            return out

        stage3.export = timed_export
        stage3.run()
        launches = check_counted(record, attention_ops, stage3.policy.mar_cfg)
        log(f"train_run launches: training steps {[c[0] for c in record['train']]} (0 uva_* "
            f"launches); validation {launches['validate']}; rollouts {launches['rollout']} over "
            f"{sum(i['calls'] for _, i in record['rollout'])} policy calls; video FVD "
            f"{launches['video_fvd']} over {len(record.get('video_fvd', []))} calls")
        if len(record.get("video_fvd", [])) != 2:  # stage 1's epoch and stage 2's first
            raise AssertionError(f"train_run: {len(record.get('video_fvd', []))} video FVD calls, "
                                 f"want 2")

        # 5. the export served as eval_sim_torch.py serves it
        export = os.path.join(cfg2["output_dir"], "export")
        with open(os.path.join(export, "meta.json")) as f:
            meta = json.load(f)
        served = UnifiedVideoActionPolicy.from_cfg(meta["cfg"], device="cuda")
        served.load_params(*eval_sim_torch.load_weights(export))
        served.set_normalizer(LinearNormalizer.load(os.path.join(export, "normalizer.npz")))
        memory = stage3.serving_policy()
        handoff = {}
        for B in (1, stage3.batch_size):
            frames = stage3.data.img[torch.arange(4 * B, device="cuda")].permute(0, 3, 1, 2)
            frames = frames.reshape(B, 4, *frames.shape[1:])
            noise = memory.sample_noise(B, torch.Generator(device="cuda").manual_seed(B))
            got = served.predict_action_frames(frames, noise=noise)
            want = memory.predict_action_frames(frames, noise=noise)
            check_actions(served, got, B)
            if not torch.equal(got, want):
                raise AssertionError(f"the export served at B={B} differs from the EMA in memory by "
                                     f"{(got - want).abs().max().item()}")
            handoff[f"B={B}"] = [float(got.min()), float(got.max())]
        log(f"train_run export ({meta['export_dtype']}) served through eval_sim_torch.load_weights: "
            f"actions bit-equal to the EMA in memory, range {json.dumps(handoff)}")

        # 6. measurements: a blocking save; the resumed trainer's load and
        # its run's export, timed above
        timed = os.path.join(RUN_OUT, "timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage3.save(timed, stage3.epoch - 1)
        save_s = time.perf_counter() - t0
        state = stage3.state
        steps = []
        while len(steps) < RUN_TIMED_STEPS + RUN_WARMUP_STEPS:
            for mode, frames, batch in stage3.batches():
                steps.append((mode, frames, batch))
                if len(steps) == RUN_TIMED_STEPS + RUN_WARMUP_STEPS:
                    break
            stage3.epoch += 1
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
        events[0].record()
        for i, (mode, frames, batch) in enumerate(steps):
            train_step(state, batch, mode, frames, generator=stage3.generator, pregathered=True)
            events[i + 1].record()
        events[-1].synchronize()
        ms = statistics.median(events[i].elapsed_time(events[i + 1])
                               for i in range(RUN_WARMUP_STEPS, len(steps)))
        perf = {
            "checkpoint_save_s": save_s, "checkpoint_load_s": load_s, "export_s": export_s[0],
            "checkpoint_bytes": dir_bytes(timed), "export_bytes": dir_bytes(export),
            "export_dtype": meta["export_dtype"], "store_bytes": stage3.data.nbytes,
            "training_windows": len(stage3.data), "validation_windows": len(stage3.val_data),
            "ms_per_step": ms, "batch": stage3.batch_size,
            "rollout_wall_s": [i["wall_s"] for _, i in record["rollout"]],
            "rollout_calls": [i["calls"] for _, i in record["rollout"]],
            "phase_s": time.perf_counter() - t_phase, "card": card_line(),
        }
        log(f"train_run perf: {json.dumps(perf)}")
        return {"perf": perf, "launches": launches}
    finally:
        ckpt_lib.wait_for_checkpoints()
        shutil.rmtree(RUN_OUT, ignore_errors=True)


# ----------------------------------- PushT from the scripted expert to a recorded rollout

# pusht_pipeline: the port's expert writing demos, uva_pusht.yaml's recipe
# (config.PUSHT_256_RUN) on the host loader with the host augmentation, and a
# recorded env
PIPE_OUT = os.path.join(REPO, "build", "pusht_pipeline")
PIPE_SEED0, PIPE_TRIES = 20000, 4  # expert episodes tried (of up to 300 steps at 96 px)
PIPE_STEPS, PIPE_TIMED_FROM = 4, 1  # bf16 steps at the recipe's B = 16; the first warms up
PIPE_VIDEO_STEPS = 6  # recorded env steps


def gif_blocks(path: str) -> tuple:
    """(header, number of images, the bytes from the trailer on) of a GIF,
    walking its blocks."""
    with open(path, "rb") as f:
        data = f.read()
    flags = data[10]
    i = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    n = 0
    while i < len(data) and data[i] != 0x3B:
        if data[i] == 0x21:  # an extension: its label, then its sub-blocks
            i += 2
        elif data[i] == 0x2C:  # an image: its descriptor, local table and LZW code size
            flags = data[i + 9]
            i += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0) + 1
            n += 1
        else:
            raise AssertionError(f"{path}: block {data[i]:#x} at byte {i}")
        while data[i]:
            i += data[i] + 1
        i += 1
    return data[:6], n, data[i:]


def phase_pusht_pipeline(attention_ops, int8_ops, corpus) -> dict:
    """The PushT pipeline on the card's machine, each step failing the phase
    where it fails: (a) tools/gen_pusht_demos.py's generate tries PIPE_TRIES
    episodes of the port's expert from env seed PIPE_SEED0 and writes the
    kept ones (reward >= 0.9) as an .npz, which PushTImageDataset loads with
    the host augmentation; (b) train_torch.py's Trainer on
    config.PUSHT_256_RUN (uva_pusht.yaml: mar_base at 256 px, B = 16,
    data_aug) through the host loader with task.dataset.device_aug=false (the
    loader's 8 threads crop, resize and blur each clip) on the committed
    corpus: PIPE_STEPS bf16 steps with every metric finite and no uva_*
    kernel launched, each step's time by CUDA events and its wait for the
    loader on the host clock, peak memory; then one validation reading
    whose predict call launches the online kernel's D = 64 instance once per
    ViT block; (c) a PushTEnv(render_action=True) in VideoRecordingWrapper
    for PIPE_VIDEO_STEPS steps: the GIF's header, frame count and trailer.
    Returns the phase's numbers and the validation's launches."""
    from unified_video_action_tpu_torch import config as port_config
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.config import apply_overrides
    from unified_video_action_tpu_torch.data.loader import collate
    from unified_video_action_tpu_torch.data.pusht_dataset import PushTImageDataset
    from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
    from unified_video_action_tpu_torch.envs.pusht import PushTEnv
    from unified_video_action_tpu_torch.envs.video_recording import VideoRecorder, VideoRecordingWrapper
    from unified_video_action_tpu_torch.tools.gen_pusht_demos import generate
    from unified_video_action_tpu_torch.training.train_state import train_step
    from unified_video_action_tpu_torch.training.workspace import Trainer

    shutil.rmtree(PIPE_OUT, ignore_errors=True)
    perf = {"card": card_line()}

    # (a) the expert's demos, then the .npz as a dataset with the host augmentation
    demos = os.path.join(PIPE_OUT, "demos.npz")
    meta = generate(demos, episodes=PIPE_TRIES, seed0=PIPE_SEED0, max_tries=PIPE_TRIES,
                    log=lambda m: log(f"pusht_pipeline demos: {m}"))
    kept = ReplayBuffer.load(demos)
    log(f"pusht_pipeline demos: {meta['episodes']} of {meta['tried']} episodes kept "
        f"({kept.n_steps} steps), max rewards {json.dumps(meta['tried_rewards'])}, "
        f"{meta['seconds']:.1f}s")
    if meta["tried"] != PIPE_TRIES or kept.n_episodes != meta["episodes"] or not meta["episodes"]:
        raise AssertionError(f"pusht_pipeline demos: {meta}, {kept.n_episodes} episodes in {demos}")
    ds = PushTImageDataset(demos, horizon=32, pad_before=1, pad_after=7, data_aug=True,
                           device_aug=False)
    item = collate([ds[0], ds[len(ds) - 1]])
    if item["obs"]["image"].shape != (2, 32, 3, 96, 96) or item["obs"]["image"].dtype != np.uint8:
        raise AssertionError(f"pusht_pipeline: the demos' items are {item['obs']['image'].shape}")
    perf["demos"] = {k: meta[k] for k in ("episodes", "tried", "steps", "tried_rewards", "seconds")}

    # (b) the recipe on the host loader: the corpus read once for the
    # flagship's phases shares its replay buffer (the same dataset keys)
    cfg = copy.deepcopy(port_config.PUSHT_256_RUN)
    apply_overrides(cfg, [f"training.seed={SEED}", "task.dataset.device_aug=false",
                          f"task.dataset.dataset_path={CORPUS}", "training.num_epochs=1",
                          f"training.max_train_steps={PIPE_STEPS}", "training.max_val_steps=1",
                          "training.checkpoint_every=0", f"output_dir={PIPE_OUT}/run"])
    dataset = copy.copy(corpus)
    dataset.data_aug, dataset.device_aug = True, False
    t0 = time.perf_counter()
    trainer = Trainer(cfg, "cuda", dataset=dataset)
    policy = trainer.policy
    c = policy.mar_cfg
    # the KL-16 VAE's kl16.ckpt is absent: a numpy-seeded ch-128 VAE
    load_vae(policy, convert.seeded_tree(policy.vae, SEED + 1))
    log(f"pusht_pipeline: trainer built in {time.perf_counter() - t0:.1f}s: {c.encoder_depth}+"
        f"{c.decoder_depth} blocks of d={c.encoder_embed_dim}, {c.attention_tokens} tokens, "
        f"B={trainer.batch_size}, {policy.dtype}, host loader {trainer.host_loader} with "
        f"{trainer.loader.num_workers} workers, data_aug {trainer.dataset.data_aug}, device_aug "
        f"{trainer.dataset.device_aug}; {len(trainer.dataset)} training windows")
    if not (trainer.host_loader and trainer.batch_size == 16 and c.attention_tokens == 1024):
        raise AssertionError("pusht_pipeline: not uva_pusht.yaml's recipe on the host loader")
    for counter in (attention_ops.launch_count, int8_ops.launch_count):
        for k in counter:
            counter[k] = 0
    torch.cuda.reset_peak_memory_stats()
    state, metrics, events, waits = trainer.state, [], [], []
    batches = trainer.batches()
    t0 = time.perf_counter()
    for i in range(PIPE_STEPS):
        tw = time.perf_counter()
        mode, frames, batch = next(batches)
        waits.append(time.perf_counter() - tw)
        if "aug_top" in batch["obs"]:
            raise AssertionError("pusht_pipeline: the device augmentation's draws in a host-augmented batch")
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        metrics.append(train_step(state, batch, mode, frames, generator=trainer.generator,
                                  pregathered=True))
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    events.append(end)
    batches.close()
    steps_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(len(events) - 1)]
    launched = {k: v for k, v in {**attention_ops.launch_count, **int8_ops.launch_count}.items() if v}
    values = [{k: v.item() for k, v in m.items()} for m in metrics]
    log(f"pusht_pipeline: {len(values)} bf16 steps at B={trainer.batch_size} in {steps_s:.1f}s; "
        f"step ms {json.dumps(step_ms)}; loader wait s {json.dumps(waits)}; losses "
        f"{json.dumps(values)}; uva_* launches {launched}")
    if launched or not all(np.isfinite(list(v.values())).all() for v in values):
        raise AssertionError(f"pusht_pipeline: launches {launched}, metrics {values}")
    for counter in (attention_ops.launch_count, attention_ops.instance_count):
        for k in counter:
            counter[k] = 0
    t0 = time.perf_counter()
    val = trainer.validate()
    val_s = time.perf_counter() - t0
    val_launches = {**attention_ops.launch_count, **attention_ops.instance_count}
    plan = attention_plan_of(attention_ops, c, trainer.batch_size, torch.bfloat16)
    blocks = c.encoder_depth + c.decoder_depth
    log(f"pusht_pipeline validation: val_action_l2_distances {val} in {val_s:.1f}s; launches "
        f"{json.dumps({k: v for k, v in val_launches.items() if v})}")
    if (val is None or not np.isfinite(val) or plan.instance != "attention_wgmma_online_d64"
            or val_launches[plan.instance] != blocks
            or sum(val_launches[k] for k in attention_ops.launch_count) != blocks):
        raise AssertionError(f"pusht_pipeline validation: {val}, plan {plan.instance}, launches "
                             f"{val_launches}")
    timed = step_ms[PIPE_TIMED_FROM:]
    perf["train"] = {"ms_per_step": statistics.median(timed), "step_ms": step_ms,
                     "loader_wait_s": waits, "loader_wait_s_median": statistics.median(waits[PIPE_TIMED_FROM:]),
                     "samples_per_s": trainer.batch_size / (statistics.median(timed) / 1e3),
                     "peak_mem_gb": peak / 1e9, "B": trainer.batch_size,
                     "val_action_l2_distances": val, "val_s": val_s, "host_rss": host_rss()}
    del trainer, state, policy

    # (c) a recorded env: the action marker in every frame after the first
    path = os.path.join(PIPE_OUT, "video", "pusht.mp4")
    env = VideoRecordingWrapper(PushTEnv(render_action=True), VideoRecorder(fps=10), file_path=path)
    env.seed(SEED)
    env.reset()
    t0 = time.perf_counter()
    for a in np.random.default_rng(SEED + 30).uniform(50, 450, (PIPE_VIDEO_STEPS, 2)):
        env.step(a)
        if not (env.render() == (255, 0, 0)).all(-1).any():
            raise AssertionError("pusht_pipeline: a frame without the action marker")
    written = env.stop_recording()
    video_s = time.perf_counter() - t0
    head, n, tail = gif_blocks(written)
    log(f"pusht_pipeline video: {written}: {head}, {n} images, trailer {tail!r}, "
        f"{os.path.getsize(written)} bytes, {video_s:.2f}s for {PIPE_VIDEO_STEPS} steps")
    if written != os.path.splitext(path)[0] + ".gif" or head != b"GIF89a" or n != PIPE_VIDEO_STEPS + 1 \
            or tail != b"\x3b":
        raise AssertionError(f"pusht_pipeline video: {written}, {head}, {n} images, {tail!r}")
    perf["video"] = {"frames": n, "bytes": os.path.getsize(written), "s": video_s}
    log(f"pusht_pipeline perf: {json.dumps(perf)}")
    shutil.rmtree(PIPE_OUT, ignore_errors=True)
    return {"perf": perf, "launches_validate": val_launches}


# ------------------------------------- UMI and toolhang: the conditioning streams

# the UMI multi-task model (config.UMI_MULTI: mar_base at 256 px, 1024 frame
# tokens and the 64-token text buffer, N = 1088, the online kernel with a
# 64-row last KV tile) and the toolhang model (config.TOOLHANG: N = 1024, the
# second camera and the 9-d state)
UMI_BATCHES, UMI_ROUTE_BATCH = (1, 32), 8
TOOLHANG_BATCHES, TOOLHANG_ROUTE_BATCH = (1, 8), 8
UMI_PROMPT = "pick up the cup and place it on the saucer"
# N = 1088 is a multiple of the serve controls' 64-row KV tile, so the
# unmasked_kv_edge control plants no fault on this path (it gave the kernel
# route's readings to the digit on the card); the kernel phase holds the
# online kernel's 128-row KV edge at N = 1088 (64 rows) with that control
REJECTED_CONTROLS_UMI = ("exp_base_2", "scale_x1.1")


def umi_obs(B: int, rng) -> dict:
    """A 16-step UMI observation window as the robot's controller sends it
    (``eval_real.py``): 224 px frames, the relative-pose state keys and the
    past actions."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"camera0_rgb": rng.integers(0, 256, (B, 16, 3, 224, 224), dtype=np.uint8),
            "robot0_eef_pos": 0.1 * f(B, 16, 3), "robot0_eef_rot_axis_angle": f(B, 16, 6),
            "robot0_gripper_width": rng.uniform(size=(B, 16, 1)).astype(np.float32),
            "robot0_eef_rot_axis_angle_wrt_start": f(B, 16, 6), "past_action": 0.1 * f(B, 16, 10)}


def toolhang_obs(B: int, rng) -> dict:
    """A 16-step toolhang window: both 240 px cameras and the 9-d state."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"sideview_image": rng.integers(0, 256, (B, 16, 3, 240, 240), dtype=np.uint8),
            "robot0_eye_in_hand_image": rng.integers(0, 256, (B, 16, 3, 240, 240), dtype=np.uint8),
            "robot0_eef_pos": f(B, 16, 3), "robot0_eef_quat": f(B, 16, 4),
            "robot0_gripper_qpos": f(B, 16, 2)}


def phase_serve_streams(attention_ops, name: str, run_cfg: dict, batches, route_batch, make_obs,
                        rejected, goal=None) -> tuple:
    """A model with conditioning streams at full width (``run_cfg``:
    config.UMI_MULTI or config.TOOLHANG; numpy-seeded MAR, denoiser and
    ch-128 VAE weights; bf16, 100 sampler steps) through the obs-dict
    predict_action (``goal``: precomputed language latents). Counted: one
    call at each of ``batches``, each launching the instance attention_plan
    names (the online kernel at D = 64) once per ViT block and no other
    attention kernel. Then the kernel route against the plain route at
    ``route_batch`` with the serve limits and the controls ``rejected``,
    the streams fed to both; the card in fp32 against the port on the CPU
    in fp32 at B=1; request times. Returns the launches of the counted
    calls and those of the fp32 kernel in the fp32 call by path."""
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    def make_policy(device="cuda", dtype="bfloat16"):
        return UnifiedVideoActionPolicy.from_cfg(run_cfg, device=device, compute_dtype=dtype)

    policy = make_policy()
    c = policy.mar_cfg
    D = c.encoder_embed_dim // c.encoder_num_heads
    trees = (convert.seeded_tree(policy.mar, SEED), convert.seeded_tree(policy.vae, SEED + 1))
    policy.load_params(*trees)
    log(f"{name} policy: mar {c.encoder_depth}+{c.decoder_depth} blocks, d={c.encoder_embed_dim}, "
        f"{c.encoder_num_heads} heads of D={D}, {c.img_size}px, {c.total_tokens} frame tokens, "
        f"{c.attention_tokens} attended, {c.n_streams} streams (history {c.use_history_action}, "
        f"state {c.proprio_dim if c.use_proprioception else None}, second camera "
        f"{policy.encodes_second_camera}, text {c.has_text}), action dim {policy.action_dim}, "
        f"{policy.mar.diffactloss.num_steps} sampler steps, {policy.dtype}; MAR+heads "
        f"{sum(p.numel() for p in policy.mar.parameters()) / 1e6:.1f}M and VAE "
        f"{sum(p.numel() for p in policy.vae.parameters()) / 1e6:.1f}M numpy-seeded "
        f"(seeds {SEED}, {SEED + 1})")

    rng = np.random.default_rng(SEED + 60)
    sizes = sorted(set(batches) | {route_batch, 1})
    obs = {B: make_obs(B, rng) for B in sizes}
    noise = {B: policy.sample_noise(B, torch.Generator(device="cuda").manual_seed(SEED + 60 + B))
             for B in sizes}
    for B in batches:  # warm-up: not counted
        policy.predict_action(obs[B], noise=noise[B], language_goal=goal)
    torch.cuda.synchronize()

    # the path: every count set to 0 just before, read just after
    counters = (attention_ops.launch_count, attention_ops.instance_count)
    for counter in counters:
        for k in counter:
            counter[k] = 0

    def counts() -> dict:
        return {k: v for counter in counters for k, v in counter.items()}

    per_call = {}
    for B in batches:
        before = counts()
        res = policy.predict_action(obs[B], noise=noise[B], language_goal=goal)
        per_call[B] = {k: v - before[k] for k, v in counts().items()}
        if res["action"].shape != (B, policy.n_action_steps, policy.action_dim):
            raise AssertionError(f"{name}: action shape {res['action'].shape}")
        check_actions(policy, torch.from_numpy(res["action_pred"]), B)
    torch.cuda.synchronize()
    launches = counts()
    blocks = c.encoder_depth + c.decoder_depth
    for B in batches:
        plan = attention_plan_of(attention_ops, c, B, torch.bfloat16)
        want = {**attention_launches_per_request(attention_ops, c, B, torch.bfloat16),
                **attention_instances_per_request(attention_ops, c, B, torch.bfloat16)}
        log(f"{name} predict_action B={B}: plan {plan}, launches "
            f"{json.dumps({k: v for k, v in per_call[B].items() if v})}")
        if (per_call[B] != want or per_call[B][plan.instance] != blocks
                or plan.instance != f"attention_wgmma_online_d{D}"):
            raise AssertionError(f"{name} B={B}: launches {per_call[B]}, want {want} "
                                 f"({blocks} of attention_wgmma_online_d{D})")

    # the streams as predict_action_frames takes them, read from the windows
    inputs = {B: request_inputs(policy, obs[B], goal) for B in (route_batch, 1)}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy32 = make_policy(dtype="float32")
    policy32.load_params(*trees)
    rb = route_batch
    diffs = route_check(attention_ops, policy, policy32, {rb: inputs[rb][0]}, {rb: noise[rb]},
                        rejected, {rb: inputs[rb][2]}, {rb: inputs[rb][1]})
    f32_launches = fp32_card_vs_cpu(attention_ops, name, policy32, make_policy(device="cpu", dtype="float32"),
                                    trees, inputs[1], noise[1])
    del policy32

    # request times on the host clock, each until the action is on the host
    def request_ms(B: int, reps: int) -> float:
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            policy.predict_action(obs[B], noise=noise[B], language_goal=goal)
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    torch.cuda.reset_peak_memory_stats()
    big = max(batches)
    serve = {"p50_ms_b1": request_ms(1, REPS_B1), f"median_ms_b{big}": request_ms(big, REPS_LARGE)}
    serve.update({f"chunks_per_s_b{big}": big / (serve[f"median_ms_b{big}"] / 1e3),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "kernel_vs_plain": diffs,
                  "attention_instance": attention_plan_of(attention_ops, c, big, torch.bfloat16).instance,
                  "card": card_line()})
    log(f"{name} " + json.dumps(serve))
    return launches, {f"{name}_fp32_vs_cpu_b1": {f"attention_f32_d{D}": f32_launches}}


def request_inputs(policy, obs: dict, goal=None) -> tuple:
    """An obs-dict request as ``predict_action_frames`` takes it, made as
    ``predict_action_async`` makes it: the selected frames (float frames
    rounded to uint8), the streams (``history_actions``, ``proprio``) and
    the encoded goal."""
    from unified_video_action_tpu_torch.utils import image as image_util
    from unified_video_action_tpu_torch.utils.frames import select_frame_indices

    o = image_util.remap_image_keys(policy.task_name, obs)
    image = np.asarray(o["image"])
    idx = select_frame_indices(image.shape[1], policy.mar_cfg.n_frames)
    sel = image[:, idx]
    if sel.dtype != np.uint8:
        sel = np.round(sel * 255.0).astype(np.uint8)
    streams = {"history_actions": policy._history_actions(o),
               "proprio": policy._build_proprio_eval(o, idx)}
    return (torch.from_numpy(np.ascontiguousarray(sel)), streams,
            policy._encode_language_goal(goal, image.shape[0]))


def fp32_card_vs_cpu(attention_ops, name: str, policy32, cpu32, trees, inputs, noise) -> int:
    """The card in fp32 (``policy32``: the fp32 kernel at the model's D)
    against the port on the CPU in fp32 (``cpu32``, given ``trees``) on one
    request (``request_inputs``' tuple and its draws), normalized actions
    within SERVE_FP32_ATOL, the fp32 kernel once per ViT block. Returns its
    launches."""
    c = policy32.mar_cfg
    D = c.encoder_embed_dim // c.encoder_num_heads
    blocks = c.encoder_depth + c.decoder_depth
    cpu32.load_params(*trees)
    frames, streams, text = inputs
    cpu_noise = {k: v.cpu() for k, v in noise.items()}
    before = attention_ops.instance_count[f"attention_f32_d{D}"]
    on_card = policy32.predict_action_frames(frames, noise=cpu_noise, text_latents=text,
                                             **streams).cpu()
    f32_launches = attention_ops.instance_count[f"attention_f32_d{D}"] - before
    t0 = time.perf_counter()
    on_cpu = cpu32.predict_action_frames(frames, noise=cpu_noise,
                                         text_latents=None if text is None else text.cpu(), **streams)
    cpu_s = time.perf_counter() - t0
    d = (normalized(policy32, on_card) - normalized(policy32, on_cpu)).abs().max().item()
    log(f"{name} card fp32 ({f32_launches} launches of attention_f32_d{D}) vs CPU fp32 ({cpu_s:.1f}s), "
        f"B={frames.shape[0]}, normalized actions: max abs {d}; atol {SERVE_FP32_ATOL}")
    if d > SERVE_FP32_ATOL or f32_launches != blocks:
        raise AssertionError(f"{name}: the card's fp32 run disagrees with the CPU's ({d}) or did not "
                             f"launch the fp32 kernel once per block ({f32_launches})")
    return f32_launches


# real_loop: the real-robot deployment path (eval_real_torch.py's policy
# node, the UMI obs and action bridge, the shared-memory IPC) in a closed
# loop with the sim-backed UmiRealEnv
REAL_HZ = 10.0  # the control rate: the obs window's spacing and the actions'
REAL_HORIZON = 16  # the UMI window of umi_obs, for the frames and the state
REAL_CYCLES = 8  # requests in the loop (at least 8; 10 before the PushT pipeline)
REAL_RECORDED_CYCLE = 3  # the cycle whose request the route and fp32 checks replay
REAL_CAMERA = dict(px=224, fps=20.0, get_max_k=32)  # 32 frames cover the 1.5 s window
REAL_ARM = dict(hz=125.0, get_max_k=256)  # 2 s of state
REAL_GRIPPER = dict(hz=30.0, get_max_k=64)
REAL_INIT_POSE = (0.4, 0.0, 0.3, 0.0, 3.0, 0.0)
# the speed limits (m/s, rad/s) lie past the seeded policy's jumps (relative
# positions up to 1 m, any rotation), so each waypoint lands at its time
REAL_SPEED = 100.0
REAL_TAU = 0.02  # the sim arm's lag, s: 0.5 s settles a 1 m jump to 1e-9 m
REAL_SETTLE_S = 0.5
REAL_POSE_ATOL = 1e-3  # m and rad: the arm against its trajectory at the end
REAL_TASK = "cup"


def rotation_angle(a: np.ndarray, b: np.ndarray) -> float:
    """The angle (rad) between two axis-angle rotations."""
    from unified_video_action_tpu_torch.utils.rotation import axis_angle_to_matrix

    r = axis_angle_to_matrix(np.asarray(a, np.float64)).T @ axis_angle_to_matrix(np.asarray(b, np.float64))
    return float(np.arccos(np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)))


def superseded(rows: list, timestamps) -> list:
    """The action timestamps an episode records after a chunk scheduled at
    ``timestamps``: the chunk replaces the rows from its first timestamp on,
    as it replaces those waypoints in the controllers' trajectories."""
    ts = list(timestamps)
    return [t for t in rows if not ts or t < ts[0]] + ts


def phase_real_loop(attention_ops) -> tuple:
    """UMI served to a robot in a closed loop: config.UMI_MULTI on the
    seeded weights of serve_umi, bf16, 100 sampler steps, the kernel route,
    behind the port's PolicyInferenceNode (the hash encoder's latent as the
    task's language latent, smoothing window 3); the sim-backed UmiRealEnv
    (the arm at REAL_ARM, the gripper, one 224 px camera at 20 fps; each a
    spawned process over the shared-memory library built from
    native/shm_ipc.cpp) at REAL_HZ with the 16-step window. Each cycle:
    get_obs, get_real_umi_obs_dict against the episode's start pose,
    node.infer, get_real_umi_action on the latest pose, the timestamps the
    aligned obs time plus k / REAL_HZ, exec_actions; a cycle every
    n_action_steps / REAL_HZ (0.8 s) or, when the request outlasts that, as
    soon as it returns. Checks: 24 online D = 64 launches a request and no
    other attention kernel; every absolute action finite and every cycle
    scheduling at least one; the recorded cycle's request replayed through
    the kernel route against the plain route (route_check, the serve limits
    and the controls) and in fp32 on the card against the CPU; the arm's
    pose against its own trajectory (TargetTCPPose) and that against the
    last action, within REAL_POSE_ATOL, the gripper's width against the last
    action; the episode's timestamps increasing and its actions those the
    controllers kept. Returns the loop's launches and the fp32 launches."""
    from unified_video_action_tpu_torch import config as port_config
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.ipc import shm
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
    from unified_video_action_tpu_torch.real import (CameraProcess, PoseInterpolationController,
                                                     UmiRealEnv, WidthController)
    from unified_video_action_tpu_torch.real.sim import SimArmBackend, SimCameraBackend, SimGripperBackend
    from unified_video_action_tpu_torch.serving.real_inference import (get_real_umi_action,
                                                                       get_real_umi_obs_dict)
    from unified_video_action_tpu_torch.serving.zmq_server import PolicyInferenceNode
    from unified_video_action_tpu_torch.utils.language import HashTextEncoder

    log(f"g++ native/shm_ipc.cpp -> {shm.library_path().name}: {shm.build():.1f}s")
    fs = os.statvfs("/dev/shm")
    shm_size, shm_free = fs.f_blocks * fs.f_frsize, fs.f_bavail * fs.f_frsize

    def make_policy(device="cuda", dtype="bfloat16"):
        return UnifiedVideoActionPolicy.from_cfg(port_config.UMI_MULTI, device=device, compute_dtype=dtype)

    policy = make_policy()
    c = policy.mar_cfg
    trees = (convert.seeded_tree(policy.mar, SEED), convert.seeded_tree(policy.vae, SEED + 1))
    policy.load_params(*trees)
    goal = HashTextEncoder().encode(UMI_PROMPT)
    node = PolicyInferenceNode(policy, {REAL_TASK: goal}, smooth_window=3, seed=SEED)

    px = REAL_CAMERA["px"]
    robot = PoseInterpolationController(
        SimArmBackend(init_pose=np.asarray(REAL_INIT_POSE), tau=REAL_TAU), frequency=REAL_ARM["hz"],
        max_pos_speed=REAL_SPEED, max_rot_speed=REAL_SPEED, get_max_k=REAL_ARM["get_max_k"])
    gripper = WidthController(SimGripperBackend(init_width=0.08, max_speed=REAL_SPEED),
                              frequency=REAL_GRIPPER["hz"], max_speed=REAL_SPEED,
                              get_max_k=REAL_GRIPPER["get_max_k"])
    cam = CameraProcess(SimCameraBackend((px, px), seed=SEED), resolution=(px, px),
                        fps=REAL_CAMERA["fps"], get_max_k=REAL_CAMERA["get_max_k"])
    env = UmiRealEnv(robot, gripper, [cam], frequency=REAL_HZ, camera_obs_horizon=REAL_HORIZON,
                     robot_obs_horizon=REAL_HORIZON, gripper_obs_horizon=REAL_HORIZON)
    rings = [cam.ring, robot.ring, gripper.ring, robot.input_queue, gripper.input_queue]
    need = sum(r.nbytes for r in rings)
    log(f"/dev/shm: {shm_size} bytes, {shm_free} free; the loop's rings and queues {need} bytes "
        f"(the camera's {cam.ring.n_slots} slots of {cam.ring.slot_bytes} bytes)")
    if shm_free < need:
        env.stop()
        raise AssertionError(f"/dev/shm has {shm_free} bytes free, the loop needs {need}")

    counters = (attention_ops.launch_count, attention_ops.instance_count)

    def counts() -> dict:
        return {k: v for counter in counters for k, v in counter.items()}

    period = policy.n_action_steps / REAL_HZ
    t_start = time.perf_counter()
    with env:
        log(f"real_loop env: arm, gripper and camera processes ready in {time.perf_counter() - t_start:.1f}s")
        time.sleep(REAL_HORIZON / REAL_HZ)  # the state streams cover the window
        obs = env.get_obs()
        start_pose = np.concatenate([obs["robot0_eef_pos"][-1], obs["robot0_eef_rot_axis_angle"][-1]])

        def request(obs) -> dict:
            return {k: v[None] for k, v in
                    get_real_umi_obs_dict(obs, episode_start_pose=start_pose).items()}

        node.infer(request(obs), REAL_TASK)  # warm-up: not counted
        torch.cuda.synchronize()
        env.start_episode()
        for counter in counters:
            for k in counter:
                counter[k] = 0
        loop = {"request_ms": [], "latency_ms": [], "fresh": [], "sent": [], "cycle_start": []}
        per_request, rows, recorded, last = [], [], None, None
        for i in range(REAL_CYCLES):
            t_cycle = time.perf_counter()
            loop["cycle_start"].append(t_cycle)
            obs = env.get_obs()
            req = request(obs)
            noise = None
            if i == REAL_RECORDED_CYCLE:
                noise = policy.sample_noise(1, torch.Generator(device="cuda").manual_seed(SEED + 90))
                recorded = (req, noise)
            before = counts()
            t0 = time.perf_counter()
            action = node.infer(req, REAL_TASK, noise=noise)
            loop["request_ms"].append((time.perf_counter() - t0) * 1e3)
            per_request.append({k: v - before[k] for k, v in counts().items()})
            current = np.concatenate([obs["robot0_eef_pos"][-1], obs["robot0_eef_rot_axis_angle"][-1]])
            actions = get_real_umi_action(action[0], current)
            stamps = obs["timestamp"][-1] + np.arange(len(actions)) / REAL_HZ
            if actions.shape != (16, 7) or not np.isfinite(actions).all():
                raise AssertionError(f"real_loop cycle {i}: absolute actions {actions.shape}, "
                                     f"finite {np.isfinite(actions).all()}")
            t_exec = time.time()
            n = env.exec_actions(actions, stamps)
            loop["latency_ms"].append((t_exec - obs["timestamp"][-1]) * 1e3)
            loop["fresh"].append(n)
            loop["sent"].append(len(actions))
            if n == 0:
                raise AssertionError(f"real_loop cycle {i}: every action was stale "
                                     f"(request {loop['request_ms'][-1]:.1f} ms)")
            rows = superseded(rows, stamps[len(stamps) - n:])  # the fresh ones are the last n
            last = (actions[-1], stamps[-1])
            time.sleep(max(0.0, t_cycle + period - time.perf_counter()))
        launches = counts()
        # the trajectories end at the last action's time; then they settle
        time.sleep(max(0.0, last[1] - time.time()) + REAL_SETTLE_S)
        arm, width = env.get_robot_state(), gripper.get_state()
        episode = env.end_episode()
    log(f"real_loop env stopped; {time.perf_counter() - t_start:.1f}s since the processes started")

    # launches: each request the online kernel's D = 64 instance once per block
    blocks = c.encoder_depth + c.decoder_depth
    want = {**attention_launches_per_request(attention_ops, c, 1, torch.bfloat16),
            **attention_instances_per_request(attention_ops, c, 1, torch.bfloat16)}
    plan = attention_plan_of(attention_ops, c, 1, torch.bfloat16)
    bad = [i for i, got in enumerate(per_request) if got != want]
    if bad or plan.instance != "attention_wgmma_online_d64" or want[plan.instance] != blocks:
        raise AssertionError(f"real_loop: requests {bad} launched {[per_request[i] for i in bad]}, "
                             f"want {want} ({blocks} of attention_wgmma_online_d64)")

    # the arm against its own trajectory at the end, and that against the last action
    actual, target = arm["ActualTCPPose"][-1], arm["TargetTCPPose"][-1]
    pose_err = {
        "arm_vs_trajectory_pos": float(np.abs(actual[:3] - target[:3]).max()),
        "arm_vs_trajectory_rot": rotation_angle(actual[3:], target[3:]),
        "trajectory_vs_last_action_pos": float(np.abs(target[:3] - last[0][:3]).max()),
        "trajectory_vs_last_action_rot": rotation_angle(target[3:], last[0][3:6]),
        "gripper_vs_last_action": float(abs(width["gripper_position"][-1] - last[0][6])),
    }
    log(f"real_loop end state: {json.dumps(pose_err)}; atol {REAL_POSE_ATOL}")
    if max(pose_err.values()) > REAL_POSE_ATOL:
        raise AssertionError(f"real_loop: the arm or gripper is off its trajectory: {pose_err}")

    # the episode: increasing timestamps, and the actions the controllers kept
    increasing = {k: bool(np.all(np.diff(v) > 0)) for k, v in episode.items() if k.endswith("_timestamp")}
    kept = episode["action_timestamp"].tolist() == rows and episode["action"].shape == (len(rows), 7)
    log(f"real_loop episode: {json.dumps({k: list(np.shape(v)) for k, v in episode.items()})}, "
        f"timestamps increasing {json.dumps(increasing)}, {len(rows)} actions kept of "
        f"{sum(loop['fresh'])} scheduled")
    if not all(increasing.values()) or not kept:
        raise AssertionError(f"real_loop: episode timestamps {increasing}, actions kept as the "
                             f"controllers kept them: {kept}")

    # the recorded cycle's request: the kernel route against the plain route,
    # and the card in fp32 against the CPU in fp32
    req, noise = recorded
    inputs = request_inputs(policy, req, goal)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy32 = make_policy(dtype="float32")
    policy32.load_params(*trees)
    diffs = route_check(attention_ops, policy, policy32, {1: inputs[0]}, {1: noise},
                        REJECTED_CONTROLS_UMI, {1: inputs[2]}, {1: inputs[1]})
    f32_launches = fp32_card_vs_cpu(attention_ops, "real_loop", policy32,
                                    make_policy(device="cpu", dtype="float32"), trees, inputs, noise)
    del policy32

    periods = np.diff(loop["cycle_start"]) * 1e3
    stale = sum(loop["sent"]) - sum(loop["fresh"])
    summary = {
        "requests": len(loop["request_ms"]),
        "request_ms_median": statistics.median(loop["request_ms"]),
        "request_ms_max": max(loop["request_ms"]),
        "obs_to_action_ms_median": statistics.median(loop["latency_ms"]),
        "obs_to_action_ms_max": max(loop["latency_ms"]),
        "stale_dropped": stale, "actions_sent": sum(loop["sent"]),
        "control_period_ms_median": float(np.median(periods)),
        "control_period_ms_max": float(periods.max()), "control_period_ms_target": period * 1e3,
        "dev_shm_bytes": shm_size, "dev_shm_free_bytes": shm_free,
        "launches_per_request": {k: v for k, v in want.items() if v},
        "kernel_vs_plain": diffs, "card": card_line(),
    }
    log(f"real_loop requests (host clock, obs dict to smoothed chunk): median "
        f"{summary['request_ms_median']:.2f} ms, max {summary['request_ms_max']:.2f} ms over {REAL_CYCLES}")
    log(f"real_loop obs-to-first-action latency (aligned obs time to exec_actions): median "
        f"{summary['obs_to_action_ms_median']:.2f} ms, max {summary['obs_to_action_ms_max']:.2f} ms")
    log(f"real_loop stale actions dropped by exec_actions: {stale} of {summary['actions_sent']}")
    log(f"real_loop control period: median {summary['control_period_ms_median']:.2f} ms, max "
        f"{summary['control_period_ms_max']:.2f} ms (target {period * 1e3:.0f} ms)")
    log(f"real_loop /dev/shm: {shm_size} bytes, {shm_free} free; card: {summary['card']}")
    log(f"real_loop " + json.dumps(summary))
    return launches, {"real_loop_fp32_vs_cpu_b1": {"attention_f32_d64": f32_launches}}

# train_umi: the UMI stage-2 recipe (config.UMI_MULTI with
# config.UMI_TRAIN_OVERRIDES) on the port's synthetic corpus, made here
UMI_OUT = os.path.join(REPO, "build", "train_umi")
UMI_EPISODES, UMI_EPISODE_LEN = 4, 60  # a dataset; one of each dataset's four is validation's
UMI_STEPS = 5  # bf16 steps at the config's B = 32
UMI_TIMED_FROM = 2  # the first steps warm up
UMI_PARITY_B, UMI_PARITY_DEPTH = 1, 2  # fp32 card-vs-CPU steps at full width, 2+2 blocks
UMI_PARITY_MODES = ("policy_model", "full_dynamic_model", "policy_model")
# the corpus's stores: every key zlib (a standard-library codec: the path
# needs no optional library), the mouse dataset as a .zarr.zip
UMI_CODEC = {"id": "zlib", "level": 1}
UMI_STORE_KEYS = ("camera0_rgb", "robot0_eef_pos", "robot0_eef_rot_axis_angle",
                  "robot0_gripper_width", "robot0_demo_start_pose")
UMI_SUFFIXES = {"mouse": ".zarr.zip"}
UMI_SYSTEM_CODECS = ("libblosc", "libzstd", "liblz4")


def umi_train_config(paths: dict, *overrides: str) -> dict:
    from unified_video_action_tpu_torch import config as port_config
    from unified_video_action_tpu_torch.config import apply_overrides

    cfg = copy.deepcopy(port_config.UMI_MULTI)
    apply_overrides(cfg, [*port_config.UMI_TRAIN_OVERRIDES, f"training.seed={SEED}",
                          # B = 32 at N = 1088 does not fit without it (PERF.md)
                          "model.policy.autoregressive_model_params.grad_checkpointing=true",
                          "training.num_epochs=1", f"training.max_train_steps={UMI_STEPS}",
                          "training.max_val_steps=1", "training.checkpoint_every=0",
                          "task.dataset.val_ratio=0.25", f"output_dir={UMI_OUT}/run", *overrides])
    for name, path in paths.items():
        cfg["task"]["dataset"]["datasets_cfg"][name]["path"] = path
    return cfg


def umi_parity(paths: dict, trainer) -> dict:
    """UMI_PARITY_MODES' steps in fp32 (no TF32) at B = UMI_PARITY_B with the
    model cut to UMI_PARITY_DEPTH + UMI_PARITY_DEPTH blocks at full width, on
    the card and on the CPU: the same weights, loader batches (the random
    history frequency, language latents, the per-sample state gather), noise
    (the label drop) and dropout masks; each step's metrics within
    TRAIN_PARITY_RTOL."""
    from unified_video_action_tpu_torch.data.loader import collate
    from unified_video_action_tpu_torch.training.ema import EmaConfig
    from unified_video_action_tpu_torch.training.train_state import create_train_state, train_step
    from unified_video_action_tpu_torch.training.workspace import build_policy, to_device_batch

    amp = "model.policy.autoregressive_model_params."
    cfg = umi_train_config(paths, "model.policy.compute_dtype=float32", f"{amp}model_size=custom",
                           *(f"{amp}{k}={v}" for k, v in (
                               ("encoder_embed_dim", 768), ("decoder_embed_dim", 768),
                               ("encoder_num_heads", 12), ("decoder_num_heads", 12),
                               ("encoder_depth", UMI_PARITY_DEPTH), ("decoder_depth", UMI_PARITY_DEPTH))))
    policies = {dev: build_policy(cfg, torch.device(dev)) for dev in ("cpu", "cuda")}
    vae = trainer.policy.vae_params()
    for p in policies.values():
        p.init_params(SEED)
        p.set_normalizer(trainer.normalizer)
        load_vae(p, vae)
    policies["cuda"].mar.load_state_dict(policies["cpu"].mar.state_dict())
    states = {dev: create_train_state(p, EmaConfig(), learning_rate=1e-4, weight_decay=0.02,
                                      betas=(0.9, 0.95), warmup_steps=500, total_steps=1000)
              for dev, p in policies.items()}
    rng = np.random.default_rng(SEED + 7)
    items = rng.choice(len(trainer.dataset), (len(UMI_PARITY_MODES), UMI_PARITY_B), replace=False)
    steps, seconds = [], {"cpu": 0.0, "cuda": 0.0}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for k, mode in enumerate(UMI_PARITY_MODES):
            host = collate([trainer.dataset[int(i)] for i in items[k]])
            frames = np.arange(3, 11)
            gen = torch.Generator().manual_seed(SEED + k)
            noise = policies["cpu"].sample_train_noise(UMI_PARITY_B, gen)
            drop = policies["cpu"].mar.draw_dropout(UMI_PARITY_B, gen, torch.device("cpu"))
            row = {"mode": mode}
            for dev in ("cpu", "cuda"):
                to = lambda t: t.to(dev)
                t0 = time.perf_counter()
                m = train_step(states[dev], to_device_batch(host, torch.device(dev)), mode, frames,
                               noise={k2: to(v) for k2, v in noise.items()},
                               drop={s2: [tuple(None if x is None else to(x) for x in blk)
                                          for blk in v] for s2, v in drop.items()})
                row[dev] = {k2: v.item() for k2, v in m.items()}
                seconds[dev] += time.perf_counter() - t0
            for key, want in row["cpu"].items():
                got = row["cuda"][key]
                if not np.isfinite(got) or abs(got - want) > TRAIN_PARITY_RTOL * abs(want):
                    raise AssertionError(f"train_umi parity step {k + 1} ({mode}): {key} {got} on the "
                                         f"card, {want} on the CPU")
            log(f"train_umi parity step {k + 1} ({mode}): card {json.dumps(row['cuda'])}, "
                f"CPU {json.dumps(row['cpu'])}")
            steps.append(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    log(f"train_umi parity: {UMI_PARITY_DEPTH}+{UMI_PARITY_DEPTH} blocks of d=768 at B={UMI_PARITY_B}, "
        f"CPU {seconds['cpu']:.1f}s, card {seconds['cuda']:.1f}s for {len(steps)} steps")
    return {"steps": steps, "cpu_s": seconds["cpu"], "card_s": seconds["cuda"]}


def umi_codec_line(root: str, store: str) -> dict:
    """For each of UMI_SYSTEM_CODECS: where the library loads, a chunk of
    the camera key round-trips through its codec (blosc, zstd), and for
    liblz4 the directory store ``store`` packed as a .zarr.tar.lz4 goes
    through tools/stage_datasets.py extract and reads back equal; where it
    does not load, reading such data raises an error naming the library.
    Returns {library: the case that held}."""
    import tarfile

    from unified_video_action_tpu_torch.data import zarrlite
    from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
    from unified_video_action_tpu_torch.tools import stage_datasets
    from unified_video_action_tpu_torch.utils import lz4f

    frames = np.asarray(ReplayBuffer.load(store, lazy=True)["camera0_rgb"][:4])
    loaders = {"libblosc": zarrlite._Blosc.lib, "libzstd": zarrlite._Zstd.lib,
               "liblz4": lz4f._Lib.get}
    codecs = {"libblosc": dict(zarrlite.DEFAULT_COMPRESSOR), "libzstd": {"id": "zstd", "level": 3}}
    line = {}
    for lib in UMI_SYSTEM_CODECS:
        try:
            loaders[lib]()
            loaded = True
        except RuntimeError as e:
            loaded, reason = False, str(e)
        if lib in codecs:
            group = zarrlite.open_group(zarrlite.MemoryStore(), mode="w")
            if loaded:
                arr = group.create_dataset("x", data=frames, chunks=(2,) + frames.shape[1:],
                                           compressor=codecs[lib])
                back = zarrlite.open_group(group.store)["x"][:]
                if not np.array_equal(back, frames):
                    raise AssertionError(f"train_umi codec line: {lib}'s chunk round trip differs")
                line[lib] = f"loaded: a chunk of {frames.nbytes} bytes round-trips"
                continue
            arr = group.create_dataset("x", shape=frames.shape, dtype=frames.dtype,
                                       compressor=None)
            meta = json.loads(group.store.get("x/.zarray"))
            group.store.set("x/.zarray", json.dumps(dict(meta, compressor=codecs[lib])).encode())
            group.store.set("x/0.0.0.0", b"\0" * 64)
            reader = zarrlite.open_group(group.store)["x"]
        else:
            if loaded:
                packed = os.path.join(root, "packed")
                os.makedirs(packed, exist_ok=True)
                raw = io.BytesIO()
                with tarfile.open(fileobj=raw, mode="w") as t:
                    t.add(store, arcname=os.path.basename(store))
                archive = os.path.join(packed, os.path.basename(store) + ".tar.lz4")
                with open(archive, "wb") as f:
                    f.write(lz4f.compress(raw.getvalue()))
                out = os.path.join(root, "staged")
                said = stage_datasets.extract_all(packed, out)
                a = ReplayBuffer.load(store)
                b = ReplayBuffer.load(os.path.join(out, os.path.basename(store)))
                if not (a.keys() == b.keys() and np.array_equal(a.episode_ends, b.episode_ends)
                        and all(np.array_equal(a[k], b[k]) for k in a.keys())):
                    raise AssertionError(f"train_umi codec line: {archive} staged differs: {said}")
                line[lib] = (f"loaded: a .zarr.tar.lz4 of {os.path.getsize(archive)} bytes staged "
                             f"by stage_datasets extract and read back equal")
                continue
            reader = None
        try:
            reader[:] if reader is not None else lz4f.decompress(b"\x04\x22\x4d\x18")
        except RuntimeError as e:
            if lib not in str(e):
                raise AssertionError(f"train_umi codec line: {lib} absent, but the error says {e}")
            line[lib] = f"not loaded ({reason}); reading raises naming it"
            continue
        raise AssertionError(f"train_umi codec line: {lib} did not load, yet reading did not raise")
    return line


def umi_reference_checkpoints(cfg: dict, out: str) -> tuple:
    """A reference-format MAR checkpoint and a kl16.ckpt written under
    ``out`` from seeded weights of the config's model (the flax layout
    through tests/_torch_reference_layout.py), and ``cfg`` pointed at them
    (pretrained_model_path, autoencoder_path). Returns the two trees."""
    from tests import _torch_reference_layout as reference
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    meta = UnifiedVideoActionPolicy.from_cfg(cfg, device="meta")
    trees = {"mar": convert.seeded_tree(meta.mar, SEED + 3),
             "vae": convert.seeded_tree(meta.vae, SEED + 1)}
    os.makedirs(out, exist_ok=True)
    policy_cfg = cfg["model"]["policy"]
    policy_cfg["autoregressive_model_params"]["pretrained_model_path"] = os.path.join(out, "mar.ckpt")
    policy_cfg["vae_model_params"]["autoencoder_path"] = os.path.join(out, "kl16.ckpt")
    reference.write_mar_checkpoint(policy_cfg["autoregressive_model_params"]["pretrained_model_path"],
                                   trees["mar"])
    reference.write_vae_checkpoint(policy_cfg["vae_model_params"]["autoencoder_path"], trees["vae"])
    return trees


def umi_imported_leaves(policy, trees: dict) -> dict:
    """Every leaf of the trainer's MAR (fp32) and VAE tree against its
    source in the reference checkpoints: all bit-equal, none kept at init
    or skipped."""
    from unified_video_action_tpu_torch import convert

    got = {"mar": convert.flatten_tree(convert.to_flax_tree(policy.mar)),
           "vae": convert.flatten_tree(policy.vae_tree)}
    counts = {"skipped": policy._last_mar_import_skipped,
              "kept_at_init": policy._last_mar_import_kept_at_init}
    for name, tree in trees.items():
        want = convert.flatten_tree(tree)
        differ = [p for p in want if p not in got[name] or not np.array_equal(got[name][p], want[p])]
        counts[f"{name}_leaves"], counts[f"{name}_differ"] = len(want), len(differ)
        if differ or got[name].keys() != want.keys():
            raise AssertionError(f"train_umi checkpoint: {len(differ)} of {len(want)} {name} leaves "
                                 f"differ from the reference checkpoint: {differ[:5]}")
    if counts["skipped"] or counts["kept_at_init"]:
        raise AssertionError(f"train_umi checkpoint: {counts}")
    return counts


def umi_lazy_batch_check(trainer, cfg: dict) -> dict:
    """The trainer's datasets read lazily from zarr (each camera array a
    ZarrArray, two directory stores and one zip); one batch of B items from
    them bit-equal to the same items of an in-memory load of the stores."""
    from unified_video_action_tpu_torch.data import zarrlite
    from unified_video_action_tpu_torch.data.loader import collate
    from unified_video_action_tpu_torch.training.workspace import build_dataset

    stores = {}
    for name, ds in trainer.dataset.datasets.items():
        arrays = [ds.replay_buffer[k] for k in UMI_STORE_KEYS]
        if not all(isinstance(a, zarrlite.ZarrArray) for a in arrays):
            raise AssertionError(f"train_umi: {name} is not read lazily: {[type(a) for a in arrays]}")
        stores[name] = type(arrays[0].store).__name__
    if sorted(stores.values()) != ["DirectoryStore", "DirectoryStore", "ZipStore"]:
        raise AssertionError(f"train_umi: stores {stores}")
    eager = copy.deepcopy(cfg)
    for spec in eager["task"]["dataset"]["datasets_cfg"].values():
        spec["lazy"] = False
    memory = build_dataset(eager)
    idx = np.random.default_rng(SEED + 8).choice(len(trainer.dataset), trainer.batch_size,
                                                 replace=False)
    t0 = time.perf_counter()
    lazy_batch = collate([trainer.dataset[int(i)] for i in idx])
    lazy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    memory_batch = collate([memory[int(i)] for i in idx])
    memory_s = time.perf_counter() - t0

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    a, b = dict(leaves(lazy_batch)), dict(leaves(memory_batch))
    differ = [k for k in a if k not in b or not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))]
    if differ or a.keys() != b.keys():
        raise AssertionError(f"train_umi: the lazy batch differs from the in-memory one at {differ}")
    return {"stores": stores, "batch_keys": len(a), "lazy_batch_s": lazy_s,
            "memory_batch_s": memory_s}


def umi_cache_peak(trainer) -> dict:
    """The chunk caches of the trainer's lazy arrays: the largest peak of
    one array, their sum, and the bound each is held to."""
    from unified_video_action_tpu_torch.data import zarrlite

    peaks = {f"{name}/{k}": ds.replay_buffer[k].cache_peak_bytes
             for name, ds in trainer.dataset.datasets.items() for k in UMI_STORE_KEYS}
    if max(peaks.values()) > zarrlite.CACHE_BYTES:
        raise AssertionError(f"train_umi: a chunk cache past its bound: {peaks}")
    return {"max_array_peak_bytes": max(peaks.values()), "sum_peak_bytes": sum(peaks.values()),
            "bound_bytes_per_array": zarrlite.CACHE_BYTES, "arrays": len(peaks)}


def load_vae(policy, tree: dict) -> None:
    """The VAE of ``tree`` (flax layout, fp32) into ``policy``, kept as its
    ``vae_tree`` (what its serving policies and checkpoints read)."""
    from unified_video_action_tpu_torch import convert

    convert.load_into(policy.vae, tree)
    policy.vae_tree = tree


def phase_train_umi(attention_ops, int8_ops) -> dict:
    """The UMI multi-task model's stage 2 on the card through train_torch.py's
    Trainer and the host loader: the port's synthetic corpus
    (tools/gen_synthetic_umi.py: three datasets of UMI_EPISODES episodes at
    224 px) written here as reference-layout zarr stores (UMI_CODEC on every
    key, UMI_SUFFIXES) and read lazily (umi_lazy_batch_check); the codec
    line (umi_codec_line); the MAR and the VAE from reference-format torch
    checkpoints (umi_reference_checkpoints, umi_imported_leaves); fp32
    card-vs-CPU steps (umi_parity); UMI_STEPS bf16 steps at the config's B =
    32 (mar_base, N = 1088, both task modes drawn, the random history
    frequency, the label drop, dropout 0.1) with every metric finite and no
    uva_* kernel launched, ms per step by CUDA events, the loader's wait a
    batch and peak memory; the chunk caches' peak; then the epoch's
    validation: one val_action_l2_distances reading, its predict call
    launching the online kernel's D = 64 instance once per ViT block.
    Returns the phase's numbers and the validation's launches."""
    from unified_video_action_tpu_torch.tools.gen_synthetic_umi import write_corpus
    from unified_video_action_tpu_torch.training.train_state import train_step
    from unified_video_action_tpu_torch.training.workspace import Trainer

    t0 = time.perf_counter()
    shutil.rmtree(UMI_OUT, ignore_errors=True)
    with contextlib.redirect_stdout(io.StringIO()):
        paths = write_corpus(os.path.join(UMI_OUT, "umi"), UMI_EPISODES, UMI_EPISODE_LEN, 224,
                             compressors={k: dict(UMI_CODEC) for k in UMI_STORE_KEYS},
                             suffixes=UMI_SUFFIXES)
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    codecs = umi_codec_line(os.path.join(UMI_OUT, "codecs"), paths["cup"])
    log(f"train_umi codec line: {json.dumps(codecs)} ({time.perf_counter() - t0:.1f}s)")
    cfg = umi_train_config(paths)
    t0 = time.perf_counter()
    trees = umi_reference_checkpoints(cfg, os.path.join(UMI_OUT, "reference"))
    ckpt_s = time.perf_counter() - t0
    sizes = {os.path.basename(p): os.path.getsize(p) for p in (
        cfg["model"]["policy"]["autoregressive_model_params"]["pretrained_model_path"],
        cfg["model"]["policy"]["vae_model_params"]["autoencoder_path"])}
    t0 = time.perf_counter()
    trainer = Trainer(cfg, "cuda")
    trainer_s = time.perf_counter() - t0
    policy = trainer.policy
    c = policy.mar_cfg
    imported = umi_imported_leaves(policy, trees)
    log(f"train_umi: reference checkpoints {json.dumps(sizes)} written in {ckpt_s:.1f}s; the "
        f"trainer started from them: {json.dumps(imported)}")
    log(f"train_umi: corpus of {len(paths)} zarr stores x {UMI_EPISODES} episodes x "
        f"{UMI_EPISODE_LEN} steps at 224 px ({json.dumps(UMI_CODEC)}, {UMI_SUFFIXES}) written in "
        f"{corpus_s:.1f}s; {len(trainer.dataset)} training and {len(trainer.val_dataset)} "
        f"validation items; trainer built in {trainer_s:.1f}s: "
        f"{c.encoder_depth}+{c.decoder_depth} blocks of d={c.encoder_embed_dim}, {c.attention_tokens} "
        f"tokens, streams: state {c.proprio_dim}, text {c.has_text}, history "
        f"{c.use_history_action}, different_history_freq {c.different_history_freq}, "
        f"grad_checkpointing {c.grad_checkpointing}; B={trainer.batch_size}, {policy.dtype}, "
        f"{trainer.loader.num_workers} loader workers")
    if c.use_history_action or not (c.use_proprioception and c.has_text and c.different_history_freq):
        raise AssertionError(f"train_umi: not the stage-2 streams: {c}")
    lazy = umi_lazy_batch_check(trainer, cfg)
    log(f"train_umi: one batch of B={trainer.batch_size} from the lazy stores bit-equal to the "
        f"in-memory load: {json.dumps(lazy)}")

    parity = umi_parity(paths, trainer)

    # the bf16 steps, timed, with the loader's wait for each batch
    for counter in (attention_ops.launch_count, int8_ops.launch_count):
        for k in counter:
            counter[k] = 0
    torch.cuda.reset_peak_memory_stats()
    state, modes, metrics, events, waits = trainer.state, [], [], [], []
    batches = trainer.batches()
    t0 = time.perf_counter()
    for i in range(UMI_STEPS):
        tw = time.perf_counter()
        mode, frames, batch = next(batches)
        waits.append(time.perf_counter() - tw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        metrics.append(train_step(state, batch, mode, frames, generator=trainer.generator,
                                  pregathered=True))
        modes.append(mode)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    events.append(end)
    batches.close()
    steps_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(len(events) - 1)]
    launched = {k: v for k, v in {**attention_ops.launch_count, **int8_ops.launch_count}.items() if v}
    values = [{k: v.item() for k, v in m.items()} for m in metrics]
    log(f"train_umi: {len(values)} bf16 steps at B={trainer.batch_size} in {steps_s:.1f}s, modes "
        f"{modes}; step ms {json.dumps(step_ms)}; loader wait s {json.dumps(waits)}; losses "
        f"{json.dumps(values)}; uva_* launches {launched}")
    if (len(values) != UMI_STEPS or set(modes) != set(policy.task_modes) or launched
            or not all(np.isfinite(list(v.values())).all() for v in values)):
        raise AssertionError(f"train_umi: steps {len(values)}, modes {modes}, launches {launched}, "
                             f"metrics {values}")
    cache = umi_cache_peak(trainer)
    log(f"train_umi chunk caches: {json.dumps(cache)}")

    # the epoch's validation: one reading through the serving policy
    for counter in (attention_ops.launch_count, attention_ops.instance_count):
        for k in counter:
            counter[k] = 0
    val = trainer.validate()
    val_launches = {**attention_ops.launch_count, **attention_ops.instance_count}
    plan = attention_plan_of(attention_ops, c, trainer.batch_size, torch.bfloat16)
    blocks = c.encoder_depth + c.decoder_depth
    log(f"train_umi validation: val_action_l2_distances {val}; launches "
        f"{json.dumps({k: v for k, v in val_launches.items() if v})}")
    if (val is None or not np.isfinite(val) or plan.instance != "attention_wgmma_online_d64"
            or val_launches[plan.instance] != blocks
            or sum(val_launches[k] for k in attention_ops.launch_count) != blocks):
        raise AssertionError(f"train_umi validation: {val}, plan {plan.instance}, launches "
                             f"{val_launches}")
    timed = step_ms[UMI_TIMED_FROM:]
    perf = {"ms_per_step": statistics.median(timed), "step_ms": step_ms,
            "loader_wait_s": waits, "loader_wait_s_median": statistics.median(waits[UMI_TIMED_FROM:]),
            "samples_per_s": trainer.batch_size / (statistics.median(timed) / 1e3),
            "peak_mem_gb": peak / 1e9, "grad_checkpointing": c.grad_checkpointing,
            "B": trainer.batch_size, "val_action_l2_distances": val, "stores": "zarr, lazy",
            "chunk_cache": cache, "card": card_line()}
    log(f"train_umi perf: {json.dumps(perf)}")
    shutil.rmtree(UMI_OUT, ignore_errors=True)
    return {"perf": perf, "parity": parity, "launches_validate": val_launches, "codecs": codecs,
            "checkpoint": imported, "lazy": lazy}


# suite_toolhang, suite_libero10: the robomimic and LIBERO suites, trained
# then evaluated on the stub backend (the simulators are not on the card's
# machine; a stub's score is a seed schedule that measures nothing)
SUITE_OUT = os.path.join(REPO, "build", "suites")
SUITE_STEPS, SUITE_B, SUITE_TIMED_FROM = 4, 8, 1  # bf16 steps at B = 8; the first warms up
SUITE_TOKENS = 1024  # both configs: 4 frames of 16 x 16 tokens, no text buffer
SUITE_EVAL = {  # the runners' overrides: (n_train, n_test, max_steps)
    "toolhang": ("task.env_runner.n_train=2", "task.env_runner.n_test=4",
                 "task.env_runner.max_steps=64"),
    "libero10": ("task.env_runner.n_test=2", "task.env_runner.max_steps=16"),  # 32 before the PushT pipeline
}
# the log keys an evaluation writes beside the runners' scores
EVAL_LOG_KEYS = {"test_mean_score", "env_backend", "STUB_SCORES_NOT_REAL", "ckpt_source",
                 "ckpt_digest", "act_steps", "serving_quant", "obs_codec", "port", "device",
                 "compute_dtype", "eval_wall_s"}


@contextlib.contextmanager
def recorded_requests(attention_ops):
    """Within the block, every ``UnifiedVideoActionPolicy.predict_action``
    call is recorded: its goal, action chunk, host ms (the action copied to
    the host) and the attention launches it made, by kernel and instance;
    and the first call's obs dict."""
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    original = UnifiedVideoActionPolicy.predict_action
    calls = []
    counters = (attention_ops.launch_count, attention_ops.instance_count)

    def counts() -> dict:
        return {k: v for counter in counters for k, v in counter.items()}

    def recorded(self, obs_dict, generator=None, noise=None, language_goal=None):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(self, obs_dict, generator, noise, language_goal)
        ms = (time.perf_counter() - t0) * 1e3
        calls.append({"obs": None if calls else {k: np.array(v) for k, v in obs_dict.items()},
                      "goal": language_goal, "action": out["action"],
                      "action_pred": out["action_pred"], "ms": ms,
                      "launches": {k: v - before[k] for k, v in counts().items()}})
        return out

    UnifiedVideoActionPolicy.predict_action = recorded
    try:
        yield calls
    finally:
        UnifiedVideoActionPolicy.predict_action = original


def check_stub_logs(name: str, runner) -> int:
    """Every stub of ``runner``'s last run received the runner's undone
    actions (7-d, axis-angle), cut where its episode ended; returns the
    actions the stubs received."""
    stepped = np.stack(runner.env_actions, axis=1)  # (envs, calls, n_action_steps, 7)
    received = 0
    for i, env in enumerate(runner.raw_envs):
        flat = stepped[i].reshape(-1, stepped.shape[-1]).astype(np.float32)
        log = np.stack(env.action_log)
        if (stepped.shape[-1] != 7 or not 0 < len(log) <= len(flat)
                or not np.array_equal(log, flat[: len(log)])):
            raise AssertionError(f"{name}: env {i}'s stub received {log.shape} actions, not the "
                                 f"runner's {flat.shape}")
        received += len(log)
    return received


def phase_suite(attention_ops, int8_ops, kind: str) -> tuple:
    """One suite (``kind``: "toolhang", config.TOOLHANG, or "libero10",
    config.LIBERO10 with data_aug) at full width through train_torch.py's
    Trainer and the host loader on synthetic stores written here by
    tools/gen_synthetic_suites.py (toolhang: 8 demos of 64 steps, two 240
    px cameras; LIBERO-10: ten task stores of 3 demos of 48 steps at 128
    px), config.SUITE_TRAIN_OVERRIDES (grad_checkpointing): SUITE_STEPS bf16
    steps at B = SUITE_B with every metric finite and no uva_* kernel
    launched, ms per step by CUDA events, peak memory; the slim export;
    eval_sim_torch.py's evaluate on it with the stub backend (SUITE_EVAL):
    every request 24 launches of the online kernel's D = 64 instance and no
    other attention kernel, finite actions, each stub's action_log the
    runner's undone actions, the log's keys and its .STUB name; for LIBERO
    one goal per runner and test_mean_score the mean of the per-task means.
    Then the first request through the kernel route against the plain
    route (the serve limits, the controls that plant a fault at N = 1024),
    and its first env in fp32 on the card against the CPU. Returns the
    phase's numbers, the counted launches and the fp32 check's."""
    import eval_sim_torch
    from unified_video_action_tpu_torch import config as port_config
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.config import apply_overrides
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
    from unified_video_action_tpu_torch.tools import gen_synthetic_suites as gen
    from unified_video_action_tpu_torch.training.train_state import train_step
    from unified_video_action_tpu_torch.training.workspace import Trainer

    name = f"suite_{kind}"
    out = os.path.join(SUITE_OUT, kind)
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    data = os.path.join(out, "data")
    if kind == "toolhang":
        store = gen.write_toolhang(data)
        data_keys = [f"task.dataset.dataset_path={store}", f"task.env_runner.dataset_path={store}"]
    else:
        store = os.path.dirname(gen.write_libero10(data)[0])
        data_keys = [f"task.dataset.dataset_dir={store}", f"task.env_runner.dataset_dir={store}"]
    corpus_s = time.perf_counter() - t0
    cfg = copy.deepcopy({"toolhang": port_config.TOOLHANG, "libero10": port_config.LIBERO10}[kind])
    apply_overrides(cfg, [*port_config.SUITE_TRAIN_OVERRIDES, *data_keys, f"training.seed={SEED}",
                          f"dataloader.batch_size={SUITE_B}", "training.num_epochs=1",
                          f"output_dir={out}/run"])
    t0 = time.perf_counter()
    trainer = Trainer(cfg, "cuda")
    policy = trainer.policy
    c = policy.mar_cfg
    # the KL-16 VAE's kl16.ckpt is absent: a numpy-seeded ch-128 VAE
    load_vae(policy, convert.seeded_tree(policy.vae, SEED + 1))
    log(f"{name}: stores written in {corpus_s:.1f}s; {len(trainer.dataset)} training and "
        f"{len(trainer.val_dataset)} validation windows; trainer built in "
        f"{time.perf_counter() - t0:.1f}s: {c.encoder_depth}+{c.decoder_depth} blocks of "
        f"d={c.encoder_embed_dim}, {c.attention_tokens} tokens, state "
        f"{c.proprio_dim if c.use_proprioception else None}, second camera "
        f"{policy.encodes_second_camera}, text {c.has_text}, grad_checkpointing "
        f"{c.grad_checkpointing}; B={trainer.batch_size}, {policy.dtype}, "
        f"data_aug {getattr(trainer.dataset, 'transforms', None) is not None}")
    if (c.attention_tokens != SUITE_TOKENS or not c.grad_checkpointing
            or trainer.batch_size != SUITE_B):
        raise AssertionError(f"{name}: not the config's model: {c}")

    # the bf16 steps, timed
    for counter in (attention_ops.launch_count, int8_ops.launch_count):
        for k in counter:
            counter[k] = 0
    torch.cuda.reset_peak_memory_stats()
    metrics, events = [], []
    t0 = time.perf_counter()
    for i, (mode, frames, batch) in enumerate(trainer.batches()):
        if i == SUITE_STEPS:
            break
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        metrics.append(train_step(trainer.state, batch, mode, frames, generator=trainer.generator,
                                  pregathered=True))
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    end.synchronize()
    events.append(end)
    steps_s = time.perf_counter() - t0
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(len(events) - 1)]
    launched = {k: v for k, v in {**attention_ops.launch_count, **int8_ops.launch_count}.items() if v}
    values = [{k: v.item() for k, v in m.items()} for m in metrics]
    train = {"ms_per_step": statistics.median(step_ms[SUITE_TIMED_FROM:]), "step_ms": step_ms,
             "steps_s": steps_s, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "B": trainer.batch_size, "card": card_line()}
    log(f"{name}: {len(values)} bf16 steps, losses {json.dumps(values)}; uva_* launches {launched}; "
        f"{json.dumps(train)}")
    if (len(values) != SUITE_STEPS or launched
            or not all(np.isfinite(list(v.values())).all() for v in values)):
        raise AssertionError(f"{name}: steps {len(values)}, launches {launched}, metrics {values}")

    # the export, evaluated through eval_sim_torch.py on the stub
    t0 = time.perf_counter()
    export = trainer.export(os.path.join(out, "export"))
    export_s = time.perf_counter() - t0
    del trainer, policy
    torch.cuda.empty_cache()
    eval_cfg = json.load(open(os.path.join(export, "meta.json")))["cfg"]
    apply_overrides(eval_cfg, ["task.env_runner.env_backend=stub", *SUITE_EVAL[kind]])
    for counter in (attention_ops.launch_count, attention_ops.instance_count):
        for k in counter:
            counter[k] = 0
    t0 = time.perf_counter()
    with recorded_requests(attention_ops) as calls, contextlib.redirect_stdout(io.StringIO()):
        eval_log, policy, runners, log_path = eval_sim_torch.evaluate(
            eval_cfg, export, os.path.join(out, "eval"), device="cuda")
    eval_s = time.perf_counter() - t0
    launches = {**attention_ops.launch_count, **attention_ops.instance_count}
    runners = runners if isinstance(runners, list) else [runners]
    batch = len(calls[0]["action"])
    want = {**attention_launches_per_request(attention_ops, c, batch, torch.bfloat16),
            **attention_instances_per_request(attention_ops, c, batch, torch.bfloat16)}
    plan = attention_plan_of(attention_ops, c, batch, torch.bfloat16)
    if plan.instance != "attention_wgmma_online_d64" or want[plan.instance] != c.encoder_depth + \
            c.decoder_depth:
        raise AssertionError(f"{name}: plan {plan}, launches a request {want}")
    for k, call in enumerate(calls):
        if call["launches"] != want:
            raise AssertionError(f"{name} request {k}: launches {call['launches']}, want {want}")
        check_actions(policy, torch.from_numpy(call["action_pred"]), batch)
    if any(launches[k] != len(calls) * v for k, v in want.items()):
        raise AssertionError(f"{name}: {launches} launched over {len(calls)} requests")
    received = sum(check_stub_logs(name, r) for r in runners)
    score_keys = {k for k in eval_log if "sim_max_reward" in k or "mean_score" in k}
    if (not log_path.endswith(".STUB.json") or set(eval_log) != EVAL_LOG_KEYS | score_keys
            or eval_log["env_backend"] != "stub" or json.load(open(log_path)) != eval_log):
        raise AssertionError(f"{name}: the log {log_path}: {sorted(eval_log)}")
    means = [eval_log[getattr(r, "log_prefix", "") + "test/mean_score"] for r in runners]
    if (abs(eval_log["test_mean_score"] - sum(means) / len(means)) > 1e-12
            or len([k for k in eval_log if "sim_max_reward" in k])
            != sum(len(r.raw_envs) for r in runners)):
        raise AssertionError(f"{name}: test_mean_score {eval_log['test_mean_score']} of {means}")
    if kind == "libero10":
        goals = {r.language_goal for r in runners}
        per_call = [call["goal"] for call in calls]
        if (len(runners) != 10 or len(goals) != 10 or set(per_call) != goals
                or sorted(set(per_call), key=per_call.index) != [r.language_goal for r in runners]):
            raise AssertionError(f"{name}: goals {per_call} for runners {goals}")
    request_ms = statistics.median(call["ms"] for call in calls)
    log(f"{name} eval: {len(runners)} runner(s), {len(calls)} requests at B={batch} "
        f"(median {request_ms:.2f} ms, by the host clock to the action on the host), "
        f"{received} actions received by the stubs; launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; {log_path} in {eval_s:.1f}s; "
        f"scores {json.dumps({k: v for k, v in eval_log.items() if 'mean_score' in k})}")

    # the first request: kernel route against plain, and fp32 card vs CPU
    first = calls[0]
    noise = {B: policy.sample_noise(B, torch.Generator(device="cuda").manual_seed(SEED + 70 + B))
             for B in (batch, 1)}
    inputs = {batch: request_inputs(policy, first["obs"], first["goal"]),
              1: request_inputs(policy, {k: v[:1] for k, v in first["obs"].items()}, first["goal"])}
    trees = eval_sim_torch.load_weights(export)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy32 = UnifiedVideoActionPolicy.from_cfg(eval_cfg, device="cuda", compute_dtype="float32")
    policy32.load_params(*trees)
    policy32.set_normalizer(policy.normalizer)
    diffs = route_check(attention_ops, policy, policy32, {batch: inputs[batch][0]},
                        {batch: noise[batch]}, REJECTED_CONTROLS_256, {batch: inputs[batch][2]},
                        {batch: inputs[batch][1]})
    cpu32 = UnifiedVideoActionPolicy.from_cfg(eval_cfg, device="cpu", compute_dtype="float32")
    cpu32.set_normalizer(policy.normalizer)
    f32_launches = fp32_card_vs_cpu(attention_ops, name, policy32, cpu32, trees, inputs[1], noise[1])
    D = c.encoder_embed_dim // c.encoder_num_heads
    del policy32, cpu32, policy
    shutil.rmtree(out, ignore_errors=True)
    perf = {"train": train, "export_s": export_s, "eval_s": eval_s, "requests": len(calls),
            "request_batch": batch, "request_ms_median": request_ms,
            "request_ms": [call["ms"] for call in calls], "stub_actions": received,
            "kernel_vs_plain": diffs, "card": card_line()}
    log(f"{name} perf: {json.dumps(perf)}")
    return perf, launches, {f"{name}_fp32_vs_cpu_b1": {f"attention_f32_d{D}": f32_launches}}


# clip: the CLIP text tower at the width of openai/clip-vit-base-patch32
CLIP_B = 8
CLIP_FP32_RTOL = 1e-4  # ||card - CPU|| / ||CPU||, both fp32 (no TF32): summation order only
CLIP_BF16_RTOL = 3e-2  # the same in bf16: 12 layers of bf16 roundings


def phase_clip() -> dict:
    """models/clip.ClipTextModel at the width of openai/clip-vit-base-patch32
    (12 layers, 512 wide, 8 heads, 77 tokens, vocabulary 49,408, projection
    512) on numpy-seeded weights, through get_text_encoder and
    ClipTextEncoder.encode_ids (the tokenizer's vocabulary is not in the
    repository: token ids drawn from a seed, the end-of-text token at
    several positions, twice in a row, and nowhere): fp32 and bf16 on the
    card against fp32 on the CPU, relative L2 within CLIP_FP32_RTOL and
    CLIP_BF16_RTOL; ms per encode by CUDA events. Its attention is causal and
    plain: no kernel launch."""
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.models.clip import ClipTextConfig, ClipTextModel
    from unified_video_action_tpu_torch.utils.language import ClipTextEncoder, get_text_encoder

    cfg = ClipTextConfig()
    with torch.device("meta"):
        weights = convert.seeded_tree(ClipTextModel(cfg), SEED + 80)
    rng = np.random.default_rng(SEED + 80)
    ids = rng.integers(1, cfg.eos_token_id, (CLIP_B, cfg.max_position_embeddings))
    for row, at in enumerate((5, 12, 30, 76, 0, 20)):
        ids[row, at] = cfg.eos_token_id
    ids[6, [3, 9]] = cfg.eos_token_id  # pooled at the first; row 7: no end-of-text token
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = ClipTextEncoder(weights, cfg, device="cpu").encode_ids(ids)
    out = {"B": CLIP_B, "tokens": cfg.max_position_embeddings, "card": card_line()}
    for dtype in (torch.float32, torch.bfloat16):
        enc, max_length = get_text_encoder("libero10", "clip", weights, device="cuda", dtype=dtype)
        if not isinstance(enc, ClipTextEncoder) or max_length != 77:
            raise AssertionError(f"clip: get_text_encoder gave {type(enc).__name__}, {max_length}")
        got = enc.encode_ids(ids)
        rel = float(np.linalg.norm(got - cpu) / np.linalg.norm(cpu))
        tag = str(dtype).replace("torch.", "")
        ms = time_ms(lambda: enc.model(torch.as_tensor(ids, device="cuda")), reps=10, rounds=3)
        out[tag] = {"rel_l2_vs_cpu_fp32": rel, "max_abs": float(np.abs(got - cpu).max()), "ms": ms}
        limit = CLIP_FP32_RTOL if dtype == torch.float32 else CLIP_BF16_RTOL
        if not np.isfinite(got).all() or got.shape != (CLIP_B, cfg.projection_dim) or rel > limit:
            raise AssertionError(f"clip {tag}: relative L2 {rel} against the CPU, limit {limit}")
        del enc
    log(f"clip: {json.dumps(out)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from unified_video_action_tpu_torch.ops import _build
    from unified_video_action_tpu_torch.ops import attention as attention_ops
    from unified_video_action_tpu_torch.ops import int8_mm as int8_ops
    from unified_video_action_tpu_torch.ops import quant

    with Phase("env"):
        card = card_line()
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"card: {card}")
    with Phase("build"):
        with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
            seconds = dict(zip(KERNEL_SOURCES, pool.map(_build.build, KERNEL_SOURCES)))
        for name in KERNEL_SOURCES:
            log(f"nvcc csrc/{name}.cu: {seconds[name]:.1f}s\n{_build.build_log(name)}")
    meta_policy, normalizer = flagship_config()
    from unified_video_action_tpu_torch import config as port_config
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
    huge_cfg = UnifiedVideoActionPolicy.from_cfg(port_config.PUSHT_HUGE96, device="meta").mar_cfg
    with Phase("kernel"):
        rows = phase_kernel(attention_ops)
        ragged_d80_rows = online_d80_ragged(attention_ops)
        width_rows = head_width_control(attention_ops)
        int8_rows = phase_kernel_int8(int8_ops, quant, int8_path_shapes(meta_policy.mar_cfg))
        int8_huge_rows = phase_kernel_int8(int8_ops, quant, int8_mar_shapes(huge_cfg), misaligned=False)
        int8_kernel_controls(int8_ops, quant, meta_policy.mar_cfg)
    trees = serving_weights(meta_policy)
    with Phase("serve"):
        launches, fp32_paths, fp32 = phase_serve(attention_ops, trees, normalizer)
    with Phase("serve_256px"):
        launches_256 = phase_serve_256px(attention_ops, normalizer, "serve_256px", port_config.PUSHT_256)
    with Phase("serve_small96"):
        launches_small96, paths = phase_serve_small(attention_ops, int8_ops, "small96",
                                                    port_config.PUSHT_SMALL96, normalizer)
        fp32_paths.update(paths)
    with Phase("serve_kitchen128"):
        launches_kitchen, paths = phase_serve_small(attention_ops, int8_ops, "kitchen128",
                                                    port_config.KITCHEN_SMALL128, None, goal=KITCHEN_GOAL,
                                                    rejected=REJECTED_CONTROLS_KITCHEN)
        fp32_paths.update(paths)
    with Phase("serve_huge96"):
        launches_huge96, paths = phase_serve_small(attention_ops, int8_ops, "huge96",
                                                   port_config.PUSHT_HUGE96, normalizer)
        fp32_paths.update(paths)
    with Phase("serve_huge256"):
        launches_huge256 = phase_serve_256px(attention_ops, normalizer, "serve_huge256",
                                             port_config.PUSHT_HUGE256)
    from unified_video_action_tpu_torch.utils.language import HashTextEncoder

    with Phase("serve_umi"):
        launches_umi, paths = phase_serve_streams(
            attention_ops, "serve_umi", port_config.UMI_MULTI, UMI_BATCHES, UMI_ROUTE_BATCH, umi_obs,
            REJECTED_CONTROLS_UMI, goal=HashTextEncoder().encode(UMI_PROMPT))
        fp32_paths.update(paths)
    with Phase("serve_toolhang"):
        launches_toolhang, paths = phase_serve_streams(
            attention_ops, "serve_toolhang", port_config.TOOLHANG, TOOLHANG_BATCHES,
            TOOLHANG_ROUTE_BATCH, toolhang_obs, REJECTED_CONTROLS_256)
        fp32_paths.update(paths)
    with Phase("real_loop"):
        launches_real, paths = phase_real_loop(attention_ops)
        fp32_paths.update(paths)
    with Phase("deployed"):
        deployed, gemm_request_ms, calls = phase_serve_deployed(
            attention_ops, int8_ops, trees, normalizer)
    with Phase("rollout"):
        rollouts = phase_rollout(attention_ops, int8_ops, trees, normalizer)
    from unified_video_action_tpu_torch.training.workspace import build_dataset

    t0 = time.perf_counter()
    corpus = build_dataset(train_run_config(1))  # the video and train_run phases' corpus
    log(f"corpus {CORPUS} read in {time.perf_counter() - t0:.1f}s")
    with Phase("video"):
        video = phase_video(attention_ops, trees, normalizer, corpus)
    fp32_paths["video_fp32_vs_cpu"] = {"attention_f32_d64":
                                       video["flagship"]["launches_fp32"]["attention_f32_d64"]}
    with Phase("train"):
        train = phase_train(attention_ops, int8_ops)
    with Phase("train_run"):
        train_run = phase_train_run(attention_ops, int8_ops, corpus)
    with Phase("pusht_pipeline"):
        pipeline = phase_pusht_pipeline(attention_ops, int8_ops, corpus)
    with Phase("train_umi"):
        train_umi = phase_train_umi(attention_ops, int8_ops)
    suites, launches_suites = {}, {}
    for kind in ("toolhang", "libero10"):
        with Phase(f"suite_{kind}"):
            suites[kind], launches_suites[f"suite_{kind}"], paths = phase_suite(
                attention_ops, int8_ops, kind)
            fp32_paths.update(paths)
    with Phase("clip"):
        clip = phase_clip()

    # the int8_gemm device time of one deployed request: profiled (cached
    # request) and modelled from the kernel phase (every layer's calls times
    # its time)
    request_ms = {f"B={B}": {"profiled": gemm_request_ms[B],
                             "modelled": int8_request_ms(int8_rows, calls, B, "gemm_ms")}
                  for B in (1, 128)}
    log(f"int8_gemm device ms per deployed request: {json.dumps(request_ms)}")

    rollout_paths = {"rollout_deployed": rollouts["a"], "rollout_plain_int8": rollouts["b"],
                     "rollout_bf16_uncached": rollouts["c"], "rollout_deployed_async": rollouts["d"]}
    attention_by_path = {"predict_action_100_steps": launches, "predict_action_256px": launches_256,
                         "predict_action_cached_deployed": deployed, **rollout_paths,
                         "serve_small96": launches_small96, "serve_kitchen128": launches_kitchen,
                         "serve_huge96": launches_huge96, "serve_huge256": launches_huge256,
                         "train_run_validation": train_run["launches"]["validate"],
                         "train_run_rollouts": train_run["launches"]["rollout"],
                         "video_fvd_flagship": video["flagship"]["launches_fvd"],
                         "sample_video_num_iter4": video["flagship"]["launches_iter"],
                         "sample_video_256px": video["256px"]["launches"],
                         "sample_video_kitchen128_cfg": video["kitchen128"]["launches"],
                         "train_run_video_fvd": train_run["launches"]["video_fvd"],
                         "serve_umi": launches_umi, "serve_toolhang": launches_toolhang,
                         "real_loop": launches_real,
                         "train_umi_validation": train_umi["launches_validate"],
                         "pusht256_host_loader_validation": pipeline["launches_validate"],
                         **launches_suites}
    attention_keys = tuple(attention_ops.launch_count) + attention_ops.INSTANCES
    attention_by_path = {path: {k: n.get(k, 0) for k in attention_keys}
                         for path, n in attention_by_path.items()}
    attention_launches = {k: sum(p[k] for p in attention_by_path.values()) for k in attention_keys}
    int8_by_path = {"predict_action_cached_deployed": deployed, "rollout_deployed": rollouts["a"],
                    "rollout_deployed_async": rollouts["d"],
                    "serve_small96": launches_small96, "serve_kitchen128": launches_kitchen,
                    "serve_huge96": launches_huge96}
    gemm_launches = {k: sum(n[k] for n in int8_by_path.values()) for k in int8_ops.GEMM_KERNELS}
    quant_launches = {k: sum(n[k] for n in int8_by_path.values()) for k in int8_ops.QUANT_KERNELS}
    int8_row = int8_rows[0]  # qkv at B=128, the path's largest int8 shape

    def timing(row: dict) -> dict:
        return {k: row[k] for k in ("instance", "split", "max_abs_err", "rel_rms_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by", "library_ms")}

    def attention_entry(name, instance, replaces, shape, **other_shapes) -> dict:
        """One entry of an attention kernel instance: its launches over the
        counted paths, and its kernel-phase row at ``shape`` (B, N, H, D)
        with the rows of ``other_shapes`` beside it."""
        B, N, H, D = shape
        return {
            "name": name, "route": "cuda",
            "source": "unified_video_action_tpu_torch/csrc/attention.cu",
            "replaces": f"unified_video_action_tpu/ops/attention.py:{replaces}",
            "launches": attention_launches[instance],
            "launches_by_path": {path: n[instance] for path, n in attention_by_path.items() if n[instance]},
            "shape": list(shape), **timing(attention_row(rows, B, N, D=D)),
            **{k: timing(attention_row(rows, b, n, D=D)) for k, (b, n) in other_shapes.items()},
        }

    # one entry per instance of the two TMA kernels, which the counted paths
    # launch, and of the fp32 kernel, which the fp32 request and the serve
    # phases' fp32 checks launch. The staged route (the staging copy, then a
    # TMA kernel) serves bf16 views off a 16-byte boundary, which no path
    # makes: it is held in the kernel phase, and its rows, the copy's entry
    # and every fp32 row are under "unaligned_and_fp32".
    staged_rows = {"attention_staged_d64": attention_row(rows, 8, 1088, D=64, aligned=False),
                   "attention_staged_d80": attention_row(rows, 8, 1024, D=80, aligned=False),
                   "attention_staged_d128": attention_row(rows, 8, 320, D=128, aligned=False)}
    stage_entry = {
        "name": "attention_stage", "route": "cuda",
        "source": "unified_video_action_tpu_torch/csrc/attention.cu",
        "replaces": "unified_video_action_tpu/ops/attention.py:161",
        "role": "copies bf16 q, k, v views that TMA cannot read into one buffer for the TMA kernels",
        "launches": attention_launches[attention_ops.STAGE],
        "launches_kernel_phase": sum(r["stage"]["launches"] for r in rows if r["staged"]),
        "shape": [8, 1088, 12, 64],
        **{k: staged_rows["attention_staged_d64"]["stage"][k]
           for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "by_d": {name: {k: r["stage"][k] for k in ("ms", "library_ms", "bound_ms")}
                 for name, r in staged_rows.items()},
    }
    side_rows = {**staged_rows,
                 **{f"{r['instance']} ({r['B']}, {r['N']}){'' if r['aligned'] else ' unaligned'}": r
                    for r in rows if r["kernel"] == "attention_f32"}}
    fp32_instances = [f"attention_f32_d{D}" for D in attention_ops.HEAD_DIMS]
    fp32_launches = {i: sum(n.get(i, 0) for n in fp32_paths.values()) for i in fp32_instances}
    if not all(fp32_launches.values()):
        raise AssertionError(f"an fp32 instance launched on no path: {fp32_launches}")

    def fp32_entry(instance: str, shape) -> dict:
        B, N, H, D = shape
        return {
            "name": f"flash_attention_f32_d{D}", "route": "cuda",
            "source": "unified_video_action_tpu_torch/csrc/attention.cu",
            "replaces": "unified_video_action_tpu/ops/attention.py:33",
            "launches": fp32_launches[instance],
            "launches_by_path": {path: n[instance] for path, n in fp32_paths.items() if n.get(instance)},
            "shape": list(shape), **timing(attention_row(rows, B, N, torch.float32, D=D)),
        }

    kernels = {"kernels": [
        {**attention_entry("flash_attention", "attention_wgmma_d64", 33, (128, 144, 12, 64), b1=(1, 144)),
         "launches_by_kernel": attention_launches,
         "unaligned_and_fp32": {**{k: {**timing(r), "shape": [r["B"], r["N"], r["H"], r["D"]]}
                                   for k, r in side_rows.items()},
                                "attention_stage": stage_entry}},
        {**attention_entry("flash_attention_online", "attention_wgmma_online_d64", 67,
                           (128, 1024, 12, 64), b1=(1, 1024), umi_b32=(32, 1088), umi_b1=(1, 1088),
                           pusht256_b16=(16, 1024)),
         "by_shape": {f"({r['B']}, {r['N']})": {"ms": r["ms"], "library_ms": r["library_ms"],
                                                "bound_ms": r["bound_ms"]}
                      for r in rows if r["instance"] == "attention_wgmma_online_d64"}},
        attention_entry("flash_attention_d128", "attention_wgmma_d128", 33, (128, 144, 6, 128),
                        b1=(1, 144)),
        attention_entry("flash_attention_online_d128", "attention_wgmma_online_d128", 67,
                        (128, 320, 6, 128), b1=(1, 320), b16=(16, 320)),
        {**attention_entry("flash_attention_d80", "attention_wgmma_d80", 33, (128, 144, 16, 80),
                           b1=(1, 144)),
         "head_width_control": width_rows},
        {**attention_entry("flash_attention_online_d80", "attention_wgmma_online_d80", 67,
                           (128, 1024, 16, 80), b1=(1, 1024), b16=(16, 1024)),
         "ragged_n": ragged_d80_rows},
        {**fp32_entry("attention_f32_d64", (128, 144, 12, 64)),
         "request_b128": {k: fp32[k] for k in ("median_ms", "attention_device_ms", "attention_instances")
                          if k in fp32}},
        fp32_entry("attention_f32_d128", (128, 144, 6, 128)),
        fp32_entry("attention_f32_d80", (128, 144, 16, 80)),
        {
            "name": "int8_gemm",
            "route": "cuda",
            "source": "unified_video_action_tpu_torch/csrc/int8_mm.cu",
            "replaces": "unified_video_action_tpu/ops/int8_mm.py:32",
            "launches": sum(gemm_launches.values()),
            "launches_by_kernel": gemm_launches,
            "launches_by_path": {path: sum(n[k] for k in int8_ops.GEMM_KERNELS)
                                 for path, n in int8_by_path.items()},
            "shape": [int8_row["M"], int8_row["K"], int8_row["N"]],
            "kernel": int8_row["kernel"],
            "max_abs_err": int8_row["bit_equal"]["max_abs_err"],
            "ms": int8_row["gemm_ms"],
            "s32_ms": int8_row["gemm_s32_ms"],
            "plain_ms": int8_row["gemm_plain_ms"],
            "bound_ms": int8_row["gemm_bound_ms"],
            "bound_by": int8_row["gemm_bound_by"],
            "library_ms": int8_row["gemm_library_ms"],
            "request_ms": request_ms,
        }, {
            "name": "quantize_rows",
            "route": "cuda",
            "source": "unified_video_action_tpu_torch/csrc/int8_mm.cu",
            "replaces": "unified_video_action_tpu/ops/int8_mm.py:96",
            "launches": sum(quant_launches.values()),
            "launches_by_kernel": quant_launches,
            "launches_by_path": {path: sum(n[k] for k in int8_ops.QUANT_KERNELS)
                                 for path, n in int8_by_path.items()},
            "shape": [int8_row["M"], int8_row["K"]],
            "kernel": int8_row["rows_kernel"],
            "max_abs_err": int8_row["bit_equal"]["x_q_max_abs_err"],
            "ms": int8_row["rows_ms"],
            "plain_ms": int8_row["rows_plain_ms"],
            "bound_ms": int8_row["rows_bound_ms"],
            "bound_by": int8_row["rows_bound_by"],
            "library_ms": None,
            "ms_by_shape": {f"{r['layer']} ({r['M']}, {r['K']})": r["rows_ms"]
                            for r in int8_rows + int8_huge_rows},
            "kernel_by_shape": {f"{r['layer']} ({r['M']}, {r['K']})": r["rows_kernel"]
                                for r in int8_rows + int8_huge_rows},
            "scalar_ms_by_shape": {f"{r['layer']} ({r['M']}, {r['K']})": r["rows_scalar_ms"]
                                   for r in int8_rows + int8_huge_rows if "rows_scalar_ms" in r},
        },
    ]}
    log(f"train: {json.dumps({k: train[k] for k in ('perf', 'overfit', 'run_s')})}")
    log(f"train_run: {json.dumps(train_run['perf'])}")
    log(f"train_umi: {json.dumps(train_umi['perf'])}")
    log(f"pusht_pipeline: {json.dumps(pipeline['perf'])}")
    for kind, perf in suites.items():
        log(f"suite_{kind}: {json.dumps({k: v for k, v in perf.items() if k != 'kernel_vs_plain'})}")
    log(f"clip: {json.dumps(clip)}")
    log(f"video: {json.dumps({'fvd': video['flagship']['fvd'], 'stages': video['flagship']['stages'], 'psnr': video['flagship']['psnr']})}")
    log(f"total {time.perf_counter() - _T0:.1f}s")
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
