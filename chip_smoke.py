#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's PushT serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its elapsed seconds; a phase that fails raises, and the
script exits non-zero without its result line):

1. env    torch and CUDA versions, the card's name and power limit.
2. build  the attention kernel, unified_video_action_tpu_torch/csrc/attention.cu, by nvcc.
3. kernel each kernel against its plain PyTorch version on the card, at the
          serving path's shapes and beyond, with times beside its bound and
          beside one PyTorch library call computing the same function.
4. serve  UnifiedVideoActionPolicy.predict_action at the flagship's width
          (mar_base: 12+12 blocks, d=768, 12 heads, 96 px, 144 tokens), in
          bf16 at B=1 and B=128 with 100 sampler steps. The VAE weights are
          the committed pusht_vae96.npz; the MAR and denoiser weights are
          numpy draws from a seed in the flax layout, through the weight
          bridge (the flagship's orbax checkpoint needs JAX to be read).
          Checks: shape, finite values inside the normalizer's range, the
          kernel launched once per ViT block per call, the kernel route
          against the plain-attention route under the same noise, controls
          (the kernel with planted faults, which that comparison must
          reject), and the card in fp32 against the port on the CPU in fp32.

The last lines are the card (``nvidia-smi`` name and power limit), one JSON
object with every kernel's numbers, and the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
It needs one card and reads only files of this repository.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
LATEST = os.path.join(REPO, "pretrained_models", "uva_pusht_small", "latest")
VAE_NPZ = os.path.join(REPO, "pretrained_models", "vae", "pusht_vae96.npz")
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32: outside the tensor cores
# attention: atol of tests/test_ops.py
ATTN_ATOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
# serve, the kernel route against the plain route in bf16 under the same
# noise (P is rounded to bf16 in the kernel and not in the plain version):
# - the decoder output that conditions the action head, after 24 bf16
#   blocks, measured against the same blocks in fp32: the kernel route's
#   mean |z - z_fp32| may exceed the plain route's (the bf16 floor of the
#   model) by at most this factor. The kernel's ratio is about 1.0; a
#   softmax scale 10 % off gives about 1.2 (the controls below).
SERVE_Z_FLOOR_RATIO = 1.1
# - the normalized action chunk ([-1, 1]): mean |da| and the 99th percentile
#   of |da|. Not the max: the sampler's first step multiplies x and eps by
#   about 2e4 before clipping x0 to [-1, 1], so an element whose terms nearly
#   cancel lands on either side under any bf16-level change of z.
SERVE_ACTION_MEAN_ATOL = 1e-2
SERVE_ACTION_P99_ATOL = 5e-2
# the planted faults (``control_faults``) that those limits must reject; the
# smaller scale errors are printed to show how far the limits see
REJECTED_CONTROLS = ("exp_base_2", "unmasked_kv_edge", "scale_x1.1")
KV_TILE = 64  # the kernel's KV tile (csrc/attention.cu)
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


def attention_bound(B: int, N: int, H: int, D: int, dtype: torch.dtype):
    """Least time for (B, N, H, D) attention: q, k, v read once, out written
    once, and 4·B·H·N²·D operations at the type's peak."""
    item = torch.finfo(dtype).bits // 8
    t_bytes = 4 * B * N * H * D * item / HBM_BYTES_PER_S
    t_ops = 4 * B * H * N * N * D / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(attention_ops):
    cases = [
        (128, 144, 12, torch.bfloat16), (128, 144, 12, torch.float32),
        (8, 100, 12, torch.bfloat16), (8, 100, 12, torch.float32),
        (8, 1088, 12, torch.bfloat16), (8, 1088, 12, torch.float32),
        (1, 2304, 12, torch.bfloat16), (1, 2304, 12, torch.float32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for B, N, H, dtype in cases:
        # the layout the fused qkv projection gives the kernel: strided views
        qkv = torch.randn(B, N, 3, H, 64, generator=gen, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
        out = attention_ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attention_ops.attention_plain(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        ok = err <= ATTN_ATOL[dtype] and bool(torch.isfinite(out).all())
        ms = time_ms(lambda: attention_ops.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: attention_ops.attention_plain(q, k, v), reps=5)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound_ms, bound_by = attention_bound(B, N, H, 64, dtype)
        row = dict(B=B, N=N, H=H, D=64, dtype=str(dtype).split(".")[-1], max_abs_err=err,
                   atol=ATTN_ATOL[dtype], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        log("attention " + json.dumps(row))
        if not ok:
            raise AssertionError(f"attention kernel disagrees with its plain version: {row}")
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


def normalized(policy, actions: torch.Tensor) -> torch.Tensor:
    return policy.normalizer["action"].normalize(actions.float())


def check_actions(policy, actions: torch.Tensor, batch: int) -> None:
    if tuple(actions.shape) != (batch, 16, 2):
        raise AssertionError(f"action chunk shape {tuple(actions.shape)} != {(batch, 16, 2)}")
    if not bool(torch.isfinite(actions).all()):
        raise AssertionError("non-finite actions")
    # x0 is clipped to [-1, 1] and the last step adds no noise, so the
    # normalized chunk lies in [-1, 1]
    span = normalized(policy, actions).abs().max().item()
    if span > 1.0 + 1e-2:
        raise AssertionError(f"normalized actions reach {span}, outside [-1, 1]")


def breakdown(policy, frames: torch.Tensor, noise, reps: int = 5) -> dict:
    """One request's stages by CUDA events (median ms of ``reps``; the gaps
    the host leaves between launches count in the stage they fall in), and
    the device's busy share of one request by ``torch.profiler``, with the
    kernels that took most device time."""
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
    else:
        out["device_idle_share"] = "not measured (the profiler saw no device time)"
    return out


def phase_serve(attention_ops):
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer
    from unified_video_action_tpu_torch.models import transformer
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    meta = os.path.join(LATEST, "meta.json")
    normalizer = LinearNormalizer.load(os.path.join(LATEST, "normalizer.npz"))

    def make_policy(device: str, dtype: str):
        p = UnifiedVideoActionPolicy.from_run_config(meta, device=device, compute_dtype=dtype)
        p.set_normalizer(normalizer)
        return p

    policy = make_policy("cuda", "bfloat16")
    c = policy.mar_cfg
    log(f"policy: mar {c.encoder_depth}+{c.decoder_depth} blocks, d={c.encoder_embed_dim}, "
        f"{c.encoder_num_heads} heads, {c.img_size}px, {c.total_tokens} tokens, "
        f"{policy.mar.diffactloss.num_steps} sampler steps, {policy.dtype}")
    mar_tree = convert.seeded_tree(policy.mar, SEED)
    if not os.path.isfile(VAE_NPZ):
        raise FileNotFoundError(f"the committed VAE weights are missing: {VAE_NPZ}")
    vae_tree = convert.load_flat_npz(VAE_NPZ)
    policy.load_params(mar_tree, vae_tree)
    n_mar = sum(p.numel() for p in policy.mar.parameters())
    n_vae = sum(p.numel() for p in policy.vae.parameters())
    log(f"weights: MAR+denoiser {n_mar / 1e6:.1f}M numpy-seeded (seed {SEED}) in flax layout "
        f"through convert.py (the orbax flagship needs JAX to be read); "
        f"VAE encoder {n_vae / 1e6:.1f}M from pretrained_models/vae/pusht_vae96.npz; normalizer from latest/normalizer.npz")

    rng = np.random.default_rng(SEED)
    frames = {B: torch.from_numpy(rng.integers(0, 256, (B, 4, 3, 96, 96), dtype=np.uint8))
              for B in (1, 128)}
    noise = {B: policy.sample_noise(B, torch.Generator(device="cuda").manual_seed(SEED + B))
             for B in (1, 128)}

    # warm-up (cuBLAS/cuDNN handles, kernel library load): not counted
    for B in (1, 128):
        policy.predict_action(frames[B], noise=noise[B])
    torch.cuda.synchronize()

    # the main path: one request at B=1 and one at B=128, counted
    attention_ops.launch_count = 0
    actions = {}
    per_call = {}
    for B in (1, 128):
        before = attention_ops.launch_count
        actions[B] = policy.predict_action(frames[B], noise=noise[B])
        torch.cuda.synchronize()
        per_call[B] = attention_ops.launch_count - before
    launches = attention_ops.launch_count
    blocks = c.encoder_depth + c.decoder_depth
    log(f"attention launches: {per_call} per call, {launches} in all ({blocks} blocks per call)")
    for B in (1, 128):
        check_actions(policy, actions[B], B)
        if per_call[B] != blocks:
            raise AssertionError(f"B={B}: {per_call[B]} attention launches, want {blocks}")

    # fp32 on the card, matmuls and convolutions without TF32: the reference
    # for the bf16 routes here, and held against the CPU below
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy32 = make_policy("cuda", "float32")
    policy32.load_params(mar_tree, vae_tree)

    # the kernel route against the plain route, same weights and noise
    refs = {}
    with torch.no_grad():
        policy.set_attn_impl("plain")
        for B in (1, 128):
            cond = policy._encode_frames(policy._prep_frames(frames[B].cuda()), noise[B]["vae"])
            policy32.set_attn_impl("plain")
            z_ref = policy32.mar.policy_latents(cond)
            policy32.set_attn_impl("kernel")
            refs[B] = {
                "cond": cond, "z_ref": z_ref,
                "z_plain": policy.mar.policy_latents(cond).float(),
                "actions": normalized(policy, policy.predict_action(frames[B], noise=noise[B])),
            }
        policy.set_attn_impl("kernel")

    def against_plain(B: int, route_actions: torch.Tensor) -> dict:
        """The route ``policy`` is set to, against the plain route, at batch B."""
        r = refs[B]
        with torch.no_grad():
            z = policy.mar.policy_latents(r["cond"]).float()
        da = (normalized(policy, route_actions) - r["actions"]).abs().flatten()
        return {
            "z_err_kernel": (z - r["z_ref"]).abs().mean().item(),
            "z_err_plain": (r["z_plain"] - r["z_ref"]).abs().mean().item(),
            "z_kernel_vs_plain_max": (z - r["z_plain"]).abs().max().item(),
            "z_max": r["z_ref"].abs().max().item(),
            "action_mean": da.mean().item(),
            "action_p99": torch.quantile(da, 0.99).item(),
            "action_max": da.max().item(),
        }

    def within_limits(d: dict) -> bool:
        return (d["z_err_kernel"] <= SERVE_Z_FLOOR_RATIO * d["z_err_plain"]
                and d["action_mean"] <= SERVE_ACTION_MEAN_ATOL
                and d["action_p99"] <= SERVE_ACTION_P99_ATOL)

    diffs = {B: against_plain(B, actions[B]) for B in (1, 128)}
    log(f"kernel vs plain attention, bf16: {json.dumps(diffs)}; limits: z_err_kernel <= "
        f"{SERVE_Z_FLOOR_RATIO} z_err_plain, action_mean {SERVE_ACTION_MEAN_ATOL}, "
        f"action_p99 {SERVE_ACTION_P99_ATOL}")
    for B, d in diffs.items():
        if not within_limits(d):
            raise AssertionError(f"B={B}: kernel route disagrees with the plain route: {d}")

    # controls: the kernel with a planted fault must fail those limits (at
    # B=1 or B=128), else the limits could not tell a wrong kernel
    controls = control_faults(attention_ops)
    control_diffs = {}
    try:
        for name, fault in controls.items():
            transformer.ATTN_IMPLS["control"] = fault
            policy.set_attn_impl("control")
            control_diffs[name] = {
                B: against_plain(B, policy.predict_action(frames[B], noise=noise[B]))
                for B in (1, 128)
            }
            control_diffs[name]["rejected"] = not all(
                within_limits(control_diffs[name][B]) for B in (1, 128))
    finally:
        policy.set_attn_impl("kernel")
        transformer.ATTN_IMPLS.pop("control", None)
    log(f"controls, faulty kernels against the plain route: {json.dumps(control_diffs)}")
    passed = [name for name, d in control_diffs.items()
              if name in REJECTED_CONTROLS and not d["rejected"]]
    if passed:
        raise AssertionError(f"faulty kernels pass the serve limits: {passed}")

    # timing: CUDA events around whole requests, after the warm-up
    def request_ms(B: int, reps: int):
        dev, host = [], []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            policy.predict_action(frames[B], noise=noise[B])
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(start.elapsed_time(end))
        return statistics.median(dev), statistics.median(host)

    torch.cuda.reset_peak_memory_stats()
    p50_b1, host_b1 = request_ms(1, 9)
    ms_b128, host_b128 = request_ms(128, 5)
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
        log(f"where the time goes, B={B}: " + json.dumps(breakdown(policy, frames[B], noise[B])))

    # the card in fp32 (kernel route) against the port on the CPU in fp32
    cpu32 = make_policy("cpu", "float32")
    cpu32.load_params(mar_tree, vae_tree)
    cpu_noise = {k: v.cpu() for k, v in noise[1].items()}
    on_card = policy32.predict_action(frames[1], noise=cpu_noise).cpu()
    on_cpu = cpu32.predict_action(frames[1], noise=cpu_noise)
    d = (normalized(policy, on_card) - normalized(policy, on_cpu)).abs().max().item()
    log(f"card fp32 vs CPU fp32, B=1, normalized actions: max abs {d}; atol {SERVE_FP32_ATOL}")
    if d > SERVE_FP32_ATOL:
        raise AssertionError(f"the card's fp32 run disagrees with the CPU's: {d}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from unified_video_action_tpu_torch.ops import _build
    from unified_video_action_tpu_torch.ops import attention as attention_ops

    with Phase("env"):
        card = card_line()
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"card: {card}")
    with Phase("build"):
        seconds = _build.build("attention")
        log(f"nvcc csrc/attention.cu: {seconds:.1f}s\n{_build.build_log('attention')}")
    with Phase("kernel"):
        rows = phase_kernel(attention_ops)
    with Phase("serve"):
        launches = phase_serve(attention_ops)

    path_row = rows[0]  # B=128 N=144 H=12 D=64 bf16: the serving path's shape
    kernels = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "unified_video_action_tpu_torch/csrc/attention.cu",
        "replaces": "unified_video_action_tpu/ops/attention.py:33",
        "launches": launches,
        "max_abs_err": path_row["max_abs_err"],
        "ms": path_row["ms"],
        "plain_ms": path_row["plain_ms"],
        "bound_ms": path_row["bound_ms"],
        "bound_by": path_row["bound_by"],
        "library_ms": path_row["library_ms"],
    }]}
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
