#!/usr/bin/env python3
"""Time the kernels of one tree of the port, for an A/B in turns on one card.

    python3 unified_video_action_tpu_torch/tools/kernels_ab.py --tree DIR [--out FILE]

Imports ``unified_video_action_tpu_torch`` from DIR (this repository's root,
or an earlier commit's package unpacked by ``git archive`` into a git-ignored
directory), builds its kernels under DIR and measures, at the serving
paths' shapes at mar_base width (B=128 and B=1):

* device time per ``flash_attention`` launch at (B, 144, 12, 64) and at the
  256 px path's (B, 1024, 12, 64) bf16, by replaying a CUDA graph of 20
  launches (chip_smoke.py's ``graph_ms``), and host time per call (below);
* device time per ``quantize_rows`` launch at each shape of chip_smoke.py's
  ``int8_path_shapes``, by CUDA-graph replay;
* device time per ``int8_gemm`` launch at each shape of chip_smoke.py's
  ``int8_path_shapes``, by replaying a CUDA graph of 20 launches
  (chip_smoke.py's ``graph_ms``): with the path's epilogue (rescale, cast,
  bias) and with s32 out;
* host time per call of ``w8a8_linear`` and of ``int8_gemm`` at the B=1
  shapes: the wrapper's Python, its checks and the ctypes call, with 200
  calls queued and not waited for (the card keeps up, so this is the host's
  time);
* the deployed tier's request (ddim10, W8A8 int8, yuv420,
  ``predict_action_cached``), median host-clock time of cached calls at B=1
  and B=128, with chip_smoke.py's seeded weights and windows;
* the 256 px request (this repository's ``config.PUSHT_256``, 100 steps,
  bf16, numpy-seeded weights): median time of ``predict_action_frames`` at
  B=1 and B=128, by CUDA events and on the host clock;
* ``attention_variants`` (only with ``--parts``; needs a tree with the
  online-softmax kernel): every bf16 attention kernel variant of the tree's
  C interface at each of ``VARIANT_SHAPES`` (head dimension 64, 12 heads:
  mar_base) and, at each other head dimension the tree builds, of
  ``VARIANT_SHAPES_D128`` (6 heads of 128: mar_small, the 96 px path's N =
  144 and the kitchen path's N = 320) and ``VARIANT_SHAPES_D80`` (16 heads
  of 80: mar_huge, the 96 px path's N = 144 and the 256 px path's N =
  1024), whatever
  ``attention_plan`` would pick (the single-pass kernel at N <= 144, split
  per q-tile or whole heads; the online kernel in 128- or 64-row work
  items), each held against ``attention_plain``
  (chip_smoke.py's ``attention_check``) and timed by CUDA-graph replay
  beside SDPA and the bound: the measurement behind ``attention_plan``'s
  crossover and split thresholds, per head dimension (``--head-dims``
  picks some of the tree's). The call exits non-zero if a variant
  disagrees with the plain version.

* ``fp32_attention``: ``flash_attention`` in fp32 at the three serving
  shapes at N = 144, (8, 1088, 12, 64) and (128, 1024, 12, 64), beside SDPA;
  ``fp32_request``: the fp32 mar_base request at B=128 (chip_smoke.py's
  ``fp32_request``). Both run on any tree: the before and after of the fp32
  kernel.
* ``tf32_tiles`` (only with ``--parts``; needs a tree with the 3xTF32
  kernel): every tile of the fp32 kernel at each head dimension beside SDPA
  and the bound; ``tf32_sass``: each fp32 instance's machine code, its
  instructions per tensor-core product.

The configs, the weights and chip_smoke.py's helpers are this repository's,
whichever tree is timed. ``--parts`` picks what to measure (all but
``attention_variants``, ``tf32_tiles`` and ``tf32_sass`` by default).
Run it for two trees in one call, in turns (A, B, B, A), and compare only
within that call. Prints one JSON line, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_smoke():
    """This repository's chip_smoke.py as a module, loaded by path (a tree
    under test may hold another chip_smoke.py)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_smoke()


def host_us(fn, calls: int = 200, rounds: int = 5) -> float:
    """Median over ``rounds`` of the host time per call (us) of ``calls``
    calls, launched without waiting for the card."""
    fn()
    per_round = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_round.append((time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return statistics.median(per_round)


def _load_config():
    """This repository's port config module, loaded by path (a tree under
    test may predate ``PUSHT_256``)."""
    path = os.path.join(REPO, "unified_video_action_tpu_torch", "config", "__init__.py")
    spec = importlib.util.spec_from_file_location("port_config", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def attention_rows(attention, cfg) -> list:
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    rows = []
    H = cfg.encoder_num_heads
    for B, N in ((128, cfg.total_tokens), (1, cfg.total_tokens), (128, 1024), (1, 1024)):
        qkv = torch.randn(B, N, 3, H, 64, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        row = {"B": B, "N": N, "H": H,
               "us": 1e3 * smoke.graph_ms(lambda: attention.flash_attention(q, k, v)),
               "host_us": host_us(lambda: attention.flash_attention(q, k, v))}
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
    return rows


def quantize_rows(int8_mm, cfg) -> list:
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    rows = []
    for layer, M, K, N, dtype in smoke.int8_path_shapes(cfg):
        x = smoke.int8_inputs(M, K, N, dtype, gen)[0]
        row = {"layer": layer, "M": M, "K": K, "x_dtype": str(dtype).split(".")[-1],
               "us": 1e3 * smoke.graph_ms(lambda: int8_mm.quantize_rows(x))}
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
    return rows


def gemm_rows(int8_mm, cfg) -> list:
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    rows = []
    for layer, M, K, N, dtype in smoke.int8_path_shapes(cfg):
        x, w_q, w_scale, bias = smoke.int8_inputs(M, K, N, dtype, gen)
        x_q, x_scale = int8_mm.quantize_rows(x)
        row = {"layer": layer, "M": M, "K": K, "N": N,
               "epilogue_us": 1e3 * smoke.graph_ms(
                   lambda: int8_mm.int8_gemm(x_q, w_q, x_scale, w_scale, bias, dtype)),
               "s32_us": 1e3 * smoke.graph_ms(lambda: int8_mm.int8_gemm(x_q, w_q))}
        if layer.endswith(" B=1"):
            row["host_us_int8_gemm"] = host_us(
                lambda: int8_mm.int8_gemm(x_q, w_q, x_scale, w_scale, bias, dtype))
            row["host_us_w8a8_linear"] = host_us(lambda: int8_mm.w8a8_linear(x, w_q, w_scale, bias))
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
    return rows


def deployed_requests(int8_mm, meta_policy, normalizer) -> dict:
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    meta = os.path.join(smoke.LATEST, "meta.json")
    with open(meta) as f:
        amp = json.load(f)["cfg"]["model"]["policy"]["autoregressive_model_params"]
    amp = dict(amp, act_diff_testing_steps="ddim10")
    policy = UnifiedVideoActionPolicy.from_run_config(
        meta, device="cuda", compute_dtype="bfloat16", autoregressive_model_params=amp,
        obs_codec="yuv420", serving_quant="int8")
    policy.set_normalizer(normalizer)
    policy.load_params(*smoke.serving_weights(meta_policy))
    rng = np.random.default_rng(smoke.SEED + 2)
    out = {}
    for B, reps in ((1, 21), (128, 5)):
        windows = [{"image": rng.integers(0, 256, (B, 16, 3, 96, 96), dtype=np.uint8)}
                   for _ in range(2)]
        gen = torch.Generator(device="cuda").manual_seed(smoke.SEED + 10 + B)
        noise = (policy.sample_noise(B, gen, n_new=4), policy.sample_noise(B, gen, n_new=2))
        _, cache = policy.predict_action_cached(windows[0], noise=noise[0])
        policy.predict_action_cached(windows[1], cache=cache, n_shift=8, noise=noise[1])  # warm-up
        before = dict(int8_mm.launch_count)
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            policy.predict_action_cached(windows[1], cache=cache, n_shift=8, noise=noise[1])
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"B={B}"] = {"median_cached_ms": statistics.median(ms), "cached_ms": ms,
                         "launches_per_request": {k: (int8_mm.launch_count[k] - before[k]) / reps
                                                  for k in int8_mm.launch_count}}
    return out


def requests_256px(normalizer) -> dict:
    from unified_video_action_tpu_torch import convert
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    policy = UnifiedVideoActionPolicy.from_cfg(_load_config().PUSHT_256, device="cuda")
    policy.set_normalizer(normalizer)
    policy.load_params(convert.seeded_tree(policy.mar, smoke.SEED),
                       convert.seeded_tree(policy.vae, smoke.SEED + 1))
    rng = np.random.default_rng(smoke.SEED + 30)
    out = {}
    for B, reps in ((1, 9), (128, 5)):
        frames = torch.from_numpy(rng.integers(0, 256, (B, 4, 3, 96, 96), dtype=np.uint8))
        noise = policy.sample_noise(B, torch.Generator(device="cuda").manual_seed(smoke.SEED + 30 + B))
        policy.predict_action_frames(frames, noise=noise)  # warm-up
        dev, host = [], []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            policy.predict_action_frames(frames, noise=noise)
            end.record()
            end.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            dev.append(start.elapsed_time(end))
        out[f"B={B}"] = {"median_ms": statistics.median(dev), "median_host_ms": statistics.median(host),
                         "ms": dev}
        print(json.dumps({"serve_256px": B, **out[f"B={B}"]}), file=sys.stderr, flush=True)
    return out


def fp32_request(meta_policy, normalizer) -> dict:
    """The flagship's width in fp32 (compute_dtype="float32": the fp32
    attention kernel at D = 64 in each of the 24 ViT blocks; matmuls and
    convolutions without TF32), chip_smoke.py's seeded weights and frames:
    ``predict_action_frames`` at B=128, 100 steps, by CUDA events
    (chip_smoke.py's ``fp32_request``)."""
    from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    policy = UnifiedVideoActionPolicy.from_run_config(os.path.join(smoke.LATEST, "meta.json"),
                                                      device="cuda", compute_dtype="float32")
    policy.set_normalizer(normalizer)
    policy.load_params(*smoke.serving_weights(meta_policy))
    out = smoke.fp32_request(policy)
    print(json.dumps({"fp32_request": out}), file=sys.stderr, flush=True)
    return out


VARIANT_SHAPES = [
    (128, 1024), (1, 1024), (8, 1088), (1, 2304), (2, 1088), (8, 1000), (8, 257),
    (128, 257), (32, 512), (128, 384), (8, 384),
    (128, 256), (8, 256), (1, 256), (128, 200), (8, 200), (1, 200),
    (128, 145), (8, 145), (1, 145), (128, 144), (8, 144), (1, 144), (4, 1),
]
# head dimension 128 (6 heads): the batches around each split threshold at
# the mar_small paths' N = 144 (18 q-tiles of 64 rows per sample) and N =
# 320 (18 work items of 128 rows per sample), and ragged N
VARIANT_SHAPES_D128 = [
    (1, 144), (2, 144), (4, 144), (8, 144), (12, 144), (16, 144), (24, 144), (32, 144),
    (64, 144), (128, 144), (8, 137),
    (1, 320), (4, 320), (8, 320), (12, 320), (16, 320), (22, 320), (24, 320), (32, 320),
    (64, 320), (128, 320), (8, 257), (8, 1000),
]
# head dimension 80 (16 heads): mar_huge's N = 144 and N = 1024 (128 work
# items of 128 rows per sample), the item counts around the online kernel's
# split threshold (16 heads x 2 to 6 KV tiles at B = 1: 32 to 96 items),
# and ragged N
VARIANT_SHAPES_D80 = [
    (1, 144), (8, 144), (16, 144), (128, 144), (8, 137),
    (1, 145), (1, 256), (1, 384), (1, 500), (1, 512), (1, 640), (1, 768), (2, 512),
    (1, 1024), (2, 1024), (3, 1024), (4, 1024), (8, 1024), (16, 1024), (128, 1024), (8, 1000),
]
VARIANT_SHAPES_BY_D = {64: VARIANT_SHAPES, 80: VARIANT_SHAPES_D80, 128: VARIANT_SHAPES_D128}
HEADS = {64: 12, 80: 16, 128: 6}


def attention_variants(attention, head_dims) -> list:
    lib = attention._lib()
    if not hasattr(lib, "uva_flash_attention_online"):
        raise RuntimeError("attention_variants needs a tree with uva_flash_attention_online")
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    dtype = torch.bfloat16
    rows, bad = [], []
    shapes = [(B, N, D) for D in head_dims for B, N in VARIANT_SHAPES_BY_D[D]]
    for B, N, D in shapes:
        H = HEADS[D]
        qkv = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
        want = attention.attention_plain(q, k, v)
        out = torch.empty(B, N, H, D, dtype=dtype, device="cuda")
        base = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, D,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        variants = {"online": (lib.uva_flash_attention_online, (0,)),
                    "online_split": (lib.uva_flash_attention_online, (1,))}
        if N <= attention.SINGLE_PASS_MAX_N:
            variants.update(single_pass_split=(lib.uva_flash_attention_wgmma, (1,)))
            if D == 64:  # at D = 80 and 128 only the split instance is built
                variants.update(single_pass=(lib.uva_flash_attention_wgmma, (0,)))
        plan = (attention.attention_plan(B, N, H, D, dtype) if hasattr(attention, "HEAD_DIMS")
                else attention.attention_plan(B, N, H, dtype))
        row = {"B": B, "N": N, "H": H, "D": D, "plan": plan.__dict__}
        for name, (fn, extra) in variants.items():
            def call(fn=fn, extra=extra, name=name):
                # the current stream: a CUDA graph captures on its own
                rc = fn(*base, *extra, torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            out.zero_()
            call()
            torch.cuda.synchronize()
            errs, ok = smoke.attention_check(out, want)
            if not ok:
                bad.append((B, N, D, name, errs))
            row[name] = {**errs, "ok": ok, "ms": smoke.graph_ms(call) if ok else None}
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row["sdpa_ms"] = smoke.graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        row["bound_ms"], row["bound_by"] = smoke.attention_bound(B, N, H, D, dtype)
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
    if bad:
        raise AssertionError(f"attention variants disagree with the plain version: {bad}")
    return rows


# the fp32 kernel's tiles (m16 tiles a warp, KV rows a tile; 4 warps a CTA)
# that uva_flash_attention_tf32_tile builds at each head dimension, and the
# fp32 shapes they are swept at: each fp32 serving path's N (144; the
# kitchen's 320 at D = 128; the 256 px paths' 1024) at B = 1 and 128, a
# ragged N and N = 2304 (the longest accumulation)
TF32_TILES = {64: ((1, 32), (1, 48), (1, 64), (2, 32), (2, 64)),
              80: ((1, 32), (1, 48), (1, 64)), 128: ((1, 32), (1, 48), (1, 64))}
TF32_SHAPES = {
    64: [(1, 144), (128, 144), (8, 1088), (128, 1024), (1, 2304)],
    80: [(1, 144), (128, 144), (8, 1000), (128, 1024), (1, 2304)],
    128: [(1, 144), (128, 144), (16, 320), (128, 320), (8, 1000), (1, 2304)],
}


# the fp32 shapes the wrapper is timed at, any tree: the three serving
# shapes at N = 144, a long row, and the 256 px path's fp32 shape
FP32_SHAPES = [(128, 144, 12, 64), (128, 144, 6, 128), (128, 144, 16, 80), (8, 1088, 12, 64),
               (128, 1024, 12, 64)]


def fp32_attention(attention) -> list:
    """``flash_attention`` on fp32 views of one qkv tensor at each of
    ``FP32_SHAPES`` (the kernel the tree's plan names), held against
    ``attention_plain`` and timed by CUDA-graph replay beside SDPA and the
    bound."""
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    rows = []
    for B, N, H, D in FP32_SHAPES:
        q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").unbind(2)
        errs, ok = smoke.attention_check(attention.flash_attention(q, k, v),
                                         attention.attention_plain(q, k, v))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row = {"B": B, "N": N, "H": H, "D": D, **errs, "ok": ok,
               "ms": smoke.graph_ms(lambda: attention.flash_attention(q, k, v)),
               "sdpa_ms": smoke.graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               "bound_ms": smoke.attention_bound(B, N, H, D, torch.float32)[0]}
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
    return rows


def tf32_tiles(attention, head_dims) -> list:
    """Every tile of the fp32 (3xTF32) kernel at each of ``TF32_SHAPES``,
    held against ``attention_plain`` (chip_smoke.py's ``attention_check``)
    and timed by CUDA-graph replay beside the wrapper (the tile it takes),
    SDPA and the bound: the measurement behind csrc/attention.cu's
    ``launch_tf32_default``. Raises if a tile disagrees with the plain version."""
    lib = attention._lib()
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    rows, bad = [], []
    for D in head_dims:
        H = HEADS[D]
        for B, N in TF32_SHAPES[D]:
            q, k, v = torch.randn(B, N, 3, H, D, generator=gen, device="cuda").unbind(2)
            want = attention.attention_plain(q, k, v)
            out = torch.empty(B, N, H, D, device="cuda")
            base = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, D,
                    *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
            row = {"B": B, "N": N, "H": H, "D": D}
            for tile in TF32_TILES[D]:
                def call(tile=tile):
                    rc = lib.uva_flash_attention_tf32_tile(*base, *tile, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"tf32 tile {tile}: CUDA error {rc}")
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                errs, ok = smoke.attention_check(out, want)
                if not ok:
                    bad.append((B, N, D, tile, errs))
                row["x".join(map(str, tile))] = {**errs, "ok": ok, "ms": smoke.graph_ms(call) if ok else None}
            row["wrapper_ms"] = smoke.graph_ms(lambda: attention.flash_attention(q, k, v))
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            row["sdpa_ms"] = smoke.graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
            row["bound_ms"], row["bound_by"] = smoke.attention_bound(B, N, H, D, torch.float32)
            print(json.dumps(row), file=sys.stderr, flush=True)
            rows.append(row)
    if bad:
        raise AssertionError(f"tf32 tiles disagree with the plain version: {bad}")
    return rows


def tf32_sass(attention) -> dict:
    """The machine code of each fp32 (3xTF32) kernel instance in the tree's
    built library, by ``cuobjdump -sass`` (beside nvcc): its instructions,
    its HMMA (tensor-core) instructions among them and the most frequent
    opcodes. The kernel's loop over a KV tile is unrolled whole, so their
    ratio bounds from above the instructions issued per tensor-core product
    (the code run once a CTA, before and after the loop, counts too)."""
    import collections
    import re
    import subprocess

    from unified_video_action_tpu_torch.ops import _build

    attention._lib()
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path("attention"))],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0].strip()
        if "attn_tf32_kernel" not in name:
            continue
        ops = collections.Counter(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body))
        args = re.search(r"attn_tf32_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E", name)
        key = "D={} m_tiles={} kv_rows={} aligned={}".format(*args.groups()) if args else name
        out[key] = {"instructions": sum(ops.values()), "hmma": ops["HMMA"],
                    "per_hmma": sum(ops.values()) / max(ops["HMMA"], 1), "top": ops.most_common(12)}
    print(json.dumps({"tf32_sass": out}), file=sys.stderr, flush=True)
    return out


PARTS = ("attention", "quantize_rows", "gemm", "deployed", "serve_256px", "fp32_attention",
         "fp32_request", "attention_variants", "tf32_tiles", "tf32_sass")
DEFAULT_PARTS = PARTS[:-3]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="directory that holds unified_video_action_tpu_torch/")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--parts", default=",".join(DEFAULT_PARTS), help=f"comma-separated, of {PARTS}")
    ap.add_argument("--head-dims", help="comma-separated head dimensions for attention_variants and "
                                        "tf32_tiles (default: every one the tree builds)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernels_ab: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from unified_video_action_tpu_torch.ops import attention, int8_mm

    for module in (attention, int8_mm):
        if not module.__file__.startswith(tree + os.sep):
            raise RuntimeError(f"imported {module.__file__}, not the package under {tree}")
    head_dims = getattr(attention, "HEAD_DIMS", (64,))  # a tree before D = 128 builds 64 only
    if args.head_dims:
        wanted = tuple(int(d) for d in args.head_dims.split(","))
        if not set(wanted) <= set(head_dims):
            ap.error(f"the tree builds head dimensions {head_dims}, not {wanted}")
        head_dims = wanted
    meta_policy, normalizer = smoke.flagship_config()
    cfg = meta_policy.mar_cfg
    measure = {"attention": lambda: attention_rows(attention, cfg),
               "quantize_rows": lambda: quantize_rows(int8_mm, cfg),
               "gemm": lambda: gemm_rows(int8_mm, cfg),
               "deployed": lambda: deployed_requests(int8_mm, meta_policy, normalizer),
               "serve_256px": lambda: requests_256px(normalizer),
               "fp32_attention": lambda: fp32_attention(attention),
               "fp32_request": lambda: fp32_request(meta_policy, normalizer),
               "attention_variants": lambda: attention_variants(attention, head_dims),
               "tf32_tiles": lambda: tf32_tiles(attention, head_dims),
               "tf32_sass": lambda: tf32_sass(attention)}
    parts = args.parts.split(",")
    unknown = set(parts) - set(PARTS)
    if unknown:
        ap.error(f"unknown parts {sorted(unknown)}")
    with torch.no_grad():
        result = {"tree": args.tree, "card": smoke.card_line(),
                  **{part: measure[part]() for part in parts}}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
