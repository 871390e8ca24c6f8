"""Where the port's bf16 training gradient parts from JAX's (ROADMAP C7), on
the CPU at the tiny training size of ``tests/test_torch_train_losses.py``.
Not a test: a probe, run from the repo root as

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_grad_stages [--mode inverse_model] [--seeds 0 5]

For the first seed it prints every MAR leaf's gradient in backward order
(the action head, the action pool, then the decoder and the encoder from the
last block to the first) with the port's bf16 distance from JAX's fp32
gradient over JAX's own bf16 distance (relative L2), and the action pool's
fc1 ReLU: the pre-activations whose sign in the port's bf16 differs from
fp32, and their values. For each seed it prints the whole
gradient's two ratios (port bf16 vs JAX bf16, and port bf16 vs JAX fp32,
each over JAX bf16 vs JAX fp32), in the mode and in full_dynamic_model.
"""

import argparse

import jax
import numpy as np

from tests.test_torch_train_losses import (
    B,
    TASK_MODES,
    _rel,
    _whole,
    build_pair,
    jax_loss_and_grads,
    jax_train_draws,
    make_batch,
    port_grads,
    to_jax,
    to_torch,
    train_kw,
)

BACKWARD_ORDER = ("diffactloss", "diffloss", "decoder_norm", "decoder_blocks", "decoder_embed",
                  "encoder_norm", "encoder_blocks")


def _backward_key(path):
    top = BACKWARD_ORDER.index(path[0]) if path[0] in BACKWARD_ORDER else len(BACKWARD_ORDER)
    block = -int(path[1].split("_")[-1]) if len(path) > 1 and path[1].startswith("block_") else 0
    return top, path[1] if path[0] == "diffactloss" else "", block, path


def _seed_run(seed, mode):
    batch = make_batch(2 + seed)
    j32, params, p32 = build_pair(train_kw(), seed=1 + seed, batch=batch)
    j16, _, p16 = build_pair(train_kw("bfloat16"), seed=1 + seed, batch=batch)
    key = jax.random.PRNGKey(40 + TASK_MODES.index(mode) + 100 * seed)
    noise = jax_train_draws(key, p32, B)
    _, _, _, g32 = jax_loss_and_grads(j32, params, to_jax(batch), key, mode)
    _, _, _, g16 = jax_loss_and_grads(j16, params, to_jax(batch), key, mode)
    pre = {}
    hook = p16.mar.diffactloss.pool.fc1.register_forward_hook(
        lambda m, i, o: pre.__setitem__("port16", o.detach().float().numpy())) \
        if hasattr(p16.mar, "diffactloss") else None
    p16.compute_loss(to_torch(batch), mode, noise=noise)[0].backward()
    if hook is not None:
        hook.remove()
    return j16, j32, params, p16, batch, key, g32, g16, port_grads(p16.mar), pre


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="inverse_model")
    ap.add_argument("--seeds", nargs=2, type=int, default=(0, 5))
    args = ap.parse_args()
    for seed in range(*args.seeds):
        for mode in (args.mode, "full_dynamic_model"):
            j16, j32, params, p16, batch, key, g32, g16, gp, pre = _seed_run(seed, mode)
            if seed == args.seeds[0] and mode == args.mode:
                print(f"{'leaf':50s} {'port16-jax32':>12s} {'jax16-jax32':>12s} {'ratio':>6s}")
                for path in sorted((p for p in g32 if np.abs(g32[p]).max() > 0), key=_backward_key):
                    pe, je = _rel(gp[path], g32[path]), _rel(g16[path], g32[path])
                    print(f"{'/'.join(path):50s} {pe:12.4g} {je:12.4g} {pe / je:6.2f}")
            g, w, f = (_whole(d, g32) for d in (gp, g16, g32))
            print(f"seed {seed} {mode}: port16-jax16 / jax16-jax32 {_rel(g, w) / _rel(w, f):.2f}, "
                  f"port16-jax32 / jax16-jax32 {_rel(g, f) / _rel(w, f):.2f}", flush=True)
    # the pool's fc1 ReLU at the first seed: whose sign rounds across 0
    *_, batch, key, _, _, _, pre = _seed_run(args.seeds[0], args.mode)
    p32 = build_pair(train_kw(), seed=1 + args.seeds[0], batch=batch)[2]
    got32 = {}
    hook = p32.mar.diffactloss.pool.fc1.register_forward_hook(
        lambda m, i, o: got32.__setitem__("x", o.detach().numpy()))
    p32.compute_loss(to_torch(batch), args.mode,
                     noise=jax_train_draws(key, p32, B))
    hook.remove()
    ref = got32["x"]
    flips = np.argwhere((pre["port16"] > 0) != (ref > 0))
    print(f"action pool fc1: {ref.size} pre-activations, {int((np.abs(ref) < 0.01).sum())} within "
          f"0.01 of 0 in fp32; the port's bf16 flips {flips.tolist()}: "
          + ", ".join(f"fp32 {ref[tuple(i)]:.5f} -> bf16 {pre['port16'][tuple(i)]:.5f}" for i in flips))


if __name__ == "__main__":
    main()
