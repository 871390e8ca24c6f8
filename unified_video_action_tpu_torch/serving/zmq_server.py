"""ZMQ REP policy inference server (the port's own copy of
``serving/zmq_server.py``).

The reference's real-robot serving node (eval_real.py:66-214): bind a REP
socket, receive pickled obs dicts, run ``predict_action`` with the per-task
language latent, smooth the action chunk with a moving average, and reply
with the action array (or a traceback string on error, matching the
reference's fault behavior at eval_real.py:191-194).

JAX's node splits a PRNG key per request; this one draws from a
``torch.Generator`` on the policy's device, seeded once. ``infer`` also
takes the draws themselves (``noise``, as the policy's ``predict_action``
takes them), so that a caller can replay a request. ``serve`` imports
``zmq`` inside itself: the package imports without it.
"""

from __future__ import annotations

import pickle
import time
import traceback
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def smooth_action(actions: np.ndarray, window: int = 3) -> np.ndarray:
    """Centered moving average over the chunk's time axis, edges replicated
    (reference smooth_action, eval_real.py:37-64)."""
    actions = np.asarray(actions)
    T = actions.shape[-2]
    pad = window // 2
    padded = np.concatenate(
        [np.repeat(actions[..., :1, :], pad, axis=-2), actions,
         np.repeat(actions[..., -1:, :], pad, axis=-2)],
        axis=-2,
    )
    out = np.empty_like(actions)
    for t in range(T):
        out[..., t, :] = padded[..., t: t + window, :].mean(axis=-2)
    return out


class PolicyInferenceNode:
    """``policy``: the port's ``UnifiedVideoActionPolicy`` with its weights
    loaded; ``language_latents``: {task_name: latent}, passed to
    ``predict_action`` as the goal of requests naming that task."""

    def __init__(self, policy, language_latents: Optional[Dict[str, np.ndarray]] = None,
                 smooth_window: int = 3, seed: int = 0):
        self.policy = policy
        self.language_latents = language_latents or {}
        self.smooth_window = smooth_window
        self.generator = torch.Generator(device=policy.device).manual_seed(seed)

    def infer(self, obs_dict: Dict[str, Any], task_name: Optional[str] = None,
              noise: Optional[Mapping[str, torch.Tensor]] = None) -> np.ndarray:
        """The smoothed (B, 16, A) action chunk of one request. ``noise``:
        the draws of ``policy.sample_noise``; by default they come from the
        node's generator."""
        goal = self.language_latents.get(task_name) if task_name else None
        result = self.policy.predict_action(obs_dict, generator=self.generator, noise=noise,
                                            language_goal=goal)
        action = result["action_pred"]
        if self.smooth_window > 1:
            action = smooth_action(action, self.smooth_window)
        return action

    def serve(self, bind: str = "tcp://0.0.0.0:8766", max_requests: Optional[int] = None) -> None:
        """REQ/REP loop. ``max_requests`` bounds the loop (tests/drain);
        production serving passes None and runs until killed, like the
        reference node (eval_real.py:174-198)."""
        import zmq

        ctx = zmq.Context()
        socket = ctx.socket(zmq.REP)
        socket.bind(bind)
        print(f"policy server listening on {bind}", flush=True)
        served = 0
        try:
            while max_requests is None or served < max_requests:
                msg = socket.recv()
                try:
                    payload = pickle.loads(msg)
                    obs_dict = payload["obs"] if "obs" in payload else payload
                    task_name = payload.get("task_name") if isinstance(payload, dict) else None
                    t0 = time.time()
                    action = self.infer(obs_dict, task_name)
                    print(f"request served in {time.time() - t0:.4f}s", flush=True)
                    socket.send(pickle.dumps(action))
                except Exception:
                    socket.send(pickle.dumps(traceback.format_exc()))
                served += 1
        finally:
            socket.close(linger=0)
            ctx.term()
