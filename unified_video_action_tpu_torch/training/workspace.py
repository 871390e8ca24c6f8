"""The training loop (the port's own copy of the part of
``training/workspace.py`` that the loop needs, :200-420): the dataset and its
normalizer, the device-resident store, the policy initialized from the seed,
AdamW + EMA, and the epochs of steps, each with its task mode, frame
selection and augmentation drawn on the host.

``Trainer(cfg, device).run()`` takes a run config (the ``cfg`` of an exported
checkpoint's ``meta.json``, e.g. the flagship's) and returns the
``TrainState``; a serving policy serves its EMA weights through
``load_params(state.ema_tree(), vae_tree)``. It writes ``logs.jsonl`` (one
line an epoch: the last step's metrics and the count of the epoch's steps
with a metric that is not finite) and ``normalizer.npz`` under the config's
``output_dir``. Only the device-resident input path is ported
(``dataloader.device_resident: true``; on the CPU the store is host memory).
Checkpoints, resume, trackers, validation, rollouts during training, the
host loader and more than one GPU wait for later slices.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from unified_video_action_tpu_torch.data.device_dataset import DeviceReplayDataset
from unified_video_action_tpu_torch.data.pusht_dataset import PushTImageDataset
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.training.ema import EmaConfig
from unified_video_action_tpu_torch.training.train_state import (
    TrainState,
    create_train_state,
    train_step,
)
from unified_video_action_tpu_torch.utils import image as image_util
from unified_video_action_tpu_torch.utils.device import resolve_device
from unified_video_action_tpu_torch.utils.frames import select_frame_indices

# dataset keys that the dataset does not read
_DATASET_IGNORED = ("_target_", "language_emb_model", "dataset_type", "normalizer_type")


def build_dataset(cfg: Mapping) -> PushTImageDataset:
    ds_cfg = dict(cfg["task"]["dataset"])
    name = str(ds_cfg.get("_target_", "PushTImageDataset")).rsplit(".", 1)[-1]
    if name != "PushTImageDataset":
        raise NotImplementedError(f"dataset {name!r} is not ported; only PushTImageDataset")
    for k in _DATASET_IGNORED:
        ds_cfg.pop(k, None)
    return PushTImageDataset(**ds_cfg)


def build_policy(cfg: Mapping, device: torch.device) -> UnifiedVideoActionPolicy:
    kwargs = {k: v for k, v in cfg["model"]["policy"].items() if k != "_target_"}
    task = cfg["task"]
    return UnifiedVideoActionPolicy(
        task_name=task["name"], task_modes=tuple(task.get("task_modes") or ()),
        normalizer_type=task.get("dataset", {}).get("normalizer_type", "all"),
        train=True, device=device, **kwargs)


class Trainer:
    """One training run of ``cfg`` on ``device``; :meth:`run` trains."""

    def __init__(self, cfg: Mapping, device: Union[str, torch.device] = "cuda",
                 output_dir: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = output_dir or cfg.get("output_dir", "outputs/run")
        tcfg = cfg["training"]
        self.seed = int(tcfg["seed"])
        self.np_rng = np.random.default_rng(self.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        debug = bool(tcfg.get("debug", False))
        self.num_epochs = 2 if debug else int(tcfg["num_epochs"])
        max_steps = 3 if debug else tcfg.get("max_train_steps")
        self.max_train_steps = None if max_steps is None else int(max_steps)
        self.batch_size = 2 if debug else int(cfg["dataloader"]["batch_size"])
        if not cfg["dataloader"].get("device_resident", False):
            raise NotImplementedError("only the device-resident input path is ported: "
                                      "set dataloader.device_resident=true")
        self.epoch = 0
        self.policy = build_policy(cfg, self.device)
        self.dataset = build_dataset(cfg)
        self.normalizer = self.dataset.get_normalizer()
        self.policy.set_normalizer(self.normalizer)
        self.data = DeviceReplayDataset(self.dataset, self.device)
        steps_per_epoch = max(len(self.data) // self.batch_size, 1)
        if self.max_train_steps is not None:
            steps_per_epoch = min(steps_per_epoch, self.max_train_steps)
        opt_cfg = cfg["model"]["policy"].get("optimizer") or {}
        ema = cfg.get("ema", {})
        self.policy.init_params(self.seed)
        self.state = create_train_state(
            self.policy,
            ema_cfg=EmaConfig(
                update_after_step=int(ema.get("update_after_step", 0)),
                inv_gamma=float(ema.get("inv_gamma", 1.0)),
                power=float(ema.get("power", 0.75)),
                min_value=float(ema.get("min_value", 0.0)),
                max_value=float(ema.get("max_value", 0.9999)),
            ),
            grad_accum=int(tcfg.get("gradient_accumulate_every", 1)),
            learning_rate=float(opt_cfg.get("learning_rate", 1e-4)),
            weight_decay=float(opt_cfg.get("weight_decay", 0.02)),
            betas=tuple(opt_cfg.get("betas", (0.9, 0.95))),
            warmup_steps=int(tcfg.get("lr_warmup_steps", 1000)),
            total_steps=steps_per_epoch * self.num_epochs,
            schedule=tcfg.get("lr_scheduler", "cosine"),
        )

    def draw_aug(self, batch: int) -> Dict[str, np.ndarray]:
        """Per-sample crop corners and blur widths, drawn on the host."""
        m_h, m_w = image_util.aug_margins(*self.data.frame_hw)
        return {"aug_top": self.np_rng.integers(0, m_h, batch).astype(np.int32),
                "aug_left": self.np_rng.integers(0, m_w, batch).astype(np.int32),
                "aug_sigma": self.np_rng.uniform(0.1, 2.0, batch).astype(np.float32)}

    def batches(self) -> Iterator[Tuple[str, np.ndarray, Dict[str, Any]]]:
        """One epoch of (task mode, frame indices, batch on the device): the
        samples shuffled by a generator seeded with (seed, epoch), the last
        partial batch dropped; only indices and the augmentation's scalars
        cross to the device."""
        order = np.arange(len(self.data))
        np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        for s in range(len(order) // self.batch_size):
            idxs = order[s * self.batch_size:(s + 1) * self.batch_size]
            task_mode = self.policy.choose_task_mode(self.np_rng)
            frame_indices = select_frame_indices(self.data.horizon, eval=False)
            aug = self.draw_aug(self.batch_size) if self.data.data_aug else None
            yield task_mode, frame_indices, self.data.gather(idxs, frame_indices, aug)

    def run(self) -> TrainState:
        os.makedirs(self.output_dir, exist_ok=True)
        self.normalizer.save(os.path.join(self.output_dir, "normalizer.npz"))
        log_path = os.path.join(self.output_dir, "logs.jsonl")
        open(log_path, "w").close()  # a run's log holds that run's epochs only
        while self.epoch < self.num_epochs:
            t0 = time.perf_counter()
            steps = []
            for i, (task_mode, frame_indices, batch) in enumerate(self.batches()):
                if self.max_train_steps is not None and i >= self.max_train_steps:
                    break
                steps.append(train_step(self.state, batch, task_mode, frame_indices,
                                        generator=self.generator, pregathered=True))
            line = {"epoch": self.epoch, "global_step": self.state.step,
                    "epoch_time": time.perf_counter() - t0,
                    **{k: float(v) for k, v in (steps[-1] if steps else {}).items()}}
            if steps:
                # the epoch's steps whose metrics are not all finite
                stacked = torch.stack([torch.stack(list(m.values())) for m in steps])
                line["nonfinite_steps"] = int((~torch.isfinite(stacked)).any(dim=1).sum())
            if self.device.type == "cuda":
                line["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
            with open(log_path, "a") as f:
                f.write(json.dumps(line) + "\n")
            print(json.dumps(line), flush=True)
            self.epoch += 1
        return self.state
