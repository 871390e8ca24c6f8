"""The training loop (the port's counterpart of ``training/workspace.py:
64-688``): the dataset, its validation split and its normalizer, the
device-resident store, the policy initialized from the seed (and merged
from ``pretrained_model_path``), AdamW + EMA, and the epochs of steps, each
with its task mode, frame selection and augmentation drawn on the host;
then, at each epoch's end and at the config's cadences, validation,
rollouts, early stopping, the step log and checkpoints.

``Trainer(cfg, device).run()`` takes a run config (the ``cfg`` of an
exported checkpoint's ``meta.json``, e.g. the flagship's) and returns the
``TrainState``. Under the config's ``output_dir`` it writes:

* ``logs.jsonl``: one line an epoch (JAX's step log: the last step's
  metrics, ``video_fvd_vae`` and ``video_fvd_pixel`` (or ``video_fvd``),
  ``val_action_l2_distances``, ``test_mean_score`` and the runner's scores,
  ``early_stopped``, ``_step``; and the count of the epoch's steps with a
  metric that is not finite). A run that resumes
  appends to it; any other run starts it empty.
* ``tracker/`` (``trackers.build_tracker``: the same lines as
  ``metrics.jsonl``, ``config.json``, ``summary.json``) and
  ``normalizer.npz``.
* ``checkpoints/latest`` every ``checkpoint_every`` epochs and at the last
  epoch, ``checkpoints/<format_str>`` for the top-k by ``monitor_key``
  (``training/checkpoint.py``), and ``export/``, the slim export of the
  final EMA in the compute dtype (not when ``checkpoint_every <= 0``, which
  means the run saves nothing).

The cadences (``val_every``, ``rollout_every``, ``checkpoint_every``,
``sample_every``) fire at epochs divisible by them; 0 or less means never;
``training.debug`` sets each to 1, 2 epochs of 3 steps, 3 validation
batches, a rollout of one train and one test seed of 20 steps. The
``sample_every`` hook is the video FVD of the EMA policy on the validation
split (``eval/offline.test_video_fvd``; an error in it is printed as ``[fvd]
skipped`` and training goes on, as in JAX). Validation is the RMSE of the
EMA policy's actions against the future actions on the validation split
(``val_action_l2``); rollouts run the task's env runner
(``runners/base.py``). All three serve the EMA weights through one serving policy
on the trainer's device (its attention through the CUDA kernel on the card),
built at the first and refreshed at each. Early stopping counts rollouts
without a new best ``test_mean_score`` (or, with ``rollout_every <= 0``,
epochs without a new best top-k monitor) up to ``early_stop_patience``.
``resume`` restarts from ``checkpoints/latest`` at its epoch (the last one
finished, which runs again, as in JAX). SIGTERM and SIGINT stop the run
after the step in flight and save ``latest`` with the unfinished epoch, which
a resumed run replays. Every key of the config's ``training``,
``checkpoint``, ``ema``, ``logging``, ``dataloader`` and ``val_dataloader``
sections is acted on or named in the log as ignored (:func:`config_report`).
Two input paths: the device-resident store (``dataloader.device_resident:
true``, the PushT datasets; on the CPU the store is host memory), and the
host loader (``data/loader.py``) for the UMI datasets of a
``task_type: multiple_datasets`` config, as JAX runs them (``training/
workspace.py:169-181``, ``:340-375``): its batches collated on the host by
``dataloader.num_workers`` threads (``worker_mode`` "process" forks them),
the task mode and the frame indices (a random history frequency under
``different_history_freq``) drawn per batch, the numeric fields copied to
the device and the string ones (``dataset_name``) left behind. More than
one GPU waits for a later slice.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from unified_video_action_tpu_torch.data.device_dataset import DeviceReplayDataset
from unified_video_action_tpu_torch.data.loader import DataLoader
from unified_video_action_tpu_torch.data.pusht_dataset import PushTImageDataset
from unified_video_action_tpu_torch.data.umi_dataset import (
    UmiMultiDataset,
    build_umi_multi_from_config,
)
from unified_video_action_tpu_torch.eval import offline
from unified_video_action_tpu_torch.policy.policy import UnifiedVideoActionPolicy
from unified_video_action_tpu_torch.training import checkpoint as ckpt_lib
from unified_video_action_tpu_torch.training.ema import EmaConfig
from unified_video_action_tpu_torch.training.trackers import build_tracker
from unified_video_action_tpu_torch.training.train_state import (
    TrainState,
    create_train_state,
    train_step,
)
from unified_video_action_tpu_torch.utils import image as image_util
from unified_video_action_tpu_torch.utils.device import resolve_device
from unified_video_action_tpu_torch.utils.frames import select_frame_indices, split_trajectory

# dataset keys that the dataset does not read
_DATASET_IGNORED = ("_target_", "language_emb_model", "dataset_type", "normalizer_type")

# the keys of a run config's sections that the trainer acts on
ACTED_ON = {
    "training": {"seed", "debug", "num_epochs", "max_train_steps", "max_val_steps", "resume",
                 "rollout_every", "checkpoint_every", "val_every", "sample_every",
                 "early_stop_patience", "gradient_accumulate_every", "lr_scheduler",
                 "lr_warmup_steps"},
    "checkpoint": {"topk"},
    "ema": {"update_after_step", "inv_gamma", "power", "min_value", "max_value"},
    "logging": {"name", "project", "mode"},
    "dataloader": {"batch_size", "device_resident"},
    "val_dataloader": set(),
}
# the loader keys the host loader acts on besides those
HOST_LOADER_KEYS = {"num_workers", "worker_mode", "prefetch"}
# the keys it ignores, each with the reason the log gives; a key in neither
# table is named as one the port does not read
IGNORED = {
    "training.use_ema": "the EMA is always kept, and validation, rollouts and the export serve it, "
                        "as in JAX",
    "training.mesh": "one GPU: the port has no device mesh (ROADMAP A10)",
    "training.shard_optimizer_state": "one GPU: the port has no device mesh (ROADMAP A10)",
    "checkpoint.save_last_ckpt": "checkpoints/latest is saved every checkpoint_every epochs and "
                                 "at the last, as in JAX",
    "dataloader.num_workers": "the device-resident store has no loader workers",
    "dataloader.worker_mode": "the device-resident store has no loader workers",
    "dataloader.prefetch": "the device-resident store has no host loader to prefetch",
    "dataloader.shuffle": "the training windows are shuffled every epoch, as JAX's loader "
                          "shuffles them whatever the key says",
    "val_dataloader.batch_size": "validation batches take dataloader.batch_size, as in JAX",
    "val_dataloader.num_workers": "the device-resident store has no loader workers; the host "
                                  "loader validates with 2 workers, as JAX's",
    "val_dataloader.shuffle": "validation takes its windows in order, as in JAX",
}


def uses_host_loader(cfg: Mapping) -> bool:
    """Whether the run reads its batches through the host loader (not the
    device-resident store)."""
    return not (cfg.get("dataloader") or {}).get("device_resident", False)


def config_report(cfg: Mapping) -> Dict[str, str]:
    """{dotted key: reason} of every key of the run config's training
    sections that the trainer ignores (``IGNORED``, or not read at all)."""
    out = {}
    for section, acted in ACTED_ON.items():
        if section == "dataloader" and uses_host_loader(cfg):
            acted = acted | HOST_LOADER_KEYS
        for key in (cfg.get(section) or {}):
            dotted = f"{section}.{key}"
            if key not in acted:
                out[dotted] = IGNORED.get(dotted, "the port does not read this key")
    return out


def build_dataset(cfg: Mapping) -> Union[PushTImageDataset, UmiMultiDataset]:
    """The task's dataset from its ``_target_``: ``PushTImageDataset`` or
    ``build_umi_multi_from_config`` (the UMI datasets)."""
    ds_cfg = dict(cfg["task"]["dataset"])
    name = str(ds_cfg.get("_target_", "PushTImageDataset")).rsplit(".", 1)[-1]
    builders = {"PushTImageDataset": PushTImageDataset,
                "build_umi_multi_from_config": build_umi_multi_from_config}
    if name not in builders:
        raise NotImplementedError(f"dataset {name!r} is not ported; only {sorted(builders)}")
    for k in _DATASET_IGNORED:
        ds_cfg.pop(k, None)
    return builders[name](**ds_cfg)


def to_device_batch(batch: Mapping[str, Any], device: torch.device) -> Dict[str, Any]:
    """A host loader's numpy batch on ``device``: numeric leaves as tensors,
    string leaves (``dataset_name``) left out, as JAX's ``_to_jax_batch``."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, Mapping):
            out[k] = to_device_batch(v, device)
        elif np.asarray(v).dtype.kind not in "USO":
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def build_policy(cfg: Mapping, device: torch.device) -> UnifiedVideoActionPolicy:
    kwargs = {k: v for k, v in cfg["model"]["policy"].items() if k != "_target_"}
    task = cfg["task"]
    return UnifiedVideoActionPolicy(
        task_name=task["name"], task_modes=tuple(task.get("task_modes") or ()),
        normalizer_type=task.get("dataset", {}).get("normalizer_type", "all"),
        train=True, device=device, **kwargs)


def val_action_l2(policy: UnifiedVideoActionPolicy, batch: Mapping[str, Any],
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Mapping[str, torch.Tensor]] = None) -> Optional[float]:
    """JAX's ``_val_action_l2`` (``training/workspace.py:646-688``): the
    RMSE between ``policy``'s action chunk for the first half of each
    window of ``batch`` (``obs["image"]`` (B, T, 3, H, W) uint8, ``action``
    (B, T, A)) and the window's future actions, over the first 9 action
    dimensions; None without the action head. ``noise`` injects the
    predict call's draws; otherwise they come from ``generator``.

    A UMI batch (``img_indices`` in its obs) holds the 8 frames its items
    train on, the first 4 the conditioning ones: those condition the
    prediction as they condition training, with the state as training
    takes it (``_build_proprio_train``) and the batch's language latents,
    and the future is the second half of the action window. JAX's function
    raises on such a batch (its frame selection picks frames 3-6 of the
    4-frame half-window), so this reading has no JAX counterpart beyond its
    predict program on the same inputs."""
    if not policy.mar_cfg.predict_action:
        return None
    obs = image_util.remap_image_keys(policy.task_name, dict(batch["obs"]))
    image = obs["image"]
    T = image.shape[1]
    window = image[:, : T // 2]
    if "img_indices" in obs:
        text = batch.get("language_latents")
        text = None if text is None else policy._encode_language_goal(text, image.shape[0])
        proprio, _ = policy._build_proprio_train(obs, np.arange(T), {})
        pred = policy.predict_action_frames(window, generator, noise, text, None, proprio)
        T = batch["action"].shape[1]
    elif policy.obs_codec or window.dtype != torch.uint8:
        pred = policy.predict_action_async({"image": window.cpu().numpy()}, generator, noise)
    else:
        frames = window[:, select_frame_indices(T // 2, policy.mar_cfg.n_frames)]
        pred = policy.predict_action_frames(frames, generator, noise)
    pred = pred.cpu().numpy()
    _, future = split_trajectory(np.asarray(batch["action"].cpu()), T, policy.shift_action,
                                 policy.use_history_action)
    n = min(pred.shape[-1], 9)
    d = pred[..., :n] - future[..., :n]
    return float(np.sqrt((d ** 2).mean()))


class Trainer:
    """One training run of ``cfg`` on ``device``; :meth:`run` trains.
    ``dataset``, where given, is ``build_dataset(cfg)`` built already (runs
    of one corpus share it)."""

    def __init__(self, cfg: Mapping, device: Union[str, torch.device] = "cuda",
                 output_dir: Optional[str] = None,
                 dataset: Optional[Union[PushTImageDataset, UmiMultiDataset]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = output_dir or cfg.get("output_dir", "outputs/run")
        tcfg = cfg["training"]
        self.seed = int(tcfg["seed"])
        self.np_rng = np.random.default_rng(self.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.debug = debug = bool(tcfg.get("debug", False))
        self.num_epochs = 2 if debug else int(tcfg["num_epochs"])
        max_steps = 3 if debug else tcfg.get("max_train_steps")
        self.max_train_steps = None if max_steps is None else int(max_steps)
        max_val = 3 if debug else tcfg.get("max_val_steps")
        self.max_val_steps = None if max_val is None else int(max_val)
        every = lambda key, default: 1 if debug else int(tcfg.get(key, default))
        self.rollout_every = every("rollout_every", 10)
        self.checkpoint_every = every("checkpoint_every", 10)
        self.val_every = every("val_every", 1)
        self.sample_every = every("sample_every", 5)
        self.early_stop_patience = int(tcfg["early_stop_patience"]) if tcfg.get(
            "early_stop_patience") else None
        self.resume = bool(tcfg.get("resume", False))
        self.batch_size = 2 if debug else int(cfg["dataloader"]["batch_size"])
        self.host_loader = uses_host_loader(cfg)
        self.ignored_keys = config_report(cfg)
        for key, why in self.ignored_keys.items():
            print(f"[config] ignored {key}: {why}", flush=True)
        self.epoch = 0
        self.restored = False
        self.last_metrics: Dict[str, Any] = {}
        self.policy = build_policy(cfg, self.device)
        self.dataset = dataset if dataset is not None else build_dataset(cfg)
        self.val_dataset = self.dataset.get_validation_dataset()
        self.normalizer = self.dataset.get_normalizer()
        self.policy.set_normalizer(self.normalizer)
        if self.host_loader:
            if not isinstance(self.dataset, UmiMultiDataset):
                raise NotImplementedError("the host loader serves the UMI datasets; set "
                                          "dataloader.device_resident=true for PushT")
            dl = cfg["dataloader"]
            loader = dict(worker_mode=dl.get("worker_mode", "thread"),
                          prefetch=int(dl.get("prefetch", 2)))
            self.loader = DataLoader(self.dataset, self.batch_size, shuffle=True, seed=self.seed,
                                     num_workers=int(dl.get("num_workers", 4)), **loader)
            self.val_loader = DataLoader(self.val_dataset, self.batch_size, shuffle=False,
                                         drop_last=False, num_workers=2, **loader)
            self.data, self.val_data = self.dataset, self.val_dataset
        else:
            self.data = DeviceReplayDataset(self.dataset, self.device)
            self.val_data = self.data.split(self.val_dataset)
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
        topk = dict((cfg.get("checkpoint") or {}).get("topk") or {})
        self.topk = ckpt_lib.TopKCheckpointManager(
            save_dir=os.path.join(self.output_dir, "checkpoints"),
            monitor_key=topk.get("monitor_key", "test_mean_score"),
            mode=topk.get("mode", "max"), k=int(topk.get("k", 1)),
            format_str=topk.get("format_str", "epoch={epoch:04d}"))
        self.env_runner = None
        self.serving: Optional[UnifiedVideoActionPolicy] = None

    @property
    def latest_path(self) -> str:
        return os.path.join(self.output_dir, "checkpoints", "latest")

    # -- the epoch --------------------------------------------------------

    def draw_aug(self, batch: int) -> Dict[str, np.ndarray]:
        """Per-sample crop corners and blur widths, drawn on the host."""
        m_h, m_w = image_util.aug_margins(*self.data.frame_hw)
        return {"aug_top": self.np_rng.integers(0, m_h, batch).astype(np.int32),
                "aug_left": self.np_rng.integers(0, m_w, batch).astype(np.int32),
                "aug_sigma": self.np_rng.uniform(0.1, 2.0, batch).astype(np.float32)}

    def batches(self) -> Iterator[Tuple[str, np.ndarray, Dict[str, Any]]]:
        """One epoch of (task mode, frame indices, batch on the device): the
        samples shuffled by a generator seeded with (seed, epoch), the last
        partial batch dropped; from the device store only indices and the
        augmentation's scalars cross to the device."""
        if self.host_loader:
            yield from self.host_batches()
            return
        order = np.arange(len(self.data))
        np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        for s in range(len(order) // self.batch_size):
            idxs = order[s * self.batch_size:(s + 1) * self.batch_size]
            task_mode = self.policy.choose_task_mode(self.np_rng)
            frame_indices = select_frame_indices(self.data.horizon, eval=False)
            aug = self.draw_aug(self.batch_size) if self.data.data_aug else None
            yield task_mode, frame_indices, self.data.gather(idxs, frame_indices, aug)

    def host_batches(self) -> Iterator[Tuple[str, np.ndarray, Dict[str, Any]]]:
        """JAX's host-loader ``prepare`` (``training/workspace.py:340-375``):
        per batch of the loader, the task mode and then the frame indices
        drawn on the host (the history frames at random under
        ``different_history_freq``); a window the items did not gather
        already (no ``img_indices``) keeps only those frames; then the copy
        to the device."""
        for b in self.loader:
            task_mode = self.policy.choose_task_mode(self.np_rng)
            obs = b["obs"]
            key = image_util.main_image_key(self.policy.task_name, obs)
            frame_indices = select_frame_indices(
                obs[key].shape[1], eval=False,
                different_history_freq=self.policy.different_history_freq, rng=self.np_rng)
            if "img_indices" not in obs:
                b = dict(b, obs=dict(obs, **{key: obs[key][:, frame_indices]}))
            yield task_mode, frame_indices, to_device_batch(b, self.device)

    def train_epoch(self, stop=lambda: False) -> List[Dict[str, torch.Tensor]]:
        """The epoch's steps (at most ``max_train_steps``; after the step in
        flight once ``stop()`` holds); returns their metrics."""
        t0, steps = time.perf_counter(), []
        for i, (task_mode, frame_indices, batch) in enumerate(self.batches()):
            if self.max_train_steps is not None and i >= self.max_train_steps:
                break
            steps.append(train_step(self.state, batch, task_mode, frame_indices,
                                    generator=self.generator, pregathered=True))
            if i > 0 and i % 200 == 0:  # the step before is done by now
                print(f"[epoch {self.epoch}] step {i} loss "
                      f"{float(steps[-2]['train_loss']):.4f} t={time.perf_counter() - t0:.0f}s",
                      flush=True)
            if stop():
                break
        return steps

    # -- evaluation -------------------------------------------------------

    def serving_policy(self) -> UnifiedVideoActionPolicy:
        """The serving policy of the run's config on the trainer's device,
        holding the current EMA weights: built at the first call; later
        calls copy the EMA into it on the device, cast as the weight bridge
        casts (a W8A8 model takes the bridge again, which quantizes)."""
        if self.serving is None or self.serving.serving_quant:
            if self.serving is None:
                self.serving = UnifiedVideoActionPolicy.from_cfg(self.cfg, device=self.device)
            self.serving.load_params(self.state.ema_tree(), self.policy.vae_params())
        else:
            with torch.no_grad():
                for name, p in self.serving.mar.named_parameters():
                    p.copy_(self.state.ema[name])
        self.serving.set_normalizer(self.policy.normalizer)
        return self.serving

    def val_batches(self) -> Iterator[Dict[str, Any]]:
        """The validation windows in order, in batches of the training batch
        size, gathered from the device store (or collated by the host loader
        and copied to the device)."""
        if self.host_loader:
            for b in self.val_loader:
                yield to_device_batch(b, self.device)
            return
        n = len(self.val_data)
        for start in range(0, n, self.batch_size):
            yield self.val_data.gather(np.arange(start, min(start + self.batch_size, n)))

    def video_fvd(self) -> Dict[str, float]:
        """JAX's ``sample_every`` hook (``training/workspace.py:452-473``):
        ``eval.offline.test_video_fvd`` of the EMA policy over 4 validation
        batches (1 under ``debug``), its media under ``output_dir/media``."""
        return offline.test_video_fvd(self.serving_policy(), self.val_batches(),
                              num_batches=1 if self.debug else 4,
                              output_dir=os.path.join(self.output_dir, "media"))

    def validate(self) -> Optional[float]:
        """The mean of ``val_action_l2`` over the validation windows, in
        order, in batches of the training batch size, at most
        ``max_val_steps`` batches; None without validation windows or
        without the action head."""
        n = len(self.val_data)
        if n == 0 or not self.policy.mar_cfg.predict_action:
            return None
        policy = self.serving_policy()
        losses = []
        for j, batch in enumerate(self.val_batches()):
            if self.max_val_steps is not None and j >= self.max_val_steps:
                break
            losses.append(val_action_l2(policy, batch, self.generator))
        return float(np.mean(losses))

    def rollout(self) -> Dict[str, Any]:
        """The env runner's log for the EMA policy (``runners/base.py``)."""
        from unified_video_action_tpu_torch.runners.base import env_rollout

        return env_rollout(self.serving_policy(), self.env_runner, self.generator)

    def build_env_runner(self):
        """The task's env runner where rollouts can fire, else None (JAX
        builds none for a run whose rollouts never fire, or without the
        action head); ``debug`` cuts it to one train and one test seed of 20
        steps."""
        task = self.cfg.get("task", {})
        if not (self.rollout_every > 0 and self.policy.mar_cfg.predict_action
                and "env_runner" in task):
            return None
        from unified_video_action_tpu_torch.runners.base import load_env_runner

        run_cfg = self.cfg
        if self.debug:
            run_cfg = json.loads(json.dumps(self.cfg))
            run_cfg["task"]["env_runner"].update(n_train=1, n_test=1, max_steps=20)
        return load_env_runner(run_cfg, output_dir=self.output_dir)

    # -- checkpoints ------------------------------------------------------

    def save(self, path: str, epoch: int, blocking: bool = True) -> None:
        ckpt_lib.save_checkpoint(path, self.state, cfg=self.cfg, normalizer=self.policy.normalizer,
                                 epoch=epoch, blocking=blocking)

    def restore(self) -> bool:
        """With ``resume``, load ``checkpoints/latest`` where it exists (or the
        ``.old`` or ``.tmp`` a crash mid-publish left) and move to its epoch;
        whether it loaded."""
        if self.restored or not (self.resume and ckpt_lib.is_port_checkpoint(self.latest_path)):
            return self.restored
        _, meta, norm = ckpt_lib.load_checkpoint(self.latest_path, self.state)
        self.epoch = int(meta.get("epoch", 0))
        if norm is not None:
            self.policy.set_normalizer(norm)
        self.restored = True
        print(f"resumed from {self.latest_path} @ epoch {self.epoch} (step {self.state.step})",
              flush=True)
        return True

    def export(self, path: Optional[str] = None) -> str:
        """The slim export of the EMA weights in the compute dtype (default
        ``<output_dir>/export``)."""
        path = path or os.path.join(self.output_dir, "export")
        dtype = "float32" if self.policy.dtype == torch.float32 else "bfloat16"
        ckpt_lib.export_slim(path, self.state.ema_tree(), self.policy.vae_params(), self.cfg,
                             self.policy.normalizer, dtype, max(self.epoch - 1, 0), self.state.step)
        return path

    # -- the run ----------------------------------------------------------

    def run(self) -> TrainState:
        """Train to ``num_epochs`` (or an early stop, or a SIGTERM or
        SIGINT), with the epoch's evaluations, logs and checkpoints."""
        stop = {"preempted": False}

        def on_signal(signum, frame):
            if not stop["preempted"]:
                print(f"[preempt] signal {signum}: stopping after the step in flight", flush=True)
            stop["preempted"] = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, on_signal)
            except ValueError:  # not the main thread
                pass
        try:
            return self._run(lambda: stop["preempted"])
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)

    def _run(self, preempted) -> TrainState:
        os.makedirs(self.output_dir, exist_ok=True)
        resumed = self.restore()
        self.normalizer.save(os.path.join(self.output_dir, "normalizer.npz"))
        log_path = os.path.join(self.output_dir, "logs.jsonl")
        if not resumed:
            open(log_path, "w").close()  # a fresh run's log holds that run's epochs only
        logger = ckpt_lib.JsonLogger(log_path)
        tracker = build_tracker(self.cfg.get("logging"), self.output_dir, config=dict(self.cfg))
        self.env_runner = self.build_env_runner()
        topk = dict((self.cfg.get("checkpoint") or {}).get("topk") or {})
        early_monitor = topk.get("monitor_key", "test_mean_score")
        early_sign = -1.0 if topk.get("mode", "max") == "min" else 1.0
        early = {"best": float("-inf"), "stale": 0, "stop": False}
        fires = lambda every: every > 0 and self.epoch % every == 0
        try:
            while self.epoch < self.num_epochs and not preempted() and not early["stop"]:
                t0 = time.perf_counter()
                steps = self.train_epoch(preempted)
                if preempted():
                    break  # the unfinished epoch is saved below and replayed on resume
                step_log = self.epoch_log(steps, t0)
                if (self.policy.mar_cfg.predict_video and fires(self.sample_every)
                        and len(self.val_data) > 0):
                    try:
                        step_log.update(self.video_fvd())
                    except Exception as e:  # the video eval never stops training, as in JAX
                        print(f"[fvd] skipped: {e}", flush=True)
                if fires(self.val_every):
                    l2 = self.validate()
                    if l2 is not None:
                        step_log["val_action_l2_distances"] = l2
                if self.env_runner is not None and fires(self.rollout_every):
                    runner_log = self.rollout()
                    step_log.update({k: v for k, v in runner_log.items()
                                     if "mean_score" in k or "sim_max_reward" in k})
                    step_log["test_mean_score"] = runner_log.get("test/mean_score", 0.0)
                    if self.early_stop_patience is not None:
                        self._early_stop(early, step_log["test_mean_score"], "test_mean_score",
                                         1.0, step_log)
                if (self.early_stop_patience is not None and self.rollout_every <= 0
                        and early_monitor in step_log):
                    self._early_stop(early, early_sign * float(step_log[early_monitor]),
                                     early_monitor, early_sign, step_log)
                logger.log(step_log, step=self.state.step)
                tracker.log(step_log, step=self.state.step)
                print(json.dumps(step_log), flush=True)
                self.last_metrics = step_log
                if fires(self.checkpoint_every):
                    self.save(self.latest_path, self.epoch, blocking=False)
                    monitor = self.topk.monitor_key
                    if monitor in step_log:
                        path = self.topk.get_ckpt_path({"epoch": self.epoch, monitor: step_log[monitor],
                                                        "monitor": step_log[monitor]})
                        if path is not None:
                            self.save(path, self.epoch, blocking=False)
                self.epoch += 1
            if preempted():
                self.save(self.latest_path, self.epoch)
                print(f"[preempt] checkpoint saved at epoch {self.epoch}", flush=True)
            elif self.num_epochs > 0 and self.checkpoint_every > 0:
                if (self.epoch - 1) % self.checkpoint_every != 0:
                    self.save(self.latest_path, self.epoch - 1)
                ckpt_lib.wait_for_checkpoints()
                print(f"[export] {self.export()}", flush=True)
            ckpt_lib.wait_for_checkpoints()
        finally:
            logger.close()
            tracker.finish()
        return self.state

    def epoch_log(self, steps: List[Dict[str, torch.Tensor]], t0: float) -> Dict[str, Any]:
        """The epoch's line: the last step's metrics and the count of steps
        with a metric that is not finite."""
        line = {"epoch": self.epoch, "global_step": self.state.step,
                "epoch_time": time.perf_counter() - t0,
                **{k: float(v) for k, v in (steps[-1] if steps else {}).items()}}
        if steps:
            stacked = torch.stack([torch.stack(list(m.values())) for m in steps])
            line["nonfinite_steps"] = int((~torch.isfinite(stacked)).any(dim=1).sum())
        if self.device.type == "cuda":
            line["max_memory_allocated"] = torch.cuda.max_memory_allocated(self.device)
        return line

    def _early_stop(self, early: dict, score: float, name: str, sign: float,
                    step_log: dict) -> None:
        """One evaluation for the patience counter (``score``: higher is
        better)."""
        if score > early["best"]:
            early["best"], early["stale"] = score, 0
            return
        early["stale"] += 1
        if early["stale"] >= self.early_stop_patience:
            early["stop"] = True
            step_log["early_stopped"] = True
            print(f"[early-stop] no {name} improvement in {early['stale']} evaluations (best "
                  f"{sign * early['best']:.4f}); stopping after epoch {self.epoch}", flush=True)
