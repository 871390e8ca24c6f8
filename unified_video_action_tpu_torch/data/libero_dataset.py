"""The LIBERO dataset (the port's own copy of the JAX package's
``data/libero_dataset.py``: ``language_from_filename``,
``prompt_from_filename``, ``tokenize_language`` and
``LiberoReplayImageDataset`` at :102-269), numpy only.

Equivalent of the reference's ``LiberoReplayImageDataset``
(dataset/libero_replay_image_dataset.py:39-509): a directory of per-task
robomimic-layout stores, the language instruction from each file name
("..._SCENE1_pick_up_the_book_demo.hdf5" -> "pick up the book"), the
tokenized instruction on every step (the ``language`` obs key, stacked
input ids and attention mask), the vertical flip of the upside-down
agentview render, rot6d actions under ``abs_action``, the per-episode text
latents under ``emit_language_latents``, and ``ColorJitter`` under
``data_aug``.

Stores are HDF5 files (through ``h5py``) or ``.npz`` stores of the same
layout (``data/robomimic_dataset.RobomimicStore``), by extension; a
directory's ``*.hdf5`` and ``*.npz`` are both read, sorted by name.

``tokenize_language`` differs from the JAX package's on purpose: the CLIP
BPE tokenizer waits for its vocabulary files, and JAX's fallback hashes
each word with Python's ``hash``, which is salted per process
(``PYTHONHASHSEED``), so its ids differ between processes (ROADMAP C14).
The port's fallback hashes each word with sha256: the same ids in every
process.
"""

from __future__ import annotations

import glob
import hashlib
import os
import re
from typing import Dict, List, Optional

import numpy as np

from unified_video_action_tpu_torch.data.augmentation import VideoTransforms
from unified_video_action_tpu_torch.data.normalizer import (
    LinearNormalizer,
    NormalizerField,
    fit_field,
)
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
from unified_video_action_tpu_torch.data.robomimic_dataset import (
    RobomimicStore,
    _abs_action_normalizer,
    convert_robomimic_actions,
)
from unified_video_action_tpu_torch.data.sampler import SequenceSampler, get_val_mask
from unified_video_action_tpu_torch.envs.kitchen_tasks import KITCHEN_TASK_PROMPTS, task_from_name

# the stores of a task directory
STORE_EXTENSIONS = (".hdf5", ".npz")
# the token ids of the hash fallback: 1..TOKEN_BUCKETS
TOKEN_BUCKETS = 30000


def store_stem(path: str) -> str:
    """A store's file name without its extension (``.hdf5`` or ``.npz``)."""
    return re.sub(r"\.(hdf5|npz)$", "", os.path.basename(path))


def task_stores(dataset_dir: str) -> List[str]:
    """The task stores under ``dataset_dir``, sorted by path."""
    return sorted(p for ext in STORE_EXTENSIONS
                  for p in glob.glob(os.path.join(dataset_dir, "*" + ext)))


def language_from_filename(path: str) -> str:
    """'KITCHEN_SCENE1_put_the_black_bowl_demo.hdf5' -> 'put the black bowl'
    (reference derives the instruction after the SCENE marker, :326-333)."""
    stem = re.sub(r"_demo$", "", store_stem(path))
    m = re.search(r"SCENE\d+_(.*)", stem)
    text = m.group(1) if m else stem
    return text.replace("_", " ").strip()


def prompt_from_filename(path: str) -> str:
    """The instruction of a demo file, the string the eval runner conditions
    on: a kitchen task's prompt where the name holds one, else
    :func:`language_from_filename`."""
    task = task_from_name(path)
    if task is not None:
        return KITCHEN_TASK_PROMPTS[task]
    return language_from_filename(path)


def stable_token_id(word: str) -> int:
    """A word's token id in 1..TOKEN_BUCKETS: the first 8 bytes of its
    sha256, little-endian, modulo TOKEN_BUCKETS, plus 1."""
    return int.from_bytes(hashlib.sha256(word.encode()).digest()[:8], "little") % TOKEN_BUCKETS + 1


def tokenize_language(text: str, max_length: int = 77) -> np.ndarray:
    """(2, max_length) int64 stacked [input_ids; attention_mask]: one id per
    whitespace-separated word (:func:`stable_token_id`), at most
    ``max_length``, zeros after."""
    ids = np.zeros(max_length, np.int64)
    mask = np.zeros(max_length, np.int64)
    for i, w in enumerate(text.split()[:max_length]):
        ids[i] = stable_token_id(w)
        mask[i] = 1
    return np.stack([ids, mask], axis=0)


class LiberoReplayImageDataset:
    def __init__(
        self,
        dataset_dir: str,
        shape_meta: dict,
        horizon: int = 32,
        pad_before: int = 0,
        pad_after: int = 0,
        abs_action: bool = True,
        seed: int = 42,
        val_ratio: float = 0.0,
        max_episodes_per_task: Optional[int] = None,
        data_aug: bool = False,
        language_max_length: int = 77,
        emit_language_latents: bool = False,
        **kwargs,
    ):
        files = task_stores(dataset_dir)
        if not files:
            raise FileNotFoundError(f"no .hdf5 or .npz stores under {dataset_dir}")
        obs_meta = shape_meta["obs"]
        self.rgb_keys = [k for k, v in obs_meta.items() if v.get("type") == "rgb"]
        self.lowdim_keys = [k for k, v in obs_meta.items()
                            if v.get("type") == "low_dim" and k != "language"]

        # the text latents of each task's prompt, through the encoder the
        # policy and the eval runner use (the hash encoder without CLIP
        # weights), once per task file
        self.emit_language_latents = bool(emit_language_latents)
        text_encoder = None
        if self.emit_language_latents:
            from unified_video_action_tpu_torch.utils.language import get_text_encoder

            text_encoder, _ = get_text_encoder("libero", "clip")

        self.replay_buffer = ReplayBuffer.create_empty()
        episode_latents: List[np.ndarray] = []
        for path in files:
            prompt = prompt_from_filename(path)
            tokens = tokenize_language(prompt, language_max_length)
            latent = (text_encoder.encode(prompt)[0].astype(np.float32)
                      if text_encoder is not None else None)
            with RobomimicStore(path) as store:
                demos = store.demos()
                if max_episodes_per_task is not None:
                    demos = demos[:max_episodes_per_task]
                for demo in demos:
                    ep: Dict[str, np.ndarray] = {}
                    for k in self.rgb_keys:
                        # agentview renders bottom-up; the reference's rot180
                        # then horizontal flip (:218-223) is a vertical flip,
                        # as the eval adapter's img[::-1]
                        ep[k] = store[f"data/{demo}/obs/{k}"][:, ::-1, :]
                    for k in self.lowdim_keys:
                        ep[k] = store[f"data/{demo}/obs/{k}"]
                    ep["action"] = convert_robomimic_actions(store[f"data/{demo}/actions"],
                                                             abs_action=abs_action)
                    ep["language"] = np.tile(tokens[None], (len(ep["action"]), 1, 1))
                    self.replay_buffer.add_episode(ep)
                    if latent is not None:
                        episode_latents.append(latent)
        self.episode_latents = np.stack(episode_latents) if episode_latents else None

        val_mask = get_val_mask(self.replay_buffer.n_episodes, val_ratio, seed)
        self.train_mask = ~val_mask
        self.val_mask = val_mask
        self.sampler = SequenceSampler(self.replay_buffer, sequence_length=horizon,
                                       pad_before=pad_before, pad_after=pad_after,
                                       episode_mask=self.train_mask)
        self.horizon = horizon
        self.pad_before, self.pad_after = pad_before, pad_after
        self.abs_action = abs_action
        self.seed = seed
        self.transforms = (
            VideoTransforms([{"name": "ColorJitter", "brightness": 0.3, "contrast": 0.4,
                              "saturation": 0.5, "hue": 0.08, "p": 0.8}], seed=seed)
            if data_aug else None
        )

    def get_validation_dataset(self) -> "LiberoReplayImageDataset":
        val = object.__new__(LiberoReplayImageDataset)
        val.__dict__.update(self.__dict__)
        val.sampler = SequenceSampler(self.replay_buffer, sequence_length=self.horizon,
                                      pad_before=self.pad_before, pad_after=self.pad_after,
                                      episode_mask=self.val_mask)
        val.transforms = None
        return val

    def get_normalizer(self) -> LinearNormalizer:
        n = LinearNormalizer()
        action = self.replay_buffer["action"]
        n.fields["action"] = _abs_action_normalizer(action) if self.abs_action else fit_field(action)
        for k in self.rgb_keys:
            n.fields[k] = NormalizerField.image_range()
        for k in self.lowdim_keys:
            n.fields[k] = fit_field(self.replay_buffer[k])
        return n

    def __len__(self) -> int:
        return len(self.sampler)

    def __getitem__(self, idx: int) -> Dict:
        sample = self.sampler.sample_sequence(idx)
        obs: Dict[str, np.ndarray] = {}
        for k in self.rgb_keys:
            if self.transforms is not None:
                img = np.moveaxis(sample[k].astype(np.float32) / 255.0, -1, 1)
                img = self.transforms(img, sample_seed=idx)
            else:
                # no host transform: the frames stay uint8 (the train step
                # scales them on the device)
                img = np.moveaxis(sample[k], -1, 1)
            obs[k] = img
        for k in self.lowdim_keys:
            obs[k] = sample[k].astype(np.float32)
        obs["language"] = sample["language"].astype(np.int64)
        item = {"obs": obs, "action": sample["action"].astype(np.float32)}
        if self.emit_language_latents and self.episode_latents is not None:
            buffer_start = int(self.sampler.indices[idx][0])
            ep_idx = int(np.searchsorted(self.replay_buffer.episode_ends, buffer_start,
                                         side="right"))
            item["language_latents"] = self.episode_latents[ep_idx]
        return item
