"""PushT image dataset (the port's own copy of ``data/pusht_dataset.py``):
horizon-long windows of (img, state, action) from a replay buffer, the
limits-fit normalizer of action and agent_pos, a seeded train/val episode
split with its validation dataset, and the synthetic source.

Two sources: ``dataset_path``, a replay buffer (``ReplayBuffer.load``: a
``.npz`` read with numpy, or HDF5 through ``h5py``), or ``synthetic: N``, N episodes of a scripted pusher rolled out
in the port's own PushT env (:func:`make_synthetic_pusht`, the JAX
package's, frame for frame). ``agent_pos_dim`` 14 is the human_pp task's
keypoint variant (``uva_human_pp.yaml``): 7 keypoints of the agent and the
actions, from either source.

``__getitem__`` serves the host loader (``data/loader.py``): a window's
uint8 frames (T, 3, H, W), agent positions and actions. With ``data_aug``
the augmentation runs on the device inside the train step
(``utils/image.augment_video``, the scalars drawn per batch on the host) or,
with ``device_aug=False``, here on the host: JAX's ``_augment``, one draw a
clip from ``default_rng((seed, idx))``, a 95 % crop, the ``INTER_LINEAR``
resize back and a 5 x 5 Gaussian blur with sigma ~ U(0.1, 2), both on uint8
as OpenCV computes them (``envs/raster.resize_linear_u8`` and
``data/augmentation.gaussian_blur_u8``, bit for bit). JAX skips that
augmentation where OpenCV is absent; the port always applies it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from unified_video_action_tpu_torch.data.augmentation import gaussian_blur_u8
from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer, NormalizerField
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
from unified_video_action_tpu_torch.data.sampler import (
    SequenceSampler,
    downsample_mask,
    get_val_mask,
)
from unified_video_action_tpu_torch.envs.raster import resize_linear_u8


class PushTImageDataset:
    def __init__(
        self,
        dataset_path: str = "",
        horizon: int = 32,
        pad_before: int = 0,
        pad_after: int = 0,
        seed: int = 42,
        val_ratio: float = 0.0,
        max_train_episodes: Optional[int] = None,
        data_aug: bool = False,
        device_aug: bool = True,
        synthetic: Optional[int] = None,
        agent_pos_dim: int = 2,
    ):
        self.agent_pos_dim = agent_pos_dim
        if synthetic is not None:
            self.replay_buffer = make_synthetic_pusht(n_episodes=synthetic, seed=seed,
                                                      agent_pos_dim=agent_pos_dim)
        else:
            if not os.path.exists(dataset_path):
                raise FileNotFoundError(f"dataset_path {dataset_path!r} does not exist")
            self.replay_buffer = ReplayBuffer.load(dataset_path, keys=["img", "state", "action"])
        self.val_mask = get_val_mask(self.replay_buffer.n_episodes, val_ratio, seed=seed)
        self.train_mask = downsample_mask(~self.val_mask, max_train_episodes, seed=seed)
        self.sampler = SequenceSampler(self.replay_buffer, sequence_length=horizon,
                                       pad_before=pad_before, pad_after=pad_after,
                                       episode_mask=self.train_mask)
        self.horizon = horizon
        self.pad_before = pad_before
        self.pad_after = pad_after
        self.data_aug = data_aug
        self.device_aug = device_aug
        self.seed = seed

    def get_validation_dataset(self) -> "PushTImageDataset":
        """The windows of the ``val_mask`` episodes, without augmentation
        (JAX's ``get_validation_dataset``), over the same replay buffer."""
        val = object.__new__(PushTImageDataset)
        val.__dict__.update(self.__dict__)
        val.sampler = SequenceSampler(self.replay_buffer, sequence_length=self.horizon,
                                      pad_before=self.pad_before, pad_after=self.pad_after,
                                      episode_mask=self.val_mask)
        val.train_mask = self.val_mask
        val.data_aug = False
        return val

    def get_normalizer(self) -> LinearNormalizer:
        n = LinearNormalizer()
        n.fit({"action": self.replay_buffer["action"],
               "agent_pos": self.replay_buffer["state"][..., : self.agent_pos_dim]})
        n.fields["image"] = NormalizerField.image_range()
        return n

    def __len__(self) -> int:
        return len(self.sampler)

    def __getitem__(self, idx: int) -> Dict:
        """Window ``idx``: ``{"obs": {"image": (T, 3, H, W) uint8,
        "agent_pos": (T, agent_pos_dim) float32}, "action": (T, A) float32}``,
        the frames augmented here under ``data_aug`` without ``device_aug``."""
        sample = self.sampler.sample_sequence(idx)
        agent_pos = sample["state"][:, : self.agent_pos_dim].astype(np.float32)
        image = np.ascontiguousarray(np.moveaxis(sample["img"], -1, 1))
        if self.data_aug and not self.device_aug:
            image = self._augment(image, idx)
        return {"obs": {"image": image, "agent_pos": agent_pos},
                "action": sample["action"].astype(np.float32)}

    def _augment(self, video: np.ndarray, idx: int) -> np.ndarray:
        """One seeded crop, resize and blur for the whole (T, C, H, W) uint8
        clip (JAX's ``_augment``, ``data/pusht_dataset.py:139-160``): the
        frames' channels side by side, so that each step runs once a clip."""
        rng = np.random.default_rng((self.seed, idx))
        T, C, H, W = video.shape
        ch, cw = int(H * 0.95), int(W * 0.95)
        top = rng.integers(0, H - ch + 1)
        left = rng.integers(0, W - cw + 1)
        sigma = float(rng.uniform(0.1, 2.0))
        crop = video[:, :, top:top + ch, left:left + cw]
        planes = np.ascontiguousarray(crop.reshape(T * C, ch, cw).transpose(1, 2, 0))
        out = gaussian_blur_u8(resize_linear_u8(planes, (W, H)), (5, 5), sigma)
        return np.ascontiguousarray(out.transpose(2, 0, 1).reshape(T, C, H, W))


def make_synthetic_pusht(n_episodes: int = 8, max_steps: int = 60, seed: int = 42,
                         render_size: int = 96, agent_pos_dim: int = 2) -> ReplayBuffer:
    """A replay buffer of ``n_episodes`` scripted pushes (at most
    ``max_steps`` each) in the port's PushT env: the agent steers toward the
    block's far side from the goal, with seeded jitter.

    ``agent_pos_dim > 2`` makes the human_pp keypoint variant (JAX's
    ``data/pusht_dataset.py:166-215``): the agent's track and the actions
    become K = agent_pos_dim // 2 keypoints, the position plus K fixed
    offsets drawn ~ U(-20, 20) after each episode's rollout, clipped to [0,
    511]; the state keeps the block's pose after them."""
    from unified_video_action_tpu_torch.envs.pusht import PushTEnv

    buffer = ReplayBuffer()
    rng = np.random.default_rng(seed)
    for _ in range(n_episodes):
        env = PushTEnv(render_size=render_size, render_action=False)
        env.seed(int(rng.integers(0, 10_000)))
        env.reset()
        imgs, states, actions = [], [], []
        goal = env.goal_pose[:2]
        for _ in range(max_steps):
            block = np.asarray(env.block.position)
            agent = np.asarray(env.agent.position)
            push_dir = goal - block
            push_dir = push_dir / (np.linalg.norm(push_dir) + 1e-6)
            target = block - push_dir * 40 + rng.normal(0, 4, 2)
            action = np.clip(agent + (target - agent) * 0.5, 10, 500)
            states.append(np.concatenate([agent, block, [env.block.angle]]))
            imgs.append(env.render("rgb_array"))
            actions.append(action)
            _, _, done, _, _ = env.step(action)
            if done:
                break
        state_arr = np.asarray(states, dtype=np.float32)
        action_arr = np.asarray(actions, dtype=np.float32)
        if agent_pos_dim > 2:
            k = agent_pos_dim // 2
            offs = rng.uniform(-20, 20, (1, k, 2)).astype(np.float32)

            def expand(xy):  # (T, 2) -> (T, 2K): the K keypoints of each step
                return np.clip(xy[:, None, :] + offs, 0, 511).reshape(len(xy), 2 * k)

            action_arr = expand(action_arr)
            state_arr = np.concatenate([expand(state_arr[:, :2]), state_arr[:, 2:]], axis=1)
        buffer.add_episode({"img": np.asarray(imgs, dtype=np.uint8), "state": state_arr,
                            "action": action_arr})
    return buffer
