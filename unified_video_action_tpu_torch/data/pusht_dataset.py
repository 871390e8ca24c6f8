"""PushT image dataset (the port's own copy of ``data/pusht_dataset.py``):
horizon-long windows of (img, state, action) from a replay buffer, the
limits-fit normalizer of action and agent_pos, a seeded train/val episode
split with its validation dataset, and the synthetic source.

Two sources: ``dataset_path``, a replay buffer (``ReplayBuffer.load``: a
``.npz`` read with numpy, or HDF5 through ``h5py``), or ``synthetic: N``, N episodes of a scripted pusher rolled out
in the port's own PushT env (:func:`make_synthetic_pusht`, the JAX
package's, frame for frame). With ``data_aug`` the augmentation runs on the
device inside the train step (``utils/image.augment_video``); the host cv2
path of ``device_aug=False`` waits for a later slice.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from unified_video_action_tpu_torch.data.normalizer import LinearNormalizer, NormalizerField
from unified_video_action_tpu_torch.data.replay_buffer import ReplayBuffer
from unified_video_action_tpu_torch.data.sampler import (
    SequenceSampler,
    downsample_mask,
    get_val_mask,
)


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
        if data_aug and not device_aug:
            raise NotImplementedError("the host (cv2) augmentation is not ported; "
                                      "data_aug runs on the device (device_aug=True)")
        self.agent_pos_dim = agent_pos_dim
        if synthetic is not None:
            if agent_pos_dim != 2:
                raise NotImplementedError("the synthetic source has the 2-d agent position only")
            self.replay_buffer = make_synthetic_pusht(n_episodes=synthetic, seed=seed)
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


def make_synthetic_pusht(n_episodes: int = 8, max_steps: int = 60, seed: int = 42,
                         render_size: int = 96) -> ReplayBuffer:
    """A replay buffer of ``n_episodes`` scripted pushes (at most
    ``max_steps`` each) in the port's PushT env: the agent steers toward the
    block's far side from the goal, with seeded jitter."""
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
        buffer.add_episode({"img": np.asarray(imgs, dtype=np.uint8),
                            "state": np.asarray(states, dtype=np.float32),
                            "action": np.asarray(actions, dtype=np.float32)})
    return buffer
