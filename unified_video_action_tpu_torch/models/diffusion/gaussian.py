"""IDDPM-family gaussian diffusion for sampling (port of
``models/diffusion/gaussian.py``: schedules, ``space_timesteps``,
``_map_t``, ``p_mean_variance`` with LEARNED_RANGE, ``p_sample_loop`` at
:308-340 and ``ddim_sample_loop`` at :342-383). ``training_losses`` waits for
the training slice.

The schedule is computed once in float64 numpy, as in the JAX package, and
each coefficient enters the arithmetic as its float32 value. The loops are
plain Python loops over the respaced steps; all rows of a batch share the
step, so the coefficients are scalars. Randomness is injected: a loop takes
the per-step standard-normal noise as one (steps, N, C) tensor, whose row i
is used at the i-th step taken (internal step ``steps - 1 - i``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x_t, t_orig) -> (..., 2C)


def linear_beta_schedule(num_timesteps: int) -> np.ndarray:
    scale = 1000.0 / num_timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, num_timesteps, dtype=np.float64)


def cosine_beta_schedule(num_timesteps: int, max_beta: float = 0.999) -> np.ndarray:
    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = [
        min(1 - alpha_bar((i + 1) / num_timesteps) / alpha_bar(i / num_timesteps), max_beta)
        for i in range(num_timesteps)
    ]
    return np.array(betas, dtype=np.float64)


def get_named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_beta_schedule(num_timesteps)
    if name == "cosine":
        return cosine_beta_schedule(num_timesteps)
    raise ValueError(f"unknown beta schedule: {name}")


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Original timesteps kept by a respacing: an int, a list of ints, or a
    string ("100", "25,25" or "ddimN"), with the reference's semantics
    (respace.py:12-61)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    elif isinstance(section_counts, int):
        section_counts = [section_counts]

    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


class GaussianDiffusion:
    """Schedule of one (possibly respaced) diffusion, with LEARNED_RANGE
    variance and EPSILON mean prediction. ``timestep_map`` maps the internal
    step index to the original timestep the denoiser was trained on."""

    def __init__(self, betas: np.ndarray, timestep_map: np.ndarray, original_num_steps: int):
        betas = np.asarray(betas, dtype=np.float64)
        if betas.ndim != 1 or not ((betas > 0).all() and (betas <= 1).all()):
            raise ValueError("betas must be a 1-D array in (0, 1]")
        self.timestep_map = np.asarray(timestep_map, dtype=np.int64)
        self.original_num_steps = original_num_steps
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        self.betas = betas
        self.alphas_cumprod = acp
        self.alphas_cumprod_prev = acp_prev
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / acp)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / acp - 1.0)
        self.posterior_log_variance_clipped = np.log(np.append(post_var[1], post_var[1:]))
        self.posterior_mean_coef1 = betas * np.sqrt(acp_prev) / (1.0 - acp)
        self.posterior_mean_coef2 = (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)
        self.log_betas = np.log(betas)

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    @staticmethod
    def _f32(arr: np.ndarray, t: int) -> float:
        """Coefficient ``arr[t]`` as its float32 value."""
        return float(np.float32(arr[t]))

    def _map_t(self, t: int, n: int, device: torch.device) -> torch.Tensor:
        """(n,) original timesteps for internal step ``t``."""
        return torch.full((n,), int(self.timestep_map[t]), dtype=torch.int64, device=device)

    def p_mean_variance(self, model_output: torch.Tensor, x_t: torch.Tensor, t: int,
                        clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
        """LEARNED_RANGE + EPSILON posterior for internal step ``t`` (the same
        for every row). ``model_output`` is (eps ‖ v) on the last axis."""
        c = x_t.shape[-1]
        eps, v = model_output[..., :c], model_output[..., c:]
        min_log = self._f32(self.posterior_log_variance_clipped, t)
        max_log = self._f32(self.log_betas, t)
        frac = (v + 1.0) / 2.0
        model_log_variance = frac * max_log + (1.0 - frac) * min_log
        pred_xstart = (
            self._f32(self.sqrt_recip_alphas_cumprod, t) * x_t
            - self._f32(self.sqrt_recipm1_alphas_cumprod, t) * eps
        )
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        mean = (
            self._f32(self.posterior_mean_coef1, t) * pred_xstart
            + self._f32(self.posterior_mean_coef2, t) * x_t
        )
        return {
            "mean": mean,
            "variance": torch.exp(model_log_variance),
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    def _check_noise(self, noise: torch.Tensor, step_noise: torch.Tensor) -> None:
        want = (self.num_timesteps,) + tuple(noise.shape)
        if tuple(step_noise.shape) != want:
            raise ValueError(f"step_noise must be {want}, got {tuple(step_noise.shape)}")

    def p_sample_loop(self, denoise_fn: DenoiseFn, noise: torch.Tensor,
                      step_noise: torch.Tensor, clip_denoised: bool = True,
                      temperature: float = 1.0) -> torch.Tensor:
        """Ancestral sampling from ``noise`` over every respaced step. The
        added noise is scaled by ``temperature``; none is added at t == 0."""
        self._check_noise(noise, step_noise)
        x = noise
        for i, t in enumerate(range(self.num_timesteps - 1, -1, -1)):
            out = self.p_mean_variance(
                denoise_fn(x, self._map_t(t, x.shape[0], x.device)), x, t,
                clip_denoised=clip_denoised,
            )
            x = out["mean"]
            if t != 0:
                x = x + torch.exp(0.5 * out["log_variance"]) * step_noise[i] * temperature
        return x

    def ddim_sample_loop(self, denoise_fn: DenoiseFn, noise: torch.Tensor,
                         step_noise: torch.Tensor, clip_denoised: bool = True,
                         eta: float = 0.0) -> torch.Tensor:
        """DDIM sampling over the respaced schedule (noise enters only when
        ``eta`` > 0)."""
        self._check_noise(noise, step_noise)
        x = noise
        for i, t in enumerate(range(self.num_timesteps - 1, -1, -1)):
            out = self.p_mean_variance(
                denoise_fn(x, self._map_t(t, x.shape[0], x.device)), x, t,
                clip_denoised=clip_denoised,
            )
            x0 = out["pred_xstart"]
            a_t = self._f32(self.alphas_cumprod, t)
            a_prev = self._f32(self.alphas_cumprod_prev, t)
            eps = (self._f32(self.sqrt_recip_alphas_cumprod, t) * x - x0) / self._f32(
                self.sqrt_recipm1_alphas_cumprod, t
            )
            sigma = eta * math.sqrt((1 - a_prev) / (1 - a_t)) * math.sqrt(1 - a_t / a_prev)
            x = x0 * math.sqrt(a_prev) + math.sqrt(1 - a_prev - sigma**2) * eps
            if t != 0:
                x = x + sigma * step_noise[i]
        return x


def create_diffusion(timestep_respacing, noise_schedule: str = "cosine",
                     diffusion_steps: int = 1000) -> GaussianDiffusion:
    """The reference's factory (diffusion/__init__.py:11-47): keep the
    respaced steps and recompute betas from the kept alpha-bars."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    use_timesteps = space_timesteps(diffusion_steps, timestep_respacing)
    timestep_map, new_betas = [], []
    last_alpha_cumprod = 1.0
    for i, acp in enumerate(np.cumprod(1.0 - betas)):
        if i in use_timesteps:
            new_betas.append(1 - acp / last_alpha_cumprod)
            last_alpha_cumprod = acp
            timestep_map.append(i)
    return GaussianDiffusion(
        betas=np.array(new_betas, dtype=np.float64),
        timestep_map=np.array(timestep_map, dtype=np.int64),
        original_num_steps=diffusion_steps,
    )
