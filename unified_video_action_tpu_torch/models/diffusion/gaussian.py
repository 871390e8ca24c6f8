"""IDDPM-family gaussian diffusion (port of ``models/diffusion/gaussian.py``:
schedules, ``space_timesteps``, ``_map_t``, ``p_mean_variance`` with
LEARNED_RANGE, ``p_sample_loop`` at :308-340, ``ddim_sample_loop`` at
:342-383, and for training ``q_sample`` (:246), ``q_posterior_mean_variance``
(:253), the log-likelihood helpers (:121-162), ``vb_terms_bpd`` (:387) and
``training_losses`` (:406-433)).

The schedule is computed once in float64 numpy, as in the JAX package, and
each coefficient enters the arithmetic as its float32 value. The loops are
plain Python loops over the respaced steps; all rows of a batch share the
step, so the coefficients are scalars. Training draws one step per row: there
``t`` is an int64 tensor and the coefficients are gathered per row. Randomness
is injected: a loop takes the per-step standard-normal noise as one (steps,
N, C) tensor, whose row i is used at the i-th step taken (internal step
``steps - 1 - i``); ``training_losses`` takes its noise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Union

import numpy as np
import torch

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x_t, t_orig) -> (..., 2C)
# an internal step shared by every row (sampling), or one per row (training)
Step = Union[int, torch.Tensor]


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


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two diagonal gaussians, elementwise (in nats)."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of a gaussian discretized to 1/255-wide buckets on [-1, 1]."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all axes but the first."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


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
        self.sqrt_alphas_cumprod = np.sqrt(acp)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - acp)
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
    def _f32(arr: np.ndarray, t: Step, x: torch.Tensor = None):
        """Coefficient ``arr[t]`` as its float32 value: a Python float for an
        int step, else gathered per row of ``t`` and shaped to broadcast over
        ``x`` (JAX's ``_gather``)."""
        if isinstance(t, int):
            return float(np.float32(arr[t]))
        out = torch.as_tensor(arr, dtype=torch.float32, device=t.device)[t]
        return out.reshape(out.shape + (1,) * (x.dim() - out.dim()))

    def _map_t(self, t: Step, n: int, device: torch.device) -> torch.Tensor:
        """(n,) original timesteps for internal step ``t`` (or for each row's)."""
        if isinstance(t, int):
            return torch.full((n,), int(self.timestep_map[t]), dtype=torch.int64, device=device)
        return torch.as_tensor(self.timestep_map, device=t.device)[t]

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return (self._f32(self.sqrt_alphas_cumprod, t, x_start) * x_start
                + self._f32(self.sqrt_one_minus_alphas_cumprod, t, x_start) * noise)

    def q_posterior_mean_variance(self, x_start: torch.Tensor, x_t: torch.Tensor, t: torch.Tensor):
        """Mean and log variance of q(x_{t-1} | x_t, x_0)."""
        mean = (self._f32(self.posterior_mean_coef1, t, x_t) * x_start
                + self._f32(self.posterior_mean_coef2, t, x_t) * x_t)
        return mean, self._f32(self.posterior_log_variance_clipped, t, x_t)

    def p_mean_variance(self, model_output: torch.Tensor, x_t: torch.Tensor, t: Step,
                        clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
        """LEARNED_RANGE + EPSILON posterior for internal step ``t`` (an int
        for every row, or a tensor of one per row). ``model_output`` is
        (eps ‖ v) on the last axis."""
        c = x_t.shape[-1]
        eps, v = model_output[..., :c], model_output[..., c:]
        min_log = self._f32(self.posterior_log_variance_clipped, t, x_t)
        max_log = self._f32(self.log_betas, t, x_t)
        frac = (v + 1.0) / 2.0
        model_log_variance = frac * max_log + (1.0 - frac) * min_log
        pred_xstart = (
            self._f32(self.sqrt_recip_alphas_cumprod, t, x_t) * x_t
            - self._f32(self.sqrt_recipm1_alphas_cumprod, t, x_t) * eps
        )
        if clip_denoised:
            pred_xstart = pred_xstart.clamp(-1.0, 1.0)
        mean = (
            self._f32(self.posterior_mean_coef1, t, x_t) * pred_xstart
            + self._f32(self.posterior_mean_coef2, t, x_t) * x_t
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


    def vb_terms_bpd(self, model_output: torch.Tensor, x_start: torch.Tensor, x_t: torch.Tensor,
                     t: torch.Tensor, clip_denoised: bool = False) -> torch.Tensor:
        """Variational-bound term per row in bits per dim: the KL of the
        posteriors, or the decoder's NLL where t == 0."""
        true_mean, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        out = self.p_mean_variance(model_output, x_t, t, clip_denoised=clip_denoised)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = mean_flat(kl) / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        decoder_nll = mean_flat(decoder_nll) / math.log(2.0)
        return torch.where(t == 0, decoder_nll, kl)

    def training_losses(self, denoise_fn: DenoiseFn, x_start: torch.Tensor, t: torch.Tensor,
                        noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """MSE(eps) + learned-range VB loss per row, shape (N,). ``t``: (N,)
        int64 internal steps of this schedule; ``noise``: standard normal of
        ``x_start``'s shape. The VB term sees eps detached, so the variance
        head cannot move the mean prediction."""
        x_t = self.q_sample(x_start, t, noise)
        model_output = denoise_fn(x_t, self._map_t(t, t.shape[0], t.device))
        c = x_start.shape[-1]
        eps, v = model_output[..., :c], model_output[..., c:]
        frozen_out = torch.cat([eps.detach(), v], dim=-1)
        vb = self.vb_terms_bpd(frozen_out, x_start, x_t, t, clip_denoised=False)
        mse = mean_flat((noise - eps) ** 2)
        return {"loss": mse + vb, "mse": mse, "vb": vb}


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
