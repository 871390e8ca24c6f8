from unified_video_action_tpu_torch.models.diffusion.gaussian import (
    GaussianDiffusion,
    create_diffusion,
    space_timesteps,
)

__all__ = ["GaussianDiffusion", "create_diffusion", "space_timesteps"]
