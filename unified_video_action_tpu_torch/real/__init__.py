"""Real-robot runtime (the port's own copy of ``real/``): timed-waypoint
controllers over the native C++ shared-memory IPC, camera processes, and
the latency-aligned UmiRealEnv orchestration (the reference's
umi/real_world stack, umi/real_world/umi_env.py:26-603,
rtde_interpolation_controller.py:23-376, wsg_controller.py:19-241,
uvc_camera.py:22-330). numpy, scipy and the standard library only; OpenCV
is imported inside the few functions that need it."""

from unified_video_action_tpu_torch.real.trajectory import (  # noqa: F401
    PoseTrajectory,
    ScalarTrajectory,
)
from unified_video_action_tpu_torch.real.controller import (  # noqa: F401
    PoseInterpolationController,
    WidthController,
)
from unified_video_action_tpu_torch.real.camera import CameraProcess  # noqa: F401
from unified_video_action_tpu_torch.real.env import UmiRealEnv  # noqa: F401
from unified_video_action_tpu_torch.real.visualizer import MultiCameraVisualizer  # noqa: F401
