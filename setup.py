from setuptools import find_packages, setup

setup(
    name="unified_video_action_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas) unified video-action model framework"
    ),
    # unified_video_action_tpu (JAX, the reference) and
    # unified_video_action_tpu_torch (its PyTorch/CUDA port)
    packages=find_packages(exclude=("tests",)),
    package_data={
        "unified_video_action_tpu": ["config/yaml/**/*.yaml"],
        "unified_video_action_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "envs/*.json",
                                           "config/yaml/**/*.yaml"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "einops",
        "pyyaml",
        "h5py",
        "dill",
    ],
    extras_require={
        "envs": ["opencv-python", "pygame"],
        "serving": ["pyzmq"],
        "language": ["transformers"],
        "import": ["torch"],
    },
)
