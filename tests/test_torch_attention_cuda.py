"""The CUDA attention kernel against its plain version, on the card.

Needs an NVIDIA GPU and nvcc; skips without a GPU. The machine with the card
has no JAX, so this file imports only torch and the port, and runs there
without the suite's conftest (which sets up JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_attention_cuda.py

Tolerances are those of tests/test_ops.py: atol 2e-5 in fp32 and 3e-2 in
bf16. The shapes are the serving path's (B=128, N=144), ragged N, and N
beyond the TPU's single-pass limit of 2048.
"""

import pytest
import torch

from unified_video_action_tpu_torch.ops import attention as port


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,N,H,dtype,atol",
    [
        (128, 144, 12, torch.bfloat16, 3e-2),
        (128, 144, 12, torch.float32, 2e-5),
        (4, 100, 12, torch.bfloat16, 3e-2),
        (4, 100, 12, torch.float32, 2e-5),
        (2, 1088, 12, torch.bfloat16, 3e-2),
        (1, 2304, 12, torch.float32, 2e-5),
    ],
)
def test_kernel_matches_plain_on_the_card(B, N, H, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn(B, N, 3, H, 64, generator=g, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    before = port.launch_count
    got = port.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert port.launch_count == before + 1
    want = port.attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
