"""Non-causal flash attention: the CUDA kernels' wrapper and their plain version.

Port of ``unified_video_action_tpu/ops/attention.py:33-191`` (the Pallas
kernels ``_attn_kernel_single_pass`` and ``_attn_kernel`` behind
``flash_attention``). The kernels are ``csrc/attention.cu``; its source says
what bounds them on an H100 and how they are laid out.

Layout: q, k, v are (B, N, H, D), as the fused qkv projection leaves them;
the kernels read them through their strides, so the views that
``MultiHeadAttention`` slices out of one qkv tensor go in without a copy.
Every kernel is built for each head dimension of ``HEAD_DIMS``: 64
(mar_base, 768 over 12 heads), 80 (mar_huge, 1280 over 16) and 128
(mar_small and mar_tiny, 768 over 6); another D raises ``ValueError`` on
the card.

:func:`flash_attention` launches the kernel that :func:`attention_plan`
names, with no fallback between kernels:

* ``attention_wgmma``: bf16, N <= ``SINGLE_PASS_MAX_N`` (144). The
  single-pass Hopper kernel (TMA + wgmma, the exact softmax of a whole
  row), as the TPU's ``_attn_kernel_single_pass``.
* ``attention_wgmma_online``: bf16, N > ``SINGLE_PASS_MAX_N``. The
  online-softmax Hopper kernel (TMA ring of 128-row KV tiles,
  warp-specialized, wgmma for both products; at D = 80 its tiles hold the
  80 columns exactly, a 64-column and a 16-column slab), as the TPU's
  ``_attn_kernel``.
* ``attention_f32``: fp32, aligned or not. Both products on the tensor
  cores in 3xTF32 (each operand split into two TF32 halves, three mma.sync
  m16n8k8 products, within the fp32 tolerance of 2e-5 where one TF32
  product is not), K and V streamed in KV tiles by cp.async, an online
  softmax in registers; its tile by D and N is ``launch_tf32_default`` in
  the source.

TMA reads only views whose every base and stride is a multiple of 16 bytes.
A bf16 call with an operand off that boundary is ``staged``: one launch of
the copy kernel ``uva_stage_qkv`` (:func:`stage_qkv`, counted as
``attention_stage``) puts q, k and v into one contiguous (B, N, 3, H, D)
buffer, and the plan's TMA kernel runs on its views.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch

from unified_video_action_tpu_torch.ops import _build

# the head dimensions the kernels are built for (csrc/attention.cu)
HEAD_DIMS = (64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the KV rows the single-pass kernel holds in shared memory (the 96 px path's
# N; above it the online kernel is the faster, attention_plan)
SINGLE_PASS_MAX_N = 144
KERNELS = ("attention_wgmma", "attention_wgmma_online", "attention_f32")
# the staging copy's counter (:func:`stage_qkv`)
STAGE = "attention_stage"

# Incremented once for every launch of each CUDA kernel, and nowhere else:
# by kernel (the attention kernels and the staging copy), and by attention
# kernel and head dimension (the instance, ``plan.instance``)
launch_count = {k: 0 for k in KERNELS + (STAGE,)}
INSTANCES = tuple(f"{k}_d{d}" for k in KERNELS for d in HEAD_DIMS)
instance_count = {i: 0 for i in INSTANCES}

ENCODE_ERROR = 10000  # csrc/hopper.cuh kEncodeError


# by head dimension: up to this many (head, q-tile) pairs the single-pass
# kernel gives each pair a CTA of its own (two per SM of an H100 at D = 64),
# else a CTA takes a head. None: always, since at D = 128 a whole head's
# stage (120 KB) leaves room for no second one, and the split instance (two
# 88 KB stages) was the faster at every batch swept but B = 16 (below). The
# single pass holds D = 80 in D = 128's layout (csrc/attention.cu), so the
# same holds.
SPLIT_MAX_TILES = {64: 264, 80: None, 128: None}
# by head dimension: the online kernel's work items are 64-row q-tiles (CTAs
# of one warpgroup, two an SM at D = 64 and 80, one at D = 128) up to this
# many 128-row ones (three waves of an H100's 132 SMs at D = 64; at D = 80
# the sweep puts the crossover between 64 and 80, with the padded tiles and
# with the exact-width ones), else 128-row q-tiles (two warpgroups taking
# turns)
ONLINE_SPLIT_MAX_ITEMS = {64: 396, 80: 66, 128: 288}


@dataclass(frozen=True)
class AttentionPlan:
    """Which kernel :func:`flash_attention` launches: ``kernel`` is the key of
    :data:`launch_count`, ``head_dim`` the D of its instance (``instance``
    is the key of :data:`instance_count`); for the single-pass kernel
    ``split`` says a CTA takes one q-tile of a head instead of the whole
    head, for the online kernel that its work items are 64-row q-tiles
    instead of 128; ``staged`` that the operands are first copied by
    :func:`stage_qkv` into one buffer that TMA can read."""
    kernel: str
    head_dim: int
    split: bool = False
    staged: bool = False

    @property
    def instance(self) -> str:
        return f"{self.kernel}_d{self.head_dim}"


@functools.lru_cache(maxsize=1024)
def attention_plan(B: int, N: int, H: int, D: int, dtype: torch.dtype,
                   aligned: bool = True) -> AttentionPlan:
    """The kernel for (B, N, H, D) attention in ``dtype``; ``aligned`` says
    every operand's base and strides are 16-byte multiples (TMA's rules).
    Cached: the serving path asks for the same shapes on every call. A D
    outside ``HEAD_DIMS`` raises ``ValueError``.

    * fp32: the 3xTF32 tensor-core kernel, aligned or not.
    * bf16, an operand off a 16-byte boundary: the plan of the aligned call
      of the same shape, ``staged``.
    * bf16, N <= SINGLE_PASS_MAX_N (144, the 96 px path's N): the
      single-pass wgmma kernel, split where B·H·⌈N/64⌉ <= SPLIT_MAX_TILES[D]
      (B = 1 at the serving shape: 36 q-tiles on 36 SMs instead of 12 heads
      on 12; B <= 7 at N = 144 and H = 12), always at D = 80 and 128.
    * bf16, N > 144: the online-softmax wgmma kernel (the 256 px path's N =
      1024, the kitchen path's 320), in 64-row work items where
      B·H·⌈N/128⌉ <= ONLINE_SPLIT_MAX_ITEMS[D] (B = 1 at N = 1024: 96
      items), else in 128-row ones (B = 128).

    The crossover and the split follow ``tools/kernels_ab.py --parts
    attention_variants`` on an H100 (every variant at 24 shapes, PERF.md):
    at N = 144 the single-pass kernel takes 0.048 ms at B = 128 against the
    online kernel's 0.065, and from N = 145 to 256 the online kernel is the
    faster at B = 1, 8 and 128 (at (128, 256) 0.081 ms against the
    single-pass kernel's 256-row instance's 0.101, which was therefore
    dropped). At the path's N = 1024 the two item sizes are even at B = 1
    and 128-row items are the faster at B = 128. At D = 128 (6 heads, the
    same sweep at 23 shapes): at N = 144 the split single pass took 0.0554
    ms at B = 128 against the whole-head instance's 0.0602 and 0.0047 at B =
    1 against 0.0082, losing only at B = 16 (0.0104 against 0.0096); at N =
    320 the 64-row online items were the faster up to B = 16 (288 items;
    0.0230 ms against 0.0242) but for B = 12 (0.0182 against 0.0175), and
    128-row items from B = 22 (396 items) on. At D = 80 (16 heads, the same
    sweep at 21 shapes): at N = 144 the split single pass was the faster at
    every B (0.1135 ms at B = 128 against the online kernel's 0.1365); past
    it 64-row online items were the faster up to 64 items of 128 rows (at
    (1, 512) 0.0096 ms against 0.0110) and 128-row items from 80 items (at
    (1, 640) 0.0131 against 0.0177; at (1, 1024) 0.0205 against 0.0287).
    The online kernel's exact-width D = 80 tiles (two 64-row CTAs an SM)
    kept that crossover in the same sweep: 64-row items at (1, 512) 0.0083
    ms against 0.0088-0.0092, 128-row items at (1, 640) 0.0104 against
    0.0120 and at (1, 1024) 0.0148-0.0149 against 0.0177-0.0181; at N =
    144 and B = 128 its 64-row items (0.1075-0.1095 ms) now edge out the
    single pass (0.1132-0.1159), which still takes N <= 144 (the faster at
    B <= 16).
    """
    if B <= 0 or N <= 0 or H <= 0:
        raise ValueError(f"attention of shape ({B}, {N}, {H}) is empty")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernels are built for D in {HEAD_DIMS}, got D={D}")
    if dtype == torch.float32:
        return AttentionPlan("attention_f32", D)
    if dtype != torch.bfloat16:
        raise ValueError(f"the kernels take float32 or bfloat16, got {dtype}")
    if N <= SINGLE_PASS_MAX_N:
        limit = SPLIT_MAX_TILES[D]
        return AttentionPlan("attention_wgmma", D, limit is None or B * H * -(-N // 64) <= limit,
                             not aligned)
    return AttentionPlan("attention_wgmma_online", D,
                         B * H * -(-N // 128) <= ONLINE_SPLIT_MAX_ITEMS[D], not aligned)


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """JAX's ``tied_dropout`` given its mask (``models/transformer.py:25-47``):
    ``where(keep, x / (1 - rate), 0)``; the identity where ``keep`` is None."""
    if keep is None:
        return x
    # 1 - rate in x's dtype, as JAX rounds a Python scalar to the array's dtype
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    keep: Optional[torch.Tensor] = None, rate: float = 0.0,
                    fp32_products: bool = True) -> torch.Tensor:
    """The plain version: einsum, softmax in fp32, einsum (the JAX package's
    einsum path, ``models/transformer.py:128-134``), cast back to q's dtype.
    With ``fp32_products`` (the version the kernels are held to, and
    serving's plain route) both products are taken in fp32; without, in q's
    dtype, as JAX's XLA path takes them in its compute dtype (training),
    the probabilities cast to that dtype before the second product.
    ``keep`` is the attention-weight dropout's mask at ``rate``."""
    D = q.shape[-1]
    dtype = torch.float32 if fp32_products else q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dtype), k.to(dtype)) * (D ** -0.5)
    p = dropout(torch.softmax(s.float(), dim=-1).to(dtype), keep, rate)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(dtype)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("attention")
    common = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
    lib.uva_flash_attention.argtypes = common + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.uva_flash_attention.restype = ctypes.c_int
    lib.uva_flash_attention_tf32_tile.argtypes = common + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.uva_flash_attention_tf32_tile.restype = ctypes.c_int
    lib.uva_flash_attention_wgmma.argtypes = common + [ctypes.c_int, ctypes.c_void_p]
    lib.uva_flash_attention_wgmma.restype = ctypes.c_int
    lib.uva_flash_attention_online.argtypes = common + [ctypes.c_int, ctypes.c_void_p]
    lib.uva_flash_attention_online.restype = ctypes.c_int
    lib.uva_stage_qkv.argtypes = common + [ctypes.c_void_p]
    lib.uva_stage_qkv.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Raises on what no kernel takes; returns whether every tensor's base and
    (B, N, H) strides are 16-byte multiples (``attention_plan``'s ``aligned``)."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, N, H, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernels are built for D in {HEAD_DIMS}, got D={q.shape[-1]}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    item = q.element_size()
    aligned = True
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        sb, sn, sh, sd = x.stride()
        if sd != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
        aligned = aligned and x.data_ptr() % 16 == 0 and (sb * item) % 16 == 0 \
            and (sn * item) % 16 == 0 and (sh * item) % 16 == 0
    return aligned


def stage_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The staging copy's plain version: q, k, v stacked into one contiguous
    (B, N, 3, H, D) tensor."""
    return torch.stack((q, k, v), dim=2)


def stage_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k and v copied into one contiguous (B, N, 3, H, D) buffer, returned
    as its three (B, N, H, D) views: every base and stride a multiple of
    D·2 or H·D·2 bytes, which ``_check`` calls aligned and the TMA kernels
    take. On CUDA tensors (bf16) one launch of ``uva_stage_qkv`` into a
    buffer from the caching allocator (its base 512-byte aligned), or
    raises; on CPU tensors :func:`stage_plain`."""
    if q.device.type == "cpu":
        return stage_plain(q, k, v).unbind(2)
    _check(q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the staging copy takes bfloat16, got {q.dtype}")
    B, N, H, D = q.shape
    qkv = torch.empty((B, N, 3, H, D), dtype=q.dtype, device=q.device)
    rc = _lib().uva_stage_qkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), qkv.data_ptr(), B, N, H, D,
                              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                              torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attention staging copy launch failed: CUDA error {rc}")
    launch_count[STAGE] += 1
    return qkv.unbind(2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q·Kᵀ·D^-½)·V over (B, N, H, D) tensors -> contiguous (B, N, H, D).

    On a CUDA tensor this launches the kernel :func:`attention_plan` names,
    after the staging copy where the plan is ``staged`` (or raises); on a
    CPU tensor it runs the plain version. The kernels have no backward: an
    input that requires grad raises, on either device (training attends
    through the blocks' plain path, ``models/transformer.py``).
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("flash_attention has no backward: inputs that require grad go through "
                         "the plain training path (MultiHeadAttention in train mode)")
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    aligned = _check(q, k, v)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    plan = attention_plan(B, N, H, D, q.dtype, aligned)
    if plan.staged:
        q, k, v = stage_qkv(q, k, v)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan.kernel == "attention_wgmma":
        rc = _lib().uva_flash_attention_wgmma(*args, int(plan.split), stream)
    elif plan.kernel == "attention_wgmma_online":
        rc = _lib().uva_flash_attention_online(*args, int(plan.split), stream)
    else:
        rc = _lib().uva_flash_attention(*args, _DTYPE_CODES[q.dtype], int(aligned), stream)
    if rc >= ENCODE_ERROR:
        raise RuntimeError(f"flash attention ({plan.kernel}): cuTensorMapEncodeTiled failed: "
                           f"CUresult {rc - ENCODE_ERROR}")
    if rc != 0:
        raise RuntimeError(f"flash attention kernel launch failed ({plan.kernel}): CUDA error {rc}")
    launch_count[plan.kernel] += 1
    instance_count[plan.instance] += 1
    return out
