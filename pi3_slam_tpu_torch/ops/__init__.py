"""Ops: RoPE, resampling, pixel shuffle, and the hand-written kernels.

Each kernel wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), incremented where it launches its kernel and nowhere
else, so a run can show that the main path went through the kernels. A
wrapper with an fp32 entry counts that kernel's launches apart
(``wrapper.launches_fp32``, reported as ``<name>_fp32``).
"""

from contextlib import contextmanager

from .block_mlp import block_mlp
from .dots_attention import dots_attention
from .flash_attention import attention_single_pass, flash_attention
from .focal_shift import solve_shift
from .mlp import mlp
from .packed_attention import attention_single_pass_packed, flash_attention_packed
from .partial_attention import flash_attention_partial
from .qkv_producer import qkv_rope_producer

KERNEL_WRAPPERS = {
    "qkv_rope_producer": qkv_rope_producer,
    "attention_single_pass_packed": attention_single_pass_packed,
    "flash_attention_packed": flash_attention_packed,
    "flash_attention_partial": flash_attention_partial,
    "block_mlp": block_mlp,
    "flash_attention": flash_attention,
    "attention_single_pass": attention_single_pass,
    "mlp": mlp,
    "dots_attention": dots_attention,
    "focal_shift": solve_shift,
}


# the wrappers with an fp32 entry beside their bf16 one (every one but the
# bf16 probe's and the fp32-only focal / shift solve's)
FP32_ENTRIES = tuple(name for name in KERNEL_WRAPPERS
                     if name not in ("dots_attention", "focal_shift"))


def launch_counts() -> dict[str, int]:
    counts = {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}
    counts.update({f"{name}_fp32": KERNEL_WRAPPERS[name].launches_fp32 for name in FP32_ENTRIES})
    return counts


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for name in FP32_ENTRIES:
        KERNEL_WRAPPERS[name].launches_fp32 = 0


@contextmanager
def uncounted():
    """Launches inside the block leave the counts as they were: a kernel
    held against its plain version is no launch of the path that holds it."""
    saved = launch_counts()
    try:
        yield
    finally:
        for name, fn in KERNEL_WRAPPERS.items():
            fn.launches = saved[name]
        for name in FP32_ENTRIES:
            KERNEL_WRAPPERS[name].launches_fp32 = saved[f"{name}_fp32"]
