"""Ops: RoPE, resampling, pixel shuffle, and the hand-written kernels.

Each kernel wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), incremented where it launches its kernel and nowhere
else, so a run can show that the main path went through the kernels.
"""

from .block_mlp import block_mlp
from .dots_attention import dots_attention
from .flash_attention import attention_single_pass, flash_attention
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
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
