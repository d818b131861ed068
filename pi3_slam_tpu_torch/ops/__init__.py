"""Ops: RoPE, resampling, pixel shuffle, and the hand-written kernels.

Each kernel wrapper counts its launches in a plain integer attribute
(``wrapper.launches``), incremented where it launches its kernel and nowhere
else, so a run can show that the main path went through the kernels.
"""

from .block_mlp import block_mlp
from .packed_attention import attention_single_pass_packed, flash_attention_packed
from .qkv_producer import qkv_rope_producer

KERNEL_WRAPPERS = {
    "qkv_rope_producer": qkv_rope_producer,
    "attention_single_pass_packed": attention_single_pass_packed,
    "flash_attention_packed": flash_attention_packed,
    "block_mlp": block_mlp,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
