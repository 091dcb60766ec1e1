"""The port's kernels: hand-written CUDA for Hopper, with plain PyTorch
versions beside them (:mod:`.ref`) and a launch count on every wrapper."""

from .flash_attention import (d256_dkv, d256_dq, d256_forward,
                              f32tc_dkv, f32tc_dq, f32tc_forward,
                              flash_attention,
                              flash_attention_dkv, flash_attention_dq,
                              simt_dkv, simt_dq, simt_forward)
from .ops import merge_blocks_device, split_merged
from .pack_blocks import pack_rows
from .relayout import chunked_to_rowmajor, rowmajor_to_chunked

__all__ = ["merge_blocks_device", "split_merged", "pack_rows",
           "chunked_to_rowmajor", "rowmajor_to_chunked", "flash_attention",
           "flash_attention_dq", "flash_attention_dkv",
           "WRAPPERS",
           "launch_counts", "reset_launch_counts"]

#: every kernel's launch counter, by kernel name, each added to by that
#: kernel alone: its wrapper's, or for the flash kernels one per kernel
#: (``flash_attention``, ``flash_attention_dq`` and ``flash_attention_dkv``
#: count the sm90 route's kernels for head_dim up to 128, the ``_d256``
#: names its head_dim-256 kernels, the ``_f32tc`` names the f32 kernels on
#: the tensor cores (3xTF32), the ``_simt`` names the CUDA-core ones); a
#: route's launches are the sum of its kernels'
WRAPPERS = {"pack_rows": pack_rows,
            "chunked_to_rowmajor": chunked_to_rowmajor,
            "rowmajor_to_chunked": rowmajor_to_chunked,
            "flash_attention": flash_attention,
            "flash_attention_d256": d256_forward,
            "flash_attention_f32tc": f32tc_forward,
            "flash_attention_simt": simt_forward,
            "flash_attention_dq": flash_attention_dq,
            "flash_attention_dq_d256": d256_dq,
            "flash_attention_dq_f32tc": f32tc_dq,
            "flash_attention_dq_simt": simt_dq,
            "flash_attention_dkv": flash_attention_dkv,
            "flash_attention_dkv_d256": d256_dkv,
            "flash_attention_dkv_f32tc": f32tc_dkv,
            "flash_attention_dkv_simt": simt_dkv}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
