"""The port's kernels: CUDA C++ for sm_90a under ``csrc/``, their wrappers,
the plain PyTorch versions the wrappers take for CPU tensors, and the public
ops with their tile autotuner.

Routing is by the tensor's device (``_build.route``): a wrapper launches its
kernel for a CUDA tensor, or raises, and takes its plain version only for a
CPU tensor.  The JAX package's ``kernels/dispatch.py`` (``REPRO_INTERPRET``,
which can send a call to the reference) has no counterpart here: no
variable sends a CUDA tensor away from its kernel.
"""
from . import autotune, ops, ref
from .bisect_tiles import bisect_block_sums
from .e3cs_tiles import e3cs_update_kernel_call, fused_gumbel_topk_kernel_call
from .gumbel_topk import gumbel_topk_kernel_call
from .ops import e3cs_update_tiled, fused_gumbel_topk_sample, gumbel_topk_sample
from .round_fused import fused_alloc_select, fused_perturb_select, fused_round_tail
from .threefry import LAUNCHES as THREEFRY_LAUNCHES
from .threefry import threefry, threefry_categorical, threefry_rows
from .unpack_bits import unpack_bits, unpack_crumbs

__all__ = [
    "autotune",
    "ops",
    "ref",
    "bisect_block_sums",
    "e3cs_update_kernel_call",
    "fused_gumbel_topk_kernel_call",
    "gumbel_topk_kernel_call",
    "e3cs_update_tiled",
    "fused_gumbel_topk_sample",
    "gumbel_topk_sample",
    "fused_alloc_select",
    "fused_perturb_select",
    "fused_round_tail",
    "unpack_bits",
    "unpack_crumbs",
    "threefry",
    "threefry_rows",
    "threefry_categorical",
    "WRAPPERS",
    "launch_counts",
    "reset_launch_counts",
    "add_launch_counts",
]

# every wrapper that launches a kernel, by the name its count is reported under
WRAPPERS = {
    "round_select.from_w": fused_alloc_select,
    "round_select.from_p": fused_perturb_select,
    "round_tail": fused_round_tail,
    "unpack_bits": unpack_bits,
    "unpack_crumbs": unpack_crumbs,
    "bisect_block_sums": bisect_block_sums,
    "gumbel_topk": gumbel_topk_kernel_call,
    "fused_gumbel_topk": fused_gumbel_topk_kernel_call,
    "e3cs_update": e3cs_update_kernel_call,
    # one count a threefry epilogue and the rows and categorical entries, again for the original layout
    # (kernels.threefry.LAUNCHES)
    **{f"threefry.{mode}": count for mode, count in THREEFRY_LAUNCHES.items()},
}


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def add_launch_counts(counts: dict) -> None:
    """Add ``{wrapper name: n}`` to the counts (negative ``n`` takes launches
    back): a captured round step's launches run at each replay, not at the
    capture."""
    for name, n in counts.items():
        WRAPPERS[name].launches += n
