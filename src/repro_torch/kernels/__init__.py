"""The port's kernels: CUDA C++ for sm_90a under ``csrc/``, their wrappers,
and the plain PyTorch versions the wrappers take for CPU tensors."""
from .round_fused import fused_alloc_select, fused_perturb_select, fused_round_tail
from .unpack_bits import unpack_bits, unpack_crumbs

__all__ = [
    "fused_alloc_select",
    "fused_perturb_select",
    "fused_round_tail",
    "unpack_bits",
    "unpack_crumbs",
    "WRAPPERS",
    "launch_counts",
    "reset_launch_counts",
]

# every wrapper that launches a kernel, by the name its count is reported under
WRAPPERS = {
    "round_select.from_w": fused_alloc_select,
    "round_select.from_p": fused_perturb_select,
    "round_tail": fused_round_tail,
    "unpack_bits": unpack_bits,
    "unpack_crumbs": unpack_crumbs,
}


def launch_counts() -> dict:
    """Kernel launches so far, by wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
