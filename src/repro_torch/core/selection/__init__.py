from .e3cs import E3CSState, e3cs_init, e3cs_probs, e3cs_update
from .prob_alloc import prob_alloc
from .quota import make_quota_schedule
from .sampling import (
    gumbel_row,
    local_topk_candidates,
    merge_topk_candidates,
    perturbed_scores,
    plackett_luce_sample,
    selection_mask,
    top_k,
)

__all__ = [
    "E3CSState",
    "e3cs_init",
    "e3cs_probs",
    "e3cs_update",
    "prob_alloc",
    "make_quota_schedule",
    "gumbel_row",
    "local_topk_candidates",
    "merge_topk_candidates",
    "perturbed_scores",
    "plackett_luce_sample",
    "selection_mask",
    "top_k",
]
