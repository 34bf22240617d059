from .baselines import PowDState, UCBState, fedcs_select, pow_d_select, random_select, ucb_init, ucb_select, ucb_update
from .e3cs import E3CSState, e3cs_init, e3cs_probs, e3cs_update
from .prob_alloc import prob_alloc
from .quota import make_quota_schedule
from .regret import empirical_expected_cep, oracle_cep, regret
from .sampling import (
    gumbel_from_uniform,
    exact_top_k,
    gumbel_row,
    inclusion_probability_mc,
    local_topk_candidates,
    merge_topk_candidates,
    perturbed_scores,
    plackett_luce_sample,
    sample_selection,
    selection_mask,
    systematic_sample,
    top_k,
    uniform_row,
)

__all__ = [
    "PowDState",
    "UCBState",
    "fedcs_select",
    "pow_d_select",
    "random_select",
    "ucb_init",
    "ucb_select",
    "ucb_update",
    "E3CSState",
    "e3cs_init",
    "e3cs_probs",
    "e3cs_update",
    "prob_alloc",
    "make_quota_schedule",
    "empirical_expected_cep",
    "oracle_cep",
    "regret",
    "gumbel_from_uniform",
    "exact_top_k",
    "gumbel_row",
    "inclusion_probability_mc",
    "local_topk_candidates",
    "merge_topk_candidates",
    "perturbed_scores",
    "plackett_luce_sample",
    "sample_selection",
    "selection_mask",
    "systematic_sample",
    "top_k",
    "uniform_row",
]
