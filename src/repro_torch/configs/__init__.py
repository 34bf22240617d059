from .base import (
    FLConfig, INPUT_SHAPES, InputShape, ModelConfig, get_config, list_archs, register, smoke_variant,
)
from . import (  # noqa: F401  (registration side effects)
    stablelm_1_6b, llama3_405b, qwen2_vl_72b, gemma_2b, deepseek_v3_671b,
    mamba2_130m, nemotron_4_15b, qwen3_moe_30b_a3b, zamba2_7b, whisper_base,
    paper_cnn,
)

ASSIGNED = [
    "stablelm-1.6b", "llama3-405b", "qwen2-vl-72b", "gemma-2b",
    "deepseek-v3-671b", "mamba2-130m", "nemotron-4-15b",
    "qwen3-moe-30b-a3b", "zamba2-7b", "whisper-base",
]

__all__ = ["FLConfig", "ModelConfig", "InputShape", "INPUT_SHAPES", "register", "get_config", "list_archs",
           "smoke_variant", "ASSIGNED"]
