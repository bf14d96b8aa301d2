"""RecurrentGemma 9B (Griffin hybrid: RG-LRU + local attention, 2:1)
[arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000, local window 2048.
Griffin pattern: two recurrent (RG-LRU) blocks followed by one local-attention
block. Sub-quadratic: runs long_500k natively (O(1) LRU state + windowed KV).
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab_size=256_000,
        attention_kind="gqa",
        block_pattern=("rglru", "rglru", "local_attn"),
        local_window=2048,
        lru_width=4096,
        conv1d_width=4,
        norm="rmsnorm",
        activation="gelu",  # GeGLU in Griffin; gated handled in layers
        logit_softcap=30.0,
        source="arXiv:2402.19427",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="recurrentgemma-9b-reduced",
        num_layers=3,  # one full rglru/rglru/local_attn cycle
        d_model=256,
        num_heads=4,
        num_kv_heads=1,
        d_ff=512,
        vocab_size=512,
        local_window=64,
        lru_width=256,
    )
