"""Kimi K2 — trillion-parameter MoE, 32B active [arXiv:2501.kimi2 per
assignment table].

61L d_model=7168 64H (GQA kv=8) moe_d_ff=2048 vocab=163840,
384 routed experts top-8 + 1 shared expert, first layer dense.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=18432,  # dense MLP width for the leading dense layer
        vocab_size=163_840,
        attention_kind="gqa",
        num_experts=384,
        num_experts_per_tok=8,
        num_shared_experts=1,
        moe_d_ff=2048,
        first_dense_layers=1,
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=50_000.0,
        source="arXiv:2501.kimi2 (assignment table)",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="kimi-k2-1t-a32b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        num_experts=4,
        num_experts_per_tok=2,
        num_shared_experts=1,
        moe_d_ff=128,
        first_dense_layers=1,
    )
