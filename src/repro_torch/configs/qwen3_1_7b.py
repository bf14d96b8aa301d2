"""Qwen3 1.7B (dense, GQA + qk-norm) [hf:Qwen/Qwen3-8B family].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim=128.
RMSNorm + SwiGLU + RoPE (theta 1e6), qk-norm, tied embeddings.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151_936,
        attention_kind="gqa",
        use_qk_norm=True,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        activation="swiglu",
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-8B",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="qwen3-1.7b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
    )
