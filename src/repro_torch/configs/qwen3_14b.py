"""Qwen3 14B (dense, GQA + qk-norm) [hf:Qwen/Qwen3-8B family].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, head_dim=128,
per-head RMS qk-norm.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151_936,
        attention_kind="gqa",
        use_qk_norm=True,
        rope_theta=1_000_000.0,
        norm="rmsnorm",
        activation="swiglu",
        source="hf:Qwen/Qwen3-8B",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="qwen3-14b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
    )
