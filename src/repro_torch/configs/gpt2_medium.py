"""GPT-2 medium (345M) — the paper's own evaluation model (Table I / §VI).

24L d_model=1024 16H d_ff=4096 vocab=50304, LayerNorm + GELU + learned
positions (GPT-2 family).
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="gpt2-medium",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=50_304,
        attention_kind="gqa",
        positional="learned",
        max_position_embeddings=4096,
        norm="layernorm",
        activation="gelu",
        tie_embeddings=True,
        source="Pier paper Table I / GPT-2",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="gpt2-medium-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        max_position_embeddings=1024,
    )
