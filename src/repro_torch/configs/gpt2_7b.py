"""GPT-2 7B (paper §VI-B3, DP+TP) — the paper's own evaluation model (Table I / §VI).

32L d_model=4096 32H d_ff=16384 vocab=50304, LayerNorm + GELU + learned
positions (GPT-2 family).
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="gpt2-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=16384,
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
        name="gpt2-7b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        max_position_embeddings=1024,
    )
