"""GPT-2 XL (1.5B) — the paper's own evaluation model (Table I / §VI).

48L d_model=1600 25H d_ff=6400 vocab=50304, LayerNorm + GELU + learned
positions (GPT-2 family).
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="gpt2-xl",
        family="dense",
        num_layers=48,
        d_model=1600,
        num_heads=25,
        num_kv_heads=25,
        d_ff=6400,
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
        name="gpt2-xl-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        max_position_embeddings=1024,
    )
