"""GPT-2 small (125M) — the paper's own evaluation model (Table I).

12L d_model=768 12H d_ff=3072 vocab=50304 (padded to a multiple of 128, as
Megatron-LM does), LayerNorm + GELU + learned positions.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="gpt2-small",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
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
        name="gpt2-small-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        max_position_embeddings=1024,
    )
