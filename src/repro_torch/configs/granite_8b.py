"""IBM Granite 8B code model (dense, llama-arch) [arXiv:2405.04324].

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=49_152,
        attention_kind="gqa",
        norm="rmsnorm",
        activation="swiglu",
        rope_theta=10_000_000.0,
        source="arXiv:2405.04324",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="granite-8b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
    )
