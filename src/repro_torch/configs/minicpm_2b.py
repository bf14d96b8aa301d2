"""MiniCPM 2B (dense, llama-like, WSD schedule) [arXiv:2404.06395].

40L d_model=2304 36H (MHA kv=36) d_ff=5760 vocab=122753, tied embeddings.
The WSD (warmup-stable-decay) *inner* LR schedule is available as
``TrainConfig.lr_schedule="wsd"``.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        num_layers=40,
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        d_ff=5760,
        vocab_size=122_753,
        attention_kind="gqa",
        tie_embeddings=True,
        norm="rmsnorm",
        activation="swiglu",
        source="arXiv:2404.06395",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="minicpm-2b-reduced",
        num_layers=2,
        d_model=288,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
    )
