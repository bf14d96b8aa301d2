"""xLSTM 1.3B (SSM-family: sLSTM + mLSTM blocks) [arXiv:2405.04517].

48L d_model=2048 4H vocab=50304, attention-free. We use the paper's 7:1
mLSTM:sLSTM block ratio. Sub-quadratic: runs long_500k natively (O(1)
matrix-memory decode state).
"""

from repro_torch.config import ModelConfig

# 7 mLSTM blocks then 1 sLSTM block, cycled over the 48 layers.
_PATTERN = ("mlstm",) * 7 + ("slstm",)


def model_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,  # mLSTM/sLSTM blocks carry their own up/down projections
        vocab_size=50_304,
        attention_kind="none",
        positional="none",
        block_pattern=_PATTERN,
        mlstm_chunk=64,
        norm="rmsnorm",
        activation="swiglu",
        source="arXiv:2405.04517",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="xlstm-1.3b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        vocab_size=512,
        block_pattern=("mlstm", "slstm"),
        mlstm_chunk=16,
    )
