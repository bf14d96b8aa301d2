"""Chameleon 34B (early-fusion VLM) [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. Early fusion: image
content enters as VQ-VAE code tokens sharing the text vocabulary, so the
backbone is a standard decoder; the VQ tokenizer frontend is stubbed per the
assignment (``input_specs`` provides interleaved token ids). Chameleon uses
qk-norm for training stability.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=65_536,
        attention_kind="gqa",
        use_qk_norm=True,
        norm="rmsnorm",
        activation="swiglu",
        source="arXiv:2405.09818",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="chameleon-34b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
    )
