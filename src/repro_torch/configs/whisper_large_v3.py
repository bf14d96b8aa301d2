"""Whisper large-v3 (audio encoder-decoder) [arXiv:2212.04356].

32L (enc) + 32L (dec) d_model=1280 20H (MHA) d_ff=5120 vocab=51866.
The mel-spectrogram + conv feature extractor frontend is STUBBED per the
assignment: ``input_specs`` provides precomputed frame embeddings of shape
(batch, encoder_seq_len, d_model). Pre-LN transformer with learned positions
and GELU, per the original architecture.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,  # decoder layers
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51_866,
        attention_kind="gqa",
        positional="learned",
        max_position_embeddings=448 * 128,  # extended for the assigned shapes
        is_encoder_decoder=True,
        encoder_layers=32,
        encoder_seq_len=1500,
        norm="layernorm",
        activation="gelu",
        source="arXiv:2212.04356",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="whisper-large-v3-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        encoder_layers=2,
        encoder_seq_len=64,
        max_position_embeddings=4096,
    )
