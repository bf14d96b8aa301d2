"""DeepSeek-V2 236B (MoE, MLA) [arXiv:2405.04434].

60L d_model=5120 128H d_ff(moe)=1536 vocab=102400; MLA kv_lora_rank=512,
2 shared + 160 routed experts, top-6. The first layer uses a dense MLP
(d_ff=12288) per the model card.
"""

from repro_torch.config import ModelConfig


def model_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,  # MLA: all heads share the latent kv cache
        d_ff=12288,  # dense MLP for the leading dense layer
        vocab_size=102_400,
        attention_kind="mla",
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        num_experts=160,
        num_experts_per_tok=6,
        num_shared_experts=2,
        moe_d_ff=1536,
        first_dense_layers=1,
        norm="rmsnorm",
        activation="swiglu",
        source="arXiv:2405.04434",
    )


def reduced_config() -> ModelConfig:
    return model_config().replace(
        name="deepseek-v2-236b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=512,
        kv_lora_rank=64,
        q_lora_rank=96,
        qk_rope_head_dim=16,
        qk_nope_head_dim=32,
        v_head_dim=32,
        num_experts=4,
        num_experts_per_tok=2,
        num_shared_experts=1,
        moe_d_ff=128,
        first_dense_layers=1,
    )
