"""Model configuration of the PyTorch port.

A copy of the reference package's ``ModelConfig`` (``src/repro/config.py``),
field for field and default for default, so that a configuration means the
same model in both packages (``tests/test_torch_model.py`` checks that the
two stay equal). The port imports nothing of the reference package, so it
keeps this copy. The parameter-count hooks of the original are left out:
they trace the JAX initializer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition.

    One decoder substrate covers dense / MoE / SSM / hybrid / VLM families;
    encoder-decoder (audio) adds a stubbed-frontend encoder stack. The port
    runs the dense GPT-2 family so far (``repro_torch.configs``).
    """

    name: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention variants -------------------------------------------------
    attention_kind: str = "gqa"  # gqa | mla | none (for pure-SSM layers)
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    positional: str = "rope"  # rope | learned | none
    max_position_embeddings: int = 8192  # only for learned positions
    sliding_window: int = 0  # 0 -> full attention; >0 -> SWA window
    logit_softcap: float = 0.0

    # --- MLA (DeepSeek-V2) ---------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading layers that use the dense MLP
    router_aux_loss_coef: float = 0.001
    expert_capacity_factor: float = 1.25

    # --- SSM / hybrid block pattern -------------------------------------------
    # Cycled over layers. Entries: "attn", "local_attn", "mlstm", "slstm", "rglru".
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048
    lru_width: int = 0  # 0 -> d_model
    conv1d_width: int = 4
    mlstm_chunk: int = 64

    # --- encoder-decoder (audio) ----------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 1500
    frontend_dim: int = 0  # stubbed frontend embedding dim (0 -> d_model)

    # --- misc ------------------------------------------------------------------
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    activation: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    source: str = ""  # citation for the config

    # ------------------------------------------------------------------ helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def block_kind(self, layer_idx: int) -> str:
        """Mixing-block kind ("attn", "mlstm", ...) for a decoder layer."""
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def uses_kv_cache(self, layer_idx: int) -> bool:
        return self.block_kind(layer_idx) in ("attn", "local_attn")

    @property
    def sub_quadratic(self) -> bool:
        """True if every mixing block has O(1)/O(window) decode state."""
        kinds = {self.block_kind(i) for i in range(self.num_layers)}
        if "attn" in kinds and self.sliding_window == 0 and self.attention_kind != "none":
            return False
        if self.attention_kind == "mla" and self.sliding_window == 0 and "attn" in kinds:
            return False
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
