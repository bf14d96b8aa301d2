"""Architecture configuration registry of the PyTorch port.

The port runs the paper's own GPT-2 family, the dense RMSNorm families
(RoPE, SwiGLU, GQA): Qwen3-1.7B and Qwen3-14B (qk-norm), MiniCPM-2B (MHA,
a tied table of 122 753 rows) and Granite-8B (an untied ``lm_head``), and,
through the dense serve path, the recurrent families RecurrentGemma-9B
(RG-LRU and local MQA attention) and xLSTM-1.3B (mLSTM and sLSTM), and
the MoE families: DeepSeek-V2-236B (MLA attention, through the dense
serve path) and Kimi-K2 (GQA, through the paged path), the early-fusion
VLM Chameleon-34B (GQA 64 / 8 with qk-norm, through the paged path) and
the audio encoder-decoder Whisper-large-v3 (a bidirectional encoder over
stubbed frame embeddings and cross-attention, through the dense serve
path). Each module is a copy of its counterpart in ``src/repro/configs/``
(the ``tests/test_torch_*`` files check the copies field by field), and
every architecture the reference registers is ported.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import ModelConfig

ARCH_MODULES = ["gpt2_small", "gpt2_medium", "gpt2_xl", "gpt2_7b", "qwen3_1_7b",
                "minicpm_2b", "granite_8b", "qwen3_14b", "recurrentgemma_9b", "xlstm_1_3b",
                "deepseek_v2_236b", "kimi_k2_1t_a32b", "chameleon_34b", "whisper_large_v3"]

# display names as the reference's registry spells them, and its aliases
_DISPLAY = {"qwen3_1_7b": "qwen3-1.7b", "xlstm_1_3b": "xlstm-1.3b"}
_CANONICAL = {_DISPLAY.get(m, m.replace("_", "-")): m for m in ARCH_MODULES}
_ALIASES = {"qwen3-1-7b": "qwen3_1_7b", "xlstm-1-3b": "xlstm_1_3b"}


def _module_for(name: str):
    key = name.replace("_", "-").lower()
    mod = _ALIASES.get(key) or _CANONICAL.get(key)
    if mod is None:
        raise KeyError(
            f"unknown architecture {name!r}; available: {sorted(_CANONICAL)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ModelConfig:
    """Full-scale config for ``--arch <name>``."""
    return _module_for(name).model_config()


def get_reduced_config(name: str) -> ModelConfig:
    """Reduced same-family smoke variant (2 layers, d_model 256)."""
    return _module_for(name).reduced_config()


def list_architectures() -> List[str]:
    return sorted(_CANONICAL)
