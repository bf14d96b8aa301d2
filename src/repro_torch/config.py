"""Configuration of the PyTorch port.

Copies of the reference package's ``ModelConfig``, ``ParallelConfig``,
``OuterCommConfig``, ``MembershipConfig`` and ``TrainConfig``
(``src/repro/config.py``), field for
field and default for default (``ParallelConfig`` differs in three
defaults, which its docstring names), so that a configuration means the
same model and run in both packages (``tests/test_torch_model.py``,
``tests/test_torch_outer.py`` and ``tests/test_torch_trainer.py`` check
that they stay equal). The port imports nothing of the reference package, so it
keeps this copy. The parameter-count hooks of the original are left out:
they trace the JAX initializer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union


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


# ---------------------------------------------------------------------------
# Parallel layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    """Process layout and Pier group structure (copy of
    ``repro/config.py:ParallelConfig``).

    A *group* is one ``(pod, data_outer)`` index of ``data_inner`` ranks;
    inner steps communicate only inside a group, the outer sync only across
    groups. Field for field the reference's, with three defaults changed so
    that the all-defaults config is one the port runs: ``model_axis_size``
    1, ``fsdp`` False and ``shard_experts`` False. In-group tensor
    parallelism, FSDP and expert sharding are ROADMAP.md queue 1, item 10:
    asking for them raises ``NotImplementedError``, as does activation
    checkpointing (``remat``), context parallelism and scanned layers.
    ``use_pallas`` is kept for the field list and read by nothing: which
    kernel runs follows the tensor's device.
    """

    data_axis_size: int = 16
    model_axis_size: int = 1
    num_pods: int = 1
    # Pier groups along the data axis *per pod*; groups per run =
    # num_pods * data_outer, data_inner = data_axis_size // data_outer
    data_outer: int = 4

    fsdp: bool = False
    shard_experts: bool = False
    remat: str = "none"
    use_pallas: bool = False
    num_microbatches: int = 1  # gradient accumulation inside the inner step
    context_parallel: bool = False
    scan_layers: bool = False

    def __post_init__(self):
        unported = {"model_axis_size > 1": self.model_axis_size > 1, "fsdp": self.fsdp,
                    "shard_experts": self.shard_experts, "remat": self.remat != "none",
                    "context_parallel": self.context_parallel,
                    "scan_layers": self.scan_layers}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"ParallelConfig: {', '.join(asked)} not ported yet (in-group "
                f"sharding is ROADMAP.md queue 1, item 10)")
        if self.num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got {self.num_microbatches}")

    @property
    def data_inner(self) -> int:
        assert self.data_axis_size % self.data_outer == 0, (
            f"data axis {self.data_axis_size} not divisible by "
            f"data_outer {self.data_outer}")
        return self.data_axis_size // self.data_outer

    @property
    def num_groups(self) -> int:
        return self.num_pods * self.data_outer

    @property
    def group_size(self) -> int:
        return self.data_inner * self.model_axis_size

    @property
    def num_devices(self) -> int:
        return self.num_pods * self.data_axis_size * self.model_axis_size

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Outer collective and training configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OuterCommConfig:
    """The outer collective's knobs (copy of ``repro/config.py:OuterCommConfig``).

    The all-defaults config is the flat fp32 mean of Δθ;
    ``repro_torch.sync.resolve_strategy`` maps every config onto its
    strategy, and raises ``NotImplementedError`` for ``sharded``, which is
    not ported yet.
    """

    compression: str = "none"  # none | quantize | int8-wire | rs-ag
    bits: int = 8  # 4 | 8
    block: int = 256  # absmax-scale block (elements per scale)
    hierarchical: bool = False
    chunks: int = 1
    sharded: bool = False

    def __post_init__(self):
        if self.compression not in ("none", "quantize", "int8-wire", "rs-ag"):
            raise ValueError(
                f"outer compression must be 'none', 'quantize', 'int8-wire' "
                f"or 'rs-ag', got {self.compression!r}")
        if self.compression != "none" and self.bits not in (4, 8):
            raise ValueError(f"outer comm bits must be 4 or 8, got {self.bits}")
        if self.block < 1:
            raise ValueError(f"outer comm block must be >= 1, got {self.block}")
        if self.chunks < 1:
            raise ValueError(f"comm chunks must be >= 1, got {self.chunks}")
        if self.compression == "rs-ag" and self.hierarchical:
            raise ValueError("rs-ag composes a flat exchange: it cannot be "
                             "hierarchical")
        if self.compression == "rs-ag" and self.chunks > 1:
            raise ValueError("rs-ag needs chunks=1")

    def replace(self, **kw) -> "OuterCommConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MembershipConfig:
    """Elastic outer-membership knobs (copy of ``repro/config.py:MembershipConfig``).

    Present on ``TrainConfig.membership`` only when elastic membership is
    asked for; ``None`` keeps the fixed-membership steps.
    ``max_staleness``: a group that missed more than this many consecutive
    post-warmup outer events is evicted (0: on the first miss).
    ``min_live``: an outer event with fewer live groups is refused when the
    membership controller is built. ``rejoin_bootstrap``: a rejoining
    group's donor, ``"anchor"`` (the freshly installed anchor) or
    ``"checkpoint"`` (the latest complete checkpoint when a manager is
    attached, else the anchor).
    """

    max_staleness: int = 1
    min_live: int = 1
    rejoin_bootstrap: str = "anchor"  # anchor | checkpoint

    def __post_init__(self):
        if self.max_staleness < 0:
            raise ValueError(f"max_staleness must be >= 0, got {self.max_staleness}")
        if self.min_live < 1:
            raise ValueError(f"min_live must be >= 1, got {self.min_live}")
        if self.rejoin_bootstrap not in ("anchor", "checkpoint"):
            raise ValueError(f"rejoin_bootstrap must be 'anchor' or 'checkpoint', "
                             f"got {self.rejoin_bootstrap!r}")

    def replace(self, **kw) -> "MembershipConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization hyperparameters (copy of ``repro/config.py:TrainConfig``).

    Field for field and default for default the reference's, so that a
    configuration means the same run in both packages
    (``tests/test_torch_outer.py`` checks it). Left out: the deprecated
    flat outer-comm spellings (``outer_compression`` ...).
    ``sync_delay="auto"`` must be resolved to an int before a schedule runs
    (``launch/train.py:resolve_auto_sync_delay``, or the Trainer's sync
    controller).
    """

    optimizer: str = "pier"  # pier | diloco | adamw

    # ---- inner optimizer (AdamW, Table I) ----
    inner_lr: float = 4e-4
    inner_min_lr: float = 4e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.1
    clip_grad: float = 1.0
    lr_schedule: str = "cosine"  # cosine | wsd | constant
    lr_warmup_frac: float = 0.02
    wsd_decay_frac: float = 0.1

    # ---- run shape ----
    total_steps: int = 100_000
    global_batch_size: int = 512
    seq_len: int = 1024
    seed: int = 0

    # ---- Pier / DiLoCo outer optimizer ----
    sync_interval: int = 50  # r / H in the paper
    # the averaged Δθ dispatched at sync step t is applied at t + sync_delay
    # (0 = eager); must be < sync_interval. "auto": resolved at start-up
    sync_delay: Union[int, str] = 0
    outer_comm: Optional[OuterCommConfig] = None  # None -> all defaults
    # elastic membership: None keeps fixed membership
    membership: Optional[MembershipConfig] = None
    warmup_frac: float = 0.10  # p: lazy-start proportion
    outer_optimizer: str = "nesterov_torch"  # nesterov_torch | nesterov_classic | sgd
    outer_momentum: float = 0.9  # terminal mu
    # momentum decay schedule (Alg. 2): (frac_lo, frac_hi, mu)
    momentum_decay: Tuple[Tuple[float, float, float], ...] = (
        (0.10, 0.15, 0.99),
        (0.15, 0.20, 0.95),
        (0.20, 1.01, 0.90),
    )
    # outer LR schedule (§V): warmup 0->1 over [p, outer_lr_warmup_end], then
    # mid value until outer_lr_mid_end, then final value
    outer_lr_warmup_end: float = 0.20
    outer_lr_mid: float = 1.1
    outer_lr_mid_end: float = 0.80
    outer_lr_final: float = 0.9
    fixed_outer_lr: float = 0.7  # DiLoCo baseline's constant
    momentum_warmup: bool = True  # Alg. 1 (off for vanilla DiLoCo)
    lazy_start: bool = True  # AdamW phase before switching (DiLoCo: off)

    # ---- memory ----
    offload_outer_state: bool = False
    opt_state_dtype: str = "float32"  # float32 (paper) | bfloat16

    # ---- loss ----
    z_loss_coef: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "outer_comm", self.outer_comm or OuterCommConfig())
        if isinstance(self.sync_delay, str):
            if self.sync_delay != "auto":
                raise ValueError(f"sync_delay must be an int or 'auto', got {self.sync_delay!r}")
            return
        if not isinstance(self.sync_delay, int) or isinstance(self.sync_delay, bool):
            raise ValueError(f"sync_delay must be an int or 'auto', got {self.sync_delay!r}")
        if self.sync_delay < 0:
            raise ValueError(f"sync_delay must be >= 0, got {self.sync_delay}")
        if self.sync_delay >= self.sync_interval:
            raise ValueError(
                f"sync_delay ({self.sync_delay}) must be < sync_interval "
                f"({self.sync_interval}): the in-flight Δθ must be applied "
                "before the next dispatch")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def warmup_steps(self) -> int:
        return int(self.total_steps * self.warmup_frac)

    def mu_at(self, step: int) -> float:
        """Momentum-decay schedule (Algorithm 2, lines 12-18)."""
        frac = step / max(self.total_steps, 1)
        for lo, hi, mu in self.momentum_decay:
            if lo <= frac < hi:
                return mu
        return self.outer_momentum

    def outer_lr_at(self, step: int) -> float:
        """Outer LR schedule from §V (Implementation)."""
        frac = step / max(self.total_steps, 1)
        p = self.warmup_frac
        if frac < p:
            return 0.0  # outer optimizer not applied during lazy start
        if frac < self.outer_lr_warmup_end:
            span = self.outer_lr_warmup_end - p
            return (frac - p) / max(span, 1e-9)
        if frac < self.outer_lr_mid_end:
            return self.outer_lr_mid
        return self.outer_lr_final
