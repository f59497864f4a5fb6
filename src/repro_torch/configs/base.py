"""Architecture configuration dataclasses (copy of ``repro/configs/base.py``).

The port keeps its own copy so that it imports nothing of the JAX package.
Only ``param_count`` differs: it asks the port's registry, which counts the
port's own parameter shapes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class ArchFamily(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"            # rwkv6
    HYBRID = "hybrid"      # zamba2: mamba2 backbone + shared attention block
    VLM = "vlm"            # qwen2-vl: dense decoder + M-RoPE, stubbed vision
    AUDIO = "audio"        # seamless: encoder-decoder, stubbed codec frontend


class AttentionKind(str, enum.Enum):
    FULL = "full"                  # causal full attention
    SLIDING = "sliding"            # causal sliding-window attention
    BIDIRECTIONAL = "bidirectional"  # encoder self-attention


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A single transformer/SSM/hybrid architecture.

    ``num_layers`` counts *blocks* — the unit of the paper's logical split
    (propagation lengths L_i index into this stack).
    """

    name: str
    family: ArchFamily
    num_layers: int
    d_model: int
    num_heads: int                      # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    head_dim: int = 0                   # 0 -> d_model // num_heads
    attention: AttentionKind = AttentionKind.FULL
    sliding_window: int = 0             # used when attention == SLIDING
    qkv_bias: bool = False              # qwen-style QKV bias
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = ()  # qwen2-vl M-RoPE (t, h, w) splits
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    expert_pad_to: int = 1              # pad expert dim for even sharding
    # --- SSM / hybrid ---
    ssm_state: int = 0                  # Mamba2 state size N
    ssm_head_dim: int = 64              # Mamba2 head dim P
    ssm_expand: int = 2                 # d_inner = expand * d_model
    ssm_conv_width: int = 4
    shared_attn_every: int = 0          # zamba2: shared block applied every k layers
    rwkv_head_dim: int = 64
    # --- enc-dec ---
    num_encoder_layers: int = 0         # >0 -> encoder-decoder
    encoder_seq_len: int = 0            # pre-encoded source length for decode stubs
    # --- modality frontend stubs ---
    frontend_tokens: int = 0            # patch/frame embeddings prepended (stub)
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"             # activation/compute dtype
    param_dtype: str = "float32"
    vocab_pad_to: int = 256
    source: str = ""                    # citation for the config

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def padded_experts(self) -> int:
        return _round_up(self.num_experts, self.expert_pad_to)

    @property
    def is_attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def is_encdec(self) -> bool:
        return self.num_encoder_layers > 0

    def param_count(self) -> int:
        """Analytical parameter count (exact for the port's param tree)."""
        from repro_torch.models.registry import count_params_analytical

        return count_params_analytical(self)

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)
