"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention block.

[arXiv:2411.15242] Zamba2 family: Mamba2 blocks with a single *shared*
full-attention transformer block applied periodically (weights reused at each
application).  38 layers, d_model=2048, 32 heads (GQA kv=32 -> MHA in the
shared block), d_ff=8192 (shared block MLP), vocab=32000, ssm_state=64.
"""
from repro_torch.configs.base import ArchConfig, ArchFamily, AttentionKind

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family=ArchFamily.HYBRID,
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,          # shared block invoked every 6 mamba layers
    attention=AttentionKind.FULL,
    sliding_window=8192,          # long-context mode window for the shared block
    source="arXiv:2411.15242",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        dtype="float32",
        name="zamba2-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        ssm_state=16,
        shared_attn_every=2,
        sliding_window=64,
    )
