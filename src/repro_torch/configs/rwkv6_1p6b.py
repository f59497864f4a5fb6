"""rwkv6-1.6b (Finch) — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 24 layers, d_model=2048, d_ff=7168 (channel-mix),
vocab=65536.  WKV6 heads of size 64 -> 32 heads.
"""
from repro_torch.configs.base import ArchConfig, ArchFamily

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family=ArchFamily.SSM,
    num_layers=24,
    d_model=2048,
    num_heads=0,               # attention-free
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    source="arXiv:2404.05892",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        dtype="float32",
        name="rwkv6-smoke",
        num_layers=2,
        d_model=256,
        d_ff=512,
        vocab_size=512,
        rwkv_head_dim=32,
    )
