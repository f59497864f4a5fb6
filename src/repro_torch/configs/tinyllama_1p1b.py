"""tinyllama-1.1b — llama2-architecture small dense model.

[arXiv:2401.02385] 22 layers, d_model=2048, 32 heads / 4 kv heads,
d_ff=5632, vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, ArchFamily, AttentionKind

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family=ArchFamily.DENSE,
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    attention=AttentionKind.FULL,
    source="arXiv:2401.02385",
)


def smoke_config() -> ArchConfig:
    return CONFIG.with_overrides(
        dtype="float32",
        name="tinyllama-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        d_ff=512,
        vocab_size=512,
    )
