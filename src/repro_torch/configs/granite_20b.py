"""granite-20b [dense] — llama-arch MQA, code [arXiv:2405.04324; hf]."""
from repro_torch.config import ArchConfig, AttentionConfig, register_arch


@register_arch("granite-20b")
def granite_20b() -> ArchConfig:
    return ArchConfig(
        name="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        d_ff=24576,
        vocab_size=49152,
        attention=AttentionConfig(num_heads=48, num_kv_heads=1, head_dim=128),
        act="gelu",
        tie_embeddings=True,
        source="arXiv:2405.04324; hf",
        notes="MQA (kv=1 => KV-head dim unshardable; decode cache shards the "
        "sequence dim instead — DESIGN.md §7).  Full attention => long_500k "
        "skipped.",
    )


@register_arch("tiny-granite")
def tiny_granite() -> ArchConfig:
    return ArchConfig(
        name="tiny-granite",
        family="dense",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        attention=AttentionConfig(num_heads=4, num_kv_heads=1, head_dim=16),
        act="gelu",
        source="reduced",
    )
