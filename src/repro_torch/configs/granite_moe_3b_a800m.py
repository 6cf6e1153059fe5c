"""granite-moe-3b-a800m [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.config import ArchConfig, AttentionConfig, MoEConfig, register_arch


@register_arch("granite-moe-3b-a800m")
def granite_moe() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        d_ff=512,  # per-expert ffn width
        vocab_size=49155,
        attention=AttentionConfig(
            num_heads=24, num_kv_heads=8, head_dim=64, rope_theta=10_000.0,
        ),
        moe=MoEConfig(num_experts=40, top_k=8, expert_ffn_dim=512),
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
        notes="40 experts top-8; full attention => long_500k skipped "
        "(DESIGN.md §5).",
    )


@register_arch("tiny-granite-moe")
def tiny_granite_moe() -> ArchConfig:
    return ArchConfig(
        name="tiny-granite-moe",
        family="moe",
        num_layers=2,
        d_model=48,
        d_ff=32,
        vocab_size=96,
        attention=AttentionConfig(num_heads=6, num_kv_heads=2, head_dim=8),
        moe=MoEConfig(num_experts=5, top_k=3, expert_ffn_dim=32,
                      capacity_factor=8.0),  # dropless at test scale
        source="reduced",
    )
