"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from repro_torch.config import ArchConfig, AttentionConfig, MoEConfig, register_arch


@register_arch("mixtral-8x7b")
def mixtral_8x7b() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab_size=32000,
        attention=AttentionConfig(
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            rope_theta=1e6,
            sliding_window=4096,
            layer_pattern="L",  # SWA on every layer
        ),
        moe=MoEConfig(num_experts=8, top_k=2, expert_ffn_dim=14336),
        tie_embeddings=False,
        source="arXiv:2401.04088; hf",
        notes="8 experts top-2, sliding-window attention; long_500k runs "
        "(SWA => sub-quadratic decode).",
    )


@register_arch("tiny-mixtral")
def tiny_mixtral() -> ArchConfig:
    return ArchConfig(
        name="tiny-mixtral",
        family="moe",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        attention=AttentionConfig(
            num_heads=4, num_kv_heads=2, head_dim=16,
            sliding_window=16, layer_pattern="L",
        ),
        moe=MoEConfig(num_experts=4, top_k=2, expert_ffn_dim=128,
                      capacity_factor=8.0),  # dropless at test scale
        tie_embeddings=False,
        source="reduced",
    )
