"""hymba-1.5b [hybrid] — parallel attn + mamba heads, ssm_state=16
[arXiv:2411.13676; hf]."""
from repro_torch.config import ArchConfig, AttentionConfig, SSMConfig, register_arch


@register_arch("hymba-1.5b")
def hymba_1_5b() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        d_ff=5504,
        vocab_size=32001,
        attention=AttentionConfig(
            num_heads=25,
            num_kv_heads=5,
            head_dim=64,
            sliding_window=1024,
            layer_pattern="L",  # hymba: SWA on (nearly) all layers
        ),
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
        tie_embeddings=True,
        source="arXiv:2411.13676; hf",
        notes="Parallel attention+Mamba heads fused per block; meta-tokens "
        "stubbed out (DESIGN.md §5).  SWA + O(1) SSM state => long_500k runs.",
    )


@register_arch("tiny-hymba")
def tiny_hymba() -> ArchConfig:
    return ArchConfig(
        name="tiny-hymba",
        family="hybrid",
        num_layers=2,
        d_model=48,
        d_ff=96,
        vocab_size=96,
        attention=AttentionConfig(
            num_heads=3, num_kv_heads=1, head_dim=16,
            sliding_window=8, layer_pattern="L",
        ),
        ssm=SSMConfig(state_dim=4, conv_width=2, expand=2),
        source="reduced",
    )
