"""gemma3-1b [dense] — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""
from repro_torch.config import ArchConfig, AttentionConfig, register_arch


@register_arch("gemma3-1b")
def gemma3_1b() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b",
        family="dense",
        num_layers=26,
        d_model=1152,
        d_ff=6912,
        vocab_size=262144,
        attention=AttentionConfig(
            num_heads=4,
            num_kv_heads=1,
            head_dim=256,
            rope_theta=1e6,
            sliding_window=512,
            layer_pattern="LLLLLG",  # 5:1 local:global
            qk_norm=True,
        ),
        tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt; unverified",
        notes="5:1 sliding-window => long_500k runs (global layers bounded "
        "count; local layers O(w)).",
    )


@register_arch("tiny-gemma3")
def tiny_gemma3() -> ArchConfig:
    return ArchConfig(
        name="tiny-gemma3",
        family="dense",
        num_layers=6,
        d_model=48,
        d_ff=96,
        vocab_size=256,
        attention=AttentionConfig(
            num_heads=2, num_kv_heads=1, head_dim=24,
            sliding_window=8, layer_pattern="LLLLLG", qk_norm=True,
        ),
        source="reduced",
    )
