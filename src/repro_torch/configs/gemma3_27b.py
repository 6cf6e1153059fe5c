"""gemma3-27b [dense] — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt;
unverified]."""
from repro_torch.config import ArchConfig, AttentionConfig, register_arch


@register_arch("gemma3-27b")
def gemma3_27b() -> ArchConfig:
    return ArchConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        d_ff=21504,
        vocab_size=262144,
        attention=AttentionConfig(
            num_heads=32,
            num_kv_heads=16,
            head_dim=128,
            rope_theta=1e6,
            sliding_window=1024,
            layer_pattern="LLLLLG",
            qk_norm=True,
        ),
        tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt; unverified",
        notes="5:1 sliding-window => long_500k runs.",
    )
