"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  Frontend is a STUB: input_specs() provides
precomputed frame embeddings; the backbone is exercised fully."""
from repro_torch.config import ArchConfig, AttentionConfig, register_arch


@register_arch("musicgen-large")
def musicgen_large() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        d_ff=8192,
        vocab_size=2048,
        attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=64),
        input_mode="embeddings",
        act="gelu",
        tie_embeddings=True,
        source="arXiv:2306.05284; hf",
        notes="EnCodec frame embeddings stubbed at input; full attention => "
        "long_500k skipped.",
    )


@register_arch("tiny-musicgen")
def tiny_musicgen() -> ArchConfig:
    return ArchConfig(
        name="tiny-musicgen",
        family="audio",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=64,
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=16),
        input_mode="embeddings",
        act="gelu",
        source="reduced",
    )
