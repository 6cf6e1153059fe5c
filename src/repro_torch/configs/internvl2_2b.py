"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings; the InternLM2-style backbone is exercised fully."""
from repro_torch.config import ArchConfig, AttentionConfig, register_arch


@register_arch("internvl2-2b")
def internvl2_2b() -> ArchConfig:
    return ArchConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        d_ff=8192,
        vocab_size=92553,
        attention=AttentionConfig(num_heads=16, num_kv_heads=8, head_dim=128),
        input_mode="embeddings",
        tie_embeddings=True,
        source="arXiv:2404.16821; hf",
        notes="Patch embeddings stubbed at input; full attention => "
        "long_500k skipped.",
    )


@register_arch("tiny-internvl2")
def tiny_internvl2() -> ArchConfig:
    return ArchConfig(
        name="tiny-internvl2",
        family="vlm",
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=128,
        attention=AttentionConfig(num_heads=4, num_kv_heads=2, head_dim=16),
        input_mode="embeddings",
        source="reduced",
    )
