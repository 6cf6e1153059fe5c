"""minicpm-2b [dense] — WSD schedule (arch = llama-like) [arXiv:2404.06395; hf]."""
from repro_torch.config import ArchConfig, AttentionConfig, register_arch


@register_arch("minicpm-2b")
def minicpm_2b() -> ArchConfig:
    return ArchConfig(
        name="minicpm-2b",
        family="dense",
        num_layers=40,
        d_model=2304,
        d_ff=5760,
        vocab_size=122753,
        attention=AttentionConfig(num_heads=36, num_kv_heads=36, head_dim=64),
        tie_embeddings=True,
        source="arXiv:2404.06395; hf",
        notes="Trains with the WSD (warmup-stable-decay) schedule "
        "(repro.train.optimizer).  Full attention => long_500k skipped.",
    )


@register_arch("tiny-minicpm")
def tiny_minicpm() -> ArchConfig:
    return ArchConfig(
        name="tiny-minicpm",
        family="dense",
        num_layers=2,
        d_model=60,
        d_ff=120,
        vocab_size=128,
        attention=AttentionConfig(num_heads=6, num_kv_heads=6, head_dim=10),
        source="reduced",
    )
