"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from repro_torch.config import ArchConfig, AttentionConfig, SSMConfig, register_arch


@register_arch("xlstm-125m")
def xlstm_125m() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        d_ff=0,  # xLSTM blocks carry their own projections; no MLP
        vocab_size=50304,
        # num_heads reused as the mLSTM head count (assignment: 4H kv=4)
        attention=AttentionConfig(num_heads=4, num_kv_heads=4, head_dim=192),
        ssm=SSMConfig(block_pattern="mmmmms"),  # xLSTM[~5:1 m:s]
        tie_embeddings=True,
        source="arXiv:2405.04517; unverified",
        notes="Recurrent O(1) decode state => long_500k runs.",
    )


@register_arch("tiny-xlstm")
def tiny_xlstm() -> ArchConfig:
    return ArchConfig(
        name="tiny-xlstm",
        family="ssm",
        num_layers=4,
        d_model=32,
        d_ff=0,
        vocab_size=64,
        attention=AttentionConfig(num_heads=2, num_kv_heads=2, head_dim=16),
        ssm=SSMConfig(block_pattern="ms"),
        source="reduced",
    )
